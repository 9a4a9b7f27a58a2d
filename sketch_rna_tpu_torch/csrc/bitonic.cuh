// Shared-memory bitonic sort, used by the fused sketch kernel (sketch.cu)
// and the row sort kernel (row_sort.cu).
#pragma once

// Sorts every aligned `seg`-long segment of s[0, n) ascending, in place.
// n and seg are powers of two with seg <= n.  Every thread of the block
// must call it, after a __syncthreads() that makes s visible; it returns
// after a __syncthreads(), so s is sorted for every thread.
//
// Stage (size, stride) compares lane i (bit `stride` of i clear) with
// lane i + stride; the pair is put in ascending order when bit `size` of
// i's offset within its segment is clear, descending otherwise.  Each
// thread walks the n/2 pairs with a block-wide stride, so no thread idles
// while another owns two lanes.
template <typename T>
__device__ __forceinline__ void bitonic_sort_shared(T* s, int n, int seg) {
  const int half = n >> 1;
  for (int size = 2; size <= seg; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int p = i | stride;
        const bool up = ((i & (seg - 1)) & size) == 0;
        const T a = s[i];
        const T b = s[p];
        if ((a > b) == up) {
          s[i] = b;
          s[p] = a;
        }
      }
      __syncthreads();
    }
  }
}

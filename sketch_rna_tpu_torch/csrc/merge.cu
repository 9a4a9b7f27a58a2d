// Merge of adjacent sorted runs: every row of a contiguous [N, 2w] array
// of int32 or int64 keys holds two ascending runs of w keys, [0, w) and
// [w, 2w); the output row is their merge, ascending.  w is a power of two.
//
// No TPU kernel has this job: the JAX package merges sorted event parts
// with a bitonic merge in XLA (sketch_rna_tpu/match/rowmatch.py:122,
// _bitonic_merge_pair).  In the port it is the merge round of
// row_sort_wide (rows past K4's 16384 lanes: one K4 launch sorts the
// 16384-lane chunks, then one launch of this kernel per doubling) and of
// rowmatch.sort_event_parts (per-k event parts merged into one row).  Its
// plain version is match/row_sort.py bitonic_merge_pair.
//
// Bound: device bytes.  A round reads each key once and writes it once;
// a merge does one comparison per output.  At [8192, 32768] int64 that is
// 4.3 GB, 1.28 ms at 3.35 TB/s.
//
// Design: a merge path.  A block owns a tile of 2048 consecutive outputs.
// When a tile lies inside one row (2w >= 2048), two threads binary-search
// the tile's first and last diagonals in device memory for the split of
// the two runs, and the block stages the two slices it needs (2048 keys
// in all) in shared memory with 16-byte loads.  Narrower rows lie whole
// inside a tile, which stages its 2048 keys directly.  Each thread then
// finds its own 8 outputs' split in shared memory by the same search and
// merges them sequentially, ties from the left run, into a shared output
// tile that the block stores with coalesced 16-byte writes.  Keys carry no
// payload, so the output is bit-equal to any sort of the row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // outputs per block

// The number of a's among the first d outputs of merging a[0, na) and
// b[0, nb), ties taken from a: the smallest i with a[i] > b[d - 1 - i].
template <typename T>
__device__ __forceinline__ int merge_path(const T* a, int na, const T* b, int nb, int d) {
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// How many keys p lies past the 16-byte boundary below it (0 .. V - 1).
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// dst[0, n) = src[0, n) by the whole block, where dst and src lie at the
// same offset modulo 16 bytes: a scalar head and tail, 16-byte vectors
// between.
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (V - misalign(src)) % V);
  const int nvec = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  const int4* vsrc = reinterpret_cast<const int4*>(src + head);
  int4* vdst = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += kThreads) vdst[i] = vsrc[i];
  for (int i = head + V * nvec + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// n: keys in all (N * 2w); w2: the row width 2w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, long long w2) {
  constexpr int V = 16 / sizeof(T);
  __shared__ __align__(16) T s_in[kTile + 3 * V];
  __shared__ __align__(16) T s_out[kTile + V];
  __shared__ int split[2];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long w = w2 / 2;
  const int tl = static_cast<int>(min(static_cast<long long>(kTile), n - t0));  // outputs of this tile
  T* so = s_out + misalign(out + t0);
  const int g = threadIdx.x * kPerThread;  // this thread's first output in the tile
  if (w2 >= kTile) {
    // The tile is outputs [d0, d0 + kTile) of one row.
    const long long row = t0 / w2;
    const int d0 = static_cast<int>(t0 - row * w2);
    const T* a = x + row * w2;
    const T* b = a + w;
    if (threadIdx.x == 0) split[0] = merge_path(a, static_cast<int>(w), b, static_cast<int>(w), d0);
    if (threadIdx.x == 32) split[1] = merge_path(a, static_cast<int>(w), b, static_cast<int>(w), d0 + kTile);
    __syncthreads();
    const int a0 = split[0];
    const int na = split[1] - a0;
    const int b0 = d0 - a0;
    const int nb = kTile - na;
    T* sa = s_in + misalign(a + a0);
    T* sb = s_in + (misalign(a + a0) + na + V - 1) / V * V + misalign(b + b0);
    copy_block(sa, a + a0, na);
    copy_block(sb, b + b0, nb);
    __syncthreads();
    int i = merge_path(sa, na, sb, nb, g);
    int j = g - i;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const bool take_a = j >= nb || (i < na && sa[i] <= sb[j]);
      so[g + r] = take_a ? sa[i++] : sb[j++];
    }
  } else {
    // Whole rows: the tile's keys are its rows' two runs in place.
    T* s = s_in + misalign(x + t0);
    copy_block(s, x + t0, tl);
    __syncthreads();
    const int rw = static_cast<int>(w2);
    const int hw = rw / 2;
    for (int q = 0; q < kPerThread && g + q < tl;) {
      const int p0 = (g + q) & ~(rw - 1);  // the row's first key in the tile
      const int d = g + q - p0;
      const int cnt = min(kPerThread - q, rw - d);
      const T* sa = s + p0;
      const T* sb = sa + hw;
      int i = merge_path(sa, hw, sb, hw, d);
      int j = d - i;
      for (int r = 0; r < cnt; ++r) {
        const bool take_a = j >= hw || (i < hw && sa[i] <= sb[j]);
        so[d + p0 + r] = take_a ? sa[i++] : sb[j++];
      }
      q += cnt;
    }
  }
  __syncthreads();
  copy_block(out + t0, so, tl);
}

template <typename T>
int launch_merge(const void* x, void* out, int N, int W, void* stream) {
  const long long n = static_cast<long long>(N) * W;
  const long long blocks = (n + kTile - 1) / kTile;
  merge_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [N, W] keys, W = 2w a power of two >= 2; each row of x holds two
// ascending runs of w keys.
extern "C" int merge_pairs_launch(const void* x, void* out, int N, int W, void* stream) {
  return launch_merge<int32_t>(x, out, N, W, stream);
}

extern "C" int merge_pairs_i64_launch(const void* x, void* out, int N, int W, void* stream) {
  return launch_merge<long long>(x, out, N, W, stream);
}

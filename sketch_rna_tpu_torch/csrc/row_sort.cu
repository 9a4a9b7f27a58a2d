// K4: ascending sort of every row of a contiguous [B, W] array of int32
// or int64 keys, W a power of two from 2 to 16384.
//
// Replaces the TPU kernel sketch_rna_tpu/match/pallas_sort.py
// _sort_kernel / _bitonic_pass (entry bitonic_row_sort).  On the port's
// path the int32 instance sorts the packed event keys of every read
// (grouping) and the packed (rank, tid) keys of the top-C selection.  The
// int64 instance is the key+payload sort the JAX package does with
// jax.lax.sort over two operands: both halves fit in 32 bits, so a
// (key << 32) | payload int64 sorts exactly as (key, payload).  It sorts
// the long reads' window hashes (sketch dedup), the per-k candidate
// tables by (tid, score) (multi-k combine) and the (rank, tid) keys of a
// top-C selection past the int32 packing bound.
//
// Bound: shared-memory traffic.  A row costs W*log2(W)*(log2(W)+1)/4
// compare-exchanges, each two shared loads and up to two stores, while
// device memory sees the row once in and once out — that single
// read + write per row is the design's floor, as VMEM residency was on
// the TPU.  Rows of W >= 256 get a block each (up to 64 KB of dynamic
// shared memory at W = 16384 for int32, 128 KB for int64, of the 227 KB a
// block may hold); narrower rows pack 2048 / W rows into one block so
// every block sorts 2048 keys and no launch is mostly idle.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPackedKeys = 2048;  // keys per block for rows narrower than 256
constexpr int kOwnBlockWidth = 256;

template <typename T>
__global__ void row_sort_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int W,
                                int rows_per_block, T pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* keys = reinterpret_cast<T*>(smem_raw);
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = min(rows_per_block, static_cast<int>(B - row0));
  const int n = rows_per_block * W;
  const int valid = rows * W;
  const T* src = x + row0 * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // Rows past B (last block only) sort as separate segments and are never stored.
    keys[i] = i < valid ? src[i] : pad;
  }
  __syncthreads();
  bitonic_sort_shared(keys, n, W);
  T* dst = out + row0 * W;
  for (int i = threadIdx.x; i < valid; i += blockDim.x) dst[i] = keys[i];
}

template <typename T>
int launch_row_sort(const void* x, void* out, int B, int W, T pad, void* stream) {
  const int rows_per_block = W >= kOwnBlockWidth ? 1 : kPackedKeys / W;
  const int n = rows_per_block * W;
  const int threads = min(n / 2, kMaxThreads);
  const size_t smem = static_cast<size_t>(n) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_sort_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  row_sort_kernel<T><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), B, W, rows_per_block, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int row_sort_launch(const void* x, void* out, int B, int W, void* stream) {
  return launch_row_sort<int32_t>(x, out, B, W, INT_MAX, stream);
}

extern "C" int row_sort_i64_launch(const void* x, void* out, int B, int W, void* stream) {
  return launch_row_sort<long long>(x, out, B, W, LLONG_MAX, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// Bound: device bytes at every W.  A row is read once and written once
// (2 * W * sizeof(key) bytes); a comparison sort needs log2(W!) < W log2 W
// comparisons of a row, which at the CUDA cores' integer rate (132 SMs x
// 64 lanes x 1.98 GHz) take under a third of the bytes' time even at
// W = 16384.  At [8192, 256] int32 the bytes take 5.0 us at 3.35 TB/s.
// The bitonic network below does W log2 W (log2 W + 1) / 4
// compare-exchanges a row, 2.7x the comparisons a sort needs at W = 256
// and 4.2x at 16384, so the wide rows sit well under their bound.
//
// Design: the network runs in registers (row_sort.cuh, which the
// grouping kernel G, group.cu, shares).  Each thread holds E keys
// (E = 8 for rows up to 256 lanes, 16 above), loaded as 16-byte vectors
// in a warp-striped layout: key j of lane l sits at row offset
// (j / V) * 32V + l * V + j % V, V keys per 16 bytes, so every global
// load and store is a coalesced 16-byte access.  A stage whose partner
// differs in the low log2(V) bits or in the bits above the lane's is a
// compare-exchange between two registers of one thread; a partner in
// another lane of the warp comes by __shfl_xor_sync.  A warp so sorts
// 32 * E keys (256 int32 at E = 8) with no shared memory and no barrier,
// and a row of up to 32 * E lanes never leaves its warp; several rows
// share a warp when W is smaller.  Wider rows (1024 to 16384 lanes) get
// one block of W / 16 threads: only the stages of stride >= 32 * E go
// through shared memory (64 KB per int32 row, 128 KB per int64 row)
// behind a block barrier, and each merge finishes in registers.  At
// W = 16384 that is 15 barrier-separated shared passes, where a
// shared-memory network needs 105.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "row_sort.cuh"

namespace {

constexpr int kWarpThreads = 128;  // threads of a block whose rows fit a warp
constexpr int kMaxWidth = 1 << 14;
constexpr int kMaxDevices = 64;

// A block covers blockDim.x * E consecutive keys.  Rows of W <= 32E:
// each warp sorts its 32E keys alone.  Wider rows: blockDim.x * E == W,
// one row per block, with W keys of dynamic shared memory.
template <typename T, int E, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
    row_sort_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, int W, T pad, bool vec) {
  constexpr int kTile = 32 * E;
  const int lane = threadIdx.x & 31;
  const int wbase = (threadIdx.x >> 5) * kTile;
  const long long e0 = static_cast<long long>(blockIdx.x) * blockDim.x * E + wbase;
  if (W <= kTile && e0 >= n) return;  // a warp past the last row
  T v[E];
  load_keys(v, x, e0, lane, n, pad, vec);
  sort_tile(v, lane, wbase, W);
  if (W > kTile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    for (int size = 2 * kTile; size <= W; size <<= 1) {
      const int dir = size & (W - 1);
      store_keys(v, s, wbase, lane, W, true);
      __syncthreads();
      for (int stride = size >> 1; stride >= kTile; stride >>= 1) {
        for (int p = threadIdx.x; p < (W >> 1); p += blockDim.x) {
          const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
          const T a = s[i];
          const T b = s[i | stride];
          if ((b < a) == ((i & dir) == 0)) {
            s[i] = b;
            s[i | stride] = a;
          }
        }
        __syncthreads();
      }
      // Each thread reads back the keys it wrote, so the next size's
      // store needs no barrier before it.
      load_keys(v, s, wbase, lane, W, pad, true);
      merge_tile(v, lane, wbase, (wbase & dir) != 0);
    }
  }
  store_keys(v, out, e0, lane, n, vec);
}

// Raise the wide kernel's dynamic shared memory limit, once per device,
// to the most a row can need (sketch.cu follows the same rule).
template <typename T>
cudaError_t allow_shared() {
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && raised[dev])) return e;
  e = cudaFuncSetAttribute(row_sort_kernel<T, 16, 1024>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxWidth * static_cast<int>(sizeof(T)));
  if (e == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return e;
}

template <typename T>
int launch_row_sort(const void* x, void* out, int B, int W, T pad, void* stream) {
  const long long n = static_cast<long long>(B) * W;
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(out);
  if (W <= 32 * 8) {
    const long long blocks = (n + kWarpThreads * 8 - 1) / (kWarpThreads * 8);
    row_sort_kernel<T, 8, kWarpThreads><<<static_cast<unsigned>(blocks), kWarpThreads, 0, st>>>(xs, ys, n, W, pad, vec);
  } else if (W <= 32 * 16) {
    const long long blocks = (n + kWarpThreads * 16 - 1) / (kWarpThreads * 16);
    row_sort_kernel<T, 16, kWarpThreads><<<static_cast<unsigned>(blocks), kWarpThreads, 0, st>>>(xs, ys, n, W, pad, vec);
  } else {
    const size_t smem = static_cast<size_t>(W) * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t e = allow_shared<T>();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    row_sort_kernel<T, 16, 1024><<<B, W / 16, smem, st>>>(xs, ys, n, W, pad, vec);
  }
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

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
// Design: the network runs in registers.  Each thread holds E keys
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

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpThreads = 128;  // threads of a block whose rows fit a warp
constexpr int kMaxWidth = 1 << 14;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Put a and b in ascending order (descending when !ascending).  For int32
// a min or a max chosen by a predicate (one IMNMX each); int64 has no
// such instruction, so one 64-bit compare decides a swap.
template <typename T>
__device__ __forceinline__ void order(T& a, T& b, bool ascending) {
  const T x = a;
  if constexpr (sizeof(T) == 4) {
    a = ascending ? min(x, b) : max(x, b);
    b = ascending ? max(x, b) : min(x, b);
  } else {
    const bool swap = (b < x) == ascending;
    a = swap ? b : x;
    b = swap ? x : b;
  }
}

// The smaller of v and o when keep_min, else the larger.
template <typename T>
__device__ __forceinline__ T keep(T v, T o, bool keep_min) {
  if constexpr (sizeof(T) == 4) {
    return keep_min ? min(v, o) : max(v, o);
  } else {
    return (o < v) == keep_min ? o : v;
  }
}

// One stage (compare distance `stride`) of the bitonic network over the
// E keys of every lane.  Key j of a lane sits at row offset
// wbase | lane * V | c(j), c(j) = (j / V) * 32V + j % V (wbase: the warp's
// first key in a row-aligned frame).  A pair sorts ascending when bit
// `dirc` of its offset is clear, descending when set, the whole reversed
// when `flip`.  The callers' loops unroll, so stride and dirc are
// compile-time constants here, and so are the register indices and
// c(j) & dirc: only the lane's and warp's share of the direction is
// computed, once per stage.
template <typename T, int E>
__device__ __forceinline__ void stage(T (&v)[E], int lane, int wbase, int dirc, bool flip, int stride) {
  constexpr int V = 16 / sizeof(T);
  const int tbit = (wbase & dirc) | ((lane * V) & dirc);
  if (stride < V || stride >= 32 * V) {
    const int r = stride < V ? stride : stride / 32;  // partner distance in registers
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & r) == 0) {
        const int c = (j / V) * 32 * V + j % V;
        order(v[j], v[j | r], ((tbit | (c & dirc)) == 0) != flip);
      }
    }
  } else {
    const int m = stride / V;  // partner lane distance
    const bool lower = (lane & m) == 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const T o = __shfl_xor_sync(kFull, v[j], m);
      const int c = (j / V) * 32 * V + j % V;
      const bool keep_min = lower == (((tbit | (c & dirc)) == 0) != flip);
      v[j] = keep(v[j], o, keep_min);
    }
  }
}

// Sort every aligned min(W, 32E)-key segment of the warp's keys: merges of
// size 2 .. min(W, 32E), each alternating in direction by its size bit
// except the merge of a whole row, which is ascending.
template <typename T, int E>
__device__ __forceinline__ void sort_tile(T (&v)[E], int lane, int wbase, int W) {
  constexpr int kLog = log2i(32 * E);
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
    if ((1 << ls) < W) {
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) stage(v, lane, wbase, 1 << ls, false, 1 << lt);
    } else if ((1 << ls) == W) {
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) stage(v, lane, wbase, 0, false, 1 << lt);
    }
  }
}

// The stages of stride < 32E of one merge of a block-wide row; its size
// is above the warp's keys, so one direction holds for the whole warp.
template <typename T, int E>
__device__ __forceinline__ void merge_tile(T (&v)[E], int lane, int wbase, bool descending) {
  constexpr int kLog = log2i(32 * E);
#pragma unroll
  for (int lt = kLog - 1; lt >= 0; --lt) stage(v, lane, wbase, 0, descending, 1 << lt);
}

// Key j of the lane lives at offset e0 + (j / V) * 32V + lane * V + j % V.
// Keys past n load as pad and are not stored.
template <typename T, int E>
__device__ __forceinline__ void load_keys(T (&v)[E], const T* __restrict__ x, long long e0, int lane,
                                          long long n, T pad, bool vec) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int jh = 0; jh < E / V; ++jh) {
    const long long g = e0 + jh * 32 * V + lane * V;
    if (vec && g + V <= n) {
      if constexpr (V == 4) {
        const int4 q = *reinterpret_cast<const int4*>(x + g);
        v[4 * jh] = q.x;
        v[4 * jh + 1] = q.y;
        v[4 * jh + 2] = q.z;
        v[4 * jh + 3] = q.w;
      } else {
        const longlong2 q = *reinterpret_cast<const longlong2*>(x + g);
        v[2 * jh] = q.x;
        v[2 * jh + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int jl = 0; jl < V; ++jl) v[jh * V + jl] = g + jl < n ? x[g + jl] : pad;
    }
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_keys(const T (&v)[E], T* __restrict__ y, long long e0, int lane,
                                           long long n, bool vec) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int jh = 0; jh < E / V; ++jh) {
    const long long g = e0 + jh * 32 * V + lane * V;
    if (vec && g + V <= n) {
      if constexpr (V == 4) {
        *reinterpret_cast<int4*>(y + g) = make_int4(v[4 * jh], v[4 * jh + 1], v[4 * jh + 2], v[4 * jh + 3]);
      } else {
        *reinterpret_cast<longlong2*>(y + g) = make_longlong2(v[2 * jh], v[2 * jh + 1]);
      }
    } else {
#pragma unroll
      for (int jl = 0; jl < V; ++jl) {
        if (g + jl < n) y[g + jl] = v[jh * V + jl];
      }
    }
  }
}

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

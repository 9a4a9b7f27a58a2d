// K4's register sort network, shared by the row sort (row_sort.cu) and
// the grouping kernel G (group.cu): the bitonic stages over E keys a
// lane in the warp-striped layout, a warp's whole sort of 32E keys, the
// in-register stages of a block-wide merge, and the 16-byte-vector loads
// and stores of that layout.  row_sort.cu's note sets out the design.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

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

}  // namespace

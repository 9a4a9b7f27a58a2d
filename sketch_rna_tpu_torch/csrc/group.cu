// G: group a batch's per-k event rows into top-C candidate tables in one
// launch, one warp a read.
//
// Replaces no TPU kernel: the JAX package groups in XLA
// (sketch_rna_tpu/match/rowmatch.py row_events_to_candidates,
// group_parts_per_k, combine_k_tables), and so does the port's plain
// chain (match/rowmatch.py group_event_parts_plain): two K4 sorts a k and
// some forty whole-row PyTorch operations (shifts, where, cummax, cumsum,
// max), each writing a [B, W] row to device memory and reading it back.
// At ks (21, 31) that chain held over half of a GENCODE sample's time.
//
// What it computes, exactly the plain chain's tables and stats:
//   - per read and k: the events' tids sorted, each run of one tid
//     counted, and a run passes iff count * q >= best * p in int32 (the
//     chain fraction's small p / q) or, without one, count >= f * best in
//     float32, best the k's largest count;
//   - one k: the passing tids' top C by (count desc, tid asc);
//   - several: each k's passing tids cut to their top C_k (C_k = min(2C,
//     W_k)); a tid meets iff it is in every k's non-empty table, its score
//     the sum of its counts; the top C of those;
//   - tid, score [B, C] int32 and mask [B, C] bool, 0 past the read's
//     candidates; stats[0] += the candidates past C, stats[1] += the
//     passing tids past C_k (integer atomics: exact in any order).
//
// Bound: device bytes.  Each k's row is read once (4 B a lane) and the
// tables written once (9 B a slot): at k = 31's [8192, 128] and C = 64,
// 8.9 MB, 2.7 us at 3.35 TB/s; at ks (21, 31) and [8192, 256] twice,
// 21.5 MB, 6.4 us.  The comparisons a sort needs (log2 W! a row) take
// under a tenth of that at the CUDA cores' integer rate.
//
// Design: a warp holds a read.  Each k's row loads into registers in
// K4's striped layout (E keys a lane, 32E >= W lanes, sentinels past W)
// and sorts there with K4's network (row_sort.cuh).  One store to the
// warp's shared memory turns it into a blocked layout (lane l holds lanes
// lE .. lE + E - 1): run starts and ends compare neighbours, the run
// counts come from a running start position and one warp max-scan, the
// best count from a warp reduce.  The passing runs, in tid order, are
// compacted into a shared list by a warp prefix sum.  The top C is a
// counting selection: the list is already in tid order, so the entries
// of one count take ranks in list order, and one ballot pass a distinct
// count (highest first, stopping at C ranks) places them; counts in a row
// of W lanes take at most sqrt(2W) distinct values.  Several ks: the first
// non-empty k's kept entries are the base list; each later k's kept
// entries binary-search it and add their count and a hit.  No block
// barrier: a block's warps are independent reads.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "row_sort.cuh"

namespace {

constexpr int kMaxKs = 16;               // group.py's MAX_KS
constexpr int kBlockWarps = 4;
constexpr int kBlockShared = 48 * 1024;  // bytes a block takes without an opt-in
constexpr int kScoreBits = 24;           // a base entry: score | hits << kScoreBits
constexpr int kScoreMask = (1 << kScoreBits) - 1;
constexpr int kKept = 1 << 30;           // a work entry within its k's top C_k

struct Parts {
  const int* key[kMaxKs];  // [B, width[k]] int32 event rows, INT_MAX past a read's events
  int width[kMaxKs];
  int cap[kMaxKs];  // C_k (several ks)
};

// The int32 chain test: q > 0 compares count * q >= best * p with int32
// wrap-around, as PyTorch's int32 tensors do; else the float32 product.
struct Chain {
  int p;
  int q;
  float f;
};

__device__ __forceinline__ bool passes(int count, int best, const Chain& c) {
  if (c.q > 0) {
    return static_cast<int>(static_cast<unsigned>(count) * static_cast<unsigned>(c.q)) >=
           static_cast<int>(static_cast<unsigned>(best) * static_cast<unsigned>(c.p));
  }
  return static_cast<float>(count) >= __fmul_rn(c.f, static_cast<float>(best));
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ int warp_exclusive_sum(int x, int lane) {
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += t;
  }
  return inc - x;
}

// The largest x of the lanes below this one (-1 for lane 0).
__device__ __forceinline__ int warp_exclusive_max(int x, int lane) {
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, t);
  }
  const int below = __shfl_up_sync(kFull, inc, 1);
  return lane ? below : -1;
}

// Sort one k's row of W lanes (at row, W <= 32E) and write its passing
// runs, (tid, count) in ascending tid order, to the work list wt / ws (32E
// entries each; wt doubles as the sorted row's staging).  Returns their
// number.
template <int E>
__device__ int passing_runs(const int* __restrict__ row, int W, int* wt, int* ws, int lane, const Chain& chain) {
  const bool vec = reinterpret_cast<uintptr_t>(row) % 16 == 0 && W % 4 == 0;
  int v[E];
  load_keys(v, row, 0, lane, W, INT_MAX, vec);
  sort_tile(v, lane, 0, 32 * E);
  __syncwarp();  // the previous k's list reads are done
  store_keys(v, wt, 0, lane, 32 * E, true);
  __syncwarp();
  if (wt[0] == INT_MAX) return 0;  // no event at this k
  const int p0 = lane * E;
  int key[E];
#pragma unroll
  for (int j = 0; j < E; j += 4) {
    const int4 q = *reinterpret_cast<const int4*>(wt + p0 + j);
    key[j] = q.x;
    key[j + 1] = q.y;
    key[j + 2] = q.z;
    key[j + 3] = q.w;
  }
  const int prev = lane ? wt[p0 - 1] : -1;
  const int next = lane < 31 ? wt[p0 + E] : INT_MAX;
  // start[j]: the latest run start at or before lane p0 + j in this lane
  // (-1 before the first); ends: bit j set where a run ends.
  int start[E];
  unsigned ends = 0;
  int last = -1;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int before = j ? key[j - 1] : prev;
    const int after = j + 1 < E ? key[j + 1] : next;
    const bool valid = key[j] != INT_MAX;
    if (valid && key[j] != before) last = p0 + j;
    start[j] = last;
    if (valid && key[j] != after) ends |= 1u << j;
  }
  const int carry = warp_exclusive_max(last, lane);
  int best = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    start[j] = p0 + j - max(start[j], carry) + 1;  // the count, at a run's end
    if (ends >> j & 1u) best = max(best, start[j]);
  }
  best = __reduce_max_sync(kFull, best);
  unsigned meets = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if ((ends >> j & 1u) && passes(start[j], best, chain)) meets |= 1u << j;
  }
  const int mine = __popc(meets);
  int at = warp_exclusive_sum(mine, lane);
  const int n = __shfl_sync(kFull, at + mine, 31);
  __syncwarp();  // every lane has read its keys from wt
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (meets >> j & 1u) {
      wt[at] = key[j];
      ws[at] = start[j];
      ++at;
    }
  }
  __syncwarp();
  return n;
}

// The entries i < n of a list in ascending tid order whose eligible(i)
// holds, ranked by (score desc, tid asc), score = sc[i] & kScoreMask >= 1:
// emit(i, rank) for every rank below cap.  Entry i is lane i % 32's
// (slot i / 32; n <= 32E).  Returns the number of eligible entries.
template <int E, typename Eligible, typename Emit>
__device__ __forceinline__ int select_top(const int* sc, int n, int cap, int lane, Eligible eligible, Emit emit) {
  int top = 0, total = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j * 32 >= n) break;
    const int i = j * 32 + lane;
    const bool e = i < n && eligible(i);
    total += __popc(__ballot_sync(kFull, e));
    if (e) top = max(top, sc[i] & kScoreMask);
  }
  int s = __reduce_max_sync(kFull, top);
  int taken = 0;
  while (s > 0 && taken < cap) {  // one pass a distinct score, highest first
    int below = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j * 32 >= n) break;
      const int i = j * 32 + lane;
      const int v = i < n && eligible(i) ? sc[i] & kScoreMask : 0;
      const unsigned hit = __ballot_sync(kFull, v == s);
      if (v == s) {
        const int rank = taken + __popc(hit & lanes_below(lane));
        if (rank < cap) emit(i, rank);
      }
      taken += __popc(hit);
      if (v < s) below = max(below, v);
    }
    s = __reduce_max_sync(kFull, below);
  }
  return total;
}

// Lower bound of t in the ascending list bt[0, n).
__device__ __forceinline__ int lower_bound(const int* bt, int n, int t) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (bt[lo + half] < t) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Shared memory a warp: the work list (32E tids, 32E scores), then at
// several ks the base list (list_cap tids, list_cap scores).
template <int E>
__global__ void __launch_bounds__(32 * kBlockWarps)
    group_kernel(Parts parts, int K, int B, int C, int list_cap, Chain chain, int* __restrict__ out_tid,
                 int* __restrict__ out_score, bool* __restrict__ out_mask, unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // a whole warp: no barrier follows
  int* wt = reinterpret_cast<int*>(smem_raw) + warp * (64 * E + 2 * list_cap);
  int* ws = wt + 32 * E;
  int* bt = ws + 32 * E;
  int* bs = bt + list_cap;
  int* tid = out_tid + row * C;
  int* score = out_score + row * C;
  bool* mask = out_mask + row * C;
  auto put = [&](int t, int s, int rank) {
    tid[rank] = t;
    score[rank] = s;
    mask[rank] = true;
  };
  int found;  // the read's candidates before the cut at C
  unsigned long long spilled_k = 0;
  if (K == 1) {
    const int n = passing_runs<E>(parts.key[0] + row * parts.width[0], parts.width[0], wt, ws, lane, chain);
    found = select_top<E>(
        ws, n, C, lane, [](int) { return true; }, [&](int i, int rank) { put(wt[i], ws[i], rank); });
  } else {
    int nb = -1;    // the base list's length; -1 until a k has events
    int others = 0;  // the non-empty ks after the base
    for (int k = 0; k < K; ++k) {
      const int W = parts.width[k];
      const int n = passing_runs<E>(parts.key[k] + row * W, W, wt, ws, lane, chain);
      if (n == 0) continue;  // a k without events passes vacuously
      const int cap = parts.cap[k];
      const bool all = n <= cap;
      if (!all) {
        spilled_k += n - cap;
        select_top<E>(
            ws, n, cap, lane, [](int) { return true; }, [&](int i, int) { ws[i] |= kKept; });
        __syncwarp();
      }
      if (nb < 0) {  // the base: this k's kept entries, in tid order
        nb = 0;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (j * 32 >= n) break;
          const int i = j * 32 + lane;
          const bool kept = i < n && (all || (ws[i] & kKept));
          const unsigned m = __ballot_sync(kFull, kept);
          if (kept) {
            const int at = nb + __popc(m & lanes_below(lane));
            bt[at] = wt[i];
            bs[at] = ws[i] & kScoreMask;
          }
          nb += __popc(m);
        }
      } else {  // each kept entry meets its tid in the base at most once
        ++others;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (j * 32 >= n) break;
          const int i = j * 32 + lane;
          if (i < n && (all || (ws[i] & kKept))) {
            const int at = lower_bound(bt, nb, wt[i]);
            if (at < nb && bt[at] == wt[i]) bs[at] += (ws[i] & kScoreMask) + (1 << kScoreBits);
          }
        }
      }
      __syncwarp();
    }
    found = nb < 0 ? 0
                   : select_top<E>(
                         bs, nb, C, lane, [&](int i) { return (bs[i] >> kScoreBits) == others; },
                         [&](int i, int rank) { put(bt[i], bs[i] & kScoreMask, rank); });
  }
  for (int r = min(found, C) + lane; r < C; r += 32) {
    tid[r] = 0;
    score[r] = 0;
    mask[r] = false;
  }
  if (lane == 0) {
    if (found > C) atomicAdd(&stats[0], static_cast<unsigned long long>(found - C));
    if (spilled_k) atomicAdd(&stats[1], spilled_k);
  }
}

template <int E>
cudaError_t launch(const Parts& parts, int K, int B, int C, int list_cap, const Chain& chain, void* tid, void* score,
                   void* mask, void* stats, cudaStream_t st) {
  const int warp_bytes = 4 * (64 * E + 2 * list_cap);
  const int warps = std::max(1, std::min(kBlockWarps, kBlockShared / warp_bytes));
  const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
  group_kernel<E><<<blocks, 32 * warps, warps * warp_bytes, st>>>(
      parts, K, B, C, list_cap, chain, static_cast<int*>(tid), static_cast<int*>(score), static_cast<bool*>(mask),
      static_cast<unsigned long long*>(stats));
  return cudaGetLastError();
}

}  // namespace

// keys, widths, caps: host arrays of K (1 <= K <= 16) device pointers to
// [B, widths[k]] int32 rows, their widths (powers of two, 2 to 1024) and,
// at K > 1, each k's table size C_k.  p, q, f: the chain test (q > 0: the
// int32 one).  tid, score: [B, C] int32; mask: [B, C] bool; stats: [2]
// int64, zeroed by the caller.
extern "C" int group_launch(const void* const* keys, const int* widths, const int* caps, int K, int B, int C, int p,
                            int q, float f, void* tid, void* score, void* mask, void* stats, void* stream) {
  if (K < 1 || K > kMaxKs || B < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Parts parts{};
  int widest = 0, list_cap = 0;
  for (int k = 0; k < K; ++k) {
    parts.key[k] = static_cast<const int*>(keys[k]);
    parts.width[k] = widths[k];
    parts.cap[k] = K > 1 ? caps[k] : 0;
    if (widths[k] < 2 || widths[k] > 1024 || (widths[k] & (widths[k] - 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    widest = std::max(widest, widths[k]);
    if (K > 1) list_cap = std::max(list_cap, caps[k]);
  }
  list_cap = (list_cap + 3) & ~3;  // keep each warp's lists 16-byte aligned
  const Chain chain{p, q, f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (widest <= 128) {
    e = launch<4>(parts, K, B, C, list_cap, chain, tid, score, mask, stats, st);
  } else if (widest <= 256) {
    e = launch<8>(parts, K, B, C, list_cap, chain, tid, score, mask, stats, st);
  } else if (widest <= 512) {
    e = launch<16>(parts, K, B, C, list_cap, chain, tid, score, mask, stats, st);
  } else {
    e = launch<32>(parts, K, B, C, list_cap, chain, tid, score, mask, stats, st);
  }
  return static_cast<int>(e);
}

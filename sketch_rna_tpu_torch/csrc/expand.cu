// E: posting expansion.  For every row b of a [B, S] batch of posting
// runs (start, length), int64, one per sketch lane as the probe P leaves
// them, the row's events as int32 tids in probe order: lane j of the
// [B, W] output holds postings[start[s] + j - begin[s]], s the run whose
// events [begin[s], begin[s] + length[s]) hold j (begin the exclusive
// prefix sum of the row's lengths), and INT32_MAX past the row's events.
// The caller sizes W (a power of two) to the batch's largest row, so no
// event falls past it.
//
// No TPU kernel has this job: the JAX package expands in XLA
// (sketch_rna_tpu/match/rowmatch.py row_expand_from_runs, :74-120, at
// k_index 0 and num_k 1), with static shapes: every lane of a [B, Epr]
// row finds its run by comparing against the row's cumulative run ends,
// then one gather.  This kernel keeps that formulation, so a batch's
// expansion has static shapes and allocates nothing, and a step that holds
// it can be captured in a CUDA graph (utils/step_graphs.py).  Its plain
// version is match/expand.py row_expand_plain (cumsum, searchsorted,
// gather).
//
// Bound: device bytes.  Each run's length is read once (8 bytes a lane
// of [B, S]), the start only of a run that holds an event (in 32-byte
// sectors), each output lane written once (4 bytes), and a valid lane
// gathers one 4-byte posting (utils/roofline.py expand_work).
//
// Design (simple first): one block of 256 threads a row.  The block
// stages the row's inclusive run ends in shared memory, kTile runs at a
// time (a thread scans kPer consecutive runs, a warp scan of the threads'
// sums, then the warps' totals), so any S fits; each lane j of the tile's
// events then finds its run by a binary search over the tile's ends and
// gathers its posting.  Lanes past the row's events are written without a
// read.  A row of W lanes is stored by its 256 threads side by side
// (coalesced); the posting gathers are random by nature.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                 // runs a thread scans in a tile
constexpr int kTile = kThreads * kPer;  // runs staged at a time: 16 KB of int64 ends
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    row_expand_kernel(const long long* __restrict__ start, const long long* __restrict__ length,
                      const int32_t* __restrict__ postings, int32_t* __restrict__ key, int S, int W) {
  __shared__ long long ends[kTile];
  __shared__ long long warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const long long* st = start + row * S;
  const long long* ln = length + row * S;
  int32_t* out = key + row * W;
  long long carry = 0;  // the row's events in the tiles before this one
  for (int t0 = 0; t0 < S && carry < W; t0 += kTile) {
    const int n = min(kTile, S - t0);
    const int first = threadIdx.x * kPer;
    long long v[kPer];
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      sum += first + i < n ? ln[t0 + first + i] : 0;
      v[i] = sum;  // inclusive within the thread's runs
    }
    long long incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    long long base = carry + incl - sum;  // events before this thread's runs
    for (int w = 0; w < warp; ++w) base += warp_total[w];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (first + i < n) ends[first + i] = base + v[i];
    }
    __syncthreads();
    const long long tile_end = ends[n - 1];
    const long long stop = tile_end < W ? tile_end : static_cast<long long>(W);
    for (long long j = carry + threadIdx.x; j < stop; j += kThreads) {
      int lo = 0, hi = n - 1;  // the tile's first run whose end passes j
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ends[mid] > j) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      const long long begin = lo ? ends[lo - 1] : carry;
      out[j] = postings[st[t0 + lo] + (j - begin)];
    }
    carry = tile_end;
    __syncthreads();  // the next tile rewrites ends and warp_total
  }
  for (long long j = carry + threadIdx.x; j < W; j += kThreads) out[j] = INT_MAX;
}

}  // namespace

// start, length [B, S] int64, postings [P] int32 -> key [B, W] int32.
extern "C" int row_expand_launch(const void* start, const void* length, const void* postings, void* key, int B,
                                 int S, int W, void* stream) {
  if (B > 0 && W > 0) {
    row_expand_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(start), static_cast<const long long*>(length),
        static_cast<const int32_t*>(postings), static_cast<int32_t*>(key), S, W);
  }
  return static_cast<int>(cudaGetLastError());
}

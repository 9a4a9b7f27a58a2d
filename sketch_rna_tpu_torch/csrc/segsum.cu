// S: the EM's per-transcript sum over a segmented-sum plan, with a fixed
// addition order.  Given values v [n] in the EM's flat lane order and the
// plan of em/segsum.py (perm [n_pad] int32, is_start [nblk, 512] bool,
// seg_end [T] int32, seg_live [T] bool, carry_tid [nblk] int32, carry_on
// [nblk] bool), ps[t] = the sum of v over the lanes of transcript t, for
// float64, float32 and int32 values.
//
// No TPU kernel has this job: the JAX package computes it in XLA
// (sketch_rna_tpu/em/segsum.py segsum_apply: a gather, an associative
// scan and a small scatter), behind --em-segsum on.  Its plain version is
// em/segsum.py segsum_plain, which follows the addition tree below step
// for step, so the two agree bit for bit.
//
// Bound: device bytes.  Each value, perm entry and is_start flag is read
// once (v, 4 + 1 bytes a lane), seg_end and seg_live once and ps written
// once a transcript; one addition a lane.  The gather v[perm] is random:
// on the c3 EM's lanes (33 MB of float64 values) the 50 MB L2 serves it,
// and it is the floor.
//
// Design: one fixed tree, no atomics, at most four launches.  Every level
// is the same block scan (block_scan below) of THREADS x PER elements:
// each thread sums its PER elements serially (a segmented sum: a start
// flag restarts it), a warp scans its 32 thread totals with five
// __shfl_up_sync steps and no barrier, the warp totals go through shared
// memory with one barrier, each thread folds the totals of the warps
// before its own (left to right), and a fix-up adds the carry to the
// thread's elements before its first start.
//   1. segsum_scan_kernel: a block of 128 threads per plan block of 512
//      sorted lanes, 4 lanes a thread (one 16-byte perm load, one 32-bit
//      word of is_start flags, four independent value gathers).  A lane
//      that ends its run in the block stores its partial to q.
//   2. segsum_carry_kernel: the blocks' last partials, chained by
//      carry_on / carry_tid, are a segmented sequence of their own, scanned
//      512 to a block in the same way.  A block without carry_on enters as
//      a zero; a run starts at block b unless carry_on[b - 1], carry_on[b]
//      and carry_tid[b - 1] == carry_tid[b].  Each element's scan goes to
//      s1, and a flag says whether its run reaches back to its carry
//      block's first element.
//   3. segsum_top_kernel: one block scans the carry blocks' totals into
//      s2: 128 x 4 up to 512 of them (n_pad up to 2^27), else 1024 x 8
//      (at most 8,192: n_pad < 2^31).
//   4. segsum_final_kernel: one thread a transcript, coalesced: ps[t] =
//      q[seg_end[t]] + the carry total at b = seg_end[t] / 512 - 1, taken
//      when carry_on[b] and carry_tid[b] == t; that total is s1[b], plus
//      s2 of the previous carry block when the run reaches back past
//      its own.  An O(1) test where the previous design searched.
// Launches 2 and 3 run only when there is more than one block to carry
// across.  On the c3 EM's 4,113,920 padded lanes: 8,035 plan blocks, 16
// carry blocks, one top block.  So a result is bit-identical from run to
// run, where index_add_'s atomics add in the order the hardware happens to
// take.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;        // lanes of a plan block, elements of a carry block
constexpr int kScanThreads = 128;  // 4 elements a thread
constexpr int kTopThreads = 1024;  // the top level past 512 carry blocks, 8 elements a thread
constexpr int kTopPer = 8;

// The segmented inclusive scan of a block's THREADS x PER elements, PER
// consecutive ones a thread in x, their start flags a bit each in starts.
// On return x holds each element's partial from its run's start (or the
// block's first element); the result has bit r set when element r's run
// reaches back to the block's first element.  em/segsum.py _block_scan
// is the same tree in whole-tensor steps.
template <typename T, int THREADS, int PER>
__device__ __forceinline__ unsigned block_scan(T (&x)[PER], unsigned starts, T* s_val, int* s_flag) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 1; r < PER; ++r) {
    if (!((starts >> r) & 1u)) x[r] = x[r - 1] + x[r];
  }
  T a = x[PER - 1];
  int f = starts != 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T al = __shfl_up_sync(0xffffffffu, a, d);
    const int fl = __shfl_up_sync(0xffffffffu, f, d);
    if (lane >= d) {
      if (!f) a = al + a;
      f |= fl;
    }
  }
  const T ea = __shfl_up_sync(0xffffffffu, a, 1);  // the warp's threads before this one
  const int ef = __shfl_up_sync(0xffffffffu, f, 1);
  if (lane == 31) {
    s_val[warp] = a;
    s_flag[warp] = f;
  }
  __syncthreads();
  T ca = T(0);  // the warps before this one
  int cf = 0;
  if (warp > 0) {
    ca = s_val[0];
    cf = s_flag[0];
    for (int u = 1; u < warp; ++u) {
      const T wu = s_val[u];
      const int fu = s_flag[u];
      ca = fu ? wu : ca + wu;
      cf |= fu;
    }
  }
  T carry = ca;  // into this thread, from the block's elements before it
  int pf = cf;
  bool has = warp > 0;
  if (lane > 0) {
    carry = (!ef && warp > 0) ? ca + ea : ea;
    pf = ef | cf;
    has = true;
  }
  unsigned reach = 0;
  unsigned seen = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    seen |= (starts >> r) & 1u;
    if (!seen) {
      if (has) x[r] = carry + x[r];
      if (!pf) reach |= 1u << r;
    }
  }
  return reach;
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    segsum_scan_kernel(const T* __restrict__ v, int n, const int* __restrict__ perm,
                       const uint8_t* __restrict__ is_start, T* __restrict__ q) {
  __shared__ T s_val[kScanThreads / 32];
  __shared__ int s_flag[kScanThreads / 32];
  const int tid = threadIdx.x;
  const long long g = static_cast<long long>(blockIdx.x) * kBlock + 4 * tid;
  const int4 p = *reinterpret_cast<const int4*>(perm + g);
  const unsigned word = *reinterpret_cast<const unsigned*>(is_start + g);
  T x[4];
  x[0] = p.x < n ? v[p.x] : T(0);
  x[1] = p.y < n ? v[p.y] : T(0);
  x[2] = p.z < n ? v[p.z] : T(0);
  x[3] = p.w < n ? v[p.w] : T(0);
  unsigned starts = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) starts |= ((word >> (8 * r)) & 0xffu) ? 1u << r : 0u;
  block_scan<T, kScanThreads, 4>(x, starts, s_val, s_flag);
  const bool last_ends = tid == kScanThreads - 1 || is_start[g + 4] != 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r < 3 ? ((starts >> (r + 1)) & 1u) : last_ends) q[g + r] = x[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    segsum_carry_kernel(const T* __restrict__ q, const int* __restrict__ carry_tid,
                        const uint8_t* __restrict__ carry_on, int nblk, T* __restrict__ s1,
                        uint8_t* __restrict__ reach1) {
  __shared__ T s_val[kScanThreads / 32];
  __shared__ int s_flag[kScanThreads / 32];
  const int b0 = blockIdx.x * kBlock + 4 * threadIdx.x;
  T x[4];
  unsigned starts = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + r;
    const bool on = b < nblk && carry_on[b];
    x[r] = on ? q[static_cast<long long>(b) * kBlock + kBlock - 1] : T(0);
    const bool cont = on && b > 0 && carry_on[b - 1] && carry_tid[b - 1] == carry_tid[b];
    starts |= cont ? 0u : 1u << r;
  }
  const unsigned reach = block_scan<T, kScanThreads, 4>(x, starts, s_val, s_flag);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (b0 + r < nblk) {
      s1[b0 + r] = x[r];
      reach1[b0 + r] = (reach >> r) & 1u;
    }
  }
}

template <typename T, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS)
    segsum_top_kernel(const T* __restrict__ s1, const uint8_t* __restrict__ reach1, int nblk, int nblk1,
                      T* __restrict__ s2) {
  __shared__ T s_val[THREADS / 32];
  __shared__ int s_flag[THREADS / 32];
  const int c0 = PER * threadIdx.x;
  T x[PER];
  unsigned starts = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int c = c0 + r;
    const int last = min(c * kBlock + kBlock - 1, nblk - 1);  // carry block c's total
    x[r] = c < nblk1 ? s1[last] : T(0);
    starts |= (c >= nblk1 || !reach1[last]) ? 1u << r : 0u;
  }
  block_scan<T, THREADS, PER>(x, starts, s_val, s_flag);
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    if (c0 + r < nblk1) s2[c0 + r] = x[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    segsum_final_kernel(const T* __restrict__ q, const T* __restrict__ s1, const uint8_t* __restrict__ reach1,
                        const T* __restrict__ s2, const int* __restrict__ seg_end,
                        const uint8_t* __restrict__ seg_live, const int* __restrict__ carry_tid,
                        const uint8_t* __restrict__ carry_on, T* __restrict__ ps, int T_) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T_) return;
  if (!seg_live[t]) {
    ps[t] = T(0);
    return;
  }
  const int e = seg_end[t];
  T acc = q[e];
  const int b = e / kBlock - 1;  // the block before t's last one
  if (b >= 0 && carry_on[b] && carry_tid[b] == t) {
    T total = s1[b];
    const int c = b / kBlock;
    if (c > 0 && reach1[b]) total = s2[c - 1] + total;
    acc = acc + total;
  }
  ps[t] = acc;
}

template <typename T>
int launch_segsum(const void* v, int n, const void* perm, const void* is_start, const void* seg_end,
                  const void* seg_live, const void* carry_tid, const void* carry_on, void* scratch, void* flags,
                  void* ps, int nblk, int T_, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* q = static_cast<T*>(scratch);
  T* s1 = q + static_cast<long long>(nblk) * kBlock;
  T* s2 = s1 + nblk;
  uint8_t* reach1 = static_cast<uint8_t*>(flags);
  const int* ctid = static_cast<const int*>(carry_tid);
  const uint8_t* con = static_cast<const uint8_t*>(carry_on);
  const int nblk1 = (nblk + kBlock - 1) / kBlock;
  if (nblk1 > kTopThreads * kTopPer) return static_cast<int>(cudaErrorInvalidValue);
  if (nblk > 0) {
    segsum_scan_kernel<T><<<nblk, kScanThreads, 0, s>>>(static_cast<const T*>(v), n, static_cast<const int*>(perm),
                                                        static_cast<const uint8_t*>(is_start), q);
  }
  if (nblk > 1) {
    segsum_carry_kernel<T><<<nblk1, kScanThreads, 0, s>>>(q, ctid, con, nblk, s1, reach1);
  }
  if (nblk1 > kBlock) {
    segsum_top_kernel<T, kTopThreads, kTopPer><<<1, kTopThreads, 0, s>>>(s1, reach1, nblk, nblk1, s2);
  } else if (nblk1 > 1) {  // up to 512 carry blocks (n_pad <= 2^27): the lane scan's shape
    segsum_top_kernel<T, kScanThreads, 4><<<1, kScanThreads, 0, s>>>(s1, reach1, nblk, nblk1, s2);
  }
  if (T_ > 0) {
    segsum_final_kernel<T><<<(T_ + 255) / 256, 256, 0, s>>>(q, s1, reach1, s2, static_cast<const int*>(seg_end),
                                                            static_cast<const uint8_t*>(seg_live), ctid, con,
                                                            static_cast<T*>(ps), T_);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v [n] values in flat lane order; the plan's arrays (nblk blocks of 512
// lanes, T transcripts; perm 16-byte and is_start 4-byte aligned);
// scratch [nblk * 512 + nblk + ceil(nblk / 512)] of v's type; flags
// [nblk] bytes; ps [T].
#define SEGSUM_ENTRY(name, T)                                                                                   \
  extern "C" int name(const void* v, int n, const void* perm, const void* is_start, const void* seg_end,       \
                      const void* seg_live, const void* carry_tid, const void* carry_on, void* scratch,        \
                      void* flags, void* ps, int nblk, int T_, void* stream) {                                  \
    return launch_segsum<T>(v, n, perm, is_start, seg_end, seg_live, carry_tid, carry_on, scratch, flags, ps,   \
                            nblk, T_, stream);                                                                  \
  }

SEGSUM_ENTRY(segsum_f64_launch, double)
SEGSUM_ENTRY(segsum_f32_launch, float)
SEGSUM_ENTRY(segsum_i32_launch, int)

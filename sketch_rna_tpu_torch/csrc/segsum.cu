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
// once a transcript.  The gather v[perm] is random: on the c3 EM's lanes
// that is the term that matters, as it was on the TPU.
//
// Design: two launches, no atomics.  Pass 1 gives each plan block of 512
// sorted lanes a block of 512 threads.  Thread i loads v[perm[i]] (0 for
// a pad lane) and its run-start flag, then runs a segmented inclusive
// Hillis-Steele scan over the whole block: at step d (1, 2, .., 256) a
// lane whose run does not start within its window takes left + self,
// left being lane i - d, and ORs in lane i - d's flag.  Lane i - d lies in
// another warp for the first lanes of every warp at every step, so each
// step goes through shared memory between two barriers (warp shuffles
// cannot reach across warps).  Every addition combines lanes of one run,
// and the tree is the same on every call.  A lane that ends its run in
// the block (the next lane starts a run, or it is the block's last)
// stores its partial to a scratch row.  Pass 2 gives
// each transcript a warp: ps[t] = the partial at seg_end[t], plus, when
// the run began in an earlier block, the sum of the earlier blocks' last
// partials (the chain of blocks whose carry_on is set for t, its first
// block found by a binary search), taken pairwise in a fixed tree over
// the chain's positions, 32 positions a step, so the plain version
// computes it with a few whole-tensor steps.  A transcript with a
// million lanes spans ~2,000 blocks; walked one block at a time by one
// thread, such chains made a call on the c3 EM's 4.1M lanes take 3.7 ms
// on an H100.  So a result is bit-identical from run to run, where
// index_add_'s atomics add in the order the hardware happens to take.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;

template <typename T>
__global__ void __launch_bounds__(kBlock)
    segsum_scan_kernel(const T* __restrict__ v, int n, const int* __restrict__ perm,
                       const uint8_t* __restrict__ is_start, T* __restrict__ q) {
  __shared__ T s_v[kBlock];
  __shared__ int s_f[kBlock];
  const int i = threadIdx.x;
  const long long g = static_cast<long long>(blockIdx.x) * kBlock + i;
  const int p = perm[g];
  T x = p < n ? v[p] : T(0);
  int f = is_start[g];
#pragma unroll
  for (int d = 1; d < kBlock; d <<= 1) {
    s_v[i] = x;
    s_f[i] = f;
    __syncthreads();
    if (i >= d) {
      const T xl = s_v[i - d];
      const int fl = s_f[i - d];
      if (!f) x = xl + x;
      f |= fl;
    }
    __syncthreads();
  }
  if (i == kBlock - 1 || is_start[g + 1]) q[g] = x;
}

// One warp per transcript t (32 transcripts a block of 256 threads).
template <typename T>
__global__ void __launch_bounds__(256)
    segsum_gather_kernel(const T* __restrict__ q, const int* __restrict__ seg_end,
                         const uint8_t* __restrict__ seg_live, const int* __restrict__ carry_tid,
                         const uint8_t* __restrict__ carry_on, T* __restrict__ ps, int T_) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= T_) return;  // the whole warp
  if (!seg_live[t]) {
    if (lane == 0) ps[t] = T(0);
    return;
  }
  const int e = seg_end[t];
  const int b_end = e / kBlock;
  // The chain's first block: blocks [b0, b_end) carry t into the next,
  // and every block below b0 ends on a smaller transcript, so
  // "carry_on[b] and carry_tid[b] >= t" is false below b0 and true from
  // it: a binary search.
  int lo = 0;
  int hi = b_end;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (carry_on[mid] && carry_tid[mid] >= t) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (lo == b_end) {
    if (lane == 0) ps[t] = q[e];
    return;
  }
  // The chain's carries summed pairwise, as a tree over their positions
  // padded with zeros to a power of two.  The warp reduces 32 positions
  // at a time (levels 0 .. 4, left + right by shuffles; missing positions
  // are zeros, which add nothing); lane 0 keeps a binary counter of the
  // resulting level-5 partials, then folds them from the right, the last
  // first.
  T part[32];
  int level[32];
  int top = 0;
  for (int c0 = lo; c0 < b_end; c0 += 32) {
    const int b = c0 + lane;
    T x = b < b_end ? q[static_cast<long long>(b) * kBlock + kBlock - 1] : T(0);
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const T y = __shfl_down_sync(0xffffffffu, x, s);
      if ((lane & (2 * s - 1)) == 0) x = x + y;
    }
    if (lane == 0) {
      int l = 5;
      while (top > 0 && level[top - 1] == l) {
        x = part[--top] + x;
        ++l;
      }
      part[top] = x;
      level[top++] = l;
    }
  }
  if (lane == 0) {
    T chain = part[--top];
    while (top > 0) chain = part[--top] + chain;
    ps[t] = q[e] + chain;
  }
}

template <typename T>
int launch_segsum(const void* v, int n, const void* perm, const void* is_start, const void* seg_end,
                  const void* seg_live, const void* carry_tid, const void* carry_on, void* scratch, void* ps,
                  int nblk, int T_, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* q = static_cast<T*>(scratch);
  if (nblk > 0) {
    segsum_scan_kernel<T><<<nblk, kBlock, 0, s>>>(static_cast<const T*>(v), n, static_cast<const int*>(perm),
                                                  static_cast<const uint8_t*>(is_start), q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (T_ > 0) {
    constexpr int kWarps = 8;  // transcripts a block
    segsum_gather_kernel<T><<<(T_ + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
        q, static_cast<const int*>(seg_end), static_cast<const uint8_t*>(seg_live),
        static_cast<const int*>(carry_tid), static_cast<const uint8_t*>(carry_on), static_cast<T*>(ps), T_);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v [n] values in flat lane order; the plan's arrays (nblk blocks of 512
// lanes, T transcripts); scratch [nblk * 512] of v's type; ps [T].
#define SEGSUM_ENTRY(name, T)                                                                                      \
  extern "C" int name(const void* v, int n, const void* perm, const void* is_start, const void* seg_end,          \
                      const void* seg_live, const void* carry_tid, const void* carry_on, void* scratch, void* ps, \
                      int nblk, int T_, void* stream) {                                                            \
    return launch_segsum<T>(v, n, perm, is_start, seg_end, seg_live, carry_tid, carry_on, scratch, ps, nblk, T_,   \
                            stream);                                                                               \
  }

SEGSUM_ENTRY(segsum_f64_launch, double)
SEGSUM_ENTRY(segsum_f32_launch, float)
SEGSUM_ENTRY(segsum_i32_launch, int)

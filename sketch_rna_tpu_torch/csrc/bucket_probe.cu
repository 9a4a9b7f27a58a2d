// P: the bucketed index probe.  For every lane of a contiguous [B, S]
// batch of sketch hashes (int64 holding uint32 values) with its bool
// mask, the posting run (start, length) of the hash in one k's packed
// bucket table [nb, 3 * mb] int32, a row per bucket laid out as
// [key bits (mb) | start (mb) | length (mb)]; (0, 0) for a masked lane or
// a hash the table does not hold.  Unused key slots hold -1 with start
// and length 0, and a lane's result is the sum over every slot whose key
// equals its hash, so a hash of 0xFFFFFFFF (the -1 bits) that also
// matches empty slots adds only zeros.
//
// No TPU kernel has this job: the JAX package probes in XLA
// (sketch_rna_tpu/match/bucket_lookup.py bucket_lookup, a [B, S, 3 * mb]
// row gather, a compare and two masked sums).  Its plain version is
// match/bucket_lookup.py bucket_lookup_plain, which computes just that.
//
// Bound: device bytes.  Each lane's mask is read and its start and
// length written (17 bytes); a masked-in lane also needs its 8-byte hash
// (whole 32-byte sectors of them: 4 lanes a sector), the key part of its
// bucket row (4 * mb bytes) and, on a hit, its 8-byte run.  At [8192, 32]
// with ~4 of 32 lanes a read masked in, the 17 bytes a lane dominate.
//
// Design.  The TPU gathers whole 3 * mb rows because its vector unit
// wants 128-lane tiles; here a probe reads only what it needs, and the
// probes of a block run side by side.  A block of 256 threads takes 256
// consecutive lanes, one a thread: it loads their masks coalesced, and
// the hashes of the masked-in lanes only, and compacts the masked-in
// lanes into a queue in shared memory (a ballot and popc a warp, then a
// prefix over the block's 8 warp counts).  Each queue entry is then
// probed by a group of G = 4 threads (the most probes in flight; 4 beat 8
// and 16 at both main-path widths on an H100, PERF.md §6; 32 registers a
// thread keep 8 blocks on an SM): thread j of the group issues all of its
// key loads (slots j, j + G, ..; 4-byte loads, coalesced across the
// group, since a row starts at 12 * mb bytes) before it compares any, one
// pass covering G * kPer >= 42 slots (the widest row the builder's bucket
// merging makes, 3 * mb <= 128; a deeper first histogram, keys clustered
// under one large key, takes more passes), a thread whose slot matches
// reads that slot's start and length, and a reduction over the group's
// lanes sums them.  The group's first thread puts the run into shared
// memory at its lane's place, and after one barrier every lane stores its
// int64 (start, length) coalesced.  So a block's dependent chain is mask
// and hash -> keys -> run -> store, however many of its lanes are masked
// in: at [8192, 32] (~28 entries a block) each group probes once; at
// [8191, 160] (~156) a group of 4 takes ~3 entries in turn, and the 8
// blocks an SM holds keep the other groups' loads in flight meanwhile.
// What holds it then, by reckoning (no profiler reads counters on the
// card's machine): at [8192, 32] the chain's four dependent memory trips
// in one wave; at [8191, 160] the random 32-byte sectors of the rows (4
// to 5 of keys a probe, 2 more for a hit's start and length) from a table
// the L2 does not keep between launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // lanes a block, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int G = 4;           // threads that probe one queue entry
constexpr int kOnePass = 42;   // slots one pass of a group's loads covers: a merged row's 3 * mb <= 128
constexpr int kPer = (kOnePass + G - 1) / G;  // key loads a thread issues at once

// 8 blocks an SM (32 registers a thread): [8192, 32] lanes are 1,024
// blocks, one wave on 132 SMs.
__global__ void __launch_bounds__(kThreads, 8)
    bucket_probe_kernel(const long long* __restrict__ hashes, const uint8_t* __restrict__ mask,
                        const int* __restrict__ packed, long long* __restrict__ out_start,
                        long long* __restrict__ out_length, int n, int nb, int mb, int shift) {
  __shared__ unsigned s_hash[kThreads];          // the queue: hashes of the masked-in lanes
  __shared__ uint8_t s_lane[kThreads];           // and their places in the block
  __shared__ int s_start[kThreads];
  __shared__ int s_length[kThreads];
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool on = i < n && mask[i] != 0;
  const unsigned h = on ? static_cast<unsigned>(hashes[i]) : 0u;  // a masked lane's hash is never read
  const unsigned ballot = __ballot_sync(0xffffffffu, on);
  if (lane == 0) s_count[warp] = __popc(ballot);
  s_start[tid] = 0;
  s_length[tid] = 0;
  __syncthreads();
  int before = 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (on) {
    const int pos = before + __popc(ballot & ((1u << lane) - 1u));
    s_hash[pos] = h;
    s_lane[pos] = static_cast<uint8_t>(tid);
  }
  __syncthreads();

  const int j = tid % G;  // this thread's place in its group
  const unsigned group_mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  const int row_w = 3 * mb;
  for (int e = tid / G; e < total; e += kThreads / G) {
    const unsigned hq = s_hash[e];
    const unsigned b = min(hq >> shift, static_cast<unsigned>(nb - 1));
    const int key = static_cast<int>(hq);
    int start = 0;
    int length = 0;
    for (int c0 = j; c0 < mb; c0 += G * kPer) {  // one pass unless mb > G * kPer
      const int* slots = packed + static_cast<long long>(b) * row_w + c0;  // this thread's first slot
      int k[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) k[r] = c0 + r * G < mb ? __ldg(slots + r * G) : ~key;  // ~key never matches
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        if (k[r] == key) {
          start += __ldg(slots + mb + r * G);
          length += __ldg(slots + 2 * mb + r * G);
        }
      }
    }
    start = __reduce_add_sync(group_mask, start);
    length = __reduce_add_sync(group_mask, length);
    if (j == 0) {
      s_start[s_lane[e]] = start;
      s_length[s_lane[e]] = length;
    }
  }
  __syncthreads();
  if (i < n) {
    out_start[i] = s_start[tid];
    out_length[i] = s_length[tid];
  }
}

}  // namespace

// hashes [n] int64 (uint32 values), mask [n] bool, packed [nb, 3 * mb]
// int32 -> out_start, out_length [n] int64.
extern "C" int bucket_probe_launch(const void* hashes, const void* mask, const void* packed, void* out_start,
                                   void* out_length, int n, int nb, int mb, int shift, void* stream) {
  const long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  bucket_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(hashes), static_cast<const uint8_t*>(mask), static_cast<const int*>(packed),
      static_cast<long long*>(out_start), static_cast<long long*>(out_length), n, nb, mb, shift);
  return static_cast<int>(cudaGetLastError());
}

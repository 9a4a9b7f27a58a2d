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
// wants 128-lane tiles; here a warp owns 32 consecutive lanes (a read's
// sketch row at cap 32) and reads only what a probe needs.  The warp
// loads its 32 masks coalesced and the hashes of its masked-in lanes
// only, takes the ballot of the masked-in lanes, and for each of them in
// turn reads the key part of that lane's bucket row cooperatively (lane
// j the slots j, j + 32, ..; a coalesced 4 * mb-byte read, 168 bytes at
// mb = 42) and compares it with the broadcast hash.  Only a lane whose
// slot matches reads that slot's start and length; a warp sum hands the
// run to the owning lane.  Every lane then stores its (start, length)
// coalesced.  Masked lanes cost no hash or row read, so that traffic
// scales with the kept hashes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bucket_probe_kernel(const long long* __restrict__ hashes, const uint8_t* __restrict__ mask,
                        const int* __restrict__ packed, long long* __restrict__ out_start,
                        long long* __restrict__ out_length, int n, int nb, int mb, int shift) {
  const int lane = threadIdx.x & 31;
  const long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) - lane;
  if (base >= n) return;  // the whole warp is past the end
  const long long i = base + lane;
  const bool in = i < n;
  const bool on = in && mask[i] != 0;
  const unsigned h = on ? static_cast<unsigned>(hashes[i]) : 0u;  // a masked lane's hash is never read
  int start = 0;
  int length = 0;
  unsigned todo = __ballot_sync(0xffffffffu, on);
  const int row_w = 3 * mb;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const unsigned hq = __shfl_sync(0xffffffffu, h, src);
    const unsigned b = min(hq >> shift, static_cast<unsigned>(nb - 1));
    const int* row = packed + static_cast<long long>(b) * row_w;
    const int key = static_cast<int>(hq);
    int s = 0;
    int l = 0;
    for (int j = lane; j < mb; j += 32) {
      if (row[j] == key) {
        s += row[mb + j];
        l += row[2 * mb + j];
      }
    }
    s = __reduce_add_sync(0xffffffffu, s);
    l = __reduce_add_sync(0xffffffffu, l);
    if (lane == src) {
      start = s;
      length = l;
    }
  }
  if (in) {
    out_start[i] = start;
    out_length[i] = length;
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

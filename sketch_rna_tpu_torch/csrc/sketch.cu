// K1: fused ntHash2 + FracMinHash threshold + set-dedup of one k.
// K2: the same for several ks over one load of the codes.
//
// K1 replaces the TPU kernel sketch_rna_tpu/hash/pallas_hash.py
// _fused_sketch_kernel (entry sketch_batch_pallas); K2 replaces
// _fused_sketch_kernel_multik (entry sketch_batch_pallas_multik).  As the
// two Pallas kernels share _fused_sketch_one_k, both launches here run
// one kernel body, sketch_one_k per k.  Per read and k: the low-32-bit
// forward hash of every window, kept iff the window lies inside the read
// and hash <= threshold; the distinct kept values ascending in `cap`
// lanes (sentinel 0xFFFFFFFF past them); and the number of distinct
// values that did not fit.  That overflow count follows
// sketch/fracminhash.py dedup_select (distinct values), not the Pallas
// kernels' count of dropped lanes, so kernel and plain version agree
// exactly.
//
// Bound: device bytes.  A read brings L code bytes and its length in and
// takes cap * 9 + 4 bytes out per k: at [8192, 104], ks (21, 31), caps
// (32, 32) that is 5.7 MB, 1.69 us at 3.35 TB/s.  The work a read needs
// is O(1) integer operations per window, far below the card's rate.
//
// Design: one warp per read, four reads per block.  The block copies its
// reads' codes into shared memory with 16-byte loads.  The warp then
// computes one prefix XOR of the read, P(m+1) = P(m) ^ srol^(-m)(seed[s_m]),
// with a warp scan; it serves every k.  srol is XOR-linear, so window i
// of k hashes to srol^(k-1+i)(P(i+k) ^ P(i)): O(1) work per window where
// the windowed XOR takes k table lookups.  The low 32 bits of srol^d(x)
// depend only on x's 33-bit low field rotated by d mod 33, so P keeps
// that field alone, and the 4 x 33 rotated seeds its terms need sit in
// shared memory (hash/nthash.py nthash_prefix_u32 is the same arithmetic
// in torch).  Per k each lane hashes one window of every 32, tests the
// threshold, and a ballot compacts the survivors into a per-warp buffer.
// FracMinHash keeps ~5% of windows, so a 100 bp read has ~4 survivors:
// with at most 32 they are sorted by a shuffle bitonic network over the
// next power of two of lanes (6 stages for up to 8 survivors, 15 for 32;
// no barrier), the first of each run of equal values is found with
// __shfl_up_sync, ranks come from ballot / popc, and the row's `cap`
// lanes are stored coalesced.  More than 32 survivors (low-complexity
// reads, fractions near 1) take the wide path in the same kernel: the
// warp sorts its buffer, padded to a power of two, in shared memory
// under __syncwarp.  Reads up to 1024 windows (nk_pad, the buffer) take
// these kernels; longer ones take the hash-plane kernel K3 (hash.cu) and
// a K4 dedup.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxKs = 8;  // ks per K2 launch
constexpr int kWarps = 4;  // reads per block
constexpr int kMaxDevices = 64;
constexpr uint64_t kMask33 = (1ull << 33) - 1;

// The 33-bit low fields of the ntHash seeds of A, C, G, T (hash/nthash.py).
__device__ __forceinline__ uint64_t seed33(unsigned code) {
  const uint64_t s = code == 0   ? 0x3C8BFBB395C60474ull
                     : code == 1 ? 0x3193C18562A02B4Cull
                     : code == 2 ? 0x20323ED082572324ull
                                 : 0x295549F54BE24456ull;
  return s & kMask33;
}

// Rotate a 33-bit value left by d, 0 <= d < 33.
__device__ __forceinline__ uint64_t rot33(uint64_t x, int d) {
  return ((x << d) | (x >> (33 - d))) & kMask33;
}

struct MultiK {
  int num_k;
  int k[kMaxKs];
  int cap[kMaxKs];
  long long* hashes[kMaxKs];
  bool* mask[kMaxKs];
  int32_t* overflow[kMaxKs];
};

// P[0..L] of the warp's read: P[m] = XOR over q < m of srol^(-q)(seed[s_q])
// in the low field, terms[code][q mod 33].  Lane l folds positions
// [l*C, l*C + C), parking each term in P; a warp XOR-scan of the folds
// gives each lane its starting prefix.
__device__ __forceinline__ void prefix_xor(const uint8_t* seq, int L, const uint64_t (*terms)[33],
                                           uint64_t* P, int lane) {
  const int C = (L + 31) / 32;
  const int m0 = min(lane * C, L);
  const int m1 = min(m0 + C, L);
  uint64_t fold = 0;
  for (int m = m0, r = m0 % 33; m < m1; ++m, r = r == 32 ? 0 : r + 1) {
    const uint64_t t = terms[seq[m] & 3][r];
    P[m + 1] = t;
    fold ^= t;
  }
  uint64_t inc = fold;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc ^= o;
  }
  uint64_t run = inc ^ fold;
  if (lane == 0) P[0] = 0;
  for (int m = m0; m < m1; ++m) {
    run ^= P[m + 1];
    P[m + 1] = run;
  }
}

// Sort one value per lane ascending across the warp, where lanes from
// n on (n a power of two, 2 <= n <= 32) hold the sentinel already.
__device__ __forceinline__ uint32_t warp_sort(uint32_t v, int lane, int n) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    if (size > n) break;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t o = __shfl_xor_sync(kFull, v, stride);
      const bool ascending = size == n || (lane & size) == 0;
      v = ((lane & stride) == 0) == ascending ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The wide path: sort buf[0, count) (count > 32) padded with the
// sentinel to n = pow2ceil(count) lanes, then rank the first lane of each
// run of equal values and write those of rank < cap.  Returns the number
// of distinct values.
__device__ int wide_dedup(uint32_t* buf, int count, int cap, long long* __restrict__ dst,
                          bool* __restrict__ mdst, int lane) {
  int n = 64;
  while (n < count) n <<= 1;
  for (int i = count + lane; i < n; i += 32) buf[i] = kSentinel;
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < (n >> 1); p += 32) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const uint32_t a = buf[i];
        const uint32_t b = buf[i | stride];
        if ((b < a) == ((i & size) == 0)) {
          buf[i] = b;
          buf[i | stride] = a;
        }
      }
      __syncwarp();
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int distinct = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const uint32_t v = buf[i];
    const bool first = v != kSentinel && (i == 0 || v != buf[i - 1]);
    const unsigned ballot = __ballot_sync(kFull, first);
    const int rank = distinct + __popc(ballot & below);
    if (first && rank < cap) {
      dst[rank] = v;
      mdst[rank] = true;
    }
    distinct += __popc(ballot);
  }
  return distinct;
}

// One k of the warp's read.  buf holds at least pow2ceil(L - k + 1) and
// 32 values.
__device__ __forceinline__ void sketch_one_k(const uint64_t* P, int L, int length, int k,
                                             uint32_t threshold, int cap, uint32_t* buf,
                                             long long* __restrict__ dst, bool* __restrict__ mdst,
                                             int32_t* __restrict__ overflow, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const int n_win = min(L - k + 1, length - (k - 1));  // windows inside the read
  int count = 0;
  // Window i = w0 + lane rotates by (k - 1 + i) mod 33; 32 more is one less.
  for (int w0 = 0, d = (k - 1 + lane) % 33; w0 < n_win; w0 += 32, d = d == 0 ? 32 : d - 1) {
    const int i = w0 + lane;
    uint32_t h = kSentinel;
    if (i < n_win) h = static_cast<uint32_t>(rot33(P[i + k] ^ P[i], d));
    const bool keep = i < n_win && h <= threshold;
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (keep) buf[count + __popc(ballot & below)] = h;
    count += __popc(ballot);
  }
  __syncwarp();
  int distinct;
  if (count <= 32) {
    int n = 2;
    while (n < count) n <<= 1;
    const uint32_t v = warp_sort(lane < count ? buf[lane] : kSentinel, lane, n);
    const uint32_t prev = __shfl_up_sync(kFull, v, 1);
    const bool first = v != kSentinel && (lane == 0 || v != prev);
    const unsigned ballot = __ballot_sync(kFull, first);
    distinct = __popc(ballot);
    if (first) buf[__popc(ballot & below)] = v;  // every lane has read its survivor
    __syncwarp();
    for (int c = lane; c < cap; c += 32) {
      const bool kept = c < distinct;
      dst[c] = kept ? buf[c] : kSentinel;
      mdst[c] = kept;
    }
  } else {
    distinct = wide_dedup(buf, count, cap, dst, mdst, lane);
    for (int c = distinct + lane; c < cap; c += 32) {
      dst[c] = kSentinel;
      mdst[c] = false;
    }
  }
  if (lane == 0) *overflow = distinct > cap ? distinct - cap : 0;
  __syncwarp();  // buf is free for the next k
}

// Shared memory: [kWarps][L + 1] prefixes, [kWarps][buf_len] survivors,
// then the block's codes (kWarps * L bytes + 16 of alignment slack).
__global__ void __launch_bounds__(kWarps * 32)
    sketch_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                  const MultiK p, int B, int L, int buf_len, uint32_t threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t terms[4][33];  // srol^(-r)(seed[code]), low field
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 4 * 33; i += blockDim.x) {
    const int r = i % 33;
    terms[i / 33][r] = rot33(seed33(i / 33), r ? 33 - r : 0);
  }
  uint64_t* pre = reinterpret_cast<uint64_t*>(smem);
  uint32_t* bufs = reinterpret_cast<uint32_t*>(pre + kWarps * (L + 1));
  uint8_t* staged = reinterpret_cast<uint8_t*>(bufs + kWarps * buf_len);

  // Copy the block's rows of codes, 16 bytes a thread where aligned: the
  // copy keeps the source's offset modulo 16, so the vectors line up.
  const int row0 = blockIdx.x * kWarps;
  const int rows = min(kWarps, B - row0);
  const int length = warp < rows ? lengths[row0 + warp] : 0;  // in flight with the copy
  const uint8_t* src = codes + static_cast<size_t>(row0) * L;
  const int nbytes = rows * L;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  uint8_t* seq_all = staged + mis;
  const int head = min(nbytes, (16 - mis) & 15);
  const int nvec = (nbytes - head) >> 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) seq_all[i] = src[i];
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(seq_all + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) vdst[i] = vsrc[i];
  for (int i = head + 16 * nvec + threadIdx.x; i < nbytes; i += blockDim.x) seq_all[i] = src[i];
  __syncthreads();
  if (warp >= rows) return;

  const int row = row0 + warp;
  uint64_t* P = pre + warp * (L + 1);
  uint32_t* buf = bufs + warp * buf_len;
  prefix_xor(seq_all + warp * L, L, terms, P, lane);
  __syncwarp();
  for (int t = 0; t < p.num_k; ++t) {
    const size_t o = static_cast<size_t>(row) * p.cap[t];
    sketch_one_k(P, L, length, p.k[t], threshold, p.cap[t], buf, p.hashes[t] + o, p.mask[t] + o,
                 p.overflow[t] + row, lane);
  }
}

// Raise the kernel's dynamic shared memory limit, once per device, to the
// most the device grants a block beside the kernel's static table: the
// need grows with L and k, which have no fixed bound here (row_sort.cu
// follows the same rule with the most a row can need).
cudaError_t allow_shared() {
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && raised[dev])) return e;
  int most = 0;
  cudaFuncAttributes attr{};
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, sketch_kernel);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - static_cast<int>(attr.sharedSizeBytes));
  }
  if (e == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return e;
}

int launch_sketch(const void* codes, const void* lengths, const MultiK& p, int B, int L,
                  unsigned int threshold, void* stream) {
  int buf_len = 32;
  for (int t = 0; t < p.num_k; ++t) {
    int nk_pad = 1;
    while (nk_pad < L - p.k[t] + 1) nk_pad <<= 1;
    buf_len = nk_pad > buf_len ? nk_pad : buf_len;
  }
  const size_t smem = static_cast<size_t>(kWarps) * (L + 1) * sizeof(uint64_t) +
                      static_cast<size_t>(kWarps) * buf_len * sizeof(uint32_t) +
                      static_cast<size_t>(kWarps) * L + 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_shared();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  sketch_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), p, B, L, buf_len,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes [B, L] uint8, lengths [B] int32; out_hashes [B, cap] int64,
// out_mask [B, cap] bool, out_overflow [B] int32.
extern "C" int fused_sketch_launch(const void* codes, const void* lengths, void* out_hashes,
                                   void* out_mask, void* out_overflow, int B, int L, int k,
                                   unsigned int threshold, int cap, void* stream) {
  MultiK p{};
  p.num_k = 1;
  p.k[0] = k;
  p.cap[0] = cap;
  p.hashes[0] = static_cast<long long*>(out_hashes);
  p.mask[0] = static_cast<bool*>(out_mask);
  p.overflow[0] = static_cast<int32_t*>(out_overflow);
  return launch_sketch(codes, lengths, p, B, L, threshold, stream);
}

// ks, caps: host arrays of num_k ints; out_*: host arrays of num_k device
// pointers (out_hashes[i] is [B, caps[i]]).
extern "C" int fused_sketch_multik_launch(const void* codes, const void* lengths, int num_k,
                                          const int* ks, const int* caps, void* const* out_hashes,
                                          void* const* out_masks, void* const* out_overflows,
                                          int B, int L, unsigned int threshold, void* stream) {
  if (num_k < 1 || num_k > kMaxKs) return static_cast<int>(cudaErrorInvalidValue);
  MultiK p{};
  p.num_k = num_k;
  for (int i = 0; i < num_k; ++i) {
    p.k[i] = ks[i];
    p.cap[i] = caps[i];
    p.hashes[i] = static_cast<long long*>(out_hashes[i]);
    p.mask[i] = static_cast<bool*>(out_masks[i]);
    p.overflow[i] = static_cast<int32_t*>(out_overflows[i]);
  }
  return launch_sketch(codes, lengths, p, B, L, threshold, stream);
}

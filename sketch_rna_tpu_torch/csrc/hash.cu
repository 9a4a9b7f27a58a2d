// K3: ntHash2 + FracMinHash threshold of one k, compacted to the kept
// windows of each row.
//
// Replaces the TPU kernel sketch_rna_tpu/hash/pallas_hash.py _hash_kernel
// (entry nthash_sketch_pallas).  The TPU kernel writes a [B, L - k + 1]
// plane: the low-32-bit forward hash of every window that lies inside
// its read (w < lengths[b] - (k - 1)) and passes the threshold, the
// sentinel 0xFFFFFFFF elsewhere.  This kernel writes the same
// information compacted: per row, the kept hashes (int64 holding uint32)
// and their window indices (int32) in window order, then the sentinel
// and -1 up to the output width m.  It carries the reads too long for
// the fused kernels (a K4 dedup of the kept hashes follows) and the
// index build, which hashes a whole transcriptome as one row.
//
// Bound: ~8 integer operations per code position and per window against
// the codes in and the kept pairs out: at [8192, 2000], k = 31, fraction
// 0.05 the operations bound it (~16 us at the CUDA cores' 32-bit rate,
// the bytes ~9 us).  The plane this replaces wrote 8 bytes per window,
// though FracMinHash keeps ~5% of them.
//
// Design: O(1) per window by the forward rolling recurrence of ntHash in
// the 33-bit low field that the low 32 bits depend on (srol rotates it
// alone): fh(i+1) = srol(fh(i)) ^ srol^k(seed[s_i]) ^ seed[s_{i+k}].  The
// two terms come from one 16-entry table indexed by the leaving and the
// entering code, whose 128 bytes cover each shared-memory bank once, so a
// warp's lookups never conflict.  (The prefix-XOR form of K1 / K2 gives
// the same values, but rotates every term by its position mod 33 through
// a 4 x 33 table, and those random lookups serialise on banks.)  A warp
// owns a tile of 1024 windows of one row, so nothing crosses warps: no
// scan and no block barrier.  It stages the tile's codes and their
// (k - 1)-base halo realigned to 16 bytes (aligned 16-byte loads of the
// row, shifted into place in registers).  A lane owns 32 consecutive
// windows: it reads its own 32 codes (those that leave as it rolls) and
// the 32 from k on (those that enter) with aligned 16-byte loads, builds
// its first window's hash from k codes four at a time (a 256-entry
// table), then rolls.  Warp g of the grid takes tile g mod T of row
// g / T, so a multi-megabase row spreads over thousands of warps and a
// batch of reads fills every warp of a block.  Two launches keep the
// output deterministic and in window order: the first counts each warp
// tile's kept windows into [T, B]; the wrapper's cumsum gives each tile
// its offset and each row its count; the second hashes again, and each
// lane writes its survivors at the tile's offset plus the lanes before it
// (a warp scan of the lanes' counts); the row's last tile writes the
// padding.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 32;              // consecutive windows of a lane
constexpr int kWarpTile = 32 * kPerLane;  // windows of a warp: the count granularity
static_assert(kPerLane == 32, "a lane's windows and codes are two 16-byte chunks");
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

// The 16 bytes that start `shift` (0 .. 15) bytes into the 32 bytes
// lo, hi (lo.x lowest): two select stages move whole words, a funnel
// shift the rest.
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi, int shift) {
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t t[7], u[5];
#pragma unroll
  for (int o = 0; o < 7; ++o) t[o] = (shift & 4) ? v[o + 1] : v[o];
#pragma unroll
  for (int o = 0; o < 5; ++o) u[o] = (shift & 8) ? t[o + 2] : t[o];
  const unsigned r = 8 * (shift & 3);
  return make_uint4(__funnelshift_r(u[0], u[1], r), __funnelshift_r(u[1], u[2], r),
                    __funnelshift_r(u[2], u[3], r), __funnelshift_r(u[3], u[4], r));
}

// The four 2-bit codes of a word's bytes gathered into one byte, the
// first (lowest) byte's code highest.
__device__ __forceinline__ unsigned quad_index(uint32_t w) { return ((w & 0x03030303u) * 0x40100401u) >> 24; }

// 16-byte chunks of one warp's staged codes: its tile and the halo,
// realigned to start at a chunk, and the chunks its lanes read past them.
__host__ __device__ __forceinline__ int warp_chunks(int k) { return kWarpTile / 16 + k / 16 + 3; }

// Pass 1 (kWrite false): tile_counts[t, row] = warp tile t's kept windows.
// Pass 2 (kWrite true): incl[t, row] is the inclusive sum of the row's
// tile counts over tiles 0 .. t; write the pairs to out_h / out_w, rows of
// m lanes.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    hash_kept_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths, int B, int L,
                     int k, uint32_t threshold, int T, int32_t* __restrict__ tile_counts,
                     const int32_t* __restrict__ incl, long long* __restrict__ out_h,
                     int32_t* __restrict__ out_w, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  // enter[c] = seed[c]; roll[c_out + 4 c_in] = srol^k(seed[c_out]) ^ seed[c_in],
  // the terms that leave and enter as a window moves on.  roll's 128 bytes
  // cover each bank once, so a warp's lookups never conflict.
  // quad[c0 << 6 | c1 << 4 | c2 << 2 | c3] = srol^3(seed[c0]) ^ srol^2(seed[c1])
  // ^ srol(seed[c2]) ^ seed[c3]: four codes of a window's first hash at once.
  __shared__ uint64_t enter[4];
  __shared__ uint64_t roll[16];
  __shared__ uint64_t quad[256];
  if (threadIdx.x < 16) {
    roll[threadIdx.x] = rot33(seed33(threadIdx.x & 3), k % 33) ^ seed33(threadIdx.x >> 2);
    if (threadIdx.x < 4) enter[threadIdx.x] = seed33(threadIdx.x);
  }
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    quad[i] = rot33(seed33(i >> 6), 3) ^ rot33(seed33((i >> 4) & 3), 2) ^ rot33(seed33((i >> 2) & 3), 1) ^
              seed33(i & 3);
  }
  __syncthreads();  // the block's only barrier
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= static_cast<long long>(B) * T) return;
  const int row = static_cast<int>(g / T);  // this warp's row and tile
  const int t = static_cast<int>(g - static_cast<long long>(row) * T);
  const int w0 = t * kWarpTile;
  const int n_win = min(kWarpTile, L - k + 1 - w0);  // windows of this tile
  const int span = n_win + k - 1;                     // codes they read
  const int i0 = lane * kPerLane;                     // the lane's first window in the tile
  uint4* const A = reinterpret_cast<uint4*>(smem) + warp * warp_chunks(k);

  // Stage the tile's codes realigned to A's chunks: each lane reads
  // aligned 16-byte chunks of the row and shifts the pair of them that
  // holds its output chunk into place (a chunk is read only when it holds
  // a byte of the span, so no read leaves the row's allocation).
  const uint8_t* src = codes + static_cast<size_t>(row) * L + w0;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint4* aligned = reinterpret_cast<const uint4*>(src - mis);
  for (int c = lane; 16 * c < span; c += 32) {
    const uint4 lo = aligned[c];
    const uint4 hi = 16 * c + 16 - mis < span ? aligned[c + 1] : lo;
    A[c] = realign(lo, hi, mis);
  }
  const int limit = min(n_win, lengths[row] - (k - 1) - w0);  // tile windows inside the read
  __syncwarp();

  // The lane's windows are [i0, i0 + 32): the codes that leave
  // as it rolls are its own 32, those that enter the 32 from k on.
  const uint4 own0 = A[2 * lane], own1 = A[2 * lane + 1];
  const uint4* const ent = A + 2 * lane + k / 16;
  const uint4 e0 = ent[0], e1 = ent[1], e2 = ent[2];
  const uint4 in0 = realign(e0, e1, k & 15), in1 = realign(e1, e2, k & 15);
  const uint32_t out[8] = {own0.x, own0.y, own0.z, own0.w, own1.x, own1.y, own1.z, own1.w};
  const uint32_t in[8] = {in0.x, in0.y, in0.z, in0.w, in1.x, in1.y, in1.z, in1.w};

  // x: the 33-bit low field of the forward hash of window i0 + j,
  // first built from the window's k codes, four per step where it can.
  unsigned keep = 0;
  uint32_t h[kPerLane];
  if (i0 < limit) {
    uint64_t x = 0;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      if (4 * o + 4 <= k) {
        x = rot33(x, 4) ^ quad[quad_index(out[o])];
      } else {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          if (4 * o + b < k) x = rot33(x, 1) ^ enter[(out[o] >> (8 * b)) & 3];
        }
      }
    }
    for (int p = 32; p < k; p += 16) {  // a k past 32: the first window's other codes
      const uint4 c = A[2 * lane + p / 16];
      const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (p + 4 * o + 4 <= k) {
          x = rot33(x, 4) ^ quad[quad_index(cw[o])];
        } else {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (p + 4 * o + b < k) x = rot33(x, 1) ^ enter[(cw[o] >> (8 * b)) & 3];
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      // Byte b: the code that leaves (bits 0-1) and the one that enters
      // (bits 2-3) as the lane moves from window 4 o + b to the next.
      const uint32_t moves = (out[o] & 0x03030303u) | ((in[o] & 0x03030303u) << 2);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * o + b;
        h[j] = static_cast<uint32_t>(x);
        if (i0 + j < limit && h[j] <= threshold) keep |= 1u << j;
        x = rot33(x, 1) ^ roll[(moves >> (8 * b)) & 15];
      }
    }
  }
  const int count = __popc(keep);
  if constexpr (!kWrite) {
    int total = count;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
    if (lane == 0) tile_counts[static_cast<size_t>(t) * B + row] = total;
  } else {
    int before = count;  // lanes 0 .. lane's counts, then minus its own
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, before, o);
      if (lane >= o) before += v;
    }
    before -= count;
    int at = (t ? incl[static_cast<size_t>(t - 1) * B + row] : 0) + before;
    long long* dh = out_h + static_cast<size_t>(row) * m;
    int32_t* dw = out_w + static_cast<size_t>(row) * m;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if ((keep >> j) & 1u) {
        dh[at] = h[j];
        dw[at] = w0 + i0 + j;
        ++at;
      }
    }
    if (t == T - 1) {
      for (int i = incl[static_cast<size_t>(T - 1) * B + row] + lane; i < m; i += 32) {
        dh[i] = kSentinel;
        dw[i] = -1;
      }
    }
  }
}

int tiles(int L, int k) { return (L - k + 1 + kWarpTile - 1) / kWarpTile; }

template <bool kWrite>
int launch(const void* codes, const void* lengths, int B, int L, int k, unsigned int threshold,
           void* tile_counts, const void* incl, void* out_h, void* out_w, int m, void* stream) {
  const int T = tiles(L, k);
  const long long blocks = (static_cast<long long>(B) * T + kWarps - 1) / kWarps;
  // Past 48 KB (k above ~11,000) the launch fails and the wrapper raises.
  const size_t smem = static_cast<size_t>(kWarps) * warp_chunks(k) * sizeof(uint4);
  hash_kept_kernel<kWrite><<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), B, L, k, threshold, T,
      static_cast<int32_t*>(tile_counts), static_cast<const int32_t*>(incl), static_cast<long long*>(out_h),
      static_cast<int32_t*>(out_w), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Warp tiles per row: T of the [T, B] count array.
extern "C" int nthash_kept_tiles(int L, int k) { return tiles(L, k); }

// Pass 1. codes [B, L] uint8, lengths [B] int32; tile_counts [T, B] int32 out.
extern "C" int nthash_count_launch(const void* codes, const void* lengths, void* tile_counts, int B, int L,
                                   int k, unsigned int threshold, void* stream) {
  return launch<false>(codes, lengths, B, L, k, threshold, tile_counts, nullptr, nullptr, nullptr, 0, stream);
}

// Pass 2. incl [T, B] int32: inclusive sums of pass 1's counts over the
// tiles of each row (incl[T - 1, b] <= m); out_h [B, m] int64, out_w [B, m]
// int32 out.
extern "C" int nthash_kept_launch(const void* codes, const void* lengths, const void* incl, void* out_h,
                                  void* out_w, int B, int L, int k, unsigned int threshold, int m,
                                  void* stream) {
  return launch<true>(codes, lengths, B, L, k, threshold, nullptr, incl, out_h, out_w, m, stream);
}

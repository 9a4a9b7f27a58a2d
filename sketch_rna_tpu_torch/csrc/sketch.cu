// K1: fused ntHash2 + FracMinHash threshold + set-dedup of one k.
// K2: the same for several ks over one load of the codes.
//
// K1 replaces the TPU kernel sketch_rna_tpu/hash/pallas_hash.py
// _fused_sketch_kernel (entry sketch_batch_pallas); K2 replaces
// _fused_sketch_kernel_multik (entry sketch_batch_pallas_multik).  As the
// two Pallas kernels share _fused_sketch_one_k, these two share
// sketch_one_k below.  Per read and k: the low-32-bit forward hash of
// every window, kept iff the window lies inside the read and hash <=
// threshold; the distinct kept values ascending in `cap` lanes (sentinel
// 0xFFFFFFFF past them); and the number of distinct values that did not
// fit.  That overflow count follows sketch/fracminhash.py dedup_select
// (distinct values), not the Pallas kernels' count of dropped lanes, so
// kernel and plain version agree exactly.
//
// Bound: the XOR work (k table lookups per window) and the shared-memory
// sort, not device bytes — a read brings at most L <= ~1 KB of codes in
// and takes cap * 9 bytes out per k.  So the [B, nk] hash plane never
// reaches device memory, as the TPU kernels kept it in VMEM: one block
// per read stages the codes in shared memory (once, for every k in K2),
// loads the k's [k, 4] table there, writes its nk_pad window hashes
// (sentinel where not kept) to shared memory, bitonic-sorts them there,
// marks the first lane of every run of equal values, and compacts those
// lanes with a ballot/popc prefix count.  The sort costs the same at any
// cap, so unlike the TPU kernels' `cap` min-extraction passes there is no
// cap limit; nk_pad <= 1024 (reads up to ~1 kb) keeps one lane per
// thread.  Longer reads take the hash-plane kernel K3 (hash.cu) and a
// K4 dedup.

#include <cstdint>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kMaxKs = 8;  // ks per K2 launch

// One k of the read `row`, whose L codes are staged in seq.  Every thread
// of the block calls it; blockDim.x is a multiple of 32 and >= nk_pad.
// Shared scratch: hs [nk_pad], tab [4 * k], warp_counts [32].  It returns
// after a __syncthreads(), so the scratch is free for the next k.
__device__ void sketch_one_k(const uint8_t* seq, int L, int length,
                             const uint32_t* __restrict__ tables, int k, uint32_t threshold,
                             int cap, int nk_pad, uint32_t* hs, uint32_t* tab, int* warp_counts,
                             long long* __restrict__ dst, bool* __restrict__ mdst,
                             int32_t* __restrict__ overflow) {
  const int t = threadIdx.x;
  for (int i = t; i < 4 * k; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const int nk = L - k + 1;
  const int inside = length - (k - 1);  // windows that lie inside the read
  for (int w = t; w < nk_pad; w += blockDim.x) {
    uint32_t h = kSentinel;
    if (w < nk && w < inside) {
      uint32_t x = 0;
      for (int j = 0; j < k; ++j) x ^= tab[4 * j + (seq[w + j] & 3)];
      if (x <= threshold) h = x;
    }
    hs[w] = h;
  }
  __syncthreads();
  bitonic_sort_shared(hs, nk_pad, nk_pad);

  // First lane of each run of equal kept values -> its rank among them.
  uint32_t v = kSentinel;
  bool first = false;
  if (t < nk_pad) {
    v = hs[t];
    first = v != kSentinel && (t == 0 || v != hs[t - 1]);
  }
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, first);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  int distinct = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    distinct += c;
  }
  const int rank = before + __popc(ballot & ((1u << lane) - 1u));

  if (first && rank < cap) {
    dst[rank] = v;
    mdst[rank] = true;
  }
  for (int c = distinct + t; c < cap; c += blockDim.x) {
    dst[c] = kSentinel;
    mdst[c] = false;
  }
  if (t == 0) *overflow = distinct > cap ? distinct - cap : 0;
  __syncthreads();
}

// blockDim.x == max(nk_pad, 32): thread t owns sorted lane t.
__global__ void fused_sketch_kernel(const uint8_t* __restrict__ codes,
                                    const int32_t* __restrict__ lengths,
                                    const uint32_t* __restrict__ tables,
                                    long long* __restrict__ out_hashes,
                                    bool* __restrict__ out_mask,
                                    int32_t* __restrict__ out_overflow,
                                    int L, int k, uint32_t threshold, int cap, int nk_pad) {
  extern __shared__ uint32_t smem[];
  uint32_t* hs = smem;                                           // [nk_pad] window hashes
  uint32_t* tab = hs + nk_pad;                                   // [k][4] rotated seeds
  int* warp_counts = reinterpret_cast<int*>(tab + 4 * k);        // [32]
  uint8_t* seq = reinterpret_cast<uint8_t*>(warp_counts + 32);   // [L] codes

  const int row = blockIdx.x;
  const uint8_t* src = codes + static_cast<size_t>(row) * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) seq[i] = src[i];
  // sketch_one_k's first __syncthreads() publishes seq.
  const size_t o = static_cast<size_t>(row) * cap;
  sketch_one_k(seq, L, lengths[row], tables, k, threshold, cap, nk_pad, hs, tab, warp_counts,
               out_hashes + o, out_mask + o, out_overflow + row);
}

struct MultiK {
  int num_k;
  int k[kMaxKs];
  int cap[kMaxKs];
  int nk_pad[kMaxKs];
  const uint32_t* tables[kMaxKs];
  long long* hashes[kMaxKs];
  bool* mask[kMaxKs];
  int32_t* overflow[kMaxKs];
};

// blockDim.x == max(max nk_pad, 32); shared scratch sized for the widest
// k, reused by each k in turn.
__global__ void fused_sketch_multik_kernel(const uint8_t* __restrict__ codes,
                                           const int32_t* __restrict__ lengths, const MultiK p,
                                           int L, int k_max, int nk_pad_max, uint32_t threshold) {
  extern __shared__ uint32_t smem[];
  uint32_t* hs = smem;                                           // [nk_pad_max]
  uint32_t* tab = hs + nk_pad_max;                               // [k_max][4]
  int* warp_counts = reinterpret_cast<int*>(tab + 4 * k_max);    // [32]
  uint8_t* seq = reinterpret_cast<uint8_t*>(warp_counts + 32);   // [L] codes, loaded once

  const int row = blockIdx.x;
  const uint8_t* src = codes + static_cast<size_t>(row) * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) seq[i] = src[i];
  const int length = lengths[row];
  for (int i = 0; i < p.num_k; ++i) {
    const size_t o = static_cast<size_t>(row) * p.cap[i];
    sketch_one_k(seq, L, length, p.tables[i], p.k[i], threshold, p.cap[i], p.nk_pad[i], hs, tab,
                 warp_counts, p.hashes[i] + o, p.mask[i] + o, p.overflow[i] + row);
  }
}

}  // namespace

extern "C" int fused_sketch_launch(const void* codes, const void* lengths, const void* tables,
                                   void* out_hashes, void* out_mask, void* out_overflow,
                                   int B, int L, int k, unsigned int threshold, int cap,
                                   int nk_pad, void* stream) {
  const int threads = nk_pad < 32 ? 32 : nk_pad;
  const size_t smem = static_cast<size_t>(nk_pad + 4 * k + 32) * sizeof(uint32_t) + L;
  fused_sketch_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(tables), static_cast<long long*>(out_hashes),
      static_cast<bool*>(out_mask), static_cast<int32_t*>(out_overflow), L, k, threshold, cap,
      nk_pad);
  return static_cast<int>(cudaGetLastError());
}

// ks, caps, nk_pads: host arrays of num_k ints; tables, out_*: host arrays
// of num_k device pointers (out_hashes[i] is [B, caps[i]]).
extern "C" int fused_sketch_multik_launch(const void* codes, const void* lengths, int num_k,
                                          const int* ks, const int* caps, const int* nk_pads,
                                          void* const* tables, void* const* out_hashes,
                                          void* const* out_masks, void* const* out_overflows,
                                          int B, int L, unsigned int threshold, void* stream) {
  if (num_k < 1 || num_k > kMaxKs) return static_cast<int>(cudaErrorInvalidValue);
  MultiK p{};
  p.num_k = num_k;
  int k_max = 0;
  int nk_pad_max = 0;
  for (int i = 0; i < num_k; ++i) {
    p.k[i] = ks[i];
    p.cap[i] = caps[i];
    p.nk_pad[i] = nk_pads[i];
    p.tables[i] = static_cast<const uint32_t*>(tables[i]);
    p.hashes[i] = static_cast<long long*>(out_hashes[i]);
    p.mask[i] = static_cast<bool*>(out_masks[i]);
    p.overflow[i] = static_cast<int32_t*>(out_overflows[i]);
    k_max = ks[i] > k_max ? ks[i] : k_max;
    nk_pad_max = nk_pads[i] > nk_pad_max ? nk_pads[i] : nk_pad_max;
  }
  const int threads = nk_pad_max < 32 ? 32 : nk_pad_max;
  const size_t smem = static_cast<size_t>(nk_pad_max + 4 * k_max + 32) * sizeof(uint32_t) + L;
  fused_sketch_multik_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), p, L, k_max,
      nk_pad_max, threshold);
  return static_cast<int>(cudaGetLastError());
}

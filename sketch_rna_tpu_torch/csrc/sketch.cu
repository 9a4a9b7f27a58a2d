// K1: fused ntHash2 + FracMinHash threshold + set-dedup of one k.
//
// Replaces the TPU kernel sketch_rna_tpu/hash/pallas_hash.py
// _fused_sketch_kernel (body _fused_sketch_one_k, entry
// sketch_batch_pallas).  Per read: the low-32-bit forward hash of every
// window, kept iff the window lies inside the read and hash <= threshold;
// the distinct kept values ascending in `cap` lanes (sentinel 0xFFFFFFFF
// past them); and the number of distinct values that did not fit.  That
// overflow count follows sketch/fracminhash.py dedup_select (distinct
// values), not the Pallas kernel's count of dropped lanes, so kernel and
// plain version agree exactly.
//
// Bound: the XOR work (k table lookups per window) and the shared-memory
// sort, not device bytes — a read brings at most L <= ~1 KB of codes in
// and takes cap * 9 bytes out.  So the [B, nk] hash plane never reaches
// device memory, as the TPU kernel kept it in VMEM: one block per read
// stages the codes and the [k, 4] table in shared memory, writes its
// nk_pad window hashes (sentinel where not kept) to shared memory,
// bitonic-sorts them there, marks the first lane of every run of equal
// values, and compacts those lanes with a ballot/popc prefix count.
// The sort costs the same at any cap, so unlike the TPU kernel's `cap`
// min-extraction passes there is no cap limit; nk_pad <= 1024 (reads up
// to ~1 kb) keeps one lane per thread.

#include <cstdint>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// blockDim.x == max(nk_pad, 32): thread t owns sorted lane t.
__global__ void fused_sketch_kernel(const uint8_t* __restrict__ codes,
                                    const int32_t* __restrict__ lengths,
                                    const uint32_t* __restrict__ tables,
                                    long long* __restrict__ out_hashes,
                                    bool* __restrict__ out_mask,
                                    int32_t* __restrict__ out_overflow,
                                    int L, int k, uint32_t threshold, int cap, int nk_pad) {
  extern __shared__ uint32_t smem[];
  uint32_t* hs = smem;                                      // [nk_pad] window hashes
  uint32_t* tab = hs + nk_pad;                              // [k][4] rotated seeds
  int* warp_counts = reinterpret_cast<int*>(tab + 4 * k);  // [32]
  uint8_t* seq = reinterpret_cast<uint8_t*>(warp_counts + 32);  // [L] codes

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* src = codes + static_cast<size_t>(row) * L;
  for (int i = t; i < L; i += blockDim.x) seq[i] = src[i];
  for (int i = t; i < 4 * k; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const int nk = L - k + 1;
  const int inside = lengths[row] - (k - 1);  // windows that lie inside the read
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

  long long* dst = out_hashes + static_cast<size_t>(row) * cap;
  bool* mdst = out_mask + static_cast<size_t>(row) * cap;
  if (first && rank < cap) {
    dst[rank] = v;
    mdst[rank] = true;
  }
  for (int c = distinct + t; c < cap; c += blockDim.x) {
    dst[c] = kSentinel;
    mdst[c] = false;
  }
  if (t == 0) out_overflow[row] = distinct > cap ? distinct - cap : 0;
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

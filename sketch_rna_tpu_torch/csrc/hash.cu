// K3: ntHash2 + FracMinHash threshold plane of one k.
//
// Replaces the TPU kernel sketch_rna_tpu/hash/pallas_hash.py _hash_kernel
// (entry nthash_sketch_pallas; used by sketch_batch_pallas_unfused).  Out
// [b, w] is the low-32-bit forward hash of window w of read b when the
// window lies inside the read (w < lengths[b] - (k - 1)) and the hash is
// <= threshold, else the sentinel 0xFFFFFFFF; held in int64, as the
// port's plain version holds it.  It carries the reads too long for the
// fused kernels' one-lane-per-thread sort (a K4 dedup follows) and the
// index build, which hashes a whole transcriptome as one row.
//
// Bound: the k table lookups per window (k XORs from shared memory) and
// the 8-byte store per window; codes come in once per tile.  A block owns
// a tile of 1024 windows of one row (grid x) and walks rows (grid y), so
// a single multi-megabase row still spreads over thousands of blocks.
// The block stages the tile's codes with their (k - 1)-base halo and the
// [k, 4] table in shared memory; thread t hashes windows t, t + 256, ...,
// so neighbouring threads store neighbouring windows (coalesced).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWindowsPerThread = 4;
constexpr int kTile = kThreads * kWindowsPerThread;  // windows per block
constexpr int kMaxRowsInGrid = 65535;                // grid y limit

__global__ void __launch_bounds__(kThreads)
    nthash_sketch_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                         const uint32_t* __restrict__ tables, long long* __restrict__ out, int B,
                         int L, int k, uint32_t threshold) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;                                  // [k][4] rotated seeds
  uint8_t* seq = reinterpret_cast<uint8_t*>(tab + 4 * k);  // [kTile + k - 1] codes

  const int nk = L - k + 1;
  const int w0 = blockIdx.x * kTile;
  const int n_win = min(kTile, nk - w0);  // windows of this tile
  const int span = n_win + k - 1;         // codes they read
  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) tab[i] = tables[i];
  for (int row = blockIdx.y; row < B; row += gridDim.y) {
    __syncthreads();  // tab is published; the previous row's readers are done with seq
    const uint8_t* src = codes + static_cast<size_t>(row) * L + w0;
    for (int i = threadIdx.x; i < span; i += blockDim.x) seq[i] = src[i];
    __syncthreads();
    const int inside = lengths[row] - (k - 1) - w0;  // tile windows inside the read
    long long* dst = out + static_cast<size_t>(row) * nk + w0;
#pragma unroll
    for (int j = 0; j < kWindowsPerThread; ++j) {
      const int w = threadIdx.x + j * kThreads;
      if (w < n_win) {
        uint32_t h = kSentinel;
        if (w < inside) {
          uint32_t x = 0;
          for (int i = 0; i < k; ++i) x ^= tab[4 * i + (seq[w + i] & 3)];
          if (x <= threshold) h = x;
        }
        dst[w] = h;
      }
    }
  }
}

}  // namespace

// codes [B, L] uint8, lengths [B] int32, tables [k, 4] uint32, out [B, L - k + 1] int64.
extern "C" int nthash_sketch_launch(const void* codes, const void* lengths, const void* tables,
                                    void* out, int B, int L, int k, unsigned int threshold,
                                    void* stream) {
  const int nk = L - k + 1;
  const dim3 grid((nk + kTile - 1) / kTile, B < kMaxRowsInGrid ? B : kMaxRowsInGrid);
  const size_t smem = static_cast<size_t>(4 * k) * sizeof(uint32_t) + kTile + k - 1;
  nthash_sketch_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths),
      static_cast<const uint32_t*>(tables), static_cast<long long*>(out), B, L, k, threshold);
  return static_cast<int>(cudaGetLastError());
}

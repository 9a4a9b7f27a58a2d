// Merge of adjacent sorted runs: every row of a contiguous [N, 2w] array
// of int32 or int64 keys holds two ascending runs of w keys, [0, w) and
// [w, 2w); the output row is their merge, ascending.  w is a power of two.
//
// No TPU kernel has this job: the JAX package merges sorted event parts
// with a bitonic merge in XLA (sketch_rna_tpu/match/rowmatch.py:122,
// _bitonic_merge_pair).  In the port it is the merge round of
// row_sort_wide (rows past K4's 16384 lanes: one K4 launch sorts the
// 16384-lane chunks, then one merge per doubling) and of
// rowmatch.sort_event_parts (per-k event parts merged into one row: the
// sharded route's [8192, 256] and [8192, 512] int32 rounds on every
// batch).  Its plain version is match/row_sort.py bitonic_merge_pair.
//
// Bound: device bytes.  A merge reads each key once and writes it once;
// it needs one comparison per output.  At [8192, 256] int32 that is
// 16.8 MB, 5.0 us at 3.35 TB/s; at [8192, 32768] int64 4.3 GB, 1.28 ms.
//
// What held the first design, a merge path at every width (a block
// staged 2048 keys in shared memory, each thread binary-searched its
// diagonal there and merged 8 outputs): on narrow rows each thread's
// first output was 8 * tid, so a warp's search steps, merge reads and
// output stores went 8 words apart (int32) or 16 (int64) -- 8- and
// 16-way bank conflicts on every shared access, in a grid of one wave
// that lasted as long as one block's chain of them; on wide rows two
// threads binary-searched the tile's diagonals in device memory before
// any key was staged, about 15 dependent loads at the head of every
// block with the memory pipe idle.
//
// Design now, one regime a width: rows up to kRegisterMaxWidth = 1024
// lanes take the first, wider rows the second (the wrapper's
// REGISTER_MERGE_MAX_WIDTH, match/row_sort.py).  At 2048 int32 lanes the
// register merge, 64 keys a lane, measured slower than the staged path
// on an H100 (PERF.md section 6), so neither key type goes past 1024.
//
// Narrow rows: a bitonic merge in registers, with no shared memory, no search and no
// barrier.  G lanes own a row (a warp when the row holds 32 vectors or
// more), E = W / G keys a lane, in K4's warp-striped layout: key j of
// lane l sits at row offset (j / V) * G * V + l * V + j % V, V keys a
// 16-byte vector, so a warp's every load and store is one contiguous,
// coalesced run of 16-byte accesses.  The vectors of the second run are
// read mirrored (the vector at offset o is b's vector ending at
// 2w - 1 - o, its keys reversed), so the row in registers is bitonic: a
// ascending, then b descending.  The log2(W) half-cleaner stages then run
// as register compare-exchanges for partners in another vector of the
// lane, __shfl_xor_sync exchanges (an int64 key is two 32-bit shuffles)
// for partners in another lane, and register compare-exchanges within a
// vector.  At [8192, 256] int32 that is 1,024 compare-exchanges a row,
// 16.8M min/max over the call: a fifth of the bytes' time at the CUDA
// cores' integer rate.
//
// Wide rows: two launches.  (a) merge_partition_kernel computes every
// tile's diagonal split at once, one thread a tile boundary binary-
// searching the row in device memory, all in flight together: the
// search's chain of loads is paid once a call, not once a tile.  (b)
// merge_tiles_kernel: persistent blocks (as many as the card holds at
// once) walk the tiles, double-buffered: a block stages tile t + 1's two
// slices into shared memory with cp.async (16-byte copies, a scalar head
// and tail at unaligned ends) while it merges tile t (a third buffer
// costs an SM one of its three int64 blocks, and measured slower).  Each
// thread finds its diagonal in the staged slices and merges kItems
// outputs sequentially, ties from the left run, the two heads in
// registers (one shared load an output).  kItems is odd (15 int32, 11
// int64), so a warp's threads start their outputs an odd number of words
// apart and the stores to the shared output tile, 32 (int32) or 16
// (int64, a half-warp's access) distinct banks apart, are conflict-free;
// the block then stores the tile with coalesced 16-byte writes.
//
// Keys carry no payload, so either regime's output is bit-equal to any
// sort of the row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// ---------------------------------------------------------------------
// Narrow rows: a bitonic merge in registers.

constexpr int kRegThreads = 256;

// a, b in ascending order.  For int32 a min and a max (one IMNMX each);
// int64 has no such instruction, so one 64-bit compare decides a swap.
template <typename T>
__device__ __forceinline__ void order(T& a, T& b) {
  const T x = a;
  if constexpr (sizeof(T) == 4) {
    a = min(x, b);
    b = max(x, b);
  } else {
    const bool swap = b < x;
    a = swap ? b : x;
    b = swap ? x : b;
  }
}

// The smaller of v and o when keep_min, else the larger.
template <typename T>
__device__ __forceinline__ T keep(T v, T o, bool keep_min) {
  if constexpr (sizeof(T) == 4) {
    return keep_min ? min(v, o) : max(v, o);
  } else {
    return (o < v) == keep_min ? o : v;
  }
}

// r = p[0, V): one 16-byte load when vec (p then 16-byte aligned), else V
// scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&r)[V], bool vec) {
  if constexpr (V * sizeof(T) == 16) {
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(p));
        r[0] = t.x;
        r[1] = t.y;
        r[2] = t.z;
        r[3] = t.w;
      } else {
        const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(p));
        r[0] = t.x;
        r[1] = t.y;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) r[k] = p[k];
}

// p[0, V) = v[c * V, c * V + V), as load_vec.
template <typename T, int V, int E>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&v)[E], int c, bool vec) {
  if constexpr (V * sizeof(T) == 16) {
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<int4*>(p) = make_int4(v[c * V], v[c * V + 1], v[c * V + 2], v[c * V + 3]);
      } else {
        *reinterpret_cast<longlong2*>(p) = make_longlong2(v[c * V], v[c * V + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) p[k] = v[c * V + k];
}

// One row of W = G * E keys on G lanes (G = 1 << lg, 1 .. 32; 32 whenever
// a lane holds more than one vector), E keys a lane in the warp-striped
// layout above.  vec: x and out are 16-byte aligned.
template <typename T, int E>
__global__ void __launch_bounds__(kRegThreads)
    merge_register_kernel(const T* __restrict__ x, T* __restrict__ out, long long N, int W, int lg, bool vec) {
  constexpr int V = E < 16 / static_cast<int>(sizeof(T)) ? E : 16 / static_cast<int>(sizeof(T));
  constexpr int NV = E / V;  // vectors a lane
  const int G = 1 << lg;
  const long long t = static_cast<long long>(blockIdx.x) * kRegThreads + threadIdx.x;
  const long long row = t >> lg;
  const int l = static_cast<int>(t & (G - 1));
  const int w = W >> 1;
  // Lanes past the last row run the network on zeros: every lane of a
  // warp takes part in its shuffles.
  const bool live = row < N;
  T v[E];
  if (!live) {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = 0;
  } else if (G == 1) {  // the whole row in one lane (E == W): a, then b mirrored
    const T* src = x + row * W;
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = src[j < E / 2 ? j : 3 * E / 2 - 1 - j];
  } else {
    const T* src = x + row * W;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int o = c * G * V + l * V;  // the vector's first row offset
      const bool mirrored = o >= w;     // in the second run: b's keys 2w - 1 - o down
      T r[V];
      load_vec(src + (mirrored ? 3 * w - o - V : o), r, vec);
#pragma unroll
      for (int k = 0; k < V; ++k) v[c * V + k] = mirrored ? r[V - 1 - k] : r[k];
    }
  }
  // Half-cleaners of distance W/2 .. 1, lower offsets keeping the minima.
  // Partners in another vector of the lane (offset distance r * G, r >= V):
#pragma unroll
  for (int r = E / 2; r >= V; r >>= 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & r) == 0) order(v[j], v[j | r]);
    }
  }
  // in another lane (offset distance m * V):
  for (int m = G >> 1; m >= 1; m >>= 1) {
    const bool lower = (l & m) == 0;
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = keep(v[j], __shfl_xor_sync(kFull, v[j], m), lower);
  }
  // within a vector:
#pragma unroll
  for (int r = V / 2; r >= 1; r >>= 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & r) == 0) order(v[j], v[j | r]);
    }
  }
  if (!live) return;
  T* dst = out + row * W;
  if (G == 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) dst[j] = v[j];
  } else {
#pragma unroll
    for (int c = 0; c < NV; ++c) store_vec<T, V>(dst + c * G * V + l * V, v, c, vec);
  }
}

template <typename T, int E>
cudaError_t register_merge(const T* x, T* out, int N, int W, bool vec, cudaStream_t st) {
  const int lg = log2i(W / E);
  const long long lanes = static_cast<long long>(N) << lg;
  const long long blocks = (lanes + kRegThreads - 1) / kRegThreads;
  merge_register_kernel<T, E><<<static_cast<unsigned>(blocks), kRegThreads, 0, st>>>(x, out, N, W, lg, vec);
  return cudaGetLastError();
}

// The widest row the register merge takes: 32 keys a lane.
constexpr int kRegisterMaxWidth = 1024;

template <typename T>
int launch_register(const void* x, void* out, int N, int W, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (W < 2 || W > kRegisterMaxWidth || (W & (W - 1))) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int E = W / 32 > (W < V ? W : V) ? W / 32 : (W < V ? W : V);  // keys a lane
  cudaError_t e = cudaErrorInvalidValue;
  switch (E) {
    case 2: e = register_merge<T, 2>(xs, ys, N, W, vec, st); break;
    case 4: e = register_merge<T, 4>(xs, ys, N, W, vec, st); break;
    case 8: e = register_merge<T, 8>(xs, ys, N, W, vec, st); break;
    case 16: e = register_merge<T, 16>(xs, ys, N, W, vec, st); break;
    case 32: e = register_merge<T, 32>(xs, ys, N, W, vec, st); break;
    default: break;
  }
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------
// Wide rows: a partition launch, then a staged merge path.

constexpr int kTileThreads = 256;
constexpr int kStages = 2;  // tiles a block has staged or in flight

// Outputs a thread merges: odd (see the note at the top).
template <typename T>
__host__ __device__ constexpr int tile_items() {
  return sizeof(T) == 4 ? 15 : 11;
}

template <typename T>
__host__ __device__ constexpr int tile_outputs() {
  return kTileThreads * tile_items<T>();
}

// The number of a's among the first d outputs of merging a[0, na) and
// b[0, nb), ties taken from a: the smallest i with a[i] > b[d - 1 - i].
template <typename T>
__device__ __forceinline__ int merge_path(const T* a, int na, const T* b, int nb, int d) {
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// splits[row, k] = the number of a-keys among the first min(k * tile, W)
// outputs of the row's merge, k = 0 .. per_row - 1: one thread a boundary.
template <typename T>
__global__ void __launch_bounds__(256)
    merge_partition_kernel(const T* __restrict__ x, int* __restrict__ splits, long long n_splits, int W, int tile,
                           int per_row) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_splits) return;
  const long long row = s / per_row;
  const int k = static_cast<int>(s - row * per_row);
  const int d = static_cast<int>(min(static_cast<long long>(k) * tile, static_cast<long long>(W)));
  const int w = W >> 1;
  const T* a = x + row * W;
  splits[s] = merge_path(a, w, a + w, w, d);
}

// How many keys p lies past the 16-byte boundary below it (0 .. V - 1).
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n of this thread's newest copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// dst[0, n) = src[0, n) by the whole block through cp.async, where dst
// (shared) and src lie at the same offset modulo 16 bytes: a scalar head
// and tail, 16-byte copies between.
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (V - misalign(src)) % V);
  const int nvec = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += kTileThreads) cp_async<sizeof(T)>(dst + i, src + i);
  for (int i = threadIdx.x; i < nvec; i += kTileThreads) cp_async<16>(dst + head + V * i, src + head + V * i);
  for (int i = head + V * nvec + threadIdx.x; i < n; i += kTileThreads) cp_async<sizeof(T)>(dst + i, src + i);
}

// dst[0, n) = src[0, n) (shared) by the whole block, at the same offset
// modulo 16 bytes: 16-byte stores between a scalar head and tail.
template <typename T>
__device__ __forceinline__ void store_block(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (V - misalign(dst)) % V);
  const int nvec = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += kTileThreads) dst[i] = src[i];
  const int4* vsrc = reinterpret_cast<const int4*>(src + head);
  int4* vdst = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += kTileThreads) vdst[i] = vsrc[i];
  for (int i = head + V * nvec + threadIdx.x; i < n; i += kTileThreads) dst[i] = src[i];
}

// One tile: outputs [d0, d0 + len) of the row starting at key `base`,
// from a[a0, a0 + na) and b[b0, b0 + nb), staged at offsets sa and sb of
// a stage buffer (each slice at its source's offset modulo 16 bytes).
struct Tile {
  long long base;
  int d0, len, a0, na, b0, nb, sa, sb;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const T* x, long long tile, int per_row, int W, int s0, int s1) {
  constexpr int V = 16 / sizeof(T);
  Tile t;
  const long long row = tile / per_row;
  t.base = row * W;
  t.d0 = static_cast<int>(tile - row * per_row) * tile_outputs<T>();
  t.len = min(tile_outputs<T>(), W - t.d0);
  t.a0 = s0;
  t.na = s1 - s0;
  t.b0 = t.d0 - s0;
  t.nb = t.len - t.na;
  t.sa = misalign(x + t.base + t.a0);
  t.sb = (t.sa + t.na + V - 1) / V * V + misalign(x + t.base + (W >> 1) + t.b0);
  return t;
}

// The splits bounding `tile` (its row holds per_row + 1 of them).
__device__ __forceinline__ void load_splits(const int* __restrict__ splits, long long tile, int per_row, int& s0,
                                            int& s1) {
  const long long i = tile + tile / per_row;
  s0 = __ldg(splits + i);
  s1 = __ldg(splits + i + 1);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    merge_tiles_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ splits, long long tiles,
                       int W, int per_row) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kItems = tile_items<T>();
  constexpr int kStage = tile_outputs<T>() + 3 * V;  // two slices, each up to V - 1 keys off alignment
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);  // kStages buffers of kStage keys
  T* const out_tile = stage + kStages * kStage;
  const int w = W >> 1;
  const long long step = gridDim.x;
  long long tile = blockIdx.x;
  // s0[k], s1[k]: the splits of the block's tile it + k, read a tile
  // before its copies are issued, so no copy waits on a load.
  int s0[kStages], s1[kStages];
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    if (tile + k * step < tiles) load_splits(splits, tile + k * step, per_row, s0[k], s1[k]);
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (tile + k * step < tiles) {
      const Tile t = tile_of(x, tile + k * step, per_row, W, s0[k], s1[k]);
      stage_async(stage + k * kStage + t.sa, x + t.base + t.a0, t.na);
      stage_async(stage + k * kStage + t.sb, x + t.base + w + t.b0, t.nb);
    }
    cp_async_commit();
  }
  for (int it = 0; tile < tiles; ++it, tile += step) {
    const long long ahead = tile + (kStages - 1) * step;
    if (ahead < tiles) {  // into the buffer merged last (read before the previous barrier)
      const Tile t = tile_of(x, ahead, per_row, W, s0[kStages - 1], s1[kStages - 1]);
      T* buf = stage + ((it + kStages - 1) % kStages) * kStage;
      stage_async(buf + t.sa, x + t.base + t.a0, t.na);
      stage_async(buf + t.sb, x + t.base + w + t.b0, t.nb);
    }
    cp_async_commit();  // empty groups at the end keep the count
    const Tile t = tile_of(x, tile, per_row, W, s0[0], s1[0]);
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      s0[k] = s0[k + 1];
      s1[k] = s1[k + 1];
    }
    if (ahead + step < tiles) load_splits(splits, ahead + step, per_row, s0[kStages - 1], s1[kStages - 1]);
    cp_async_wait<kStages - 1>();  // this tile's copies, this thread's share
    __syncthreads();               // everyone's; and the previous tile's store has read out_tile
    const T* buf = stage + (it % kStages) * kStage;
    const T* sa = buf + t.sa;
    const T* sb = buf + t.sb;
    T* dst = out + t.base + t.d0;
    T* so = out_tile + misalign(dst);
    const int g = threadIdx.x * kItems;  // this thread's first output in the tile
    if (g < t.len) {
      int i = merge_path(sa, t.na, sb, t.nb, g);
      int j = g - i;
      const int cnt = min(kItems, t.len - g);
      // The two heads stay in registers: one shared load an output.  A
      // head one past its slice reads slack or the other slice, unused.
      T ha = sa[i], hb = sb[j];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if (r < cnt) {
          const bool take_a = j >= t.nb || (i < t.na && ha <= hb);
          so[g + r] = take_a ? ha : hb;
          const T next = take_a ? sa[++i] : sb[++j];
          ha = take_a ? next : ha;
          hb = take_a ? hb : next;
        }
      }
    }
    __syncthreads();
    store_block(dst, so, t.len);
  }
}

template <typename T>
int launch_partition(const void* x, void* splits, int N, int W, int tile, void* stream) {
  if (tile < 1 || W < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int per_row = (W + tile - 1) / tile + 1;
  const long long n = static_cast<long long>(N) * per_row;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  merge_partition_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int*>(splits), n, W, tile, per_row);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiles(const void* x, void* out, const void* splits, int N, int W, void* stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr size_t smem = ((kStages + 1) * static_cast<size_t>(tile_outputs<T>()) + (3 * kStages + 1) * V) * sizeof(T);
  // Blocks the card holds at once, found once per device.
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks_at_once = dev < kMaxDevices ? resident[dev] : 0;
  if (!blocks_at_once) {
    int per_sm = 0, sms = 0;
    e = cudaFuncSetAttribute(merge_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_tiles_kernel<T>, kTileThreads, smem);
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks_at_once = per_sm * sms;
    if (blocks_at_once < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < kMaxDevices) resident[dev] = blocks_at_once;
  }
  const int per_row = (W + tile_outputs<T>() - 1) / tile_outputs<T>();
  const long long tiles = static_cast<long long>(N) * per_row;
  const long long blocks = tiles < blocks_at_once ? tiles : blocks_at_once;
  merge_tiles_kernel<T><<<static_cast<unsigned>(blocks), kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(splits), tiles, W, per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [N, W] keys, W = 2w a power of two from 2 to kRegisterMaxWidth;
// each row of x holds two ascending runs of w keys.
extern "C" int merge_register_launch(const void* x, void* out, int N, int W, void* stream) {
  return launch_register<int32_t>(x, out, N, W, stream);
}

extern "C" int merge_register_i64_launch(const void* x, void* out, int N, int W, void* stream) {
  return launch_register<long long>(x, out, N, W, stream);
}

// splits: [N, ceil(W / tile) + 1] int32, the number of a-keys before each
// boundary min(k * tile, W) of each row's merge, ties from a.
extern "C" int merge_partition_launch(const void* x, void* splits, int N, int W, int tile, void* stream) {
  return launch_partition<int32_t>(x, splits, N, W, tile, stream);
}

extern "C" int merge_partition_i64_launch(const void* x, void* splits, int N, int W, int tile, void* stream) {
  return launch_partition<long long>(x, splits, N, W, tile, stream);
}

// out = the merge of x's rows, from splits made at merge_tile_outputs.
extern "C" int merge_tiles_launch(const void* x, void* out, const void* splits, int N, int W, void* stream) {
  return launch_tiles<int32_t>(x, out, splits, N, W, stream);
}

extern "C" int merge_tiles_i64_launch(const void* x, void* out, const void* splits, int N, int W, void* stream) {
  return launch_tiles<long long>(x, out, splits, N, W, stream);
}

// The tile of merge_tiles (outputs a block merges at a time), by key size.
extern "C" int merge_tile_outputs(int itemsize) {
  return itemsize == 8 ? tile_outputs<long long>() : tile_outputs<int32_t>();
}

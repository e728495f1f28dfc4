// Hand-written Hopper (sm_90a) kernels of tempo_tpu_torch: the sketch updates
// (HyperLogLog and count-min) and the critical path's pointer doubling.
//
// None of these replaces a Pallas kernel: each replaces a jitted JAX program
// of the reference, which XLA compiled for the TPU.
//   hll_update      tempo_tpu/ops/sketch.py:55-69     (hll_update)
//   cm_update       tempo_tpu/ops/sketch.py:117-133   (cm_update)
//   root_path_sums  tempo_tpu/ops/graph.py:106-150    (_root_sums_limbs via
//                                                      root_path_sums_device)
// Each computes the same function as its plain PyTorch version
// (tempo_tpu_torch/ops/sketch.py _hll_update_plain / _cm_update_plain,
// tempo_tpu_torch/ops/graph.py _root_path_sums_plain), bit for bit. The
// interface is plain C: pointers, sizes and the CUDA stream as arguments,
// bound from Python with ctypes. Every entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns the first
// non-zero cudaError_t so that the wrapper raises.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libtempo_graph_sketch_kernels.so
//        graph_sketch_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kHllIndexSeed = 0x2545F491u;
constexpr uint32_t kHllRankSeed = 0x27220A95u;
// a block keeps its own copy of the sketch in shared memory up to this size
// (HLL to p = 14, count-min to depth x width = 16,384 counters: the defaults
// are p = 12 and 4 x 4,096); a larger sketch takes global atomics
constexpr int kPrivateBytes = 64 * 1024;

using u64 = unsigned long long;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The cluster a grid of *blocks CTAs launches in: the largest power of two
// up to `most` that the grid fills; *blocks is rounded up to a whole number
// of clusters.
unsigned grid_cluster(int64_t* blocks, unsigned most) {
  unsigned k = 1;
  while (k < most && 2 * (int64_t)k <= *blocks) k *= 2;
  *blocks = cdiv(*blocks, k) * k;
  return k;
}

// ---------------------------------------------------------------------------
// hashing, as tempo_tpu/ops/hashing.py: fnv1a-32 over the big-endian bytes
// of the key's uint32 limbs, then the murmur3 finalizer seeded by xor
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t fnv_word(uint32_t h, uint32_t w) {
  h = (h ^ (w >> 24)) * kFnvPrime;
  h = (h ^ ((w >> 16) & 0xFFu)) * kFnvPrime;
  h = (h ^ ((w >> 8) & 0xFFu)) * kFnvPrime;
  return (h ^ (w & 0xFFu)) * kFnvPrime;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h, uint32_t seed) {
  h ^= seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The key of row r: `limbs` holds n rows of `width` limbs, each limb 4 bytes
// (uint32 bits) or 8 bytes (an int64 holding a uint32 value: its low 32 bits,
// as the plain version's `& 0xFFFFFFFF`). Keys of 4 limbs whose rows are
// 16-byte aligned (the quad form) load as one or two 16-byte loads instead
// (load_quad, hash_quad).
template <typename T>
__device__ __forceinline__ uint32_t key_hash(const T* __restrict__ limbs, int width, int64_t r) {
  uint32_t h = kFnvOffset;
  const T* row = limbs + r * width;
  for (int i = 0; i < width; ++i) h = fnv_word(h, (uint32_t)row[i]);
  return h;
}

// ---------------------------------------------------------------------------
// hll_update
//
// Replaces the jitted ops/sketch.hll_update of the reference
// (tempo_tpu/ops/sketch.py:55-69): for every row whose `valid` is true (all
// rows when it is null), register h_idx & (m - 1) takes the max of itself and
// clz(h_rank) + 1, where h_idx and h_rank are the key's fnv1a finalized with
// two seeds. clz(0) is 32, as jax.lax.clz gives.
//
// What bounds it on this card: the bytes of the keys, 16 a row (32 for int64
// limbs) and 1 of `valid`. At the compaction step's 2**22 rows that is 71 MB,
// 21 us of HBM; the hashing is ~86 integer operations a row, 5 us. Every row
// ends in one max into a register that many rows share (4,096 registers at
// the default p = 12), and max updates to one address of device memory are
// serialised in L2.
//
// Design: the grid is sized by the rows alone: one row a thread up to two
// CTAs an SM, so a block writer's flush of 8,192 IDs spreads over 32 CTAs
// and a push of 4,096 edge keys over 16; past that each thread takes rows a
// grid apart, kHllRowsInFlight at a time, all their `valid` bytes and then
// all their keys loaded before it hashes any (the warp's loads of one row
// slot are contiguous). Each CTA folds into a private copy of the registers
// in shared memory, with a read before the atomic so that a row that cannot
// raise its register issues none. The CTAs of a thread-block cluster (up to
// kHllCluster) then merge through distributed shared memory: CTA c of the
// cluster owns registers [c m / K, (c + 1) m / K), maxes them over its
// peers' copies and issues one global 64-bit atomicMax for each non-zero
// one, so the global atomics fall by the cluster's size. Registers that do
// not fit (p > 14) take one global atomicMax a row in the same kernel. max
// is associative and commutative, so the order of the atomics cannot change
// the registers: the result is bit-equal to the plain version's scatter-max.
// ---------------------------------------------------------------------------

constexpr int kHllRowsInFlight = 2;  // rows a thread loads before it hashes any
constexpr int kHllCtasPerSm = 4;     // the grid's cap, with one row a thread below it
constexpr int kHllCluster = 8;       // CTAs that merge their private registers together

// The four uint32 limbs of row r of a quad-form key array.
__device__ __forceinline__ uint4 load_quad(const uint32_t* __restrict__ limbs, int64_t r) {
  return reinterpret_cast<const uint4*>(limbs)[r];
}

__device__ __forceinline__ uint4 load_quad(const u64* __restrict__ limbs, int64_t r) {
  const ulonglong2 a = reinterpret_cast<const ulonglong2*>(limbs)[2 * r];
  const ulonglong2 b = reinterpret_cast<const ulonglong2*>(limbs)[2 * r + 1];
  return make_uint4((uint32_t)a.x, (uint32_t)a.y, (uint32_t)b.x, (uint32_t)b.y);
}

__device__ __forceinline__ uint32_t hash_quad(uint4 v) {
  return fnv_word(fnv_word(fnv_word(fnv_word(kFnvOffset, v.x), v.y), v.z), v.w);
}

// Bit u (u < kRows): row r0 + u * stride exists and is valid (all rows when
// valid is null).
template <int kRows>
__device__ __forceinline__ uint32_t live_rows(const uint8_t* __restrict__ valid, int64_t n,
                                              int64_t r0, int64_t stride) {
  uint32_t ok = 0;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int64_t r = r0 + u * stride;
    if (r < n && (valid == nullptr || valid[r] != 0)) ok |= 1u << u;
  }
  return ok;
}

template <typename T, bool kQuad, bool kPrivate>
__global__ void __launch_bounds__(kThreads)
hll_update_kernel(const T* __restrict__ limbs, int width, const uint8_t* __restrict__ valid,
                  int64_t n, uint32_t mask, long long* __restrict__ regs) {
  extern __shared__ uint32_t priv[];
  const uint32_t m = mask + 1;
  if (kPrivate) {
    for (uint32_t i = threadIdx.x; i < m; i += blockDim.x) priv[i] = 0;
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t step = kHllRowsInFlight * stride;
  int64_t r0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t ok = live_rows<kHllRowsInFlight>(valid, n, r0, stride);
  for (; r0 < n; r0 += step) {
    uint4 key[kHllRowsInFlight];
    if constexpr (kQuad) {
#pragma unroll
      for (int u = 0; u < kHllRowsInFlight; ++u)
        if (ok >> u & 1u) key[u] = load_quad(limbs, r0 + u * stride);
    }
    // the next rows' mask loads while these hash
    const uint32_t next = live_rows<kHllRowsInFlight>(valid, n, r0 + step, stride);
#pragma unroll
    for (int u = 0; u < kHllRowsInFlight; ++u) {
      if (!(ok >> u & 1u)) continue;
      uint32_t base;
      if constexpr (kQuad) {
        base = hash_quad(key[u]);
      } else {
        base = key_hash(limbs, width, r0 + u * stride);
      }
      const uint32_t idx = fmix32(base, kHllIndexSeed) & mask;
      const uint32_t rho = (uint32_t)__clz((int)fmix32(base, kHllRankSeed)) + 1u;
      if (kPrivate) {
        if (priv[idx] < rho) atomicMax(&priv[idx], rho);
      } else {
        atomicMax(&regs[idx], (long long)rho);
      }
    }
    ok = next;
  }
  if (kPrivate) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every copy of the cluster is whole
    const uint32_t k = cluster.num_blocks();
    const uint32_t per = m / k;  // m and k are powers of two, m >= 16 >= k
    const uint32_t lo = cluster.block_rank() * per;
    for (uint32_t i = lo + threadIdx.x; i < lo + per; i += blockDim.x) {
      uint32_t v = 0;
      for (uint32_t q = 0; q < k; ++q) v = max(v, cluster.map_shared_rank(priv, q)[i]);
      if (v != 0) atomicMax(&regs[i], (long long)v);
    }
    cluster.sync();  // no CTA leaves while a peer still reads its copy
  }
}

// hll_update's launch: one row a thread up to kHllCtasPerSm CTAs an SM (a
// grid-stride loop past that), and with private registers a cluster of up to
// kHllCluster CTAs, the grid rounded up to whole clusters.
template <typename T, bool kQuad, bool kPrivate>
cudaError_t launch_hll(const void* limbs, int width, const uint8_t* valid, int64_t n,
                       uint32_t m, long long* regs, cudaStream_t st) {
  const size_t smem = kPrivate ? m * sizeof(uint32_t) : 0;
  auto kernel = hll_update_kernel<T, kQuad, kPrivate>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t cap = (int64_t)std::max(std::min(occ, kHllCtasPerSm), 1) * sm_count();
  int64_t blocks = std::max<int64_t>(std::min(cdiv(n, kThreads), cap), 1);
  const unsigned cluster = kPrivate ? grid_cluster(&blocks, kHllCluster) : 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kPrivate ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, (const T*)limbs, width, valid, n, m - 1, regs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cm_update
//
// Replaces the jitted ops/sketch.cm_update of the reference
// (tempo_tpu/ops/sketch.py:117-133): every row whose `valid` is true adds its
// uint32 weight (1 when `weights` is null) to one counter in each of `depth`
// rows of the sketch, column fmix32(fnv1a(key), seed * 31 + i) & (width - 1)
// in row i; the counters wrap mod 2**32.
//
// The counters are int64 tensors holding uint32 values. The kernel adds into
// the low 32-bit word of each (the card is little-endian) with 32-bit
// atomics, which wrap mod 2**32 and never carry into the high word; the
// wrapper hands it counters already masked to 32 bits, so the high words stay
// zero and the result is the plain version's (counts + sum) & 0xFFFFFFFF.
//
// What bounds it on this card: the valid rows' keys, as for hll_update (32 B
// an int64 row: 109 MB, 33 us of HBM at the compaction step's 3,407,872
// valid rows), and depth adds a row into a few thousand hot counters.
//
// Design, hll_update's levers, resized for count-min's 64-KB copies:
// - the grid is sized by the rows alone: one row a thread up to
//   kCmCtasPerSm CTAs an SM, a grid-stride loop past that. Each private
//   copy costs 64 KB to zero and merge, so the CTAs that keep one are
//   large: kCmThreads threads (kThreads without a copy); two of 1,024
//   fill an SM's threads and take 128 KB of shared memory;
// - a thread hashes its row while the next row's weight and key, and the
//   `valid` byte of the row after it, load;
// - each CTA adds into a private copy of the counters in shared memory,
//   and the CTAs of a thread-block cluster (up to kCmCluster: the largest
//   that keeps 7/8 of the CTAs that fit unclustered, by
//   cudaOccupancyMaxActiveClusters) merge through distributed shared
//   memory: CTA c owns the cells [c s, (c + 1) s), s the cells over the
//   cluster's size rounded up to four so that the merge reads 16 bytes at
//   a time (the cells past depth x width stay zero), sums them over its
//   peers' copies and issues one global add for each non-zero sum, so the
//   global adds fall by the cluster's size;
// - a sketch over kPrivateBytes, or rows that make fewer than
//   kCmPrivateUpdates updates a counter (a push of 4,096 keys: its CTAs
//   would each zero and merge 16,384 counters to add a few hundred), add
//   straight into the output instead.
// Integer adds mod 2**32 commute and associate, so the counters are exact
// whatever the order and the grouping of the adds.
// ---------------------------------------------------------------------------

constexpr int kCmThreads = 1024;      // a CTA's threads with a private copy (kThreads without)
constexpr int kCmCtasPerSm = 2;       // the grid's cap, with one row a thread below it
constexpr int kCmCluster = 8;         // the largest cluster whose CTAs merge their copies
constexpr int kCmPrivateUpdates = 2;  // updates a counter below which the adds go global

// The weight of row r (1 when weights is null; 0 when the row is not live)
// and, in the quad form, its key.
template <typename T, bool kQuad>
__device__ __forceinline__ void cm_row(const T* __restrict__ limbs,
                                       const uint32_t* __restrict__ weights, bool live, int64_t r,
                                       uint4& key, uint32_t& w) {
  w = !live ? 0u : weights == nullptr ? 1u : weights[r];
  if constexpr (kQuad) key = live ? load_quad(limbs, r) : make_uint4(0, 0, 0, 0);
}

template <typename T, bool kQuad, bool kPrivate>
__global__ void __launch_bounds__(kPrivate ? kCmThreads : kThreads)
cm_update_kernel(const T* __restrict__ limbs, int width, const uint32_t* __restrict__ weights,
                 const uint8_t* __restrict__ valid, int64_t n, int depth, uint32_t col_mask,
                 uint32_t seed0, uint32_t span, uint32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t cm_priv[];  // kPrivate: the cluster's size x span
  const uint32_t cols = col_mask + 1;
  if (kPrivate) {
    uint4* words = reinterpret_cast<uint4*>(cm_priv);
    const uint32_t quads = cg::this_cluster().num_blocks() * span / 4;
    for (uint32_t i = threadIdx.x; i < quads; i += blockDim.x) words[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint4 key = make_uint4(0, 0, 0, 0);
  uint32_t w;
  cm_row<T, kQuad>(limbs, weights, live_rows<1>(valid, n, r, stride), r, key, w);
  uint32_t ok = live_rows<1>(valid, n, r + stride, stride);
  for (; r < n; r += stride) {
    // the next row's weight and key, and the mask after it, load while this
    // row hashes
    uint4 next_key = make_uint4(0, 0, 0, 0);
    uint32_t next_w;
    cm_row<T, kQuad>(limbs, weights, ok, r + stride, next_key, next_w);
    ok = live_rows<1>(valid, n, r + 2 * stride, stride);
    if (w != 0) {
      uint32_t base;
      if constexpr (kQuad) {
        base = hash_quad(key);
      } else {
        base = key_hash(limbs, width, r);
      }
      for (int i = 0; i < depth; ++i) {
        const uint32_t cell = (uint32_t)i * cols + (fmix32(base, seed0 + (uint32_t)i) & col_mask);
        if (kPrivate) {
          atomicAdd(&cm_priv[cell], w);
        } else {
          atomicAdd(&counts[2 * (size_t)cell], w);  // the int64 counter's low word
        }
      }
    }
    key = next_key;
    w = next_w;
  }
  if (kPrivate) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every copy of the cluster is whole
    const uint32_t k = cluster.num_blocks();
    const uint32_t lo = cluster.block_rank() * span;
    for (uint32_t i = lo + 4 * threadIdx.x; i < lo + span; i += 4 * blockDim.x) {
      uint4 v = make_uint4(0, 0, 0, 0);
      for (uint32_t q = 0; q < k; ++q) {
        const uint4 c = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(cm_priv, q) + i);
        v.x += c.x;
        v.y += c.y;
        v.z += c.z;
        v.w += c.w;
      }
      // a cell past depth x width sums to zero, so it is never added
      if (v.x != 0) atomicAdd(&counts[2 * (size_t)i], v.x);
      if (v.y != 0) atomicAdd(&counts[2 * (size_t)i + 2], v.y);
      if (v.z != 0) atomicAdd(&counts[2 * (size_t)i + 4], v.z);
      if (v.w != 0) atomicAdd(&counts[2 * (size_t)i + 6], v.w);
    }
    cluster.sync();  // no CTA leaves while a peer still reads its copy
  }
}

// Cells of a private copy that each CTA of a cluster of k merges.
uint32_t cm_span(int64_t cells, unsigned k) { return (uint32_t)(cdiv(cdiv(cells, k), 4) * 4); }

// The private kernel's grid on one device for a sketch of `cells` counters:
// the CTAs that run at once (kCmCtasPerSm an SM at most) and the cluster
// they merge in, the largest up to kCmCluster that keeps 7/8 of them.
struct CmFit {
  int dev = -1;
  int64_t cells = -1;
  int64_t cap = 0;
  unsigned cluster = 1;
};

template <typename K>
cudaError_t cm_fit(K kernel, int dev, int64_t cells, CmFit* fit) {
  // the most any sketch's copies take (kPrivateBytes and a cluster's
  // rounding, 16 B a CTA), so that no size lowers it under another's launch
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kPrivateBytes + 16 * kCmCluster);
  const int64_t most_ctas = (int64_t)kCmCtasPerSm * sm_count();
  CmFit got;
  int64_t alone = 0;
  for (unsigned k = 1; err == cudaSuccess && k <= (unsigned)kCmCluster; k *= 2) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(k);
    config.blockDim = dim3(kCmThreads);
    config.dynamicSmemBytes = (size_t)k * cm_span(cells, k) * sizeof(uint32_t);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    const int64_t ctas = std::min((int64_t)clusters * k, most_ctas) / k * k;
    if (k == 1) alone = ctas;
    if (err == cudaSuccess && ctas > 0 && 8 * ctas >= 7 * alone) {
      got.cap = ctas;
      got.cluster = k;
    }
  }
  if (err != cudaSuccess) return err;
  if (got.cap == 0) return cudaErrorInvalidConfiguration;
  got.dev = dev;
  got.cells = cells;
  *fit = got;
  return cudaSuccess;
}

// cm_update's launch: one row a thread up to kCmCtasPerSm CTAs an SM (a
// grid-stride loop past that), and with a private copy a cluster of up to
// CmFit's size, the grid a whole number of clusters.
template <typename T, bool kQuad, bool kPrivate>
cudaError_t launch_cm(const void* limbs, int width, const uint32_t* weights,
                      const uint8_t* valid, int64_t n, int depth, uint32_t cols, uint32_t seed0,
                      uint32_t* counts, cudaStream_t st) {
  auto kernel = cm_update_kernel<T, kQuad, kPrivate>;
  const int threads = kPrivate ? kCmThreads : kThreads;
  const int64_t cells = (int64_t)depth * cols;
  int64_t cap = 0;
  unsigned most = 1;
  cudaError_t err = cudaSuccess;
  if (kPrivate) {
    thread_local CmFit fit;  // for the last device and sketch size this thread launched
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (fit.dev != dev || fit.cells != cells))
      err = cm_fit(kernel, dev, cells, &fit);
    cap = fit.cap;
    most = fit.cluster;
  } else {
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, 0);
    cap = (int64_t)std::max(std::min(occ, kCmCtasPerSm), 1) * sm_count();
  }
  if (err != cudaSuccess) return err;
  int64_t blocks = std::max<int64_t>(std::min(cdiv(n, threads), cap), 1);
  const unsigned cluster = grid_cluster(&blocks, most);  // cap is a whole number of `most`
  const uint32_t span = kPrivate ? cm_span(cells, cluster) : 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = (size_t)cluster * span * sizeof(uint32_t);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kPrivate ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, (const T*)limbs, width, weights, valid, n, depth,
                           cols - 1, seed0, span, counts);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// root_path_sums
//
// Replaces the jitted ops/graph._root_sums_limbs of the reference
// (tempo_tpu/ops/graph.py:106-150, called through root_path_sums_device):
// pointer doubling over a span forest. Starting from acc = self time and
// p = parent (-1 at a root), each of `rounds` rounds sets, for every span i
// with p[i] >= 0, acc[i] += acc[p[i]] and p[i] = p[p[i]], reading the values
// of the round before; after k rounds acc[i] sums the self times of i and its
// ancestors up to distance 2**k - 1. The TPU keeps the uint64 sums as two
// uint32 limbs with an explicit carry; here they are native 64-bit adds,
// which wrap mod 2**64 exactly as the limbs do.
//
// What bounds it on this card: the bytes. Each round reads p and acc (12 B a
// span), gathers them at the parent (12 B, mostly from L2: parents lie in
// the same trace, a few rows away) and writes them (12 B); ceil(log2 n) + 1
// rounds, 22 at n = 2**21. The least the card must move for the function is
// parent and self time in, the sums out: 20 B a span (and 4 B a trace start
// for the segmented form).
//
// Two designs, one entry point each:
//
// tt_root_path_sums: one launch a round, each reading one pair of buffers
// and writing the other (ping-pong), so that no round reads a value of its
// own round: an in-place update would race. Every round runs, as in the JAX
// arm; once every pointer is -1 a round only copies. A parent index outside
// [-1, n) is taken as a root instead of being read out of bounds. It serves
// callers that know no trace segments.
//
// tt_root_path_sums_segmented, for callers that pass the traces' first rows
// (`firsts`, ascending from 0, every parent inside its own trace, as
// ops/graph.parent_row_join makes them): one launch over whole traces. CTA k
// takes the traces whose first row lies in rows [k W, (k + 1) W) (W =
// kRpsWindow; it finds them in `firsts` with one cooperative search and a
// forward scan, while cp.async copies the window's parents and self times
// into shared memory), loads the rest of its last trace, runs the rounds
// there and writes the sums once: 20 B a span through HBM, against 36 B a
// round. Each thread keeps its kRpsSlots spans' pointer and sum in
// registers; a round gathers every live span's step from the tile, a
// barrier, then publishes the new values, and a second barrier
// (__syncthreads_or) also tells whether any pointer is still live: about
// six shared-memory wavefronts a live warp of spans a round. The CTA stops
// once every pointer of its traces is -1, since later rounds are no-ops; a
// trace with a parent cycle never gets there and runs all `rounds`, whose
// count its sums (mod 2**64) depend on. A run of traces longer than the
// tile (kRpsTile rows from row k W: any trace of more than W + 1 spans may
// be one) runs in the same launch, its CTA doing the rounds in global
// scratch over those rows alone (one CTA's gathers: slow for a deep trace
// of tens of thousands of spans). A parent outside its trace, or `firsts`
// not ascending from 0 below n, sets *flag (the wrapper raises) and is
// never followed out of its CTA's rows.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
root_path_round_kernel(const int32_t* __restrict__ p_in, const u64* __restrict__ acc_in,
                       int32_t n, int32_t* __restrict__ p_out, u64* __restrict__ acc_out) {
  const int32_t i = (int32_t)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  int32_t p = p_in[i];
  u64 a = acc_in[i];
  if (p >= 0 && p < n) {
    a += acc_in[p];
    p = p_in[p];
  } else {
    p = -1;
  }
  acc_out[i] = a;
  p_out[i] = p;
}

constexpr int kRpsThreads = 512;
constexpr int kRpsSlots = 16;                          // spans a thread holds through a round
constexpr int kRpsTile = kRpsThreads * kRpsSlots;      // rows a CTA keeps in shared memory
constexpr int kRpsWindow = kRpsTile / 2;               // rows whose trace starts a CTA takes
constexpr int kRpsWords = kRpsTile / 32;               // the tile's trace-start bitmap
constexpr int kRpsGather = 8;                          // gathers in flight a thread past the tile
constexpr size_t kRpsSmem = (size_t)kRpsTile * (sizeof(u64) + sizeof(int32_t)) +
                            2 * kRpsWords * sizeof(uint32_t);

// A 16-byte copy from device to shared memory that runs on while the thread
// goes on (cp.async), and the wait for all of the thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first t in [a, b) with f[t] >= x (b if none), f ascending: every
// thread of the block probes one of blockDim.x evenly spaced rows, and the
// count of those below x narrows [a, b) to one gap, two or three rounds for
// a million traces. Every thread of the block calls it and gets the answer.
__device__ int64_t block_lower_bound(const int32_t* __restrict__ f, int64_t a, int64_t b,
                                     int32_t x) {
  while (b - a > (int64_t)blockDim.x) {
    const int64_t step = (b - a + blockDim.x - 1) / blockDim.x;
    const int64_t pos = a + (int64_t)threadIdx.x * step;
    const int c = __syncthreads_count(pos < b && f[pos] < x);
    if (c == 0) return a;
    b = min(b, a + (int64_t)c * step);  // f[a + (c - 1) step] < x <= f[a + c step]
    a += (int64_t)(c - 1) * step + 1;
  }
  const int64_t pos = a + threadIdx.x;
  return a + __syncthreads_count(pos < b && f[pos] < x);
}

// The trace of row x of the tile, counted from the tile's first start:
// starts at or before x.
__device__ __forceinline__ uint32_t tile_trace(const uint32_t* bits, const uint32_t* rank,
                                               int32_t x) {
  return rank[x >> 5] + __popc(bits[x >> 5] & (0xFFFFFFFFu >> (31 - (x & 31))));
}

// The rounds of rows [r0, r1) in global memory, for a run longer than the
// tile: the parents checked against their traces (firsts[t0, t1), by binary
// search), then ping-pong between two halves of `scratch` (2 n records),
// one block barrier a round, and the sums into `out`. A record holds a
// span's sum (.x) and pointer (.y), so that a gather is one 16-byte load:
// one CTA's gathers are bound by the misses it can keep in flight. No other
// CTA touches these rows.
__device__ void rps_global_run(const int32_t* __restrict__ parent,
                               const u64* __restrict__ self_ns,
                               const int32_t* __restrict__ firsts, int64_t t0, int64_t t1,
                               int32_t n, int32_t r0, int32_t r1, int32_t rounds, u64* out,
                               ulonglong2* scratch, int32_t* flag) {
  ulonglong2* src = scratch;
  ulonglong2* dst = scratch + n;
  for (int32_t i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const int32_t p = parent[i];
    int32_t q = -1;
    if (p >= 0) {
      int64_t a = t0, b = t1;  // the last trace starting at or before i
      while (b - a > 1) {
        const int64_t mid = (a + b) / 2;
        if (firsts[mid] <= i) a = mid; else b = mid;
      }
      const int32_t lo = firsts[a], hi = a + 1 < t1 ? firsts[a + 1] : r1;
      if (p >= lo && p < hi) q = p; else *flag = 1;
    }
    src[i] = make_ulonglong2(self_ns[i], (u64)(uint32_t)q);
  }
  __syncthreads();
  for (int32_t k = 0; k < rounds; ++k) {
    int live = 0;
    // kRpsGather spans a thread at a time, every load before any store, so
    // that their gathers (L2 round trips) are in flight together
    for (int32_t b = r0 + threadIdx.x; b < r1; b += kRpsGather * blockDim.x) {
      ulonglong2 v[kRpsGather];
#pragma unroll
      for (int u = 0; u < kRpsGather; ++u) {
        const int32_t i = b + u * (int32_t)blockDim.x;
        v[u] = i < r1 ? src[i] : make_ulonglong2(0, (u64)0xFFFFFFFFu);
      }
#pragma unroll
      for (int u = 0; u < kRpsGather; ++u) {
        const int32_t q = (int32_t)(uint32_t)v[u].y;
        if (q >= 0) {
          const ulonglong2 g = src[q];
          v[u].x += g.x;
          v[u].y = g.y;
          live |= (int32_t)(uint32_t)g.y >= 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kRpsGather; ++u) {
        const int32_t i = b + u * (int32_t)blockDim.x;
        if (i < r1) dst[i] = v[u];
      }
    }
    ulonglong2* t = src; src = dst; dst = t;
    if (!__syncthreads_or(live)) break;
  }
  for (int32_t i = r0 + threadIdx.x; i < r1; i += blockDim.x) out[i] = src[i].x;
}

__global__ void __launch_bounds__(kRpsThreads, 2)
root_path_segmented_kernel(const int32_t* __restrict__ parent, const u64* __restrict__ self_ns,
                           const int32_t* __restrict__ firsts, int32_t n, int32_t n_traces,
                           int32_t rounds, bool vec, u64* out, ulonglong2* scratch,
                           int32_t* flag) {
  extern __shared__ __align__(16) unsigned char rps_smem[];
  u64* sacc = reinterpret_cast<u64*>(rps_smem);             // [kRpsTile] self times, then sums
  int32_t* sp = reinterpret_cast<int32_t*>(sacc + kRpsTile);  // [kRpsTile] pointers, tile rows
  uint32_t* bits = reinterpret_cast<uint32_t*>(sp + kRpsTile);  // trace starts in the tile
  uint32_t* rank = bits + kRpsWords;                           // starts before each word
  __shared__ int32_t edge[2];                                  // the run's first and end rows
  const int tid = threadIdx.x;
  const int64_t T = n_traces;

  // this CTA's share of the check that firsts ascend from 0 below n (n > 0)
  {
    if (T == 0 && blockIdx.x == 0 && tid == 0) *flag = 1;
    const int64_t a = (int64_t)blockIdx.x * T / gridDim.x;
    const int64_t b = (int64_t)(blockIdx.x + 1) * T / gridDim.x;
    for (int64_t t = a + tid; t < b; t += blockDim.x) {
      const int32_t f = firsts[t];
      if (f < 0 || f >= n || (t == 0 && f != 0) || (t + 1 < T && firsts[t + 1] <= f)) *flag = 1;
    }
  }
  const int32_t lo = (int32_t)blockIdx.x * kRpsWindow;
  const int32_t hi = (int32_t)min((int64_t)n, (int64_t)lo + kRpsWindow);
  // the window's rows [lo, pre) start on their way to the tile (tile row =
  // row - lo; lo is a multiple of 4, so tile and global rows share their
  // 16-byte alignment) while the search below runs
  const int32_t pre = vec ? hi & ~3 : lo;
  for (int32_t v = (lo >> 2) + tid; v < (pre >> 2); v += blockDim.x)
    cp_async16(sp + 4 * v - lo, parent + 4 * v);
  for (int32_t v = (lo >> 1) + tid; v < (pre >> 1); v += blockDim.x)
    cp_async16(sacc + 2 * v - lo, self_ns + 2 * v);
  // the traces that start in [lo, hi): from t0, a chunk of firsts a pass,
  // their starts marked in the tile's bitmap
  for (int i = tid; i < kRpsWords; i += blockDim.x) bits[i] = 0;
  const int64_t t0 = block_lower_bound(firsts, 0, T, lo);  // its barriers order the zeroing
  int64_t cnt = 0;
  for (;;) {
    const int64_t t = t0 + cnt + tid;
    const int32_t f = t < T ? firsts[t] : n;
    const bool in = t < T && f < hi;
    if (in && f >= lo) atomicOr(&bits[(f - lo) >> 5], 1u << ((f - lo) & 31));
    if (cnt == 0 && tid == 0) edge[0] = f;
    const int c = __syncthreads_count(in);
    if (tid == c && c < (int)blockDim.x) edge[1] = f;  // the first start past the window
    cnt += c;
    if (c < (int)blockDim.x || cnt > kRpsWindow) break;
  }
  __syncthreads();
  const int32_t r0 = edge[0], r1 = edge[1];
  const bool bad = cnt > kRpsWindow || r0 < lo || r1 > n || r1 <= r0;  // firsts do not ascend
  if (cnt == 0 || bad || r1 - lo > kRpsTile) {
    cp_async_wait_all();  // no copy outlives its CTA
    if (cnt == 0) return;  // no trace starts here: the rows belong to an earlier CTA's run
    if (bad) {
      if (tid == 0) *flag = 1;
    } else {
      rps_global_run(parent, self_ns, firsts, t0, t0 + cnt, n, r0, r1, rounds, out, scratch,
                     flag);
    }
    return;
  }

  // the run's rows past the prefetch, 16 bytes a load where the pointers allow
  const int32_t L = r1 - r0, x0 = r0 - lo;
  const int32_t rest = max(r0, pre);
  if (vec) {
    const int32_t a4 = rest >> 2, b4 = r1 >> 2, a2 = rest >> 1, b2 = r1 >> 1;
    for (int32_t v = a4 + tid; v < b4; v += blockDim.x)
      reinterpret_cast<int4*>(sp)[v - (lo >> 2)] = reinterpret_cast<const int4*>(parent)[v];
    for (int32_t v = a2 + tid; v < b2; v += blockDim.x)
      reinterpret_cast<ulonglong2*>(sacc)[v - (lo >> 1)] =
          reinterpret_cast<const ulonglong2*>(self_ns)[v];
    const int32_t i = max(rest, b4 * 4) + tid;  // the last rows past the 16-byte ones
    if (i < r1) sp[i - lo] = parent[i];
    if (tid == 0 && (r1 & 1) && r1 - 1 >= rest) sacc[r1 - 1 - lo] = self_ns[r1 - 1];
  } else {
    for (int32_t i = rest + tid; i < r1; i += blockDim.x) {
      sp[i - lo] = parent[i];
      sacc[i - lo] = self_ns[i];
    }
  }
  // rank[w]: trace starts in the words before w (one warp's scan)
  if (tid < 32) {
    constexpr int kPer = kRpsWords / 32;
    uint32_t c[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      c[j] = __popc(bits[tid * kPer + j]);
      sum += c[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += y;
    }
    uint32_t run = incl - sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      rank[tid * kPer + j] = run;
      run += c[j];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // every parent inside its own trace, made a tile row (-1: a root); each
  // thread keeps its spans' pointer and sum in registers from here on
  u64 acc[kRpsSlots];
  int32_t ptr[kRpsSlots];
#pragma unroll
  for (int j = 0; j < kRpsSlots; ++j) {
    const int32_t o = tid + j * kRpsThreads;
    ptr[j] = -1;
    if (o < L) {
      const int32_t x = x0 + o;
      const int32_t p = sp[x];
      acc[j] = sacc[x];
      if (p >= 0) {
        if (p >= r0 && p < r1 && tile_trace(bits, rank, p - lo) == tile_trace(bits, rank, x))
          ptr[j] = p - lo;
        else
          *flag = 1;
      }
      sp[x] = ptr[j];
    }
  }
  __syncthreads();
  // a round: gather every live span's step from the tile, a barrier, then
  // publish the new values (a second barrier, which also counts the live)
  for (int32_t k = 0; k < rounds; ++k) {
    uint32_t moved = 0;
    int live = 0;
#pragma unroll
    for (int j = 0; j < kRpsSlots; ++j) {
      const int32_t q = ptr[j];
      if (q >= 0) {
        acc[j] += sacc[q];
        ptr[j] = sp[q];
        moved |= 1u << j;
        live |= ptr[j] >= 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRpsSlots; ++j) {
      if (moved >> j & 1u) {
        const int32_t x = x0 + tid + j * kRpsThreads;
        sacc[x] = acc[j];
        sp[x] = ptr[j];
      }
    }
    if (!__syncthreads_or(live)) break;
  }
  // the sums out, once: a warp's slot is 32 consecutive rows
#pragma unroll
  for (int j = 0; j < kRpsSlots; ++j) {
    const int32_t o = tid + j * kRpsThreads;
    if (o < L) out[r0 + o] = acc[j];
  }
}

}  // namespace

extern "C" {

// limbs: (n, width) of limb_bytes (4: uint32 bits, 8: int64 holding uint32)
// a limb; valid (nullable): (n,) bool; regs: (m,) int64, m a power of two,
// which the kernel maxes into.
int tt_hll_update(const void* limbs, int32_t width, int32_t limb_bytes, const void* valid,
                  int64_t n, int32_t m, void* regs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  long long* r = (long long*)regs;
  const bool quad = width == 4 && ((uintptr_t)limbs & 15) == 0;
  const bool priv = (size_t)m * sizeof(uint32_t) <= (size_t)kPrivateBytes;
  cudaError_t err;
  if (limb_bytes == 4) {
    err = quad ? (priv ? launch_hll<uint32_t, true, true>(limbs, width, v, n, m, r, st)
                       : launch_hll<uint32_t, true, false>(limbs, width, v, n, m, r, st))
               : (priv ? launch_hll<uint32_t, false, true>(limbs, width, v, n, m, r, st)
                       : launch_hll<uint32_t, false, false>(limbs, width, v, n, m, r, st));
  } else {
    err = quad ? (priv ? launch_hll<u64, true, true>(limbs, width, v, n, m, r, st)
                       : launch_hll<u64, true, false>(limbs, width, v, n, m, r, st))
               : (priv ? launch_hll<u64, false, true>(limbs, width, v, n, m, r, st)
                       : launch_hll<u64, false, false>(limbs, width, v, n, m, r, st));
  }
  return (int)err;
}

// limbs as tt_hll_update's; weights (nullable): (n,) uint32 bits; valid
// (nullable): (n,) bool; counts: (depth, cols) int64 holding uint32 values,
// cols a power of two, which the kernel adds into mod 2**32; seed0: the first
// hash stream's seed, (seed * 31) mod 2**32.
int tt_cm_update(const void* limbs, int32_t width, int32_t limb_bytes, const void* weights,
                 const void* valid, int64_t n, int32_t depth, int32_t cols, uint32_t seed0,
                 void* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* w = (const uint32_t*)weights;
  const uint8_t* v = (const uint8_t*)valid;
  uint32_t* c = (uint32_t*)counts;
  const bool quad = width == 4 && ((uintptr_t)limbs & 15) == 0;
  // a private copy when the sketch fits and the rows make enough updates a
  // counter to pay for its zeroing and merge
  const int64_t cells = (int64_t)depth * cols;
  const bool priv = cells * (int64_t)sizeof(uint32_t) <= kPrivateBytes &&
                    n * depth >= kCmPrivateUpdates * cells;
  cudaError_t err;
#define TT_CM(T, Q, P) launch_cm<T, Q, P>(limbs, width, w, v, n, depth, (uint32_t)cols, seed0, c, st)
  if (limb_bytes == 4) {
    err = quad ? (priv ? TT_CM(uint32_t, true, true) : TT_CM(uint32_t, true, false))
               : (priv ? TT_CM(uint32_t, false, true) : TT_CM(uint32_t, false, false));
  } else {
    err = quad ? (priv ? TT_CM(u64, true, true) : TT_CM(u64, true, false))
               : (priv ? TT_CM(u64, false, true) : TT_CM(u64, false, false));
  }
#undef TT_CM
  return (int)err;
}

// parent: (n,) int32, -1 at a root; self_ns: (n,) uint64 bits; p_a/acc_a and
// p_b/acc_b: (n,) scratch pairs. Round k reads the inputs (k = 0) or the pair
// round k - 1 wrote, and writes pair a (k even) or b (k odd): the sums end in
// acc_a when `rounds` is odd, else in acc_b. *launched: kernels launched.
int tt_root_path_sums(const void* parent, const void* self_ns, int32_t n, int32_t rounds,
                      void* p_a, void* acc_a, void* p_b, void* acc_b, int32_t* launched,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  *launched = 0;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)cdiv(n, kThreads);
  const int32_t* p_in = (const int32_t*)parent;
  const u64* acc_in = (const u64*)self_ns;
  for (int32_t k = 0; k < rounds; ++k) {
    int32_t* p_out = (int32_t*)(k % 2 == 0 ? p_a : p_b);
    u64* acc_out = (u64*)(k % 2 == 0 ? acc_a : acc_b);
    root_path_round_kernel<<<blocks, kThreads, 0, st>>>(p_in, acc_in, n, p_out, acc_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    p_in = p_out;
    acc_in = acc_out;
  }
  return 0;
}


// parent: (n,) int32, -1 at a root; self_ns: (n,) uint64 bits; firsts:
// (n_traces,) int32, each trace's first row, ascending from 0; out: (n,)
// uint64 sums; scratch: 32 n bytes, 16-byte aligned, for runs longer than
// a CTA's tile; flag: an int32 the caller zeroed, set to 1 on a parent
// outside its trace or firsts that do not ascend from 0 below n. One
// launch; *launched: kernels launched.
int tt_root_path_sums_segmented(const void* parent, const void* self_ns, const void* firsts,
                                int32_t n, int32_t n_traces, int32_t rounds, void* out,
                                void* scratch, void* flag, int32_t* launched, void* stream) {
  *launched = 0;
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(root_path_segmented_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kRpsSmem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (((uintptr_t)parent | (uintptr_t)self_ns) & 15) == 0;
  root_path_segmented_kernel<<<(unsigned)cdiv(n, kRpsWindow), kRpsThreads, kRpsSmem,
                               (cudaStream_t)stream>>>(
      (const int32_t*)parent, (const u64*)self_ns, (const int32_t*)firsts, n, n_traces, rounds,
      vec, (u64*)out, (ulonglong2*)scratch, (int32_t*)flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

}  // extern "C"

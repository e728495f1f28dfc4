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

#include <algorithm>

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
// a block zeroes and merges its private copy once, so it takes at least
// this many updates for each counter of the copy
constexpr int64_t kUpdatesPerCounter = 4;

using u64 = unsigned long long;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

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
// as the plain version's `& 0xFFFFFFFF`). kQuad: 4 limbs a row and the rows
// 16-byte aligned, so a row is one or two 16-byte loads.
template <typename T, bool kQuad>
__device__ __forceinline__ uint32_t key_hash(const T* __restrict__ limbs, int width, int64_t r) {
  uint32_t h = kFnvOffset;
  if constexpr (kQuad && sizeof(T) == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(limbs)[r];
    h = fnv_word(fnv_word(fnv_word(fnv_word(h, v.x), v.y), v.z), v.w);
  } else if constexpr (kQuad) {
    const ulonglong2 a = reinterpret_cast<const ulonglong2*>(limbs)[2 * r];
    const ulonglong2 b = reinterpret_cast<const ulonglong2*>(limbs)[2 * r + 1];
    h = fnv_word(fnv_word(fnv_word(fnv_word(h, (uint32_t)a.x), (uint32_t)a.y),
                          (uint32_t)b.x), (uint32_t)b.y);
  } else {
    const T* row = limbs + r * width;
    for (int i = 0; i < width; ++i) h = fnv_word(h, (uint32_t)row[i]);
  }
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
// 21 us of HBM; the hashing is ~60 integer operations a row, 4 us. Every row
// ends in one max into a register that many rows share (4,096 registers at
// the default p = 12), and max updates to one address of device memory are
// serialised in L2.
//
// Design: each block folds its rows (a grid-stride loop, so a warp's loads
// are contiguous) into a private copy of the registers in shared memory, with
// a read before the atomic so that a row that cannot raise its register
// issues none; then it merges every non-zero register into the output with
// one 64-bit atomicMax. The grid keeps at least kUpdatesPerCounter rows for
// each register a block zeroes and merges. Registers that do not fit
// (p > 14) take one global atomicMax a row in the same kernel. max is
// associative and commutative, so the order of the atomics cannot change the
// registers: the result is bit-equal to the plain version's scatter-max.
// ---------------------------------------------------------------------------

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
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    if (valid != nullptr && !valid[r]) continue;
    const uint32_t base = key_hash<T, kQuad>(limbs, width, r);
    const uint32_t idx = fmix32(base, kHllIndexSeed) & mask;
    const uint32_t rho = (uint32_t)__clz((int)fmix32(base, kHllRankSeed)) + 1u;
    if (kPrivate) {
      if (priv[idx] < rho) atomicMax(&priv[idx], rho);
    } else {
      atomicMax(&regs[idx], (long long)rho);
    }
  }
  if (kPrivate) {
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < m; i += blockDim.x) {
      const uint32_t v = priv[i];
      if (v != 0) atomicMax(&regs[i], (long long)v);
    }
  }
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
// What bounds it: the keys' bytes as for hll_update, and depth adds a row into
// a few thousand hot counters. Design as hll_update's: a private copy of the
// counters in shared memory (64 KB at the default 4 x 4,096), depth
// shared-memory adds a row, then one global add for each non-zero counter of
// the copy; a sketch over 16,384 counters adds straight into the output.
// Integer adds commute, so the counts are exact whatever the order.
// ---------------------------------------------------------------------------

template <typename T, bool kQuad, bool kPrivate>
__global__ void __launch_bounds__(kThreads)
cm_update_kernel(const T* __restrict__ limbs, int width, const uint32_t* __restrict__ weights,
                 const uint8_t* __restrict__ valid, int64_t n, int depth, uint32_t col_mask,
                 uint32_t seed0, uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t priv[];
  const uint32_t cols = col_mask + 1;
  const uint32_t cells = (uint32_t)depth * cols;
  if (kPrivate) {
    for (uint32_t i = threadIdx.x; i < cells; i += blockDim.x) priv[i] = 0;
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    if (valid != nullptr && !valid[r]) continue;
    const uint32_t w = weights == nullptr ? 1u : weights[r];
    if (w == 0) continue;
    const uint32_t base = key_hash<T, kQuad>(limbs, width, r);
    for (int i = 0; i < depth; ++i) {
      const uint32_t cell = (uint32_t)i * cols + (fmix32(base, seed0 + (uint32_t)i) & col_mask);
      if (kPrivate) {
        atomicAdd(&priv[cell], w);
      } else {
        atomicAdd(&counts[2 * (size_t)cell], w);  // the int64 counter's low word
      }
    }
  }
  if (kPrivate) {
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < cells; i += blockDim.x) {
      const uint32_t v = priv[i];
      if (v != 0) atomicAdd(&counts[2 * (size_t)i], v);
    }
  }
}

// Blocks for a sketch kernel over n rows making `updates` counter updates:
// at least one row a thread, at most what the card holds at once, and, with
// a private copy of `counters` counters, only as many blocks as keep
// kUpdatesPerCounter updates for each counter a block zeroes and merges.
template <typename K>
cudaError_t sketch_grid(K kernel, int64_t n, int64_t updates, int64_t counters, size_t smem,
                        unsigned* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  int occ = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  int64_t g = std::min<int64_t>(cdiv(n, kThreads), (int64_t)std::max(occ, 1) * sm_count());
  if (smem > 0) g = std::min(g, cdiv(updates, kUpdatesPerCounter * counters));
  *blocks = (unsigned)std::max<int64_t>(g, 1);
  return cudaSuccess;
}

template <typename T, bool kQuad, bool kPrivate>
cudaError_t launch_hll(const void* limbs, int width, const uint8_t* valid, int64_t n,
                       uint32_t m, long long* regs, cudaStream_t st) {
  const size_t smem = kPrivate ? m * sizeof(uint32_t) : 0;
  auto kernel = hll_update_kernel<T, kQuad, kPrivate>;
  unsigned blocks = 1;
  cudaError_t err = sketch_grid(kernel, n, n, m, smem, &blocks);
  if (err != cudaSuccess) return err;
  hll_update_kernel<T, kQuad, kPrivate><<<blocks, kThreads, smem, st>>>(
      (const T*)limbs, width, valid, n, m - 1, regs);
  return cudaGetLastError();
}

template <typename T, bool kQuad, bool kPrivate>
cudaError_t launch_cm(const void* limbs, int width, const uint32_t* weights,
                      const uint8_t* valid, int64_t n, int depth, uint32_t cols, uint32_t seed0,
                      uint32_t* counts, cudaStream_t st) {
  const int64_t cells = (int64_t)depth * cols;
  const size_t smem = kPrivate ? cells * sizeof(uint32_t) : 0;
  auto kernel = cm_update_kernel<T, kQuad, kPrivate>;
  unsigned blocks = 1;
  cudaError_t err = sketch_grid(kernel, n, n * depth, cells, smem, &blocks);
  if (err != cudaSuccess) return err;
  cm_update_kernel<T, kQuad, kPrivate><<<blocks, kThreads, smem, st>>>(
      (const T*)limbs, width, weights, valid, n, depth, cols - 1, seed0, counts);
  return cudaGetLastError();
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
// parent and self time in, the sums out: 20 B a span.
//
// Design: one launch a round, each reading one pair of buffers and writing
// the other (ping-pong), so that no round reads a value of its own round: an
// in-place update would race. Every round runs, as in the JAX arm; once every
// pointer is -1 a round only copies. A parent index outside [-1, n) is taken
// as a root instead of being read out of bounds (the wrapper's host arm
// raises on one). A later design may keep each trace's rounds in shared
// memory, since traces are contiguous segments and parents stay inside them.
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
  const bool priv = (size_t)depth * cols * sizeof(uint32_t) <= (size_t)kPrivateBytes;
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

}  // extern "C"

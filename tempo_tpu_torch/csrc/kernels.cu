// Hand-written Hopper (sm_90a) kernels of tempo_tpu_torch.
//
// Each kernel replaces one Pallas TPU kernel of tempo_tpu/ops/pallas_kernels.py
// and computes the same function as its plain PyTorch version in
// tempo_tpu_torch/ops/pallas_kernels.py. The interface is plain C: pointers,
// sizes and the CUDA stream as arguments, bound from Python with ctypes. Every
// entry point launches on the caller's stream, does not synchronise, allocates
// nothing, and returns the first non-zero cudaError_t (of a launch, or of the
// attribute and occupancy calls before it) so that the wrapper raises.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libtempo_kernels.so kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

using u64 = unsigned long long;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// seg_bincount
//
// Replaces _bincount_kernel / _bincount_call (tempo_tpu/ops/pallas_kernels.py:
// 194-245), the TraceQL metrics reduction: counts[slot] += weight for every
// row whose slot lies in [0, n_slots), into an int64 vector that the caller
// zeroed or that already holds earlier counts (the metrics accumulator keeps
// one on the card for a whole query).
//
// What bounds it on this card: the atomics, not the bytes. A flush reads 4 or
// 8 bytes a row, 1-8 MB, which HBM moves in 0.3-3 us; every row then needs one
// add into a counter that other rows hit too, and the adds to one address of
// device memory are serialised in L2. A metrics flush hits few slots: the
// spans of a minute share one time bin, so a flush of the quantile query
// spreads a million rows over a few hundred (series, bucket) slots of its
// 990,720. The TPU kernel built a one-hot tile and folded it on the MXU in
// f32 (exact only below 2**24, at most 2**15 slots); Hopper has integer
// atomics instead, so counts here are exact 64-bit integers at any size and
// weights may be negative.
//
// Design: each block folds its own contiguous range of rows into 32-bit
// counters in shared memory with shared-memory atomics, then merges every
// non-zero counter into the global vector with one 64-bit atomic, so a hot
// slot takes one global atomic per block instead of one per row.
// * Rows arrive as aligned 16-byte groups of 4 (slots and, where they share
//   the alignment, weights); each thread loads two groups before any atomic.
//   The `head` rows before the first aligned slot and at most 3 after the last
//   group are folded one by one. Runs of equal slots among a thread's 4
//   unweighted rows fold into one add.
// * Dense arm, n_slots <= kSmemSlots (49,152): one counter per slot, up to
//   192 KiB of dynamic shared memory (opted into once per device with
//   cudaFuncSetAttribute).
// * Hashed arm, wider slot spaces (up to MAX_SLOTS = 2**22): a table of
//   kHashSlots (slot, counter) entries, direct-mapped by a multiplicative
//   hash. A row's slot claims a free entry with atomicCAS; an entry never
//   changes owner, so a row whose entry belongs to another slot adds straight
//   into the global vector. The first slots a block meets, which in a metrics
//   flush are the hot ones, stay in shared memory.
// * The grid comes from the input: at least one 4-row group per thread up to
//   one block per SM, and beyond that only as many blocks as keep each block's
//   rows at 8x its counters, so that zeroing and merging them stays small next
//   to the rows it folds.
// Exactness of the 32-bit counters: unweighted rows add 1 and a block folds
// at most 2**31 + 6 rows, so a counter stays below 2**32. A weighted row with
// |w| < 2**16 adds w modulo 2**32, and a weighted block folds at most 2**15
// rows, so the true sum S of what one counter took has |S| < 2**31 and is the
// int32 that its bits spell; the merge sign-extends it. Rows with
// |w| >= 2**16 skip shared memory and go straight to the 64-bit global atomic.
// ---------------------------------------------------------------------------

constexpr int kSmemSlots = 49152;
constexpr int kHashBits = 13;
constexpr int kHashSlots = 1 << kHashBits;
constexpr int kBinThreads = 512;
constexpr int kSmallW = 1 << 16;
constexpr int64_t kWeightedGroups = (1 << 13) - 2;  // 4-row groups a weighted block folds:
                                                    // with 6 edge rows, < 2**15 rows
constexpr int64_t kUnweightedGroups = 1 << 29;      // 2**31 rows, + 6 edge rows
constexpr int32_t kFree = -1;                       // hashed arm: entry owned by no slot

struct Rows {
  const int32_t* slots;
  const int32_t* weights;  // nullptr: every row weighs 1
  int64_t n;
  int64_t head;    // rows before the first 16-byte-aligned slot (0..3)
  int64_t groups;  // whole 4-row groups from row `head`
  int32_t edges;   // head rows + rows after the last group (0..6)
  bool wvec;       // weights + head is 16-byte aligned as well
};

Rows make_rows(const int32_t* slots, const int32_t* weights, int64_t n) {
  Rows r;
  r.slots = slots;
  r.weights = weights;
  r.n = n;
  int64_t head = ((16 - ((uintptr_t)slots & 15)) & 15) / 4;
  r.head = head < n ? head : n;
  r.groups = (n - r.head) / 4;
  r.edges = (int32_t)(n - 4 * r.groups);
  r.wvec = weights != nullptr && (((uintptr_t)(weights + r.head)) & 15) == 0;
  return r;
}

__device__ __forceinline__ int64_t edge_row(const Rows& r, int e) {
  return e < r.head ? e : 4 * r.groups + e;
}

__device__ __forceinline__ void load_group(const Rows& r, int64_t g, int32_t s[4],
                                           int32_t w[4]) {
  const int64_t i = r.head + 4 * g;
  const int4 sv = __ldg(reinterpret_cast<const int4*>(r.slots + i));
  s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
  if (r.weights == nullptr) {
    w[0] = w[1] = w[2] = w[3] = 1;
  } else if (r.wvec) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(r.weights + i));
    w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __ldg(r.weights + i + k);
  }
}

// Unweighted rows: fold each run of equal slots among the 4 into its first
// row (a dead row gets slot -1, which is never counted).
__device__ __forceinline__ void combine_runs(int32_t s[4], int32_t w[4]) {
#pragma unroll
  for (int k = 3; k > 0; --k) {
    if (s[k] == s[k - 1]) {
      w[k - 1] += w[k];
      s[k] = -1;
    }
  }
}

template <bool kWeighted, bool kHashed>
__device__ __forceinline__ void fold(int32_t* keys, uint32_t* ctr, u64* out, int32_t s,
                                     int32_t w, int32_t n_slots) {
  if ((uint32_t)s >= (uint32_t)n_slots) return;
  if (kWeighted && !(w > -kSmallW && w < kSmallW)) {
    atomicAdd(&out[s], (u64)(long long)w);
    return;
  }
  if (!kHashed) {
    atomicAdd(&ctr[s], (uint32_t)w);
    return;
  }
  const uint32_t h = ((uint32_t)s * 2654435761u) >> (32 - kHashBits);
  int32_t owner = *reinterpret_cast<volatile int32_t*>(&keys[h]);
  if (owner == kFree) {
    const int32_t prev = atomicCAS(&keys[h], kFree, s);
    owner = prev == kFree ? s : prev;
  }
  if (owner == s) {
    atomicAdd(&ctr[h], (uint32_t)w);
  } else {
    atomicAdd(&out[s], (u64)(long long)w);
  }
}

template <bool kWeighted>
__device__ __forceinline__ void merge(u64* out, int32_t slot, uint32_t c) {
  if (c) atomicAdd(&out[slot], kWeighted ? (u64)(long long)(int32_t)c : (u64)c);
}

template <bool kWeighted, bool kHashed>
__global__ void __launch_bounds__(kBinThreads)
seg_bincount_kernel(Rows r, int64_t groups_per_block, int32_t n_slots, u64* __restrict__ out) {
  // dense: n_slots counters; hashed: kHashSlots keys, then kHashSlots counters
  extern __shared__ uint4 smem4[];
  int32_t* keys = reinterpret_cast<int32_t*>(smem4);
  uint32_t* ctr = reinterpret_cast<uint32_t*>(smem4) + (kHashed ? kHashSlots : 0);
  const int n4 = kHashed ? kHashSlots / 2 : (n_slots + 3) / 4;
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const bool key_part = kHashed && j < kHashSlots / 4;
    smem4[j] = key_part ? make_uint4(~0u, ~0u, ~0u, ~0u) : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int64_t g0 = (int64_t)blockIdx.x * groups_per_block;
  const int64_t g1 = min(r.groups, g0 + groups_per_block);
  for (int64_t g = g0 + threadIdx.x; g < g1; g += 2 * blockDim.x) {
    int32_t s[8], w[8];
    load_group(r, g, s, w);
    if (g + blockDim.x < g1) {
      load_group(r, g + blockDim.x, s + 4, w + 4);
    } else {
#pragma unroll
      for (int k = 4; k < 8; ++k) s[k] = -1, w[k] = 0;
    }
    if (!kWeighted) {
      combine_runs(s, w);
      combine_runs(s + 4, w + 4);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) fold<kWeighted, kHashed>(keys, ctr, out, s[k], w[k], n_slots);
  }
  if (blockIdx.x == 0 && threadIdx.x < r.edges) {
    const int64_t i = edge_row(r, threadIdx.x);
    fold<kWeighted, kHashed>(keys, ctr, out, r.slots[i], kWeighted ? r.weights[i] : 1, n_slots);
  }
  __syncthreads();

  if (kHashed) {
    for (int j = threadIdx.x; j < kHashSlots; j += blockDim.x) merge<kWeighted>(out, keys[j], ctr[j]);
  } else {
    // counters past n_slots in the last uint4 were never touched, so they are 0
    const uint4* c4 = reinterpret_cast<const uint4*>(ctr);
    for (int j = threadIdx.x; j < n4; j += blockDim.x) {
      const uint4 c = c4[j];
      merge<kWeighted>(out, 4 * j, c.x);
      merge<kWeighted>(out, 4 * j + 1, c.y);
      merge<kWeighted>(out, 4 * j + 2, c.z);
      merge<kWeighted>(out, 4 * j + 3, c.w);
    }
  }
}

// ---------------------------------------------------------------------------
// in_set_scan
//
// Replaces _in_set_kernel / _in_set_call (tempo_tpu/ops/pallas_kernels.py:
// 55-105): row r matches iff for every predicate column c, the column's value
// as uint32 bits equals one of codes[c][0..S). Rows >= n are written False (the
// JAX wrapper masks them after the kernel, :140-143). The padding code
// 0xFFFFFFFF is compared like any other code, which keeps the JAX kernel's
// quirk: a column value 0xFFFFFFFF inside [0, n) matches a padded set.
//
// What bounds it on this card: bytes. A row reads each column once (2-4 bytes
// for dictionary codes) and writes one byte; the C*S compares are cheap next
// to that.
//
// Design. The kernel reads the columns where they lie: a table of up to
// kMaxCols column pointers with each column's element width (1, 2, 4 or 8
// bytes; 8 keeps the low 32 bits, narrow signed types sign-extend, as the
// JAX wrapper's astype(uint32) does) travels by value as a kernel parameter,
// so no (C, n) staging matrix is built. Each thread owns 8 consecutive rows:
// it issues the 16-byte loads (uint2 for bytes, uint4 for 2-byte codes, two
// or four uint4 for wider ones) of up to 4 columns before comparing any of
// them, compares without early exit against the (C, S) code table held in
// shared memory (every lane reads the same word: a broadcast), and stores its
// 8 result bytes as one uint2.
// Alignment: the groups of 8 rows start at the first row where column 0 is
// aligned for its vector load; a column that is not aligned at the same rows
// (a view at another odd offset) is read with scalar loads of the same rows,
// and the groups that cross row 0, n or n_pad, or an unaligned output, load
// and store row by row. More than kMaxCols columns take further launches,
// each ANDing its columns into the output.
// ---------------------------------------------------------------------------

constexpr int kMaxCols = 8;
constexpr int kLoadCols = 4;  // columns whose loads are in flight together

struct Cols {
  const void* ptr[kMaxCols];
  int32_t width[kMaxCols];
  uint32_t sign_mask;  // bit c: column c is a signed type narrower than 4 bytes
  uint32_t vec_mask;   // bit c: column c is aligned for vector loads at the group starts
  int32_t n_cols;
};

__device__ __forceinline__ uint32_t load_one(const void* p, int width, bool sgn, int64_t r) {
  switch (width) {
    case 1:
      return sgn ? (uint32_t)(int32_t)static_cast<const int8_t*>(p)[r]
                 : (uint32_t)static_cast<const uint8_t*>(p)[r];
    case 2:
      return sgn ? (uint32_t)(int32_t)static_cast<const int16_t*>(p)[r]
                 : (uint32_t)static_cast<const uint16_t*>(p)[r];
    case 8:
      return static_cast<const uint32_t*>(p)[2 * r];  // low word (little-endian)
    default:
      return static_cast<const uint32_t*>(p)[r];
  }
}

__device__ __forceinline__ uint32_t narrow(uint32_t word, int k, int bits, bool sgn) {
  const uint32_t v = (word >> (k * bits)) & ((1u << bits) - 1);
  if (!sgn) return v;
  return (uint32_t)(((int32_t)(v << (32 - bits))) >> (32 - bits));
}

// 8 rows from r0 with vector loads; p + r0 * width is aligned to min(16, 8 * width).
__device__ __forceinline__ void load8(const void* p, int width, bool sgn, int64_t r0,
                                      uint32_t v[8]) {
  switch (width) {
    case 1: {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(p) + r0));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = narrow(x.x, k, 8, sgn);
        v[4 + k] = narrow(x.y, k, 8, sgn);
      }
      break;
    }
    case 2: {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(p) + r0));
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = narrow(w[k], 0, 16, sgn);
        v[2 * k + 1] = narrow(w[k], 1, 16, sgn);
      }
      break;
    }
    case 8: {
      const uint4* q = reinterpret_cast<const uint4*>(static_cast<const uint64_t*>(p) + r0);
      uint4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = __ldg(q + k);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = x[k].x;
        v[2 * k + 1] = x[k].z;
      }
      break;
    }
    default: {
      const uint4* q = reinterpret_cast<const uint4*>(static_cast<const uint32_t*>(p) + r0);
      const uint4 a = __ldg(q), b = __ldg(q + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  }
}

__device__ __forceinline__ uint2 bits_to_bytes(uint32_t bits) {
  uint2 b;
  b.x = (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) | ((bits & 8u) << 21);
  b.y = ((bits >> 4) & 1u) | (((bits >> 4) & 2u) << 7) | (((bits >> 4) & 4u) << 14) |
        (((bits >> 4) & 8u) << 21);
  return b;
}

__global__ void __launch_bounds__(kThreads)
in_set_scan_kernel(Cols cols, const uint32_t* __restrict__ codes, int32_t n_codes,
                   int64_t shift, int64_t n, int64_t n_pad, int32_t and_into,
                   uint8_t* __restrict__ out) {
  extern __shared__ uint32_t sh_codes[];
  const int total = cols.n_cols * n_codes;
  for (int j = threadIdx.x; j < total; j += blockDim.x) sh_codes[j] = codes[j];
  __syncthreads();

  const int64_t r0 = 8 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) - shift;
  if (r0 >= n_pad) return;
  uint32_t hit = 0xffu;  // bit k: row r0 + k
  const bool full = r0 >= 0 && r0 + 8 <= n;
  if (!full) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (r0 + k < 0 || r0 + k >= n) hit &= ~(1u << k);
  }
  if (hit) {
    // fully unrolled, so that every index into the parameter table is a
    // constant and the table stays in the constant bank
#pragma unroll
    for (int c0 = 0; c0 < kMaxCols; c0 += kLoadCols) {
      if (c0 >= cols.n_cols) break;
      uint32_t v[kLoadCols][8];
#pragma unroll
      for (int j = 0; j < kLoadCols; ++j) {
        const int c = c0 + j;
        if (c >= cols.n_cols) break;
        const bool sgn = (cols.sign_mask >> c) & 1u;
        if (full && ((cols.vec_mask >> c) & 1u)) {
          load8(cols.ptr[c], cols.width[c], sgn, r0, v[j]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[j][k] = ((hit >> k) & 1u) ? load_one(cols.ptr[c], cols.width[c], sgn, r0 + k) : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadCols; ++j) {
        const int c = c0 + j;
        if (c >= cols.n_cols) break;
        const uint32_t* cc = sh_codes + c * n_codes;
        uint32_t m = 0;
        for (int s = 0; s < n_codes; ++s) {
          const uint32_t code = cc[s];
#pragma unroll
          for (int k = 0; k < 8; ++k) m |= (uint32_t)(v[j][k] == code) << k;
        }
        hit &= m;
      }
    }
  }

  const bool vec_out = r0 >= 0 && r0 + 8 <= n_pad && (((uintptr_t)(out + r0)) & 7) == 0;
  if (vec_out) {
    uint2* o = reinterpret_cast<uint2*>(out + r0);
    uint2 b = bits_to_bytes(hit);
    if (and_into) {
      const uint2 prev = *o;
      b.x &= prev.x;
      b.y &= prev.y;
    }
    *o = b;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int64_t r = r0 + k;
      if (r < 0 || r >= n_pad) continue;
      const uint8_t bit = (hit >> k) & 1u;
      out[r] = and_into ? (uint8_t)(out[r] & bit) : bit;
    }
  }
}

// ---------------------------------------------------------------------------
// u64_range_scan
//
// Replaces _range_kernel / _range_call (tempo_tpu/ops/pallas_kernels.py:
// 152-182): lo_bound <= v <= hi_bound on 64-bit values held as (hi, lo)
// uint32 limbs. Rows >= n are written False (the wrapper's mask, :603-604).
//
// What bounds it: memory, 8 bytes read and 1 written per row. Hopper compares
// 64-bit integers natively, so the limbs are joined in registers and compared
// once; the limb layout stays at the interface so that results compare one
// for one with the JAX kernel.
// ---------------------------------------------------------------------------

__global__ void u64_range_scan_kernel(const uint32_t* __restrict__ hi,
                                      const uint32_t* __restrict__ lo,
                                      unsigned long long lo_bound,
                                      unsigned long long hi_bound,
                                      int64_t n_pad, int64_t n,
                                      uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n_pad; r += stride) {
    const unsigned long long v = ((unsigned long long)hi[r] << 32) | lo[r];
    out[r] = (r < n && v >= lo_bound && v <= hi_bound) ? 1 : 0;
  }
}

int grid_for(int64_t n, int max_blocks) {
  int64_t g = (n + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  return (int)(g < max_blocks ? g : max_blocks);
}

// cudaFuncSetAttribute once per device for each instance of the kernel
template <bool kWeighted, bool kHashed>
cudaError_t opt_in_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(seg_bincount_kernel<kWeighted, kHashed>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemSlots * (int)sizeof(uint32_t));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <bool kWeighted, bool kHashed>
cudaError_t launch_bincount(const Rows& r, int32_t n_slots, u64* out, cudaStream_t st) {
  cudaError_t err = opt_in_smem<kWeighted, kHashed>();
  if (err != cudaSuccess) return err;
  const int64_t counters = kHashed ? kHashSlots : n_slots;
  const size_t smem = kHashed ? 2 * kHashSlots * sizeof(uint32_t)
                              : (size_t)cdiv(n_slots, 4) * sizeof(uint4);
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, seg_bincount_kernel<kWeighted, kHashed>, kBinThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t sms = sm_count();
  // at least one 4-row group a thread up to one block per SM; more blocks
  // only while each still folds 8x its counters in rows; never more rows in
  // a block than the 32-bit counters hold exactly
  int64_t blocks = std::max(std::min(cdiv(r.n, 8 * counters), (int64_t)occ * sms),
                            std::min(cdiv(r.groups, kBinThreads), sms));
  blocks = std::max(blocks, cdiv(r.groups, kWeighted ? kWeightedGroups : kUnweightedGroups));
  blocks = std::max<int64_t>(blocks, 1);
  const int64_t per_block = std::max<int64_t>(cdiv(r.groups, blocks), 1);
  seg_bincount_kernel<kWeighted, kHashed><<<(unsigned)blocks, kBinThreads, smem, st>>>(
      r, per_block, n_slots, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// slots, weights (nullable): (n,) int32; out: (n_slots,) int64, which the
// kernel adds into (zeroed by the caller, or holding earlier counts).
int tt_seg_bincount(const void* slots, const void* weights, int64_t n,
                    int32_t n_slots, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Rows r = make_rows((const int32_t*)slots, (const int32_t*)weights, n);
  u64* o = (u64*)out;
  const bool weighted = weights != nullptr;
  cudaError_t err;
  if (n_slots <= kSmemSlots) {
    err = weighted ? launch_bincount<true, false>(r, n_slots, o, st)
                   : launch_bincount<false, false>(r, n_slots, o, st);
  } else {
    err = weighted ? launch_bincount<true, true>(r, n_slots, o, st)
                   : launch_bincount<false, true>(r, n_slots, o, st);
  }
  return (int)err;
}

// cols: n_cols column pointers, each (n,) of widths[c] bytes an element
// (bit c of sign_mask: sign-extend); codes: (n_cols, n_codes) uint32;
// out: (n_pad,) uint8. One launch per kMaxCols columns.
int tt_in_set_scan(const void* const* cols, const int32_t* widths, uint32_t sign_mask,
                   int32_t n_cols, const void* codes, int32_t n_codes, int64_t n,
                   int64_t n_pad, void* out, void* stream) {
  // groups of 8 rows start where column 0 is aligned for its vector load
  const int64_t w0 = widths[0];
  const int64_t a0 = std::min<int64_t>(16, 8 * w0);
  const int64_t first = (int64_t)(((a0 - ((uintptr_t)cols[0] & (a0 - 1))) & (a0 - 1)) / w0);
  const int64_t shift = (8 - first % 8) % 8;
  const int64_t groups = cdiv(n_pad + shift, 8);
  const unsigned blocks = (unsigned)std::max<int64_t>(cdiv(groups, kThreads), 1);
  for (int32_t c0 = 0; c0 < n_cols; c0 += kMaxCols) {
    Cols t;
    t.n_cols = std::min(kMaxCols, n_cols - c0);
    t.sign_mask = 0;
    t.vec_mask = 0;
    for (int j = 0; j < t.n_cols; ++j) {
      const int64_t w = widths[c0 + j];
      const int64_t a = std::min<int64_t>(16, 8 * w);
      t.ptr[j] = cols[c0 + j];
      t.width[j] = (int32_t)w;
      t.sign_mask |= ((sign_mask >> (c0 + j)) & 1u) << j;
      if ((((uintptr_t)cols[c0 + j] - (uintptr_t)(shift * w)) & (a - 1)) == 0) t.vec_mask |= 1u << j;
    }
    const size_t smem = (size_t)t.n_cols * n_codes * sizeof(uint32_t);
    in_set_scan_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        t, (const uint32_t*)codes + (int64_t)c0 * n_codes, n_codes, shift, n, n_pad, c0 > 0,
        (uint8_t*)out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// hi, lo: (n_pad,) uint32; out: (n_pad,) uint8.
int tt_u64_range_scan(const void* hi, const void* lo, unsigned long long lo_bound,
                      unsigned long long hi_bound, int64_t n_pad, int64_t n,
                      void* out, void* stream) {
  u64_range_scan_kernel<<<grid_for(n_pad, 132 * 16), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)hi, (const uint32_t*)lo, lo_bound, hi_bound, n_pad, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

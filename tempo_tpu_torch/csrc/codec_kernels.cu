// Hand-written Hopper (sm_90a) kernels of the vtpu1 codec in tempo_tpu_torch:
// the device page-encode arm (rle_change_mask, dbp_pack) and the compiled
// query tier (dbp_decode, compiled_metrics).
//
// These replace jitted device programs of the JAX package, not Pallas
// kernels: ops/encode.py's _rle_kernel, _dbp_kernel and _pack_kernel,
// ops/pallas_kernels.py's _dbp_decode_jit and compiled/program.py's
// build_metrics_program. Each computes the same function as its plain
// PyTorch version beside its wrapper (tempo_tpu_torch/ops/encode.py,
// ops/pallas_kernels.py, compiled/program.py). The interface is plain C,
// as in kernels.cu: pointers, sizes and the CUDA stream as arguments, bound
// with ctypes. Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing (the wrapper passes outputs and scratch),
// and returns the first non-zero cudaError_t.
//
// uint32 data arrives as the bits of int32 tensors and uint64 data as the
// bits of int64 tensors; the kernels read both as unsigned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libtempo_codec_kernels.so codec_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

using u64 = unsigned long long;

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Batched page encode: rle_change_mask and dbp_pack
//
// Each launch covers every page of a batch (the block writer's batch is one
// row group's lightweight pages). The pages' u32 sources lie in one flat
// buffer; a page table in device memory (int64 rows, offsets in u32 words)
// says where each page's sources are, where its output words go and which
// tile is its first; a flattened tile list (int32, one entry a tile) names
// each tile's page, so a block finds its page with one load and no page is
// padded or launched alone. Both kernels stage a tile in shared memory with
// cp.async 16-byte copies (scalar loads where a segment is not 16-byte
// aligned, and for the tail), so each input word is read from device memory
// once and no register holds it on the way, and mask the ragged end of each
// page themselves.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Issue dst[0, count) = src[0, count) for the block's threads together (dst
// 16-byte aligned); complete with cp_async_wait_all() and a barrier.
__device__ __forceinline__ void stage_async(uint32_t* __restrict__ dst,
                                            const uint32_t* __restrict__ src, int64_t count) {
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int64_t n4 = count >> 2;
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int64_t i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// rle_change_mask
//
// Replaces _rle_kernel (tempo_tpu/ops/encode.py:135-144): for each page of
// (rows, lanes) uint32 lanes, mark i (i < rows - 1) = row i+1 differs from
// row i in some lane. Marks are stored as bits, 32 rows a word (bit i % 32 of
// word i / 32), from the page's out_off; the host turns them into run firsts
// and lengths. Page table: in_off, rows, lanes, out_off, first_tile,
// tile_rows.
//
// What bounds it: memory, 4 * lanes bytes read a row and one bit written.
// The earlier design (one launch a page, a thread a row, a byte a mark)
// read each row twice (as its own row and as the row before's neighbour)
// and paid a launch, a copy and a device-wide sync for each of a row
// group's pages, far above the sub-microsecond bound of a page. Design: one
// launch for the batch; a block stages one tile of a page, tile_rows rows
// (a power of two, tile_rows * lanes <= 2048 words: every tile about 8 KB
// whatever its lanes) plus one halo row, each row read from device memory
// once; each thread compares its rows with the next from shared memory (as
// 16- or 8-byte vectors where the lanes allow), a warp ballot turns 32 marks
// into a word, and the tile's words are stored whole. Rows past the page's
// end give zero bits.
// ---------------------------------------------------------------------------

constexpr int kRleFields = 6;
constexpr int kMaxTileRows = 2048;

__global__ void __launch_bounds__(kThreads) rle_change_mask_kernel(
    const uint32_t* __restrict__ data, const int64_t* __restrict__ table,
    const int32_t* __restrict__ tile_page, uint32_t* __restrict__ out) {
  extern __shared__ uint4 rows_sh4[];
  __shared__ uint32_t words_sh[kMaxTileRows / 32];
  uint32_t* rows_sh = reinterpret_cast<uint32_t*>(rows_sh4);
  const int64_t tile = blockIdx.x;
  const int64_t* e = table + (int64_t)__ldg(tile_page + tile) * kRleFields;
  const int64_t rows = e[1];
  const int k = (int)e[2];
  const int tile_rows = (int)e[5];
  const int64_t r0 = (tile - e[4]) * tile_rows;
  const int64_t r_end = min64(r0 + tile_rows + 1, rows);  // the tile's rows and the halo row
  stage_async(rows_sh, data + e[0] + r0 * k, (r_end - r0) * k);
  cp_async_wait_all();
  __syncthreads();
  const int64_t marks = rows - 1;
  for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) {  // tile_rows % 32 == 0: whole warps
    bool diff = false;
    if (r0 + i < marks) {
      const uint32_t* a = rows_sh + i * k;
      const uint32_t* b = a + k;
      uint32_t x = 0;
      if ((k & 3) == 0) {
        for (int c = 0; c < k; c += 4) {
          const uint4 u = *reinterpret_cast<const uint4*>(a + c);
          const uint4 v = *reinterpret_cast<const uint4*>(b + c);
          x |= (u.x ^ v.x) | (u.y ^ v.y) | (u.z ^ v.z) | (u.w ^ v.w);
        }
      } else if ((k & 1) == 0) {
        for (int c = 0; c < k; c += 2) {
          const uint2 u = *reinterpret_cast<const uint2*>(a + c);
          const uint2 v = *reinterpret_cast<const uint2*>(b + c);
          x |= (u.x ^ v.x) | (u.y ^ v.y);
        }
      } else {
        for (int c = 0; c < k; ++c) x |= a[c] ^ b[c];
      }
      diff = x != 0u;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, diff);
    if ((threadIdx.x & 31) == 0) words_sh[i >> 5] = word;
  }
  __syncthreads();
  const int64_t w0 = r0 >> 5;
  const int64_t n_words = min64(tile_rows >> 5, ((marks + 31) >> 5) - w0);
  for (int j = threadIdx.x; j < n_words; j += blockDim.x) out[e[3] + w0 + j] = words_sh[j];
}

// ---------------------------------------------------------------------------
// dbp_pack
//
// Replaces _dbp_kernel and _pack_kernel through _pack_lanes
// (tempo_tpu/ops/encode.py:124-202). Column table: lo_off, hi_off, rows,
// item_bits, width, out_off, first_tile, 0. Delta mode (item_bits
// 8/16/32/64): the rows - 1 deltas of rows i and i+1 of the column's uint32
// limbs (the high limbs at hi_off for 64-bit items), wrapped to the item
// width and sign-extended to 64 bits, zigzagged (low limb only: widths are
// capped at 32). Pack mode (item_bits 0): the rows values as they are (a dct
// index stream). The m values pack at the column's static width w (1..32)
// into a little-endian bit stream, value i at bits [i*w, (i+1)*w), stored as
// ceil(m*w/32) words from out_off whose bytes are np.packbits(bitorder=
// "little")'s, the spare bits zero.
//
// What bounds it: memory, 4 (8 for 64-bit items) bytes read a value and w/8
// written. The earlier design launched once a page (and once per 16 columns,
// its column table passed by value), and built each output word from device
// memory, recomputing the zigzag of every value whose bits straddle two
// words. Design: the column table lives in device memory (no cap on
// columns; both modes in one launch); a block takes kPackValues values of
// one column, so its words are exactly 64 * w, none shared with another
// block. It stages the values and the one after (for the last delta) in
// shared memory, computes each zigzag once (in registers, then into shared
// memory with one pad word every 32), and builds each output word from the
// at most ceil(32/w) + 1 values that overlap it (a 64-bit window cut by a
// funnel shift). Word j starts at value 32j/w, so the lanes of a warp read
// 32/w words apart: unpadded, that is a 2- to 32-way bank conflict at the
// small widths of dct index streams, and shared memory, not device memory,
// became the limit; the pad word spreads those reads over the banks.
// Consecutive threads store consecutive words, so a warp's stores coalesce.
// Values past the column's end are zero, so the ragged end needs no padding.
// ---------------------------------------------------------------------------

constexpr int kDbpFields = 8;
constexpr int kPackValues = 2048;
constexpr int kPackPerThread = kPackValues / kThreads;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ uint32_t zigzag_lo(uint32_t a, uint32_t b, uint32_t ha, uint32_t hb,
                                              int item_bits) {
  uint32_t d_lo, d_hi;
  if (item_bits == 64) {
    d_lo = b - a;
    d_hi = hb - ha - (b < a ? 1u : 0u);
  } else if (item_bits == 32) {
    d_lo = b - a;
    d_hi = 0u - (d_lo >> 31);
  } else {
    const uint32_t mask = (1u << item_bits) - 1u;
    const uint32_t d_w = (b - a) & mask;
    const uint32_t sign = (d_w >> (item_bits - 1)) & 1u;
    d_lo = d_w | (sign ? ~mask : 0u);
    d_hi = 0u - sign;
  }
  return (d_lo << 1) ^ (0u - (d_hi >> 31));
}

__global__ void __launch_bounds__(kThreads) dbp_pack_kernel(
    const uint32_t* __restrict__ data, const int64_t* __restrict__ table,
    const int32_t* __restrict__ tile_col, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t lo_sh[kPackValues + 4];
  // the high limbs, then the zigzags (value i at padded(i))
  __shared__ __align__(16) uint32_t hi_sh[kPackValues + kPackValues / 32 + 4];
  const int64_t tile = blockIdx.x;
  const int64_t* e = table + (int64_t)__ldg(tile_col + tile) * kDbpFields;
  const int64_t rows = e[2];
  const int item_bits = (int)e[3];
  const int w = (int)e[4];
  const int64_t m = item_bits ? rows - 1 : rows;
  const int64_t v0 = (tile - e[6]) * kPackValues;
  const int64_t count = min64(v0 + kPackValues + 1, rows) - v0;
  stage_async(lo_sh, data + e[0] + v0, count);
  if (item_bits == 64) stage_async(hi_sh, data + e[1] + v0, count);
  cp_async_wait_all();
  __syncthreads();
  const uint32_t vmask = w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  uint32_t z[kPackPerThread];
#pragma unroll
  for (int j = 0; j < kPackPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    uint32_t v = 0u;
    if (v0 + i < m) {
      v = item_bits == 0 ? lo_sh[i]
          : item_bits == 64 ? zigzag_lo(lo_sh[i], lo_sh[i + 1], hi_sh[i], hi_sh[i + 1], 64)
                            : zigzag_lo(lo_sh[i], lo_sh[i + 1], 0u, 0u, item_bits);
    }
    z[j] = v & vmask;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPackPerThread; ++j) hi_sh[padded(threadIdx.x + j * kThreads)] = z[j];
  __syncthreads();
  const int tile_words = (kPackValues / 32) * w;
  const int64_t wbase = (tile - e[6]) * tile_words;
  const int64_t n_words = min64(tile_words, ((m * w + 31) >> 5) - wbase);
  uint32_t* dst = out + e[5] + wbase;
  for (int j = threadIdx.x; j < n_words; j += blockDim.x) {
    const int bit0 = j * 32;
    const int i0 = bit0 / w;
    const int s = bit0 - i0 * w;  // bits of value i0 below the word
    unsigned long long acc = 0ull;
    for (int i = i0, sh = 0; sh < s + 32; ++i, sh += w)
      acc |= (unsigned long long)hi_sh[padded(i)] << sh;
    dst[j] = __funnelshift_r((uint32_t)acc, (uint32_t)(acc >> 32), s);
  }
}

// ---------------------------------------------------------------------------
// dbp_decode
//
// Replaces _dbp_decode_jit with _limb_add (tempo_tpu/ops/pallas_kernels.py:
// 373-417): for each unit u, packed zigzag deltas of width w_u <= 32 in
// uint32 words, and a first value -> n absolute uint64 values, the inclusive
// prefix sum of [first, d_0, ..., d_{n-2}] modulo 2^64. Each delta is
// extracted from the one or two words its bits straddle (shift counts kept
// below 32), unzigzagged in 32 bits and sign-extended, which is exact since
// |delta| < 2^31.
//
// What bounds it: memory, w/8 bytes read and 8 written a value; the TPU
// carried u64 as two u32 limbs through an associative scan, Hopper adds
// 64-bit integers natively. Design: one block of 256 threads a unit walks its
// values in tiles of 1024 (4 consecutive values a thread): a thread sums its
// 4 deltas, a warp-shuffle scan and a scan of the 8 warp totals in shared
// memory give each thread its offset, and a 64-bit carry runs from tile to
// tile. Simple, not fast: a single unit of many values runs on one SM.
// ---------------------------------------------------------------------------

constexpr int kScanItems = 4;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ u64 dbp_delta(const uint32_t* __restrict__ words, int64_t n_words,
                                         int64_t j, uint32_t w, uint32_t mask) {
  if (w == 0) return 0ull;
  const u64 off = (u64)j * w;
  const int64_t wi = (int64_t)(off >> 5);
  const uint32_t rem = (uint32_t)(off & 31u);
  const uint32_t lo_w = wi < n_words ? words[wi] : 0u;
  const uint32_t hi_w = wi + 1 < n_words ? words[wi + 1] : 0u;
  const uint32_t hi_part = rem == 0u ? 0u : (hi_w << ((32u - rem) & 31u));
  const uint32_t z = ((lo_w >> rem) | hi_part) & mask;
  const uint32_t d = (z >> 1) ^ (0u - (z & 1u));
  return (u64)(int64_t)(int32_t)d;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Block-wide exclusive offset of each thread's `sum` (in thread order) and the
// block total. Ends with a barrier, so warp_tot may be reused at once.
template <typename T>
__device__ __forceinline__ T block_exclusive(T sum, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_scan(sum);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const T s = warp_tot[k];
    before += k < warp ? s : (T)0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - sum;
}

__global__ void __launch_bounds__(kThreads) dbp_decode_kernel(
    const uint32_t* __restrict__ words, int64_t words_stride, const u64* __restrict__ first,
    const int32_t* __restrict__ width, int64_t n, u64* __restrict__ out) {
  __shared__ u64 warp_tot[kWarps];
  const int64_t u = blockIdx.x;
  const uint32_t* wu = words + u * words_stride;
  u64* ou = out + u * n;
  const uint32_t w = (uint32_t)width[u];
  const uint32_t mask = w >= 32u ? 0xFFFFFFFFu : ((1u << w) - 1u);
  u64 carry = first[u];
  constexpr int64_t kTile = (int64_t)kThreads * kScanItems;
  for (int64_t t0 = 0; t0 < n; t0 += kTile) {
    const int64_t base = t0 + (int64_t)threadIdx.x * kScanItems;
    u64 v[kScanItems];
    u64 sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = base + k;
      // element i > 0 adds delta i-1; element 0 is the first value (the carry)
      sum += (i > 0 && i < n) ? dbp_delta(wu, words_stride, i - 1, w, mask) : 0ull;
      v[k] = sum;
    }
    u64 tile_total;
    const u64 off = carry + block_exclusive(sum, warp_tot, &tile_total);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = base + k;
      if (i < n) ou[i] = off + v[k];
    }
    carry += tile_total;
  }
}

// ---------------------------------------------------------------------------
// compiled_metrics
//
// Replaces the fused program of build_metrics_program (tempo_tpu/compiled/
// program.py:58-123): for Q query lanes over U stacked units of n_pad rows,
// the AND of the column hits (an rle run's verdict repeated to its rows, a
// dct dictionary entry's verdict gathered by the row's index, a dbp decoded
// value in an inclusive u64 range; set verdicts inverted for != and !~),
// then `valid`, t_s >= start and bin = (t_s - start) / step < n_bins (u32
// throughout), counted into (Q, slot_pad) int64 bins.
//
// What bounds it: memory for the rows (t_s, valid and one payload word a
// column a row, read once per lane) and the atomics of hot bins; a metrics
// window puts a row group's rows into few bins. Design: a first kernel
// computes each rle column's run starts per unit on the card (an exclusive
// block scan of the run lengths), so a row finds its run by a binary search
// over them; dbp columns arrive decoded by a dbp_decode launch just before
// (the reference fuses the decode; here it is a second kernel of the same
// dispatch). The counting kernel runs one thread a row over a (row tiles,
// U, Q) grid, counts into 32-bit shared-memory bins when slot_pad fits in
// 48 KB, and merges each non-zero bin into the int64 output with one
// atomic. Rows past a unit's length are dropped by `valid` before any
// payload is read, never by the value they hold.
// ---------------------------------------------------------------------------

constexpr int kMaxCCols = 16;
constexpr int kDescFields = 11;
constexpr int32_t kSmemBins = 48 * 1024 / 4;

struct CCol {
  int32_t codec;    // 0 rle, 1 dct, 2 dbp
  int32_t kind;     // 0 set, 1 range
  int32_t invert;   // set: the verdict is inverted
  int32_t pad;      // rle: runs a unit (RP); dct: dictionary entries a unit (VP)
  int32_t n_codes;  // set: codes a (lane, unit) (K)
  const uint32_t* values;   // rle (U, RP) run values; dct (U, VP) dictionary
  const int32_t* aux;       // rle (U, RP) run lengths; dct (U, n_pad) indices
  int32_t* starts;          // rle (U, RP + 1) run starts, written by run_starts_kernel
  const u64* decoded;       // dbp (U, n_pad) values
  const uint32_t* codes;    // set (Q, U, K)
  const u64* bounds;        // range (Q, 2): inclusive lo, hi
};

struct CCols {
  int32_t n_cols;
  CCol c[kMaxCCols];
};

__global__ void __launch_bounds__(kThreads) run_starts_kernel(const int32_t* __restrict__ lengths,
                                                              int64_t rp, int32_t* __restrict__ starts) {
  __shared__ int32_t warp_tot[kWarps];
  const int64_t u = blockIdx.x;
  const int32_t* lu = lengths + u * rp;
  int32_t* su = starts + u * (rp + 1);
  int32_t carry = 0;
  constexpr int64_t kTile = (int64_t)kThreads * kScanItems;
  for (int64_t t0 = 0; t0 < rp; t0 += kTile) {
    const int64_t base = t0 + (int64_t)threadIdx.x * kScanItems;
    int32_t v[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = sum;  // exclusive within the thread
      sum += base + k < rp ? lu[base + k] : 0;
    }
    int32_t tile_total;
    const int32_t off = carry + block_exclusive(sum, warp_tot, &tile_total);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (base + k < rp) su[base + k] = off + v[k];
    carry += tile_total;
  }
  if (threadIdx.x == 0) su[rp] = carry;
}

__device__ __forceinline__ bool col_hit(const CCol& cc, int64_t u, int64_t q, int64_t n_units,
                                        int64_t n_pad, int64_t r) {
  u64 v;
  if (cc.codec == 0) {
    // the last run k with start_k <= r (jnp.repeat fills rows past the
    // lengths' sum with the last run; such rows are not valid)
    const int32_t* st = cc.starts + u * (cc.pad + 1);
    int32_t lo = 0, hi = cc.pad - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (st[mid] <= r) lo = mid; else hi = mid - 1;
    }
    v = cc.values[u * cc.pad + lo];
  } else if (cc.codec == 1) {
    v = cc.values[u * cc.pad + cc.aux[u * n_pad + r]];
  } else {
    v = cc.decoded[u * n_pad + r];
  }
  if (cc.kind == 1) return v >= cc.bounds[2 * q] && v <= cc.bounds[2 * q + 1];
  const uint32_t* codes = cc.codes + (q * n_units + u) * cc.n_codes;
  bool h = false;
  for (int32_t s = 0; s < cc.n_codes; ++s) h |= (uint32_t)v == codes[s];
  return h != (cc.invert != 0);
}

__global__ void __launch_bounds__(kThreads) compiled_metrics_kernel(
    CCols cols, const uint32_t* __restrict__ t_s, const uint8_t* __restrict__ valid,
    int64_t n_pad, const uint32_t* __restrict__ tb, const uint32_t* __restrict__ nb,
    int32_t slot_pad, int32_t smem_bins, u64* __restrict__ out) {
  extern __shared__ uint32_t bins_sh[];
  const int64_t u = blockIdx.y, q = blockIdx.z, n_units = gridDim.y;
  for (int32_t s = threadIdx.x; s < smem_bins; s += blockDim.x) bins_sh[s] = 0u;
  __syncthreads();
  const uint32_t start = tb[2 * q], step = tb[2 * q + 1], n_bins = nb[q];
  u64* out_q = out + q * slot_pad;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n_pad; r += stride) {
    const int64_t row = u * n_pad + r;
    if (!valid[row]) continue;
    const uint32_t ts = t_s[row];
    if (ts < start) continue;
    const uint32_t bin = (ts - start) / step;
    if (bin >= n_bins) continue;
    bool hit = true;
    for (int32_t c = 0; c < cols.n_cols && hit; ++c) hit = col_hit(cols.c[c], u, q, n_units, n_pad, r);
    if (!hit) continue;
    if (smem_bins) atomicAdd(&bins_sh[bin], 1u);
    else atomicAdd(&out_q[bin], 1ull);
  }
  if (!smem_bins) return;
  __syncthreads();
  for (int32_t s = threadIdx.x; s < smem_bins; s += blockDim.x)
    if (bins_sh[s]) atomicAdd(&out_q[s], (u64)bins_sh[s]);
}

}  // namespace

extern "C" {

// data: the batch's flat uint32 sources; table: pages x 6 int64 in device
// memory (in_off, rows >= 2, lanes, out_off, first_tile, tile_rows: a
// multiple of 32 up to 2048); tile_page: n_tiles int32 in device memory,
// each tile's page (a page's ceil((rows - 1) / tile_rows) tiles, in order
// from first_tile); stage_words: the most words a tile stages,
// (tile_rows + 1) * lanes over the pages (the dynamic shared memory); out:
// uint32 mark words.
int tt_rle_change_mask(const void* data, const void* table, const void* tile_page,
                       int64_t n_tiles, int32_t stage_words, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = ((size_t)stage_words * 4 + 15) & ~(size_t)15;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rle_change_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rle_change_mask_kernel<<<(unsigned)n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)data, (const int64_t*)table, (const int32_t*)tile_page, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// data: the batch's flat uint32 sources; table: columns x 8 int64 in device
// memory (lo_off, hi_off, rows, item_bits, width 1..32, out_off, first_tile,
// 0); tile_col: n_tiles int32 in device memory, each tile's column (a
// column's ceil(m / 2048) tiles for its m values, in order from first_tile);
// out: uint32 stream words.
int tt_dbp_pack(const void* data, const void* table, const void* tile_col, int64_t n_tiles,
                void* out, void* stream) {
  if (n_tiles == 0) return 0;
  dbp_pack_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)data, (const int64_t*)table, (const int32_t*)tile_col, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// words: (U, words_stride) uint32; first: (U,) uint64; width: (U,) int32;
// out: (U, n) uint64.
int tt_dbp_decode(const void* words, int64_t words_stride, const void* first, const void* width,
                  int32_t n_units, int64_t n, void* out, void* stream) {
  if (n_units == 0 || n == 0) return 0;
  dbp_decode_kernel<<<(unsigned)n_units, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, words_stride, (const u64*)first, (const int32_t*)width, n,
      (u64*)out);
  return (int)cudaGetLastError();
}

// desc: n_cols x 11 int64 on the host, per column: codec, kind, invert, pad,
// n_codes, then device pointers values, aux, starts (scratch), decoded,
// codes, bounds (0 where unused). t_s: (U, n_pad) uint32; valid: (U, n_pad)
// uint8; tb: (Q, 2) uint32 start, step; nb: (Q,) uint32; out: (Q, slot_pad)
// int64, zeroed by the caller.
int tt_compiled_metrics(const int64_t* desc, int32_t n_cols, const void* t_s, const void* valid,
                        int64_t n_pad, int32_t n_units, int32_t n_q, const void* tb,
                        const void* nb, int32_t slot_pad, void* out, void* stream) {
  if (n_cols > kMaxCCols) return (int)cudaErrorInvalidValue;
  if (n_units == 0 || n_q == 0 || n_pad == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  CCols cols;
  cols.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    const int64_t* d = desc + c * kDescFields;
    CCol& cc = cols.c[c];
    cc.codec = (int32_t)d[0];
    cc.kind = (int32_t)d[1];
    cc.invert = (int32_t)d[2];
    cc.pad = (int32_t)d[3];
    cc.n_codes = (int32_t)d[4];
    cc.values = (const uint32_t*)d[5];
    cc.aux = (const int32_t*)d[6];
    cc.starts = (int32_t*)d[7];
    cc.decoded = (const u64*)d[8];
    cc.codes = (const uint32_t*)d[9];
    cc.bounds = (const u64*)d[10];
    if (cc.codec == 0) {
      run_starts_kernel<<<(unsigned)n_units, kThreads, 0, st>>>(cc.aux, cc.pad, cc.starts);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const int32_t smem_bins = slot_pad <= kSmemBins ? slot_pad : 0;
  const unsigned tiles = (unsigned)std::max<int64_t>(1, std::min<int64_t>(cdiv(n_pad, kThreads), 64));
  const dim3 grid(tiles, (unsigned)n_units, (unsigned)n_q);
  compiled_metrics_kernel<<<grid, kThreads, (size_t)smem_bins * sizeof(uint32_t), st>>>(
      cols, (const uint32_t*)t_s, (const uint8_t*)valid, n_pad, (const uint32_t*)tb,
      (const uint32_t*)nb, slot_pad, smem_bins, (u64*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

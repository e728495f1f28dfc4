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
constexpr int kMaxGrid = 132 * 16;

using u64 = unsigned long long;

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

unsigned grid_for(int64_t n) {
  return (unsigned)std::max<int64_t>(1, std::min<int64_t>(cdiv(n, kThreads), kMaxGrid));
}

// ---------------------------------------------------------------------------
// rle_change_mask
//
// Replaces _rle_kernel (tempo_tpu/ops/encode.py:135-144): over (n_pad, k)
// uint32 lanes, out[i] = row i+1 differs from row i in any lane, for
// i < n_pad - 1. The host turns the mask into run firsts and lengths.
//
// What bounds it: memory, 4k bytes read and one written a row. One thread a
// row; neighbouring threads read neighbouring rows, so the loads of a warp
// are contiguous, and each row is read by two threads (its own and the one
// before), the second time from L1/L2.
// ---------------------------------------------------------------------------

__global__ void rle_change_mask_kernel(const uint32_t* __restrict__ a, int64_t n_pad, int32_t k,
                                       uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_pad - 1; i += stride) {
    const uint32_t* r0 = a + i * k;
    uint32_t diff = 0;
    for (int32_t c = 0; c < k; ++c) diff |= r0[c] ^ r0[c + k];
    out[i] = diff != 0u;
  }
}

// ---------------------------------------------------------------------------
// dbp_pack
//
// Replaces _dbp_kernel and _pack_kernel through _pack_lanes
// (tempo_tpu/ops/encode.py:124-202). Delta mode (item_bits 8/16/32/64): for
// each sub-column c of lo/hi uint32 limb planes (k, n_pad), the delta of rows
// i and i+1 wrapped to the item width and sign-extended to 64 bits, its
// zigzag (low limb only: widths are capped at 32), packed at the column's
// static width w into a little-endian bit stream (value i at bits
// [i*w, (i+1)*w)), the n_pad-th value being zero. Pack mode (item_bits 0):
// the bitpack of a uint32 index stream (dct). The words of the stream, read
// as bytes, are np.packbits(bitorder="little")'s bytes.
//
// What bounds it: memory, 4 (8 for 64-bit items) bytes read a value and w/8
// written. The TPU built a (values, w) bit matrix and folded bytes with a
// weighted sum; here one thread builds one output word from the at most
// ceil(32/w)+1 values whose bits overlap it, computing each delta and zigzag
// in registers from rows i and i+1: no bit matrix, no atomics, each output
// word written once. Width 0 gives an empty stream.
// ---------------------------------------------------------------------------

constexpr int kMaxPackCols = 16;

struct PackCols {
  int32_t n_cols;
  int32_t width[kMaxPackCols];
  int64_t word_off[kMaxPackCols + 1];  // first output word of each column; [n_cols] = total
};

__device__ __forceinline__ uint32_t zigzag_lo(const uint32_t* __restrict__ lo,
                                              const uint32_t* __restrict__ hi, int64_t i,
                                              int item_bits) {
  const uint32_t a = lo[i], b = lo[i + 1];
  uint32_t d_lo, d_hi;
  if (item_bits == 64) {
    d_lo = b - a;
    const uint32_t borrow = b < a ? 1u : 0u;
    d_hi = hi[i + 1] - hi[i] - borrow;
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
  const uint32_t neg = 0u - (d_hi >> 31);
  return (d_lo << 1) ^ neg;
}

__global__ void dbp_pack_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
                                int64_t n_pad, int item_bits, PackCols cols,
                                uint32_t* __restrict__ out) {
  const int c = blockIdx.y;
  const int64_t w = cols.width[c];
  const int64_t n_words = cols.word_off[c + 1] - cols.word_off[c];
  const uint32_t* lo_c = lo + (int64_t)c * n_pad;
  const uint32_t* hi_c = item_bits == 64 ? hi + (int64_t)c * n_pad : nullptr;
  uint32_t* out_c = out + cols.word_off[c];
  const uint32_t vmask = w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  // delta mode: n_pad - 1 zigzags, then the zero value; pack mode: n_pad values
  const int64_t last = item_bits ? n_pad - 2 : n_pad - 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n_words; j += stride) {
    const int64_t bit0 = j * 32;
    const int64_t i_hi = (bit0 + 31) / w;
    const int64_t i_end = i_hi < last ? i_hi : last;
    uint32_t word = 0;
    for (int64_t i = bit0 / w; i <= i_end; ++i) {
      const uint32_t z = (item_bits ? zigzag_lo(lo_c, hi_c, i, item_bits) : lo_c[i]) & vmask;
      const int64_t b = i * w - bit0;
      word |= b >= 0 ? (uint32_t)((u64)z << b) : (z >> (-b));
    }
    out_c[j] = word;
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

// a: (n_pad, k) uint32; out: (n_pad - 1,) uint8.
int tt_rle_change_mask(const void* a, int64_t n_pad, int32_t k, void* out, void* stream) {
  if (n_pad < 2) return 0;
  rle_change_mask_kernel<<<grid_for(n_pad - 1), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, n_pad, k, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// lo, hi: (k, n_pad) uint32 limb planes (hi read only for item_bits 64;
// item_bits 0 packs lo as it is); widths: k static widths <= 32;
// word_off: k + 1 word offsets into out, uint32 words.
int tt_dbp_pack(const void* lo, const void* hi, int64_t n_pad, int32_t item_bits,
                const int32_t* widths, const int64_t* word_off, int32_t k, void* out,
                void* stream) {
  for (int32_t c0 = 0; c0 < k; c0 += kMaxPackCols) {
    PackCols t;
    t.n_cols = std::min(kMaxPackCols, k - c0);
    int64_t most = 0;
    for (int j = 0; j <= t.n_cols; ++j) t.word_off[j] = word_off[c0 + j] - word_off[c0];
    for (int j = 0; j < t.n_cols; ++j) {
      t.width[j] = widths[c0 + j];
      most = std::max(most, t.word_off[j + 1] - t.word_off[j]);
    }
    if (most == 0) continue;
    const dim3 grid(grid_for(most), (unsigned)t.n_cols);
    dbp_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lo + (int64_t)c0 * n_pad,
        hi ? (const uint32_t*)hi + (int64_t)c0 * n_pad : nullptr, n_pad, item_bits, t,
        (uint32_t*)out + word_off[c0]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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

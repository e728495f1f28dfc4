// Hand-written Hopper (sm_90a) kernels of the vtpu1 codec in tempo_tpu_torch:
// the device page-encode arm (rle_change_mask, dbp_pack), the compiled
// query tier (dbp_decode, compiled_metrics) and the device tier's resident
// scans (resident_rle_scan, resident_dct_scan, resident_dbp_scan).
//
// These replace jitted device programs of the JAX package, not Pallas
// kernels: ops/encode.py's _rle_kernel, _dbp_kernel and _pack_kernel,
// ops/pallas_kernels.py's _dbp_decode_jit, compiled/program.py's
// build_metrics_program and ops/scan.py's resident scans. Each computes the
// same function as its plain PyTorch version beside its wrapper
// (tempo_tpu_torch/ops/encode.py, ops/pallas_kernels.py,
// compiled/program.py, ops/scan.py). The interface is plain C,
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

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_dependent() may start while the kernel before it on the stream
// runs, once every block of that kernel has called grid_launch_dependents();
// grid_dependency_wait() then returns when that kernel has finished and
// its writes are visible (at once when there is none).
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
// The dbp tile machinery, shared by dbp_decode and compiled_metrics
//
// A dbp stream holds a unit's zigzag deltas at a fixed width w <= 32 in
// uint32 words; element i of the unit is first + d_0 + ... + d_{i-1}
// modulo 2^64. A unit is cut into tiles of kTile elements, one block a
// tile, so tile t needs the carry first + (the delta sums of tiles
// 0..t-1) and a scan inside itself. Within a tile each lane owns kPer
// consecutive elements (warp w's lane l: elements w * kSeg + kPer * l + k),
// so its deltas are one run of kPer * w bits:
// - dbp_stage copies the words of the tile's deltas into shared memory
//   once (cp.async, 16 bytes at a time where the row is aligned), zeros
//   past the stream's end, as the plain version reads them;
// - dbp_lane_deltas cuts a lane's deltas from a sliding pair of staged
//   words (a funnel shift a delta, one new word every 32 bits);
// - dbp_tile_sum (the reduce pass) sums a tile's deltas;
// - dbp_tile_values (the scan pass) gives each lane its elements' values in
//   registers: a running sum, one warp scan of the lane totals and one
//   exchange of warp totals, from the carry of the tiles before.
// A delta is unzigzagged in 32 bits and sign-extended, which is exact
// since |delta| < 2^31.
// ---------------------------------------------------------------------------

constexpr int kTile = 2048;  // elements (rows) a block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = kTile / kWarps;     // elements a warp
constexpr int kPer = kTile / kThreads;   // consecutive elements a lane
constexpr int kTileWords = kTile / 32;   // bit-mask words a tile: word w * kPer + k, bit l
// the staged words of a tile: kTile deltas of <= 32 bits, the word one
// straddles, the word after the last (the funnel shift's high word) and
// up to 3 words of alignment, and 4 more the sliding pair may read past
constexpr int kStageWords = kTile + 12;
static_assert(kTile % (kThreads * 4) == 0, "a lane's elements are whole 16-byte loads of t_s");

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// The block's sum of `v`, to every thread; xs: kWarps u64 of shared memory.
// Ends with a barrier.
__device__ __forceinline__ u64 block_sum(u64 v, u64* xs) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) xs[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 all = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) all += xs[k];
  __syncthreads();
  return all;
}

struct DbpTile {
  const uint32_t* sh;  // staged words; sh[0] is word bit0 / 32 of the stream
  u64 bit0;
  uint32_t w, mask;
};

// Issue the copy of the words that hold the deltas of elements [i0, i1)
// (element i adds d_{i-1}) of one unit's stream of n_words words into sh
// (kStageWords, 16-byte aligned); complete with cp_async_wait_all() and a
// barrier.
__device__ __forceinline__ DbpTile dbp_stage(uint32_t* sh, const uint32_t* __restrict__ words,
                                             int64_t n_words, uint32_t w, int64_t i0, int64_t i1) {
  DbpTile t;
  t.sh = sh;
  t.bit0 = 0;
  t.w = w;
  t.mask = w >= 32u ? 0xFFFFFFFFu : ((1u << w) - 1u);
  const int64_t jlo = i0 > 0 ? i0 - 1 : 0, jend = i1 - 1;  // deltas [jlo, jend)
  if (w == 0u || jend <= jlo) return t;
  const int64_t wa = (int64_t)(((u64)jlo * w) >> 5) & ~(int64_t)3;
  const int64_t wend = (int64_t)((((u64)jend * w - 1) >> 5) + 2);
  t.bit0 = (u64)wa * 32;
  const int64_t have = min64(wend, n_words) - wa;
  if (have > 0) stage_async(sh, words + wa, have);
  for (int64_t k = (have > 0 ? have : 0) + threadIdx.x; k < wend - wa; k += blockDim.x) sh[k] = 0u;
  return t;
}

// This lane's kPer deltas: d[k] is the delta element ib + k adds (d_{ib+k-1}
// for 1 <= ib + k < n, else 0), ib = i0 + the lane's first element.
__device__ __forceinline__ void dbp_lane_deltas(const DbpTile& t, int64_t ib, int64_t n,
                                                int32_t (&d)[kPer]) {
  if (t.w == 0u) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) d[k] = 0;
    return;
  }
  const int64_t j0 = ib > 0 ? ib - 1 : 0;  // the lane's first delta
  const uint32_t off = (uint32_t)((u64)j0 * t.w - t.bit0);
  uint32_t wi = off >> 5, rem = off & 31u;
  uint32_t lo = t.sh[wi], hi = t.sh[wi + 1];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = ib + k;
    d[k] = 0;
    if (i >= 1 && i < n) {
      const uint32_t z = __funnelshift_r(lo, hi, rem) & t.mask;
      d[k] = (int32_t)((z >> 1) ^ (0u - (z & 1u)));
      rem += t.w;
      if (rem >= 32u) {
        rem -= 32u;
        ++wi;
        lo = hi;
        hi = t.sh[wi + 1];
      }
    }
  }
}

__device__ __forceinline__ int64_t lane_first(int64_t i0) {
  return i0 + (int64_t)(threadIdx.x >> 5) * kSeg + kPer * (threadIdx.x & 31);
}

// The delta sum of the tile at i0 (elements below n), to every thread; xs:
// kWarps u64. Ends with a barrier.
__device__ __forceinline__ u64 dbp_tile_sum(const DbpTile& t, int64_t i0, int64_t n, u64* xs) {
  int32_t d[kPer];
  dbp_lane_deltas(t, lane_first(i0), n, d);
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s += d[k];
  return block_sum((u64)s, xs);
}

// This thread's share of the carry into tile t: the sums of tiles [0, t)
// of its unit.
__device__ __forceinline__ u64 dbp_carry_part(const u64* __restrict__ sums, int64_t t) {
  u64 s = 0;
  for (int64_t k = threadIdx.x; k < t; k += blockDim.x) s += sums[k];
  return s;
}

// This lane's kPer values of tile `tile` (at i0 = tile * kTile; elements
// past n take no delta): `first` plus the sums of the tiles before it plus
// the deltas up to each element. The sums of the tiles before are `part`
// summed over the block (each thread's share, dbp_carry_part), or, when
// `sums` is given (the unit's tile sums, written by the launch before),
// read from it after grid_dependency_wait, once the deltas are cut. xs:
// 2 * kWarps u64. Every thread of the block calls it; it holds one barrier.
__device__ __forceinline__ void dbp_tile_values(const DbpTile& t, int64_t tile, int64_t n,
                                                u64 first, const u64* __restrict__ sums, u64 part,
                                                u64* xs, u64 (&v)[kPer]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = tile * kTile;
  int32_t d[kPer];
  dbp_lane_deltas(t, lane_first(i0), n, d);
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s += d[k];
  const u64 incl = warp_inclusive_scan((u64)s);
  if (sums) {
    grid_dependency_wait();
    part = dbp_carry_part(sums, tile);
  }
  const u64 cs = warp_sum(part);
  if (lane == 31) xs[warp] = incl;
  if (lane == 0) xs[kWarps + warp] = cs;
  __syncthreads();
  u64 acc = first + incl - (u64)s;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) acc += xs[kWarps + k] + (k < warp ? xs[k] : 0ull);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    acc += (u64)(int64_t)d[k];
    v[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// dbp_decode
//
// Replaces _dbp_decode_jit with _limb_add (tempo_tpu/ops/pallas_kernels.py:
// 373-417): for each unit u, packed zigzag deltas of width w_u <= 32 in
// uint32 words, and a first value -> n absolute uint64 values, the inclusive
// prefix sum of [first, d_0, ..., d_{n-2}] modulo 2^64. The TPU carried u64
// as two u32 limbs through an associative scan; Hopper adds 64-bit integers
// natively.
//
// What bounds it: memory, w/8 bytes read and 8 written a value. The earlier
// design ran one block a unit through its values in serial tiles of 1,024:
// 64 blocks on 132 SMs at the compiled tier's shape and one SM for a long
// column, with two scattered 4-byte word loads a value and strided 8-byte
// stores. Design: reduce, then scan, over a (tiles, units) grid:
// dbp_tile_sum_kernel writes each tile's delta sum (every tile but a unit's
// last; a unit of one tile needs no first pass), and dbp_decode_kernel
// gives its tile the carry first + the sums of the tiles before it (summed
// across the block). The scan pass is a programmatic dependent launch: it
// stages its words and cuts its deltas while the reduce pass runs, and
// waits for the sums only then. It takes each lane's values from
// dbp_tile_values and
// stores them through shared memory in element order (a pad value every 8,
// so the lanes' 64-bit stores hit distinct banks), so a warp's 32 values
// go out as 256 contiguous bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int vpad(int e) { return e + (e >> 3); }
// the staged words, then (over them: every lane has cut its deltas at the
// barrier in dbp_tile_values) the values, 64-bit with a pad every 8
constexpr int kDecodeWords = kStageWords > 2 * (kTile + kTile / 8) ? kStageWords
                                                                   : 2 * (kTile + kTile / 8);

__global__ void __launch_bounds__(kThreads) dbp_tile_sum_kernel(
    const uint32_t* __restrict__ words, int64_t words_stride, const int32_t* __restrict__ width,
    int64_t n, int64_t n_tiles, u64* __restrict__ sums) {
  __shared__ __align__(16) uint32_t sh[kStageWords];
  __shared__ u64 xs[kWarps];
  grid_launch_dependents();
  const int64_t t = blockIdx.x, u = blockIdx.y;
  const int64_t i0 = t * kTile;
  const DbpTile tile = dbp_stage(sh, words + u * words_stride, words_stride, (uint32_t)width[u],
                                 i0, min64(i0 + kTile, n));
  cp_async_wait_all();
  __syncthreads();
  const u64 s = dbp_tile_sum(tile, i0, n, xs);
  if (threadIdx.x == 0) sums[u * n_tiles + t] = s;
}

__global__ void __launch_bounds__(kThreads) dbp_decode_kernel(
    const uint32_t* __restrict__ words, int64_t words_stride, const u64* __restrict__ first,
    const int32_t* __restrict__ width, int64_t n, int64_t n_tiles, const u64* __restrict__ sums,
    u64* __restrict__ out) {
  __shared__ __align__(16) uint32_t sh[kDecodeWords];
  __shared__ u64 xs[2 * kWarps];
  u64* v_sh = reinterpret_cast<u64*>(sh);
  const int64_t t = blockIdx.x, u = blockIdx.y;
  const int64_t i0 = t * kTile;
  const DbpTile tile = dbp_stage(sh, words + u * words_stride, words_stride, (uint32_t)width[u],
                                 i0, min64(i0 + kTile, n));
  const u64 first_u = first[u];
  cp_async_wait_all();
  __syncthreads();
  u64 v[kPer];
  dbp_tile_values(tile, t, n, first_u, sums + u * n_tiles, 0, xs, v);
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * kSeg;
#pragma unroll
  for (int k = 0; k < kPer; ++k) v_sh[vpad(w0 + kPer * lane + k)] = v[k];
  __syncwarp();
  u64* ou = out + u * n;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int e = w0 + 32 * m + lane;
    if (i0 + e < n) ou[i0 + e] = v_sh[vpad(e)];
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
// What bounds it: memory, each input read once: t_s and valid, the words
// the dbp deltas occupy, the rle runs, the dct dictionaries and indices,
// the codes and bounds, and the counts written once. The earlier design
// decoded each dbp column into a (U, n_pad) u64 tensor with a dbp_decode
// launch and read it back, found each row's rle run by a binary search
// (about 15 dependent loads a row) after a run-starts launch a column,
// re-read every row once a lane (a (row tiles, U, Q) grid) and counted a
// tile's rows, which fall into one or two bins, with atomics on the same
// shared-memory word. Design: at most two launches a dispatch, whatever its
// columns, and no decoded column in device memory.
// - compiled_prepare_kernel computes the dbp tile sums of every dbp column
//   and, for every rle column, the run starts and the run that covers each
//   row tile's first row (skipped when there are no such columns).
// - compiled_count_kernel runs one block a (row tile of kTile rows, unit),
//   each lane owning kPer consecutive rows. A lane reads its rows' t_s and
//   valid once (16- and 4-byte loads) into registers and sets their bits
//   in a mask a query lane (each window tested without a division), then
//   the masks narrow column by column: an rle column stages the tile's
//   runs (from the prepared first runs of the tile and the next) with each
//   run's verdict once a lane, and each counted row finds its run (a
//   binary search for a lane's first row, a step forward for the next); a
//   dct column gathers the index (16-byte loads) and dictionary entry of
//   each row a lane counts; a dbp column is decoded in registers by
//   dbp_tile_values, its carry from the prepared tile sums. The count is a
//   programmatic dependent launch of the prepare launch: it reads its rows
//   and copies its first dbp column's words while the prepare runs, and
//   waits for it only before the columns. Rows no lane counts (pad rows
//   past a unit's length among them)
//   read no dictionary entry. Last, each counted row adds one to its
//   lane's bin (a division by multiplication) with one atomic; the bins
//   live in shared memory when Q x slot_pad x 4 B fits the dynamic budget
//   and are flushed with one global atomic a non-zero bin, else the
//   atomics go straight to the int64 output.
// ---------------------------------------------------------------------------

constexpr int kMaxCCols = 16;
constexpr int kDescFields = 11;
// the dynamic shared memory a block may take: 227 KB less the static part
constexpr int64_t kMaxDynSmem = 227 * 1024 - 4096;
// set codes staged in shared memory when every set column's Q x K fits
// together (else read from L1/L2)
constexpr int64_t kMaxStagedCodes = 4096;

struct CCol {
  int32_t codec;    // 0 rle, 1 dct, 2 dbp
  int32_t kind;     // 0 set, 1 range
  int32_t invert;   // set: the verdict is inverted
  int32_t pad;      // rle: runs a unit (RP); dct: dictionary entries a unit (VP); dbp: words a unit (WP)
  int32_t n_codes;  // set: codes a (lane, unit) (K)
  const uint32_t* values;  // rle (U, RP) run values; dct (U, VP) dictionary; dbp (U, WP) words
  const int32_t* aux;      // rle (U, RP) run lengths; dct (U, n_pad) indices; dbp (U,) widths
  // the prepare launch's: rle (U, RP + 1 + n_tiles) int32, the run starts
  // then each tile's first run; dbp (U, n_tiles) u64 tile sums
  void* scratch;
  const u64* first;        // dbp (U,) first values
  const uint32_t* codes;   // set (Q, U, K)
  const u64* bounds;       // range (Q, 2): inclusive lo, hi
};

struct CCols {
  int32_t n_cols;
  CCol c[kMaxCCols];
};

// Copy the column table from the kernel's parameters into shared memory
// (static offsets: a parameter indexed at run time would be copied to every
// thread's local memory); a barrier before use.
__device__ __forceinline__ void load_cols(const CCols& cols, CCols* sh) {
#pragma unroll
  for (int c = 0; c < kMaxCCols; ++c)
    if (threadIdx.x == c && c < cols.n_cols) sh->c[c] = cols.c[c];
  if (threadIdx.x == 0) sh->n_cols = cols.n_cols;
}

// One unit's rle scratch: the run starts of its rp run lengths (an
// exclusive scan) at su[0..rp], su[rp] their sum, then at su[rp + 1 + t]
// the run covering row tile t's first row: the last run starting at or
// before it (a zero-length run covers nothing; the last run covers every
// row past the lengths' sum, as the plain version's searchsorted gives
// them). Each thread takes kItems consecutive runs and keeps their starts
// in registers. Every thread of the block calls it.
__device__ __forceinline__ void rle_prepare_block(const int32_t* __restrict__ lu, int64_t rp,
                                                  int64_t n_tiles, int32_t* __restrict__ su,
                                                  int32_t* warp_tot) {
  constexpr int kItems = 8;
  constexpr int64_t kChunk = (int64_t)kThreads * kItems;
  int32_t* first_run = su + rp + 1;
  int32_t carry = 0;
  for (int64_t t0 = 0; t0 < rp; t0 += kChunk) {
    const int64_t base = t0 + (int64_t)threadIdx.x * kItems;
    int32_t v[kItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = sum;  // exclusive within the thread
      sum += base + k < rp ? lu[base + k] : 0;
    }
    int32_t total;
    const int32_t off = carry + block_exclusive(sum, warp_tot, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t run = base + k;
      if (run >= rp) break;
      const int64_t a = off + v[k];
      const int64_t b = run == rp - 1 ? n_tiles * kTile : off + (k + 1 < kItems ? v[k + 1] : sum);
      su[run] = (int32_t)a;
      for (int64_t t = (a + kTile - 1) / kTile; t < n_tiles && t * kTile < b; ++t)
        first_run[t] = (int32_t)run;
    }
    carry += total;
  }
  if (threadIdx.x == 0) su[rp] = carry;
}

// 8 blocks an SM: its dbp tile sums (a block a tile) fill the card in one
// wave
__global__ void __launch_bounds__(kThreads, 8) compiled_prepare_kernel(CCols cols_p, int64_t n_pad,
                                                                    int64_t n_units,
                                                                    int64_t n_tiles) {
  __shared__ __align__(16) uint32_t sh[kStageWords];
  __shared__ u64 xs[kWarps];
  __shared__ int32_t itot[kWarps];
  __shared__ CCols cols;
  grid_launch_dependents();
  load_cols(cols_p, &cols);
  __syncthreads();
  // the rle columns' blocks first (each scans a unit's runs: the longest
  // blocks), then the dbp columns' tile sums
  int64_t b = blockIdx.x;
  for (int c = 0; c < cols.n_cols; ++c) {
    const CCol& cc = cols.c[c];
    if (cc.codec != 0) continue;
    if (b < n_units) {  // a unit's run starts and tiles' first runs
      rle_prepare_block(cc.aux + b * cc.pad, cc.pad, n_tiles,
                        static_cast<int32_t*>(cc.scratch) + b * (cc.pad + 1 + n_tiles), itot);
      return;
    }
    b -= n_units;
  }
  for (int c = 0; c < cols.n_cols; ++c) {
    const CCol& cc = cols.c[c];
    if (cc.codec != 2) continue;
    const int64_t jobs = n_units * (n_tiles - 1);  // every tile but a unit's last
    if (b < jobs) {
      const int64_t u = b / (n_tiles - 1), t = b % (n_tiles - 1), i0 = t * kTile;
      const DbpTile tile = dbp_stage(sh, cc.values + u * cc.pad, cc.pad, (uint32_t)cc.aux[u], i0,
                                     min64(i0 + kTile, n_pad));
      cp_async_wait_all();
      __syncthreads();
      const u64 s = dbp_tile_sum(tile, i0, n_pad, xs);
      if (threadIdx.x == 0) static_cast<u64*>(cc.scratch)[u * n_tiles + t] = s;
      return;
    }
    b -= jobs;
  }
}

// Lane q's verdict on value v of column cc; codes + q * stride are the
// lane's codes of this unit, bounds its range.
__device__ __forceinline__ bool lane_hit(const CCol& cc, const uint32_t* codes, int64_t stride,
                                         const u64* bounds, int q, u64 v) {
  if (cc.kind == 1) return v >= bounds[2 * q] && v <= bounds[2 * q + 1];
  const uint32_t* cq = codes + q * stride;
  bool h = false;
  for (int32_t s = 0; s < cc.n_codes; ++s) h |= (uint32_t)v == cq[s];
  return h != (cc.invert != 0);
}

// Lane q's verdicts on this lane's kPer values (bit k: value k), each
// code or bound read once.
template <typename V>
__device__ __forceinline__ uint32_t lane_hits(const CCol& cc, const uint32_t* codes, int64_t stride,
                                              const u64* bounds, int q, const V (&v)[kPer]) {
  uint32_t hits = 0u;
  if (cc.kind == 1) {
    const u64 lo = bounds[2 * q], hi = bounds[2 * q + 1];
#pragma unroll
    for (int k = 0; k < kPer; ++k) hits |= (uint32_t)((u64)v[k] >= lo && (u64)v[k] <= hi) << k;
    return hits;
  }
  const uint32_t* cq = codes + q * stride;
  for (int32_t s = 0; s < cc.n_codes; ++s) {
    const uint32_t code = cq[s];
#pragma unroll
    for (int k = 0; k < kPer; ++k) hits |= (uint32_t)((uint32_t)v[k] == code) << k;
  }
  return cc.invert ? hits ^ ((1u << kPer) - 1u) : hits;
}

// AND the warp's lanes' verdicts (bit k of each lane's hits: its row k)
// into lane q's kPer mask words of the warp's rows; the warp calls it
// together.
__device__ __forceinline__ void narrow_words(uint32_t* words, uint32_t hits) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t bits = __ballot_sync(0xffffffffu, (hits >> k) & 1u);
    if ((threadIdx.x & 31) == 0) words[k] &= bits;
  }
}

// Division by an invariant u32 (Granlund and Montgomery, "Division by
// invariant integers using multiplication", 1994, fig. 4.1): n / d ==
// (t + ((n - t) >> s1)) >> s2 with t = umulhi(m, n), exact for every u32 n
// and d >= 1. shifts holds s1 | s2 << 8.
__device__ __forceinline__ void div_magic(uint32_t d, uint32_t* m, uint32_t* shifts) {
  const int l = d > 1u ? 32 - __clz(d - 1u) : 0;  // ceil(log2 d)
  // m = floor(2^32 (2^l - d) / d) + 1 < 2^32: a double quotient, corrected
  const u64 num = (((u64)1 << l) - d) << 32, dd = d ? d : 1u;
  u64 q = (u64)((double)num / (double)dd);
  while (q * dd > num) --q;
  while ((q + 1) * dd <= num) ++q;
  *m = (uint32_t)(q + 1u);
  *shifts = (l ? 1u : 0u) | ((uint32_t)(l ? l - 1 : 0) << 8);
}

__device__ __forceinline__ uint32_t div_by_magic(uint32_t n, uint32_t m, uint32_t shifts) {
  const uint32_t t = __umulhi(m, n);
  return (t + ((n - t) >> (shifts & 0xffu))) >> (shifts >> 8);
}

// The runs [k0, k1] that cover row tile t of a unit (its rle scratch st:
// rp run starts and more, then each tile's first run).
__device__ __forceinline__ void rle_tile_runs(const int32_t* st, int32_t rp, int64_t n_tiles,
                                              int64_t t, int32_t* k0, int32_t* k1) {
  *k0 = rp > 0 ? st[rp + 1 + t] : 0;
  *k1 = t + 1 < n_tiles ? st[rp + 2 + t] : rp - 1;
}

// The count kernel's dynamic shared memory, in 4-byte words (offsets
// multiples of 4 words, so every area is 16-byte aligned).
struct CountSmem {
  int64_t region, mask, runs, run_hits, bounds, codes, lanes, lims, bins, total;
};

// The runs an rle column stages a tile: every run that starts in it (at
// most kTile of positive length), the one before and the one after; the
// zero-length runs that pad a unit's runs come last and are cut.
constexpr int kRunSlots = kTile + 2 * kThreads;

__host__ __device__ __forceinline__ int64_t round4(int64_t x) { return (x + 3) & ~(int64_t)3; }

__host__ __device__ __forceinline__ CountSmem count_smem(int64_t n_q, int64_t n_cols, bool has_dbp,
                                                         bool has_rle, int64_t staged_codes,
                                                         int64_t bins) {
  CountSmem s;
  s.region = 0;
  s.mask = s.region + (has_dbp ? round4(kStageWords) : 0);
  s.runs = s.mask + round4(n_q * kTileWords);
  s.run_hits = s.runs + (has_rle ? kRunSlots : 0);
  s.bounds = s.run_hits + (has_rle ? round4(n_q * (kRunSlots / 32)) : 0);
  s.codes = s.bounds + 4 * n_q * n_cols;
  s.lanes = s.codes + round4(staged_codes);
  s.lims = s.lanes + round4(3 * n_q);
  s.bins = s.lims + round4(2 * n_q);
  s.total = s.bins + round4(bins);
  return s;
}

__global__ void __launch_bounds__(kThreads, 4) compiled_count_kernel(
    CCols cols_p, const uint32_t* __restrict__ t_s, const uint8_t* __restrict__ valid,
    int64_t n_pad, int64_t n_units, int64_t n_tiles, int32_t n_q, const uint32_t* __restrict__ tb,
    const uint32_t* __restrict__ nb, int32_t slot_pad, bool has_dbp, bool has_rle,
    int64_t staged_codes, bool smem_bins, u64* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  __shared__ u64 xs[2 * kWarps];
  __shared__ CCols cols;
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const CountSmem L = count_smem(n_q, cols_p.n_cols, has_dbp, has_rle, staged_codes,
                                 smem_bins ? (int64_t)n_q * slot_pad : 0);
  uint32_t* region = smem + L.region;
  uint32_t* mask = smem + L.mask;  // (Q, kTileWords): the rows each lane counts
  int32_t* runs = reinterpret_cast<int32_t*>(smem + L.runs);  // an rle column's staged starts
  uint32_t* run_hits = smem + L.run_hits;  // (Q, kRunSlots / 32): their verdicts
  u64* bounds_sh = reinterpret_cast<u64*>(smem + L.bounds);  // (n_cols, Q, 2)
  uint32_t* codes_sh = smem + L.codes;  // each set column's (Q, K), when they all fit
  // (Q, 3): start and the step's division magic (multiplier, shifts)
  uint32_t* lanes = smem + L.lanes;
  u64* lims = reinterpret_cast<u64*>(smem + L.lims);  // (Q,): the window's seconds, n_bins x step
  uint32_t* bins = smem + L.bins;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* my_mask = mask + warp * kPer;     // + q * kTileWords + k: lane q's word of row k

  const int64_t u = blockIdx.x / n_tiles, t = blockIdx.x % n_tiles;
  const int64_t r0 = t * kTile;
  const int lr = warp * kSeg + kPer * lane;  // this lane's first row in the tile
  const int64_t rb = r0 + lr;                 // ... in the unit

  // this lane's rows' t_s and valid, read once (16- and 4-byte loads where
  // aligned), issued before the block's set-up
  uint32_t ts[kPer];
  bool ok[kPer];
  {
    const int64_t g = u * n_pad + rb;
    if (rb + kPer <= n_pad && (g & 3) == 0) {
#pragma unroll
      for (int k = 0; k < kPer; k += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(t_s + g + k);
        const uchar4 y = *reinterpret_cast<const uchar4*>(valid + g + k);
        ts[k] = x.x, ts[k + 1] = x.y, ts[k + 2] = x.z, ts[k + 3] = x.w;
        ok[k] = y.x != 0, ok[k + 1] = y.y != 0, ok[k + 2] = y.z != 0, ok[k + 3] = y.w != 0;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool in = rb + k < n_pad;
        ts[k] = in ? t_s[g + k] : 0u;
        ok[k] = in && valid[g + k] != 0;
      }
    }
  }
  load_cols(cols_p, &cols);
  for (int q = threadIdx.x; q < n_q; q += blockDim.x) {
    const uint32_t step = tb[2 * q + 1];
    lanes[3 * q] = tb[2 * q];
    div_magic(step, &lanes[3 * q + 1], &lanes[3 * q + 2]);
    lims[q] = (u64)min(nb[q], (uint32_t)slot_pad) * step;
  }
  if (smem_bins)
    for (int64_t s = threadIdx.x; s < (int64_t)n_q * slot_pad; s += blockDim.x) bins[s] = 0u;
  __syncthreads();
  // the first dbp column's words, copied while the rows are read
  int first_dbp = -1;
  for (int c = 0; c < cols.n_cols && first_dbp < 0; ++c)
    if (cols.c[c].codec == 2) first_dbp = c;
  DbpTile staged;
  if (first_dbp >= 0) {
    const CCol& cc = cols.c[first_dbp];
    staged = dbp_stage(region, cc.values + u * cc.pad, cc.pad, (uint32_t)cc.aux[u], r0,
                       min64(r0 + kTile, n_pad));
  }

  // a mask word a lane a row: the rows each lane's window counts
  // ((t_s - start) / step < n_bins as t_s - start < n_bins x step)
  uint32_t my_live = 0u;  // bit k: a lane counts row k
  for (int q = 0; q < n_q; ++q) {
    const uint32_t start = lanes[3 * q];
    const u64 lim = lims[q];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = ok[k] && ts[k] >= start && (u64)(ts[k] - start) < lim;
      const uint32_t bits = __ballot_sync(0xffffffffu, in);
      if (lane == 0) my_mask[q * kTileWords + k] = bits;
      my_live |= (uint32_t)in << k;
    }
  }
  if (!__syncthreads_or(my_live != 0u)) {  // no lane counts a row of this tile
    cp_async_wait_all();
    return;
  }
  // every column's range bounds and (when they fit) this unit's codes
  for (int c = 0, at = 0; c < cols.n_cols; ++c) {
    const CCol& cc = cols.c[c];
    if (cc.kind == 1) {
      for (int s = threadIdx.x; s < 2 * n_q; s += blockDim.x)
        bounds_sh[2 * n_q * c + s] = cc.bounds[s];
    } else if (staged_codes) {
      for (int64_t s = threadIdx.x; s < (int64_t)n_q * cc.n_codes; s += blockDim.x)
        codes_sh[at + s] = cc.codes[((s / cc.n_codes) * n_units + u) * cc.n_codes + s % cc.n_codes];
      at += n_q * cc.n_codes;
    }
  }
  __syncthreads();
  grid_dependency_wait();  // the prepare launch's run starts and tile sums
  // what the first rle and dbp columns read of it, read together
  int first_rle = -1;
  for (int c = 0; c < cols.n_cols && first_rle < 0; ++c)
    if (cols.c[c].codec == 0) first_rle = c;
  int32_t k0_first = 0, k1_first = -1;
  if (first_rle >= 0) {
    const CCol& cc = cols.c[first_rle];
    rle_tile_runs(static_cast<const int32_t*>(cc.scratch) + u * (cc.pad + 1 + n_tiles), cc.pad,
                  n_tiles, t, &k0_first, &k1_first);
  }
  u64 part_first = 0, first_value = 0;
  if (first_dbp >= 0) {
    const CCol& cc = cols.c[first_dbp];
    part_first = dbp_carry_part(static_cast<const u64*>(cc.scratch) + u * n_tiles, t);
    first_value = cc.first[u];
  }

  for (int c = 0, at = 0; c < cols.n_cols; ++c) {
    const CCol& cc = cols.c[c];
    const u64* bounds = bounds_sh + 2 * n_q * c;
    const uint32_t* codes = cc.codes + u * cc.n_codes;  // lane q's: + q * U * K
    int64_t stride = n_units * cc.n_codes;
    if (cc.kind == 0 && staged_codes) {
      codes = codes_sh + at;
      stride = cc.n_codes;
      at += n_q * cc.n_codes;
    }
    if (cc.codec == 2) {
      // the tile decoded in registers (every row's delta: the scan needs
      // them), its carry from the prepared tile sums
      const bool first = c == first_dbp;
      const DbpTile tile = first ? staged
                                 : dbp_stage(region, cc.values + u * cc.pad, cc.pad,
                                             (uint32_t)cc.aux[u], r0, min64(r0 + kTile, n_pad));
      const u64 part = first ? part_first
                             : dbp_carry_part(static_cast<const u64*>(cc.scratch) + u * n_tiles, t);
      const u64 first_u = first ? first_value : cc.first[u];
      cp_async_wait_all();
      __syncthreads();
      u64 v[kPer];
      dbp_tile_values(tile, t, n_pad, first_u, nullptr, part, xs, v);
      for (int q = 0; q < n_q; ++q)
        narrow_words(my_mask + q * kTileWords, lane_hits(cc, codes, stride, bounds, q, v));
    } else if (cc.codec == 1) {
      // the index and dictionary entry of each row a lane counts
      const int64_t g = u * n_pad + rb;
      int32_t idx[kPer];
      if (my_live != 0u && rb + kPer <= n_pad && (g & 3) == 0) {
#pragma unroll
        for (int k = 0; k < kPer; k += 4) {
          const int4 x = *reinterpret_cast<const int4*>(cc.aux + g + k);
          idx[k] = x.x, idx[k + 1] = x.y, idx[k + 2] = x.z, idx[k + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) idx[k] = (my_live >> k) & 1u ? cc.aux[g + k] : 0;
      }
      uint32_t v[kPer];
      const uint32_t* dv = cc.values + u * cc.pad;
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = (my_live >> k) & 1u ? dv[idx[k]] : 0u;
      for (int q = 0; q < n_q; ++q)
        narrow_words(my_mask + q * kTileWords, lane_hits(cc, codes, stride, bounds, q, v));
    } else {
      // the runs that cover the tile's rows (from the prepared first runs
      // of this tile and the next), staged with each run's verdict once a
      // lane (a ballot a warp of runs), two runs a thread a pass; then each
      // counted row's run: a binary search for a lane's first, a step
      // forward for the next
      const int32_t rp = cc.pad;
      const int32_t* st = static_cast<const int32_t*>(cc.scratch) + u * (rp + 1 + n_tiles);
      const uint32_t* vals = cc.values + u * rp;
      int32_t k0 = k0_first, k1 = k1_first;
      if (c != first_rle) rle_tile_runs(st, rp, n_tiles, t, &k0, &k1);
      const int staged = min(k1 - k0 + 1, kRunSlots);
      for (int cb = 0; cb < staged; cb += 2 * kThreads) {
        int32_t a[2];
        u64 v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = cb + h * kThreads + threadIdx.x;
          a[h] = j < staged ? st[k0 + j] : 0x7FFFFFFF;
          v[h] = j < staged ? vals[k0 + j] : 0u;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = cb + h * kThreads + threadIdx.x;
          if (j < kRunSlots) runs[j] = a[h];
          for (int q = 0; q < n_q; ++q) {
            const uint32_t bits = __ballot_sync(
                0xffffffffu, j < staged && lane_hit(cc, codes, stride, bounds, q, v[h]));
            if (lane == 0 && j < kRunSlots) run_hits[q * (kRunSlots / 32) + (j >> 5)] = bits;
          }
        }
      }
      __syncthreads();
      int run[kPer];
      int j = 0;
      if (my_live) {
        int hi = staged - 1;  // the last staged run starting at or before the lane's first row
        while (j < hi) {
          const int mid = (j + hi + 1) >> 1;
          if (runs[mid] <= rb) j = mid;
          else hi = mid - 1;
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if ((my_live >> k) & 1u)
          while (j + 1 < staged && runs[j + 1] <= rb + k) ++j;
        run[k] = j;
      }
      for (int q = 0; q < n_q; ++q) {
        const uint32_t* hq = run_hits + q * (kRunSlots / 32);
        uint32_t hits = 0u;
#pragma unroll
        for (int k = 0; k < kPer; ++k) hits |= ((hq[run[k] >> 5] >> (run[k] & 31)) & 1u) << k;
        narrow_words(my_mask + q * kTileWords, hits);
      }
    }
    __syncthreads();
  }

  // count: each counted row adds one to its lane's bin (a division by
  // multiplication)
  for (int q = 0; q < n_q; ++q) {
    const uint32_t start = lanes[3 * q], dm = lanes[3 * q + 1], ds = lanes[3 * q + 2];
    uint32_t* bins_q = bins + (int64_t)q * slot_pad;
    u64* out_q = out + (int64_t)q * slot_pad;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!((my_mask[q * kTileWords + k] >> lane) & 1u)) continue;
      const uint32_t bin = div_by_magic(ts[k] - start, dm, ds);
      if (smem_bins) atomicAdd(&bins_q[bin], 1u);
      else atomicAdd(&out_q[bin], 1ull);
    }
  }
  if (!smem_bins) return;
  __syncthreads();
  for (int64_t s = threadIdx.x; s < (int64_t)n_q * slot_pad; s += blockDim.x)
    if (bins[s]) atomicAdd(&out[s], (u64)bins[s]);
}

// ---------------------------------------------------------------------------
// Resident scans: resident_rle_scan, resident_dct_scan, resident_dbp_scan
//
// Replace the device tier's jitted scans of tempo_tpu/ops/scan.py:169-216
// (_rle_in_set_resident_jit, _rle_between_resident_jit,
// _dct_in_set_resident_jit, _dct_between_resident_jit,
// _dbp_between_resident_jit): a row mask over one page held on the card in
// its encoded form. A value's verdict (resident_verdict) is, by mode, 0 "in
// the code set", 1 "not in it" or 2 lo <= value <= hi, all unsigned 32-bit;
// a dbp page's is lo <= value <= hi over its decoded unsigned 64-bit values.
// The mask is written a byte a row (a torch.bool tensor). Each lane owns
// kPer consecutive rows (lane_first), stored as one 8-byte word, so a warp
// writes 256 contiguous bytes.
//
// What bounds them: memory. rle reads 8 bytes a run and writes a byte a row,
// dct reads 4 bytes an index and writes a byte a row (its dictionary is
// small), dbp reads w / 8 bytes a row and writes one; the code set is tiny
// beside the page. Designs:
// - rle: row r takes the verdict of the LAST run whose start (the exclusive
//   prefix sum of the lengths) is <= r, which is jnp.repeat(verdicts,
//   lengths, total_repeat_length=n)'s rule: rows past the runs' total take
//   the last run's verdict, runs past n are cut, a zero-length run wins
//   no row. The starts are a reduce-then-scan over 2,048-run tiles, as
//   dbp_decode's: rle_run_sums_kernel sums each tile's lengths (pages of
//   more than one tile), rle_run_starts_kernel gives each run its start and
//   verdict, packed as start << 1 | verdict in one int64, and
//   rle_expand_kernel gives each lane's first row its run by a binary search
//   over the starts, then walks the runs forward over its 8 rows. Both
//   later passes are programmatic dependent launches.
// - dct: dct_verdict_kernel computes the verdict once per dictionary entry;
//   dct_gather_kernel (a dependent launch) loads its rows' indices as two
//   16-byte vectors before it waits, then gathers the verdicts. An index
//   reads as jnp indexing does: a negative one from the end, one past the
//   end clamped.
// - dbp: dbp_decode's two passes with the compare in the scan's epilogue,
//   so no decoded value is written: resident_dbp_sum_kernel sums each
//   tile's deltas (pages of more than one 2,048-row tile), and
//   resident_dbp_scan_kernel (a dependent launch) gives each lane its
//   values from the carry and compares them. A lane cuts its deltas
//   straight from the words in device memory (no staging), which serves
//   every width to 64: a delta is the low 32 bits of its w-bit field, as
//   the reference's decode reads it (pages hold w <= 32).
// ---------------------------------------------------------------------------

constexpr int32_t kModeBetween = 2;

__device__ __forceinline__ bool resident_verdict(uint32_t v, const uint32_t* __restrict__ codes,
                                                 int32_t n_codes, int32_t mode, uint32_t lo,
                                                 uint32_t hi) {
  if (mode == kModeBetween) return v >= lo && v <= hi;
  bool hit = false;
  for (int32_t k = 0; k < n_codes; ++k) hit |= __ldg(codes + k) == v;
  return hit != (mode == 1);
}

// Store a lane's kPer verdict bytes (bit 8 * k of `bytes`: row i0 + k) to
// out[i0, min(i0 + kPer, n)).
__device__ __forceinline__ void store_mask(uint8_t* __restrict__ out, int64_t i0, int64_t n,
                                           u64 bytes) {
  if (i0 + kPer <= n) {
    *reinterpret_cast<u64*>(out + i0) = bytes;
  } else {
    for (int k = 0; i0 + k < n; ++k) out[i0 + k] = (uint8_t)(bytes >> (8 * k));
  }
}

__global__ void __launch_bounds__(kThreads) rle_run_sums_kernel(
    const int32_t* __restrict__ lengths, int64_t r, u64* __restrict__ sums) {
  __shared__ u64 xs[kWarps];
  grid_launch_dependents();
  const int64_t k0 = lane_first((int64_t)blockIdx.x * kTile);
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s += k0 + k < r ? lengths[k0 + k] : 0;
  const u64 all = block_sum((u64)s, xs);
  if (threadIdx.x == 0) sums[blockIdx.x] = all;
}

__global__ void __launch_bounds__(kThreads) rle_run_starts_kernel(
    const uint32_t* __restrict__ values, const int32_t* __restrict__ lengths, int64_t r,
    const uint32_t* __restrict__ codes, int32_t n_codes, int32_t mode, uint32_t lo, uint32_t hi,
    const u64* sums, int64_t* __restrict__ packed) {
  __shared__ u64 xs[2 * kWarps];
  grid_launch_dependents();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x, k0 = lane_first(t * kTile);
  int64_t len[kPer];
  u64 hits = 0, s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool live = k0 + k < r;
    len[k] = live ? lengths[k0 + k] : 0;
    s += (u64)len[k];
    if (live && resident_verdict(values[k0 + k], codes, n_codes, mode, lo, hi)) hits |= 1u << k;
  }
  const u64 incl = warp_inclusive_scan(s);
  grid_dependency_wait();  // the tile sums (at once for a one-tile page)
  const u64 cs = warp_sum(dbp_carry_part(sums, t));
  if (lane == 31) xs[warp] = incl;
  if (lane == 0) xs[kWarps + warp] = cs;
  __syncthreads();
  u64 acc = incl - s;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) acc += xs[kWarps + k] + (k < warp ? xs[k] : 0ull);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k0 + k < r) packed[k0 + k] = (int64_t)((acc << 1) | ((hits >> k) & 1u));
    acc += (u64)len[k];
  }
}

__device__ __forceinline__ int64_t run_start(const int64_t* packed, int64_t k) {
  return packed[k] >> 1;
}

__global__ void __launch_bounds__(kThreads) rle_expand_kernel(const int64_t* packed, int64_t r,
                                                              int64_t n,
                                                              uint8_t* __restrict__ out) {
  const int64_t i0 = lane_first((int64_t)blockIdx.x * kTile);
  grid_dependency_wait();  // the starts and verdicts
  if (i0 >= n) return;
  int64_t a = 1, b = r;  // the first run starting past i0 lies in [a, b]; run 0 starts at 0
  while (a < b) {
    const int64_t m = (a + b) >> 1;
    if (run_start(packed, m) <= i0) a = m + 1;
    else b = m;
  }
  int64_t k = a - 1;
  u64 bytes = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    while (k + 1 < r && run_start(packed, k + 1) <= i0 + j) ++k;
    bytes |= (u64)(packed[k] & 1) << (8 * j);
  }
  store_mask(out, i0, n, bytes);
}

__global__ void __launch_bounds__(kThreads) dct_verdict_kernel(
    const uint32_t* __restrict__ values, int64_t v_count, const uint32_t* __restrict__ codes,
    int32_t n_codes, int32_t mode, uint32_t lo, uint32_t hi, uint8_t* __restrict__ verdict) {
  grid_launch_dependents();
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e < v_count) verdict[e] = resident_verdict(values[e], codes, n_codes, mode, lo, hi);
}

__global__ void __launch_bounds__(kThreads) dct_gather_kernel(const int32_t* __restrict__ idx,
                                                              int64_t n, const uint8_t* verdict,
                                                              int64_t v_count,
                                                              uint8_t* __restrict__ out) {
  const int64_t i0 = lane_first((int64_t)blockIdx.x * kTile);
  int32_t ix[kPer];
  if (i0 + kPer <= n && (reinterpret_cast<uintptr_t>(idx) & 15u) == 0) {
    const int4 p = __ldg(reinterpret_cast<const int4*>(idx + i0));
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx + i0) + 1);
    ix[0] = p.x, ix[1] = p.y, ix[2] = p.z, ix[3] = p.w;
    ix[4] = q.x, ix[5] = q.y, ix[6] = q.z, ix[7] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) ix[k] = i0 + k < n ? idx[i0 + k] : 0;
  }
  grid_dependency_wait();  // the entries' verdicts
  if (i0 >= n) return;
  u64 bytes = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    int64_t e = ix[k] < 0 ? ix[k] + v_count : ix[k];
    e = e < 0 ? 0 : (e >= v_count ? v_count - 1 : e);
    bytes |= (u64)verdict[e] << (8 * k);
  }
  store_mask(out, i0, n, bytes);
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* __restrict__ words,
                                                 int64_t n_words, int64_t k) {
  return k < n_words ? __ldg(words + k) : 0u;
}

// As dbp_lane_deltas, read from device memory at any width w <= 64: d[k] is
// the delta element ib + k adds, the low 32 bits of field ib + k - 1.
__device__ __forceinline__ void resident_lane_deltas(const uint32_t* __restrict__ words,
                                                     int64_t n_words, uint32_t w, int64_t ib,
                                                     int64_t n, int32_t (&d)[kPer]) {
  const uint32_t mask = w >= 32u ? 0xFFFFFFFFu : ((1u << w) - 1u);
  const u64 off = (u64)(ib > 0 ? ib - 1 : 0) * w;
  int64_t wi = (int64_t)(off >> 5);
  uint32_t rem = (uint32_t)(off & 31u);
  uint32_t lo = word_or_zero(words, n_words, wi), hi = word_or_zero(words, n_words, wi + 1);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = ib + k;
    d[k] = 0;
    if (i >= 1 && i < n) {
      const uint32_t z = __funnelshift_r(lo, hi, rem) & mask;
      d[k] = (int32_t)((z >> 1) ^ (0u - (z & 1u)));
      rem += w;
      while (rem >= 32u) {
        rem -= 32u;
        ++wi;
        lo = hi;
        hi = word_or_zero(words, n_words, wi + 1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) resident_dbp_sum_kernel(
    const uint32_t* __restrict__ words, int64_t n_words, uint32_t w, int64_t n,
    u64* __restrict__ sums) {
  __shared__ u64 xs[kWarps];
  grid_launch_dependents();
  int32_t d[kPer];
  resident_lane_deltas(words, n_words, w, lane_first((int64_t)blockIdx.x * kTile), n, d);
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s += d[k];
  const u64 all = block_sum((u64)s, xs);
  if (threadIdx.x == 0) sums[blockIdx.x] = all;
}

__global__ void __launch_bounds__(kThreads) resident_dbp_scan_kernel(
    const uint32_t* __restrict__ words, int64_t n_words, u64 first, uint32_t w, int64_t n,
    u64 lo, u64 hi, const u64* sums, uint8_t* __restrict__ out) {
  __shared__ u64 xs[2 * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x, i0 = lane_first(t * kTile);
  int32_t d[kPer];
  resident_lane_deltas(words, n_words, w, i0, n, d);
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s += d[k];
  const u64 incl = warp_inclusive_scan((u64)s);
  grid_dependency_wait();  // the tile sums (at once for a one-tile page)
  const u64 cs = warp_sum(dbp_carry_part(sums, t));
  if (lane == 31) xs[warp] = incl;
  if (lane == 0) xs[kWarps + warp] = cs;
  __syncthreads();
  u64 acc = first + incl - (u64)s;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) acc += xs[kWarps + k] + (k < warp ? xs[k] : 0ull);
  u64 bytes = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    acc += (u64)(int64_t)d[k];
    bytes |= (u64)(acc >= lo && acc <= hi) << (8 * k);
  }
  if (i0 < n) store_mask(out, i0, n, bytes);
}

// Launch kernel<<<grid, kThreads, smem, stream>>>(args...), when
// `programmatic` as a programmatic dependent launch of the kernel before it
// on the stream (see grid_dependency_wait; only after a launch of this
// file, whose inputs were complete before it started); returns the
// launch's error.
template <typename... P, typename... A>
cudaError_t launch_dependent(bool programmatic, void (*kernel)(P...), dim3 grid, size_t smem,
                             cudaStream_t stream, A... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = programmatic ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<P>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// The elements a tile of dbp_decode and compiled_metrics, for the wrappers'
// scratch: (U, ceil(n / tile)) u64 tile sums.
int tt_dbp_tile(void) { return kTile; }

// words: (U, words_stride) uint32; first: (U,) uint64; width: (U,) int32;
// sums: (U, ceil(n / tt_dbp_tile())) uint64 scratch; out: (U, n) uint64.
// *launched: the kernels launched (1, or 2 when a unit has more than one
// tile).
int tt_dbp_decode(const void* words, int64_t words_stride, const void* first, const void* width,
                  int32_t n_units, int64_t n, void* sums, void* out, int32_t* launched,
                  void* stream) {
  *launched = 0;
  if (n_units == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_tiles = cdiv(n, kTile);
  if (n_tiles > 1) {
    dbp_tile_sum_kernel<<<dim3((unsigned)(n_tiles - 1), (unsigned)n_units), kThreads, 0, st>>>(
        (const uint32_t*)words, words_stride, (const int32_t*)width, n, n_tiles, (u64*)sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  const cudaError_t err = launch_dependent(
      n_tiles > 1, dbp_decode_kernel, dim3((unsigned)n_tiles, (unsigned)n_units), 0, st,
      (const uint32_t*)words, words_stride, (const u64*)first, (const int32_t*)width, n, n_tiles,
      (const u64*)sums, (u64*)out);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// desc: n_cols x 11 int64 on the host, per column: codec, kind, invert, pad,
// n_codes, then device pointers values, aux, scratch, first, codes, bounds
// (0 where unused), with n_tiles = ceil(n_pad / tt_dbp_tile()):
//   rle  values (U, RP), lengths (U, RP), scratch (U, RP + 1 + n_tiles) int32;
//   dct  dictionary (U, VP), indices (U, n_pad);
//   dbp  words (U, WP), widths (U,) int32, scratch (U, n_tiles) uint64,
//        first (U,) uint64;
//   set codes (Q, U, K); range bounds (Q, 2) uint64.
// t_s: (U, n_pad) uint32; valid: (U, n_pad) uint8; tb: (Q, 2) uint32 start,
// step; nb: (Q,) uint32; out: (Q, slot_pad) int64, zeroed by the caller.
// *launched: the kernels launched (the prepare launch when there is an rle
// column or a dbp column of more than one tile, then the count launch).
int tt_compiled_metrics(const int64_t* desc, int32_t n_cols, const void* t_s, const void* valid,
                        int64_t n_pad, int32_t n_units, int32_t n_q, const void* tb,
                        const void* nb, int32_t slot_pad, void* out, int32_t* launched,
                        void* stream) {
  *launched = 0;
  if (n_cols > kMaxCCols) return (int)cudaErrorInvalidValue;
  if (n_units == 0 || n_q == 0 || n_pad == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_tiles = cdiv(n_pad, kTile);
  CCols cols;
  cols.n_cols = n_cols;
  bool has_dbp = false, has_rle = false;
  int64_t max_codes = 0, prepare_blocks = 0;
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
    cc.scratch = (void*)d[7];
    cc.first = (const u64*)d[8];
    cc.codes = (const uint32_t*)d[9];
    cc.bounds = (const u64*)d[10];
    if (cc.codec == 2) {
      has_dbp = true;
      prepare_blocks += (int64_t)n_units * (n_tiles - 1);
    } else if (cc.codec == 0) {
      has_rle = true;
      prepare_blocks += n_units;
    }
    if (cc.kind == 0) max_codes += (int64_t)n_q * cc.n_codes;
  }
  if (prepare_blocks > 0) {
    compiled_prepare_kernel<<<(unsigned)prepare_blocks, kThreads, 0, st>>>(cols, n_pad, n_units,
                                                                          n_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  const int64_t staged_codes = max_codes <= kMaxStagedCodes ? max_codes : 0;
  bool smem_bins = true;
  int64_t words =
      count_smem(n_q, n_cols, has_dbp, has_rle, staged_codes, (int64_t)n_q * slot_pad).total;
  if (words * 4 > kMaxDynSmem) {  // the lanes' bins do not fit: global atomics
    smem_bins = false;
    words = count_smem(n_q, n_cols, has_dbp, has_rle, staged_codes, 0).total;
    if (words * 4 > kMaxDynSmem) return (int)cudaErrorInvalidValue;  // too many lanes
  }
  const size_t smem = (size_t)words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compiled_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = launch_dependent(
      prepare_blocks > 0, compiled_count_kernel, dim3((unsigned)(n_tiles * n_units)), smem, st,
      cols, (const uint32_t*)t_s, (const uint8_t*)valid, n_pad, (int64_t)n_units, n_tiles, n_q,
      (const uint32_t*)tb, (const uint32_t*)nb, slot_pad, has_dbp, has_rle, staged_codes,
      smem_bins, (u64*)out);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// values: (r,) uint32 run values; lengths: (r,) int32 run lengths (>= 0);
// codes: (n_codes,) uint32 (modes 0 and 1); sums: ceil(r / tt_dbp_tile())
// uint64 scratch; packed: (r,) int64 scratch; out: (n,) uint8 row mask.
// *launched: the kernels launched (2, or 3 when r spans more than one
// tile).
int tt_resident_rle_scan(const void* values, const void* lengths, int64_t r, const void* codes,
                         int32_t n_codes, int32_t mode, uint32_t lo, uint32_t hi, int64_t n,
                         void* sums, void* packed, void* out, int32_t* launched, void* stream) {
  *launched = 0;
  if (n == 0) return 0;
  if (r == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t r_tiles = cdiv(r, kTile);
  if (r_tiles > 1) {
    rle_run_sums_kernel<<<(unsigned)(r_tiles - 1), kThreads, 0, st>>>((const int32_t*)lengths, r,
                                                                       (u64*)sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  cudaError_t err = launch_dependent(r_tiles > 1, rle_run_starts_kernel, dim3((unsigned)r_tiles),
                                     0, st, (const uint32_t*)values, (const int32_t*)lengths, r,
                                     (const uint32_t*)codes, n_codes, mode, lo, hi,
                                     (const u64*)sums, (int64_t*)packed);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  err = launch_dependent(true, rle_expand_kernel, dim3((unsigned)cdiv(n, kTile)), 0, st,
                         (const int64_t*)packed, r, n, (uint8_t*)out);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// values: (v_count,) uint32 dictionary; idx: (n,) int32; codes: (n_codes,)
// uint32 (modes 0 and 1); verdict: (v_count,) uint8 scratch; out: (n,) uint8
// row mask. *launched: the kernels launched (2).
int tt_resident_dct_scan(const void* values, int64_t v_count, const void* idx, int64_t n,
                         const void* codes, int32_t n_codes, int32_t mode, uint32_t lo,
                         uint32_t hi, void* verdict, void* out, int32_t* launched, void* stream) {
  *launched = 0;
  if (n == 0) return 0;
  if (v_count == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dct_verdict_kernel<<<(unsigned)cdiv(v_count, kThreads), kThreads, 0, st>>>(
      (const uint32_t*)values, v_count, (const uint32_t*)codes, n_codes, mode, lo, hi,
      (uint8_t*)verdict);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  err = launch_dependent(true, dct_gather_kernel, dim3((unsigned)cdiv(n, kTile)), 0, st,
                         (const int32_t*)idx, n, (const uint8_t*)verdict, v_count, (uint8_t*)out);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

// words: (n_words,) uint32, the packed deltas with their guard word; width
// 0..64; lo, hi: inclusive uint64 bounds; sums: ceil(n / tt_dbp_tile())
// uint64 scratch; out: (n,) uint8 row mask. *launched: the kernels launched
// (1, or 2 when n spans more than one tile).
int tt_resident_dbp_scan(const void* words, int64_t n_words, uint64_t first, int32_t width,
                         int64_t n, uint64_t lo, uint64_t hi, void* sums, void* out,
                         int32_t* launched, void* stream) {
  *launched = 0;
  if (n == 0) return 0;
  if (width < 0 || width > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_tiles = cdiv(n, kTile);
  if (n_tiles > 1) {
    resident_dbp_sum_kernel<<<(unsigned)(n_tiles - 1), kThreads, 0, st>>>(
        (const uint32_t*)words, n_words, (uint32_t)width, n, (u64*)sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  const cudaError_t err = launch_dependent(
      n_tiles > 1, resident_dbp_scan_kernel, dim3((unsigned)n_tiles), 0, st,
      (const uint32_t*)words, n_words, (u64)first, (uint32_t)width, n, (u64)lo, (u64)hi,
      (const u64*)sums, (uint8_t*)out);
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // extern "C"

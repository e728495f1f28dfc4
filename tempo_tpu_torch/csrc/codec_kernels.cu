// Hand-written Hopper (sm_90a) kernels of the vtpu1 codec in tempo_tpu_torch:
// the device page-encode arm (rle_change_mask, dbp_pack), the compiled
// query tier (dbp_decode, compiled_metrics), the device tier's resident
// scans (resident_rle_scan, resident_dct_scan, resident_dbp_scan) and the
// fused run-length decode + in-set scan of the mesh and batched searches
// (rle_cols_hit).
//
// These replace jitted device programs of the JAX package, not Pallas
// kernels: ops/encode.py's _rle_kernel, _dbp_kernel and _pack_kernel,
// ops/pallas_kernels.py's _dbp_decode_jit and rle_cols_hit(_live),
// compiled/program.py's build_metrics_program and ops/scan.py's resident
// scans. Each computes the
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
#include <climits>
#include <cstring>

namespace {

constexpr int kThreads = 256;

using u64 = unsigned long long;

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

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
// block total, over NW warps. Ends with a barrier, so warp_tot may be reused
// at once.
template <typename T, int NW = kWarps>
__device__ __forceinline__ T block_exclusive(T sum, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_scan(sum);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const T s = warp_tot[k];
    before += k < warp ? s : (T)0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - sum;
}

// The block's sum of `v` over NW warps, to every thread; xs: NW u64 of
// shared memory. Ends with a barrier.
template <int NW = kWarps>
__device__ __forceinline__ u64 block_sum(u64 v, u64* xs) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) xs[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 all = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) all += xs[k];
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
// its encoded form. A value's verdict is, by mode, 0 "in the code set", 1
// "not in it" or 2 lo <= value <= hi, all unsigned 32-bit; a dbp page's is
// lo <= value <= hi over its decoded unsigned 64-bit values. The mask is
// written a byte a row (a torch.bool tensor).
//
// What bounds them: memory. rle reads 8 bytes a run and writes a byte a row,
// dct reads 4 bytes an index and writes a byte a row (its dictionary is
// small), dbp reads w / 8 bytes a row and writes one; the code set is tiny
// beside the page. A page is tens of KB, so the launches, not the bytes,
// decide the time: each scan takes one launch a page, and one launch over a
// search's pages (the designs below, "One launch a scan").
// ---------------------------------------------------------------------------

constexpr int32_t kModeBetween = 2;

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

// ---------------------------------------------------------------------------
// One launch a scan: resident_rle_scan, resident_dct_scan, resident_dbp_scan
//
// Each page's scan runs in one launch, in the CTAs of that page (ctas a
// page, from its rows), with no dependent launch and no
// global scratch; a batched launch runs every page of a page table the
// same way, one group of CTAs a page, each page's mask at its out_off of
// one buffer. A launch's parameters go by value (ScanParams,
// __grid_constant__): the page itself (a single scan) or the page table's
// device pointer, the mode and bounds, and a code set of up to kScanCodes
// codes (a larger one is copied to the card once a call: codes_dev). The
// CTAs a page: enough for its rows, at most kScanCtas (rle), kDctCtas (dct)
// or kDbpCtas (dbp), and in an rle batch no more than two waves over the
// card's SMs (scan_ctas).
// - rle: each CTA stages a tile of up to kRunTile runs (values and
//   lengths, 64 KB) into shared memory by Hopper's 1-D bulk copy (TMA)
//   completing on an mbarrier (stage_bulk), scans the lengths into starts
//   in place (a thread owns an odd number of consecutive runs, so a warp's
//   accesses fall on distinct banks: warp shuffles, then one pass across
//   warps), turns each value into its verdict once, and then writes the
//   rows of its share (whole 16-row chunks, 16-byte stores) that the
//   tile's runs cover: [start of the tile's first run, start of the next
//   tile's), the last tile's to n. Row r takes the verdict of the last run
//   whose start is <= r, jnp.repeat's rule: rows past the runs' total take
//   the last run's verdict, runs past n are cut (their starts saturate at
//   n), a zero-length run wins no row. Larger pages loop over run tiles and
//   carry the prefix. Each 16-row chunk finds its run by a binary search of
//   the starts in shared memory and walks on. The CTAs of a page each scan
//   all of its runs (a few tens of KB from L2) and write only their share
//   of rows.
// - dbp: the CTAs of a page form a cluster, each with a share of the rows
//   in tiles of kPer rows a lane (CTAs of 256 threads, or of 512 for pages
//   over kDbpCtas x 2,048 rows). Each lane cuts its rows' deltas (the low
//   32 bits of each width-bit field, any width 0-64, as the reference's
//   decode reads it) straight from the page's words in device memory into
//   registers, and a block scan gives each lane its offset and the share
//   its sum. Each CTA then pushes its sum into the shared memory of every
//   later CTA of the cluster and arrives on that CTA's mbarrier; a CTA
//   waits only for the sums of the CTAs before it (the one cluster barrier,
//   which makes the mbarriers visible, is arrived at before the deltas are
//   cut), then each lane adds its deltas onto the carry, compares each
//   value with [lo, hi] as unsigned 64-bit and writes its kPer bytes as
//   one 8-byte store. A share of more than one tile cuts its deltas twice.
// - dct: each CTA takes 2,048-row tiles of one page (a tile a CTA up to
//   kDctCtas CTAs a page; a larger page loops) and first loads its first
//   tile's indices, a lane's kPer rows as two 16-byte vectors, so that the
//   loads are in flight while it builds the page's verdict bitset in
//   shared memory: a warp loads kDctLoads words of 32 dictionary entries
//   at once (coalesced), compares each entry with the code set (read
//   where the launch left it: its parameters, or device memory; no copy)
//   or the bounds and stores each ballot as one word. Then each lane
//   gathers its rows' bits (an index reads as jnp indexing does: a
//   negative one from the end, one past the end clamped) and writes its
//   kPer bytes as one 8-byte store. No scratch, no second launch. Every
//   CTA of a page needs the whole bitset, so a dictionary of more than
//   one round of its warps' loads (kDctBitsetEntries) would put more
//   serial rounds in front of every store: such a page (a batch, when
//   one of its pages has one) takes a verdict a row instead, each lane
//   loading its rows' values from the dictionary by index and comparing
//   them. (Measured on the H100 with tools/ab_dct_scan.py: from 2,048
//   entries up a verdict a row beat the bitset, a cluster of up to 16
//   CTAs splitting it over distributed shared memory, and CTAs of at
//   least V rows, by 1.2-10x; at 257 entries the bitset won.)
// ---------------------------------------------------------------------------

constexpr int kScanCodes = 256;                 // codes that go by value
constexpr int kScanCtas = 8;                    // the most CTAs an rle page
constexpr int kDbpCtas = 16;                    // the most CTAs a dbp page (a non-portable cluster)
constexpr int kDctCtas = 32;                    // the most CTAs a dct page (a tile each)
constexpr int kRunTile = 8192;                  // rle runs a tile: 64 KB of values and lengths
constexpr int kRleCtaRows = 16 * kThreads;      // rows a CTA expands in one chunk a thread
constexpr int kPageFields = 8;

// A page of a resident scan, as the wrappers lay it out in 8 int64: rle
// values, lengths, runs r, rows n, 0, 0, out_off, 0; dct dictionary, idx,
// entries v, rows n, 0, 0, out_off, 0; dbp words, 0, words, rows n, first,
// width, out_off, 0.
struct ScanPage {
  const uint32_t* a;
  const uint32_t* b;
  int64_t count, n;
  u64 first;
  int64_t width, out_off, unused;
};
static_assert(sizeof(ScanPage) == kPageFields * 8, "8 int64 a page");

struct ScanParams {
  ScanPage page;          // the page of a single scan (table null)
  const ScanPage* table;  // a batch's pages in device memory
  uint8_t* out;
  int32_t ctas, mode, n_codes, by_row;  // by_row: a dct verdict a row, not a bitset
  uint32_t lo, hi;        // rle and dct bounds
  u64 lo64, hi64;         // dbp bounds
  const uint32_t* codes_dev;  // the code set in device memory when it exceeds kScanCodes
  uint32_t codes[kScanCodes];
};

// The code set where a CTA reads it: copied into `sh` (kScanCodes words of
// shared memory) when it fits, else in device memory. Every thread calls
// it; the caller's next block barrier publishes the copy.
__device__ __forceinline__ const uint32_t* scan_codes(const ScanParams& p, uint32_t* sh) {
  if (p.mode == kModeBetween || p.n_codes > kScanCodes) return p.codes_dev;
  for (int k = threadIdx.x; k < p.n_codes; k += blockDim.x)
    sh[k] = p.codes_dev ? __ldg(p.codes_dev + k) : p.codes[k];
  return sh;
}

// A run value's or a dictionary entry's verdict; the first eight codes are
// compared from registers (c8: the code set's first eight, repeated from its
// first where it has fewer, which keeps membership), the rest from `codes`.
__device__ __forceinline__ bool scan_verdict(const ScanParams& p, const uint32_t* codes,
                                             const uint32_t (&c8)[8], uint32_t v) {
  if (p.mode == kModeBetween) return v >= p.lo && v <= p.hi;
  bool hit = false;
  if (p.n_codes > 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) hit |= c8[k] == v;
  }
  for (int32_t k = 8; k < p.n_codes; ++k) hit |= codes[k] == v;
  return hit != (p.mode == 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// An mbarrier that `count` arrivals complete (one, with the bulk copies'
// bytes, for staging), visible to the cluster after its next barrier.
__device__ __forceinline__ void mbar_init(u64* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait for phase `parity` of bar, acquiring what the arrivals released (at
// the CTA's scope, or the cluster's for arrivals from other CTAs).
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    if constexpr (kCluster) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    }
  } while (!done);
}

// dst[0, count) = src[0, count) and dst[count, fill) = 0, in uint32 words
// (dst 16-byte aligned shared memory). The body, the whole 16-byte groups
// of a 16-byte aligned src, goes by bulk copy, the rest by loads.
struct Segment {
  uint32_t* dst;
  const uint32_t* src;
  int64_t count, fill;
};

__device__ __forceinline__ int64_t bulk_words(const Segment& s) {
  return (reinterpret_cast<uintptr_t>(s.src) & 15u) ? 0 : (s.count & ~(int64_t)3);
}

// Start staging the segments with every thread of the block: thread 0 arms
// the barrier with the bodies' bytes and issues their bulk copies, every
// thread loads the tails and zeroes the fill. A buffer read before must be
// released by a block barrier first; the proxy fence orders those reads
// before the copy's writes. stage_wait completes it.
template <int N>
__device__ __forceinline__ void stage_issue(const Segment (&seg)[N], u64* bar) {
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t bytes = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) bytes += (uint32_t)(bulk_words(seg[i]) * 4);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int64_t w = bulk_words(seg[i]);
      if (w > 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_u32(seg[i].dst)),
            "l"(seg[i].src), "r"((uint32_t)(w * 4)), "r"(smem_u32(bar))
            : "memory");
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int64_t k = bulk_words(seg[i]) + threadIdx.x; k < seg[i].fill; k += blockDim.x)
      seg[i].dst[k] = k < seg[i].count ? __ldg(seg[i].src + k) : 0u;
  }
}

// Wait for the barrier's phase `parity` and meet at a block barrier.
__device__ __forceinline__ void stage_wait(u64* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncthreads();
}

// Stage the segments: stage_issue, then stage_wait.
template <int N>
__device__ __forceinline__ void stage_bulk(const Segment (&seg)[N], u64* bar, uint32_t parity) {
  stage_issue(seg, bar);
  stage_wait(bar, parity);
}

// Rows [a, b) of out (b - a <= 16) from the verdict bytes w (byte k: row
// base + k): one 16-byte store for a whole aligned chunk, else bytes.
__device__ __forceinline__ void store_rows(uint8_t* __restrict__ out, int64_t base, int64_t a,
                                           int64_t b, const uint32_t (&w)[4]) {
  if (a == base && b == base + 16 && (reinterpret_cast<uintptr_t>(out + base) & 15u) == 0) {
    *reinterpret_cast<uint4*>(out + base) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (base + k >= a && base + k < b) out[base + k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// The run of a tile that covers row a: the last of its cnt starts (in
// shared memory, ascending, starts[0] <= a) at or before a.
__device__ __forceinline__ int covering_run(const int32_t* starts, int cnt, int64_t a) {
  int l = 0, h = cnt - 1;
  while (l < h) {
    const int m = (l + h + 1) >> 1;
    if (starts[m] <= a) l = m;
    else h = m - 1;
  }
  return l;
}

// The rows [lo, hi) of one run tile (cnt runs with their starts and
// verdicts in shared memory, starts[0] <= lo) in 16-row chunks from row
// `first`, blockDim.x chunks apart: each chunk's rows [a, b) in [lo, hi)
// find their first row's run by covering_run and walk on, calling
// row(k, v) on each row base + k with that row's verdict v, then
// chunk(base, a, b).
template <typename Row, typename Chunk>
__device__ __forceinline__ void rle_walk(const uint32_t* verdict, const int32_t* starts, int cnt,
                                         int64_t lo, int64_t hi, int64_t first, Row&& row_fn,
                                         Chunk&& chunk) {
  for (int64_t base = first; base < hi; base += 16 * (int64_t)blockDim.x) {
    const int64_t a = base > lo ? base : lo, b = min64(base + 16, hi);
    if (a >= b) continue;
    int l = covering_run(starts, cnt, a);
    int64_t next = l + 1 < cnt ? starts[l + 1] : INT64_MAX;
    uint32_t v = verdict[l];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int64_t row = base + k;
      if (row >= a && row < b) {
        while (row >= next) {
          ++l;
          v = verdict[l];
          next = l + 1 < cnt ? starts[l + 1] : INT64_MAX;
        }
        row_fn(k, v);
      }
    }
    chunk(base, a, b);
  }
}

// The rows [lo, hi) of one run tile as mask bytes in out.
__device__ __forceinline__ void rle_expand(const uint32_t* verdict, const int32_t* starts, int cnt,
                                           int64_t lo, int64_t hi, uint8_t* __restrict__ out) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  rle_walk(
      verdict, starts, cnt, lo, hi, (lo & ~(int64_t)15) + 16 * (int64_t)threadIdx.x,
      [&](int k, uint32_t v) { w[k >> 2] |= v << (8 * (k & 3)); },
      [&](int64_t base, int64_t a, int64_t b) {
        store_rows(out, base, a, b, w);
        w[0] = w[1] = w[2] = w[3] = 0u;
      });
}

__device__ __forceinline__ ScanPage scan_page(const ScanParams& p, int64_t pi) {
  return p.table ? p.table[pi] : p.page;
}

// This CTA's share of a page's n rows: whole 16-row chunks, [*lo, *hi).
__device__ __forceinline__ void row_share(int64_t n, int ctas, int c, int64_t* lo, int64_t* hi) {
  const int64_t per = cdiv(cdiv(n, 16), ctas) * 16;
  *lo = min64(n, c * per);
  *hi = min64(n, *lo + per);
}

// A staged tile's cnt lengths -> their starts in place: the exclusive
// prefix sum from carry (the lengths of the tiles before), in 64 bits, so
// no sum wraps, saturated at n. Thread t owns `per` consecutive runs, per
// odd, so that a warp's threads read and write distinct banks, and calls
// each(j) on each of its runs once that run's start is written. Returns
// the tile's total length; ends with a block barrier.
template <typename Each>
__device__ __forceinline__ int64_t tile_starts(int32_t* starts, int cnt, int64_t carry, int64_t n,
                                               int64_t* warp_tot, Each&& each) {
  const int per = (int)(cdiv(cnt, kThreads) | 1);
  const int j0 = min(cnt, (int)threadIdx.x * per), j1 = min(cnt, j0 + per);
  int64_t s = 0;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) s += starts[j];
  int64_t total;
  int64_t acc = carry + block_exclusive(s, warp_tot, &total);  // ends with a barrier
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const int32_t len = starts[j];
    starts[j] = (int32_t)min64(acc, n);
    each(j);
    acc += len;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) resident_rle_kernel(const __grid_constant__ ScanParams p) {
  extern __shared__ uint4 rle_sm4[];
  uint32_t* verdict = reinterpret_cast<uint32_t*>(rle_sm4);  // run values, then verdicts
  int32_t* starts = reinterpret_cast<int32_t*>(verdict + kRunTile);  // lengths, then starts
  __shared__ u64 bar;
  __shared__ int64_t warp_tot[kWarps];
  __shared__ uint32_t codes_sh[kScanCodes];
  const int c = (int)(blockIdx.x % (unsigned)p.ctas);
  const ScanPage pg = scan_page(p, blockIdx.x / (unsigned)p.ctas);
  const int64_t n = pg.n, r = pg.count;
  uint8_t* out = p.out + pg.out_off;
  int64_t row_lo, row_hi;
  row_share(n, p.ctas, c, &row_lo, &row_hi);
  if (row_lo >= row_hi) return;
  if (r == 0) {  // no run: no row in the set
    for (int64_t i = row_lo + threadIdx.x; i < row_hi; i += blockDim.x) out[i] = 0;
    return;
  }
  const uint32_t* codes = scan_codes(p, codes_sh);
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  uint32_t c8[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c8[k] = p.n_codes > 0 ? codes[k < p.n_codes ? k : 0] : 0u;
  uint32_t parity = 0;
  int64_t carry = 0;  // the lengths of the tiles before
  for (int64_t k0 = 0; k0 < r && min64(carry, n) < row_hi; k0 += kRunTile) {
    const int cnt = (int)min64(kRunTile, r - k0);
    const Segment seg[2] = {{verdict, pg.a + k0, cnt, cnt},
                            {reinterpret_cast<uint32_t*>(starts), pg.b + k0, cnt, cnt}};
    stage_bulk(seg, &bar, parity);
    parity ^= 1u;
    const int64_t total = tile_starts(starts, cnt, carry, n, warp_tot, [&](int j) {
      verdict[j] = scan_verdict(p, codes, c8, verdict[j]) ? 1u : 0u;
    });
    const int64_t s0 = min64(carry, n);
    const int64_t s1 = k0 + cnt < r ? min64(carry + total, n) : n;
    const int64_t lo = s0 > row_lo ? s0 : row_lo, hi = min64(s1, row_hi);
    if (lo < hi) rle_expand(verdict, starts, cnt, lo, hi, out);
    carry += total;
    __syncthreads();  // the tile is read before the next stage overwrites it
  }
}

// ---------------------------------------------------------------------------
// rle_cols_hit: the fused run-length decode + in-set scan
//
// Replaces the jitted programs rle_cols_hit / rle_cols_hit_live
// (tempo_tpu/ops/pallas_kernels.py:478-515) and the programs built on them:
// _batched_rle_in_set_jit (:517), _fused_rle_in_set_jit (:551) and the mesh
// scans make_sharded_rle_scan / make_sharded_batched_rle_scan
// (tempo_tpu/parallel/search.py:133,175). The wrapper and the plain PyTorch
// version are rle_hit_lanes and _rle_hit_plain in
// tempo_tpu_torch/ops/pallas_kernels.py.
//
// The function, for unit u (a row group's run payload), lane q (a query's
// code sets) and row r < n:
//   out[u][q][r] = hit[u][r] AND over columns c of
//                  (not live[u][q][c]) OR (values[u][c][j] in codes[u][q][c])
// where j is the run that covers row r: the LAST run whose exclusive start
// (the prefix sum of lengths[u][c]) is <= r. That is jnp.repeat's rule with
// total_repeat_length = n: rows past the runs' total take the last run, even
// a zero-length padding run, and runs that overrun n are cut. The code
// 0xFFFFFFFF pads a code set and never matches, even a value 0xFFFFFFFF.
// Without `lengths` every run covers one row (an expanded column: the mesh
// tag scan), so j = min(r, run_pad - 1). Without `live` every column is
// live; without `hit` every row starts true.
//
// What bounds it: bytes, 8 a run, 4 a code, a byte a row of `hit` and one a
// row and lane of out. A mesh shard's unit is tens of KB, far under a
// microsecond at the card's memory rate, so in practice the launch and the
// few dependent steps inside it decide the time. Design: one launch a call,
// no global scratch, on the resident rle scan's run-tile machinery. A unit's
// rows are cut into shares of at most kHitRows (row_share), a CTA a share,
// and each CTA serves every lane of its unit, so its runs are staged and
// scanned once for all lanes. Each thread owns one 16-row chunk of the
// share and keeps a word a row in registers for a group of up to 32 lanes
// (bit q for lane q), ANDed over the columns. For each column the CTA
// - puts in flight together the column's first run tile (values and
//   lengths, up to kRunTile runs, by bulk copy: stage_issue), the first
//   round of the group's codes and the live flags (and, before the first
//   column, each thread's 16 bytes of `hit`), so their latencies overlap;
// - skips the column where it is dead for every lane of the group, else
//   gathers the group's code sets into one list of (code, lane bit) pairs
//   in shared memory, the padding code and dead lanes dropped (a lane with
//   2 real codes of 64 costs 2 compares a run);
// - scans the lengths into 32-bit starts saturated at n (tile_starts: 64-bit
//   sums carried across tiles, so any int32 lengths are exact), and stops at
//   the first tile that starts past its share;
// - tests each run that covers its rows once against the list, a verdict
//   word a run (bit q: the value is in lane q's set, or the column is dead
//   for lane q), written over the run's value;
// - expands the verdicts to the rows by rle_walk, each thread walking its
//   own chunk, and ANDs them into its row words.
// Without lengths the run is the row: no tile and no scan; each thread
// loads its rows' values (16-byte loads) with the codes and tests them.
// Last, each thread writes its chunk of every lane, ANDed with `hit`, as
// one 16-byte store. More lanes than a group (32, or kHitCodes / K with a
// code set of more than 64) take further groups, each repeating the column
// loop.
// ---------------------------------------------------------------------------

constexpr int kHitRows = 16 * kThreads;  // the most rows a CTA owns: a 16-row chunk a thread
constexpr int kHitCodes = 2048;  // (code, lane bit) pairs a lane group gathers: 32 lanes at K = 64
constexpr uint32_t kNoMatch = 0xFFFFFFFFu;

struct HitParams {
  const uint32_t* values;  // (U, C, RP)
  const int32_t* lengths;  // (U, C, RP), or null: a run a row
  const uint32_t* codes;   // (U, Q, C, K)
  const uint8_t* live;     // (U, Q, C), or null
  const uint8_t* hit;      // (U, n), or null
  uint8_t* out;            // (U, Q, n)
  int64_t n;
  int32_t cols, run_pad, n_codes, lanes;
  int32_t ctas;   // CTAs a unit
  int32_t group;  // lanes a group
  int32_t tile;   // runs a staged tile (a multiple of 4; 0 without lengths)
};

// The 16 bytes at p[0, 16) as words, byte k in word k / 4 at bit 8 (k % 4):
// one 16-byte load when p is 16-byte aligned and the 16 bytes lie before
// `end`, else the bytes before `end` (the rest 0).
__device__ __forceinline__ void load16(const uint8_t* p, const uint8_t* end, uint32_t (&w)[4]) {
  if (p + 16 <= end && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((k & 3) == 0) w[k >> 2] = 0u;
    if (p + k < end) w[k >> 2] |= (uint32_t)__ldg(p + k) << (8 * (k & 3));
  }
}

__global__ void __launch_bounds__(kThreads) rle_cols_hit_kernel(const __grid_constant__ HitParams p) {
  extern __shared__ uint4 hit_sm4[];
  uint32_t* verdict = reinterpret_cast<uint32_t*>(hit_sm4);        // run values, then verdicts
  int32_t* starts = reinterpret_cast<int32_t*>(verdict + p.tile);  // lengths, then starts
  uint2* set = reinterpret_cast<uint2*>(starts + p.tile);  // the group's (code, lane bit) pairs
  __shared__ u64 bar;
  __shared__ int64_t warp_tot[kWarps];
  const int64_t u = blockIdx.x / (unsigned)p.ctas;
  const int64_t n = p.n, rp = p.run_pad;
  int64_t row_lo, row_hi;
  row_share(n, p.ctas, (int)(blockIdx.x % (unsigned)p.ctas), &row_lo, &row_hi);
  if (row_lo >= row_hi) return;
  // this thread's rows: one 16-row chunk [base, end) of the share (empty
  // past it), their lane words in registers across the columns
  const int64_t base = row_lo + 16 * (int64_t)threadIdx.x, end = min64(base + 16, row_hi);
  const int lane = (int)(threadIdx.x & 31);
  uint32_t h[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
  if (p.hit != nullptr && base < end) load16(p.hit + u * n + base, p.hit + u * n + end, h);
  if (threadIdx.x == 0) mbar_init(&bar);
  uint32_t parity = 0;
  for (int q0 = 0; q0 < p.lanes; q0 += p.group) {
    const int nl = min(p.group, p.lanes - q0);
    const uint32_t all = nl == 32 ? 0xFFFFFFFFu : (1u << nl) - 1u;
    const int64_t lane0 = u * p.lanes + q0;  // the group's first (unit, lane)
    const int total = nl * p.n_codes;        // the group's codes of a column
    uint32_t rw[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) rw[k] = 0xFFFFFFFFu;
    for (int c = 0; c < p.cols; ++c) {
      const int64_t uc = u * p.cols + c;
      __syncthreads();  // the column before is read (and the barrier made)
      // in flight together: the first run tile, the values of this
      // thread's rows (a run a row), the first round of codes, the flags
      if (p.lengths != nullptr) {
        const int first = (int)min64(p.tile, rp);
        const Segment seg[2] = {
            {verdict, p.values + uc * rp, first, first},
            {reinterpret_cast<uint32_t*>(starts),
             reinterpret_cast<const uint32_t*>(p.lengths) + uc * rp, first, first}};
        stage_issue(seg, &bar);
      }
      uint32_t v16[16];
      if (p.lengths == nullptr) {
        const uint32_t* vals = p.values + uc * rp;
        if (base + 16 <= rp && (reinterpret_cast<uintptr_t>(vals + base) & 15u) == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(vals + base) + i);
            v16[4 * i] = x.x, v16[4 * i + 1] = x.y, v16[4 * i + 2] = x.z, v16[4 * i + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k)
            v16[k] = base + k < end ? __ldg(vals + min64(base + k, rp - 1)) : 0u;
        }
      }
      auto code_at = [&](int e) {  // code e of the group's column c (lane e / K)
        const int q = e / p.n_codes;
        return __ldg(p.codes + ((lane0 + q) * p.cols + c) * p.n_codes + (e - q * p.n_codes));
      };
      uint32_t code = (int)threadIdx.x < total ? code_at((int)threadIdx.x) : kNoMatch;
      // the group's lanes for which column c is dead, in every warp
      const uint32_t dead = __ballot_sync(
          0xffffffffu, p.live != nullptr && lane < nl && p.live[(lane0 + lane) * p.cols + c] == 0);
      if (dead == all) {  // every row passes for every lane
        if (p.lengths != nullptr) {
          stage_wait(&bar, parity);
          parity ^= 1u;
        }
        continue;
      }
      int ns = 0;  // the list's pairs
      for (int e0 = 0; e0 < total; e0 += kThreads) {
        const int e = e0 + (int)threadIdx.x;
        if (e0 > 0) code = e < total ? code_at(e) : kNoMatch;
        const uint32_t bit = e < total ? 1u << (e / p.n_codes) : 0u;
        const bool keep = code != kNoMatch && !(dead & bit);
        int64_t part;
        const int at = ns + (int)block_exclusive<int64_t>(keep, warp_tot, &part);
        if (keep) set[at] = make_uint2(code, bit);
        ns += (int)part;
      }
      auto word = [&](uint32_t v) {  // a value's verdict word
        uint32_t w = dead;
        for (int i = 0; i < ns; ++i) {
          const uint2 s = set[i];
          w |= v == s.x ? s.y : 0u;
        }
        return w;
      };
      if (p.lengths == nullptr) {
        __syncthreads();  // the list is written
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (base + k < end) rw[k] &= word(v16[k]);
        }
        continue;
      }
      int64_t carry = 0;  // the lengths of the tiles before
      for (int64_t k0 = 0; k0 < rp && min64(carry, n) < row_hi; k0 += p.tile) {
        const int cnt = (int)min64(p.tile, rp - k0);
        if (k0 == 0) {
          stage_wait(&bar, parity);  // its barrier also publishes the list
        } else {
          const Segment next[2] = {
              {verdict, p.values + uc * rp + k0, cnt, cnt},
              {reinterpret_cast<uint32_t*>(starts),
               reinterpret_cast<const uint32_t*>(p.lengths) + uc * rp + k0, cnt, cnt}};
          stage_bulk(next, &bar, parity);
        }
        parity ^= 1u;
        const int64_t sum = tile_starts(starts, cnt, carry, n, warp_tot, [](int) {});
        const int64_t s0 = min64(carry, n);
        const int64_t s1 = k0 + cnt < rp ? min64(carry + sum, n) : n;
        const int64_t lo = s0 > row_lo ? s0 : row_lo, hi = min64(s1, row_hi);
        carry += sum;
        if (lo < hi) {
          const int j1 = covering_run(starts, cnt, hi - 1);
          for (int j = covering_run(starts, cnt, lo) + (int)threadIdx.x; j <= j1; j += kThreads)
            verdict[j] = word(verdict[j]);
          __syncthreads();
          rle_walk(
              verdict, starts, cnt, lo, hi, base, [&](int k, uint32_t v) { rw[k] &= v; },
              [](int64_t, int64_t, int64_t) {});
        }
        __syncthreads();  // the tile is read before the next stage overwrites it
      }
    }
    if (base < end) {
      for (int q = 0; q < nl; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = (((rw[4 * i] >> q) & 1u) | (((rw[4 * i + 1] >> q) & 1u) << 8) |
                  (((rw[4 * i + 2] >> q) & 1u) << 16) | (((rw[4 * i + 3] >> q) & 1u) << 24)) &
                 h[i];
        }
        store_rows(p.out + (lane0 + q) * n, base, base, end, w);
      }
    }
  }
}

// The deltas that rows [ib, ib + kPer) of a page add (row i adds field
// i - 1; row 0 and rows at or past n add none), cut straight from its words
// in device memory: a funnel shift a delta from a sliding pair of words
// (past the page's count a word reads as zero), the low 32 bits of a
// width-bit field at any width 0-64, unzigzagged and sign-extended.
__device__ __forceinline__ void dbp_page_deltas(const ScanPage& pg, uint32_t w, int64_t ib,
                                                int32_t (&d)[kPer]) {
  const uint32_t mask = w >= 32u ? 0xFFFFFFFFu : ((1u << w) - 1u);
  const u64 off = (u64)(ib > 0 ? ib - 1 : 0) * w;
  int64_t wi = (int64_t)(off >> 5);
  uint32_t rem = (uint32_t)(off & 31u);
  auto word = [&](int64_t k) { return k < pg.count ? __ldg(pg.a + k) : 0u; };
  uint32_t lo = word(wi), hi = word(wi + 1);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = ib + k;
    d[k] = 0;
    if (i >= 1 && i < pg.n) {
      const uint32_t z = __funnelshift_r(lo, hi, rem) & mask;
      d[k] = (int32_t)((z >> 1) ^ (0u - (z & 1u)));
      rem += w;
      while (rem >= 32u) {
        rem -= 32u;
        ++wi;
        lo = hi;
        hi = word(wi + 1);
      }
    }
  }
}

__device__ __forceinline__ u64 lane_sum(const int32_t (&d)[kPer]) {
  u64 s = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s += (u64)(int64_t)d[k];
  return s;
}

// Rows [i0, i0 + kPer) of out: acc (the value before row i0) plus each
// delta, compared with [lo, hi] as unsigned 64-bit; one 8-byte store.
__device__ __forceinline__ void dbp_compare(const int32_t (&d)[kPer], u64 acc, u64 lo, u64 hi,
                                            uint8_t* __restrict__ out, int64_t i0, int64_t n) {
  u64 bytes = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    acc += (u64)(int64_t)d[k];
    bytes |= (u64)(acc >= lo && acc <= hi) << (8 * k);
  }
  if (i0 < n) store_mask(out, i0, n, bytes);
}

// A dbp page's scan in CTAs of T threads, each lane kPer rows of a tile of
// kPer x T (lane_first).
template <int T>
__global__ void __launch_bounds__(T) resident_dbp_kernel(const __grid_constant__ ScanParams p) {
  constexpr int kNW = T / 32;
  constexpr int64_t kRows = (int64_t)kPer * T;  // rows a tile
  __shared__ u64 xs[kNW];
  __shared__ u64 pushed[kDbpCtas];  // the sums of the shares before this one
  __shared__ u64 bar;               // completes when all of them are in
  const int c = (int)(blockIdx.x % (unsigned)p.ctas);
  const ScanPage pg = scan_page(p, blockIdx.x / (unsigned)p.ctas);
  const uint32_t w = (uint32_t)pg.width;
  uint8_t* out = p.out + pg.out_off;
  const int64_t tiles = cdiv(pg.n, kRows), per = cdiv(tiles, p.ctas);
  const int64_t t0 = min64(tiles, c * per), t1 = min64(tiles, t0 + per);
  if (p.ctas > 1) {  // every CTA's barrier set up before any CTA pushes
    if (threadIdx.x == 0 && c > 0) mbar_init(&bar, (uint32_t)c);
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  int32_t d[kPer];
  u64 before = 0, total = 0;  // the lane's offset in a one-tile share; the share's sum
  if (t1 - t0 == 1) {
    dbp_page_deltas(pg, w, lane_first(t0 * kRows), d);
    before = block_exclusive<u64, kNW>(lane_sum(d), xs, &total);
  } else if (p.ctas > 1) {
    u64 s = 0;
    for (int64_t t = t0; t < t1; ++t) {
      dbp_page_deltas(pg, w, lane_first(t * kRows), d);
      s += lane_sum(d);
    }
    total = block_sum<kNW>(s, xs);
  }
  u64 carry = pg.first;
  if (p.ctas > 1) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    // thread k pushes the share's sum into CTA k > c and arrives on its
    // barrier; only pushes cross CTAs and every CTA waits for all of the
    // pushes into it, so a CTA may exit without a cluster barrier
    const int to = threadIdx.x;
    if (to > c && to < p.ctas) {
      asm volatile(
          "{\n .reg .b32 ra, rb;\n mapa.shared::cluster.u32 ra, %0, %2;\n"
          " mapa.shared::cluster.u32 rb, %1, %2;\n st.shared::cluster.u64 [ra], %3;\n"
          " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rb];\n}\n" ::"r"(
              smem_u32(&pushed[c])),
          "r"(smem_u32(&bar)), "r"(to), "l"(total)
          : "memory");
    }
    if (c > 0) {
      mbar_wait<true>(&bar, 0);
      const int lane = threadIdx.x & 31;
      carry += warp_sum(lane < c ? pushed[lane] : 0ull);
    }
  }
  if (t1 - t0 == 1) {
    dbp_compare(d, carry + before, p.lo64, p.hi64, out, lane_first(t0 * kRows), pg.n);
    return;
  }
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t i0 = lane_first(t * kRows);
    dbp_page_deltas(pg, w, i0, d);
    u64 tile_sum;
    const u64 acc = carry + block_exclusive<u64, kNW>(lane_sum(d), xs, &tile_sum);
    dbp_compare(d, acc, p.lo64, p.hi64, out, i0, pg.n);
    carry += tile_sum;
  }
}

// A lane's kPer indices of rows [i0, i0 + kPer) (rows at or past n read 0):
// two 16-byte loads where the rows are whole and aligned.
__device__ __forceinline__ void dct_indices(const int32_t* __restrict__ idx, int64_t i0, int64_t n,
                                            int32_t (&ix)[kPer]) {
  if (i0 + kPer <= n && (reinterpret_cast<uintptr_t>(idx + i0) & 15u) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(idx + i0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(idx + i0) + 1);
    ix[0] = a.x, ix[1] = a.y, ix[2] = a.z, ix[3] = a.w;
    ix[4] = b.x, ix[5] = b.y, ix[6] = b.z, ix[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) ix[k] = i0 + k < n ? __ldg(idx + i0 + k) : 0;
  }
}

constexpr int kDctLoads = 4;  // dictionary words a warp loads for the bitset
// The most entries a page's bitset holds: one round of a CTA's warps'
// loads; a larger dictionary takes a verdict a row.
constexpr int kDctBitsetEntries = 32 * kWarps * kDctLoads;

// A dct page's scan (see "One launch a scan"); dynamic shared memory: the
// verdict bitset, cdiv(v, 32) words (none when p.by_row).
__global__ void __launch_bounds__(kThreads)
    resident_dct_kernel(const __grid_constant__ ScanParams p) {
  extern __shared__ uint4 dct_sm4[];
  uint32_t* bits = reinterpret_cast<uint32_t*>(dct_sm4);
  const int c = (int)(blockIdx.x % (unsigned)p.ctas);
  const ScanPage pg = scan_page(p, blockIdx.x / (unsigned)p.ctas);
  const int32_t v = (int32_t)pg.count;  // the host caps a dictionary at 2^31 - 1 entries
  const int64_t n = pg.n;
  const int tiles = (int)cdiv(n, kTile);
  if (c >= tiles) return;
  const int32_t* idx = reinterpret_cast<const int32_t*>(pg.b);
  int32_t ix[kPer];
  dct_indices(idx, lane_first((int64_t)c * kTile), n, ix);
  // the code set where the launch left it: its parameters, or device memory
  const uint32_t* codes = p.codes_dev ? p.codes_dev : p.codes;
  uint32_t c8[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c8[k] = p.n_codes > 0 ? codes[k < p.n_codes ? k : 0] : 0u;
  if (!p.by_row) {  // v <= kDctBitsetEntries: warp k loads words k, k + kWarps, ...
    const int lane = threadIdx.x & 31, words = (v + 31) >> 5;
    uint32_t val[kDctLoads];
#pragma unroll
    for (int j = 0; j < kDctLoads; ++j) {
      const int e = ((int)(threadIdx.x >> 5) + j * kWarps) * 32 + lane;
      val[j] = e < v ? __ldg(pg.a + e) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kDctLoads; ++j) {
      const int w = (int)(threadIdx.x >> 5) + j * kWarps;
      const bool hit = w * 32 + lane < v && scan_verdict(p, codes, c8, val[j]);
      const uint32_t word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0 && w < words) bits[w] = word;
    }
    __syncthreads();
  }
  uint8_t* out = p.out + pg.out_off;
  for (int t = c; t < tiles; t += p.ctas) {
    const int64_t i0 = lane_first((int64_t)t * kTile);
    if (t != c) dct_indices(idx, i0, n, ix);
    if (i0 >= n || v == 0) continue;  // v == 0: no row (a page of rows has a dictionary)
    int32_t e[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      e[k] = ix[k] < 0 ? ix[k] + v : ix[k];
      e[k] = e[k] < 0 ? 0 : (e[k] >= v ? v - 1 : e[k]);
    }
    u64 bytes = 0;
    if (p.by_row) {
      uint32_t val[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) val[k] = __ldg(pg.a + e[k]);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        bytes |= (u64)scan_verdict(p, codes, c8, val[k]) << (8 * k);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        bytes |= (u64)((bits[e[k] >> 5] >> (e[k] & 31)) & 1u) << (8 * k);
    }
    store_mask(out, i0, n, bytes);
  }
}

constexpr size_t kRleSmem = 2 * (size_t)kRunTile * 4;

// Launch `kernel` over n_pages pages of prm.ctas CTAs of `threads` each (a
// cluster of them when `cluster`, of up to 16); returns the launch's error.
cudaError_t scan_launch(void (*kernel)(ScanParams), const ScanParams& prm, int64_t n_pages,
                        size_t smem, bool cluster, cudaStream_t stream, int threads = kThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(n_pages * prm.ctas));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)prm.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster && prm.ctas > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, prm);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// CTAs a page: enough for its rows (rows_a_cta each), at most `most`, and
// where `fill`, no more than two waves' worth over the card's SMs for all
// pages (each rle CTA scans all of its page's runs again).
int scan_ctas(int64_t max_n, int64_t rows_a_cta, int64_t n_pages, int most, bool fill) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      sms = count;
  }
  int64_t c = cdiv(max_n, rows_a_cta);
  const int64_t waves = cdiv(2 * (int64_t)(sms > 0 ? sms : 132), n_pages);
  if (fill && c > waves) c = waves;
  return (int)(c < 1 ? 1 : (c > most ? most : c));
}

// The parameters of an rle or dct scan of one page (page on the host) or
// of a page table (table in device memory), its code set by value when it
// fits; false when an argument is out of range.
bool code_params(ScanParams* prm, const int64_t* page, const void* table, int64_t max_n,
                 const void* codes, int32_t n_codes, const void* codes_dev, int32_t mode,
                 uint32_t lo, uint32_t hi, void* out) {
  if (max_n > INT32_MAX || mode < 0 || mode > kModeBetween) return false;
  if (mode != kModeBetween && n_codes > kScanCodes && codes_dev == nullptr) return false;
  memset(prm, 0, sizeof(ScanParams));
  if (page) memcpy(&prm->page, page, sizeof(ScanPage));
  prm->table = (const ScanPage*)table;
  prm->out = (uint8_t*)out;
  prm->mode = mode;
  prm->n_codes = mode == kModeBetween ? 0 : n_codes;
  prm->lo = lo;
  prm->hi = hi;
  prm->codes_dev = (const uint32_t*)codes_dev;
  if (codes_dev == nullptr && prm->n_codes > 0)
    memcpy(prm->codes, codes, 4 * (size_t)prm->n_codes);
  return true;
}

// The rle scan of one page or of a page table; see tt_resident_rle_scan.
int rle_scan(const int64_t* page, const void* table, int32_t n_pages, int64_t max_n,
             const void* codes, int32_t n_codes, const void* codes_dev, int32_t mode, uint32_t lo,
             uint32_t hi, void* out, int32_t* launched, void* stream) {
  *launched = 0;
  if (n_pages == 0 || max_n == 0) return 0;
  ScanParams prm;
  if (!code_params(&prm, page, table, max_n, codes, n_codes, codes_dev, mode, lo, hi, out))
    return (int)cudaErrorInvalidValue;
  prm.ctas = scan_ctas(max_n, kRleCtaRows, n_pages, kScanCtas, true);
  const cudaError_t err =
      scan_launch(resident_rle_kernel, prm, n_pages, kRleSmem, false, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// The dct scan of one page or of a page table (max_v: the most entries of
// a page's dictionary); see tt_resident_dct_scan.
int dct_scan(const int64_t* page, const void* table, int32_t n_pages, int64_t max_n,
             int64_t max_v, const void* codes, int32_t n_codes, const void* codes_dev,
             int32_t mode, uint32_t lo, uint32_t hi, void* out, int32_t* launched, void* stream) {
  *launched = 0;
  if (n_pages == 0 || max_n == 0) return 0;
  ScanParams prm;
  if (max_v < 1 || max_v > INT32_MAX ||
      !code_params(&prm, page, table, max_n, codes, n_codes, codes_dev, mode, lo, hi, out))
    return (int)cudaErrorInvalidValue;
  prm.by_row = max_v > kDctBitsetEntries;
  prm.ctas = (int)std::min<int64_t>(cdiv(max_n, kTile), kDctCtas);
  const size_t smem = prm.by_row ? 0 : (size_t)cdiv(max_v, 32) * 4;
  const cudaError_t err =
      scan_launch(resident_dct_kernel, prm, n_pages, smem, false, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

int dbp_scan(const int64_t* page, const void* table, int32_t n_pages, int64_t max_n,
             uint64_t lo, uint64_t hi, void* out, int32_t* launched, void* stream) {
  *launched = 0;
  if (n_pages == 0 || max_n == 0) return 0;
  if (page && (page[5] < 0 || page[5] > 64)) return (int)cudaErrorInvalidValue;
  ScanParams prm = {};
  if (page) memcpy(&prm.page, page, sizeof(ScanPage));
  prm.table = (const ScanPage*)table;
  prm.out = (uint8_t*)out;
  // CTAs of 512 threads where 256 would leave a CTA more than one tile
  const bool wide = cdiv(max_n, kTile) > kDbpCtas;
  const int threads = wide ? 2 * kThreads : kThreads;
  prm.ctas = scan_ctas(max_n, (int64_t)kPer * threads, n_pages, kDbpCtas, false);
  prm.mode = kModeBetween;
  prm.lo64 = lo;
  prm.hi64 = hi;
  const cudaError_t err =
      scan_launch(wide ? resident_dbp_kernel<2 * kThreads> : resident_dbp_kernel<kThreads>, prm,
                  n_pages, 0, true, (cudaStream_t)stream, threads);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
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

// page: 8 int64 on the host, an rle page in ScanPage's layout (values,
// lengths, r >= 1, n <= INT32_MAX, 0, 0, 0, 0; lengths >= 0); codes:
// n_codes uint32 on the host, by value in the launch when n_codes <=
// tt_resident_scan_codes(), else codes_dev, the same codes in device memory
// (taken whenever given); mode 0 "in the set", 1 "not in it", 2 lo <= value
// <= hi; out: (n,) uint8 row mask. *launched: the kernels launched (1, or 0
// when n == 0).
int tt_resident_rle_scan(const int64_t* page, const void* codes, int32_t n_codes,
                         const void* codes_dev, int32_t mode, uint32_t lo, uint32_t hi, void* out,
                         int32_t* launched, void* stream) {
  return rle_scan(page, nullptr, 1, page[3], codes, n_codes, codes_dev, mode, lo, hi, out,
                  launched, stream);
}

// table: n_pages x 8 int64 rle pages in device memory, each with its mask's
// offset in out (a multiple of 16 keeps the stores whole; pages of r == 0
// give zeros); max_n: the most rows of a page; the rest as
// tt_resident_rle_scan. *launched: 1, or 0 when there is no row.
int tt_resident_rle_scan_batch(const void* table, int32_t n_pages, int64_t max_n,
                               const void* codes, int32_t n_codes, const void* codes_dev,
                               int32_t mode, uint32_t lo, uint32_t hi, void* out,
                               int32_t* launched, void* stream) {
  return rle_scan(nullptr, table, n_pages, max_n, codes, n_codes, codes_dev, mode, lo, hi, out,
                  launched, stream);
}

// The most codes a resident rle or dct scan takes by value.
int tt_resident_scan_codes(void) { return kScanCodes; }

// page: 8 int64 on the host, a dct page in ScanPage's layout (dictionary,
// idx, v >= 1 entries, n <= INT32_MAX rows, 0, 0, 0, 0; idx int32, read as
// jnp indexing reads it); codes, mode, lo, hi and out as
// tt_resident_rle_scan. *launched: the kernels launched (1, or 0 when n ==
// 0).
int tt_resident_dct_scan(const int64_t* page, const void* codes, int32_t n_codes,
                         const void* codes_dev, int32_t mode, uint32_t lo, uint32_t hi, void* out,
                         int32_t* launched, void* stream) {
  return dct_scan(page, nullptr, 1, page[3], page[2], codes, n_codes, codes_dev, mode, lo, hi,
                  out, launched, stream);
}

// table: n_pages x 8 int64 dct pages in device memory, each with its mask's
// offset in out (a multiple of 16; a page of rows has a dictionary); max_n,
// max_v: the most rows and dictionary entries of a page; the rest as
// tt_resident_dct_scan. *launched: 1, or 0 when there is no row.
int tt_resident_dct_scan_batch(const void* table, int32_t n_pages, int64_t max_n, int64_t max_v,
                               const void* codes, int32_t n_codes, const void* codes_dev,
                               int32_t mode, uint32_t lo, uint32_t hi, void* out,
                               int32_t* launched, void* stream) {
  return dct_scan(nullptr, table, n_pages, max_n, max_v, codes, n_codes, codes_dev, mode, lo, hi,
                  out, launched, stream);
}

// page: 8 int64 on the host, a dbp page in ScanPage's layout (words, 0,
// n_words, n, first, width 0..64, 0, 0: the packed deltas with their guard
// word); lo, hi: inclusive uint64 bounds; out: (n,) uint8 row mask.
// *launched: the kernels launched (1, or 0 when n == 0).
int tt_resident_dbp_scan(const int64_t* page, uint64_t lo, uint64_t hi, void* out,
                         int32_t* launched, void* stream) {
  return dbp_scan(page, nullptr, 1, page[3], lo, hi, out, launched, stream);
}

// table: n_pages x 8 int64 dbp pages in device memory (widths 0..64), each
// with its mask's offset in out; max_n: the most rows of a page.
// *launched: 1, or 0 when there is no row.
int tt_resident_dbp_scan_batch(const void* table, int32_t n_pages, int64_t max_n, uint64_t lo,
                               uint64_t hi, void* out, int32_t* launched, void* stream) {
  return dbp_scan(nullptr, table, n_pages, max_n, lo, hi, out, launched, stream);
}

// values (U, C, RP) uint32; lengths (U, C, RP) int32 >= 0, or null (a run
// a row); codes (U, Q, C, K) uint32; live (U, Q, C) bool or null; hit (U,
// n) bool or null; out (U, Q, n) bool. One launch (none when there is no
// row or lane); n <= INT32_MAX.
int tt_rle_cols_hit(const uint32_t* values, const int32_t* lengths, int32_t n_units,
                    int32_t n_cols, int32_t run_pad, const uint32_t* codes, int32_t n_codes,
                    int32_t n_lanes, const uint8_t* live, const uint8_t* hit, int64_t n,
                    uint8_t* out, void* stream) {
  if (n_units <= 0 || n_lanes <= 0 || n <= 0) return 0;
  if (n_cols <= 0 || run_pad <= 0 || n_codes <= 0 || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  HitParams p;
  p.values = values;
  p.lengths = lengths;
  p.codes = codes;
  p.live = live;
  p.hit = hit;
  p.out = out;
  p.n = n;
  p.cols = n_cols;
  p.run_pad = run_pad;
  p.n_codes = n_codes;
  p.lanes = n_lanes;
  p.ctas = (int)cdiv(n, kHitRows);
  p.group = std::max(1, std::min(32, kHitCodes / n_codes));
  p.tile = lengths == nullptr ? 0 : (int)((std::min<int64_t>(run_pad, kRunTile) + 3) & ~3);
  const int64_t grid = (int64_t)n_units * p.ctas;
  const int64_t smem = (int64_t)p.tile * 8 + (int64_t)p.group * n_codes * 8;
  if (grid > INT32_MAX || smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      rle_cols_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rle_cols_hit_kernel<<<(unsigned)grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

// tempo_tpu native codec library.
//
// Host-side runtime for the block codec: compression (zstd, zlib),
// CRC32 page checksums, and integer column transforms
// (delta + zigzag + varint) used by the vtpu1/v2t page formats before
// general-purpose compression. Fills the native-code obligation the
// reference covers with vendored pure-Go libs
// (tempodb/encoding/v2/pool.go:96-405 compression pools,
// tempodb/encoding/v2/page.go CRC pages, segmentio/parquet-go delta
// codecs) — here as real C++ running off the Python GIL via ctypes.
//
// API convention: functions return the number of bytes/elements
// written, or a negative error code.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <new>

#include <zlib.h>
#if defined(__has_include) && __has_include(<zstd.h>)
#include <zstd.h>
#else
// Some images ship the zstd runtime (libzstd.so.1) without the dev
// header. The handful of entry points used below have had a stable ABI
// since zstd 1.3, so declare them directly and let the loader bind.
extern "C" {
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t srcSize);
}
#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)
#endif

extern "C" {

enum {
  TTPU_ERR_CAP = -1,      // destination too small
  TTPU_ERR_CORRUPT = -2,  // malformed input
  TTPU_ERR_ARG = -3,      // bad argument
};

// ---------------------------------------------------------------------------
// checksums
// ---------------------------------------------------------------------------

uint32_t ttpu_crc32(const uint8_t* src, size_t n) {
  return (uint32_t)crc32(0L, src, (uInt)n);
}

// xxhash-like 64-bit mix used for quick content addressing of pages.
uint64_t ttpu_hash64(const uint8_t* src, size_t n, uint64_t seed) {
  const uint64_t PRIME1 = 0x9E3779B185EBCA87ULL;
  const uint64_t PRIME2 = 0xC2B2AE3D27D4EB4FULL;
  uint64_t h = seed ^ (n * PRIME1);
  size_t i = 0;
  while (i + 8 <= n) {
    uint64_t k;
    memcpy(&k, src + i, 8);
    k *= PRIME2;
    k = (k << 31) | (k >> 33);
    k *= PRIME1;
    h ^= k;
    h = ((h << 27) | (h >> 37)) * PRIME1 + PRIME2;
    i += 8;
  }
  while (i < n) {
    h ^= (uint64_t)src[i] * PRIME1;
    h = ((h << 11) | (h >> 53)) * PRIME2;
    i++;
  }
  h ^= h >> 33;
  h *= PRIME2;
  h ^= h >> 29;
  h *= PRIME1;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// compression
// ---------------------------------------------------------------------------

size_t ttpu_zstd_bound(size_t n) { return ZSTD_compressBound(n); }

long long ttpu_zstd_compress(const uint8_t* src, size_t n, uint8_t* dst,
                             size_t cap, int level) {
  size_t r = ZSTD_compress(dst, cap, src, n, level);
  if (ZSTD_isError(r)) return TTPU_ERR_CAP;
  return (long long)r;
}

long long ttpu_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap) {
  size_t r = ZSTD_decompress(dst, cap, src, n);
  if (ZSTD_isError(r)) return TTPU_ERR_CORRUPT;
  return (long long)r;
}

// content size embedded in a zstd frame, or -1 if unknown.
long long ttpu_zstd_content_size(const uint8_t* src, size_t n) {
  unsigned long long r = ZSTD_getFrameContentSize(src, n);
  if (r == ZSTD_CONTENTSIZE_ERROR || r == ZSTD_CONTENTSIZE_UNKNOWN)
    return TTPU_ERR_CORRUPT;
  return (long long)r;
}

size_t ttpu_zlib_bound(size_t n) { return compressBound((uLong)n); }

long long ttpu_zlib_compress(const uint8_t* src, size_t n, uint8_t* dst,
                             size_t cap, int level) {
  uLongf dlen = (uLongf)cap;
  int r = compress2(dst, &dlen, src, (uLong)n, level);
  if (r != Z_OK) return TTPU_ERR_CAP;
  return (long long)dlen;
}

long long ttpu_zlib_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap) {
  uLongf dlen = (uLongf)cap;
  int r = uncompress(dst, &dlen, src, (uLong)n);
  if (r == Z_BUF_ERROR) return TTPU_ERR_CAP;
  if (r != Z_OK) return TTPU_ERR_CORRUPT;
  return (long long)dlen;
}

// ---------------------------------------------------------------------------
// integer column transforms: delta + zigzag + LEB128 varint
// ---------------------------------------------------------------------------

static inline uint64_t zigzag(int64_t v) {
  return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}
static inline int64_t unzigzag(uint64_t v) {
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

// delta-encode then varint. Worst case 10 bytes/elem.
long long ttpu_varint_encode_i64(const int64_t* src, size_t n, uint8_t* dst,
                                 size_t cap) {
  size_t o = 0;
  int64_t prev = 0;
  for (size_t i = 0; i < n; i++) {
    uint64_t u = zigzag(src[i] - prev);
    prev = src[i];
    do {
      if (o >= cap) return TTPU_ERR_CAP;
      uint8_t b = u & 0x7F;
      u >>= 7;
      dst[o++] = b | (u ? 0x80 : 0);
    } while (u);
  }
  return (long long)o;
}

long long ttpu_varint_decode_i64(const uint8_t* src, size_t n, int64_t* dst,
                                 size_t cap_elems) {
  size_t i = 0, e = 0;
  int64_t prev = 0;
  while (i < n) {
    if (e >= cap_elems) return TTPU_ERR_CAP;
    uint64_t u = 0;
    int shift = 0;
    for (;;) {
      if (i >= n || shift > 63) return TTPU_ERR_CORRUPT;
      uint8_t b = src[i++];
      u |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    prev += unzigzag(u);
    dst[e++] = prev;
  }
  return (long long)e;
}

// ---------------------------------------------------------------------------
// page codec: [u8 codec][u32 crc of raw][u32 raw_len][payload]
// one call per page, combining transform + compression + checksum so the
// whole page path runs without the GIL.
// codec ids: 0=none 1=zlib 2=zstd
// ---------------------------------------------------------------------------

enum { PAGE_HDR = 9 };

long long ttpu_page_encode(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t cap, int codec, int level) {
  if (cap < PAGE_HDR) return TTPU_ERR_CAP;
  uint32_t crc = ttpu_crc32(src, n);
  dst[0] = (uint8_t)codec;
  memcpy(dst + 1, &crc, 4);
  uint32_t rl = (uint32_t)n;
  memcpy(dst + 5, &rl, 4);
  long long body;
  switch (codec) {
    case 0:
      if (cap - PAGE_HDR < n) return TTPU_ERR_CAP;
      memcpy(dst + PAGE_HDR, src, n);
      body = (long long)n;
      break;
    case 1:
      body = ttpu_zlib_compress(src, n, dst + PAGE_HDR, cap - PAGE_HDR, level);
      break;
    case 2:
      body = ttpu_zstd_compress(src, n, dst + PAGE_HDR, cap - PAGE_HDR, level);
      break;
    default:
      return TTPU_ERR_ARG;
  }
  if (body < 0) return body;
  return body + PAGE_HDR;
}

// returns raw length; dst must hold ttpu_page_raw_len() bytes.
long long ttpu_page_raw_len(const uint8_t* src, size_t n) {
  if (n < PAGE_HDR) return TTPU_ERR_CORRUPT;
  uint32_t rl;
  memcpy(&rl, src + 5, 4);
  return (long long)rl;
}

long long ttpu_page_decode(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t cap) {
  if (n < PAGE_HDR) return TTPU_ERR_CORRUPT;
  int codec = src[0];
  uint32_t crc, rl;
  memcpy(&crc, src + 1, 4);
  memcpy(&rl, src + 5, 4);
  if (cap < rl) return TTPU_ERR_CAP;
  long long body;
  switch (codec) {
    case 0:
      if (n - PAGE_HDR != rl) return TTPU_ERR_CORRUPT;
      memcpy(dst, src + PAGE_HDR, rl);
      body = rl;
      break;
    case 1:
      body = ttpu_zlib_decompress(src + PAGE_HDR, n - PAGE_HDR, dst, cap);
      break;
    case 2:
      body = ttpu_zstd_decompress(src + PAGE_HDR, n - PAGE_HDR, dst, cap);
      break;
    default:
      return TTPU_ERR_CORRUPT;
  }
  if (body < 0) return body;
  if ((uint32_t)body != rl) return TTPU_ERR_CORRUPT;
  if (ttpu_crc32(dst, rl) != crc) return TTPU_ERR_CORRUPT;
  return body;
}

// ---------------------------------------------------------------------------
// column codec: crc + optional byte-shuffle + compression in ONE call.
//
// Byte-shuffle (blosc-style): an N x width byte matrix is transposed so
// each byte plane is contiguous. Fixed-width columns (timestamps,
// dictionary codes, float64 attrs) have near-constant high bytes, so the
// shuffled layout compresses several times smaller AND several times
// faster under zstd than the interleaved bytes (measured on the bench
// workload: u64 timestamps 310 MB/s -> 2.5 GB/s at better ratio).
// codec ids: 0=none 1=zlib 2=zstd 3=zstd+shuffle
// ---------------------------------------------------------------------------

static void shuffle_bytes(const uint8_t* src, size_t n_elems, size_t width,
                          uint8_t* dst) {
  for (size_t p = 0; p < width; p++) {
    const uint8_t* s = src + p;
    uint8_t* d = dst + p * n_elems;
    for (size_t i = 0; i < n_elems; i++) d[i] = s[i * width];
  }
}

static void unshuffle_bytes(const uint8_t* src, size_t n_elems, size_t width,
                            uint8_t* dst) {
  for (size_t p = 0; p < width; p++) {
    const uint8_t* s = src + p * n_elems;
    uint8_t* d = dst + p;
    for (size_t i = 0; i < n_elems; i++) d[i * width] = s[i];
  }
}

long long ttpu_col_encode(const uint8_t* src, size_t n, size_t width,
                          int codec, int level, uint8_t* dst, size_t cap,
                          uint32_t* crc_out) {
  if (width == 0 || n % width != 0) return TTPU_ERR_ARG;
  *crc_out = ttpu_crc32(src, n);
  switch (codec) {
    case 0:
      if (cap < n) return TTPU_ERR_CAP;
      memcpy(dst, src, n);
      return (long long)n;
    case 1:
      return ttpu_zlib_compress(src, n, dst, cap, level);
    case 2:
      return ttpu_zstd_compress(src, n, dst, cap, level);
    case 3: {
      if (width == 1) return ttpu_zstd_compress(src, n, dst, cap, level);
      uint8_t* tmp = new (std::nothrow) uint8_t[n];
      if (!tmp) return TTPU_ERR_CAP;
      shuffle_bytes(src, n / width, width, tmp);
      long long r = ttpu_zstd_compress(tmp, n, dst, cap, level);
      delete[] tmp;
      return r;
    }
    default:
      return TTPU_ERR_ARG;
  }
}

long long ttpu_col_decode(const uint8_t* src, size_t n, int codec,
                          size_t width, uint8_t* dst, size_t raw_len,
                          uint32_t* crc_out) {
  if (width == 0 || raw_len % width != 0) return TTPU_ERR_ARG;
  long long body;
  switch (codec) {
    case 0:
      if (n != raw_len) return TTPU_ERR_CORRUPT;
      memcpy(dst, src, n);
      body = (long long)n;
      break;
    case 1:
      body = ttpu_zlib_decompress(src, n, dst, raw_len);
      break;
    case 2:
      body = ttpu_zstd_decompress(src, n, dst, raw_len);
      break;
    case 3: {
      if (width == 1) {
        body = ttpu_zstd_decompress(src, n, dst, raw_len);
        break;
      }
      uint8_t* tmp = new (std::nothrow) uint8_t[raw_len];
      if (!tmp) return TTPU_ERR_CAP;
      body = ttpu_zstd_decompress(src, n, tmp, raw_len);
      if (body == (long long)raw_len)
        unshuffle_bytes(tmp, raw_len / width, width, dst);
      delete[] tmp;
      break;
    }
    default:
      return TTPU_ERR_CORRUPT;
  }
  if (body < 0) return body;
  if ((size_t)body != raw_len) return TTPU_ERR_CORRUPT;
  *crc_out = ttpu_crc32(dst, raw_len);
  return body;
}

// ---------------------------------------------------------------------------
// k-way merge of sorted id streams. Keys are u128 (two u64 lanes: hi,lo)
// or u192 (three lanes: hi,mid,lo = traceID high/low + spanID). Host-side
// bookmark merge used by the compactor to plan row pulls across input
// blocks whose rows are already sorted; the device handles intra-batch
// sort/dedupe, this handles the streaming cross-block order.
// Emits (stream_idx u32, row_idx u32) pairs in global id order with
// duplicates flagged via dup_mask bit.
// ---------------------------------------------------------------------------

static long long kway_merge_impl(const uint64_t* const* keys_hi,
                                 const uint64_t* const* keys_mid,
                                 const uint64_t* const* keys_lo,
                                 const size_t* lens, size_t k,
                                 uint32_t* out_stream, uint32_t* out_row,
                                 uint8_t* out_dup, size_t cap) {
  if (k == 0) return 0;
  // simple loser-tree-free k-way scan: k is small (<=8 in compaction)
  size_t pos_buf[64];
  if (k > 64) return TTPU_ERR_ARG;
  memset(pos_buf, 0, sizeof(pos_buf));
  size_t emitted = 0;
  uint64_t last_hi = 0, last_mid = 0, last_lo = 0;
  bool have_last = false;
  for (;;) {
    int best = -1;
    uint64_t bh = 0, bm = 0, bl = 0;
    for (size_t i = 0; i < k; i++) {
      if (pos_buf[i] >= lens[i]) continue;
      uint64_t h = keys_hi[i][pos_buf[i]];
      uint64_t m = keys_mid ? keys_mid[i][pos_buf[i]] : 0;
      uint64_t l = keys_lo[i][pos_buf[i]];
      if (best < 0 || h < bh || (h == bh && (m < bm || (m == bm && l < bl)))) {
        best = (int)i;
        bh = h;
        bm = m;
        bl = l;
      }
    }
    if (best < 0) break;
    if (emitted >= cap) return TTPU_ERR_CAP;
    out_stream[emitted] = (uint32_t)best;
    out_row[emitted] = (uint32_t)pos_buf[best];
    out_dup[emitted] =
        (have_last && bh == last_hi && bm == last_mid && bl == last_lo) ? 1 : 0;
    last_hi = bh;
    last_mid = bm;
    last_lo = bl;
    have_last = true;
    pos_buf[best]++;
    emitted++;
  }
  return (long long)emitted;
}

long long ttpu_kway_merge_u128(const uint64_t* const* keys_hi,
                               const uint64_t* const* keys_lo,
                               const size_t* lens, size_t k,
                               uint32_t* out_stream, uint32_t* out_row,
                               uint8_t* out_dup, size_t cap) {
  return kway_merge_impl(keys_hi, nullptr, keys_lo, lens, k, out_stream,
                         out_row, out_dup, cap);
}

long long ttpu_kway_merge_u192(const uint64_t* const* keys_hi,
                               const uint64_t* const* keys_mid,
                               const uint64_t* const* keys_lo,
                               const size_t* lens, size_t k,
                               uint32_t* out_stream, uint32_t* out_row,
                               uint8_t* out_dup, size_t cap) {
  return kway_merge_impl(keys_hi, keys_mid, keys_lo, lens, k, out_stream,
                         out_row, out_dup, cap);
}

}  // extern "C"

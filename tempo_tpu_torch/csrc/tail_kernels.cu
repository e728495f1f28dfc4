// Hand-written Hopper (sm_90a) kernels of tempo_tpu_torch's ingest tail: the
// standing fold and the live-tail search mask over a just-cut batch parked on
// the card (tempo_tpu_torch/ops/ingest_tail.py).
//
// Neither replaces a Pallas kernel: each replaces a jitted JAX program of the
// reference, which XLA compiled for the TPU.
//   tail_fold  tempo_tpu/ops/ingest_tail.py:234-295  (_fold_kernel via
//                                                     resident_fold)
//   tail_scan  tempo_tpu/ops/ingest_tail.py:410-436  (_scan_kernel via
//                                                     tail_search_mask)
// Each computes the same function as its plain PyTorch version
// (ops/ingest_tail.py _tail_fold_plain / _tail_scan_plain), bit for bit. The
// interface is plain C: a descriptor (a host struct the entry point passes to
// the kernel by value) and the CUDA stream, bound from Python with ctypes.
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the first non-zero cudaError_t so that the
// wrapper raises.
//
// What bounds them: both read each parked column they use once (4 B a row a
// column) and do a few integer operations a row, so both are bound by bytes,
// and at a cut's size (32,768 to 786,432 rows, 0.1-3 MB a column) by the
// latency of a DRAM round trip and of the launch more than by the rate. So a
// thread keeps several 16-byte loads (4 rows each) in flight before it uses
// any, a row's dependent loads (the next predicate, the time limbs, by(), the
// duration limbs) are issued for all of a thread's passing rows together, and
// the grid is sized from the rows and the card: at least one CTA an SM while
// there are rows for it, at most what the SMs hold at once.
//
// The fold keeps what every row re-reads on chip: the bin edges (the
// reference compares each row with every edge; here a binary search over the
// edges in shared memory, exact because the edges ascend and the pad is u64
// max, so the count of edges <= t is the reference's ge.sum), the by() codes
// (a binary search too) and, when it fits and the CTA has more rows than
// cells, a private histogram in shared memory that is added into the output
// once at the end, a non-zero cell at a time; otherwise the rows add into the
// output with global atomics. Only a few rows in ten pass a cut's predicates,
// so a warp packs its passing rows before the searches (else each warp would
// search as many rounds as its fullest lane has rows). The constants travel
// in the descriptor when they fit (kValEdges edges, kValCodes codes,
// kMaxPreds predicates: the descriptor stays under the 4 KB of classic
// kernel parameters), so such a fold copies nothing to the card; larger ones
// come staged in device memory (one copy from the wrapper's pinned buffer).
// The entry point zeroes the counts itself, with a small kernel that the
// fold overlaps (a programmatic dependent launch: its prologue, loads and
// searches run while the zeroing does; a cudaMemsetAsync took ~3.4 us of
// device time before the fold could start).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libtempo_tail_kernels.so tail_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace tail {

constexpr int kMaxPreds = 16;   // predicates by value; more come staged
constexpr int kValEdges = 128;  // edges (u64) by value; more come staged
constexpr int kValCodes = 128;  // by() codes by value; more come staged
constexpr int kMaxEq = 5;       // name, service.name, service, http.method, http.url
constexpr int kFoldThreads = 256;
constexpr int kFoldQuads = 4;      // 16-byte loads (4 rows each) a fold thread has in flight
constexpr int kFoldMinQuads = 32;  // the fewest quads a CTA takes when the rows are few
constexpr int kWarpRows = 32 * 4 * kFoldQuads;  // a warp's passing rows a round, at most
constexpr int kZeroThreads = 256;
constexpr int kScanThreads = 256;
constexpr int kScanRows = 8;          // rows a scan thread takes: 2 loads a column, 1 store
constexpr int kScanRowsFew = 4;       // the same while 8-row runs leave SMs without a CTA
constexpr int kSmemCap = 200 * 1024;  // dynamic shared memory a fold CTA may take

struct Pred {
  const uint32_t* col;
  uint32_t lit;
  uint32_t op;  // 0 =, 1 !=, 2 >, 3 >=, 4 <, 5 <=
};

struct FoldDesc {
  const uint32_t* t_lo;  // start time limbs
  const uint32_t* t_hi;
  const uint32_t* by;    // by() column, or null
  // null: the constants below, by value; else on the card: edges u64[e_pad],
  // codes u32[u_pad] (padded to 8 bytes), Pred[n_preds]
  const unsigned char* consts;
  int32_t* counts;       // u_pad * (e_pad - 1), zeroed by the entry point's kernel
  int32_t n_preds, n, e_pad, u_pad, nb_real;
  int32_t quads_per_cta, shared_hist;  // set by the entry point
  Pred preds[kMaxPreds];
  uint64_t edges[kValEdges];
  uint32_t uvals[kValCodes];
};

struct ScanDesc {
  const uint32_t* eq_cols[kMaxEq];
  const uint32_t* status;    // http_status column, or null: no status tag
  const uint32_t* dur_lo;    // duration limbs, null without a bound
  const uint32_t* dur_hi;
  uint8_t* out;              // p bytes
  uint64_t min_d, max_d;     // 0: no bound
  uint32_t codes[kMaxEq];
  uint32_t status_val;
  int32_t n_eq, n, p;
};

__device__ __forceinline__ bool compare(uint32_t c, uint32_t lit, uint32_t op) {
  switch (op) {
    case 0: return c == lit;
    case 1: return c != lit;
    case 2: return c > lit;
    case 3: return c >= lit;
    case 4: return c < lit;
    default: return c <= lit;
  }
}

// the number of entries of the ascending a[0, len) that are <= x, by binary
// lifting: the same steps for every x, so a warp's lanes never part
template <typename T>
__device__ __forceinline__ int count_le(const T* a, int len, T x) {
  int pos = 0;
  for (int step = 1 << (31 - __clz(len)); step > 0; step >>= 1) {
    if (pos + step <= len && a[pos + step - 1] <= x) pos += step;
  }
  return pos;
}

// rows 4q .. 4q+3 of a column (16-byte aligned, checked by the wrapper)
__device__ __forceinline__ uint4 load_quad(const uint32_t* col, int64_t q) {
  return __ldg(reinterpret_cast<const uint4*>(col) + q);
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// the bits of the rows of a quad starting at row that lie below n
__device__ __forceinline__ uint32_t rows_below(int64_t row, int n) {
  const int64_t left = n - row;
  return left >= 4 ? 0xFu : left > 0 ? (1u << left) - 1u : 0u;
}

// Programmatic dependent launch (Hopper): the fold launches while the zeroing
// of its counts runs, and waits for it only where it first adds into them.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__global__ void __launch_bounds__(kZeroThreads) tail_zero_kernel(int32_t* counts, int64_t n) {
  grid_launch_dependents();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    counts[i] = 0;
  }
}

// One passing row into its cell: the number of edges <= its start less one
// is its bin, kept in [0, nb_real); the number of by() codes <= its code less
// one its series (a negative cell is clipped to 0, as jnp.bincount clips).
__device__ __forceinline__ void fold_row(const FoldDesc& d, const uint64_t* edges,
                                         const uint32_t* uvals, int32_t* cells, uint32_t t_lo,
                                         uint32_t t_hi, uint32_t code) {
  const int bin = count_le(edges, d.e_pad, (uint64_t(t_hi) << 32) | t_lo) - 1;
  if (bin < 0 || bin >= d.nb_real) return;
  int cell = bin;
  if (d.by != nullptr) {
    cell += (count_le(uvals, d.u_pad, code) - 1) * (d.e_pad - 1);
    if (cell < 0) cell = 0;
  }
  atomicAdd(cells + cell, 1);
}

// Rows [0, n) in quads of 4; CTA b takes quads [b, b + 1) * quads_per_cta, a
// thread kFoldQuads of them a round (thread t: quads t, t + blockDim, ...),
// their loads in flight together. A row passes when every predicate holds on
// a defined (non-zero) value (str and num predicates alike: the u32 compare
// and c != 0); keep holds a bit a row of the thread's round (row r of its
// k-th quad is bit 4k + r). Then the time limbs and by() of the passing rows'
// quads are loaded together, and a warp packs its passing rows into its
// buffer in shared memory, so that its lanes take one row each for the
// binary searches and the add (fold_row) and the warp's rounds of searches
// are its passing rows over 32, not the most any lane holds.
__global__ void __launch_bounds__(kFoldThreads) tail_fold_kernel(const FoldDesc d) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* edges = reinterpret_cast<uint64_t*>(smem);
  Pred* preds = reinterpret_cast<Pred*>(edges + d.e_pad);
  uint32_t* uvals = reinterpret_cast<uint32_t*>(preds + d.n_preds);
  int32_t* hist = reinterpret_cast<int32_t*>(uvals + d.u_pad);
  const int n_cells = d.u_pad * (d.e_pad - 1);
  // the warp's buffer: t_lo, t_hi and by() of up to kWarpRows passing rows
  const int lane = threadIdx.x & 31;
  uint32_t* buf = reinterpret_cast<uint32_t*>(hist + (d.shared_hist ? n_cells : 0)) +
                  3 * kWarpRows * (threadIdx.x >> 5);
  const int64_t quads = ((int64_t)d.n + 3) >> 2;
  const int64_t q_begin = (int64_t)blockIdx.x * d.quads_per_cta;
  const int64_t q_end = min(quads, q_begin + d.quads_per_cta);
  if (q_begin >= q_end) return;
  const Pred* staged =
      d.consts == nullptr ? nullptr
                          : reinterpret_cast<const Pred*>(d.consts + 8 * d.e_pad +
                                                          ((4 * d.u_pad + 7) & ~7));
  // the first column a round reads: the first predicate's, else the time
  // limbs and by()
  const Pred first = d.n_preds == 0 ? Pred{nullptr, 0, 0}
                     : d.consts == nullptr ? d.preds[0]
                                           : staged[0];
  int32_t* cells = d.shared_hist ? hist : d.counts;
  // rounds are the same for every thread of the CTA, so a warp's lanes
  // pack their rows together
  for (int64_t start = q_begin; start < q_end; start += (int64_t)kFoldThreads * kFoldQuads) {
    const int64_t base = start + threadIdx.x;
    uint32_t keep = 0;
#pragma unroll
    for (int k = 0; k < kFoldQuads; ++k) {
      const int64_t q = base + (int64_t)k * kFoldThreads;
      if (q < q_end) keep |= rows_below(4 * q, d.n) << (4 * k);
    }
    uint4 v[kFoldQuads], lo[kFoldQuads], hi[kFoldQuads], by[kFoldQuads];
#pragma unroll
    for (int k = 0; k < kFoldQuads; ++k) {
      const int64_t q = base + (int64_t)k * kFoldThreads;
      v[k] = lo[k] = hi[k] = by[k] = make_uint4(0, 0, 0, 0);
      if ((keep >> (4 * k)) & 0xFu) {
        if (first.col != nullptr) {
          v[k] = load_quad(first.col, q);
        } else {
          lo[k] = load_quad(d.t_lo, q);
          hi[k] = load_quad(d.t_hi, q);
          if (d.by != nullptr) by[k] = load_quad(d.by, q);
        }
      }
    }
    if (start == q_begin) {
      // the constants into shared memory while the first loads fly
      if (d.consts == nullptr) {
        for (int i = threadIdx.x; i < d.e_pad; i += blockDim.x) edges[i] = d.edges[i];
        for (int i = threadIdx.x; i < d.u_pad; i += blockDim.x) uvals[i] = d.uvals[i];
        for (int i = threadIdx.x; i < d.n_preds; i += blockDim.x) preds[i] = d.preds[i];
      } else {
        const uint64_t* e = reinterpret_cast<const uint64_t*>(d.consts);
        const uint32_t* u = reinterpret_cast<const uint32_t*>(d.consts + 8 * d.e_pad);
        for (int i = threadIdx.x; i < d.e_pad; i += blockDim.x) edges[i] = e[i];
        for (int i = threadIdx.x; i < d.u_pad; i += blockDim.x) uvals[i] = u[i];
        for (int i = threadIdx.x; i < d.n_preds; i += blockDim.x) preds[i] = staged[i];
      }
      if (d.shared_hist) {
        for (int i = threadIdx.x; i < n_cells; i += blockDim.x) hist[i] = 0;
      }
      __syncthreads();
    }
    if (first.col != nullptr) {
#pragma unroll
      for (int k = 0; k < kFoldQuads; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t c = lane_of(v[k], r);
          if (c == 0 || !compare(c, first.lit, first.op)) keep &= ~(1u << (4 * k + r));
        }
      }
      for (int j = 1; j < d.n_preds && keep != 0; ++j) {
        const Pred pr = preds[j];
#pragma unroll
        for (int k = 0; k < kFoldQuads; ++k) {
          v[k] = make_uint4(0, 0, 0, 0);
          if ((keep >> (4 * k)) & 0xFu) v[k] = load_quad(pr.col, base + (int64_t)k * kFoldThreads);
        }
#pragma unroll
        for (int k = 0; k < kFoldQuads; ++k) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t c = lane_of(v[k], r);
            if (c == 0 || !compare(c, pr.lit, pr.op)) keep &= ~(1u << (4 * k + r));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kFoldQuads; ++k) {
        const int64_t q = base + (int64_t)k * kFoldThreads;
        if ((keep >> (4 * k)) & 0xFu) {
          lo[k] = load_quad(d.t_lo, q);
          hi[k] = load_quad(d.t_hi, q);
          if (d.by != nullptr) by[k] = load_quad(d.by, q);
        }
      }
    }
    // the counts are the zeroing kernel's until it has finished
    if (!d.shared_hist) grid_dependency_wait();
    int fill = 0;
#pragma unroll
    for (int b = 0; b < 4 * kFoldQuads; ++b) {
      const bool mine = (keep >> b) & 1u;
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, mine);
      if (mine) {
        const int at = fill + __popc(m & ((1u << lane) - 1u));
        buf[at] = lane_of(lo[b >> 2], b & 3);
        buf[kWarpRows + at] = lane_of(hi[b >> 2], b & 3);
        buf[2 * kWarpRows + at] = lane_of(by[b >> 2], b & 3);
      }
      fill += __popc(m);
    }
    __syncwarp();
    for (int i = lane; i < fill; i += 32) {
      fold_row(d, edges, uvals, cells, buf[i], buf[kWarpRows + i], buf[2 * kWarpRows + i]);
    }
    __syncwarp();
  }
  if (d.shared_hist) {
    __syncthreads();
    grid_dependency_wait();
    for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
      const int32_t v = hist[i];
      if (v != 0) atomicAdd(d.counts + i, v);
    }
  }
}

// the mask bits m of rows that equal code, kQ quads from q
template <int kQ>
__device__ __forceinline__ uint32_t match_eq(const uint32_t* col, int64_t q, uint32_t m,
                                             uint32_t code) {
  uint4 v[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    v[k] = make_uint4(0, 0, 0, 0);
    if ((m >> (4 * k)) & 0xFu) v[k] = load_quad(col, q + k);
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (lane_of(v[k], r) != code) m &= ~(1u << (4 * k + r));
    }
  }
  return m;
}

// four mask bits -> four bytes of 0 or 1
__device__ __forceinline__ uint32_t mask_bytes(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// A thread takes runs of kRows (4, 8 or 16) rows of p (a multiple of kRows):
// row < n, the equalities, the status and the duration bounds (unsigned
// 64-bit, from two limbs), each column loaded a quad at a time only where a
// row of the quad still passes; the run's mask bytes go out in one store.
// Grid-stride over the runs.
template <int kRows>
__global__ void __launch_bounds__(kScanThreads) tail_scan_kernel(const ScanDesc d) {
  constexpr int kQ = kRows / 4;
  const int64_t runs = d.p / kRows;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t run = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; run < runs; run += stride) {
    const int64_t row0 = run * kRows;
    const int64_t q = row0 >> 2;
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < kQ; ++k) m |= rows_below(row0 + 4 * k, d.n) << (4 * k);
#pragma unroll
    for (int j = 0; j < kMaxEq; ++j) {
      if (j < d.n_eq && m != 0) m = match_eq<kQ>(d.eq_cols[j], q, m, d.codes[j]);
    }
    if (d.status != nullptr && m != 0) m = match_eq<kQ>(d.status, q, m, d.status_val);
    if (d.dur_lo != nullptr && m != 0) {
      uint4 lo[kQ], hi[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        lo[k] = hi[k] = make_uint4(0, 0, 0, 0);
        if ((m >> (4 * k)) & 0xFu) {
          lo[k] = load_quad(d.dur_lo, q + k);
          hi[k] = load_quad(d.dur_hi, q + k);
        }
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t dur = (uint64_t(lane_of(hi[k], r)) << 32) | lane_of(lo[k], r);
          if ((d.min_d != 0 && dur < d.min_d) || (d.max_d != 0 && dur > d.max_d)) {
            m &= ~(1u << (4 * k + r));
          }
        }
      }
    }
    if (kQ == 4) {
      *reinterpret_cast<uint4*>(d.out + row0) = make_uint4(
          mask_bytes(m), mask_bytes(m >> 4), mask_bytes(m >> 8), mask_bytes(m >> 12));
    } else if (kQ == 2) {
      *reinterpret_cast<uint2*>(d.out + row0) = make_uint2(mask_bytes(m), mask_bytes(m >> 4));
    } else {
      *reinterpret_cast<uint32_t*>(d.out + row0) = mask_bytes(m);
    }
  }
}

// What a launch needs of its device, looked up once a thread and a device:
// the SM count, the scan's CTAs an SM, and the fold's dynamic shared-memory
// ceiling, set to kSmemCap (the most any descriptor can ask for) so that no
// fold's size lowers it under another thread's launch.
struct Device {
  int id = -1, sms = 1, scan_ctas = 1, scan_ctas_few = 1;
};

cudaError_t device_setup(Device* out) {
  thread_local int cached_dev = -1;
  thread_local Device cached;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev) {
    Device got;
    err = cudaDeviceGetAttribute(&got.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(tail_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemCap);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got.scan_ctas, tail_scan_kernel<kScanRows>, kScanThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got.scan_ctas_few, tail_scan_kernel<kScanRowsFew>, kScanThreads, 0);
    }
    if (err != cudaSuccess) return err;
    got.id = dev;
    got.sms = got.sms > 0 ? got.sms : 1;
    got.scan_ctas = got.scan_ctas > 0 ? got.scan_ctas : 1;
    got.scan_ctas_few = got.scan_ctas_few > 0 ? got.scan_ctas_few : 1;
    cached_dev = dev;
    cached = got;
  }
  *out = cached;
  return cudaSuccess;
}

}  // namespace tail

extern "C" {

// desc: the host descriptor, copied into the launch; n > 0.
int tt_tail_fold(const tail::FoldDesc* desc, void* stream) {
  using namespace tail;
  FoldDesc d = *desc;
  if (d.n <= 0 || d.e_pad < 2 || d.u_pad < 1 || d.n_preds < 0) return cudaErrorInvalidValue;
  if (d.consts == nullptr &&
      (d.n_preds > kMaxPreds || d.e_pad > kValEdges || d.u_pad > kValCodes)) {
    return cudaErrorInvalidValue;
  }
  const int64_t n_cells = (int64_t)d.u_pad * (d.e_pad - 1);
  const int64_t base = 8LL * d.e_pad + (int64_t)sizeof(Pred) * d.n_preds + 4LL * d.u_pad;
  Device dev;
  cudaError_t err = device_setup(&dev);
  if (err != cudaSuccess) return err;
  // the grid: a round of kFoldQuads quads a thread, at least one CTA an SM
  // while each gets kFoldMinQuads, whole waves of SMs, at most what the SMs
  // hold at once (counted with the private histogram, the larger case)
  const int64_t quads = ((int64_t)d.n + 3) / 4;
  const int64_t per_round = (int64_t)kFoldThreads * kFoldQuads;
  int64_t grid = (quads + per_round - 1) / per_round;
  if (grid < dev.sms) {
    const int64_t spread = (quads + kFoldMinQuads - 1) / kFoldMinQuads;
    grid = spread < dev.sms ? spread : dev.sms;
  } else {
    grid = (grid + dev.sms - 1) / dev.sms * dev.sms;
  }
  // the warps' buffers of passing rows, and a private histogram where it fits
  const int64_t bufs = 12LL * kWarpRows * (kFoldThreads / 32);
  const int64_t hist_bytes = base + bufs + 4 * n_cells <= kSmemCap ? 4 * n_cells : 0;
  if (base + bufs > kSmemCap) return cudaErrorInvalidValue;
  // the CTAs an SM holds at this shared-memory size, looked up again only
  // when the size or the device changes
  thread_local int occ_dev = -1, occ = 1;
  thread_local int64_t occ_smem = -1;
  if (occ_dev != dev.id || occ_smem != base + bufs + hist_bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, tail_fold_kernel, kFoldThreads,
                                                        (size_t)(base + bufs + hist_bytes));
    if (err != cudaSuccess) return err;
    occ_dev = dev.id;
    occ_smem = base + bufs + hist_bytes;
  }
  const int64_t most = (int64_t)(occ > 0 ? occ : 1) * dev.sms;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;
  d.quads_per_cta = (int32_t)((quads + grid - 1) / grid);
  // a private histogram pays its zeroing and its merge once a CTA: only
  // when it fits and the CTA has more rows than cells
  d.shared_hist = hist_bytes > 0 && n_cells <= 4LL * d.quads_per_cta;
  const int64_t smem = base + bufs + (d.shared_hist ? hist_bytes : 0);
  // the counts zeroed by a kernel the fold overlaps (its first adds wait
  // for it): a few hundred cells take one CTA
  const int64_t zero_grid = (n_cells + 4LL * kZeroThreads - 1) / (4LL * kZeroThreads);
  tail_zero_kernel<<<(unsigned)(zero_grid < 4LL * dev.sms ? zero_grid : 4LL * dev.sms),
                     kZeroThreads, 0, (cudaStream_t)stream>>>(d.counts, n_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(kFoldThreads);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, tail_fold_kernel, d);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int tt_tail_scan(const tail::ScanDesc* desc, void* stream) {
  using namespace tail;
  const ScanDesc d = *desc;
  if (d.p <= 0) return cudaSuccess;
  if (d.n_eq < 0 || d.n_eq > kMaxEq || d.n < 0 || d.n > d.p || d.p % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  if ((d.min_d != 0 || d.max_d != 0) && (d.dur_lo == nullptr || d.dur_hi == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Device dev;
  cudaError_t err = device_setup(&dev);
  if (err != cudaSuccess) return err;
  // 8-row runs once every SM gets a whole CTA of them, else 4-row runs
  // (more threads, each with a shorter chain of compares); the grid: a run
  // a thread, at least one CTA an SM while each gets a warp's runs, at most
  // what the SMs hold at once
  const bool wide = d.p / kScanRows >= (int64_t)dev.sms * kScanThreads;
  const int rows = wide ? kScanRows : kScanRowsFew;
  const int64_t runs = d.p / rows;
  int64_t grid = (runs + kScanThreads - 1) / kScanThreads;
  if (grid < dev.sms) {
    const int64_t spread = (runs + 31) / 32;
    grid = spread < dev.sms ? spread : dev.sms;
  }
  const int64_t most = (int64_t)(wide ? dev.scan_ctas : dev.scan_ctas_few) * dev.sms;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;
  if (wide) {
    tail_scan_kernel<kScanRows><<<(unsigned)grid, kScanThreads, 0, (cudaStream_t)stream>>>(d);
  } else {
    tail_scan_kernel<kScanRowsFew><<<(unsigned)grid, kScanThreads, 0, (cudaStream_t)stream>>>(d);
  }
  return cudaGetLastError();
}

}  // extern "C"

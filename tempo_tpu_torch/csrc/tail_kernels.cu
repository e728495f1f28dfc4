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
// column) and do a few integer operations a row, so both are bound by bytes.
// The fold's design keeps what every row re-reads on chip: the bin edges (the
// reference compares each row with every edge; here a binary search over the
// edges in shared memory, exact because the edges ascend and the pad is u64
// max, so the count of edges <= t is the reference's ge.sum), the by() codes
// (a binary search too) and, when it fits and the CTA has more rows than
// cells, a private histogram in shared memory that is added into the output
// once at the end; otherwise the rows add into the output with global
// atomics. The literals travel in the descriptor; only the edges and the
// by() codes are copied to the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libtempo_tail_kernels.so tail_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace tail {

constexpr int kMaxPreds = 16;  // predicates by value; more go through Pred* more
constexpr int kMaxEq = 5;      // name, service.name, service, http.method, http.url
constexpr int kFoldThreads = 512;
constexpr int kFoldRowsPerThread = 4;  // rows a thread takes before the grid is capped
constexpr int kScanThreads = 256;
constexpr int kSmemCap = 200 * 1024;  // dynamic shared memory a fold CTA may take

struct Pred {
  const uint32_t* col;
  uint32_t lit;
  uint32_t op;  // 0 =, 1 !=, 2 >, 3 >=, 4 <, 5 <=
};

struct FoldDesc {
  Pred preds[kMaxPreds];
  const Pred* more;          // every predicate, on the card, when n_preds > kMaxPreds
  const uint32_t* t_lo;      // start time limbs
  const uint32_t* t_hi;
  const uint32_t* by;        // by() column, or null
  const uint32_t* consts;    // edges_lo[e_pad], edges_hi[e_pad], uvals[u_pad]
  int32_t* counts;           // u_pad * (e_pad - 1), zeroed by the caller
  int32_t n_preds, n, e_pad, u_pad, nb_real;
  int32_t shared_hist;       // set by the entry point
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

// the number of entries of the ascending a[0, len) that are <= x
template <typename T>
__device__ __forceinline__ int count_le(const T* a, int len, T x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Grid-stride over rows [0, n): a row passes when every predicate holds on a
// defined (non-zero) value (str and num predicates alike: the u32 compare and
// c != 0), its bin (edges <= t, less one) lies in [0, nb_real), and then adds
// one to cell idx * (e_pad - 1) + bin (idx: by() codes <= its code, less one;
// a negative cell is clipped to 0, as jnp.bincount clips).
__global__ void __launch_bounds__(kFoldThreads) tail_fold_kernel(const FoldDesc d) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* edges = reinterpret_cast<uint64_t*>(smem);
  Pred* preds = reinterpret_cast<Pred*>(edges + d.e_pad);
  uint32_t* uvals = reinterpret_cast<uint32_t*>(preds + d.n_preds);
  int32_t* hist = reinterpret_cast<int32_t*>(uvals + d.u_pad);
  const int b_pad = d.e_pad - 1;
  const int n_cells = d.u_pad * b_pad;
  for (int i = threadIdx.x; i < d.e_pad; i += blockDim.x) {
    edges[i] = (uint64_t(d.consts[d.e_pad + i]) << 32) | d.consts[i];
  }
  for (int i = threadIdx.x; i < d.n_preds; i += blockDim.x) {
    preds[i] = d.n_preds > kMaxPreds ? d.more[i] : d.preds[i];
  }
  for (int i = threadIdx.x; i < d.u_pad; i += blockDim.x) {
    uvals[i] = d.consts[2 * d.e_pad + i];
  }
  if (d.shared_hist) {
    for (int i = threadIdx.x; i < n_cells; i += blockDim.x) hist[i] = 0;
  }
  __syncthreads();
  int32_t* cells = d.shared_hist ? hist : d.counts;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < d.n; row += stride) {
    bool keep = true;
    for (int j = 0; j < d.n_preds && keep; ++j) {
      const uint32_t c = preds[j].col[row];
      keep = c != 0 && compare(c, preds[j].lit, preds[j].op);
    }
    if (!keep) continue;
    const uint64_t t = (uint64_t(d.t_hi[row]) << 32) | d.t_lo[row];
    const int bin = count_le(edges, d.e_pad, t) - 1;
    if (bin < 0 || bin >= d.nb_real) continue;
    int cell = bin;
    if (d.by != nullptr) {
      cell += (count_le(uvals, d.u_pad, d.by[row]) - 1) * b_pad;
      if (cell < 0) cell = 0;
    }
    atomicAdd(cells + cell, 1);
  }
  if (d.shared_hist) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
      const int32_t v = hist[i];
      if (v != 0) atomicAdd(d.counts + i, v);
    }
  }
}

// One thread a row of p: row < n, the equalities, the status and the
// duration bounds (unsigned 64-bit, from two limbs).
__global__ void __launch_bounds__(kScanThreads) tail_scan_kernel(const ScanDesc d) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= d.p) return;
  bool m = row < d.n;
#pragma unroll
  for (int j = 0; j < kMaxEq; ++j) {
    if (j < d.n_eq) m = m && d.eq_cols[j][row] == d.codes[j];
  }
  if (d.status != nullptr) m = m && d.status[row] == d.status_val;
  if (d.dur_lo != nullptr && m) {
    const uint64_t dur = (uint64_t(d.dur_hi[row]) << 32) | d.dur_lo[row];
    if (d.min_d != 0) m = dur >= d.min_d;
    if (d.max_d != 0) m = m && dur <= d.max_d;
  }
  d.out[row] = m ? 1 : 0;
}

// What a fold launch needs of its device, looked up once a thread and a
// device: the SM count, and the kernel's dynamic shared-memory ceiling, set
// to kSmemCap (the most any descriptor can ask for) so that no fold's size
// lowers it under another thread's launch.
cudaError_t fold_setup(int* sms) {
  thread_local int cached_dev = -1, cached_sms = 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev) {
    int got = 0;
    err = cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(tail_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemCap);
    }
    if (err != cudaSuccess) return err;
    cached_dev = dev;
    cached_sms = got > 0 ? got : 1;
  }
  *sms = cached_sms;
  return cudaSuccess;
}

}  // namespace tail

extern "C" {

// desc: the host descriptor, copied into the launch; n > 0.
int tt_tail_fold(const tail::FoldDesc* desc, void* stream) {
  using namespace tail;
  FoldDesc d = *desc;
  if (d.n <= 0 || d.e_pad < 2 || d.u_pad < 1 || d.n_preds < 0) return cudaErrorInvalidValue;
  if (d.n_preds > kMaxPreds && d.more == nullptr) return cudaErrorInvalidValue;
  const int64_t n_cells = (int64_t)d.u_pad * (d.e_pad - 1);
  const int64_t base = 8LL * d.e_pad + (int64_t)sizeof(Pred) * d.n_preds + 4LL * d.u_pad;
  int sms = 1;
  cudaError_t err = fold_setup(&sms);
  if (err != cudaSuccess) return err;
  int64_t grid = (d.n + kFoldThreads * kFoldRowsPerThread - 1) /
                 (kFoldThreads * kFoldRowsPerThread);
  const int64_t most = 2LL * sms;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;
  const int64_t rows_per_cta = (d.n + grid - 1) / grid;
  // a private histogram pays its zeroing and its merge once a CTA: only
  // when it fits and the CTA has more rows than cells
  d.shared_hist = base + 4 * n_cells <= kSmemCap && n_cells <= rows_per_cta;
  const int64_t smem = base + (d.shared_hist ? 4 * n_cells : 0);
  if (smem > kSmemCap) return cudaErrorInvalidValue;
  tail_fold_kernel<<<(unsigned)grid, kFoldThreads, (size_t)smem, (cudaStream_t)stream>>>(d);
  return cudaGetLastError();
}

int tt_tail_scan(const tail::ScanDesc* desc, void* stream) {
  using namespace tail;
  const ScanDesc d = *desc;
  if (d.p <= 0) return cudaSuccess;
  if (d.n_eq < 0 || d.n_eq > kMaxEq || d.n < 0 || d.n > d.p) return cudaErrorInvalidValue;
  if ((d.min_d != 0 || d.max_d != 0) && (d.dur_lo == nullptr || d.dur_hi == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int64_t grid = (d.p + kScanThreads - 1) / kScanThreads;
  tail_scan_kernel<<<(unsigned)grid, kScanThreads, 0, (cudaStream_t)stream>>>(d);
  return cudaGetLastError();
}

}  // extern "C"

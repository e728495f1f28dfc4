// Hand-written Hopper (sm_90a) kernels of tempo_tpu_torch.
//
// Each kernel replaces one Pallas TPU kernel of tempo_tpu/ops/pallas_kernels.py
// and computes the same function as its plain PyTorch version in
// tempo_tpu_torch/ops/pallas_kernels.py. The interface is plain C: pointers,
// sizes and the CUDA stream as arguments, bound from Python with ctypes. Every
// entry point launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so that a refused launch reaches the
// wrapper, which raises.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtempo_kernels.so kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// seg_bincount
//
// Replaces _bincount_kernel / _bincount_call (tempo_tpu/ops/pallas_kernels.py:
// 194-245), the TraceQL metrics reduction: counts[slot] += weight for every
// row whose slot lies in [0, n_slots).
//
// What bounds it: memory. Each row is read once (4 bytes of slot, 4 of
// weight) and does one integer add; the output is 8 bytes per slot. The TPU
// kernel built a one-hot tile and folded it on the MXU in f32, exact only
// below 2**24; Hopper has fast integer atomics instead, so the counts here
// are exact 64-bit integers at any size.
//
// Design: when the slot space fits in shared memory (8 bytes a slot, at most
// kSmemSlots), each block keeps a private 64-bit histogram there, takes a
// grid-stride share of the rows with shared-memory atomics, and merges its
// non-zero counters into the global array with one global atomic each. Wider
// slot spaces (the quantile shape: series x bins x 258 buckets) add straight
// into the global array with 64-bit atomics. Weights are added as 64-bit
// two's complement, so negative weights are exact too.
// ---------------------------------------------------------------------------

constexpr int kSmemSlots = 6144;  // 48 KiB of 64-bit counters: no opt-in needed

__global__ void seg_bincount_smem(const int32_t* __restrict__ slots,
                                  const int32_t* __restrict__ weights,
                                  int64_t n, int32_t n_slots,
                                  unsigned long long* __restrict__ out) {
  __shared__ unsigned long long hist[kSmemSlots];
  for (int j = threadIdx.x; j < n_slots; j += blockDim.x) hist[j] = 0ull;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t s = slots[i];
    if (s >= 0 && s < n_slots) {
      const long long w = weights ? (long long)weights[i] : 1ll;
      atomicAdd(&hist[s], (unsigned long long)w);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_slots; j += blockDim.x) {
    const unsigned long long c = hist[j];
    if (c) atomicAdd(&out[j], c);
  }
}

__global__ void seg_bincount_global(const int32_t* __restrict__ slots,
                                    const int32_t* __restrict__ weights,
                                    int64_t n, int32_t n_slots,
                                    unsigned long long* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t s = slots[i];
    if (s >= 0 && s < n_slots) {
      const long long w = weights ? (long long)weights[i] : 1ll;
      atomicAdd(&out[s], (unsigned long long)w);
    }
  }
}

// ---------------------------------------------------------------------------
// in_set_scan
//
// Replaces _in_set_kernel / _in_set_call (tempo_tpu/ops/pallas_kernels.py:
// 55-105): row r matches iff for every predicate column c, cols[c][r] equals
// one of codes[c][0..S). Rows >= n are written False (the JAX wrapper masks
// them after the kernel, :140-143).
//
// What bounds it: memory. Each row reads C 4-byte codes and writes one byte;
// the C*S compares per row are cheap next to that.
//
// Design: the (C, S) code table goes to shared memory once per block (the TPU
// kept it in SMEM beside the scalar unit); each thread owns one row, so that
// neighbouring threads read neighbouring words of every column. The padding
// code 0xFFFFFFFF is compared like any other code, which keeps the JAX
// kernel's quirk: a column value 0xFFFFFFFF inside [0, n) matches a padded set.
// ---------------------------------------------------------------------------

__global__ void in_set_scan_kernel(const uint32_t* __restrict__ cols,
                                   const uint32_t* __restrict__ codes,
                                   int32_t n_cols, int32_t n_codes,
                                   int64_t n_pad, int64_t n,
                                   uint8_t* __restrict__ out) {
  extern __shared__ uint32_t sh_codes[];
  const int total = n_cols * n_codes;
  for (int j = threadIdx.x; j < total; j += blockDim.x) sh_codes[j] = codes[j];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n_pad; r += stride) {
    bool all = r < n;
    for (int c = 0; c < n_cols && all; ++c) {
      const uint32_t v = cols[(int64_t)c * n_pad + r];
      bool hit = false;
      for (int s = 0; s < n_codes; ++s) hit |= (v == sh_codes[c * n_codes + s]);
      all = hit;
    }
    out[r] = all ? 1 : 0;
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

}  // namespace

extern "C" {

// slots, weights (nullable): (n,) int32; out: (n_slots,) int64, zeroed by the caller.
int tt_seg_bincount(const void* slots, const void* weights, int64_t n,
                    int32_t n_slots, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)slots;
  const int32_t* w = (const int32_t*)weights;
  unsigned long long* o = (unsigned long long*)out;
  if (n_slots <= kSmemSlots) {
    // two blocks a SM on 132 SMs: enough rows per block that the merge of
    // its private histogram stays small next to the rows it counted
    seg_bincount_smem<<<grid_for(n, 264), kThreads, 0, st>>>(s, w, n, n_slots, o);
  } else {
    seg_bincount_global<<<grid_for(n, 132 * 16), kThreads, 0, st>>>(s, w, n, n_slots, o);
  }
  return (int)cudaGetLastError();
}

// cols: (n_cols, n_pad) uint32 row-major; codes: (n_cols, n_codes) uint32; out: (n_pad,) uint8.
int tt_in_set_scan(const void* cols, const void* codes, int32_t n_cols,
                   int32_t n_codes, int64_t n_pad, int64_t n, void* out,
                   void* stream) {
  const size_t smem = (size_t)n_cols * n_codes * sizeof(uint32_t);
  in_set_scan_kernel<<<grid_for(n_pad, 132 * 16), kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)cols, (const uint32_t*)codes, n_cols, n_codes, n_pad, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
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

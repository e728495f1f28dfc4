// rle_cols_hit: the fused run-length decode + in-set scan, for Hopper (sm_90a).
//
// Replaces the jitted program rle_cols_hit / rle_cols_hit_live
// (tempo_tpu/ops/pallas_kernels.py:478-515) and the programs built on it:
// _fused_rle_in_set_jit (:551), _batched_rle_in_set_jit (:517), and the mesh
// scans make_sharded_rle_scan / make_sharded_batched_rle_scan
// (tempo_tpu/parallel/search.py:133,175). Wrappers and the plain PyTorch
// version are in tempo_tpu_torch/ops/pallas_kernels.py.
//
// The function, for unit u (a row group's run payload) and lane q (a query's
// code sets) and row r < n:
//   out[u][q][r] = hit[u][r] AND over columns c of
//                  (not live[u][q][c]) OR (values[u][c][j] in codes[u][q][c])
// where j is the run that covers row r: the LAST run whose exclusive start
// (the prefix sum of lengths[u][c]) is <= r. That is jnp.repeat's rule with
// total_repeat_length = n: rows past the runs' total take the last run, even
// a zero-length padding run, and runs that overrun n are cut. The code
// 0xFFFFFFFF pads a code set and never matches, even a value 0xFFFFFFFF.
// Without `lengths` every run covers one row (an expanded column: the mesh
// tag scan), so j = min(r, run_pad - 1). Without `live` every column is live;
// without `hit` every row starts True.
//
// Two launches: rle_starts_kernel writes each (unit, column)'s exclusive run
// starts into the caller's int64 scratch (one block a column, a chunked block
// scan), then rle_hit_kernel runs a (row tile, unit x lane) grid: the lane's
// (C, K) codes and its live flags are staged in shared memory, and each
// thread finds its rows' runs by binary search over the starts.
// tt_rle_cols_hit makes both launches; tt_rle_run_starts and tt_rle_hit make
// one each, so that each can be timed alone. Plain C interface, launches on
// the caller's stream, no synchronisation, returns the first non-zero
// cudaError_t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libtempo_rle_kernels.so rle_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;  // lengths a thread sums per chunk
constexpr int kHitThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kHitThreads * kRowsPerThread;
constexpr uint32_t kNoMatch = 0xFFFFFFFFu;
constexpr int kMaxSmem = 48 * 1024;

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Exclusive prefix sums of lengths[uc][0..run_pad) -> starts[uc][...], one
// block a (unit, column), kScanThreads * kScanItems lengths a chunk.
__global__ void __launch_bounds__(kScanThreads)
rle_starts_kernel(const int32_t* __restrict__ lengths, int32_t run_pad,
                  int64_t* __restrict__ starts) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry_sh;
  const int64_t base = (int64_t)blockIdx.x * run_pad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_sh = 0;
  __syncthreads();
  for (int64_t c0 = 0; c0 < run_pad; c0 += kScanThreads * kScanItems) {
    int64_t v[kScanItems];
    int64_t local = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t j = c0 + (int64_t)threadIdx.x * kScanItems + k;
      v[k] = j < run_pad ? (int64_t)lengths[base + j] : 0;
      local += v[k];
    }
    // inclusive scan of the threads' sums: warp shuffles, then the warps'
    int64_t incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int64_t w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int64_t t = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += t;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    const int64_t carry = carry_sh;
    int64_t run = carry + incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t j = c0 + (int64_t)threadIdx.x * kScanItems + k;
      if (j < run_pad) starts[base + j] = run;
      run += v[k];
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry_sh = carry + warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

// The run of `starts` (run_pad entries, starts[0] = 0) that covers row r:
// the last j with starts[j] <= r.
__device__ __forceinline__ int32_t covering_run(const int64_t* __restrict__ starts,
                                                int32_t run_pad, int64_t r) {
  int32_t lo = 0, hi = run_pad;  // invariant: starts[lo] <= r, starts[hi..] > r
  while (hi - lo > 1) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(starts + mid) <= r) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kHitThreads)
rle_hit_kernel(const uint32_t* __restrict__ values, const int64_t* __restrict__ starts,
               int32_t n_cols, int32_t run_pad, const uint32_t* __restrict__ codes,
               int32_t n_codes, int32_t n_lanes, const uint8_t* __restrict__ live,
               const uint8_t* __restrict__ hit, int64_t n, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t sh[];
  uint32_t* sh_codes = sh;
  uint8_t* sh_live = reinterpret_cast<uint8_t*>(sh + n_cols * n_codes);
  const int64_t uq = blockIdx.y;  // unit * n_lanes + lane
  const int64_t u = uq / n_lanes;
  const int total = n_cols * n_codes;
  for (int j = threadIdx.x; j < total; j += blockDim.x)
    sh_codes[j] = codes[uq * total + j];
  for (int c = threadIdx.x; c < n_cols; c += blockDim.x)
    sh_live[c] = live == nullptr ? 1 : live[uq * n_cols + c];
  __syncthreads();

  const uint32_t* uvals = values + u * (int64_t)n_cols * run_pad;
  const int64_t* ustarts = starts == nullptr ? nullptr : starts + u * (int64_t)n_cols * run_pad;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = (int64_t)blockIdx.x * kTileRows + k * kHitThreads + threadIdx.x;
    if (r >= n) break;
    bool h = hit == nullptr ? true : hit[u * n + r] != 0;
    for (int c = 0; c < n_cols && h; ++c) {
      if (!sh_live[c]) continue;  // a dead column accepts every row
      const int32_t j = ustarts == nullptr
                            ? (int32_t)(r < run_pad ? r : run_pad - 1)
                            : covering_run(ustarts + (int64_t)c * run_pad, run_pad, r);
      const uint32_t v = __ldg(uvals + (int64_t)c * run_pad + j);
      const uint32_t* cs = sh_codes + c * n_codes;
      bool ok = false;
      for (int q = 0; q < n_codes; ++q) {
        const uint32_t code = cs[q];
        ok |= (v == code) & (code != kNoMatch);
      }
      h = ok;
    }
    out[uq * n + r] = h ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// The first launch alone: lengths (U, C, RP) int32 -> starts (U, C, RP)
// int64, each (unit, column)'s exclusive run starts.
int tt_rle_run_starts(const int32_t* lengths, int32_t n_units, int32_t n_cols, int32_t run_pad,
                      int64_t* starts, void* stream) {
  if (n_units <= 0 || n_cols <= 0 || run_pad <= 0) return (int)cudaErrorInvalidValue;
  rle_starts_kernel<<<(unsigned)((int64_t)n_units * n_cols), kScanThreads, 0,
                      (cudaStream_t)stream>>>(lengths, run_pad, starts);
  return (int)cudaGetLastError();
}

// The second launch alone, over starts the first wrote (or null: one row a
// run). Arguments as tt_rle_cols_hit's.
int tt_rle_hit(const uint32_t* values, const int64_t* starts, int32_t n_units, int32_t n_cols,
               int32_t run_pad, const uint32_t* codes, int32_t n_codes, int32_t n_lanes,
               const uint8_t* live, const uint8_t* hit, int64_t n, uint8_t* out, void* stream) {
  if (n_units <= 0 || n_lanes <= 0 || n <= 0) return 0;
  if (n_cols <= 0 || run_pad <= 0 || n_codes <= 0) return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)n_units * n_lanes;
  const int64_t smem = (int64_t)n_cols * n_codes * 4 + n_cols;
  if (lanes > 65535 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)cdiv(n, kTileRows), (unsigned)lanes);
  rle_hit_kernel<<<grid, kHitThreads, (size_t)smem, (cudaStream_t)stream>>>(
      values, starts, n_cols, run_pad, codes, n_codes, n_lanes, live, hit, n, out);
  return (int)cudaGetLastError();
}

// values (U, C, RP) uint32; lengths (U, C, RP) int32 or null (one row a run);
// codes (U, Q, C, K) uint32; live (U, Q, C) bool or null; hit (U, n) bool or
// null; starts: (U, C, RP) int64 scratch (unused without lengths); out
// (U, Q, n) bool. Both launches, the second on the first's starts.
int tt_rle_cols_hit(const uint32_t* values, const int32_t* lengths, int32_t n_units,
                    int32_t n_cols, int32_t run_pad, const uint32_t* codes, int32_t n_codes,
                    int32_t n_lanes, const uint8_t* live, const uint8_t* hit, int64_t n,
                    int64_t* starts, uint8_t* out, void* stream) {
  if (n_units <= 0 || n_lanes <= 0 || n <= 0) return 0;
  if (lengths != nullptr) {
    const int err = tt_rle_run_starts(lengths, n_units, n_cols, run_pad, starts, stream);
    if (err != 0) return err;
  }
  return tt_rle_hit(values, lengths != nullptr ? starts : nullptr, n_units, n_cols, run_pad,
                    codes, n_codes, n_lanes, live, hit, n, out, stream);
}

}  // extern "C"

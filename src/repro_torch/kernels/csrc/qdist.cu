// Product-quantization ADC kernels for Hopper (sm_90a): the distance
// matrix (`pq_adc`) and the fused k-nearest scan (`pq_topk`).
//
// Replace the TPU kernels `pq_adc_pallas` and `pq_topk_pallas` of
// src/repro/kernels/qdist.py. They compute what those kernels compute,
// and what the plain PyTorch versions `pq_adc_ref` / `pq_topk_ref`
// (src/repro_torch/kernels/qdist.py) compute:
//
//   d[q, x] = xpad[x] + lut[q, 0, code[x, 0]] + ... + lut[q, M-1, code[x, M-1]]
//
// over per-query tables luts [Bq, M, 256] float32 and code rows
// codes [Bx, M] uint8, xpad [Bx] float32 (+inf marks a padding row; 0
// when absent). The sum starts at xpad and adds one table entry per
// subspace, in subspace order, each add rounded on its own
// (__fadd_rn): the reference's order, so kernel, plain version and
// reference agree bitwise on any input.
//
// Layout. A CTA of 256 threads holds kQ queries' tables in shared memory
// (kQ * M KB: 64 KB at M=16, kQ=4; dynamic shared memory, opted in above
// 48 KB) and its threads stride over code rows, one row a thread at a
// time. A row is read with 16-byte loads when M % 16 == 0 (one load at
// M=16), 4-byte loads when M % 4 == 0, else byte by byte; each code is
// looked up for all kQ queries, so a row is read once per CTA.
//
// pq_topk keeps, per thread and query, a sorted list of its k best
// (distance, row) in local memory (topk.cuh's ThreadLists); a row enters
// only if it beats the list's last entry. The CTA then merges its
// threads' lists in k rounds of a block-wide minimum. The order is total —
// by distance, then by row id, so among equal distances the lower row
// wins, as `lax.top_k` and `_select_k` give — which makes the result
// independent of how rows are split. So the rows are split into S ranges
// (grid.x), each CTA writes a partial list [Bq, S, k], and a second kernel
// (topk.cuh's merge_splits_kernel) merges the S lists of a query by ranks
// in that order. Blocks run in no order and share nothing. Rows with
// distance +inf (padding) never enter a list; a slot that no finite
// distance fills holds (+inf, -1). Ragged Bx is masked here, not padded.
//
// What bounds it on this card: per (query, row) M shared-memory lookups
// at data-dependent addresses and M float adds, against M bytes of codes
// read per row per CTA (L2-resident at the main path's 512 KB of codes)
// and 1 KB of table per query and subspace. At 256 queries x 32,768 rows
// x M=16 that is 134M lookups (about 16 us at 32 lookups a clock per SM,
// 132 SMs, 1.98 GHz) against about 4.9 MB of compulsory traffic (1.5 us
// at 3.35 TB/s): the lookups bound it. The design keeps every lookup in
// shared memory, reads a row once for kQ queries, and fills the card by
// splitting rows across CTAs. cp.async / TMA staging of the code rows is
// later work.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = topk::kMaxK;
constexpr int kMaxSplits = 32;

// Add the lookups of the 4 codes packed in word c (subspaces m..m+3) to
// every query's sum, subspace by subspace.
template <int kQ>
__device__ __forceinline__ void adc_word(unsigned int c, int m,
                                         const float* lut, int tab,
                                         float (&acc)[kQ]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int off = (m + b) * 256 + static_cast<int>((c >> (8 * b)) & 0xffu);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
      acc[qi] = __fadd_rn(acc[qi], lut[qi * tab + off]);
  }
}

// ADC of one code row for the CTA's kQ queries; acc holds the starting
// value (xpad) on entry.
template <int kQ>
__device__ __forceinline__ void adc_row(const uint8_t* __restrict__ row,
                                        int M, int vec, const float* lut,
                                        float (&acc)[kQ]) {
  const int tab = M * 256;
  if (vec == 16) {
    const uint4* r = reinterpret_cast<const uint4*>(row);
    for (int j = 0; j < M / 16; ++j) {
      const uint4 c = __ldg(r + j);
      adc_word<kQ>(c.x, 16 * j, lut, tab, acc);
      adc_word<kQ>(c.y, 16 * j + 4, lut, tab, acc);
      adc_word<kQ>(c.z, 16 * j + 8, lut, tab, acc);
      adc_word<kQ>(c.w, 16 * j + 12, lut, tab, acc);
    }
  } else if (vec == 4) {
    const unsigned int* r = reinterpret_cast<const unsigned int*>(row);
    for (int j = 0; j < M / 4; ++j) adc_word<kQ>(__ldg(r + j), 4 * j, lut, tab, acc);
  } else {
    for (int m = 0; m < M; ++m) {
      const int off = m * 256 + row[m];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi)
        acc[qi] = __fadd_rn(acc[qi], lut[qi * tab + off]);
    }
  }
}

// Copy queries q0..q0+kQ-1's tables into shared memory (zeros past Bq).
template <int kQ>
__device__ __forceinline__ void load_luts(const float* __restrict__ luts,
                                          float* lut_s, int q0, int Bq,
                                          int M) {
  const int tab = M * 256;
  for (int i = threadIdx.x; i < kQ * tab; i += kThreads) {
    const int qi = i / tab;
    lut_s[i] = q0 + qi < Bq
                   ? luts[static_cast<long long>(q0 + qi) * tab + (i - qi * tab)]
                   : 0.f;
  }
  __syncthreads();
}

template <int kQ>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ luts,      // [Bq, M, 256]
              const uint8_t* __restrict__ codes,   // [Bx, M]
              const float* __restrict__ xpad,      // [Bx] or null
              float* __restrict__ out,             // [Bq, Bx]
              int Bq, int Bx, int M, int vec) {
  extern __shared__ float lut_s[];                 // [kQ, M, 256]
  const int q0 = blockIdx.y * kQ;
  load_luts<kQ>(luts, lut_s, q0, Bq, M);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long x = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       x < Bx; x += stride) {
    float acc[kQ];
    const float base = xpad != nullptr ? xpad[x] : 0.f;
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) acc[qi] = base;
    adc_row<kQ>(codes + x * M, M, vec, lut_s, acc);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
      if (q0 + qi < Bq) out[static_cast<long long>(q0 + qi) * Bx + x] = acc[qi];
  }
}

// Pass 1 of pq_topk: CTA (s, g) scans rows [s*chunk, (s+1)*chunk) for
// query group g and writes its k best of each query to part[q, s, :].
template <int kQ>
__global__ void __launch_bounds__(kThreads)
pq_topk_partial_kernel(const float* __restrict__ luts,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ xpad,
                       float* __restrict__ part_d,   // [Bq, S, K]
                       int* __restrict__ part_i,     // [Bq, S, K]
                       int Bq, int Bx, int M, int vec, int K, int chunk) {
  extern __shared__ float lut_s[];
  __shared__ float red_d[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win_d;
  __shared__ int win_i;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, S = gridDim.x;
  const int q0 = blockIdx.y * kQ;
  load_luts<kQ>(luts, lut_s, q0, Bq, M);

  // this thread's sorted lists, one per query
  topk::ThreadLists<kQ> lists;
  lists.init(K);

  const long long lo = static_cast<long long>(s) * chunk;
  const long long hi = min(static_cast<long long>(Bx), lo + chunk);
  for (long long x = lo + tid; x < hi; x += kThreads) {
    float acc[kQ];
    const float base = xpad != nullptr ? xpad[x] : 0.f;
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) acc[qi] = base;
    adc_row<kQ>(codes + x * M, M, vec, lut_s, acc);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
      lists.offer(qi, acc[qi], static_cast<int>(x), K);   // x increases
  }

  // merge the threads' lists: K rounds of a block-wide (d, id) minimum
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    if (q0 + qi >= Bq) break;                     // uniform across the CTA
    int head = 0;
    const long long obase = (static_cast<long long>(q0 + qi) * S + s) * K;
    for (int r = 0; r < K; ++r) {
      float d = head < K ? lists.d[qi][head] : CUDART_INF_F;
      int id = head < K ? lists.i[qi][head] : -1;
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, d, o);
        const int oi = __shfl_xor_sync(0xffffffffu, id, o);
        if (topk::before(od, oi, d, id)) { d = od; id = oi; }
      }
      if (lane == 0) { red_d[warp] = d; red_i[warp] = id; }
      __syncthreads();
      if (tid == 0) {
        float bd = red_d[0];
        int bi = red_i[0];
        for (int w = 1; w < kWarps; ++w)
          if (topk::before(red_d[w], red_i[w], bd, bi)) { bd = red_d[w]; bi = red_i[w]; }
        win_d = bd;
        win_i = bi;
        part_d[obase + r] = bd;
        part_i[obase + r] = bi;
      }
      __syncthreads();
      // row ids are unique across threads: exactly one owner advances
      if (win_i >= 0 && head < K && lists.i[qi][head] == win_i) ++head;
      __syncthreads();                            // win_* is rewritten next round
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kQ>
int launch_adc(const void* luts, const void* codes, const void* xpad, void* out,
               int Bq, int Bx, int M, int vec, int grid_x, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kQ) * M * 256 * sizeof(float);
  cudaError_t err = allow_smem(pq_adc_kernel<kQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, (Bq + kQ - 1) / kQ);
  pq_adc_kernel<kQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(xpad), static_cast<float*>(out), Bq, Bx, M, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kQ>
int launch_topk(const void* luts, const void* codes, const void* xpad,
                void* part_d, void* part_i, void* out_d, void* out_i, int Bq,
                int Bx, int M, int vec, int K, int S, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kQ) * M * 256 * sizeof(float);
  cudaError_t err = allow_smem(pq_topk_partial_kernel<kQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = static_cast<int>((static_cast<long long>(Bx) + S - 1) / S);
  const dim3 grid(S, (Bq + kQ - 1) / kQ);
  pq_topk_partial_kernel<kQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(xpad), static_cast<float*>(part_d),
      static_cast<int*>(part_i), Bq, Bx, M, vec, K, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(topk::merge_splits<kThreads>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), Bq, S, K, 1.f,
      stream));
}

}  // namespace

// C interface, bound with ctypes. `kq` (queries a CTA holds: 1, 2 or 4),
// `vec` (code load width: 16, 4 or 1 bytes) and the split counts were
// chosen and every shape checked by the Python wrapper. Each launches on
// `stream` and returns cudaGetLastError().
extern "C" int repro_pq_adc(const void* luts, const void* codes, const void* xpad,
                            void* out, int device, int Bq, int Bx, int M, int vec,
                            int kq, int grid_x, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0 || Bx == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kq) {
    case 4: return launch_adc<4>(luts, codes, xpad, out, Bq, Bx, M, vec, grid_x, st);
    case 2: return launch_adc<2>(luts, codes, xpad, out, Bq, Bx, M, vec, grid_x, st);
    case 1: return launch_adc<1>(luts, codes, xpad, out, Bq, Bx, M, vec, grid_x, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_pq_topk(const void* luts, const void* codes, const void* xpad,
                             void* part_d, void* part_i, void* out_d, void* out_i,
                             int device, int Bq, int Bx, int M, int vec, int kq,
                             int K, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0) return 0;
  if (K < 1 || K > kMaxK || S < 1 || S > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kq) {
    case 4: return launch_topk<4>(luts, codes, xpad, part_d, part_i, out_d, out_i,
                                  Bq, Bx, M, vec, K, S, st);
    case 2: return launch_topk<2>(luts, codes, xpad, part_d, part_i, out_d, out_i,
                                  Bq, Bx, M, vec, K, S, st);
    case 1: return launch_topk<1>(luts, codes, xpad, part_d, part_i, out_d, out_i,
                                  Bq, Bx, M, vec, K, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_qdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

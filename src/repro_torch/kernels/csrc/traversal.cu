// Fused multi-hop layer-0 HNSW traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_traversal_pallas` of
// src/repro/kernels/traversal.py (the paper's Fig. 6 search engine). It
// computes what that kernel computes, and what the plain PyTorch version
// `fused_traversal_ref` (src/repro_torch/kernels/traversal.py) computes:
// up to H layer-0 beam-search hops per launch for every query lane.
//
// Layout. One CTA of 128 threads (4 warps) per lane; L = P*B lanes, lane l
// searches partition p = l / B of the stacked tables [P, N_pad, ...] for
// query l % B. The lane's candidate list [C], final list [EF] and the
// popped row's M0 distances / ids live in shared memory for the whole
// launch. The visited bitmap stays in global memory, [L, ceil(N_pad/32)]
// words: at the paper's scale it cannot fit in shared memory (5M points
// give 0.62 MB a query; 1M rows give 125 KB a lane).
//
// State is updated IN PLACE: cand_d/cand_i, fin_d/fin_i, visited, hops
// and calcs are read at launch and written back at exit. The kernel
// allocates nothing.
//
// Per hop:
//   1. live = cand_d[0] < fin_d[EF-1] && hops < max_hops. A lane that is
//      not live breaks out; its state stays frozen, exactly the
//      reference's where(live, new, old).
//   2. Pop the head c, read its neighbor row. Test-and-set is one
//      atomicOr per valid neighbor; the old word gives `was`. Ids within a
//      row are unique (restructure de-duplicates rows), so this equals the
//      reference's read-all-then-add.
//   3. Distances to the active (valid and not visited) neighbors: a group
//      of 8 threads takes one row, 16-byte loads, a shuffle reduction for
//      the dot product; row offsets are 64-bit (N_pad*D_pad passes 2^31
//      at about 16.7M rows of 128 d). l2 is xsq - 2*dot + qsq with
//      __fmul_rn/__fsub_rn/__fadd_rn, so nvcc cannot contract it into an
//      FMA: the only difference from the plain version is the summation
//      order of the dot product (exact on integer-valued data).
//      Rows are float32 or 8-bit codes (uint8 / int8, IndexSpec.dtype):
//      a code row is D_pad bytes, so at D_pad=128 each of the 8 threads
//      reads its 16 codes with one 16-byte load, widens them to float32
//      (int8 sign-extended) and multiply-adds them against the float32
//      query. 8-bit codes at D <= 256 keep every partial sum an integer
//      below 2^24, so the dot product is exact in any order and kernel,
//      plain version and reference agree bitwise.
//   4. Line-11 guard against fin_d[EF-1] from before the merge; calcs
//      counts every active neighbor, including those the guard drops.
//   5. Stable sort of the batch by rank counting,
//      pos_i = #(d_j < d_i) + #(j < i, d_j == d_i), then rank-merge into
//      the popped candidate list and the final list (the old list ranks
//      with <, the batch with <=, so ties keep the old entry first) and
//      truncate to C / EF.
//
// What bounds it on this card: per hop and lane a dependent gather of
// about M0*(4*D_pad+4) + 4*M0_pad bytes (16.6 KB at D_pad=128, M0=32;
// M0*(D_pad+4) + 4*M0_pad bytes, 4.3 KB, for 8-bit rows),
// scattered rows with a data-dependent address chain between hops, and a
// few hundred flops. It is bound by memory latency and gather bandwidth,
// not arithmetic. The design's answer is many lanes in flight: one small
// CTA per lane (about 11 KB of shared memory, 16 CTAs an SM) and 16 rows
// loaded at once per CTA. Pipelining the gathers with cp.async / TMA is
// later work.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;                   // threads per gathered row
constexpr int kRowsInFlight = kThreads / kGroup;
constexpr int kMaxM0 = 128;                 // == kThreads: one neighbor a thread
constexpr int kMaxC = 256;

enum Metric : int { kL2 = 0, kIP = 1, kCosine = 2 };

// Partial dot product of one row with the query over this thread's
// 16-byte slices of the row (the sub-th of each 8 x 16-byte stride).
template <typename T>
struct RowDot;

template <>
struct RowDot<float> {
  static __device__ __forceinline__ float partial(const float* __restrict__ row,
                                                  const float* __restrict__ q,
                                                  int D, int sub) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = sub * 4; k < D; k += kGroup * 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row + k));
      const float4 y = __ldg(reinterpret_cast<const float4*>(q + k));
      acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
    return acc;
  }
};

// Byte j of a little-endian 32-bit word as float32: uint8 zero-extended,
// int8 sign-extended (arithmetic shift of the byte moved to the top).
template <typename T>
__device__ __forceinline__ float code_at(unsigned int w, int j);

template <>
__device__ __forceinline__ float code_at<uint8_t>(unsigned int w, int j) {
  return static_cast<float>((w >> (8 * j)) & 0xffu);
}

template <>
__device__ __forceinline__ float code_at<int8_t>(unsigned int w, int j) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * j)) >> 24);
}

// 8-bit code rows: one 16-byte load carries 16 codes, multiplied against
// 16 float32 query values (four float4 loads).
template <typename T>
struct RowDot8 {
  static __device__ __forceinline__ float partial(const T* __restrict__ row,
                                                  const float* __restrict__ q,
                                                  int D, int sub) {
    float acc = 0.f;
    for (int k = sub * 16; k < D; k += kGroup * 16) {
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(row + k));
      const unsigned int w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(q + k + 4 * i));
        acc += code_at<T>(w[i], 0) * y.x + code_at<T>(w[i], 1) * y.y +
               code_at<T>(w[i], 2) * y.z + code_at<T>(w[i], 3) * y.w;
      }
    }
    return acc;
  }
};

template <>
struct RowDot<uint8_t> : RowDot8<uint8_t> {};

template <>
struct RowDot<int8_t> : RowDot8<int8_t> {};

__device__ __forceinline__ float metric_dist(int metric, float dot, float xsq,
                                             float qsq) {
  if (metric == kL2) {
    const float d = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, dot)), qsq);
    return fmaxf(d, 0.0f);
  }
  if (metric == kIP) return -dot;
  return __fsub_rn(1.0f, dot);
}

// #(a[i] < x) over an ascending array
__device__ __forceinline__ int count_less(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #(a[i] <= x) over an ascending array
__device__ __forceinline__ int count_less_equal(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge ascending (ad, ai)[na] with the batch (bd, bi)[nb] into
// (od, oi)[n_out], keeping the first n_out of the na + nb merged entries.
__device__ __forceinline__ void rank_merge(const float* ad, const int* ai, int na,
                                           const float* bd, const int* bi, int nb,
                                           float* od, int* oi, int n_out) {
  for (int i = threadIdx.x; i < na; i += kThreads) {
    const int pos = i + count_less(bd, nb, ad[i]);
    if (pos < n_out) { od[pos] = ad[i]; oi[pos] = ai[i]; }
  }
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const int pos = j + count_less_equal(ad, na, bd[j]);
    if (pos < n_out) { od[pos] = bd[j]; oi[pos] = bi[j]; }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_traversal_kernel(const T* __restrict__ vectors,       // [P, N, D]
                       const float* __restrict__ sqnorms,   // [P, N]
                       const int* __restrict__ l0_nbrs,     // [P, N, M0]
                       const float* __restrict__ queries,   // [B, D]
                       const float* __restrict__ qsq,       // [B]
                       float* __restrict__ g_cand_d,        // [L, C]
                       int* __restrict__ g_cand_i,          // [L, C]
                       float* __restrict__ g_fin_d,         // [L, EF]
                       int* __restrict__ g_fin_i,           // [L, EF]
                       unsigned int* __restrict__ g_visited,  // [L, W]
                       int* __restrict__ g_hops,            // [L]
                       int* __restrict__ g_calcs,           // [L]
                       int B, int N, int D, int M0, int C, int EF, int W,
                       int H, int max_hops, int metric) {
  __shared__ float cand_d[kMaxC], pop_d[kMaxC], fin_d[kMaxC], old_d[kMaxC];
  __shared__ int cand_i[kMaxC], pop_i[kMaxC], fin_i[kMaxC], old_i[kMaxC];
  __shared__ float new_d[kMaxM0], srt_d[kMaxM0];
  __shared__ int new_i[kMaxM0], srt_i[kMaxM0], nbr[kMaxM0];
  __shared__ bool act[kMaxM0];

  const int tid = threadIdx.x;
  const int group = tid / kGroup, sub = tid % kGroup;
  const long long lane = blockIdx.x;
  const long long part = lane / B;
  const int qrow = static_cast<int>(lane % B);

  const T* vec = vectors + part * N * D;
  const float* sq = sqnorms + part * N;
  const int* nbrs = l0_nbrs + part * N * M0;
  const float* q = queries + static_cast<long long>(qrow) * D;
  const float qs = qsq[qrow];
  unsigned int* visited = g_visited + lane * W;

  for (int i = tid; i < C; i += kThreads) {
    cand_d[i] = g_cand_d[lane * C + i];
    cand_i[i] = g_cand_i[lane * C + i];
  }
  for (int i = tid; i < EF; i += kThreads) {
    fin_d[i] = g_fin_d[lane * EF + i];
    fin_i[i] = g_fin_i[lane * EF + i];
  }
  int hops = g_hops[lane];
  int calcs = g_calcs[lane];
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    // every thread reads the same shared values: the break is uniform
    const float bound = fin_d[EF - 1];
    if (!(cand_d[0] < bound && hops < max_hops)) break;
    const long long c = max(cand_i[0], 0);

    // stage 1: neighbor row, visited test-and-set, pop, stash fin
    if (tid < M0) {
      const int id = nbrs[c * M0 + tid];
      bool was = true;
      if (id >= 0) {
        const unsigned int bit = 1u << (id & 31);
        was = (atomicOr(visited + (id >> 5), bit) & bit) != 0u;
      }
      nbr[tid] = id >= 0 ? id : 0;
      act[tid] = !was;
    }
    for (int i = tid; i < C; i += kThreads) {
      pop_d[i] = i + 1 < C ? cand_d[i + 1] : CUDART_INF_F;
      pop_i[i] = i + 1 < C ? cand_i[i + 1] : -1;
    }
    for (int i = tid; i < EF; i += kThreads) {
      old_d[i] = fin_d[i];
      old_i[i] = fin_i[i];
    }
    __syncthreads();

    // stage 2: distances, kRowsInFlight rows at a time; the shuffles run
    // in every thread (rows past M0 or inactive contribute 0)
    for (int base = 0; base < M0; base += kRowsInFlight) {
      const int m = base + group;
      const bool on = m < M0 && act[m];
      float dot = on ? RowDot<T>::partial(vec + nbr[m] * static_cast<long long>(D),
                                          q, D, sub)
                     : 0.f;
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (sub == 0 && m < M0) {
        float d = on ? metric_dist(metric, dot, sq[nbr[m]], qs) : CUDART_INF_F;
        d = d < bound ? d : CUDART_INF_F;          // line-11 guard
        new_d[m] = d;
        new_i[m] = isfinite(d) ? nbr[m] : -1;
      }
    }
    calcs += __syncthreads_count(tid < M0 && act[tid]);

    // stage 3: stable sort of the batch by rank counting
    if (tid < M0) {
      const float di = new_d[tid];
      int pos = 0;
      for (int j = 0; j < M0; ++j) {
        const float dj = new_d[j];
        pos += (dj < di) || (dj == di && j < tid);
      }
      srt_d[pos] = di;
      srt_i[pos] = new_i[tid];
    }
    __syncthreads();

    // stage 4: rank-merge into the final and the popped candidate lists
    rank_merge(old_d, old_i, EF, srt_d, srt_i, M0, fin_d, fin_i, EF);
    rank_merge(pop_d, pop_i, C, srt_d, srt_i, M0, cand_d, cand_i, C);
    ++hops;
    __syncthreads();
  }

  for (int i = tid; i < C; i += kThreads) {
    g_cand_d[lane * C + i] = cand_d[i];
    g_cand_i[lane * C + i] = cand_i[i];
  }
  for (int i = tid; i < EF; i += kThreads) {
    g_fin_d[lane * EF + i] = fin_d[i];
    g_fin_i[lane * EF + i] = fin_i[i];
  }
  if (tid == 0) {
    g_hops[lane] = hops;
    g_calcs[lane] = calcs;
  }
}

template <typename T>
int launch_traversal(const void* vectors, const void* sqnorms,
                     const void* l0_nbrs, const void* queries, const void* qsq,
                     void* cand_d, void* cand_i, void* fin_d, void* fin_i,
                     void* visited, void* hops, void* calcs, int device, int L,
                     int B, int N, int D, int M0, int C, int EF, int W, int H,
                     int max_hops, int metric, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L == 0) return 0;
  fused_traversal_kernel<T><<<L, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vectors), static_cast<const float*>(sqnorms),
      static_cast<const int*>(l0_nbrs), static_cast<const float*>(queries),
      static_cast<const float*>(qsq), static_cast<float*>(cand_d),
      static_cast<int*>(cand_i), static_cast<float*>(fin_d),
      static_cast<int*>(fin_i), static_cast<unsigned int*>(visited),
      static_cast<int*>(hops), static_cast<int*>(calcs), B, N, D, M0, C, EF,
      W, H, max_hops, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes: one entry point per row type. Each
// launches on `stream` and returns cudaGetLastError(); shapes were checked
// by the Python wrapper.
#define REPRO_TRAVERSAL_ENTRY(NAME, T)                                        \
  extern "C" int NAME(                                                        \
      const void* vectors, const void* sqnorms, const void* l0_nbrs,          \
      const void* queries, const void* qsq, void* cand_d, void* cand_i,       \
      void* fin_d, void* fin_i, void* visited, void* hops, void* calcs,       \
      int device, int L, int B, int N, int D, int M0, int C, int EF, int W,   \
      int H, int max_hops, int metric, void* stream) {                        \
    return launch_traversal<T>(vectors, sqnorms, l0_nbrs, queries, qsq,       \
                               cand_d, cand_i, fin_d, fin_i, visited, hops,   \
                               calcs, device, L, B, N, D, M0, C, EF, W, H,    \
                               max_hops, metric, stream);                     \
  }

REPRO_TRAVERSAL_ENTRY(repro_fused_traversal_f32, float)
REPRO_TRAVERSAL_ENTRY(repro_fused_traversal_u8, uint8_t)
REPRO_TRAVERSAL_ENTRY(repro_fused_traversal_i8, int8_t)

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Running k-smallest lists and the merge across row splits, shared by the
// fused scan kernels: `pq_topk` (qdist.cu) and `l2topk` / `l2topk_q`
// (l2topk.cu).
//
// Order. Every list is ordered by distance, then by row id: among equal
// distances the lower row wins, as the reference's `_select_k` and
// `lax.top_k` give. The order is total, so the k best of a set do not
// depend on how its rows were split across threads or CTAs, and blocks
// may run in any order.
//
// ThreadLists holds one thread's sorted lists, one per query, in local
// memory. A row enters only if it beats the list's last entry; a thread
// offers its rows in increasing id, so a strict < keeps the order. Rows
// with distance +inf (padding) never enter; a slot that no finite
// distance fills holds (+inf, -1).
//
// WarpList holds one sorted list across the 32 lanes of a warp, two
// positions a lane, in registers: an insertion is a rank by ballot and a
// shift by shuffle, whatever k is.
//
// merge_splits_kernel is the second launch of a fused scan: each query's
// S partial lists [Bq, S, K] (each split's k best, in order) become its k
// best, each entry written at its rank; empty entries (id -1) are skipped.
// The final distance is multiplied by `scale` (1 where there is none).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace topk {

constexpr int kMaxK = 64;

// (d, id) order: by distance, then by row id.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <int kQ>
struct ThreadLists {
  float d[kQ][kMaxK];
  int i[kQ][kMaxK];
  float kth[kQ];

  __device__ __forceinline__ void init(int K) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      for (int j = 0; j < K; ++j) {
        d[qi][j] = CUDART_INF_F;
        i[qi][j] = -1;
      }
      kth[qi] = CUDART_INF_F;
    }
  }

  // Offer row `id` at distance `dist` to query qi's list.
  __device__ __forceinline__ void offer(int qi, float dist, int id, int K) {
    if (dist < kth[qi]) {
      int j = K - 1;
      while (j > 0 && d[qi][j - 1] > dist) {
        d[qi][j] = d[qi][j - 1];
        i[qi][j] = i[qi][j - 1];
        --j;
      }
      d[qi][j] = dist;
      i[qi][j] = id;
      kth[qi] = d[qi][K - 1];
    }
  }
};

// A sorted list of up to 64 entries spread over a warp: lane l holds
// positions l (d0, i0) and l + 32 (d1, i1). Every lane of the warp calls
// each member with the same arguments.
struct WarpList {
  float d0, d1;
  int i0, i1;

  __device__ __forceinline__ void init() {
    d0 = d1 = CUDART_INF_F;
    i0 = i1 = -1;
  }

  // The entry at position p, in every lane.
  __device__ __forceinline__ void at(int p, float& d, int& id) const {
    d = __shfl_sync(0xffffffffu, p < 32 ? d0 : d1, p & 31);
    id = __shfl_sync(0xffffffffu, p < 32 ? i0 : i1, p & 31);
  }

  // Insert (d, id), which comes before the entry at position K-1: its
  // rank p is the count of entries before it (entries from position K on
  // come after it, so they do not count), and every entry from p on moves
  // up one position (the one at 63 drops).
  __device__ __forceinline__ void insert(float d, int id, int lane) {
    const int p = __popc(__ballot_sync(0xffffffffu, before(d0, i0, d, id))) +
                  __popc(__ballot_sync(0xffffffffu, before(d1, i1, d, id)));
    const float u0 = __shfl_up_sync(0xffffffffu, d0, 1);
    const int v0 = __shfl_up_sync(0xffffffffu, i0, 1);
    float u1 = __shfl_up_sync(0xffffffffu, d1, 1);
    int v1 = __shfl_up_sync(0xffffffffu, i1, 1);
    const float t = __shfl_sync(0xffffffffu, d0, 31);
    const int ti = __shfl_sync(0xffffffffu, i0, 31);
    if (lane == 0) { u1 = t; v1 = ti; }              // position 31 -> 32
    if (lane == p) { d0 = d; i0 = id; }
    else if (lane > p) { d0 = u0; i0 = v0; }
    if (lane + 32 == p) { d1 = d; i1 = id; }
    else if (lane + 32 > p) { d1 = u1; i1 = v1; }
  }
};

// One CTA per query; dynamic shared memory of S * K * 8 bytes.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ part_d,
                    const int* __restrict__ part_i,
                    float* __restrict__ out_d,      // [Bq, K]
                    int* __restrict__ out_i,        // [Bq, K]
                    int S, int K, float scale) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const int n = S * K;
  float* cd = reinterpret_cast<float*>(merge_smem);
  int* ci = reinterpret_cast<int*>(cd + n);
  const long long q = blockIdx.x;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    cd[c] = part_d[q * n + c];
    ci[c] = part_i[q * n + c];
  }
  for (int j = threadIdx.x; j < K; j += kThreads) {
    out_d[q * K + j] = CUDART_INF_F;
    out_i[q * K + j] = -1;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int id = ci[c];
    if (id < 0) continue;
    const float d = cd[c];
    int rank = 0;
    for (int o = 0; o < n && rank < K; ++o)
      rank += ci[o] >= 0 && before(cd[o], ci[o], d, id);
    if (rank < K) {
      out_d[q * K + rank] = __fmul_rn(d, scale);
      out_i[q * K + rank] = id;
    }
  }
}

// Launch merge_splits_kernel on Bq queries' partial lists; returns
// cudaGetLastError(). Opts in to more than 48 KB of shared memory where
// S * K needs it.
template <int kThreads>
cudaError_t merge_splits(const float* part_d, const int* part_i, float* out_d,
                         int* out_i, int Bq, int S, int K, float scale,
                         cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * K * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_splits_kernel<kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  merge_splits_kernel<kThreads><<<Bq, kThreads, smem, stream>>>(
      part_d, part_i, out_d, out_i, S, K, scale);
  return cudaGetLastError();
}

}  // namespace topk

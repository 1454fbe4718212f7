// Per-row k smallest of a float32 matrix for Hopper (sm_90a): `topk`.
//
// Replaces the TPU kernel `topk_pallas` (src/repro/kernels/topk.py). It
// computes what it computes, and what the plain PyTorch version
// `topk_ref` (src/repro_torch/kernels/topk.py) computes: for each row of
// x [B, N] the k smallest (value, column) pairs, ascending, as
// (values [B, k] float32, ids [B, k] int32). The order is by value, then
// by column: among equal values the lower column wins, as the reference's
// `_select_k` (it takes the first argmin) and `lax.top_k` give. A +inf or
// NaN entry never enters a list; a slot that no other entry fills holds
// (+inf, -1). (The reference's +inf slots carry ids that depend on its
// block size; ROADMAP.md Queue 3.)
//
// Layout. A CTA of 8 warps; W warps share a row (W in {1, 2, 4, 8}, the
// wrapper's choice from N), so a CTA takes 8 / W rows. A warp streams its
// row's columns 32 at a time (one a lane, coalesced; W warps of a row
// interleave their 32-column chunks, four chunks in flight), and keeps
// the row's sorted k-list across its lanes in registers (topk.cuh's
// WarpList). A column whose value beats the list's k-th (by ballot) is
// inserted by a popcount rank and a shift of shuffles, so most columns
// cost one compare. With W = 1 the warp writes its list; with W > 1 the W
// lists go to shared memory and the row's W * 32 threads write each entry
// at its rank among the W * k candidates. The order is total, so the
// answer does not depend on W.
//
// What bounds it on this card: the bytes, each entry of x read once
// (B * N * 4) and the output written once (B * k * 8), against about one
// compare an entry. On the MoE router's rows ([16,384, 64], k = 6: 5.0 MB
// in and out) that is 1.5 us at 3.35 TB/s, under the cost of a launch;
// at [256, 1M] (1.02 GB) 0.31 ms. At 64 columns a row the list upkeep
// bounds it instead: each of the first 32 columns beats a list not yet
// full, so a warp runs some 20 dependent insertions of ~10 shuffles
// (PERF.md has its time). Later work: a bitonic sort of the row in
// registers for short rows, more columns in flight for long ones.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;             // 32-column chunks a warp loads at once
constexpr unsigned int kFull = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(kThreads)
select_k_kernel(const float* __restrict__ x,   // [B, N]
                float* __restrict__ out_d,     // [B, K]
                int* __restrict__ out_i,       // [B, K]
                long long B, long long N, int K) {
  constexpr int kRows = kWarps / W;
  __shared__ float cand_d[kWarps][topk::kMaxK];
  __shared__ int cand_i[kWarps][topk::kMaxK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % W;                        // the warp's place in its row
  const long long row = static_cast<long long>(blockIdx.x) * kRows + warp / W;
  const bool live = row < B;                      // uniform across the warp

  topk::WarpList list;
  list.init();
  if (live) {
    const float* xr = x + row * N;
    const long long step = static_cast<long long>(W) * 32;
    for (long long c0 = static_cast<long long>(wr) * 32; c0 < N;
         c0 += step * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + u * step + lane;
        v[u] = c < N ? __ldg(xr + c) : CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long base = c0 + u * step;     // lane 0's column
        if (base >= N) break;                     // uniform across the warp
        float kd;
        int ki;
        list.at(K - 1, kd, ki);
        unsigned int m = __ballot_sync(
            kFull, topk::before(v[u], static_cast<int>(base) + lane, kd, ki));
        // each column that beats the k-th is inserted against the list as
        // it stands (earlier insertions may have lowered its k-th)
        while (m) {
          const int l = __ffs(m) - 1;
          m &= m - 1;
          const float d = __shfl_sync(kFull, v[u], l);
          const int id = static_cast<int>(base) + l;
          list.at(K - 1, kd, ki);
          if (topk::before(d, id, kd, ki)) list.insert(d, id, lane);
        }
      }
    }
  }

  if (W == 1) {
    if (!live) return;
    if (lane < K) {
      out_d[row * K + lane] = list.d0;
      out_i[row * K + lane] = list.i0;
    }
    if (lane + 32 < K) {
      out_d[row * K + lane + 32] = list.d1;
      out_i[row * K + lane + 32] = list.i1;
    }
    return;
  }

  // W lists of a row -> its k best, each candidate written at its rank
  if (lane < K) {
    cand_d[warp][lane] = list.d0;
    cand_i[warp][lane] = list.i0;
  }
  if (lane + 32 < K) {
    cand_d[warp][lane + 32] = list.d1;
    cand_i[warp][lane + 32] = list.i1;
  }
  __syncthreads();
  if (!live) return;
  const int first = warp - wr;                    // the row's first warp
  const int n = W * K;
  const int t = wr * 32 + lane;
  int valid = 0;
  for (int o = 0; o < n; ++o) valid += cand_i[first + o / K][o % K] >= 0;
  for (int c = t; c < n; c += W * 32) {
    const int id = cand_i[first + c / K][c % K];
    if (id < 0) continue;
    const float d = cand_d[first + c / K][c % K];
    int rank = 0;
    for (int o = 0; o < n && rank < K; ++o) {
      const int oi = cand_i[first + o / K][o % K];
      rank += oi >= 0 && topk::before(cand_d[first + o / K][o % K], oi, d, id);
    }
    if (rank < K) {
      out_d[row * K + rank] = d;
      out_i[row * K + rank] = id;
    }
  }
  for (int j = valid + t; j < K; j += W * 32) {   // slots no entry fills
    out_d[row * K + j] = CUDART_INF_F;
    out_i[row * K + j] = -1;
  }
}

template <int W>
cudaError_t launch(const float* x, float* out_d, int* out_i, long long B,
                   long long N, int K, cudaStream_t stream) {
  constexpr int kRows = kWarps / W;
  const long long grid = (B + kRows - 1) / kRows;
  select_k_kernel<W><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      x, out_d, out_i, B, N, K);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. x [B, N] float32 row-major; out_d /
// out_i [B, K]; W warps a row in {1, 2, 4, 8}. The Python wrapper checked
// every shape and pointer. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int repro_select_k(const void* x, void* out_d, void* out_i,
                              int device, long long B, long long N, int K,
                              int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  // column ids are int32 (a chunk's lanes reach N + 31); rows fit a 1-D grid
  if (N < 1 || N > 0x7fffffffLL - 32 || B > 0x7fffffffLL || K < 1 ||
      K > topk::kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* dp = static_cast<float*>(out_d);
  int* ip = static_cast<int*>(out_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: err = launch<1>(xp, dp, ip, B, N, K, st); break;
    case 2: err = launch<2>(xp, dp, ip, B, N, K, st); break;
    case 4: err = launch<4>(xp, dp, ip, B, N, K, st); break;
    case 8: err = launch<8>(xp, dp, ip, B, N, K, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_select_k_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

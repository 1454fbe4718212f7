// Fused exact k-nearest scan for Hopper (sm_90a): `l2topk` and `l2topk_q`.
//
// Replaces the TPU kernels `l2topk_pallas` (src/repro/kernels/l2topk.py)
// and `l2topk_q_pallas` (src/repro/kernels/qdist.py). It computes what
// they compute, and what the plain PyTorch versions `l2topk_ref` /
// `l2topk_q_ref` (src/repro_torch/kernels/) compute: for each query the k
// smallest of
//
//   d[q, x] = max((qsq[q] + xsq[x]) - 2 * dot(q, x), 0)
//
// as (dists [Bq, k] ascending, ids [Bq, k] int32), without writing the
// [Bq, Bx] matrix. Rows are float32, uint8 or int8 [Bx, D]; queries are
// float32 [Bq, D] (the wrapper casts 8-bit codes, which is exact). The
// selection is made on d; `out_scale` (l2topk_q's scale^2, 1 for l2topk)
// multiplies the k winners only in the final write, as the reference's
// flush does. Rows with xsq = +inf (padding) get d = +inf and never enter
// a list; a slot that no finite row fills holds (+inf, -1).
//
// Layout. Pass 1: CTA (g, s) takes 64 queries (grid.x) and one split of
// the rows (grid.y, S splits of whole 64-row tiles). For each tile,
// scan_tile.cuh computes the 64 x 64 dot products (one FMA chain per
// output, CUDA cores); a warp then holds all 64 rows' distances of its 8
// queries, and keeps each query's sorted list across its lanes in
// registers (topk.cuh's WarpList). A row whose distance beats the list's
// k-th (by ballot) is inserted by a rank and a shift of shuffles, so most
// rows cost one compare and an insertion costs the same at any k. The
// warp writes the split's k best to part[q, s, :], and pass 2 (topk.cuh's
// merge_splits_kernel) merges each query's S lists by rank. The order is
// (distance, row id) throughout — the reference's: among equal distances
// the lower row wins — so the answer does not depend on S or on the
// order in which blocks run. The wrapper chooses S to fill the card (66
// splits x 4 query blocks at Bq = 256, two CTAs an SM) with S * k <=
// 2,048 candidates a query for pass 2. Two earlier layouts kept
// lists in local memory, shifted entry by entry: 16 lists a query (one a
// thread of the 4 x 4 micro-tile), and one list a query (a keeper thread
// over the tile's distances in shared memory); at k=64 they took 45x and
// 20x the time of the tile's FMAs (PERF.md §6).
//
// What bounds it on this card: 2 * Bq * Bx * D operations against the
// rows read once (the output is Bq * k entries). At 256 x 1,000,000 x 128:
// float32 rows, 65.5 GFLOP (0.98 ms at 67 TFLOP/s of FP32) against 512 MB
// (0.15 ms), so the operations bound it; 8-bit rows, 128 MB of codes
// (0.038 ms at 3.35 TB/s) against the same products as int8 (0.033 ms at
// 1,979 TOP/s), so the bytes bound it. The FP32-FMA design sits far from
// that 8-bit bound; integer tensor cores (mma.sync / wgmma on u8 / s8,
// exact int32 sums) are later work, as are a larger micro-tile and
// cp.async / TMA staging.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "scan_tile.cuh"
#include "topk.cuh"

namespace {

using scan::kThreads;
using scan::kTile;

constexpr int kMaxSplits = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2topk_partial_kernel(const float* __restrict__ q,       // [Bq, D]
                      const T* __restrict__ x,           // [Bx, D]
                      const float* __restrict__ qsq,     // [Bq]
                      const float* __restrict__ xsq,     // [Bx], +inf on pads
                      float* __restrict__ part_d,        // [Bq, S, K]
                      int* __restrict__ part_i,          // [Bq, S, K]
                      int Bq, int Bx, int D, int qvec, int xvec, int K,
                      long long chunk) {
  __shared__ __align__(16) scan::Slab qs;
  __shared__ __align__(16) scan::Slab xs;
  const int tid = threadIdx.x, lane = tid & 31, tx = tid % 16, ty = tid / 16;
  const int half = lane >> 4;                  // ty = 2 * warp + half
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long qw = q0 + (tid >> 5) * 8;    // the warp's 8 queries
  const int s = blockIdx.y, S = gridDim.y;
  const long long lo = s * chunk;
  const long long hi = min(static_cast<long long>(Bx), lo + chunk);

  float qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qi = q0 + ty * 4 + i;
    qn[i] = qi < Bq ? qsq[qi] : 0.f;
  }
  // lists[h][i]: query qw + 4h + i, whose distances the lanes of half h
  // hold in acc[i][.]
  topk::WarpList lists[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) lists[h][i].init();

  for (long long x0 = lo; x0 < hi; x0 += kTile) {     // uniform across the CTA
    float acc[4][4];
    scan::tile_dot<T>(q, x, q0, Bq, x0, Bx, D, qvec, xvec, qs, xs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float kd[2];
      int ki[2];
      lists[0][i].at(K - 1, kd[0], ki[0]);
      lists[1][i].at(K - 1, kd[1], ki[1]);
      const float my_kd = half ? kd[1] : kd[0];
      const int my_ki = half ? ki[1] : ki[0];
      const bool live = q0 + ty * 4 + i < Bq;
      float dist[4];
      bool cand[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long row = x0 + tx * 4 + j;
        const float xn = row < hi ? xsq[row] : 0.f;
        dist[j] = fmaxf(scan::l2_from_dot(qn[i], xn, acc[i][j]), 0.f);
        cand[j] = live && row < hi &&
                  topk::before(dist[j], static_cast<int>(row), my_kd, my_ki);
      }
      // a row beats the k-th of its list: insert it, against the list as
      // it stands (earlier insertions may have lowered its k-th)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned int m = __ballot_sync(0xffffffffu, cand[j]) &
                           (h ? 0xffff0000u : 0x0000ffffu);
          while (m) {
            const int l = __ffs(m) - 1;
            m &= m - 1;
            const float v = __shfl_sync(0xffffffffu, dist[j], l);
            const int id = static_cast<int>(x0) + (l & 15) * 4 + j;
            float cd;
            int ci;
            lists[h][i].at(K - 1, cd, ci);
            if (topk::before(v, id, cd, ci)) lists[h][i].insert(v, id, lane);
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = qw + 4 * h + i;
      if (qi >= Bq) continue;                        // uniform across the warp
      const long long obase = (qi * S + s) * K;
      if (lane < K) {
        part_d[obase + lane] = lists[h][i].d0;
        part_i[obase + lane] = lists[h][i].i0;
      }
      if (lane + 32 < K) {
        part_d[obase + lane + 32] = lists[h][i].d1;
        part_i[obase + lane + 32] = lists[h][i].i1;
      }
    }
}

template <typename T>
int launch(const void* q, const void* x, const void* qsq, const void* xsq,
           void* part_d, void* part_i, void* out_d, void* out_i, int Bq,
           int Bx, int D, int qvec, int xvec, int K, int S, float scale,
           cudaStream_t stream) {
  const long long per = (static_cast<long long>(Bx) + S - 1) / S;
  const long long chunk = ((per + kTile - 1) / kTile) * kTile;
  const dim3 grid((Bq + kTile - 1) / kTile, S);
  l2topk_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(x),
      static_cast<const float*>(qsq), static_cast<const float*>(xsq),
      static_cast<float*>(part_d), static_cast<int*>(part_i), Bq, Bx, D, qvec,
      xvec, K, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(topk::merge_splits<kThreads>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), Bq, S, K, scale,
      stream));
}

}  // namespace

// C interface, bound with ctypes. `dtype` is the row type (0 float32,
// 1 uint8, 2 int8); `qvec` / `xvec` say whether the queries / rows may be
// staged 16 (float32) or 8 (code) bytes at a time; part_d / part_i are
// [Bq, S, K] scratch. The Python wrapper checked every shape and pointer.
// Launches both passes on `stream` and returns cudaGetLastError().
extern "C" int repro_l2topk(const void* q, const void* x, const void* qsq,
                            const void* xsq, void* part_d, void* part_i,
                            void* out_d, void* out_i, int device, int Bq,
                            int Bx, int D, int dtype, int qvec, int xvec, int K,
                            int S, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0) return 0;
  if (D < 1 || K < 1 || K > topk::kMaxK || S < 1 || S > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, x, qsq, xsq, part_d, part_i, out_d, out_i,
                                 Bq, Bx, D, qvec, xvec, K, S, scale, st);
    case 1: return launch<uint8_t>(q, x, qsq, xsq, part_d, part_i, out_d, out_i,
                                   Bq, Bx, D, qvec, xvec, K, S, scale, st);
    case 2: return launch<int8_t>(q, x, qsq, xsq, part_d, part_i, out_d, out_i,
                                  Bq, Bx, D, qvec, xvec, K, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_l2topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

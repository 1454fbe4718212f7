// Pairwise distance matrix for Hopper (sm_90a): `l2dist` and `l2dist_q`.
//
// Replaces the TPU kernels `l2dist_pallas` (src/repro/kernels/l2dist.py)
// and `l2dist_q_pallas` (src/repro/kernels/qdist.py). It computes what
// they compute, and what the plain PyTorch versions `l2dist_ref` /
// `l2dist_q_ref` (src/repro_torch/kernels/) compute:
//
//   out[q, x] = l2:     (qsq[q] + xsq[x]) - 2 * dot(q, x)
//               ip:     0 - dot(q, x)
//               cosine: 1 - dot(q, x)          (unit-norm inputs)
//   l2dist_q:  max(l2, 0) * out_scale          (clamp = 1)
//
// over float32 queries [Bq, D] and float32, uint8 or int8 rows [Bx, D]
// (the wrapper casts 8-bit queries to float32, which is exact). l2dist
// does not clamp, as the reference does not.
//
// Layout. One CTA of 256 threads per 64 queries (grid.x) walks 64-row
// tiles (grid.y, striding by gridDim.y <= 65535 so Bx may reach 2^31 - 1);
// scan_tile.cuh computes each tile's dot products as one FMA chain per
// output on the CUDA cores, and the epilogue writes the tile straight to
// the output (float4 stores when Bx % 4 == 0). The CTAs of the query
// blocks of one row tile are neighbours in launch order, so a row tile is
// read from device memory about once and from L2 by the others. The
// kernel allocates nothing: the wrapper allocates the [Bq, Bx] output.
//
// What bounds it on this card: 2 * Bq * Bx * D operations against the
// rows read once and 4 * Bq * Bx output bytes. At 256 x 1,000,000 x 128:
// float32 rows, 65.5 GFLOP (0.98 ms at 67 TFLOP/s of FP32) against 1.59
// GB (0.47 ms at 3.35 TB/s), so the operations bound it; 8-bit rows, the
// same products as int8 (0.033 ms at 1,979 TOP/s) against 1.07 GB of
// output and 128 MB of codes (0.36 ms), so the bytes bound it. The design
// reuses each staged value 4 times from registers (a 4 x 4 micro-tile)
// and 64 times from shared memory; a larger micro-tile, cp.async / TMA
// staging and, for 8-bit rows, integer tensor cores (exact int32 sums)
// are later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "scan_tile.cuh"

namespace {

using scan::kThreads;
using scan::kTile;

enum Metric : int { kL2 = 0, kIP = 1, kCosine = 2 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2dist_kernel(const float* __restrict__ q,       // [Bq, D]
              const T* __restrict__ x,           // [Bx, D]
              const float* __restrict__ qsq,     // [Bq] (l2 only)
              const float* __restrict__ xsq,     // [Bx] (l2 only)
              float* __restrict__ out,           // [Bq, Bx]
              int Bq, int Bx, int D, int qvec, int xvec, int ovec,
              int metric, int clamp, float scale) {
  __shared__ __align__(16) scan::Slab qs;
  __shared__ __align__(16) scan::Slab xs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long n_tiles = (static_cast<long long>(Bx) + kTile - 1) / kTile;
  float qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qi = q0 + ty * 4 + i;
    qn[i] = metric == kL2 && qi < Bq ? qsq[qi] : 0.f;
  }
  for (long long t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const long long x0 = t * kTile;
    float acc[4][4];
    scan::tile_dot<T>(q, x, q0, Bq, x0, Bx, D, qvec, xvec, qs, xs, acc);
    const long long c0 = x0 + tx * 4;
    float xn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xn[j] = metric == kL2 && c0 + j < Bx ? xsq[c0 + j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q0 + ty * 4 + i;
      if (qi >= Bq) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d = metric == kL2 ? scan::l2_from_dot(qn[i], xn[j], acc[i][j])
                  : metric == kIP ? __fsub_rn(0.f, acc[i][j])
                                  : __fsub_rn(1.f, acc[i][j]);
        if (clamp) d = __fmul_rn(fmaxf(d, 0.f), scale);
        v[j] = d;
      }
      float* o = out + qi * Bx + c0;
      if (ovec && c0 + 3 < Bx) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < Bx) o[j] = v[j];
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* x, const void* qsq, const void* xsq,
           void* out, int Bq, int Bx, int D, int qvec, int xvec, int metric,
           int clamp, float scale, cudaStream_t stream) {
  const long long n_tiles = (static_cast<long long>(Bx) + kTile - 1) / kTile;
  const dim3 grid((Bq + kTile - 1) / kTile,
                  static_cast<unsigned int>(n_tiles < 65535 ? n_tiles : 65535));
  const int ovec = Bx % 4 == 0;
  l2dist_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(x),
      static_cast<const float*>(qsq), static_cast<const float*>(xsq),
      static_cast<float*>(out), Bq, Bx, D, qvec, xvec, ovec, metric, clamp,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is the row type (0 float32,
// 1 uint8, 2 int8); `qvec` / `xvec` say whether the queries / rows may be
// staged 16 (float32) or 8 (code) bytes at a time; `clamp` applies
// max(., 0) * scale. The Python wrapper checked every shape and pointer.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_l2dist(const void* q, const void* x, const void* qsq,
                            const void* xsq, void* out, int device, int Bq,
                            int Bx, int D, int dtype, int qvec, int xvec,
                            int metric, int clamp, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0 || Bx == 0) return 0;
  if (D < 1 || metric < kL2 || metric > kCosine)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, x, qsq, xsq, out, Bq, Bx, D, qvec, xvec,
                                 metric, clamp, scale, st);
    case 1: return launch<uint8_t>(q, x, qsq, xsq, out, Bq, Bx, D, qvec, xvec,
                                   metric, clamp, scale, st);
    case 2: return launch<int8_t>(q, x, qsq, xsq, out, Bq, Bx, D, qvec, xvec,
                                  metric, clamp, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_l2dist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

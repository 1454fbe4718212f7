// The distance tile of the exact-scan kernels (l2dist.cu, l2topk.cu): a
// CTA of 256 threads takes 64 queries and 64 rows and computes their 4,096
// dot products over all of D.
//
// Queries are float32 [Bq, D]; rows are float32, uint8 or int8 [Bx, D],
// widened to float32 as they are staged (int8 sign-extended). K-tiles of
// 32 columns of both are staged in shared memory, k-major (s[k][row]), so
// that each thread reads its 4 queries and its 4 rows of a column as one
// float4 each. Thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4
// outputs of queries ty*4.. and rows tx*4.. of the tile.
//
// Each output is one float32 FMA chain over k = 0..D-1 in order, on the
// CUDA cores (no TF32: it keeps 10 bits of mantissa and would break the
// exactness below). On integer-valued float32 data with every partial sum
// an integer below 2^24 — 8-bit codes, or byte data at D <= 256 — the dot
// product is exact in any order, so these kernels, their plain PyTorch
// versions and the reference agree bitwise there.
//
// Staging: thread (r, c) = (tid % 64, tid / 64) loads row r of the tile,
// 16 bytes at a time (float4 of floats, 8 codes as a uint2) when D and
// the base pointer allow it ("vec"), else element by element; a warp then
// writes 32 consecutive rows of one k, which has no bank conflicts.
// Entries past n or D are zero. Row offsets are 64-bit.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace scan {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // queries and rows of a CTA tile
constexpr int kTK = 32;       // columns of a K-tile

typedef float Slab[kTK][kTile];

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

// Stage rows r0..r0+63, columns k0..k0+31 of a row-major [n, D] matrix.
template <typename T>
struct Stage {                       // 8-bit codes
  static __device__ __forceinline__ void load(const T* __restrict__ a,
                                              long long r0, long long n,
                                              int D, int k0, bool vec,
                                              Slab& s) {
    const int r = threadIdx.x % kTile, c = threadIdx.x / kTile;
    const long long row = r0 + r;
    const bool in = row < n;
    const T* src = a + (in ? row : 0) * static_cast<long long>(D);
    if (vec) {                       // D % 8 == 0, 8-byte aligned rows
      const int kk = c * 8;
      uint2 w = make_uint2(0u, 0u);
      if (in && k0 + kk < D) w = __ldg(reinterpret_cast<const uint2*>(src + k0 + kk));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[kk + j][r] = code_at<T>(w.x, j);
        s[kk + 4 + j][r] = code_at<T>(w.y, j);
      }
    } else {
      for (int kk = c; kk < kTK; kk += kThreads / kTile)
        s[kk][r] = in && k0 + kk < D ? static_cast<float>(src[k0 + kk]) : 0.f;
    }
  }
};

template <>
struct Stage<float> {
  static __device__ __forceinline__ void load(const float* __restrict__ a,
                                              long long r0, long long n,
                                              int D, int k0, bool vec,
                                              Slab& s) {
    const int r = threadIdx.x % kTile, c = threadIdx.x / kTile;
    const long long row = r0 + r;
    const bool in = row < n;
    const float* src = a + (in ? row : 0) * static_cast<long long>(D);
    if (vec) {                       // D % 4 == 0, 16-byte aligned rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = (c + 4 * h) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && k0 + kk < D) v = __ldg(reinterpret_cast<const float4*>(src + k0 + kk));
        s[kk][r] = v.x;
        s[kk + 1][r] = v.y;
        s[kk + 2][r] = v.z;
        s[kk + 3][r] = v.w;
      }
    } else {
      for (int kk = c; kk < kTK; kk += kThreads / kTile)
        s[kk][r] = in && k0 + kk < D ? src[k0 + kk] : 0.f;
    }
  }
};

// acc[i][j] = dot(query q0 + ty*4 + i, row x0 + tx*4 + j) over all of D.
// Every thread of the CTA calls it (it synchronizes the CTA).
template <typename T>
__device__ __forceinline__ void tile_dot(const float* __restrict__ q,
                                         const T* __restrict__ x,
                                         long long q0, long long Bq,
                                         long long x0, long long Bx, int D,
                                         bool qvec, bool xvec, Slab& qs,
                                         Slab& xs, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kTK) {
    Stage<float>::load(q, q0, Bq, D, k0, qvec, qs);
    Stage<T>::load(x, x0, Bx, D, k0, xvec, xs);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Squared L2 from the norms and the dot product, as the reference orders
// it: (qsq + xsq) - 2*dot, each op rounded on its own (no contraction).
__device__ __forceinline__ float l2_from_dot(float qsq, float xsq, float dot) {
  return __fsub_rn(__fadd_rn(qsq, xsq), __fmul_rn(2.f, dot));
}

}  // namespace scan

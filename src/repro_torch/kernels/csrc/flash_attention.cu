// Masked flash attention for Hopper (sm_90a): `flash_attention`.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/attention.py), the Pallas twin of the LM substrate's
// `blockwise_attn` (src/repro/models/layers.py), with the whole of that
// function's mask (`_mask_block`). It computes what the plain PyTorch
// version `flash_attention_ref` (src/repro_torch/kernels/attention.py)
// computes:
//
//   out[b, t] = sum_c softmax_c(q[b, t] . k[b / G, c] / sqrt(hd)) v[b / G, c]
//
// over q [BH, T, hd], k, v [BKV, S, hd] (G = BH / BKV query heads a KV
// head) in float32 or bf16, out in q's type. Row t sits at global position
// r = q_offset + t, key c at local position c; the key is live when c < S
// (the reference's `s_valid`), with `causal` c <= r or c < prefix, and
// with window > 0 c > r - window. The softmax runs online over key blocks
// in float32, as the reference's (it casts q, k and v to float32): a
// running max m, sum l and accumulator acc a row, masked scores at -1e30,
// out = acc / max(l, 1e-20), and 0 on a row that saw no live key (the
// reference's -inf guards). Key blocks outside every row's live range are
// never visited (the reference's `live`, and the window's start).
//
// Layout. One CTA of 256 threads a (bh, 64-query block); the heaviest
// causal blocks are launched first. The CTA stages its queries once,
// transposed (qT [hd][64]), then streams 64-key blocks: keys transposed
// (kT [hd][68]) and values row-major (vs [64][hd rounded up to 64]),
// widened to float32 as they are staged, 16 bytes a thread where the rows
// allow it. Thread (tr, tc) of a 16 x 16 grid computes a 4 x 4 tile of
// scores (one FP32 FMA chain an entry over hd), the row's max and sum
// by shuffles across the 16 threads of a row, and writes its
// probabilities to shared memory (p [64][68]); then it owns 4 rows x
// (4 columns in each 64-column group of hd) of the accumulator, in
// registers. Any hd up to 256 (NG = ceil(hd / 64) column groups; the
// path's 192 takes 168 KB of shared memory, one CTA an SM).
//
// What bounds it on this card: the operations, 4 * BH * hd * (the
// (query, key) pairs visited; T^2 / 2 under a causal mask) on the CUDA
// cores at 67 TFLOP/s FP32; at MLA prefill's [128, 2048, 192] that is
// 206 GFLOP, 3.1 ms, against 302 MB of q, k, v and out (0.09 ms). This
// kernel feeds FP32 FMAs from shared memory. It takes float32, and the
// bf16 shapes csrc/flash_attention_tc.cu (wgmma and TMA, which the model's
// path takes) refuses: hd not a multiple of 8, or an unaligned base.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kLDK = kBK + 4;          // kT and p row strides (16-byte rows)
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// Eight bf16 or four float32 values of one 16-byte load, widened.
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* src, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(raw.x);
      f[1] = __uint_as_float(raw.y);
      f[2] = __uint_as_float(raw.z);
      f[3] = __uint_as_float(raw.w);
    } else {
      const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

// dst[d * ld + r] = src[r, d] (rows r < 64 of a [rows, hd] block; rows at
// or past `valid` read as 0). Consecutive threads take consecutive rows, so
// the transposed stores hit consecutive banks.
template <typename T>
__device__ __forceinline__ void stage_transposed(float* dst, int ld,
                                                 const T* src, int valid,
                                                 int hd, bool vec) {
  if (vec) {
    constexpr int V = Vec16<T>::kN;
    const int chunks = hd / V;
    for (int e = threadIdx.x; e < 64 * chunks; e += kThreads) {
      const int r = e % 64, d0 = (e / 64) * V;
      float f[V];
      if (r < valid) {
        Vec16<T>::load(src + static_cast<long long>(r) * hd + d0, f);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(d0 + j) * ld + r] = f[j];
    }
  } else {
    for (int e = threadIdx.x; e < 64 * hd; e += kThreads) {
      const int r = e % 64, d = e / 64;
      dst[d * ld + r] =
          r < valid ? to_f(src[static_cast<long long>(r) * hd + d]) : 0.f;
    }
  }
}

// dst[r * ld + d] = src[r, d], rows at or past `valid` as 0.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           int valid, int hd, bool vec) {
  if (vec) {
    constexpr int V = Vec16<T>::kN;
    const int chunks = hd / V;
    for (int e = threadIdx.x; e < 64 * chunks; e += kThreads) {
      const int r = e / chunks, d0 = (e % chunks) * V;
      float f[V];
      if (r < valid) {
        Vec16<T>::load(src + static_cast<long long>(r) * hd + d0, f);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * ld + d0 + j] = f[j];
    }
  } else {
    for (int e = threadIdx.x; e < 64 * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      dst[r * ld + d] =
          r < valid ? to_f(src[static_cast<long long>(r) * hd + d]) : 0.f;
    }
  }
}

__host__ __device__ constexpr int v_stride(int ng) { return ng * 64; }

__host__ __device__ inline size_t smem_bytes(int hd, int ng) {
  return sizeof(float) * (static_cast<size_t>(hd) * kBQ +
                          static_cast<size_t>(hd) * kLDK +
                          static_cast<size_t>(kBK) * v_stride(ng) +
                          static_cast<size_t>(kBQ) * kLDK);
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,   // [BH, Tq, hd]
                       const T* __restrict__ k,   // [BKV, S, hd]
                       const T* __restrict__ v,   // [BKV, S, hd]
                       T* __restrict__ o,         // [BH, Tq, hd]
                       int BH, int G, int Tq, int S, int hd, float scale,
                       int causal, int window, int prefix, int q_offset,
                       int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDV = v_stride(NG);
  float* qT = smem;                        // [hd][kBQ]
  float* kT = qT + hd * kBQ;               // [hd][kLDK]
  float* vs = kT + hd * kLDK;              // [kBK][LDV]
  float* ps = vs + kBK * LDV;              // [kBQ][kLDK]

  const int nqb = (Tq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const long long qoff = static_cast<long long>(bh) * Tq * hd;
  const long long koff = static_cast<long long>(bh / G) * S * hd;

  // vs's columns from hd to LDV are never staged: zero them once
  for (int e = tid; e < kBK * LDV; e += kThreads) vs[e] = 0.f;
  stage_transposed(qT, kBQ, q + qoff + static_cast<long long>(q0) * hd,
                   Tq - q0, hd, vec);

  float m[4], l[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  // The live keys of global row r are one interval [lo(r), hi(r)]: c < S,
  // with `causal` c <= max(r, prefix - 1), with a window c >= r - window
  // + 1; both ends grow with r. This thread's four rows' intervals, and
  // the key blocks any of this block's rows may see, [lo(r_lo), hi(r_hi)].
  const auto lo_of = [&](int r) {
    return window > 0 ? max(0, r - window + 1) : 0;
  };
  const auto hi_of = [&](int r) {
    return causal ? min(S - 1, max(r, prefix - 1)) : S - 1;
  };
  int key_lo[4], key_hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key_lo[i] = lo_of(q_offset + q0 + tr * 4 + i);
    key_hi[i] = hi_of(q_offset + q0 + tr * 4 + i);
  }
  const int lo = lo_of(q_offset + q0);
  const int hi = hi_of(q_offset + min(q0 + kBQ, Tq) - 1);
  const int last = lo > hi ? -1 : hi / kBK;
  for (int kb = lo / kBK; kb <= last; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                       // the previous block is consumed
    stage_transposed(kT, kLDK, k + koff + static_cast<long long>(k0) * hd,
                     S - k0, hd, vec);
    stage_rows(vs, LDV, v + koff + static_cast<long long>(k0) * hd, S - k0,
               hd, vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kBQ + tr * 4);
      const float4 b = *reinterpret_cast<const float4*>(kT + d * kLDK + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc * 4 + j;
        float val = s[i][j] * scale;
        if (col < key_lo[i] || col > key_hi[i]) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      // the 16 threads of a row are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (tr * 4 + i) * kLDK + tc * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] *= corr[i];
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (tr * 4 + i) * kLDK + j0);
        pv[i][0] = p4.x;
        pv[i][1] = p4.y;
        pv[i][2] = p4.z;
        pv[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              vs + (j0 + jj) * LDV + g * 64 + tc * 4);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[i][g * 4 + u] = fmaf(pv[i][jj], wv[u], acc[i][g * 4 + u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= Tq) continue;
    // a row with no live key is 0 (the reference's -inf guards)
    const float inv_l = m[i] == kNegInf ? 0.f : 1.f / fmaxf(l[i], 1e-20f);
    T* orow = o + qoff + static_cast<long long>(row) * hd;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = g * 64 + tc * 4 + u;
        if (col < hd) from_f(acc[i][g * 4 + u] * inv_l, orow + col);
      }
  }
}

// The mask's scalars, as the C interface takes them.
struct Mask {
  int causal, window, prefix, q_offset;
};

template <typename T, int NG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int BKV, int Tq, int S, int hd, float scale,
                   const Mask& mk, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, NG);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long nqb = (Tq + kBQ - 1) / kBQ;
  const long long grid = nqb * BH;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_kernel<T, NG>
      <<<static_cast<unsigned int>(grid), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), BH, BH / BKV, Tq, S,
          hd, scale, mk.causal, mk.window, mk.prefix, mk.q_offset, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int BH, int BKV, int Tq, int S, int hd, float scale,
                      const Mask& mk, int vec, cudaStream_t st) {
  switch ((hd + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, BH, BKV, Tq, S, hd, scale, mk, vec, st);
    case 2: return launch<T, 2>(q, k, v, o, BH, BKV, Tq, S, hd, scale, mk, vec, st);
    case 3: return launch<T, 3>(q, k, v, o, BH, BKV, Tq, S, hd, scale, mk, vec, st);
    case 4: return launch<T, 4>(q, k, v, o, BH, BKV, Tq, S, hd, scale, mk, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes. q [BH, Tq, hd], k / v [BKV, S, hd] and
// o [BH, Tq, hd] contiguous, all of `dtype` (0 float32, 1 bf16), BKV
// dividing BH; 1 <= hd <= 256; window, prefix and q_offset >= 0 (prefix
// 0: none); `vec` says the rows may be staged 16 bytes at a time (hd * the
// element size a multiple of 16, every pointer 16-byte aligned); `scale`
// is 1 / sqrt(hd) rounded to float32. The Python wrapper checked every
// shape and pointer. Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int device,
                                     int BH, int BKV, int Tq, int S, int hd,
                                     int dtype, int causal, int window,
                                     int prefix, int q_offset, float scale,
                                     int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH == 0 || Tq == 0) return 0;
  if (S < 1 || hd < 1 || hd > 256 || BKV < 1 || BH % BKV != 0 ||
      window < 0 || prefix < 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{causal, window, prefix, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_hd<float>(q, k, v, o, BH, BKV, Tq, S, hd, scale, mk,
                                   vec, st); break;
    case 1: err = launch_hd<__nv_bfloat16>(q, k, v, o, BH, BKV, Tq, S, hd,
                                           scale, mk, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

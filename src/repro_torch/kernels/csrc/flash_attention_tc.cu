// Masked flash attention on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/attention.py), with the whole mask of the reference's
// `blockwise_attn` (src/repro/models/layers.py `_mask_block`), for bf16
// inputs whose head dim is a multiple of 8; csrc/flash_attention.cu keeps
// float32 and the other bf16 shapes (the wrapper, kernels/attention.py,
// picks by shape). It computes the function of `flash_attention_ref`
// (kernels/attention.py):
//
//   out[b, t] = sum_c softmax_c(q[b, t] . k[b / G, c] / sqrt(hd)) v[b / G, c]
//
// over q [BH, T, hd], k, v [BKV, S, hd] bf16 (G = BH / BKV grouped query
// heads a KV head, never repeated in memory), out bf16. Row t sits at
// global position r = q_offset + t, key c at local position c; the key is
// live when c < S, with `causal` c <= r or c < prefix, and with window > 0
// c > r - window. Masked scores are -1e30, the softmax runs online in
// float32 and out = acc / max(l, 1e-20); a row that saw no live key (its
// running max still -1e30) is written as 0. The reference keeps P in
// float32 for P.V, and so does this kernel: P splits exactly into three
// bf16 pieces.
//
// What bounds it on this card: the operations. At MLA prefill's
// [128, 2048, 192] causal, q.k^T is 103.1 GFLOP and P.V three times that
// (P in three pieces), 412 GFLOP at the bf16 tensor cores' 989 TFLOP/s:
// 0.417 ms, against 403 MB of q, k, v and out (0.120 ms at 3.35 TB/s).
//
// The design, against that bound:
// - A CTA of three warpgroups takes (head, 128 query rows), the heaviest
//   causal blocks first. Warpgroups 0 and 1 consume, 64 query rows each
//   (wgmma's M); warpgroup 2 produces, one thread issuing TMA copies.
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240). The CTA's live key tiles [first, last] come from the mask
//   (`live_tiles` over its rows); the producer loads exactly those, and
//   both consumers wait on exactly those, computing only the tiles live
//   for their own 64 rows. An empty range loads nothing, waits on nothing
//   and writes zeros.
// - TMA stages bf16 as it is, never widened, through 3-D tensor maps over
//   q [BH, T, hd] and k, v [BKV, S, hd] (addressed at bh / G) with
//   128-byte swizzle: boxes of 64 columns (hd is 1 to 4 boxes, zero-filled
//   past hd: hd 120 reads 56 zero columns in its second box) by 64 keys or
//   128 queries. Rows past S or T read as zeros and no tile crosses into
//   the next head. Q is loaded once; K and V tiles of 64 keys stream
//   through a ring of 2 or 3 stages with full / empty mbarriers. Key tiles
//   wholly outside every row's window, or wholly in every row's causal
//   future past the prefix, are never loaded.
// - S = Q.K^T on `wgmma` m64n64k16 (bf16 -> f32, both from shared
//   memory, K-major), hd / 16 k-steps. The mask is applied only on tiles
//   that are not wholly live for every row of the warpgroup: each row's
//   live keys are one interval, so two compares a score.
// - The softmax runs in float32 in the accumulator's own fragment layout:
//   row max and sum across the four threads of a quad, exp2f with the
//   scale and log2(e) folded into one multiply.
// - P.V on `wgmma` m64n64k16 with A from registers (the score fragment is
//   the A fragment) and V MN-major from shared memory: P = p1 + p2 + p3,
//   p1 = bf16(P), p2 = bf16(P - p1), p3 = bf16(P - p1 - p2), each
//   subtraction exact in float32, one product a piece into the float32
//   accumulator after it is rescaled by the softmax's correction.
// - The epilogue divides by max(l, 1e-20) in registers and stores bf16
//   pairs; rows >= T and columns >= hd are never written.
// Not yet: overlap of one tile's softmax with the next tile's products
// within a warpgroup, a persistent grid, TMA stores.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::desc_sw128;
using hopper::encoder;
using hopper::fence_regs;
using hopper::kEncodeFailed;
using hopper::kNoEncoder;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_3d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait_all;

constexpr int kConsumers = 2;               // warpgroups of 64 query rows
constexpr int kBQ = 64 * kConsumers;        // query rows a CTA
constexpr int kBK = 64;                     // keys a tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = kBK * 128;        // [64 keys][64 bf16], one box
constexpr int kQBoxBytes = kBQ * 128;       // [128 rows][64 bf16]
constexpr float kNegInf = -1e30f;           // the reference's NEG_INF

// The mask's scalars (global rows, local keys).
struct Mask {
  int S, causal, window, prefix, q_offset;
};

// The live keys of global row r form one interval [lo, hi] (lo > hi: none):
// c < S, with `causal` c <= max(r, prefix - 1), with window > 0
// c >= r - window + 1 (`_mask_block`). Both ends grow with r.
__device__ __forceinline__ int2 row_keys(const Mask& mk, int r) {
  return make_int2(mk.window > 0 ? max(0, r - mk.window + 1) : 0,
                   mk.causal ? min(mk.S - 1, max(r, mk.prefix - 1))
                             : mk.S - 1);
}

// The key tiles [first, last] rows r_lo..r_hi may see (first > last: none):
// every such key lies in [lo(r_lo), hi(r_hi)]. kernels/attention.py
// `live_keys` mirrors it.
__device__ __forceinline__ void live_tiles(const Mask& mk, int r_lo, int r_hi,
                                           int& first, int& last) {
  const int lo = row_keys(mk, r_lo).x, hi = row_keys(mk, r_hi).y;
  first = lo / kBK;
  last = lo > hi ? first - 1 : hi / kBK;
}

// Shared memory of a CTA at NG 64-column groups of hd (byte offsets from a
// 1024-byte aligned base: the 128-byte swizzle repeats every 1024 bytes).
template <int NG>
struct Smem {
  static constexpr int kStages = NG == 4 ? 2 : 3;
  static constexpr int kK = NG * kQBoxBytes;                 // after Q
  static constexpr int kV = kK + kStages * NG * kBoxBytes;
  static constexpr int kBar = kV + kStages * NG * kBoxBytes;
  // q_full, full[kStages], empty[kStages]; + 1024 to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32("+f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs in
// the m64k16 fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) = p1 + p2 + p3 exactly, each a bf16 pair (x in [0, 1]).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& p1,
                                       uint32_t& p2, uint32_t& p3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x0, x1);
  const float2 f1 = __bfloat1622float2(h1);
  const float r0 = x0 - f1.x, r1 = x1 - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(r0, r1);
  const float2 f2 = __bfloat1622float2(h2);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(h2);
  p3 = bf16x2_bits(__floats2bfloat162_rn(r0 - f2.x, r1 - f2.y));
}

template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o,  // [BH, Tq, hd]
                          int BH, int G, int Tq, int hd, const Mask mk,
                          float scale_log2) {
  using L = Smem<NG>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int nqb = (Tq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH, bkv = bh / G;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  // the key tiles any of this CTA's rows may see: the producer loads them
  // and both consumers wait on them, so all three agree on the range
  int first, last;
  live_tiles(mk, mk.q_offset + q0, mk.q_offset + min(q0 + kBQ, Tq) - 1,
             first, last);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival a warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers && first <= last) {
      mbar_expect_tx(q_full, NG * kQBoxBytes);
      for (int g = 0; g < NG; ++g)
        tma_load_3d(sq + g * kQBoxBytes, &tm_q, q_full, 64 * g, q0, bh);
      for (int kb = first; kb <= last; ++kb) {
        const int i = kb - first, st = i % kStages;
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * NG * kBoxBytes);
        for (int g = 0; g < NG; ++g) {
          const uint32_t off = (st * NG + g) * kBoxBytes;
          tma_load_3d(sk + off, &tm_k, full + 8 * st, 64 * g, kb * kBK, bkv);
          tma_load_3d(sv + off, &tm_v, full + 8 * st, 64 * g, kb * kBK, bkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int wq0 = q0 + 64 * wg;             // this warpgroup's first row
    const int row0 = wq0 + 16 * warp + lane / 4;  // and row0 + 8
    const int grow0 = mk.q_offset + row0;     // row0's global position
    const int cq = 2 * (lane % 4);            // fragment column in an n8
    // this warpgroup's rows a..b (global), the tiles live for them, the
    // keys every one of them sees [all_lo, all_hi], and this thread's two
    // rows' live keys
    const int a = mk.q_offset + wq0, b = mk.q_offset + min(wq0 + 63, Tq - 1);
    int wfirst = 0, wlast = -1;
    if (wq0 < Tq) live_tiles(mk, a, b, wfirst, wlast);
    const int all_lo = row_keys(mk, b).x, all_hi = row_keys(mk, a).y;
    const int2 keys[2] = {row_keys(mk, grow0), row_keys(mk, grow0 + 8)};
    float acc[NG][32];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    if (first <= last) mbar_wait(q_full, 0);
    for (int kb = first; kb <= last; ++kb) {
      const int i = kb - first, st = i % kStages, k0 = kb * kBK;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      // a tile no row of this warpgroup may see adds nothing
      if (kb >= wfirst && kb <= wlast) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s,
                     desc_sw128(sq + g * kQBoxBytes + wg * kBoxBytes + 32 * kk,
                                16),
                     desc_sw128(sk + (st * NG + g) * kBoxBytes + 32 * kk, 16),
                     g | kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // s[4j + e]: row row0 + 8 (e / 2), key k0 + 8j + cq + (e % 2)
        // a tile not wholly live for every row is masked key by key
        const bool edge = k0 < all_lo || k0 + kBK - 1 > all_hi;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (edge) {
              const int col = k0 + 8 * j + cq + (e & 1);
              const int2 kr = keys[e >> 1];
              if (col < kr.x || col > kr.y) x = kNegInf;
            }
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          corr[h] = exp2f(m[h] - mx[h]);
          m[h] = mx[h];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
          sum[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l[h] = l[h] * corr[h] + sum[h];
        }
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[g][i] *= corr[(i >> 1) & 1];

        // the A fragment of keys 16kk..16kk+15 is s[8kk .. 8kk + 7]
        uint32_t a[3][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], a[0][kk][r],
                   a[1][kk][r], a[2][kk][r]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int piece = 0; piece < 3; ++piece)
#pragma unroll
            for (int g = 0; g < NG; ++g)
              wgmma_rs(acc[g], a[piece][kk],
                       desc_sw128(sv + (st * NG + g) * kBoxBytes +
                                      kk * 16 * 128,
                                  kBoxBytes));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int g = 0; g < NG; ++g) fence_regs(acc[g]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    const long long obase = static_cast<long long>(bh) * Tq * hd;
    const float den[2] = {fmaxf(l[0], 1e-20f), fmaxf(l[1], 1e-20f)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Tq) continue;
      // a row with no live key is 0 (the reference's -inf guards)
      const bool dead = m[h] == kNegInf;
      __nv_bfloat16* orow = o + obase + static_cast<long long>(row) * hd;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * g + 8 * j + cq;  // hd % 8 == 0: col + 1 < hd
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(
                    dead ? 0.f : acc[g][4 * j + 2 * h] / den[h],
                    dead ? 0.f : acc[g][4 * j + 2 * h + 1] / den[h]);
        }
    }
  }
}

// A tensor map over x [BH, rows, hd] bf16 with boxes [1, box_rows, 64].
bool encode(CUtensorMap* map, const void* x, int BH, int rows, int hd,
            int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(x), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NG>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BKV, int Tq, int hd, const Mask& mk, float scale_log2,
           cudaStream_t stream) {
  if (encoder() == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, BH, Tq, hd, kBQ) ||
      !encode(&tk, k, BKV, mk.S, hd, kBK) ||
      !encode(&tv, v, BKV, mk.S, hd, kBK))
    return kEncodeFailed;
  constexpr int smem = Smem<NG>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>((Tq + kBQ - 1) / kBQ) * BH;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc_kernel<NG>
      <<<static_cast<unsigned int>(grid), kThreads, smem, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), BH, BH / BKV, Tq, hd,
          mk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. q [BH, Tq, hd], k / v [BKV, S, hd] and
// o [BH, Tq, hd] contiguous bf16, BKV dividing BH, every pointer 16-byte
// aligned, hd a multiple of 8 up to 256; window, prefix and q_offset >= 0
// (prefix 0: none); `scale_log2` is log2(e) / sqrt(hd) rounded to float32.
// The Python wrapper checked every shape and pointer. Launches on
// `stream`; returns cudaGetLastError() or one of the codes above.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* o, int device,
                                        int BH, int BKV, int Tq, int S,
                                        int hd, int causal, int window,
                                        int prefix, int q_offset,
                                        float scale_log2, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH == 0 || Tq == 0) return 0;
  if (S < 1 || hd < 8 || hd > 256 || hd % 8 != 0 || BKV < 1 ||
      BH % BKV != 0 || window < 0 || prefix < 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{S, causal, window, prefix, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((hd + 63) / 64) {
    case 1: return launch<1>(q, k, v, o, BH, BKV, Tq, hd, mk, scale_log2, st);
    case 2: return launch<2>(q, k, v, o, BH, BKV, Tq, hd, mk, scale_log2, st);
    case 3: return launch<3>(q, k, v, o, BH, BKV, Tq, hd, mk, scale_log2, st);
    default: return launch<4>(q, k, v, o, BH, BKV, Tq, hd, mk, scale_log2, st);
  }
}

extern "C" const char* repro_flash_attention_tc_error_string(int err) {
  return hopper::error_string(err);
}

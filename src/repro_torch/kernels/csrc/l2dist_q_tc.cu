// Code-space distance matrix over 8-bit rows on Hopper's integer tensor
// cores (sm_90a): `l2dist_q` with u8 / s8 `wgmma` into s32.
//
// Replaces the TPU kernel `l2dist_q_pallas` (src/repro/kernels/qdist.py)
// for queries given as codes of the rows' dtype (uint8 or int8), D a
// multiple of 16 up to 256, Bx a multiple of 4 and 16-byte aligned bases
// (TMA's pitch and address rules, the [Bq, Bx] output's included);
// csrc/l2dist.cu keeps code-valued float32 queries and the other shapes
// (the wrapper, kernels/qdist.py, picks by dtype and shape). It computes
// the function of `l2dist_q_ref`:
//
//   out[q, x] = max((qsq[q] + xsq[x]) - 2 * dot(q, x), 0) * out_scale
//
// each op rounded on its own, the clamp before the scale (a pad row's
// xsq = +inf reads +inf). The dot product is an exact int32 sum (at most
// 255^2 x 256 < 2^24 for uint8, 128^2 x 256 for int8, codes of -128
// included), so its float32 value is exact and the result equals the
// plain version and the reference bitwise.
//
// What bounds it on this card: at 256 x 1,000,000 x 128 the 1.02 GB
// output and 128 MB of codes (1,156 MB with the norms, 0.345 ms at 3.35
// TB/s) against 65.5 GOP at int8's 1,979 TOP/s (0.033 ms): the bytes, the
// output first. So the stores must never wait on the products.
//
// The design: l2topk_q_tc.cu's products with l2dist_tc.cu's output.
// - A persistent CTA holds 64 queries (wgmma's N) and walks 64-row tiles
//   (wgmma's M) with a stride, the CTAs of the query blocks of one row
//   tile neighbours in launch order, so a tile is read from device memory
//   about once and from L2 by the others. Warpgroups 0 and 1 consume
//   alternate tiles; one thread of warpgroup 2 issues the TMA copies.
// - TMA stages the query codes once and 64-row tiles of codes through a
//   ring of four stages a consumer, in boxes of 128 bytes (128-byte
//   swizzle) by 64 rows, zeros past D and past Bx. A stage serves one
//   warpgroup only (TMA copies may land out of order).
// - `wgmma` m64n64k32 runs with the rows as A and the queries as B, both
//   K-major in shared memory, 4 k-steps a box into an s32 accumulator.
// - The epilogue applies the formula in registers, writes the [64 rows x
//   64 queries] tile transposed into a swizzled staging tile and
//   TMA-stores it as two [64 queries x 32 rows] boxes of the output
//   (clipped at Bq and Bx). Each warpgroup has two staging tiles, so a
//   tile's store runs under the next two tiles' products and epilogues;
//   the warpgroup waits only until the older store has read its tile.
//
// Shared memory at D <= 128 (NB = 1 box): queries 8,192, ring 8 stages x
// 8,192 = 65,536, staging 2 warpgroups x 2 tiles x 16,384 = 65,536, 17
// mbarriers, 1,024 to align: 140,424 bytes; at D <= 256 (NB = 2) 214,152.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "scan_tile.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;                 // rows of a tile, queries of a CTA
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = kTile * 128;         // [64][128 codes], one box
constexpr int kOutBox = kTile * 128;      // [64 queries][32 floats]
constexpr int kStages = 4 * kConsumers;   // stages w, w + 2, w + 4, w + 6
constexpr int kOutBufs = 2;               // staging tiles a consumer

// Shared memory at NB boxes of 128 columns (byte offsets from a 1024-byte
// aligned base).
template <int NB>
struct Smem {
  static constexpr int kQ = 0;
  static constexpr int kRing = NB * kBox;
  static constexpr int kOut = kRing + kStages * NB * kBox;  // 2 boxes a tile
  static constexpr int kBar = kOut + kConsumers * kOutBufs * 2 * kOutBox;
  // q_full, full[kStages], empty[kStages]; + 1024 to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};
static_assert(Smem<1>::kBytes == 140424 && Smem<2>::kBytes == 214152 &&
                  Smem<2>::kBytes <= 232448,
              "the layout no longer fits a block");

// The ring stage of a CTA's tile i: warpgroup i % 2 consumes it, and its
// tiles take its four stages in turn.
__device__ __forceinline__ int stage(int i) {
  return i % kConsumers +
         kConsumers * ((i / kConsumers) % (kStages / kConsumers));
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
l2dist_q_tc_kernel(const __grid_constant__ CUtensorMap tm_q,   // [Bq, D]
                   const __grid_constant__ CUtensorMap tm_x,   // [Bx, D]
                   const __grid_constant__ CUtensorMap tm_o,   // [Bq, Bx]
                   const float* __restrict__ qsq,              // [Bq]
                   const float* __restrict__ xsq,   // [Bx], +inf on pads
                   int Bq, int Bx, float scale) {
  using L = Smem<NB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw);   // generic view
  const uint32_t q_full = base + L::kBar;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int G = (Bq + kTile - 1) / kTile;     // query blocks
  const int P = gridDim.x / G;                // CTAs a query block
  const int qb = blockIdx.x % G, slot = blockIdx.x / G;
  const int q0 = qb * kTile;
  const int n_tiles = (Bx + kTile - 1) / kTile;
  const int mine = slot < n_tiles ? (n_tiles - 1 - slot) / P + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);            // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, NB * kBox);
      for (int b = 0; b < NB; ++b)
        tma_load_2d(base + L::kQ + b * kBox, &tm_q, q_full, 128 * b, q0);
      for (int i = 0; i < mine; ++i) {
        const int st = stage(i), use = i / kStages;
        mbar_wait(empty + 8 * st, (use & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, NB * kBox);
        const int x0 = (slot + i * P) * kTile;
        for (int b = 0; b < NB; ++b)
          tma_load_2d(base + L::kRing + (st * NB + b) * kBox, &tm_x,
                      full + 8 * st, 128 * b, x0);
      }
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;               // fragment rows r0, r0 + 8

  // the norms of this thread's 16 queries: q0 + 8j + 2t + e
  float qn[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + 8 * j + 2 * t + e;
      qn[j][e] = q < Bq ? qsq[q] : 0.f;
    }
  mbar_wait(q_full, 0);

  for (int i = wg, n = 0; i < mine; i += kConsumers, ++n) {
    const int st = stage(i);
    const int x0 = (slot + i * P) * kTile;
    float xn[2];                              // rows r0, r0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = x0 + r0 + 8 * h;
      xn[h] = row < Bx ? xsq[row] : 0.f;      // past Bx: clipped by the store
    }
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    int acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {     // zeros past D add nothing
      const uint32_t off = (kk / 4) * kBox + 32 * (kk % 4);
      wgmma_i8<T>(acc, desc_sw128(base + L::kRing + st * NB * kBox + off, 16),
                  desc_sw128(base + L::kQ + off, 16), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);

    // epilogue: acc[4j + e] is row r0 + 8 (e / 2), query 8j + 2t + (e % 2)
    const uint32_t stage_out =
        base + L::kOut + (wg * kOutBufs + n % kOutBufs) * 2 * kOutBox;
    if (tid == 0) bulk_wait_read_but_newest();   // this staging tile is free
    named_sync(1 + wg, 128);
    // rows r0 and r0 + 8 lie in box warp / 2 of the staging tile
    unsigned char* out = sp + (stage_out - base) + (warp / 2) * kOutBox;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = __fmul_rn(
            fmaxf(scan::l2_from_dot(qn[j][e & 1], xn[e >> 1],
                                    __int2float_rn(acc[4 * j + e])),
                  0.f),
            scale);
        const int r = (r0 + 8 * (e >> 1)) % 32;
        *reinterpret_cast<float*>(out + sw128(8 * j + 2 * t + (e & 1), 4 * r)) =
            d;
      }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (tid == 0) {
      tma_store_2d(&tm_o, stage_out, x0, q0);
      if (x0 + 32 < Bx) tma_store_2d(&tm_o, stage_out + kOutBox, x0 + 32, q0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

template <typename T, int NB>
int launch(const void* q, const void* x, const void* qsq, const void* xsq,
           void* out, int Bq, int Bx, int D, float scale,
           cudaStream_t stream) {
  if (encoder() == nullptr) return kNoEncoder;
  CUtensorMap tq, tx, to;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!encode_2d(&tq, u8, 1, q, Bq, D, kTile, 128) ||
      !encode_2d(&tx, u8, 1, x, Bx, D, kTile, 128) ||
      !encode_2d(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, Bq, Bx, kTile,
                 32))
    return kEncodeFailed;
  constexpr int smem = Smem<NB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      l2dist_q_tc_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long G = (Bq + kTile - 1) / kTile;
  const long long n_tiles = (Bx + kTile - 1) / kTile;
  long long per = sms / G;                    // CTAs a query block
  per = per < 1 ? 1 : per > n_tiles ? n_tiles : per;
  if (G * per > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  l2dist_q_tc_kernel<T, NB>
      <<<static_cast<unsigned int>(G * per), kThreads, smem, stream>>>(
          tq, tx, to, static_cast<const float*>(qsq),
          static_cast<const float*>(xsq), Bq, Bx, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. q [Bq, D] and x [Bx, D] contiguous codes
// of one dtype (1 uint8, 2 int8), 16-byte aligned, D % 16 == 0 and D <=
// 256, Bx % 4 == 0; qsq [Bq] and xsq [Bx] float32; out [Bq, Bx] float32.
// The Python wrapper checked every shape and pointer. Launches on
// `stream`; returns cudaGetLastError() or one of hopper.cuh's codes.
extern "C" int repro_l2dist_q_tc(const void* q, const void* x, const void* qsq,
                                 const void* xsq, void* out, int device,
                                 int Bq, int Bx, int D, int dtype, float scale,
                                 void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0 || Bx == 0) return 0;
  if (D < 16 || D > 256 || D % 16 != 0 || Bx % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = D <= 128;
#define REPRO_L2DIST_Q_TC(T, NB) \
  launch<T, NB>(q, x, qsq, xsq, out, Bq, Bx, D, scale, st)
  switch (dtype) {
    case 1:
      return one ? REPRO_L2DIST_Q_TC(uint8_t, 1)
                 : REPRO_L2DIST_Q_TC(uint8_t, 2);
    case 2:
      return one ? REPRO_L2DIST_Q_TC(int8_t, 1) : REPRO_L2DIST_Q_TC(int8_t, 2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_L2DIST_Q_TC
}

extern "C" const char* repro_l2dist_q_tc_error_string(int err) {
  return hopper::error_string(err);
}

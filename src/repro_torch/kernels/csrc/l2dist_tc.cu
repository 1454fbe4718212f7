// Pairwise distance matrix over float32 rows on Hopper's tensor cores
// (sm_90a): `l2dist` in 3 x TF32 on `wgmma`.
//
// Replaces the TPU kernel `l2dist_pallas` (src/repro/kernels/l2dist.py)
// for float32 queries and rows with D a multiple of 4 up to 128, Bx a
// multiple of 4 and 16-byte aligned bases (TMA's pitch and address rules);
// csrc/l2dist.cu keeps the other shapes and the 8-bit rows (the wrapper,
// kernels/l2dist.py, picks by shape). It computes the function of
// `l2dist_ref`:
//
//   out[q, x] = l2:     (qsq[q] + xsq[x]) - 2 * dot(q, x)   (no clamp)
//               ip:     0 - dot(q, x)
//               cosine: 1 - dot(q, x)
//
// each op rounded on its own, as scan::l2_from_dot does.
//
// The dot product. Each float32 operand splits exactly into two TF32
// pieces: hi = x & 0xffffe000 (the bits the TF32 units read) and lo = x -
// hi (exact in float32), and dot = hi.hi + hi.lo + lo.hi, three `wgmma`
// products into one float32 accumulator (on integer rows its sums read
// bitwise equal to the plain version's at 256 x 1M x 128, so no block of
// products is promoted to the CUDA cores). The dropped lo.lo term and the
// units' reading of lo to 10 bits leave each product within about 3 x
// 2^-20 |q_k x_k|, so |d - d_exact| stays near 3e-6 (qsq + xsq), inside the
// scan's 1e-5 gate. On integer-valued rows up to 2048, lo = 0 and every
// product is exact: the sums are integers, exact below 2^24 in any order,
// so the kernel equals the plain version and the reference bitwise.
//
// What bounds it on this card: at 256 x 1,000,000 x 128 the 1.02 GB output
// and 512 MB of rows (1.54 GB, 0.460 ms at 3.35 TB/s) against 3 x 65.5
// GFLOP at TF32's 495 TFLOP/s (0.397 ms): the bytes, the output first.
//
// The design, against that bound:
// - A persistent CTA holds 64 queries (wgmma's N) and walks 64-row tiles
//   (wgmma's M) with a stride, the CTAs of the query blocks of one row
//   tile neighbours in launch order, so a tile is read from device memory
//   about once and from L2 by the others. Warpgroups 0 and 1 consume
//   alternate tiles; one thread of warpgroup 2 issues TMA copies.
// - TMA stages the queries once and the rows through a ring of two stages
//   a consumer, in boxes of 32 floats (128 bytes, 128-byte swizzle) by 64
//   rows, zeros past D and past Bx. A stage serves one warpgroup only: TMA
//   copies may land out of order, and a warpgroup that waited on a stage
//   another one had used could see a phase it never saw begin as done.
//   The consumers split the queries' box in place into hi and a lo copy
//   beside it: the B operands, K-major in shared memory.
// - The rows are the A operand from registers: each thread reads its
//   m64k8 fragment from the swizzled box and splits it there, one box (4
//   k-steps, 12 products) at a time.
// - The epilogue applies the metric to the [64 rows x 64 queries]
//   accumulator in registers, writes it transposed into a swizzled
//   staging tile and TMA-stores it as two [64 queries x 32 rows] boxes of
//   the [Bq, Bx] output (clipped at Bq and Bx). The store runs while the
//   warpgroup computes its next tile; it waits only before it writes the
//   staging tile again.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "scan_tile.cuh"

namespace {

using namespace hopper;

enum Metric : int { kL2 = 0, kIP = 1, kCosine = 2 };

constexpr int kTile = 64;                 // rows of a tile, queries of a CTA
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = kTile * 128;         // [64][32 floats], one box
constexpr int kStages = 2 * kConsumers;   // stages wg and wg + 2 are wg's

// Shared memory at NB boxes of 32 columns (byte offsets from a 1024-byte
// aligned base).
template <int NB>
struct Smem {
  static constexpr int kQHi = 0;
  static constexpr int kQLo = NB * kBox;
  static constexpr int kRing = 2 * NB * kBox;
  static constexpr int kOut = kRing + kStages * NB * kBox;   // 2 boxes a wg
  static constexpr int kBar = kOut + kConsumers * 2 * kBox;
  // q_full, full[kStages], empty[kStages]; + 1024 to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// The ring stage of a CTA's tile i: warpgroup i % 2 consumes it, and its
// tiles take its two stages in turn.
__device__ __forceinline__ int stage(int i) {
  return i % kConsumers + kConsumers * ((i / kConsumers) % 2);
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
l2dist_tc_kernel(const __grid_constant__ CUtensorMap tm_q,   // [Bq, D]
                 const __grid_constant__ CUtensorMap tm_x,   // [Bx, D]
                 const __grid_constant__ CUtensorMap tm_o,   // [Bq, Bx]
                 const float* __restrict__ qsq,              // [Bq] (l2)
                 const float* __restrict__ xsq,              // [Bx] (l2)
                 int Bq, int Bx, int metric) {
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
        tma_load_2d(base + L::kQHi + b * kBox, &tm_q, q_full, 32 * b, q0);
      for (int i = 0; i < mine; ++i) {
        const int st = stage(i), use = i / kStages;
        mbar_wait(empty + 8 * st, (use & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, NB * kBox);
        const int x0 = (slot + i * P) * kTile;
        for (int b = 0; b < NB; ++b)
          tma_load_2d(base + L::kRing + (st * NB + b) * kBox, &tm_x,
                      full + 8 * st, 32 * b, x0);
      }
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;               // fragment rows r0, r0 + 8

  // split the queries once: hi in place, lo beside it
  mbar_wait(q_full, 0);
  for (int c = threadIdx.x; c < NB * kBox / 16; c += 128 * kConsumers) {
    float4* hp = reinterpret_cast<float4*>(sp + L::kQHi + 16 * c);
    const float4 v = *hp;
    const float4 h = make_float4(__uint_as_float(tf32_hi(v.x)),
                                 __uint_as_float(tf32_hi(v.y)),
                                 __uint_as_float(tf32_hi(v.z)),
                                 __uint_as_float(tf32_hi(v.w)));
    *hp = h;
    *reinterpret_cast<float4*>(sp + L::kQLo + 16 * c) =
        make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
  fence_proxy_async();
  named_sync(1, 128 * kConsumers);

  // the norms of this thread's 16 queries: q0 + 8j + 2t + e
  float qn[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + 8 * j + 2 * t + e;
      qn[j][e] = metric == kL2 && q < Bq ? qsq[q] : 0.f;
    }

  const uint32_t stage_out = base + L::kOut + wg * 2 * kBox;
  for (int i = wg; i < mine; i += kConsumers) {
    const int st = stage(i);
    const int x0 = (slot + i * P) * kTile;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    const unsigned char* tile = sp + L::kRing + st * NB * kBox;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      // a[kk][p]: row r0 + 8 (p & 1), column 8 kk + t + 4 (p >> 1) of box b
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float v = *reinterpret_cast<const float*>(
              tile + b * kBox +
              sw128(r0 + 8 * (p & 1), 4 * (8 * kk + t + 4 * (p >> 1))));
          ahi[kk][p] = tf32_hi(v);
          alo[kk][p] = __float_as_uint(v - __uint_as_float(ahi[kk][p]));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = b * kBox + 32 * kk;
        const uint64_t bhi = desc_sw128(base + L::kQHi + off, 16);
        const uint64_t blo = desc_sw128(base + L::kQLo + off, 16);
        wgmma_tf32(acc, ahi[kk], bhi, b | kk);
        wgmma_tf32(acc, ahi[kk], blo, 1);
        wgmma_tf32(acc, alo[kk], bhi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);

    // epilogue: acc[4j + e] is row r0 + 8 (e / 2), query 8j + 2t + (e % 2)
    float xn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = x0 + r0 + 8 * h;
      xn[h] = metric == kL2 && row < Bx ? xsq[row] : 0.f;
    }
    if (tid == 0) bulk_wait_read();           // the staging tile is free
    named_sync(2 + wg, 128);
    // rows r0 and r0 + 8 lie in box warp / 2 of the staging tile
    unsigned char* out = sp + (stage_out - base) + (warp / 2) * kBox;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dot = acc[4 * j + e];
        const float d =
            metric == kL2 ? scan::l2_from_dot(qn[j][e & 1], xn[e >> 1], dot)
            : metric == kIP ? __fsub_rn(0.f, dot) : __fsub_rn(1.f, dot);
        const int r = (r0 + 8 * (e >> 1)) % 32;
        *reinterpret_cast<float*>(out + sw128(8 * j + 2 * t + (e & 1), 4 * r)) =
            d;
      }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (tid == 0) {
      tma_store_2d(&tm_o, stage_out, x0, q0);
      if (x0 + 32 < Bx) tma_store_2d(&tm_o, stage_out + kBox, x0 + 32, q0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

template <int NB>
int launch(const void* q, const void* x, const void* qsq, const void* xsq,
           void* out, int Bq, int Bx, int D, int metric, cudaStream_t stream) {
  if (encoder() == nullptr) return kNoEncoder;
  CUtensorMap tq, tx, to;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode_2d(&tq, f32, 4, q, Bq, D, kTile, 32) ||
      !encode_2d(&tx, f32, 4, x, Bx, D, kTile, 32) ||
      !encode_2d(&to, f32, 4, out, Bq, Bx, kTile, 32))
    return kEncodeFailed;
  constexpr int smem = Smem<NB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      l2dist_tc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  l2dist_tc_kernel<NB>
      <<<static_cast<unsigned int>(G * per), kThreads, smem, stream>>>(
          tq, tx, to, static_cast<const float*>(qsq),
          static_cast<const float*>(xsq), Bq, Bx, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. q [Bq, D], x [Bx, D], out [Bq, Bx]
// contiguous float32, 16-byte aligned, D % 4 == 0 and D <= 128, Bx % 4 ==
// 0; qsq / xsq [Bq] / [Bx] for l2 (null otherwise). The Python wrapper
// checked every shape and pointer. Launches on `stream`; returns
// cudaGetLastError() or one of hopper.cuh's codes.
extern "C" int repro_l2dist_tc(const void* q, const void* x, const void* qsq,
                               const void* xsq, void* out, int device, int Bq,
                               int Bx, int D, int metric, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0 || Bx == 0) return 0;
  if (D < 4 || D > 128 || D % 4 != 0 || Bx % 4 != 0 || metric < kL2 ||
      metric > kCosine)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch<1>(q, x, qsq, xsq, out, Bq, Bx, D, metric, st);
    case 2: return launch<2>(q, x, qsq, xsq, out, Bq, Bx, D, metric, st);
    case 3: return launch<3>(q, x, qsq, xsq, out, Bq, Bx, D, metric, st);
    default: return launch<4>(q, x, qsq, xsq, out, Bq, Bx, D, metric, st);
  }
}

extern "C" const char* repro_l2dist_tc_error_string(int err) {
  return hopper::error_string(err);
}

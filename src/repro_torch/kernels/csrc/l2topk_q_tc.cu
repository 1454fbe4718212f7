// Fused exact k-nearest scan over 8-bit code rows on Hopper's integer
// tensor cores (sm_90a): `l2topk_q` with u8 / s8 `wgmma` into s32.
//
// Replaces the TPU kernel `l2topk_q_pallas` (src/repro/kernels/qdist.py)
// for queries given as codes of the rows' dtype (uint8 or int8), D a
// multiple of 16 up to 256 and 16-byte aligned bases (TMA's pitch and
// address rules); csrc/l2topk.cu keeps code-valued float32 queries and the
// other shapes (the wrapper, kernels/qdist.py, picks by dtype and shape).
// It computes the function of `l2topk_q_ref`: for each query the k
// smallest of
//
//   d[q, x] = max((qsq[q] + xsq[x]) - 2 * dot(q, x), 0)
//
// as (dists [Bq, k] ascending, ids [Bq, k] int32), selected in code space;
// `out_scale` multiplies the k winners only in the final write. Rows with
// xsq = +inf (padding) never enter a list; ties go to the lower row; a
// slot that no finite row fills holds (+inf, -1).
//
// Exactness. The dot product is an exact int32 sum (at most 255^2 x 256 <
// 2^24 for uint8, 128^2 x 256 for int8), so its float32 value is exact
// and scan::l2_from_dot gives the reference's float32 distance bitwise.
//
// What bounds it on this card: at 256 x 1,000,000 x 128 the 128 MB of
// codes (0.038 ms at 3.35 TB/s; 132 MB with xsq) against 65.5 GOP at
// int8's 1,979 TOP/s (0.033 ms): the bytes. What the design spends beyond
// that is the selection: 256 M distances to filter, and the insertions of
// the rows that pass, which come in bursts at the start of each split.
//
// The design. Pass 1: CTA (g, s) takes 64 queries and one split of the
// rows (S splits of whole 64-row tiles). A CTA is two MMA warpgroups, 16
// selection warps and one producer warp:
// - TMA stages the 64 query codes once and 64-row tiles of codes through
//   a ring of 6 stages, in boxes of 128 bytes (128-byte swizzle; at D =
//   128 one row is one box row) by 64 rows, zeros past D and past Bx.
// - The MMA warpgroups take alternate tiles, each through its own 3
//   stages (TMA copies may land out of order, and a warpgroup that waited
//   on a stage the other had used could take a phase it never saw begin
//   for done). `wgmma` m64n64k32 runs with the rows as A and the queries as
//   B, both K-major in shared memory, 4 k-steps a box into an s32
//   accumulator. The epilogue turns it into float32 distances (xsq loaded a
//   tile ahead, +inf past Bx) and writes them transposed into one of 8 (4
//   at D > 128) [64 queries x 64 rows] distance tiles (rows padded to 68
//   floats: no bank conflicts either way).
// - A selection half-warp holds 2 queries x 64 rows of a distance tile, 4
//   rows a lane, and each query's sorted list lives across its warp's
//   lanes (topk.cuh's WarpList). A row passes the filter if its distance
//   is <= its list's k-th, one compare; a row that passes and comes before
//   the k-th is inserted by rank, as in l2topk.cu. Most tiles end at one
//   vote a warp.
// The warp writes the split's k best to part[q, s, :], and pass 2
// (topk.cuh's merge_splits) merges each query's S lists by rank, in the
// total (distance, row id) order, so the answer does not depend on S.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "scan_tile.cuh"
#include "topk.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;                 // rows of a tile, queries of a CTA
constexpr int kMma = 2;                   // MMA warpgroups, alternate tiles
constexpr int kQH = 2;                    // queries a selection half-warp
constexpr int kSelect = 32 * kTile / (2 * kQH);   // selection threads
constexpr int kThreads = 128 * kMma + kSelect + 32;
constexpr int kBox = kTile * 128;         // [64][128 bytes], one box
constexpr int kStages = 3 * kMma;         // stages w, w + 2, w + 4 are w's
constexpr int kLd = kTile + 4;            // floats a distance-tile row
constexpr int kDistBytes = kTile * kLd * 4;
constexpr int kMaxSplits = 128;

// Shared memory at NB boxes of 128 columns (byte offsets from a 1024-byte
// aligned base).
template <int NB>
struct Smem {
  // distance tiles in flight; tile i takes buffer i % kDistBufs, so MMA
  // warpgroup w fills buffers w, w + 2, ... (8 at D <= 128; 4 above,
  // where the ring's stages are twice as large)
  static constexpr int kDistBufs = NB == 1 ? 4 * kMma : 2 * kMma;
  static constexpr int kQ = 0;
  static constexpr int kRing = NB * kBox;
  static constexpr int kDist = kRing + kStages * NB * kBox;
  static constexpr int kBar = kDist + kDistBufs * kDistBytes;
  // q_full, full[kStages], empty[kStages], dfull[kDistBufs],
  // dempty[kDistBufs]
  static constexpr int kBytes =
      kBar + 8 * (1 + 2 * kStages + 2 * kDistBufs) + 1024;
};

// The ring stage of a CTA's tile i: MMA warpgroup i % 2 consumes it, and
// its tiles take its stages in turn (a stage that two warpgroups shared
// could complete a phase that one of them never saw begin: TMA copies may
// land out of order).
__device__ __forceinline__ int stage(int i) {
  return i % kMma + kMma * ((i / kMma) % (kStages / kMma));
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
l2topk_q_tc_kernel(const __grid_constant__ CUtensorMap tm_q,   // [Bq, D]
                   const __grid_constant__ CUtensorMap tm_x,   // [Bx, D]
                   const float* __restrict__ qsq,              // [Bq]
                   const float* __restrict__ xsq,   // [Bx], +inf on pads
                   float* __restrict__ part_d,                 // [Bq, S, K]
                   int* __restrict__ part_i,                   // [Bq, S, K]
                   int Bq, int Bx, int K, int chunk) {
  using L = Smem<NB>;
  constexpr int kDistBufs = L::kDistBufs;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw);   // generic view
  const uint32_t q_full = base + L::kBar;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;
  const uint32_t dfull = empty + 8 * kStages;
  const uint32_t dempty = dfull + 8 * kDistBufs;

  const int q0 = blockIdx.x * kTile;
  const int s = blockIdx.y, S = gridDim.y;
  const long long lo_ll = static_cast<long long>(s) * chunk;
  const int lo = lo_ll < Bx ? static_cast<int>(lo_ll) : Bx;
  const int hi = static_cast<int>(lo_ll + chunk < Bx ? lo_ll + chunk : Bx);
  const int n = (hi - lo + kTile - 1) / kTile;      // tiles of this split

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4);           // one arrival an MMA warp
    }
    for (int b = 0; b < kDistBufs; ++b) {
      mbar_init(dfull + 8 * b, 1);            // its MMA warpgroup, once
      mbar_init(dempty + 8 * b, kSelect / 32);  // one a selection warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kMma + kSelect) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == 128 * kMma + kSelect) {
      mbar_expect_tx(q_full, NB * kBox);
      for (int b = 0; b < NB; ++b)
        tma_load_2d(base + L::kQ + b * kBox, &tm_q, q_full, 128 * b, q0);
      for (int i = 0; i < n; ++i) {
        const int st = stage(i);
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, NB * kBox);
        for (int b = 0; b < NB; ++b)
          tma_load_2d(base + L::kRing + (st * NB + b) * kBox, &tm_x,
                      full + 8 * st, 128 * b, lo + i * kTile);
      }
    }
    return;
  }

  if (threadIdx.x < 128 * kMma) {
    // ---- MMA warpgroups: products and distances of alternate tiles ----
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * warp + g;             // fragment rows r0, r0 + 8
    float qn[8][2];                           // queries q0 + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * j + 2 * t + e;
        qn[j][e] = q < Bq ? qsq[q] : 0.f;
      }
    // xsq of this thread's rows r0, r0 + 8 of tile i, loaded a tile ahead
    // (+inf past Bx: those rows never enter a list)
    auto row_norms = [&](int i, float (&xn)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lo + i * kTile + r0 + 8 * h;
        xn[h] = i < n && row < Bx ? xsq[row] : CUDART_INF_F;
      }
    };
    float xn[2], xn_next[2];
    row_norms(wg, xn);
    mbar_wait(q_full, 0);
    for (int i = wg; i < n; i += kMma) {
      const int st = stage(i);
      row_norms(i + kMma, xn_next);
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      int acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {   // zeros past D add nothing
        const uint32_t off = (kk / 4) * kBox + 32 * (kk % 4);
        wgmma_i8<T>(acc, desc_sw128(base + L::kRing + st * NB * kBox + off, 16),
                    desc_sw128(base + L::kQ + off, 16), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);

      // acc[4j + e]: row r0 + 8 (e / 2), query q0 + 8j + 2t + (e % 2)
      const int db = i % kDistBufs;
      mbar_wait(dempty + 8 * db, ((i / kDistBufs) & 1) ^ 1);
      float* dist = reinterpret_cast<float*>(sp + L::kDist + db * kDistBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dist[(8 * j + 2 * t + (e & 1)) * kLd + r0 + 8 * (e >> 1)] =
              fmaxf(scan::l2_from_dot(qn[j][e & 1], xn[e >> 1],
                                      __int2float_rn(acc[4 * j + e])),
                    0.f);
      named_sync(1 + wg, 128);
      if (tid == 0) mbar_arrive(dfull + 8 * db);
      xn[0] = xn_next[0];
      xn[1] = xn_next[1];
    }
    return;
  }

  // ---- selection warps ----
  // Half-warp h of selection warp w holds queries qw + kQH h + i (i <
  // kQH), qw = q0 + 2 kQH w, and each of its 16 lanes 4 rows of the tile:
  // thread (ty, tx) takes queries kQH ty + i, rows 4 tx + j. lists[h][i]
  // is query qw + kQH h + i, across the warp's lanes; lk[i] the k-th
  // distance of this lane's query kQH ty + i (-inf past Bq: it takes
  // nothing).
  const int tid = threadIdx.x - 128 * kMma, lane = tid & 31;
  const int tx = tid % 16, ty = tid / 16;
  const int half = lane >> 4;
  const int qw = q0 + (tid >> 5) * 2 * kQH;
  topk::WarpList lists[2][kQH];
  float lk[kQH];
#pragma unroll
  for (int i = 0; i < kQH; ++i) {
    lists[0][i].init();
    lists[1][i].init();
    lk[i] = q0 + kQH * ty + i < Bq ? CUDART_INF_F : -CUDART_INF_F;
  }
  for (int it = 0; it < n; ++it) {
    const int db = it % kDistBufs, x0 = lo + it * kTile;
    mbar_wait(dfull + 8 * db, (it / kDistBufs) & 1);
    const float* dist =
        reinterpret_cast<const float*>(sp + L::kDist + db * kDistBytes);
    float dv[kQH][4];                         // query kQH ty + i, row 4 tx + j
#pragma unroll
    for (int i = 0; i < kQH; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          dist + (kQH * ty + i) * kLd + tx * 4);
      dv[i][0] = v.x;
      dv[i][1] = v.y;
      dv[i][2] = v.z;
      dv[i][3] = v.w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(dempty + 8 * db);   // the tile is in registers
    // a row can enter only at a distance <= its list's k-th (a tie on the
    // distance may still win on the row id); most tiles end here
    bool cand[kQH][4], any = false;
#pragma unroll
    for (int i = 0; i < kQH; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cand[i][j] = dv[i][j] <= lk[i];
        any |= cand[i][j];
      }
    if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
    for (int i = 0; i < kQH; ++i) {
      if (!__any_sync(0xffffffffu, cand[i][0] | cand[i][1] | cand[i][2] |
                                       cand[i][3]))
        continue;
      // insert each candidate that comes before its list's k-th, against
      // the list as it stands (earlier insertions may have lowered it)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned int m = __ballot_sync(0xffffffffu, cand[i][j]) &
                           (h ? 0xffff0000u : 0x0000ffffu);
          while (m) {
            const int l = __ffs(m) - 1;
            m &= m - 1;
            const float val = __shfl_sync(0xffffffffu, dv[i][j], l);
            const int id = x0 + (l & 15) * 4 + j;
            float cd;
            int ci;
            lists[h][i].at(K - 1, cd, ci);
            if (topk::before(val, id, cd, ci))
              lists[h][i].insert(val, id, lane);
          }
        }
        float kd;
        int kid;
        lists[h][i].at(K - 1, kd, kid);
        if (half == h && lk[i] != -CUDART_INF_F) lk[i] = kd;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kQH; ++i) {
      const long long qi = qw + kQH * h + i;
      if (qi >= Bq) continue;                 // uniform across the warp
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

template <typename T, int NB>
int launch(const void* q, const void* x, const void* qsq, const void* xsq,
           void* part_d, void* part_i, void* out_d, void* out_i, int Bq,
           int Bx, int D, int K, int S, float scale, cudaStream_t stream) {
  if (encoder() == nullptr) return kNoEncoder;
  CUtensorMap tq, tx;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!encode_2d(&tq, u8, 1, q, Bq, D, kTile, 128) ||
      !encode_2d(&tx, u8, 1, x, Bx, D, kTile, 128))
    return kEncodeFailed;
  constexpr int smem = Smem<NB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      l2topk_q_tc_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = (static_cast<long long>(Bx) + S - 1) / S;
  const long long chunk = ((per + kTile - 1) / kTile) * kTile;
  if (chunk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Bq + kTile - 1) / kTile, S);
  l2topk_q_tc_kernel<T, NB><<<grid, kThreads, smem, stream>>>(
      tq, tx, static_cast<const float*>(qsq), static_cast<const float*>(xsq),
      static_cast<float*>(part_d), static_cast<int*>(part_i), Bq, Bx, K,
      static_cast<int>(chunk));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(topk::merge_splits<256>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), Bq, S, K, scale,
      stream));
}

}  // namespace

// C interface, bound with ctypes. q [Bq, D] and x [Bx, D] contiguous codes
// of one dtype (1 uint8, 2 int8), 16-byte aligned, D % 16 == 0 and D <=
// 256; qsq [Bq] and xsq [Bx] float32; part_d / part_i [Bq, S, K] hold
// pass 1's lists.
// The Python wrapper checked every shape and pointer. Launches both passes
// on `stream`; returns cudaGetLastError() or one of hopper.cuh's codes.
extern "C" int repro_l2topk_q_tc(const void* q, const void* x, const void* qsq,
                                 const void* xsq, void* part_d, void* part_i,
                                 void* out_d, void* out_i, int device, int Bq,
                                 int Bx, int D, int dtype, int K, int S,
                                 float scale, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0) return 0;
  if (D < 16 || D > 256 || D % 16 != 0 || K < 1 || K > topk::kMaxK ||
      S < 1 || S > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = D <= 128;
#define REPRO_L2TOPK_Q_TC(T, NB)                                             \
  launch<T, NB>(q, x, qsq, xsq, part_d, part_i, out_d, out_i, Bq, Bx, D, K, \
                S, scale, st)
  switch (dtype) {
    case 1:
      return one ? REPRO_L2TOPK_Q_TC(uint8_t, 1)
                 : REPRO_L2TOPK_Q_TC(uint8_t, 2);
    case 2:
      return one ? REPRO_L2TOPK_Q_TC(int8_t, 1) : REPRO_L2TOPK_Q_TC(int8_t, 2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_L2TOPK_Q_TC
}

extern "C" const char* repro_l2topk_q_tc_error_string(int err) {
  return hopper::error_string(err);
}

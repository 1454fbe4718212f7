// Fused exact k-nearest scan over float32 rows on Hopper's tensor cores
// (sm_90a): `l2topk` in 3 x TF32 on `wgmma`.
//
// Replaces the TPU kernel `l2topk_pallas` (src/repro/kernels/l2topk.py)
// for float32 queries and rows with D a multiple of 4 up to 128, at least
// one row, and contiguous operands with 16-byte aligned bases (TMA's pitch
// and address rules; no [Bq, Bx] output is stored, so Bx takes any
// value); csrc/l2topk.cu keeps the other shapes and the 8-bit rows (the
// wrapper, kernels/l2topk.py, picks by dtype and shape). It computes the
// function of `l2topk_ref`: for each query the k smallest of
//
//   d[q, x] = max((qsq[q] + xsq[x]) - 2 * dot(q, x), 0)
//
// each op rounded on its own, as scan::l2_from_dot does, as (dists [Bq, k]
// ascending, ids [Bq, k] int32). Rows with xsq = +inf (padding) never
// enter a list; ties go to the lower row; a slot that no finite row fills
// holds (+inf, -1).
//
// The dot product, as in l2dist_tc.cu: each float32 operand splits
// exactly into TF32 hi = x & 0xffffe000 and lo = x - hi, and dot = hi.hi +
// hi.lo + lo.hi, three `wgmma` products into one float32 accumulator. On
// integer-valued rows up to 2048, lo = 0 and every sum is an integer below
// 2^24, so the kernel equals the plain version and the reference bitwise;
// on float data |d - d_exact| stays near 3e-6 (qsq + xsq), inside the
// scan's 1e-5 gate, and ids differ only at near-ties.
//
// What bounds it on this card: at 256 x 1,000,000 x 128, 3 x 65.5 GFLOP at
// TF32's 495 TFLOP/s (0.397 ms) against 512 MB of rows (0.153 ms at 3.35
// TB/s; the output is Bq * k entries): the operations.
//
// The design: l2dist_tc.cu's products under l2topk_q_tc.cu's selection.
// Pass 1: CTA (g, s) takes 64 queries and one split of the rows (S splits
// of whole 64-row tiles). A CTA is two MMA warpgroups, 16 selection warps
// and a producer warpgroup (896 threads, 72 registers a thread at launch:
// the MMA warps would spill there, and ptxas would serialise their wgmma).
// setmaxnreg moves registers from the producer (to 24) and the selection
// warps (to 64) to the MMA warpgroups (112), whose loop over the k-steps
// is unrolled by two: 0 spills. With 8 selection warps and no setmaxnreg
// (544 threads) the selection took 0.96 of 1.68 ms at k = 10
// (scripts/torch_topk_q_profile.py).
// - TMA stages the 64 queries once and 64-row tiles through a ring of two
//   stages an MMA warpgroup, in boxes of 32 floats (128 bytes, 128-byte
//   swizzle) by 64 rows, zeros past D and past Bx. A stage serves one
//   warpgroup only (TMA copies may land out of order, and a warpgroup that
//   waited on a stage the other had used could take a phase it never saw
//   begin for done).
// - The MMA warpgroups split the queries' boxes in place into hi and a lo
//   copy beside them (the B operands, K-major), then take alternate tiles:
//   each thread reads its m64k8 row fragments from the swizzled box and
//   splits them in registers (the A operand), two k-steps (6 products) at
//   a time to stay within the register budget.
// - The epilogue forms the distances (xsq loaded a tile ahead, +inf past
//   Bx; qsq from shared memory) and writes them transposed into a [64
//   queries x 64 rows] distance tile, unpadded: row r of query q at
//   column r ^ 8 ((q / 2) % 4), so neither the epilogue's writes nor the
//   selection's float4 reads meet a bank conflict.
// - Selection as in l2topk_q_tc.cu: a half-warp holds 2 queries x 64 rows
//   of a tile, 4 rows a lane, and each query's sorted list across its
//   warp's lanes (topk.cuh's WarpList); a row passes the filter if its
//   distance is <= its list's k-th, one compare.
// The warp writes the split's k best to part[q, s, :], and pass 2
// (topk.cuh's merge_splits) merges each query's S lists by rank, in the
// total (distance, row id) order, so the answer does not depend on S.
//
// Shared memory at D = 128 (NB = 4 boxes): queries hi 32,768 + lo 32,768,
// ring 4 stages x 32,768 = 131,072, two distance tiles 2 x 16,384, qsq
// 256, 13 mbarriers 104, and 1,024 to align the base: 230,760 of the
// 232,448 bytes a block may use. l2topk_q_tc.cu's padded tiles (17,408
// bytes each) would not fit beside this ring; at NB <= 3 there is room
// for four tiles.

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
constexpr int kThreads = 128 * kMma + kSelect + 128;   // + the producer
// registers a thread: 72 at launch (65,536 / 896, in steps of 8); the
// producer and the selection warps give what the MMA warpgroups take
// (setmaxnreg.inc takes only what a setmaxnreg.dec of the CTA released)
constexpr int kLaunchRegs = 72, kProducerRegs = 24, kSelectRegs = 64;
constexpr int kMmaRegs = 112;
static_assert(kThreads == 896 &&
                  128 * (kLaunchRegs - kProducerRegs) +
                          kSelect * (kLaunchRegs - kSelectRegs) ==
                      128 * kMma * (kMmaRegs - kLaunchRegs),
              "setmaxnreg must give the MMA warpgroups exactly what the "
              "producer frees");
constexpr int kBox = kTile * 128;         // [64][32 floats], one box
constexpr int kStages = 2 * kMma;         // stages w and w + 2 are w's
constexpr int kDistBytes = kTile * kTile * 4;
constexpr int kMaxSplits = 128;

// Shared memory at NB boxes of 32 columns (byte offsets from a 1024-byte
// aligned base).
template <int NB>
struct Smem {
  // distance tiles in flight; tile i takes buffer i % kDistBufs, so MMA
  // warpgroup w fills buffers w, w + 2, ...
  static constexpr int kDistBufs = NB == 4 ? kMma : 2 * kMma;
  static constexpr int kQHi = 0;
  static constexpr int kQLo = NB * kBox;
  static constexpr int kRing = 2 * NB * kBox;
  static constexpr int kDist = kRing + kStages * NB * kBox;
  static constexpr int kQsq = kDist + kDistBufs * kDistBytes;
  static constexpr int kBar = kQsq + 4 * kTile;
  // q_full, full[kStages], empty[kStages], dfull[kDistBufs],
  // dempty[kDistBufs]; + 1024 to align the base
  static constexpr int kBytes =
      kBar + 8 * (1 + 2 * kStages + 2 * kDistBufs) + 1024;
};
static_assert(Smem<4>::kBytes == 230760 && Smem<4>::kBytes <= 232448,
              "the layout at D = 128 no longer fits a block");

// The ring stage of a CTA's tile i: MMA warpgroup i % 2 consumes it, and
// its tiles take its two stages in turn.
__device__ __forceinline__ int stage(int i) {
  return i % kMma + kMma * ((i / kMma) % (kStages / kMma));
}

// Float index of (query q, row r) in a distance tile: rows of a query are
// contiguous, their 8-row groups permuted by the query's bits 1-2.
__device__ __forceinline__ int dix(int q, int r) {
  return q * kTile + (r ^ ((q & 6) << 2));
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
l2topk_tc_kernel(const __grid_constant__ CUtensorMap tm_q,   // [Bq, D]
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x == 128 * kMma + kSelect) {
      mbar_expect_tx(q_full, NB * kBox);
      for (int b = 0; b < NB; ++b)
        tma_load_2d(base + L::kQHi + b * kBox, &tm_q, q_full, 32 * b, q0);
      for (int i = 0; i < n; ++i) {
        const int st = stage(i);
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, NB * kBox);
        for (int b = 0; b < NB; ++b)
          tma_load_2d(base + L::kRing + (st * NB + b) * kBox, &tm_x,
                      full + 8 * st, 32 * b, lo + i * kTile);
      }
    }
    return;
  }

  if (threadIdx.x < 128 * kMma) {
    // ---- MMA warpgroups: products and distances of alternate tiles ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMmaRegs)
                 : "memory");
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * warp + g;             // fragment rows r0, r0 + 8
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

    // split the queries once: hi in place, lo beside it; their norms
    // beside them (0 past Bq: those queries take nothing)
    mbar_wait(q_full, 0);
    for (int c = threadIdx.x; c < NB * kBox / 16; c += 128 * kMma) {
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
    float* const qn = reinterpret_cast<float*>(sp + L::kQsq);
    if (threadIdx.x < kTile)
      qn[threadIdx.x] = q0 + threadIdx.x < Bq ? qsq[q0 + threadIdx.x] : 0.f;
    fence_proxy_async();
    named_sync(1 + kMma, 128 * kMma);

    for (int i = wg; i < n; i += kMma) {
      const int st = stage(i);
      row_norms(i + kMma, xn_next);
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      const unsigned char* tile = sp + L::kRing + st * NB * kBox;
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll 2
      for (int h = 0; h < 2 * NB; ++h) {      // two k-steps of 8 columns
        const int b = h / 2;
        // a[j][p]: row r0 + 8 (p & 1), column 8 kk + t + 4 (p >> 1) of
        // box b, kk = 2 (h % 2) + j
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int kk = 2 * (h % 2) + j;
            const float v = *reinterpret_cast<const float*>(
                tile + b * kBox +
                sw128(r0 + 8 * (p & 1), 4 * (8 * kk + t + 4 * (p >> 1))));
            ahi[j][p] = tf32_hi(v);
            alo[j][p] = __float_as_uint(v - __uint_as_float(ahi[j][p]));
          }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t off = b * kBox + 32 * (2 * (h % 2) + j);
          const uint64_t bhi = desc_sw128(base + L::kQHi + off, 16);
          const uint64_t blo = desc_sw128(base + L::kQLo + off, 16);
          wgmma_tf32(acc, ahi[j], bhi, h | j);
          wgmma_tf32(acc, ahi[j], blo, 1);
          wgmma_tf32(acc, alo[j], bhi, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);

      // acc[4j + e]: row r0 + 8 (e / 2), query q0 + 8j + 2t + (e % 2)
      const int db = i % kDistBufs;
      mbar_wait(dempty + 8 * db, ((i / kDistBufs) & 1) ^ 1);
      float* dist = reinterpret_cast<float*>(sp + L::kDist + db * kDistBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 qv = *reinterpret_cast<const float2*>(qn + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dist[dix(8 * j + 2 * t + (e & 1), r0 + 8 * (e >> 1))] =
              fmaxf(scan::l2_from_dot(e & 1 ? qv.y : qv.x, xn[e >> 1],
                                      acc[4 * j + e]),
                    0.f);
      }
      named_sync(1 + wg, 128);
      if (tid == 0) mbar_arrive(dfull + 8 * db);
      xn[0] = xn_next[0];
      xn[1] = xn_next[1];
    }
    return;
  }

  // ---- selection warps ----
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kSelectRegs)
               : "memory");
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
          dist + dix(kQH * ty + i, 4 * tx));
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

template <int NB>
int launch(const void* q, const void* x, const void* qsq, const void* xsq,
           void* part_d, void* part_i, void* out_d, void* out_i, int Bq,
           int Bx, int D, int K, int S, cudaStream_t stream) {
  if (encoder() == nullptr) return kNoEncoder;
  CUtensorMap tq, tx;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode_2d(&tq, f32, 4, q, Bq, D, kTile, 32) ||
      !encode_2d(&tx, f32, 4, x, Bx, D, kTile, 32))
    return kEncodeFailed;
  constexpr int smem = Smem<NB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      l2topk_tc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // fewer registers at launch would leave setmaxnreg.inc waiting forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, l2topk_tc_kernel<NB>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != kLaunchRegs) return kRegisterBudget;
  const long long per = (static_cast<long long>(Bx) + S - 1) / S;
  const long long chunk = ((per + kTile - 1) / kTile) * kTile;
  if (chunk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Bq + kTile - 1) / kTile, S);
  l2topk_tc_kernel<NB><<<grid, kThreads, smem, stream>>>(
      tq, tx, static_cast<const float*>(qsq), static_cast<const float*>(xsq),
      static_cast<float*>(part_d), static_cast<int*>(part_i), Bq, Bx, K,
      static_cast<int>(chunk));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(topk::merge_splits<256>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), Bq, S, K, 1.f,
      stream));
}

}  // namespace

// C interface, bound with ctypes. q [Bq, D] and x [Bx, D] contiguous
// float32, 16-byte aligned, D % 4 == 0 and D <= 128, Bx >= 1; qsq [Bq] and
// xsq [Bx] float32; part_d / part_i [Bq, S, K] hold pass 1's lists. The
// Python wrapper checked every shape and pointer. Launches both passes on
// `stream`; returns cudaGetLastError() or one of hopper.cuh's codes.
extern "C" int repro_l2topk_tc(const void* q, const void* x, const void* qsq,
                               const void* xsq, void* part_d, void* part_i,
                               void* out_d, void* out_i, int device, int Bq,
                               int Bx, int D, int K, int S, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0) return 0;
  if (Bx < 1 || D < 4 || D > 128 || D % 4 != 0 || K < 1 ||
      K > topk::kMaxK || S < 1 || S > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
#define REPRO_L2TOPK_TC(NB)                                                  \
  launch<NB>(q, x, qsq, xsq, part_d, part_i, out_d, out_i, Bq, Bx, D, K, S, \
             st)
    case 1: return REPRO_L2TOPK_TC(1);
    case 2: return REPRO_L2TOPK_TC(2);
    case 3: return REPRO_L2TOPK_TC(3);
    default: return REPRO_L2TOPK_TC(4);
#undef REPRO_L2TOPK_TC
  }
}

extern "C" const char* repro_l2topk_tc_error_string(int err) {
  return hopper::error_string(err);
}

// The staging that Hopper's two PQ scan kernels share (csrc/pq_topk_smem.cu,
// the fused k-nearest, and csrc/pq_adc_smem.cu, the distance matrix): the
// CTA's interleaved tables, each warp's ring of TMA bulk-copied code tiles,
// and the per-row lookup of the reference's sum.
//
// - A CTA takes kQ = 128 / M queries (128 KB of tables in shared memory,
//   one CTA an SM). The tables are interleaved, entry (q, m, c) at word
//   (m * 256 + c) * kQ + q, so the kQ lanes of a row, which read one code,
//   fall on kQ distinct banks. Lanes take (query, row) pairs: lane l holds
//   query l % kQ of a step's 32 / kQ rows.
// - Each of the 16 warps streams its tiles' code rows (and xpad) into its
//   own ring of kStages stages with TMA bulk copies, one mbarrier a stage,
//   issued by its lane 0. No stage is shared between warps: TMA copies
//   land out of order, and a warp must never wait on a phase another
//   consumes. A bulk copy moves multiples of 16 bytes, so the xpad rows
//   past Bx rounded down to 4 are read from global memory.
// - A row's distance starts at its xpad (0 when absent) and adds one table
//   entry per subspace, in subspace order, each add rounded on its own
//   (__fadd_rn): the reference's order, so it is bitwise the plain
//   version's. A code byte is a shift and a mask, its scaled offset added
//   to the lane's table base; the subspace offset m * 256 * kQ * 4 is the
//   load's immediate (M is a template argument and the loops unroll).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace pq_stage {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 32;               // rows a bulk copy brings

// The head of both kernels' shared memory for M subspaces: the tables,
// then each warp's code stages, xpad stages and mbarriers. A kernel's own
// buffers start at kEnd (kernels/qdist.py's `pq_*_smem_bytes` mirror it).
template <int M>
struct Ring {
  static constexpr int kQ = 128 / M;        // queries a CTA
  static constexpr int kRows = 32 / kQ;     // rows a warp takes a step
  static constexpr int kStages = M <= 32 ? 3 : 2;
  static constexpr int kTable = kQ * M * 256 * 4;
  static constexpr int kCodeStage = kTileRows * M;
  static constexpr int kXpadStage = kTileRows * 4;
  static constexpr int kCodes = kTable;
  static constexpr int kXpad = kCodes + kWarps * kStages * kCodeStage;
  static constexpr int kBars = kXpad + kWarps * kStages * kXpadStage;
  static constexpr int kEnd = kBars + kWarps * kStages * 8;
};

// One warp's ring: tile j of the warp goes to stage j % kStages.
template <int M>
struct WarpRing {
  using R = Ring<M>;
  uint8_t* code_s;
  float* xpad_s;
  uint32_t bar0;

  __device__ __forceinline__ WarpRing(unsigned char* smem, int warp)
      : code_s(smem + R::kCodes + warp * R::kStages * R::kCodeStage),
        xpad_s(reinterpret_cast<float*>(smem + R::kXpad) +
               warp * R::kStages * kTileRows),
        bar0(hopper::smem_u32(smem + R::kBars) + warp * R::kStages * 8) {}

  // lane 0: the stages' mbarriers, made visible to the async proxy
  __device__ __forceinline__ void init() const {
    for (int st = 0; st < R::kStages; ++st) hopper::mbar_init(bar0 + 8 * st, 1);
    hopper::mbar_fence_init();
  }

  // lane 0: rows [t0, min(t0 + 32, end)) of tile j into its stage, their
  // xpad up to bx4 (Bx rounded down to 4)
  __device__ __forceinline__ void issue(int j, const uint8_t* codes,
                                        const float* xpad, long long t0,
                                        long long end, long long bx4) const {
    const int n = static_cast<int>(min(static_cast<long long>(kTileRows), end - t0));
    const int nx = xpad == nullptr ? 0
        : static_cast<int>(max(0LL, min(static_cast<long long>(n), bx4 - t0)));
    const int st = j % R::kStages;
    const uint32_t bar = bar0 + 8 * st;
    hopper::mbar_expect_tx(bar, n * M + nx * 4);
    hopper::bulk_load(hopper::smem_u32(code_s + st * R::kCodeStage),
                      codes + t0 * M, n * M, bar);
    if (nx > 0)
      hopper::bulk_load(hopper::smem_u32(xpad_s + st * kTileRows), xpad + t0,
                        nx * 4, bar);
  }

  // every lane: wait until tile j has landed
  __device__ __forceinline__ void wait(int j) const {
    hopper::mbar_wait(bar0 + 8 * (j % R::kStages), (j / R::kStages) & 1);
  }

  __device__ __forceinline__ const uint8_t* codes(int j) const {
    return code_s + (j % R::kStages) * R::kCodeStage;
  }

  __device__ __forceinline__ const float* xpad(int j) const {
    return xpad_s + (j % R::kStages) * kTileRows;
  }
};

// The CTA's tables [kQ, M, 256] from luts [Bq, M, 256], interleaved, zeros
// past Bq. Every thread of the CTA calls it; the caller syncs after.
template <int M>
__device__ __forceinline__ void load_tables(const float* __restrict__ luts,
                                            float* lut_s, int q0, int Bq,
                                            int tid) {
  constexpr int kQ = Ring<M>::kQ;
  for (int e = tid; e < M * 256; e += kThreads) {
    float v[kQ];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi)
      v[qi] = q0 + qi < Bq
                  ? __ldg(luts + static_cast<long long>(q0 + qi) * (M * 256) + e)
                  : 0.f;
    if constexpr (kQ >= 4) {
#pragma unroll
      for (int qi = 0; qi < kQ; qi += 4)
        *reinterpret_cast<float4*>(lut_s + e * kQ + qi) =
            make_float4(v[qi], v[qi + 1], v[qi + 2], v[qi + 3]);
    } else {
      *reinterpret_cast<float2*>(lut_s + e * kQ) = make_float2(v[0], v[1]);
    }
  }
}

// A row's start: its xpad (staged below bx4, from global memory from bx4 to
// end), 0 without xpad or past end.
__device__ __forceinline__ float row_start(const float* xs,
                                           const float* __restrict__ xpad,
                                           int r, long long row, long long bx4,
                                           long long end) {
  if (xpad == nullptr) return 0.f;
  return row < bx4 ? xs[r] : row < end ? __ldg(xpad + row) : 0.f;
}

// acc + lut[q, 0, c0] + ... + lut[q, M-1, cM-1] in subspace order, over the
// row's M staged code bytes; lq is the lane's table base (lut_s + q).
template <int M>
__device__ __forceinline__ float adc_row(const uint8_t* row_codes,
                                         const float* lq, float acc) {
  constexpr int kQ = Ring<M>::kQ;
  const uint4* cw = reinterpret_cast<const uint4*>(row_codes);
#pragma unroll
  for (int v = 0; v < M / 16; ++v) {
    const uint4 w4 = cw[v];
    const unsigned int w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int m = 16 * v + 4 * h + b;
        const int c = static_cast<int>((w[h] >> (8 * b)) & 0xffu);
        acc = __fadd_rn(acc, lq[(m * 256 + c) * kQ]);
      }
  }
  return acc;
}

}  // namespace pq_stage

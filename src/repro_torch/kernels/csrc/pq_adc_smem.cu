// PQ ADC distance matrix for Hopper (sm_90a), redesigned: `pq_adc` with
// queries across lanes and the code rows staged by TMA bulk copies.
//
// Replaces the TPU kernel `pq_adc_pallas` (src/repro/kernels/qdist.py)
// for M in {16, 32, 64} subspaces and 16-byte aligned codes (and xpad);
// csrc/qdist.cu keeps the other shapes (the wrapper, kernels/qdist.py
// `pq_adc_route`, picks by shape). It computes the function of
// `pq_adc_ref`:
//
//   d[q, x] = xpad[x] + lut[q, 0, code[x, 0]] + ... + lut[q, M-1, code[x, M-1]]
//
// over luts [Bq, M, 256] float32, codes [Bx, M] uint8 and xpad [Bx] float32
// (+inf marks a padding row; 0 when absent), as d [Bq, Bx] float32. The sum
// starts at xpad and adds one table entry per subspace, in subspace order,
// each add rounded on its own (__fadd_rn): the reference's order, so the
// matrix is bitwise the plain version's on any input. Ragged Bq and Bx are
// masked, not padded.
//
// What bounds it on this card: the shared-memory lookups, Bq * Bx * M of
// them at data-dependent addresses. At 256 x 32,768 x 16 that is 134 M
// lookups, 0.016 ms at 32 a clock on 132 SMs at 1.98 GHz, against 38 MB
// of compulsory traffic, mostly the 33.5 MB output (0.011 ms); at 256 x
// 1,000,000 x 16, 4.1 G lookups (0.490 ms) against 1.04 GB (0.312 ms).
// scripts/torch_pq_adc_profile.py splits the measured time by variants of
// this source: the bank conflicts and the stores are small shares; the
// work around the lookups (byte extraction, the dependent adds, which the
// reference's order forbids reassociating) and the lookups' own issue
// take the rest.
//
// The design is csrc/pq_topk_smem.cu's with the selection taken out and
// the matrix written back; the staging both share is csrc/pq_stage.cuh's.
// CTA (s, g) takes kQ = 128 / M queries and its 16 warps take 32-row
// tiles in turn, warp w of CTA s the tiles s * 16 + w + j * 16 * S.
// - Lanes take (query, row) pairs over the interleaved tables: 2.10
//   wavefronts a lookup instruction at M = 16 against 3.15 for qdist.cu's
//   32 rows of one query. Extracting a code byte with one PRMT instead of
//   a shift and a mask measured the same within 1%
//   (scripts/torch_pq_adc_profile.py).
// - A tile's [kQ, 32] distances go to the warp's staging buffer in shared
//   memory (a pitch of 32 + 32 / kQ words, so a step's 32 lanes hit 32
//   banks), then each query's 32 distances leave as one 128-byte row
//   segment of out[q, x0 : x0 + 32], 32 lanes on consecutive words.

#include <cstdint>

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "pq_stage.cuh"

namespace {

using pq_stage::kThreads;
using pq_stage::kTileRows;
using pq_stage::kWarps;

// Shared-memory layout for M subspaces (kernels/qdist.py
// `pq_adc_smem_bytes` mirrors it): pq_stage's ring, then each warp's
// staged distances.
template <int M>
struct Layout : pq_stage::Ring<M> {
  using R = pq_stage::Ring<M>;
  static constexpr int kPitch = kTileRows + R::kRows;   // staged words a query
  static constexpr int kOut = R::kEnd;
  static constexpr int kBytes = kOut + kWarps * R::kQ * kPitch * 4;
};

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
pq_adc_smem_kernel(const float* __restrict__ luts,      // [Bq, M, 256]
                   const uint8_t* __restrict__ codes,   // [Bx, M]
                   const float* __restrict__ xpad,      // [Bx] or null
                   float* __restrict__ out,             // [Bq, Bx]
                   int Bq, int Bx) {
  using L = Layout<M>;
  constexpr int kQ = L::kQ, kRows = L::kRows;
  constexpr int kStages = L::kStages, kPitch = L::kPitch;
  extern __shared__ __align__(128) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQ;
  const long long n_tiles = (static_cast<long long>(Bx) + kTileRows - 1) / kTileRows;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const int my_tiles =
      first < n_tiles ? static_cast<int>((n_tiles - first + stride - 1) / stride) : 0;
  const long long bx = Bx, bx4 = bx & ~3LL;
  const pq_stage::WarpRing<M> ring(smem, warp);
  float* stage = reinterpret_cast<float*>(smem + L::kOut) + warp * kQ * kPitch;
  auto tile_row = [&](int j) { return (first + j * stride) * kTileRows; };

  if (lane == 0) {
    ring.init();
    for (int j = 0; j < kStages && j < my_tiles; ++j)
      ring.issue(j, codes, xpad, tile_row(j), bx, bx4);
  }
  // the CTA's tables; overlaps the first copies
  pq_stage::load_tables<M>(luts, lut_s, q0, Bq, tid);
  __syncthreads();

  const int qi = lane % kQ;                 // this lane's query
  const int rl = lane / kQ;                 // and its row within a step
  const float* lq = lut_s + qi;
  const int n_queries = min(kQ, Bq - q0);

  for (int j = 0; j < my_tiles; ++j) {
    const long long t0 = tile_row(j);
    const int n = static_cast<int>(min(static_cast<long long>(kTileRows), bx - t0));
    ring.wait(j);
    const uint8_t* cs = ring.codes(j);
    const float* xs = ring.xpad(j);
#pragma unroll
    for (int step = 0; step < kQ; ++step) { // kQ steps of kRows rows: 32 rows
      const int r = step * kRows + rl;
      // rows past Bx read stale codes (in range) and are never written
      stage[qi * kPitch + r] = pq_stage::adc_row<M>(
          cs + r * M, lq, pq_stage::row_start(xs, xpad, r, t0 + r, bx4, bx));
    }
    __syncwarp();
    // every lane has read the code stage: it may take tile j + kStages
    if (lane == 0 && j + kStages < my_tiles) {
      hopper::fence_proxy_async();
      ring.issue(j + kStages, codes, xpad, tile_row(j + kStages), bx, bx4);
    }
    // each query's 32 distances as one row segment
    if (lane < n) {
      float* o = out + static_cast<long long>(q0) * bx + t0 + lane;
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (q < n_queries) o[q * bx] = stage[q * kPitch + lane];
    }
    __syncwarp();                           // before the next tile's steps
  }
}

template <int M>
int launch(const void* luts, const void* codes, const void* xpad, void* out,
           int Bq, int Bx, int S, cudaStream_t stream) {
  using L = Layout<M>;
  cudaError_t err = cudaFuncSetAttribute(
      pq_adc_smem_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S, (Bq + L::kQ - 1) / L::kQ);
  pq_adc_smem_kernel<M><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(xpad), static_cast<float*>(out), Bq, Bx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. M in {16, 32, 64}; S CTAs along the rows
// of each query group. The Python wrapper checked every shape, alignment
// and pointer. Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_pq_adc_smem(const void* luts, const void* codes,
                                 const void* xpad, void* out, int device,
                                 int Bq, int Bx, int M, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0) return 0;
  if (Bx < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 16: return launch<16>(luts, codes, xpad, out, Bq, Bx, S, st);
    case 32: return launch<32>(luts, codes, xpad, out, Bq, Bx, S, st);
    case 64: return launch<64>(luts, codes, xpad, out, Bq, Bx, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a CTA at M subspaces (0 for an M it refuses).
extern "C" int repro_pq_adc_smem_bytes(int M) {
  switch (M) {
    case 16: return Layout<16>::kBytes;
    case 32: return Layout<32>::kBytes;
    case 64: return Layout<64>::kBytes;
    default: return 0;
  }
}

extern "C" const char* repro_pq_adc_smem_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

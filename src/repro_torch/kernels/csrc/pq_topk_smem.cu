// Fused PQ ADC k-nearest scan for Hopper (sm_90a), redesigned: `pq_topk`
// with the lists in registers, queries across lanes and the code rows
// staged by TMA bulk copies.
//
// Replaces the TPU kernel `pq_topk_pallas` (src/repro/kernels/qdist.py)
// for M in {16, 32, 64} subspaces and 16-byte aligned codes (and xpad);
// csrc/qdist.cu keeps the other shapes (the wrapper, kernels/qdist.py
// `pq_topk_route`, picks by shape). It computes the function of
// `pq_topk_ref`: for each query the k smallest of
//
//   d[q, x] = xpad[x] + lut[q, 0, code[x, 0]] + ... + lut[q, M-1, code[x, M-1]]
//
// as (dists [Bq, k] ascending, ids [Bq, k] int32). The sum starts at xpad
// (0 when absent) and adds one table entry per subspace, in subspace
// order, each add rounded on its own (__fadd_rn): the reference's order,
// so the result is bitwise the plain version's on any input. The order is
// by distance, then by row id (the lower row wins a tie); +inf and NaN
// rows never enter a list; a slot that nothing fills holds (+inf, -1).
//
// What bounds it on this card: the shared-memory lookups, Bq * Bx * M of
// them at data-dependent addresses. At 256 x 32,768 x 16 that is 134 M
// lookups, 0.016 ms at 32 a clock on 132 SMs at 1.98 GHz, against 4.7 MB
// of compulsory traffic (0.0014 ms) and 134 M float adds (0.002 ms); at
// 256 x 1,000,000 x 16, 4.1 G lookups, 0.490 ms.
//
// The design. Pass 1: CTA (s, g) takes kQ = 128 / M queries and split s
// of the rows, in 32-row tiles; 16 warps take the tiles in turn. The
// tables, the warps' rings of code tiles and the per-row lookup are
// csrc/pq_stage.cuh's, which csrc/pq_adc_smem.cu shares.
// - Lanes take (query, row) pairs over the interleaved tables, so two
//   rows collide only where their codes agree modulo 32 / kQ. Expected
//   shared-memory wavefronts a lookup instruction (a simulation over
//   random codes): 2.10 at M = 16 (kQ = 8), 2.54 at M = 32, 2.92 at
//   M = 64, against 3.15 for 32 lanes on 32 rows of one query (qdist.cu's
//   layout).
// - Each warp keeps one sorted list a query across its lanes, in
//   registers (topk.cuh's WarpList), and a lane keeps its query's k-th. A
//   step's 32 distances take one ballot against those; after the first
//   tiles most steps end there. A distance that passes is not inserted
//   at once: it goes to its (warp, query) buffer of 32 in shared memory,
//   at its place among the step's passing lanes of that query. When a
//   buffer has no room for another step's rows (and at the end), the
//   warp merges every buffer into its list by ranks (merge_buffer), all
//   lanes at once, and takes the new k-ths. Inserting each passing
//   distance at once (a ballot, a shift of shuffles and the k-th's
//   refresh, each waiting on the last) took more time than the lookups
//   at the exact PQ path's 32,768 rows; scripts/torch_pq_topk_profile.py
//   times that selection beside this one.
// - At the end the tables' shared memory holds the 16 warps' lists; each
//   entry's rank among a query's 16 lists is its place in its own list
//   plus a binary search in each other list, and the entries of rank < k
//   go to part[q, s, :].
// Pass 2, topk.cuh's merge_splits, merges each query's S lists by rank.
// The order is total, so the answer depends on neither the warps nor S.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "pq_stage.cuh"
#include "topk.cuh"

namespace {

using pq_stage::kThreads;
using pq_stage::kTileRows;
using pq_stage::kWarps;
constexpr int kMaxK = topk::kMaxK;
constexpr int kMaxSplits = 32;
constexpr int kBuffered = 32;               // candidates a (warp, query) holds
constexpr unsigned int kFull = 0xffffffffu;

// Shared-memory layout for M subspaces (kernels/qdist.py
// `pq_topk_smem_bytes` mirrors it): pq_stage's ring, then the warps'
// counts, candidate buffers and merge scratch.
template <int M>
struct Layout : pq_stage::Ring<M> {
  using R = pq_stage::Ring<M>;
  static constexpr int kCounts = R::kEnd;
  static constexpr int kBuffers = kCounts + R::kQ * kWarps * 4;
  static constexpr int kScratch = kBuffers + kWarps * R::kQ * kBuffered * 8;
  static constexpr int kBytes = kScratch + kWarps * kMaxK * 8;
  static_assert(R::kQ * kWarps * kMaxK * 8 <= R::kTable,
                "merge lists fit the tables");
};

// Merge one warp's n buffered candidates (each before the list's k-th)
// into its sorted list: each candidate's rank is the list entries before
// it (a binary search) plus the candidates before it, each list entry's
// its position plus the candidates before it; the K first ranks are
// written to `scratch` and read back into the list. Every lane of the
// warp calls it with the same arguments.
__device__ __forceinline__ void merge_buffer(topk::WarpList& list,
                                             const int2* buf, int n,
                                             int2* scratch, int K, int lane) {
  if (lane < K) scratch[lane] = make_int2(__float_as_int(list.d0), list.i0);
  if (lane + 32 < K)
    scratch[lane + 32] = make_int2(__float_as_int(list.d1), list.i1);
  const int valid =
      __popc(__ballot_sync(kFull, lane < K && list.i0 >= 0)) +
      __popc(__ballot_sync(kFull, lane + 32 < K && list.i1 >= 0));
  __syncwarp();
  float bd = 0.f;
  int bi = -1, rb = 0;
  if (lane < n) {
    const int2 e = buf[lane];
    bd = __int_as_float(e.x);
    bi = e.y;
    int a = 0, b = valid;
    while (a < b) {
      const int mid = (a + b) >> 1;
      const int2 f = scratch[mid];
      if (topk::before(__int_as_float(f.x), f.y, bd, bi)) a = mid + 1;
      else b = mid;
    }
    rb = a;
  }
  int r0 = lane, r1 = lane + 32;
  for (int o = 0; o < n; ++o) {
    const int2 f = buf[o];
    const float fd = __int_as_float(f.x);
    rb += topk::before(fd, f.y, bd, bi);
    r0 += topk::before(fd, f.y, list.d0, list.i0);
    if (K > 32) r1 += topk::before(fd, f.y, list.d1, list.i1);
  }
  __syncwarp();                             // every read of the old list done
  if (lane < valid && r0 < K)
    scratch[r0] = make_int2(__float_as_int(list.d0), list.i0);
  if (lane + 32 < valid && r1 < K)
    scratch[r1] = make_int2(__float_as_int(list.d1), list.i1);
  if (lane < n && rb < K) scratch[rb] = make_int2(__float_as_int(bd), bi);
  const int filled = min(valid + n, K);
  __syncwarp();
  const int2 e0 = lane < filled ? scratch[lane] : make_int2(0, -1);
  const int2 e1 = lane + 32 < filled ? scratch[lane + 32] : make_int2(0, -1);
  list.d0 = lane < filled ? __int_as_float(e0.x) : CUDART_INF_F;
  list.i0 = e0.y;
  list.d1 = lane + 32 < filled ? __int_as_float(e1.x) : CUDART_INF_F;
  list.i1 = e1.y;
  __syncwarp();                             // before the scratch is reused
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
pq_topk_smem_kernel(const float* __restrict__ luts,      // [Bq, M, 256]
                    const uint8_t* __restrict__ codes,   // [Bx, M]
                    const float* __restrict__ xpad,      // [Bx] or null
                    float* __restrict__ part_d,          // [Bq, S, K]
                    int* __restrict__ part_i,            // [Bq, S, K]
                    int Bq, int Bx, int K, int chunk) {
  using L = Layout<M>;
  constexpr int kQ = L::kQ, kRows = L::kRows, kStages = L::kStages;
  // the lanes that hold query 0 (lane % kQ == 0); << q gives query q's
  constexpr unsigned int kQueryLanes =
      kQ == 8 ? 0x01010101u : kQ == 4 ? 0x11111111u : 0x55555555u;
  extern __shared__ __align__(128) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  int* counts = reinterpret_cast<int*>(smem + L::kCounts);   // [kQ, kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, S = gridDim.x;
  const int q0 = blockIdx.y * kQ;
  const long long lo = static_cast<long long>(s) * chunk;
  const long long hi = min(static_cast<long long>(Bx), lo + chunk);
  const int n_tiles =
      lo < hi ? static_cast<int>((hi - lo + kTileRows - 1) / kTileRows) : 0;
  const int my_tiles =
      warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const long long bx4 = static_cast<long long>(Bx) & ~3LL;
  const pq_stage::WarpRing<M> ring(smem, warp);
  auto tile_row = [&](int j) {
    return lo + static_cast<long long>(warp + j * kWarps) * kTileRows;
  };

  if (lane == 0) {
    ring.init();
    for (int j = 0; j < kStages && j < my_tiles; ++j)
      ring.issue(j, codes, xpad, tile_row(j), hi, bx4);
  }
  // the CTA's tables; overlaps the first copies
  pq_stage::load_tables<M>(luts, lut_s, q0, Bq, tid);
  __syncthreads();

  const int qi = lane % kQ;                 // this lane's query
  const int rl = lane / kQ;                 // and its row within a step
  const float* lq = lut_s + qi;
  const unsigned int below = (1u << lane) - 1u;
  const unsigned int my_lanes = kQueryLanes << qi;
  int2* buf = reinterpret_cast<int2*>(smem + L::kBuffers) + warp * kQ * kBuffered;
  int2* scratch = reinterpret_cast<int2*>(smem + L::kScratch) + warp * kMaxK;
  topk::WarpList lists[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) lists[q].init();
  float kd = CUDART_INF_F;                  // this lane's query's k-th
  int ki = -1;
  int held = 0;                             // its buffered candidates

  // every query's buffer into its list, each list named at compile time
  auto merge_all = [&]() {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int n = __shfl_sync(kFull, held, q);   // lane q holds query q
      if (n == 0) continue;                 // uniform across the warp
      merge_buffer(lists[q], buf + q * kBuffered, n, scratch, K, lane);
      float a;
      int b;
      lists[q].at(K - 1, a, b);
      if (q == qi) { kd = a; ki = b; }
    }
    held = 0;
  };

  for (int j = 0; j < my_tiles; ++j) {
    const long long t0 = tile_row(j);
    ring.wait(j);
    const uint8_t* cs = ring.codes(j);
    const float* xs = ring.xpad(j);
#pragma unroll 2
    for (int step = 0; step < kTileRows / kRows; ++step) {
      const int r = step * kRows + rl;
      const long long row = t0 + r;
      const float acc = pq_stage::adc_row<M>(
          cs + r * M, lq, pq_stage::row_start(xs, xpad, r, row, bx4, hi));
      const float d = row < hi ? acc : CUDART_INF_F;
      const int id = static_cast<int>(row);
      const bool in = topk::before(d, id, kd, ki);
      const unsigned int pass = __ballot_sync(kFull, in);
      if (pass == 0u) continue;             // uniform across the warp
      // each passing distance goes to its query's buffer, at its place
      // among the query's passing lanes
      if (in)
        buf[qi * kBuffered + held + __popc(pass & my_lanes & below)] =
            make_int2(__float_as_int(d), id);
      held += __popc(pass & my_lanes);
      // a buffer without room for another step's rows: merge them all
      if (__any_sync(kFull, held > kBuffered - kRows)) merge_all();
    }
    __syncwarp();
    // every lane has read the stage: it may take tile j + kStages
    if (lane == 0 && j + kStages < my_tiles) {
      hopper::fence_proxy_async();
      ring.issue(j + kStages, codes, xpad, tile_row(j + kStages), hi, bx4);
    }
  }
  if (__any_sync(kFull, held > 0)) merge_all();

  // the warps' lists -> shared memory (over the tables), with their counts
  __syncthreads();
  float* cand_d = lut_s;                                   // [kQ, kWarps, kMaxK]
  int* cand_i = reinterpret_cast<int*>(lut_s + kQ * kWarps * kMaxK);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int base = (q * kWarps + warp) * kMaxK;
    if (lane < K) { cand_d[base + lane] = lists[q].d0; cand_i[base + lane] = lists[q].i0; }
    if (lane + 32 < K) {
      cand_d[base + lane + 32] = lists[q].d1;
      cand_i[base + lane + 32] = lists[q].i1;
    }
    const int valid =
        __popc(__ballot_sync(kFull, lane < K && lists[q].i0 >= 0)) +
        __popc(__ballot_sync(kFull, lane + 32 < K && lists[q].i1 >= 0));
    if (lane == 0) counts[q * kWarps + warp] = valid;
  }
  __syncthreads();

  // each entry at its rank among its query's kWarps lists (ids are unique)
  for (int c = tid; c < kQ * kWarps * K; c += kThreads) {
    const int q = c / (kWarps * K), w = (c / K) % kWarps, j = c % K;
    if (q0 + q >= Bq || j >= counts[q * kWarps + w]) continue;
    const float d = cand_d[(q * kWarps + w) * kMaxK + j];
    const int id = cand_i[(q * kWarps + w) * kMaxK + j];
    int rank = j;
    for (int w2 = 0; w2 < kWarps && rank < K; ++w2) {
      if (w2 == w) continue;
      const float* ld = cand_d + (q * kWarps + w2) * kMaxK;
      const int* li = cand_i + (q * kWarps + w2) * kMaxK;
      int a = 0, b = counts[q * kWarps + w2];   // entries before (d, id)
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (topk::before(ld[mid], li[mid], d, id)) a = mid + 1;
        else b = mid;
      }
      rank += a;
    }
    if (rank < K) {
      const long long o = (static_cast<long long>(q0 + q) * S + s) * K + rank;
      part_d[o] = d;
      part_i[o] = id;
    }
  }
  for (int c = tid; c < kQ * K; c += kThreads) {        // slots no entry fills
    const int q = c / K, j = c % K;
    if (q0 + q >= Bq) continue;
    int valid = 0;
    for (int w = 0; w < kWarps; ++w) valid += counts[q * kWarps + w];
    if (j >= valid) {
      const long long o = (static_cast<long long>(q0 + q) * S + s) * K + j;
      part_d[o] = CUDART_INF_F;
      part_i[o] = -1;
    }
  }
}

template <int M>
int launch(const void* luts, const void* codes, const void* xpad, void* part_d,
           void* part_i, void* out_d, void* out_i, int Bq, int Bx, int K, int S,
           int chunk, cudaStream_t stream) {
  using L = Layout<M>;
  cudaError_t err = cudaFuncSetAttribute(
      pq_topk_smem_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S, (Bq + L::kQ - 1) / L::kQ);
  pq_topk_smem_kernel<M><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(xpad), static_cast<float*>(part_d),
      static_cast<int*>(part_i), Bq, Bx, K, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(topk::merge_splits<256>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), Bq, S, K, 1.f,
      stream));
}

}  // namespace

// C interface, bound with ctypes. M in {16, 32, 64}; S splits of `chunk`
// rows each (a multiple of 32; the last may be short). The Python wrapper
// checked every shape, alignment and pointer. Launches both passes on
// `stream` and returns cudaGetLastError().
extern "C" int repro_pq_topk_smem(const void* luts, const void* codes,
                                  const void* xpad, void* part_d, void* part_i,
                                  void* out_d, void* out_i, int device, int Bq,
                                  int Bx, int M, int K, int S, int chunk,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bq == 0) return 0;
  if (Bx < 1 || K < 1 || K > kMaxK || S < 1 || S > kMaxSplits ||
      chunk % kTileRows != 0 || static_cast<long long>(S) * chunk < Bx)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 16: return launch<16>(luts, codes, xpad, part_d, part_i, out_d, out_i,
                               Bq, Bx, K, S, chunk, st);
    case 32: return launch<32>(luts, codes, xpad, part_d, part_i, out_d, out_i,
                               Bq, Bx, K, S, chunk, st);
    case 64: return launch<64>(luts, codes, xpad, part_d, part_i, out_d, out_i,
                               Bq, Bx, K, S, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a CTA at M subspaces (0 for an M it refuses).
extern "C" int repro_pq_topk_smem_bytes(int M) {
  switch (M) {
    case 16: return Layout<16>::kBytes;
    case 32: return Layout<32>::kBytes;
    case 64: return Layout<64>::kBytes;
    default: return 0;
  }
}

extern "C" const char* repro_pq_topk_smem_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

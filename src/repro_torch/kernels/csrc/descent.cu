// Greedy descent of the HNSW upper layers (ef 1) for Hopper (sm_90a): every
// query lane, every upper layer and every hop in one launch.
//
// Replaces no Pallas kernel: the reference runs this descent as one
// `lax.while_loop` on the device (src/repro/core/search.py:212-259,
// `_greedy_upper`), with no round trip to the host. Its plain PyTorch
// version is kernels/descent.py `greedy_upper`: lockstep torch ops over
// all lanes, a host sync a hop.
// This kernel computes exactly what that loop computes, lane by lane:
//
//   * lane l searches partition l / B for query l % B;
//   * the entry point's distance first (`calcs` starts at 1);
//   * layers n_layers .. 1, skipping those above the partition's
//     max_level; on each, up to `upper_hops` hops: score the current
//     node's upper-layer neighbour row (an id of -1, or a node without an
//     upper row, is invalid), add the valid count to `calcs`, take the
//     first minimum (argmin's rule: a NaN first, then the lowest distance,
//     then the lowest slot) and move only if it is strictly below the
//     current distance, else leave the layer;
//   * it writes (cur, cur_d, calcs) for every lane.
//
// Distances are `metric_dist`'s (traversal_async.cu): __fmul_rn /
// __fsub_rn / __fadd_rn, then the clamp. On 8-bit rows every dot product
// is an exact integer below 2^24, so the kernel equals the plain version
// bitwise; on float32 rows it does wherever the products and their sums
// are exact (integer-valued rows), as the layer-0 kernels do.
//
// What bounds it on this card: neither bytes nor operations (the cell's
// upper-layer rows are ~8 MB, L2-resident) but a chain of dependent loads,
// hop after hop. One warp takes one lane for its whole walk, so a hop costs
// two dependent round trips and no barrier across warps:
//
// 1. The neighbour row: lane i of the warp loads neighbour i of a tile of
//    16 (rows wider than 16 are taken tile by tile).
// 2. In one round, everything the tile's ids name: owner lane i loads its
//    neighbour's sqnorm and its upper-row index `up_ptr` (so the next
//    hop's row is known as soon as the argmin is), and the warp loads the
//    16 rows, 16 bytes a thread: a group of 8 threads a row, each taking
//    every 8th 16-byte chunk, 4 rows a pass, all passes issued at once
//    (up to kNB 128-byte blocks of each row in flight).
// 3. Each group sums its row by __shfl_xor_sync, owner lane i takes row
//    i's dot product and distance, and a butterfly of shuffles leaves the
//    tile's first minimum on every lane: the decision to move is uniform
//    and needs no memory.
//
// The query is staged once a walk in the warp's slice of shared memory, in
// the order the chunks read it (8-bit rows: the four float4 under chunk c
// at j * nch + c, as traversal_async.cu's SmemDot8), so the 8 threads of a
// group read consecutive float4s. 8 warps (lanes) a CTA.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;                    // lanes a CTA, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;                    // threads a row, 16 bytes each
constexpr int kRowsPerPass = 32 / kGroup;    // 4
constexpr int kPasses = 4;
constexpr int kTile = kRowsPerPass * kPasses;  // 16 neighbours a tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;

enum Metric : int { kL2 = 0, kIP = 1, kCosine = 2 };

// Byte j of a little-endian 32-bit word as float32: uint8 zero-extended,
// int8 sign-extended.
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

// Float32 rows: 16-byte chunk c holds elements 4c..4c+3, beside query
// chunk c.
template <typename T>
struct ChunkDot {
  static __device__ void stage(float4* qs, const float* q, int D, int t) {
    for (int i = t; i < D / 4; i += 32)
      qs[i] = __ldg(reinterpret_cast<const float4*>(q) + i);
  }
  static __device__ __forceinline__ void add(float& acc, uint4 x,
                                             const float4* qs, int nch,
                                             int c) {
    const float4 b = qs[c];
    acc += __uint_as_float(x.x) * b.x + __uint_as_float(x.y) * b.y +
           __uint_as_float(x.z) * b.z + __uint_as_float(x.w) * b.w;
  }
};

// 8-bit code rows: chunk c holds 16 codes; the four float4 of the query
// values under it sit at j * nch + c (j = 0..3).
template <typename T>
struct ChunkDot8 {
  static __device__ void stage(float4* qs, const float* q, int D, int t) {
    const int nch = D / 16;
    for (int i = t; i < D / 4; i += 32)
      qs[(i & 3) * nch + (i >> 2)] =
          __ldg(reinterpret_cast<const float4*>(q) + i);
  }
  static __device__ __forceinline__ void add(float& acc, uint4 x,
                                             const float4* qs, int nch,
                                             int c) {
    const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 y = qs[j * nch + c];
      acc += code_at<T>(w[j], 0) * y.x + code_at<T>(w[j], 1) * y.y +
             code_at<T>(w[j], 2) * y.z + code_at<T>(w[j], 3) * y.w;
    }
  }
};

template <>
struct ChunkDot<uint8_t> : ChunkDot8<uint8_t> {};

template <>
struct ChunkDot<int8_t> : ChunkDot8<int8_t> {};

__device__ __forceinline__ float metric_dist(int metric, float dot, float xsq,
                                             float qsq) {
  if (metric == kL2) {
    const float d = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, dot)), qsq);
    return fmaxf(d, 0.0f);
  }
  if (metric == kIP) return -dot;
  return __fsub_rn(1.0f, dot);
}

// (a, ia) comes before (b, ib) in argmin's order: a NaN first, then the
// lower distance, then the lower slot.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a < b || (a == b && ia < ib);
}

// The distances of a tile of up to kTile rows: `nid` is owner lane i's
// row id (i < kTile; -1 on every other lane and where invalid). Returns
// owner lane i's distance (+inf where nid < 0) and sets `nptr` to its
// row's up_ptr (-1 where nid < 0). Every lane of the warp takes part.
template <typename T, int kNB>
__device__ __forceinline__ float tile_distances(
    int nid, int& nptr, const T* __restrict__ vec,
    const float* __restrict__ sq, const int* __restrict__ ptr,
    const float4* qs, int D, int nch, float qn, int metric, int t) {
  float xsq = 0.f;
  nptr = -1;
  if (nid >= 0) {
    xsq = metric == kL2 ? __ldg(sq + nid) : 0.f;
    nptr = __ldg(ptr + nid);
  }
  const int g = t / kGroup, j = t % kGroup;
  int rid[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
    rid[p] = __shfl_sync(kFull, nid, kRowsPerPass * p + g);
  float acc[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) acc[p] = 0.f;
  const int nb = nch / kGroup;               // 128-byte blocks a row
  for (int b0 = 0; b0 < nb; b0 += kNB) {
    uint4 x[kPasses][kNB];
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
#pragma unroll
      for (int b = 0; b < kNB; ++b)
        x[p][b] = rid[p] >= 0 && b0 + b < nb
                      ? __ldg(reinterpret_cast<const uint4*>(
                                  vec + static_cast<long long>(rid[p]) * D) +
                              (b0 + b) * kGroup + j)
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
#pragma unroll
      for (int b = 0; b < kNB; ++b)
        if (b0 + b < nb)
          ChunkDot<T>::add(acc[p], x[p][b], qs, nch, (b0 + b) * kGroup + j);
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    acc[p] += __shfl_xor_sync(kFull, acc[p], 4);
    acc[p] += __shfl_xor_sync(kFull, acc[p], 2);
    acc[p] += __shfl_xor_sync(kFull, acc[p], 1);
  }
  // row r = kRowsPerPass * p + g: owner lane r reads group r % 4's sum of
  // pass r / 4
  float dot = 0.f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const float v = __shfl_sync(kFull, acc[p], kGroup * (t % kRowsPerPass));
    if (t / kRowsPerPass == p) dot = v;
  }
  return nid >= 0 ? metric_dist(metric, dot, xsq, qn) : CUDART_INF_F;
}

template <typename T, int kNB>
__global__ void __launch_bounds__(kThreads)
greedy_descent_kernel(const T* __restrict__ vectors,      // [P, N, D]
                      const float* __restrict__ sqnorms,  // [P, N]
                      const int* __restrict__ up_ptr,     // [P, N]
                      const int* __restrict__ up_nbrs,    // [P, NL, U, Mu]
                      const int* __restrict__ entry,      // [P]
                      const int* __restrict__ max_level,  // [P]
                      const float* __restrict__ queries,  // [B, D]
                      const float* __restrict__ qsq,      // [B]
                      int* __restrict__ out_cur,          // [L]
                      float* __restrict__ out_d,          // [L]
                      int* __restrict__ out_calcs,        // [L]
                      int L, int B, int N, int D, int n_layers, int U,
                      int Mu, int upper_hops, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const long long lane = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (lane >= L) return;                     // the whole warp leaves
  const long long part = lane / B;
  const int qrow = static_cast<int>(lane % B);
  const int nch = D * static_cast<int>(sizeof(T)) / 16;
  float4* qs = reinterpret_cast<float4*>(smem) + warp * (D / 4);
  ChunkDot<T>::stage(qs, queries + static_cast<long long>(qrow) * D, D, t);
  __syncwarp();

  const T* vec = vectors + part * N * D;
  const float* sq = sqnorms + part * N;
  const int* ptr = up_ptr + part * N;
  const int* nbrs = up_nbrs + part * n_layers * U * Mu;
  const float qn = qsq[qrow];

  // the entry point, scored by owner lane 0
  int cur = entry[part];
  int row;
  float cur_d = tile_distances<T, kNB>(t == 0 ? cur : -1, row, vec, sq, ptr,
                                       qs, D, nch, qn, metric, t);
  cur_d = __shfl_sync(kFull, cur_d, 0);
  row = __shfl_sync(kFull, row, 0);
  int calcs = 1;

  for (int layer = min(max_level[part], n_layers); layer >= 1; --layer) {
    const int* lnbrs = nbrs + static_cast<long long>(layer - 1) * U * Mu;
    for (int h = 0; h < upper_hops; ++h) {
      float best_d = CUDART_INF_F;
      int best_i = INT_MAX, best = 0, best_ptr = -1;
      if (row >= 0) {                        // uniform: row is the warp's
        const int* nrow = lnbrs + static_cast<long long>(row) * Mu;
        for (int t0 = 0; t0 < Mu; t0 += kTile) {
          const int slot = t0 + t;
          const int nid = t < kTile && slot < Mu ? __ldg(nrow + slot) : -1;
          int nptr;
          float bd = tile_distances<T, kNB>(nid, nptr, vec, sq, ptr, qs, D,
                                            nch, qn, metric, t);
          calcs += __popc(__ballot_sync(kFull, nid >= 0));
          int bi = slot;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_xor_sync(kFull, bd, off);
            const int oi = __shfl_xor_sync(kFull, bi, off);
            if (before(od, oi, bd, bi)) {
              bd = od;
              bi = oi;
            }
          }
          // every lane holds the tile's first minimum (bd, bi)
          const int src = (bi - t0) & 31;
          const int id = __shfl_sync(kFull, nid, src);
          const int id_ptr = __shfl_sync(kFull, nptr, src);
          if (before(bd, bi, best_d, best_i)) {
            best_d = bd;
            best_i = bi;
            best = id;
            best_ptr = id_ptr;
          }
        }
      }
      if (!(best_d < cur_d)) break;          // no nearer neighbour
      cur = best;
      cur_d = best_d;
      row = best_ptr;
    }
  }
  if (t == 0) {
    out_cur[lane] = cur;
    out_d[lane] = cur_d;
    out_calcs[lane] = calcs;
  }
}

template <typename T, int kNB>
cudaError_t launch_nb(const void* vectors, const void* sqnorms,
                      const void* up_ptr, const void* up_nbrs,
                      const void* entry, const void* max_level,
                      const void* queries, const void* qsq, void* out_cur,
                      void* out_d, void* out_calcs, int L, int B, int N, int D,
                      int n_layers, int U, int Mu, int upper_hops, int metric,
                      cudaStream_t stream) {
  const int bytes = kWarps * D * static_cast<int>(sizeof(float));
  auto kernel = greedy_descent_kernel<T, kNB>;
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const int grid = (L + kWarps - 1) / kWarps;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(vectors), static_cast<const float*>(sqnorms),
      static_cast<const int*>(up_ptr), static_cast<const int*>(up_nbrs),
      static_cast<const int*>(entry), static_cast<const int*>(max_level),
      static_cast<const float*>(queries), static_cast<const float*>(qsq),
      static_cast<int*>(out_cur), static_cast<float*>(out_d),
      static_cast<int*>(out_calcs), L, B, N, D, n_layers, U, Mu, upper_hops,
      metric);
  return cudaGetLastError();
}

// Up to 4 blocks of 128 bytes of each of a pass's rows in flight: 16
// 16-byte loads a thread (the 8-bit rows of D 128 take one block, float32
// rows of D 128 four).
template <typename T>
int launch(const void* vectors, const void* sqnorms, const void* up_ptr,
           const void* up_nbrs, const void* entry, const void* max_level,
           const void* queries, const void* qsq, void* out_cur, void* out_d,
           void* out_calcs, int device, int L, int B, int N, int D,
           int n_layers, int U, int Mu, int upper_hops, int metric,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L == 0) return 0;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  if (D < 1 || row_bytes % (16 * kGroup) != 0 || B < 1 || Mu < 1 ||
      n_layers < 0 || upper_hops < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = row_bytes / (16 * kGroup);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DESCENT_ARGS                                                   \
  vectors, sqnorms, up_ptr, up_nbrs, entry, max_level, queries, qsq,        \
      out_cur, out_d, out_calcs, L, B, N, D, n_layers, U, Mu, upper_hops,   \
      metric, s
  if (nb == 1) err = launch_nb<T, 1>(REPRO_DESCENT_ARGS);
  else if (nb == 2) err = launch_nb<T, 2>(REPRO_DESCENT_ARGS);
  else err = launch_nb<T, 4>(REPRO_DESCENT_ARGS);
#undef REPRO_DESCENT_ARGS
  return static_cast<int>(err);
}

}  // namespace

// C interface, bound with ctypes: one entry point per row type. Each
// launches on `stream` and returns cudaGetLastError(); shapes were checked
// by the Python wrapper (kernels/descent.py).
#define REPRO_DESCENT_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* vectors, const void* sqnorms,               \
                      const void* up_ptr, const void* up_nbrs,                \
                      const void* entry, const void* max_level,               \
                      const void* queries, const void* qsq, void* out_cur,    \
                      void* out_d, void* out_calcs, int device, int L, int B, \
                      int N, int D, int n_layers, int U, int Mu,              \
                      int upper_hops, int metric, void* stream) {             \
    return launch<T>(vectors, sqnorms, up_ptr, up_nbrs, entry, max_level,     \
                     queries, qsq, out_cur, out_d, out_calcs, device, L, B,   \
                     N, D, n_layers, U, Mu, upper_hops, metric, stream);      \
  }

REPRO_DESCENT_ENTRY(repro_greedy_descent_f32, float)
REPRO_DESCENT_ENTRY(repro_greedy_descent_u8, uint8_t)
REPRO_DESCENT_ENTRY(repro_greedy_descent_i8, int8_t)

extern "C" const char* repro_descent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Per-row k smallest of a float32 matrix with short rows, for Hopper
// (sm_90a): `topk` at N <= 256 columns, the MoE router's shape.
//
// Replaces the TPU kernel `topk_pallas` (src/repro/kernels/topk.py) for
// rows of at most 256 columns; csrc/select_k.cu keeps the longer rows (the
// wrapper, kernels/topk.py `takes_short_rows`, picks by shape). It
// computes the function of `topk_ref`: for each row of x [B, N] the k
// smallest (value, column) pairs, ascending, as (values [B, k] float32,
// ids [B, k] int32). Among equal values the lower column wins; -0.0 and
// +0.0 are equal values (tied by column) and each keeps its sign, since
// values are copied, never recomputed. NaN and +inf never enter; a slot
// that no entry fills holds (+inf, -1).
//
// What bounds it on this card: the bytes, B * N * 4 in and B * k * 8 out
// (5.0 MB at the router's [16,384, 64], k = 6: 1.5 us at 3.35 TB/s),
// under the cost of a launch; at a decode step's [8, 64] the launch alone.
//
// The design. A warp takes a row whole, E entries a lane (E the power of
// two with 32 E >= N: two at N = 64), in coalesced loads, each as a
// 64-bit key: an order-preserving map of the value (both zeros mapped to
// one key) above the column, so that the keys' order is the total
// (value, column) order, and NaN / +inf (never selected) as the largest
// key. No entry is inserted anywhere; the warp
// - takes each lane's smallest key and, over those 32 minima in shared
//   memory (broadcast reads), the least value that has K of them at or
//   below it (a REDUX min): at least K entries lie at or below it, so
//   the entries above it are out (all stay in where K > 32 or fewer than
//   K lanes hold a valid entry);
// - gathers the entries that stay (about K + a few on the router's rows)
//   in shared memory by ballot, and counts for each the keys below its
//   own among them: that is its rank in the row, and the entries of rank
//   < k are written at their rank.
// On the router's rows that is 32 compares a lane for the bound and a
// dozen for the ranks, against select_k.cu's ~20 dependent insertions of
// ~10 shuffles each (its list upkeep). A CTA of 8 warps takes 8 rows, so
// 16,384 rows are 2,048 CTAs, about two waves of the card's 132 SMs.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 256;
constexpr int kMaxK = 64;
constexpr unsigned int kFull = 0xffffffffu;

// The key of (v, column c): the total order by value, then by column.
__device__ __forceinline__ unsigned long long order_key(float v, int c) {
  if (!(v < CUDART_INF_F)) return ~0ull;            // NaN and +inf
  unsigned int u = __float_as_uint(v);
  if ((u & 0x7fffffffu) == 0u) u = 0u;               // -0.0 ties with +0.0
  const unsigned int o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<unsigned int>(c);
}

template <int E>
__global__ void __launch_bounds__(kThreads)
select_k_short_kernel(const float* __restrict__ x,   // [B, N]
                      float* __restrict__ out_d,     // [B, K]
                      int* __restrict__ out_i,       // [B, K]
                      long long B, int N, int K) {
  __shared__ __align__(16) unsigned int mins[kWarps][32];
  __shared__ __align__(16) unsigned long long cand[kWarps][32 * E];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= B) return;                             // uniform across the warp
  const float* xr = x + row * N;
  float v[E];
  unsigned long long key[E];
  unsigned long long lmin = ~0ull;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = lane + 32 * e;
    v[e] = c < N ? __ldg(xr + c) : CUDART_INF_F;
    key[e] = order_key(v[e], c);
    lmin = min(lmin, key[e]);
  }

  // The bound: the least lane minimum's value with at least K lane minima
  // at or below it (all values where no lane minimum has K: K > 32, or
  // fewer than K valid lanes). At least K entries lie at or below it, so
  // an entry above it is not among the K smallest.
  const unsigned int mine = static_cast<unsigned int>(lmin >> 32);
  mins[warp][lane] = mine;
  __syncwarp();
  const uint4* mw = reinterpret_cast<const uint4*>(mins[warp]);
  int at_or_below = 0;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const uint4 p = mw[o];
    at_or_below += (p.x <= mine) + (p.y <= mine) + (p.z <= mine) + (p.w <= mine);
  }
  const unsigned int bound =
      __reduce_min_sync(kFull, at_or_below >= K ? mine : 0xffffffffu);

  // the candidates (valid, at or below the bound), gathered into shared
  // memory; a candidate's rank among them is its rank in the row
  const unsigned int below = (1u << lane) - 1u;
  bool cnd[E];
  int n = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cnd[e] = key[e] != ~0ull && static_cast<unsigned int>(key[e] >> 32) <= bound;
    const unsigned int b = __ballot_sync(kFull, cnd[e]);
    if (cnd[e]) cand[warp][n + __popc(b & below)] = key[e];
    n += __popc(b);
  }
  __syncwarp();
  int rank[E];
#pragma unroll
  for (int e = 0; e < E; ++e) rank[e] = 0;
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const unsigned long long c = cand[warp][o];
#pragma unroll
    for (int e = 0; e < E; ++e) rank[e] += c < key[e];
  }

  int valid = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    valid += __popc(__ballot_sync(kFull, v[e] < CUDART_INF_F));
    if (cnd[e] && rank[e] < K) {
      out_d[row * K + rank[e]] = v[e];
      out_i[row * K + rank[e]] = lane + 32 * e;
    }
  }
  for (int j = valid + lane; j < K; j += 32) {      // slots no entry fills
    out_d[row * K + j] = CUDART_INF_F;
    out_i[row * K + j] = -1;
  }
}

template <int E>
cudaError_t launch(const float* x, float* out_d, int* out_i, long long B, int N,
                   int K, cudaStream_t stream) {
  const long long grid = (B + kWarps - 1) / kWarps;
  select_k_short_kernel<E><<<static_cast<unsigned int>(grid), kThreads, 0,
                             stream>>>(x, out_d, out_i, B, N, K);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. x [B, N] float32 row-major, 1 <= N <=
// 256; out_d / out_i [B, K], 1 <= K <= 64. The Python wrapper checked
// every shape and pointer. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int repro_select_k_short(const void* x, void* out_d, void* out_i,
                                    int device, long long B, int N, int K,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  if (N < 1 || N > kMaxN || K < 1 || K > kMaxK ||
      (B + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* dp = static_cast<float*>(out_d);
  int* ip = static_cast<int*>(out_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 32) err = launch<1>(xp, dp, ip, B, N, K, st);
  else if (N <= 64) err = launch<2>(xp, dp, ip, B, N, K, st);
  else if (N <= 128) err = launch<4>(xp, dp, ip, B, N, K, st);
  else err = launch<8>(xp, dp, ip, B, N, K, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_select_k_short_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

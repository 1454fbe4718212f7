// Fused multi-hop layer-0 HNSW traversal for Hopper (sm_90a), laid out
// for the card's memory latency.
//
// Replaces the TPU kernel `fused_traversal_pallas` of
// src/repro/kernels/traversal.py (the paper's Fig. 6 search engine), as
// csrc/traversal.cu does, and computes exactly what traversal.cu and the
// plain PyTorch version `fused_traversal_ref` compute: up to H layer-0
// beam-search hops a launch for every query lane, over float32, uint8 or
// int8 rows; l2 / ip / cosine; the line-11 guard; `calcs` counting every
// active neighbour; the stable rank order of the batch and the two rank
// merges with the same tie rules; state updated in place. On
// integer-valued rows every dot product is an exact integer below 2^24,
// so the two kernels and the plain version agree bitwise.
// kernels/traversal.py's `traversal_route` picks this kernel or
// traversal.cu by shape alone.
//
// What bounds it on this card: not bytes (about 2 us a superstep at the
// main path's shapes) but a chain of dependent steps. A hop needs the
// popped head's neighbour list, then the rows it names; the next head is
// known only after this hop's merge. traversal.cu paid five or six
// global round trips and four __syncthreads a hop. This kernel pays two
// round trips (list, rows) and two __syncthreads, hides the list, and
// keeps the merge's work off the critical path of every warp:
//
// 1. The visited bitmap lives in shared memory for the whole launch when
//    its W = ceil(N_pad / 32) words fit (`kSharedBitmap`): loaded at
//    launch, written back at exit, the test-and-set a shared-memory
//    atomicOr. Above the route's threshold (the 1M-row tables, 125 KB a
//    lane) the same kernel keeps it in global memory.
// 2. Warp 0 owns the neighbours (lane m neighbour m, M0 <= 32): each lane
//    test-and-sets its id and, if the row is new, issues one TMA bulk copy
//    of the row into its slot of a shared staging tile, completing on one
//    mbarrier, and loads the row's sqnorm beside it. Every active row of
//    the hop is in flight at once: one round trip. The owner's last
//    arrival on the mbarrier publishes the sqnorm and id with the row.
// 3. Groups of 4 threads take a staged row each for the distance; after
//    one barrier warp 0 ranks the batch (stable) and places it in both
//    lists by binary search, while warps 1-3 move the old entries up by
//    the batch entries below them (float4 counts over a 32-slot batch).
//    The merges need no sorted batch, and no warp runs both halves.
// 4. The next head is min(pop[0], the batch's best), the old entry first
//    on a tie; warp 0 finds it right after its rank loop (the lane of
//    rank 0) and loads its lanes' elements of the head's neighbour list at
//    once, so that load flies while the merges run and is in the owners'
//    registers next hop.
// 5. Lists are double-buffered and sized by C and EF; the query is staged
//    once a launch. 128 threads, __launch_bounds__(128, 8): 8 CTAs an SM,
//    so the main path's L = 1,024 lanes run in one wave on 132 SMs,
//    within ~28 KB of shared memory a CTA (float32: 20,240 bytes at D_pad
//    128, M0 32, C 72, EF 40, W 256).
//
// Row slots are read by groups of 4 threads, each taking every 4th
// 16-byte chunk from a start rotated by the slot, so the 8 threads of a
// quarter warp hit 8 bank groups. 8-bit rows keep the float32 query in a
// chunk-major order for the same reason.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 4;                   // threads a staged row
constexpr int kMaxM0 = 32;                  // a lane of warp 0 a neighbour
constexpr int kMinBlocks = 8;               // CTAs an SM

enum Metric : int { kL2 = 0, kIP = 1, kCosine = 2 };

// Byte offsets of dynamic shared memory. kernels/traversal.py's
// `async_smem_bytes` mirrors `bytes`.
struct Layout {
  int rows, query, bat_d, bat_i, bat_sq, bat_id, cand_d, cand_i, fin_d,
      fin_i, bitmap, bytes;
};

__host__ __device__ inline Layout layout(int row_bytes, int D, int M0, int C,
                                         int EF, int w_smem) {
  Layout l;
  l.rows = 16;                      // the mbarrier (8 bytes) first
  l.query = l.rows + M0 * row_bytes;
  l.bat_d = l.query + 4 * D;        // the batch: kMaxM0 slots, 16-aligned
  l.bat_i = l.bat_d + 4 * kMaxM0;
  l.bat_sq = l.bat_i + 4 * kMaxM0;  // each staged row's sqnorm and id
  l.bat_id = l.bat_sq + 4 * kMaxM0;
  l.cand_d = l.bat_id + 4 * kMaxM0;
  l.cand_i = l.cand_d + 8 * C;      // lists: two buffers each
  l.fin_d = l.cand_i + 8 * C;
  l.fin_i = l.fin_d + 8 * EF;
  l.bitmap = l.fin_i + 8 * EF;
  l.bytes = l.bitmap + 4 * w_smem;
  return l;
}

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
struct SmemDot {
  static __device__ void stage_query(float4* qs, const float* q, int D) {
    for (int t = threadIdx.x; t < D / 4; t += kThreads)
      qs[t] = __ldg(reinterpret_cast<const float4*>(q) + t);
  }
  // this thread's share (chunks = s mod 4) of row slot m's dot product
  static __device__ __forceinline__ float partial(const unsigned char* row,
                                                  const float4* qs, int D,
                                                  int m, int s) {
    const float4* x = reinterpret_cast<const float4*>(row);
    const int nch = D / 4;
    int c = (kGroup * m + s) % nch;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < nch / kGroup; ++i) {
      const float4 a = x[c], b = qs[c];
      acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      c += kGroup;
      if (c >= nch) c -= nch;
    }
    return acc;
  }
};

// 8-bit code rows: chunk c holds 16 codes; the four float4 of the query
// values under it sit at j * nch + c (j = 0..3).
template <typename T>
struct SmemDot8 {
  static __device__ void stage_query(float4* qs, const float* q, int D) {
    const int nch = D / 16;
    for (int t = threadIdx.x; t < D / 4; t += kThreads)
      qs[(t & 3) * nch + (t >> 2)] =
          __ldg(reinterpret_cast<const float4*>(q) + t);
  }
  static __device__ __forceinline__ float partial(const unsigned char* row,
                                                  const float4* qs, int D,
                                                  int m, int s) {
    const uint4* x = reinterpret_cast<const uint4*>(row);
    const int nch = D / 16;
    int c = (kGroup * m + s) % nch;
    float acc = 0.f;
    for (int i = 0; i < nch / kGroup; ++i) {
      const uint4 c4 = x[c];
      const unsigned int w[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 y = qs[j * nch + c];
        acc += code_at<T>(w[j], 0) * y.x + code_at<T>(w[j], 1) * y.y +
               code_at<T>(w[j], 2) * y.z + code_at<T>(w[j], 3) * y.w;
      }
      c += kGroup;
      if (c >= nch) c -= nch;
    }
    return acc;
  }
};

template <>
struct SmemDot<uint8_t> : SmemDot8<uint8_t> {};

template <>
struct SmemDot<int8_t> : SmemDot8<int8_t> {};

__device__ __forceinline__ float metric_dist(int metric, float dot, float xsq,
                                             float qsq) {
  if (metric == kL2) {
    const float d = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, dot)), qsq);
    return fmaxf(d, 0.0f);
  }
  if (metric == kIP) return -dot;
  return __fsub_rn(1.0f, dot);
}

// #(a[i] <= x) over an ascending array
__device__ __forceinline__ int count_less_equal(const float* a, int n,
                                                float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, bool kSharedBitmap>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
traversal_async_kernel(const T* __restrict__ vectors,       // [P, N, D]
                       const float* __restrict__ sqnorms,   // [P, N]
                       const int* __restrict__ l0_nbrs,     // [P, N, M0]
                       const float* __restrict__ queries,   // [B, D]
                       const float* __restrict__ qsq,       // [B]
                       float* __restrict__ g_cand_d,        // [L, C]
                       int* __restrict__ g_cand_i,          // [L, C]
                       float* __restrict__ g_fin_d,         // [L, EF]
                       int* __restrict__ g_fin_i,           // [L, EF]
                       unsigned int* __restrict__ g_visited,  // [L, W]
                       int* __restrict__ g_hops,            // [L]
                       int* __restrict__ g_calcs,           // [L]
                       int B, int N, int D, int M0, int C, int EF, int W,
                       int H, int max_hops, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const Layout lay = layout(row_bytes, D, M0, C, EF, kSharedBitmap ? W : 0);
  const uint32_t bar = hopper::smem_u32(smem);
  unsigned char* rows = smem + lay.rows;
  float4* qs = reinterpret_cast<float4*>(smem + lay.query);
  float* bat_d = reinterpret_cast<float*>(smem + lay.bat_d);
  int* bat_i = reinterpret_cast<int*>(smem + lay.bat_i);
  float* bat_sq = reinterpret_cast<float*>(smem + lay.bat_sq);
  int* bat_id = reinterpret_cast<int*>(smem + lay.bat_id);
  float* cand_d = reinterpret_cast<float*>(smem + lay.cand_d);
  int* cand_i = reinterpret_cast<int*>(smem + lay.cand_i);
  float* fin_d = reinterpret_cast<float*>(smem + lay.fin_d);
  int* fin_i = reinterpret_cast<int*>(smem + lay.fin_i);
  const float4* bat_d4 = reinterpret_cast<const float4*>(bat_d);

  const int tid = threadIdx.x;
  const int m = tid / kGroup, s = tid % kGroup;   // row slot read, share
  const bool owner = tid < M0;                    // warp 0: neighbour tid
  const long long lane = blockIdx.x;
  const long long part = lane / B;
  const int qrow = static_cast<int>(lane % B);

  const T* vec = vectors + part * N * D;
  const float* sq = sqnorms + part * N;
  const int* nbrs = l0_nbrs + part * N * M0;
  const float qn = qsq[qrow];
  unsigned int* g_vis = g_visited + lane * W;
  unsigned int* vis =
      kSharedBitmap ? reinterpret_cast<unsigned int*>(smem + lay.bitmap)
                    : g_vis;

  if (tid == 0) {
    hopper::mbar_init(bar, 2 * M0);         // two arrivals an owner a hop
    hopper::mbar_fence_init();
  }
  SmemDot<T>::stage_query(qs, queries + static_cast<long long>(qrow) * D, D);
  // batch slots past M0 stay (+inf, -1): the counts run over kMaxM0
  for (int i = tid; i < kMaxM0; i += kThreads) {
    bat_d[i] = CUDART_INF_F;
    bat_i[i] = -1;
  }
  for (int i = tid; i < C; i += kThreads) {
    cand_d[i] = g_cand_d[lane * C + i];
    cand_i[i] = g_cand_i[lane * C + i];
  }
  for (int i = tid; i < EF; i += kThreads) {
    fin_d[i] = g_fin_d[lane * EF + i];
    fin_i[i] = g_fin_i[lane * EF + i];
  }
  if (kSharedBitmap)
    for (int i = tid; i < W; i += kThreads) vis[i] = g_vis[i];
  int hops = g_hops[lane];
  int calcs = g_calcs[lane];
  // the first head's neighbour list, in flight across the barrier
  int nid = -1;
  if (owner && H > 0)
    nid = __ldg(nbrs + static_cast<long long>(max(g_cand_i[lane * C], 0)) *
                           M0 + tid);
  __syncthreads();

  int cur = 0;
  uint32_t phase = 0;
  for (int h = 0; h < H; ++h) {
    const float* cd = cand_d + cur * C;
    const int* ci = cand_i + cur * C;
    const float* fd = fin_d + cur * EF;
    const int* fi = fin_i + cur * EF;
    // every thread reads the same shared values: the break is uniform
    const float bound = fd[EF - 1];
    if (!(cd[0] < bound && hops < max_hops)) break;

    // 1. warp 0: test-and-set, then every new row's copy at once, its
    //    sqnorm and id beside it (published by the owner's last arrival)
    bool act = false;
    if (owner) {
      if (nid >= 0) {
        const unsigned int bit = 1u << (nid & 31);
        act = (atomicOr(vis + (nid >> 5), bit) & bit) == 0u;
      }
      if (act) {
        hopper::mbar_expect_tx(bar, row_bytes);
        hopper::bulk_load(hopper::smem_u32(rows + tid * row_bytes),
                          vec + static_cast<long long>(nid) * D, row_bytes,
                          bar);
        bat_sq[tid] = metric == kL2 ? __ldg(sq + nid) : 0.f;
      } else {
        hopper::mbar_arrive(bar);
      }
      bat_id[tid] = act ? nid : -1;
      hopper::mbar_arrive(bar);
    }
    hopper::mbar_wait(bar, phase & 1u);
    ++phase;

    // 2. distances: a group of 4 threads a staged row
    const int rid = m < M0 ? bat_id[m] : -1;
    float dot = rid >= 0
                    ? SmemDot<T>::partial(rows + m * row_bytes, qs, D, m, s)
                    : 0.f;
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (s == 0 && m < M0) {
      float d = rid >= 0 ? metric_dist(metric, dot, bat_sq[m], qn)
                         : CUDART_INF_F;
      d = d < bound ? d : CUDART_INF_F;          // line-11 guard
      bat_d[m] = d;
      bat_i[m] = isfinite(d) ? rid : -1;
    }
    calcs += __syncthreads_count(act);

    // 3. rank merges into the other buffers: warp 0 places the batch,
    //    warps 1-3 move the old entries
    const int nx = cur ^ 1;
    float* ncd = cand_d + nx * C;
    int* nci = cand_i + nx * C;
    float* nfd = fin_d + nx * EF;
    int* nfi = fin_i + nx * EF;
    if (tid < 32) {
      // batch entry tid: its stable rank over the 32 slots
      const float d = bat_d[tid];
      const int id = bat_i[tid];
      int rank = 0;
#pragma unroll
      for (int kk = 0; kk < kMaxM0 / 4; ++kk) {
        const float4 v = bat_d4[kk];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          rank += (e[c] < d) || (e[c] == d && 4 * kk + c < tid);
      }
      if (h + 1 < H) {
        // the next head: pop[0] unless the batch's first minimum (the
        // entry of rank 0) is below it
        const int j0 = __ffs(__ballot_sync(0xffffffffu, rank == 0)) - 1;
        const float dmin = __shfl_sync(0xffffffffu, d, j0);
        const int imin = __shfl_sync(0xffffffffu, id, j0);
        const float p0 = C > 1 ? cd[1] : CUDART_INF_F;
        const int head = p0 <= dmin ? (C > 1 ? ci[1] : -1) : imin;
        if (owner)
          nid = head >= 0
                    ? __ldg(nbrs + static_cast<long long>(head) * M0 + tid)
                    : -1;
      }
      if (owner) {
        const int pf = rank + count_less_equal(fd, EF, d);
        if (pf < EF) { nfd[pf] = d; nfi[pf] = id; }
        // the popped list is cd[1..C-1] then (+inf, -1)
        const int pc = rank + count_less_equal(cd + 1, C - 1, d) +
                       (d == CUDART_INF_F);
        if (pc < C) { ncd[pc] = d; nci[pc] = id; }
      }
    } else {
      // old entry i of both lists moves up by the batch entries below it
      for (int i = tid - 32; i < C; i += kThreads - 32) {
        const float a = i + 1 < C ? cd[i + 1] : CUDART_INF_F;
        const int ai = i + 1 < C ? ci[i + 1] : -1;
        const float f = i < EF ? fd[i] : CUDART_INF_F;
        int nc = 0, nf = 0;
#pragma unroll
        for (int kk = 0; kk < kMaxM0 / 4; ++kk) {
          const float4 v = bat_d4[kk];
          nc += (v.x < a) + (v.y < a) + (v.z < a) + (v.w < a);
          nf += (v.x < f) + (v.y < f) + (v.z < f) + (v.w < f);
        }
        if (i + nc < C) { ncd[i + nc] = a; nci[i + nc] = ai; }
        if (i < EF && i + nf < EF) { nfd[i + nf] = f; nfi[i + nf] = fi[i]; }
      }
    }
    ++hops;
    cur = nx;
    __syncthreads();
  }

  const float* cd = cand_d + cur * C;
  const int* ci = cand_i + cur * C;
  const float* fd = fin_d + cur * EF;
  const int* fi = fin_i + cur * EF;
  for (int i = tid; i < C; i += kThreads) {
    g_cand_d[lane * C + i] = cd[i];
    g_cand_i[lane * C + i] = ci[i];
  }
  for (int i = tid; i < EF; i += kThreads) {
    g_fin_d[lane * EF + i] = fd[i];
    g_fin_i[lane * EF + i] = fi[i];
  }
  if (kSharedBitmap)
    for (int i = tid; i < W; i += kThreads) g_vis[i] = vis[i];
  if (tid == 0) {
    g_hops[lane] = hops;
    g_calcs[lane] = calcs;
  }
}

template <typename T, bool kShared>
cudaError_t prepare() {
  // 8 CTAs of ~28 KB need the shared-memory side of the L1 split
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      traversal_async_kernel<T, kShared>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
int launch_async(const void* vectors, const void* sqnorms,
                 const void* l0_nbrs, const void* queries, const void* qsq,
                 void* cand_d, void* cand_i, void* fin_d, void* fin_i,
                 void* visited, void* hops, void* calcs, int device, int L,
                 int B, int N, int D, int M0, int C, int EF, int W, int H,
                 int max_hops, int metric, int shared_bitmap, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M0 < 1 || M0 > kMaxM0 || D % 128 != 0 || C < 1 || EF < 1 || EF > C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const int bytes = layout(D * static_cast<int>(sizeof(T)), D, M0, C, EF,
                           shared_bitmap ? W : 0).bytes;
  err = shared_bitmap ? prepare<T, true>() : prepare<T, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = shared_bitmap ? traversal_async_kernel<T, true>
                              : traversal_async_kernel<T, false>;
  kernel<<<L, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vectors), static_cast<const float*>(sqnorms),
      static_cast<const int*>(l0_nbrs), static_cast<const float*>(queries),
      static_cast<const float*>(qsq), static_cast<float*>(cand_d),
      static_cast<int*>(cand_i), static_cast<float*>(fin_d),
      static_cast<int*>(fin_i), static_cast<unsigned int*>(visited),
      static_cast<int*>(hops), static_cast<int*>(calcs), B, N, D, M0, C, EF,
      W, H, max_hops, metric);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int D, int M0, int C, int EF, int W, int shared_bitmap) {
  const int bytes = layout(D * static_cast<int>(sizeof(T)), D, M0, C, EF,
                           shared_bitmap ? W : 0).bytes;
  cudaError_t err = shared_bitmap ? prepare<T, true>() : prepare<T, false>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, shared_bitmap ? traversal_async_kernel<T, true>
                          : traversal_async_kernel<T, false>,
        kThreads, bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// C interface, bound with ctypes: one entry point per row type, the
// bitmap's placement an argument. Each launches on `stream` and returns
// cudaGetLastError(); shapes were checked by the Python wrapper.
#define REPRO_TRAVERSAL_ASYNC_ENTRY(NAME, T)                                  \
  extern "C" int NAME(                                                        \
      const void* vectors, const void* sqnorms, const void* l0_nbrs,          \
      const void* queries, const void* qsq, void* cand_d, void* cand_i,       \
      void* fin_d, void* fin_i, void* visited, void* hops, void* calcs,       \
      int device, int L, int B, int N, int D, int M0, int C, int EF, int W,   \
      int H, int max_hops, int metric, int shared_bitmap, void* stream) {     \
    return launch_async<T>(vectors, sqnorms, l0_nbrs, queries, qsq, cand_d,   \
                           cand_i, fin_d, fin_i, visited, hops, calcs,        \
                           device, L, B, N, D, M0, C, EF, W, H, max_hops,     \
                           metric, shared_bitmap, stream);                    \
  }

REPRO_TRAVERSAL_ASYNC_ENTRY(repro_traversal_async_f32, float)
REPRO_TRAVERSAL_ASYNC_ENTRY(repro_traversal_async_u8, uint8_t)
REPRO_TRAVERSAL_ASYNC_ENTRY(repro_traversal_async_i8, int8_t)

// Dynamic shared memory of a launch, in bytes (row_bytes = D * the row
// element's size; w_smem = W with the bitmap in shared memory, else 0).
extern "C" int repro_traversal_async_smem_bytes(int row_bytes, int D, int M0,
                                                int C, int EF, int w_smem) {
  return layout(row_bytes, D, M0, C, EF, w_smem).bytes;
}

// CTAs of the instantiation for row type `dtype` (0 float32, 1 uint8, 2
// int8) resident on one SM at these shapes, or minus the CUDA error.
extern "C" int repro_traversal_async_blocks_per_sm(int dtype, int D, int M0,
                                                   int C, int EF, int W,
                                                   int shared_bitmap) {
  if (dtype == 0) return blocks_per_sm<float>(D, M0, C, EF, W, shared_bitmap);
  if (dtype == 1)
    return blocks_per_sm<uint8_t>(D, M0, C, EF, W, shared_bitmap);
  return blocks_per_sm<int8_t>(D, M0, C, EF, W, shared_bitmap);
}

extern "C" const char* repro_traversal_async_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

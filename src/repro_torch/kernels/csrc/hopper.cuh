// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention_tc.cu and the exact scans l2dist_tc.cu, l2topk_tc.cu,
// l2dist_q_tc.cu, l2topk_q_tc.cu) and the layer-0 traversal
// (traversal_async.cu): mbarriers, TMA bulk copies, TMA loads and stores
// through tensor maps, wgmma shared-memory descriptors, fences and the
// scans' m64n64 products (3 x TF32 pieces, u8 / s8), named barriers, and
// libcuda's cuTensorMapEncodeTiled reached through the runtime (no -lcuda
// on the nvcc line).
//
// Every swizzled operand here uses the 128-byte swizzle: TMA writes a box
// whose rows are 128 bytes, and the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8) of its 1024-byte group, so bases are 1024-byte aligned.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, byte b) in a 128-byte-swizzled box of 128-byte
// rows, from the box's 1024-byte aligned base.
__device__ __forceinline__ uint32_t sw128(uint32_t r, uint32_t b) {
  return r * 128u + ((((b >> 4) ^ r) & 7u) << 4) + (b & 15u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of more than
// about 10 s (2^34 clocks) can only be a fault in the pipeline: it traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
               "}\n" ::"r"(bar), "r"(bytes) : "memory");
}

// TMA's 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory, completing on
// `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One TMA box of a 2-D map at (column c, row r) into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}

// One TMA box of a 3-D map at (column c, row r, plane p) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c, int r, int p) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(p)
      : "memory");
}

// One TMA box from shared memory to a 2-D map at (column c, row r); the
// parts of the box past the map's edges are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c), "r"(r)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// The committed stores have read their shared memory (it may be reused).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Every committed store but the newest has read its shared memory.
__device__ __forceinline__ void bulk_wait_read_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
// The committed stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders this thread's shared-memory writes before later reads of the
// async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: 8-row
// groups 1024 bytes apart (SBO); `lbo` is the stride between 64-column
// boxes, read only for MN-major operands wider than one box.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The accumulator is written by the tensor cores until the wait: keep the
// compiler from moving its reads or writes across this point.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 32 accumulator registers d[0..31] of an m64n64 wgmma as asm operands
// %0..%31, with constraint c ("+f" for f32, "+r" for s32).
#define HOPPER_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define HOPPER_D32(c)                                                    \
  HOPPER_D4(c, 0), HOPPER_D4(c, 4), HOPPER_D4(c, 8), HOPPER_D4(c, 12),   \
      HOPPER_D4(c, 16), HOPPER_D4(c, 20), HOPPER_D4(c, 24), HOPPER_D4(c, 28)
#define HOPPER_D32_LIST                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// The bits of a float32 that the TF32 units read: hi = x & 0xffffe000.
// x - hi (the lo piece) is exact in float32, and 0 on integers up to 2048.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// d[64 x 64] (+)= A[64 x 8] . B[64 x 8]^T in TF32: A from registers (the
// m64k8 fragment), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOPPER_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_D32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T over 8-bit codes into s32,
// both K-major in shared memory: .u8.u8 for uint8, .s8.s8 for int8.
template <typename T>
__device__ __forceinline__ void wgmma_i8(int (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_i8<uint8_t>(int (&d)[32], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 " HOPPER_D32_LIST
      ", %32, %33, p;\n}\n"
      : HOPPER_D32("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_i8<int8_t>(int (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " HOPPER_D32_LIST
      ", %32, %33, p;\n}\n"
      : HOPPER_D32("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

// Error codes beside cudaError_t's
constexpr int kNoEncoder = -1, kEncodeFailed = -2, kRegisterBudget = -3;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, reached through the runtime.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tensor map over a row-major [rows, cols] matrix of `elem`-byte
// elements (the row pitch a multiple of 16 bytes), with boxes of
// [box_rows, box_cols] and the 128-byte swizzle. Reads past the edges
// are zeros.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                      const void* base, long long rows, long long cols,
                      int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(base), dims, strides, box,
                   step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline const char* error_string(int err) {
  if (err == kNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda";
  if (err == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  if (err == kRegisterBudget)
    return "the kernel's registers at launch differ from what its setmaxnreg "
           "assumes";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace hopper

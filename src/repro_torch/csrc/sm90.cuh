// Hopper (sm_90a) building blocks for the port's kernels: mbarriers, TMA
// tensor loads and bulk copies into shared memory, wgmma shared-memory
// descriptors and the m64n64k16 bf16 products (both operands
// in shared memory, or A in registers), and the host-side tensor-map
// encoder; 16-byte cp.async copies and the cluster launch.  Raw PTX, no
// library: the port's kernels build from these.
//
// Shared-memory tiles are 64 rows of 128 bytes (64 bf16), written by TMA
// with CU_TENSOR_MAP_SWIZZLE_128B and read by wgmma through a descriptor
// of the same swizzle; every tile starts on a 1024-byte boundary (one
// swizzle atom of 8 rows), so the descriptors' base offset stays 0.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so the library needs no -lcuda

#include "common.cuh"

namespace repro {
namespace sm90 {

constexpr int kTileBytes = 64 * 64 * 2;  // one 64 x 64 bf16 tile, 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// allocated 1 KB larger than the tiles need).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers --------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` of asynchronous copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`
// (0 for its first use, 1 for its second, ...).  A wait that outlasts
// about ten seconds traps, so a copy that never lands fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (!start) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// ---- asynchronous copies ---------------------------------------------
// A box of a 2-D or 3-D tensor map (coordinates innermost first) into
// shared memory, completing on `bar`.  Elements outside the tensor are
// filled with zeros and still count toward the barrier's bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared
// memory, completing on `bar`; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from global into shared memory by the calling thread (cp.async,
// cached in L2 only), completing with the thread's next commit group; both
// addresses 16-byte aligned.  A thread that waits for its own groups sees
// its own copies; other threads' copies need a barrier after the wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of the thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Eight bf16 values of a 16-byte load as f32.
__device__ __forceinline__ void bf16x8_to_f32(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---- wgmma ------------------------------------------------------------
// Descriptor of a 128-byte-swizzled operand tile in shared memory: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (SWIZZLE_128B) in bits 62-63.  K-major tiles (rows of 64 K values): the
// stride offset is 1024 bytes from one group of 8 rows to the next, the
// leading offset is unused (1), and the K step of 16 values within the
// 128-byte row advances the start address by 32 bytes.  MN-major tiles
// (rows of 64 N values, one row per K): the stride offset is 1024 bytes
// from one group of 8 K rows to the next, the leading offset the distance
// to the next 64 N values.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;
  return d;
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

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

#define REPRO_WG_D8(b)                                                   \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),        \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define REPRO_WG_D32 \
  REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24)
#define REPRO_WG_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), both K-major bf16 tiles
// in shared memory.  scale_d = 0 overwrites d.  Accumulator layout: warp w
// of the warpgroup holds rows 16 w + lane / 4 (+ 8 for bit 1 of the
// register index) and columns 8 (i / 4) + 2 (lane % 4) + (i % 2).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : REPRO_WG_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers: a[0] rows
// lane / 4, columns 2 (lane % 4) + {0, 1}; a[1] the same 8 rows down;
// a[2], a[3] the same 8 columns right) * B (16 x 64), an MN-major tile in
// shared memory (transposed by the instruction).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : REPRO_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef REPRO_WG_D8
#undef REPRO_WG_D32
#undef REPRO_WG_REGS

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- host: launches ----------------------------------------------------
// Launch `kernel` on `stream` with thread-block clusters of `cluster`
// blocks (a cluster of 1 is a plain launch), raising the kernel's
// dynamic shared-memory limit to `smem` first (static and dynamic shared
// memory together may exceed 48 KB only so).  A refused launch's error is
// returned and cleared, so that it is not reported again by a later call.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid,
                                  int threads, dim3 cluster, size_t smem,
                                  cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster.x;
  attr.val.clusterDim.y = cluster.y;
  attr.val.clusterDim.z = cluster.z;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// ---- host: tensor maps -------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
#endif
  }
  return fn;
}

// A tensor map over a row-major bf16 tensor of `rank` (2 or 3) dims given
// innermost first, rows of dims[0] elements, with 64 x 64 (x 1) boxes and
// 128-byte swizzle.  Returns a CUDA error code (0 on success).
inline int encode_bf16_rows(CUtensorMap* map, const void* ptr, int rank,
                            const uint64_t* dims) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t box[3] = {64, 64, 1}, estride[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    stride *= dims[i];
    if (i + 1 < rank) gstride[i] = stride;
  }
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                  const_cast<void*>(ptr), gdim, gstride, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace repro

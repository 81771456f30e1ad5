// Hopper building blocks for the bf16 products of the fused block backward
// (sm_90a only: wgmma exists for no other target).
//
// - TMA: a tensor map (host, encode_tmap_2d) describes a row-major bf16
//   matrix and a box of it; one thread asks for a box to be copied into
//   shared memory (tma_load_2d), and the copy reports its bytes to an
//   mbarrier. Every map here uses the 128-byte swizzle, so a box row is
//   128 bytes (64 bf16) and a box lands on a 1024-byte aligned address.
//   cuTensorMapEncodeTiled is a driver function; it is fetched through the
//   runtime's cudaGetDriverEntryPoint, so the library links no libcuda.
//   Elements outside the matrix read as zero, which covers a ragged last
//   pixel tile.
// - mbarrier: init, arrive with the expected bytes, wait on a phase.
// - wgmma: one warpgroup (128 threads) computes a 64 x 128 f32 tile D +=
//   A . B from two shared-memory descriptors, k = 16 per instruction. The
//   descriptor of a 128-byte swizzled tile (sw128_desc) takes two strides,
//   as CUTLASS's canonical GMMA layouts define them:
//     K-major (the reduction dimension contiguous, box {64 k, rows}): row r
//       at 128 r bytes; SBO = 1024 (eight rows), LBO unused; the k-th
//       16-wide slice starts 32 k bytes in.
//     MN-major (M or N contiguous, boxes {64 mn, 64 k} side by side): k row
//       at 128 k bytes inside a box; SBO = 1024 (eight k rows), LBO = the
//       bytes of one box (the next 64 of M or N); the k-th slice starts
//       2048 k bytes in. wgmma reads it with its transpose bit set, which
//       16-bit types allow.
//   wgmma_fence / wgmma_commit / wgmma_wait<N> order the asynchronous
//   products; fence_acc keeps the compiler from moving accumulator reads or
//   writes across them.
// The accumulator of a 64 x 128 tile: thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 i + 2 (t % 4) (+ 1):
// d[4 i + 2 h + e] is row + 8 h, column 8 i + 2 (t % 4) + e.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_bf16 {

constexpr int BOX = 64;             // bf16 of one 128-byte swizzled box row
constexpr uint32_t SW_ATOM = 1024;  // bytes of eight swizzled rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------------

// box at element (c0 = inner, c1 = outer) of the map's matrix into dst
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// A row-major bf16 matrix of `outer` rows of `inner` elements (inner a
// multiple of 8, base 16-byte aligned), boxes of box_outer rows x
// box_inner (<= 64) elements, 128-byte swizzle.
inline cudaError_t encode_tmap_2d(CUtensorMap* map, const void* base, uint64_t inner,
                                  uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- wgmma -----------------------------------------------------------------------

// descriptor of a 128-byte swizzled tile at `smem` (byte strides)
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 f32) += A (64 x 16) . B (16 x 128); TA / TB = 1: the operand
// is MN-major (transposed), 0: K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Descriptors of the k-th 16-deep slice of a 64-row (A) or 128-column (B)
// operand whose tile starts at `tile`.
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int k) {
  return sw128_desc(tile + 32 * k, 16, SW_ATOM);
}

__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int k, uint32_t box_bytes) {
  return sw128_desc(tile + 2048 * k, box_bytes, SW_ATOM);
}

}  // namespace wgmma_bf16

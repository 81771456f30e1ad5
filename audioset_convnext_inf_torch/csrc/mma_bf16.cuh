// Tile primitives for the bf16 tensor-core kernels of this package (sm_90a).
//
// - mma_16816: one warp-wide mma.sync.m16n8k16 with bf16 operands and f32
//   accumulators, D = A . B + D, A 16x16 row-major, B 16x8 "col" (stored
//   N x K row-major, i.e. each output column's K values contiguous).
// - ldmatrix_x4 / ldmatrix_x4_trans: four 8x8 b16 matrices from shared
//   memory into mma fragments. Each lane passes the address of one 16-byte
//   row; rows of a tile are padded by 16 bytes (row stride = 16 mod 128
//   bytes), so the eight rows of one matrix fall in eight distinct bank
//   groups and the loads are free of bank conflicts. The lane-address
//   helpers below give the row and column each lane points at for the four
//   operand cases the kernels use.
// - cp_async16 / cp_async_commit / cp_async_wait: the 16-byte cp.async.cg
//   copies (global -> shared, through L2 only) that feed a ring of weight
//   or activation tiles, committed in groups and waited on with wait_group,
//   so the copy of tile t+S-1 overlaps the products on tile t.
// - Ring: that ring of tiles, STAGES deep, in the order a kernel streams
//   them.
// - The launch plan both fused-block kernels share (channel padding,
//   pixels per block, width class) and their weight-tile geometry; the
//   Python plans in ops/fused_block.py mirror it.
// - allow_smem (host): the dynamic shared-memory opt-in of a kernel, raised
//   once per size rather than on every launch.
//
// mma.sync is the simple route to the tensor cores; wgmma with TMA and warp
// specialisation is the next step (it needs 64-row warpgroup tiles and
// descriptor-addressed, swizzled shared memory).
//
// scripts/ablate_fused_block_torch.py rebuilds the kernels with parts
// switched off or other plans by -D macros: ABLATE_MMA and ABLATE_PREFETCH
// here, ABLATE_STENCIL in fused_block.cu, MT_CLASS3 and MT_WIDE below. The
// package's own build defines none of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

constexpr size_t MAX_SMEM = 232448;  // shared memory one block may opt into on an H100

// ---- the launch plan of the bf16 fused-block kernels ----------------------

constexpr int CPAD = 128;  // channels are padded to a multiple of this for the tiles
constexpr int NH = 128;    // hidden units per chunk
constexpr int KT = 64;     // depth of an [n][k] weight tile
constexpr int TR = 128;    // rows of an [n][k] tile, columns of a [k][n] tile
constexpr int TLD = KT + 8;       // padded row of an [n][k] tile: 144 bytes
constexpr int KNLD = TR + 8;      // padded row of a [k][n] tile (64 rows): 272 bytes
constexpr int HLD = NH + 8;       // padded row of a hidden chunk
constexpr int STAGES = 3;         // depth of the weight-tile ring
constexpr int STAGE = TR * TLD;   // bf16 elements of one ring stage (>= KT * KNLD)

// Pixels per block: 64 up to CP = 384, 32 above (at C = 768, 32 beat 16
// for K1 and K2: PERF.md, Findings).
#ifndef MT_CLASS3
#define MT_CLASS3 64
#endif
#ifndef MT_WIDE
#define MT_WIDE 32
#endif

// Width class: the 128-channel output blocks a thread's (MT, C) f32
// accumulator covers at most (MT * NCMAX / 2 registers): 3 for CP <= 384,
// 6 for CP <= 768, else 8.
constexpr int ncmax(int cp) { return cp <= 384 ? 3 : cp <= 768 ? 6 : 8; }
constexpr int plan_mt(int cp) { return ncmax(cp) == 3 ? MT_CLASS3 : MT_WIDE; }
constexpr int padded_c(int c) { return (c + CPAD - 1) / CPAD * CPAD; }
// The plan a bf16 kernel runs for C channels: cp = padded_c(C), mt = plan_mt(cp).
constexpr bool plan_ok(int c, int mt, int cp) { return cp == padded_c(c) && mt == plan_mt(cp); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with src_bytes < 16 the rest is zero-filled
// (0 = a row of zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// A ring of S stages of SIZE bf16 elements at `base` that streams `n`
// tiles in order. `load(t, dst)` issues the cp.async copies of tile t into
// dst (every thread its share). prime() starts the first S-1 tiles, so they
// fly while the block does other work; next() waits for tile t, makes it
// visible to every warp, refills the stage the previous tile freed with
// tile t+S-1 and returns tile t. Every thread commits one group per call,
// empty or not, so wait_group counts stay aligned.
template <int S, int SIZE>
struct Ring {
  bf16* base;
  int n;
  int t = 0;

  __device__ __forceinline__ Ring(bf16* base_, int n_) : base(base_), n(n_) {}
  __device__ __forceinline__ bf16* stage(int i) const { return base + (i % S) * SIZE; }

  template <typename Load>
  __device__ __forceinline__ void prime(Load&& load) {
    for (int s = 0; s < S - 1; ++s) {
      if (s < n) load(s, stage(s));
      cp_async_commit();
    }
  }

  template <typename Load>
  __device__ __forceinline__ const bf16* next(Load&& load) {
    cp_async_wait<S - 2>();
    __syncthreads();
#ifndef ABLATE_PREFETCH
    if (t + S - 1 < n) load(t + S - 1, stage(t + S - 1));
#endif
    cp_async_commit();
    return stage(t++);
  }
};

#ifndef ABLATE_MMA
#define MMA_16816_OP "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
#else
#define MMA_16816_OP "// "  // the operands stay live, the instruction is a comment
#endif

// d (16x8 f32: rows g and g+8, columns 2t and 2t+1 of lane 4g+t) += a . b
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      MMA_16816_OP
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane addresses for ldmatrix_x4, as (row, column) offsets inside a tile.
// A operand (16 x 16 of m x k), stored [m][k]: fragments a0..a3.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// A operand stored [k][m] (K-major), with .trans: a0..a3.
__device__ __forceinline__ int at_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int at_col(int lane) { return ((lane >> 3) & 1) * 8; }
// B operand for two 8-column output tiles (16 x 16 of n x k), stored [n][k]:
// r0, r1 = b0, b1 of columns 0-7; r2, r3 = b0, b1 of columns 8-15.
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }
// The same B fragments from a tile stored [k][n], with .trans.
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device.
// The attribute is raised only when a launch needs more than the kernel was
// granted before, not on every launch; a refusal is cleared so that it does
// not surface at a later launch. `granted` is the kernel's own record.
template <typename Kern>
inline cudaError_t allow_smem(Kern kernel, size_t bytes, std::atomic<int> (&granted)[32]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& g = granted[dev & 31];
  if (dev < 32 && g.load() >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  for (int cur = g.load(); dev < 32 && cur < (int)bytes && !g.compare_exchange_weak(cur, (int)bytes);) {
  }
  return err;
}

}  // namespace mma_bf16

// Pieces both bf16 fused-block kernels share (sm_90a): the bf16 type, the
// shared-memory limit a block may opt into, the channel padding of the
// weight tiles, bf16 pair packing, and allow_smem (host), the dynamic
// shared-memory opt-in of a kernel, raised once per size rather than on
// every launch. Their products run on wgmma (wgmma_bf16.cuh); the
// forward's launch plan is in fused_block.cu, the backward's in
// fused_block_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

constexpr size_t MAX_SMEM = 232448;  // shared memory one block may opt into on an H100

constexpr int CPAD = 128;  // channels are padded to a multiple of this for the tiles
constexpr int padded_c(int c) { return (c + CPAD - 1) / CPAD * CPAD; }

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

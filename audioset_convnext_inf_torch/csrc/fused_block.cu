// Fused ConvNeXt block forward for Hopper (sm_90a), NHWC layout.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_fused_block.py::_kernel,
// in both its modes. One launch computes a whole block:
//
//   d   = round(dwconv7x7(x) + b_dw)                 f32 sum, pad 3
//   xn  = round(LN(d) * ln_w + ln_b)                 f32 stats E[x^2]-E[x]^2
//   h   = round(gelu_tanh(xn . W1^T + b1))           f32 accumulation
//   out = round(x + ((h . W2^T + b2) * gamma) * s[b]) f32, one final rounding
//
// where round() casts to the activation type T (float or bf16); these are
// the TPU kernel's rounding points, not those of the unfused block. The
// training ("save") mode passes the per-sample drop-path scale s (B,) and
// a d_out buffer, which receives d exactly as rounded before the LN; the
// serving mode passes neither (s = 1, d not stored).
// Weights arrive in the reference layouts: dww (49, C) f32 tap-major (the
// wrapper transposes the (C,1,7,7) conv weight), W1 (4C, C) and W2 (C, 4C)
// in T; biases, LN affine and gamma in f32. Any C in [1, 1024].
//
// What bounds it on an H100: the two products, 8*C^2 multiply-adds per
// pixel against 49*C for the stencil, make the block compute-bound (at
// C=384, B=16 a stage-3 launch is ~68 GFLOP against ~45 MB of traffic).
// What the design does about it: each thread block takes M=16 output
// pixels, keeps d/xn, the hidden chunk and the (M, C) f32 sum in shared
// memory, and walks the 4C hidden units in chunks of 64, so the (M, 4C)
// hidden never reaches device memory, as on the TPU. Device memory sees one
// read of x (the 7x7 halo comes back through L2) and one write of out.
// Weight tiles are staged through shared memory with coalesced loads and
// the products run as f32 FMAs on the CUDA cores with a 4x1 register tile.
// That caps it at the f32 FMA rate (67 TFLOP/s), not the bf16 tensor-core
// rate the bound assumes; wgmma/TMA tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 7;        // dwconv kernel size
constexpr int P = 3;        // dwconv padding
constexpr int M = 16;       // output pixels per thread block
constexpr int NT = 256;     // threads per block
constexpr int NH = 64;      // hidden units per chunk
constexpr int KT = 64;      // reduction depth of one staged W1 tile
constexpr int CT = 64;      // output channels of one staged W2 tile
constexpr int WT_LD = 65;   // padded row of the staged tile (no bank conflicts)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}

// TRAIN = the save mode (dps and d_out given); a template argument, so the
// serving instantiation is the same code as without the mode.
template <typename T, bool TRAIN>
__global__ void __launch_bounds__(NT) fused_block_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ dww, const float* __restrict__ dwb,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ gamma, const float* __restrict__ dps, T* __restrict__ d_out,
    int B, int H, int W, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int CS = (C + 3) & ~3;        // row stride: float4-aligned, zero tail
  float* xs = smem;                   // [M][CS]  d, then xn
  float* acc = xs + M * CS;           // [M][CS]  f32 sum of h . W2^T
  float* hs = acc + M * CS;           // [M][NH]  gelu(h) of the current chunk
  float* wt = hs + M * NH;            // [64][WT_LD] staged weight tile

  const int tid = threadIdx.x;
  const int HW = H * W;
  const long long npix = (long long)B * HW;
  const long long p0 = (long long)blockIdx.x * M;
  const int hidden = 4 * C;

  // ---- phase 1: 7x7 depthwise stencil of the block's M pixels -----------
  for (int c = tid; c < CS; c += NT) {
    for (int m = 0; m < M; ++m) {
      const long long p = p0 + m;
      float v = 0.f;
      if (c < C && p < npix) {
        const int b = (int)(p / HW);
        const int r = (int)(p - (long long)b * HW);
        const int h = r / W, w = r - (r / W) * W;
        const T* xb = x + (long long)b * HW * C + c;
        float a = dwb[c];
        for (int dy = 0; dy < K; ++dy) {
          const int hh = h + dy - P;
          if (hh < 0 || hh >= H) continue;
          for (int dx = 0; dx < K; ++dx) {
            const int ww = w + dx - P;
            if (ww < 0 || ww >= W) continue;
            a += to_f<T>(xb[((long long)hh * W + ww) * C]) * dww[(dy * K + dx) * C + c];
          }
        }
        v = round_t<T>(a);
        if constexpr (TRAIN) d_out[p * C + c] = from_f<T>(a);
      }
      xs[m * CS + c] = v;
      acc[m * CS + c] = 0.f;
    }
  }
  __syncthreads();

  // ---- phase 2: LayerNorm, one warp per pixel -----------------------------
  const int warp = tid >> 5, lane = tid & 31;
  const float inv_c = 1.0f / (float)C;
  for (int m = warp; m < M; m += NT / 32) {
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = xs[m * CS + c];
      s += v;
      ss += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mean = s * inv_c;
    const float var = fmaxf(ss * inv_c - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < C; c += 32) {
      const float v = (xs[m * CS + c] - mean) * rstd;
      xs[m * CS + c] = round_t<T>(v * lnw[c] + lnb[c]);
    }
  }
  __syncthreads();

  // ---- phase 3: MLP over hidden chunks; thread = 4 pixels x 1 column -----
  const int jn = tid % NH;            // hidden unit (3a) / channel (3b) in tile
  const int mg = (tid / NH) * 4;      // first of this thread's 4 pixels
  for (int j0 = 0; j0 < hidden; j0 += NH) {
    // 3a: h[m][j0+jn] = xn[m] . W1[j0+jn]
    float h4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < CS; k0 += KT) {
      for (int i = tid; i < NH * KT; i += NT) {
        const int jj = i / KT, kk = i - (i / KT) * KT;
        const int j = j0 + jj, k = k0 + kk;
        wt[kk * WT_LD + jj] = (j < hidden && k < C) ? to_f<T>(w1[(long long)j * C + k]) : 0.f;
      }
      __syncthreads();
      const int kn = min(KT, CS - k0);
      for (int kk = 0; kk < kn; kk += 4) {
        const float wa = wt[(kk + 0) * WT_LD + jn];
        const float wb = wt[(kk + 1) * WT_LD + jn];
        const float wc = wt[(kk + 2) * WT_LD + jn];
        const float wd = wt[(kk + 3) * WT_LD + jn];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(&xs[(mg + i) * CS + k0 + kk]);
          h4[i] += a.x * wa + a.y * wb + a.z * wc + a.w * wd;
        }
      }
      __syncthreads();
    }
    {
      const int j = j0 + jn;
      const float bj = j < hidden ? b1[j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hs[(mg + i) * NH + jn] = j < hidden ? round_t<T>(gelu_tanh(h4[i] + bj)) : 0.f;
    }
    __syncthreads();

    // 3b: acc[m][c] += h[m][j0:j0+NH] . W2[c][j0:j0+NH]
    for (int c0 = 0; c0 < C; c0 += CT) {
      for (int i = tid; i < CT * NH; i += NT) {
        const int cc = i / NH, jj = i - (i / NH) * NH;
        const int c = c0 + cc, j = j0 + jj;
        wt[jj * WT_LD + cc] = (c < C && j < hidden) ? to_f<T>(w2[(long long)c * hidden + j]) : 0.f;
      }
      __syncthreads();
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int jj = 0; jj < NH; jj += 4) {
        const float wa = wt[(jj + 0) * WT_LD + jn];
        const float wb = wt[(jj + 1) * WT_LD + jn];
        const float wc = wt[(jj + 2) * WT_LD + jn];
        const float wd = wt[(jj + 3) * WT_LD + jn];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 hv = *reinterpret_cast<const float4*>(&hs[(mg + i) * NH + jj]);
          a4[i] += hv.x * wa + hv.y * wb + hv.z * wc + hv.w * wd;
        }
      }
      const int c = c0 + jn;
      if (c < C) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[(mg + i) * CS + c] += a4[i];
      }
      __syncthreads();
    }
  }

  // ---- phase 4: bias, layer scale, residual, one rounding ----------------
  for (int idx = tid; idx < M * C; idx += NT) {
    const int m = idx / C, c = idx - (idx / C) * C;
    const long long p = p0 + m;
    if (p >= npix) continue;
    float y = acc[m * CS + c] + b2[c];
    if (gamma != nullptr) y *= gamma[c];
    if constexpr (TRAIN) y *= dps[p / HW];
    const long long off = p * C + c;
    out[off] = from_f<T>(to_f<T>(x[off]) + y);
  }
}

template <typename T, bool TRAIN>
int launch(const void* x, void* out, const float* dww, const float* dwb,
           const float* lnw, const float* lnb, const void* w1, const float* b1,
           const void* w2, const float* b2, const float* gamma, const float* s, void* d_out,
           int B, int H, int W, int C, float eps, cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  if (npix == 0) return 0;
  const int cs = (C + 3) & ~3;
  const size_t smem = sizeof(float) * (2 * (size_t)M * cs + (size_t)M * NH + 64 * WT_LD);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<T, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((npix + M - 1) / M);
  fused_block_kernel<T, TRAIN><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), dww, dwb, lnw, lnb,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, gamma, s,
      static_cast<T*>(d_out), B, H, W, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// gamma may be null; s and d_out are both given (save mode) or both null.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_block_forward(
    const void* x, void* out, const void* dww, const void* dwb,
    const void* lnw, const void* lnb, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* s, void* d_out,
    int B, int H, int W, int C, float eps, int dtype, void* stream) {
  if (C < 1 || C > 1024 || B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if ((s == nullptr) != (d_out == nullptr)) return (int)cudaErrorInvalidValue;
  const bool train = s != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FB_LAUNCH(T, TR)                                                              \
  launch<T, TR>(x, out, f(dww), f(dwb), f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(gamma), \
                f(s), d_out, B, H, W, C, eps, st)
  if (dtype == 0) return train ? FB_LAUNCH(float, true) : FB_LAUNCH(float, false);
  if (dtype == 1) return train ? FB_LAUNCH(__nv_bfloat16, true) : FB_LAUNCH(__nv_bfloat16, false);
#undef FB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

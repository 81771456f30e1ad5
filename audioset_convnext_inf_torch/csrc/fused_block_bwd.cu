// Fused ConvNeXt block backward for Hopper (sm_90a), NHWC layout.
//
// Replaces the TPU kernel of the JAX package,
// ops/pallas_fused_block_bwd.py::_bwd_kernel. From the block input x, the
// dwconv output d saved by the forward's save mode and the upstream
// gradient dy, one call computes dx and every weight gradient of
//
//   y = x + s[b] * gamma * (gelu_tanh(LN(d) . W1^T + b1) . W2^T + b2),  d = dwconv7x7(x) + b_dw
//
// recomputing the LN statistics, h1 and the GELU from d. T is the
// activation type (float or bf16); sums are f32; the rounding points are
// the TPU kernel's: xn, gact, dys = dy*s, dz2 = dys*gamma, dh1 and dd round
// to T, and dx = round(dy + dgrad stencil of dd).
//
// What bounds it on an H100: five products of 2*N*C*4C operations each
// (h1, dg = dz2 . W2, dxn = dh1 . W1, M = dys^T . gact, dW1 = dh1^T . xn)
// against 2*49*C per pixel for the two stencils:
// 2*N*(2*C*49 + 5*C*4C) operations, 84.3 GFLOP at B=16 stage 3 (N=14112,
// C=384) and 82.4 GFLOP at stage 4 (N=3472, C=768), 0.085 and 0.083 ms at
// the bf16 tensor-core peak. Operations bound it, as in the forward.
//
// What the design does about it, in this first version: each launch is a
// plain kernel with f32 FMAs on the CUDA cores (no tensor cores yet), and
// every sum has a fixed order, so two runs give bit-equal gradients (no
// float atomics). On the TPU the grid runs in order and the weight
// gradients sum in VMEM across it; here blocks run in parallel, so:
//   1. chain_kernel: one block per 16 pixels recomputes LN, h1 and the
//      GELU, runs the per-pixel products dg = dz2 . W2 and dxn = dh1 . W1
//      through shared memory (the (16, 4C) hidden stays on chip, in chunks
//      of 64 units), the LN backward, and writes dd. It also writes xn,
//      dys, gact and dh1 in T to a workspace the wrapper allocates, and
//      per-block partial sums of the vector gradients.
//   2. wgrad_gemm_kernel, twice: the two products that contract over all
//      pixels, M (C x 4C) and dW1 (4C x C), as 64x64 output tiles each
//      looping over the pixels in order. The workspace round trip through
//      device memory (about 108 MB at stage 3 in bf16) is one the TPU
//      kernel avoids; fusing it back is later work.
//   3. dw_wgrad_kernel: the 49 x C depthwise weight gradient, per-chunk
//      partial sums over 256-pixel chunks.
//   4. dw_dgrad_kernel: dx, one thread per output element.
//   5. sum_rows_kernel, twice: the partial sums of steps 1 and 3 in order.
// Seven launches per call. dW2 = M * gamma, db2 = gamma * sum(dys) and
// dgamma come from M outside, in the wrapper, as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 7;        // dwconv kernel size
constexpr int P = 3;        // dwconv padding
constexpr int M = 16;       // pixels per chain block
constexpr int NT = 256;     // threads per block
constexpr int NH = 64;      // hidden units per chunk
constexpr int KT = 64;      // reduction depth of one staged tile
constexpr int CT = 64;      // output channels of one staged tile
constexpr int WT_LD = 65;   // padded row of the staged tile (no bank conflicts)
constexpr int GT = 64;      // output tile edge of the weight-gradient products
constexpr int GP = 32;      // pixels per staged step of those products
constexpr int WG_C = 32;    // channels per dw_wgrad block

constexpr float C0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float C1 = 0.044715f;

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

template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[m][j] += sum_k src[m][k] * wt[k][j] over one staged (kn x 64) tile,
// for this thread's 4 pixels (mg..mg+3) and column jn.
__device__ __forceinline__ void tile_fma(float (&r)[4], const float* src, int ld, int k0,
                                         int kn, const float* wt, int jn, int mg) {
  for (int kk = 0; kk < kn; kk += 4) {
    const float wa = wt[(kk + 0) * WT_LD + jn];
    const float wb = wt[(kk + 1) * WT_LD + jn];
    const float wc = wt[(kk + 2) * WT_LD + jn];
    const float wd = wt[(kk + 3) * WT_LD + jn];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(&src[(mg + i) * ld + k0 + kk]);
      r[i] += a.x * wa + a.y * wb + a.z * wc + a.w * wd;
    }
  }
}

// part row of one chain block: [sdys | dlnb | dlns | db_dw] (C each), db1 (4C)
template <typename T>
__global__ void __launch_bounds__(NT) chain_kernel(
    const T* __restrict__ d, const T* __restrict__ dy,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ w2, const float* __restrict__ gamma, const float* __restrict__ dps,
    T* __restrict__ xn_ws, T* __restrict__ dys_ws, T* __restrict__ gact_ws,
    T* __restrict__ dh1_ws, T* __restrict__ dd_out, float* __restrict__ part,
    long long npix, int HW, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int CS = (C + 3) & ~3;        // row stride: float4-aligned, zero tail
  float* xs = smem;                   // [M][CS] xn
  float* zs = xs + M * CS;            // [M][CS] dz2
  float* acc = zs + M * CS;           // [M][CS] dxn = dh1 . W1
  float* hs = acc + M * CS;           // [M][NH] dh1 of the current chunk (rounded)
  float* fs = hs + M * NH;            // [M][NH] dh1 of the current chunk (f32)
  float* wt = fs + M * NH;            // [64][WT_LD] staged weight tile
  float* mean_s = wt + 64 * WT_LD;    // [M] per-pixel LN statistics and
  float* rstd_s = mean_s + M;         //     the LN backward's two means
  float* m1_s = rstd_s + M;
  float* m2_s = m1_s + M;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p0 = (long long)blockIdx.x * M;
  const int hidden = 4 * C;
  const float inv_c = 1.0f / (float)C;
  float* pb = part + (long long)blockIdx.x * 8 * C;

  // ---- 1a: LN statistics of d, one warp per pixel (as in the forward) ----
  for (int m = warp; m < M; m += NT / 32) {
    const long long p = p0 + m;
    float s = 0.f, ss = 0.f;
    if (p < npix) {
      for (int c = lane; c < C; c += 32) {
        const float v = to_f<T>(d[p * C + c]);
        s += v;
        ss += v * v;
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mean = s * inv_c;
      mean_s[m] = mean;
      rstd_s[m] = rsqrtf(fmaxf(ss * inv_c - mean * mean, 0.f) + eps);
    }
  }
  __syncthreads();

  // ---- 1b: xn, dys, dz2 per channel; partial sum of dy*s -----------------
  for (int c = tid; c < CS; c += NT) {
    float sd = 0.f;
    for (int m = 0; m < M; ++m) {
      const long long p = p0 + m;
      float xv = 0.f, zv = 0.f;
      if (c < C && p < npix) {
        const long long off = p * C + c;
        const float xhat = (to_f<T>(d[off]) - mean_s[m]) * rstd_s[m];
        const T xn = from_f<T>(xhat * lnw[c] + lnb[c]);
        xn_ws[off] = xn;
        xv = to_f<T>(xn);
        const float dys32 = to_f<T>(dy[off]) * dps[p / HW];
        dys_ws[off] = from_f<T>(dys32);
        zv = round_t<T>(dys32 * gamma[c]);
        sd += dys32;
      }
      xs[m * CS + c] = xv;
      zs[m * CS + c] = zv;
      acc[m * CS + c] = 0.f;
    }
    if (c < C) pb[c] = sd;
  }
  __syncthreads();

  // ---- 2: the hidden units in chunks of NH; thread = 4 pixels x 1 unit ---
  const int jn = tid % NH;
  const int mg = (tid / NH) * 4;
  for (int j0 = 0; j0 < hidden; j0 += NH) {
    // 2a: h1 = xn . W1[j]
    float h4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < CS; k0 += KT) {
      for (int i = tid; i < NH * KT; i += NT) {
        const int jj = i / KT, kk = i - (i / KT) * KT;
        const int j = j0 + jj, k = k0 + kk;
        wt[kk * WT_LD + jj] = (j < hidden && k < C) ? to_f<T>(w1[(long long)j * C + k]) : 0.f;
      }
      __syncthreads();
      tile_fma(h4, xs, CS, k0, min(KT, CS - k0), wt, jn, mg);
      __syncthreads();
    }
    // 2b: dg = dz2 . W2[:, j]
    float g4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < CS; k0 += KT) {
      for (int i = tid; i < NH * KT; i += NT) {
        const int kk = i / NH, jj = i - (i / NH) * NH;
        const int j = j0 + jj, k = k0 + kk;
        wt[kk * WT_LD + jj] = (j < hidden && k < C) ? to_f<T>(w2[(long long)k * hidden + j]) : 0.f;
      }
      __syncthreads();
      tile_fma(g4, zs, CS, k0, min(KT, CS - k0), wt, jn, mg);
      __syncthreads();
    }
    // 2c: GELU and its derivative from h1; dh1 = dg * gelu'(h1)
    {
      const int j = j0 + jn;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mg + i;
        const long long p = p0 + m;
        float f = 0.f, fr = 0.f;
        if (j < hidden) {
          const float h1 = h4[i] + b1[j];
          const float th = tanhf(C0 * (h1 + C1 * h1 * h1 * h1));
          const float gp = 0.5f * (1.0f + th) + 0.5f * h1 * (1.0f - th * th) * C0 *
                           (1.0f + 3.0f * C1 * h1 * h1);
          f = g4[i] * gp;
          const T dh1 = from_f<T>(f);
          fr = to_f<T>(dh1);
          if (p < npix) {
            gact_ws[p * hidden + j] = from_f<T>(0.5f * h1 * (1.0f + th));
            dh1_ws[p * hidden + j] = dh1;
          }
        }
        hs[m * NH + jn] = fr;
        fs[m * NH + jn] = f;
      }
    }
    __syncthreads();
    if (tid < NH && j0 + tid < hidden) {
      float sb = 0.f;
      for (int m = 0; m < M; ++m) sb += fs[m * NH + tid];
      pb[4 * C + j0 + tid] = sb;
    }
    // 2d: dxn[m][c] += dh1[m][j0:j0+NH] . W1[j0:j0+NH][c]
    for (int c0 = 0; c0 < C; c0 += CT) {
      for (int i = tid; i < CT * NH; i += NT) {
        const int jj = i / CT, cc = i - (i / CT) * CT;
        const int c = c0 + cc, j = j0 + jj;
        wt[jj * WT_LD + cc] = (c < C && j < hidden) ? to_f<T>(w1[(long long)j * C + c]) : 0.f;
      }
      __syncthreads();
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      tile_fma(a4, hs, NH, 0, NH, wt, jn, mg);
      const int c = c0 + jn;
      if (c < C) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[(mg + i) * CS + c] += a4[i];
      }
      __syncthreads();
    }
  }

  // ---- 3a: the LN backward's per-pixel means, one warp per pixel ---------
  for (int m = warp; m < M; m += NT / 32) {
    const long long p = p0 + m;
    float s1 = 0.f, s2 = 0.f;
    if (p < npix) {
      for (int c = lane; c < C; c += 32) {
        const float xhat = (to_f<T>(d[p * C + c]) - mean_s[m]) * rstd_s[m];
        const float dxh = acc[m * CS + c] * lnw[c];
        s1 += dxh;
        s2 += dxh * xhat;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m1_s[m] = s1 * inv_c;
      m2_s[m] = s2 * inv_c;
    }
  }
  __syncthreads();

  // ---- 3b: dd, and partial sums of dxn, dxn*xhat and dd per channel ------
  for (int c = tid; c < C; c += NT) {
    float sb = 0.f, ss = 0.f, sw = 0.f;
    for (int m = 0; m < M; ++m) {
      const long long p = p0 + m;
      if (p >= npix) break;
      const long long off = p * C + c;
      const float dxn = acc[m * CS + c];
      const float xhat = (to_f<T>(d[off]) - mean_s[m]) * rstd_s[m];
      const float ddc = rstd_s[m] * (dxn * lnw[c] - m1_s[m] - xhat * m2_s[m]);
      dd_out[off] = from_f<T>(ddc);
      sb += dxn;
      ss += dxn * xhat;
      sw += ddc;
    }
    pb[C + c] = sb;
    pb[2 * C + c] = ss;
    pb[3 * C + c] = sw;
  }
}

// out (R x N) f32 = A^T . Bm over npix pixels: A (npix x R), Bm (npix x N),
// both pixel-major in T. One 64x64 output tile per block; thread = 4x4.
template <typename T>
__global__ void __launch_bounds__(NT) wgrad_gemm_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, float* __restrict__ out,
    long long npix, int R, int N) {
  __shared__ __align__(16) float as[GP][GT];
  __shared__ __align__(16) float bs[GP][GT];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long q0 = 0; q0 < npix; q0 += GP) {
    for (int i = tid; i < GP * GT; i += NT) {
      const int pp = i / GT, cc = i - (i / GT) * GT;
      const long long q = q0 + pp;
      as[pp][cc] = (q < npix && r0 + cc < R) ? to_f<T>(A[q * R + r0 + cc]) : 0.f;
      bs[pp][cc] = (q < npix && n0 + cc < N) ? to_f<T>(Bm[q * N + n0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < GP; ++pp) {
      const float4 a = *reinterpret_cast<const float4*>(&as[pp][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[pp][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)r * N + n] = acc[i][j];
    }
  }
}

// part[chunk][tap][c] = sum over the chunk's pixels of x(window tap) * dd.
// Block = 32 channels x 8 tap groups (taps g, g+8, ...).
template <typename T>
__global__ void __launch_bounds__(NT) dw_wgrad_kernel(
    const T* __restrict__ x, const T* __restrict__ dd, float* __restrict__ part,
    long long npix, int H, int W, int C, int chunk) {
  const int c = blockIdx.x * WG_C + (threadIdx.x % WG_C);
  const int g = threadIdx.x / WG_C;
  const long long q0 = (long long)blockIdx.y * chunk;
  const long long q1 = q0 + chunk < npix ? q0 + chunk : npix;
  const int HW = H * W;
  float a[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < C) {
    for (long long q = q0; q < q1; ++q) {
      const long long b = q / HW;
      const int r = (int)(q - b * HW);
      const int h = r / W, w = r - (r / W) * W;
      const float gd = to_f<T>(dd[q * C + c]);
      const T* xb = x + b * HW * C + c;
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const int tap = g + 8 * i;
        if (tap >= K * K) break;
        const int hh = h + tap / K - P, ww = w + tap % K - P;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          a[i] += to_f<T>(xb[((long long)hh * W + ww) * C]) * gd;
      }
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int tap = g + 8 * i;
      if (tap < K * K) part[((long long)blockIdx.y * K * K + tap) * C + c] = a[i];
    }
  }
}

// dx = round(dy + sum_taps w[tap] * dd[pixel - tap offset]): the transpose
// of the forward stencil, one thread per output element.
template <typename T>
__global__ void __launch_bounds__(NT) dw_dgrad_kernel(
    const T* __restrict__ dd, const T* __restrict__ dy, const float* __restrict__ dww,
    T* __restrict__ dx, long long npix, int H, int W, int C) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= npix * C) return;
  const long long q = idx / C;
  const int c = (int)(idx - q * C);
  const int HW = H * W;
  const long long b = q / HW;
  const int r = (int)(q - b * HW);
  const int h = r / W, w = r - (r / W) * W;
  const T* db = dd + b * HW * C + c;
  float a = to_f<T>(dy[idx]);
  for (int ky = 0; ky < K; ++ky) {
    const int hh = h - ky + P;
    if (hh < 0 || hh >= H) continue;
    for (int kx = 0; kx < K; ++kx) {
      const int ww = w - kx + P;
      if (ww < 0 || ww >= W) continue;
      a += to_f<T>(db[((long long)hh * W + ww) * C]) * dww[(ky * K + kx) * C + c];
    }
  }
  dx[idx] = from_f<T>(a);
}

// out[col] = sum over rows, in row order, of part[row][col].
__global__ void __launch_bounds__(NT) sum_rows_kernel(
    const float* __restrict__ part, long long rows, int cols, float* __restrict__ out) {
  const int col = blockIdx.x * NT + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
  for (long long r = 0; r < rows; ++r) s += part[r * cols + col];
  out[col] = s;
}

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

template <typename T>
int launch(const void* x, const void* d, const void* dy, const float* dww,
           const float* lnw, const float* lnb, const void* w1, const float* b1,
           const void* w2, const float* gamma, const float* dps, void* dx,
           void* xn_ws, void* dys_ws, void* gact_ws, void* dh1_ws, void* dd_ws,
           float* part_chain, float* part_wgrad, float* vec_out, float* dww_out,
           float* m_out, float* dw1_out, int B, int H, int W, int C, int chunk, float eps,
           cudaStream_t st) {
  const long long npix = (long long)B * H * W;
  if (npix == 0) return 0;
  const int cs = (C + 3) & ~3;
  const size_t smem = sizeof(float) * (3 * (size_t)M * cs + 2 * (size_t)M * NH +
                                       64 * WT_LD + 4 * M);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  const auto mt = [](void* p) { return static_cast<T*>(p); };
  const long long nblk = (npix + M - 1) / M;
  chain_kernel<T><<<(unsigned)nblk, NT, smem, st>>>(
      ct(d), ct(dy), lnw, lnb, ct(w1), b1, ct(w2), gamma, dps, mt(xn_ws), mt(dys_ws),
      mt(gact_ws), mt(dh1_ws), mt(dd_ws), part_chain, npix, H * W, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int hidden = 4 * C;
  // M (C x 4C) = dys^T . gact; dW1 (4C x C) = dh1^T . xn
  wgrad_gemm_kernel<T><<<dim3(blocks(hidden, GT), blocks(C, GT)), NT, 0, st>>>(
      ct(dys_ws), ct(gact_ws), m_out, npix, C, hidden);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wgrad_gemm_kernel<T><<<dim3(blocks(C, GT), blocks(hidden, GT)), NT, 0, st>>>(
      ct(dh1_ws), ct(xn_ws), dw1_out, npix, hidden, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long nchunk = (npix + chunk - 1) / chunk;
  dw_wgrad_kernel<T><<<dim3(blocks(C, WG_C), (unsigned)nchunk), NT, 0, st>>>(
      ct(x), ct(dd_ws), part_wgrad, npix, H, W, C, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_dgrad_kernel<T><<<blocks(npix * C, NT), NT, 0, st>>>(
      ct(dd_ws), ct(dy), dww, mt(dx), npix, H, W, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows_kernel<<<blocks(8 * C, NT), NT, 0, st>>>(part_chain, nblk, 8 * C, vec_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows_kernel<<<blocks(K * K * C, NT), NT, 0, st>>>(part_wgrad, nchunk, K * K * C, dww_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// Inputs: x, d, dy (B,H,W,C) in T; dww (49,C) f32 tap-major; lnw, lnb, b1,
// gamma (f32); W1 (4C,C), W2 (C,4C) in T; s (B,) f32. Outputs: dx in T;
// vec_out (8C) f32 = [sum dy*s | dlnb | dlns | db_dw | db1 (4C)]; dww_out
// (49,C), m_out (C,4C) = (dy*s)^T . gact, dw1_out (4C,C), all f32.
// Workspace the caller allocates: xn, dys, dd (B*H*W*C) and gact, dh1
// (B*H*W*4C) in T; part_chain (ceil(B*H*W/16) * 8C) and part_wgrad
// (ceil(B*H*W/chunk) * 49C) in f32. Returns the first cudaError_t of the
// seven launches (0 = launched).
extern "C" int fused_block_backward(
    const void* x, const void* d, const void* dy, const void* dww, const void* lnw,
    const void* lnb, const void* w1, const void* b1, const void* w2, const void* gamma,
    const void* s, void* dx, void* xn_ws, void* dys_ws, void* gact_ws, void* dh1_ws,
    void* dd_ws, void* part_chain, void* part_wgrad, void* vec_out, void* dww_out,
    void* m_out, void* dw1_out, int B, int H, int W, int C, int chunk, float eps, int dtype,
    void* stream) {
  if (C < 1 || C > 1024 || B < 0 || H < 0 || W < 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto fm = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FBB_LAUNCH(T)                                                                    \
  launch<T>(x, d, dy, f(dww), f(lnw), f(lnb), w1, f(b1), w2, f(gamma), f(s), dx, xn_ws,  \
            dys_ws, gact_ws, dh1_ws, dd_ws, fm(part_chain), fm(part_wgrad), fm(vec_out), \
            fm(dww_out), fm(m_out), fm(dw1_out), B, H, W, C, chunk, eps, st)
  if (dtype == 0) return FBB_LAUNCH(float);
  if (dtype == 1) return FBB_LAUNCH(__nv_bfloat16);
#undef FBB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

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
//
// bf16 (the serving and training paths): fused_block_mma_kernel<MT, NCMAX,
// TRAIN>. One block of 256 threads takes MT consecutive pixels (flattened
// over b, h, w; MT = 64 up to C = 384, 32 above: the launch plan of
// mma_bf16.cuh, which the wrapper's mirrors):
//   1. the 7x7 stencil on the CUDA cores: a thread takes a channel pair
//      and a run of up to 8 pixels of one image row and walks each input
//      row once (bf16x2 loads of x through L1/L2, the run's sums and the
//      row's taps in registers); d rounded to bf16 into shared memory (and
//      to d_out in save mode). Loading all 49 taps per output instead made
//      the stencil two thirds of the kernel: the shared-memory carve-out
//      leaves L1 too small for the 7x7 halo;
//   2. LayerNorm, one warp per pixel, xn (bf16) written over d;
//   3. the 4C hidden units in chunks of 128: h = xn . W1[chunk]^T on the
//      tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), + b1, GELU
//      (tanhf), rounded to bf16 into shared memory, then
//      acc += h . W2[:, chunk]^T on the tensor cores. W1 and W2 stream as
//      bf16 tiles of 128 rows x 64 through a 3-stage cp.async ring
//      (mma_bf16.cuh's Ring; the first tiles are in flight during the
//      stencil); the (MT, 4C) hidden
//      never leaves the chip, as on the TPU;
//   4. the (MT, C) f32 sum lives in registers, split over the 8 warps by
//      output channel (MT*NCMAX/2 per thread, NCMAX = ceil(C/128) rounded
//      up to a width class); + b2, * gamma, * s, + x, one rounding,
//      straight from the registers.
// The channel count is padded to CP = 128*ceil(C/128) for the tiles: the
// wrapper hands over W1 (4CP, CP) and W2 (CP, 4CP), zero-padded when
// C != CP, so every 16-byte copy is aligned and in bounds.
//
// f32 (the f32 parity config never launches it; kept for the f32 kernel
// tests): fused_block_f32_kernel keeps the first version's scheme, 16
// pixels per block, weight tiles staged through shared memory, products as
// f32 FMAs on the CUDA cores. TF32 tensor cores would break its 1e-4 f32
// tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;  // bf16, the tile primitives and the launch plan

constexpr int K = 7;        // dwconv kernel size
constexpr int P = 3;        // dwconv padding
constexpr int NT = 256;     // threads per block

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}


// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int SEG = 8;          // longest run of row pixels one stencil item covers

size_t mma_smem_bytes(int mt, int cp) {
  return sizeof(bf16) * ((size_t)mt * (cp + 8) + (size_t)mt * HLD + (size_t)STAGES * STAGE);
}

template <int MT, int NCMAX, bool TRAIN>
__global__ void __launch_bounds__(NT, MT <= 16 ? 2 : 1) fused_block_mma_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ out,
    const float* __restrict__ dww, const float* __restrict__ dwb,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ gamma, const float* __restrict__ dps, bf16* __restrict__ d_out,
    int B, int H, int W, int C, int cp, float eps) {
  constexpr int MI = MT / 16;           // m16 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XLD = cp + 8;               // padded row of xs (bf16)
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [MT][XLD] d, then xn
  bf16* hs = xs + MT * XLD;                      // [MT][HLD] GELU output of the chunk
  bf16* ring = hs + MT * HLD;                    // [STAGES][STAGE] weight tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HW = H * W;
  const long long npix = (long long)B * HW;
  const long long p0 = (long long)blockIdx.x * MT;
  const int hidden = 4 * C;
  const int kc = cp / KT;               // W1 tiles per chunk (= W2 tiles per chunk)
  const int nc = cp / TR;               // 128-channel output blocks
  const int tpc = 2 * kc;               // tiles per chunk
  const int ntiles = (4 * cp / NH) * tpc;

  // tile t of the stream: per chunk, kc tiles of W1[chunk rows][k0:k0+64],
  // then for each output block cb two tiles W2[cb rows][chunk half]
  auto load_tile = [&](int t, bf16* dst) {
    const int chunk = t / tpc, i = t - chunk * tpc;
    const bf16* src;
    int ld;
    if (i < kc) {
      src = w1 + (long long)chunk * NH * cp + i * KT;
      ld = cp;
    } else {
      const int ii = i - kc;
      src = w2 + (long long)(ii >> 1) * TR * 4 * cp + chunk * NH + (ii & 1) * KT;
      ld = 4 * cp;
    }
#pragma unroll
    for (int q = 0; q < TR * KT / 8 / NT; ++q) {
      const int idx = tid + q * NT, r = idx >> 3, ch = idx & 7;
      cp_async16(dst + r * TLD + ch * 8, src + (long long)r * ld + ch * 8);
    }
  };
  Ring<STAGES, STAGE> tiles(ring, ntiles);
  tiles.prime(load_tile);  // in flight during the stencil

  // ---- 1: 7x7 depthwise stencil ------------------------------------------
  // Work item = a run of up to SEG consecutive pixels of one image row x a
  // channel pair. The thread walks each of the 7 input rows once, keeping
  // the run's sums and the row's 7 tap weights in registers, so an output
  // costs about 12 loads of x instead of 49; the sums take the taps in
  // the order dy, dx as before (out-of-image taps add +-0).
  __shared__ int seg_tab[MT];  // run: first pixel (from p0) << 8 | length
  __shared__ int seg_n;
  const long long p_end = p0 + MT < npix ? p0 + MT : npix;
  if (tid == 0) {
    int n = 0;
    for (long long p = p0; p < p_end;) {
      const int w = (int)(p % W);
      const int len = (int)min((long long)min(SEG, W - w), p_end - p);
      seg_tab[n++] = ((int)(p - p0) << 8) | len;
      p += len;
    }
    seg_n = n;
  }
  for (int i = (int)(p_end - p0) * XLD + tid; i < MT * XLD; i += NT) xs[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  const bool vec = (C % 2 == 0) && ((reinterpret_cast<uintptr_t>(x) & 3) == 0);
  const int npair = (C + 1) / 2;
#ifdef ABLATE_STENCIL
  const int n_items = 0;  // d left zero
#else
  const int n_items = seg_n * npair;
#endif
  for (int it = tid; it < n_items; it += NT) {
    const int s = it / npair, c = (it - s * npair) * 2;
    const int m0 = seg_tab[s] >> 8, len = seg_tab[s] & 255;
    const long long p = p0 + m0, row = p / W;
    const int w0 = (int)(p - row * W);
    const int b = (int)(row / H), h = (int)(row - (long long)b * H);
    const bool two = c + 1 < C;
    float a0[SEG], a1[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      a0[j] = dwb[c];
      a1[j] = two ? dwb[c + 1] : 0.f;
    }
    for (int dy = 0; dy < K; ++dy) {
      const int hh = h + dy - P;
      if (hh < 0 || hh >= H) continue;
      const bf16* xr = x + ((long long)b * H + hh) * W * C + c;
      float k0[K], k1[K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float* wt = dww + (dy * K + dx) * C + c;
        k0[dx] = wt[0];
        k1[dx] = two ? wt[1] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < SEG + K - 1; ++k) {
        const int ww = w0 - P + k;
        float v0 = 0.f, v1 = 0.f;
        if (k < len + K - 1 && ww >= 0 && ww < W) {
          const bf16* xp = xr + (long long)ww * C;
          if (vec) {
            const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));
            v0 = v.x;
            v1 = v.y;
          } else {
            v0 = __bfloat162float(xp[0]);
            v1 = two ? __bfloat162float(xp[1]) : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          const int dx = k - j;
          if (dx >= 0 && dx < K) {
            a0[j] += v0 * k0[dx];
            a1[j] += v1 * k1[dx];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      if (j >= len) break;
      const __nv_bfloat162 dv = __floats2bfloat162_rn(a0[j], two ? a1[j] : 0.f);
      *reinterpret_cast<__nv_bfloat162*>(xs + (m0 + j) * XLD + c) = dv;
      if constexpr (TRAIN) {
        d_out[(p + j) * C + c] = dv.x;
        if (two) d_out[(p + j) * C + c + 1] = dv.y;
      }
    }
  }
  __syncthreads();

  // ---- 2: LayerNorm, one warp per pixel -----------------------------------
  const float inv_c = 1.0f / (float)C;
  for (int m = warp; m < MT; m += NT / 32) {
    bf16* row = xs + m * XLD;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = __bfloat162float(row[c]);
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
    for (int c = lane; c < cp; c += 32) {
      const float v = (__bfloat162float(row[c]) - mean) * rstd;
      row[c] = __float2bfloat16_rn(c < C ? v * lnw[c] + lnb[c] : 0.f);
    }
  }

  // ---- 3: the MLP over hidden chunks on the tensor cores ------------------
  float acc[NCMAX][MI][2][4];
#pragma unroll
  for (int cb = 0; cb < NCMAX; ++cb)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cb][mi][nn][e] = 0.f;

  const int ar = a_row(lane), ac = a_col(lane), br = b_row(lane), bc = b_col(lane);
  const int g = lane >> 2, tq = lane & 3;
  for (int chunk = 0; chunk < 4 * cp / NH; ++chunk) {
    // 3a: h (MT x 128) = xn . W1[chunk]^T; warp owns hidden units warp*16..+16
    float h[MI][2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[mi][0][e] = h[mi][1][e] = 0.f;
    for (int i = 0; i < kc; ++i) {
      const bf16* tile = tiles.next(load_tile);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, tile + (warp * 16 + br) * TLD + kk * 16 + bc);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t a[4];
          ldmatrix_x4(a, xs + (mi * 16 + ar) * XLD + i * KT + kk * 16 + ac);
          mma_16816(h[mi][0], a, b[0], b[1]);
          mma_16816(h[mi][1], a, b[2], b[3]);
        }
      }
    }
    // 3b: + b1, GELU, one rounding, into hs (read after the next tile's sync)
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int jl = warp * 16 + nn * 8 + 2 * tq;
      const int j = chunk * NH + jl;
      const float bj0 = j < hidden ? b1[j] : 0.f;
      const float bj1 = j + 1 < hidden ? b1[j + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mi * 16 + g + half * 8;
          *reinterpret_cast<uint32_t*>(hs + row * HLD + jl) =
              pack_bf16x2(gelu_tanh(h[mi][nn][2 * half] + bj0),
                          gelu_tanh(h[mi][nn][2 * half + 1] + bj1));
        }
    }
    // 3c: acc[:, cb block] += h . W2[cb block, chunk]^T
#pragma unroll
    for (int cb = 0; cb < NCMAX; ++cb) {
      if (cb < nc) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const bf16* tile = tiles.next(load_tile);
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) {
            uint32_t b[4];
            ldmatrix_x4(b, tile + (warp * 16 + br) * TLD + kk * 16 + bc);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              uint32_t a[4];
              ldmatrix_x4(a, hs + (mi * 16 + ar) * HLD + kh * KT + kk * 16 + ac);
              mma_16816(acc[cb][mi][0], a, b[0], b[1]);
              mma_16816(acc[cb][mi][1], a, b[2], b[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- 4: bias, layer scale, residual, one rounding, from the registers ---
#pragma unroll
  for (int cb = 0; cb < NCMAX; ++cb) {
    if (cb >= nc) continue;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = cb * TR + warp * 16 + nn * 8 + 2 * tq + e1;
        if (c >= C) continue;
        const float bc2 = b2[c];
        const float gc = gamma != nullptr ? gamma[c] : 1.f;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long p = p0 + mi * 16 + g + half * 8;
            if (p >= npix) continue;
            float y = acc[cb][mi][nn][2 * half + e1] + bc2;
            if (gamma != nullptr) y *= gc;
            if constexpr (TRAIN) y *= dps[p / HW];
            const long long off = p * C + c;
            out[off] = __float2bfloat16_rn(__bfloat162float(x[off]) + y);
          }
      }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (the first version's scheme)
// ---------------------------------------------------------------------------

constexpr int M16 = 16;      // output pixels per thread block
constexpr int NH64 = 64;     // hidden units per chunk
constexpr int KT64 = 64;     // reduction depth of one staged W1 tile
constexpr int CT = 64;       // output channels of one staged W2 tile
constexpr int WT_LD = 65;    // padded row of the staged tile (no bank conflicts)

size_t f32_smem_bytes(int C) {
  const int cs = (C + 3) & ~3;
  return sizeof(float) * (2 * (size_t)M16 * cs + (size_t)M16 * NH64 + 64 * WT_LD);
}

template <bool TRAIN>
__global__ void __launch_bounds__(NT) fused_block_f32_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ dww, const float* __restrict__ dwb,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ gamma, const float* __restrict__ dps, float* __restrict__ d_out,
    int B, int H, int W, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int CS = (C + 3) & ~3;        // row stride: float4-aligned, zero tail
  float* xs = smem;                   // [M16][CS]  d, then xn
  float* acc = xs + M16 * CS;         // [M16][CS]  f32 sum of h . W2^T
  float* hs = acc + M16 * CS;         // [M16][NH64] gelu(h) of the current chunk
  float* wt = hs + M16 * NH64;        // [64][WT_LD] staged weight tile

  const int tid = threadIdx.x;
  const int HW = H * W;
  const long long npix = (long long)B * HW;
  const long long p0 = (long long)blockIdx.x * M16;
  const int hidden = 4 * C;

  // ---- phase 1: 7x7 depthwise stencil of the block's M16 pixels -----------
  for (int c = tid; c < CS; c += NT) {
    for (int m = 0; m < M16; ++m) {
      const long long p = p0 + m;
      float v = 0.f;
      if (c < C && p < npix) {
        const int b = (int)(p / HW);
        const int r = (int)(p - (long long)b * HW);
        const int h = r / W, w = r - (r / W) * W;
        const float* xb = x + (long long)b * HW * C + c;
        float a = dwb[c];
        for (int dy = 0; dy < K; ++dy) {
          const int hh = h + dy - P;
          if (hh < 0 || hh >= H) continue;
          for (int dx = 0; dx < K; ++dx) {
            const int ww = w + dx - P;
            if (ww < 0 || ww >= W) continue;
            a += xb[((long long)hh * W + ww) * C] * dww[(dy * K + dx) * C + c];
          }
        }
        v = a;
        if constexpr (TRAIN) d_out[p * C + c] = a;
      }
      xs[m * CS + c] = v;
      acc[m * CS + c] = 0.f;
    }
  }
  __syncthreads();

  // ---- phase 2: LayerNorm, one warp per pixel -----------------------------
  const int warp = tid >> 5, lane = tid & 31;
  const float inv_c = 1.0f / (float)C;
  for (int m = warp; m < M16; m += NT / 32) {
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
      xs[m * CS + c] = v * lnw[c] + lnb[c];
    }
  }
  __syncthreads();

  // ---- phase 3: MLP over hidden chunks; thread = 4 pixels x 1 column -----
  const int jn = tid % NH64;          // hidden unit (3a) / channel (3b) in tile
  const int mg = (tid / NH64) * 4;    // first of this thread's 4 pixels
  for (int j0 = 0; j0 < hidden; j0 += NH64) {
    // 3a: h[m][j0+jn] = xn[m] . W1[j0+jn]
    float h4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < CS; k0 += KT64) {
      for (int i = tid; i < NH64 * KT64; i += NT) {
        const int jj = i / KT64, kk = i - (i / KT64) * KT64;
        const int j = j0 + jj, k = k0 + kk;
        wt[kk * WT_LD + jj] = (j < hidden && k < C) ? w1[(long long)j * C + k] : 0.f;
      }
      __syncthreads();
      const int kn = min(KT64, CS - k0);
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
        hs[(mg + i) * NH64 + jn] = j < hidden ? gelu_tanh(h4[i] + bj) : 0.f;
    }
    __syncthreads();

    // 3b: acc[m][c] += h[m][j0:j0+NH64] . W2[c][j0:j0+NH64]
    for (int c0 = 0; c0 < C; c0 += CT) {
      for (int i = tid; i < CT * NH64; i += NT) {
        const int cc = i / NH64, jj = i - (i / NH64) * NH64;
        const int c = c0 + cc, j = j0 + jj;
        wt[jj * WT_LD + cc] = (c < C && j < hidden) ? w2[(long long)c * hidden + j] : 0.f;
      }
      __syncthreads();
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int jj = 0; jj < NH64; jj += 4) {
        const float wa = wt[(jj + 0) * WT_LD + jn];
        const float wb = wt[(jj + 1) * WT_LD + jn];
        const float wc = wt[(jj + 2) * WT_LD + jn];
        const float wd = wt[(jj + 3) * WT_LD + jn];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 hv = *reinterpret_cast<const float4*>(&hs[(mg + i) * NH64 + jj]);
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

  // ---- phase 4: bias, layer scale, residual ------------------------------
  for (int idx = tid; idx < M16 * C; idx += NT) {
    const int m = idx / C, c = idx - (idx / C) * C;
    const long long p = p0 + m;
    if (p >= npix) continue;
    float y = acc[m * CS + c] + b2[c];
    if (gamma != nullptr) y *= gamma[c];
    if constexpr (TRAIN) y *= dps[p / HW];
    const long long off = p * C + c;
    out[off] = x[off] + y;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x; void* out; const float* dww; const float* dwb; const float* lnw;
  const float* lnb; const void* w1; const float* b1; const void* w2; const float* b2;
  const float* gamma; const float* s; void* d_out; int B, H, W, C, cp; float eps;
};

template <int MT, int NCMAX, bool TRAIN>
int launch_mma(const Args& a, size_t smem, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(fused_block_mma_kernel<MT, NCMAX, TRAIN>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const long long npix = (long long)a.B * a.H * a.W;
  fused_block_mma_kernel<MT, NCMAX, TRAIN><<<(unsigned)((npix + MT - 1) / MT), NT, smem, st>>>(
      static_cast<const bf16*>(a.x), static_cast<bf16*>(a.out), a.dww, a.dwb, a.lnw, a.lnb,
      static_cast<const bf16*>(a.w1), a.b1, static_cast<const bf16*>(a.w2), a.b2, a.gamma, a.s,
      static_cast<bf16*>(a.d_out), a.B, a.H, a.W, a.C, a.cp, a.eps);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int launch_bf16(const Args& a, size_t smem, cudaStream_t st) {
  switch (ncmax(a.cp)) {
    case 3: return launch_mma<plan_mt(384), 3, TRAIN>(a, smem, st);
    case 6: return launch_mma<plan_mt(768), 6, TRAIN>(a, smem, st);
    default: return launch_mma<plan_mt(1024), 8, TRAIN>(a, smem, st);
  }
}

template <bool TRAIN>
int launch_f32(const Args& a, size_t smem, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(fused_block_f32_kernel<TRAIN>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const long long npix = (long long)a.B * a.H * a.W;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  fused_block_f32_kernel<TRAIN><<<(unsigned)((npix + M16 - 1) / M16), NT, smem, st>>>(
      f(a.x), static_cast<float*>(a.out), a.dww, a.dwb, a.lnw, a.lnb, f(a.w1), a.b1, f(a.w2),
      a.b2, a.gamma, a.s, static_cast<float*>(a.d_out), a.B, a.H, a.W, a.C, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory in bytes of one block under the launch plan (mt pixels per
// block, channels padded to cp), or -1 if the kernel cannot run that plan.
// dtype: 0 = float32 (mt = 16, cp = C), 1 = bfloat16 (plan_ok in
// mma_bf16.cuh: cp = 128*ceil(C/128), mt = 64 for cp <= 384, else 32).
extern "C" long long fused_block_plan_smem(int C, int dtype, int mt, int cp) {
  if (C < 1 || C > 1024) return -1;
  size_t smem;
  if (dtype == 0) {
    if (mt != M16 || cp != C) return -1;
    smem = f32_smem_bytes(C);
  } else if (dtype == 1) {
    if (!plan_ok(C, mt, cp)) return -1;
    smem = mma_smem_bytes(mt, cp);
  } else {
    return -1;
  }
  return smem <= MAX_SMEM ? (long long)smem : -1;
}

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// gamma may be null; s and d_out are both given (save mode) or both null.
// mt and cp are the wrapper's launch plan (see fused_block_plan_smem); in
// bf16, w1 is (4cp, cp) and w2 (cp, 4cp), zero beyond C and 4C.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_block_forward(
    const void* x, void* out, const void* dww, const void* dwb,
    const void* lnw, const void* lnb, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* s, void* d_out,
    int B, int H, int W, int C, float eps, int dtype, void* stream, int mt, int cp) {
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long smem = fused_block_plan_smem(C, dtype, mt, cp);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if ((s == nullptr) != (d_out == nullptr)) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Args a{x, out, f(dww), f(dwb), f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(gamma), f(s),
               d_out, B, H, W, C, cp, eps};
  const bool train = s != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return train ? launch_f32<true>(a, smem, st) : launch_f32<false>(a, smem, st);
  return train ? launch_bf16<true>(a, smem, st) : launch_bf16<false>(a, smem, st);
}

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
// On the TPU the grid runs in order and the weight gradients sum in VMEM
// across it; here blocks run in parallel, so one call is seven launches,
// and every sum has a fixed order, so two runs give bit-equal gradients
// (no float atomics):
//   1. the chain: one block per MT pixels recomputes LN, h1 and the GELU,
//      runs the per-pixel products dg = dz2 . W2 and dxn = dh1 . W1 (the
//      (MT, 4C) hidden stays on chip, in chunks), the LN backward, and
//      writes dd. It also writes xn, dys, gact and dh1 in T to a workspace
//      the wrapper allocates, and per-block partial sums of the vector
//      gradients.
//   2. the two products that contract over all pixels, M (C x 4C) and dW1
//      (4C x C). The workspace round trip through device memory (about
//      108 MB at stage 3 in bf16) is one the TPU kernel avoids; fusing it
//      back is later work.
//   3. sum_rows_kernel: the fixed-order sum of step 2's split partials
//      (bf16) / a second product launch (f32).
//   4. dw_wgrad_kernel: the 49 x C depthwise weight gradient, per-chunk
//      partial sums over 256-pixel chunks.
//   5. dw_dgrad_kernel: dx, one thread per output element.
//   6-7. sum_rows_kernel, twice: the partial sums of steps 1 and 4 in order.
// dW2 = M * gamma, db2 = gamma * sum(dys) and dgamma come from M outside,
// in the wrapper, as in the JAX package.
//
// bf16 (the training path) runs the products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums; mma_bf16.cuh):
//   - chain_mma_kernel<MT, NCMAX>: MT = 64 pixels per block up to C = 384, 32
//     above (the launch plan of mma_bf16.cuh, as in the forward); xn and
//     dz2 held in shared memory as bf16; per chunk of 128 hidden units h1 = xn .
//     W1[j]^T, dg = dz2 . W2[:, j] (a [k][n] tile, ldmatrix.trans), dh1 =
//     round(dg * gelu'(h1)), dxn += dh1 . W1[j] (.trans again); the (MT, C)
//     dxn sum in registers, split over the warps by channel; W1 and W2
//     stream as 16 KB bf16 tiles through a 3-stage cp.async ring
//     (mma_bf16.cuh's Ring).
//   - wgrad_mma_kernel: both products in one launch, 128x128 output tiles,
//     the pixel loop split into fixed ranges (split-K) with f32 partials,
//     32-pixel steps through a 4-stage cp.async ring, both operands
//     pixel-major (ldmatrix.trans); sum_rows_kernel adds the partials in
//     split order, M and dW1 in one launch (part_mm holds a row of both per
//     split, and m_out and dw1_out are one buffer).
//   Channels are padded to CP = 128*ceil(C/128) for the tiles: W1 (4CP, CP)
//   and W2 (CP, 4CP) come zero-padded from the wrapper when C != CP, and the
//   xn/dys (N x CP) and gact/dh1 (N x 4CP) workspaces carry zeros there.
// f32 (no path the card serves launches it) keeps the first version's
// FMA kernels (chain_kernel, wgrad_gemm_kernel: 16 pixels per block, f32
// FMAs on the CUDA cores); TF32 would break its 1e-4 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;  // bf16, the tile primitives and the launch plan

constexpr int K = 7;        // dwconv kernel size
constexpr int P = 3;        // dwconv padding
constexpr int NT = 256;     // threads per block
constexpr int WG_C = 32;    // channels per dw_wgrad block

constexpr float C0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float C1 = 0.044715f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}


// ---------------------------------------------------------------------------
// bf16: the chain on the tensor cores
// ---------------------------------------------------------------------------

// The tile geometry, the ring and the plan (pixels per block, width class:
// the 128-channel blocks of dxn a thread's accumulator covers) are
// mma_bf16.cuh's, as in the forward.
size_t chain_smem_bytes(int mt, int cp) {
  return sizeof(bf16) * (2 * (size_t)mt * (cp + 8) + 2 * (size_t)mt * HLD + (size_t)STAGES * STAGE) +
         sizeof(float) * 4 * (size_t)mt;
}

// part row of one chain block: [sdys | dlnb | dlns | db_dw] (C each), db1 (4C)
template <int MT, int NCMAX>
__global__ void __launch_bounds__(NT, MT <= 16 ? 2 : 1) chain_mma_kernel(
    const bf16* __restrict__ d, const bf16* __restrict__ dy,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ gamma, const float* __restrict__ dps,
    bf16* __restrict__ xn_ws, bf16* __restrict__ dys_ws, bf16* __restrict__ gact_ws,
    bf16* __restrict__ dh1_ws, bf16* __restrict__ dd_out, float* __restrict__ part,
    long long npix, int HW, int C, int cp, float eps) {
  constexpr int MI = MT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XLD = cp + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [MT][XLD] xn
  bf16* zs = xs + MT * XLD;                      // [MT][XLD] dz2
  float* dxs = reinterpret_cast<float*>(smem_raw);  // [MT][XLD] f32 dxn, over xs and zs at the end
  bf16* hs = zs + MT * XLD;                      // [MT][HLD] dh1 of the chunk
  bf16* gs = hs + MT * HLD;                      // [MT][HLD] gact of the chunk
  bf16* ring = gs + MT * HLD;                    // [STAGES][STAGE] weight tiles
  float* mean_s = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [MT] LN statistics and
  float* rstd_s = mean_s + MT;                                      // the LN backward's means
  float* m1_s = rstd_s + MT;
  float* m2_s = m1_s + MT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p0 = (long long)blockIdx.x * MT;
  const int hidden = 4 * C;
  const float inv_c = 1.0f / (float)C;
  float* pb = part + (long long)blockIdx.x * 8 * C;
  const int kc = cp / KT;           // tiles of each of the first two products per chunk
  const int nc = cp / TR;           // 128-channel blocks of dxn
  const int tpc = 3 * kc;           // tiles per chunk: kc (h1) + kc (dg) + 2 nc (dxn)
  const int ntiles = (4 * cp / NH) * tpc;

  // tile t: per chunk, kc [n][k] tiles W1[chunk rows][k0:k0+64] (h1), kc
  // [k][n] tiles W2[k0:k0+64][chunk] (dg), 2 per channel block [k][n] tiles
  // W1[chunk half][cb block] (dxn)
  auto load_tile = [&](int t, bf16* dst) {
    const int chunk = t / tpc, i = t - chunk * tpc;
    if (i < kc) {
      const bf16* src = w1 + (long long)chunk * NH * cp + i * KT;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = tid + q * NT, r = idx >> 3, ch = idx & 7;
        cp_async16(dst + r * TLD + ch * 8, src + (long long)r * cp + ch * 8);
      }
    } else {
      const bf16* src;
      int ld;
      if (i < 2 * kc) {
        src = w2 + (long long)(i - kc) * KT * 4 * cp + chunk * NH;
        ld = 4 * cp;
      } else {
        const int ii = i - 2 * kc;
        src = w1 + (long long)(chunk * NH + (ii & 1) * KT) * cp + (ii >> 1) * TR;
        ld = cp;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = tid + q * NT, r = idx >> 4, ch = idx & 15;
        cp_async16(dst + r * KNLD + ch * 8, src + (long long)r * ld + ch * 8);
      }
    }
  };
  Ring<STAGES, STAGE> tiles(ring, ntiles);
  tiles.prime(load_tile);  // in flight during step 1

  // ---- 1a: LN statistics of d, one warp per pixel -------------------------
  for (int m = warp; m < MT; m += NT / 32) {
    const long long p = p0 + m;
    float s = 0.f, ss = 0.f;
    if (p < npix) {
      for (int c = lane; c < C; c += 32) {
        const float v = __bfloat162float(d[p * C + c]);
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

  // ---- 1b: xn, dys, dz2 per channel; partial sum of dy*s ------------------
  for (int c = tid; c < cp; c += NT) {
    float sd = 0.f;
    for (int m = 0; m < MT; ++m) {
      const long long p = p0 + m;
      bf16 xn = __float2bfloat16_rn(0.f), dys = xn, zv = xn;
      if (c < C && p < npix) {
        const long long off = p * C + c;
        const float xhat = (__bfloat162float(d[off]) - mean_s[m]) * rstd_s[m];
        xn = __float2bfloat16_rn(xhat * lnw[c] + lnb[c]);
        const float dys32 = __bfloat162float(dy[off]) * dps[p / HW];
        dys = __float2bfloat16_rn(dys32);
        zv = __float2bfloat16_rn(dys32 * gamma[c]);
        sd += dys32;
      }
      if (p < npix) {
        xn_ws[p * cp + c] = xn;
        dys_ws[p * cp + c] = dys;
      }
      xs[m * XLD + c] = xn;
      zs[m * XLD + c] = zv;
    }
    if (c < C) pb[c] = sd;
  }

  // ---- 2: the hidden units in chunks of NH on the tensor cores ------------
  float acc[NCMAX][MI][2][4];
#pragma unroll
  for (int cb = 0; cb < NCMAX; ++cb)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cb][mi][nn][e] = 0.f;

  const int ar = a_row(lane), ac = a_col(lane);
  const int br = b_row(lane), bc = b_col(lane), btr = bt_row(lane), btc = bt_col(lane);
  const int g = lane >> 2, tq = lane & 3;

  for (int chunk = 0; chunk < 4 * cp / NH; ++chunk) {
    float h[MI][2][4], gq[MI][2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[mi][0][e] = h[mi][1][e] = gq[mi][0][e] = gq[mi][1][e] = 0.f;
    // 2a: h1 = xn . W1[j]^T; warp owns hidden units warp*16..+16
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
    // 2b: dg = dz2 . W2[:, j]
    for (int i = 0; i < kc; ++i) {
      const bf16* tile = tiles.next(load_tile);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tile + (kk * 16 + btr) * KNLD + warp * 16 + btc);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t a[4];
          ldmatrix_x4(a, zs + (mi * 16 + ar) * XLD + i * KT + kk * 16 + ac);
          mma_16816(gq[mi][0], a, b[0], b[1]);
          mma_16816(gq[mi][1], a, b[2], b[3]);
        }
      }
    }
    // 2c: GELU and its derivative from h1; dh1 = dg * gelu'(h1); db1 partial
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int jl = warp * 16 + nn * 8 + 2 * tq;
      const int j = chunk * NH + jl;
      float sb[2] = {0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float fv[2], gv[2];
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const float h1 = h[mi][nn][2 * half + e1] + (j + e1 < hidden ? b1[j + e1] : 0.f);
            const float th = tanhf(C0 * (h1 + C1 * h1 * h1 * h1));
            const float gp = 0.5f * (1.0f + th) + 0.5f * h1 * (1.0f - th * th) * C0 *
                             (1.0f + 3.0f * C1 * h1 * h1);
            fv[e1] = gq[mi][nn][2 * half + e1] * gp;
            gv[e1] = 0.5f * h1 * (1.0f + th);
            sb[e1] += fv[e1];
          }
          const int row = mi * 16 + g + half * 8;
          *reinterpret_cast<uint32_t*>(hs + row * HLD + jl) = pack_bf16x2(fv[0], fv[1]);
          *reinterpret_cast<uint32_t*>(gs + row * HLD + jl) = pack_bf16x2(gv[0], gv[1]);
        }
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        float v = sb[e1];
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (g == 0 && j + e1 < hidden) pb[4 * C + j + e1] = v;
      }
    }
    // 2d: dxn[:, cb block] += dh1 . W1[j][cb block]; the first tile's sync
    // also publishes hs/gs, which go to the workspace from there
#pragma unroll
    for (int cb = 0; cb < NCMAX; ++cb) {
      if (cb < nc) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const bf16* tile = tiles.next(load_tile);
          if (cb == 0 && kh == 0) {
            for (int idx = tid; idx < 2 * MT * 16; idx += NT) {
              const int arr = idx / (MT * 16), r = (idx >> 4) % MT, ch = idx & 15;
              const long long p = p0 + r;
              if (p >= npix) continue;
              const bf16* src = (arr ? gs : hs) + r * HLD + ch * 8;
              bf16* dst = (arr ? gact_ws : dh1_ws) + p * 4 * cp + chunk * NH + ch * 8;
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            }
          }
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, tile + (kk * 16 + btr) * KNLD + warp * 16 + btc);
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
  __syncthreads();  // xs and zs are free: dxn goes there in f32
#pragma unroll
  for (int cb = 0; cb < NCMAX; ++cb) {
    if (cb >= nc) continue;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mi * 16 + g + half * 8;
          const int c = cb * TR + warp * 16 + nn * 8 + 2 * tq;
          *reinterpret_cast<float2*>(dxs + row * XLD + c) =
              make_float2(acc[cb][mi][nn][2 * half], acc[cb][mi][nn][2 * half + 1]);
        }
  }
  __syncthreads();

  // ---- 3a: the LN backward's per-pixel means, one warp per pixel ---------
  for (int m = warp; m < MT; m += NT / 32) {
    const long long p = p0 + m;
    float s1 = 0.f, s2 = 0.f;
    if (p < npix) {
      for (int c = lane; c < C; c += 32) {
        const float xhat = (__bfloat162float(d[p * C + c]) - mean_s[m]) * rstd_s[m];
        const float dxh = dxs[m * XLD + c] * lnw[c];
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
    for (int m = 0; m < MT; ++m) {
      const long long p = p0 + m;
      if (p >= npix) break;
      const long long off = p * C + c;
      const float dxn = dxs[m * XLD + c];
      const float xhat = (__bfloat162float(d[off]) - mean_s[m]) * rstd_s[m];
      const float ddc = rstd_s[m] * (dxn * lnw[c] - m1_s[m] - xhat * m2_s[m]);
      dd_out[off] = __float2bfloat16_rn(ddc);
      sb += dxn;
      ss += dxn * xhat;
      sw += ddc;
    }
    pb[C + c] = sb;
    pb[2 * C + c] = ss;
    pb[3 * C + c] = sw;
  }
}

// ---------------------------------------------------------------------------
// bf16: the two weight-gradient products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int GT = 128;          // output tile edge
constexpr int KP = 32;           // pixels per ring stage
constexpr int GSTAGES = 4;       // ring depth
constexpr int GLD = GT + 8;      // padded row of a [pixel][128] tile
constexpr size_t WG_SMEM = sizeof(bf16) * GSTAGES * 2 * KP * GLD;

// part[split][product][R x N] f32: product 0 is M = dys^T . gact (R = CP,
// N = 4CP), product 1 is dW1 = dh1^T . xn (R = 4CP, N = CP), each over the
// pixels [split * split_px, (split + 1) * split_px). Block = one 128x128
// output tile of one product and one split; 8 warps of 64x32.
__global__ void __launch_bounds__(NT, 2) wgrad_mma_kernel(
    const bf16* __restrict__ dys, const bf16* __restrict__ gact, const bf16* __restrict__ dh1,
    const bf16* __restrict__ xn, float* __restrict__ part, long long npix, int cp,
    int split_px) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [GSTAGES][2][KP][GLD]
  const int prod = blockIdx.z;
  const bf16* A = prod == 0 ? dys : dh1;
  const bf16* Bm = prod == 0 ? gact : xn;
  const int R = prod == 0 ? cp : 4 * cp, N = prod == 0 ? 4 * cp : cp;
  const int ntn = N / GT;
  const int r0 = (blockIdx.x / ntn) * GT, n0 = (blockIdx.x % ntn) * GT;
  const long long q0 = (long long)blockIdx.y * split_px;
  const long long q1 = q0 + split_px < npix ? q0 + split_px : npix;
  const int nsteps = q1 > q0 ? (int)((q1 - q0 + KP - 1) / KP) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load = [&](int step, bf16* st) {
    const long long q = q0 + (long long)step * KP;
#pragma unroll
    for (int k = 0; k < 2 * KP * GT / 8 / NT; ++k) {
      const int idx = tid + k * NT, arr = idx / (KP * GT / 8);
      const int r = (idx >> 4) % KP, ch = idx & 15;
      const long long qq = q + r;
      const bool in = qq < q1;
      const bf16* src = arr ? Bm + (in ? qq : 0) * N + n0 : A + (in ? qq : 0) * R + r0;
      cp_async16(st + (arr * KP + r) * GLD + ch * 8, src + ch * 8, in ? 16 : 0);
    }
  };
  Ring<GSTAGES, 2 * KP * GLD> steps(ring, nsteps);
  steps.prime(load);

  const int wm = warp >> 2, wn = warp & 3;  // warp tile rows wm*64, columns wn*32
  const int atr = at_row(lane), atc = at_col(lane), btr = bt_row(lane), btc = bt_col(lane);
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    const bf16* As = steps.next(load);
    const bf16* Bs = As + KP * GLD;
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(a[mi], As + (kk * 16 + atr) * GLD + wm * 64 + mi * 16 + atc);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4_trans(b[nb], Bs + (kk * 16 + btr) * GLD + wn * 32 + nb * 16 + btc);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  float* out = part + ((long long)blockIdx.y * 2 + prod) * (4LL * cp * cp);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + wm * 64 + mi * 16 + g + half * 8;
        const int n = n0 + wn * 32 + ni * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (long long)r * N + n) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs (the first version's scheme)
// ---------------------------------------------------------------------------

constexpr int M16 = 16;      // pixels per chain block
constexpr int NH64 = 64;     // hidden units per chunk
constexpr int KT64 = 64;     // reduction depth of one staged tile
constexpr int CT = 64;       // output channels of one staged tile
constexpr int WT_LD = 65;    // padded row of the staged tile (no bank conflicts)
constexpr int GT64 = 64;     // output tile edge of the weight-gradient products
constexpr int GP = 32;       // pixels per staged step of those products

size_t f32_chain_smem_bytes(int C) {
  const int cs = (C + 3) & ~3;
  return sizeof(float) * (3 * (size_t)M16 * cs + 2 * (size_t)M16 * NH64 + 64 * WT_LD + 4 * M16);
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
__global__ void __launch_bounds__(NT) chain_kernel(
    const float* __restrict__ d, const float* __restrict__ dy,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ gamma, const float* __restrict__ dps,
    float* __restrict__ xn_ws, float* __restrict__ dys_ws, float* __restrict__ gact_ws,
    float* __restrict__ dh1_ws, float* __restrict__ dd_out, float* __restrict__ part,
    long long npix, int HW, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int CS = (C + 3) & ~3;        // row stride: float4-aligned, zero tail
  float* xs = smem;                   // [M16][CS] xn
  float* zs = xs + M16 * CS;          // [M16][CS] dz2
  float* acc = zs + M16 * CS;         // [M16][CS] dxn = dh1 . W1
  float* hs = acc + M16 * CS;         // [M16][NH64] dh1 of the current chunk
  float* fs = hs + M16 * NH64;        // [M16][NH64] dh1 of the current chunk (for db1)
  float* wt = fs + M16 * NH64;        // [64][WT_LD] staged weight tile
  float* mean_s = wt + 64 * WT_LD;    // [M16] per-pixel LN statistics and
  float* rstd_s = mean_s + M16;       //     the LN backward's two means
  float* m1_s = rstd_s + M16;
  float* m2_s = m1_s + M16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p0 = (long long)blockIdx.x * M16;
  const int hidden = 4 * C;
  const float inv_c = 1.0f / (float)C;
  float* pb = part + (long long)blockIdx.x * 8 * C;

  // ---- 1a: LN statistics of d, one warp per pixel (as in the forward) ----
  for (int m = warp; m < M16; m += NT / 32) {
    const long long p = p0 + m;
    float s = 0.f, ss = 0.f;
    if (p < npix) {
      for (int c = lane; c < C; c += 32) {
        const float v = d[p * C + c];
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
    for (int m = 0; m < M16; ++m) {
      const long long p = p0 + m;
      float xv = 0.f, zv = 0.f;
      if (c < C && p < npix) {
        const long long off = p * C + c;
        const float xhat = (d[off] - mean_s[m]) * rstd_s[m];
        xv = xhat * lnw[c] + lnb[c];
        xn_ws[off] = xv;
        const float dys32 = dy[off] * dps[p / HW];
        dys_ws[off] = dys32;
        zv = dys32 * gamma[c];
        sd += dys32;
      }
      xs[m * CS + c] = xv;
      zs[m * CS + c] = zv;
      acc[m * CS + c] = 0.f;
    }
    if (c < C) pb[c] = sd;
  }
  __syncthreads();

  // ---- 2: the hidden units in chunks of NH64; thread = 4 pixels x 1 unit -
  const int jn = tid % NH64;
  const int mg = (tid / NH64) * 4;
  for (int j0 = 0; j0 < hidden; j0 += NH64) {
    // 2a: h1 = xn . W1[j]
    float h4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < CS; k0 += KT64) {
      for (int i = tid; i < NH64 * KT64; i += NT) {
        const int jj = i / KT64, kk = i - (i / KT64) * KT64;
        const int j = j0 + jj, k = k0 + kk;
        wt[kk * WT_LD + jj] = (j < hidden && k < C) ? w1[(long long)j * C + k] : 0.f;
      }
      __syncthreads();
      tile_fma(h4, xs, CS, k0, min(KT64, CS - k0), wt, jn, mg);
      __syncthreads();
    }
    // 2b: dg = dz2 . W2[:, j]
    float g4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < CS; k0 += KT64) {
      for (int i = tid; i < NH64 * KT64; i += NT) {
        const int kk = i / NH64, jj = i - (i / NH64) * NH64;
        const int j = j0 + jj, k = k0 + kk;
        wt[kk * WT_LD + jj] = (j < hidden && k < C) ? w2[(long long)k * hidden + j] : 0.f;
      }
      __syncthreads();
      tile_fma(g4, zs, CS, k0, min(KT64, CS - k0), wt, jn, mg);
      __syncthreads();
    }
    // 2c: GELU and its derivative from h1; dh1 = dg * gelu'(h1)
    {
      const int j = j0 + jn;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mg + i;
        const long long p = p0 + m;
        float f = 0.f;
        if (j < hidden) {
          const float h1 = h4[i] + b1[j];
          const float th = tanhf(C0 * (h1 + C1 * h1 * h1 * h1));
          const float gp = 0.5f * (1.0f + th) + 0.5f * h1 * (1.0f - th * th) * C0 *
                           (1.0f + 3.0f * C1 * h1 * h1);
          f = g4[i] * gp;
          if (p < npix) {
            gact_ws[p * hidden + j] = 0.5f * h1 * (1.0f + th);
            dh1_ws[p * hidden + j] = f;
          }
        }
        hs[m * NH64 + jn] = f;
        fs[m * NH64 + jn] = f;
      }
    }
    __syncthreads();
    if (tid < NH64 && j0 + tid < hidden) {
      float sb = 0.f;
      for (int m = 0; m < M16; ++m) sb += fs[m * NH64 + tid];
      pb[4 * C + j0 + tid] = sb;
    }
    // 2d: dxn[m][c] += dh1[m][j0:j0+NH64] . W1[j0:j0+NH64][c]
    for (int c0 = 0; c0 < C; c0 += CT) {
      for (int i = tid; i < CT * NH64; i += NT) {
        const int jj = i / CT, cc = i - (i / CT) * CT;
        const int c = c0 + cc, j = j0 + jj;
        wt[jj * WT_LD + cc] = (c < C && j < hidden) ? w1[(long long)j * C + c] : 0.f;
      }
      __syncthreads();
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      tile_fma(a4, hs, NH64, 0, NH64, wt, jn, mg);
      const int c = c0 + jn;
      if (c < C) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[(mg + i) * CS + c] += a4[i];
      }
      __syncthreads();
    }
  }

  // ---- 3a: the LN backward's per-pixel means, one warp per pixel ---------
  for (int m = warp; m < M16; m += NT / 32) {
    const long long p = p0 + m;
    float s1 = 0.f, s2 = 0.f;
    if (p < npix) {
      for (int c = lane; c < C; c += 32) {
        const float xhat = (d[p * C + c] - mean_s[m]) * rstd_s[m];
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
    for (int m = 0; m < M16; ++m) {
      const long long p = p0 + m;
      if (p >= npix) break;
      const long long off = p * C + c;
      const float dxn = acc[m * CS + c];
      const float xhat = (d[off] - mean_s[m]) * rstd_s[m];
      const float ddc = rstd_s[m] * (dxn * lnw[c] - m1_s[m] - xhat * m2_s[m]);
      dd_out[off] = ddc;
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
// both pixel-major. One 64x64 output tile per block; thread = 4x4.
__global__ void __launch_bounds__(NT) wgrad_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm, float* __restrict__ out,
    long long npix, int R, int N) {
  __shared__ __align__(16) float as[GP][GT64];
  __shared__ __align__(16) float bs[GP][GT64];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * GT64, n0 = blockIdx.x * GT64;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long q0 = 0; q0 < npix; q0 += GP) {
    for (int i = tid; i < GP * GT64; i += NT) {
      const int pp = i / GT64, cc = i - (i / GT64) * GT64;
      const long long q = q0 + pp;
      as[pp][cc] = (q < npix && r0 + cc < R) ? A[q * R + r0 + cc] : 0.f;
      bs[pp][cc] = (q < npix && n0 + cc < N) ? Bm[q * N + n0 + cc] : 0.f;
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

// ---------------------------------------------------------------------------
// both types: the depthwise stencils and the fixed-order sums
// ---------------------------------------------------------------------------

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

struct Args {
  const void *x, *d, *dy; const float *dww, *lnw, *lnb; const void* w1; const float* b1;
  const void* w2; const float *gamma, *dps; void *dx, *xn_ws, *dys_ws, *gact_ws, *dh1_ws, *dd_ws;
  float *part_chain, *part_wgrad, *vec_out, *dww_out, *m_out, *dw1_out, *part_mm;
  int B, H, W, C, chunk, cp, split, split_px; float eps;
};

// launches 4-7, the same for both types
template <typename T>
int launch_tail(const Args& a, long long npix, long long nchain, cudaStream_t st) {
  const long long nchunk = (npix + a.chunk - 1) / a.chunk;
  dw_wgrad_kernel<T><<<dim3(blocks(a.C, WG_C), (unsigned)nchunk), NT, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dd_ws), a.part_wgrad, npix, a.H, a.W,
      a.C, a.chunk);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_dgrad_kernel<T><<<blocks(npix * a.C, NT), NT, 0, st>>>(
      static_cast<const T*>(a.dd_ws), static_cast<const T*>(a.dy), a.dww,
      static_cast<T*>(a.dx), npix, a.H, a.W, a.C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows_kernel<<<blocks(8 * a.C, NT), NT, 0, st>>>(a.part_chain, nchain, 8 * a.C, a.vec_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows_kernel<<<blocks(K * K * a.C, NT), NT, 0, st>>>(a.part_wgrad, nchunk, K * K * a.C,
                                                           a.dww_out);
  return (int)cudaGetLastError();
}

template <int MT, int NCMAX>
int launch_bf16(const Args& a, size_t smem, cudaStream_t st) {
  static std::atomic<int> chain_granted[32], wgrad_granted[32];
  cudaError_t err = allow_smem(chain_mma_kernel<MT, NCMAX>, smem, chain_granted);
  if (err == cudaSuccess) err = allow_smem(wgrad_mma_kernel, WG_SMEM, wgrad_granted);
  if (err != cudaSuccess) return (int)err;
  const long long npix = (long long)a.B * a.H * a.W;
  const long long nchain = (npix + MT - 1) / MT;
  const auto ct = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto mt = [](void* p) { return static_cast<bf16*>(p); };
  chain_mma_kernel<MT, NCMAX><<<(unsigned)nchain, NT, smem, st>>>(
      ct(a.d), ct(a.dy), a.lnw, a.lnb, ct(a.w1), a.b1, ct(a.w2), a.gamma, a.dps, mt(a.xn_ws),
      mt(a.dys_ws), mt(a.gact_ws), mt(a.dh1_ws), mt(a.dd_ws), a.part_chain, npix, a.H * a.W, a.C,
      a.cp, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tiles = (a.cp / GT) * (4 * a.cp / GT);
  wgrad_mma_kernel<<<dim3(tiles, a.split, 2), NT, WG_SMEM, st>>>(
      ct(a.dys_ws), ct(a.gact_ws), ct(a.dh1_ws), ct(a.xn_ws), a.part_mm, npix, a.cp, a.split_px);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // part_mm is [split][M | dW1]: rows of 8 cp^2, summed in split order into m_out | dw1_out
  const int n = 8 * a.cp * a.cp;
  sum_rows_kernel<<<blocks(n, NT), NT, 0, st>>>(a.part_mm, a.split, n, a.m_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_tail<bf16>(a, npix, nchain, st);
}

int launch_f32(const Args& a, size_t smem, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(chain_kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const long long npix = (long long)a.B * a.H * a.W;
  const long long nchain = (npix + M16 - 1) / M16;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto mf = [](void* p) { return static_cast<float*>(p); };
  chain_kernel<<<(unsigned)nchain, NT, smem, st>>>(
      cf(a.d), cf(a.dy), a.lnw, a.lnb, cf(a.w1), a.b1, cf(a.w2), a.gamma, a.dps, mf(a.xn_ws),
      mf(a.dys_ws), mf(a.gact_ws), mf(a.dh1_ws), mf(a.dd_ws), a.part_chain, npix, a.H * a.W,
      a.C, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int C = a.C, hidden = 4 * C;
  // M (C x 4C) = dys^T . gact; dW1 (4C x C) = dh1^T . xn
  wgrad_gemm_kernel<<<dim3(blocks(hidden, GT64), blocks(C, GT64)), NT, 0, st>>>(
      cf(a.dys_ws), cf(a.gact_ws), a.m_out, npix, C, hidden);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wgrad_gemm_kernel<<<dim3(blocks(C, GT64), blocks(hidden, GT64)), NT, 0, st>>>(
      cf(a.dh1_ws), cf(a.xn_ws), a.dw1_out, npix, hidden, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_tail<float>(a, npix, nchain, st);
}

}  // namespace

// Shared memory in bytes of one chain block under the launch plan (mt
// pixels per block, channels padded to cp), or -1 if the kernel cannot run
// that plan. dtype: 0 = float32 (mt = 16, cp = C), 1 = bfloat16 (cp =
// 128*ceil(C/128), mt = 64 for cp <= 384, else 32: plan_ok in mma_bf16.cuh).
extern "C" long long fused_block_bwd_plan_smem(int C, int dtype, int mt, int cp) {
  if (C < 1 || C > 1024) return -1;
  size_t smem;
  if (dtype == 0) {
    if (mt != M16 || cp != C) return -1;
    smem = f32_chain_smem_bytes(C);
  } else if (dtype == 1) {
    if (!plan_ok(C, mt, cp)) return -1;
    smem = chain_smem_bytes(mt, cp);
  } else {
    return -1;
  }
  return smem <= MAX_SMEM ? (long long)smem : -1;
}

// Shared memory in bytes of one weight-gradient product block (bf16).
extern "C" long long fused_block_bwd_wgrad_smem() { return (long long)WG_SMEM; }

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// Inputs: x, d, dy (B,H,W,C) in T; dww (49,C) f32 tap-major; lnw, lnb, b1,
// gamma (f32); W1 (4cp,cp), W2 (cp,4cp) in T (cp = C in f32; zero beyond C
// and 4C); s (B,) f32. Outputs: dx in T; vec_out (8C) f32 = [sum dy*s |
// dlnb | dlns | db_dw | db1 (4C)]; dww_out (49,C), m_out (cp,4cp) =
// (dy*s)^T . gact, dw1_out (4cp,cp), all f32; in bf16 dw1_out must follow
// m_out in memory (dw1_out = m_out + 4cp^2). Workspace the caller
// allocates: xn, dys (N x cp), gact, dh1 (N x 4cp) and dd (N x C) in T, N =
// B*H*W; part_chain (ceil(N/mt) * 8C), part_wgrad (ceil(N/chunk) * 49C) and,
// in bf16, part_mm (split * 2 * 4cp^2) in f32. The plan: mt pixels per
// chain block, split ranges of split_px pixels (a multiple of 32) for the
// bf16 weight-gradient products, split = ceil(N / split_px); f32 takes mt =
// 16 and split = 1. Returns the first cudaError_t of the seven launches (0
// = launched).
extern "C" int fused_block_backward(
    const void* x, const void* d, const void* dy, const void* dww, const void* lnw,
    const void* lnb, const void* w1, const void* b1, const void* w2, const void* gamma,
    const void* s, void* dx, void* xn_ws, void* dys_ws, void* gact_ws, void* dh1_ws,
    void* dd_ws, void* part_chain, void* part_wgrad, void* vec_out, void* dww_out,
    void* m_out, void* dw1_out, int B, int H, int W, int C, int chunk, float eps, int dtype,
    void* stream, int mt, int cp, int split, int split_px, void* part_mm) {
  if (B < 0 || H < 0 || W < 0 || chunk < 1) return (int)cudaErrorInvalidValue;
  const long long smem = fused_block_bwd_plan_smem(C, dtype, mt, cp);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  if (dtype == 1) {
    if (split < 1 || split_px < 1 || split_px % KP != 0 || part_mm == nullptr ||
        static_cast<float*>(dw1_out) != static_cast<float*>(m_out) + 4LL * cp * cp) {
      return (int)cudaErrorInvalidValue;
    }
    if ((long long)split * split_px < npix || (long long)(split - 1) * split_px >= npix) {
      if (npix > 0) return (int)cudaErrorInvalidValue;
    }
  } else if (split != 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (npix == 0) return 0;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto fm = [](void* p) { return static_cast<float*>(p); };
  const Args a{x, d, dy, f(dww), f(lnw), f(lnb), w1, f(b1), w2, f(gamma), f(s), dx, xn_ws,
               dys_ws, gact_ws, dh1_ws, dd_ws, fm(part_chain), fm(part_wgrad), fm(vec_out),
               fm(dww_out), fm(m_out), fm(dw1_out), fm(part_mm), B, H, W, C, chunk, cp, split,
               split_px, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, (size_t)smem, st);
  const size_t sm = (size_t)smem;
  switch (ncmax(cp)) {
    case 3: return launch_bf16<plan_mt(384), 3>(a, sm, st);
    case 6: return launch_bf16<plan_mt(768), 6>(a, sm, st);
    default: return launch_bf16<plan_mt(1024), 8>(a, sm, st);
  }
}

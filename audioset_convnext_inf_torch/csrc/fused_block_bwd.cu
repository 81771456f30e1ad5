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
// The unfused-rounding mode (bf16, template flag UNF) differentiates the
// forward's unfused-rounding save mode (fused_block.cu), the unfused
// block's function: h1 = round(xn . W1^T + b1) and gact = round(gelu(h1))
// in ATen's expression, gelu' in the form of ATen's tanh-GELU backward at
// that h1; the taps, gamma and s come in bf16, as the forward took them;
// and dgamma = sum dy*s * z over the pixels, z = round(gact . W2^T + b2)
// as the forward saved it after d (d is then (2, N, C)), added per block
// in step 1 and summed in step 7. Every other step, sum and rounding is
// the same.
//
// What bounds it on an H100: five products of 2*N*C*4C operations each
// (h1, dg = dz2 . W2, dxn = dh1 . W1, M = dys^T . gact, dW1 = dh1^T . xn)
// against 2*49*C per pixel for the two stencils:
// 2*N*(2*C*49 + 5*C*4C) operations, 84.3 GFLOP at B=16 stage 3 (N=14112,
// C=384) and 82.4 GFLOP at stage 4 (N=3472, C=768), 0.085 and 0.083 ms at
// the bf16 tensor-core peak. Operations bound it, as in the forward.
//
// On the TPU the grid runs in order and the weight gradients sum in VMEM
// across it; here blocks run in parallel, so one call is several launches,
// and every sum has a fixed order, so two runs give bit-equal gradients
// (no float atomics).
//
// bf16 (the training path), seven launches:
//   1. prep_kernel, PX pixels a block: the LN statistics of d (one warp a
//      pixel), xn = round(LN(d)), dys = round(dy*s) and dz2 =
//      round(dys*gamma) into (N x CP) workspaces, zero beyond C; the
//      statistics; per-block sums of dy*s.
//   2. chain_h_kernel on wgmma: a block takes 128 pixels x 128 hidden
//      units. Two warpgroups (64 pixels each) run h1 = xn . W1^T and dg =
//      dz2 . W2 from one ring of TMA-fed stages (xn, dz2 and the W1 tile
//      K-major, the W2 tile N-major through the transpose bit); then gact
//      = round(gelu(h1 + b1)), dh1 = round(dg * gelu'(h1)) into the
//      workspaces through shared memory, and the block's column sums of
//      dh1 before rounding (db1).
//   3. gemm_kernel: dxn = dh1 . W1 (f32, N x CP), 128 x 128 tiles, dh1
//      K-major and W1 N-major, the 4C reduction cut into `ksplit` ranges
//      when the tiles alone would not fill the card (stage 4), each range
//      its own f32 partial.
//   4. ln_bwd_kernel, PX pixels a block: the partials of dxn added in range
//      order, the LN backward (its two per-pixel means), dd = round(...),
//      per-block sums of dxn, dxn*xhat and dd.
//   5. gemm_kernel: M = dys^T . gact (CP x 4CP) and dW1 = dh1^T . xn (4CP x
//      CP) in one launch, 128 x 128 tiles, both operands pixel-major (the
//      transpose bit on A and B), the pixels cut into `split` ranges of
//      split_px (split-K) with f32 partials.
//   6. dw_bwd_kernel: both depthwise stencils from one staging in shared
//      memory (below).
//   7. sum_parts_kernel: every partial sum of steps 1-6 added in a fixed
//      order.
// Steps 2 and 3 are two launches, with dh1 between them in device memory:
// dh1 goes to its workspace anyway (step 5 reads it), and reading it back
// costs 43 MB at stage 3 (0.013 ms at 3.35 TB/s); in return no block has
// to hold a 64 x C f32 dxn in registers beside h1 and dg, which a
// warpgroup cannot at C = 768, and both launches fill the card (stage 4:
// 672 and 336 blocks on 132 SMs). The workspaces
// (xn/dys/dz2/gact/dh1, about 130 MB at stage 3) are a round trip the TPU
// kernel avoids; fusing them back is later work. The wgmma kernels issue
// their TMA loads from one thread of the consumer warpgroups, S stages
// ahead (no producer warp, no setmaxnreg: 256 threads and 64 or 128
// accumulator registers a thread); a stage is refilled once both
// warpgroups have waited for the products that read it.
//   Channels are padded to CP = 128*ceil(C/128) for the tiles: W1 (4CP, CP)
//   and W2 (CP, 4CP) come zero-padded from the wrapper when C != CP, the
//   xn/dys/dz2 (N x CP) and gact/dh1 (N x 4CP) workspaces carry zeros
//   there, and TMA reads pixels beyond N as zeros.
// f32 (no path the card serves launches it) keeps the first version's
// FMA kernels (chain_kernel, wgrad_gemm_kernel: 16 pixels per block, f32
// FMAs on the CUDA cores; TF32 would break its 1e-4 tolerance), then steps
// 6 and 7.
//
// The stencils (dw_bwd_kernel<T>, both types): a block takes a tile of
// th x tw output pixels of one image and a slab of 64 channels, and
// stages dd with its 3-pixel halo and x in shared memory (16-byte loads).
// From that one staging it computes
//   dx = round(dy + sum over taps of w[tap] * dd(pixel - tap)) as row runs:
//     a thread takes a channel pair and a run of up to 7 pixels of a row
//     and walks each of the 7 staged dd rows once, the run's sums and the
//     row's 7 taps in registers (as K1's forward stencil does);
//   the block's 49 x 64 partial of dW_dw[tap] = sum x(pixel) * dd(pixel -
//     tap): a thread owns a channel pair and one tap row and walks each
//     staged row 7 output columns at a time, their x and the 13 dd values
//     they meet in registers.
// The block partials are added in block order by step 7.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "wgmma_bf16.cuh"

namespace {

using namespace wgmma_bf16;

constexpr int K = 7;        // dwconv kernel size
constexpr int P = 3;        // dwconv padding
constexpr int NT = 256;     // threads per block

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
// bf16: the launch plan
// ---------------------------------------------------------------------------

constexpr int BM = 128;          // pixels (or rows) of a wgmma block tile: two warpgroups of 64
constexpr int BN = 128;          // columns of a wgmma block tile
constexpr int BK = BOX;          // reduction depth of one ring stage
constexpr int PX = 32;           // pixels of a prep / LN-backward block
constexpr uint32_t TILE = BM * BK * 2;        // bytes of a 128 x 64 bf16 tile
constexpr int CH_STAGES = 3;                  // ring depth of the chain
constexpr uint32_t CH_STAGE = 4 * TILE;       // xn, dz2, W1 and W2 tiles
constexpr int GM_STAGES = 3;                  // ring depth of the products
constexpr uint32_t GM_STAGE = 2 * TILE;       // A and B tiles
constexpr size_t CHAIN_SMEM = CH_STAGES * CH_STAGE + SW_ATOM;  // + alignment slack
constexpr size_t GEMM_SMEM = GM_STAGES * GM_STAGE + SW_ATOM;

// reduction steps of each of the ksplit ranges of dxn's 4CP
__host__ __device__ constexpr int ksplit_steps(int cp, int ksplit) {
  return (4 * cp / BK + ksplit - 1) / ksplit;
}

__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  return p + ((SW_ATOM - (smem_u32(p) & (SW_ATOM - 1))) & (SW_ATOM - 1));
}

// ---------------------------------------------------------------------------
// bf16 step 1: LN statistics, xn, dys, dz2
// ---------------------------------------------------------------------------

// 8 channels [c, c + 8) of one row at `off` (= pixel * C + c) as f32,
// zero at and beyond C; vec: C % 8 == 0 and the tensor 16-byte aligned.
__device__ __forceinline__ void load8(const bf16* t, long long off, int c, int C, bool vec,
                                      float (&v)[8]) {
  if (vec) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (c < C) u = *reinterpret_cast<const uint4*>(t + off);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c + e < C ? __bfloat162float(t[off + e]) : 0.f;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
}

// Steps 1 and 4 spread a block's PX pixels x cp channels over its threads
// as (pixel lane, 8-channel group) pairs: cp / 8 groups, NT / (cp / 8)
// lanes, each lane every lanes-th pixel; a lane's per-channel sums meet in
// shared memory ([lanes][cp] = NT * 8 floats) and are added in lane order.

// part_vec row of a block: [sum dy*s | dlnb | dlns | db_dw] (C each); this
// step writes the first quarter, ln_bwd_kernel the rest. UNF: the block's
// sums of dy*s * z (z after d) into its row of part_dg (C).
template <bool UNF>
__global__ void __launch_bounds__(NT) prep_kernel(
    const bf16* __restrict__ d, const bf16* __restrict__ dy, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ gamma, const float* __restrict__ dps,
    bf16* __restrict__ xn_ws, bf16* __restrict__ dys_ws, bf16* __restrict__ dz2_ws,
    float2* __restrict__ stats, float* __restrict__ part_vec, float* __restrict__ part_dg,
    long long npix, int HW, int C, int cp, float eps) {
  __shared__ float mean_s[PX], rstd_s[PX];
  __shared__ __align__(16) float red[NT * 8];
  __shared__ __align__(16) float red_dg[UNF ? NT * 8 : 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p0 = (long long)blockIdx.x * PX;
  const float inv_c = 1.0f / (float)C;
  const int G = cp / 8, L = NT / G;
  const bool vec = C % 8 == 0 && ((reinterpret_cast<uintptr_t>(d) |
                                   reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  // ---- 1: LN statistics of d, one warp a pixel ------------------------------
  for (int m = warp; m < PX; m += NT / 32) {
    const long long p = p0 + m;
    float s = 0.f, ss = 0.f;
    if (p < npix) {
      for (int g = lane; g < G; g += 32) {
        float v[8];
        load8(d, p * C + 8 * g, 8 * g, C, vec, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[e];
          ss += v[e] * v[e];
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mean = s * inv_c;
      const float rstd = rsqrtf(fmaxf(ss * inv_c - mean * mean, 0.f) + eps);
      mean_s[m] = mean;
      rstd_s[m] = rstd;
      if (p < npix) stats[p] = make_float2(mean, rstd);
    }
  }
  __syncthreads();
  // ---- 2: xn, dys, dz2 (zero beyond C); sums of dy*s -------------------------
  const int g = tid % G, l = tid / G, c = 8 * g;
  if (l < L) {
    float lw[8], lb[8], gm[8], sd[8], sg[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = c + e < C;
      lw[e] = in ? lnw[c + e] : 0.f;
      lb[e] = in ? lnb[c + e] : 0.f;
      gm[e] = in ? gamma[c + e] : 0.f;
      sd[e] = sg[e] = 0.f;
    }
#pragma unroll 4
    for (int m = l; m < PX; m += L) {
      const long long p = p0 + m;
      if (p < npix) {
        float dv[8], gv[8], xn[8], ys[8], zz[8];
        load8(d, p * C + c, c, C, vec, dv);
        load8(dy, p * C + c, c, C, vec, gv);
        // 32-bit: the entry point holds N below 2^31 (a 64-bit division is a call)
        const float sc = dps[(int)p / HW], mean = mean_s[m], rstd = rstd_s[m];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool in = c + e < C;
          const float d32 = gv[e] * sc;
          xn[e] = in ? (dv[e] - mean) * rstd * lw[e] + lb[e] : 0.f;
          ys[e] = d32;
          zz[e] = d32 * gm[e];
          sd[e] += d32;
        }
        *reinterpret_cast<uint4*>(xn_ws + p * cp + c) = pack8(xn);
        *reinterpret_cast<uint4*>(dys_ws + p * cp + c) = pack8(ys);
        *reinterpret_cast<uint4*>(dz2_ws + p * cp + c) = pack8(zz);
        if constexpr (UNF) {
          float zv[8];
          load8(d + npix * C, p * C + c, c, C, vec, zv);
#pragma unroll
          for (int e = 0; e < 8; ++e) sg[e] += ys[e] * zv[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[l * cp + c + e] = sd[e];
      if constexpr (UNF) red_dg[l * cp + c + e] = sg[e];
    }
  }
  __syncthreads();
  float* pb = part_vec + (long long)blockIdx.x * 4 * C;
  for (int cc = tid; cc < C; cc += NT) {
    float t = 0.f, tg = 0.f;
    for (int k = 0; k < L; ++k) {
      t += red[k * cp + cc];
      if constexpr (UNF) tg += red_dg[k * cp + cc];
    }
    pb[cc] = t;
    if constexpr (UNF) part_dg[(long long)blockIdx.x * C + cc] = tg;
  }
}

// ---------------------------------------------------------------------------
// bf16 step 2: h1, dg on wgmma; gact, dh1, db1
// ---------------------------------------------------------------------------

// Block (x = 128 hidden units, y = 128 pixels). Ring stage: xn [128 px][64
// c], dz2 [128 px][64 c], W1 [128 j][64 c] (K-major, 16 KB each), W2 [64
// c][64 j] x 2 (N-major). part_db1 row y: the block's sums of dh1 before
// rounding, for its 128 hidden units. UNF: h1 and gact at the unfused
// block's rounding points, gelu' as ATen's tanh-GELU backward takes it.
template <bool UNF>
__global__ void __launch_bounds__(NT, 1) chain_h_kernel(
    const __grid_constant__ CUtensorMap t_xn, const __grid_constant__ CUtensorMap t_dz2,
    const __grid_constant__ CUtensorMap t_w1, const __grid_constant__ CUtensorMap t_w2,
    const float* __restrict__ b1, bf16* __restrict__ gact_ws, bf16* __restrict__ dh1_ws,
    float* __restrict__ part_db1, long long npix, int C, int cp) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[CH_STAGES];
  unsigned char* ring = align_atom(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nk = cp / BK;
  if (tid == 0) {
    for (int s = 0; s < CH_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int kt) {
    unsigned char* st = ring + (kt % CH_STAGES) * CH_STAGE;
    uint64_t* bar = &full[kt % CH_STAGES];
    const int k0 = kt * BK;
    mbar_expect_tx(bar, CH_STAGE);
    tma_load_2d(st, &t_xn, bar, k0, m0);
    tma_load_2d(st + TILE, &t_dz2, bar, k0, m0);
    tma_load_2d(st + 2 * TILE, &t_w1, bar, k0, n0);
    tma_load_2d(st + 3 * TILE, &t_w2, bar, n0, k0);
    tma_load_2d(st + 3 * TILE + TILE / 2, &t_w2, bar, n0 + BOX, k0);
  };
  if (tid == 0)
    for (int kt = 0; kt < CH_STAGES && kt < nk; ++kt) load(kt);

  float h[64], g[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) h[i] = g[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const unsigned char* st = ring + (kt % CH_STAGES) * CH_STAGE;
    mbar_wait(&full[kt % CH_STAGES], (kt / CH_STAGES) & 1);
    fence_acc(h);
    fence_acc(g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_m64n128k16<0, 0>(h, kmajor_desc(st + wg * (TILE / 2), kk), kmajor_desc(st + 2 * TILE, kk));
      wgmma_m64n128k16<0, 1>(g, kmajor_desc(st + TILE + wg * (TILE / 2), kk),
                             mnmajor_desc(st + 3 * TILE, kk, TILE / 2));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of step kt - 1 are done
    fence_acc(h);
    fence_acc(g);
    if (kt >= 1) {
      __syncthreads();  // ... in both warpgroups: its stage may be refilled
      if (tid == 0 && kt - 1 + CH_STAGES < nk) load(kt - 1 + CH_STAGES);
    }
  }
  wgmma_wait<0>();
  fence_acc(h);
  fence_acc(g);
  __syncthreads();  // every product is done: the ring holds the epilogue

  constexpr int HS = BN + 8;  // padded row of a staged tile
  bf16* gs = reinterpret_cast<bf16*>(ring);  // [BM][HS] gact
  bf16* hs = gs + BM * HS;                   // [BM][HS] dh1
  float* red = reinterpret_cast<float*>(hs + BM * HS);  // [8 warps][BN] sums of dh1
  const int hidden = 4 * C, quad = lane & 3;
  const int rbase = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * quad;
    float sb[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float fv[2], gv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n0 + col + e;
        const float h1 = h[4 * i + 2 * hh + e] + (j < hidden ? b1[j] : 0.f);
        if constexpr (UNF) {
          const float hr = __bfloat162float(__float2bfloat16_rn(h1));
          const float sq = hr * hr;
          const float th = tanhf(C0 * (hr + C1 * (sq * hr)));
          const float left = 0.5f * hr, right = 1.0f + th;
          fv[e] = g[4 * i + 2 * hh + e] *
                  (0.5f * right + left * (1.0f - th * th) * (C0 * (1.0f + 3.0f * C1 * sq)));
          gv[e] = left * right;
        } else {
          const float th = tanhf(C0 * (h1 + C1 * h1 * h1 * h1));
          const float gp = 0.5f * (1.0f + th) + 0.5f * h1 * (1.0f - th * th) * C0 *
                           (1.0f + 3.0f * C1 * h1 * h1);
          fv[e] = g[4 * i + 2 * hh + e] * gp;
          gv[e] = 0.5f * h1 * (1.0f + th);
        }
        sb[e] += fv[e];
      }
      const int row = rbase + 8 * hh;
      *reinterpret_cast<uint32_t*>(hs + row * HS + col) = pack_bf16x2(fv[0], fv[1]);
      *reinterpret_cast<uint32_t*>(gs + row * HS + col) = pack_bf16x2(gv[0], gv[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = sb[e];
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < 4) red[warp * BN + col + e] = v;
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < hidden) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * BN + tid];  // rows in order
    part_db1[(long long)blockIdx.y * hidden + n0 + tid] = s;
  }
  for (int idx = tid; idx < 2 * BM * (BN / 8); idx += NT) {
    const int arr = idx / (BM * (BN / 8)), r = (idx / (BN / 8)) % BM, ch = idx % (BN / 8);
    const long long p = (long long)m0 + r;
    if (p >= npix) continue;
    const bf16* src = (arr ? gs : hs) + r * HS + ch * 8;
    bf16* dst = (arr ? gact_ws : dh1_ws) + p * 4 * cp + n0 + ch * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
}

// ---------------------------------------------------------------------------
// bf16 steps 3 and 5: f32 products on wgmma
// ---------------------------------------------------------------------------

// out (R x N, f32, row-major) = A . B over one reduction range, 128 x 128
// tiles; A is K-major ([row][k]) or, with A_MN, M-major ([k][row]); B is
// N-major ([k][col]). Grid (tiles, ranges, products): product z of the
// launch reads maps a[z], b[z] and writes out + z * stride_prod + range *
// stride_z; rows at or past m_valid are not written. Range r covers
// reduction indices [r * k_per_z, min((r + 1) * k_per_z, k_len)).
struct GemmShape {
  int R[2], N[2];
  long long stride_prod, stride_z;
  int m_valid[2];
  int k_len, k_per_z;
};

template <bool A_MN>
__global__ void __launch_bounds__(NT, 2) gemm_kernel(
    const __grid_constant__ CUtensorMap ta0, const __grid_constant__ CUtensorMap tb0,
    const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap tb1,
    float* __restrict__ out, const GemmShape shape) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[GM_STAGES];
  unsigned char* ring = align_atom(smem_raw);
  const int prod = blockIdx.z, range = blockIdx.y;
  const CUtensorMap* ta = prod ? &ta1 : &ta0;
  const CUtensorMap* tb = prod ? &tb1 : &tb0;
  const int N = shape.N[prod], ntn = N / BN;
  const int m0 = (blockIdx.x / ntn) * BM, n0 = (blockIdx.x % ntn) * BN;
  if (m0 >= shape.R[prod]) return;
  const int kb = range * shape.k_per_z;
  const int ke = min(kb + shape.k_per_z, shape.k_len);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < GM_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int kt) {
    unsigned char* st = ring + (kt % GM_STAGES) * GM_STAGE;
    uint64_t* bar = &full[kt % GM_STAGES];
    const int k0 = kb + kt * BK;
    mbar_expect_tx(bar, GM_STAGE);
    if (A_MN) {
      tma_load_2d(st, ta, bar, m0, k0);
      tma_load_2d(st + TILE / 2, ta, bar, m0 + BOX, k0);
    } else {
      tma_load_2d(st, ta, bar, k0, m0);
    }
    tma_load_2d(st + TILE, tb, bar, n0, k0);
    tma_load_2d(st + TILE + TILE / 2, tb, bar, n0 + BOX, k0);
  };
  if (tid == 0)
    for (int kt = 0; kt < GM_STAGES && kt < nk; ++kt) load(kt);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const unsigned char* st = ring + (kt % GM_STAGES) * GM_STAGE;
    mbar_wait(&full[kt % GM_STAGES], (kt / GM_STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned char* a = st + wg * (TILE / 2);  // this warpgroup's 64 rows
      const uint64_t da = A_MN ? mnmajor_desc(a, kk, TILE / 2) : kmajor_desc(a, kk);
      wgmma_m64n128k16<A_MN ? 1 : 0, 1>(acc, da, mnmajor_desc(st + TILE, kk, TILE / 2));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (kt >= 1) {
      __syncthreads();
      if (tid == 0 && kt - 1 + GM_STAGES < nk) load(kt - 1 + GM_STAGES);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  float* o = out + prod * shape.stride_prod + range * shape.stride_z;
  const int rbase = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rbase + 8 * hh;
      if (r < shape.m_valid[prod])
        *reinterpret_cast<float2*>(o + (long long)r * N + n0 + 8 * i + 2 * (lane & 3)) =
            make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
}

// ---------------------------------------------------------------------------
// bf16 step 4: the LN backward
// ---------------------------------------------------------------------------

// dxn (ksplit ranges of N x cp f32) added in range order, staged [PX][cp]
// in shared memory; part_vec row: [. | dlnb | dlns | db_dw].
__global__ void __launch_bounds__(NT) ln_bwd_kernel(
    const bf16* __restrict__ d, const float* __restrict__ dxn, int ksplit,
    const float2* __restrict__ stats, const float* __restrict__ lnw, bf16* __restrict__ dd_out,
    float* __restrict__ part_vec, long long npix, int C, int cp) {
  extern __shared__ __align__(16) float dxs[];  // [PX][cp]
  __shared__ float mean_s[PX], rstd_s[PX], m1_s[PX], m2_s[PX];
  __shared__ __align__(16) float red[3][NT * 8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p0 = (long long)blockIdx.x * PX;
  const long long zstride = npix * cp;
  const float inv_c = 1.0f / (float)C;
  const int G = cp / 8, L = NT / G;
  const bool vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  // ---- 1: dxn staged, the LN backward's two means, one warp a pixel ------
  for (int m = warp; m < PX; m += NT / 32) {
    const long long p = p0 + m;
    float s1 = 0.f, s2 = 0.f;
    if (p < npix) {
      const float2 st = stats[p];
      for (int g = lane; g < G; g += 32) {
        const int c = 8 * g;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, dv[8];
        for (int z = 0; z < ksplit; ++z) {
          const float4* src = reinterpret_cast<const float4*>(dxn + z * zstride + p * cp + c);
          const float4 a = src[0], b = src[1];
          v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
          v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
        }
        float4* dst = reinterpret_cast<float4*>(dxs + m * cp + c);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        load8(d, p * C + c, c, C, vec, dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (c + e < C) {
            const float xhat = (dv[e] - st.x) * st.y;
            const float dxh = v[e] * lnw[c + e];
            s1 += dxh;
            s2 += dxh * xhat;
          }
        }
      }
      if (lane == 0) {
        mean_s[m] = st.x;
        rstd_s[m] = st.y;
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
  // ---- 2: dd; sums of dxn, dxn * xhat and dd (pixel lane, 8-channel group) -
  const int g = tid % G, l = tid / G, c = 8 * g;
  if (l < L) {
    float lw[8], sb[8], ss[8], sw[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lw[e] = c + e < C ? lnw[c + e] : 0.f;
      sb[e] = ss[e] = sw[e] = 0.f;
    }
#pragma unroll 4
    for (int m = l; m < PX; m += L) {
      const long long p = p0 + m;
      if (p < npix) {
        float dv[8], out[8];
        load8(d, p * C + c, c, C, vec, dv);
        const float4 a = reinterpret_cast<const float4*>(dxs + m * cp + c)[0];
        const float4 b = reinterpret_cast<const float4*>(dxs + m * cp + c)[1];
        const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        const float mean = mean_s[m], rstd = rstd_s[m], m1 = m1_s[m], m2 = m2_s[m];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xhat = (dv[e] - mean) * rstd;
          const float ddc = c + e < C ? rstd * (v[e] * lw[e] - m1 - xhat * m2) : 0.f;
          out[e] = ddc;
          if (c + e < C) {
            sb[e] += v[e];
            ss[e] += v[e] * xhat;
            sw[e] += ddc;
          }
        }
        const long long off = p * C + c;
        if (vec) {
          if (c < C) *reinterpret_cast<uint4*>(dd_out + off) = pack8(out);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c + e < C) dd_out[off + e] = __float2bfloat16_rn(out[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[0][l * cp + c + e] = sb[e];
      red[1][l * cp + c + e] = ss[e];
      red[2][l * cp + c + e] = sw[e];
    }
  }
  __syncthreads();
  float* pb = part_vec + (long long)blockIdx.x * 4 * C;
  for (int cc = tid; cc < C; cc += NT) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < L; ++k) {
      t0 += red[0][k * cp + cc];
      t1 += red[1][k * cp + cc];
      t2 += red[2][k * cp + cc];
    }
    pb[C + cc] = t0;
    pb[2 * C + cc] = t1;
    pb[3 * C + cc] = t2;
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

constexpr int SCS = 64;                     // channels of a stencil slab
constexpr int RUN = 7;                      // pixels of a row run (the main path's W: 14, 7)
constexpr int STENCIL_ROWS = 16;            // most output rows of a stencil tile
constexpr int STENCIL_COLS = 32;            // most output columns of a stencil tile
constexpr int STENCIL_SMEM_CAP = 112640;    // 110 KiB: two blocks an SM

// The stencil tile for an H x W image: tw columns (all of W up to 32,
// else W in even pieces of at most 32), th rows (as many as fit the cap,
// at most 16, H in even pieces); shared memory = dd with its halo + x
// (within the cap) + the slab's 49 taps in f32.
struct StencilPlan {
  int th, tw, nth, ntw;
  size_t smem;
};

StencilPlan stencil_plan(int H, int W, int esize) {
  StencilPlan sp;
  sp.ntw = (W + STENCIL_COLS - 1) / STENCIL_COLS;
  sp.tw = (W + sp.ntw - 1) / sp.ntw;
  const int staged = STENCIL_SMEM_CAP / (SCS * esize);  // pixels that fit
  int rows = (staged - 2 * P * (sp.tw + 2 * P)) / (2 * sp.tw + 2 * P);
  rows = std::max(1, std::min(rows, std::min(STENCIL_ROWS, H)));
  sp.nth = (H + rows - 1) / rows;
  sp.th = (H + sp.nth - 1) / sp.nth;
  sp.smem = (size_t)((sp.th + 2 * P) * (sp.tw + 2 * P) + sp.th * sp.tw) * SCS * esize +
            sizeof(float) * K * K * SCS;
  return sp;
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Block (x = tile of th x tw pixels, y = 64-channel slab, z = image).
// dww (C, 49): the conv weight's own layout. dx = round(dy + sum_taps
// w[tap] * dd(pixel - tap)); part row (image, tile): [49 taps][C] sums
// over the tile of x(pixel) * dd(pixel - tap).
template <typename T>
__global__ void __launch_bounds__(NT) dw_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dd, const T* __restrict__ dy,
    const float* __restrict__ dww, T* __restrict__ dx, float* __restrict__ part, int H, int W,
    int C, int th, int tw, int ntw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DH = th + 2 * P, DW = tw + 2 * P;
  float* wts = reinterpret_cast<float*>(smem_raw);  // [49][SCS] the slab's taps
  T* ds = reinterpret_cast<T*>(wts + K * K * SCS);  // [DH][DW][SCS] dd with its halo
  T* xs = ds + (size_t)DH * DW * SCS;               // [th][tw][SCS] x
  const int tid = threadIdx.x, tile = blockIdx.x, c0 = blockIdx.y * SCS, b = blockIdx.z;
  const int h0 = (tile / ntw) * th, w0 = (tile % ntw) * tw;
  const long long img = (long long)b * H * W;

  // ---- staging: 16-byte chunks where C allows, zeros outside ------------
  constexpr int EV = 16 / sizeof(T);  // elements of a chunk
  constexpr int NV = SCS / EV;        // chunks of a staged pixel
  const bool vec = C % EV == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                    reinterpret_cast<uintptr_t>(dd)) & 15) == 0;
  for (int i = tid; i < K * K * SCS; i += NT) {
    const int c = c0 + i % SCS;
    wts[i] = c < C ? dww[c * (K * K) + i / SCS] : 0.f;
  }
  const int nd = DH * DW, nx = th * tw;
#pragma unroll 4
  for (int i = tid; i < (nd + nx) * NV; i += NT) {
    const int pix = i / NV, ch = i - pix * NV;
    const bool halo = pix < nd;
    const int q = halo ? pix : pix - nd, width = halo ? DW : tw;
    const int row = q / width;
    const int hh = h0 + row - (halo ? P : 0), ww = w0 + (q - row * width) - (halo ? P : 0);
    const T* src = halo ? dd : x;
    T* dst = (halo ? ds : xs) + (size_t)q * SCS + ch * EV;
    const int c = c0 + ch * EV;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const long long off = (img + (long long)(in ? hh : 0) * W + (in ? ww : 0)) * C + c;
    if (vec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in && c < C) v = *reinterpret_cast<const uint4*>(src + off);
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      for (int e = 0; e < EV; ++e) dst[e] = (in && c + e < C) ? src[off + e] : from_f<T>(0.f);
    }
  }
  __syncthreads();

  // ---- dx: a channel pair x a run of up to RUN pixels of one row ---------
  const bool pairs = C % 2 == 0 && ((reinterpret_cast<uintptr_t>(dy) |
                                     reinterpret_cast<uintptr_t>(dx)) & (2 * sizeof(T) - 1)) == 0;
  const int nrun = (tw + RUN - 1) / RUN;
  const int items = th * nrun * (SCS / 2);
  for (int it = tid; it < items; it += NT) {
    const int pr = it % (SCS / 2), rest = it / (SCS / 2);
    const int run = rest % nrun, r = rest / nrun;
    const int c = c0 + 2 * pr, hh = h0 + r, wa = run * RUN;
    const int len = min(min(RUN, tw - wa), W - w0 - wa);
    if (c >= C || hh >= H || len <= 0) continue;
    const bool two = c + 1 < C;
    float a0[RUN], a1[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) a0[j] = a1[j] = 0.f;
    for (int ky = 0; ky < K; ++ky) {
      float k0[K], k1[K];
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float2 wt = *reinterpret_cast<const float2*>(wts + (ky * K + kx) * SCS + 2 * pr);
        k0[kx] = wt.x;
        k1[kx] = wt.y;  // zero beyond C
      }
      // staged row r + 6 - ky is image row hh - (ky - 3); staged column wa + k
      // feeds run pixel j through tap kx = j + 6 - k
      const T* row = ds + ((size_t)(r + 2 * P - ky) * DW + wa) * SCS + 2 * pr;
#pragma unroll
      for (int k = 0; k < RUN + K - 1; ++k) {
        if (k < len + K - 1) {
          const float2 v = ld2(row + (size_t)k * SCS);
#pragma unroll
          for (int j = 0; j < RUN; ++j) {
            const int kx = j + K - 1 - k;
            if (kx >= 0 && kx < K) {
              a0[j] += k0[kx] * v.x;
              a1[j] += k1[kx] * v.y;
            }
          }
        }
      }
    }
    const long long base = (img + (long long)hh * W + w0 + wa) * C + c;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (j >= len) break;
      const long long off = base + (long long)j * C;
      if (pairs) {
        const float2 g = ld2(dy + off);
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<uint32_t*>(dx + off) = pack_bf16x2(g.x + a0[j], g.y + a1[j]);
        } else {
          *reinterpret_cast<float2*>(dx + off) = make_float2(g.x + a0[j], g.y + a1[j]);
        }
      } else {
        dx[off] = from_f<T>(to_f<T>(dy[off]) + a0[j]);
        if (two) dx[off + 1] = from_f<T>(to_f<T>(dy[off + 1]) + a1[j]);
      }
    }
  }

  // ---- dW_dw: a channel pair x one tap row, a 7-wide window of dd --------
  if (tid < K * (SCS / 2)) {
    const int ky = tid / (SCS / 2), pr = tid % (SCS / 2);
    const int c = c0 + 2 * pr;
    if (c < C) {
      float s0[K], s1[K];
#pragma unroll
      for (int i = 0; i < K; ++i) s0[i] = s1[i] = 0.f;
      for (int r = 0; r < th; ++r) {
        // output column q0 + j meets staged dd columns q0 + j .. q0 + j + 6
        // (taps 6 .. 0); RUN columns at a time, window and x in registers
        const T* drow = ds + (size_t)(r + 2 * P - ky) * DW * SCS + 2 * pr;
        const T* xrow = xs + (size_t)r * tw * SCS + 2 * pr;
        for (int q0 = 0; q0 < tw; q0 += RUN) {
          float2 win[RUN + K - 1], xv[RUN];
#pragma unroll
          for (int i = 0; i < RUN + K - 1; ++i)
            win[i] = q0 + i < DW ? ld2(drow + (size_t)(q0 + i) * SCS) : make_float2(0.f, 0.f);
#pragma unroll
          for (int j = 0; j < RUN; ++j)
            xv[j] = q0 + j < tw ? ld2(xrow + (size_t)(q0 + j) * SCS) : make_float2(0.f, 0.f);
#pragma unroll
          for (int j = 0; j < RUN; ++j)
#pragma unroll
            for (int i = 0; i < K; ++i) {
              s0[K - 1 - i] += xv[j].x * win[j + i].x;
              s1[K - 1 - i] += xv[j].y * win[j + i].y;
            }
        }
      }
      float* out = part + ((long long)(b * gridDim.x + tile) * K * K + ky * K) * C + c;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        out[kx * C] = s0[kx];
        if (c + 1 < C) out[kx * C + 1] = s1[kx];
      }
    }
  }
}

// out[col] = sum over rows of part[row * ld + col], for up to eight
// segments, each into its own output; with tcols, the (cols / tcols) x
// tcols sum is written transposed (out[(col % tcols) * (cols / tcols) +
// col / tcols]). Segment i takes blocks [first[i], first[i + 1]). Its
// `groups` threads of a column (a power of two, at most 32 and at most the
// rows) each add a run of consecutive rows in row order, then the runs are
// added in order: a fixed order, so the sum is bit-reproducible. A thread
// takes `cpt` columns, NT / groups apart: 4 where the rows are few (M |
// dW1's split ranges), else 1, so that long sums spread over many blocks.
constexpr int SUM_CPT = 4;  // most columns a thread
constexpr int SUM_SEGS = 8;

struct Seg {
  const float* part;
  float* out;
  int rows, cols, ld, tcols, groups, cpt;
};
struct Segs {
  Seg s[SUM_SEGS];
  int first[SUM_SEGS + 1];  // first block of each segment; first[SUM_SEGS] = the grid
};

__global__ void __launch_bounds__(NT) sum_parts_kernel(const Segs segs) {
  __shared__ float grp[SUM_CPT][NT];
  const int bx = blockIdx.x;
  // constant indices only: a dynamic index would copy the parameters to the stack
  Seg g = segs.s[0];
  int first = segs.first[0];
#pragma unroll
  for (int i = 1; i < SUM_SEGS; ++i)
    if (bx >= segs.first[i]) {
      g = segs.s[i];
      first = segs.first[i];
    }
  const int width = NT / g.groups;
  const int cl = threadIdx.x % width, gi = threadIdx.x / width;
  const int col0 = (bx - first) * width * g.cpt + cl;
  const int per = (g.rows + g.groups - 1) / g.groups;
  const int r0 = gi * per, r1 = min(r0 + per, g.rows);
  float s[SUM_CPT];
#pragma unroll
  for (int k = 0; k < SUM_CPT; ++k) s[k] = 0.f;
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const float* row = g.part + (long long)r * g.ld;
#pragma unroll
    for (int k = 0; k < SUM_CPT; ++k)
      if (k < g.cpt && col0 + k * width < g.cols) s[k] += row[col0 + k * width];
  }
#pragma unroll
  for (int k = 0; k < SUM_CPT; ++k) grp[k][threadIdx.x] = s[k];
  __syncthreads();
  if (gi == 0) {
#pragma unroll
    for (int k = 0; k < SUM_CPT; ++k) {
      const int col = col0 + k * width;
      if (k >= g.cpt || col >= g.cols) continue;
      float t = 0.f;
      for (int j = 0; j < g.groups; ++j) t += grp[k][j * width + cl];
      g.out[g.tcols ? (col % g.tcols) * (g.cols / g.tcols) + col / g.tcols : col] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// host: the launches
// ---------------------------------------------------------------------------

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

struct Args {
  const void *x, *d, *dy; const float *dww, *lnw, *lnb; const void* w1; const float* b1;
  const void* w2; const float *gamma, *dps;
  void* dx; float *sdys_out, *dlnb_out, *dlns_out, *dbdw_out, *db1_out, *dww_out, *mm_out;
  void *xn_ws, *dys_ws, *dz2_ws, *gact_ws, *dh1_ws, *dd_ws; float* dxn_ws; float2* stats;
  float *part_vec, *part_db1, *part_dww, *part_mm;
  int B, H, W, C, cp, split, split_px, ksplit; float eps;
  float *dg_out, *part_dg;  // the unfused-rounding mode's dgamma and its block sums, else null
};

template <typename T>
cudaError_t launch_stencil(const Args& a, const StencilPlan& sp, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(dw_bwd_kernel<T>, sp.smem, granted);
  if (err != cudaSuccess) return err;
  dw_bwd_kernel<T><<<dim3(sp.nth * sp.ntw, blocks(a.C, SCS), a.B), NT, sp.smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dd_ws), static_cast<const T*>(a.dy),
      a.dww, static_cast<T*>(a.dx), a.part_dww, a.H, a.W, a.C, sp.th, sp.tw, sp.ntw);
  return cudaGetLastError();
}

// the first n segments of `segs` (the rest empty) in one launch
cudaError_t launch_sums(Segs segs, int n, cudaStream_t st) {
  segs.first[0] = 0;
  for (int i = 0; i < SUM_SEGS; ++i) {
    Seg& g = segs.s[i];
    g.groups = 1;
    while (g.groups < 32 && 2 * g.groups <= g.rows) g.groups *= 2;
    g.cpt = g.rows <= 8 ? SUM_CPT : 1;
    segs.first[i + 1] = segs.first[i] + (i < n ? (int)blocks(g.cols, g.cpt * NT / g.groups) : 0);
  }
  sum_parts_kernel<<<segs.first[SUM_SEGS], NT, 0, st>>>(segs);
  return cudaGetLastError();
}

// The four C-wide sums of a part_vec row (stride ld): sum dy*s, dlnb, dlns,
// db_dw, each into its own output.
void vec_segments(const Args& a, int rows, int ld, Seg* s) {
  float* outs[4] = {a.sdys_out, a.dlnb_out, a.dlns_out, a.dbdw_out};
  for (int i = 0; i < 4; ++i) s[i] = Seg{a.part_vec + i * a.C, outs[i], rows, a.C, ld, 0, 1, 1};
}

// allow_smem's record of what the kernels both modes launch were granted:
// one per kernel, or one mode's smaller grant would lower the other's
std::atomic<int> g_dxn[32], g_wgrad[32], g_ln[32];

template <bool UNF>
cudaError_t launch_bf16(const Args& a, const StencilPlan& sp, cudaStream_t st) {
  static std::atomic<int> g_chain[32];  // chain_h_kernel<UNF>'s own
  const long long npix = (long long)a.B * a.H * a.W;
  const int cp = a.cp, hid = 4 * cp, C = a.C;
  const size_t ln_smem = sizeof(float) * PX * cp;
  cudaError_t err;
  if ((err = allow_smem(chain_h_kernel<UNF>, CHAIN_SMEM, g_chain)) != cudaSuccess) return err;
  if ((err = allow_smem(gemm_kernel<false>, GEMM_SMEM, g_dxn)) != cudaSuccess) return err;
  if ((err = allow_smem(gemm_kernel<true>, GEMM_SMEM, g_wgrad)) != cudaSuccess) return err;
  if ((err = allow_smem(ln_bwd_kernel, ln_smem, g_ln)) != cudaSuccess) return err;

  // the operands of the three wgmma launches: K-major boxes {64, 128 rows},
  // MN-major boxes {64, 64 k rows}
  CUtensorMap xn_k, dz2_k, w1_k, w2_n, dh1_k, w1_n, dys_m, gact_n, dh1_m, xn_n;
  const struct { CUtensorMap* map; const void* base; int inner; long long outer; int rows; } maps[] = {
      {&xn_k, a.xn_ws, cp, npix, BM},     {&dz2_k, a.dz2_ws, cp, npix, BM},
      {&w1_k, a.w1, cp, hid, BN},         {&w2_n, a.w2, hid, cp, BK},
      {&dh1_k, a.dh1_ws, hid, npix, BM},  {&w1_n, a.w1, cp, hid, BK},
      {&dys_m, a.dys_ws, cp, npix, BK},   {&gact_n, a.gact_ws, hid, npix, BK},
      {&dh1_m, a.dh1_ws, hid, npix, BK},  {&xn_n, a.xn_ws, cp, npix, BK},
  };
  for (const auto& m : maps)
    if ((err = encode_tmap_2d(m.map, m.base, m.inner, m.outer, BOX, m.rows)) != cudaSuccess)
      return err;

  const auto cb = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto mb = [](void* p) { return static_cast<bf16*>(p); };
  const unsigned nblk = blocks(npix, PX), mtiles = blocks(npix, BM);
  prep_kernel<UNF><<<nblk, NT, 0, st>>>(cb(a.d), cb(a.dy), a.lnw, a.lnb, a.gamma, a.dps,
                                        mb(a.xn_ws), mb(a.dys_ws), mb(a.dz2_ws), a.stats,
                                        a.part_vec, a.part_dg, npix, a.H * a.W, C, cp, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chain_h_kernel<UNF><<<dim3(hid / BN, mtiles), NT, CHAIN_SMEM, st>>>(
      xn_k, dz2_k, w1_k, w2_n, a.b1, mb(a.gact_ws), mb(a.dh1_ws), a.part_db1, npix, C, cp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const GemmShape dxn_shape{{(int)npix, 0}, {cp, 0}, 0, npix * cp, {(int)npix, 0}, hid,
                            ksplit_steps(cp, a.ksplit) * BK};
  gemm_kernel<false><<<dim3(mtiles * (cp / BN), a.ksplit, 1), NT, GEMM_SMEM, st>>>(
      dh1_k, w1_n, dh1_k, w1_n, a.dxn_ws, dxn_shape);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ln_bwd_kernel<<<nblk, NT, ln_smem, st>>>(cb(a.d), a.dxn_ws, a.ksplit, a.stats, a.lnw,
                                           mb(a.dd_ws), a.part_vec, npix, C, cp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // part_mm is [split][M | dW1]: rows of 8 cp^2, summed in split order into mm_out
  const GemmShape wg_shape{{cp, hid}, {hid, cp}, (long long)hid * cp, 2LL * hid * cp,
                           {cp, hid}, (int)npix, a.split_px};
  gemm_kernel<true><<<dim3((cp / BN) * (hid / BN), a.split, 2), NT, GEMM_SMEM, st>>>(
      dys_m, gact_n, dh1_m, xn_n, a.part_mm, wg_shape);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stencil<bf16>(a, sp, st)) != cudaSuccess) return err;
  Segs segs{};
  vec_segments(a, (int)nblk, 4 * C, segs.s);
  segs.s[4] = Seg{a.part_db1, a.db1_out, (int)mtiles, 4 * C, 4 * C, 0, 1, 1};
  segs.s[5] = Seg{a.part_dww, a.dww_out, a.B * sp.nth * sp.ntw, K * K * C, K * K * C, C, 1, 1};
  segs.s[6] = Seg{a.part_mm, a.mm_out, a.split, 2 * hid * cp, 2 * hid * cp, 0, 1, 1};
  if (!UNF) return launch_sums(segs, 7, st);
  segs.s[7] = Seg{a.part_dg, a.dg_out, (int)nblk, C, C, 0, 1, 1};
  return launch_sums(segs, 8, st);
}

cudaError_t launch_f32(const Args& a, size_t smem, const StencilPlan& sp, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(chain_kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const long long npix = (long long)a.B * a.H * a.W;
  const long long nchain = (npix + M16 - 1) / M16;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto mf = [](void* p) { return static_cast<float*>(p); };
  chain_kernel<<<(unsigned)nchain, NT, smem, st>>>(
      cf(a.d), cf(a.dy), a.lnw, a.lnb, cf(a.w1), a.b1, cf(a.w2), a.gamma, a.dps, mf(a.xn_ws),
      mf(a.dys_ws), mf(a.gact_ws), mf(a.dh1_ws), mf(a.dd_ws), a.part_vec, npix, a.H * a.W,
      a.C, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int C = a.C, hidden = 4 * C;
  // M (C x 4C) = dys^T . gact; dW1 (4C x C) = dh1^T . xn, right after M
  wgrad_gemm_kernel<<<dim3(blocks(hidden, GT64), blocks(C, GT64)), NT, 0, st>>>(
      cf(a.dys_ws), cf(a.gact_ws), a.mm_out, npix, C, hidden);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_gemm_kernel<<<dim3(blocks(C, GT64), blocks(hidden, GT64)), NT, 0, st>>>(
      cf(a.dh1_ws), cf(a.xn_ws), a.mm_out + (long long)hidden * C, npix, hidden, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stencil<float>(a, sp, st)) != cudaSuccess) return err;
  Segs segs{};
  vec_segments(a, (int)nchain, 8 * C, segs.s);
  segs.s[4] = Seg{a.part_vec + 4 * C, a.db1_out, (int)nchain, 4 * C, 8 * C, 0, 1, 1};
  segs.s[5] = Seg{a.part_dww, a.dww_out, a.B * sp.nth * sp.ntw, K * K * C, K * K * C, C, 1, 1};
  return launch_sums(segs, 6, st);
}

}  // namespace

// Shared memory in bytes of one chain block under the launch plan (mt
// pixels per block, channels padded to cp), or -1 if the kernel cannot run
// that plan. dtype: 0 = float32 (the FMA chain: mt = 16, cp = C), 1 =
// bfloat16 (chain_h_kernel: mt = 128, cp = 128*ceil(C/128)).
extern "C" long long fused_block_bwd_plan_smem(int C, int dtype, int mt, int cp) {
  if (C < 1 || C > 1024) return -1;
  size_t smem;
  if (dtype == 0) {
    if (mt != M16 || cp != C) return -1;
    smem = f32_chain_smem_bytes(C);
  } else if (dtype == 1) {
    if (mt != BM || cp != padded_c(C)) return -1;
    smem = CHAIN_SMEM;
  } else {
    return -1;
  }
  return smem <= MAX_SMEM ? (long long)smem : -1;
}

// Shared memory in bytes of one wgmma product block (bf16 steps 3 and 5).
extern "C" long long fused_block_bwd_wgrad_smem() { return (long long)GEMM_SMEM; }

// Shared memory in bytes of one LN-backward block at cp channels (bf16).
extern "C" long long fused_block_bwd_ln_smem(int cp) { return (long long)(sizeof(float) * PX * cp); }

// Shared memory in bytes of one stencil block for an H x W image, or -1
// unless (th, tw) is the tile the kernel takes there.
extern "C" long long fused_block_bwd_stencil_smem(int H, int W, int dtype, int th, int tw) {
  if (H < 1 || W < 1 || (dtype != 0 && dtype != 1)) return -1;
  const StencilPlan sp = stencil_plan(H, W, dtype ? 2 : 4);
  return sp.th == th && sp.tw == tw && sp.smem <= MAX_SMEM ? (long long)sp.smem : -1;
}

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// Inputs: x, d, dy (B,H,W,C) in T; dww (C,49) f32 (the conv weight's
// layout); lnw, lnb, b1, gamma (f32); W1 (4cp,cp), W2 (cp,4cp) in T (cp = C
// in f32; zero beyond C and 4C); s (B,) f32. Outputs, f32 but dx: dx in T;
// sum dy*s, dlnb, dlns, db_dw (C each), db1 (4C); dww_out (C,49); mm_out
// (2, 4cp^2) = [M = (dy*s)^T . gact (cp,4cp) | dW1 (4cp,cp)]. Workspaces the caller
// allocates, N = B*H*W: xn, dys (N x cp), gact, dh1 (N x 4cp) and dd (N x
// C) in T; part_vec (f32: ceil(N/16) x 8C; bf16: ceil(N/px) x 4C) and
// part_dww (B * stencil tiles x 49C) in f32; bf16 only: dz2 (N x cp) in
// T, dxn (ksplit x N x cp), stats (2N), part_db1 (ceil(N/mt) x 4C) and
// part_mm (split x 8cp^2) in f32 (null in f32). unfused = 1 (bf16 only)
// selects the unfused-rounding mode: d then holds 2 N C values (d, then z),
// dww, gamma and s hold bf16 values, and dg_out (C, dgamma) and part_dg
// (ceil(N/px) x C) are given (null otherwise). The plan: mt pixels per
// chain block, px per prep / LN-backward block, split ranges of split_px
// pixels (a multiple of 64, split = ceil(N / split_px)) for the
// weight-gradient products, ksplit ranges of dxn's reduction, the stencil
// tile th x tw; f32 takes mt = px = 16, split = ksplit = 1. Returns the
// first cudaError_t of the launches (0 = launched).
extern "C" int fused_block_backward(
    const void* x, const void* d, const void* dy, const void* dww, const void* lnw,
    const void* lnb, const void* w1, const void* b1, const void* w2, const void* gamma,
    const void* s, void* dx, void* sdys_out, void* dlnb_out, void* dlns_out, void* dbdw_out,
    void* db1_out, void* dww_out, void* mm_out, void* xn_ws,
    void* dys_ws, void* dz2_ws, void* gact_ws, void* dh1_ws, void* dd_ws, void* dxn_ws,
    void* stats_ws, void* part_vec, void* part_db1, void* part_dww, void* part_mm, int B, int H,
    int W, int C, float eps, int dtype, void* stream, int mt, int cp, int px, int split,
    int split_px, int ksplit, int th, int tw, void* dg_out, void* part_dg, int unfused) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || H < 0 || W < 0) return bad;
  if (unfused ? dtype != 1 || dg_out == nullptr || part_dg == nullptr
              : dg_out != nullptr || part_dg != nullptr)
    return bad;
  const long long smem = fused_block_bwd_plan_smem(C, dtype, mt, cp);
  if (smem < 0) return bad;
  const long long npix = (long long)B * H * W;
  if (npix == 0) return 0;
  const StencilPlan sp = stencil_plan(H, W, dtype ? 2 : 4);
  if (sp.th != th || sp.tw != tw || sp.smem > MAX_SMEM) return bad;
  if (dtype == 1) {
    const int nk = 4 * cp / BK;
    if (px != PX || npix > INT_MAX - BM || split < 1 || split_px < 1 || split_px % BK != 0 ||
        (long long)split * split_px < npix || (long long)(split - 1) * split_px >= npix ||
        ksplit < 1 || ksplit > nk || (ksplit - 1) * ksplit_steps(cp, ksplit) >= nk ||
        dz2_ws == nullptr || dxn_ws == nullptr || stats_ws == nullptr || part_db1 == nullptr ||
        part_mm == nullptr) {
      return bad;
    }
  } else if (px != M16 || split != 1 || ksplit != 1) {
    return bad;
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto fm = [](void* p) { return static_cast<float*>(p); };
  const Args a{x, d, dy, f(dww), f(lnw), f(lnb), w1, f(b1), w2, f(gamma), f(s), dx,
               fm(sdys_out), fm(dlnb_out), fm(dlns_out), fm(dbdw_out), fm(db1_out),
               fm(dww_out), fm(mm_out), xn_ws, dys_ws, dz2_ws, gact_ws, dh1_ws,
               dd_ws, fm(dxn_ws), static_cast<float2*>(stats_ws), fm(part_vec), fm(part_db1),
               fm(part_dww), fm(part_mm), B, H, W, C, cp, split, split_px, ksplit, eps,
               fm(dg_out), fm(part_dg)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(a, (size_t)smem, sp, st);
  return (int)(unfused ? launch_bf16<true>(a, sp, st) : launch_bf16<false>(a, sp, st));
}

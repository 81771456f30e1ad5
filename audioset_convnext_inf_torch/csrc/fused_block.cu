// Fused ConvNeXt block forward for Hopper (sm_90a), NHWC layout.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_fused_block.py::_kernel,
// in both its modes. One call computes a whole block:
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
// The unfused-rounding mode (bf16, template flag UNF) rounds where the
// unfused block of ops does (ops/nhwc.py::convnext_block, the JAX
// package's _block_apply), so that it computes that function:
//
//   d   = round(round(dwconv7x7(x)) + b_dw)          taps given in bf16
//   xn  = round(LN(d) * ln_w + ln_b)                 as above
//   h   = round(gelu_tanh(round(xn . W1^T + b1)))     ATen's GELU expression
//   z   = round(h . W2^T + b2)
//   y   = round(z * gamma)                            gamma given in bf16
//   out = round(x + y)                                serving
//   out = round(x + round(y * s[b]))                  save: s given in bf16
//
// and in save mode (the bf16 training step's stages 1-2: TRAIN and UNF, NB
// = 1 and 2 only) d_out is (2, N, C): d, then z, which the backward's
// unfused-rounding mode reads for dgamma. Only the stencil's and the two
// epilogues' arithmetic differ; the products, the ring and the TMA
// schedule are the same.
// Weights arrive in the reference layouts: dww (49, C) f32 tap-major (the
// wrapper transposes the (C,1,7,7) conv weight), W1 (4C, C) and W2 (C, 4C)
// in T; biases, LN affine and gamma in f32. Any C in [1, 1024].
//
// What bounds it on an H100: the two products, 8*C^2 multiply-adds per
// pixel against 49*C for the stencil: 2*N*(49*C + 8*C^2) operations, 33.8
// GFLOP at B=16 stage 3 (N=14112, C=384) and 33.0 at stage 4 (N=3472,
// C=768), 0.034 ms at the bf16 tensor-core peak, against about 23 MB of
// x, out and weights (0.007 ms at 3.35 TB/s): operations bound it. What
// stands between a kernel and that bound is the weight stream: 8*C^2
// bf16 bytes a block of pixels must read from L2 (2.4 MB at C=384, 9.4
// MB at C=768). A box of weights fetched from L2 feeds as many pixel rows
// as share it; at 128 rows it carries 128 operations a byte, below the
// ~170 a byte the tensor cores need from each SM's share of L2 (about 24
// bytes a clock), so the design shares each box as widely as the
// registers allow. Past that, a block's time goes to the stencil on the
// CUDA cores, to the first product (its 64-wide wgmma reads both operands
// from shared memory) and to GELU (PERF.md, Findings).
//
// bf16 (the serving and training paths): fused_block_wgmma_kernel<NB,
// TRAIN, UNF>, 384 threads: two consumer warpgroups and a producer warpgroup,
// all of which compute the stencil and LN first. A block takes MT = 64
// consecutive pixels (flattened over b, h, w), NB *
// 128 of the output channels (output slice o, blockIdx.y) and a range of
// the 4C hidden units (blockIdx.z); blocks come in clusters of two with
// neighbouring pixel tiles and the same slice and range.
//   1. The stencil, from x staged in shared memory: the tile's image rows
//      with their 3-row halo and 3-column padding, with the slab's 49 taps
//      and bias, as many channels at a time as the h tiles and the ring
//      hold, in 16-byte loads of 8 channels, 8 loads in flight a thread
//      (tiles of very wide rows stage one row segment at a time); no weight
//      box is in flight before both CTAs of the cluster are done with it. A
//      thread takes four channels and a run of up to 7 pixels of one row and
//      walks each staged row once, the run's sums and the row's 7 taps in
//      registers; the taps are added in the order dy, dx, one FMA each, so
//      d does not depend on the tiling. d (bf16) goes into the xn tile, and
//      in save mode to d_out.
//   2. LayerNorm, one warp a pixel, in place: xn is written straight into
//      the 128-byte swizzled K-major layout wgmma reads (sw128_offset),
//      one 64 x 64 box per 64 channels, zero beyond C and beyond N.
//   3. The hidden units in chunks of 128. The producer (one thread; its
//      warpgroup hands its registers to the consumers by setmaxnreg)
//      streams the weights by TMA in 128-row x 64 boxes (W1 boxes: hidden
//      units x 64 channels of C; W2 boxes: output channels x 64 hidden
//      units, both K-major as stored) into a ring of `stages` one-box
//      slots, a full and an empty mbarrier each. Each box is fetched once
//      per cluster and multicast into both CTAs (the two take turns): 128
//      pixel rows per box read from L2. For each chunk:
//        h = xn . W1[chunk]^T on wgmma m64n64k16, each warpgroup 64 of the
//        chunk's hidden units over all 64 pixels; + b1, GELU (tanhf),
//        rounded to bf16 into a swizzled h tile (two buffers), exchanged
//        between the warpgroups under a named barrier;
//        acc += h . W2[slice, chunk]^T, each warpgroup half of the slice's
//        output channels in one or two pieces that each lie inside one W2
//        box (m64n64k16 at NB = 1, m64n128k16 at NB = 2, m64n128k16 and
//        m64n64k16 at NB = 3, two m64n128k16 at NB = 4).
//      A warpgroup keeps one box's products in flight while it issues the
//      next box's (unless the next box is late: then it frees the last one
//      first); a slot is released once both warpgroups of both CTAs have
//      waited for the products that read it (one arrive each on both CTAs'
//      empty barrier).
//   4. The (64, 64 NB) f32 sum of a warpgroup lives in registers (32 NB a
//      thread: 32 to 128 at NB = 1 to 4, beside 32 for h, within the 232
//      registers setmaxnreg gives a consumer thread). With one
//      hidden range: + b2, * gamma, * s, + x, one rounding, from the
//      registers. With several: each block writes its f32 partial, and
//      fused_block_sum_kernel adds them in range order and finishes.
// The plan (bf16_plan): NB = CP / 128 below CP = 384 (one slice of all
// the channels there are: 3 blocks would run the second product over 3x
// the channels at C = 96), 3 up to CP = 768, else 4 (the
// registers of a (64, C) f32 sum cap a block's slice: 64 x 768 would take
// 192 registers a thread in each of two warpgroups beside everything else);
// output slices CP / (128 NB) rounded up: one up to C = 384, two above (the
// slices each recompute h); pixel tiles rounded up to pairs; the chunks
// that hold real hidden units, ceil(4C / 128) (the padded ones add only
// zeros: 4C = 384 takes 3 chunks, not 4 CP / 128 = 4); the hidden
// chunks split into ranges when the tiles and slices alone would fill
// under half the card's 132 SMs (one clip, small batches); at NB = 1 two
// blocks an SM (a block alone there waits on one latency after another:
// staging, stencil, LN, four short chunks, the epilogue), so the ring
// takes what fits in half an SM's shared memory. It depends on C
// and N only, so a pixel's result never depends on its neighbours' values.
// Every cross-block sum is added in the plan's fixed order: no atomics.
// Channels are padded to CP = 128*ceil(C/128): the wrapper hands over W1
// (4CP, CP) and W2 (CP, 4CP), zero-padded when C != CP.
//
// f32 (the f32 parity config never launches it; kept for the f32 kernel
// tests): fused_block_f32_kernel keeps the first version's scheme, 16
// pixels per block, weight tiles staged through shared memory, products as
// f32 FMAs on the CUDA cores. TF32 tensor cores would break its 1e-4 f32
// tolerance.
//
// scripts/ablate_fused_block_torch.py rebuilds this file with -D macros:
// ABLATE_STENCIL (no stencil arithmetic: d left zero), ABLATE_MMA
// (wgmma_bf16.cuh: the products are comments), ABLATE_PREFETCH (the
// producer loads only the first `stages` boxes; later ones reuse what the
// ring holds) and
// K1_SPLIT=n (n hidden ranges whatever the pixel count; the wrapper's
// launch_plan takes the same override). The package's build defines none.

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
constexpr int NT = 256;     // threads per block of the f32 kernel

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}

// the unfused-rounding mode's GELU: the expression of ATen's tanh GELU
__device__ __forceinline__ float gelu_tanh_aten(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  const float k1 = 0.044715f;
  const float x_cube = x * x * x;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x_cube)));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}


// ---------------------------------------------------------------------------
// bf16: the plan
// ---------------------------------------------------------------------------

constexpr int MT = 64;                      // pixels of a tile: one warpgroup's rows
constexpr int NH = 128;                     // hidden units of a chunk
constexpr int CLUSTER = 2;                  // CTAs that share each weight box
constexpr int SMS = 132;                    // an H100's SMs
constexpr int NT_BF = 384;                  // two consumer warpgroups + the producer's
constexpr int PRODUCER = 8;                 // the producer's first warp: lane 0 issues the loads
constexpr uint32_t CONSUMER_REGS = 232;     // setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65536
constexpr uint32_t PRODUCER_REGS = 40;
// NB = 1 (CP = 128): two blocks an SM, so that one block's stencil, LN and
// epilogue run beside the other's products: 80 registers a thread at
// launch, the producer's 32 and the consumers' 104 after setmaxnreg, the
// ring within half an SM's shared memory
constexpr uint32_t NARROW_CONSUMER_REGS = 104;
constexpr uint32_t NARROW_PRODUCER_REGS = 32;
constexpr size_t SM_SMEM = 233472;          // shared memory of an SM; each block takes 1 KB more
constexpr size_t NARROW_SMEM = SM_SMEM / 2 - 1024;  // a block's share of two, static included
template <int NB> __host__ __device__ constexpr int blocks_per_sm() { return NB == 1 ? 2 : 1; }
template <int NB> __host__ __device__ constexpr uint32_t consumer_regs() {
  return NB == 1 ? NARROW_CONSUMER_REGS : CONSUMER_REGS;
}
template <int NB> __host__ __device__ constexpr uint32_t producer_regs() {
  return NB == 1 ? NARROW_PRODUCER_REGS : PRODUCER_REGS;
}
// registers a thread at launch: all the SM's, shared by the blocks it holds
template <int NB> __host__ __device__ constexpr uint32_t launch_regs() {
  return 65536 / (NT_BF * blocks_per_sm<NB>()) / 8 * 8;
}
// setmaxnreg.inc takes only what the block's own setmaxnreg.dec released:
// the consumers may gain no more than the producer warpgroup gives up,
// else they wait for it forever
template <int NB> __host__ __device__ constexpr bool registers_balance() {
  return 2 * 128 * (consumer_regs<NB>() - launch_regs<NB>()) <=
         128 * (launch_regs<NB>() - producer_regs<NB>());
}
static_assert(registers_balance<1>() && registers_balance<2>() && registers_balance<3>() &&
              registers_balance<4>(), "setmaxnreg: the consumers' gain exceeds the producer's release");
constexpr int STAGE_CAP = 12;               // most slots of the weight ring
constexpr uint32_t BOXB = 128 * BOX * 2;    // bytes of a 128-row weight box
constexpr uint32_t XBOX = MT * BOX * 2;     // bytes of a 64 x 64 box of xn or h
constexpr uint32_t HT_BYTES = 2 * (NH / BOX) * XBOX;  // two h buffers; the stencil's staging before
constexpr size_t STATIC_RESERVE = 2048;     // static shared memory the kernel may take
constexpr int RUN = 7;                      // pixels of a stencil row run
constexpr int MAX_RUNS = 128;               // runs of a tile (64 pixels: at most 74)
constexpr int TAP_BYTES = (K * K + 1) * 8 * 4;  // a channel group's staged taps and bias

struct Plan {
  int nb, out_split, tiles, per, hidden_split, chunks, stages;
  size_t smem;
};

// The launch for C channels and npix pixels (ops/fused_block.py's
// launch_plan mirrors it; `split` > 0 forces the hidden ranges).
Plan bf16_plan(int C, long long npix, int split) {
  Plan p{};
  const int cp = padded_c(C);
  p.nb = cp < 384 ? cp / 128 : cp <= 768 ? 3 : 4;
  p.out_split = (cp + 128 * p.nb - 1) / (128 * p.nb);
  long long tiles = (npix + MT - 1) / MT;
  tiles += tiles & 1;
  p.tiles = (int)std::min<long long>(tiles, INT_MAX);
  p.chunks = (4 * C + NH - 1) / NH;  // the chunks that hold real hidden units
  const long long base = tiles * p.out_split;
  int want = 1;
  if (split > 0) {
    want = std::min(split, p.chunks);
  } else if (base > 0 && base < SMS / 2) {
    want = (int)std::min<long long>(p.chunks, SMS / base);
  }
  p.per = (p.chunks + want - 1) / want;
  p.hidden_split = (p.chunks + p.per - 1) / p.per;
  const size_t fixed = SW_ATOM + (size_t)MT * cp * 2 + HT_BYTES;
  const size_t budget = (p.nb == 1 ? NARROW_SMEM : MAX_SMEM) - STATIC_RESERVE;
  p.stages = (int)std::min<size_t>(STAGE_CAP, (budget - fixed) / BOXB);
  p.smem = fixed + (size_t)p.stages * BOXB;
  return p;
}

#ifdef K1_SPLIT
constexpr int FORCED_SPLIT = K1_SPLIT;
#else
constexpr int FORCED_SPLIT = 0;
#endif

// ---------------------------------------------------------------------------
// bf16: the kernel
// ---------------------------------------------------------------------------

struct Bf16Args {
  const bf16* x; bf16* out; const float *dww, *dwb, *lnw, *lnb, *b1, *b2, *gamma, *dps;
  bf16* d_out; float* part;
  int B, H, W, C, cp, npix, per, chunks, stages; float eps;
};

__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  return p + ((SW_ATOM - (smem_u32(p) & (SW_ATOM - 1))) & (SW_ATOM - 1));
}

// byte offset of (pixel row m, channel c) in the xn tile: 64-channel boxes
__device__ __forceinline__ uint32_t xn_offset(int m, int c) {
  return (uint32_t)(c >> 6) * XBOX + sw128_offset(m, c & 63);
}

__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int k) {
  return sw128_desc(tile + 32 * k, 16, SW_ATOM);
}

__device__ __forceinline__ void consumer_bar() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int NB, bool TRAIN, bool UNF>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT_BF, blocks_per_sm<NB>())
fused_block_wgmma_kernel(const __grid_constant__ CUtensorMap tw1,
                         const __grid_constant__ CUtensorMap tw2, const Bf16Args a) {
  static_assert(NB >= 1 && NB <= 4 && !(TRAIN && UNF && NB > 2),
                "a plan's NB; the unfused-rounding save mode is built for NB = 1, 2");
  // a warpgroup's output channels: piece 0 (acc0), 64 wide at NB = 1, else
  // 128; piece 1 (acc1), 64 wide at NB = 3, 128 at NB = 4, none below;
  // each inside one W2 box
  constexpr int N0 = NB == 1 ? 64 : 128;
  constexpr int N1 = NB == 3 ? 64 : NB == 4 ? 128 : 0;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGE_CAP], empty[STAGE_CAP];
  __shared__ int run_tab[MAX_RUNS];            // run: first pixel (from p0) << 8 | length
  __shared__ int band_first[MAX_RUNS + 1];     // first run of each staging band
  __shared__ int n_bands;
  unsigned char* xs = align_atom(smem_raw);    // xn tile: cp / 64 boxes of 64 x 64
  unsigned char* ht = xs + (size_t)MT * a.cp * 2;  // h tiles (2 x 2 boxes)
  unsigned char* ring = ht + HT_BYTES;         // `stages` slots of one weight box

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_ctarank();
  const int C = a.C, cp = a.cp, npix = a.npix;
  const int p0 = blockIdx.x * MT;
  const int valid = max(0, min(MT, npix - p0));
  const int o = blockIdx.y, z = blockIdx.z;
  const int c_begin = z * a.per, c_end = min(c_begin + a.per, a.chunks);
  const int KB = cp / BOX;                     // W1 boxes of a chunk (64 channels each)
  const int BPC = KB + 2 * NB;                 // boxes of a chunk: W1, then 2 x NB of W2
  const int T = (c_end - c_begin) * BPC;
  const int orow0 = o * 128 * NB;              // first output channel of the slice
  const int stages = a.stages;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CLUSTER * 2);       // both warpgroups of both CTAs
    }
    mbar_fence_init();
  }

  // ---- 1: the 7x7 depthwise stencil from staged x ----------------------------
  // The staging takes the h tiles and the ring: no weight box is in flight
  // before both CTAs have finished with it (the cluster_sync below).
  for (int i = tid; i < MT * cp / 8; i += NT_BF)
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
  const int W = a.W, H = a.H, rows_all = a.B * H;
  const int BUF = HT_BYTES + stages * BOXB;
  if (tid == 0) {
    // row segments of the tile, cut into runs; one staging band for the
    // whole tile where it fits 4 channel groups, else a band per segment
    int nr = 0, nb = 0;
    int p = p0, w = valid > 0 ? p0 - (p0 / W) * W : 0;
    band_first[0] = 0;
    while (p < p0 + valid) {
      const int len = min(W - w, p0 + valid - p);
      band_first[nb++] = nr;
      for (int r = 0; r < len; r += RUN) run_tab[nr++] = ((p - p0 + r) << 8) | min(RUN, len - r);
      p += len;
      w = 0;
    }
    band_first[nb] = nr;
    if (nb > 1) {
      const int last = p0 + valid - 1;
      const int ra = p0 / W, rz = last / W;
      if (((rz - ra + 1 + 2 * P) * (W + 2 * P) * 16 + TAP_BYTES) * 4 <= BUF) {  // one band
        band_first[1] = nr;
        nb = 1;
      }
    }
    n_bands = nb;
  }
  __syncthreads();
  const bool vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const bool vec4 = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(a.dww) |
                                    reinterpret_cast<uintptr_t>(a.dwb)) & 15) == 0;
  const bool pairs_out = C % 2 == 0 && (reinterpret_cast<uintptr_t>(a.d_out) & 3) == 0;
  const bool store_d = TRAIN && o == 0 && z == 0;
  const int groups = (C + 7) / 8;              // 8-channel groups holding real channels
  bf16* stg = reinterpret_cast<bf16*>(ht);     // [staged pixel][slab channels]
  for (int bd = 0; bd < n_bands; ++bd) {
    const int r0 = band_first[bd], r1 = band_first[bd + 1];
    const int pa = p0 + (run_tab[r0] >> 8);
    const int pz = p0 + (run_tab[r1 - 1] >> 8) + (run_tab[r1 - 1] & 255) - 1;
    const int ra = pa / W, rz = pz / W;
    const int col_lo = ra == rz ? pa - ra * W - P : -P;
    const int cols = ra == rz ? pz - pa + 1 + 2 * P : W + 2 * P;
    const int spx = (rz - ra + 1 + 2 * P) * cols;  // staged pixels
    const int G = min(groups, BUF / (spx * 16 + TAP_BYTES));  // channel groups a pass
    for (int g0 = 0; g0 < groups; g0 += G) {
      const int ng = min(G, groups - g0), slab = 8 * ng, c0 = 8 * g0;
      float* taps = reinterpret_cast<float*>(stg + spx * slab);  // [49][slab], then [slab] bias
      // 8 loads in flight a thread before any store: the block has few
      // warps to hide L2's latency with
      const int nt4 = (K * K + 1) * slab / 4;  // the taps and bias, 4 channels a load
#pragma unroll 1
      for (int i0 = tid; i0 < nt4; i0 += 8 * NT_BF) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * NT_BF;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nt4) {
            const int tap = i / (slab / 4), c = c0 + 4 * (i - tap * (slab / 4));
            const float* src = tap < K * K ? a.dww + tap * C + c : a.dwb + c;
            if (vec4 && c < C) {
              v[u] = *reinterpret_cast<const float4*>(src);
            } else {
              v[u].x = c < C ? src[0] : 0.f;
              v[u].y = c + 1 < C ? src[1] : 0.f;
              v[u].z = c + 2 < C ? src[2] : 0.f;
              v[u].w = c + 3 < C ? src[3] : 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + u * NT_BF < nt4) reinterpret_cast<float4*>(taps)[i0 + u * NT_BF] = v[u];
      }
      const int nx = spx * ng;                 // x: 8 channels a load
#pragma unroll 1
      for (int i0 = tid; i0 < nx; i0 += 8 * NT_BF) {
        uint4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * NT_BF;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (i < nx) {
            const int px = i / ng, g = i - px * ng;
            const int sr = px / cols, sc = px - sr * cols;
            const int gr = ra - P + sr, gw = col_lo + sc, c = c0 + 8 * g;
            if (gr >= 0 && gr < rows_all && gw >= 0 && gw < W) {
              const bf16* src = a.x + ((long long)gr * W + gw) * C + c;
              if (vec) {
                v[u] = *reinterpret_cast<const uint4*>(src);
              } else {
                float f[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) f[e] = c + e < C ? __bfloat162float(src[e]) : 0.f;
                v[u] = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                  pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * NT_BF;
          if (i < nx) {
            const int px = i / ng;
            *reinterpret_cast<uint4*>(stg + px * slab + 8 * (i - px * ng)) = v[u];
          }
        }
      }
      __syncthreads();
#ifndef ABLATE_STENCIL
      // a thread: four channels (two pairs) x a run of up to RUN pixels
      const int nquad = slab / 4;
      for (int it = tid; it < (r1 - r0) * nquad; it += NT_BF) {
        const int rr = it / nquad, qd = it - rr * nquad;
        const int c = c0 + 4 * qd;
        if (c >= C) continue;
        const int m0 = run_tab[r0 + rr] >> 8, len = run_tab[r0 + rr] & 255;
        const int pp = p0 + m0, grow = pp / W, w0 = pp - grow * W;
        const int h = grow % H;
        const float4 b4 = *reinterpret_cast<const float4*>(taps + K * K * slab + 4 * qd);
        const float bias[4] = {b4.x, b4.y, b4.z, b4.w};  // zero beyond C
        float acc[4][RUN];
#pragma unroll
        for (int j = 0; j < RUN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e][j] = UNF ? 0.f : bias[e];  // UNF: bias after a rounding
        for (int dy = 0; dy < K; ++dy) {
          const int hh = h + dy - P;
          if (hh < 0 || hh >= H) continue;
          float kt[4][K];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const float4 wt = *reinterpret_cast<const float4*>(taps + (dy * K + dx) * slab + 4 * qd);
            kt[0][dx] = wt.x;
            kt[1][dx] = wt.y;
            kt[2][dx] = wt.z;
            kt[3][dx] = wt.w;
          }
          // staged row grow - ra + dy is image row hh; staged column
          // w0 - 3 + k - col_lo feeds run pixel j through tap dx = k - j
          const bf16* srow = stg + ((grow - ra + dy) * cols + (w0 - P - col_lo)) * slab + 4 * qd;
#pragma unroll
          for (int k = 0; k < RUN + K - 1; ++k) {
            if (k < len + K - 1) {
              const uint2 u = *reinterpret_cast<const uint2*>(srow + k * slab);
              const float v[4] = {__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u)};
#pragma unroll
              for (int j = 0; j < RUN; ++j) {
                const int dx = k - j;
                if (dx >= 0 && dx < K) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[e][j] += v[e] * kt[e][dx];
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          if (j >= len) break;
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            if (c + e >= C) break;
            const bool two = c + e + 1 < C;
            float v0 = acc[e][j], v1 = two ? acc[e + 1][j] : 0.f;
            if constexpr (UNF) {
              v0 = round_bf16(v0) + bias[e];
              v1 = round_bf16(v1) + bias[e + 1];
            }
            const __nv_bfloat162 dv = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(xs + xn_offset(m0 + j, c + e)) = dv;
            if (store_d) {
              bf16* dp = a.d_out + (long long)(pp + j) * C + c + e;
              if (pairs_out) {
                *reinterpret_cast<__nv_bfloat162*>(dp) = dv;
              } else {
                dp[0] = dv.x;
                if (two) dp[1] = dv.y;
              }
            }
          }
        }
      }
#endif
      __syncthreads();
    }
  }

  // ---- 2: LayerNorm, one warp a pixel, in place in the swizzled tile ---------
  float* lnw_s = reinterpret_cast<float*>(ht);  // the LN affine, staged
  float* lnb_s = lnw_s + cp;
  for (int c = tid; c < cp; c += NT_BF) {
    lnw_s[c] = c < C ? a.lnw[c] : 0.f;
    lnb_s[c] = c < C ? a.lnb[c] : 0.f;
  }
  __syncthreads();
  const float inv_c = 1.0f / (float)C;
  for (int m = warp; m < valid; m += NT_BF / 32) {
    float s = 0.f, ss = 0.f;
    for (int g = lane; g < cp / 8; g += 32) {
      const uint4 u = *reinterpret_cast<const uint4*>(xs + xn_offset(m, 8 * g));
      const uint32_t wv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
        const float lo = __uint_as_float(wv[i] << 16), hi = __uint_as_float(wv[i] & 0xffff0000u);
        s += lo + hi;
        ss += lo * lo + hi * hi;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mean = s * inv_c;
    const float var = fmaxf(ss * inv_c - mean * mean, 0.f);
    const float rstd = rsqrtf(var + a.eps);
    for (int g = lane; g < groups; g += 32) {
      uint4* ptr = reinterpret_cast<uint4*>(xs + xn_offset(m, 8 * g));
      const uint4 u = *ptr;
      const uint32_t wv[4] = {u.x, u.y, u.z, u.w};
      const float4* lw = reinterpret_cast<const float4*>(lnw_s + 8 * g);
      const float4* lb = reinterpret_cast<const float4*>(lnb_s + 8 * g);
      const float4 w0 = lw[0], w1 = lw[1], b0 = lb[0], b1 = lb[1];
      const float wts[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bss[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float xv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * g + 2 * i;
        const float v0 = (__uint_as_float(wv[i] << 16) - mean) * rstd;
        const float v1 = (__uint_as_float(wv[i] & 0xffff0000u) - mean) * rstd;
        xv[2 * i] = c < C ? v0 * wts[2 * i] + bss[2 * i] : 0.f;
        xv[2 * i + 1] = c + 1 < C ? v1 * wts[2 * i + 1] + bss[2 * i + 1] : 0.f;
      }
      *ptr = make_uint4(pack_bf16x2(xv[0], xv[1]), pack_bf16x2(xv[2], xv[3]),
                        pack_bf16x2(xv[4], xv[5]), pack_bf16x2(xv[6], xv[7]));
    }
  }
  fence_proxy_async();  // xn is read by wgmma
  cluster_sync();       // both CTAs: barriers initialised, staging done, xn written

  if (warp >= PRODUCER) {
    // ---- the producer: box t of the stream into slot t % stages, once both
    // CTAs released the slot's previous box; the CTAs take turns to load a
    // box, multicast into both ----------------------------------------------------
    setmaxnreg_dec<producer_regs<NB>()>();
    if (warp == PRODUCER && lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int slot = t % stages, ci = t / BPC, i = t - ci * BPC, chunk = c_begin + ci;
        if (t >= stages) mbar_wait(&empty[slot], ((t / stages) - 1) & 1);
        uint64_t* bar = &full[slot];
        int c0, c1;
        const CUtensorMap* map;
        if (i < KB) {  // W1 rows of the chunk x 64 channels
          map = &tw1;
          c0 = i * BOX;
          c1 = chunk * NH;
        } else {       // W2 rows of the slice x 64 hidden units of the chunk
          const int j = i - KB, hk = j / NB, b = j - hk * NB;
          map = &tw2;
          c0 = chunk * NH + hk * BOX;
          c1 = orow0 + 128 * b;
        }
        bool load = i < KB || c1 < cp;  // a W2 box past cp only feeds channels never stored
#ifdef ABLATE_PREFETCH
        load = load && t < stages;
#endif
        if (load) {
          mbar_expect_tx(bar, BOXB);
          if ((uint32_t)(t % CLUSTER) == rank)
            tma_load_2d_mc(ring + (size_t)slot * BOXB, map, bar, c0, c1, 0x3);
        } else {
          mbar_arrive(bar);
        }
      }
    }
    __syncwarp();
  } else {
    // ---- 3: the consumers ---------------------------------------------------------
    setmaxnreg_inc<consumer_regs<NB>()>();
    const int wg = warp >> 2, q = lane & 3;
    const int r0 = 16 * (warp & 3) + (lane >> 2);  // accumulator rows r0, r0 + 8
    const int hidden = 4 * C;
    // the W2 boxes of a k-slice this warpgroup reads: piece 0 (N0 rows) from
    // box pa at row offset oa, piece 1 (N1 rows) from box pb at row offset ob
    const int pa = NB == 1 ? 0 : NB == 2 ? wg : 2 * wg, oa = NB == 1 ? 64 * wg : 0;
    const int pb = NB == 3 ? 1 : 2 * wg + 1, ob = NB == 3 ? 64 * wg : 0;
    // (NB = 1: piece 0 the first or second half of box 0; NB = 2: box 0 or
    // 1; NB = 3: piece 0 from box 0 or 2, piece 1 the first or second half
    // of box 1; NB = 4: boxes 0 and 1, or 2 and 3)
    float acc0[N0 / 2], acc1[N1 > 0 ? N1 / 2 : 1];
#pragma unroll
    for (int i = 0; i < N0 / 2; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (N1 > 0 ? N1 / 2 : 1); ++i) acc1[i] = 0.f;
    int slot = 0;
    uint32_t phase = 0;
    auto take = [&]() {  // the next box of the stream, once it has landed
      const int s = slot;
      mbar_wait(&full[s], phase);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
      return s;
    };
    auto give = [&](int s) {  // this warpgroup is done with slot s: tell both CTAs
      if ((tid & 127) == 0) {
        mbar_arrive(&empty[s]);
        mbar_arrive_cluster(&empty[s], rank ^ 1);
      }
    };
    for (int chunk = c_begin; chunk < c_end; ++chunk) {
      // h (64 x 64: this warpgroup's half of the chunk) = xn . W1[rows]^T;
      // one box's products stay in flight while the next box's are issued
      float h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
      int held = -1;
      for (int kb = 0; kb < KB; ++kb) {
        if (held >= 0 && !mbar_test(&full[slot], phase)) {
          wgmma_wait<0>();  // the next box is late: free the last one first
          give(held);
          held = -1;
        }
        const int s = take();
        const unsigned char* wb = ring + (size_t)s * BOXB + wg * XBOX;
        fence_acc(h);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk)
          wgmma_m64n64k16<0, 0>(h, kdesc(xs + kb * XBOX, kk), kdesc(wb, kk));
        wgmma_commit();
        if (held >= 0) {
          wgmma_wait<1>();
          give(held);
        }
        held = s;
        fence_acc(h);
      }
      wgmma_wait<0>();
      give(held);
      fence_acc(h);
      // + b1, GELU, one rounding, into this warpgroup's box of the h tile
      unsigned char* hb = ht + ((chunk - c_begin) & 1) * (2 * XBOX);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * q;
        const int j = chunk * NH + wg * 64 + col;
        const float bj0 = j < hidden ? a.b1[j] : 0.f;
        const float bj1 = j + 1 < hidden ? a.b1[j + 1] : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + 8 * hh;
          const float v0 = h[4 * i + 2 * hh] + bj0, v1 = h[4 * i + 2 * hh + 1] + bj1;
          *reinterpret_cast<uint32_t*>(hb + wg * XBOX + sw128_offset(row, col)) =
              UNF ? pack_bf16x2(gelu_tanh_aten(round_bf16(v0)), gelu_tanh_aten(round_bf16(v1)))
                  : pack_bf16x2(gelu_tanh(v0), gelu_tanh(v1));
        }
      }
      fence_proxy_async();
      consumer_bar();  // both halves of the chunk's h are in the tile
      // acc += h . W2[this warpgroup's rows of the slice, chunk]^T, one
      // 64-deep k-slice (NB boxes) at a time
      int prev[NB];
      // hold a k-slice only where the ring keeps NB more boxes for the next chunk
      const bool hold = stages >= 3 * NB;
      for (int hk = 0; hk < NH / BOX; ++hk) {
        int sl[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) sl[b] = take();
        // (ternaries, not sl[pa]: a run-time index would put sl in local memory)
        int sa = sl[0], sb = sl[0];
        if constexpr (NB == 2) sa = wg ? sl[1] : sl[0];
        if constexpr (NB >= 3) sa = wg ? sl[2] : sl[0];
        if constexpr (NB == 3) sb = sl[1];
        if constexpr (NB == 4) sb = wg ? sl[3] : sl[1];
        const unsigned char* wa = ring + (size_t)sa * BOXB + oa * 128;
        const unsigned char* wbp = ring + (size_t)sb * BOXB + ob * 128;
        fence_acc(acc0);
        if constexpr (N1 > 0) fence_acc(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk) {
          const uint64_t da = kdesc(hb + hk * XBOX, kk);
          if constexpr (N0 == 128) {
            wgmma_m64n128k16<0, 0>(acc0, da, kdesc(wa, kk));
          } else {
            wgmma_m64n64k16<0, 0>(acc0, da, kdesc(wa, kk));
          }
          if constexpr (N1 == 64) {
            wgmma_m64n64k16<0, 0>(acc1, da, kdesc(wbp, kk));
          } else if constexpr (N1 == 128) {
            wgmma_m64n128k16<0, 0>(acc1, da, kdesc(wbp, kk));
          }
        }
        wgmma_commit();
        if (hk == 0 && hold) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
          if (hk == 1 && hold) {
#pragma unroll
            for (int b = 0; b < NB; ++b) give(prev[b]);
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) give(sl[b]);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) prev[b] = sl[b];
        fence_acc(acc0);
        if constexpr (N1 > 0) fence_acc(acc1);
      }
    }

    // ---- 4: + b2, * gamma, * s, + x, one rounding (UNF: a rounding after
    // each step); or the f32 partial ------------------------------------------------
    const bool finish = gridDim.z == 1;
    const int HW = H * W;
    const bool pairs_x = C % 2 == 0 && ((reinterpret_cast<uintptr_t>(a.x) |
                                         reinterpret_cast<uintptr_t>(a.out)) & 3) == 0;
    // column n of a piece at channel base cb
    auto emit = [&](int cb, int n, float y0, float y1, int hh) {
      const int c = cb + n;
      const int m = r0 + 8 * hh;
      if (c >= C || m >= valid) return;
      const int p = p0 + m;
      if (!finish) {
        *reinterpret_cast<float2*>(a.part + ((long long)z * npix + p) * cp + c) = make_float2(y0, y1);
        return;
      }
      const bool two = c + 1 < C;
      const long long off = (long long)p * C + c;
      y0 += a.b2[c];
      y1 += two ? a.b2[c + 1] : 0.f;
      if constexpr (UNF) {
        y0 = round_bf16(y0);
        y1 = round_bf16(y1);
        if constexpr (TRAIN) {  // z, after d in d_out
          bf16* zp = a.d_out + (long long)npix * C + off;
          const __nv_bfloat162 zv = __floats2bfloat162_rn(y0, y1);
          if (pairs_out) {  // z's offset from d_out, N C, is even with C
            *reinterpret_cast<__nv_bfloat162*>(zp) = zv;
          } else {
            zp[0] = zv.x;
            if (two) zp[1] = zv.y;
          }
        }
      }
      if (a.gamma != nullptr) {
        y0 *= a.gamma[c];
        y1 *= two ? a.gamma[c + 1] : 1.f;
        if constexpr (UNF) {
          y0 = round_bf16(y0);
          y1 = round_bf16(y1);
        }
      }
      if constexpr (TRAIN) {
        const float sc = a.dps[p / HW];
        y0 *= sc;
        y1 *= sc;
        if constexpr (UNF) {
          y0 = round_bf16(y0);
          y1 = round_bf16(y1);
        }
      }
      if (pairs_x) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + off));
        *reinterpret_cast<__nv_bfloat162*>(a.out + off) = __floats2bfloat162_rn(xv.x + y0, xv.y + y1);
      } else {
        a.out[off] = __float2bfloat16_rn(__bfloat162float(a.x[off]) + y0);
        if (two) a.out[off + 1] = __float2bfloat16_rn(__bfloat162float(a.x[off + 1]) + y1);
      }
    };
    const int cb0 = orow0 + 128 * pa + oa, cb1 = orow0 + 128 * pb + ob;
#pragma unroll
    for (int i = 0; i < N0 / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        emit(cb0, 8 * i + 2 * q, acc0[4 * i + 2 * hh], acc0[4 * i + 2 * hh + 1], hh);
    if constexpr (N1 > 0) {
#pragma unroll
      for (int i = 0; i < N1 / 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          emit(cb1, 8 * i + 2 * q, acc1[4 * i + 2 * hh], acc1[4 * i + 2 * hh + 1], hh);
    }
  }
  cluster_sync();  // neither CTA leaves while the other may still signal its barriers
}

// out = round(x + ((sum of the ranges' partials in range order + b2) * gamma)
// * s[b]), one thread an element: the hidden ranges' fixed-order sum (UNF:
// the kernel's unfused-rounding epilogue, in save mode z into z_out).
template <bool TRAIN, bool UNF>
__global__ void __launch_bounds__(NT) fused_block_sum_kernel(
    const float* __restrict__ part, int splits, const bf16* __restrict__ x, bf16* __restrict__ out,
    const float* __restrict__ b2, const float* __restrict__ gamma, const float* __restrict__ dps,
    bf16* __restrict__ z_out, int npix, int HW, int C, int cp) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)npix * C) return;
  const int p = (int)(i / C), c = (int)(i - (long long)p * C);
  float s = part[(long long)p * cp + c];
  for (int r = 1; r < splits; ++r) s += part[((long long)r * npix + p) * cp + c];
  float y = s + b2[c];
  if constexpr (UNF) y = round_bf16(y);
  if constexpr (TRAIN && UNF) z_out[i] = __float2bfloat16_rn(y);
  if (gamma != nullptr) y = UNF ? round_bf16(y * gamma[c]) : y * gamma[c];
  if constexpr (TRAIN) y = UNF ? round_bf16(y * dps[p / HW]) : y * dps[p / HW];
  out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + y);
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
  const float* gamma; const float* s; void* d_out; float* part; int B, H, W, C, cp; float eps;
};

template <int NB, bool TRAIN, bool UNF>
int launch_wgmma(const Args& a, const Plan& p, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(fused_block_wgmma_kernel<NB, TRAIN, UNF>, p.smem, granted);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm<NB>() > 1) {  // all of the SM's memory to shared, for two blocks
    static std::atomic<bool> carved{false};
    if (!carved.load()) {
      err = cudaFuncSetAttribute(fused_block_wgmma_kernel<NB, TRAIN, UNF>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
      carved.store(true);
    }
  }
  const int cp = a.cp, npix = a.B * a.H * a.W;
  CUtensorMap w1, w2;  // 128-row x 64 boxes of W1 (4cp, cp) and W2 (cp, 4cp)
  if ((err = encode_tmap_2d(&w1, a.w1, cp, 4 * cp, BOX, 128)) != cudaSuccess) return (int)err;
  if ((err = encode_tmap_2d(&w2, a.w2, 4 * cp, cp, BOX, 128)) != cudaSuccess) return (int)err;
  const auto cb = [](const void* q) { return static_cast<const bf16*>(q); };
  const Bf16Args ka{cb(a.x), static_cast<bf16*>(a.out), a.dww, a.dwb, a.lnw, a.lnb, a.b1, a.b2,
                    a.gamma, a.s, static_cast<bf16*>(a.d_out), a.part, a.B, a.H, a.W, a.C, cp,
                    npix, p.per, p.chunks, p.stages, a.eps};
  fused_block_wgmma_kernel<NB, TRAIN, UNF><<<dim3(p.tiles, p.out_split, p.hidden_split), NT_BF,
                                             p.smem, st>>>(w1, w2, ka);
  if ((err = cudaGetLastError()) != cudaSuccess || p.hidden_split == 1) return (int)err;
  const long long n = (long long)npix * a.C;
  bf16* z_out = TRAIN && UNF ? static_cast<bf16*>(a.d_out) + n : nullptr;
  fused_block_sum_kernel<TRAIN, UNF><<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(
      a.part, p.hidden_split, cb(a.x), static_cast<bf16*>(a.out), a.b2, a.gamma, a.s, z_out,
      npix, a.H * a.W, a.C, cp);
  return (int)cudaGetLastError();
}

template <bool TRAIN, bool UNF>
int launch_bf16(const Args& a, const Plan& p, cudaStream_t st) {
  if constexpr (TRAIN && UNF) {  // built for the training route's widths only
    switch (p.nb) {
      case 1: return launch_wgmma<1, true, true>(a, p, st);
      case 2: return launch_wgmma<2, true, true>(a, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (p.nb) {
      case 1: return launch_wgmma<1, TRAIN, UNF>(a, p, st);
      case 2: return launch_wgmma<2, TRAIN, UNF>(a, p, st);
      case 3: return launch_wgmma<3, TRAIN, UNF>(a, p, st);
      default: return launch_wgmma<4, TRAIN, UNF>(a, p, st);
    }
  }
}

template <bool TRAIN>
int launch_f32(const Args& a, size_t smem, cudaStream_t st) {
  static std::atomic<int> granted[32];
  cudaError_t err = allow_smem(fused_block_f32_kernel<TRAIN>, smem, granted);
  if (err != cudaSuccess) return err;
  const long long npix = (long long)a.B * a.H * a.W;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  fused_block_f32_kernel<TRAIN><<<(unsigned)((npix + M16 - 1) / M16), NT, smem, st>>>(
      f(a.x), static_cast<float*>(a.out), a.dww, a.dwb, a.lnw, a.lnb, f(a.w1), a.b1, f(a.w2),
      a.b2, a.gamma, a.s, static_cast<float*>(a.d_out), a.B, a.H, a.W, a.C, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory in bytes of one block under the launch plan, or -1 if the
// kernel cannot run that plan. dtype 0 = float32: mt = 16, cp = C, one
// slice, one range, stages 0. dtype 1 = bfloat16: the plan bf16_plan
// gives C and npix (mt = 64, cp = 128*ceil(C/128), out_split output
// slices, hidden_split ranges of `per` chunks of 128 hidden units, `stages`
// ring stages), and npix below 2^31 - 128.
extern "C" long long fused_block_plan_smem(int C, int dtype, long long npix, int mt, int cp,
                                           int out_split, int hidden_split, int per, int stages) {
  if (C < 1 || C > 1024 || npix < 0) return -1;
  size_t smem;
  if (dtype == 0) {
    if (mt != M16 || cp != C || out_split != 1 || hidden_split != 1 || per != 0 || stages != 0)
      return -1;
    smem = f32_smem_bytes(C);
  } else if (dtype == 1) {
    const Plan p = bf16_plan(C, npix, FORCED_SPLIT);
    if (npix > INT_MAX - 2 * MT || mt != MT || cp != padded_c(C) || out_split != p.out_split ||
        hidden_split != p.hidden_split || per != p.per || stages != p.stages || p.stages < 1)
      return -1;
    smem = p.smem;
  } else {
    return -1;
  }
  return smem + (dtype == 1 ? STATIC_RESERVE : 0) <= MAX_SMEM ? (long long)smem : -1;
}

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16.
// gamma may be null; s and d_out are both given (save mode) or both null;
// unfused = 1 selects the unfused-rounding mode (bf16 only: the taps, gamma
// and s hold bf16 values; in save mode C <= 256, and d_out holds 2 N C
// values: d, then z).
// The plan's numbers are the wrapper's (see fused_block_plan_smem); in
// bf16, w1 is (4cp, cp) and w2 (cp, 4cp), zero beyond C and 4C, and `part`
// is an f32 (hidden_split, npix, cp) workspace when hidden_split > 1 (else
// null). Returns the first cudaError_t of the launches (0 = launched).
extern "C" int fused_block_forward(
    const void* x, void* out, const void* dww, const void* dwb,
    const void* lnw, const void* lnb, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* s, void* d_out,
    int B, int H, int W, int C, float eps, int dtype, void* stream, int mt, int cp,
    int out_split, int hidden_split, int per, int stages, void* part, int unfused) {
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  const long long smem =
      fused_block_plan_smem(C, dtype, npix, mt, cp, out_split, hidden_split, per, stages);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if ((s == nullptr) != (d_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (unfused && (dtype != 1 || (s != nullptr && padded_c(C) > 256)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (hidden_split > 1) != (part != nullptr)) return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Args a{x, out, f(dww), f(dwb), f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(gamma), f(s),
               d_out, static_cast<float*>(part), B, H, W, C, cp, eps};
  const bool train = s != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return train ? launch_f32<true>(a, smem, st) : launch_f32<false>(a, smem, st);
  const Plan p = bf16_plan(C, npix, FORCED_SPLIT);
  if (train) return unfused ? launch_bf16<true, true>(a, p, st) : launch_bf16<true, false>(a, p, st);
  return unfused ? launch_bf16<false, true>(a, p, st) : launch_bf16<false, false>(a, p, st);
}

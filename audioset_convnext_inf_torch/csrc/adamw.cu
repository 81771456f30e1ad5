// AdamW / Adam update of every parameter tensor of a model in one launch
// (or a few), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optax's update
// (optax.adamw / optax.adam, engine/trainer.py) to XLA, which fuses it. It
// replaces the port's per-leaf loop of ATen ops (ops/adamw.py::
// adamw_update_reference), which issues about 16 launches a parameter
// tensor, some 3,000 a step for convnext_tiny's 184 tensors, and so keeps
// the card waiting on the host.
//
// Arithmetic: exactly that loop's as ATen computes it on the card, each
// operation rounded to f32 on its own (no contraction into FMAs: __fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn, all IEEE), in the loop's order:
//
//   m = c1 * g + b1 * m                 c1 = (float)(1 - b1), b1 = (float)b1
//   v = c2 * (g * g) + b2 * v
//   u = (m * inv_bc1) / (sqrt(v * inv_bc2) + eps)
//   u = u + wd * p                      where the leaf decays
//   p = p + u * neg_lr
//
// where every scalar is the host's double rounded to float, and inv_bc =
// (float)(1.0 / bc): ATen divides a tensor by a CPU scalar as a product
// with the scalar's reciprocal, taken in double and then rounded (PyTorch
// 2.11 on an H100: bit-equal over 4 M values at 48 bias corrections, where
// the reciprocal taken in f32 differs in most of them).
//
// What bounds it on an H100: bytes. It reads p, g, m, v and writes p, m, v
// once: 28 bytes a parameter, 16 operations (14 without decay). 790 MB for
// convnext_tiny's 28,222,767 parameters, 0.236 ms at 3.35 TB/s; the
// arithmetic is far under the card's rate. What the design does about it:
//   - one block per chunk of CHUNK values of one leaf, all leaves of a launch
//     in one grid, so that the launch runs as one stream however small a
//     leaf is; a block finds its leaf by a binary search over the table's
//     first blocks (uniform over the block, read from the parameter bank);
//   - each thread keeps VEC 16-byte loads of each array in flight before it
//     computes (16-byte loads where all four pointers are 16-byte aligned;
//     a chunk starts at a multiple of CHUNK values, so chunks stay aligned),
//     scalar loads for a leaf's ragged last values and for unaligned leaves;
//   - the leaf table travels in the kernel's parameters (__grid_constant__,
//     under 4 KB: MAX_LEAVES leaves a launch), so a step copies nothing to
//     the card and never synchronises; the wrapper splits the leaves into
//     as few launches as that allows (two for convnext_tiny);
//   - it updates in place and allocates nothing.
// A chunk of 2048 values keeps a block short (57 KB of traffic), so the
// last wave of blocks leaves the card idle for little time at each launch's
// end.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                 // threads a block
constexpr int VEC = 2;                       // float4 of each array a thread per chunk
constexpr int CHUNK = THREADS * 4 * VEC;     // values a block updates: 2048
constexpr int MAX_LEAVES = 96;               // leaves a launch's table holds
constexpr unsigned char DECAY = 1;           // the leaf takes weight decay
constexpr unsigned char ALIGNED = 2;         // p, g, m and v are 16-byte aligned

struct Table {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  int n[MAX_LEAVES];             // values of each leaf
  int start[MAX_LEAVES + 1];     // each leaf's first block, then the grid's size
  unsigned char flags[MAX_LEAVES];
  int leaves;
};

struct Step {
  float c1, b1, c2, b2, inv_bc1, inv_bc2, eps, wd, neg_lr;
};

static_assert(sizeof(Table) + sizeof(Step) <= 4096, "a launch's parameters exceed 4 KB");

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, bool decay,
                                       const Step& s) {
  m = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  float u = __fdiv_rn(__fmul_rn(m, s.inv_bc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(u, s.neg_lr));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        bool decay, const Step& s) {
  update(p.x, g.x, m.x, v.x, decay, s);
  update(p.y, g.y, m.y, v.y, decay, s);
  update(p.z, g.z, m.z, v.z, decay, s);
  update(p.w, g.w, m.w, v.w, decay, s);
}

__global__ void __launch_bounds__(THREADS) adamw_kernel(const __grid_constant__ Table t,
                                                        const __grid_constant__ Step s) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.leaves;  // the last leaf whose first block is b or before
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.start[mid] <= b) lo = mid; else hi = mid;
  }
  const long long first = (long long)(b - t.start[lo]) * CHUNK;
  const int count = (int)min((long long)CHUNK, (long long)t.n[lo] - first);
  float* p = t.p[lo] + first;
  const float* g = t.g[lo] + first;
  float* m = t.m[lo] + first;
  float* v = t.v[lo] + first;
  const bool decay = t.flags[lo] & DECAY;
  int done = 0;  // values of the chunk the vector loads take
  if (t.flags[lo] & ALIGNED) {
    const int quads = count >> 2;
    float4 P[VEC], G[VEC], M[VEC], V[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int q = threadIdx.x + j * THREADS;
      if (q < quads) {
        P[j] = reinterpret_cast<const float4*>(p)[q];
        G[j] = __ldg(reinterpret_cast<const float4*>(g) + q);
        M[j] = reinterpret_cast<const float4*>(m)[q];
        V[j] = reinterpret_cast<const float4*>(v)[q];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int q = threadIdx.x + j * THREADS;
      if (q < quads) {
        update4(P[j], G[j], M[j], V[j], decay, s);
        reinterpret_cast<float4*>(p)[q] = P[j];
        reinterpret_cast<float4*>(m)[q] = M[j];
        reinterpret_cast<float4*>(v)[q] = V[j];
      }
    }
    done = quads << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += THREADS) {
    float pi = p[i], mi = m[i], vi = v[i];
    update(pi, __ldg(g + i), mi, vi, decay, s);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// The layout the wrapper plans for (ops/adamw.py checks it on the card).
extern "C" int adamw_chunk() { return CHUNK; }
extern "C" int adamw_max_leaves() { return MAX_LEAVES; }
extern "C" long long adamw_param_bytes() { return (long long)(sizeof(Table) + sizeof(Step)); }

// Plain C entry point for ctypes: one launch over `leaves` leaves (1 to
// MAX_LEAVES). ptrs holds p, g, m, v of each leaf in turn (f32, contiguous,
// on the stream's device); n each leaf's values; start each leaf's first
// block and, last, the grid's size, as the wrapper's plan gives them (a leaf
// of n values takes ceil(n / CHUNK) blocks); decay 1 where the leaf takes
// weight decay. The scalars as the header says. Returns the launch's
// cudaError_t (0 = launched); a table that does not hold together is
// refused (cudaErrorInvalidValue) before anything runs.
extern "C" int adamw_update(const unsigned long long* ptrs, const int* n, const int* start,
                            const unsigned char* decay, int leaves, float c1, float b1,
                            float c2, float b2, float inv_bc1, float inv_bc2, float eps,
                            float wd, float neg_lr, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (leaves < 1 || leaves > MAX_LEAVES || start[0] != 0) return bad;
  Table t{};
  for (int i = 0; i < leaves; ++i) {
    if (n[i] < 0 || start[i + 1] - start[i] != ((long long)n[i] + CHUNK - 1) / CHUNK) return bad;
    bool aligned = true;
    for (int k = 0; k < 4; ++k) {
      if (n[i] > 0 && ptrs[4 * i + k] == 0) return bad;
      aligned = aligned && ptrs[4 * i + k] % 16 == 0;
    }
    t.p[i] = reinterpret_cast<float*>(ptrs[4 * i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    t.m[i] = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    t.v[i] = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    t.n[i] = n[i];
    t.start[i] = start[i];
    t.flags[i] = (decay[i] ? DECAY : 0) | (aligned ? ALIGNED : 0);
  }
  t.start[leaves] = start[leaves];
  t.leaves = leaves;
  if (start[leaves] == 0) return 0;
  const Step s{c1, b1, c2, b2, inv_bc1, inv_bc2, eps, wd, neg_lr};
  adamw_kernel<<<start[leaves], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t, s);
  return (int)cudaGetLastError();
}

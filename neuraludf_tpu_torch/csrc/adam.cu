// The training step's Adam update for Hopper (sm_90a): every leaf of the
// parameter tree in one pass.
//
// Replaces no TPU kernel: the JAX package leaves Adam to XLA, which fuses
// its elementwise chain. Without this kernel the port ran that chain as
// PyTorch operations, about 33 small kernels a leaf (2,800 for the 85
// leaves of the DTU tree) and their temporaries.
//
// The function is ``train/optim.py`` ``adam_update`` leaf by leaf, each
// element through its operations in its order, in f32: the gated moments,
// t + trainable, the bias corrections of max(t, 1), then the step. Every
// operation is an _rn intrinsic, so that nvcc contracts no product and sum
// into an FMA where PyTorch rounds them apart; the result is PyTorch's bit
// for bit wherever powf agrees (a 0-dim f32 op there too). A leaf without a
// gradient (null g) reads zeros, as ``adam_step`` gives it.
//
// What bounds it on this card: bytes. An element reads p, g, m and v and
// writes p, m and v: 28 bytes, 36.2 MB for the 1,291,484 elements of the
// DTU tree, 10.8 us at 3.35 TB/s. Its arithmetic is ~20 flop an element.
//
// What this design does about it: one pass. The leaves' table goes by value
// in the launch's parameters (80 bytes a leaf, up to 128 leaves a launch;
// parameters above 4 KB need CUDA 12.1), so it is neither an allocation
// nor a host copy, and a captured graph keeps it. A block walks chunks of
// 2,048 elements of one leaf (grid-stride over the chunks of every leaf),
// 16-byte loads where the leaf's four arrays allow. Learning rates and
// trainabilities are read through device pointers (a schedule row's
// entries, which every replay of a graph rewrites) or taken as values.
// Many blocks read a leaf's step count t, so the element pass only reads
// it; a one-block launch after it advances every count: two launches for up
// to 128 leaves.
//
// Plain C interface (loaded with ctypes); the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define ADAM_THREADS 256
#define ADAM_CHUNK 2048        // elements a block takes at a time: 2 float4 a thread
#define ADAM_MAX_LEAVES 128    // leaves a launch: the table is 10,248 bytes of parameters
#define ADAM_MAX_BLOCKS 4096

// BETA1, BETA2, EPS of train/optim.py; 1 - BETA as Python computes it in
// double, then rounded to f32 as PyTorch rounds a Python scalar
#define BETA1 0.9f
#define BETA2 0.999f
#define OMB1 ((float)(1.0 - 0.9))
#define OMB2 ((float)(1.0 - 0.999))
#define EPS 1e-8f

// One leaf; the layout of ops/adam.py's _Leaf.
struct AdamLeaf {
  float* p;
  const float* g;   // null: no gradient, read as zeros
  float* m;
  float* v;
  float* t;         // the leaf's step count, 0-dim
  const float* lr;  // null: lr_val
  const float* tr;  // null: tr_val
  float lr_val;
  float tr_val;
  int n;       // elements
  int chunk0;  // first chunk of the leaf in the launch (set by adam_update)
  int vec;     // p, g, m and v 16-byte aligned (set by adam_update)
  int pad;
};

struct AdamTable {
  AdamLeaf leaf[ADAM_MAX_LEAVES];
  int n_leaves;
  int n_chunks;
};

// The per-leaf scalars of adam_update, from the leaf's step count before
// this step.
struct Coef {
  float tr, omtr, trlr, bc1, bc2;
};

__device__ __forceinline__ Coef coef_of(const AdamLeaf& L) {
  Coef c;
  c.tr = L.tr ? *L.tr : L.tr_val;
  const float lr = L.lr ? *L.lr : L.lr_val;
  c.omtr = __fsub_rn(1.f, c.tr);
  c.trlr = __fmul_rn(c.tr, lr);
  const float t_safe = fmaxf(__fadd_rn(*L.t, c.tr), 1.f);
  c.bc1 = __fsub_rn(1.f, powf(BETA1, t_safe));
  c.bc2 = __fsub_rn(1.f, powf(BETA2, t_safe));
  return c;
}

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, const Coef& c) {
  // m = tr * (BETA1 * m + (1 - BETA1) * g) + (1 - tr) * m, and v alike on g * g
  const float m1 = __fadd_rn(__fmul_rn(c.tr, __fadd_rn(__fmul_rn(BETA1, m), __fmul_rn(OMB1, g))),
                             __fmul_rn(c.omtr, m));
  const float v1 = __fadd_rn(
      __fmul_rn(c.tr, __fadd_rn(__fmul_rn(BETA2, v), __fmul_rn(OMB2, __fmul_rn(g, g)))),
      __fmul_rn(c.omtr, v));
  // p - tr * lr * m_hat / (sqrt(v_hat) + EPS)
  const float m_hat = __fdiv_rn(m1, c.bc1);
  const float v_hat = __fdiv_rn(v1, c.bc2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.trlr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), EPS)));
  m = m1;
  v = v1;
}

__device__ __forceinline__ void adam_one(const AdamLeaf& L, long long i, const Coef& c) {
  float p = L.p[i], m = L.m[i], v = L.v[i];
  adam_elem(p, L.g ? __ldg(L.g + i) : 0.f, m, v, c);
  L.p[i] = p;
  L.m[i] = m;
  L.v[i] = v;
}

__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(const __grid_constant__ AdamTable tab) {
  for (int chunk = blockIdx.x; chunk < tab.n_chunks; chunk += gridDim.x) {
    // the leaf that holds the chunk: the last whose first chunk is <= it
    // (a leaf of no elements shares its first chunk with the next leaf)
    int lo = 0, hi = tab.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.leaf[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
    }
    const AdamLeaf& L = tab.leaf[lo];
    const Coef c = coef_of(L);
    const long long base = (long long)(chunk - L.chunk0) * ADAM_CHUNK;
    const int count = (int)min((long long)ADAM_CHUNK, (long long)L.n - base);
    if (L.vec) {
      for (int j = threadIdx.x * 4; j < count; j += ADAM_THREADS * 4) {
        const long long i = base + j;
        if (j + 4 > count) {  // the leaf's last elements, fewer than 4
          for (long long k = i; k < base + count; ++k) adam_one(L, k, c);
          continue;
        }
        float4 p = *reinterpret_cast<const float4*>(L.p + i);
        float4 m = *reinterpret_cast<const float4*>(L.m + i);
        float4 v = *reinterpret_cast<const float4*>(L.v + i);
        const float4 g = L.g ? __ldg(reinterpret_cast<const float4*>(L.g + i))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        adam_elem(p.x, g.x, m.x, v.x, c);
        adam_elem(p.y, g.y, m.y, v.y, c);
        adam_elem(p.z, g.z, m.z, v.z, c);
        adam_elem(p.w, g.w, m.w, v.w, c);
        *reinterpret_cast<float4*>(L.p + i) = p;
        *reinterpret_cast<float4*>(L.m + i) = m;
        *reinterpret_cast<float4*>(L.v + i) = v;
      }
    } else {
      for (int j = threadIdx.x; j < count; j += ADAM_THREADS) adam_one(L, base + j, c);
    }
  }
}

// t = t + trainable for every leaf, after the element pass has read t.
__global__ void adam_count_kernel(const __grid_constant__ AdamTable tab) {
  const int i = threadIdx.x;
  if (i < tab.n_leaves) {
    const AdamLeaf& L = tab.leaf[i];
    *L.t = __fadd_rn(*L.t, L.tr ? *L.tr : L.tr_val);
  }
}

// leaves[n_leaves] as ops/adam.py fills them (chunk0 and vec are set
// here); two launches on `stream` for every 128 leaves.
extern "C" int adam_update(const AdamLeaf* leaves, int n_leaves, cudaStream_t stream) {
  if (n_leaves < 0) return (int)cudaErrorInvalidValue;
  for (int first = 0; first < n_leaves; first += ADAM_MAX_LEAVES) {
    AdamTable tab = {};
    tab.n_leaves = n_leaves - first < ADAM_MAX_LEAVES ? n_leaves - first : ADAM_MAX_LEAVES;
    long long chunks = 0;
    for (int i = 0; i < tab.n_leaves; ++i) {
      AdamLeaf L = leaves[first + i];
      if (L.n < 0 || !L.p || !L.m || !L.v || !L.t) return (int)cudaErrorInvalidValue;
      L.chunk0 = (int)chunks;
      L.vec = ((uintptr_t)L.p | (uintptr_t)L.g | (uintptr_t)L.m | (uintptr_t)L.v) % 16 == 0;
      chunks += (L.n + (long long)ADAM_CHUNK - 1) / ADAM_CHUNK;
      if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
      tab.leaf[i] = L;
    }
    tab.n_chunks = (int)chunks;
    if (chunks > 0) {
      const int blocks = chunks < ADAM_MAX_BLOCKS ? (int)chunks : ADAM_MAX_BLOCKS;
      adam_kernel<<<blocks, ADAM_THREADS, 0, stream>>>(tab);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    adam_count_kernel<<<1, ADAM_MAX_LEAVES, 0, stream>>>(tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

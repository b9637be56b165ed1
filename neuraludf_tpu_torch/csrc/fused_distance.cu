// Fused distance-field kernels for Hopper (sm_90a): K1 (forward) and K2
// (its second-order backward), and K5 (the value-only pass of the
// up-sampling, which the JAX package leaves to XLA; see its section below).
//
// Replaces the two Pallas TPU kernels of neuraludf_tpu/ops/fused_distance.py:
//   K1  _build -> call_fwd (body _fwd_body): the UDF MLP forward (PE, 8x256
//       softplus-100 layers with a skip concat, 257-wide head) plus one
//       reverse sweep for the spatial gradient -> (udf, feature, grad).
//   K2  _build -> call_bwd (body _bwd_body, fused.defvjp): the VJP of
//       (udf, feature, grad) w.r.t. (x, W, b), second order through grad.
//
// What bounds it on this card: operations. At the main-path width
// (58,368 points, 8x256, abs head) the function needs 1.967 MFLOP a point
// in K1 (a forward pass and a gradient sweep whose head product is one
// column: 1.15e11 flop) and 5.901 MFLOP in K2 (six passes less three
// head-width products: 3.44e11 flop), while their inputs and outputs are
// ~65 MB: far above the H100's ~295 flop/byte ridge, so the tensor-core
// rate (bf16 at tier "default", two or three bf16 passes a product at
// "high", three tf32 passes at "highest") or, on the nets the sweeps refuse,
// the CUDA cores' f32 rate is the limit: 0.116 / 0.348 ms in bf16, 0.294 /
// 0.813 ms in bf16x3, 0.696 / 2.087 ms in 3xTF32, 1.714 / 5.141 ms in f32
// (NVIDIA H100 80GB HBM3, 700 W, published peaks).
//
// What the design of tier "default" does about it (sweep_kernel,
// wgrad_kernel):
//   * Row-tile-resident sweeps. A persistent grid of one 256-thread block
//     per SM walks the row tiles. A block owns 128 rows of operands and runs
//     every layer of the forward and of the reverse sweep on them; the
//     activations stay in shared memory as bf16 wgmma operands (five
//     [128 x 64] panels in the 128-byte swizzle, 80 KB). Each of the two
//     warpgroups owns 64 rows and runs wgmma.mma_async m64n256k16 (bf16 x
//     bf16 -> f32, accumulators in registers).
//   * Weights are packed once per call to bf16, as W and as W^T, so that
//     both sweeps read their B operand K-major. They live in L2; a block
//     streams them through a 4-stage ring of [256 x 64] slices with cp.async,
//     two slices ahead of the tensor cores, across layer and tile borders
//     (the slice order is a table built on the host).
//   * Epilogues in registers: bias, softplus100, sigma(100a), the
//     second-derivative factor and the skip split are applied to the
//     accumulators and written straight into the next layer's operand
//     panels (one ex2 and one rcp an activation; the logarithm is a
//     polynomial, because the special-function unit is what the epilogue
//     waits for). PE and its VJP are computed by the block for its own rows.
//   * What the reverse sweep needs from the forward one is spilled in bf16
//     by the thread that reads it back (the accumulator fragment of layer
//     l-1's output is the fragment of layer l's back-product), into a
//     per-block buffer that mostly stays in L2: sigma(100a), and for K2
//     q = 100 sigma (1 - sigma) t_a. sigma and q are computed in f32 from the
//     accumulator; a is never stored in bf16 (the factor 100 would turn its
//     rounding into a large error of the exponent).
//   * K2 interleaves primal and tangent rows by eights (row r of a tile is
//     point 8 (r / 16) + r % 8, tangent if (r / 8) % 2), so that one thread's
//     accumulator holds a, t_a (and abar, gamma) of the same point and
//     column and no epilogue needs another thread's values; both share each
//     weight slice. K1's gradient seed gamma = c e0 makes the head's
//     back-product a scaled copy of the head's first weight column: no GEMM.
//   * The weight cotangent: the sweep writes the operand panels ([in; t_in]
//     and [abar; gamma], bf16, as they lie in shared memory) to device
//     memory with bulk copies that cost no thread an instruction;
//     wgrad_kernel multiplies them for all layers at once as a
//     grouped split-K wgmma GEMM (both operands MN-major, 128 x 256 output
//     tiles) into f32 partials, summed in a fixed order by reduce_kernel.
//     The bias cotangent is summed by the sweep per block, in a fixed order,
//     and reduced the same way. No float atomics: the result is
//     bit-reproducible.
//   Those operand panels are 1.06 GB written per K2 call at the main-path
//   width and ~1.6 GB read (a 128 x 256 tile reads [abar; gamma] twice):
//   ~0.8 ms of HBM traffic. Each block streams the 1.15 MB of weights from L2
//   once per sweep and tile (~32 B a cycle and SM), and the epilogues run
//   while the tensor cores wait, since both warpgroups work in step. These,
//   not the tensor-core rate, are the practical floor of this design.
// Tier "highest" (every product at f32 accuracy, nothing stored in bf16)
// has two routes, chosen by the wrapper from the net's shape before the
// launch. On the nets the "default" sweeps take: ROUTE_TF32X3
// (pack32_kernel, sweep32_kernel, wgrad32_kernel, the design of "default"):
//   * Products: 3xTF32 on wgmma. Each operand is split into hi =
//     cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (2^-22 relative
//     together) and a product is lo hi + hi lo + hi hi: three tf32 passes
//     at 495 TFLOP/s, 165 TFLOP/s of f32-accurate work, 2.5x the CUDA
//     cores' f32 peak. bf16x6 (six passes at 989 TFLOP/s) buys the same
//     rate with three pieces an operand and twice the operand traffic;
//     3xTF32 needs two pieces and one wgmma shape. tf32 wgmma reads its
//     shared-memory operands K-major only, so the weights are packed per
//     call, as W^T slices for the forward sweep and W slices for the
//     reverse one, each k8 slice a [rows x (8 hi | 8 lo)] f32 block in the
//     64-byte swizzle; the activations (A) are read from shared memory by
//     the threads and split in registers (wgmma takes A from registers).
//   * Accuracy: the tensor cores' accumulation truncates (it rounds toward
//     zero), which over the 96 passes of a 256-deep product costs ~2e-5
//     relative, 20x f32's. So every chunk of two k8 steps goes to a fresh
//     accumulator, the small terms first, and is added to the product's
//     accumulator with f32 adds, which round to nearest (~1e-6, f32's).
//     That needs two accumulators: a warpgroup owns 64 rows by 128
//     columns, so a tile is 64 rows (K2: 32 points, primal and tangent rows
//     interleaved as in "default") and both warpgroups read its rows; the
//     activations stay f32 in shared memory (ten [64 x 32] panels, 80 KB)
//     beside an 8-slice ring (128 KB) that runs six slices ahead. sigma(100
//     a) and q are spilled in f32; activate_f32 takes the logarithm of
//     softplus100 from lg2.approx (2e-9 absolute), not from activate's
//     polynomial (6e-8).
//   * K2's weight cotangent: the sweep writes [in; t_in] and [abar; gamma]
//     as f32 panels (2.0 GB a call at 58,368 points); wgrad32_kernel takes
//     [128 x 128] output tiles, A = the X columns from registers (split
//     there), B = G transposed by the block into K-major hi and lo halves,
//     two of them, so that a chunk's transposition runs while the tensor
//     cores work on the chunk before; the same per-chunk f32 flush;
//     split-K partials summed in a fixed order by reduce_kernel:
//     bit-reproducible.
//   What bounds it: three tensor-core passes of the function's operations,
//   0.696 ms for K1 and 2.087 ms for K2 at 58,368 points. In practice each
//   chunk waits for its passes before the flush, and the epilogues, the
//   barriers and the loads run between the chunks (PERF.md §6).
// On any other net: ROUTE_GEMM, every product as one tiled f32 GEMM on the
// CUDA cores (gemm_kernel, 64x64 tiles) with the same fused epilogues,
// through a scratch buffer in device memory.
// Tier "high" (bf16x3, the TPU kernel's _dot3) takes the nets the sweeps
// take, on ROUTE_BF16X3 (pack32_kernel<true>, sweep32_kernel<BF16X3>,
// wgrad_kernel, reduce3_kernel): the skeleton of ROUTE_TF32X3 with bf16
// pieces.
//   * Which operands are split is what JAX's differentiation of _dot3 makes
//     of each product. An activation or a tangent times W: alpha v (JAX
//     scales the skip concat before its _dot3) is split in registers into
//     hi = bf16(v) and lo = bf16(v - hi), W into hi and lo slices by the
//     pack kernel; three passes, lo hi + hi lo + hi hi, into one
//     accumulator. A cotangent g times W^T: g is rounded to bf16 (the cast's
//     transpose), two passes P = bf16(g) W_hi^T and S = bf16(g) W_lo^T into
//     two accumulators, and the epilogue forms alpha (P + bf16((S + P) -
//     P)); K1's head back-product (gamma = c e0) is that formula on one
//     column, no GEMM. Everything between the products stays f32: the
//     activations in shared memory, sigma(100 a) and q in the spill.
//   * bf16 wgmma takes k16 a step, 32 bytes, as tf32 takes k8: a ring slice
//     is a k16 step of the weights, [rows x (16 hi | 16 lo)] bf16 in 64
//     bytes a row, the tf32 slices' geometry. A chunk is four k16 steps, the
//     ring runs four slices ahead, and the sums are not flushed: at this
//     tier the bf16 cotangents' own error (8e-4 to 2e-3) dwarfs the
//     truncating accumulation's (2.4e-5 RMS at most against the explicit
//     version on a net of one hidden layer, chip_smoke.check_high_rounding).
//   * K2's weight cotangent: the sweep's epilogues write split(alpha [in;
//     t_in]) as bf16 hi and lo panels and bf16([abar; gamma]) as one,
//     [64 x 64] in the 128-byte swizzle, from their registers (1.5 GB a call
//     at 58,368 points, 1.5x "default"'s); wgrad_kernel multiplies them as
//     for "default", its second warpgroup on the lo panel of the first's
//     columns: H and L partials over 24 split-K slices, combined in a fixed
//     order by reduce3_kernel into H + bf16((L + H) - H): bit-reproducible.
//   What bounds it: three bf16 passes of the forward products and two of
//   the reverse and weight ones at 989 TFLOP/s, 0.294 ms for K1 and 0.813
//   ms for K2 at 58,368 points. Where it waits: the passes are a third of
//   K1's time and a fifteenth of K2's sweep; each chunk waits for its
//   passes, and the barriers, the weight loads from L2, the epilogues and
//   the f32 spill run between the chunks; K2's sweep also stores its 1.5
//   GB of panels from the epilogues (PERF.md §6).
//
// Math (y = s x, e = PE(y), c = phi'(raw)/s):
//   K1 forward: a_l = alpha_l in_l W_l + b_l, h_{l+1} = softplus100(a_l);
//   gradient sweep gamma_{L-1} = c e0, gamma_{l-1} = (alpha_l gamma_l W_l^T)|h
//   * sigma(100 a_{l-1}); the e-parts sum to eps; grad = s J_PE^T eps.
//   K2 stacks primal and tangent rows of every operand:
//   tangent t_e = s J_PE gbar, t_a = alpha t_in W, t_h = sigma(100a) t_a;
//   reverse abar_{l-1} = sigma abar' + 100 sigma(1-sigma) t_a gamma', with
//   ' the h-part of alpha G W^T; W̄ = alpha [in; t_in]^T [abar; gamma],
//   b̄ = sum abar; x̄ = s J_PE^T ebar + s^2 gbar (PE'' . eps).
//
// Plain C interface (loaded with ctypes); every entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sweep.cuh"

#define BM 64
#define BN 64
#define BK 32
#define NT 256
#define MAX_LAYERS 32

enum { EPI_STORE = 0, EPI_FWD = 1, EPI_BWD_T = 2, EPI_BWD_P = 3 };
enum { HEAD_ABS = 0, HEAD_SQUARE = 1, HEAD_SDF = 2 };
// how a call runs: the f32 CUDA-core GEMMs (tier "highest" on the nets the
// sweeps refuse), the bf16 sweeps ("default"), the bf16x3 sweeps ("high"),
// the 3xTF32 sweeps ("highest" on the sweeps' nets)
enum { ROUTE_GEMM = 0, ROUTE_SWEEP = 1, ROUTE_BF16X3 = 2, ROUTE_TF32X3 = 3 };

// ---------------------------------------------------------------------------
// tier "highest": f32 GEMMs on the CUDA cores
// ---------------------------------------------------------------------------

struct Epi {
  int mode;
  float* c;             // STORE: partial W̄; FWD: pre-activation (or tangent) out
  long ldc;
  const float* bias;    // FWD primal rows only
  float* h;             // FWD: next layer's input (its h-part); null at the head
  long ldh;
  const float* aprim;   // FWD tangent: this layer's primal a; BWD: a_{l-1} primal
  const float* atan;    // BWD_T in K2: t_a_{l-1}
  long lda;
  float* gt;            // BWD: G_{l-1} tangent rows (gamma)
  float* gp;            // BWD: G_{l-1} primal rows (abar)
  long ldg;
  float* ebar;          // BWD: cotangent of the embedding, columns >= kh
  long lde;
  int kh;               // width of the h-part of this layer's input
};

struct GemmArgs {
  const float* A;  // A(m, k) = A[m*sam + k*sak]
  long sam, sak;
  const float* B;  // B(k, n) = B[k*sbk + n*sbn]
  long sbk, sbn;
  int M, N, K;
  int k_chunk;     // K range of one blockIdx.z (split-K); K for no split
  float alpha;
  long c_split;    // STORE: offset of one split's partial
  Epi epi;
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus100(float a) {
  const float z = 100.f * a;
  return (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * 0.01f;
}

__device__ __forceinline__ void epilogue(const Epi& e, int m, int n, float v) {
  switch (e.mode) {
    case EPI_STORE:
      e.c[(long)m * e.ldc + n] = v;
      break;
    case EPI_FWD:
      if (e.bias) v += e.bias[n];
      e.c[(long)m * e.ldc + n] = v;
      if (e.h) {
        e.h[(long)m * e.ldh + n] =
            e.aprim ? sigm(100.f * e.aprim[(long)m * e.lda + n]) * v : softplus100(v);
      }
      break;
    case EPI_BWD_T:
      if (n < e.kh) {
        const float s = sigm(100.f * e.aprim[(long)m * e.lda + n]);
        e.gt[(long)m * e.ldg + n] = s * v;
        if (e.gp)
          e.gp[(long)m * e.ldg + n] = 100.f * s * (1.f - s) * e.atan[(long)m * e.lda + n] * v;
      } else {
        e.ebar[(long)m * e.lde + n - e.kh] += v;
      }
      break;
    case EPI_BWD_P:
      if (n < e.kh) {
        e.gp[(long)m * e.ldg + n] += sigm(100.f * e.aprim[(long)m * e.lda + n]) * v;
      } else {
        e.ebar[(long)m * e.lde + n - e.kh] += v;
      }
      break;
  }
}

// C = alpha * A @ B over [k_begin, k_end) of this blockIdx.z, then the
// epilogue. M, N multiples of 64, K and k_chunk multiples of 32.
__global__ void __launch_bounds__(NT) gemm_kernel(GemmArgs g) {
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * g.k_chunk;
  const int ke = min(g.K, kb + g.k_chunk);
  const int t = threadIdx.x;
  const bool a_kfast = g.sak == 1, b_nfast = g.sbn == 1;
  __shared__ __align__(128) float Cs[BM][BN + 4];
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int ty = t / 16, tx = t % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = t; i < BM * BK; i += NT) {
      const int mm = a_kfast ? i / BK : i % BM, kk = a_kfast ? i % BK : i / BM;
      As[kk][mm] = g.A[(long)(m0 + mm) * g.sam + (long)(k0 + kk) * g.sak];
    }
    for (int i = t; i < BK * BN; i += NT) {
      const int kk = b_nfast ? i / BN : i % BK, nn = b_nfast ? i % BN : i / BK;
      Bs[kk][nn] = g.B[(long)(k0 + kk) * g.sbk + (long)(n0 + nn) * g.sbn];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[ty * 4 + i][tx * 4 + j] = acc[i][j];
  __syncthreads();

  Epi e = g.epi;
  if (e.mode == EPI_STORE) e.c += (long)blockIdx.z * g.c_split;
  for (int i = t; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    epilogue(e, m0 + r, n0 + c, g.alpha * Cs[r][c]);
  }
}

// Positional encoding of y = s x into dst[r, 0:pe_w) (zero padded); with
// gbar, also the tangent t_e = s J_PE(y) gbar into tdst.
__global__ void pe_kernel(const float* x, int rows, int multires, float scale, int pe_w,
                          float* dst, long ld, const float* gbar, float* tdst) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float y[3], gb[3];
  for (int i = 0; i < 3; ++i) {
    y[i] = scale * x[r * 3 + i];
    gb[i] = gbar ? gbar[r * 3 + i] : 0.f;
  }
  float* d = dst + (long)r * ld;
  float* td = tdst ? tdst + (long)r * ld : nullptr;
  for (int i = 0; i < 3; ++i) {
    d[i] = y[i];
    if (td) td[i] = scale * gb[i];
  }
  int j = 3;
  for (int k = 0; k < multires; ++k, j += 6) {
    const float f = (float)(1 << k);
    for (int i = 0; i < 3; ++i) {
      const float sn = sinf(y[i] * f), cs = cosf(y[i] * f);
      d[j + i] = sn;
      d[j + 3 + i] = cs;
      if (td) {
        td[j + i] = scale * f * cs * gb[i];
        td[j + 3 + i] = -scale * f * sn * gb[i];
      }
    }
  }
  for (; j < pe_w; ++j) {
    d[j] = 0.f;
    if (td) td[j] = 0.f;
  }
}

__device__ __forceinline__ float head_phi(float raw, int head) {
  return head == HEAD_ABS ? fabsf(raw) : (head == HEAD_SQUARE ? raw * raw : raw);
}

__device__ __forceinline__ float head_dphi(float raw, int head) {
  // sign(0) = 0 for abs, as JAX's abs derivative
  if (head == HEAD_ABS) return (float)(raw > 0.f) - (float)(raw < 0.f);
  return head == HEAD_SQUARE ? 2.f * raw : 1.f;
}

// K1 head: udf, feature and the gradient-sweep seed gamma = c e0.
__global__ void head_fwd_kernel(const float* A, int rows, int np, int d_out, int head,
                                float scale, float* udf, float* feat, float* G) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * np) return;
  const int r = i / np, c = i % np;
  const float raw = A[(long)r * np];
  if (c == 0) udf[r] = head_phi(raw, head) / scale;
  else if (c < d_out) feat[(long)r * (d_out - 1) + c - 1] = A[i];
  G[i] = c == 0 ? head_dphi(raw, head) / scale : 0.f;
}

// K2 head: abar = [ubar c + (phi''/s) T, fbar] on primal rows, gamma = c e0
// on tangent rows (T = the head's tangent, column 0 of t_a).
__global__ void head_bwd_kernel(const float* A, int rows, int np, int d_out, int head,
                                float scale, const float* ubar, const float* fbar, float* G) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * np) return;
  const int r = i / np, c = i % np;
  const float raw = A[(long)r * np], tan0 = A[(long)(rows + r) * np];
  const float cc = head_dphi(raw, head) / scale;
  float gp = 0.f, gt = 0.f;
  if (c == 0) {
    gp = ubar[r] * cc + (head == HEAD_SQUARE ? 2.f / scale : 0.f) * tan0;
    gt = cc;
  } else if (c < d_out) {
    gp = fbar[(long)r * (d_out - 1) + c - 1];
  }
  G[i] = gp;
  G[(long)rows * np + i] = gt;
}

// grad = s J_PE(y)^T eps (K1), or x̄ = s J_PE^T ebar + s^2 gbar (PE'' . eps)
// (K2, when ebar is given).
__global__ void pe_vjp_kernel(const float* x, int rows, int multires, float scale,
                              const float* eps, const float* ebar, const float* gbar,
                              long lde, float* out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* ep = eps + (long)r * lde;
  const float* eb = ebar ? ebar + (long)r * lde : nullptr;
  for (int i = 0; i < 3; ++i) {
    const float y = scale * x[r * 3 + i];
    float first = eb ? eb[i] : ep[i], second = 0.f;
    for (int k = 0, j = 3; k < multires; ++k, j += 6) {
      const float f = (float)(1 << k);
      const float sn = sinf(y * f), cs = cosf(y * f);
      if (eb) {
        first += f * cs * eb[j + i] - f * sn * eb[j + 3 + i];
        second += -f * f * sn * ep[j + i] - f * f * cs * ep[j + 3 + i];
      } else {
        first += f * cs * ep[j + i] - f * sn * ep[j + 3 + i];
      }
    }
    out[r * 3 + i] = scale * first + (eb ? scale * scale * gbar[r * 3 + i] * second : 0.f);
  }
}

// part[z, n] = sum of G[r, n] over the rows of split z (primal rows only).
__global__ void colsum_kernel(const float* G, int rows, int np, int chunk, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= np) return;
  const int r0 = blockIdx.y * chunk, r1 = min(rows, r0 + chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += G[(long)r * np + n];
  part[(long)blockIdx.y * np + n] = s;
}

// out[i] = sum_z part[z*count + i], in z order.
__global__ void reduce_kernel(const float* part, int splits, long count, float* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long)z * count + i];
  out[i] = s;
}

// out[i] = H + bf16((L + H) - H), H and L the sums over z (in z order) of
// the hh and lh partials: the weight cotangent through _dot3's cast of W.
__global__ void reduce3_kernel(const float* part, long lo_off, int splits, long count,
                               float* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float h = 0.f, l = 0.f;
  for (int z = 0; z < splits; ++z) {
    h += part[(long)z * count + i];
    l += part[lo_off + (long)z * count + i];
  }
  out[i] = h + __bfloat162float(__float2bfloat16((l + h) - h));
}

// ---------------------------------------------------------------------------
// tier "default": bf16 wgmma sweeps with the activations in shared memory
// ---------------------------------------------------------------------------

#define N_PANELS 5       // four h panels and the embedding's
#define WIDTH 256        // hidden width of the sweeps
#define PE_W 64
#define F_MAX_LAYERS 16
#define MAX_SLICES 96
#define MAX_ITEMS 64
#define E_LD 65          // row stride of the f32 eps staging
#define SWEEP_MISC \
  (4 * (128 + 128 + 8 * WIDTH) + sizeof(Slice) * MAX_SLICES + sizeof(FLayer) * F_MAX_LAYERS)
#define SWEEP_SMEM (1024 + N_PANELS * PANEL + N_STAGES * STAGE + SWEEP_MISC)
#define WG_STAGE 49152   // wgrad: two X half-panels and four G half-panels
#define WGRAD_SMEM (1024 + N_STAGES * WG_STAGE)

struct FLayer {
  int np, skip, b_off, w_off, xslot, gslot;
  float alpha;
};

struct SweepArgs {
  const float* x;
  const float* b;
  const __nv_bfloat16* w16;  // W of every layer, then W^T of every layer
  long wt_off;               // where the transposed copies start
  int n_layers, multires, head, d_out, n_tiles, n_slices, nx_slots, ng_slots, b_total;
  float scale;
  float *udf, *feat, *grad;            // K1 outputs
  const float *ubar, *fbar, *gbar;     // K2 cotangents
  float *xbar, *bpart;                 // K2: x̄, per-block partial b̄
  uint8_t *xbuf, *gbuf;                // K2: operand panels of the weight cotangent
  uint4* spill;                        // per block: sigma (and q) of every hidden layer
  FLayer l[F_MAX_LAYERS];
  Slice s[MAX_SLICES];
};

struct WItem {  // one output tile of the grouped weight-cotangent GEMM
  int xs0, xs1;  // X panel slots of the two warpgroups (xs1 < 0: none; bf16x3: hi, lo)
  int gs0, n;    // first G panel slot, tile width (256 or 64)
  int w_off, np, m0, n0;
  float alpha;
};

struct WgradArgs {
  const uint8_t *xbuf, *gbuf;
  float* part;
  long w_total;
  int nx_slots, ng_slots, n_tiles;
  long lo_off;  // B3: the lo partials, lo_off floats after the hi ones
  WItem item[MAX_ITEMS];
};

struct PackArgs {
  int n;
  int kp[F_MAX_LAYERS], np[F_MAX_LAYERS];
  long w_off[F_MAX_LAYERS + 1];
};

// h = softplus100(a) and sg = sigma(100 a) from one exponential, t =
// exp(-|100 a|): sg = 1 / (1 + t) or t / (1 + t), h = max(a, 0) +
// log(1 + t) / 100. Two special-function instructions an activation (ex2,
// rcp); the logarithm is t P(t) with P of degree 5 fitted on [0, 1], 6e-8
// of absolute error in h.
__device__ __forceinline__ void activate(float a, float& h, float& sg) {
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fabsf(a) * -144.26950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + t));
  sg = a >= 0.f ? r : t * r;
  float p = -2.39795729e-04f;  // log2(1 + t) / t, times ln 2 / 100
  p = fmaf(p, t, 1.01500051e-03f);
  p = fmaf(p, t, -2.10293685e-03f);
  p = fmaf(p, t, 3.25295143e-03f);
  p = fmaf(p, t, -4.99372603e-03f);
  p = fmaf(p, t, 9.99991782e-03f);
  h = fmaf(t, p, fmaxf(a, 0.f));
}

// W and W^T of every layer in bf16: out[i] = w[i], out[total + ...] = W_l^T.
__global__ void pack_bf16_kernel(const float* w, __nv_bfloat16* out, PackArgs p) {
  const long total = p.w_off[p.n];
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const __nv_bfloat16 v = __float2bfloat16(w[i]);
  out[i] = v;
  int l = 0;
  while (i >= p.w_off[l + 1]) ++l;
  const long r = i - p.w_off[l];
  const int k = (int)(r / p.np[l]), n = (int)(r % p.np[l]);
  out[total + p.w_off[l] + (long)n * p.kp[l] + k] = v;
}

// K1 (BWD = false): a tile is 128 points. K2 (BWD = true): a tile is 64
// points, primal and tangent rows interleaved by eights.
template <bool BWD>
__global__ void __launch_bounds__(FT, 1) sweep_kernel(const __grid_constant__ SweepArgs P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t sA = (raw_addr + 1023u) & ~1023u;
  uint8_t* gA = smem_raw + (sA - raw_addr);  // the operand panels
  const uint32_t ring = sA + N_PANELS * PANEL;
  float* crow = reinterpret_cast<float*>(gA + N_PANELS * PANEL + N_STAGES * STAGE);
  float* arow = crow + 128;
  float* bwarp = arow + 128;  // [8 warps][WIDTH]
  Slice* tab = reinterpret_cast<Slice*>(bwarp + 8 * WIDTH);
  FLayer* lay = reinterpret_cast<FLayer*>(tab + MAX_SLICES);

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const int r0 = g * 64 + wq * 16 + (lane >> 2);  // row of d[4i], d[4i+1]; d[4i+2..3]: r0 + 8
  const int cq = 2 * (lane & 3);
  const uint32_t a_wg = sA + g * 64 * 128;
  const int L = P.n_layers, mr = P.multires, ns = P.n_slices;
  const float scale = P.scale;
  const int pts = BWD ? 64 : 128;
  float* bpart = BWD ? P.bpart + (long)blockIdx.x * P.b_total : nullptr;
  uint8_t* e_panel = gA + 4 * PANEL;

  for (int i = tid; i < ns; i += FT) tab[i] = P.s[i];
  for (int i = tid; i < L; i += FT) lay[i] = P.l[i];
  if (BWD)
    for (int i = tid; i < P.b_total; i += FT) bpart[i] = 0.f;
  __syncthreads();

  float acc[128], eacc[32];
  uint32_t it = 0;
  for (int q = 0; q < PREFETCH; ++q) {
    load_slice(tab, ns, P.w16, q, ring, tid);
    cp_async_commit();
  }

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long p0 = (long)tile * pts;

    // the embedding (and its tangent) into the e panel
    for (int item = tid; item < pts * (mr + 1); item += FT) {
      const int pl = item / (mr + 1), k = item % (mr + 1);
      const int row = BWD ? ((pl >> 3) * 16 + (pl & 7)) : pl;
      float y[3], gb[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        y[i] = scale * P.x[(p0 + pl) * 3 + i];
        gb[i] = BWD ? P.gbar[(p0 + pl) * 3 + i] : 0.f;
      }
      if (k < mr) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float sn, cs;
          sincosf(y[i] * f, &sn, &cs);
          put(e_panel, row, 3 + 6 * k + i, sn);
          put(e_panel, row, 6 + 6 * k + i, cs);
          if (BWD) {
            put(e_panel, row + 8, 3 + 6 * k + i, scale * f * cs * gb[i]);
            put(e_panel, row + 8, 6 + 6 * k + i, -scale * f * sn * gb[i]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          put(e_panel, row, i, y[i]);
          if (BWD) put(e_panel, row + 8, i, scale * gb[i]);
        }
        for (int c = 3 + 6 * mr; c < PE_W; ++c) {
          put(e_panel, row, c, 0.f);
          if (BWD) put(e_panel, row + 8, c, 0.f);
        }
      }
    }
    fence_async();
    __syncthreads();
    if (BWD) dump_panels(sA + 4 * PANEL, 1, P.xbuf + ((size_t)tile * P.nx_slots) * PANEL, tid);

    // forward sweep over the hidden layers
    for (int l = 0; l < L - 1; ++l) {
      const FLayer Ly = lay[l];
      sweep_gemm<256>(acc, a_wg, l == 0 ? 4 : 0, l == 0 ? 1 : 4 + (Ly.skip ? 1 : 0), ring, tab, ns,
                      P.w16, it, tid);
      const float* __restrict__ bias = P.b + Ly.b_off;
      const float alpha = Ly.alpha;
      uint4* sp = P.spill + ((size_t)(blockIdx.x * (L - 1) + l) * 16) * FT + tid;
#pragma unroll
      for (int i8 = 0; i8 < 16; ++i8) {
        uint32_t wd[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i4 = 2 * i8 + hh, col = i4 * 8 + cq;
          const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
          float h0, h1, s0, s1;
          activate(alpha * acc[4 * i4] + b0, h0, s0);
          activate(alpha * acc[4 * i4 + 1] + b1, h1, s1);
          put2(gA, r0, col, h0, h1);
          wd[2 * hh] = pack2(s0, s1);
          if (!BWD) {
            float h2, h3, s2, s3;
            activate(alpha * acc[4 * i4 + 2] + b0, h2, s2);
            activate(alpha * acc[4 * i4 + 3] + b1, h3, s3);
            put2(gA, r0 + 8, col, h2, h3);
            wd[2 * hh + 1] = pack2(s2, s3);
          } else {
            const float t0 = alpha * acc[4 * i4 + 2], t1 = alpha * acc[4 * i4 + 3];
            put2(gA, r0 + 8, col, s0 * t0, s1 * t1);
            wd[2 * hh + 1] = pack2(100.f * s0 * (1.f - s0) * t0, 100.f * s1 * (1.f - s1) * t1);
          }
        }
        sp[(size_t)i8 * FT] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
      fence_async();
      __syncthreads();
      if (BWD)
        dump_panels(sA, 4, P.xbuf + ((size_t)tile * P.nx_slots + lay[l + 1].xslot) * PANEL, tid);
    }

    // the head
    const FLayer H = lay[L - 1];
    const float* hbias = P.b + H.b_off;
    if (!BWD) {
      // columns 256.. (features only), then columns 0..255
      sweep_gemm<64>(acc, a_wg, 0, 4, ring, tab, ns, P.w16, it, tid);
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = WIDTH + i4 * 8 + cq + (j & 1), row = r0 + (j >> 1) * 8;
          if (col < P.d_out)
            P.feat[(p0 + row) * (P.d_out - 1) + col - 1] = H.alpha * acc[4 * i4 + j] + hbias[col];
        }
      }
      sweep_gemm<256>(acc, a_wg, 0, 4, ring, tab, ns, P.w16, it, tid);
#pragma unroll
      for (int i4 = 0; i4 < 32; ++i4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = i4 * 8 + cq + (j & 1), row = r0 + (j >> 1) * 8;
          const float v = H.alpha * acc[4 * i4 + j] + hbias[col];
          if (col == 0) {
            P.udf[p0 + row] = head_phi(v, P.head) / scale;
            crow[row] = head_dphi(v, P.head) / scale;
          } else if (col < P.d_out) {
            P.feat[(p0 + row) * (P.d_out - 1) + col - 1] = v;
          }
        }
      }
      __syncthreads();
      // gamma_{L-2} = sigma_{L-2} (alpha c W_head[:, 0]): the seed c e0 needs no GEMM
      const __nv_bfloat16* wh = P.w16 + P.wt_off + H.w_off;  // row 0 of W_head^T
      const uint4* sp = P.spill + ((size_t)(blockIdx.x * (L - 1) + L - 2) * 16) * FT + tid;
      const float ca = bf16_round(crow[r0]), cb = bf16_round(crow[r0 + 8]);
#pragma unroll
      for (int i8 = 0; i8 < 16; ++i8) {
        const uint4 v = sp[(size_t)i8 * FT];
        const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = (2 * i8 + hh) * 8 + cq;
          const float w0 = __bfloat162float(wh[col]), w1 = __bfloat162float(wh[col + 1]);
          const float2 sa = unpack2(wd[2 * hh]), sb = unpack2(wd[2 * hh + 1]);
          put2(gA, r0, col, sa.x * (H.alpha * (ca * w0)), sa.y * (H.alpha * (ca * w1)));
          put2(gA, r0 + 8, col, sb.x * (H.alpha * (cb * w0)), sb.y * (H.alpha * (cb * w1)));
        }
      }
    } else {
      // only column 0 of the head's forward is read: raw and its tangent
      sweep_gemm<64>(acc, a_wg, 0, 4, ring, tab, ns, P.w16, it, tid);
      if (cq == 0) {
        const int pl = (r0 >> 4) * 8 + (r0 & 7);
        const float raw = H.alpha * acc[0] + hbias[0], tan0 = H.alpha * acc[2];
        const float cc = head_dphi(raw, P.head) / scale;
        crow[pl] = cc;
        arow[pl] = P.ubar[p0 + pl] * cc + (P.head == HEAD_SQUARE ? 2.f / scale : 0.f) * tan0;
      }
      __syncthreads();
      // G_{L-1}: abar = [ubar c + (phi''/s) T, fbar] on primal rows, gamma = c e0 on tangent rows
      const int nch = H.np / 8;
      for (int item = tid; item < 128 * nch; item += FT) {
        const int row = item / nch, ch = item % nch;
        const int pl = (row >> 4) * 8 + (row & 7);
        const bool tangent = (row >> 3) & 1;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = ch * 8 + e;
          if (tangent) v[e] = col == 0 ? crow[pl] : 0.f;
          else if (col == 0) v[e] = arow[pl];
          else v[e] = col < P.d_out ? P.fbar[(p0 + pl) * (P.d_out - 1) + col - 1] : 0.f;
        }
        *reinterpret_cast<uint4*>(gA + (ch >> 3) * PANEL + row * 128 + (((ch & 7) ^ (row & 7)) << 4)) =
            make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
      for (int col = tid; col < H.np; col += FT) {
        float s = 0.f;
        for (int pl = 0; pl < 64; ++pl) {
          if (col == 0) s += arow[pl];
          else if (col < P.d_out) s += P.fbar[(p0 + pl) * (P.d_out - 1) + col - 1];
        }
        bpart[H.b_off + col] += s;
      }
    }
    fence_async();
    __syncthreads();

    // reverse sweep
#pragma unroll
    for (int i = 0; i < 32; ++i) eacc[i] = 0.f;
    for (int l = BWD ? L - 1 : L - 2; l >= 0; --l) {
      const FLayer Ly = lay[l];
      const int nk = Ly.np / 64;  // panels of G_l
      if (BWD) dump_panels(sA, nk, P.gbuf + ((size_t)tile * P.ng_slots + Ly.gslot) * PANEL, tid);
      if (l == 0 || Ly.skip) {  // the e-part of alpha G W^T: eps (and ebar)
        sweep_gemm<64>(acc, a_wg, 0, nk, ring, tab, ns, P.w16, it, tid);
#pragma unroll
        for (int i = 0; i < 32; ++i) eacc[i] += Ly.alpha * acc[i];
      }
      if (l == 0) break;
      sweep_gemm<256>(acc, a_wg, 0, nk, ring, tab, ns, P.w16, it, tid);
      const float alpha = Ly.alpha;
      const uint4* sp = P.spill + ((size_t)(blockIdx.x * (L - 1) + l - 1) * 16) * FT + tid;
#pragma unroll
      for (int i8 = 0; i8 < 16; ++i8) {
        const uint4 v = sp[(size_t)i8 * FT];
        const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i4 = 2 * i8 + hh, col = i4 * 8 + cq;
          const float2 sa = unpack2(wd[2 * hh]), sb = unpack2(wd[2 * hh + 1]);
          const float d0 = alpha * acc[4 * i4], d1 = alpha * acc[4 * i4 + 1];
          const float d2 = alpha * acc[4 * i4 + 2], d3 = alpha * acc[4 * i4 + 3];
          if (!BWD) {  // sa, sb: sigma of rows r0, r0 + 8
            put2(gA, r0, col, sa.x * d0, sa.y * d1);
            put2(gA, r0 + 8, col, sb.x * d2, sb.y * d3);
          } else {  // sa: sigma, sb: q; d0, d1: abar', d2, d3: gamma'
            float ab0 = sa.x * d0 + sb.x * d2, ab1 = sa.y * d1 + sb.y * d3;
            put2(gA, r0, col, ab0, ab1);
            put2(gA, r0 + 8, col, sa.x * d2, sa.y * d3);
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              ab0 += __shfl_xor_sync(0xffffffffu, ab0, m);
              ab1 += __shfl_xor_sync(0xffffffffu, ab1, m);
            }
            if (lane < 4) {
              bwarp[(tid >> 5) * WIDTH + col] = ab0;
              bwarp[(tid >> 5) * WIDTH + col + 1] = ab1;
            }
          }
        }
      }
      fence_async();
      __syncthreads();
      if (BWD) {  // b̄_{l-1} of this tile, warps summed in order
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += bwarp[w * WIDTH + tid];
        bpart[lay[l - 1].b_off + tid] += s;
      }
    }

    // grad = s J_PE^T eps, or x̄ = s J_PE^T ebar + s^2 gbar (PE'' . eps)
    bulk_reads_done(tid);
    __syncthreads();
    float* E = reinterpret_cast<float*>(gA);
#pragma unroll
    for (int i4 = 0; i4 < 8; ++i4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        E[(r0 + (j >> 1) * 8) * E_LD + i4 * 8 + cq + (j & 1)] = eacc[4 * i4 + j];
    }
    __syncthreads();
    for (int item = tid; item < pts * 3; item += FT) {
      const int pl = item / 3, i = item % 3;
      const int row = BWD ? ((pl >> 3) * 16 + (pl & 7)) : pl;
      const float* eb = E + row * E_LD;                   // K1: eps; K2: ebar
      const float* ep = E + (row + (BWD ? 8 : 0)) * E_LD;  // eps
      const float y = scale * P.x[(p0 + pl) * 3 + i];
      float first = eb[i], second = 0.f;
      for (int k = 0, j = 3; k < mr; ++k, j += 6) {
        const float f = (float)(1 << k);
        float sn, cs;
        sincosf(y * f, &sn, &cs);
        first += f * cs * eb[j + i] - f * sn * eb[j + 3 + i];
        second += -f * f * sn * ep[j + i] - f * f * cs * ep[j + 3 + i];
      }
      if (BWD)
        P.xbar[(p0 + pl) * 3 + i] =
            scale * first + scale * scale * P.gbar[(p0 + pl) * 3 + i] * second;
      else
        P.grad[(p0 + pl) * 3 + i] = scale * first;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One [128 x n] tile of W̄_l = alpha [in; t_in]^T [abar; gamma] over the row
// tiles of split blockIdx.y, from the operand panels the sweep wrote; both
// operands MN-major. Partial sums go to part[blockIdx.y]. B3 (route bf16x3,
// 64-row panels): a [64 x n] tile, the hh partial from warpgroup 0 and the
// lh one from warpgroup 1, which multiplies the lo panel of the same columns.
template <bool B3>
__global__ void __launch_bounds__(FT, 1) wgrad_kernel(const __grid_constant__ WgradArgs P) {
  constexpr int UNITS = B3 ? 1 : 2;  // 64-row halves of a panel
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const WItem I = P.item[blockIdx.x];
  const int t0 = (int)((long)P.n_tiles * blockIdx.y / gridDim.y);
  const int t1 = (int)((long)P.n_tiles * (blockIdx.y + 1) / gridDim.y);
  const int n_steps = (t1 - t0) * UNITS;  // 64 rows of the tiles a step
  const int nm = I.xs1 >= 0 ? 2 : 1, n_pan = I.n / 64;
  const bool active = g < nm;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  auto load_step = [&](int step) {
    if (step < n_steps) {
      const size_t tile = t0 + step / UNITS;
      const uint32_t half = (step % UNITS) * (PANEL / 2);
      const size_t pb = (size_t)UNITS * (PANEL / 2);  // bytes of a panel
      const uint32_t base = sbase + (step % N_STAGES) * WG_STAGE;
      for (int c = tid; c < (nm + n_pan) * 512; c += FT) {
        const int pn = c >> 9;
        const uint32_t o = (c & 511) * 16;
        const uint8_t* src =
            pn < nm ? P.xbuf + (tile * P.nx_slots + (pn ? I.xs1 : I.xs0)) * pb + half + o
                    : P.gbuf + (tile * P.ng_slots + I.gs0 + (pn - nm)) * pb + half + o;
        cp_async16(base + (pn < nm ? pn : 2 + pn - nm) * (PANEL / 2) + o, src);
      }
    }
    cp_async_commit();
  };

  for (int q = 0; q < PREFETCH; ++q) load_step(q);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<PREFETCH - 1>();
    fence_async();
    __syncthreads();
    load_step(step + PREFETCH);
    if (active) {
      const uint32_t base = sbase + (step % N_STAGES) * WG_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = make_desc(base + g * (PANEL / 2) + kk * 2048, PANEL / 2, 1024);
        const uint64_t db = make_desc(base + PANEL + kk * 2048, PANEL / 2, 1024);
        if (I.n == 256) wgmma_n256<1, 1>(acc, da, db, 1);
        else wgmma_n64<1, 1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  acc_fence<128>(acc);
  cp_async_wait<0>();
  if (!active) return;
  float* out = P.part + (B3 ? g * P.lo_off : 0) + (size_t)blockIdx.y * P.w_total + I.w_off +
               (size_t)(I.m0 + (B3 ? 0 : g * 64) + wq * 16 + (lane >> 2)) * I.np + I.n0 +
               2 * (lane & 3);
#pragma unroll
  for (int i4 = 0; i4 < 32; ++i4) {
    if (i4 * 8 < I.n) {
      *reinterpret_cast<float2*>(out + i4 * 8) =
          make_float2(I.alpha * acc[4 * i4], I.alpha * acc[4 * i4 + 1]);
      *reinterpret_cast<float2*>(out + (size_t)8 * I.np + i4 * 8) =
          make_float2(I.alpha * acc[4 * i4 + 2], I.alpha * acc[4 * i4 + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: the value-only pass of the up-sampling (bf16 operands, f32 sums)
// ---------------------------------------------------------------------------
//
// udf(x) alone, no gradient, nothing kept: K1's forward sweep over the
// hidden layers, whose last epilogue also takes the head's column 0 as a dot
// product of its activations (rounded to bf16, the operand K1's head GEMM
// reads) with the head's first weight column. The other head columns are
// the feature, which no caller of the pass reads. A tile is 128 rows (each
// warpgroup 64 rows by 256 columns) where the row count fills the SMs, else
// 64 rows (both warpgroups read the same 64 rows, each computes 128 of the
// 256 columns), so that a pass of a few thousand rows runs on twice as many
// SMs. Both tiles sum the head's column in one order (each half of the 256
// columns, then the halves), so a row's udf does not depend on the row
// count. Rows past the count compute on x = 0 and are not written.
// value_pack_kernel resolves the weight norm from (v, g, b) and writes the
// bf16 W^T slices of the hidden layers, the head's column and the f32
// biases, once a render, for all of its passes.

#define V_MAX_K 320  // widest padded input of a hidden layer: 256 + 64
#define VALUE_SMEM (1024 + N_PANELS * PANEL + N_STAGES * STAGE + sizeof(Slice) * MAX_SLICES + 4 * 128)

struct VPackArgs {
  const float* v[F_MAX_LAYERS];  // W (v of a weight-normed layer), [d_in x d_out] at the true widths
  const float* g[F_MAX_LAYERS];  // null: no weight norm
  const float* b[F_MAX_LAYERS];
  int kp[F_MAX_LAYERS], n_true[F_MAX_LAYERS], skip[F_MAX_LAYERS];
  long t_off[F_MAX_LAYERS];  // W_l^T [WIDTH x kp] in w16; the head's column at t_off[n_layers - 1]
  int n_layers, d0;
  __nv_bfloat16* w16;
  float* bias;  // [(n_layers - 1) x WIDTH], then the head's b[0]
};

struct VLayer {
  int skip;
  float alpha;
};

struct ValueArgs {
  const float* x;
  const __nv_bfloat16 *w16, *wh;  // the hidden layers' W^T slices; the head's column 0
  const float* bias;
  float* out;
  int n, n_tiles, n_layers, multires, head, n_slices;
  float scale;
  VLayer l[F_MAX_LAYERS];
  Slice s[MAX_SLICES];
};

// Block 8 l + c (c < 8): columns 32 c .. 32 c + 31 of hidden layer l; the
// last block: the head's column 0. W = v (g / ||v||) per output column (the
// norm over the true input rows), as nets/mlp.py's weight().
__global__ void __launch_bounds__(256) value_pack_kernel(const __grid_constant__ VPackArgs P) {
  __shared__ float tile[V_MAX_K][33];
  __shared__ float part[8][32];
  __shared__ float scl[32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const bool head = blockIdx.x == (unsigned)(P.n_layers - 1) * 8;
  const int l = head ? P.n_layers - 1 : blockIdx.x / 8, n0 = head ? 0 : (blockIdx.x % 8) * 32;
  const int nt = P.n_true[l], h_true = l == 0 ? 0 : P.n_true[l - 1];
  const int kh = l == 0 ? 0 : WIDTH;
  const int d_in = h_true + (l == 0 || P.skip[l] ? P.d0 : 0);
  const int n = n0 + lane;
  const bool live = n < nt && (!head || lane == 0);
  float s = 0.f;
  for (int k = w; k < d_in; k += 8) {
    const float v = live ? P.v[l][(long)k * nt + n] : 0.f;
    tile[k][lane] = v;
    s = fmaf(v, v, s);
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0) {
    float t = 0.f;
    for (int i = 0; i < 8; ++i) t += part[i][lane];
    scl[lane] = !live ? 0.f : (P.g[l] ? P.g[l][n] / sqrtf(t) : 1.f);
  }
  __syncthreads();
  // the true input row of padded row kpad: the h-part, then the embedding's
  auto row_of = [&](int kpad) {
    if (kpad < kh) return kpad < h_true ? kpad : -1;
    const int j = kpad - kh;
    return j < P.d0 ? h_true + j : -1;
  };
  if (head) {
    for (int kpad = tid; kpad < WIDTH; kpad += 256) {
      const int k = row_of(kpad);
      P.w16[P.t_off[l] + kpad] = __float2bfloat16(k >= 0 ? tile[k][0] * scl[0] : 0.f);
    }
    if (tid == 0) P.bias[l * WIDTH] = P.b[l][0];
    return;
  }
  const int kp = P.kp[l];
  for (int r = w; r < 32; r += 8) {
    __nv_bfloat16* dst = P.w16 + P.t_off[l] + (long)(n0 + r) * kp;
    for (int kpad = lane; kpad < kp; kpad += 32) {
      const int k = row_of(kpad);
      dst[kpad] = __float2bfloat16(k >= 0 ? tile[k][r] * scl[r] : 0.f);
    }
  }
  if (tid < 32) P.bias[l * WIDTH + n0 + tid] = n0 + tid < nt ? P.b[l][n0 + tid] : 0.f;
}

template <int ROWS>
__global__ void __launch_bounds__(FT, 1) value_kernel(const __grid_constant__ ValueArgs P) {
  constexpr int NW = ROWS == 128 ? WIDTH : WIDTH / 2;  // accumulator columns of a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t sA = (raw_addr + 1023u) & ~1023u;
  uint8_t* gA = smem_raw + (sA - raw_addr);  // the operand panels
  const uint32_t ring = sA + N_PANELS * PANEL;
  Slice* tab = reinterpret_cast<Slice*>(gA + N_PANELS * PANEL + N_STAGES * STAGE);
  float* hpart = reinterpret_cast<float*>(tab + MAX_SLICES);  // [2][64]: the head's halves (ROWS 64)

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const int r0 = (ROWS == 128 ? g * 64 : 0) + wq * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int c0 = ROWS == 128 ? 0 : g * NW, cq = 2 * (lane & 3);
  const uint32_t a_wg = sA + (ROWS == 128 ? g * 64 * 128 : 0);
  const int L = P.n_layers, mr = P.multires, ns = P.n_slices;
  const float scale = P.scale, hb = P.bias[(L - 1) * WIDTH];
  uint8_t* e_panel = gA + 4 * PANEL;

  for (int i = tid; i < ns; i += FT) tab[i] = P.s[i];
  __syncthreads();

  float acc[NW / 2];
  uint32_t it = 0;
  for (int q = 0; q < PREFETCH; ++q) {
    load_slice(tab, ns, P.w16, q, ring, tid);
    cp_async_commit();
  }

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long p0 = (long)tile * ROWS;

    // the embedding into the e panel
    for (int item = tid; item < ROWS * (mr + 1); item += FT) {
      const int row = item / (mr + 1), k = item % (mr + 1);
      const bool in = p0 + row < P.n;
      float y[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) y[i] = in ? scale * P.x[(p0 + row) * 3 + i] : 0.f;
      if (k < mr) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float sn, cs;
          sincosf(y[i] * f, &sn, &cs);
          put(e_panel, row, 3 + 6 * k + i, sn);
          put(e_panel, row, 6 + 6 * k + i, cs);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) put(e_panel, row, i, y[i]);
        for (int c = 3 + 6 * mr; c < PE_W; ++c) put(e_panel, row, c, 0.f);
      }
    }
    fence_async();
    __syncthreads();

    // this thread's part of the head's column 0 at rows r0, r0 + 8, over
    // columns 0..127 and 128..255 apart
    float u0[2] = {0.f, 0.f}, u1[2] = {0.f, 0.f};
    for (int l = 0; l < L - 1; ++l) {
      const VLayer Ly = P.l[l];
      sweep_gemm<NW>(acc, a_wg, l == 0 ? 4 : 0, l == 0 ? 1 : 4 + Ly.skip, ring, tab, ns, P.w16, it,
                     tid, c0);
      if (ROWS == 64) __syncthreads();  // the other warpgroup's products read every column
      const float* __restrict__ bias = P.bias + l * WIDTH;
      const bool last = l == L - 2;
#pragma unroll
      for (int i4 = 0; i4 < NW / 8; ++i4) {
        const int col = c0 + i4 * 8 + cq;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        float h0, h1, h2, h3, sg;
        activate(Ly.alpha * acc[4 * i4] + b0, h0, sg);
        activate(Ly.alpha * acc[4 * i4 + 1] + b1, h1, sg);
        activate(Ly.alpha * acc[4 * i4 + 2] + b0, h2, sg);
        activate(Ly.alpha * acc[4 * i4 + 3] + b1, h3, sg);
        if (!last) {
          put2(gA, r0, col, h0, h1);
          put2(gA, r0 + 8, col, h2, h3);
        } else {
          const float2 wv = unpack2(__ldg(reinterpret_cast<const unsigned int*>(P.wh + col)));
          const int hf = ROWS == 128 && i4 >= 16;
          u0[hf] = fmaf(bf16_round(h1), wv.y, fmaf(bf16_round(h0), wv.x, u0[hf]));
          u1[hf] = fmaf(bf16_round(h3), wv.y, fmaf(bf16_round(h2), wv.x, u1[hf]));
        }
      }
      if (!last) {
        fence_async();
        __syncthreads();
      }
    }

    // the head: the four threads of a row hold its 256 columns (ROWS 64:
    // each warpgroup's four threads one half)
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        u0[hf] += __shfl_xor_sync(0xffffffffu, u0[hf], m);
        u1[hf] += __shfl_xor_sync(0xffffffffu, u1[hf], m);
      }
    }
    if (ROWS == 128) {
      if ((lane & 3) == 0) {
        if (p0 + r0 < P.n) P.out[p0 + r0] = head_phi((u0[0] + u0[1]) + hb, P.head) / scale;
        if (p0 + r0 + 8 < P.n) P.out[p0 + r0 + 8] = head_phi((u1[0] + u1[1]) + hb, P.head) / scale;
      }
      __syncthreads();  // the next tile's embedding overwrites what the products read
    } else {
      if ((lane & 3) == 0) {
        hpart[g * 64 + r0] = u0[0];
        hpart[g * 64 + r0 + 8] = u1[0];
      }
      __syncthreads();
      if (tid < 64 && p0 + tid < P.n)
        P.out[p0 + tid] = head_phi((hpart[tid] + hpart[64 + tid]) + hb, P.head) / scale;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// tiers "highest" and "high" on the sweeps' nets: 3xTF32 and bf16x3 wgmma
// sweeps, f32 activations
// ---------------------------------------------------------------------------

#define XPANEL 8192       // [64 x 32] f32 activation panel: 128-byte rows, 16-byte chunks XOR row % 8
#define X_PANELS 10       // eight h panels (columns 0..255), two e panels (columns 256..319)
#define XSLICE 16384      // ring stage: a k-step of up to 256 weight rows, [hi | lo] in 64 bytes a row
#define X_STAGES 8
#define XB_PANEL 8192     // bf16x3: a [64 x 64] bf16 operand panel of the weight cotangent
#define X_MAX_SEGS 64
#define X_CHUNK 4096      // wgrad32: 32 rows of a panel
#define XW_B 16384        // wgrad32: one [128 x 32] operand half (hi or lo), K-major, 128-byte swizzle
#define XW_STAGE 32768    // wgrad32: a ring stage, four X chunks and four G chunks
#define XW_STAGES 4
#define SWEEP32_SMEM \
  (512 + X_STAGES * XSLICE + X_PANELS * XPANEL + 4 * 128 + 4 * 4 * WIDTH)
#define WGRAD32_SMEM (1024 + 4 * XW_B + XW_STAGES * XW_STAGE)

// What the two split-operand routes' sweeps take a step of a product: KS
// columns of the activations against one ring slice (32 bytes of K: a tf32
// k8 or a bf16 k16 wgmma); CH steps a chunk, whose passes one wgmma group
// runs; LEAD slices in flight ahead of the chunk (LEAD + CH <= X_STAGES).
// tf32x3 adds each chunk's passes to the product in f32 (the tensor cores'
// sums truncate); bf16x3 accumulates the whole product in the tensor cores.
template <int MODE> struct XTier;
template <> struct XTier<ROUTE_TF32X3> { static constexpr int KS = 8, CH = 2, LEAD = 6; };
template <> struct XTier<ROUTE_BF16X3> { static constexpr int KS = 16, CH = 4, LEAD = 4; };

struct XSeg {  // consecutive k-step slices of one product's weights in the packed buffer
  uint32_t off;   // float offset of the first slice; a slice is rows x 16 floats (64 bytes)
  uint16_t rows;  // N of the product (256 or 64)
  uint8_t steps;  // slices
  uint8_t acol;   // first column of the A operand in the activation panels, over KS
};

struct PSeg {  // how pack32_kernel fills one XSeg
  int src, ld, trans, kbase, n0, rows, steps, dst;
};

struct Pack32Args {
  int n;
  PSeg s[X_MAX_SEGS];
};

struct Sweep32Args {
  const float *x, *b, *w;  // w: the f32 weights (K1 reads the head's first column)
  const float* wpk;        // tf32 or bf16 hi and lo slices of every product, in the order of s
  int n_layers, multires, head, d_out, n_tiles, n_segs, nx_slots, ng_slots, b_total;
  float scale;
  float *udf, *feat, *grad;
  const float *ubar, *fbar, *gbar;
  float *xbar, *bpart;
  uint8_t *xbuf, *gbuf;  // K2: operand panels of the weight cotangent
  float4* spill;  // per block: sigma (and q) of every hidden layer, f32
  FLayer l[F_MAX_LAYERS];
  XSeg s[X_MAX_SEGS];
};

struct XItem {  // one output tile of the grouped weight-cotangent GEMM of wgrad32_kernel
  int xs0, xs1;  // first of the two X panel slots of each warpgroup (xs1 < 0: none)
  int gs0, n;    // first G panel slot, tile width (256 or 64)
  int w_off, np, m0, n0;
  float alpha;
};

struct Wgrad32Args {
  const uint8_t *xbuf, *gbuf;
  float* part;
  long w_total;
  int nx_slots, ng_slots, n_tiles;
  XItem item[MAX_ITEMS];
};

// tf32 value of v, rounded to nearest with ties away from zero (the 13 low
// bits of the result are zero)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// h = softplus100(a) and sg = sigma(100 a) in f32: activate's two
// special-function instructions and a third, h = max(a, 0) + log2(1 + t)
// ln 2 / 100 on lg2.approx (about 2e-9 absolute in h; activate's
// polynomial is 6e-8 off at a = 0, 1e-5 of h there); sg to a few ulps.
__device__ __forceinline__ void activate_f32(float a, float& h, float& sg) {
  float t, r, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fabsf(a) * -144.26950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + t));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + t));
  sg = a >= 0.f ? r : t * r;
  h = fmaf(l, 6.9314718055994531e-3f, fmaxf(a, 0.f));
}

// keeps the compiler from reusing a wgmma's A registers before it has completed
__device__ __forceinline__ void reg_fence4(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 64-byte swizzle, K-major: rows of 64
// bytes, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t make_desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// d (+)= a b, wgmma m64nNk8 tf32 x tf32 -> f32 (scale_d 0: d = a b). A from
// registers, four a thread: rows lane / 4 and lane / 4 + 8 of the warp's
// 16, columns lane % 4 and lane % 4 + 4; B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  if constexpr (N == 128) wgmma_tf32_n128(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, db, scale_d);
  else wgmma_tf32_n32(d, a, db, scale_d);
}

// d (+)= a b, wgmma m64nNk16 bf16 x bf16 -> f32 (scale_d 0: d = a b). A from
// registers, four a thread, two bf16 each: rows lane / 4 and lane / 4 + 8 of
// the warp's 16, columns 2 (lane % 4) + {0, 1} and 8 more; B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_bf16_n32(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  if constexpr (N == 128) wgmma_bf16_n128(d, a, db, scale_d);
  else wgmma_bf16_n32(d, a, db, scale_d);
}

// byte offset of f32 element (row, col) in the activation panels
__device__ __forceinline__ uint32_t xoff(int row, int col) {
  return (col >> 5) * XPANEL + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

__device__ __forceinline__ float xget(const uint8_t* act, int row, int col) {
  return *reinterpret_cast<const float*>(act + xoff(row, col));
}

__device__ __forceinline__ void xput(uint8_t* act, int row, int col, float v) {
  *reinterpret_cast<float*>(act + xoff(row, col)) = v;
}

__device__ __forceinline__ void xput2(uint8_t* act, int row, int col, float a, float b) {
  *reinterpret_cast<float2*>(act + xoff(row, col)) = make_float2(a, b);
}

// W and W^T slices of every product, split into hi and lo (tf32, or bf16
// with BF16), in the order the sweep consumes them: item i is (slice j, row
// r, k); the slice's row r holds [hi(B[k0 + k, r]) k < KS | lo(...)], B = W
// (trans) or W^T, 64 bytes either way.
template <bool BF16>
__global__ void pack32_kernel(const float* w, float* out, const __grid_constant__ Pack32Args P) {
  constexpr int KS = BF16 ? 16 : 8;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  long base = 0;
  int s = 0;
  for (; s < P.n; ++s) {
    const long cnt = (long)P.s[s].steps * P.s[s].rows * KS;
    if (i < base + cnt) break;
    base += cnt;
  }
  if (s == P.n) return;
  const PSeg q = P.s[s];
  const long e = i - base, jr = e / KS;
  const int k = (int)(e % KS), r = (int)(jr % q.rows), j = (int)(jr / q.rows);
  const int kk = q.kbase + KS * j + k, nn = q.n0 + r;
  const float v = q.trans ? w[q.src + (long)nn * q.ld + kk] : w[q.src + (long)kk * q.ld + nn];
  if constexpr (BF16) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out + q.dst) + jr * 32 + k;
    const __nv_bfloat16 hi = __float2bfloat16(v);
    o[0] = hi;
    o[16] = __float2bfloat16(v - __bfloat162float(hi));
  } else {
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    float* o = out + q.dst + (jr << 4) + k;
    o[0] = __uint_as_float(hi);
    o[8] = __uint_as_float(lo);
  }
}

struct XCursor {  // the next slice to load, and the slices loaded so far
  int seg, step;
  uint32_t n;
};

__device__ __forceinline__ void x_load_next(const Sweep32Args& P, XCursor& c, uint32_t ring,
                                            int tid) {
  const XSeg s = P.s[c.seg];
  const uint32_t dst = ring + (c.n % X_STAGES) * XSLICE;
  const float* src = P.wpk + s.off + (size_t)c.step * s.rows * 16;
  for (int i = tid; i < s.rows * 4; i += FT) {
    const int row = i >> 2, ch = i & 3;
    cp_async16(dst + row * 64 + ((ch ^ ((row >> 1) & 3)) << 4), src + row * 16 + ch * 4);
  }
  cp_async_commit();
  ++c.n;
  if (++c.step == s.steps) {
    c.step = 0;
    if (++c.seg == P.n_segs) c.seg = 0;
  }
}

// this warp's [16 x 8] piece of the activation panels at column col, split
__device__ __forceinline__ void x_afrag(const uint8_t* act, int wrow, int col, int lane,
                                        uint32_t* ah, uint32_t* al) {
  const int r = wrow + (lane >> 2), c = col + (lane & 3);
  split_tf32(xget(act, r, c), ah[0], al[0]);
  split_tf32(xget(act, r + 8, c), ah[1], al[1]);
  split_tf32(xget(act, r, c + 4), ah[2], al[2]);
  split_tf32(xget(act, r + 8, c + 4), ah[3], al[3]);
}

// this warp's [16 x 16] piece of the activation panels at column col as
// bf16: with SPLIT, alpha v into hi = bf16(alpha v) and lo = bf16(alpha v -
// hi); else hi = bf16(v) alone (a cotangent)
template <bool SPLIT>
__device__ __forceinline__ void b3_afrag(const uint8_t* act, int wrow, int col, int lane,
                                         float alpha, uint32_t* ah, uint32_t* al) {
  const int r = wrow + (lane >> 2), c = col + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = *reinterpret_cast<const float2*>(act + xoff(r + 8 * (i & 1), c + 8 * (i >> 1)));
    if (SPLIT) {
      v.x *= alpha;
      v.y *= alpha;
    }
    ah[i] = pack2(v.x, v.y);
    if (SPLIT) {
      const float2 h = unpack2(ah[i]);
      al[i] = pack2(v.x - h.x, v.y - h.y);
    }
  }
}

// slices it .. it + c - 1 are in: LEAD + it groups are committed, LEAD - c may pend
template <int LEAD>
__device__ __forceinline__ void x_wait_slices(int c) {
  if (c >= 4) cp_async_wait<(LEAD < 4 ? 0 : LEAD - 4)>();
  else if (c == 3) cp_async_wait<(LEAD < 3 ? 0 : LEAD - 3)>();
  else if (c == 2) cp_async_wait<LEAD - 2>();
  else cp_async_wait<LEAD - 1>();
}

// One chunk of a sweep product: c <= CH steps at columns col[0..c) of the
// activation panels, against the ring's next c slices; this warpgroup's N
// columns are rows g N .. g N + N - 1 of the slices.
// tf32x3: the chunk's passes go to a fresh accumulator acc2, the small
// terms first (a_lo B_hi, a_hi B_lo of every step, then a_hi B_hi), and
// acc2 is added to acc in f32: the tensor cores' accumulation truncates, so
// each chunk's sum rounds only at its own magnitude, acc rounds to nearest.
// bf16x3, a forward product (REV false): alpha A split, the same three
// passes into acc. bf16x3, a reverse product: bf16(A) B_hi into acc (P),
// bf16(A) B_lo into acc2 (S), kept apart for the epilogue.
template <int MODE, int N, bool REV>
__device__ __forceinline__ void x_chunk(float* acc, float* acc2, const uint8_t* act, int wrow,
                                        const int* col, int c, bool last, float alpha,
                                        uint32_t ring, const Sweep32Args& P, XCursor& pc,
                                        uint32_t& it, int g, int tid) {
  using T = XTier<MODE>;
  static_assert(T::CH <= 4 && T::LEAD + T::CH <= X_STAGES, "ring");
  constexpr bool TF32 = MODE == ROUTE_TF32X3;
  x_wait_slices<T::LEAD>(c);
  fence_async();
  if (last) bulk_reads_done(tid);  // the epilogue may write the panels a dump reads
  __syncthreads();
  // slices it + LEAD.. go to the stages of slices it + LEAD - X_STAGES..,
  // which the previous chunk read and waited for
  for (int q = 0; q < c; ++q) x_load_next(P, pc, ring, tid);
  uint32_t ah[T::CH][4], al[T::CH][4];
  uint32_t sb[T::CH];
#pragma unroll
  for (int q = 0; q < T::CH; ++q) {
    if (q < c) {
      if constexpr (TF32) x_afrag(act, wrow, col[q], tid & 31, ah[q], al[q]);
      else b3_afrag<!REV>(act, wrow, col[q], tid & 31, alpha, ah[q], al[q]);
    }
    sb[q] = ring + ((it + q) % X_STAGES) * XSLICE + g * N * 64;
  }
  wgmma_fence();
  if constexpr (TF32) {
#pragma unroll
    for (int q = 0; q < T::CH; ++q) {
      if (q < c) {
        wgmma_tf32<N>(acc2, al[q], make_desc64(sb[q]), q != 0);
        wgmma_tf32<N>(acc2, ah[q], make_desc64(sb[q] + 32), 1);
      }
    }
#pragma unroll
    for (int q = 0; q < T::CH; ++q)
      if (q < c) wgmma_tf32<N>(acc2, ah[q], make_desc64(sb[q]), 1);
  } else if constexpr (REV) {
#pragma unroll
    for (int q = 0; q < T::CH; ++q) {
      if (q < c) {
        wgmma_bf16<N>(acc, ah[q], make_desc64(sb[q]), 1);
        wgmma_bf16<N>(acc2, ah[q], make_desc64(sb[q] + 32), 1);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < T::CH; ++q) {
      if (q < c) {
        wgmma_bf16<N>(acc, al[q], make_desc64(sb[q]), 1);
        wgmma_bf16<N>(acc, ah[q], make_desc64(sb[q] + 32), 1);
      }
    }
#pragma unroll
    for (int q = 0; q < T::CH; ++q)
      if (q < c) wgmma_bf16<N>(acc, ah[q], make_desc64(sb[q]), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<N / 2>(acc);
  acc_fence<N / 2>(acc2);
#pragma unroll
  for (int q = 0; q < T::CH; ++q) {
    reg_fence4(ah[q]);
    if constexpr (TF32 || !REV) reg_fence4(al[q]);
  }
  if constexpr (TF32) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += acc2[i];
  }
  it += c;
}

// acc[64 x N] = the activation panels' 64 rows times this warpgroup's N
// columns of the weights of the next nseg (1 or 2) segments, one product
// over their slices, in chunks of CH steps (bf16x3, REV: P in acc, S in
// acc2). alpha scales A before bf16x3's split (a forward product).
template <int MODE, int N, bool REV>
__device__ __forceinline__ void x_gemm(float* acc, float* acc2, const uint8_t* act, int wrow,
                                       int& cs, int nseg, float alpha, uint32_t ring,
                                       const Sweep32Args& P, XCursor& pc, uint32_t& it, int g,
                                       int tid) {
  using T = XTier<MODE>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = 0.f;
    if (MODE == ROUTE_BF16X3 && REV) acc2[i] = 0.f;
  }
  const XSeg sa = P.s[cs], sb = nseg > 1 ? P.s[cs + 1] : sa;
  const int na = sa.steps, total = na + (nseg > 1 ? sb.steps : 0);
  for (int j = 0; j < total; j += T::CH) {
    const int c = total - j < T::CH ? total - j : T::CH;
    int col[T::CH];
#pragma unroll
    for (int q = 0; q < T::CH; ++q) {
      const int k = j + q;
      col[q] = k < na ? T::KS * (sa.acol + k) : T::KS * (sb.acol + k - na);
    }
    x_chunk<MODE, N, REV>(acc, acc2, act, wrow, col, c, j + c == total, alpha, ring, P, pc, it, g,
                          tid);
  }
  cs += nseg;
}

// the output of a reverse product: alpha P (tf32x3), or alpha (P + bf16((S +
// P) - P)) (bf16x3, JAX's transpose of _dot3: the W_lo part's sum passes the
// bf16 cast of hi + lo - hi)
template <int MODE>
__device__ __forceinline__ float rev_out(float alpha, float p, float s) {
  if constexpr (MODE == ROUTE_BF16X3) return alpha * (p + bf16_round((s + p) - p));
  return alpha * p;
}

// bf16x3, K2: the bf16 pair v at (row, col), (row, col + 1) of a [64 x 64]
// operand panel (128-byte rows, the 128-byte swizzle)
__device__ __forceinline__ void xb_put2(uint8_t* panel, int row, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(panel + swz(row, col)) = v;
}

// bf16x3, K2: alpha (v0, v1) split into an X panel (hi) and the next one (lo)
__device__ __forceinline__ void xb_split2(uint8_t* hi, int row, int col, float alpha, float v0,
                                          float v1) {
  const float a0 = alpha * v0, a1 = alpha * v1;
  const uint32_t h = pack2(a0, a1);
  const float2 hf = unpack2(h);
  xb_put2(hi, row, col, h);
  xb_put2(hi + XB_PANEL, row, col, pack2(a0 - hf.x, a1 - hf.y));
}

__device__ __forceinline__ void x_dump(uint32_t src, int panels, uint8_t* dst, int tid) {
  if (tid == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(src), "r"(panels * XPANEL)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// K1 (BWD = false): a tile is 64 points. K2 (BWD = true): a tile is 32
// points, primal and tangent rows interleaved by eights, as sweep_kernel's.
// Both warpgroups read the tile's 64 rows; warpgroup g owns columns
// 128 g.. of the 256-wide products and 32 g.. of the 64-wide ones. MODE is
// the route: ROUTE_TF32X3 (tier "highest") or ROUTE_BF16X3 (tier "high").
template <bool BWD, int MODE>
__global__ void __launch_bounds__(FT, 1) sweep32_kernel(const __grid_constant__ Sweep32Args P) {
  constexpr bool B3 = MODE == ROUTE_BF16X3;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t ring = (raw_addr + 511u) & ~511u;
  const uint32_t act_s = ring + X_STAGES * XSLICE;
  uint8_t* act = smem_raw + (act_s - raw_addr);  // the activation panels
  float* crow = reinterpret_cast<float*>(act + X_PANELS * XPANEL);
  float* arow = crow + 64;
  float* bwarp = crow + 128;  // K2: [4 warps of a warpgroup][WIDTH] partial b̄

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const int wrow = wq * 16;           // this warp's first row
  const int r0 = wrow + (lane >> 2);  // row of acc[4i], acc[4i+1]; acc[4i+2..3]: r0 + 8
  const int cq = 2 * (lane & 3);
  const int cw = g * 128, ce = g * 32;  // this warpgroup's first column, 256- and 64-wide
  const int L = P.n_layers, mr = P.multires;
  const float scale = P.scale;
  const int pts = BWD ? 32 : 64;
  float* bpart = BWD ? P.bpart + (long)blockIdx.x * P.b_total : nullptr;
  // bf16x3 applies alpha to the forward products' A before the split
  auto out_alpha = [](float alpha) { return B3 ? 1.f : alpha; };

  if (BWD)
    for (int i = tid; i < P.b_total; i += FT) bpart[i] = 0.f;
  __syncthreads();

  float acc[64], acc2[64], eacc[16];
  uint32_t it = 0;
  XCursor pc = {0, 0, 0u};
  for (int q = 0; q < XTier<MODE>::LEAD; ++q) x_load_next(P, pc, ring, tid);

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long p0 = (long)tile * pts;
    int cs = 0;  // the next segment of the products
    // bf16x3, K2: this tile's operand panels of the weight cotangent
    uint8_t* xb = BWD && B3 ? P.xbuf + (size_t)tile * P.nx_slots * XB_PANEL : nullptr;
    uint8_t* gb = BWD && B3 ? P.gbuf + (size_t)tile * P.ng_slots * XB_PANEL : nullptr;

    // the embedding (and its tangent) into the e panels, columns 256..319
    for (int item = tid; item < pts * (mr + 1); item += FT) {
      const int pl = item / (mr + 1), k = item % (mr + 1);
      const int row = BWD ? ((pl >> 3) * 16 + (pl & 7)) : pl;
      float y[3], gb3[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        y[i] = scale * P.x[(p0 + pl) * 3 + i];
        gb3[i] = BWD ? P.gbar[(p0 + pl) * 3 + i] : 0.f;
      }
      if (k < mr) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float sn, cs_;
          sincosf(y[i] * f, &sn, &cs_);
          xput(act, row, WIDTH + 3 + 6 * k + i, sn);
          xput(act, row, WIDTH + 6 + 6 * k + i, cs_);
          if (BWD) {
            xput(act, row + 8, WIDTH + 3 + 6 * k + i, scale * f * cs_ * gb3[i]);
            xput(act, row + 8, WIDTH + 6 + 6 * k + i, -scale * f * sn * gb3[i]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          xput(act, row, WIDTH + i, y[i]);
          if (BWD) xput(act, row + 8, WIDTH + i, scale * gb3[i]);
        }
        for (int c = 3 + 6 * mr; c < PE_W; ++c) {
          xput(act, row, WIDTH + c, 0.f);
          if (BWD) xput(act, row + 8, WIDTH + c, 0.f);
        }
      }
    }
    fence_async();
    __syncthreads();
    if (BWD && !B3) x_dump(act_s + 8 * XPANEL, 2, P.xbuf + ((size_t)tile * P.nx_slots) * XPANEL, tid);
    if (BWD && B3) {
      // split(alpha [e; t_e]) for layer 0 and every skip layer, each its own alpha
      for (int l = 0; l < L; ++l) {
        if (l > 0 && !P.l[l].skip) continue;
        uint8_t* hi = xb + (size_t)(P.l[l].xslot + (l > 0 ? 2 * WIDTH / 64 : 0)) * XB_PANEL;
        for (int c = tid; c < 64 * 8; c += FT) {
          const int row = c >> 3, ch = c & 7;
          const float4 u = *reinterpret_cast<const float4*>(act + xoff(row, WIDTH + 8 * ch));
          const float4 v = *reinterpret_cast<const float4*>(act + xoff(row, WIDTH + 8 * ch + 4));
          const float e[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 8; j += 2) xb_split2(hi, row, 8 * ch + j, P.l[l].alpha, e[j], e[j + 1]);
        }
      }
    }

    // forward sweep over the hidden layers
    for (int l = 0; l < L - 1; ++l) {
      const FLayer Ly = P.l[l];
      x_gemm<MODE, 128, false>(acc, acc2, act, wrow, cs, (l > 0) + (l == 0 || Ly.skip), Ly.alpha,
                               ring, P, pc, it, g, tid);
      __syncthreads();  // the other warpgroup is done reading the panels this layer overwrites
      const float* __restrict__ bias = P.b + Ly.b_off;
      const float alpha = out_alpha(Ly.alpha), an = P.l[l + 1].alpha;
      uint8_t* xn = B3 && BWD ? xb + (size_t)P.l[l + 1].xslot * XB_PANEL : nullptr;
      float4* sp = P.spill + ((size_t)(blockIdx.x * (L - 1) + l) * 16) * FT + tid;
#pragma unroll
      for (int i4 = 0; i4 < 16; ++i4) {
        const int col = cw + i4 * 8 + cq;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        float h0, h1, s0, s1;
        activate_f32(alpha * acc[4 * i4] + b0, h0, s0);
        activate_f32(alpha * acc[4 * i4 + 1] + b1, h1, s1);
        xput2(act, r0, col, h0, h1);
        if (!BWD) {
          float h2, h3, s2, s3;
          activate_f32(alpha * acc[4 * i4 + 2] + b0, h2, s2);
          activate_f32(alpha * acc[4 * i4 + 3] + b1, h3, s3);
          xput2(act, r0 + 8, col, h2, h3);
          sp[(size_t)i4 * FT] = make_float4(s0, s1, s2, s3);
        } else {  // row r0 + 8: the tangent t_a of row r0's point
          const float t0 = alpha * acc[4 * i4 + 2], t1 = alpha * acc[4 * i4 + 3];
          xput2(act, r0 + 8, col, s0 * t0, s1 * t1);
          sp[(size_t)i4 * FT] = make_float4(s0, s1, 100.f * s0 * (1.f - s0) * t0,
                                            100.f * s1 * (1.f - s1) * t1);
          if (B3) {  // layer l + 1's input, split after its alpha
            uint8_t* hi = xn + (size_t)(2 * (col >> 6)) * XB_PANEL;
            xb_split2(hi, r0, col & 63, an, h0, h1);
            xb_split2(hi, r0 + 8, col & 63, an, s0 * t0, s1 * t1);
          }
        }
      }
      fence_async();
      __syncthreads();
      if (BWD && !B3)
        x_dump(act_s, 8, P.xbuf + ((size_t)tile * P.nx_slots + P.l[l + 1].xslot) * XPANEL, tid);
    }

    // the head
    const FLayer H = P.l[L - 1];
    const float* hbias = P.b + H.b_off;
    const float ha = out_alpha(H.alpha);
    if (!BWD) {
      // columns 256.. (features only), then columns 0..255
      x_gemm<MODE, 32, false>(acc, acc2, act, wrow, cs, 1, H.alpha, ring, P, pc, it, g, tid);
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = WIDTH + ce + i4 * 8 + cq + (j & 1), row = r0 + (j >> 1) * 8;
          if (col < P.d_out)
            P.feat[(p0 + row) * (P.d_out - 1) + col - 1] = ha * acc[4 * i4 + j] + hbias[col];
        }
      }
      x_gemm<MODE, 128, false>(acc, acc2, act, wrow, cs, 1, H.alpha, ring, P, pc, it, g, tid);
#pragma unroll
      for (int i4 = 0; i4 < 16; ++i4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cw + i4 * 8 + cq + (j & 1), row = r0 + (j >> 1) * 8;
          const float v = ha * acc[4 * i4 + j] + hbias[col];
          if (col == 0) {
            P.udf[p0 + row] = head_phi(v, P.head) / scale;
            crow[row] = head_dphi(v, P.head) / scale;
          } else if (col < P.d_out) {
            P.feat[(p0 + row) * (P.d_out - 1) + col - 1] = v;
          }
        }
      }
      __syncthreads();
      // gamma_{L-2} = sigma_{L-2} (the seed c e0 times W_head^T): one column,
      // no GEMM; at bf16x3 rounded as the reverse products round, bf16(c)
      // against W's hi and lo (each product exact in f32)
      const float* wh = P.w + H.w_off;  // W_head [kp x np]; column 0 is wh[k np]
      const float4* sp = P.spill + ((size_t)(blockIdx.x * (L - 1) + L - 2) * 16) * FT + tid;
      const float ca = B3 ? bf16_round(crow[r0]) : crow[r0];
      const float cb = B3 ? bf16_round(crow[r0 + 8]) : crow[r0 + 8];
      auto back = [&](float c, float w) {
        if (!B3) return H.alpha * (c * w);
        const float w_hi = bf16_round(w);
        return rev_out<MODE>(H.alpha, c * w_hi, c * bf16_round(w - w_hi));
      };
#pragma unroll 4
      for (int i4 = 0; i4 < 16; ++i4) {
        const int col = cw + i4 * 8 + cq;
        const float w0 = __ldg(wh + (long)col * H.np), w1 = __ldg(wh + (long)(col + 1) * H.np);
        const float4 s = sp[(size_t)i4 * FT];
        xput2(act, r0, col, s.x * back(ca, w0), s.y * back(ca, w1));
        xput2(act, r0 + 8, col, s.z * back(cb, w0), s.w * back(cb, w1));
      }
    } else {
      // only column 0 of the head's forward is read: raw and its tangent
      x_gemm<MODE, 32, false>(acc, acc2, act, wrow, cs, 1, H.alpha, ring, P, pc, it, g, tid);
      if (g == 0 && cq == 0) {
        const int pl = (r0 >> 4) * 8 + (r0 & 7);
        const float raw = ha * acc[0] + hbias[0], tan0 = ha * acc[2];
        const float cc = head_dphi(raw, P.head) / scale;
        crow[pl] = cc;
        arow[pl] = P.ubar[p0 + pl] * cc + (P.head == HEAD_SQUARE ? 2.f / scale : 0.f) * tan0;
      }
      __syncthreads();
      // G_{L-1} over all 320 columns: abar = [ubar c + (phi''/s) T, fbar] on
      // primal rows, gamma = c e0 on tangent rows
      for (int item = tid; item < 64 * (X_PANELS * 4); item += FT) {
        const int row = item / (X_PANELS * 4), ch = item % (X_PANELS * 4);
        const int pl = (row >> 4) * 8 + (row & 7);
        const bool tangent = (row >> 3) & 1;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = ch * 8 + e;
          if (tangent) v[e] = col == 0 ? crow[pl] : 0.f;
          else if (col == 0) v[e] = arow[pl];
          else v[e] = col < P.d_out ? P.fbar[(p0 + pl) * (P.d_out - 1) + col - 1] : 0.f;
        }
        *reinterpret_cast<float4*>(act + xoff(row, ch * 8)) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(act + xoff(row, ch * 8 + 4)) = make_float4(v[4], v[5], v[6], v[7]);
        if (B3)
          *reinterpret_cast<uint4*>(gb + (size_t)(H.gslot + (ch >> 3)) * XB_PANEL + row * 128 +
                                    (((ch & 7) ^ (row & 7)) << 4)) =
              make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
      for (int col = tid; col < H.np; col += FT) {
        float s = 0.f;
        for (int pl = 0; pl < 32; ++pl) {
          if (col == 0) s += arow[pl];
          else if (col < P.d_out) s += P.fbar[(p0 + pl) * (P.d_out - 1) + col - 1];
        }
        bpart[H.b_off + col] += s;
      }
    }
    fence_async();
    __syncthreads();

    // reverse sweep
#pragma unroll
    for (int i = 0; i < 16; ++i) eacc[i] = 0.f;
    for (int l = BWD ? L - 1 : L - 2; l >= 0; --l) {
      const FLayer Ly = P.l[l];
      if (BWD && !B3)
        x_dump(act_s, l == L - 1 ? X_PANELS : 8,
               P.gbuf + ((size_t)tile * P.ng_slots + Ly.gslot) * XPANEL, tid);
      if (l == 0 || Ly.skip) {  // the e-part of alpha G W^T: eps (and ebar)
        x_gemm<MODE, 32, true>(acc, acc2, act, wrow, cs, 1, 1.f, ring, P, pc, it, g, tid);
#pragma unroll
        for (int i = 0; i < 16; ++i) eacc[i] += rev_out<MODE>(Ly.alpha, acc[i], acc2[i]);
      }
      if (l == 0) break;
      x_gemm<MODE, 128, true>(acc, acc2, act, wrow, cs, 1, 1.f, ring, P, pc, it, g, tid);
      __syncthreads();  // the other warpgroup is done reading the panels this layer overwrites
      const float alpha = Ly.alpha;
      const float4* sp = P.spill + ((size_t)(blockIdx.x * (L - 1) + l - 1) * 16) * FT + tid;
      uint8_t* gn = B3 && BWD ? gb + (size_t)P.l[l - 1].gslot * XB_PANEL : nullptr;
#pragma unroll
      for (int i4 = 0; i4 < 16; ++i4) {
        const int col = cw + i4 * 8 + cq;
        const float4 s = sp[(size_t)i4 * FT];
        const float d0 = rev_out<MODE>(alpha, acc[4 * i4], acc2[4 * i4]);
        const float d1 = rev_out<MODE>(alpha, acc[4 * i4 + 1], acc2[4 * i4 + 1]);
        const float d2 = rev_out<MODE>(alpha, acc[4 * i4 + 2], acc2[4 * i4 + 2]);
        const float d3 = rev_out<MODE>(alpha, acc[4 * i4 + 3], acc2[4 * i4 + 3]);
        if (!BWD) {  // s: sigma of rows r0 (x, y) and r0 + 8 (z, w)
          xput2(act, r0, col, s.x * d0, s.y * d1);
          xput2(act, r0 + 8, col, s.z * d2, s.w * d3);
        } else {  // s: sigma (x, y) and q (z, w); d0, d1: abar', d2, d3: gamma'
          float ab0 = s.x * d0 + s.z * d2, ab1 = s.y * d1 + s.w * d3;
          xput2(act, r0, col, ab0, ab1);
          xput2(act, r0 + 8, col, s.x * d2, s.y * d3);
          if (B3) {  // G_{l-1} in bf16
            uint8_t* panel = gn + (size_t)(col >> 6) * XB_PANEL;
            xb_put2(panel, r0, col & 63, pack2(ab0, ab1));
            xb_put2(panel, r0 + 8, col & 63, pack2(s.x * d2, s.y * d3));
          }
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            ab0 += __shfl_xor_sync(0xffffffffu, ab0, m);
            ab1 += __shfl_xor_sync(0xffffffffu, ab1, m);
          }
          if (lane < 4) {
            bwarp[wq * WIDTH + col] = ab0;
            bwarp[wq * WIDTH + col + 1] = ab1;
          }
        }
      }
      fence_async();
      __syncthreads();
      if (BWD) {  // b̄_{l-1} of this tile, warps summed in order
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += bwarp[w * WIDTH + tid];
        bpart[P.l[l - 1].b_off + tid] += s;
      }
    }

    // grad = s J_PE^T eps, or x̄ = s J_PE^T ebar + s^2 gbar (PE'' . eps)
    bulk_reads_done(tid);
    __syncthreads();
    float* E = reinterpret_cast<float*>(act);
#pragma unroll
    for (int i4 = 0; i4 < 4; ++i4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        E[(r0 + (j >> 1) * 8) * E_LD + ce + i4 * 8 + cq + (j & 1)] = eacc[4 * i4 + j];
    }
    __syncthreads();
    for (int item = tid; item < pts * 3; item += FT) {
      const int pl = item / 3, i = item % 3;
      const int row = BWD ? ((pl >> 3) * 16 + (pl & 7)) : pl;
      const float* eb = E + row * E_LD;                   // K1: eps; K2: ebar
      const float* ep = E + (row + (BWD ? 8 : 0)) * E_LD;  // eps
      const float y = scale * P.x[(p0 + pl) * 3 + i];
      float first = eb[i], second = 0.f;
      for (int k = 0, j = 3; k < mr; ++k, j += 6) {
        const float f = (float)(1 << k);
        float sn, cs_;
        sincosf(y * f, &sn, &cs_);
        first += f * cs_ * eb[j + i] - f * sn * eb[j + 3 + i];
        second += -f * f * sn * ep[j + i] - f * f * cs_ * ep[j + 3 + i];
      }
      if (BWD)
        P.xbar[(p0 + pl) * 3 + i] =
            scale * first + scale * scale * P.gbar[(p0 + pl) * 3 + i] * second;
      else
        P.grad[(p0 + pl) * 3 + i] = scale * first;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgrad32_kernel's A operand for one chunk: rows m of this warpgroup's 64 X
// columns, k the chunk's 32 rows, split in registers.
__device__ __forceinline__ void w_afrag(const uint8_t* xs, int wq, int lane, uint32_t (*ah)[4],
                                        uint32_t (*al)[4]) {
  const int m = wq * 16 + (lane >> 2), tig = lane & 3;
  auto xv = [&](int k, int mm) {
    return *reinterpret_cast<const float*>(xs + (mm >> 5) * X_CHUNK + k * 128 +
                                           ((((mm & 31) >> 2) ^ (k & 7)) << 4) + (mm & 3) * 4);
  };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kk * 8 + tig;
    split_tf32(xv(k, m), ah[kk][0], al[kk][0]);
    split_tf32(xv(k, m + 8), ah[kk][1], al[kk][1]);
    split_tf32(xv(k + 4, m), ah[kk][2], al[kk][2]);
    split_tf32(xv(k + 4, m + 8), ah[kk][3], al[kk][3]);
  }
}

// The products of one chunk into a fresh tmp, the small terms first; not
// waited for here.
template <int N>
__device__ __forceinline__ void w_issue(float* tmp, uint32_t (*ah)[4], uint32_t (*al)[4],
                                        uint32_t b_hi, uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32<N>(tmp, al[kk], make_desc(b_hi + kk * 32, 16, 1024), kk != 0);
    wgmma_tf32<N>(tmp, ah[kk], make_desc(b_lo + kk * 32, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32<N>(tmp, ah[kk], make_desc(b_hi + kk * 32, 16, 1024), 1);
  wgmma_commit();
}

// Waits for the chunk's products and adds tmp to acc in f32 (as x_chunk).
template <int N>
__device__ __forceinline__ void w_finish(float* acc, float* tmp, uint32_t (*ah)[4],
                                         uint32_t (*al)[4]) {
  wgmma_wait<0>();
  acc_fence<N / 2>(tmp);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    reg_fence4(ah[kk]);
    reg_fence4(al[kk]);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += tmp[i];
}

// One [128 x N] tile (N = 128 or 64) of W̄_l = alpha [in; t_in]^T [abar;
// gamma] over the row tiles of split blockIdx.y, from the f32 panels the
// sweep wrote, in chunks of 32 rows: A = the X columns of a warpgroup, from
// registers (split there); B = G, transposed by the block into K-major tf32
// hi and lo halves, two buffers, so that a chunk's transposition runs while
// the tensor cores work on the one before. Partial sums go to
// part[blockIdx.y].
template <int N>
__device__ __forceinline__ void wgrad32_tile(const Wgrad32Args& P, const XItem& I, uint8_t* base,
                                             uint32_t sbase) {
  uint8_t* stages = base + 4 * XW_B;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const int t0 = (int)((long)P.n_tiles * blockIdx.y / gridDim.y);
  const int t1 = (int)((long)P.n_tiles * (blockIdx.y + 1) / gridDim.y);
  const int n_steps = (t1 - t0) * 2;  // 32 rows of the 64-row tiles a step
  const int nm = I.xs1 >= 0 ? 2 : 1;
  const bool active = g < nm;

  float acc[N / 2], tmp[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t ah[4][4], al[4][4];

  // stage: X chunks of warpgroup 0 (two panels), of warpgroup 1, then the G chunks
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const size_t tile = t0 + (step >> 1);
      const uint32_t half = (step & 1) * X_CHUNK;
      const uint32_t dst = smem_u32(stages) + (step % XW_STAGES) * XW_STAGE;
      for (int c = tid; c < (2 * nm + N / 32) * (X_CHUNK / 16); c += FT) {
        const int pn = c / (X_CHUNK / 16);
        const uint32_t o = (c % (X_CHUNK / 16)) * 16;
        const uint8_t* src =
            pn < 2 * nm
                ? P.xbuf + (tile * P.nx_slots + (pn >= 2 ? I.xs1 : I.xs0) + (pn & 1)) * XPANEL
                : P.gbuf + (tile * P.ng_slots + I.gs0 + (pn - 2 * nm)) * XPANEL;
        const int so = pn < 2 * nm ? pn : 4 + pn - 2 * nm;  // slot in the stage
        cp_async16(dst + so * X_CHUNK + o, src + half + o);
      }
    }
    cp_async_commit();
  };

  for (int q = 0; q < XW_STAGES - 1; ++q) load_step(q);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<XW_STAGES - 2>();
    // this step's chunks are in; every thread is done with step - 1's stage
    // and has waited for step - 2's products, which read this step's B buffer
    __syncthreads();
    load_step(step + XW_STAGES - 1);
    const uint8_t* st = stages + (step % XW_STAGES) * XW_STAGE;
    const uint32_t bh = sbase + (step & 1) * 2 * XW_B;
    {  // B: G^T rows n, the chunk's 32 rows as k, split; 4 k a thread and pass
      uint8_t* bb = base + (step & 1) * 2 * XW_B;
      const uint8_t* gs = st + 4 * X_CHUNK;
      constexpr int per = FT / N;  // threads on one n
      const int n = tid % N, c0 = (tid / N) * (8 / per);
#pragma unroll
      for (int c = c0; c < c0 + 8 / per; ++c) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * c + i;
          v[i] = *reinterpret_cast<const float*>(gs + (n >> 5) * X_CHUNK + k * 128 +
                                                 ((((n & 31) >> 2) ^ (k & 7)) << 4) + (n & 3) * 4);
        }
        uint32_t h[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], h[i], lo[i]);
        const int o = n * 128 + ((c ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(bb + o) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(bb + XW_B + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_async();
    if (active && step > 0) w_finish<N>(acc, tmp, ah, al);
    __syncthreads();  // B of this step is in
    if (active) {
      w_afrag(st + g * 2 * X_CHUNK, wq, lane, ah, al);
      w_issue<N>(tmp, ah, al, bh, bh + XW_B);
    }
  }
  if (active && n_steps > 0) w_finish<N>(acc, tmp, ah, al);
  cp_async_wait<0>();
  if (!active) return;
  float* out = P.part + (size_t)blockIdx.y * P.w_total + I.w_off +
               (size_t)(I.m0 + g * 64 + wq * 16 + (lane >> 2)) * I.np + I.n0 + 2 * (lane & 3);
#pragma unroll
  for (int i4 = 0; i4 < N / 8; ++i4) {
    *reinterpret_cast<float2*>(out + i4 * 8) =
        make_float2(I.alpha * acc[4 * i4], I.alpha * acc[4 * i4 + 1]);
    *reinterpret_cast<float2*>(out + (size_t)8 * I.np + i4 * 8) =
        make_float2(I.alpha * acc[4 * i4 + 2], I.alpha * acc[4 * i4 + 3]);
  }
}

__global__ void __launch_bounds__(FT, 1) wgrad32_kernel(const __grid_constant__ Wgrad32Args P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t sbase = (raw_addr + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (sbase - raw_addr);
  const XItem I = P.item[blockIdx.x];
  if (I.n == 128) wgrad32_tile<128>(P, I, base, sbase);
  else wgrad32_tile<64>(P, I, base, sbase);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

namespace {

struct Layer {
  int kp, np, kh, skip;  // padded in width, padded out width, h-part width, skip
  float alpha;
  long w_off, b_off;
};

struct Net {
  int n;
  Layer l[MAX_LAYERS];
  int pe_w, max_np, max_kp;
  long w_total, b_total;
};

bool make_net(int n_layers, const int* dims, int pe_w, Net* net) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || pe_w % BN) return false;
  net->n = n_layers;
  net->pe_w = pe_w;
  net->max_np = net->max_kp = 0;
  long w = 0, b = 0;
  for (int i = 0; i < n_layers; ++i) {
    Layer& L = net->l[i];
    L.kp = dims[4 * i];
    L.np = dims[4 * i + 1];
    L.kh = dims[4 * i + 2];
    L.skip = dims[4 * i + 3];
    L.alpha = L.skip ? 0.70710678118654752f : 1.f;
    L.w_off = w;
    L.b_off = b;
    w += (long)L.kp * L.np;
    b += L.np;
    if (L.kp % BN || L.np % BN || L.kh % BN) return false;
    if (i > 0 && L.kh != net->l[i - 1].np) return false;
    if (L.kp != L.kh + (L.skip || i == 0 ? pe_w : 0)) return false;
    net->max_np = L.np > net->max_np ? L.np : net->max_np;
    net->max_kp = L.kp > net->max_kp ? L.kp : net->max_kp;
  }
  net->w_total = w;
  net->b_total = b;
  return true;
}

// ----- tier "highest" on any other net (route ROUTE_GEMM) -----

struct Scratch {
  float* in[MAX_LAYERS];
  float* a[MAX_LAYERS];
  float *g0, *g1, *ebar, *wpart, *bpart;
};

// rows_total = rows (K1) or 2 rows (K2); returns the float count.
size_t carve(const Net& net, long rows_total, int splits, float* base, Scratch* s) {
  size_t off = 0;
  for (int i = 0; i < net.n; ++i) {
    if (s) s->in[i] = base + off;
    off += rows_total * net.l[i].kp;
    if (s) s->a[i] = base + off;
    off += rows_total * net.l[i].np;
  }
  if (s) s->g0 = base + off;
  off += rows_total * net.max_np;
  if (s) s->g1 = base + off;
  off += rows_total * net.max_np;
  if (s) s->ebar = base + off;
  off += rows_total * net.pe_w;
  if (s) s->wpart = base + off;
  off += (size_t)splits * net.max_kp * net.max_np;
  if (s) s->bpart = base + off;
  off += (size_t)splits * net.max_np;
  return off;
}

void gemm(const GemmArgs& g, int splits, cudaStream_t st) {
  gemm_kernel<<<dim3(g.N / BN, g.M / BM, splits), NT, 0, st>>>(g);
}

GemmArgs row_gemm(const float* A, long lda, const float* B, long sbk, long sbn, int M, int N,
                  int K, float alpha, const Epi& e) {
  GemmArgs g = {};
  g.A = A; g.sam = lda; g.sak = 1;
  g.B = B; g.sbk = sbk; g.sbn = sbn;
  g.M = M; g.N = N; g.K = K; g.k_chunk = K;
  g.alpha = alpha;
  g.epi = e;
  return g;
}

// Embedding of x (and its tangent) into layer 0's input and the e-part of
// every skip layer's input.
void embed(const Net& net, const Scratch& s, const float* x, int rows, int multires, float scale,
           const float* gbar, long tan_rows, cudaStream_t st) {
  const int tb = 128, nb = (rows + tb - 1) / tb;
  for (int i = 0; i < net.n; ++i) {
    if (i > 0 && !net.l[i].skip) continue;
    const Layer& L = net.l[i];
    float* dst = s.in[i] + L.kh;
    pe_kernel<<<nb, tb, 0, st>>>(x, rows, multires, scale, net.pe_w, dst, L.kp, gbar,
                                 gbar ? dst + tan_rows * L.kp : nullptr);
  }
}

// Forward sweep over the rows [row0, row0 + rows) of every buffer. With
// tangent, these are the tangent rows and the primal rows start at 0.
void forward_sweep(const Net& net, const Scratch& s, const float* w, const float* b, int rows,
                   long row0, bool tangent, cudaStream_t st) {
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    Epi e = {};
    e.mode = EPI_FWD;
    e.c = s.a[i] + row0 * L.np;
    e.ldc = L.np;
    e.bias = tangent ? nullptr : b + L.b_off;
    if (i + 1 < net.n) {
      e.h = s.in[i + 1] + row0 * net.l[i + 1].kp;
      e.ldh = net.l[i + 1].kp;
    }
    if (tangent) {
      e.aprim = s.a[i];
      e.lda = L.np;
    }
    gemm(row_gemm(s.in[i] + row0 * L.kp, L.kp, w + L.w_off, L.np, 1, rows, L.np, L.kp, L.alpha, e),
         1, st);
  }
}

void forward_f32(const Net& net, const float* xf, const float* w, const float* b, int multires,
                 float scale, int head, int d_out, int rows, float* udf, float* feat, float* grad,
                 float* scratch, cudaStream_t st) {
  Scratch s;
  carve(net, rows, 0, scratch, &s);
  embed(net, s, xf, rows, multires, scale, nullptr, 0, st);
  forward_sweep(net, s, w, b, rows, 0, false, st);

  const Layer& last = net.l[net.n - 1];
  float *gc = s.g0, *gn = s.g1;
  const long cnt = (long)rows * last.np;
  head_fwd_kernel<<<(cnt + 255) / 256, 256, 0, st>>>(s.a[net.n - 1], rows, last.np, d_out, head,
                                                     scale, udf, feat, gc);
  cudaMemsetAsync(s.ebar, 0, sizeof(float) * rows * net.pe_w, st);
  for (int i = net.n - 1; i >= 0; --i) {
    const Layer& L = net.l[i];
    Epi e = {};
    e.mode = EPI_BWD_T;
    e.kh = L.kh;
    e.ebar = s.ebar;
    e.lde = net.pe_w;
    if (i > 0) {
      e.aprim = s.a[i - 1];
      e.lda = L.kh;
      e.gt = gn;
      e.ldg = L.kh;
    }
    gemm(row_gemm(gc, L.np, w + L.w_off, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, st);
    float* tmp = gc; gc = gn; gn = tmp;
  }
  pe_vjp_kernel<<<(rows + 127) / 128, 128, 0, st>>>(xf, rows, multires, scale, s.ebar, nullptr,
                                                    nullptr, net.pe_w, grad);
}

void backward_f32(const Net& net, const float* xf, const float* wf, const float* b, int multires,
                  float scale, int head, int d_out, int rows, const float* ubar, const float* fbar,
                  const float* gbar, float* xbar, float* wbar, float* bbar, float* scratch,
                  int splits, cudaStream_t st) {
  Scratch s;
  const long R = rows;
  const int pe_w = net.pe_w;
  carve(net, 2 * R, splits, scratch, &s);

  embed(net, s, xf, rows, multires, scale, gbar, R, st);
  forward_sweep(net, s, wf, b, rows, 0, false, st);
  forward_sweep(net, s, wf, b, rows, R, true, st);

  const Layer& last = net.l[net.n - 1];
  float *gc = s.g0, *gn = s.g1;
  const long cnt = R * last.np;
  head_bwd_kernel<<<(cnt + 255) / 256, 256, 0, st>>>(s.a[net.n - 1], rows, last.np, d_out, head,
                                                     scale, ubar, fbar, gc);
  cudaMemsetAsync(s.ebar, 0, sizeof(float) * 2 * R * pe_w, st);
  // split-K for the weight cotangent: K = 2R rows in chunks of 32
  const long k_total = 2 * R;
  const int k_chunk = (int)(((k_total + splits - 1) / splits + BK - 1) / BK * BK);
  const int w_splits = (int)((k_total + k_chunk - 1) / k_chunk);
  const int b_chunk = (rows + splits - 1) / splits;

  for (int i = net.n - 1; i >= 0; --i) {
    const Layer& L = net.l[i];
    const float* wl = wf + L.w_off;
    Epi e = {};
    e.kh = L.kh;
    e.lde = pe_w;
    if (i > 0) {
      e.lda = L.kh;
      e.ldg = L.kh;
    }
    // tangent rows: gamma_{l-1}, the second-derivative part of abar_{l-1}, eps
    e.mode = EPI_BWD_T;
    e.ebar = s.ebar + R * pe_w;
    if (i > 0) {
      e.aprim = s.a[i - 1];
      e.atan = s.a[i - 1] + R * L.kh;
      e.gt = gn + R * L.kh;
      e.gp = gn;
    }
    gemm(row_gemm(gc + R * L.np, L.np, wl, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, st);
    // primal rows: abar_{l-1} += sigma(100 a) (abar W^T)|h, ebar
    e.mode = EPI_BWD_P;
    e.ebar = s.ebar;
    e.atan = nullptr;
    e.gt = nullptr;
    gemm(row_gemm(gc, L.np, wl, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, st);
    // W̄ = alpha [in; t_in]^T [abar; gamma], split-K partials then a reduction
    GemmArgs g = {};
    g.A = s.in[i]; g.sam = 1; g.sak = L.kp;
    g.B = gc; g.sbk = L.np; g.sbn = 1;
    g.M = L.kp; g.N = L.np; g.K = (int)k_total; g.k_chunk = k_chunk;
    g.alpha = L.alpha;
    g.c_split = (long)L.kp * L.np;
    g.epi.mode = EPI_STORE;
    g.epi.c = s.wpart;
    g.epi.ldc = L.np;
    gemm(g, w_splits, st);
    const long wcnt = (long)L.kp * L.np;
    reduce_kernel<<<(wcnt + 255) / 256, 256, 0, st>>>(s.wpart, w_splits, wcnt, wbar + L.w_off);
    // b̄ = sum of abar over the primal rows
    colsum_kernel<<<dim3((L.np + 127) / 128, splits), 128, 0, st>>>(gc, rows, L.np, b_chunk,
                                                                   s.bpart);
    reduce_kernel<<<(L.np + 255) / 256, 256, 0, st>>>(s.bpart, splits, L.np, bbar + L.b_off);
    float* tmp = gc; gc = gn; gn = tmp;
  }
  pe_vjp_kernel<<<(rows + 127) / 128, 128, 0, st>>>(xf, rows, multires, scale, s.ebar + R * pe_w,
                                                    s.ebar, gbar, pe_w, xbar);
}

// ----- tier "default" -----

// The sweeps take the widths they were written for: a 64-wide embedding
// first, 256-wide hidden layers, skips into hidden layers, a 320-wide head;
// rows in whole tiles (128 on ROUTE_SWEEP, 64 on ROUTE_TF32X3).
bool sweep_takes(const Net& net, int multires, int rows, int row_tile) {
  if (net.n < 2 || net.n > F_MAX_LAYERS || net.pe_w != PE_W || 3 + 6 * multires > PE_W)
    return false;
  if (rows <= 0 || rows % row_tile) return false;
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    if (L.kh != (i == 0 ? 0 : WIDTH)) return false;
    if (L.np != (i == net.n - 1 ? WIDTH + 64 : WIDTH)) return false;
    if (i == net.n - 1 && L.skip) return false;
  }
  return true;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

struct FastScratch {
  __nv_bfloat16* w16;
  uint4* spill;
  uint8_t *xbuf, *gbuf;
  float *part, *bpart;
  int grid, n_tiles, nx_slots, ng_slots;
};

size_t round256(size_t v) { return (v + 255) / 256 * 256; }

// byte count; fills fs when base is given
size_t carve_fast(const Net& net, int rows, bool backward, int splits, uint8_t* base,
                  FastScratch* fs) {
  FastScratch f = {};
  f.n_tiles = rows / (backward ? 64 : 128);
  const int sms = sm_count();
  f.grid = f.n_tiles < sms ? f.n_tiles : sms;
  f.nx_slots = 1 + 4 * (net.n - 1);
  f.ng_slots = 4 * (net.n - 1) + 5;
  size_t off = 0;
  f.w16 = (__nv_bfloat16*)(base + off);
  off += round256(4 * (size_t)net.w_total);
  f.spill = (uint4*)(base + off);
  off += (size_t)f.grid * (net.n - 1) * 16 * FT * 16;
  if (backward) {
    f.xbuf = base + off;
    off += (size_t)f.n_tiles * f.nx_slots * PANEL;
    f.gbuf = base + off;
    off += (size_t)f.n_tiles * f.ng_slots * PANEL;
    f.part = (float*)(base + off);
    off += round256(4 * (size_t)splits * net.w_total);
    f.bpart = (float*)(base + off);
    off += round256(4 * (size_t)f.grid * net.b_total);
  }
  if (fs) *fs = f;
  return off;
}

void add_slices(SweepArgs* a, long off, int ld, int rows, int nk) {
  for (int j = 0; j < nk && a->n_slices < MAX_SLICES; ++j) {
    Slice& s = a->s[a->n_slices++];
    s.off = (uint32_t)(off + 64 * j);
    s.ld = (uint16_t)ld;
    s.rows = (uint16_t)rows;
  }
}

// The layers and the order in which sweep_kernel<backward> consumes weight
// slices: forward W_l^T, the head, then the reverse sweep's W_l.
void fill_sweep(const Net& net, bool backward, SweepArgs* a) {
  a->n_layers = net.n;
  a->b_total = (int)net.b_total;
  a->wt_off = net.w_total;
  a->n_slices = 0;
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    FLayer& F = a->l[i];
    F.np = L.np; F.skip = L.skip; F.alpha = L.alpha;
    F.b_off = (int)L.b_off; F.w_off = (int)L.w_off;
    F.xslot = i == 0 ? 0 : 1 + 4 * (i - 1);
    F.gslot = 4 * i;
  }
  const Layer& H = net.l[net.n - 1];
  for (int i = 0; i < net.n - 1; ++i)
    add_slices(a, net.w_total + net.l[i].w_off, net.l[i].kp, WIDTH, net.l[i].kp / 64);
  if (backward) {
    add_slices(a, net.w_total + H.w_off, H.kp, 64, H.kp / 64);
  } else {
    add_slices(a, net.w_total + H.w_off + (long)WIDTH * H.kp, H.kp, 64, H.kp / 64);
    add_slices(a, net.w_total + H.w_off, H.kp, WIDTH, H.kp / 64);
  }
  for (int i = backward ? net.n - 1 : net.n - 2; i >= 0; --i) {
    const Layer& L = net.l[i];
    if (i == 0 || L.skip) add_slices(a, L.w_off + (long)L.kh * L.np, L.np, 64, L.np / 64);
    if (i > 0) add_slices(a, L.w_off, L.np, WIDTH, L.np / 64);
  }
}

void pack_weights(const Net& net, const float* w, __nv_bfloat16* w16, cudaStream_t st) {
  PackArgs p = {};
  p.n = net.n;
  for (int i = 0; i < net.n; ++i) {
    p.kp[i] = net.l[i].kp;
    p.np[i] = net.l[i].np;
    p.w_off[i] = net.l[i].w_off;
  }
  p.w_off[net.n] = net.w_total;
  pack_bf16_kernel<<<(unsigned)((net.w_total + 255) / 256), 256, 0, st>>>(w, w16, p);
}

// the output tiles of the grouped weight-cotangent GEMM
int fill_items(const Net& net, const SweepArgs& a, WItem* items) {
  int n = 0;
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    const int m_panels = L.kp / 64;
    for (int mp = 0; mp < m_panels; mp += 2) {
      for (int n0 = 0; n0 < L.np; n0 += WIDTH) {
        if (n >= MAX_ITEMS) return -1;
        WItem& I = items[n++];
        // panel j of layer i's input: the h panels, then the embedding's
        auto slot = [&](int j) { return j < L.kh / 64 ? a.l[i].xslot + j : 0; };
        I.xs0 = slot(mp);
        I.xs1 = mp + 1 < m_panels ? slot(mp + 1) : -1;
        I.gs0 = a.l[i].gslot + n0 / 64;
        I.n = L.np - n0 >= WIDTH ? WIDTH : 64;
        I.w_off = (int)L.w_off;
        I.np = L.np;
        I.m0 = 64 * mp;
        I.n0 = n0;
        I.alpha = L.alpha;
      }
    }
  }
  return n;
}

// ----- tiers "highest" and "high" on the sweeps' nets (routes ROUTE_TF32X3, ROUTE_BF16X3) -----

struct X32Scratch {
  float* wpk;
  float4* spill;
  uint8_t *xbuf, *gbuf;
  float *part, *bpart;
  int grid, n_tiles, nx_slots, ng_slots;
};

// The products in the order sweep32_kernel<backward, mode> consumes them
// (forward W^T slices, the head, then the reverse sweep's W slices), how
// pack32_kernel fills them, and each layer's panel slots of the weight
// cotangent: ROUTE_TF32X3 dumps f32 [64 x 32] panels (the embedding's once,
// in slots 0 and 1); ROUTE_BF16X3 writes a hi and a lo [64 x 64] bf16 panel
// of every 64 columns of each layer's input (the embedding's for layer 0 and
// again, after its alpha, for each skip layer) and one of its cotangent.
// Returns the floats of the packed buffer; sets *nx, *ng to the slots.
long fill_sweep32(const Net& net, bool backward, int d_out, int multires, int mode,
                  Sweep32Args* a, Pack32Args* p, int* nx, int* ng) {
  const int ks = mode == ROUTE_BF16X3 ? 16 : 8;  // columns a k-step
  int n = 0;
  long dst = 0;
  auto add = [&](const Layer& L, int trans, int kbase, int n0, int rows, int steps, int acol) {
    XSeg& s = a->s[n];
    s.off = (uint32_t)dst;
    s.rows = (uint16_t)rows;
    s.steps = (uint8_t)steps;
    s.acol = (uint8_t)(acol / ks);
    p->s[n] = {(int)L.w_off, L.np, trans, kbase, n0, rows, steps, (int)dst};
    dst += (long)steps * rows * 16;
    ++n;
  };
  a->n_layers = net.n;
  a->b_total = (int)net.b_total;
  int xs = 0, gs = 0;
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    FLayer& F = a->l[i];
    F.np = L.np; F.skip = L.skip; F.alpha = L.alpha;
    F.b_off = (int)L.b_off; F.w_off = (int)L.w_off;
    if (mode == ROUTE_BF16X3) {
      F.xslot = xs;
      F.gslot = gs;
      xs += 2 * L.kp / 64;
      gs += L.np / 64;
    } else {
      F.xslot = i == 0 ? 0 : 2 + 8 * (i - 1);
      F.gslot = 8 * i;
      xs = 2 + 8 * i;
      gs = 8 * i + X_PANELS;
    }
  }
  *nx = xs;
  *ng = gs;
  const int ne = (3 + 6 * multires + ks - 1) / ks;  // k-steps of the embedding's real columns
  for (int i = 0; i < net.n - 1; ++i) {
    const Layer& L = net.l[i];
    if (i > 0) add(L, 0, 0, 0, WIDTH, L.kh / ks, 0);
    if (i == 0 || L.skip) add(L, 0, L.kh, 0, WIDTH, ne, WIDTH);
  }
  const Layer& H = net.l[net.n - 1];
  if (backward) {
    add(H, 0, 0, 0, 64, H.kp / ks, 0);
  } else {
    add(H, 0, 0, WIDTH, 64, H.kp / ks, 0);
    add(H, 0, 0, 0, WIDTH, H.kp / ks, 0);
  }
  for (int i = backward ? net.n - 1 : net.n - 2; i >= 0; --i) {
    const Layer& L = net.l[i];
    const int kg = i == net.n - 1 ? (d_out + ks - 1) / ks : L.np / ks;  // G's columns, over ks
    if (i == 0 || L.skip) add(L, 1, 0, L.kh, 64, kg, 0);
    if (i > 0) add(L, 1, 0, 0, WIDTH, kg, 0);
  }
  a->n_segs = n;
  p->n = n;
  return dst;
}

// byte count; fills fs when base is given
size_t carve_x32(const Net& net, int rows, bool backward, int splits, int d_out, int multires,
                 int mode, uint8_t* base, X32Scratch* fs) {
  Sweep32Args a = {};
  Pack32Args p = {};
  X32Scratch f = {};
  const long packed =
      fill_sweep32(net, backward, d_out, multires, mode, &a, &p, &f.nx_slots, &f.ng_slots);
  const size_t panel = mode == ROUTE_BF16X3 ? XB_PANEL : XPANEL;
  f.n_tiles = rows / (backward ? 32 : 64);
  const int sms = sm_count();
  f.grid = f.n_tiles < sms ? f.n_tiles : sms;
  size_t off = 0;
  f.wpk = (float*)(base + off);
  off += round256(4 * (size_t)packed);
  f.spill = (float4*)(base + off);
  off += (size_t)f.grid * (net.n - 1) * 16 * FT * 16;
  if (backward) {
    f.xbuf = base + off;
    off += (size_t)f.n_tiles * f.nx_slots * panel;
    f.gbuf = base + off;
    off += (size_t)f.n_tiles * f.ng_slots * panel;
    f.part = (float*)(base + off);  // bf16x3: the hh partials, then the lh ones
    off += round256(4 * (size_t)splits * net.w_total * (mode == ROUTE_BF16X3 ? 2 : 1));
    f.bpart = (float*)(base + off);
    off += round256(4 * (size_t)f.grid * net.b_total);
  }
  if (fs) *fs = f;
  return off;
}

// the output tiles of wgrad32_kernel: 128 X columns (64 for the embedding)
// by 128 G columns (the head's last 64 apart)
int fill_items32(const Net& net, const Sweep32Args& a, XItem* items) {
  int n = 0;
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    const int h_pan = L.kh / 32;
    for (int mt = 0; mt <= h_pan; mt += 4) {
      const bool e_tile = mt == h_pan;
      if (e_tile && !(i == 0 || L.skip)) break;
      for (int n0 = 0; n0 < L.np; n0 += 128) {
        if (n >= MAX_ITEMS) return -1;
        XItem& I = items[n++];
        I.xs0 = e_tile ? 0 : a.l[i].xslot + mt;
        I.xs1 = !e_tile && mt + 2 < h_pan ? a.l[i].xslot + mt + 2 : -1;
        I.gs0 = a.l[i].gslot + n0 / 32;
        I.n = L.np - n0 >= 128 ? 128 : 64;
        I.w_off = (int)L.w_off;
        I.np = L.np;
        I.m0 = e_tile ? L.kh : 32 * mt;
        I.n0 = n0;
        I.alpha = L.alpha;
      }
    }
  }
  return n;
}

// the output tiles of wgrad_kernel on route bf16x3: the 64 X columns of one
// hi panel (warpgroup 0) and its lo panel (warpgroup 1) by 256 G columns
// (the head's last 64 apart); alpha is in the panels already
int fill_items3(const Net& net, const Sweep32Args& a, WItem* items) {
  int n = 0;
  for (int i = 0; i < net.n; ++i) {
    const Layer& L = net.l[i];
    for (int mp = 0; mp < L.kp / 64; ++mp) {
      for (int n0 = 0; n0 < L.np; n0 += WIDTH) {
        if (n >= MAX_ITEMS) return -1;
        WItem& I = items[n++];
        I.xs0 = a.l[i].xslot + 2 * mp;
        I.xs1 = I.xs0 + 1;
        I.gs0 = a.l[i].gslot + n0 / 64;
        I.n = L.np - n0 >= WIDTH ? WIDTH : 64;
        I.w_off = (int)L.w_off;
        I.np = L.np;
        I.m0 = 64 * mp;
        I.n0 = n0;
        I.alpha = 1.f;
      }
    }
  }
  return n;
}

template <int MODE>
int forward_x32(const Net& net, const float* x, const float* w, const float* b, int multires,
                float scale, int head, int d_out, int rows, float* udf, float* feat, float* grad,
                uint8_t* scratch, cudaStream_t st) {
  constexpr bool B3 = MODE == ROUTE_BF16X3;
  X32Scratch fs;
  carve_x32(net, rows, false, 0, d_out, multires, MODE, scratch, &fs);
  Sweep32Args a = {};
  Pack32Args p = {};
  int nx, ng;
  const long packed = fill_sweep32(net, false, d_out, multires, MODE, &a, &p, &nx, &ng);
  const long items = B3 ? packed : packed / 2;  // weights packed: 16 or 8 in 16 floats
  pack32_kernel<B3><<<(unsigned)((items + 255) / 256), 256, 0, st>>>(w, fs.wpk, p);
  a.x = x; a.b = b; a.w = w; a.wpk = fs.wpk;
  a.multires = multires; a.head = head; a.d_out = d_out; a.scale = scale;
  a.n_tiles = fs.n_tiles;
  a.udf = udf; a.feat = feat; a.grad = grad;
  a.spill = fs.spill;
  sweep32_kernel<false, MODE><<<fs.grid, FT, SWEEP32_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int backward_x32(const Net& net, const float* x, const float* w, const float* b, int multires,
                 float scale, int head, int d_out, int rows, const float* ubar, const float* fbar,
                 const float* gbar, float* xbar, float* wbar, float* bbar, uint8_t* scratch,
                 int splits, cudaStream_t st) {
  constexpr bool B3 = MODE == ROUTE_BF16X3;
  X32Scratch fs;
  carve_x32(net, rows, true, splits, d_out, multires, MODE, scratch, &fs);
  Sweep32Args a = {};
  Pack32Args p = {};
  int nx, ng;
  const long packed = fill_sweep32(net, true, d_out, multires, MODE, &a, &p, &nx, &ng);
  Wgrad32Args g32 = {};
  WgradArgs g3 = {};
  const int n_items = B3 ? fill_items3(net, a, g3.item) : fill_items32(net, a, g32.item);
  if (n_items < 0) return cudaErrorInvalidValue;
  const long items = B3 ? packed : packed / 2;
  pack32_kernel<B3><<<(unsigned)((items + 255) / 256), 256, 0, st>>>(w, fs.wpk, p);
  a.x = x; a.b = b; a.w = w; a.wpk = fs.wpk;
  a.multires = multires; a.head = head; a.d_out = d_out; a.scale = scale;
  a.n_tiles = fs.n_tiles; a.nx_slots = fs.nx_slots; a.ng_slots = fs.ng_slots;
  a.ubar = ubar; a.fbar = fbar; a.gbar = gbar;
  a.xbar = xbar; a.bpart = fs.bpart;
  a.xbuf = fs.xbuf; a.gbuf = fs.gbuf; a.spill = fs.spill;
  sweep32_kernel<true, MODE><<<fs.grid, FT, SWEEP32_SMEM, st>>>(a);
  if (B3) {
    g3.xbuf = fs.xbuf; g3.gbuf = fs.gbuf; g3.part = fs.part; g3.w_total = net.w_total;
    g3.nx_slots = fs.nx_slots; g3.ng_slots = fs.ng_slots; g3.n_tiles = fs.n_tiles;
    g3.lo_off = (long)splits * net.w_total;
    wgrad_kernel<true><<<dim3(n_items, splits), FT, WGRAD_SMEM, st>>>(g3);
    reduce3_kernel<<<(unsigned)((net.w_total + 255) / 256), 256, 0, st>>>(
        fs.part, g3.lo_off, splits, net.w_total, wbar);
  } else {
    g32.xbuf = fs.xbuf; g32.gbuf = fs.gbuf; g32.part = fs.part; g32.w_total = net.w_total;
    g32.nx_slots = fs.nx_slots; g32.ng_slots = fs.ng_slots; g32.n_tiles = fs.n_tiles;
    wgrad32_kernel<<<dim3(n_items, splits), FT, WGRAD32_SMEM, st>>>(g32);
    reduce_kernel<<<(unsigned)((net.w_total + 255) / 256), 256, 0, st>>>(fs.part, splits,
                                                                         net.w_total, wbar);
  }
  reduce_kernel<<<(unsigned)((net.b_total + 255) / 256), 256, 0, st>>>(fs.bpart, fs.grid,
                                                                       net.b_total, bbar);
  return (int)cudaGetLastError();
}

// ----- K5 -----

// Where the packed weights lie: W_l^T [WIDTH x kp] of each hidden layer at
// t_off[l] (bf16), the head's column 0 at t_off[n - 1], then from w_bytes
// on the f32 biases, WIDTH a hidden layer, and the head's b[0].
struct VPack {
  long t_off[F_MAX_LAYERS];
  size_t w_bytes, bytes;
};

// K5 takes the nets K1's "default" sweeps take.
bool value_layout(const Net& net, int multires, VPack* vp) {
  if (!sweep_takes(net, multires, 128, 128)) return false;
  long t = 0;
  for (int i = 0; i < net.n - 1; ++i) {
    vp->t_off[i] = t;
    t += (long)WIDTH * net.l[i].kp;
  }
  vp->t_off[net.n - 1] = t;
  vp->w_bytes = round256(2 * (size_t)(t + WIDTH));
  vp->bytes = vp->w_bytes + round256(4 * ((size_t)(net.n - 1) * WIDTH + 1));
  return true;
}

}  // namespace

// K5's dynamic shared memory limit, set once per device.
static cudaError_t set_value_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(value_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)VALUE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(value_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)VALUE_SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The sweeps' dynamic shared memory limits, set once per device (at the
// first launch, which precedes any graph capture of it), not at every launch.
static cudaError_t set_smem_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(sweep_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SWEEP_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SWEEP_SMEM);
  const void* wgrads[] = {(const void*)wgrad_kernel<false>, (const void*)wgrad_kernel<true>};
  for (const void* k : wgrads)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WGRAD_SMEM);
  const void* sweeps32[] = {(const void*)sweep32_kernel<false, ROUTE_TF32X3>,
                            (const void*)sweep32_kernel<true, ROUTE_TF32X3>,
                            (const void*)sweep32_kernel<false, ROUTE_BF16X3>,
                            (const void*)sweep32_kernel<true, ROUTE_BF16X3>};
  for (const void* k : sweeps32)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SWEEP32_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgrad32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)WGRAD32_SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

extern "C" {

// Bytes of scratch one call needs on route (ROUTE_*); 0 if the route does
// not take this net or row count.
size_t fd_scratch_bytes(int n_layers, const void* dims, int pe_w, int multires, int rows,
                        int backward, int splits, int d_out, int route) {
  Net net;
  if (!make_net(n_layers, (const int*)dims, pe_w, &net)) return 0;
  if (route == ROUTE_SWEEP || route == ROUTE_TF32X3 || route == ROUTE_BF16X3) {
    if (!sweep_takes(net, multires, rows, route == ROUTE_SWEEP ? 128 : 64) || splits < 1 ||
        d_out <= WIDTH)
      return 0;
    if (route == ROUTE_SWEEP) return carve_fast(net, rows, backward != 0, splits, nullptr, nullptr);
    return carve_x32(net, rows, backward != 0, splits, d_out, multires, route, nullptr, nullptr);
  }
  if (rows % BM || route != ROUTE_GEMM) return 0;
  return sizeof(float) * carve(net, backward ? 2L * rows : rows, backward ? splits : 0, nullptr,
                               nullptr);
}

// K1. x [rows,3] (rows a multiple of 64, of 128 on the sweeps); outputs
// udf [rows,1], feat [rows,d_out-1], grad [rows,3].
int fd_forward(const void* x, const void* w, const void* b, int n_layers, const void* dims,
               int pe_w, int multires, float scale, int head, int d_out, int rows, int route,
               void* udf, void* feat, void* grad, void* scratch, void* stream) {
  Net net;
  if (rows % BM || !make_net(n_layers, (const int*)dims, pe_w, &net)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == ROUTE_GEMM) {
    forward_f32(net, (const float*)x, (const float*)w, (const float*)b, multires, scale, head,
                d_out, rows, (float*)udf, (float*)feat, (float*)grad, (float*)scratch, st);
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_SWEEP && route != ROUTE_TF32X3 && route != ROUTE_BF16X3)
    return cudaErrorInvalidValue;
  if (!sweep_takes(net, multires, rows, route == ROUTE_SWEEP ? 128 : 64) ||
      d_out > net.l[net.n - 1].np || d_out <= WIDTH)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem_attributes();
  if (err != cudaSuccess) return (int)err;
  if (route == ROUTE_TF32X3)
    return forward_x32<ROUTE_TF32X3>(net, (const float*)x, (const float*)w, (const float*)b,
                                     multires, scale, head, d_out, rows, (float*)udf,
                                     (float*)feat, (float*)grad, (uint8_t*)scratch, st);
  if (route == ROUTE_BF16X3)
    return forward_x32<ROUTE_BF16X3>(net, (const float*)x, (const float*)w, (const float*)b,
                                     multires, scale, head, d_out, rows, (float*)udf,
                                     (float*)feat, (float*)grad, (uint8_t*)scratch, st);
  FastScratch fs;
  carve_fast(net, rows, false, 0, (uint8_t*)scratch, &fs);
  pack_weights(net, (const float*)w, fs.w16, st);
  SweepArgs a = {};
  fill_sweep(net, false, &a);
  a.x = (const float*)x; a.b = (const float*)b; a.w16 = fs.w16;
  a.multires = multires; a.head = head; a.d_out = d_out; a.scale = scale;
  a.n_tiles = fs.n_tiles;
  a.udf = (float*)udf; a.feat = (float*)feat; a.grad = (float*)grad;
  a.spill = fs.spill;
  sweep_kernel<false><<<fs.grid, FT, SWEEP_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// K2. Cotangents ubar [rows,1], fbar [rows,d_out-1], gbar [rows,3];
// outputs x̄ [rows,3], W̄ and b̄ packed like w and b.
int fd_backward(const void* x, const void* w, const void* b, int n_layers, const void* dims,
                int pe_w, int multires, float scale, int head, int d_out, int rows, int route,
                const void* ubar, const void* fbar, const void* gbar, void* xbar, void* wbar,
                void* bbar, void* scratch, int splits, void* stream) {
  Net net;
  if (rows % BM || splits < 1 || !make_net(n_layers, (const int*)dims, pe_w, &net))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == ROUTE_GEMM) {
    backward_f32(net, (const float*)x, (const float*)w, (const float*)b, multires, scale, head,
                 d_out, rows, (const float*)ubar, (const float*)fbar, (const float*)gbar,
                 (float*)xbar, (float*)wbar, (float*)bbar, (float*)scratch, splits, st);
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_SWEEP && route != ROUTE_TF32X3 && route != ROUTE_BF16X3)
    return cudaErrorInvalidValue;
  if (!sweep_takes(net, multires, rows, route == ROUTE_SWEEP ? 128 : 64) ||
      d_out > net.l[net.n - 1].np || d_out <= WIDTH)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem_attributes();
  if (err != cudaSuccess) return (int)err;
  if (route == ROUTE_TF32X3)
    return backward_x32<ROUTE_TF32X3>(net, (const float*)x, (const float*)w, (const float*)b,
                                      multires, scale, head, d_out, rows, (const float*)ubar,
                                      (const float*)fbar, (const float*)gbar, (float*)xbar,
                                      (float*)wbar, (float*)bbar, (uint8_t*)scratch, splits, st);
  if (route == ROUTE_BF16X3)
    return backward_x32<ROUTE_BF16X3>(net, (const float*)x, (const float*)w, (const float*)b,
                                      multires, scale, head, d_out, rows, (const float*)ubar,
                                      (const float*)fbar, (const float*)gbar, (float*)xbar,
                                      (float*)wbar, (float*)bbar, (uint8_t*)scratch, splits, st);
  FastScratch fs;
  carve_fast(net, rows, true, splits, (uint8_t*)scratch, &fs);
  pack_weights(net, (const float*)w, fs.w16, st);
  SweepArgs a = {};
  fill_sweep(net, true, &a);
  a.x = (const float*)x; a.b = (const float*)b; a.w16 = fs.w16;
  a.multires = multires; a.head = head; a.d_out = d_out; a.scale = scale;
  a.n_tiles = fs.n_tiles; a.nx_slots = fs.nx_slots; a.ng_slots = fs.ng_slots;
  a.ubar = (const float*)ubar; a.fbar = (const float*)fbar; a.gbar = (const float*)gbar;
  a.xbar = (float*)xbar; a.bpart = fs.bpart;
  a.xbuf = fs.xbuf; a.gbuf = fs.gbuf; a.spill = fs.spill;
  sweep_kernel<true><<<fs.grid, FT, SWEEP_SMEM, st>>>(a);

  WgradArgs g = {};
  g.xbuf = fs.xbuf; g.gbuf = fs.gbuf; g.part = fs.part; g.w_total = net.w_total;
  g.nx_slots = fs.nx_slots; g.ng_slots = fs.ng_slots; g.n_tiles = fs.n_tiles;
  const int n_items = fill_items(net, a, g.item);
  if (n_items < 0) return cudaErrorInvalidValue;
  wgrad_kernel<false><<<dim3(n_items, splits), FT, WGRAD_SMEM, st>>>(g);
  reduce_kernel<<<(unsigned)((net.w_total + 255) / 256), 256, 0, st>>>(fs.part, splits,
                                                                       net.w_total, (float*)wbar);
  reduce_kernel<<<(unsigned)((net.b_total + 255) / 256), 256, 0, st>>>(fs.bpart, fs.grid,
                                                                       net.b_total, (float*)bbar);
  return (int)cudaGetLastError();
}

// K5. Bytes of the packed weights; 0 if K5 does not take the net.
size_t fd_value_pack_bytes(int n_layers, const void* dims, int pe_w, int multires) {
  Net net;
  VPack vp;
  if (!make_net(n_layers, (const int*)dims, pe_w, &net) || !value_layout(net, multires, &vp))
    return 0;
  return vp.bytes;
}

// K5's weight pack. v, g, b: n_layers device pointers each (g[l] null: no
// weight norm), their layers at the true widths n_true[l] out and d0 of the
// embedding.
int fd_value_pack(int n_layers, const void* dims, const void* n_true, int d0, int pe_w,
                  int multires, const void* v, const void* g, const void* b, void* packed,
                  void* stream) {
  Net net;
  VPack vp;
  if (!make_net(n_layers, (const int*)dims, pe_w, &net) || !value_layout(net, multires, &vp) ||
      d0 != 3 * (1 + 2 * multires))
    return cudaErrorInvalidValue;
  const int* nt = (const int*)n_true;
  VPackArgs a = {};
  a.n_layers = n_layers;
  a.d0 = d0;
  for (int i = 0; i < n_layers; ++i) {
    if (nt[i] < 1 || nt[i] > net.l[i].np) return cudaErrorInvalidValue;
    a.v[i] = ((const float* const*)v)[i];
    a.g[i] = ((const float* const*)g)[i];
    a.b[i] = ((const float* const*)b)[i];
    a.kp[i] = net.l[i].kp;
    a.n_true[i] = nt[i];
    a.skip[i] = net.l[i].skip;
    a.t_off[i] = vp.t_off[i];
  }
  a.w16 = (__nv_bfloat16*)packed;
  a.bias = (float*)((uint8_t*)packed + vp.w_bytes);
  value_pack_kernel<<<(n_layers - 1) * 8 + 1, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K5. x [n, 3] -> out [n], from fd_value_pack's packed weights; tiles of
// 128 rows where they fill the SMs, else of 64.
int fd_value(const void* x, int n, int n_layers, const void* dims, int pe_w, int multires,
             float scale, int head, const void* packed, void* out, void* stream) {
  Net net;
  VPack vp;
  if (n < 0 || !make_net(n_layers, (const int*)dims, pe_w, &net) ||
      !value_layout(net, multires, &vp))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaError_t err = set_value_smem();
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  const int tile_rows = (n + 127) / 128 >= sms ? 128 : 64;
  ValueArgs a = {};
  a.x = (const float*)x;
  a.w16 = (const __nv_bfloat16*)packed;
  a.wh = a.w16 + vp.t_off[n_layers - 1];
  a.bias = (const float*)((const uint8_t*)packed + vp.w_bytes);
  a.out = (float*)out;
  a.n = n;
  a.n_tiles = (n + tile_rows - 1) / tile_rows;
  a.n_layers = n_layers;
  a.multires = multires;
  a.head = head;
  a.scale = scale;
  for (int i = 0; i < n_layers - 1; ++i) {
    a.l[i].skip = net.l[i].skip;
    a.l[i].alpha = net.l[i].alpha;
    for (int j = 0; j < net.l[i].kp / 64; ++j) {
      if (a.n_slices >= MAX_SLICES) return cudaErrorInvalidValue;
      Slice& s = a.s[a.n_slices++];
      s.off = (uint32_t)(vp.t_off[i] + 64 * j);
      s.ld = (uint16_t)net.l[i].kp;
      s.rows = WIDTH;
    }
  }
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_rows == 128)
    value_kernel<128><<<grid, FT, VALUE_SMEM, st>>>(a);
  else
    value_kernel<64><<<grid, FT, VALUE_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

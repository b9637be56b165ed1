// Fused distance-field kernels for Hopper (sm_90a): K1 (forward) and K2
// (its second-order backward).
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
// (bf16, tier "default") or CUDA-core (f32, tier "highest") rate is the
// limit: 0.116 / 0.348 ms in bf16.
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
// Tier "highest" runs every product as one tiled f32 GEMM on the CUDA cores
// (gemm_kernel, 64x64 tiles) with the same fused epilogues, through a
// scratch buffer in device memory.
// Tier "high" (bf16x3, the TPU kernel's _dot3) takes the same route with
// gemm3_kernel: the same 64x64 tiles, each operand split on its way into
// shared memory into bf16 hi = bf16(v) and lo = bf16(v - hi), and the
// passes run as mma.sync m16n8k16 (bf16 x bf16 -> f32) into two
// accumulators, hi x hi and the lo terms. Which operands are split is what
// JAX's differentiation of _dot3 makes of each product: an activation or a
// tangent times W splits both (three passes); a cotangent times W^T keeps
// the cotangent in bf16 and splits W (two passes, P + bf16((S + P) - P));
// the weight cotangent splits [in; t_in] and keeps [abar; gamma] in bf16
// (two passes, H + bf16((L + H) - H) after the split-K sum, reduce3_kernel).
// Everything between the products stays f32, as in the TPU kernel. What
// bounds it is the same as "default"'s, at 2 to 3 passes a product; this
// first version does not pipeline its loads and does not reach that bound.
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

#define BM 64
#define BN 64
#define BK 32
#define NT 256
#define MAX_LAYERS 32

enum { EPI_STORE = 0, EPI_FWD = 1, EPI_BWD_T = 2, EPI_BWD_P = 3 };
enum { HEAD_ABS = 0, HEAD_SQUARE = 1, HEAD_SDF = 2 };
enum { TIER_HIGHEST = 0, TIER_DEFAULT = 1, TIER_HIGH = 2 };
// tier "high" products: activation x W (both split), cotangent x W^T (W
// split), [in; t_in]^T x [abar; gamma] (the left side split)
enum { P3_FWD = 0, P3_REV = 1, P3_WGRAD = 2 };

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
  int mode3;       // tier "high": P3_FWD, P3_REV or P3_WGRAD
  float a_scale;   // tier "high": A is scaled by it before the split
  long lo_off;     // tier "high", P3_WGRAD: offset of the lo partials
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

// ---------------------------------------------------------------------------
// tier "high": bf16x3 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

#define SK 40  // row stride (bf16) of an operand tile: 32 + 8 spreads the fragment loads over all banks

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b, a [16 x 16] row-major and b [16 x 8] column-major fragments
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C = A @ B over [k_begin, k_end) of this blockIdx.z in bf16x3 passes, then
// the epilogue: P3_FWD alpha (hh + lo terms); P3_REV alpha (hh + bf16((hl +
// hh) - hh)); P3_WGRAD stores the hh and lh partials (lo_off apart) for
// reduce3_kernel. Shapes as gemm_kernel's. Eight warps, each a 16 x 32
// piece of the 64 x 64 tile: four m16n8 accumulators a pass class.
__global__ void __launch_bounds__(NT) gemm3_kernel(GemmArgs g) {
  __shared__ __align__(16) uint8_t smem[2 * BM * (BN + 1) * 4];  // operand tiles, then C
  __nv_bfloat16* Ah = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][SK], k contiguous
  __nv_bfloat16* Al = Ah + BM * SK;
  __nv_bfloat16* Bh = Al + BM * SK;  // [BN][SK]: B transposed, k contiguous
  __nv_bfloat16* Bl = Bh + BN * SK;
  const bool a_lo = g.mode3 != P3_REV, b_lo = g.mode3 != P3_WGRAD;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * g.k_chunk;
  const int ke = min(g.K, kb + g.k_chunk);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32, gid = lane >> 2, tig = lane & 3;
  const bool a_kfast = g.sak == 1, b_nfast = g.sbn == 1;
  float acc0[4][4], acc1[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[j][i] = acc1[j][i] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = t; i < BM * BK; i += NT) {
      const int mm = a_kfast ? i / BK : i % BM, kk = a_kfast ? i % BK : i / BM;
      const float v = g.a_scale * g.A[(long)(m0 + mm) * g.sam + (long)(k0 + kk) * g.sak];
      const __nv_bfloat16 h = __float2bfloat16(v);
      Ah[mm * SK + kk] = h;
      if (a_lo) Al[mm * SK + kk] = __float2bfloat16(v - __bfloat162float(h));
    }
    for (int i = t; i < BK * BN; i += NT) {
      const int kk = b_nfast ? i / BN : i % BK, nn = b_nfast ? i % BN : i / BK;
      const float v = g.B[(long)(k0 + kk) * g.sbk + (long)(n0 + nn) * g.sbn];
      const __nv_bfloat16 h = __float2bfloat16(v);
      Bh[nn * SK + kk] = h;
      if (b_lo) Bl[nn * SK + kk] = __float2bfloat16(v - __bfloat162float(h));
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const int ao = (wm + gid) * SK + ks + 2 * tig;
      const uint32_t ah[4] = {ld32(Ah + ao), ld32(Ah + ao + 8 * SK), ld32(Ah + ao + 8),
                              ld32(Ah + ao + 8 * SK + 8)};
      uint32_t al[4] = {0u, 0u, 0u, 0u};
      if (a_lo) {
        al[0] = ld32(Al + ao); al[1] = ld32(Al + ao + 8 * SK);
        al[2] = ld32(Al + ao + 8); al[3] = ld32(Al + ao + 8 * SK + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bo = (wn + 8 * j + gid) * SK + ks + 2 * tig;
        const uint32_t bh0 = ld32(Bh + bo), bh1 = ld32(Bh + bo + 8);
        mma_bf16(acc0[j], ah, bh0, bh1);
        if (b_lo) mma_bf16(acc1[j], ah, ld32(Bl + bo), ld32(Bl + bo + 8));
        if (a_lo) mma_bf16(acc1[j], al, bh0, bh1);
      }
    }
    __syncthreads();
  }

  float (*C0)[BN + 1] = reinterpret_cast<float (*)[BN + 1]>(smem);
  float (*C1)[BN + 1] = C0 + BM;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + gid + (i >> 1) * 8, c = wn + 8 * j + 2 * tig + (i & 1);
      C0[r][c] = acc0[j][i];
      C1[r][c] = acc1[j][i];
    }
  __syncthreads();

  Epi e = g.epi;
  if (g.mode3 == P3_WGRAD) {
    float* c = e.c + (long)blockIdx.z * g.c_split;
    for (int i = t; i < BM * BN; i += NT) {
      const int r = i / BN, cc = i % BN;
      const long o = (long)(m0 + r) * e.ldc + n0 + cc;
      c[o] = C0[r][cc];
      c[g.lo_off + o] = C1[r][cc];
    }
    return;
  }
  for (int i = t; i < BM * BN; i += NT) {
    const int r = i / BN, cc = i % BN;
    const float h = C0[r][cc], l = C1[r][cc];
    // the reverse product is JAX's transpose of _dot3: the W_lo part's sum
    // passes the bf16 cast of hi + lo - hi
    const float v = g.mode3 == P3_FWD ? h + l : h + bf16r((l + h) - h);
    epilogue(e, m0 + r, n0 + cc, g.alpha * v);
  }
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
  out[i] = h + bf16r((l + h) - h);
}

// ---------------------------------------------------------------------------
// tier "default": bf16 wgmma sweeps with the activations in shared memory
// ---------------------------------------------------------------------------

#define FT 256           // threads of a block: two warpgroups
#define PANEL 16384      // bytes of a [128 x 64] bf16 operand panel
#define N_PANELS 5       // four h panels and the embedding's
#define STAGE 32768      // bytes of a ring stage: a [256 x 64] weight slice
#define N_STAGES 4
#define PREFETCH 2       // slices in flight ahead of the tensor cores
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

struct Slice {  // a [rows x 64] slice of the packed bf16 weights, row stride ld
  uint32_t off;
  uint16_t ld, rows;
};

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
  int xs0, xs1;  // X panel slots of the two warpgroups (xs1 < 0: none)
  int gs0, n;    // first G panel slot, tile width (256 or 64)
  int w_off, np, m0, n0;
  float alpha;
};

struct WgradArgs {
  const uint8_t *xbuf, *gbuf;
  float* part;
  long w_total;
  int nx_slots, ng_slots, n_tiles;
  WItem item[MAX_ITEMS];
};

struct PackArgs {
  int n;
  int kp[F_MAX_LAYERS], np[F_MAX_LAYERS];
  long w_off[F_MAX_LAYERS + 1];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes shared-memory writes of this thread visible to wgmma's reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands: rows
// of 128 bytes, 8-row groups sbo bytes apart (lbo unused). MN-major operands:
// 64 MN-elements a row, 8-row K groups sbo apart, 64-wide MN groups lbo apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// byte offset of element (row, col) of a 64-column bf16 panel
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// keeps the compiler from reading accumulators before wgmma_wait
template <int N>
__device__ __forceinline__ void acc_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

__device__ __forceinline__ void load_slice(const Slice* tab, int n_slices,
                                            const __nv_bfloat16* w16, uint32_t idx,
                                            uint32_t ring, int tid) {
  const Slice s = tab[idx % n_slices];
  const uint32_t dst = ring + (idx % N_STAGES) * STAGE;
  const __nv_bfloat16* src = w16 + s.off;
  for (int c = tid; c < s.rows * 8; c += FT) {
    const int row = c >> 3, ch = c & 7;
    cp_async16(dst + row * 128 + ((ch ^ (row & 7)) << 4), src + (long)row * s.ld + ch * 8);
  }
}

// Copies operand panels to device memory with one bulk copy of the async
// proxy, started by one thread after a fence_async and a barrier: no thread
// spends instructions on the bytes. bulk_reads_done() before the panels are
// written again.
__device__ __forceinline__ void dump_panels(uint32_t src, int panels, uint8_t* dst, int tid) {
  if (tid == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(src), "r"(panels * PANEL)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

__device__ __forceinline__ void bulk_reads_done(int tid) {
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// acc[64 x N] = A[64 x 64 nk] @ B^T over the next nk slices of the ring; A
// is this warpgroup's rows of the panels panel0 .. panel0 + nk - 1. Slice
// it + PREFETCH is loaded into the stage that slice it - 2 used: every thread
// has passed wgmma_wait<1> of iteration it - 1 before the barrier, so the
// products that read it are done (N_STAGES = PREFETCH + 2).
template <int N>
__device__ __forceinline__ void sweep_gemm(float* acc, uint32_t a_wg, int panel0, int nk,
                                           uint32_t ring, const Slice* tab, int n_slices,
                                           const __nv_bfloat16* w16, uint32_t& it, int tid) {
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<PREFETCH - 1>();
    fence_async();
    if (j == nk - 1) bulk_reads_done(tid);  // the epilogue may write the panels a dump reads
    __syncthreads();
    load_slice(tab, n_slices, w16, it + PREFETCH, ring, tid);
    cp_async_commit();
    const uint32_t sb = ring + (it % N_STAGES) * STAGE;
    const uint32_t sa = a_wg + (panel0 + j) * PANEL;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = make_desc(sa + kk * 32, 16, 1024);
      const uint64_t db = make_desc(sb + kk * 32, 16, 1024);
      if constexpr (N == 256) wgmma_n256<0, 0>(acc, da, db, (j | kk) != 0);
      else wgmma_n64<0, 0>(acc, da, db, (j | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    ++it;
  }
  wgmma_wait<0>();
  acc_fence<N / 2>(acc);
}

__device__ __forceinline__ void put(uint8_t* panel, int row, int col, float v) {
  *reinterpret_cast<__nv_bfloat16*>(panel + swz(row, col)) = __float2bfloat16(v);
}

__device__ __forceinline__ void put2(uint8_t* panels, int row, int col, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(panels + (col >> 6) * PANEL + swz(row, col & 63)) = pack2(lo, hi);
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
// operands MN-major. Partial sums go to part[blockIdx.y].
__global__ void __launch_bounds__(FT, 1) wgrad_kernel(const __grid_constant__ WgradArgs P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const WItem I = P.item[blockIdx.x];
  const int t0 = (int)((long)P.n_tiles * blockIdx.y / gridDim.y);
  const int t1 = (int)((long)P.n_tiles * (blockIdx.y + 1) / gridDim.y);
  const int n_steps = (t1 - t0) * 2;  // 64 rows of the tiles a step
  const int nm = I.xs1 >= 0 ? 2 : 1, n_pan = I.n / 64;
  const bool active = g < nm;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  auto load_step = [&](int step) {
    if (step < n_steps) {
      const size_t tile = t0 + (step >> 1);
      const uint32_t half = (step & 1) * (PANEL / 2);
      const uint32_t base = sbase + (step % N_STAGES) * WG_STAGE;
      for (int c = tid; c < (nm + n_pan) * 512; c += FT) {
        const int pn = c >> 9;
        const uint32_t o = (c & 511) * 16;
        const uint8_t* src =
            pn < nm ? P.xbuf + (tile * P.nx_slots + (pn ? I.xs1 : I.xs0)) * PANEL + half + o
                    : P.gbuf + (tile * P.ng_slots + I.gs0 + (pn - nm)) * PANEL + half + o;
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
  float* out = P.part + (size_t)blockIdx.y * P.w_total + I.w_off +
               (size_t)(I.m0 + g * 64 + wq * 16 + (lane >> 2)) * I.np + I.n0 + 2 * (lane & 3);
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

// ----- tiers "highest" and "high" -----

struct Scratch {
  float* in[MAX_LAYERS];
  float* a[MAX_LAYERS];
  float *g0, *g1, *ebar, *wpart, *bpart;
};

// rows_total = rows (K1) or 2 rows (K2); returns the float count. Tier
// "high" keeps two partials (hh and lh) of the weight cotangent a split.
size_t carve(const Net& net, long rows_total, int splits, bool high, float* base, Scratch* s) {
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
  off += (size_t)splits * net.max_kp * net.max_np * (high ? 2 : 1);
  if (s) s->bpart = base + off;
  off += (size_t)splits * net.max_np;
  return off;
}

// Tier "highest": gemm_kernel. Tier "high": gemm3_kernel in mode; alpha
// then scales A before the split (P3_FWD, P3_WGRAD: JAX divides the skip
// concat before its _dot3) or the result (P3_REV: after the transpose).
void gemm(GemmArgs g, int splits, bool high, int mode, cudaStream_t st) {
  const dim3 grid(g.N / BN, g.M / BM, splits);
  if (!high) {
    gemm_kernel<<<grid, NT, 0, st>>>(g);
    return;
  }
  g.mode3 = mode;
  g.a_scale = 1.f;
  if (mode != P3_REV) {
    g.a_scale = g.alpha;
    g.alpha = 1.f;
  }
  gemm3_kernel<<<grid, NT, 0, st>>>(g);
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
                   long row0, bool tangent, bool high, cudaStream_t st) {
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
         1, high, P3_FWD, st);
  }
}

void forward_f32(const Net& net, const float* xf, const float* w, const float* b, int multires,
                 float scale, int head, int d_out, int rows, float* udf, float* feat, float* grad,
                 float* scratch, bool high, cudaStream_t st) {
  Scratch s;
  carve(net, rows, 0, high, scratch, &s);
  embed(net, s, xf, rows, multires, scale, nullptr, 0, st);
  forward_sweep(net, s, w, b, rows, 0, false, high, st);

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
    gemm(row_gemm(gc, L.np, w + L.w_off, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, high, P3_REV,
         st);
    float* tmp = gc; gc = gn; gn = tmp;
  }
  pe_vjp_kernel<<<(rows + 127) / 128, 128, 0, st>>>(xf, rows, multires, scale, s.ebar, nullptr,
                                                    nullptr, net.pe_w, grad);
}

void backward_f32(const Net& net, const float* xf, const float* wf, const float* b, int multires,
                  float scale, int head, int d_out, int rows, const float* ubar, const float* fbar,
                  const float* gbar, float* xbar, float* wbar, float* bbar, float* scratch,
                  int splits, bool high, cudaStream_t st) {
  Scratch s;
  const long R = rows;
  const int pe_w = net.pe_w;
  carve(net, 2 * R, splits, high, scratch, &s);

  embed(net, s, xf, rows, multires, scale, gbar, R, st);
  forward_sweep(net, s, wf, b, rows, 0, false, high, st);
  forward_sweep(net, s, wf, b, rows, R, true, high, st);

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
    gemm(row_gemm(gc + R * L.np, L.np, wl, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, high,
         P3_REV, st);
    // primal rows: abar_{l-1} += sigma(100 a) (abar W^T)|h, ebar
    e.mode = EPI_BWD_P;
    e.ebar = s.ebar;
    e.atan = nullptr;
    e.gt = nullptr;
    gemm(row_gemm(gc, L.np, wl, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, high, P3_REV, st);
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
    g.lo_off = (long)splits * net.max_kp * net.max_np;
    gemm(g, w_splits, high, P3_WGRAD, st);
    const long wcnt = (long)L.kp * L.np;
    if (high)
      reduce3_kernel<<<(wcnt + 255) / 256, 256, 0, st>>>(s.wpart, g.lo_off, w_splits, wcnt,
                                                          wbar + L.w_off);
    else
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
// first, 256-wide hidden layers, skips into hidden layers, a 320-wide head.
bool sweep_takes(const Net& net, int multires, int rows) {
  if (net.n < 2 || net.n > F_MAX_LAYERS || net.pe_w != PE_W || 3 + 6 * multires > PE_W)
    return false;
  if (rows <= 0 || rows % 128) return false;
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

}  // namespace

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
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)WGRAD_SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

extern "C" {

// Bytes of scratch one call needs at tier (TIER_HIGHEST, TIER_DEFAULT,
// TIER_HIGH); 0 if the kernels do not take this net.
size_t fd_scratch_bytes(int n_layers, const void* dims, int pe_w, int multires, int rows,
                        int backward, int splits, int tier) {
  Net net;
  if (!make_net(n_layers, (const int*)dims, pe_w, &net)) return 0;
  if (tier == TIER_DEFAULT) {
    if (!sweep_takes(net, multires, rows) || splits < 1) return 0;
    return carve_fast(net, rows, backward != 0, splits, nullptr, nullptr);
  }
  if (rows % BM || (tier != TIER_HIGHEST && tier != TIER_HIGH)) return 0;
  return sizeof(float) * carve(net, backward ? 2L * rows : rows, backward ? splits : 0,
                               tier == TIER_HIGH, nullptr, nullptr);
}

// K1. x [rows,3] (rows a multiple of 64, of 128 at tier "default"); outputs
// udf [rows,1], feat [rows,d_out-1], grad [rows,3].
int fd_forward(const void* x, const void* w, const void* b, int n_layers, const void* dims,
               int pe_w, int multires, float scale, int head, int d_out, int rows, int tier,
               void* udf, void* feat, void* grad, void* scratch, void* stream) {
  Net net;
  if (rows % BM || !make_net(n_layers, (const int*)dims, pe_w, &net)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tier == TIER_HIGHEST || tier == TIER_HIGH) {
    forward_f32(net, (const float*)x, (const float*)w, (const float*)b, multires, scale, head,
                d_out, rows, (float*)udf, (float*)feat, (float*)grad, (float*)scratch,
                tier == TIER_HIGH, st);
    return (int)cudaGetLastError();
  }
  if (tier != TIER_DEFAULT) return cudaErrorInvalidValue;
  if (!sweep_takes(net, multires, rows) || d_out > net.l[net.n - 1].np) return cudaErrorInvalidValue;
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
  cudaError_t err = set_smem_attributes();
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<false><<<fs.grid, FT, SWEEP_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// K2. Cotangents ubar [rows,1], fbar [rows,d_out-1], gbar [rows,3];
// outputs x̄ [rows,3], W̄ and b̄ packed like w and b.
int fd_backward(const void* x, const void* w, const void* b, int n_layers, const void* dims,
                int pe_w, int multires, float scale, int head, int d_out, int rows, int tier,
                const void* ubar, const void* fbar, const void* gbar, void* xbar, void* wbar,
                void* bbar, void* scratch, int splits, void* stream) {
  Net net;
  if (rows % BM || splits < 1 || !make_net(n_layers, (const int*)dims, pe_w, &net))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tier == TIER_HIGHEST || tier == TIER_HIGH) {
    backward_f32(net, (const float*)x, (const float*)w, (const float*)b, multires, scale, head,
                 d_out, rows, (const float*)ubar, (const float*)fbar, (const float*)gbar,
                 (float*)xbar, (float*)wbar, (float*)bbar, (float*)scratch, splits,
                 tier == TIER_HIGH, st);
    return (int)cudaGetLastError();
  }
  if (tier != TIER_DEFAULT) return cudaErrorInvalidValue;
  if (!sweep_takes(net, multires, rows) || d_out > net.l[net.n - 1].np) return cudaErrorInvalidValue;
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
  cudaError_t err = set_smem_attributes();
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<true><<<fs.grid, FT, SWEEP_SMEM, st>>>(a);

  WgradArgs g = {};
  g.xbuf = fs.xbuf; g.gbuf = fs.gbuf; g.part = fs.part; g.w_total = net.w_total;
  g.nx_slots = fs.nx_slots; g.ng_slots = fs.ng_slots; g.n_tiles = fs.n_tiles;
  const int n_items = fill_items(net, a, g.item);
  if (n_items < 0) return cudaErrorInvalidValue;
  wgrad_kernel<<<dim3(n_items, splits), FT, WGRAD_SMEM, st>>>(g);
  reduce_kernel<<<(unsigned)((net.w_total + 255) / 256), 256, 0, st>>>(fs.part, splits,
                                                                       net.w_total, (float*)wbar);
  reduce_kernel<<<(unsigned)((net.b_total + 255) / 256), 256, 0, st>>>(fs.bpart, fs.grid,
                                                                       net.b_total, (float*)bbar);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// limit: 0.116 / 0.348 ms in bf16. The GEMMs below run every product at
// the padded widths, the head's included, so they do more than that.
//
// What this design does about it: every pass is one tiled GEMM (64x64
// tiles, wmma bf16 tensor-core fragments with f32 accumulation, or f32 FMA
// on the CUDA cores) whose epilogue fuses the elementwise work (bias,
// softplus100, sigma(100a), the second-derivative factor, the skip split),
// so no pass has a separate elementwise kernel. Pre-activations and
// tangents go to a device scratch buffer (~2.5 GB for K2) and every GEMM
// reads and writes them in HBM, which keeps both kernels at a few percent of
// the bound; keeping them in shared memory, TMA and wgmma are later work.
// The TPU kernel summed weight cotangents across a sequential grid; here
// blocks run in parallel, so W̄ and b̄ are split-K partial sums reduced by a
// second pass, in a fixed order: the result is deterministic.
//
// Math (y = s x, e = PE(y), c = phi'(raw)/s):
//   K1 forward: a_l = alpha_l in_l W_l + b_l, h_{l+1} = softplus100(a_l);
//   gradient sweep gamma_{L-1} = c e0, gamma_{l-1} = (alpha_l gamma_l W_l^T)|h
//   * sigma(100 a_{l-1}); the e-parts sum to eps; grad = s J_PE^T eps.
//   K2 stacks primal rows [0,R) and tangent rows [R,2R) of every buffer:
//   tangent t_e = s J_PE gbar, t_a = alpha t_in W, t_h = sigma(100a) t_a;
//   reverse abar_{l-1} = sigma abar' + 100 sigma(1-sigma) t_a gamma', with
//   ' the h-part of alpha G W^T; W̄ = alpha [in; t_in]^T [abar; gamma],
//   b̄ = sum abar; x̄ = s J_PE^T ebar + s^2 gbar (PE'' . eps).
//
// Plain C interface (loaded with ctypes); every entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

using namespace nvcuda;

#define BM 64
#define BN 64
#define BK 32
#define NT 256
#define MAX_LAYERS 32

enum { EPI_STORE = 0, EPI_FWD = 1, EPI_BWD_T = 2, EPI_BWD_P = 3 };
enum { HEAD_ABS = 0, HEAD_SQUARE = 1, HEAD_SDF = 2 };

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
template <bool BF16>
__global__ void __launch_bounds__(NT) gemm_kernel(GemmArgs g) {
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * g.k_chunk;
  const int ke = min(g.K, kb + g.k_chunk);
  const int t = threadIdx.x;
  const bool a_kfast = g.sak == 1, b_nfast = g.sbn == 1;
  __shared__ __align__(128) float Cs[BM][BN + 4];

  if constexpr (BF16) {
    __shared__ __align__(128) __nv_bfloat16 As[BM][BK + 8];
    __shared__ __align__(128) __nv_bfloat16 Bs[BK][BN + 8];
    const int warp = t >> 5, wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = kb; k0 < ke; k0 += BK) {
      for (int i = t; i < BM * BK; i += NT) {
        const int mm = a_kfast ? i / BK : i % BM, kk = a_kfast ? i % BK : i / BM;
        As[mm][kk] = __float2bfloat16(g.A[(long)(m0 + mm) * g.sam + (long)(k0 + kk) * g.sak]);
      }
      for (int i = t; i < BK * BN; i += NT) {
        const int kk = b_nfast ? i / BN : i % BK, nn = b_nfast ? i % BN : i / BK;
        Bs[kk][nn] = __float2bfloat16(g.B[(long)(k0 + kk) * g.sbk + (long)(n0 + nn) * g.sbn]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, &As[wm * 16][kk], BK + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &Bs[kk][wn * 32 + j * 16], BN + 8);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 16][wn * 32 + j * 16], acc[j], BN + 4, wmma::mem_row_major);
  } else {
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
  }
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
  return true;
}

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

void gemm(const GemmArgs& g, int splits, int bf16, cudaStream_t st) {
  dim3 grid(g.N / BN, g.M / BM, splits);
  if (bf16) gemm_kernel<true><<<grid, NT, 0, st>>>(g);
  else gemm_kernel<false><<<grid, NT, 0, st>>>(g);
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
                   long row0, bool tangent, int bf16, cudaStream_t st) {
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
         1, bf16, st);
  }
}

}  // namespace

extern "C" {

size_t fd_scratch_floats(int n_layers, const void* dims, int pe_w, int rows, int backward,
                         int splits) {
  Net net;
  if (!make_net(n_layers, (const int*)dims, pe_w, &net)) return 0;
  return carve(net, backward ? 2L * rows : rows, backward ? splits : 0, nullptr, nullptr);
}

// K1. x [rows,3] (rows a multiple of 64); outputs udf [rows,1],
// feat [rows,d_out-1], grad [rows,3].
int fd_forward(const void* x, const void* w, const void* b, int n_layers, const void* dims,
               int pe_w, int multires, float scale, int head, int d_out, int rows, int bf16,
               void* udf, void* feat, void* grad, void* scratch, void* stream) {
  Net net;
  if (rows % BM || !make_net(n_layers, (const int*)dims, pe_w, &net)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s;
  carve(net, rows, 0, (float*)scratch, &s);
  const float* xf = (const float*)x;
  embed(net, s, xf, rows, multires, scale, nullptr, 0, st);
  forward_sweep(net, s, (const float*)w, (const float*)b, rows, 0, false, bf16, st);

  const Layer& last = net.l[net.n - 1];
  float *gc = s.g0, *gn = s.g1;
  const long cnt = (long)rows * last.np;
  head_fwd_kernel<<<(cnt + 255) / 256, 256, 0, st>>>(s.a[net.n - 1], rows, last.np, d_out, head,
                                                     scale, (float*)udf, (float*)feat, gc);
  cudaMemsetAsync(s.ebar, 0, sizeof(float) * rows * pe_w, st);
  for (int i = net.n - 1; i >= 0; --i) {
    const Layer& L = net.l[i];
    Epi e = {};
    e.mode = EPI_BWD_T;
    e.kh = L.kh;
    e.ebar = s.ebar;
    e.lde = pe_w;
    if (i > 0) {
      e.aprim = s.a[i - 1];
      e.lda = L.kh;
      e.gt = gn;
      e.ldg = L.kh;
    }
    gemm(row_gemm(gc, L.np, (const float*)w + L.w_off, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1,
         bf16, st);
    float* tmp = gc; gc = gn; gn = tmp;
  }
  pe_vjp_kernel<<<(rows + 127) / 128, 128, 0, st>>>(xf, rows, multires, scale, s.ebar, nullptr,
                                                    nullptr, pe_w, (float*)grad);
  return (int)cudaGetLastError();
}

// K2. Cotangents ubar [rows,1], fbar [rows,d_out-1], gbar [rows,3];
// outputs x̄ [rows,3], W̄ and b̄ packed like w and b.
int fd_backward(const void* x, const void* w, const void* b, int n_layers, const void* dims,
                int pe_w, int multires, float scale, int head, int d_out, int rows, int bf16,
                const void* ubar, const void* fbar, const void* gbar, void* xbar, void* wbar,
                void* bbar, void* scratch, int splits, void* stream) {
  Net net;
  if (rows % BM || splits < 1 || !make_net(n_layers, (const int*)dims, pe_w, &net))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s;
  const long R = rows;
  carve(net, 2 * R, splits, (float*)scratch, &s);
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;

  embed(net, s, xf, rows, multires, scale, (const float*)gbar, R, st);
  forward_sweep(net, s, wf, (const float*)b, rows, 0, false, bf16, st);
  forward_sweep(net, s, wf, (const float*)b, rows, R, true, bf16, st);

  const Layer& last = net.l[net.n - 1];
  float *gc = s.g0, *gn = s.g1;
  const long cnt = R * last.np;
  head_bwd_kernel<<<(cnt + 255) / 256, 256, 0, st>>>(s.a[net.n - 1], rows, last.np, d_out, head,
                                                     scale, (const float*)ubar,
                                                     (const float*)fbar, gc);
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
    gemm(row_gemm(gc + R * L.np, L.np, wl, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, bf16, st);
    // primal rows: abar_{l-1} += sigma(100 a) (abar W^T)|h, ebar
    e.mode = EPI_BWD_P;
    e.ebar = s.ebar;
    e.atan = nullptr;
    e.gt = nullptr;
    gemm(row_gemm(gc, L.np, wl, 1, L.np, rows, L.kp, L.np, L.alpha, e), 1, bf16, st);
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
    gemm(g, w_splits, bf16, st);
    const long wcnt = (long)L.kp * L.np;
    reduce_kernel<<<(wcnt + 255) / 256, 256, 0, st>>>(s.wpart, w_splits, wcnt,
                                                      (float*)wbar + L.w_off);
    // b̄ = sum of abar over the primal rows
    colsum_kernel<<<dim3((L.np + 127) / 128, splits), 128, 0, st>>>(gc, rows, L.np, b_chunk,
                                                                   s.bpart);
    reduce_kernel<<<(L.np + 255) / 256, 256, 0, st>>>(s.bpart, splits, L.np,
                                                      (float*)bbar + L.b_off);
    float* tmp = gc; gc = gn; gn = tmp;
  }
  pe_vjp_kernel<<<(rows + 127) / 128, 128, 0, st>>>(xf, rows, multires, scale, s.ebar + R * pe_w,
                                                    s.ebar, (const float*)gbar, pe_w,
                                                    (float*)xbar);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The NeRF++ background MLP for Hopper (sm_90a): K4, a forward sweep and
// its backward, in place of the port's per-layer PyTorch chain.
//
// Replaces no TPU kernel: the JAX package leaves the background model
// (neuraludf_tpu/nets/fields.py, background NeRF) to XLA, which fuses each
// layer's bias and ReLU into its matrix product. Without this kernel the
// port ran every layer as PyTorch operations: casts of x and W to bf16, the
// product, a cast back, the bias, the ReLU, and in the backward their
// transposes and the bias reductions, ~190 kernels a training step.
//
// The function (nets/fields.py background_nerf_apply, the published DTU
// NeRF++: D = 8, W = 256, a skip after layer 4, view directions):
//   e = PE10(pts) (4 -> 84), v = PE4(views) (3 -> 27)
//   h_0 = relu(e W_0 + b_0); h_l = relu(in_l W_l + b_l), in_5 = [e, h_4]
//   raw = h_7 W_alpha + b_alpha; f = h_7 W_feat + b_feat
//   h_v = relu([f, v] W_views + b_views); rgb = h_v W_rgb + b_rgb
// Every product takes bf16 operands and sums in f32; biases are added in
// f32 (the PyTorch chain also rounds each product's output to bf16).
// Backward, from the cotangents of raw and rgb (no cotangent flows to pts
// or views: the caller keeps the plain path where one would):
//   g_v = [h_v > 0] (d_rgb W_rgb^T); g_f = (g_v W_views^T)[:, f-part]
//   g_7 = [h_7 > 0] (g_f W_feat^T + d_raw W_alpha^T)
//   g_{l-1} = [h_{l-1} > 0] (g_l W_l^T)[:, h-part]
//   W̄ = in^T g, b̄ = sum g for every layer (the heads' with d_raw, d_rgb).
//
// What bounds it on this card: operations. At a DTU step's 74,752 rows
// (512 rays x 146 samples) the forward is 90.3 GFLOP and the backward
// twice that less the first layer's input product (267.8 GFLOP in all),
// 0.091 / 0.271 ms at the bf16 tensor-core peak, while its inputs and
// outputs are ~2.4 MB. The PyTorch chain moves ~32 bytes an output element
// each way through device memory, ~5 ms a step.
//
// What this design does about it (the design of K1/K2's "default" sweeps,
// csrc/fused_distance.cu, whose building blocks it shares in sweep.cuh):
//   * Row-tile-resident sweeps. A persistent grid of one 256-thread block
//     per SM walks 128-row tiles; each of the two warpgroups owns 64 rows
//     and runs wgmma.mma_async m64n256k16 (m64n128k16 for the view layer),
//     bf16 x bf16 -> f32 in registers. The activations stay in shared
//     memory as bf16 operand panels ([128 x 64], 128-byte swizzle): the
//     encoding of pts (two panels; the second holds the view encoding after
//     the skip layer) and four hidden panels, 96 KB. The skip concat [e, h]
//     is the six panels read as one operand, not a copy; [v, f] likewise.
//   * Weights are packed once per call to bf16 as W^T (the forward's K-major
//     B operand) and W (the backward's) by nerf_pack_kernel, straight from
//     the parameters (the padding of the encodings' rows is a row map); they
//     live in L2 and stream through a 4-stage cp.async ring of [256 x 64]
//     slices, two ahead of the tensor cores, across layer and tile borders.
//   * Epilogues in registers: bias and ReLU applied to the accumulators and
//     written straight into the next layer's panels. The one-column alpha
//     head and the three-column rgb head are dot products of the epilogue's
//     own bf16 activations with bf16 weights: four lanes and two shuffles a
//     row, no GEMM.
//   * For the backward the forward keeps, per tile, each layer's input
//     panels (the weight cotangents' left operand: 41 panels, 656 KB a tile,
//     383 MB at 74,752 rows), written by bulk copies of the async proxy that
//     cost no thread an instruction, and each ReLU's mask as bits in the
//     accumulator's fragment order (one 16-byte word a thread and layer, 21
//     MB), which the backward's thread of the same fragment reads back.
//     Recomputing the trunk in the backward instead would run the forward's
//     products a second time: on the H100 keeping them costs the forward
//     0.11 ms at a step's rows, the forward alone takes 0.32 ms (PERF.md §6).
//   * The backward sweep (nerf_bwd_kernel) runs the reverse products on the
//     same tiles and ring, the masks and the head's outer products in its
//     epilogues, sums each bias cotangent per block in a fixed order, and
//     writes each cotangent panel out by bulk copy; nerf_wgrad_kernel
//     multiplies the input and cotangent panels of every layer at once as a
//     grouped split-K wgmma GEMM (both operands MN-major, 128 x N output
//     tiles), and nerf_reduce_kernel sums the splits and the blocks in a
//     fixed order into the parameters' own shapes. No float atomics:
//     bit-reproducible.
//
// Plain C interface (loaded with ctypes); every entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sweep.cuh"

#define ROWS 128        // rows of a tile
#define WIDTH 256
#define N_MM 10         // layers with packed weights: lin0..lin7, feature, views
#define N_GL 12         // layers with weight cotangents: those, alpha, rgb
#define L_FEAT 8
#define L_VIEWS 9
#define L_ALPHA 10
#define L_RGB 11
#define MAX_SLICES 48
#define MAX_ITEMS 32
#define N_MASKS 9       // ReLU masks a tile: lin0..lin7, views
#define PE_ITEMS 11     // the pts encoding: 10 frequencies and the identity
#define VE_ITEMS 5      // the view encoding: 4 frequencies and the identity
// the operand panels a tile keeps for the weight cotangents (slots)
#define XS_E 0          // the pts encoding, 2
#define XS_H 2          // h_l, 4 each, l = 0..7
#define XS_VF 34        // [view encoding | feature], 1 + 4
#define XS_HV 39        // the view layer's output, 2
#define X_SLOTS 41
#define GS_D 0          // [d_raw | d_rgb | 0], 1
#define GS_V 1          // the view layer's pre-activation cotangent, 2
#define GS_F 3          // the feature's, 4
#define GS_A 7          // lin l's pre-activation cotangent, 4 each
#define G_SLOTS 39
#define WG_STAGE 49152  // wgrad: two X half-panels and four G half-panels
#define FWD_SMEM (1024 + 6 * PANEL + N_STAGES * STAGE + 8 * MAX_SLICES)
#define BWD_SMEM (1024 + 5 * PANEL + N_STAGES * STAGE + 4 * (4 * ROWS + 8 * WIDTH) + 8 * MAX_SLICES)
#define WGRAD_SMEM (1024 + N_STAGES * WG_STAGE)

struct FwdArgs {
  const float *pts, *views;
  const __nv_bfloat16* w16;
  const float* b[N_GL];
  const float *w_alpha, *w_rgb;
  float *raw, *rgb;
  uint8_t* xbuf;  // SAVE: the operand panels of every tile
  uint4* mask;    // SAVE: the ReLU masks of every tile
  int n, n_tiles, n_slices;
  Slice s[MAX_SLICES];
};

struct BwdArgs {
  const __nv_bfloat16* w16;
  const float *w_alpha, *w_rgb;
  const float *draw, *drgb;
  const uint4* mask;
  uint8_t* gbuf;  // the cotangent panels of every tile
  float* bpart;   // per block: the bias cotangents' partial sums
  int n, n_tiles, n_slices, b_total;
  int b_off[N_GL];
  Slice s[MAX_SLICES];
};

struct WItem {  // one output tile of the grouped weight-cotangent GEMM
  int xs0, xs1;  // X panel slots of the two warpgroups (xs1 < 0: none)
  int gs0, n;    // first G panel slot, tile width (256, 128 or 64)
  int w_off, np, m0;
};

struct WgradArgs {
  const uint8_t *xbuf, *gbuf;
  float* part;
  long w_total;
  int n_tiles;
  WItem item[MAX_ITEMS];
};

struct PackArgs {
  const float* w[N_MM];
  long off[N_MM + 1];
  int kp[N_MM], np[N_MM], nseg[N_MM], t0[N_MM][2], cnt[N_MM][2], p0[N_MM][2];
};

struct RLeaf {  // one parameter's cotangent in the output buffer
  long dst;
  int cols, layer, col0, bias, nseg, t0[2], cnt[2], p0[2];
};

struct ReduceArgs {
  const float *part, *bpart;
  float* out;
  long w_total, total;
  int splits, blocks, b_total;
  long w_off[N_GL];
  int np[N_GL], b_off[N_GL];
  RLeaf leaf[2 * N_GL];
};

// W (row-major [kp x np], the encodings' rows placed by the row map) and
// W^T of every layer of the sweeps in bf16: w16[i], w16[total + ...].
__global__ void nerf_pack_kernel(const __grid_constant__ PackArgs P, __nv_bfloat16* w16) {
  const long total = P.off[N_MM];
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    int l = 0;
    while (i >= P.off[l + 1]) ++l;
    const long r = i - P.off[l];
    const int k = (int)(r / P.np[l]), n = (int)(r % P.np[l]);
    float v = 0.f;
    for (int s = 0; s < P.nseg[l]; ++s)
      if (k >= P.p0[l][s] && k < P.p0[l][s] + P.cnt[l][s])
        v = P.w[l][(long)(P.t0[l][s] + k - P.p0[l][s]) * P.np[l] + n];
    const __nv_bfloat16 b = __float2bfloat16(v);
    w16[i] = b;
    w16[total + P.off[l] + (long)n * P.kp[l] + k] = b;
  }
}

// the mask bits of acc[4 i4 .. 4 i4 + 3]: rows r0, r0 + 8 by columns col, col + 1
__device__ __forceinline__ uint32_t nibble(float a0, float a1, float a2, float a3) {
  return (uint32_t)(a0 > 0.f) | (uint32_t)(a1 > 0.f) << 1 | (uint32_t)(a2 > 0.f) << 2 |
         (uint32_t)(a3 > 0.f) << 3;
}

// K4 forward. SAVE (the autograd path): also the operand panels and masks.
template <bool SAVE>
__global__ void __launch_bounds__(FT, 1) nerf_fwd_kernel(const __grid_constant__ FwdArgs P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t sA = (raw_addr + 1023u) & ~1023u;
  uint8_t* gA = smem_raw + (sA - raw_addr);  // panels 0, 1: encodings; 2..5: hidden
  uint8_t* gH = gA + 2 * PANEL;
  const uint32_t ring = sA + 6 * PANEL;
  Slice* tab = reinterpret_cast<Slice*>(gA + 6 * PANEL + N_STAGES * STAGE);

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = tid >> 7;
  const int r0 = g * 64 + wq * 16 + (lane >> 2);  // row of d[4i], d[4i+1]; d[4i+2..3]: r0 + 8
  const int cq = 2 * (lane & 3);
  const uint32_t a_wg = sA + g * 64 * 128;
  const int ns = P.n_slices;
  for (int i = tid; i < ns; i += FT) tab[i] = P.s[i];
  __syncthreads();

  float acc[128];
  uint32_t it = 0;
  for (int q = 0; q < PREFETCH; ++q) {
    load_slice(tab, ns, P.w16, q, ring, tid);
    cp_async_commit();
  }

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;
    uint8_t* xt = P.xbuf + (size_t)tile * X_SLOTS * PANEL;
    uint4* mt = P.mask + (size_t)tile * N_MASKS * FT + tid;
    bulk_reads_done(tid);  // the last tile's panels are out
    __syncthreads();

    // [pts, sin(2^k pts), cos(2^k pts)] into panels 0, 1; zeros past column 84
    for (int item = tid; item < ROWS * PE_ITEMS; item += FT) {
      const int row = item / PE_ITEMS, k = item % PE_ITEMS;
      const bool in = row0 + row < P.n;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = in ? P.pts[(row0 + row) * 4 + i] : 0.f;
      if (k < PE_ITEMS - 1) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sn, cs;
          sincosf(p[i] * f, &sn, &cs);
          put(gA, row, 4 + 8 * k + i, sn);
          put(gA, row, 8 + 8 * k + i, cs);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) put(gA, row, i, p[i]);
        for (int c = 84; c < 128; ++c) put(gA, row, c, 0.f);
      }
    }
    fence_async();
    __syncthreads();
    if (SAVE) dump_panels(sA, 2, xt + XS_E * PANEL, tid);

    // the trunk: h_l = relu(in_l W_l + b_l); in_0 = e, in_5 = [e, h_4]
    for (int l = 0; l < 8; ++l) {
      sweep_gemm<256>(acc, a_wg, l == 0 || l == 5 ? 0 : 2, l == 0 ? 2 : (l == 5 ? 6 : 4), ring,
                      tab, ns, P.w16, it, tid);
      const float* __restrict__ bias = P.b[l];
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      float ra = 0.f, rb = 0.f;  // the alpha head's dot products (l = 7)
#pragma unroll
      for (int i4 = 0; i4 < 32; ++i4) {
        const int col = i4 * 8 + cq;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        const float a0 = acc[4 * i4] + b0, a1 = acc[4 * i4 + 1] + b1;
        const float a2 = acc[4 * i4 + 2] + b0, a3 = acc[4 * i4 + 3] + b1;
        const float h0 = fmaxf(a0, 0.f), h1 = fmaxf(a1, 0.f);
        const float h2 = fmaxf(a2, 0.f), h3 = fmaxf(a3, 0.f);
        put2(gH, r0, col, h0, h1);
        put2(gH, r0 + 8, col, h2, h3);
        bits[i4 >> 3] |= nibble(a0, a1, a2, a3) << (4 * (i4 & 7));
        if (l == 7) {
          const float w0 = bf16_round(__ldg(P.w_alpha + col));
          const float w1 = bf16_round(__ldg(P.w_alpha + col + 1));
          ra = fmaf(bf16_round(h0), w0, ra);
          ra = fmaf(bf16_round(h1), w1, ra);
          rb = fmaf(bf16_round(h2), w0, rb);
          rb = fmaf(bf16_round(h3), w1, rb);
        }
      }
      if (SAVE) mt[(size_t)l * FT] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
      if (l == 7) {
        ra += __shfl_xor_sync(0xffffffffu, ra, 1);
        ra += __shfl_xor_sync(0xffffffffu, ra, 2);
        rb += __shfl_xor_sync(0xffffffffu, rb, 1);
        rb += __shfl_xor_sync(0xffffffffu, rb, 2);
        if ((lane & 3) == 0) {
          const float ba = __ldg(P.b[L_ALPHA]);
          if (row0 + r0 < P.n) P.raw[row0 + r0] = ra + ba;
          if (row0 + r0 + 8 < P.n) P.raw[row0 + r0 + 8] = rb + ba;
        }
      }
      fence_async();
      __syncthreads();
      if (SAVE) dump_panels(sA + 2 * PANEL, 4, xt + (XS_H + 4 * l) * PANEL, tid);
    }

    // the feature: h_7 W_feat + b_feat, no activation
    sweep_gemm<256>(acc, a_wg, 2, 4, ring, tab, ns, P.w16, it, tid);
    {
      const float* __restrict__ bias = P.b[L_FEAT];
#pragma unroll
      for (int i4 = 0; i4 < 32; ++i4) {
        const int col = i4 * 8 + cq;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        put2(gH, r0, col, acc[4 * i4] + b0, acc[4 * i4 + 1] + b1);
        put2(gH, r0 + 8, col, acc[4 * i4 + 2] + b0, acc[4 * i4 + 3] + b1);
      }
    }
    // [views, sin(2^k views), cos(2^k views)] into panel 1, zeros past column 27:
    // the view layer reads panels 1..5 as [v, f]
    for (int item = tid; item < ROWS * VE_ITEMS; item += FT) {
      const int row = item / VE_ITEMS, k = item % VE_ITEMS;
      const bool in = row0 + row < P.n;
      float v[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) v[i] = in ? P.views[(row0 + row) * 3 + i] : 0.f;
      if (k < VE_ITEMS - 1) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float sn, cs;
          sincosf(v[i] * f, &sn, &cs);
          put(gA + PANEL, row, 3 + 6 * k + i, sn);
          put(gA + PANEL, row, 6 + 6 * k + i, cs);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) put(gA + PANEL, row, i, v[i]);
        for (int c = 27; c < 64; ++c) put(gA + PANEL, row, c, 0.f);
      }
    }
    fence_async();
    __syncthreads();
    if (SAVE) dump_panels(sA + PANEL, 5, xt + XS_VF * PANEL, tid);

    // the view layer, then the rgb head
    sweep_gemm<128>(acc, a_wg, 1, 5, ring, tab, ns, P.w16, it, tid);
    {
      const float* __restrict__ bias = P.b[L_VIEWS];
      uint32_t bits[2] = {0u, 0u};
      float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
      for (int i4 = 0; i4 < 16; ++i4) {
        const int col = i4 * 8 + cq;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        const float a0 = acc[4 * i4] + b0, a1 = acc[4 * i4 + 1] + b1;
        const float a2 = acc[4 * i4 + 2] + b0, a3 = acc[4 * i4 + 3] + b1;
        const float h0 = bf16_round(fmaxf(a0, 0.f)), h1 = bf16_round(fmaxf(a1, 0.f));
        const float h2 = bf16_round(fmaxf(a2, 0.f)), h3 = bf16_round(fmaxf(a3, 0.f));
        put2(gH, r0, col, h0, h1);
        put2(gH, r0 + 8, col, h2, h3);
        bits[i4 >> 3] |= nibble(a0, a1, a2, a3) << (4 * (i4 & 7));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float w0 = bf16_round(__ldg(P.w_rgb + col * 3 + j));
          const float w1 = bf16_round(__ldg(P.w_rgb + (col + 1) * 3 + j));
          c[0][j] = fmaf(h1, w1, fmaf(h0, w0, c[0][j]));
          c[1][j] = fmaf(h3, w1, fmaf(h2, w0, c[1][j]));
        }
      }
      if (SAVE) mt[(size_t)(N_MASKS - 1) * FT] = make_uint4(bits[0], bits[1], 0u, 0u);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          c[r][j] += __shfl_xor_sync(0xffffffffu, c[r][j], 1);
          c[r][j] += __shfl_xor_sync(0xffffffffu, c[r][j], 2);
        }
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long row = row0 + r0 + 8 * r;
          if (row < P.n) {
#pragma unroll
            for (int j = 0; j < 3; ++j) P.rgb[row * 3 + j] = c[r][j] + __ldg(P.b[L_RGB] + j);
          }
        }
      }
    }
    fence_async();
    __syncthreads();
    if (SAVE) dump_panels(sA + 2 * PANEL, 2, xt + XS_HV * PANEL, tid);
  }
  cp_async_wait<0>();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The epilogue of a reverse product (N = 256): v = acc (+ d_raw W_alpha^T
// when dr is given), masked by the forward's bits (all on without mask);
// bf16 into panels 0..3, and the column sums of v over the warp's rows into
// bwarp.
__device__ __forceinline__ void rev_epilogue(const float* acc, const uint4* mask, const float* dr,
                                             const float* w_alpha, uint8_t* gG, float* bwarp,
                                             int r0, int cq, int lane, int warp) {
  const uint4 m = mask ? *mask : make_uint4(~0u, ~0u, ~0u, ~0u);
  const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
  const float da = dr ? bf16_round(dr[r0 * 4]) : 0.f, db = dr ? bf16_round(dr[(r0 + 8) * 4]) : 0.f;
#pragma unroll
  for (int i4 = 0; i4 < 32; ++i4) {
    const int col = i4 * 8 + cq;
    float v0 = acc[4 * i4], v1 = acc[4 * i4 + 1], v2 = acc[4 * i4 + 2], v3 = acc[4 * i4 + 3];
    if (dr) {
      const float w0 = bf16_round(__ldg(w_alpha + col)), w1 = bf16_round(__ldg(w_alpha + col + 1));
      v0 = fmaf(da, w0, v0);
      v1 = fmaf(da, w1, v1);
      v2 = fmaf(db, w0, v2);
      v3 = fmaf(db, w1, v3);
    }
    const uint32_t nib = mw[i4 >> 3] >> (4 * (i4 & 7));
    v0 = nib & 1u ? v0 : 0.f;
    v1 = nib & 2u ? v1 : 0.f;
    v2 = nib & 4u ? v2 : 0.f;
    v3 = nib & 8u ? v3 : 0.f;
    put2(gG, r0, col, v0, v1);
    put2(gG, r0 + 8, col, v2, v3);
    float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
    for (int k = 4; k < 32; k <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, k);
      s1 += __shfl_xor_sync(0xffffffffu, s1, k);
    }
    if (lane < 4) {
      bwarp[warp * WIDTH + col] = s0;
      bwarp[warp * WIDTH + col + 1] = s1;
    }
  }
}

// K4 backward sweep: the cotangents of every pre-activation, per tile, into
// their panels (gbuf) and the bias cotangents into per-block sums.
__global__ void __launch_bounds__(FT, 1) nerf_bwd_kernel(const __grid_constant__ BwdArgs P) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t sA = (raw_addr + 1023u) & ~1023u;
  uint8_t* gA = smem_raw + (sA - raw_addr);  // panels 0..3: G; 4: [d_raw | d_rgb]
  const uint32_t ring = sA + 5 * PANEL;
  float* drow = reinterpret_cast<float*>(gA + 5 * PANEL + N_STAGES * STAGE);  // [ROWS][4]
  float* bwarp = drow + 4 * ROWS;                                              // [8 warps][WIDTH]
  Slice* tab = reinterpret_cast<Slice*>(bwarp + 8 * WIDTH);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wq = warp & 3, g = tid >> 7;
  const int r0 = g * 64 + wq * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t a_wg = sA + g * 64 * 128;
  const int ns = P.n_slices;
  float* bpart = P.bpart + (long)blockIdx.x * P.b_total;
  for (int i = tid; i < ns; i += FT) tab[i] = P.s[i];
  for (int i = tid; i < P.b_total; i += FT) bpart[i] = 0.f;
  __syncthreads();

  float acc[128];
  uint32_t it = 0;
  for (int q = 0; q < PREFETCH; ++q) {
    load_slice(tab, ns, P.w16, q, ring, tid);
    cp_async_commit();
  }

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;
    uint8_t* gt = P.gbuf + (size_t)tile * G_SLOTS * PANEL;
    const uint4* mt = P.mask + (size_t)tile * N_MASKS * FT + tid;
    bulk_reads_done(tid);  // the last tile's panels are out
    for (int i = tid; i < ROWS * 4; i += FT) {
      const int row = i >> 2, c = i & 3;
      const long r = row0 + row;
      drow[i] = r < P.n ? (c == 0 ? P.draw[r] : P.drgb[r * 3 + c - 1]) : 0.f;
    }
    __syncthreads();
    // panel 4: [d_raw, d_rgb, 0...] in bf16; the heads' bias cotangents
    for (int i = tid; i < ROWS * 8; i += FT) {
      const int row = i >> 3, ch = i & 7;
      const float* d = drow + row * 4;
      *reinterpret_cast<uint4*>(gA + 4 * PANEL + row * 128 + ((ch ^ (row & 7)) << 4)) =
          ch == 0 ? make_uint4(pack2(d[0], d[1]), pack2(d[2], d[3]), 0u, 0u)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid < 4) {
      float s = 0.f;
      for (int row = 0; row < ROWS; ++row) s += drow[row * 4 + tid];
      bpart[tid == 0 ? P.b_off[L_ALPHA] : P.b_off[L_RGB] + tid] += s;
    }
    // g_v = [h_v > 0] (d_rgb W_rgb^T), as the fragment of an m64n128 accumulator
    {
      const uint4 m = mt[(size_t)(N_MASKS - 1) * FT];
      const uint32_t mw[2] = {m.x, m.y};
      float dc[2][3];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 3; ++j) dc[r][j] = bf16_round(drow[(r0 + 8 * r) * 4 + 1 + j]);
#pragma unroll
      for (int i4 = 0; i4 < 16; ++i4) {
        const int col = i4 * 8 + cq;
        float w[2][3];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < 3; ++j) w[e][j] = bf16_round(__ldg(P.w_rgb + (col + e) * 3 + j));
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* d = dc[q >> 1];
          const float* ww = w[q & 1];
          v[q] = fmaf(d[2], ww[2], fmaf(d[1], ww[1], d[0] * ww[0]));
        }
        const uint32_t nib = mw[i4 >> 3] >> (4 * (i4 & 7));
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = (nib >> q) & 1u ? v[q] : 0.f;
        put2(gA, r0, col, v[0], v[1]);
        put2(gA, r0 + 8, col, v[2], v[3]);
        float s0 = v[0] + v[2], s1 = v[1] + v[3];
#pragma unroll
        for (int k = 4; k < 32; k <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, k);
          s1 += __shfl_xor_sync(0xffffffffu, s1, k);
        }
        if (lane < 4) {
          bwarp[warp * WIDTH + col] = s0;
          bwarp[warp * WIDTH + col + 1] = s1;
        }
      }
    }
    fence_async();
    __syncthreads();
    dump_panels(sA + 4 * PANEL, 1, gt + GS_D * PANEL, tid);
    dump_panels(sA, 2, gt + GS_V * PANEL, tid);
    if (tid < 128) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += bwarp[w * WIDTH + tid];
      bpart[P.b_off[L_VIEWS] + tid] += s;
    }

    // g_f = (g_v W_views^T)[:, f-part]; g_7 = [h_7 > 0] (g_f W_feat^T + d_raw W_alpha^T);
    // g_{l-1} = [h_{l-1} > 0] (g_l W_l^T)[:, h-part]
    for (int step = 0; step < 9; ++step) {
      const int l = 8 - step;  // the layer whose pre-activation cotangent comes out
      sweep_gemm<256>(acc, a_wg, 0, step == 0 ? 2 : 4, ring, tab, ns, P.w16, it, tid);
      rev_epilogue(acc, step == 0 ? nullptr : mt + (size_t)l * FT, step == 1 ? drow : nullptr,
                   P.w_alpha, gA, bwarp, r0, cq, lane, warp);
      fence_async();
      __syncthreads();
      dump_panels(sA, 4, gt + (l == L_FEAT ? GS_F : GS_A + 4 * l) * PANEL, tid);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += bwarp[w * WIDTH + tid];
      bpart[P.b_off[l] + tid] += s;
    }
  }
  cp_async_wait<0>();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One [128 x n] tile of W̄ = X^T G over the row tiles of split blockIdx.y,
// from the operand panels the sweeps wrote; both operands MN-major. Partial
// sums go to part[blockIdx.y].
__global__ void __launch_bounds__(FT, 1) nerf_wgrad_kernel(const __grid_constant__ WgradArgs P) {
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
      const size_t tile = t0 + step / 2;
      const uint32_t half = (step % 2) * (PANEL / 2);
      const uint32_t base = sbase + (step % N_STAGES) * WG_STAGE;
      for (int c = tid; c < (nm + n_pan) * 512; c += FT) {
        const int pn = c >> 9;
        const uint32_t o = (c & 511) * 16;
        const uint8_t* src =
            pn < nm ? P.xbuf + (tile * X_SLOTS + (pn ? I.xs1 : I.xs0)) * PANEL + half + o
                    : P.gbuf + (tile * G_SLOTS + I.gs0 + (pn - nm)) * PANEL + half + o;
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
        else if (I.n == 128) wgmma_n128<1, 1>(acc, da, db, 1);
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
               (size_t)(I.m0 + g * 64 + wq * 16 + (lane >> 2)) * I.np + 2 * (lane & 3);
#pragma unroll
  for (int i4 = 0; i4 < 32; ++i4) {
    if (i4 * 8 < I.n) {
      *reinterpret_cast<float2*>(out + i4 * 8) = make_float2(acc[4 * i4], acc[4 * i4 + 1]);
      *reinterpret_cast<float2*>(out + (size_t)8 * I.np + i4 * 8) =
          make_float2(acc[4 * i4 + 2], acc[4 * i4 + 3]);
    }
  }
}

// Each parameter's cotangent in its own shape: the weights' split-K partials
// and the biases' per-block sums, added in a fixed order.
__global__ void nerf_reduce_kernel(const __grid_constant__ ReduceArgs P) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.total) return;
  int e = 0;
  while (e + 1 < 2 * N_GL && i >= P.leaf[e + 1].dst) ++e;
  const RLeaf& L = P.leaf[e];
  const long r = i - L.dst;
  float s = 0.f;
  if (L.bias) {
    const float* src = P.bpart + P.b_off[L.layer] + L.col0 + r;
    for (int b = 0; b < P.blocks; ++b) s += src[(long)b * P.b_total];
  } else {
    const int k = (int)(r / L.cols), n = (int)(r % L.cols) + L.col0;
    int p = k;
    for (int q = 0; q < L.nseg; ++q)
      if (k >= L.t0[q] && k < L.t0[q] + L.cnt[q]) p = L.p0[q] + k - L.t0[q];
    const float* src = P.part + P.w_off[L.layer] + (long)p * P.np[L.layer] + n;
    for (int z = 0; z < P.splits; ++z) s += src[(long)z * P.w_total];
  }
  P.out[i] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

namespace {

// The layers as the sweeps lay them out (the published DTU NeRF++): padded
// input width kp, output width np, the true rows' map into the padded rows
// (t0: first true row, cnt rows, p0: first padded row), the h-part's first
// padded row (the backward's rows of W), the true shape (din, dout) and the
// first column of the cotangent panel the heads read (alpha 0, rgb 1..3).
struct Geo {
  int kp, np, nseg, t0[2], cnt[2], p0[2], hp0, din, dout, col0;
};

const Geo GEO[N_GL] = {
    {128, 256, 1, {0, 0}, {84, 0}, {0, 0}, -1, 84, 256, 0},           // lin0: e
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // lin1
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // lin2
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // lin3
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // lin4
    {384, 256, 2, {0, 84}, {84, 256}, {0, 128}, 128, 340, 256, 0},    // lin5: [e, h_4]
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // lin6
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // lin7
    {256, 256, 1, {0, 0}, {256, 0}, {0, 0}, 0, 256, 256, 0},          // feature
    {320, 128, 2, {256, 0}, {27, 256}, {0, 64}, 64, 283, 128, 0},     // views: [f, v] as [v, f]
    {256, 64, 1, {0, 0}, {256, 0}, {0, 0}, -1, 256, 1, 0},            // alpha
    {128, 64, 1, {0, 0}, {128, 0}, {0, 0}, -1, 128, 3, 1},            // rgb
};

// the X panel slots of each layer's input, in its padded row order
int x_slots(int l, int* out) {
  int n = 0;
  auto add = [&](int s0, int k) { for (int j = 0; j < k; ++j) out[n++] = s0 + j; };
  if (l == 0) add(XS_E, 2);
  else if (l == 5) { add(XS_E, 2); add(XS_H + 16, 4); }
  else if (l < 8) add(XS_H + 4 * (l - 1), 4);
  else if (l == L_FEAT || l == L_ALPHA) add(XS_H + 28, 4);
  else if (l == L_VIEWS) add(XS_VF, 5);
  else add(XS_HV, 2);
  return n;
}

int g_slot(int l) {
  return l < 8 ? GS_A + 4 * l : l == L_FEAT ? GS_F : l == L_VIEWS ? GS_V : GS_D;
}

struct Sizes {
  long w_off[N_GL + 1];  // padded weights: the packed layers, then alpha and rgb
  int b_off[N_GL + 1];
};

Sizes sizes() {
  Sizes s;
  s.w_off[0] = 0;
  s.b_off[0] = 0;
  for (int l = 0; l < N_GL; ++l) {
    s.w_off[l + 1] = s.w_off[l] + (long)GEO[l].kp * GEO[l].np;
    s.b_off[l + 1] = s.b_off[l] + GEO[l].np;
  }
  return s;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

size_t round256(size_t v) { return (v + 255) / 256 * 256; }

int n_tiles(int n) { return (n + ROWS - 1) / ROWS; }

int grid_for(int n) {
  const int t = n_tiles(n), sms = sm_count();
  return t < sms ? t : sms;
}

// the output tiles of the weight cotangents' GEMM: one per two X panels of a layer
int n_items() {
  int x[8], k = 0;
  for (int l = 0; l < N_GL; ++l) k += (x_slots(l, x) + 1) / 2;
  return k;
}

// split-K slices of the weight cotangent: about two waves of blocks
int splits_for(int n) {
  const int items = n_items(), t = n_tiles(n);
  int s = (2 * sm_count() + items - 1) / items;
  return s < 1 ? 1 : (s > t ? t : s);
}

// forward scratch: the bf16 weights, then (save) the masks and the panels
struct FwdScratch {
  __nv_bfloat16* w16;
  uint4* mask;
  uint8_t* xbuf;
};

size_t carve_fwd(int n, bool save, uint8_t* base, FwdScratch* fs) {
  const Sizes s = sizes();
  size_t off = 0;
  FwdScratch f = {};
  f.w16 = (__nv_bfloat16*)(base + off);
  off += round256(2 * 2 * (size_t)s.w_off[N_MM]);
  if (save) {
    f.mask = (uint4*)(base + off);
    off += (size_t)n_tiles(n) * N_MASKS * FT * 16;
    f.xbuf = base + off;
    off += (size_t)n_tiles(n) * X_SLOTS * PANEL;
  }
  if (fs) *fs = f;
  return off;
}

struct BwdScratch {
  uint8_t* gbuf;
  float *part, *bpart;
};

size_t carve_bwd(int n, uint8_t* base, BwdScratch* bs) {
  const Sizes s = sizes();
  size_t off = 0;
  BwdScratch b = {};
  b.gbuf = base + off;
  off += (size_t)n_tiles(n) * G_SLOTS * PANEL;
  b.part = (float*)(base + off);
  off += round256(4 * (size_t)splits_for(n) * s.w_off[N_GL]);
  b.bpart = (float*)(base + off);
  off += round256(4 * (size_t)grid_for(n) * s.b_off[N_GL]);
  if (bs) *bs = b;
  return off;
}

void add_slices(Slice* tab, int* count, long off, int ld, int rows, int nk) {
  for (int j = 0; j < nk && *count < MAX_SLICES; ++j) {
    Slice& s = tab[(*count)++];
    s.off = (uint32_t)(off + 64 * j);
    s.ld = (uint16_t)ld;
    s.rows = (uint16_t)rows;
  }
}

// the order in which the forward sweep consumes weight slices: W_l^T of
// lin0..lin7, the feature, the view layer
int fwd_slices(Slice* tab) {
  const Sizes s = sizes();
  const long wt = s.w_off[N_MM];  // where the transposed copies start
  int n = 0;
  for (int l = 0; l < N_MM; ++l)
    add_slices(tab, &n, wt + s.w_off[l], GEO[l].kp, GEO[l].np, GEO[l].kp / 64);
  return n;
}

// the backward sweep's: W's h-part rows of the view layer, the feature,
// lin7..lin1
int bwd_slices(Slice* tab) {
  const Sizes s = sizes();
  int n = 0;
  for (int l = L_VIEWS; l >= 1; --l) {
    const Geo& G = GEO[l];
    add_slices(tab, &n, s.w_off[l] + (long)G.hp0 * G.np, G.np, WIDTH, G.np / 64);
  }
  return n;
}

int fill_items(WItem* items) {
  const Sizes s = sizes();
  int n = 0;
  for (int l = 0; l < N_GL; ++l) {
    int xs[8];
    const int m = x_slots(l, xs);
    for (int mp = 0; mp < m; mp += 2) {
      if (n >= MAX_ITEMS) return -1;
      WItem& I = items[n++];
      I.xs0 = xs[mp];
      I.xs1 = mp + 1 < m ? xs[mp + 1] : -1;
      I.gs0 = g_slot(l);
      I.n = GEO[l].np;
      I.w_off = (int)s.w_off[l];
      I.np = GEO[l].np;
      I.m0 = 64 * mp;
    }
  }
  return n;
}

}  // namespace

// The kernels' dynamic shared memory limits, set once per device (at the
// first launch, which precedes any graph capture of it), not at every launch.
static cudaError_t set_smem_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(nerf_fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FWD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FWD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BWD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)WGRAD_SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

extern "C" {

// Bytes of scratch a call on n rows needs: the forward's (without and with
// what the backward reads: kind 0, 1) or the backward's (kind 2). Call with
// the launch's device current (the backward's depends on its SM count).
size_t nerf_scratch_bytes(int n, int kind) {
  if (n <= 0 || kind < 0 || kind > 2) return 0;
  return kind == 2 ? carve_bwd(n, nullptr, nullptr) : carve_fwd(n, kind == 1, nullptr, nullptr);
}

// Floats of the parameters' cotangents: every layer's W [din, dout] then b
// [dout], lin0..lin7, feature, views, alpha, rgb.
long nerf_param_count() {
  long t = 0;
  for (int l = 0; l < N_GL; ++l) t += (long)(GEO[l].din + 1) * GEO[l].dout;
  return t;
}

// K4 forward. pts [n,4], views [n,3]; w, b: the 12 layers' weights [din,
// dout] and biases in the order above; raw [n,1], rgb [n,3]. With save, the
// scratch keeps what nerf_backward reads.
int nerf_forward(const void* pts, const void* views, const void* const* w, const void* const* b,
                 int n, void* raw, void* rgb, int save, void* scratch, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  FwdScratch fs;
  carve_fwd(n, save != 0, (uint8_t*)scratch, &fs);
  const Sizes s = sizes();
  PackArgs pk = {};
  for (int l = 0; l < N_MM; ++l) {
    const Geo& G = GEO[l];
    pk.w[l] = (const float*)w[l];
    pk.off[l] = s.w_off[l];
    pk.kp[l] = G.kp;
    pk.np[l] = G.np;
    pk.nseg[l] = G.nseg;
    for (int q = 0; q < 2; ++q) {
      pk.t0[l][q] = G.t0[q];
      pk.cnt[l][q] = G.cnt[q];
      pk.p0[l][q] = G.p0[q];
    }
  }
  pk.off[N_MM] = s.w_off[N_MM];
  nerf_pack_kernel<<<(unsigned)((s.w_off[N_MM] + 255) / 256), 256, 0, st>>>(pk, fs.w16);

  FwdArgs a = {};
  a.pts = (const float*)pts;
  a.views = (const float*)views;
  a.w16 = fs.w16;
  for (int l = 0; l < N_GL; ++l) a.b[l] = (const float*)b[l];
  a.w_alpha = (const float*)w[L_ALPHA];
  a.w_rgb = (const float*)w[L_RGB];
  a.raw = (float*)raw;
  a.rgb = (float*)rgb;
  a.xbuf = fs.xbuf;
  a.mask = fs.mask;
  a.n = n;
  a.n_tiles = n_tiles(n);
  a.n_slices = fwd_slices(a.s);
  if (save)
    nerf_fwd_kernel<true><<<grid_for(n), FT, FWD_SMEM, st>>>(a);
  else
    nerf_fwd_kernel<false><<<grid_for(n), FT, FWD_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// K4 backward. draw [n,1], drgb [n,3]; fwd_scratch: a saving forward's on
// the same weights and n; out: nerf_param_count() floats, each layer's W̄
// then b̄ in the parameters' shapes.
int nerf_backward(const void* const* w, int n, const void* draw, const void* drgb,
                  const void* fwd_scratch, void* scratch, void* out, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  FwdScratch fs;
  carve_fwd(n, true, (uint8_t*)fwd_scratch, &fs);
  BwdScratch bs;
  carve_bwd(n, (uint8_t*)scratch, &bs);
  const Sizes s = sizes();
  const int grid = grid_for(n), tiles = n_tiles(n), splits = splits_for(n);

  BwdArgs a = {};
  a.w16 = fs.w16;
  a.w_alpha = (const float*)w[L_ALPHA];
  a.w_rgb = (const float*)w[L_RGB];
  a.draw = (const float*)draw;
  a.drgb = (const float*)drgb;
  a.mask = fs.mask;
  a.gbuf = bs.gbuf;
  a.bpart = bs.bpart;
  a.n = n;
  a.n_tiles = tiles;
  a.b_total = s.b_off[N_GL];
  for (int l = 0; l < N_GL; ++l) a.b_off[l] = s.b_off[l];
  a.n_slices = bwd_slices(a.s);
  nerf_bwd_kernel<<<grid, FT, BWD_SMEM, st>>>(a);

  WgradArgs g = {};
  g.xbuf = fs.xbuf;
  g.gbuf = bs.gbuf;
  g.part = bs.part;
  g.w_total = s.w_off[N_GL];
  g.n_tiles = tiles;
  const int items = fill_items(g.item);
  if (items < 0) return cudaErrorInvalidValue;
  nerf_wgrad_kernel<<<dim3(items, splits), FT, WGRAD_SMEM, st>>>(g);

  ReduceArgs r = {};
  r.part = bs.part;
  r.bpart = bs.bpart;
  r.out = (float*)out;
  r.w_total = s.w_off[N_GL];
  r.splits = splits;
  r.blocks = grid;
  r.b_total = s.b_off[N_GL];
  long dst = 0;
  for (int l = 0; l < N_GL; ++l) {
    const Geo& G = GEO[l];
    r.w_off[l] = s.w_off[l];
    r.np[l] = G.np;
    r.b_off[l] = s.b_off[l];
    for (int bias = 0; bias < 2; ++bias) {
      RLeaf& L = r.leaf[2 * l + bias];
      L.dst = dst;
      L.cols = G.dout;
      L.layer = l;
      L.col0 = G.col0;
      L.bias = bias;
      L.nseg = G.nseg;
      for (int q = 0; q < 2; ++q) {
        L.t0[q] = G.t0[q];
        L.cnt[q] = G.cnt[q];
        L.p0[q] = G.p0[q];
      }
      dst += bias ? G.dout : (long)G.din * G.dout;
    }
  }
  r.total = dst;
  nerf_reduce_kernel<<<(unsigned)((dst + 255) / 256), 256, 0, st>>>(r);
  return (int)cudaGetLastError();
}

}  // extern "C"

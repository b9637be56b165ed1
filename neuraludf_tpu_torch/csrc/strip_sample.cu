// Warp sampler for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel of neuraludf_tpu/ops/strip_sample.py
// (_build_call, body _make_kernel, entry strip_sample): forward-only
// bilinear sampling of V source images at absolute pixel positions with
// clamped-border semantics, plus the in-image mask. The blending finetune
// calls it once a step on the warp positions of the top-k samples of every
// ray (8 views x 512 rays x 32 samples x 122 positions = 15,990,784).
//
// The TPU has no gathers, so its kernel copied one aligned 64x256 bf16 strip
// per (view, chunk) and formed the bilinear weights as hat functions
// contracted on the matrix unit; positions outside their strip were lost.
// Hopper gathers: each position reads its four neighbouring texels and
// blends them, in f32, and no position can escape, so the mask is the
// in-image mask alone. Strips, their origins and the bf16 image copy do not
// exist here.
//
// What bounds it on this card: bytes. A position reads 8 bytes of
// coordinates and writes 12 bytes of colour and 1 of mask; the images
// (46 MB for eight 600x800 views) are read once if the cache holds them.
// The arithmetic is ~25 flop a position, far under the ridge.
//
// What this design does about it: one thread per position; neighbouring
// threads take neighbouring positions of one (view, row), so the coordinate
// loads and the three colour-plane stores are coalesced. Images are channel
// last ([V, H, W, 3]), so a texel's three channels are 12 adjacent bytes and
// a position touches four short runs, not twelve scattered words. The
// positions of one ray's patch cluster within a few pixels, so most texel
// reads hit L1/L2. Offsets are 64-bit: V*NW*P may pass 2^31.
//
// Plain C interface (loaded with ctypes); the entry returns cudaGetLastError().

#include <cuda_runtime.h>

#define SS_THREADS 256

__global__ void __launch_bounds__(SS_THREADS)
ss_kernel(const float* __restrict__ img, const float* __restrict__ gx,
          const float* __restrict__ gy, int H, int W, long long NW, int P, long long n,
          float* __restrict__ colors, unsigned char* __restrict__ mask) {
  const long long i = blockIdx.x * (long long)SS_THREADS + threadIdx.x;
  if (i >= n) return;
  const float x = gx[i], y = gy[i];
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  // every comparison is false for a NaN
  const bool in_img = x >= 0.f && x <= xmax && y >= 0.f && y <= ymax;
  // fmaxf returns its other operand for a NaN, so a NaN position samples
  // texel (0, 0); +-1e11 clamps to the border: the colour is always finite
  const float xc = fminf(fmaxf(x, 0.f), xmax);
  const float yc = fminf(fmaxf(y, 0.f), ymax);
  const float xf = floorf(xc), yf = floorf(yc);
  const int x0 = (int)xf, y0 = (int)yf;
  // at xc == W-1 the upper neighbour would be column W, with weight 0:
  // clamp the index, never read it
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float wx1 = xc - xf, wy1 = yc - yf;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const float w00 = wx0 * wy0, w01 = wx1 * wy0, w10 = wx0 * wy1, w11 = wx1 * wy1;

  const long long row = i / P;  // v * NW + nw
  const int p = (int)(i - row * P);
  const long long v = row / NW;
  const float* base = img + v * (long long)H * W * 3;
  const float* t00 = base + ((long long)y0 * W + x0) * 3;
  const float* t01 = base + ((long long)y0 * W + x1) * 3;
  const float* t10 = base + ((long long)y1 * W + x0) * 3;
  const float* t11 = base + ((long long)y1 * W + x1) * 3;
  float* out = colors + row * 3 * P + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[(long long)c * P] = __ldg(t00 + c) * w00 + __ldg(t01 + c) * w01 +
                            __ldg(t10 + c) * w10 + __ldg(t11 + c) * w11;
  }
  mask[i] = in_img ? 1 : 0;
}

// img [V, H, W, 3] f32; gx, gy [V, NW, P] f32 absolute pixel positions;
// colors [V, NW, 3, P] f32; mask [V, NW, P] bytes (0 or 1).
extern "C" int ss_forward(const float* img, const float* gx, const float* gy, int V, int H,
                          int W, long long NW, int P, float* colors, unsigned char* mask,
                          cudaStream_t stream) {
  if (V <= 0 || H <= 0 || W <= 0 || NW < 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)V * NW * P;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + SS_THREADS - 1) / SS_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  ss_kernel<<<(unsigned)blocks, SS_THREADS, 0, stream>>>(img, gx, gy, H, W, NW, P, n, colors,
                                                         mask);
  return (int)cudaGetLastError();
}

// Single-pass bilinear warp of the w-grid image to pixels (K8).
//
// Replaces the Pallas TPU kernel vkvolume_tpu/render/warp_pallas.py:_kernel
// (called through warp_to_pixels): every pixel samples the (C, Hi, Wi)
// float32 grid channels at its continuous grid position (gx, gy), 0 where
// gx < -5 (no ray). The frame runs it when the plan has no two-pass warp
// but a single-pass rect (R_warp).
//
// What bounds it on the H100: device-memory bandwidth. Per pixel it reads
// two f32 positions and four texels per channel and writes C values;
// neighbouring pixels read neighbouring texels, which L1/L2 serve, so the
// traffic is about the positions, the outputs and one pass over the grid
// image.
//
// Design: one thread per output pixel, all C channels, direct bilinear
// reads; neighbouring pixels on neighbouring threads, so the position reads
// and output writes coalesce. The TPU kernel DMAs an R x 640 rect of the
// grid per 8 x 128 tile and reconstructs v with a row tent. The plan makes
// that rect cover the tile's footprint (span_gx <= RECT_W - 132 and
// span_gy <= R - 10, sweep_pallas.py:1370-1375), and the tent is non-zero
// on the two rows that straddle gy, so the kernel needs no rect: it reads
// the four texels. The clamps are the TPU kernel's (warp_pallas.py:60-66):
// gx and gy clipped to the grid, iu1 = min(iu0+1, Wi-1), fu clipped; the
// arithmetic is that of the plain version (sweep_pallas._warp_reference,
// the function the JAX frame computes on a CPU), rounded the same way
// (-fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void warp_pixels_kernel(const float* __restrict__ src,
                                   const float* __restrict__ gx_g,
                                   const float* __restrict__ gy_g,
                                   float* __restrict__ out, int C, int Hi,
                                   int Wi, int n_pix) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const float gx = gx_g[i];
  const bool inside = gx > -5.0f;
  const float gxc = fminf(fmaxf(gx, 0.0f), (float)Wi - 1.0f);
  const float gyc = fminf(fmaxf(gy_g[i], 0.0f), (float)Hi - 1.0f);
  const float flx = floorf(gxc), fly = floorf(gyc);
  const int x0 = min(max((int)flx, 0), Wi - 1);
  const int y0 = min(max((int)fly, 0), Hi - 1);
  const int x1 = min(x0 + 1, Wi - 1);
  const int y1 = min(y0 + 1, Hi - 1);
  const float fx = fminf(fmaxf(gxc - flx, 0.0f), 1.0f);
  const float fy = gyc - fly;
  const size_t plane = (size_t)Hi * Wi;
  const size_t r0 = (size_t)y0 * Wi, r1 = (size_t)y1 * Wi;
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * plane;
    const float c00 = __ldg(s + r0 + x0), c01 = __ldg(s + r0 + x1);
    const float c10 = __ldg(s + r1 + x0), c11 = __ldg(s + r1 + x1);
    const float v0 = c00 + (c01 - c00) * fx;
    const float v1 = c10 + (c11 - c10) * fx;
    out[c * (size_t)n_pix + i] = inside ? v0 + (v1 - v0) * fy : 0.0f;
  }
}

}  // namespace

extern "C" int vkv_warp_pixels(const void* src, const void* gx,
                               const void* gy, void* out, int C, int Hi,
                               int Wi, int n_pix, void* stream) {
  if (n_pix == 0) return 0;
  const unsigned blocks = (unsigned)((n_pix + kThreads - 1) / kThreads);
  warp_pixels_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)gx, (const float*)gy, (float*)out, C,
      Hi, Wi, n_pix);
  return (int)cudaGetLastError();
}

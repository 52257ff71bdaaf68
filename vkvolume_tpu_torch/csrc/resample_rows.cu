// Row-aligned 1-D linear resample (K2), run twice per frame by the two-pass
// projective warp.
//
// Replaces the Pallas TPU kernels vkvolume_tpu/render/warp_pallas.py:
// _resample_kernel and _resample_kernel_pipe (the same function with a
// cross-step DMA double buffer), called through resample_rows:
//   out[c, y, x] = lerp(src[c, y, clip(pos[y, x], 0, Ws-1)]),
// 0 where pos < -5 (masked pixel), optionally u16-encoded
// (round half to even, clip to [0, 65535]).
//
// What bounds it on the H100: device-memory bandwidth. Per output element
// it reads one f32 position and two source texels per channel and writes
// one value per channel; there is no reuse beyond neighbouring positions
// hitting the same source lines, which L1/L2 serve.
//
// Design: one thread per output pixel (all channels), neighbouring x on
// neighbouring threads so the position reads and output writes coalesce.
// The source is read with scalar loads: its row length Ws is not a multiple
// of 16 bytes in general, so a vector load would need an aligned base; the
// TPU kernel's per-tile rect DMA and lane gathers have no counterpart.
// Rounding uses rintf (half to even, like jnp.round), not roundf.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename SrcT, typename OutT>
__global__ void resample_rows_kernel(const SrcT* __restrict__ src,
                                     const float* __restrict__ pos,
                                     OutT* __restrict__ out, int C, int Hs,
                                     int Ws, int Wo) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n = (long long)Hs * Wo;
  if (i >= n) return;
  const int y = (int)(i / Wo);
  const float pv = pos[i];
  const bool inside = pv > -5.0f;
  const float posc = fminf(fmaxf(pv, 0.0f), (float)Ws - 1.0f);
  const float fl = floorf(posc);
  const int iu0 = (int)fl;
  const int iu1 = min(iu0 + 1, Ws - 1);
  const float fu = fminf(fmaxf(posc - fl, 0.0f), 1.0f);
  for (int c = 0; c < C; ++c) {
    const SrcT* row = src + ((size_t)c * Hs + y) * Ws;
    const float g0 = (float)row[iu0];
    const float g1 = (float)row[iu1];
    const float val = inside ? g0 + (g1 - g0) * fu : 0.0f;
    OutT* o = out + (size_t)c * n + i;
    if constexpr (sizeof(OutT) == 2) {
      *o = (OutT)rintf(fminf(fmaxf(val, 0.0f), 65535.0f));
    } else {
      *o = val;
    }
  }
}

}  // namespace

extern "C" int vkv_resample_rows(const void* src, const void* pos, void* out,
                                 int C, int Hs, int Ws, int Wo, int src_u16,
                                 int encode_out, void* stream) {
  const long long n = (long long)Hs * Wo;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  if (src_u16 && encode_out)
    resample_rows_kernel<uint16_t, uint16_t><<<blocks, kThreads, 0, s>>>(
        (const uint16_t*)src, p, (uint16_t*)out, C, Hs, Ws, Wo);
  else if (src_u16)
    resample_rows_kernel<uint16_t, float><<<blocks, kThreads, 0, s>>>(
        (const uint16_t*)src, p, (float*)out, C, Hs, Ws, Wo);
  else if (encode_out)
    resample_rows_kernel<float, uint16_t><<<blocks, kThreads, 0, s>>>(
        (const float*)src, p, (uint16_t*)out, C, Hs, Ws, Wo);
  else
    resample_rows_kernel<float, float><<<blocks, kThreads, 0, s>>>(
        (const float*)src, p, (float*)out, C, Hs, Ws, Wo);
  return (int)cudaGetLastError();
}

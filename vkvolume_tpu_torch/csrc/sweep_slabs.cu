// Per-slab plane sweep over per-cell rays (K7).
//
// Replaces the Pallas TPU kernel vkvolume_tpu/render/sweep_pallas.py:_kernel
// (called from _sweep_pallas_jit): per 8 x 128 tile, front-to-back
// compositing over slabs, one Chebyshev leap test of the tile's footprint
// per slab, trilinear samples (plane lerp, then bilinear in the plane),
// the closed-form TF (intensity, or times the gradient TF), the opacity
// correction vaf*(1-(1-a)^kappa) and ERT at alpha > 0.99. Outputs lum,
// alpha, first-hit plane and sample count. The frame runs it when the
// brick sweep (K1) cannot: fewer slabs than voxel planes, or no brick rect.
//
// What bounds it on the H100: the control work of the tile-uniform slab
// walk and the per-sample math, not DRAM bandwidth. Every slab costs the
// block one coarse-window reduction and two block votes (ERT "live", "any
// work"), and a sample reads 8 texels (4 taps x 2 planes) per volume, which
// neighbouring pixels share through L1/L2.
//
// Design:
// * The TPU kernel's tile is the CUDA block: 128 x 4 threads, each thread
//   one pixel column and two rows of the tile, with its pixels' state in
//   registers (tile_block.cuh).
// * The slab walk (slab range, occupied range, next_valid, leap_target,
//   window_min_d) depends only on block-reduced bounds of the tile's
//   covered rays, so every thread computes the same scalars; the window
//   minimum over the coarse map is a block reduction, the ERT and "any
//   work" tests are __syncthreads_or. This keeps the sampled slabs, hence
//   nsamp and the first-hit planes, the TPU kernel's. TPU details that
//   decide which slabs are sampled are kept: the 16-row coarse window
//   with its "taller than 16 rows -> occupied" rule (sweep_pallas.py:
//   198-208), the pair-wide footprint (:179-188), leap_target's formula
//   (:214-228); the wrapper pools the coarse map as the TPU's (<= 128
//   columns, >= 8 voxels along v; :565-583).
// * TPU details that cannot change a result are dropped: the 256-lane
//   rect DMA with its aligned bases and the padded extents Sv_pad/Su_pad
//   (the plan sizes R so that every covered sample lies in the rect; here
//   texels are read straight from the volume), the 4-deep prefetch ring
//   (:286-297, :472-477, :490-496; its slab sequence is the same chain of
//   next_valid calls, which this loop walks one by one), and the separable
//   (8,R)@(R,128) tent matmul (:393-437; the tent weights are non-zero on
//   at most two rows, so it is the per-pixel bilinear sum w0*c0 + w1*c1).
// * The index arithmetic is the TPU kernel's (:323-338): qu not clamped
//   before floor, iu0 = clip(floor(qu), 0, Su-1), iu1 = min(iu0+1, Su-1),
//   fu = clip(qu - floor(qu), 0, 1); qv clamped to [0, Sv-1]; the plane
//   pair k0 = clip(floor(s*Np - 0.5), 0, Np-2) lerped in float32 (no
//   fixed-point packing, unlike K1). With `separable` each tile row takes
//   its v coordinate from the tile's first column, as the TPU's separable
//   sampler does.
// * Built without fast math and with -fmad=false: every multiply and add is
//   rounded as in the plain PyTorch version (sweep_slabs_plain), so the two
//   agree bit for bit, and powf stays exact.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_block.cuh"

// Launch scalars; mirrored field for field by cuda_build.SlabParams.
struct SlabParams {
  int Np, Sv, Su;              // transposed volume (Np, Sv, Su) u8
  int H, W;                    // image (H % 8 == 0, W % 128 == 0)
  int bp_p, CV, CU, CVp, mp;   // coarse leap map (mp, CVp, 128) u8
  int n_slabs, ert, count_samples, use_gradient, separable;
  float o_u, o_v, o_p, ds, imin, iinv, vaf;
  float inv_cvox_v, inv_cvox_u, drift_u, drift_v;
  float gmin, ginv;            // gradient TF (use_gradient)
};

namespace {

constexpr int kTileH = 8;
constexpr int kPPT = kTileH / kRows;        // pixels per thread

// Tile-uniform state of the slab walk (identical in every thread).
struct SlabWalk {
  SlabParams p;
  const uint8_t* coarse;
  float wu_min, wu_max, wv_min, wv_max, rate, inv_dsNp;
  int sgn, d_pair, k_end;

  __device__ float slab_s(int k) const { return ((float)k + 0.5f) * p.ds; }
  // First voxel plane of slab k's plane pair.
  __device__ int k0_of(int k) const {
    return clampi(f2i(floorf(slab_s(k) * (float)p.Np - 0.5f)), 0, p.Np - 2);
  }
  __device__ bool in_range(int k) const {
    return sgn > 0 ? k < k_end : k > k_end;
  }
  // Texel-coordinate bounds of the tile's footprint on slab k.
  __device__ void bounds(int k, float& qu_lo, float& qu_hi, float& qv_lo,
                         float& qv_hi) const {
    const float t = slab_s(k) - p.o_p;
    qu_lo = (p.o_u + fminf(wu_min * t, wu_max * t)) * (float)p.Su - 0.5f;
    qu_hi = (p.o_u + fmaxf(wu_min * t, wu_max * t)) * (float)p.Su - 0.5f;
    qv_lo = (p.o_v + fminf(wv_min * t, wv_max * t)) * (float)p.Sv - 0.5f;
    qv_hi = (p.o_v + fmaxf(wv_min * t, wv_max * t)) * (float)p.Sv - 0.5f;
  }

  // Min pooled map value over the tile's dilated footprint on slab k's map
  // planes; the footprint is the union of slab k's and that of the slab two
  // map planes ahead. 0: an occupied cell may be in the footprint (or the
  // window is taller than the TPU kernel's 16-row view); d >= 1: every cell
  // within Chebyshev d-1 of the footprint is empty.
  __device__ int window_min_d(int k, Scratch& sh) const {
    const int kc = clampi(k, 0, p.n_slabs - 1);
    const int k2 = clampi(kc + (sgn > 0 ? d_pair : -d_pair), 0,
                          p.n_slabs - 1);
    float a1, b1, c1, e1, a2, b2, c2, e2;
    bounds(kc, a1, b1, c1, e1);
    bounds(k2, a2, b2, c2, e2);
    const float qu_lo = fminf(a1, a2), qu_hi = fmaxf(b1, b2);
    const float qv_lo = fminf(c1, c2), qv_hi = fmaxf(e1, e2);
    const int m0 = clampi(floordiv(k0_of(kc), p.bp_p), 0, p.mp - 1);
    const int cv_lo = clampi(f2i(floorf((qv_lo - 1.0f) * p.inv_cvox_v)), 0,
                             p.CV - 1);
    const int cv_hi = clampi(f2i(floorf((qv_hi + 2.0f) * p.inv_cvox_v)), 0,
                             p.CV - 1);
    const int cu_lo = clampi(f2i(floorf((qu_lo - 1.0f) * p.inv_cvox_u)), 0,
                             p.CU - 1);
    const int cu_hi = clampi(f2i(floorf((qu_hi + 2.0f) * p.inv_cvox_u)), 0,
                             p.CU - 1);
    const int cv8 = clampi(floordiv(cv_lo, 8) * 8, 0, max(p.CVp - 16, 0));
    if (cv_hi > cv8 + 15) return 0;                  // uniform: no reduction
    int v = 255;
    const int col = threadIdx.x;
    if (col >= cu_lo && col <= cu_hi) {
      for (int r = threadIdx.y; r < 16; r += kRows) {
        const int row = cv8 + r;
        if (row >= cv_lo && row <= cv_hi)
          v = min(v, (int)coarse[((size_t)m0 * p.CVp + row) * kTileW + col]);
      }
    }
    return block_min_int(v, sh);
  }

  // The slab past the empty Chebyshev ball of radius d-1 around slab k's
  // footprint (conservative: may land one slab short, never past an
  // occupied slab).
  __device__ int leap_target(int k, int d) const {
    const int P = f2i(floorf(((float)d - 1.0f) / rate));
    const int c0 = floordiv(k0_of(k), p.bp_p);
    if (sgn > 0)
      return max(k + 1, f2i(floorf(
          ((float)((c0 + P + 1) * p.bp_p - 2) + 1.5f) * inv_dsNp - 0.5f)));
    return min(k - 1, f2i(ceilf(
        ((float)((c0 - P) * p.bp_p) + 0.5f) * inv_dsNp - 0.5f)) - 1);
  }

  // First slab from k on (in sweep order) whose footprint holds an
  // occupied map cell, leaping over empty space.
  __device__ int next_valid(int k, Scratch& sh) const {
    while (in_range(k)) {
      const int d = window_min_d(k, sh);
      if (d == 0) return k;
      k = leap_target(k, d);
    }
    return k;
  }
};

// One tap: the plane lerp of texel `off` of plane0 and the next plane.
__device__ __forceinline__ float tap(const uint8_t* __restrict__ plane0,
                                     size_t plane_sz, float fp, size_t off) {
  const float a = (float)__ldg(plane0 + off);
  const float b = (float)__ldg(plane0 + plane_sz + off);
  return a * (1.0f - fp) + b * fp;
}

// Trilinear sample in [0, 1]: rows o0/o1, columns iu0/iu1, weights fu (u)
// and w0/w1 (the tent weights of the two rows).
__device__ __forceinline__ float trilinear(const uint8_t* __restrict__ plane0,
                                           size_t plane_sz, float fp,
                                           size_t o0, size_t o1, int iu0,
                                           int iu1, float fu, float w0,
                                           float w1) {
  const float v00 = tap(plane0, plane_sz, fp, o0 + iu0);
  const float v01 = tap(plane0, plane_sz, fp, o0 + iu1);
  const float v10 = tap(plane0, plane_sz, fp, o1 + iu0);
  const float v11 = tap(plane0, plane_sz, fp, o1 + iu1);
  const float c0 = v00 + (v01 - v00) * fu;
  const float c1 = v10 + (v11 - v10) * fu;
  return (w0 * c0 + w1 * c1) * kInv255;
}

template <bool GRAD>
__global__ void __launch_bounds__(kThreads)
sweep_slabs_kernel(const float* __restrict__ wu, const float* __restrict__ wv,
                   const float* __restrict__ s_lo_g,
                   const float* __restrict__ s_hi_g,
                   const float* __restrict__ kappa_g,
                   const uint8_t* __restrict__ cov_g,
                   const uint8_t* __restrict__ coarse,
                   const uint8_t* __restrict__ vol,
                   const uint8_t* __restrict__ grad,
                   const int* __restrict__ meta,
                   float* __restrict__ lum_o, float* __restrict__ alpha_o,
                   float* __restrict__ firsts_o, int* __restrict__ nsamp_o,
                   SlabParams p) {
  __shared__ Scratch sh;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y0 = blockIdx.y * kTileH;
  const size_t W = (size_t)p.W;

  float wur[kPPT], wvq[kPPT], slo[kPPT], shi[kPPT], kap[kPPT];
  bool cv[kPPT];
  float lum[kPPT], alp[kPPT], fst[kPPT];
  int ns[kPPT];
  float r_slo = kBig, r_shi = -kBig, r_wu0 = kBig, r_wu1 = -kBig;
  float r_wv0 = kBig, r_wv1 = -kBig;
  bool r_any = false;
#pragma unroll
  for (int i = 0; i < kPPT; ++i) {
    const int y = y0 + threadIdx.y + kRows * i;
    const size_t idx = y * W + x;
    const float wvv = wv[idx];
    wur[i] = wu[idx];
    wvq[i] = p.separable ? wv[y * W + blockIdx.x * kTileW] : wvv;
    slo[i] = s_lo_g[idx];
    shi[i] = s_hi_g[idx];
    kap[i] = kappa_g[idx];
    cv[i] = cov_g[idx] != 0;
    if (cv[i]) {
      r_slo = fminf(r_slo, slo[i]);
      r_shi = fmaxf(r_shi, shi[i]);
      r_wu0 = fminf(r_wu0, wur[i]);
      r_wu1 = fmaxf(r_wu1, wur[i]);
      r_wv0 = fminf(r_wv0, wvv);
      r_wv1 = fmaxf(r_wv1, wvv);
      r_any = true;
    }
    lum[i] = 0.0f;
    alp[i] = 0.0f;
    fst[i] = 2.0f;
    ns[i] = 0;
  }

  if (__syncthreads_or(r_any)) {                  // uniform branch
    SlabWalk T;
    T.p = p;
    T.coarse = coarse;
    T.sgn = meta[2];
    const float s_lo_t = block_min(r_slo, sh);
    const float s_hi_t = block_max(r_shi, sh);
    T.wu_min = block_min(r_wu0, sh);
    T.wu_max = block_max(r_wu1, sh);
    T.wv_min = block_min(r_wv0, sh);
    T.wv_max = block_max(r_wv1, sh);
    T.rate = fmaxf(1.0f, fmaxf(fmaxf(fabsf(T.wu_min), fabsf(T.wu_max))
                                   * p.drift_u,
                               fmaxf(fabsf(T.wv_min), fabsf(T.wv_max))
                                   * p.drift_v));
    T.inv_dsNp = 1.0f / (p.ds * (float)p.Np);    // slabs per voxel plane
    // Slabs per two map planes along p.
    T.d_pair = f2i(ceilf(2.0f * (float)p.bp_p / (p.ds * (float)p.Np)));

    // Slab range covering [s_lo_t, s_hi_t], clamped to the occupied range.
    int k_a = f2i(floorf(s_lo_t / p.ds - 0.5f));
    int k_b = f2i(ceilf(s_hi_t / p.ds - 0.5f));
    k_a = clampi(max(k_a, meta[0]), 0, p.n_slabs - 1);
    k_b = clampi(min(k_b, meta[1]), 0, p.n_slabs - 1);
    int k;
    if (T.sgn > 0) {
      k = k_a;
      T.k_end = k_b + 1;
    } else {
      k = k_b;
      T.k_end = k_a - 1;
    }
    const float Suf = (float)p.Su, Svf = (float)p.Sv, Npf = (float)p.Np;
    const size_t plane_sz = (size_t)p.Sv * p.Su;

    k = T.next_valid(k, sh);
    while (T.in_range(k)) {
      if (p.ert) {                                 // any covered pixel live?
        bool live = false;
#pragma unroll
        for (int i = 0; i < kPPT; ++i) live = live || (cv[i] && alp[i] <= 0.99f);
        if (!__syncthreads_or(live)) break;
      }
      const float s = T.slab_s(k);
      bool work = false;
#pragma unroll
      for (int i = 0; i < kPPT; ++i)
        work = work || (cv[i] && s >= slo[i] && s <= shi[i]
                        && (!p.ert || alp[i] <= 0.99f));
      if (__syncthreads_or(work)) {
        const float t = s - p.o_p;
        const float zp = s * Npf - 0.5f;
        const int k0 = clampi(f2i(floorf(zp)), 0, p.Np - 2);
        const float fp = clampf(zp - (float)k0, 0.0f, 1.0f);
        const size_t plane_off = (size_t)k0 * plane_sz;
#pragma unroll
        for (int i = 0; i < kPPT; ++i) {
          bool in_rng = cv[i] && s >= slo[i] && s <= shi[i];
          if (p.ert) in_rng = in_rng && alp[i] <= 0.99f;
          if (p.count_samples) ns[i] += in_rng ? 1 : 0;
          if (!in_rng) continue;
          const float qu = (p.o_u + wur[i] * t) * Suf - 0.5f;
          const float flu = floorf(qu);
          const int iu0 = clampi(f2i(flu), 0, p.Su - 1);
          const int iu1 = min(iu0 + 1, p.Su - 1);
          const float fu = clampf(qu - flu, 0.0f, 1.0f);
          const float qv = clampf((p.o_v + wvq[i] * t) * Svf - 0.5f, 0.0f,
                                  Svf - 1.0f);
          const int r0 = clampi(f2i(floorf(qv)), 0, p.Sv - 1);
          const int r1 = min(r0 + 1, p.Sv - 1);
          const float w0 = fmaxf(0.0f, 1.0f - fabsf(qv - (float)r0));
          const float w1 = fmaxf(0.0f, 1.0f - fabsf(qv - (float)(r0 + 1)));
          const size_t o0 = (size_t)r0 * p.Su, o1 = (size_t)r1 * p.Su;
          const float intensity = trilinear(vol + plane_off, plane_sz, fp,
                                            o0, o1, iu0, iu1, fu, w0, w1);
          float a_tf = clampf((intensity - p.imin) * p.iinv, 0.0f, 1.0f);
          if (!(a_tf > 0.0f)) continue;
          if (GRAD) {
            // A zero intensity alpha skips these taps: the product is 0.
            const float gradient = trilinear(grad + plane_off, plane_sz, fp,
                                             o0, o1, iu0, iu1, fu, w0, w1);
            a_tf = a_tf * clampf((gradient - p.gmin) * p.ginv, 0.0f, 1.0f);
            if (!(a_tf > 0.0f)) continue;
          }
          const float a_corr = clampf(
              p.vaf * (1.0f - powf(1.0f - a_tf, kap[i])), 0.0f, 1.0f);
          const float one_m = 1.0f - alp[i];
          lum[i] = lum[i] + one_m * a_tf * a_corr;
          float na = alp[i] + one_m * a_corr;
          if (a_corr > 0.0f && fst[i] > 1.5f) fst[i] = s;
          if (p.ert && na > 0.99f) na = 1.0f;
          alp[i] = na;
        }
      }
      k = T.next_valid(k + T.sgn, sh);
    }
  }

#pragma unroll
  for (int i = 0; i < kPPT; ++i) {
    const size_t idx = (y0 + threadIdx.y + kRows * i) * W + x;
    lum_o[idx] = lum[i];
    alpha_o[idx] = alp[i];
    firsts_o[idx] = fst[i];
    nsamp_o[idx] = ns[i];
  }
}

}  // namespace

extern "C" int vkv_sweep_slabs(const void* wu, const void* wv,
                               const void* s_lo, const void* s_hi,
                               const void* kappa, const void* cov,
                               const void* coarse, const void* vol,
                               const void* grad, const void* meta, void* lum,
                               void* alpha, void* firsts, void* nsamp,
                               SlabParams p, void* stream) {
  if (p.H <= 0 || p.W <= 0) return 0;
  if (p.H % kTileH || p.W % kTileW) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileW, kRows);
  const dim3 grid(p.W / kTileW, p.H / kTileH);
  const cudaStream_t s = (cudaStream_t)stream;
#define VKV_LAUNCH(GRAD)                                                    \
  sweep_slabs_kernel<GRAD><<<grid, block, 0, s>>>(                          \
      (const float*)wu, (const float*)wv, (const float*)s_lo,              \
      (const float*)s_hi, (const float*)kappa, (const uint8_t*)cov,        \
      (const uint8_t*)coarse, (const uint8_t*)vol, (const uint8_t*)grad,   \
      (const int*)meta, (float*)lum, (float*)alpha, (float*)firsts,        \
      (int*)nsamp, p)
  if (p.use_gradient) VKV_LAUNCH(true); else VKV_LAUNCH(false);
#undef VKV_LAUNCH
  return (int)cudaGetLastError();
}

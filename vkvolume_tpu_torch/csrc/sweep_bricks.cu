// Brick-batched plane sweep over separable w-grid rays (K1).
//
// Replaces the Pallas TPU kernel vkvolume_tpu/render/sweep_bricks.py:_kernel
// (called from _sweep_bricks_jit): per tile_h x 128 tile of the w-grid
// image, front-to-back compositing over 8-slab bricks, with one tight ESS
// check and one Chebyshev leap per brick, bilinear in-plane samples, the
// closed-form TF, the opacity correction vaf*(1-(1-a)^kappa) and ERT at
// alpha > 0.99. Outputs lum, alpha, first-hit plane and sample count.
//
// What bounds it on the H100: the texel gathers and the per-sample math
// (one powf per contributing sample), not DRAM bandwidth: the samples read
// a few tens of MB of the volume, in the footprint of each tile's rays,
// which neighbouring pixels share through L1/L2.
//
// Design: two kernels (tile_walk.cuh).
// * brick_walk_kernel: one warp per tile computes the tile's visited bricks
//   in sweep order: the occupied brick range, then the chain of next_valid
//   (the tight cskip window, then the coarse window and leap_target) over
//   the tile's reduced ray bounds, exactly the TPU kernel's, so the sampled
//   bricks, hence nsamp and the first-hit planes, are its too. The chain
//   is followed 32 probes at a time (walk_tile).
// * sweep_bricks_kernel: one thread per pixel, 128 x 2 per block. Each warp
//   runs down its tile's list; a brick none of its pixels needs is skipped
//   by a vote, and the warp leaves when every pixel is opaque (ERT),
//   uncovered or past its slab range. No barrier: blocks of one tile
//   share nothing but the list.
// * Texels are read straight from the volume in global memory: the TPU
//   kernel's rect DMA ring, i32 texel-pair packing and MXU tent dot are
//   devices the card does not need. The tent weights are non-zero on at
//   most two rows, so the v interpolation is a two-row weighted sum.
// * The index arithmetic is the TPU kernel's (sweep_bricks.py:421-453): qu
//   (from the tile's row 0, the separable sampler) is not clamped before
//   floor, iu0 = clip(floor(qu), 0, Su-1), iu1 = min(iu0+1, Su-1) with fu
//   zeroed where iu1 == iu0, and qv (from the tile's column 0) is clamped
//   to [0, Sv-1]. Not clamp-to-edge bilinear semantics.
// * Built without fast math and with -fmad=false: every multiply and add is
//   rounded as in the plain PyTorch version (sweep_bricks_reference), so
//   the two agree bit for bit, and powf stays exact. This matters most in
//   the plane-pair lerp: zp = s*Np - 0.5 picks the plane pair and
//   (a*(1-fp) + b*fp)*256 is rounded to u8.8 fixed point (rintf, half to
//   even, as jnp.round); a contracted FMA there moves a texel or an LSB.
// * Variants are template parameters of the compositing kernel: ALIGNED
//   (one slab per voxel plane, n_slabs == Np, no plane lerp) or the
//   plane-pair lerp (sweep_bricks.py:380-387, :443-447), and GRAD, the
//   gradient-modulated TF (:469-480): the gradient map sampled by the same
//   taps, a_tf scaled by clip((g - gmin)*ginv, 0, 1). A sample whose
//   intensity alpha is 0 skips the gradient taps (its product is 0 either
//   way).
// Not ported: the texture-TF variant.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_walk.cuh"

// Launch scalars; mirrored field for field by cuda_build.BrickParams.
struct BrickParams {
  int Np, Sv, Su;          // transposed volume (Np, Sv, Su) u8
  int H, W, tile_h;        // w-grid image and tile height
  int bp_p, CV, CU, CVp, mp;   // coarse maps (mp, CVp, 128) u8
  int n_slabs, sgn, ert, count_samples;
  int aligned, use_gradient;   // the template variant the wrapper picked
  float o_u, o_v, o_p, ds, imin, iinv, vaf;
  float inv_cvox_v, inv_cvox_u, drift_u, drift_v;
  float gmin, ginv;            // gradient TF (use_gradient)
};

namespace {

constexpr int kBrick = 8;

__device__ __forceinline__ float slab_s(const BrickParams& p, int k) {
  return ((float)k + 0.5f) * p.ds;
}

// Tile-uniform state of the brick walk (identical in every lane).
struct Walk {
  BrickParams p;
  const uint8_t* coarse;
  const uint8_t* cskip;
  float wu_min, wu_max, wv_min, wv_max, rate, inv_dsNp;
  int d_pair, kb_end;

  // First voxel plane of slab k's plane pair.
  __device__ int k0_of(int k) const {
    if (p.aligned) return clampi(k, 0, p.Np - 2);
    return clampi(f2i(floorf(slab_s(p, k) * (float)p.Np - 0.5f)), 0,
                  p.Np - 2);
  }
  __device__ bool in_range(int kb) const {
    return p.sgn > 0 ? kb < kb_end : kb > kb_end;
  }

  // Union rect (texel coords) of the endpoint slabs k1, k2: it contains
  // every intermediate slab's rect.
  __device__ void bounds(int k1, int k2, float& qu_lo, float& qu_hi,
                         float& qv_lo, float& qv_hi) const {
    const float t1 = slab_s(p, k1) - p.o_p;
    const float t2 = slab_s(p, k2) - p.o_p;
    const float ulo = fminf(fminf(wu_min * t1, wu_max * t1),
                            fminf(wu_min * t2, wu_max * t2));
    const float uhi = fmaxf(fmaxf(wu_min * t1, wu_max * t1),
                            fmaxf(wu_min * t2, wu_max * t2));
    const float vlo = fminf(fminf(wv_min * t1, wv_max * t1),
                            fminf(wv_min * t2, wv_max * t2));
    const float vhi = fmaxf(fmaxf(wv_min * t1, wv_max * t1),
                            fmaxf(wv_min * t2, wv_max * t2));
    qu_lo = (p.o_u + ulo) * (float)p.Su - 0.5f;
    qu_hi = (p.o_u + uhi) * (float)p.Su - 0.5f;
    qv_lo = (p.o_v + vlo) * (float)p.Sv - 0.5f;
    qv_hi = (p.o_v + vhi) * (float)p.Sv - 0.5f;
  }

  // First brick after leaping over the empty Chebyshev ball of radius d-1
  // around the window (conservative: never skips an occupied brick).
  __device__ int leap_target(int kb, int d) const {
    const int P = f2i(floorf(((float)d - 1.0f) / rate));
    if (p.sgn > 0) {
      const int c0 = floordiv(k0_of(kb * kBrick), p.bp_p);
      const int k_tgt = f2i(floorf(
          ((float)((c0 + P + 1) * p.bp_p - 2) + 1.5f) * inv_dsNp - 0.5f));
      return max(kb + 1, floordiv(k_tgt, kBrick));
    }
    const int k2 = min(kb * kBrick + kBrick - 1, p.n_slabs - 1);
    const int c0 = floordiv(k0_of(k2), p.bp_p);
    const int k_tgt = f2i(ceilf(
        ((float)((c0 - P) * p.bp_p) + 0.5f) * inv_dsNp - 0.5f)) - 1;
    return min(kb - 1, floordiv(k_tgt, kBrick));
  }

  // One step of the TPU kernel's next_valid: true when brick kb's tight
  // window holds an occupied cell, else next = the brick past the empty
  // space around its coarse window.
  __device__ bool probe(int kb, int& next) const {
    const int k1 = kb * kBrick;
    const int k2 = min(k1 + kBrick - 1, p.n_slabs - 1);
    float a, b, c, e;
    bounds(k1, k2, a, b, c, e);
    const int m_lo = clampi(floordiv(k0_of(k1), p.bp_p), 0, p.mp - 1);
    if (window_min(p, cskip, m_lo, a, b, c, e) == 0) return true;
    int ka, kc, k_front;
    if (p.sgn > 0) {
      ka = k1;
      kc = clampi(k2 + d_pair, 0, p.n_slabs - 1);
      k_front = k1;
    } else {
      ka = clampi(k1 - d_pair, 0, p.n_slabs - 1);
      kc = k2;
      k_front = k2;
    }
    bounds(ka, kc, a, b, c, e);
    const int m0 = clampi(floordiv(k0_of(k_front), p.bp_p), 0, p.mp - 1);
    next = leap_target(kb, window_min(p, coarse, m0, a, b, c, e));
    return false;
  }
};

// One warp per tile: cnt[tile] visited bricks, in sweep order, in
// lst[tile * n_bricks ...].
__global__ void __launch_bounds__(kWalkWarps * 32)
brick_walk_kernel(const float* __restrict__ wu, const float* __restrict__ wv,
                  const float* __restrict__ s_lo_g,
                  const float* __restrict__ s_hi_g,
                  const uint8_t* __restrict__ cov_g,
                  const uint8_t* __restrict__ coarse,
                  const uint8_t* __restrict__ cskip,
                  const int* __restrict__ kb_occ, int* __restrict__ cnt,
                  int16_t* __restrict__ lst, BrickParams p) {
  TileBounds b;
  if (!tile_bounds(wu, wv, s_lo_g, s_hi_g, cov_g, p.H, p.W, p.tile_h, b))
    return;                                        // warp-uniform
  const int n_bricks = (p.n_slabs + kBrick - 1) / kBrick;
  int16_t* out = lst + (size_t)b.tile * n_bricks;
  int n = 0;
  if (b.any) {
    Walk T;
    T.p = p;
    T.coarse = coarse;
    T.cskip = cskip;
    T.wu_min = b.wu_min;
    T.wu_max = b.wu_max;
    T.wv_min = b.wv_min;
    T.wv_max = b.wv_max;
    T.rate = fmaxf(1.0f, fmaxf(fmaxf(fabsf(T.wu_min), fabsf(T.wu_max))
                                   * p.drift_u,
                               fmaxf(fabsf(T.wv_min), fabsf(T.wv_max))
                                   * p.drift_v));
    T.inv_dsNp = 1.0f / (p.ds * (float)p.Np);    // slabs per voxel plane
    T.d_pair = f2i(ceilf(2.0f * (float)p.bp_p * T.inv_dsNp));

    // Brick range covering [s_lo, s_hi] and the occupied range.
    const int k_a = f2i(floorf(b.s_lo / p.ds - 0.5f));
    const int k_b = f2i(ceilf(b.s_hi / p.ds - 0.5f));
    const int kb_a = clampi(max(floordiv(k_a, kBrick), kb_occ[0]), 0,
                            n_bricks - 1);
    const int kb_b = clampi(min(floordiv(k_b, kBrick), kb_occ[1]), 0,
                            n_bricks - 1);
    T.kb_end = p.sgn > 0 ? kb_b + 1 : kb_a - 1;
    n = walk_tile(T, p.sgn > 0 ? kb_a : kb_b, p.sgn, out);
  }
  if ((threadIdx.x & 31) == 0) cnt[b.tile] = n;
}

// Bilinear sample (intensity or gradient, in [0, 1]) of the plane pair at
// plane0 (plane1 = the next plane, read only when !ALIGNED, lerped with
// weight fp and quantised to u8.8): texel rows o0 and o1, columns iu0 and
// iu1, in-plane weights fu (u) and w0, w1 (v).
template <bool ALIGNED>
__device__ __forceinline__ float bilinear(const uint8_t* __restrict__ plane0,
                                          size_t plane_sz, float fp,
                                          size_t o0, size_t o1, int iu0,
                                          int iu1, float fu, float w0,
                                          float w1) {
  float v[4];
  const size_t off[4] = {o0 + iu0, o0 + iu1, o1 + iu0, o1 + iu1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float a = (float)__ldg(plane0 + off[t]);
    if (ALIGNED) {
      v[t] = a;
    } else {
      const float b = (float)__ldg(plane0 + plane_sz + off[t]);
      v[t] = rintf((a * (1.0f - fp) + b * fp) * 256.0f) * (1.0f / 256.0f);
    }
  }
  const float c0 = v[0] + (v[1] - v[0]) * fu;
  const float c1 = v[2] + (v[3] - v[2]) * fu;
  return (w0 * c0 + w1 * c1) * kInv255;
}

// One thread per pixel; the pixel's tile's brick list from the walk.
template <bool GRAD, bool ALIGNED>
__global__ void __launch_bounds__(kTileW * kRowsPerBlock)
sweep_bricks_kernel(const float* __restrict__ wu, const float* __restrict__ wv,
                    const float* __restrict__ s_lo_g,
                    const float* __restrict__ s_hi_g,
                    const float* __restrict__ kappa_g,
                    const uint8_t* __restrict__ cov_g,
                    const uint8_t* __restrict__ vol,
                    const uint8_t* __restrict__ grad,
                    const int* __restrict__ cnt,
                    const int16_t* __restrict__ lst,
                    float* __restrict__ lum_o, float* __restrict__ alpha_o,
                    float* __restrict__ firsts_o, int* __restrict__ nsamp_o,
                    BrickParams p) {
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kRowsPerBlock + threadIdx.y;
  const int y0 = (y / p.tile_h) * p.tile_h;
  const int tile = (y / p.tile_h) * (p.W / kTileW) + blockIdx.x;
  const size_t W = (size_t)p.W;
  const size_t idx = y * W + x;
  const int lane = threadIdx.x & 31;

  const float slo = s_lo_g[idx], shi = s_hi_g[idx], kap = kappa_g[idx];
  const bool cv = cov_g[idx] != 0;
  const float wvr = wv[y * W + blockIdx.x * kTileW];   // v math: column 0
  const float wu_c = wu[y0 * W + x];                    // u math: row 0
  float lum = 0.0f, alp = 0.0f, fst = 2.0f;
  int ns = 0;

  const int n_bricks = (p.n_slabs + kBrick - 1) / kBrick;
  const int16_t* list = lst + (size_t)tile * n_bricks;
  const int n = cnt[tile];
  const float Suf = (float)p.Su, Svf = (float)p.Sv;
  const size_t plane_sz = (size_t)p.Sv * p.Su;
  bool done = false;
  for (int base = 0; base < n && !done; base += 32) {
    const int mine = base + lane < n ? list[base + lane] : 0;
    const int m = min(32, n - base);
    for (int e = 0; e < m; ++e) {
      const int kb = __shfl_sync(kFull, mine, e);
      const float s_first = slab_s(p, kb * kBrick);
      const float s_last = slab_s(p, min(kb * kBrick + kBrick - 1,
                                         p.n_slabs - 1));
      const float sb_lo = fminf(s_first, s_last);
      const float sb_hi = fmaxf(s_first, s_last);
      // Can this pixel take a sample in this brick or a later one?
      const bool live = cv && (!p.ert || alp <= 0.99f);
      const bool ahead = p.sgn > 0 ? sb_lo <= shi : sb_hi >= slo;
      if (!__any_sync(kFull, live && ahead)) {
        done = true;
        break;
      }
      if (!__any_sync(kFull, live && sb_hi >= slo && sb_lo <= shi))
        continue;
      for (int jj = 0; jj < kBrick; ++jj) {
        const int j = p.sgn > 0 ? jj : kBrick - 1 - jj;
        const int k = kb * kBrick + j;
        const float s = slab_s(p, k);
        const float t = s - p.o_p;
        bool in_rng = cv && s >= slo && s <= shi && k < p.n_slabs;
        if (p.ert) in_rng = in_rng && alp <= 0.99f;
        if (p.count_samples) ns += in_rng ? 1 : 0;
        if (!in_rng) continue;
        const float qu = (p.o_u + wu_c * t) * Suf - 0.5f;
        const float flu = floorf(qu);
        const int iu0 = clampi(f2i(flu), 0, p.Su - 1);
        const int iu1 = min(iu0 + 1, p.Su - 1);
        float fu = clampf(qu - flu, 0.0f, 1.0f);
        if (iu1 <= iu0) fu = 0.0f;   // right edge: second tap = first
        // Plane pair (kk0, kk0 + 1) and its lerp weight.
        int kk0;
        float fp = 0.0f;
        if (ALIGNED) {
          kk0 = clampi(k, 0, p.Np - 2);
        } else {
          const float zp = s * (float)p.Np - 0.5f;
          kk0 = clampi(f2i(floorf(zp)), 0, p.Np - 2);
          fp = clampf(zp - (float)kk0, 0.0f, 1.0f);
        }
        const size_t plane_off = (size_t)kk0 * plane_sz;
        const float qv = clampf((p.o_v + wvr * t) * Svf - 0.5f, 0.0f,
                                Svf - 1.0f);
        const int r0 = clampi(f2i(floorf(qv)), 0, p.Sv - 1);
        const int r1 = min(r0 + 1, p.Sv - 1);
        const float w0 = fmaxf(0.0f, 1.0f - fabsf(qv - (float)r0));
        const float w1 = fmaxf(0.0f, 1.0f - fabsf(qv - (float)(r0 + 1)));
        const size_t o0 = (size_t)r0 * p.Su, o1 = (size_t)r1 * p.Su;
        const float intensity = bilinear<ALIGNED>(
            vol + plane_off, plane_sz, fp, o0, o1, iu0, iu1, fu, w0, w1);
        float a_tf = clampf((intensity - p.imin) * p.iinv, 0.0f, 1.0f);
        if (!(a_tf > 0.0f)) continue;
        if (GRAD) {
          const float gradient = bilinear<ALIGNED>(
              grad + plane_off, plane_sz, fp, o0, o1, iu0, iu1, fu, w0, w1);
          a_tf = a_tf * clampf((gradient - p.gmin) * p.ginv, 0.0f, 1.0f);
          if (!(a_tf > 0.0f)) continue;
        }
        const float a_corr = clampf(
            p.vaf * (1.0f - powf(1.0f - a_tf, kap)), 0.0f, 1.0f);
        const float one_m = 1.0f - alp;
        lum = lum + one_m * a_tf * a_corr;
        float na = alp + one_m * a_corr;
        if (a_corr > 0.0f && fst > 1.5f) fst = s;
        if (p.ert && na > 0.99f) na = 1.0f;
        alp = na;
      }
    }
  }
  lum_o[idx] = lum;
  alpha_o[idx] = alp;
  firsts_o[idx] = fst;
  nsamp_o[idx] = ns;
}

}  // namespace

extern "C" int vkv_brick_walk(const void* wu, const void* wv,
                              const void* s_lo, const void* s_hi,
                              const void* cov, const void* coarse,
                              const void* cskip, const void* kb_occ,
                              void* cnt, void* lst, BrickParams p,
                              void* stream) {
  if (p.H <= 0 || p.W <= 0) return 0;
  if (p.H % p.tile_h || p.W % kTileW) return (int)cudaErrorInvalidValue;
  const int tiles = (p.H / p.tile_h) * (p.W / kTileW);
  brick_walk_kernel<<<(tiles + kWalkWarps - 1) / kWalkWarps,
                      kWalkWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)wu, (const float*)wv, (const float*)s_lo,
      (const float*)s_hi, (const uint8_t*)cov, (const uint8_t*)coarse,
      (const uint8_t*)cskip, (const int*)kb_occ, (int*)cnt, (int16_t*)lst,
      p);
  return (int)cudaGetLastError();
}

extern "C" int vkv_sweep_bricks(const void* wu, const void* wv,
                                const void* s_lo, const void* s_hi,
                                const void* kappa, const void* cov,
                                const void* vol, const void* grad,
                                const void* cnt, const void* lst, void* lum,
                                void* alpha, void* firsts, void* nsamp,
                                BrickParams p, void* stream) {
  if (p.H <= 0 || p.W <= 0) return 0;
  if (p.H % p.tile_h || p.tile_h % kRowsPerBlock || p.W % kTileW)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kTileW, kRowsPerBlock);
  const dim3 grid(p.W / kTileW, p.H / kRowsPerBlock);
  const cudaStream_t s = (cudaStream_t)stream;
#define VKV_LAUNCH(GRAD, ALIGNED)                                           \
  sweep_bricks_kernel<GRAD, ALIGNED><<<grid, block, 0, s>>>(               \
      (const float*)wu, (const float*)wv, (const float*)s_lo,              \
      (const float*)s_hi, (const float*)kappa, (const uint8_t*)cov,        \
      (const uint8_t*)vol, (const uint8_t*)grad, (const int*)cnt,          \
      (const int16_t*)lst, (float*)lum, (float*)alpha, (float*)firsts,     \
      (int*)nsamp, p)
  if (p.use_gradient) {
    if (p.aligned) VKV_LAUNCH(true, true); else VKV_LAUNCH(true, false);
  } else {
    if (p.aligned) VKV_LAUNCH(false, true); else VKV_LAUNCH(false, false);
  }
#undef VKV_LAUNCH
  return (int)cudaGetLastError();
}

// What the two sweep kernels (K1: bricks, K7: slabs) share: the TPU
// kernels' index helpers (floor division, clamps, the float -> int
// conversion of an already floored value), and the two halves every sweep
// is split into.
//
// * The walk: one warp per tile_h x 128 tile reduces its covered rays'
//   bounds with shuffles and walks the coarse maps, writing the tile's
//   visited bricks or slabs, in sweep order, to a list (walk_tile: 32
//   candidates probed at once, one per lane). No block barrier anywhere.
// * The composite: one thread per pixel, 128 x 2 pixels per block, so a
//   tile is several blocks; each warp reads its tile's list 32 entries at a
//   time with one load and broadcasts each entry by shuffle. A warp leaves
//   the list when none of its pixels can take another sample (warp vote).
//
// The split is exact: the list depends only on the tile's reduced bounds
// and the maps, and a pixel's samples depend only on the list and the
// pixel (the "live" and "any work" tests of a tile-wide loop only skip
// samples that are out of range for every pixel).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkWarps = 4;               // tiles per walk block
constexpr int kRowsPerBlock = 2;            // composite block: 128 x 2
constexpr float kBig = 1e30f;
constexpr float kInv255 = 1.0f / 255.0f;

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
// float -> int of an already floored / ceiled value (absurd values clamp).
__device__ __forceinline__ int f2i(float x) {
  return (int)fminf(fmaxf(x, -1.0e9f), 1.0e9f);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The walk's tile: its index, origin and the min / max of the covered
// rays' slab range and w slopes (identical in every lane).
struct TileBounds {
  int tile, y0, x0;
  float s_lo, s_hi, wu_min, wu_max, wv_min, wv_max;
  bool any;
};

// The warp's tile (blockIdx.x * kWalkWarps + warp); false past the last.
__device__ __forceinline__ bool tile_bounds(
    const float* __restrict__ wu, const float* __restrict__ wv,
    const float* __restrict__ s_lo, const float* __restrict__ s_hi,
    const uint8_t* __restrict__ cov, int H, int W, int tile_h,
    TileBounds& b) {
  const int lane = threadIdx.x & 31;
  const int ntx = W / kTileW;
  b.tile = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (b.tile >= ntx * (H / tile_h)) return false;
  b.y0 = (b.tile / ntx) * tile_h;
  b.x0 = (b.tile % ntx) * kTileW;
  float r_slo = kBig, r_shi = -kBig, r_wu0 = kBig, r_wu1 = -kBig;
  float r_wv0 = kBig, r_wv1 = -kBig;
  bool r_any = false;
#pragma unroll 2
  for (int r = 0; r < tile_h; ++r) {
#pragma unroll
    for (int c = 0; c < kTileW; c += 32) {
      // Every field is loaded (all independent), then masked.
      const size_t idx = (size_t)(b.y0 + r) * W + b.x0 + c + lane;
      const bool cv = cov[idx] != 0;
      const float slo = __ldg(s_lo + idx), shi = __ldg(s_hi + idx);
      const float u = __ldg(wu + idx), v = __ldg(wv + idx);
      r_slo = cv ? fminf(r_slo, slo) : r_slo;
      r_shi = cv ? fmaxf(r_shi, shi) : r_shi;
      r_wu0 = cv ? fminf(r_wu0, u) : r_wu0;
      r_wu1 = cv ? fmaxf(r_wu1, u) : r_wu1;
      r_wv0 = cv ? fminf(r_wv0, v) : r_wv0;
      r_wv1 = cv ? fmaxf(r_wv1, v) : r_wv1;
      r_any = r_any || cv;
    }
  }
  b.s_lo = warp_min(r_slo);
  b.s_hi = warp_max(r_shi);
  b.wu_min = warp_min(r_wu0);
  b.wu_max = warp_max(r_wu1);
  b.wv_min = warp_min(r_wv0);
  b.wv_max = warp_max(r_wv1);
  b.any = __any_sync(kFull, r_any);
  return true;
}

// Min of ref[m] over the (trilinear-dilated) cell window of texel rect
// [qu_lo, qu_hi] x [qv_lo, qv_hi]; 0 when the window is taller than the
// TPU kernels' 16-row view. ref is (mp, CVp, 128) u8, read by one thread
// in 4-byte words (bytes outside the window's columns count as 255).
// P is BrickParams or SlabParams.
template <class P>
__device__ int window_min(const P& p, const uint8_t* __restrict__ ref, int m,
                          float qu_lo, float qu_hi, float qv_lo,
                          float qv_hi) {
  const int cv_lo = clampi(f2i(floorf((qv_lo - 1.0f) * p.inv_cvox_v)), 0,
                           p.CV - 1);
  const int cv_hi = clampi(f2i(floorf((qv_hi + 2.0f) * p.inv_cvox_v)), 0,
                           p.CV - 1);
  const int cu_lo = clampi(f2i(floorf((qu_lo - 1.0f) * p.inv_cvox_u)), 0,
                           p.CU - 1);
  const int cu_hi = clampi(f2i(floorf((qu_hi + 2.0f) * p.inv_cvox_u)), 0,
                           p.CU - 1);
  const int cv8 = clampi(floordiv(cv_lo, 8) * 8, 0, max(p.CVp - 16, 0));
  if (cv_hi > cv8 + 15) return 0;
  // Rows [cv_lo, cv_hi] lie in the 16-row view [cv8, cv8 + 15].
  const uint32_t* plane = reinterpret_cast<const uint32_t*>(
      ref + (size_t)m * p.CVp * kTileW);
  const int w_lo = cu_lo >> 2, w_hi = cu_hi >> 2;
  const uint32_t lo_pad = (1u << (8 * (cu_lo & 3))) - 1u;
  const uint32_t hi_pad = ~(0xFFFFFFFFu >> (8 * (3 - (cu_hi & 3))));
  uint32_t acc = 0xFFFFFFFFu;
  for (int row = cv_lo; row <= cv_hi; ++row) {
    const uint32_t* words = plane + row * (kTileW / 4);
    for (int w = w_lo; w <= w_hi; ++w) {
      uint32_t x = __ldg(words + w);
      if (w == w_lo) x |= lo_pad;
      if (w == w_hi) x |= hi_pad;
      acc = __vminu4(acc, x);
    }
  }
  return (int)min(min(acc & 255u, (acc >> 8) & 255u),
                  min((acc >> 16) & 255u, acc >> 24));
}

// The walk of one tile, in sweep order, written to out; returns its
// length. W (a brick or slab walk) gives in_range(k) and probe(k, next):
// true when candidate k's window holds an occupied cell (k is visited,
// then k + sgn is next), else next = the candidate its leap lands on.
// Each round probes the next 32 candidates at once, one per lane, and then
// follows that chain through the lanes' results: a run of occupied
// candidates is listed in one store, a leap that lands inside the round
// costs nothing more. Only probes the chain reaches count; the rest were
// speculative, so the list is the sequential walk's exactly.
template <class Walk>
__device__ int walk_tile(const Walk& W, int k, int sgn,
                         int16_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  while (W.in_range(k)) {
    const int kj = k + sgn * lane;
    const bool ok = W.in_range(kj);
    int next = kj;
    const bool occ = ok && W.probe(kj, next);
    const unsigned valid = __ballot_sync(kFull, ok);
    const unsigned occupied = __ballot_sync(kFull, occ);
    for (int j = 0;;) {
      // Lanes j, j + 1, ... while occupied: listed, in one store each.
      const unsigned rest = ~(occupied >> j);   // top j bits set
      const int run = rest == 0u ? 32 : __ffs(rest) - 1;
      if (lane >= j && lane < j + run) out[n + lane - j] = (int16_t)kj;
      n += run;
      j += run;
      if (j == 32) {                             // next round
        k += 32 * sgn;
        break;
      }
      if (!((valid >> j) & 1u)) return n;        // past the range
      const int to = __shfl_sync(kFull, next, j);
      if ((to - k) * sgn >= 32) {                // leaps past the round
        k = to;
        break;
      }
      j = (to - k) * sgn;
    }
  }
  return n;
}

}  // namespace

// The w-grid frame's glue around K1 and K2: three elementwise kernels, and
// K1's map inputs in one call of two kernels.
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA, and the
// port ran it as plain PyTorch, about 280 launches a frame and six
// synchronous host-to-device copies. The plain versions stay beside the
// kernels as the CPU path and their twins (render/frame_cuda.py:
// grid_plain, positions_plain, epilogue_plain):
// * frame_grid_kernel: one thread per w-grid cell writes the cell's w
//   (sweep_frame.w_grid: the Mobius forward map) and the fields K1 reads
//   (sweep_bricks.grid_fields: the AABB slab test, the clip-plane entry
//   clamp, the frag-exact back-face recompute, kappa).
// * frame_positions_kernel: the warp's positions from the pose. Pixel
//   tiles compute each pixel's ray (ray_setup.make_rays, _interval) and its
//   grid position (sweep_frame.pixel_grid_coords); grid blocks solve the
//   two-pass warp's first-pass positions (sweep_frame.warp_positions).
//   Variant A writes gx (H, W), xa (Hi, W) and gy transposed, gy_t
//   (W, Hp); variant B yb (Wi, Hp) and gx padded, gx_p (Hp, W); the
//   single-pass warp (K8) gx and gy (H, W).
// * frame_epilogue_kernel: one thread per grid cell reads K1's lum, alpha
//   and first-hit plane, and writes the (3, Hi, Wi) channel stack
//   [lum, alpha, depth] that the warp reads; depth is the first hit's
//   reverse-Z depth through proj_view_model (sweep_bricks.first_hit_depth).
// * brick_maps_kernel, then brick_range_kernel: K1's map inputs from the
//   (mp, mv, mu) u8 skip map (sweep_bricks.brick_maps_plain, about 40
//   PyTorch launches on the card): the coarse leap map and the tight skip
//   map, (mp, CVp, 128) u8 padded with 255, then the occupied brick range
//   (2,) int32 from per-plane flags the first kernel leaves.
//
// Every per-pose float comes by value in FrameScalars (the 142 floats of
// sweep_frame.pack_frame_scalars, under the 4 KB parameter limit), so a
// frame copies nothing to the card and waits for nothing.
//
// What bounds them on the H100: bytes. At the kingsnake's still pose (grid
// 2432 x 2304, image 1200 x 1280) the least work is 118 MB of grid fields,
// 19 MB of positions and 134 MB for the epilogue (the three maps in, the
// stack out): 0.08 ms at 3.35 TB/s, a few tens of operations per cell.
//
// K1's map inputs are bound by bytes as well: at the kingsnake's map (199 x
// 256 x 256 cells, factors 2 x 2) 13.0 MB read and 2 x 6.5 MB written, 6 us
// at 3.35 TB/s; the map fits in the L2. They are integers: the kernels
// give the plain version's bytes exactly.
//
// Rounding: the plain versions round after every PyTorch operation, so
// every multiply, add and divide here is an explicit round-to-nearest
// intrinsic in the plain chain's order, immune to contraction (the build's
// -fmad=false holds it too). Where the plain chain writes `c / x` for a
// Python scalar c, PyTorch computes reciprocal(x) * c; where it divides a
// CUDA tensor by a Python scalar, x * (1 / c): both are kept. minimum and
// maximum propagate NaN as torch.minimum / torch.maximum do. frame_grid
// and the epilogue's lum and alpha then match the plain versions on the
// card bit for bit; the epilogue's depth and the pixel rays sum matrix
// products that the plain versions leave to cuBLAS, whose order differs.

#include <cstdint>
#include <cuda_runtime.h>

// Launch scalars; mirrored field for field by cuda_build.FrameScalars.
struct FrameScalars {
  float s[142];          // pack_frame_scalars' array
  int Hi, Wi, row0;      // the grid's rows from row0, and its columns
  int H, W, Hp;          // the image, and its rows padded to 128
  int p_axis, sgn;       // the slice axis, the sweep's sign (+-1)
  int warp;              // 0: two-pass A, 1: two-pass B, 2: single-pass
  float kappa_scale;     // f32(dim_max) / f32(n_slabs)
};

// K1's map inputs' launch scalars (sweep_bricks.CoarseShape); mirrored
// field for field by cuda_build.BrickMapParams.
struct BrickMapParams {
  int mp, mv, mu;        // the skip map's planes, rows, columns
  int CV, CU, CVp;       // coarse rows and columns; rows padded
  int factor_v, factor_u;  // map cells per coarse cell along v, u
  int mp_span;           // map planes past m that the tight map spans
  int bp_p, Np, n_slabs; // voxel planes per map plane; volume planes; slabs
  int dist_leap;         // 0: the leap map clamped to {0, 1}
  float ds;              // f32(1 / n_slabs)
};

namespace {

// Offsets into pack_frame_scalars' array.
constexpr int kViewProjInv = 32, kGlobalToTex = 80, kPlaneTex = 100,
              kCamPosTex = 104, kPvm = 111, kGp = 127, kHcoef = 133;
constexpr int kBlock = 256;
constexpr int kTile = 32;          // positions: 32 x 32 pixels per tile
constexpr int kTileRows = 8;       // thread rows of a tile's block

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.maximum / torch.minimum on CUDA floats.
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// sweep_frame._SLICE_AXES: the in-plane (v, u) axes of slice axis P.
template <int P> struct Axes;
template <> struct Axes<0> { static constexpr int V = 2, U = 1; };
template <> struct Axes<1> { static constexpr int V = 2, U = 0; };
template <> struct Axes<2> { static constexpr int V = 1, U = 0; };

// The pose's floats by name (FrameScalars.s; constant offsets once inlined,
// so every read is a load from the parameter space).
__device__ __forceinline__ float gp(const FrameScalars& f, int k) {
  return f.s[kGp + k];            // wu0 dwu cu wv0 dwv cv
}
__device__ __forceinline__ float hc(const FrameScalars& f, int k) {
  return f.s[kHcoef + k];         // au bu cu av bv cv ap bp cp
}
__device__ __forceinline__ float cam(const FrameScalars& f, int a) {
  return f.s[kCamPosTex + a];
}
__device__ __forceinline__ float plane(const FrameScalars& f, int a) {
  return f.s[kPlaneTex + a];
}
// Row r of the row-major (4, 4) matrix at offset m times (x, y, z, 1),
// summed in order.
__device__ __forceinline__ float row_dot(const FrameScalars& f, int m, int r,
                                         float x, float y, float z) {
  const int k = m + 4 * r;
  return add(add(add(mul(x, f.s[k]), mul(y, f.s[k + 1])),
                 mul(z, f.s[k + 2])), f.s[k + 3]);
}

// sweep_frame._mob_fwd: w0 + dw * x / (1 - c * x).
__device__ __forceinline__ float mob_fwd(float w0, float dw, float c,
                                         float x) {
  return add(div(mul(x, dw), sub(1.0f, mul(x, c))), w0);
}

// sweep_frame._guard: a denominator kept 1e-20 away from 0, its sign kept.
__device__ __forceinline__ float guard(float den) {
  return fabsf(den) < 1e-20f ? (den < 0.0f ? -1e-20f : 1e-20f) : den;
}

// sweep_frame._mob_inv: (w - w0) / guard(dw + c * (w - w0)).
__device__ __forceinline__ float mob_inv(float w0, float dw, float c,
                                         float w) {
  return div(sub(w, w0), guard(add(mul(sub(w, w0), c), dw)));
}

// The w of grid column j and of grid row i (w_grid).
__device__ __forceinline__ float grid_wu(const FrameScalars& f, int j) {
  return mob_fwd(gp(f, 0), gp(f, 1), gp(f, 2),
                 add((float)j, 0.5f));
}
__device__ __forceinline__ float grid_wv(const FrameScalars& f, int i) {
  return mob_fwd(gp(f, 3), gp(f, 4), gp(f, 5),
                 add((float)(f.row0 + i), 0.5f));
}

// sweep_bricks.grid_fields of one cell. Grid (ceil(Wi / kBlock), Hi),
// block kBlock.
template <int P>
__global__ void __launch_bounds__(kBlock)
frame_grid_kernel(const FrameScalars f, float* __restrict__ wu_out,
                  float* __restrict__ wv_out, float* __restrict__ s_lo,
                  float* __restrict__ s_hi, float* __restrict__ kappa,
                  uint8_t* __restrict__ cov) {
  constexpr int U = Axes<P>::U, V = Axes<P>::V;
  const int j = blockIdx.x * kBlock + threadIdx.x, i = blockIdx.y;
  if (j >= f.Wi) return;
  const size_t e = (size_t)i * f.Wi + j;
  const float wu = grid_wu(f, j), wv = grid_wv(f, i);
  const float sg = (float)f.sgn;
  float d[3], inv[3], o[3];
  d[P] = sg;
  d[U] = mul(wu, sg);
  d[V] = mul(wv, sg);
  float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = cam(f, a);
    inv[a] = div(1.0f, d[a]);
    const float t0 = mul(inv[a], sub(0.0f, o[a]));
    const float t1 = mul(inv[a], sub(1.0f, o[a]));
    const float lo = tmin(t0, t1), hi = tmax(t0, t1);
    t_near = a == 0 ? lo : tmax(t_near, lo);
    t_far = a == 0 ? hi : tmin(t_far, hi);
  }
  const float s_o = add(add(add(mul(plane(f, 0), o[0]),
                                mul(plane(f, 1), o[1])),
                            mul(plane(f, 2), o[2])),
                        plane(f, 3));
  const float s_d = add(add(mul(d[0], plane(f, 0)),
                            mul(d[1], plane(f, 1))),
                        mul(d[2], plane(f, 2)));
  // -s_o / where(s_d == 0, 1, s_d): reciprocal, then the product.
  const float t_plane = s_d != 0.0f
      ? mul(div(1.0f, s_d), -s_o) : __int_as_float(0x7f800000);
  const float t_entry = s_d > 0.0f ? tmax(t_near, t_plane) : t_near;
  const bool covered = (t_entry < t_far) && (t_far > 0.0f);
  float entry[3], t_back = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    entry[a] = add(mul(t_entry, d[a]), o[a]);
    const float t2 = tmax(mul(-entry[a], inv[a]),
                          mul(sub(1.0f, entry[a]), inv[a]));
    t_back = a == 0 ? t2 : tmin(t_back, t2);
  }
  const float s_a = entry[P];
  const float s_b = add(mul(t_back, d[P]), entry[P]);
  wu_out[e] = wu;
  wv_out[e] = wv;
  s_lo[e] = tmin(s_a, s_b);
  s_hi[e] = tmax(s_a, s_b);
  kappa[e] = mul(__fsqrt_rn(add(add(mul(wu, wu), 1.0f), mul(wv, wv))),
                 f.kappa_scale);
  cov[e] = covered ? 1 : 0;
}

// The pixel (i, j)'s grid position (gx, gy), -10 where its ray misses:
// make_rays (no depth attachment) and pixel_grid_coords.
template <int P>
__device__ __forceinline__ void pixel_position(const FrameScalars& f, int i,
                                               int j, float& gx, float& gy) {
  constexpr int U = Axes<P>::U, V = Axes<P>::V;
  // (p + 0.5) / W * 2 - 1: a CUDA tensor over a Python scalar is
  // multiplied by the scalar's float reciprocal.
  const float ndc_x = sub(mul(mul(add((float)j, 0.5f),
                                  __frcp_rn((float)f.W)), 2.0f), 1.0f);
  const float ndc_y = sub(mul(mul(add((float)i, 0.5f),
                                  __frcp_rn((float)f.H)), 2.0f), 1.0f);
  // Unprojected at the far plane (clip (x, y, 0, 1)), then to texture
  // space.
  float world[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    world[r] = row_dot(f, kViewProjInv, r, ndc_x, ndc_y, 0.0f);
  float o[3], d[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float x = div(world[0], world[3]), y = div(world[1], world[3]),
                z = div(world[2], world[3]);
    o[r] = cam(f, r);
    d[r] = sub(row_dot(f, kGlobalToTex, r, x, y, z), o[r]);
  }
  const float n = __fsqrt_rn(add(add(mul(d[0], d[0]), mul(d[1], d[1])),
                                 mul(d[2], d[2])));
  float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    d[a] = div(d[a], n);
    const float inv = div(1.0f, d[a]);
    const float t0 = mul(sub(0.0f, o[a]), inv);
    const float t1 = mul(sub(1.0f, o[a]), inv);
    const float lo = tmin(t0, t1), hi = tmax(t0, t1);
    t_near = a == 0 ? lo : tmax(t_near, lo);
    t_far = a == 0 ? hi : tmin(t_far, hi);
  }
  const float s_o = add(add(add(mul(plane(f, 0), o[0]),
                                mul(plane(f, 1), o[1])),
                            mul(plane(f, 2), o[2])),
                        plane(f, 3));
  const float s_d = add(add(mul(d[0], plane(f, 0)),
                            mul(d[1], plane(f, 1))),
                        mul(d[2], plane(f, 2)));
  const float t_plane = s_d != 0.0f ? div(-s_o, s_d)
                                    : __int_as_float(0x7f800000);
  const float t_entry = s_d > 0.0f ? tmax(t_near, t_plane) : t_near;
  const bool valid = (t_entry < t_far) && (t_far > 0.0f);
  const bool okp = fabsf(d[P]) > 1e-6f;
  const float safe = okp ? d[P] : 1.0f;
  gx = sub(mob_inv(gp(f, 0), gp(f, 1), gp(f, 2), div(d[U], safe)), 0.5f);
  gy = sub(mob_inv(gp(f, 3), gp(f, 4), gp(f, 5), div(d[V], safe)), 0.5f);
  if (!(valid && okp)) gx = gy = -10.0f;
}

// Variant A's first-pass position at grid row gi, image column j
// (warp_positions: the row's solved image row ihat, then its grid column).
__device__ __forceinline__ float position_a(const FrameScalars& f, int gi,
                                            int j) {
  const float wv_t = mob_fwd(gp(f, 3), gp(f, 4), gp(f, 5),
                             add((float)gi, 0.5f));
  const float jj = (float)j;
  const float den = guard(sub(hc(f, 3), mul(wv_t, hc(f, 6))));
  const float ihat = div(sub(mul(wv_t, add(mul(jj, hc(f, 7)), hc(f, 8))),
                             add(mul(jj, hc(f, 4)), hc(f, 5))), den);
  const float dd = guard(add(add(mul(ihat, hc(f, 6)), mul(jj, hc(f, 7))),
                             hc(f, 8)));
  const float wu_a = div(add(add(mul(ihat, hc(f, 0)), mul(jj, hc(f, 1))),
                             hc(f, 2)), dd);
  const float xa = sub(mob_inv(gp(f, 0), gp(f, 1), gp(f, 2), wu_a), 0.5f);
  const bool ok = isfinite(xa) && ihat >= -16.0f &&
                  ihat <= (float)f.H + 15.0f;
  return ok ? xa : -10.0f;
}

// Variant B's first-pass position at grid column xg, image row ii.
__device__ __forceinline__ float position_b(const FrameScalars& f, int xg,
                                            int ii) {
  const float wu_c = mob_fwd(gp(f, 0), gp(f, 1), gp(f, 2),
                             add((float)xg, 0.5f));
  const float iir = (float)ii;
  const float den = guard(sub(hc(f, 1), mul(wu_c, hc(f, 7))));
  const float jhat = div(sub(sub(mul(wu_c, hc(f, 8)), hc(f, 2)),
                             mul(sub(hc(f, 0), mul(wu_c, hc(f, 6))), iir)),
                         den);
  const float dd = guard(add(add(mul(iir, hc(f, 6)), mul(jhat, hc(f, 7))),
                             hc(f, 8)));
  const float wv_b = div(add(add(mul(iir, hc(f, 3)), mul(jhat, hc(f, 4))),
                             hc(f, 5)), dd);
  const float yb = sub(mob_inv(gp(f, 3), gp(f, 4), gp(f, 5), wv_b), 0.5f);
  const bool ok = isfinite(yb) && jhat >= -16.0f &&
                  jhat <= (float)f.W + 15.0f && iir < (float)f.H;
  return ok ? yb : -10.0f;
}

// The warp's positions. Blocks [0, n_tiles) each take a 32 x 32 tile of
// image rows (Hp of them for the two-pass warp, H for K8); the others one
// first-pass position a thread (Hi x W for A, Wi x Hp for B). Block
// (kTile, kTileRows).
template <int P, int WARP>
__global__ void __launch_bounds__(kTile * kTileRows)
frame_positions_kernel(const FrameScalars f, int tiles_x, int n_tiles,
                       float* __restrict__ out_gx, float* __restrict__ out_gy,
                       float* __restrict__ pos1, float* __restrict__ pos2) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x;
  if (b < n_tiles) {
    const int i0 = (b / tiles_x) * kTile, j0 = (b % tiles_x) * kTile;
    const int rows = WARP == 2 ? f.H : f.Hp;
#pragma unroll
    for (int k = 0; k < kTile; k += kTileRows) {
      const int i = i0 + ty + k, j = j0 + tx;
      float gx = -10.0f, gy = -10.0f;
      if (i < f.H && j < f.W) pixel_position<P>(f, i, j, gx, gy);
      if (i < rows && j < f.W) {
        const size_t e = (size_t)i * f.W + j;
        if (WARP == 0 && i < f.H) out_gx[e] = gx;     // gx (H, W)
        if (WARP == 1) pos2[e] = gx;                  // gx_p (Hp, W)
        if (WARP == 2) {                              // gx, gy (H, W)
          out_gx[e] = gx;
          out_gy[e] = gy;
        }
      }
      if (WARP == 0) tile[ty + k][tx] = gy;
    }
    if (WARP == 0) {                                  // gy_t (W, Hp)
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTile; k += kTileRows) {
        const int j = j0 + ty + k, i = i0 + tx;
        if (j < f.W && i < f.Hp) pos2[(size_t)j * f.Hp + i] = tile[tx][ty + k];
      }
    }
    return;
  }
  if (WARP == 2) return;
  const size_t e = (size_t)(b - n_tiles) * (kTile * kTileRows) +
                   ty * kTile + tx;
  if (WARP == 0) {                                    // xa (Hi, W)
    if (e >= (size_t)f.Hi * f.W) return;
    pos1[e] = position_a(f, (int)(e / f.W), (int)(e % f.W));
  } else {                                            // yb (Wi, Hp)
    if (e >= (size_t)f.Wi * f.Hp) return;
    pos1[e] = position_b(f, (int)(e / f.Hp), (int)(e % f.Hp));
  }
}

// The channel stack [lum, alpha, depth] of one cell: first_hit_depth.
// Grid (ceil(Wi / kBlock), Hi), block kBlock.
template <int P>
__global__ void __launch_bounds__(kBlock)
frame_epilogue_kernel(const FrameScalars f, const float* __restrict__ lum,
                      const float* __restrict__ alpha,
                      const float* __restrict__ firsts,
                      float* __restrict__ chans) {
  constexpr int U = Axes<P>::U, V = Axes<P>::V;
  const int j = blockIdx.x * kBlock + threadIdx.x, i = blockIdx.y;
  if (j >= f.Wi) return;
  const size_t e = (size_t)i * f.Wi + j;
  const size_t cells = (size_t)f.Hi * f.Wi;
  const float a = alpha[e], s = firsts[e];
  chans[e] = lum[e];
  chans[cells + e] = a;
  const float t_hit = sub(s, cam(f, P));
  float pen[3];
  pen[P] = sub(s, 0.5f);
  pen[U] = sub(add(mul(grid_wu(f, j), t_hit), cam(f, U)), 0.5f);
  pen[V] = sub(add(mul(grid_wv(f, i), t_hit), cam(f, V)), 0.5f);
  // The clip position proj_view_model @ (pen, 1): its z and w.
  const float z = row_dot(f, kPvm, 2, pen[0], pen[1], pen[2]);
  const float w = row_dot(f, kPvm, 3, pen[0], pen[1], pen[2]);
  const bool hit = a > 0.0f && s < 1.5f;
  chans[2 * cells + e] = hit ? div(z, w == 0.0f ? 1.0f : w) : 0.0f;
}

constexpr int kLanes = 128;        // coarse columns, padded (TILE_W)
constexpr int kMapRows = 4;        // coarse rows a block of brick_maps owns
constexpr int kMinRun = 16;        // map planes a block of brick_maps owns:
constexpr int kMaxRun = 64;        // at least kMinRun, at most kMaxRun
constexpr int kBrick = 8;          // slabs per brick (sweep_bricks.BRICK)
constexpr int kRangeThreads = 256;
constexpr int kMaxMapPlanes = 32768;  // brick_range's shared flags

// The coarse cell (m, cv, cu): MIN over its factor_v x factor_u map cells
// that lie inside the map (the plain version pads with 255, which never
// lowers the MIN). PAIRS: factor_u 2 and the rows' pairs 2-byte aligned,
// so each row's pair is one load.
template <bool PAIRS>
__device__ __forceinline__ unsigned pool_cell(const uint8_t* __restrict__ occ,
                                              const BrickMapParams& p, int m,
                                              int cv, int cu) {
  const int v0 = cv * p.factor_v, v1 = min(v0 + p.factor_v, p.mv);
  const int u0 = cu * p.factor_u, u1 = min(u0 + p.factor_u, p.mu);
  unsigned c = 255;
  for (int v = v0; v < v1; ++v) {
    const uint8_t* row = occ + ((size_t)m * p.mv + v) * p.mu;
    if (PAIRS) {
      const unsigned w = __ldg(reinterpret_cast<const uint16_t*>(row + u0));
      c = min(c, min(w & 0xffu, w >> 8));
    } else {
      for (int u = u0; u < u1; ++u) c = min(c, (unsigned)__ldg(row + u));
    }
  }
  return c;
}

// The leap map and the tight skip map of coarse rows [blockIdx.x *
// kMapRows, + kMapRows), every column, map planes [m0, m1). A thread owns
// one (row, column) and walks the planes downwards from the run's halo
// (the mp_span planes past m1), pooling each plane's cell once: the leap
// map is the cell min'd with the plane above it (CoarseMap.pair), the
// tight map 0 iff a plane in [m, m + mp_span] holds a 0 (the nearest such
// plane kept as it walks). Rows and columns past the map's write 255. The
// walk has no barrier, so its planes' loads overlap: each thread keeps a
// bit per owned plane (run <= kMaxRun) that its cell holds a 0, and the
// block ORs them once at the end into flags (CVp / kMapRows, mp), which
// brick_range_kernel reduces. Grid (CVp / kMapRows, ceil(mp / run)), block
// (kLanes, kMapRows).
template <bool PAIRS>
__global__ void __launch_bounds__(kLanes * kMapRows)
brick_maps_kernel(const uint8_t* __restrict__ occ, const BrickMapParams p,
                  int run, uint8_t* __restrict__ coarse,
                  uint8_t* __restrict__ cskip, uint8_t* __restrict__ flags) {
  __shared__ unsigned long long held_w[kLanes * kMapRows / 32];
  const int cu = threadIdx.x, cv = blockIdx.x * kMapRows + threadIdx.y;
  const bool cell = cv < p.CV && cu < p.CU;
  const int m0 = blockIdx.y * run, m1 = min(m0 + run, p.mp);
  const int top = min(m1 + max(p.mp_span, 1), p.mp) - 1;
  int next_zero = 0x7fffffff;      // the nearest plane >= m holding a 0
  unsigned above = 255;            // the cell of plane m + 1
  unsigned long long held = 0;     // bit m - m0: owned plane m holds a 0
#pragma unroll 4
  for (int m = top; m >= m0; --m) {
    unsigned c = 255;
    if (cell) {
      c = pool_cell<PAIRS>(occ, p, m, cv, cu);
      if (!p.dist_leap) c = min(c, 1u);
      if (c == 0) next_zero = m;
    }
    if (m < m1) {
      const size_t e = ((size_t)m * p.CVp + cv) * kLanes + cu;
      coarse[e] = cell ? (uint8_t)(m + 1 < p.mp ? min(c, above) : c) : 255;
      cskip[e] = cell ? (next_zero - m <= p.mp_span ? 0 : 1) : 255;
      if (cell && c == 0) held |= 1ull << (m - m0);
    }
    above = c;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    held |= __shfl_xor_sync(0xffffffffu, held, o);
  const int t = threadIdx.y * kLanes + threadIdx.x;
  if (t % 32 == 0) held_w[t / 32] = held;
  __syncthreads();
  if (t < m1 - m0) {
    unsigned long long h = 0;
#pragma unroll
    for (int w = 0; w < kLanes * kMapRows / 32; ++w) h |= held_w[w];
    flags[(size_t)blockIdx.x * p.mp + m0 + t] = (h >> t) & 1;
  }
}

// The occupied brick range (sweep_bricks.occupied_slabs and kb_occ): per
// slab k its map planes from occupied_slabs' float32 chain ((k + 0.5) * ds)
// * Np - 0.5, each step rounded, floored and clamped; the first and the
// last brick with a slab whose planes hold a 0, else [n_bricks, -1]. One
// block; dynamic shared memory mp bytes.
__global__ void __launch_bounds__(kRangeThreads)
brick_range_kernel(const uint8_t* __restrict__ flags, int bands,
                   const BrickMapParams p, int* __restrict__ kb_occ) {
  extern __shared__ uint8_t held[];          // per map plane: holds a 0
  __shared__ int lo_w[kRangeThreads / 32], hi_w[kRangeThreads / 32];
  for (int m = threadIdx.x; m < p.mp; m += kRangeThreads) {
    uint8_t h = 0;
    for (int b = 0; b < bands; ++b) h |= flags[(size_t)b * p.mp + m];
    held[m] = h;
  }
  __syncthreads();
  const int n_bricks = (p.n_slabs + kBrick - 1) / kBrick;
  int lo = n_bricks, hi = -1;
  for (int k = threadIdx.x; k < p.n_slabs; k += kRangeThreads) {
    const float z = sub(mul(mul(add((float)k, 0.5f), p.ds), (float)p.Np),
                        0.5f);
    const long long k0 = min(max((long long)floorf(z), 0LL),
                             (long long)p.Np - 2);
    const long long ma = min(k0 / p.bp_p, (long long)p.mp - 1);
    const long long mb = min((k0 + 1) / p.bp_p, (long long)p.mp - 1);
    if (held[ma] | held[mb]) {
      lo = min(lo, k / kBrick);
      hi = max(hi, k / kBrick);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    lo_w[warp] = lo;
    hi_w[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kRangeThreads / 32; ++w) {
      lo = min(lo, lo_w[w]);
      hi = max(hi, hi_w[w]);
    }
    kb_occ[0] = lo;
    kb_occ[1] = hi;
  }
}

bool maps_ok(const BrickMapParams& p) {
  return p.mp > 0 && p.mv > 0 && p.mu > 0 && p.mp <= kMaxMapPlanes &&
         p.factor_v > 0 && p.factor_u > 0 && p.CV > 0 && p.CU > 0 &&
         p.CU <= kLanes && p.CVp >= p.CV && p.CVp % kMapRows == 0 &&
         (long long)p.CV * p.factor_v >= p.mv &&
         (long long)(p.CV - 1) * p.factor_v < p.mv &&
         (long long)p.CU * p.factor_u >= p.mu &&
         (long long)(p.CU - 1) * p.factor_u < p.mu && p.mp_span >= 0 &&
         p.bp_p > 0 && p.Np >= 2 && p.n_slabs > 0;
}

bool grid_ok(const FrameScalars& f) {
  return f.Hi > 0 && f.Wi > 0 && f.Hi <= 65535 && f.row0 >= 0 &&
         f.p_axis >= 0 && f.p_axis <= 2 && (f.sgn == 1 || f.sgn == -1);
}

}  // namespace

// The grid fields (Hi, Wi) each: wu, wv, s_lo, s_hi, kappa (f32), cov (u8,
// 0 or 1).
extern "C" int vkv_frame_grid(void* wu, void* wv, void* s_lo, void* s_hi,
                              void* kappa, void* cov, FrameScalars f,
                              void* stream) {
  if (!grid_ok(f)) return (int)cudaErrorInvalidValue;
  const dim3 grid((f.Wi + kBlock - 1) / kBlock, f.Hi);
  const cudaStream_t st = (cudaStream_t)stream;
#define VKV_LAUNCH(P)                                                      \
  frame_grid_kernel<P><<<grid, kBlock, 0, st>>>(                          \
      f, (float*)wu, (float*)wv, (float*)s_lo, (float*)s_hi,             \
      (float*)kappa, (uint8_t*)cov)
  if (f.p_axis == 0) VKV_LAUNCH(0);
  else if (f.p_axis == 1) VKV_LAUNCH(1);
  else VKV_LAUNCH(2);
#undef VKV_LAUNCH
  return (int)cudaGetLastError();
}

// The warp's positions of f.warp: A (0) gx (H, W), pos1 = xa (Hi, W), pos2
// = gy_t (W, Hp); B (1) pos1 = yb (Wi, Hp), pos2 = gx_p (Hp, W); the
// single-pass warp (2) gx and gy (H, W). Unused pointers may be null.
extern "C" int vkv_frame_positions(void* gx, void* gy, void* pos1,
                                   void* pos2, FrameScalars f,
                                   void* stream) {
  if (!grid_ok(f) || f.H <= 0 || f.W <= 0 || f.Hp < f.H || f.warp < 0 ||
      f.warp > 2)
    return (int)cudaErrorInvalidValue;
  const int rows = f.warp == 2 ? f.H : f.Hp;
  const int tiles_x = (f.W + kTile - 1) / kTile;
  const long long n_tiles = (long long)tiles_x * ((rows + kTile - 1) / kTile);
  const long long n_pos = f.warp == 0 ? (long long)f.Hi * f.W
                        : f.warp == 1 ? (long long)f.Wi * f.Hp : 0;
  const long long blocks =
      n_tiles + (n_pos + kTile * kTileRows - 1) / (kTile * kTileRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kTile, kTileRows);
  const cudaStream_t st = (cudaStream_t)stream;
#define VKV_LAUNCH(P, WARP)                                                \
  frame_positions_kernel<P, WARP><<<(unsigned)blocks, block, 0, st>>>(    \
      f, tiles_x, (int)n_tiles, (float*)gx, (float*)gy, (float*)pos1,    \
      (float*)pos2)
#define VKV_LAUNCH_WARP(P)                                                 \
  if (f.warp == 0) VKV_LAUNCH(P, 0);                                      \
  else if (f.warp == 1) VKV_LAUNCH(P, 1);                                 \
  else VKV_LAUNCH(P, 2)
  if (f.p_axis == 0) { VKV_LAUNCH_WARP(0); }
  else if (f.p_axis == 1) { VKV_LAUNCH_WARP(1); }
  else { VKV_LAUNCH_WARP(2); }
#undef VKV_LAUNCH_WARP
#undef VKV_LAUNCH
  return (int)cudaGetLastError();
}

// The (3, Hi, Wi) channel stack from K1's lum, alpha and firsts (Hi, Wi).
extern "C" int vkv_frame_epilogue(const void* lum, const void* alpha,
                                  const void* firsts, void* chans,
                                  FrameScalars f, void* stream) {
  if (!grid_ok(f)) return (int)cudaErrorInvalidValue;
  const dim3 grid((f.Wi + kBlock - 1) / kBlock, f.Hi);
  const cudaStream_t st = (cudaStream_t)stream;
#define VKV_LAUNCH(P)                                                      \
  frame_epilogue_kernel<P><<<grid, kBlock, 0, st>>>(                      \
      f, (const float*)lum, (const float*)alpha, (const float*)firsts,   \
      (float*)chans)
  if (f.p_axis == 0) VKV_LAUNCH(0);
  else if (f.p_axis == 1) VKV_LAUNCH(1);
  else VKV_LAUNCH(2);
#undef VKV_LAUNCH
  return (int)cudaGetLastError();
}

// K1's map inputs from the (mp, mv, mu) u8 map occ: coarse and cskip
// (mp, CVp, 128) u8, kb_occ (2,) int32; flags, (CVp / 4, mp) u8, is
// scratch that the first kernel fills whole. Two launches, no copy.
extern "C" int vkv_brick_maps(const void* occ, void* coarse, void* cskip,
                              void* flags, void* kb_occ, BrickMapParams p,
                              void* stream) {
  if (!maps_ok(p)) return (int)cudaErrorInvalidValue;
  // Enough planes a block that the halo (mp_span planes) stays a small
  // share of its reads, and one bit of a 64-bit mask each.
  const int run = min(kMaxRun, max(kMinRun, 4 * p.mp_span));
  const int runs = (p.mp + run - 1) / run, bands = p.CVp / kMapRows;
  if (runs > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool pairs = p.factor_u == 2 && p.mu % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(occ) % 2 == 0;
  const dim3 grid(bands, runs), block(kLanes, kMapRows);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)occ;
  if (pairs)
    brick_maps_kernel<true><<<grid, block, 0, st>>>(
        in, p, run, (uint8_t*)coarse, (uint8_t*)cskip, (uint8_t*)flags);
  else
    brick_maps_kernel<false><<<grid, block, 0, st>>>(
        in, p, run, (uint8_t*)coarse, (uint8_t*)cskip, (uint8_t*)flags);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  brick_range_kernel<<<1, kRangeThreads, p.mp, st>>>(
      (const uint8_t*)flags, bands, p, (int*)kb_occ);
  return (int)cudaGetLastError();
}

// Single-pass bilinear warp of the w-grid image to pixels (K8).
//
// Replaces the Pallas TPU kernel vkvolume_tpu/render/warp_pallas.py:_kernel
// (called through warp_to_pixels): every pixel samples the (C, Hi, Wi)
// float32 grid channels at its continuous grid position (gx, gy), 0 where
// gx < -5 (no ray). The frame runs it when the plan has no two-pass warp
// but a single-pass rect (R_warp).
//
// What bounds it on the H100: device-memory bandwidth, in principle. Per
// pixel it reads two f32 positions and writes C values; over the frame it
// reads the grid sectors its taps touch (most of the grid on the views
// the plan sends here: the grid is about as fine as the pixels, or
// finer). Measured (bench/warp_probe.py), each block's chain of round
// trips - positions, footprint, copy, taps - at eight blocks an SM holds
// it to about twice that bound, cold or warm alike.
//
// Design. The pixel -> grid map of those views turns as much as it
// scales: on the side view a pixel row walks down a grid column (gy moves
// 0.77 per pixel along x, gx 2.6 per pixel row). A strip of one pixel row
// taps a new grid row at every pixel, one 32-byte sector per tap, and the
// next row's strip, on another SM, taps them again. So a block takes a
// 2-D tile of kTileH x kTileW pixels, kPix of them per thread along x (one
// 16-byte load of gx and of gy, one 16-byte store per channel), as two
// square halves (pixels 0-15 and 16-31 of each tile row: a square's
// bounding rect in the grid is the smallest whichever way the map turns):
//   1. each half reduces the min and max of its covered pixels' clamped gx
//      and gy: its grid footprint, the rect the TPU kernel DMAs for its
//      tile (warp_pallas.py:41-53), here exact to the texel;
//   2. if both halves' rects, all C planes, fit the staging budget
//      (kStageBytes), the block copies them into shared memory with
//      cp.async (16-byte pieces when rows and base are 16-byte aligned,
//      else 4-byte ones) and every pixel reads its 4*C taps from there;
//      else it takes the halves one after the other, each staged if it
//      fits alone;
//   3. a half that does not fit alone reads its taps straight from global
//      memory (__ldg): random positions, or a plan's grid far finer than
//      its pixels;
//   4. a tile with no covered pixel stages nothing and writes zeros.
// These are paths of one launch, chosen per block. Shared-memory rows are
// padded to an odd number of 16-byte pieces, so that the taps of lanes a
// few grid rows apart fall in different banks. cp.async and not TMA: the
// rects change size and place from tile to tile, and a tensor map needs
// a fixed box and cuTensorMapEncodeTiled from libcuda.
//
// Exactness: the clamps are the TPU kernel's (warp_pallas.py:60-66): gx
// and gy clipped to the grid, x1 = min(x0+1, Wi-1), fx clipped; the
// arithmetic and its order are the plain version's
// (sweep_pallas._warp_reference), rounded the same way (-fmad=false).
// Every tap lies inside its half's rect: x0 >= floor(min gx) and x1 <=
// min(floor(max gx) + 1, Wi - 1), and the same in y.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;                           // pixel rows per block
constexpr int kTileW = 32;                           // pixels per tile row
constexpr int kPix = 4;                              // pixels per thread
constexpr int kLanesX = kTileW / kPix;               // threads per tile row
constexpr int kThreads = kTileH * kLanesX;           // 128
constexpr int kWarps = kThreads / 32;
constexpr float kInf = __builtin_huge_valf();
// The staging budget a block. 27 KB keeps eight blocks on an SM (8 x (27
// KB + the block's other 176 B + the 1 KB the SM keeps a block) <= 228
// KB), the most the kernel's 56 registers allow; of budgets of 20-55 KB
// it was the fastest on the side view and the orbit's azimuth 90
// (bench/warp_probe.py, PERF.md).
constexpr int kStageBytes = 27 * 1024;
constexpr int kStageFloats = kStageBytes / 4;

// Tile counters: no covered pixel; both halves staged at once; the halves
// staged one after the other; a half read from global memory.
enum Path { kEmpty = 0, kStaged = 1, kTwoPasses = 2, kDirect = 3 };

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float lerp2(float c00, float c01, float c10,
                                       float c11, float fx, float fy) {
  const float v0 = c00 + (c01 - c00) * fx;
  const float v1 = c10 + (c11 - c10) * fx;
  return v0 + (v1 - v0) * fy;
}

// A half's rect: rows yl..yl+rh-1, columns xa..xa+xw-1, stored as C
// blocks of rh rows `pitch` floats apart (a multiple of 4, an odd number
// of 16-byte pieces); `floats` is 0 for a half with no covered pixel.
struct Rect {
  int xa, xw, yl, rh, pitch, floats;
};

__device__ __forceinline__ Rect rect_of(float lox, float hix, float loy,
                                        float hiy, int C, int Hi, int Wi,
                                        bool src_vec) {
  Rect r{0, 0, 0, 0, 0, 0};
  if (!(lox <= hix)) return r;
  const int xl = (int)floorf(lox), xh = min((int)floorf(hix) + 1, Wi - 1);
  r.yl = (int)floorf(loy);
  r.rh = min((int)floorf(hiy) + 1, Hi - 1) - r.yl + 1;
  r.xa = src_vec ? (xl & ~3) : xl;
  r.xw = src_vec ? ((xh - r.xa + 4) & ~3) : xh - r.xa + 1;
  r.pitch = (r.xw + 3) & ~3;
  if (!((r.pitch >> 2) & 1)) r.pitch += 4;
  r.floats = C * r.rh * r.pitch;
  return r;
}

// All threads of the block copy rect r of the C planes to stage: piece i
// of the C * rh rows of q pieces goes to thread i % kThreads. The walk
// steps (row, piece) by kThreads pieces with no division in the loop.
__device__ __forceinline__ void stage_rect(float* stage, const Rect& r,
                                           const float* __restrict__ src,
                                           int C, int Hi, int Wi,
                                           bool src_vec) {
  const int q = src_vec ? r.xw >> 2 : r.xw;           // pieces per row
  const int w = src_vec ? 4 : 1;                      // floats per piece
  const int step_rows = kThreads / q, step_j = kThreads - step_rows * q;
  int row = threadIdx.x / q, j = threadIdx.x - row * q;   // of C * rh
  int c = row / r.rh, y = row - c * r.rh;
  while (c < C) {
    const float* g = src + ((size_t)c * Hi + r.yl + y) * Wi + r.xa + w * j;
    float* s = stage + row * r.pitch + w * j;
    if (src_vec)
      cp_async16(s, g);
    else
      cp_async4(s, g);
    j += step_j, row += step_rows, y += step_rows;
    if (j >= q) j -= q, ++row, ++y;
    while (y >= r.rh) y -= r.rh, ++c;
  }
}

// VEC: W % 4 == 0 and gx, gy, out 16-byte aligned (vector loads and
// stores of a thread's kPix pixels). src_vec: Wi % 4 == 0 and src 16-byte
// aligned (16-byte staging copies).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 8)
    warp_pixels_kernel(const float* __restrict__ src,
                       const float* __restrict__ gx_g,
                       const float* __restrict__ gy_g,
                       float* __restrict__ out, int C, int Hi, int Wi, int H,
                       int W, int src_vec, int* __restrict__ paths) {
  __shared__ float4 stage4[kStageFloats / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float red[4][2][kWarps];
  __shared__ Rect rects[2];

  const int tid = threadIdx.x, lane = tid & 31;
  const int half = (tid >> 2) & 1;           // lanes 4-7 of a tile row
  const int row = blockIdx.y * kTileH + tid / kLanesX;
  const int col = blockIdx.x * kTileW + (tid % kLanesX) * kPix;
  const size_t pix = (size_t)row * W + col;

  float gx[kPix], gy[kPix];
  bool valid[kPix];
  if (VEC) {
    const bool ok = row < H && col < W;
    float4 a = make_float4(-10.0f, -10.0f, -10.0f, -10.0f), b = a;
    if (ok) {
      a = __ldg(reinterpret_cast<const float4*>(gx_g + pix));
      b = __ldg(reinterpret_cast<const float4*>(gy_g + pix));
    }
    gx[0] = a.x, gx[1] = a.y, gx[2] = a.z, gx[3] = a.w;
    gy[0] = b.x, gy[1] = b.y, gy[2] = b.z, gy[3] = b.w;
#pragma unroll
    for (int k = 0; k < kPix; ++k) valid[k] = ok;
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      valid[k] = row < H && col + k < W;
      gx[k] = valid[k] ? __ldg(gx_g + pix + k) : -10.0f;
      gy[k] = valid[k] ? __ldg(gy_g + pix + k) : -10.0f;
    }
  }

  // Clamped positions, coverage, and this thread's share of its half's
  // footprint, reduced over the half's lanes of the warp (lane bits 0-1:
  // the thread within the half's row, 3-4: the row), then over the warps.
  const float wmax = (float)Wi - 1.0f, hmax = (float)Hi - 1.0f;
  float xc[kPix], yc[kPix];
  bool in[kPix];
  float lox = kInf, hix = -kInf, loy = kInf, hiy = -kInf;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    in[k] = valid[k] && gx[k] > -5.0f;
    xc[k] = fminf(fmaxf(gx[k], 0.0f), wmax);
    yc[k] = fminf(fmaxf(gy[k], 0.0f), hmax);
    if (in[k]) {
      lox = fminf(lox, xc[k]), hix = fmaxf(hix, xc[k]);
      loy = fminf(loy, yc[k]), hiy = fmaxf(hiy, yc[k]);
    }
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o == 4) continue;
    lox = fminf(lox, __shfl_xor_sync(0xffffffffu, lox, o));
    hix = fmaxf(hix, __shfl_xor_sync(0xffffffffu, hix, o));
    loy = fminf(loy, __shfl_xor_sync(0xffffffffu, loy, o));
    hiy = fmaxf(hiy, __shfl_xor_sync(0xffffffffu, hiy, o));
  }
  if ((lane & ~4) == 0) {
    red[0][half][tid >> 5] = lox, red[1][half][tid >> 5] = hix;
    red[2][half][tid >> 5] = loy, red[3][half][tid >> 5] = hiy;
  }
  __syncthreads();
  if (tid < 2) {
    float a = kInf, b = -kInf, c = kInf, d = -kInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a = fminf(a, red[0][tid][w]), b = fmaxf(b, red[1][tid][w]);
      c = fminf(c, red[2][tid][w]), d = fmaxf(d, red[3][tid][w]);
    }
    rects[tid] = rect_of(a, b, c, d, C, Hi, Wi, src_vec);
  }
  __syncthreads();

  // Both halves in one pass when they fit together (half 1's rect after
  // half 0's), else one pass per half, each staged if it fits alone.
  const int f0 = rects[0].floats, f1 = rects[1].floats;
  const bool together = f0 + f1 <= kStageFloats;
  if (paths != nullptr && tid == 0)
    atomicAdd(paths + (f0 + f1 == 0 ? kEmpty
                       : together   ? kStaged
                       : max(f0, f1) <= kStageFloats ? kTwoPasses
                                                     : kDirect),
              1);
  const size_t out_plane = (size_t)H * W;
  const int n_pass = together ? 1 : 2;
  for (int pass = 0; pass < n_pass; ++pass) {
    if (pass == 1) __syncthreads();          // pass 0's reads are done
    for (int h = 0; h < 2; ++h)
      if ((together || h == pass) && rects[h].floats > 0 &&
          rects[h].floats <= kStageFloats)
        stage_rect(stage + (together && h ? f0 : 0), rects[h], src, C, Hi,
                   Wi, src_vec);
    cp_async_wait_all();
    __syncthreads();
    if (!together && half != pass) continue;

    // This thread's pixels, tapped from its half's rect (staged) or from
    // the planes (direct).
    const Rect& mine = rects[half];
    const bool staged = mine.floats > 0 && mine.floats <= kStageFloats;
    const int plane = staged ? mine.rh * mine.pitch : Hi * Wi;
    const int pitch = staged ? mine.pitch : Wi;
    const int x_org = staged ? mine.xa : 0, y_org = staged ? mine.yl : 0;
    const float* ss = stage + (together && half ? f0 : 0);
    for (int c = 0, cs = 0; c < C; ++c, cs += plane) {
      float v[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float flx = floorf(xc[k]), fly = floorf(yc[k]);
        const int x0 = min(max((int)flx, 0), Wi - 1);
        const int y0 = min(max((int)fly, 0), Hi - 1);
        const int dx = min(x0 + 1, Wi - 1) - x0;
        const int dy = (min(y0 + 1, Hi - 1) - y0) * pitch;
        const int t = cs + (y0 - y_org) * pitch + x0 - x_org;
        const float fx = fminf(fmaxf(xc[k] - flx, 0.0f), 1.0f);
        const float fy = yc[k] - fly;
        v[k] = !in[k] ? 0.0f
               : staged
                   ? lerp2(ss[t], ss[t + dx], ss[t + dy], ss[t + dy + dx], fx,
                           fy)
                   : lerp2(__ldg(src + t), __ldg(src + t + dx),
                           __ldg(src + t + dy), __ldg(src + t + dy + dx), fx,
                           fy);
      }
      float* o = out + c * out_plane + pix;
      if (VEC) {
        if (valid[0])
          *reinterpret_cast<float4*>(o) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          if (valid[k]) o[k] = v[k];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool VEC>
int launch(const float* src, const float* gx, const float* gy, float* out,
           int C, int Hi, int Wi, int H, int W, int src_vec, int* paths,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kTileW - 1) / kTileW),
                  (unsigned)((H + kTileH - 1) / kTileH));
  warp_pixels_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      src, gx, gy, out, C, Hi, Wi, H, W, src_vec, paths);
  return (int)cudaGetLastError();
}

}  // namespace

// paths: null, or four int counters (empty, staged, two passes, direct
// tiles) that the launch adds its tiles to.
extern "C" int vkv_warp_pixels(const void* src, const void* gx,
                               const void* gy, void* out, int C, int Hi,
                               int Wi, int H, int W, void* paths,
                               void* stream) {
  if ((long long)H * W == 0) return 0;
  const bool vec = W % kPix == 0 && aligned16(gx) && aligned16(gy) &&
                   aligned16(out);
  const int src_vec = Wi % 4 == 0 && aligned16(src);
  auto* s = static_cast<const float*>(src);
  auto* x = static_cast<const float*>(gx);
  auto* y = static_cast<const float*>(gy);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<int*>(paths);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(s, x, y, o, C, Hi, Wi, H, W, src_vec, p, st)
             : launch<false>(s, x, y, o, C, Hi, Wi, H, W, src_vec, p, st);
}

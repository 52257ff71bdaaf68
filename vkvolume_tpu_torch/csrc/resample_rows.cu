// Row-aligned 1-D linear resample (K2): one pass of the two-pass
// projective warp, run twice per frame with nothing between the passes.
//
// Replaces the Pallas TPU kernels vkvolume_tpu/render/warp_pallas.py:
// _resample_kernel and _resample_kernel_pipe (the same function with a
// cross-step DMA double buffer), called through resample_rows:
//   out[c, l, j] = lerp(src[c, l, clip(pos[l, j], 0, n_src - 1)]),
// 0 where pos < -5 (masked pixel), optionally u16-encoded (round half to
// even, clip to [0, 65535]). The JAX warp (warp_two_pass[_b]) wraps the two
// passes in XLA: the u16 encode of the f32 grid channels before pass 1, a
// transpose between the passes, a transpose and the decode (/ scale) after
// pass 2. Here those are options of the pass itself:
//   - encode: an f32 source is scaled and rounded tap by tap on load,
//     rintf(clip(v * sc[c], 0, 65535)), bit for bit the separate encode;
//   - column_src: the source is (C, n_src, lines), read through the
//     transpose by strides (variant B's pass 1 reads the grid's columns);
//   - transpose_out: the output is (C, n_pos, lines), written through a
//     shared-memory tile so that reads and writes both coalesce;
//   - decode: the f32 output divided by sc[c] (IEEE division).
// A frame's warp is then two launches: variant A (C, Hi, Wi) f32 ->
// [encode, transpose_out] (C, W, Hi) u16 -> [decode, transpose_out]
// (C, Hp, W) f32; variant B (C, Hi, Wi) f32 -> [encode, column_src,
// transpose_out] (C, Hp, Wi) u16 -> [decode] (C, Hp, W) f32.
//
// What bounds it on the H100: device-memory bandwidth. Per output element
// it reads one f32 position and two source cells per channel and writes
// one value per channel; neighbouring positions hit the same source cells,
// which L1/L2 serve.
//
// Design: a block owns a tile of 32 lines x 32 positions. It computes in
// the order that coalesces its source reads (positions fast along a line
// for row sources, lines fast for a column source, whose positions are
// staged through shared memory first) and writes in the order that
// coalesces the output (lines fast for a transposed output, through a
// shared-memory tile when the two orders differ). Source cells are scalar
// loads: each output reads two cells at a data-dependent position, and
// rows are not 16-byte aligned in general (their length is arbitrary), so
// a vector load would need an aligned base; the TPU kernel's per-tile rect
// DMA and lane gathers have no counterpart. Rounding uses rintf (half to
// even, like torch.round), and the build contracts no multiply-add.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // lines and positions per block
constexpr int kRows = 8;    // warps per block
constexpr int kGroup = 4;   // channels per pass through the output tile

}  // namespace

// Mirror of PassParams in utils/cuda_build.py (field order and types must
// match). sc: per-channel scale of encode / decode (C <= 4 when used).
struct PassParams {
  int C, lines, n_src, n_pos, encode, decode;
  float sc[4];
};

namespace {

__device__ __forceinline__ float scale_of(const PassParams& p, int c) {
  return c == 0 ? p.sc[0] : c == 1 ? p.sc[1] : c == 2 ? p.sc[2] : p.sc[3];
}

template <typename SrcT>
__device__ __forceinline__ float load_cell(SrcT v, bool encode, float s) {
  const float f = (float)v;
  return encode ? rintf(fminf(fmaxf(f * s, 0.0f), 65535.0f)) : f;
}

template <typename SrcT, typename OutT, bool kColumnSrc, bool kTransposeOut>
__global__ void __launch_bounds__(kTile * kRows)
resample_pass_kernel(const SrcT* __restrict__ src,
                     const float* __restrict__ pos, OutT* __restrict__ out,
                     PassParams p) {
  constexpr bool kStaged = kColumnSrc != kTransposeOut;
  __shared__ float pos_t[kColumnSrc ? kTile : 1][kTile + 1];
  __shared__ float tile[kStaged ? kGroup : 1][kTile][kTile + 1];
  const int j0 = blockIdx.x * kTile, l0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const long long n_in = (long long)p.lines * p.n_src;   // per channel
  const long long n_out = (long long)p.lines * p.n_pos;

  if constexpr (kColumnSrc) {
    for (int a = ty; a < kTile; a += kRows) {
      const int l = l0 + a, j = j0 + tx;
      pos_t[a][tx] = l < p.lines && j < p.n_pos
                         ? pos[(long long)l * p.n_pos + j] : -10.0f;
    }
    __syncthreads();
  }
  for (int cg = 0; cg < p.C; cg += kGroup) {
    const int nc = min(kGroup, p.C - cg);
    if (kStaged && cg > 0) __syncthreads();   // the tile is read out
    // Element (a, b): line l0 + a, position j0 + b.
    for (int k = 0; k < kTile / kRows; ++k) {
      const int a = kColumnSrc ? tx : ty + kRows * k;
      const int b = kColumnSrc ? ty + kRows * k : tx;
      const int l = l0 + a, j = j0 + b;
      if (l >= p.lines || j >= p.n_pos) continue;
      const float pv = kColumnSrc ? pos_t[a][b]
                                  : pos[(long long)l * p.n_pos + j];
      const bool inside = pv > -5.0f;
      const float posc = fminf(fmaxf(pv, 0.0f), (float)p.n_src - 1.0f);
      const float fl = floorf(posc);
      const int i0 = (int)fl;
      const int i1 = min(i0 + 1, p.n_src - 1);
      const float fu = fminf(fmaxf(posc - fl, 0.0f), 1.0f);
      for (int c = cg; c < cg + nc; ++c) {
        const SrcT* base = src + c * n_in;
        SrcT v0, v1;
        if constexpr (kColumnSrc) {
          v0 = base[(long long)i0 * p.lines + l];
          v1 = base[(long long)i1 * p.lines + l];
        } else {
          const SrcT* row = base + (long long)l * p.n_src;
          v0 = row[i0];
          v1 = row[i1];
        }
        const float s = scale_of(p, c);
        const float g0 = load_cell(v0, p.encode, s);
        const float g1 = load_cell(v1, p.encode, s);
        float val = inside ? g0 + (g1 - g0) * fu : 0.0f;
        if constexpr (sizeof(OutT) == 2) {
          val = rintf(fminf(fmaxf(val, 0.0f), 65535.0f));
        } else if (p.decode) {
          val = val / s;
        }
        if constexpr (kStaged) {
          tile[c - cg][a][b] = val;
        } else {
          out[c * n_out + (kTransposeOut ? (long long)j * p.lines + l
                                         : (long long)l * p.n_pos + j)] =
              (OutT)val;
        }
      }
    }
    if constexpr (kStaged) {
      // Written lines fast (transposed output) or positions fast.
      __syncthreads();
      for (int k = 0; k < kTile / kRows; ++k) {
        const int a = kTransposeOut ? tx : ty + kRows * k;
        const int b = kTransposeOut ? ty + kRows * k : tx;
        const int l = l0 + a, j = j0 + b;
        if (l >= p.lines || j >= p.n_pos) continue;
        const long long o = kTransposeOut ? (long long)j * p.lines + l
                                          : (long long)l * p.n_pos + j;
        for (int c = cg; c < cg + nc; ++c)
          out[c * n_out + o] = (OutT)tile[c - cg][a][b];
      }
    }
  }
}

template <typename SrcT, typename OutT>
int launch_pass(const void* src, const void* pos, void* out,
                const PassParams& p, int column_src, int transpose_out,
                cudaStream_t s) {
  const dim3 grid((unsigned)((p.n_pos + kTile - 1) / kTile),
                  (unsigned)((p.lines + kTile - 1) / kTile));
  const auto* in = (const SrcT*)src;
  const auto* q = (const float*)pos;
  auto* o = (OutT*)out;
  if (column_src && transpose_out)
    resample_pass_kernel<SrcT, OutT, true, true>
        <<<grid, kTile * kRows, 0, s>>>(in, q, o, p);
  else if (column_src)
    resample_pass_kernel<SrcT, OutT, true, false>
        <<<grid, kTile * kRows, 0, s>>>(in, q, o, p);
  else if (transpose_out)
    resample_pass_kernel<SrcT, OutT, false, true>
        <<<grid, kTile * kRows, 0, s>>>(in, q, o, p);
  else
    resample_pass_kernel<SrcT, OutT, false, false>
        <<<grid, kTile * kRows, 0, s>>>(in, q, o, p);
  return (int)cudaGetLastError();
}

}  // namespace

// One pass: src (C, lines, n_src), or (C, n_src, lines) with column_src;
// pos (lines, n_pos) f32; out (C, lines, n_pos), or (C, n_pos, lines) with
// transpose_out; u16 or f32 source and output.
extern "C" int vkv_resample_pass(const void* src, const void* pos, void* out,
                                 PassParams p, int src_u16, int out_u16,
                                 int column_src, int transpose_out,
                                 void* stream) {
  if (p.C <= 0 || p.lines <= 0 || p.n_pos <= 0) return 0;
  if (p.n_src <= 0 || p.lines > 65535 * kTile ||
      ((p.encode || p.decode) && p.C > 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (src_u16 && out_u16)
    return launch_pass<uint16_t, uint16_t>(src, pos, out, p, column_src,
                                           transpose_out, s);
  if (src_u16)
    return launch_pass<uint16_t, float>(src, pos, out, p, column_src,
                                        transpose_out, s);
  if (out_u16)
    return launch_pass<float, uint16_t>(src, pos, out, p, column_src,
                                        transpose_out, s);
  return launch_pass<float, float>(src, pos, out, p, column_src,
                                   transpose_out, s);
}

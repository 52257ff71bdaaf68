// Chebyshev distance maps, built on every transfer-function edit: the
// eight anisotropic octant maps (skipmode 3) and the isotropic map
// (skipmode 2).
//
// Replaces three Pallas TPU kernels:
//   K3  vkvolume_tpu/accel/distance_pallas.py:_scan_relax_multi_kernel
//       x-line scan (+ and -), capped at ANISO_CAP, then the y zig-zag
//       relaxation (+ and -): four u8 maps from one occupancy map.
//   K4  vkvolume_tpu/accel/distance_pallas.py:_relax_multi_kernel
//       z relaxation (+ and -) of those four maps: the eight octant maps;
//       and its two-sided form, relax_dirs=(0,), on the one isotropic map
//       (relax_kernel along z, two-sided).
//   K5  vkvolume_tpu/accel/distance_pallas.py:_scan_relax_kernel with
//       scan_dir=0, relax_dirs=(0,): the two-sided x-line scan, then the
//       two-sided y relaxation (x_scan2_kernel, then relax_kernel along y).
//   K6  vkvolume_tpu/accel/distance_pallas.py:_relax_kernel (via relax_z
//       and relax_pallas): one uncapped relaxation of one map along z or
//       y, two-sided or one-sided (relax_kernel). The TPU kernel relaxes z
//       through a (Y, Z, X) transpose so that lines lie on sublanes; here
//       the axis is a stride. The two-sided K4 and K5's y pass launch the
//       same kernel.
//
// What bounds it on the H100: neither bytes nor flops. The maps are small
// (beetle, block 4: 124 x 208 x 208 u8 = 5.4 MB each; at most 16 maps read
// or written per build, all L2-resident) and the work is a data-dependent
// loop per cell of at most `cap` (63) steps for the octant maps and up to
// 255 steps for the uncapped isotropic map. It is latency-bound: what
// matters is enough independent threads in flight to hide the load
// latency of the loop.
//
// Design: one thread per cell in every launch (5.4 M threads at the
// beetle's shape, not one per line: a line-per-thread K4 would run only
// 43 K threads, about ten warps per SM). Each thread evaluates the closed
// form of its stage with the per-cell early exit "stop at n >= A": every
// candidate at distance n is max(n, .) >= n, so it cannot beat A, and the
// result is identical to the reference's full minimum. Neighbouring x are
// neighbouring threads, so every load of the loop is coalesced across the
// warp. K3 and K5 are two launches each (x-scan, then y-relax) with the
// scan maps in device memory between them: the y stage of a cell needs the
// x-scan of up to `cap` (K5: 255) rows around it, which a per-cell thread
// cannot recompute, and a whole (y, x) plane per block would tie the
// kernel to the map width.
// Integer arithmetic throughout, as the TPU kernels: exact, so kernel and
// plain version agree bit for bit. Out-of-range neighbours are padding
// (255 on the TPU), which never wins a minimum; here they are simply not
// visited.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void x_scan_kernel(const uint8_t* __restrict__ occ,
                              uint8_t* __restrict__ xs_pos,
                              uint8_t* __restrict__ xs_neg,
                              long long n_cells, int X, int cap) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int x = (int)(i % X);
  const uint8_t* row = occ + (i - x);
  const int v = row[x];
  // +x: g[x] = min_{x' >= x} occ[x'] + (x' - x), capped.
  int best = v;
  for (int k = 1; k < min(best, cap) && x + k < X; ++k)
    best = min(best, (int)row[x + k] + k);
  xs_pos[i] = (uint8_t)min(best, cap);
  // -x: g[x] = min_{x' <= x} occ[x'] + (x - x'), capped.
  best = v;
  for (int k = 1; k < min(best, cap) && x - k >= 0; ++k)
    best = min(best, (int)row[x - k] + k);
  xs_neg[i] = (uint8_t)min(best, cap);
}

// A[l] = min_{n >= 0, in bounds} max(n, D[l + dir*n]) along an axis of
// length L at element stride `stride`; `l` is the cell's index on it.
__device__ __forceinline__ int relax_cell(const uint8_t* __restrict__ d,
                                          long long i, int l, int L,
                                          long long stride, int dir) {
  int a = d[i];
  for (int n = 1; n < a; ++n) {
    const int m = l + dir * n;
    if (m < 0 || m >= L) break;
    a = min(a, max(n, (int)d[i + dir * n * stride]));
  }
  return a;
}

__global__ void y_relax4_kernel(const uint8_t* __restrict__ xs_pos,
                                const uint8_t* __restrict__ xs_neg,
                                uint8_t* __restrict__ out4,
                                long long n_cells, int Y, int X) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int y = (int)((i / X) % Y);
  // Scan-major order: (+x,+y), (+x,-y), (-x,+y), (-x,-y).
  out4[i] = (uint8_t)relax_cell(xs_pos, i, y, Y, X, +1);
  out4[n_cells + i] = (uint8_t)relax_cell(xs_pos, i, y, Y, X, -1);
  out4[2 * n_cells + i] = (uint8_t)relax_cell(xs_neg, i, y, Y, X, +1);
  out4[3 * n_cells + i] = (uint8_t)relax_cell(xs_neg, i, y, Y, X, -1);
}

__global__ void z_relax8_kernel(const uint8_t* __restrict__ in4,
                                uint8_t* __restrict__ out8,
                                long long n_cells, int Z, long long plane) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int z = (int)(i / plane);
  // Input-major: map 2j + d is input j relaxed along +z (d=0) or -z (d=1),
  // which is exactly octant index (sx<0)<<2 | (sy<0)<<1 | (sz<0).
  for (int j = 0; j < 4; ++j) {
    const uint8_t* d = in4 + j * n_cells;
    out8[(2 * j) * n_cells + i] = (uint8_t)relax_cell(d, i, z, Z, plane, +1);
    out8[(2 * j + 1) * n_cells + i] =
        (uint8_t)relax_cell(d, i, z, Z, plane, -1);
  }
}

// Two-sided x-scan: g[x] = min_{x'} occ[x'] + |x - x'| (its cap of 255 is
// a no-op: the x' = x term is at most 255).
__global__ void x_scan2_kernel(const uint8_t* __restrict__ occ,
                               uint8_t* __restrict__ xs, long long n_cells,
                               int X) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int x = (int)(i % X);
  const uint8_t* row = occ + (i - x);
  int best = row[x];
  for (int k = 1; k < best; ++k) {
    const bool up = x + k < X, dn = x - k >= 0;
    if (!up && !dn) break;
    if (up) best = min(best, (int)row[x + k] + k);
    if (dn) best = min(best, (int)row[x - k] + k);
  }
  xs[i] = (uint8_t)best;
}

// Two-sided relaxation A[l] = min_{n >= 0, in bounds} max(n, D[l +- n]).
__device__ __forceinline__ int relax_cell2(const uint8_t* __restrict__ d,
                                           long long i, int l, int L,
                                           long long stride) {
  int a = d[i];
  for (int n = 1; n < a; ++n) {
    const bool up = l + n < L, dn = l - n >= 0;
    if (!up && !dn) break;
    if (up) a = min(a, max(n, (int)d[i + n * stride]));
    if (dn) a = min(a, max(n, (int)d[i - n * stride]));
  }
  return a;
}

// K6: A[l] = min_n max(n, D[l + dir*n]) along an axis of length L at
// element stride `stride` (dir = 0: both senses).
__global__ void relax_kernel(const uint8_t* __restrict__ in,
                             uint8_t* __restrict__ out, long long n_cells,
                             int L, long long stride, int dir) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  const int l = (int)((i / stride) % L);
  out[i] = (uint8_t)(dir == 0 ? relax_cell2(in, i, l, L, stride)
                              : relax_cell(in, i, l, L, stride, dir));
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int vkv_x_scan2(const void* occ, void* xs, int Z, int Y, int X,
                           void* stream) {
  const long long n = (long long)Z * Y * X;
  if (n == 0) return 0;
  x_scan2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (uint8_t*)xs, n, X);
  return (int)cudaGetLastError();
}

extern "C" int vkv_x_scan(const void* occ, void* xs_pos, void* xs_neg,
                          int Z, int Y, int X, int cap, void* stream) {
  const long long n = (long long)Z * Y * X;
  if (n == 0) return 0;
  x_scan_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (uint8_t*)xs_pos, (uint8_t*)xs_neg, n, X, cap);
  return (int)cudaGetLastError();
}

extern "C" int vkv_y_relax4(const void* xs_pos, const void* xs_neg,
                            void* out4, int Z, int Y, int X, void* stream) {
  const long long n = (long long)Z * Y * X;
  if (n == 0) return 0;
  y_relax4_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xs_pos, (const uint8_t*)xs_neg, (uint8_t*)out4, n, Y,
      X);
  return (int)cudaGetLastError();
}

extern "C" int vkv_z_relax8(const void* in4, void* out8, int Z, int Y, int X,
                            void* stream) {
  const long long n = (long long)Z * Y * X;
  if (n == 0) return 0;
  z_relax8_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in4, (uint8_t*)out8, n, Z, (long long)Y * X);
  return (int)cudaGetLastError();
}

// axis 0 (z) or 1 (y); dir 0 (two-sided), +1 or -1.
extern "C" int vkv_relax(const void* in, void* out, int Z, int Y, int X,
                         int axis, int dir, void* stream) {
  const long long n = (long long)Z * Y * X;
  if (n == 0) return 0;
  if ((axis != 0 && axis != 1) || dir < -1 || dir > 1)
    return (int)cudaErrorInvalidValue;
  const int L = axis == 0 ? Z : Y;
  const long long stride = axis == 0 ? (long long)Y * X : (long long)X;
  relax_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, n, L, stride, dir);
  return (int)cudaGetLastError();
}

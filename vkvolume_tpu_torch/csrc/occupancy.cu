// The occupancy map of a TF edit in one pass: the u8 volume (and, with a
// gradient TF, the u8 gradient map) read once, the u8 map written once.
//
// Replaces no TPU kernel: the JAX package builds this map with XLA
// (vkvolume_tpu/accel/occupancy.py:_occupancy_u8). The plain PyTorch
// version, accel/occupancy.py:_occupancy_u8_plain, stays as the CPU path
// and the twin this kernel is held to bit for bit. It computes, per map
// cell of (bz, by, bx) voxels (bz = ceil(D / mz), and so on, the cells
// past the ragged edge zero-padded):
//   intensity TF:  max(v) >= ti                  -> OCCUPIED (0)
//   gradient TF:   any(v >= ti && g >= tg)       -> OCCUPIED (0)
// else EMPTY (255). Padding counts as a value of 0: with an intensity TF
// and ti == 0 every cell is occupied; with a gradient TF it adds nothing.
//
// What bounds it on the H100: bytes. The least work is one read of the
// volume (834 MB at the kingsnake's 1024 x 1024 x 795), one of the
// gradient and one write of the map (13 MB): 0.50 ms at 3.35 TB/s, the
// arithmetic a few operations per 4 bytes. The plain version streams
// about 12 full-volume tensors (masks, a padded copy, three amax passes).
// Design: a block owns one map-z slab (bz planes), kRowsY map-y rows and a
// tile of map-x cells whose bytes start on a 16-byte boundary (the tile is
// a multiple of lcm(16, bx) bytes, at most 1024, where that fits). Each
// thread owns a 16-byte strip along x of one map-y row and walks the
// cell row's bz * by voxel rows with 16-byte loads, kBatch of them in
// flight; it compares four bytes at once (__vcmpgeu4) and ORs the
// per-byte flags over the rows in registers. The strips' flags go to
// shared memory, where each cell ORs its run of bx bytes, so any bx works
// (cells may straddle strips). Widths that are not a multiple of 16 take
// byte loads, masked at the row's end (the wrapper holds every base to 16
// bytes). Gradient reads are skipped where no byte of the intensity strip
// passes (the TF's voxels are sparse and clustered, so most gradient
// sectors are never fetched). The kernel does not stop early in a cell
// already known to be occupied.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStripsX = 64;    // threads along x, one 16-byte strip each
constexpr int kRowsY = 4;       // map-y rows per block
constexpr int kBatch = 4;       // voxel rows in flight per thread
constexpr int kTileBytes = 1024;
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr uint8_t kOccupied = 0, kEmpty = 255;

__device__ __forceinline__ uint4 load16(const uint8_t* p, int n_valid,
                                        bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n_valid) w[i >> 2] |= (uint32_t)__ldcs(p + i) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 cmp_ge(uint4 a, uint32_t t4) {
  return make_uint4(__vcmpgeu4(a.x, t4), __vcmpgeu4(a.y, t4),
                    __vcmpgeu4(a.z, t4), __vcmpgeu4(a.w, t4));
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

__device__ __forceinline__ bool any4(uint4 a) {
  return (a.x | a.y | a.z | a.w) != 0u;
}

// 0xff in each of the strip's first n bytes, 0 in the rest.
__device__ __forceinline__ uint4 first_bytes(int n) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = n - 4 * i;
    w[i] = k >= 4 ? 0xffffffffu : k <= 0 ? 0u : (1u << (8 * k)) - 1u;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Grid (x tiles, ceil(my / kRowsY), mz), block (kStripsX, kRowsY), shared
// memory kRowsY * n_strips * 16 bytes. VEC: W % 16 == 0 (16-byte loads).
template <bool GRAD, bool VEC>
__global__ void __launch_bounds__(kStripsX * kRowsY)
occupancy_kernel(const uint8_t* __restrict__ vol,
                 const uint8_t* __restrict__ grad, uint8_t* __restrict__ out,
                 int D, int H, int W, int my, int mx, int bz, int by, int bx,
                 int tile_cells, int n_strips, uint32_t ti4, uint32_t tg4,
                 int all_occupied) {
  extern __shared__ uint4 flags[];      // [kRowsY][n_strips] strips
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cz = blockIdx.z, cy = blockIdx.y * kRowsY + ty;
  const int c0 = blockIdx.x * tile_cells;
  const int x0 = c0 * bx, xa = x0 & ~15;
  const int z0 = cz * bz, y0 = cy * by;
  const int nz = min(bz, D - z0);
  const int ny = cy < my ? max(0, min(by, H - y0)) : 0;
  const int rows = all_occupied || nz <= 0 ? 0 : nz * ny;

  for (int s = tx; s < n_strips; s += kStripsX) {
    const int xs = xa + 16 * s;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    if (xs < W && rows > 0) {
      const int n_valid = min(16, W - xs);
      for (int r0 = 0; r0 < rows; r0 += kBatch) {
        size_t off[kBatch];
        uint4 m[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          // Past the last row, the last row again: it ORs in nothing new.
          const int r = min(r0 + k, rows - 1);
          off[k] = ((size_t)(z0 + r / ny) * H + (y0 + r % ny)) * W + xs;
          m[k] = load16(vol + off[k], n_valid, VEC);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) m[k] = cmp_ge(m[k], ti4);
        if (GRAD) {
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (any4(m[k]))
              m[k] = and4(m[k], cmp_ge(load16(grad + off[k], n_valid, VEC),
                                       tg4));
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) acc = or4(acc, m[k]);
      }
      if (!VEC) acc = and4(acc, first_bytes(n_valid));
    }
    flags[ty * n_strips + s] = acc;
  }
  __syncthreads();

  const uint8_t* f = reinterpret_cast<const uint8_t*>(flags);
  for (int i = ty * kStripsX + tx; i < kRowsY * tile_cells;
       i += kStripsX * kRowsY) {
    const int row = i / tile_cells, c = i - row * tile_cells;
    const int oy = blockIdx.y * kRowsY + row, ox = c0 + c;
    if (oy >= my || ox >= mx) continue;
    const uint8_t* p = f + (size_t)row * n_strips * 16 + (x0 - xa) + c * bx;
    bool occ = all_occupied != 0;
    for (int k = 0; k < bx && !occ; ++k) occ = p[k] != 0;
    out[((size_t)cz * my + oy) * mx + ox] = occ ? kOccupied : kEmpty;
  }
}

template <bool GRAD>
cudaError_t launch(const uint8_t* vol, const uint8_t* grad, uint8_t* out,
                   int D, int H, int W, int my, int mx, int bz, int by,
                   int bx, int tile_cells, int n_strips, dim3 grid,
                   size_t smem, uint32_t ti4, uint32_t tg4, int all,
                   cudaStream_t s) {
  const dim3 block(kStripsX, kRowsY);
  if (W % 16 == 0)
    occupancy_kernel<GRAD, true><<<grid, block, smem, s>>>(
        vol, grad, out, D, H, W, my, mx, bz, by, bx, tile_cells, n_strips,
        ti4, tg4, all);
  else
    occupancy_kernel<GRAD, false><<<grid, block, smem, s>>>(
        vol, grad, out, D, H, W, my, mx, bz, by, bx, tile_cells, n_strips,
        ti4, tg4, all);
  return cudaGetLastError();
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

}  // namespace

// The u8 occupancy map (mz, my, mx) of a (D, H, W) u8 volume; grad is the
// (D, H, W) u8 gradient map, or null for an intensity-only TF. ti, tg in
// [0, 255]. Every base 16-byte aligned.
extern "C" int vkv_occupancy(const void* vol, const void* grad, void* out,
                             int D, int H, int W, int mz, int my, int mx,
                             int ti, int tg, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || mz <= 0 || my <= 0 || mx <= 0 ||
      ti < 0 || ti > 255 || tg < 0 || tg > 255)
    return (int)cudaErrorInvalidValue;
  const int bz = (D + mz - 1) / mz, by = (H + my - 1) / my,
            bx = (W + mx - 1) / mx;
  // A tile of whole cells on 16-byte boundaries: a multiple of
  // lcm(16, bx) bytes; else (bx > 64 and odd) up to 1008 bytes from any
  // byte, one strip more.
  const int unit = 16 / gcd(16, bx);
  int tile_cells, n_strips;
  if (unit * bx <= kTileBytes) {
    tile_cells = unit * (kTileBytes / (unit * bx));
    n_strips = tile_cells * bx / 16;
  } else {
    tile_cells = (kTileBytes - 16) / bx > 0 ? (kTileBytes - 16) / bx : 1;
    n_strips = (tile_cells * bx + 30) / 16;
  }
  const size_t smem = (size_t)kRowsY * n_strips * 16;
  const int tiles_x = (mx + tile_cells - 1) / tile_cells;
  const int tiles_y = (my + kRowsY - 1) / kRowsY;
  if (smem > (size_t)kMaxSharedBytes || tiles_y > 65535 || mz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(tiles_x, tiles_y, mz);
  const uint32_t ti4 = 0x01010101u * (uint32_t)ti;
  const uint32_t tg4 = 0x01010101u * (uint32_t)tg;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)vol;
  uint8_t* o = (uint8_t*)out;
  if (grad != nullptr)
    return (int)launch<true>(v, (const uint8_t*)grad, o, D, H, W, my, mx, bz,
                             by, bx, tile_cells, n_strips, grid, smem, ti4,
                             tg4, 0, s);
  return (int)launch<false>(v, nullptr, o, D, H, W, my, mx, bz, by, bx,
                            tile_cells, n_strips, grid, smem, ti4, tg4,
                            ti == 0, s);
}

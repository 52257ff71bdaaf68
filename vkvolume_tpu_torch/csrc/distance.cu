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
//       and its two-sided form, relax_dirs=(0,), on the one isotropic map.
//   K5  vkvolume_tpu/accel/distance_pallas.py:_scan_relax_kernel with
//       scan_dir=0, relax_dirs=(0,): the two-sided x-line scan, then the
//       two-sided y relaxation.
//   K6  vkvolume_tpu/accel/distance_pallas.py:_relax_kernel (via relax_z
//       and relax_pallas): one uncapped relaxation of one map along z or
//       y, two-sided or one-sided. The TPU kernel relaxes z through a
//       (Y, Z, X) transpose so that lines lie on sublanes; here the axis
//       is a stride.
//
// K4, K5 and K6 are one kernel, relax_lines_kernel, instantiated per
// sense (and, for K5, with the x-scan as its prologue). K3 is its sibling,
// scan_relax4_kernel: the same tables, search and step, two tables (one
// per x-scan sense) and four walks per thread.
//
// The relaxation A[l] = min_{n >= 0, in bounds} max(n, D[l + s n]) in one
// sense s is computed without a loop as long as the distance. (Two-sided:
// the minimum of the two senses.) Two facts make it cheap:
//  - a search: A[l] is the least t for which the window [l, l + t] (or
//    [l - t, l]) holds a value <= t. The window's minimum only falls as t
//    grows, and t = D[l] <= 255 qualifies, so t is found by descending
//    powers of two: at most 8 probes;
//  - a step: from the neighbour's a = A[l - s], A[l] = min(D[l], B) where
//    B is a or a + 1 (each term max(n, D[l + s n]), n >= 1, is the
//    neighbour's term at n - 1 or one more), and a exactly when one of the
//    a cells past l holds at most a: one probe.
// Each probe is the minimum of a window: two entries of a sparse table
// whose level k holds the minima of the windows of 2^k cells.
//
// What bounds it on the H100: neither bytes nor operations at the beetle's
// maps (124 x 208 x 208 u8 = 5.4 MB each, L2-resident), but the latency of
// dependent loads: a loop that walks n = 1, 2, ... per cell would run as
// many dependent loads as the answer (about 42 per cell and sense for K4
// and 150 for K5 there). Design: a block
// owns a tile of whole lines, C neighbouring columns of one (outer) index,
// loaded once into shared memory; it builds the table there (each level
// one __vminu4 pass over the tile), and each thread walks a run of cells
// of one column, the first by the search and every next one by a step,
// so a cell costs about one probe of shared memory. Outputs are written
// once. Lines longer than the shared memory can hold are cut into
// segments with a halo of 255 cells on each side (no window reaches
// further). K5's x-scan runs in the same block, one thread per row:
// g[x] = min_{x'} occ[x'] + |x - x'| by the two linear passes
// g = min(occ[x], g[x -+ 1] + 1) over the block's columns and the 255
// cells around them. The x-scan map never goes to device memory. Tile
// sizes come from the shape: C <= 64 columns, rounded up to a multiple of
// 4, shrunk until the table fits 100 KB; runs of ceil(L / (512 / C))
// cells. Integer arithmetic throughout, as the TPU kernels: exact, so
// kernel and plain version agree bit for bit.
//
// K3's values are capped (cap <= 255, ANISO_CAP = 63 on the engine's
// path), which shrinks all of this: a one-sided x-scan needs only the
// cap - 1 cells beyond the block's columns on its own side (a cell further
// out adds at least cap), no relaxation window of values <= cap spans more
// than cap cells (levels_for(cap) levels: 6 at 63, not 8), and a segment
// of a long line needs a halo of cap rows, not 255. Its block holds two
// tables, one per x-scan sense, level-interleaved (level k of the +x
// table, then level k of the -x table), and each thread walks its run
// four times (both y senses of both tables, four independent chains).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- relax_lines_kernel (K4, K5, K6) ----------------------------------

// Senses: both one-sided relaxations of each input (K4 x8, outputs 2j and
// 2j + 1), the two-sided one, or one sense.
enum Sense { kPlusMinus = 0, kBoth = 1, kPlus = 2, kMinus = 3 };

constexpr int kLineThreads = 512;
constexpr int kHalo = 255;          // no window reaches further
constexpr int kMaxColumns = 64;
constexpr int kTableBytes = 100 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024;  // a block's most on the H100
constexpr int kBig = 1 << 20;

// Levels of a table over T cells: windows of 2^k <= min(T, 255) (no
// window of a one-sided relaxation of u8 values spans more).
int levels_for(int T) {
  const int n = T < 255 ? T : 255;
  int k = 0;
  while ((2 << k) <= n) ++k;
  return k + 1;
}

// min(D[a .. b]) of one column, a <= b tile rows: two entries of the level
// of the largest power of two within the window. `col` is the column's
// entry of row 0 of level 0; level k (LS bytes after level k - 1) holds
// min(D[m .. m + 2^k - 1]) at row m, C bytes after row m - 1.
__device__ __forceinline__ int window_min(const uint8_t* col, int LS, int C,
                                          int a, int b) {
  const int j = 31 - __clz(b - a + 1);
  const uint8_t* lv = col + j * LS;
  return min((int)lv[a * C], (int)lv[(b - (1 << j) + 1) * C]);
}

// One-sided relaxation (S = kPlus or kMinus) of the cell at tile row m by
// a search: the least t with min(D over [m, m + t] or [m - t, m]) <= t, by
// descending powers of two from floor(log2 D[m]); windows clip to the
// tile [0, T).
template <int S>
__device__ __forceinline__ int search(const uint8_t* col, int LS, int T,
                                      int C, int m) {
  const int d = col[m * C];
  int t0 = -1;  // the largest t known to fail
  if (d == 0) return 0;
  for (int k = 31 - __clz(d); k >= 0; --k) {
    const int t = t0 + (1 << k);
    if (t >= d) continue;  // holds at D[m] itself
    const int w = S == kPlus ? window_min(col, LS, C, m, min(m + t, T - 1))
                             : window_min(col, LS, C, max(m - t, 0), m);
    if (w > t) t0 = t;
  }
  return t0 + 1;
}

// The same relaxation at row m from its neighbour's a = A[m + 1] (kPlus)
// or A[m - 1] (kMinus): A[m] = min(D[m], B) with B = min_{n >= 1}
// max(n, D[m +- n]), which is a or a + 1 (each term is the neighbour's
// term at n - 1, or one more), and a exactly when a cell within a of m,
// past it, holds at most a.
template <int S>
__device__ __forceinline__ int step(const uint8_t* col, int LS, int T, int C,
                                    int m, int a) {
  int B = a + 1;
  if (a > 0) {
    const int w = S == kPlus ? window_min(col, LS, C, m + 1,
                                          min(m + a, T - 1))
                             : window_min(col, LS, C, max(m - a, 0), m - 1);
    if (w <= a) B = a;
  }
  return min((int)col[m * C], B);
}

// K5's x-scan of one row, staged in shared memory from x = xa to xb, into
// dst[x - c0] for the block's columns x in [c0, c1): the two linear passes
// g = min(occ[x], g[x -+ 1] + 1), each started up to 255 cells out (a cell
// further away adds at least 256 and never wins against occ[x] <= 255).
__device__ __forceinline__ void scan_row(const uint8_t* __restrict__ row,
                                         int xa, int xb, int c0, int c1,
                                         uint8_t* __restrict__ dst) {
  int g = kBig;
#pragma unroll 8
  for (int x = xa; x < c1; ++x) {
    g = min((int)row[x - xa], g + 1);
    if (x >= c0) dst[x - c0] = (uint8_t)g;
  }
  g = kBig;
#pragma unroll 8
  for (int x = xb - 1; x >= c0; --x) {
    g = min((int)row[x - xa], g + 1);
    if (x < c1) dst[x - c0] = (uint8_t)min((int)dst[x - c0], g);
  }
}

// Bytes per staged row of an x-scan over w cells (the block's columns and
// the halo), padded to an odd number of words (a thread per row reads its
// own row: an odd stride keeps the 32 rows of a warp on 32 banks).
__host__ __device__ int stage_stride(int w) { return ((w + 3) / 4 | 1) * 4; }

// Rows [0, nb) of w cells (row m at src + m * pitch) into shared memory
// (row m at stage + m * W), one warp per row: coalesced loads, a byte
// each, or a word each when `words` (src, pitch, w and W multiples of 4).
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ src,
                                           long long pitch, int nb, int w,
                                           uint8_t* __restrict__ stage,
                                           int W, bool words) {
  if (words) {
    for (int m = threadIdx.x / 32; m < nb; m += kLineThreads / 32)
      for (int x = threadIdx.x % 32; x < w / 4; x += 32)
        reinterpret_cast<uint32_t*>(stage + m * W)[x] =
            reinterpret_cast<const uint32_t*>(src + m * pitch)[x];
    return;
  }
  for (int m = threadIdx.x / 32; m < nb; m += kLineThreads / 32)
    for (int x = threadIdx.x % 32; x < w; x += 32)
      stage[m * W + x] = src[m * pitch + x];
}

// Lines of length L at stride `inner` (outer x L x inner maps, n_maps of
// them n_cells apart), relaxed in sense(s) S. Block: C columns of one outer
// index of one map, one segment of seg_len cells of the line (tile rows
// [lo, hi) with the halo). XSCAN: level 0 is the two-sided x-scan of `in`
// (L = Y, inner = X).
template <int S, bool XSCAN>
__global__ void __launch_bounds__(kLineThreads, XSCAN ? 2 : 3)
relax_lines_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   long long n_cells, int outer, int L, long long inner,
                   int C, int seg_len, int n_levels, long long n_chunks,
                   int run, int stage_bytes, int words) {
  extern __shared__ uint32_t table_words[];
  uint8_t* lev = reinterpret_cast<uint8_t*>(table_words);

  long long b = blockIdx.x;
  const long long ch = b % n_chunks;
  b /= n_chunks;
  const int o = (int)(b % outer);
  const int map = (int)(b / outer);
  const long long c0 = ch * C;
  const int cw = (int)min((long long)C, inner - c0);
  const int s0 = blockIdx.y * seg_len, s1 = min(L, s0 + seg_len);
  const int lo = max(0, s0 - kHalo), hi = min(L, s1 + kHalo);
  const int T = hi - lo;
  const long long line0 = (long long)map * n_cells +
                          (long long)o * L * inner + c0;  // (o, 0, c0)

  if constexpr (XSCAN) {
    // Batches of rows staged with coalesced loads (into the table's upper
    // levels, not built yet), then one thread per row.
    const int X = (int)inner, c1 = (int)c0 + cw;
    const int xa = max(0, (int)c0 - kHalo), xb = min(X, c1 + kHalo);
    const int W = stage_stride(xb - xa);
    uint8_t* stage = lev + T * C;
    const int batch = stage_bytes / W;
    const uint8_t* row0 = in + line0 - c0 + (long long)lo * inner + xa;
    for (int b0 = 0; b0 < T; b0 += batch) {
      const int nb = min(batch, T - b0);
      __syncthreads();
      stage_rows(row0 + (long long)b0 * inner, inner, nb, xb - xa, stage, W,
                 false);
      __syncthreads();
      for (int m = threadIdx.x; m < nb; m += kLineThreads)
        scan_row(stage + m * W, xa, xb, (int)c0, c1, lev + (b0 + m) * C);
    }
  } else if (words) {
    // Rows of whole 4-byte words: one load per 4 columns (on the H100,
    // bench/distance_probe.py at the beetle's maps: 10-20 % less time per
    // relaxation than a byte per column).
    const int C4 = C / 4;
    for (int i = threadIdx.x; i < T * C4; i += kLineThreads) {
      const int m = i / C4, c = 4 * (i - m * C4);
      const long long g = line0 + (long long)(lo + m) * inner + c;
      uint32_t w = 0xffffffffu;
      if (c + 4 <= cw) {
        w = *reinterpret_cast<const uint32_t*>(in + g);
      } else {
        for (int e = 0; e < cw - c; ++e)
          w = (w & ~(0xffu << (8 * e))) | ((uint32_t)in[g + e] << (8 * e));
      }
      table_words[m * C4 + (c >> 2)] = w;
    }
  } else {
    for (int m = threadIdx.x / 32; m < T; m += kLineThreads / 32)
      for (int c = threadIdx.x % 32; c < C; c += 32)
        lev[m * C + c] = c < cw ? in[line0 + (long long)(lo + m) * inner + c]
                                : 255;
  }

  // Level k: windows of 2^k cells, rows [0, T - 2^k].
  const int C4 = C / 4;
  for (int k = 1; k < n_levels; ++k) {
    const int rows = T - (1 << k) + 1;
    if (rows <= 0) break;
    __syncthreads();
    const uint32_t* src = table_words + (long long)(k - 1) * T * C4;
    uint32_t* dst = table_words + (long long)k * T * C4;
    const int half = (1 << (k - 1)) * C4;
    for (int i = threadIdx.x; i < rows * C4; i += kLineThreads)
      dst[i] = __vminu4(src[i], src[i + half]);
  }
  __syncthreads();

  // Each thread walks one run of `run` rows of one column, in each sense
  // the kernel makes: the run's first cell in walking order by the
  // search, every next one by one step. The two-sided relaxation is the
  // minimum of the two senses (the thread's + results wait in `plus`).
  const int c = threadIdx.x % C, r = threadIdx.x / C;
  const int ma = s0 - lo + r * run, mb = min(s1 - lo, ma + run);
  if (c >= cw || r >= kLineThreads / C || ma >= mb) return;
  const int LS = T * C;
  const uint8_t* col = lev + c;
  uint8_t* plus = lev + n_levels * LS + c;
  const long long g0 = (long long)o * L * inner + (long long)lo * inner + c0
                       + c;  // tile row 0 of the column, within one map
  if constexpr (S == kPlusMinus) {
    // Both senses at once (two independent chains), each to its map.
    uint8_t* up = out + 2LL * map * n_cells + g0 + (mb - 1) * inner;
    uint8_t* dn = out + (2LL * map + 1) * n_cells + g0 + ma * inner;
    int ap = search<kPlus>(col, LS, T, C, mb - 1);
    int am = search<kMinus>(col, LS, T, C, ma);
    for (int i = 0;; ++i, up -= inner, dn += inner) {
      *up = (uint8_t)ap;
      *dn = (uint8_t)am;
      if (ma + i + 1 >= mb) break;
      ap = step<kPlus>(col, LS, T, C, mb - 2 - i, ap);
      am = step<kMinus>(col, LS, T, C, ma + 1 + i, am);
    }
    return;
  }
  uint8_t* dst = out + (long long)map * n_cells + g0;
  if constexpr (S != kMinus) {
    int a = search<kPlus>(col, LS, T, C, mb - 1);
    for (int m = mb - 1;; a = step<kPlus>(col, LS, T, C, m, a)) {
      if constexpr (S == kBoth) plus[m * C] = (uint8_t)a;
      else dst[m * inner] = (uint8_t)a;
      if (--m < ma) break;
    }
  }
  if constexpr (S != kPlus) {
    int a = search<kMinus>(col, LS, T, C, ma);
    for (int m = ma;; a = step<kMinus>(col, LS, T, C, m, a)) {
      dst[m * inner] = (uint8_t)(S == kBoth ? min(a, (int)plus[m * C]) : a);
      if (++m >= mb) break;
    }
  }
}

// Tiles of one relaxation: C columns, segments of seg_len cells, a table
// of n_levels levels over at most T rows and the + results of a two-sided
// walk (one more level's bytes), runs of `run` rows per thread.
struct Tiling {
  int C, seg_len, n_segs, n_levels, run, stage_bytes;
  long long n_chunks;
  size_t smem;
};

Tiling plan_tiles(int L, long long inner) {
  Tiling t{};
  int T = L;
  for (int cmax = kMaxColumns; cmax >= 4; cmax /= 2) {
    const long long nch = (inner + cmax - 1) / cmax;
    t.C = (int)(((inner + nch - 1) / nch + 3) / 4 * 4);
    if ((size_t)(levels_for(L) + 1) * L * t.C <= (size_t)kTableBytes) break;
  }
  t.seg_len = L;
  if ((size_t)(levels_for(L) + 1) * L * t.C > (size_t)kTableBytes) {
    // Lines too long for one table even at 4 columns: segments with halos.
    T = kTableBytes / ((levels_for(1 << 30) + 1) * t.C);
    t.seg_len = T - 2 * kHalo;
  }
  t.n_segs = (L + t.seg_len - 1) / t.seg_len;
  t.n_levels = levels_for(T);
  t.n_chunks = (inner + t.C - 1) / t.C;
  const int runs = kLineThreads / t.C;
  const int rows = L < t.seg_len ? L : t.seg_len;
  t.run = (rows + runs - 1) / runs;
  t.smem = (size_t)(t.n_levels + 1) * T * t.C;
  // K5 stages at least one row of its x-scan above level 0.
  const size_t row = stage_stride(
      (int)(inner < t.C + 2 * kHalo ? inner : t.C + 2 * kHalo));  // widest
  if (t.smem < (size_t)T * t.C + row) t.smem = (size_t)T * t.C + row;
  t.stage_bytes = (int)(t.smem - (size_t)T * t.C);
  return t;
}

template <int S, bool XSCAN>
int launch_lines(const uint8_t* in, uint8_t* out, int n_maps, int outer,
                 int L, long long inner, cudaStream_t stream) {
  const long long n_cells = (long long)outer * L * inner;
  if (n_cells == 0) return 0;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        relax_lines_kernel<S, XSCAN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const Tiling t = plan_tiles(L, inner);
  const long long nx = t.n_chunks * outer * n_maps;
  if (nx > 0x7fffffffLL || t.n_segs > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // Word loads need every row of the tile 4-byte aligned.
  const int words = inner % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(in) % 4 == 0;
  dim3 grid((unsigned)nx, (unsigned)t.n_segs);
  relax_lines_kernel<S, XSCAN><<<grid, kLineThreads, t.smem, stream>>>(
      in, out, n_cells, outer, L, inner, t.C, t.seg_len, t.n_levels,
      t.n_chunks, t.run, t.stage_bytes, words);
  return (int)cudaGetLastError();
}

// ---- scan_relax4_kernel (K3) --------------------------------------------

// K3's one-sided x-scan of one staged row (cells from x = xa), capped at
// cap, into dst[x - c0] for the block's columns x in [c0, c1): S = kPlus
// g = min(occ[x], g[x + 1] + 1) from x = xb - 1 down, kMinus
// g = min(occ[x], g[x - 1] + 1) from xa up. xb >= min(X, c1 + cap - 1) and
// xa <= max(0, c0 - cap + 1): a cell further out adds at least cap, so the
// capped value is exact.
template <int S>
__device__ __forceinline__ void scan_row_capped(const uint8_t* __restrict__ row,
                                                int xa, int xb, int c0,
                                                int c1, int cap,
                                                uint8_t* __restrict__ dst) {
  int g = kBig;
  if constexpr (S == kPlus) {
    for (int x = xb - 1; x >= c1; --x) g = min((int)row[x - xa], g + 1);
    for (int x = c1 - 1; x >= c0; --x) {
      g = min((int)row[x - xa], g + 1);
      dst[x - c0] = (uint8_t)min(g, cap);
    }
  } else {
    for (int x = xa; x < c0; ++x) g = min((int)row[x - xa], g + 1);
    for (int x = c0; x < c1; ++x) {
      g = min((int)row[x - xa], g + 1);
      dst[x - c0] = (uint8_t)min(g, cap);
    }
  }
}

// K3: lines of length L (y) at stride X in a (Z, L, X) occupancy map. Block:
// C columns of one z, one segment of seg_len rows (tile rows [lo, hi) with
// a halo of cap). Level 0 of the +x table is the capped +x scan, of the -x
// table the -x scan; outputs scan-major ((+x,+y), (+x,-y), (-x,+y),
// (-x,-y)), each written once.
__global__ void __launch_bounds__(kLineThreads, 2)
scan_relax4_kernel(const uint8_t* __restrict__ occ, uint8_t* __restrict__ out,
                   long long n_cells, int L, int X, int cap, int C,
                   int seg_len, int n_levels, int n_chunks, int run,
                   int stage_bytes, int words) {
  extern __shared__ uint32_t table_words[];
  uint8_t* lev = reinterpret_cast<uint8_t*>(table_words);

  const int ch = (int)(blockIdx.x % n_chunks);
  const long long plane = (long long)(blockIdx.x / n_chunks) * L * X;
  const int c0 = ch * C, cw = min(C, X - c0), c1 = c0 + cw;
  const int s0 = blockIdx.y * seg_len, s1 = min(L, s0 + seg_len);
  const int lo = max(0, s0 - cap), hi = min(L, s1 + cap);
  const int T = hi - lo, TC = T * C;

  // Rows staged above both level-0 tables (where the upper levels go
  // later), batch by batch; then thread m scans row m in the + sense and
  // thread nb + m in the - sense. The staged span is cap - 1 cells each
  // side, widened to whole words (more cells never change a capped scan).
  const int xa = max(0, c0 - (cap - 1)) & ~3;
  const int xb = min(X, (c1 + cap - 1 + 3) & ~3);
  const int W = stage_stride(xb - xa);
  uint8_t* stage = lev + 2 * TC;
  const int batch = stage_bytes / W;
  const uint8_t* row0 = occ + plane + (long long)lo * X + xa;
  for (int b0 = 0; b0 < T; b0 += batch) {
    const int nb = min(batch, T - b0);
    __syncthreads();
    stage_rows(row0 + (long long)b0 * X, X, nb, xb - xa, stage, W, words);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * nb; i += kLineThreads) {
      if (i < nb)
        scan_row_capped<kPlus>(stage + i * W, xa, xb, c0, c1, cap,
                               lev + (b0 + i) * C);
      else
        scan_row_capped<kMinus>(stage + (i - nb) * W, xa, xb, c0, c1, cap,
                                lev + TC + (b0 + i - nb) * C);
    }
  }

  // Level k of both tables (windows of 2^k cells, rows [0, T - 2^k]).
  const int C4 = C / 4, TC4 = T * C4;
  for (int k = 1; k < n_levels; ++k) {
    const int rows = T - (1 << k) + 1;
    if (rows <= 0) break;
    __syncthreads();
    const uint32_t* src = table_words + (long long)(k - 1) * 2 * TC4;
    uint32_t* dst = table_words + (long long)k * 2 * TC4;
    const int half = (1 << (k - 1)) * C4, n = rows * C4;
    for (int i = threadIdx.x; i < 2 * n; i += kLineThreads) {
      const int j = i < n ? i : i - n + TC4;
      dst[j] = __vminu4(src[j], src[j + half]);
    }
  }
  __syncthreads();

  // Each thread walks one run of one column four times at once: both y
  // senses of both tables, each run's first cell by the search, every
  // next by one step.
  const int c = threadIdx.x % C, r = threadIdx.x / C;
  const int ma = s0 - lo + r * run, mb = min(s1 - lo, ma + run);
  if (c >= cw || r >= kLineThreads / C || ma >= mb) return;
  const int LS = 2 * TC;  // level stride of each table
  const uint8_t* colp = lev + c;       // the +x scan's table
  const uint8_t* coln = lev + TC + c;  // the -x scan's
  const long long g0 = plane + (long long)lo * X + c0 + c;
  uint8_t* pu = out + g0 + (long long)(mb - 1) * X;
  uint8_t* pd = out + n_cells + g0 + (long long)ma * X;
  uint8_t* nu = out + 2 * n_cells + g0 + (long long)(mb - 1) * X;
  uint8_t* nd = out + 3 * n_cells + g0 + (long long)ma * X;
  int ap = search<kPlus>(colp, LS, T, C, mb - 1);
  int am = search<kMinus>(colp, LS, T, C, ma);
  int bp = search<kPlus>(coln, LS, T, C, mb - 1);
  int bm = search<kMinus>(coln, LS, T, C, ma);
  for (int i = 0;; ++i, pu -= X, pd += X, nu -= X, nd += X) {
    *pu = (uint8_t)ap;
    *pd = (uint8_t)am;
    *nu = (uint8_t)bp;
    *nd = (uint8_t)bm;
    if (ma + i + 1 >= mb) break;
    ap = step<kPlus>(colp, LS, T, C, mb - 2 - i, ap);
    am = step<kMinus>(colp, LS, T, C, ma + 1 + i, am);
    bp = step<kPlus>(coln, LS, T, C, mb - 2 - i, bp);
    bm = step<kMinus>(coln, LS, T, C, ma + 1 + i, bm);
  }
}

// K3's tiles: as plan_tiles, for two tables of levels_for(min(T, cap))
// levels each, segments with a halo of cap, and at least one staged row
// of C + 2 (cap - 1) cells (+ 6 for the widening to words) above level 0.
Tiling plan_scan_tiles(int L, int X, int cap) {
  auto tables = [cap](int T, int C) {
    return (size_t)2 * levels_for(T < cap ? T : cap) * T * C;
  };
  Tiling t{};
  int T = L;
  for (int cmax = kMaxColumns; cmax >= 4; cmax /= 2) {
    const int nch = (X + cmax - 1) / cmax;
    t.C = ((X + nch - 1) / nch + 3) / 4 * 4;
    if (tables(L, t.C) <= (size_t)kTableBytes) break;
  }
  t.seg_len = L;
  if (tables(L, t.C) > (size_t)kTableBytes) {
    T = kTableBytes / (2 * levels_for(cap) * t.C);
    t.seg_len = T - 2 * cap;
  }
  t.n_segs = (L + t.seg_len - 1) / t.seg_len;
  t.n_levels = levels_for(T < cap ? T : cap);
  t.n_chunks = (X + t.C - 1) / t.C;
  const int runs = kLineThreads / t.C;
  const int rows = L < t.seg_len ? L : t.seg_len;
  t.run = (rows + runs - 1) / runs;
  const size_t level0 = (size_t)2 * T * t.C;
  const size_t row = stage_stride(t.C + 2 * (cap - 1) + 6);
  t.smem = tables(T, t.C);
  if (t.smem < level0 + row) t.smem = level0 + row;
  t.stage_bytes = (int)(t.smem - level0);
  return t;
}

}  // namespace

// K3: the four (+-x scan capped at cap) x (+-y relaxation) maps of a
// (Z, Y, X) occupancy map, scan-major, one launch. cap in [1, 255].
extern "C" int vkv_scan_relax4(const void* occ, void* out4, int Z, int Y,
                               int X, int cap, void* stream) {
  if (cap < 1 || cap > 255) return (int)cudaErrorInvalidValue;
  const long long n_cells = (long long)Z * Y * X;
  if (n_cells == 0) return 0;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_relax4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const Tiling t = plan_scan_tiles(Y, X, cap);
  const long long nx = t.n_chunks * Z;
  if (nx > 0x7fffffffLL || t.n_segs > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // Word loads need every staged row 4-byte aligned.
  const int words = X % 4 == 0 && reinterpret_cast<uintptr_t>(occ) % 4 == 0;
  dim3 grid((unsigned)nx, (unsigned)t.n_segs);
  scan_relax4_kernel<<<grid, kLineThreads, t.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (uint8_t*)out4, n_cells, Y, X, cap, t.C,
      t.seg_len, t.n_levels, (int)t.n_chunks, t.run, t.stage_bytes, words);
  return (int)cudaGetLastError();
}

// K4 x8: each of the 4 (Z, Y, X) inputs relaxed along +z and -z, outputs
// input-major (map 2j + d is input j along +z (d = 0) or -z (d = 1), which
// is octant index (sx<0)<<2 | (sy<0)<<1 | (sz<0)).
extern "C" int vkv_z_relax8(const void* in4, void* out8, int Z, int Y, int X,
                            void* stream) {
  return launch_lines<kPlusMinus, false>(
      (const uint8_t*)in4, (uint8_t*)out8, 4, 1, Z, (long long)Y * X,
      (cudaStream_t)stream);
}

// K5: the two-sided x-scan and the two-sided y relaxation, one launch.
extern "C" int vkv_scan_relax2(const void* occ, void* out, int Z, int Y,
                               int X, void* stream) {
  return launch_lines<kBoth, true>((const uint8_t*)occ, (uint8_t*)out, 1, Z,
                                   Y, X, (cudaStream_t)stream);
}

// K6 (and the two-sided K4): axis 0 (z) or 1 (y); dir 0 (two-sided), +1
// or -1.
extern "C" int vkv_relax(const void* in, void* out, int Z, int Y, int X,
                         int axis, int dir, void* stream) {
  if ((axis != 0 && axis != 1) || dir < -1 || dir > 1)
    return (int)cudaErrorInvalidValue;
  const int outer = axis == 0 ? 1 : Z, L = axis == 0 ? Z : Y;
  const long long inner = axis == 0 ? (long long)Y * X : (long long)X;
  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (dir == 0) return launch_lines<kBoth, false>(src, dst, 1, outer, L,
                                                  inner, s);
  if (dir > 0) return launch_lines<kPlus, false>(src, dst, 1, outer, L,
                                                 inner, s);
  return launch_lines<kMinus, false>(src, dst, 1, outer, L, inner, s);
}

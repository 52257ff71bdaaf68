// The 8 x 128 (K7) or tile_h x 128 (K1) tile of a sweep kernel as one CUDA
// block of 128 x 4 threads, and what its tile-uniform control flow needs:
// block-wide reductions (warp shuffles, then shared memory) and the index
// helpers with the TPU kernels' semantics (floor division, clamps, and the
// float -> int conversion of an already floored value).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;
constexpr int kRows = 4;                    // blockDim.y
constexpr int kThreads = kTileW * kRows;
constexpr int kWarps = kThreads / 32;
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

struct Scratch {
  float f[kWarps];
  int i[kWarps];
};

__device__ __forceinline__ int lane_id() {
  return (threadIdx.y * kTileW + threadIdx.x) & 31;
}
__device__ __forceinline__ int warp_id() {
  return (threadIdx.y * kTileW + threadIdx.x) >> 5;
}

// Block-wide reductions; every thread of the block must call them.
__device__ float block_min(float v, Scratch& sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane_id() == 0) sh.f[warp_id()] = v;
  __syncthreads();
  float r = sh.f[0];
  for (int w = 1; w < kWarps; ++w) r = fminf(r, sh.f[w]);
  __syncthreads();
  return r;
}
__device__ float block_max(float v, Scratch& sh) {
  return -block_min(-v, sh);
}
__device__ int block_min_int(int v, Scratch& sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane_id() == 0) sh.i[warp_id()] = v;
  __syncthreads();
  int r = sh.i[0];
  for (int w = 1; w < kWarps; ++w) r = min(r, sh.i[w]);
  __syncthreads();
  return r;
}

}  // namespace

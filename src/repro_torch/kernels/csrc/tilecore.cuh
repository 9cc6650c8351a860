// The 64x64 verify tile shared by the pairdist (plain and filtered) and
// verify-compact kernels: shared-memory staging, the L-inf pivot bound pass
// with its whole-tile vote, and the exact distance loop. Both kernels run
// this same code, so a pair's distance and bound are bit-identical in the
// mask path and the compact path.
//
// Layout. One CTA of 256 threads per 64x64 output tile; each thread owns a
// 4x4 micro-tile strided by 16 in both directions (rows ty+16i, columns
// tx+16j, tx = tid % 16, ty = tid / 16), so the shared-memory reads of a
// warp are broadcasts on the x side and 16 consecutive words on the y side.
// The feature axis is a loop over 16-feature chunks staged in shared memory
// (rows padded to 65 words against bank conflicts); the accumulator stays
// in registers. Out-of-range rows and features stage as 0, which is exact
// for every metric, so no caller pads.
#pragma once

#include "distcore.cuh"

namespace repro_torch {

constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr int kPad = kTile + 1;

struct TileSmem {
  float xs[kChunk][kPad];
  float ys[kChunk][kPad];
  float xn[kTile];  // l2: row norms of the x tile
  float yn[kTile];  // l2: row norms of the y tile
};

// Stage rows [r0, r0+64) x features [k0, k0+16) of a row-major (n, width)
// matrix into s[feature][row], zero-filling everything out of range.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ src, int r0,
                                            int n, int width, int k0,
                                            float (*s)[kPad]) {
#pragma unroll
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int k = e % kChunk;
    const int row = r0 + r;
    const int col = k0 + k;
    s[k][r] = (row < n && col < width) ? src[static_cast<size_t>(row) * width + col] : 0.0f;
  }
}

// The L-inf pivot bound max_p |px - py| of the thread's 4x4 micro-tile.
__device__ __forceinline__ void tile_bound(const float* __restrict__ px,
                                           const float* __restrict__ py, int a,
                                           int b, int bp, int r0, int c0,
                                           TileSmem& s, float (&bound)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) bound[i][j] = 0.0f;
  for (int k0 = 0; k0 < bp; k0 += kChunk) {
    stage_chunk(px, r0, a, bp, k0, s.xs);
    stage_chunk(py, c0, b, bp, k0, s.ys);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = s.xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bound[i][j] = fmaxf(bound[i][j], fabsf(xv - s.ys[k][tx + 16 * j]));
      }
    }
    __syncthreads();
  }
}

// Block-wide vote: non-zero iff some in-range pair of the CTA's tile has
// bound <= delta_bound. Every thread of the CTA must call it.
__device__ __forceinline__ int tile_live(const float (&bound)[4][4], int a, int b,
                                         int r0, int c0, float delta_bound) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  int live = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + ty + 16 * i;
      const int col = c0 + tx + 16 * j;
      if (row < a && col < b && bound[i][j] <= delta_bound) live = 1;
    }
  return __syncthreads_or(live);
}

// The exact distances of the thread's 4x4 micro-tile (entries out of range
// hold the distance of zero-staged rows; callers mask them).
template <int METRIC>
__device__ __forceinline__ void tile_distances(const float* __restrict__ x,
                                               const float* __restrict__ y, int a,
                                               int b, int m, int r0, int c0,
                                               TileSmem& s, float (&d)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // l2: row norm of x row tid (tid < 64) or y row tid-64

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    stage_chunk(x, r0, a, m, k0, s.xs);
    stage_chunk(y, c0, b, m, k0, s.ys);
    __syncthreads();
    if (METRIC == kL2 && tid < 2 * kTile) {
      float (*src)[kPad] = tid < kTile ? s.xs : s.ys;
      const int r = tid % kTile;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) norm = fmaf(src[k][r], src[k][r], norm);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = s.xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[j] = s.ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dist_step<METRIC>(acc[i][j], xv[i], yv[j]);
    }
    __syncthreads();
  }
  if (METRIC == kL2) {
    if (tid < kTile) s.xn[tid] = norm;
    else if (tid < 2 * kTile) s.yn[tid - kTile] = norm;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xn = METRIC == kL2 ? s.xn[ty + 16 * i] : 0.0f;
      const float yn = METRIC == kL2 ? s.yn[tx + 16 * j] : 0.0f;
      d[i][j] = dist_finalize<METRIC>(acc[i][j], xn, yn);
    }
}

}  // namespace repro_torch

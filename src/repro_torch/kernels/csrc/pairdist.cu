// Blocked all-pairs distance, plain and pivot-filtered, for Hopper (sm_90a).
//
// Replaces repro/kernels/pairdist.py::pairdist_blocked (plain: f32
// distances or an int8 D<=delta mask) and ::pairdist_filtered_blocked (the
// L-inf pivot bound max_p|px-py|, a whole-tile skip of the exact work when
// no pair survives the bound, and the int8 mask (D<=delta) & (bound<=db)).
//
// Design. The 64x64 CTA tile of tilecore.cuh (4x4 register micro-tile per
// thread, 16-feature shared-memory chunks; the Pallas grid's sequential
// feature axis becomes the loop inside the CTA, and the (a, b, m)
// intermediate never exists). The CTA masks its own ragged edges. The
// filtered variant first runs the bound pass over the pivot coordinates
// (bp is small: n_dims), decides with __syncthreads_or whether any
// in-range pair of the tile survives, and otherwise writes zeros and skips
// the feature loop.
//
// Bound. l1/linf are two fp32 instructions per pair-feature on the CUDA
// cores, l2/cosine/dot one FMA: the kernel is bound by operations at the
// verify engine's tile shapes (1024 x 4096 x 128: 0.5 G pair-features per
// 20 MB moved). The 64x64x16 staging gives 64 flops per shared word loaded.
#include "tilecore.cuh"

namespace repro_torch {

template <int METRIC, bool FILTERED>
__global__ void __launch_bounds__(kThreads)
pairdist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out_f, int8_t* __restrict__ out_m, int a,
                int b, int m, int bp, int has_delta, float delta,
                float delta_bound) {
  __shared__ TileSmem s;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float bound[4][4];
  if (FILTERED) {
    tile_bound(px, py, a, b, bp, r0, c0, s, bound);
    if (!tile_live(bound, a, b, r0, c0, delta_bound)) {
      // Whole-tile skip: every pair fails the bound, so the mask is 0.
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + ty + 16 * i;
          const int col = c0 + tx + 16 * j;
          if (row < a && col < b) out_m[static_cast<size_t>(row) * b + col] = 0;
        }
      return;
    }
  }

  float d[4][4];
  tile_distances<METRIC>(x, y, a, b, m, r0, c0, s, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= a) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= b) continue;
      const size_t o = static_cast<size_t>(row) * b + col;
      if (FILTERED) {
        out_m[o] = (d[i][j] <= delta && bound[i][j] <= delta_bound) ? 1 : 0;
      } else if (has_delta) {
        out_m[o] = d[i][j] <= delta ? 1 : 0;
      } else {
        out_f[o] = d[i][j];
      }
    }
  }
}

template <bool FILTERED>
int launch(const float* x, const float* y, const float* px, const float* py,
           float* out_f, int8_t* out_m, int a, int b, int m, int bp, int metric,
           int has_delta, float delta, float delta_bound, cudaStream_t stream) {
  if (a <= 0 || b <= 0) return 0;
  const dim3 grid((b + kTile - 1) / kTile, (a + kTile - 1) / kTile);
  const dim3 block(kThreads);
  switch (metric) {
#define REPRO_CASE(ID)                                                            \
  case ID:                                                                        \
    pairdist_kernel<ID, FILTERED><<<grid, block, 0, stream>>>(                    \
        x, y, px, py, out_f, out_m, a, b, m, bp, has_delta, delta, delta_bound); \
    break;
    REPRO_CASE(kL1)
    REPRO_CASE(kL2)
    REPRO_CASE(kLinf)
    REPRO_CASE(kCosine)
    REPRO_CASE(kDot)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int pairdist_launch(const float* x, const float* y, float* out_f,
                               int8_t* out_m, int a, int b, int m, int metric,
                               int has_delta, float delta, void* stream) {
  return repro_torch::launch<false>(x, y, nullptr, nullptr, out_f, out_m, a, b, m, 0,
                                    metric, has_delta, delta, 0.0f,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int pairdist_filtered_launch(const float* x, const float* y,
                                        const float* px, const float* py,
                                        int8_t* out_m, int a, int b, int m,
                                        int bp, int metric, float delta,
                                        float delta_bound, void* stream) {
  return repro_torch::launch<true>(x, y, px, py, nullptr, out_m, a, b, m, bp, metric, 1,
                                   delta, delta_bound,
                                   static_cast<cudaStream_t>(stream));
}

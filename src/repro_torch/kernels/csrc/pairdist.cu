// Blocked all-pairs distance, plain and pivot-filtered, for Hopper (sm_90a).
//
// Replaces repro/kernels/pairdist.py::pairdist_blocked (plain: f32
// distances or an int8 D<=delta mask) and ::pairdist_filtered_blocked (the
// L-inf pivot bound max_p|px-py|, a whole-tile skip of the exact work when
// no pair survives the bound, and the int8 mask (D<=delta) & (bound<=db)).
//
// Design. One CTA of 256 threads per 64x64 output tile; each thread owns a
// 4x4 micro-tile strided by 16 in both directions (rows ty+16i, columns
// tx+16j), so the shared-memory reads of a warp are broadcasts on the x side
// and 16 consecutive words on the y side. The Pallas grid's sequential
// feature axis becomes a loop inside the CTA over 16-feature chunks staged
// in shared memory (rows padded to 65 words against bank conflicts); the
// accumulator stays in registers and the (a, b, m) intermediate never
// exists. The CTA masks its own ragged edges: out-of-range rows and
// features stage as 0, which is exact for every metric. The filtered
// variant first runs the same loop over the pivot coordinates with the
// L-inf step (bp is small: n_dims), decides with __syncthreads_or whether
// any in-range pair of the tile survives, and otherwise writes zeros and
// skips the feature loop.
//
// Bound. l1/linf are two fp32 instructions per pair-feature on the CUDA
// cores, l2/cosine/dot one FMA: the kernel is bound by operations at the
// verify engine's tile shapes (1024 x 4096 x 128: 0.5 G pair-features per
// 20 MB moved). The 64x64x16 staging gives 64 flops per shared word loaded.
#include "distcore.cuh"

namespace repro_torch {

constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr int kPad = kTile + 1;

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

template <int METRIC, bool FILTERED>
__global__ void __launch_bounds__(kThreads)
pairdist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out_f, int8_t* __restrict__ out_m, int a,
                int b, int m, int bp, int has_delta, float delta,
                float delta_bound) {
  __shared__ float xs[kChunk][kPad];
  __shared__ float ys[kChunk][kPad];
  __shared__ float xn_s[kTile];
  __shared__ float yn_s[kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float bound[4][4];
  if (FILTERED) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) bound[i][j] = 0.0f;
    for (int k0 = 0; k0 < bp; k0 += kChunk) {
      stage_chunk(px, r0, a, bp, k0, xs);
      stage_chunk(py, c0, b, bp, k0, ys);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bound[i][j] = fmaxf(bound[i][j], fabsf(xv - ys[k][tx + 16 * j]));
        }
      }
      __syncthreads();
    }
    int live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = r0 + ty + 16 * i;
        const int col = c0 + tx + 16 * j;
        if (row < a && col < b && bound[i][j] <= delta_bound) live = 1;
      }
    if (!__syncthreads_or(live)) {
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

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // l2: row norm of x row tid (tid < 64) or y row tid-64

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    stage_chunk(x, r0, a, m, k0, xs);
    stage_chunk(y, c0, b, m, k0, ys);
    __syncthreads();
    if (METRIC == kL2 && tid < 2 * kTile) {
      float (*s)[kPad] = tid < kTile ? xs : ys;
      const int r = tid % kTile;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) norm = fmaf(s[k][r], s[k][r], norm);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[j] = ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dist_step<METRIC>(acc[i][j], xv[i], yv[j]);
    }
    __syncthreads();
  }
  if (METRIC == kL2) {
    if (tid < kTile) xn_s[tid] = norm;
    else if (tid < 2 * kTile) yn_s[tid - kTile] = norm;
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i;
    const int row = r0 + rl;
    if (row >= a) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx + 16 * j;
      const int col = c0 + cl;
      if (col >= b) continue;
      const float xn = METRIC == kL2 ? xn_s[rl] : 0.0f;
      const float yn = METRIC == kL2 ? yn_s[cl] : 0.0f;
      const float d = dist_finalize<METRIC>(acc[i][j], xn, yn);
      const size_t o = static_cast<size_t>(row) * b + col;
      if (FILTERED) {
        out_m[o] = (d <= delta && bound[i][j] <= delta_bound) ? 1 : 0;
      } else if (has_delta) {
        out_m[o] = d <= delta ? 1 : 0;
      } else {
        out_f[o] = d;
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

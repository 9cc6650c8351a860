// Shared distance core of the port's CUDA kernels (pairdist, pairdist
// filtered, map-assign): the per-element accumulation step and the epilogue
// of each metric, plus the error-string export every library carries.
//
// Counterpart of repro/kernels/pairdist.py::_accumulate/_finalize. All
// arithmetic is IEEE fp32 on the CUDA cores; l2 keeps the expansion form
// |x|^2 + |y|^2 - 2 x.y of the reference so the fp guard band of
// ref.prune_delta (derived for fp32 eps) stays valid.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Metric ids shared with the Python wrappers (kernels/_build.py METRIC_IDS).
enum Metric : int { kL1 = 0, kL2 = 1, kLinf = 2, kCosine = 3, kDot = 4 };

// One feature's contribution to a pair accumulator. l2 accumulates only the
// cross term x.y here; the row norms are accumulated separately.
template <int METRIC>
__device__ __forceinline__ float dist_step(float acc, float x, float y) {
  if (METRIC == kL1) return acc + fabsf(x - y);
  if (METRIC == kLinf) return fmaxf(acc, fabsf(x - y));
  return fmaf(x, y, acc);  // l2 cross term, cosine (pre-normalised), dot
}

// The epilogue: accumulator (+ norms for l2) -> distance.
template <int METRIC>
__device__ __forceinline__ float dist_finalize(float acc, float xn, float yn) {
  if (METRIC == kL2) return sqrtf(fmaxf((xn + yn) - 2.0f * acc, 0.0f));
  if (METRIC == kCosine) return 1.0f - acc;
  return acc;
}

}  // namespace repro_torch

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

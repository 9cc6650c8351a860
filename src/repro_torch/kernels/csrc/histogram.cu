// Weighted per-dimension histogram for Hopper (sm_90a): the GoF cell counts
// of the distributed stats stage.
//
// Replaces repro/kernels/histogram.py::histogram_blocked. For u (n, m) and
// a weight per row w (n,), it computes the (m, t) counts
//   out[d, c] = sum over rows r with cell(u[r, d]) == c of w[r]
//   cell(v)   = clip(trunc(v * t), 0, t - 1)   (the product in fp32)
// The clip is taken on the fp32 product before the conversion, which gives
// the reference's cell for every input: below 0 and -inf -> 0, at or above
// t and +inf -> t - 1, and NaN -> 0 (fmaxf returns its non-NaN operand).
//
// Design. The Pallas kernel keeps an (8, t) output tile in VMEM and walks
// the rows as a sequential grid axis; on the card the CTAs run at once, so
// each CTA owns a block of kDims (= 32) dimensions and a strided range of
// rows, and accumulates a private (kDims x t) histogram in shared memory
// with shared atomicAdd. Lane l of every warp reads dimension dim0 + l, so a
// warp reads 128 contiguous bytes of a row (coalesced along m) and its 32
// updates fall on 32 different histogram rows; the histogram row stride is
// t rounded up to an odd number, so the lanes of a warp spread over the
// banks. The row's weight is one broadcast load per warp; a row of weight 0
// adds nothing and is skipped. At the end each CTA adds its non-zero cells
// into the (m, t) output with one global atomicAdd per cell (the wrapper
// zeroes the output). The grid has enough row ranges to fill the 132 SMs.
// Counts stay exact while every cell holds at most 2^24 (f32 integers), so
// the order of the atomics does not change the result.
//
// Bound. It reads n*m*4 + n*4 bytes and writes m*t*4; it does a few
// operations per element, so bytes bound it: ~0.15 ms at 1,000,000 x 128
// and 3.35 TB/s.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kDims = 32;        // dimensions per CTA: one per lane
constexpr int kHThreads = 256;   // 8 warps; warp w takes rows w, w + 8, ...
constexpr int kWarps = kHThreads / 32;
constexpr int kMaxSmemFloats = 12288;  // 48 KB of static-size dynamic smem

__global__ void __launch_bounds__(kHThreads)
histogram_kernel(const float* __restrict__ u, const float* __restrict__ w,
                 float* __restrict__ out, int n, int m, int t, int stride) {
  extern __shared__ float hist[];  // kDims x stride, stride >= t (odd)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dim0 = blockIdx.x * kDims;
  const int d = dim0 + lane;
  for (int e = tid; e < kDims * stride; e += kHThreads) hist[e] = 0.0f;
  __syncthreads();

  const float tf = static_cast<float>(t);
  const float top = static_cast<float>(t - 1);
  float* my_row = hist + lane * stride;
  for (long long r = static_cast<long long>(blockIdx.y) * kWarps + warp; r < n;
       r += static_cast<long long>(gridDim.y) * kWarps) {
    const float wr = w[r];
    if (wr == 0.0f || d >= m) continue;
    float v = __fmul_rn(u[r * m + d], tf);  // the fp32 product, never contracted
    v = fminf(fmaxf(v, 0.0f), top);
    atomicAdd(my_row + static_cast<int>(v), wr);
  }
  __syncthreads();

  for (int e = tid; e < kDims * t; e += kHThreads) {
    const int dd = e / t;
    const int c = e % t;
    const float h = hist[dd * stride + c];
    if (dim0 + dd < m && h != 0.0f) atomicAdd(out + static_cast<size_t>(dim0 + dd) * t + c, h);
  }
}

}  // namespace repro_torch

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// u (n, m) f32 row-major, w (n,) f32, out (m, t) f32 zeroed by the caller.
extern "C" int histogram_launch(const float* u, const float* w, float* out, int n,
                                int m, int t, int n_sms, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || m <= 0) return 0;
  const int stride = t | 1;
  if (t < 1 || kDims * stride > kMaxSmemFloats) return static_cast<int>(cudaErrorInvalidValue);
  const int m_blocks = (m + kDims - 1) / kDims;
  // About 8 CTAs per SM in all, never more row ranges than row groups.
  const long long row_groups = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  long long rb = (8LL * n_sms + m_blocks - 1) / m_blocks;
  if (rb > row_groups) rb = row_groups;
  if (rb > 65535) rb = 65535;
  if (rb < 1) rb = 1;
  const dim3 grid(m_blocks, static_cast<unsigned>(rb));
  const size_t smem = sizeof(float) * kDims * stride;
  histogram_kernel<<<grid, kHThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, w, out, n, m, t, stride);
  return static_cast<int>(cudaGetLastError());
}

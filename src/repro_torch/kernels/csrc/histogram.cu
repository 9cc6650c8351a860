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
// Bound. It reads n*m*4 + n*4 bytes and writes m*t*4; it does a few
// operations per element, so bytes bound it: ~0.15 ms at 1,000,000 x 128
// and 3.35 TB/s.
//
// Design. A thread owns 4 consecutive dimensions (one float4 load per row
// where m % 4 == 0 and the base is 16-byte aligned, else 4 scalar loads); a
// CTA of 256 threads owns qb such quads (a block of 4 qb dimensions) and
// 256 / qb row slots, and walks a strided range of rows, 4 rows in flight
// per thread. The wrapper's launch plan (kernels/histogram.py::
// launch_plan) picks one of three ways to count:
//  - registers (t <= 16, the stats stage's t = 8 among them): each thread
//    keeps 4 x T counters (T = 8 or 16) and adds each row's weight by
//    compare-and-select, no atomics; at the end the row slots are summed
//    through shared memory and each CTA issues one global atomicAdd per
//    non-zero cell;
//  - shared histograms (larger t): per-warp copies of the block's
//    (4 qb x t) histogram in dynamic shared memory where they fit (fewer
//    copies, or a narrower block, where they do not), updated with shared
//    atomics; row stride t | 1 (odd) so the lanes of a warp spread over the
//    banks; summed over the copies into one global atomic per non-zero cell;
//  - global atomics, where not even one quad's histogram fits.
// Counts stay exact while every cell holds at most 2^24 of integer weight
// (f32 integers), so no order of the sums or the atomics changes them.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kHThreads = 256;
constexpr int kHWarps = kHThreads / 32;
constexpr int kHUnroll = 4;  // rows in flight per thread

enum HistMode : int { kRegisters = 0, kShared = 1, kGlobal = 2 };

__device__ __forceinline__ int hist_cell(float v, float tf, float top) {
  v = __fmul_rn(v, tf);  // the fp32 product, never contracted
  return static_cast<int>(fminf(fmaxf(v, 0.0f), top));
}

// Row r's 4 values of the thread's quad (dims d0..d0+3); out-of-range
// dimensions read 0 and are never counted.
template <bool VEC>
__device__ __forceinline__ float4 hist_load(const float* __restrict__ u, long long r, int m,
                                            int d0) {
  const float* row = u + r * m + d0;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (d0 < m) v.x = __ldg(row);
  if (d0 + 1 < m) v.y = __ldg(row + 1);
  if (d0 + 2 < m) v.z = __ldg(row + 2);
  if (d0 + 3 < m) v.w = __ldg(row + 3);
  return v;
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The CTA's place: its quad of dimensions, its row slot and its rows.
struct HistPos {
  int q, sub, subs, dims, dim0, d0;
  long long r0, step;
};

__device__ __forceinline__ HistPos hist_pos(int qb) {
  HistPos p;
  p.q = threadIdx.x % qb;
  p.sub = threadIdx.x / qb;
  p.subs = kHThreads / qb;
  p.dims = 4 * qb;
  p.dim0 = blockIdx.x * p.dims;
  p.d0 = p.dim0 + 4 * p.q;
  p.step = static_cast<long long>(gridDim.y) * p.subs;
  p.r0 = static_cast<long long>(blockIdx.y) * p.subs + p.sub;
  return p;
}

// kHUnroll rows' weights and values of the thread's quad, rows r, r +
// step, ...; rows past n read weight 0.
template <bool VEC>
__device__ __forceinline__ void hist_fetch(const float* __restrict__ u,
                                           const float* __restrict__ w, int n, int m,
                                           const HistPos& p, long long r, float4 (&v)[kHUnroll],
                                           float (&wr)[kHUnroll]) {
#pragma unroll
  for (int k = 0; k < kHUnroll; ++k) {
    const long long rk = r + k * p.step;
    wr[k] = rk < n ? __ldg(w + rk) : 0.0f;
    v[k] = rk < n ? hist_load<VEC>(u, rk, m, p.d0) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// t <= TMAX: register counters, summed over the row slots in shared memory
// (red[sub][dim][c]), one global atomicAdd per non-zero cell per CTA.
template <int TMAX, bool VEC>
__global__ void __launch_bounds__(kHThreads)
histogram_reg_kernel(const float* __restrict__ u, const float* __restrict__ w,
                     float* __restrict__ out, int n, int m, int t, int qb) {
  extern __shared__ float red[];
  const HistPos p = hist_pos(qb);
  const float tf = static_cast<float>(t);
  const float top = static_cast<float>(t - 1);
  float cnt[4][TMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TMAX; ++c) cnt[i][c] = 0.0f;
  if (p.d0 < m) {
    for (long long r = p.r0; r < n; r += kHUnroll * p.step) {
      float4 v[kHUnroll];
      float wr[kHUnroll];
      hist_fetch<VEC>(u, w, n, m, p, r, v, wr);
#pragma unroll
      for (int k = 0; k < kHUnroll; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cell = hist_cell(f4(v[k], i), tf, top);
#pragma unroll
          for (int c = 0; c < TMAX; ++c) cnt[i][c] += cell == c ? wr[k] : 0.0f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TMAX; ++c) red[(p.sub * p.dims + 4 * p.q + i) * TMAX + c] = cnt[i][c];
  __syncthreads();
  for (int e = threadIdx.x; e < p.dims * t; e += kHThreads) {
    const int dl = e / t;
    const int c = e % t;
    float s = 0.0f;
    for (int k = 0; k < p.subs; ++k) s += red[(k * p.dims + dl) * TMAX + c];
    if (p.dim0 + dl < m && s != 0.0f) atomicAdd(out + static_cast<size_t>(p.dim0 + dl) * t + c, s);
  }
}

// Larger t: shared atomics into the warp's copy of the block's histogram
// (row stride `stride`, odd), summed over the copies into one global atomic
// per non-zero cell; or (kGlobal) atomics straight into the output.
template <bool VEC>
__global__ void __launch_bounds__(kHThreads)
histogram_atomic_kernel(const float* __restrict__ u, const float* __restrict__ w,
                        float* __restrict__ out, int n, int m, int t, int qb, int mode,
                        int copies, int stride) {
  extern __shared__ float hsm[];
  const HistPos p = hist_pos(qb);
  const float tf = static_cast<float>(t);
  const float top = static_cast<float>(t - 1);
  float* hist = hsm + (threadIdx.x / 32 % copies) * p.dims * stride;
  if (mode == kShared) {
    for (int e = threadIdx.x; e < copies * p.dims * stride; e += kHThreads) hsm[e] = 0.0f;
    __syncthreads();
  }
  if (p.d0 < m) {
    for (long long r = p.r0; r < n; r += kHUnroll * p.step) {
      float4 v[kHUnroll];
      float wr[kHUnroll];
      hist_fetch<VEC>(u, w, n, m, p, r, v, wr);
#pragma unroll
      for (int k = 0; k < kHUnroll; ++k) {
        if (wr[k] == 0.0f) continue;  // adds nothing (and covers rows past n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (p.d0 + i >= m) continue;
          const int cell = hist_cell(f4(v[k], i), tf, top);
          if (mode == kShared) atomicAdd(hist + (4 * p.q + i) * stride + cell, wr[k]);
          else atomicAdd(out + static_cast<size_t>(p.d0 + i) * t + cell, wr[k]);
        }
      }
    }
  }
  if (mode != kShared) return;
  __syncthreads();
  for (int e = threadIdx.x; e < p.dims * t; e += kHThreads) {
    const int dl = e / t;
    const int c = e % t;
    float s = 0.0f;
    for (int k = 0; k < copies; ++k) s += hsm[(k * p.dims + dl) * stride + c];
    if (p.dim0 + dl < m && s != 0.0f) atomicAdd(out + static_cast<size_t>(p.dim0 + dl) * t + c, s);
  }
}

// Once per kernel: let it take up to the card's opt-in shared memory and
// prefer the shared-memory carveout, so as many CTAs fit an SM as the plan's
// bytes allow. Returns a CUDA error code (0 on success).
template <auto K>
int hist_ready(int optin) {
  static int ready = -1;
  if (ready < 0) {
    cudaError_t e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(K, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    ready = static_cast<int>(e);
  }
  return ready;
}

template <int TMAX, bool VEC>
int hist_reg_launch(const float* u, const float* w, float* out, int n, int m, int t, int qb,
                    dim3 grid, size_t smem, int optin, cudaStream_t s) {
  if (const int e = hist_ready<histogram_reg_kernel<TMAX, VEC>>(optin)) return e;
  histogram_reg_kernel<TMAX, VEC><<<grid, kHThreads, smem, s>>>(u, w, out, n, m, t, qb);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int hist_atomic_launch(const float* u, const float* w, float* out, int n, int m, int t, int qb,
                       int mode, int copies, dim3 grid, size_t smem, int optin, cudaStream_t s) {
  if (const int e = hist_ready<histogram_atomic_kernel<VEC>>(optin)) return e;
  histogram_atomic_kernel<VEC><<<grid, kHThreads, smem, s>>>(u, w, out, n, m, t, qb, mode,
                                                             copies, t | 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory a plan takes (kernels/histogram.py::
// smem_bytes computes the same).
extern "C" int histogram_smem_bytes(int t, int qb, int mode, int tmax, int copies) {
  if (mode == repro_torch::kRegisters) return 4 * repro_torch::kHThreads * 4 * tmax;
  if (mode == repro_torch::kShared) return 4 * copies * 4 * qb * (t | 1);
  return 0;
}

// u (n, m) f32 row-major, w (n,) f32, out (m, t) f32 zeroed by the caller.
// The plan (mode, tmax, qb, copies, grid) comes from kernels/histogram.py::
// launch_plan; vec: float4 row loads.
extern "C" int histogram_launch(const float* u, const float* w, float* out, int n, int m,
                                int t, int mode, int tmax, int qb, int copies, int grid_x,
                                int grid_y, int vec, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || m <= 0) return 0;
  const bool qb_ok = qb >= 1 && qb <= 32 && (qb & (qb - 1)) == 0;
  const bool mode_ok = (mode == kRegisters && (tmax == 8 || tmax == 16) && t <= tmax) ||
                       (mode == kShared && copies >= 1 && copies <= kHWarps) || mode == kGlobal;
  const long long quads = (m + 3) / 4;
  if (t < 1 || !qb_ok || !mode_ok || grid_x != (quads + qb - 1) / qb || grid_y < 1 ||
      grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = static_cast<size_t>(histogram_smem_bytes(t, qb, mode, tmax, copies));
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kRegisters) {
    if (tmax == 8)
      return vec ? hist_reg_launch<8, true>(u, w, out, n, m, t, qb, grid, smem, optin, s)
                 : hist_reg_launch<8, false>(u, w, out, n, m, t, qb, grid, smem, optin, s);
    return vec ? hist_reg_launch<16, true>(u, w, out, n, m, t, qb, grid, smem, optin, s)
               : hist_reg_launch<16, false>(u, w, out, n, m, t, qb, grid, smem, optin, s);
  }
  const int cp = mode == kShared ? copies : 1;
  return vec ? hist_atomic_launch<true>(u, w, out, n, m, t, qb, mode, cp, grid, smem, optin, s)
             : hist_atomic_launch<false>(u, w, out, n, m, t, qb, mode, cp, grid, smem, optin, s);
}

// Active CTAs per SM of the register-counter kernel (float4 rows) at t <=
// tmax, or a negative CUDA error.
extern "C" int histogram_occupancy(int tmax) {
  using namespace repro_torch;
  int dev = 0, optin = 0, blocks = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = static_cast<size_t>(histogram_smem_bytes(1, 32, kRegisters, tmax, 1));
  int e = tmax == 8 ? hist_ready<histogram_reg_kernel<8, true>>(optin)
                    : hist_ready<histogram_reg_kernel<16, true>>(optin);
  if (!e)
    e = static_cast<int>(tmax == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                         &blocks, histogram_reg_kernel<8, true>, kHThreads, smem)
                                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                         &blocks, histogram_reg_kernel<16, true>, kHThreads, smem));
  return e ? -e : blocks;
}

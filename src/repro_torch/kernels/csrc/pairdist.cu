// Blocked all-pairs distance, plain and pivot-filtered, for Hopper (sm_90a).
//
// Replaces repro/kernels/pairdist.py::pairdist_blocked (plain: f32
// distances or an int8 D<=delta mask) and ::pairdist_filtered_blocked (the
// L-inf pivot bound max_p|px-py|, a skip of the exact work where no pair
// survives the bound, and the int8 mask (D<=delta) & (bound<=db)).
//
// Design. Both run the verify tile of tilecore.cuh: a 128x128 CTA tile
// (8x8 pairs per thread) or, when that grid would leave SMs without a CTA,
// a 64x64 one (4x4), chosen by the wrapper. The Pallas grid's sequential
// feature axis becomes a loop over 16-feature chunks inside the CTA,
// staged by cp.async and transposed to feature-major in shared memory; the
// (a, b, m) intermediate never exists. The filtered variant first runs the
// bound pass over exactly bp pivot dimensions (bp = n_dims, 8 on the main
// path; the Pallas kernel's 16-wide zero-padded slices are a TPU lane rule
// the card does not have), then votes: a CTA with no in-range survivor
// writes zeros (16-byte stores) and loads no feature; a warp's 32x32
// sub-tile with none skips its arithmetic. A thread owns runs of 4
// consecutive columns, so the mask leaves as char4 stores and the
// distances as float4 stores straight from registers (element stores when
// b % 4 != 0).
//
// Copy route. cp.async (16-byte cg where the wrapper finds m % 4 == 0 and
// 16-byte aligned bases, 4-byte ca otherwise), not TMA: TMA needs the same
// 16-byte strides and alignment, so it could not serve the 4-byte path,
// and it needs a tensor map encoded on the host for every launch, while
// the verify engine launches once per tile from a host loop that is
// already the wall-clock bottleneck. Not measured against TMA.
//
// Bound. l1/linf are two fp32 instructions per pair-feature on the CUDA
// cores (a subtraction, then an add or max with |.|), l2/cosine/dot one
// FMA: at the verify engine's tile (1024 x 4096 x 128) the kernel is bound
// by operations (0.5 G pair-features per ~20 MB moved). The roofline
// counts 67 TFLOP/s; with neither l1 instruction fused, l1 reaches at most
// half of it. Per feature a thread of the large tile issues 4 LDS.128 for
// 128 fp32 instructions (l1); PERF.md has what the card gives.
#include "tilecore.cuh"

namespace repro_torch {

// Zeros over the CTA's in-range part of the mask (a CTA the bound prunes
// entirely): 16-byte stores along each row when b % 16 == 0.
template <class T>
__device__ __forceinline__ void store_zeros(int8_t* __restrict__ out, int a, int b, int r0,
                                            int c0) {
  if (b % 16 == 0 && aligned16(out)) {
    constexpr int kSegs = T::kCols / 16;
    for (int e = threadIdx.x; e < T::kRows * kSegs; e += kThreads) {
      const int r = e / kSegs;
      const int c = 16 * (e % kSegs);
      if (r0 + r < a && c0 + c < b)
        *reinterpret_cast<int4*>(out + static_cast<size_t>(r0 + r) * b + c0 + c) =
            make_int4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < T::kRows * T::kCols; e += kThreads) {
      const int r = e / T::kCols;
      const int c = e % T::kCols;
      if (r0 + r < a && c0 + c < b) out[static_cast<size_t>(r0 + r) * b + c0 + c] = 0;
    }
  }
}

template <int METRIC, bool FILTERED, class T>
__global__ void __launch_bounds__(kThreads, 2)
pairdist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out_f, int8_t* __restrict__ out_m, int a, int b, int m,
                int bp, int has_delta, float delta, float delta_bound, int flags) {
  __shared__ TileSmem<T> s;
  const int r0 = blockIdx.y * T::kRows;
  const int c0 = blockIdx.x * T::kCols;

  uint64_t bits;
  if (FILTERED) {
    bits = tile_bound<T>(px, py, a, b, bp, r0, c0, flags & kVecPivots, delta_bound, s);
    if (!__syncthreads_or(bits != 0)) {
      store_zeros<T>(out_m, a, b, r0, c0);  // every pair fails the bound
      return;
    }
  } else {
    bits = range_bits<T>(a, b, r0, c0);
  }
  float d[T::TM][T::TN];
  tile_exact<METRIC, T>(x, y, a, b, m, r0, c0, flags & kVecRows, sub_live<T>(bits), s, d);

  // Each thread owns runs of 4 consecutive columns: char4 (mask) or float4
  // (distances) per row and run when b % 4 == 0, element stores otherwise.
  const bool wide = b % 4 == 0;
  const int tid = fresh_tid();
  const int i0 = blockIdx.y * T::kRows + thread_row0<T>(tid);
  const int j0 = blockIdx.x * T::kCols + thread_col0<T>(tid);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = i0 + row_off(i);
    if (row >= a) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int col = j0 + col_off(4 * g);
      const size_t o = static_cast<size_t>(row) * b + col;
      if (!FILTERED && !has_delta) {
        if (wide && col < b) {
          *reinterpret_cast<float4*>(out_f + o) =
              make_float4(d[i][4 * g], d[i][4 * g + 1], d[i][4 * g + 2], d[i][4 * g + 3]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (col + jj < b) out_f[o + jj] = d[i][4 * g + jj];
        }
        continue;
      }
      char v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = ((bits >> pair_bit<T>(i, 4 * g + jj) & 1) && d[i][4 * g + jj] <= delta) ? 1 : 0;
      if (wide && col < b) {
        *reinterpret_cast<char4*>(out_m + o) = make_char4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (col + jj < b) out_m[o + jj] = v[jj];
      }
    }
  }
}

template <bool FILTERED, class T>
int launch_tile(const float* x, const float* y, const float* px, const float* py,
                float* out_f, int8_t* out_m, int a, int b, int m, int bp, int metric,
                int has_delta, float delta, float delta_bound, int flags,
                cudaStream_t stream) {
  const dim3 grid = tile_grid<T>(a, b);
  switch (metric) {
#define REPRO_CASE(ID, PRUNABLE)                                                          \
  case ID:                                                                                \
    if constexpr (FILTERED && !PRUNABLE) {                                                \
      return static_cast<int>(cudaErrorInvalidValue); /* no triangle inequality */       \
    } else {                                                                              \
      pairdist_kernel<ID, FILTERED, T><<<grid, kThreads, 0, stream>>>(                    \
          x, y, px, py, out_f, out_m, a, b, m, bp, has_delta, delta, delta_bound, flags); \
    }                                                                                     \
    break;
    REPRO_CASE(kL1, true)
    REPRO_CASE(kL2, true)
    REPRO_CASE(kLinf, true)
    REPRO_CASE(kCosine, false)
    REPRO_CASE(kDot, false)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool FILTERED>
int launch(const float* x, const float* y, const float* px, const float* py, float* out_f,
           int8_t* out_m, int a, int b, int m, int bp, int metric, int has_delta, float delta,
           float delta_bound, int tile, int flags, cudaStream_t stream) {
  if (a <= 0 || b <= 0) return 0;
  if (const int rc = check_stage_flags(flags, x, y, m, px, py, bp)) return rc;
  if (tile == BigTile::kRows)
    return launch_tile<FILTERED, BigTile>(x, y, px, py, out_f, out_m, a, b, m, bp, metric,
                                          has_delta, delta, delta_bound, flags, stream);
  if (tile == SmallTile::kRows)
    return launch_tile<FILTERED, SmallTile>(x, y, px, py, out_f, out_m, a, b, m, bp, metric,
                                            has_delta, delta, delta_bound, flags, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

extern "C" int pairdist_launch(const float* x, const float* y, float* out_f, int8_t* out_m,
                               int a, int b, int m, int metric, int has_delta, float delta,
                               int tile, int flags, void* stream) {
  return repro_torch::launch<false>(x, y, nullptr, nullptr, out_f, out_m, a, b, m, 0, metric,
                                    has_delta, delta, 0.0f, tile, flags,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int pairdist_filtered_launch(const float* x, const float* y, const float* px,
                                        const float* py, int8_t* out_m, int a, int b, int m,
                                        int bp, int metric, float delta, float delta_bound,
                                        int tile, int flags, void* stream) {
  return repro_torch::launch<true>(x, y, px, py, nullptr, out_m, a, b, m, bp, metric, 1, delta,
                                   delta_bound, tile, flags, static_cast<cudaStream_t>(stream));
}

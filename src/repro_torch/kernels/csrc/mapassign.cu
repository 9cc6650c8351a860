// Fused map phase for Hopper (sm_90a): space map + kernel cell + packed
// whole membership in one pass over the rows.
//
// Replaces repro/kernels/mapassign.py::map_assign_blocked. For each row x:
//   xm    = D(x, anchors)                         (skipped when metric < 0:
//                                                   x then IS xm, assign-only)
//   cell  = first p with lo_k[p] <= xm < hi_k[p]  (half-open; 0 when none)
//   bits  = 32 partitions per word of lo_w[p] <= xm <= hi_w[p] (closed)
//
// Design. One CTA of 256 threads per 64-row block. The anchors are few
// (n_dims) and are staged in shared memory chunk by chunk beside the row
// block, so the space map is the pairdist core on a 64 x n_dims tile with
// the feature axis as an in-CTA loop; xm stays in shared memory for the
// containment sweeps and is written out once. The Pallas kernel's
// sequential partition axis (and its cell scratch) becomes a loop inside
// the CTA: one thread per row walks the boxes in order and stops at the
// first match, which is exactly argmax-of-bool (first match wins, no match
// -> 0). Whole membership runs one thread per (row, word) and packs 32
// partitions into a 32-bit word, stored as int32 with the uint32 bit
// pattern (bit 31 included). Boxes are read from global memory: every
// thread of a warp reads the same edge, which the cache broadcasts.
// Partitions arrive padded to a word multiple with lo = +BIG (never match)
// and dimensions padded to nap with (-BIG, +BIG) edges (never veto; the
// padded xm columns are 0).
//
// Bound. The pass reads each row once (n*m*4 bytes) and writes
// n*(na + 1 + words) words; the space map is n*na*m pair-features. At the
// main path's shapes (m=128, na=8) bytes set the bound.
#include "distcore.cuh"

namespace repro_torch {

constexpr int kRows = 64;     // rows per CTA
constexpr int kMaxNa = 64;    // mapped dimensions (padded) per CTA
constexpr int kMChunk = 16;   // feature chunk
constexpr int kMThreads = 256;
constexpr int kPerThread = kRows * kMaxNa / kMThreads;  // (row, anchor) pairs

template <int METRIC>  // METRIC < 0: assign-only
__global__ void __launch_bounds__(kMThreads)
map_assign_kernel(const float* __restrict__ x, const float* __restrict__ anchors,
                  const float* __restrict__ klo, const float* __restrict__ khi,
                  const float* __restrict__ wlo, const float* __restrict__ whi,
                  float* __restrict__ xm_out, int* __restrict__ cells,
                  int* __restrict__ bits, int n, int m, int na, int nap, int pp,
                  int want_cells, int want_member) {
  __shared__ float xm_s[kRows][kMaxNa + 1];
  __shared__ float xs[kMChunk][kRows + 1];
  __shared__ float anc_s[kMChunk][kMaxNa + 1];
  __shared__ float xn_s[kRows];
  __shared__ float an_s[kMaxNa];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;

  if (METRIC < 0) {
    for (int e = tid; e < kRows * nap; e += kMThreads) {
      const int r = e / nap;
      const int d = e % nap;
      xm_s[r][d] = (r0 + r < n && d < na) ? x[static_cast<size_t>(r0 + r) * na + d] : 0.0f;
    }
  } else {
    float acc[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) acc[q] = 0.0f;
    float norm = 0.0f;
    for (int k0 = 0; k0 < m; k0 += kMChunk) {
      for (int e = tid; e < kRows * kMChunk; e += kMThreads) {
        const int r = e / kMChunk;
        const int k = e % kMChunk;
        xs[k][r] = (r0 + r < n && k0 + k < m) ? x[static_cast<size_t>(r0 + r) * m + k0 + k] : 0.0f;
      }
      for (int e = tid; e < na * kMChunk; e += kMThreads) {
        const int d = e / kMChunk;
        const int k = e % kMChunk;
        anc_s[k][d] = k0 + k < m ? anchors[static_cast<size_t>(d) * m + k0 + k] : 0.0f;
      }
      __syncthreads();
      if (METRIC == kL2) {
        if (tid < kRows) {
#pragma unroll
          for (int k = 0; k < kMChunk; ++k) norm = fmaf(xs[k][tid], xs[k][tid], norm);
        } else if (tid < kRows + na) {
          const int d = tid - kRows;
#pragma unroll
          for (int k = 0; k < kMChunk; ++k) norm = fmaf(anc_s[k][d], anc_s[k][d], norm);
        }
      }
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int pair = q * kMThreads + tid;
        const int r = pair % kRows;
        const int d = pair / kRows;
        if (d < na) {
#pragma unroll
          for (int k = 0; k < kMChunk; ++k) acc[q] = dist_step<METRIC>(acc[q], xs[k][r], anc_s[k][d]);
        }
      }
      __syncthreads();
    }
    if (METRIC == kL2) {
      if (tid < kRows) xn_s[tid] = norm;
      else if (tid < kRows + na) an_s[tid - kRows] = norm;
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int pair = q * kMThreads + tid;
      const int r = pair % kRows;
      const int d = pair / kRows;
      if (d < na) {
        const float xn = METRIC == kL2 ? xn_s[r] : 0.0f;
        const float an = METRIC == kL2 ? an_s[d] : 0.0f;
        xm_s[r][d] = dist_finalize<METRIC>(acc[q], xn, an);
      } else if (d < nap) {
        xm_s[r][d] = 0.0f;
      }
    }
    __syncthreads();
    for (int e = tid; e < kRows * na; e += kMThreads) {
      const int r = e / na;
      const int d = e % na;
      if (r0 + r < n) xm_out[static_cast<size_t>(r0 + r) * na + d] = xm_s[r][d];
    }
  }
  __syncthreads();

  if (tid < kRows && r0 + tid < n) {
    int cell = 0;
    if (want_cells) {
      for (int p = 0; p < pp; ++p) {
        bool in = true;
        for (int d = 0; d < nap && in; ++d) {
          const float v = xm_s[tid][d];
          in = v >= klo[p * nap + d] && v < khi[p * nap + d];
        }
        if (in) {
          cell = p;
          break;
        }
      }
    }
    cells[r0 + tid] = cell;
  }

  const int words = pp / 32;
  for (int e = tid; e < kRows * words; e += kMThreads) {
    const int r = e / words;
    const int w = e % words;
    if (r0 + r >= n) continue;
    unsigned int word = 0u;
    if (want_member) {
      for (int j = 0; j < 32; ++j) {
        const int p = w * 32 + j;
        bool in = true;
        for (int d = 0; d < nap && in; ++d) {
          const float v = xm_s[r][d];
          in = v >= wlo[p * nap + d] && v <= whi[p * nap + d];
        }
        word |= static_cast<unsigned int>(in) << j;
      }
    }
    bits[static_cast<size_t>(r0 + r) * words + w] = static_cast<int>(word);
  }
}

}  // namespace repro_torch

extern "C" int map_assign_launch(const float* x, const float* anchors,
                                 const float* klo, const float* khi,
                                 const float* wlo, const float* whi, float* xm,
                                 int* cells, int* bits, int n, int m, int na,
                                 int nap, int pp, int metric, int want_cells,
                                 int want_member, void* stream) {
  using namespace repro_torch;
  if (n <= 0) return 0;
  if (na > kMaxNa || nap > kMaxNa || na > nap || pp % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows);
  const dim3 block(kMThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
#define REPRO_CASE(ID)                                                            \
  case ID:                                                                        \
    map_assign_kernel<ID><<<grid, block, 0, s>>>(x, anchors, klo, khi, wlo, whi, \
                                                 xm, cells, bits, n, m, na, nap, \
                                                 pp, want_cells, want_member);   \
    break;
    REPRO_CASE(-1)
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

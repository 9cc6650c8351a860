// The verify tile shared by the pairdist (plain and filtered) and
// verify-compact kernels: asynchronous staging, the L-inf pivot bound pass
// with its CTA vote and its 32x32 sub-tile votes, and the exact distance
// loop. Every kernel runs this same code, so a pair's distance and bound
// are bit-identical in the mask path and the compact path, whichever CTA
// tile or staging path a launch takes: each pair's sum runs over its
// features one at a time in ascending order, and the bound is a max.
//
// Layout. One CTA of 256 threads (8 warps, 4 x 2) per output tile; a warp
// owns a contiguous (4 TM) x (8 TN) block and its lanes a 4 x 8 grid. A
// thread owns TM rows (groups of 4 consecutive rows, 16 apart) and TN
// columns (groups of 4 consecutive columns, 32 apart). Two tiles:
// Tile<8, 8> (128 x 128, warp block 32 x 64) and Tile<4, 4> (64 x 64, warp
// block 16 x 32); the wrapper takes the large one when its grid still has
// a CTA for every SM. The exact loop reads the chunk feature-major: per
// feature a thread issues TM/4 + TN/4 LDS.128 (a warp's loads cover 4 or 8
// consecutive 16-byte units: no bank conflict) for TM x TN pair steps, and
// holds only those 16 operand registers beside its 64 accumulators.
//
// Staging. A chunk of 16 features (or of 16 pivot dimensions) is copied
// row-major into a staging buffer with cp.async: 16-byte copies
// (cp.async.cg) where the wrapper found the width a multiple of 4 floats
// and the bases 16-byte aligned (kVecRows / kVecPivots), 4-byte copies
// (cp.async.ca) otherwise, zero-filled out of range (src-size 0: nothing
// is read). Each thread then transposes one 4 x 4 block (4 LDS.128, 4
// STS.128) into the feature-major tiles, and the staging buffer takes the
// next chunk's copies while this chunk is computed: two barriers per chunk
// (landed, transposed), one copy in flight.
//
// Bound and skips. The bound pass stages up to 16 pivot dimensions at once
// (all of them at n_dims = 8) and loops over exactly bp. Each thread keeps
// the outcomes bound <= delta_bound (and in range) of its pairs as a 64-bit
// mask, not as floats. A CTA whose mask is empty everywhere skips the
// feature loads (__syncthreads_or); a warp's 32-column sub-tile (32 x 32 or
// 16 x 32 pairs) whose masks are empty skips its exact arithmetic
// (__any_sync) but keeps its share of staging and barriers.
#pragma once

#include "distcore.cuh"

namespace repro_torch {

constexpr int kThreads = 256;  // 8 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // features (or pivot dimensions) per staged chunk
constexpr int kRawPitch = 20;  // staging row pitch in floats (five 16-byte units)

// Stage flags chosen by the wrappers (kernels/pairdist.py::stage_flags).
constexpr int kVecRows = 1;    // feature rows: 16-byte copies
constexpr int kVecPivots = 2;  // pivot rows: 16-byte copies

template <int TM_, int TN_>
struct Tile {
  static constexpr int TM = TM_;  // rows per thread
  static constexpr int TN = TN_;  // columns per thread
  static constexpr int kWarpRows = 4 * TM;
  static constexpr int kWarpCols = 8 * TN;
  static constexpr int kRows = 4 * kWarpRows;
  static constexpr int kCols = 2 * kWarpCols;
  static constexpr int kPitch = kRows + 4;  // feature-major row pitch (x and y)
  static constexpr int kSubs = TN / 4;      // 32-column sub-tiles per warp
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TM * TN <= 64, "pairs fit one 64-bit mask");
  static_assert(kRows == kCols, "x and y share the feature-major pitch");
};
using BigTile = Tile<8, 8>;    // 128 x 128
using SmallTile = Tile<4, 4>;  // 64 x 64

template <class T>
struct __align__(16) TileSmem {
  float raw[T::kRows + T::kCols][kRawPitch];  // one chunk row-major: x rows, then y rows
  float x[kChunk][T::kPitch];                 // the chunk feature-major
  float y[kChunk][T::kPitch];
  float xn[T::kRows];  // l2: row norms of the x tile
  float yn[T::kCols];  // l2: row norms of the y tile
};

// threadIdx.x read anew where indices are needed (staging, range mask,
// epilogues): indices and addresses computed once are then not kept live,
// or spilled, across the exact pass for reuse in it or after it.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The thread's rows are row0 + row_off(i) and its columns col0 + col_off(j),
// inside the CTA tile.
template <class T>
__device__ __forceinline__ int thread_row0(int tid) {
  return (tid / 64) * T::kWarpRows + 4 * ((tid % 32) / 8);
}
template <class T>
__device__ __forceinline__ int thread_col0(int tid) {
  return ((tid / 32) % 2) * T::kWarpCols + 4 * (tid % 8);
}
__host__ __device__ constexpr int row_off(int i) { return i % 4 + 16 * (i / 4); }
__host__ __device__ constexpr int col_off(int j) { return j % 4 + 32 * (j / 4); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds128(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Asynchronously copy rows [r0, r0 + R) x columns [k0, k0 + cols) of a
// row-major (n, width) matrix into dst[R][kRawPitch], zero-filling what
// lies out of range. cols is a multiple of 4, at most 16. W floats per
// copy: W = 4 (16-byte copies: width % 4 == 0 and src 16-byte aligned) or
// W = 1.
template <int R, int W>
__device__ __forceinline__ void stage_copies(const float* __restrict__ src, int r0, int n,
                                             int width, int k0, int cols,
                                             float (*dst)[kRawPitch]) {
  const int per_row = cols / W;
  for (int e = fresh_tid(); e < R * per_row; e += kThreads) {
    const int r = e / per_row;
    const int c = W * (e % per_row);
    const bool in = r0 + r < n && k0 + c < width;
    const float* g = in ? src + static_cast<size_t>(r0 + r) * width + (k0 + c) : src;
    if (W == 4) cp_async16(&dst[r][c], g, in);
    else cp_async4(&dst[r][c], g, in);
  }
}

// Stage columns [k0, k0 + cols) of the CTA's x rows (from r0, of a) and y
// rows (from c0, of b) of two row-major (., width) matrices, one commit.
template <class T>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ x,
                                            const float* __restrict__ y, int a, int b,
                                            int width, int r0, int c0, int k0, int cols,
                                            bool vec, TileSmem<T>& s) {
  if (vec) {
    stage_copies<T::kRows, 4>(x, r0, a, width, k0, cols, s.raw);
    stage_copies<T::kCols, 4>(y, c0, b, width, k0, cols, s.raw + T::kRows);
  } else {
    stage_copies<T::kRows, 1>(x, r0, a, width, k0, cols, s.raw);
    stage_copies<T::kCols, 1>(y, c0, b, width, k0, cols, s.raw + T::kRows);
  }
  cp_async_commit();
}

// The staged chunk (cols columns, a multiple of 4) into the feature-major
// tiles: each thread moves 4 x 4 blocks through its registers.
template <class T>
__device__ __forceinline__ void transpose_chunk(int cols, TileSmem<T>& s) {
  const int groups = cols / 4;
  for (int e = fresh_tid(); e < (T::kRows + T::kCols) / 4 * groups; e += kThreads) {
    const int r = 4 * (e / groups);  // first of 4 staged rows
    const int c = 4 * (e % groups);  // first of 4 columns
    const float4 v0 = lds128(&s.raw[r][c]);
    const float4 v1 = lds128(&s.raw[r + 1][c]);
    const float4 v2 = lds128(&s.raw[r + 2][c]);
    const float4 v3 = lds128(&s.raw[r + 3][c]);
    float* dst = r < T::kRows ? &s.x[c][r] : &s.y[c][r - T::kRows];
    *reinterpret_cast<float4*>(dst) = make_float4(v0.x, v1.x, v2.x, v3.x);
    *reinterpret_cast<float4*>(dst + T::kPitch) = make_float4(v0.y, v1.y, v2.y, v3.y);
    *reinterpret_cast<float4*>(dst + 2 * T::kPitch) = make_float4(v0.z, v1.z, v2.z, v3.z);
    *reinterpret_cast<float4*>(dst + 3 * T::kPitch) = make_float4(v0.w, v1.w, v2.w, v3.w);
  }
}

// A thread's pairs as a 64-bit mask: bit pair_bit<T>(i, j) = j * TM + i, so
// each column's rows are TM consecutive bits and each 32-column sub-tile is
// 4 TM consecutive bits.
template <class T>
__device__ __forceinline__ constexpr int pair_bit(int i, int j) { return j * T::TM + i; }

// The in-range pairs of the thread's micro-tile: what every pair's mask
// starts from when nothing is pruned.
template <class T>
__device__ __forceinline__ uint64_t range_bits(int a, int b, int r0, int c0) {
  const int tid = fresh_tid();
  const int i0 = r0 + thread_row0<T>(tid);
  const int j0 = c0 + thread_col0<T>(tid);
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      if (i0 + row_off(i) < a && j0 + col_off(j) < b) bits |= 1ull << pair_bit<T>(i, j);
  return bits;
}

// The L-inf pivot bound of the thread's micro-tile over exactly bp
// dimensions, as the mask of in-range pairs with max_p |px - py| <=
// delta_bound. A max is exact, so that is the mask of pairs with every
// |px_p - py_p| <= delta_bound: each dimension clears the bits of the pairs
// it rules out, and no bound is held as a float. Every thread of the CTA
// must call it, and a barrier (the caller's vote) must follow before the
// staging buffer is reused.
template <class T>
__device__ __forceinline__ uint64_t tile_bound(const float* __restrict__ px,
                                               const float* __restrict__ py, int a, int b,
                                               int bp, int r0, int c0, bool vec,
                                               float delta_bound, TileSmem<T>& s) {
  const int i0 = thread_row0<T>(threadIdx.x);
  const int j0 = thread_col0<T>(threadIdx.x);
  uint64_t bits = range_bits<T>(a, b, r0, c0);
  for (int p0 = 0; p0 < bp; p0 += kChunk) {
    const int np = min(kChunk, bp - p0);
    stage_chunk<T>(px, py, a, b, bp, r0, c0, p0, (np + 3) & ~3, vec, s);
    cp_async_wait_all();
    __syncthreads();  // the slice is staged; the previous one is read by all
    transpose_chunk<T>((np + 3) & ~3, s);
    __syncthreads();
    for (int p = 0; p < np; ++p) {
      float4 xg[T::TM / 4], yg[T::TN / 4];
#pragma unroll
      for (int g = 0; g < T::TM / 4; ++g) xg[g] = lds128(&s.x[p][i0 + 16 * g]);
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) yg[g] = lds128(&s.y[p][j0 + 32 * g]);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          if (!(fabsf(lane4(xg[i / 4], i % 4) - lane4(yg[j / 4], j % 4)) <= delta_bound))
            bits &= ~(1ull << pair_bit<T>(i, j));
    }
  }
  return bits;
}

// The warp's vote per 32-column sub-tile: bit h set iff some lane has a
// live pair in columns [32 h, 32 h + 32) of the warp's block.
template <class T>
__device__ __forceinline__ unsigned sub_live(uint64_t bits) {
  constexpr uint64_t kSub = (1ull << (4 * T::TM)) - 1;  // one sub-tile's bits
  unsigned live = 0;
#pragma unroll
  for (int h = 0; h < T::kSubs; ++h)
    if (__any_sync(0xffffffffu, (bits >> (4 * T::TM * h) & kSub) != 0)) live |= 1u << h;
  return live;
}

// The exact distances of the thread's micro-tile (pairs of dead sub-tiles
// and out-of-range pairs hold values the caller masks with its bits). Every
// thread of the CTA must call it.
template <int METRIC, class T>
__device__ __forceinline__ void tile_exact(const float* __restrict__ x,
                                           const float* __restrict__ y, int a, int b, int m,
                                           int r0, int c0, bool vec, unsigned live,
                                           TileSmem<T>& s, float (&d)[T::TM][T::TN]) {
  const int tid = threadIdx.x;
  const int i0 = thread_row0<T>(tid);
  const int j0 = thread_col0<T>(tid);
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // l2: norm of x row tid (tid < kRows) or of y row tid - kRows

  const int nch = (m + kChunk - 1) / kChunk;
  if (nch > 0) stage_chunk<T>(x, y, a, b, m, r0, c0, 0, kChunk, vec, s);
  for (int c = 0; c < nch; ++c) {
    const int nk = min(kChunk, m - c * kChunk);  // features in chunk c
    cp_async_wait_all();
    __syncthreads();  // chunk c staged; chunk c - 1 read by all
    transpose_chunk<T>((nk + 3) & ~3, s);
    __syncthreads();  // chunk c feature-major; the staging buffer is free
    if (c + 1 < nch) stage_chunk<T>(x, y, a, b, m, r0, c0, (c + 1) * kChunk, kChunk, vec, s);
    if (METRIC == kL2 && tid < T::kRows + T::kCols) {
      const float* col = tid < T::kRows ? &s.x[0][tid] : &s.y[0][tid - T::kRows];
      for (int k = 0; k < nk; ++k) norm = fmaf(col[k * T::kPitch], col[k * T::kPitch], norm);
    }
    if (!live) continue;
#pragma unroll 1
    for (int k = 0; k < nk; ++k) {
      float4 xg[T::TM / 4];
#pragma unroll
      for (int g = 0; g < T::TM / 4; ++g) xg[g] = lds128(&s.x[k][i0 + 16 * g]);
#pragma unroll
      for (int h = 0; h < T::kSubs; ++h) {
        if (!(live & (1u << h))) continue;
        const float4 yg = lds128(&s.y[k][j0 + 32 * h]);
#pragma unroll
        for (int i = 0; i < T::TM; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][4 * h + jj] =
                dist_step<METRIC>(acc[i][4 * h + jj], lane4(xg[i / 4], i % 4), lane4(yg, jj));
      }
    }
  }
  if (METRIC == kL2) {
    if (tid < T::kRows) s.xn[tid] = norm;
    else if (tid < T::kRows + T::kCols) s.yn[tid - T::kRows] = norm;
    __syncthreads();
  }
  const int tid1 = fresh_tid();
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const float xn = METRIC == kL2 ? s.xn[thread_row0<T>(tid1) + row_off(i)] : 0.0f;
      const float yn = METRIC == kL2 ? s.yn[thread_col0<T>(tid1) + col_off(j)] : 0.0f;
      d[i][j] = dist_finalize<METRIC>(acc[i][j], xn, yn);
    }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Host side: the stage flags must match the pointers and widths they claim,
// or a 16-byte copy would fault; a wrong flag is refused before the launch.
inline int check_stage_flags(int flags, const float* x, const float* y, int m, const float* px,
                             const float* py, int bp) {
  if ((flags & kVecRows) && (m % 4 || !aligned16(x) || !aligned16(y)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if ((flags & kVecPivots) && (bp % 4 || !aligned16(px) || !aligned16(py)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

// The launch grid of tile T over an (a, b) output: CTA columns on x, rows
// on y (gridDim.y <= 65535; the wrapper checks the row count first).
template <class T>
inline dim3 tile_grid(int a, int b) {
  return dim3((b + T::kCols - 1) / T::kCols, (a + T::kRows - 1) / T::kRows);
}

}  // namespace repro_torch

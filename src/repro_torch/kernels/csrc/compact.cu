// Fused verify + on-device pair compaction for Hopper (sm_90a).
//
// Replaces repro/kernels/compact.py::verify_compact_blocked (_compact_kernel):
// the optional L-inf pivot bound with its block skip, the exact distance,
// D <= delta, padding validity (id -1), the min-cell de-dup rule of
// ref.emit_mask, and the compaction of the surviving (v_id, w_id) pairs
// into a (capacity, 2) int32 buffer, with counts = [true hit total,
// candidate count]. What leaves the kernel is O(hits), not the (a, b) mask.
//
// Design. The Pallas kernel runs its grid in order and keeps one cursor in
// VMEM across grid steps; here the CTAs run at once, so the cursor is a
// global counter. Each CTA computes the verify tile of tilecore.cuh (the
// same bound pass over exactly bp dimensions, CTA and 32x32 sub-tile
// votes, cp.async staging and distance loop as the filtered pairdist
// kernel, on the same 128x128 or 64x64 tile the wrapper picks by grid
// size, so distances and bounds are bit-identical to the mask path's),
// then in its epilogue:
//   * every thread evaluates the emission predicate of its 64 (or 16)
//     pairs into a 64-bit mask (validity, D <= delta, bound <= delta_bound,
//     and - unless CROSS - wc > cell_id or (wc == cell_id and vid < wid)),
//     column by column as 8-row masks, and counts its hits (__popcll) and
//     candidates (valid pairs passing the bound);
//   * a warp inclusive scan (__shfl_up_sync) and an exclusive scan of the
//     eight warp totals in shared memory rank every hit inside the CTA;
//   * one atomicAdd per CTA on counts[0] reserves the CTA's slot range
//     (base), a second adds its candidates to counts[1];
//   * each hit (the set bits of the mask, in order) writes (vid, wid) at
//     base + rank while that is below capacity. counts[0] stays the exact
//     total on overflow, so the caller can size its retry in one step.
// A CTA whose tile the bound prunes entirely returns after the vote: no
// hits and, since every pair fails the bound, no candidates; a dead
// sub-tile's pairs fail the bound too, so its skipped arithmetic is never
// read. Emission order depends on the order the CTAs reach the atomic; the
// engine sorts. Copy route: cp.async, not TMA, as in pairdist.cu.
//
// Bound. As the filtered pairdist kernel: operations - two fp32
// instructions per surviving pair-feature (l1/linf) or one FMA (l2, cosine,
// dot) on the CUDA cores, plus the bound pass over the pivot coordinates;
// the pair bytes written are O(hits).
#include "tilecore.cuh"

namespace repro_torch {

template <int METRIC, bool PRUNE, bool CROSS, class T>
__global__ void __launch_bounds__(kThreads, 2)
verify_compact_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ px, const float* __restrict__ py,
                      const int* __restrict__ vids, const int* __restrict__ wids,
                      const int* __restrict__ wcells, int cell_id, int a, int b, int m,
                      int bp, float delta, float delta_bound, int capacity,
                      int* __restrict__ pairs, int* __restrict__ counts, int flags) {
  __shared__ TileSmem<T> s;
  __shared__ int warp_base[kWarps];
  __shared__ int warp_cand[kWarps];
  __shared__ int cta_base;
  const int r0 = blockIdx.y * T::kRows;
  const int c0 = blockIdx.x * T::kCols;

  uint64_t bits;
  if (PRUNE) {
    bits = tile_bound<T>(px, py, a, b, bp, r0, c0, flags & kVecPivots, delta_bound, s);
    if (!__syncthreads_or(bits != 0)) return;
  } else {
    bits = range_bits<T>(a, b, r0, c0);
  }
  float d[T::TM][T::TN];
  tile_exact<METRIC, T>(x, y, a, b, m, r0, c0, flags & kVecRows, sub_live<T>(bits), s, d);

  const int tid = fresh_tid();
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * T::kRows + thread_row0<T>(tid);
  const int j0 = blockIdx.x * T::kCols + thread_col0<T>(tid);
  // Per column j the rows are one byte of the masks (pair_bit): validity,
  // the bound, the min-cell rule and D <= delta combine as row masks.
  constexpr unsigned kRowMask = (1u << T::TM) - 1;
  int vid[T::TM];
  unsigned vrows = 0;  // rows with a real (non-padding) id
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    vid[i] = i0 + row_off(i) < a ? vids[i0 + row_off(i)] : -1;
    if (vid[i] >= 0) vrows |= 1u << i;
  }
  uint64_t keep = 0;
  int n_cand = 0;
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int col = j0 + col_off(j);
    const int wid = col < b ? wids[col] : -1;
    const unsigned valid = wid >= 0 ? vrows : 0u;
    const unsigned pass = static_cast<unsigned>(bits >> pair_bit<T>(0, j)) & kRowMask;
    n_cand += __popc(valid & pass);  // valid pairs in range (and bound <= db)
    unsigned rule = valid;
    if (!CROSS) {
      const int wc = col < b ? wcells[col] : -1;
      if (wc < cell_id) {
        rule = 0;
      } else if (wc == cell_id) {
#pragma unroll
        for (int i = 0; i < T::TM; ++i)
          if (vid[i] >= wid) rule &= ~(1u << i);
      }
    }
    unsigned hit = 0;
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
      if (d[i][j] <= delta) hit |= 1u << i;
    keep |= static_cast<uint64_t>(rule & pass & hit) << pair_bit<T>(0, j);
  }
  const int n_hit = __popcll(keep);

  int incl = n_hit;  // inclusive scan of the hit counts within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int cand = __reduce_add_sync(0xffffffffu, n_cand);
  if (lane == 31) warp_base[warp] = incl;
  if (lane == 0) warp_cand[warp] = cand;
  __syncthreads();
  if (tid == 0) {
    int hits = 0;
    int cands = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = warp_base[w];
      warp_base[w] = hits;  // exclusive prefix of the warp totals
      hits += h;
      cands += warp_cand[w];
    }
    cta_base = hits ? atomicAdd(&counts[0], hits) : 0;
    if (cands) atomicAdd(&counts[1], cands);
  }
  __syncthreads();
  if (!keep) return;
  int slot = cta_base + warp_base[warp] + incl - n_hit;
  for (uint64_t rest = keep; rest && slot < capacity; rest &= rest - 1, ++slot) {
    const int k = __ffsll(static_cast<long long>(rest)) - 1;
    pairs[2 * static_cast<size_t>(slot)] = vids[i0 + row_off(k % T::TM)];
    pairs[2 * static_cast<size_t>(slot) + 1] = wids[j0 + col_off(k / T::TM)];
  }
}

template <bool PRUNE, bool CROSS, class T>
int launch_tile(const float* x, const float* y, const float* px, const float* py,
                const int* vids, const int* wids, const int* wcells, int cell_id, int a, int b,
                int m, int bp, int metric, float delta, float delta_bound, int capacity,
                int* pairs, int* counts, int flags, cudaStream_t stream) {
  const dim3 grid = tile_grid<T>(a, b);
  switch (metric) {
#define REPRO_CASE(ID, PRUNABLE)                                                         \
  case ID:                                                                               \
    if constexpr (PRUNE && !PRUNABLE) {                                                  \
      return static_cast<int>(cudaErrorInvalidValue); /* no triangle inequality */      \
    } else {                                                                             \
      verify_compact_kernel<ID, PRUNE, CROSS, T><<<grid, kThreads, 0, stream>>>(         \
          x, y, px, py, vids, wids, wcells, cell_id, a, b, m, bp, delta, delta_bound,    \
          capacity, pairs, counts, flags);                                               \
    }                                                                                    \
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

template <bool PRUNE, bool CROSS>
int launch(const float* x, const float* y, const float* px, const float* py, const int* vids,
           const int* wids, const int* wcells, int cell_id, int a, int b, int m, int bp,
           int metric, float delta, float delta_bound, int capacity, int* pairs, int* counts,
           int tile, int flags, cudaStream_t stream) {
  if (tile == BigTile::kRows)
    return launch_tile<PRUNE, CROSS, BigTile>(x, y, px, py, vids, wids, wcells, cell_id, a, b,
                                              m, bp, metric, delta, delta_bound, capacity,
                                              pairs, counts, flags, stream);
  if (tile == SmallTile::kRows)
    return launch_tile<PRUNE, CROSS, SmallTile>(x, y, px, py, vids, wids, wcells, cell_id, a,
                                                b, m, bp, metric, delta, delta_bound, capacity,
                                                pairs, counts, flags, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

extern "C" int verify_compact_launch(const float* x, const float* y, const float* px,
                                     const float* py, const int* vids, const int* wids,
                                     const int* wcells, int cell_id, int a, int b, int m,
                                     int bp, int metric, int prune, int cross, float delta,
                                     float delta_bound, int capacity, int tile, int flags,
                                     int* pairs, int* counts, void* stream) {
  using repro_torch::launch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a <= 0 || b <= 0) return 0;
  if (const int rc = repro_torch::check_stage_flags(flags, x, y, m, px, py, bp)) return rc;
  if (prune) {
    if (cross)
      return launch<true, true>(x, y, px, py, vids, wids, wcells, cell_id, a, b, m, bp, metric,
                                delta, delta_bound, capacity, pairs, counts, tile, flags, st);
    return launch<true, false>(x, y, px, py, vids, wids, wcells, cell_id, a, b, m, bp, metric,
                               delta, delta_bound, capacity, pairs, counts, tile, flags, st);
  }
  if (cross)
    return launch<false, true>(x, y, px, py, vids, wids, wcells, cell_id, a, b, m, bp, metric,
                               delta, delta_bound, capacity, pairs, counts, tile, flags, st);
  return launch<false, false>(x, y, px, py, vids, wids, wcells, cell_id, a, b, m, bp, metric,
                              delta, delta_bound, capacity, pairs, counts, tile, flags, st);
}

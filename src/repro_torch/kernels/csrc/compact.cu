// Fused verify + on-device pair compaction for Hopper (sm_90a).
//
// Replaces repro/kernels/compact.py::verify_compact_blocked (_compact_kernel):
// the optional L-inf pivot bound with its whole-block skip, the exact
// distance, D <= delta, padding validity (id -1), the min-cell de-dup rule
// of ref.emit_mask, and the compaction of the surviving (v_id, w_id) pairs
// into a (capacity, 2) int32 buffer, with counts = [true hit total,
// candidate count]. What leaves the kernel is O(hits), not the (a, b) mask.
//
// Design. The Pallas kernel runs its grid in order and keeps one cursor in
// VMEM across grid steps; here the CTAs run at once, so the cursor is a
// global counter. Each CTA computes the 64x64 tile of tilecore.cuh (the
// same bound pass, __syncthreads_or skip and distance loop as the filtered
// pairdist kernel, so distances and bounds are bit-identical to the mask
// path's), then in its epilogue:
//   * every thread evaluates the emission predicate of its 16 pairs into a
//     16-bit mask (validity, D <= delta, bound <= delta_bound, and - unless
//     CROSS - wc > cell_id or (wc == cell_id and vid < wid)) and counts its
//     hits (__popc) and candidates (valid pairs passing the bound);
//   * a warp inclusive scan (__shfl_up_sync) and an exclusive scan of the
//     eight warp totals in shared memory rank every hit inside the CTA;
//   * one atomicAdd per CTA on counts[0] reserves the CTA's slot range
//     (base), a second adds its candidates to counts[1];
//   * each hit writes (vid, wid) at base + rank when that is below
//     capacity. counts[0] stays the exact total on overflow, so the caller
//     can size its retry in one step.
// A CTA whose tile the bound prunes entirely returns after the vote: no
// hits and, since every pair fails the bound, no candidates. Emission order
// depends on the order the CTAs reach the atomic; the engine sorts.
//
// Bound. As the filtered pairdist kernel: operations - two fp32
// instructions per surviving pair-feature (l1/linf) or one FMA (l2, cosine,
// dot) on the CUDA cores, plus the bound pass over the pivot coordinates;
// the pair bytes written are O(hits).
#include "tilecore.cuh"

namespace repro_torch {

constexpr int kWarps = kThreads / 32;

template <int METRIC, bool PRUNE, bool CROSS>
__global__ void __launch_bounds__(kThreads)
verify_compact_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ px, const float* __restrict__ py,
                      const int* __restrict__ vids, const int* __restrict__ wids,
                      const int* __restrict__ wcells, int cell_id, int a, int b,
                      int m, int bp, float delta, float delta_bound, int capacity,
                      int* __restrict__ pairs, int* __restrict__ counts) {
  __shared__ TileSmem s;
  __shared__ int warp_base[kWarps];
  __shared__ int warp_cand[kWarps];
  __shared__ int cta_base;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float bound[4][4];
  if (PRUNE) {
    tile_bound(px, py, a, b, bp, r0, c0, s, bound);
    if (!tile_live(bound, a, b, r0, c0, delta_bound)) return;
  }
  float d[4][4];
  tile_distances<METRIC>(x, y, a, b, m, r0, c0, s, d);

  int vid[4], wid[4], wc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    vid[i] = row < a ? vids[row] : -1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c0 + tx + 16 * j;
    wid[j] = col < b ? wids[col] : -1;
    wc[j] = (!CROSS && col < b) ? wcells[col] : -1;
  }
  unsigned keep = 0;
  int n_cand = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = vid[i] >= 0 && wid[j] >= 0;
      const bool pass = !PRUNE || bound[i][j] <= delta_bound;
      const bool rule = CROSS || wc[j] > cell_id || (wc[j] == cell_id && vid[i] < wid[j]);
      n_cand += (valid && pass) ? 1 : 0;
      if (valid && pass && rule && d[i][j] <= delta) keep |= 1u << (4 * i + j);
    }
  const int n_hit = __popc(keep);

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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (keep & (1u << (4 * i + j))) {
        if (slot < capacity) {
          pairs[2 * static_cast<size_t>(slot)] = vid[i];
          pairs[2 * static_cast<size_t>(slot) + 1] = wid[j];
        }
        ++slot;
      }
    }
}

template <bool PRUNE, bool CROSS>
int launch(const float* x, const float* y, const float* px, const float* py,
           const int* vids, const int* wids, const int* wcells, int cell_id, int a,
           int b, int m, int bp, int metric, float delta, float delta_bound,
           int capacity, int* pairs, int* counts, cudaStream_t stream) {
  if (a <= 0 || b <= 0) return 0;
  const dim3 grid((b + kTile - 1) / kTile, (a + kTile - 1) / kTile);
  const dim3 block(kThreads);
  switch (metric) {
#define REPRO_CASE(ID)                                                          \
  case ID:                                                                      \
    verify_compact_kernel<ID, PRUNE, CROSS><<<grid, block, 0, stream>>>(        \
        x, y, px, py, vids, wids, wcells, cell_id, a, b, m, bp, delta,          \
        delta_bound, capacity, pairs, counts);                                  \
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

extern "C" int verify_compact_launch(const float* x, const float* y, const float* px,
                                     const float* py, const int* vids,
                                     const int* wids, const int* wcells,
                                     int cell_id, int a, int b, int m, int bp,
                                     int metric, int prune, int cross, float delta,
                                     float delta_bound, int capacity, int* pairs,
                                     int* counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prune) {
    if (cross)
      return repro_torch::launch<true, true>(x, y, px, py, vids, wids, wcells, cell_id, a,
                                             b, m, bp, metric, delta, delta_bound,
                                             capacity, pairs, counts, st);
    return repro_torch::launch<true, false>(x, y, px, py, vids, wids, wcells, cell_id, a,
                                            b, m, bp, metric, delta, delta_bound,
                                            capacity, pairs, counts, st);
  }
  if (cross)
    return repro_torch::launch<false, true>(x, y, px, py, vids, wids, wcells, cell_id, a,
                                            b, m, bp, metric, delta, delta_bound,
                                            capacity, pairs, counts, st);
  return repro_torch::launch<false, false>(x, y, px, py, vids, wids, wcells, cell_id, a,
                                           b, m, bp, metric, delta, delta_bound,
                                           capacity, pairs, counts, st);
}

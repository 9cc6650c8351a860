// Fused map phase for Hopper (sm_90a): space map + kernel cell + packed
// whole membership in one pass over the rows.
//
// Replaces repro/kernels/mapassign.py::map_assign_blocked. For each row x:
//   xm    = D(x, anchors)                         (skipped when metric < 0:
//                                                   x then IS xm, assign-only)
//   cell  = first p with lo_k[p] <= xm < hi_k[p]  (half-open; 0 when none)
//   bits  = 32 partitions per word of lo_w[p] <= xm <= hi_w[p] (closed),
//           stored as int32 with the uint32 bit pattern (bit 31 included)
// An output the caller does not want is zero-filled. Partitions arrive
// padded to a word multiple with lo = +BIG (never match) and dimensions
// padded to nap (a multiple of 8) with (-BIG, +BIG) edges (never veto).
//
// Bound. Bytes: the pass reads each row once (n*m*4) and writes
// n*(na + 1 + words) words; the space map is n*na*m pair-features, ~16
// operations per byte at m = 128 and na = 8, below the card's balance.
//
// Design. A CTA of 256 threads owns `rows` rows (the metric modes: 256,
// 128, 64 or 32; the assign-only mode also 512: the wrapper's
// launch plan, kernels/mapassign.py::launch_plan, takes the largest whose
// grid still has a CTA for every SM). Everything it needs lives in dynamic
// shared memory (ma_layout below; up to the card's opt-in, shared-memory
// carveout preferred):
//  - Space map. Threads split as rows x g (g = 256 / rows); a thread owns
//    one row and A consecutive anchors of a block of db = g * A anchors,
//    with A (1..32) a template parameter picked for the real n_dims, so no
//    accumulator is dead; more anchors run as further blocks over the same
//    rows. The rows and the block's anchors stream through a 3-stage
//    cp.async ring of 16-feature chunks (16-byte copies where the wrapper
//    found width % 4 == 0 and a 16-byte aligned base, else 4-byte copies;
//    anchors land feature-major), so two chunks are in flight while one is
//    computed, one barrier per chunk. A thread reads its row as LDS.128 (row
//    pitch 20 floats: no bank conflict) and its anchors as LDS.128
//    broadcasts. Each pair's sum runs over its features one at a time in
//    ascending order (l2: norms by fmaf in the same order), so xm is the
//    same bits under every plan. At most 128 registers: two CTAs per SM.
//  - Containment. A thread per row (ma_sweep) holds 8 of its coordinates
//    at a time and walks only the live partitions (never the padding), the
//    box edges staged once per (word block, dim block) in shared memory,
//    partition-major, and read as LDS.128 broadcasts; it builds each
//    32-partition word in a register. The kernel cell is the first set bit
//    of the first non-zero kernel-box word, w*32 + __ffs(b) - 1, which is
//    exactly the reference's argmax-of-bool. The assign-only mode is
//    compiled per `want` and takes up to 512 rows per CTA, 2 per thread,
//    so each edge load from shared memory serves 2 rows; its rows arrive
//    by cp.async (16-byte copies where n_dims % 4 == 0). Where every dim
//    and word fits one block (the main path), it runs persistent
//    (map_assign_stream_kernel): edges staged once per CTA, the next
//    tile's rows in flight while one is swept.
//  - No capacity limit. Membership words beyond what fits run as word
//    blocks and dimensions beyond a block as dim blocks: the per-(row,
//    word) answers are ANDed in shared memory across dim blocks, and xm is
//    re-read from global memory (L2) when it cannot stay resident. A
//    launch whose plan does not fit the card's shared memory is refused.
#include "tilecore.cuh"

namespace repro_torch {

constexpr int kMaChunk = 16;               // features per staged chunk
constexpr int kMaStages = 3;               // cp.async ring depth
constexpr int kMaXPitch = kMaChunk + 4;    // staged row pitch (floats)
constexpr int kAssignOnly = -1;            // KIND of the assign-only mode

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Float offsets of the dynamic shared memory regions (every region starts
// 16-byte aligned). kernels/mapassign.py::smem_bytes mirrors it.
struct MaLayout {
  int ring, slot, apitch, an, xm, xpitch, edges, state, cell, total;
};

__host__ __device__ inline MaLayout ma_layout(int rows, int db, int pw, bool metric) {
  MaLayout L;
  L.apitch = db + 4;  // feature-major anchor pitch
  L.xpitch = db + 4;  // xm row pitch
  L.slot = metric ? rows * kMaXPitch + kMaChunk * L.apitch : 0;
  int off = 0;
  L.ring = off;
  off += kMaStages * L.slot;
  L.an = off;
  off += metric ? round4(db) : 0;
  L.xm = off;
  off += rows * L.xpitch;
  L.edges = off;
  off += 4 * db * 32 * pw;
  L.state = off;
  off += 2 * rows * pw;
  L.cell = off;
  off += round4(rows);
  L.total = off;
  return L;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

struct MaArgs {
  const float* x;
  const float* anchors;
  const float* edge[4];  // klo, khi, wlo, whi: (pp, nap)
  float* xm;
  int* cells;
  int* bits;
  int n, m, na, nap, pp, metric;
  int rows, db, pw, p, want_cells, want_member, vec;  // p: live partitions
};

// One chunk of rows and of the block's anchors into ring slot c % stages.
__device__ __forceinline__ void ma_issue(const MaArgs& a, const MaLayout& L, float* smem,
                                         int r0, int d0, int c) {
  float* xs = smem + L.ring + (c % kMaStages) * L.slot;
  float* as = xs + a.rows * kMaXPitch;
  const int k0 = c * kMaChunk;
  const int tid = threadIdx.x;
  if (a.vec) {
    for (int e = tid; e < a.rows * (kMaChunk / 4); e += kThreads) {
      const int r = e / (kMaChunk / 4);
      const int k = k0 + 4 * (e % (kMaChunk / 4));
      const bool in = r0 + r < a.n && k < a.m;
      const float* g = in ? a.x + static_cast<size_t>(r0 + r) * a.m + k : a.x;
      cp_async16(xs + r * kMaXPitch + (k - k0), g, in);
    }
  } else {
    for (int e = tid; e < a.rows * kMaChunk; e += kThreads) {
      const int r = e / kMaChunk;
      const int k = k0 + e % kMaChunk;
      const bool in = r0 + r < a.n && k < a.m;
      const float* g = in ? a.x + static_cast<size_t>(r0 + r) * a.m + k : a.x;
      cp_async4(xs + r * kMaXPitch + (k - k0), g, in);
    }
  }
  for (int e = tid; e < a.db * kMaChunk; e += kThreads) {
    const int d = e / kMaChunk;
    const int k = k0 + e % kMaChunk;
    const bool in = d0 + d < a.na && k < a.m;
    const float* g = in ? a.anchors + static_cast<size_t>(d0 + d) * a.m + k : a.anchors;
    cp_async4(as + (k - k0) * L.apitch + d, g, in);
  }
  cp_async_commit();
}

// xm of the CTA's rows for anchors [d0, d0 + db) into xm_s, then out to
// global memory. Zero-filled chunks add nothing: |0 - 0| = 0, fmaf(0, 0, s)
// = s, max(s, 0) = s for s >= 0.
template <int KIND, int A>
__device__ __forceinline__ void ma_space_map(const MaArgs& a, const MaLayout& L, float* smem,
                                             int r0, int d0) {
  const int g = kThreads / a.rows;
  const int tid = threadIdx.x;
  const int rl = tid / g;
  const int gi = tid % g;
  float* an_s = smem + L.an;
  if (KIND == kDot && a.metric == kL2 && tid < a.db) {
    float s = 0.0f;
    if (d0 + tid < a.na) {
      const float* row = a.anchors + static_cast<size_t>(d0 + tid) * a.m;
      for (int k = 0; k < a.m; ++k) s = fmaf(row[k], row[k], s);
    }
    an_s[tid] = s;
  }
  float acc[A];
#pragma unroll
  for (int q = 0; q < A; ++q) acc[q] = 0.0f;
  float norm = 0.0f;
  const int nc = (a.m + kMaChunk - 1) / kMaChunk;
#pragma unroll
  for (int s = 0; s < kMaStages - 1; ++s) {
    if (s < nc) ma_issue(a, L, smem, r0, d0, s);
    else cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kMaStages - 2>();
    __syncthreads();  // chunk c landed everywhere; chunk c - 1's slot is free
    if (c + kMaStages - 1 < nc) ma_issue(a, L, smem, r0, d0, c + kMaStages - 1);
    else cp_async_commit();
    const float* xs = smem + L.ring + (c % kMaStages) * L.slot;
    const float* xr = xs + rl * kMaXPitch;
    const float* as = xs + a.rows * kMaXPitch + gi * A;
#pragma unroll
    for (int k4 = 0; k4 < kMaChunk; k4 += 4) {
      const float4 xv = lds128(xr + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float v = lane4(xv, kk);
        const float* ak = as + (k4 + kk) * L.apitch;
        if (KIND == kDot) norm = fmaf(v, v, norm);
        if constexpr (A % 4 == 0) {
#pragma unroll
          for (int q = 0; q < A; q += 4) {
            const float4 av = lds128(ak + q);
            acc[q] = dist_step<KIND>(acc[q], v, av.x);
            acc[q + 1] = dist_step<KIND>(acc[q + 1], v, av.y);
            acc[q + 2] = dist_step<KIND>(acc[q + 2], v, av.z);
            acc[q + 3] = dist_step<KIND>(acc[q + 3], v, av.w);
          }
        } else {
#pragma unroll
          for (int q = 0; q < A; ++q) acc[q] = dist_step<KIND>(acc[q], v, ak[q]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // an_s written; every thread done with the ring
  float* xm_s = smem + L.xm;
#pragma unroll
  for (int q = 0; q < A; ++q) {
    const int dd = gi * A + q;
    float v = 0.0f;
    if (d0 + dd < a.na) {
      if (KIND != kDot) v = acc[q];
      else if (a.metric == kL2) v = dist_finalize<kL2>(acc[q], norm, an_s[dd]);
      else if (a.metric == kCosine) v = dist_finalize<kCosine>(acc[q], 0.0f, 0.0f);
      else v = acc[q];
    }
    xm_s[rl * L.xpitch + dd] = v;
  }
  __syncthreads();
  for (int e = tid; e < a.rows * a.db; e += kThreads) {
    const int r = e / a.db;
    const int d = e % a.db;
    if (r0 + r < a.n && d0 + d < a.na)
      a.xm[static_cast<size_t>(r0 + r) * a.na + d0 + d] = xm_s[r * L.xpitch + d];
  }
}

// xm of the CTA's rows, dims [d0, d0 + db), from global memory into xm_s,
// zero past n and na. The assign-only input rows go through cp.async (16-
// byte copies where vec: na % 4 == 0 and a 16-byte aligned base), so all of
// a CTA's loads are in flight at once; the xm this CTA wrote earlier in the
// launch is read back through L2 (ld.global.cg) after a barrier.
__device__ __forceinline__ void ma_load_xm(const MaArgs& a, const MaLayout& L, float* smem,
                                           bool written, int r0, int d0) {
  float* xm_s = smem + L.xm;
  if (written) {
    for (int e = threadIdx.x; e < a.rows * a.db; e += kThreads) {
      const int r = e / a.db;
      const int d = e % a.db;
      float v = 0.0f;
      if (r0 + r < a.n && d0 + d < a.na) v = __ldcg(a.xm + static_cast<size_t>(r0 + r) * a.na + d0 + d);
      xm_s[r * L.xpitch + d] = v;
    }
    return;
  }
  const int w = a.vec ? 4 : 1;
  const int per_row = a.db / w;
  for (int e = threadIdx.x; e < a.rows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int d = w * (e % per_row);
    const bool in = r0 + r < a.n && d0 + d < a.na;
    const float* g = in ? a.x + static_cast<size_t>(r0 + r) * a.na + d0 + d : a.x;
    if (a.vec) cp_async16(xm_s + r * L.xpitch + d, g, in);
    else cp_async4(xm_s + r * L.xpitch + d, g, in);
  }
}

// The edges of partitions [p0, p0 + 32 pw_live) x dims [d0, d0 + db) into
// shared memory, partition-major: e_s[k][pl][d], k = klo, khi, wlo, whi,
// through cp.async (the caller commits and waits). Dimensions past nap get
// (-inf, +inf): they never veto.
__device__ __forceinline__ void ma_stage_edges(const MaArgs& a, const MaLayout& L, float* smem,
                                               int p0, int pw_live, int d0, bool cells,
                                               bool member) {
  float* e_s = smem + L.edges;
  const int plane = 32 * a.pw * a.db;
  for (int e = threadIdx.x; e < 32 * pw_live * a.db; e += kThreads) {
    const int pl = e / a.db;
    const int d = e % a.db;
    const bool live = d0 + d < a.nap;
    const size_t gi = static_cast<size_t>(p0 + pl) * a.nap + d0 + d;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < 2 ? !cells : !member) continue;
      float* dst = e_s + k * plane + e;
      if (live) cp_async4(dst, a.edge[k] + gi, true);
      else *dst = k % 2 ? pos_inf() : neg_inf();
    }
  }
}

// Rows against the staged partitions, a thread per row: it holds 8 of the
// coordinates of RT rows at a time (RT = rows per thread: 2 when a CTA has
// 512 rows) and walks the word's live partitions (never the padding), each
// box's edges read once as LDS.128 broadcasts for all RT rows, clearing the
// bit of each box a row is not in. Below 256 rows per CTA, g = 256 / rows
// consecutive lanes share a row, each taking every g-th partition, and AND
// their words by shuffles. The per-(row, word) answers are ANDed into the
// shared state (st_k kernel boxes, st_w whole boxes) across dim blocks.
template <bool CLOSED>
__device__ __forceinline__ bool in_box(const float4& v0, const float4& v1, const float4& l0,
                                       const float4& l1, const float4& h0, const float4& h1) {
  const bool lo = (v0.x >= l0.x) & (v0.y >= l0.y) & (v0.z >= l0.z) & (v0.w >= l0.w) &
                  (v1.x >= l1.x) & (v1.y >= l1.y) & (v1.z >= l1.z) & (v1.w >= l1.w);
  const bool hi = CLOSED ? (v0.x <= h0.x) & (v0.y <= h0.y) & (v0.z <= h0.z) & (v0.w <= h0.w) &
                               (v1.x <= h1.x) & (v1.y <= h1.y) & (v1.z <= h1.z) & (v1.w <= h1.w)
                         : (v0.x < h0.x) & (v0.y < h0.y) & (v0.z < h0.z) & (v0.w < h0.w) &
                               (v1.x < h1.x) & (v1.y < h1.y) & (v1.z < h1.z) & (v1.w < h1.w);
  return lo & hi;
}

// Word w's answers for RT rows (row i's coordinates at xr[i], db of them)
// against the staged boxes, partitions j = gi, gi + g, ... < live: bit j
// of kb[i] (kernel box) / wb[i] (whole box) is cleared where row i is out.
template <bool CELLS, bool MEMBER, int RT>
__device__ __forceinline__ void ma_word(const float* const (&xr)[RT], const float* e_s, int db,
                                        int plane, int w, int gi, int g, int live,
                                        unsigned (&kb)[RT], unsigned (&wb)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) kb[i] = wb[i] = 0xffffffffu;
  for (int d8 = 0; d8 < db; d8 += 8) {
    float4 v0[RT], v1[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      v0[i] = lds128(xr[i] + d8);
      v1[i] = lds128(xr[i] + d8 + 4);
    }
    for (int j = gi; j < live; j += g) {
      const float* e = e_s + (w * 32 + j) * db + d8;
      if (CELLS) {
        const float4 l0 = lds128(e), l1 = lds128(e + 4);
        const float4 h0 = lds128(e + plane), h1 = lds128(e + plane + 4);
#pragma unroll
        for (int i = 0; i < RT; ++i)  // branch-free: clear bit j where out
          kb[i] &= ~(static_cast<unsigned>(!in_box<false>(v0[i], v1[i], l0, l1, h0, h1)) << j);
      }
      if (MEMBER) {
        const float4 l0 = lds128(e + 2 * plane), l1 = lds128(e + 2 * plane + 4);
        const float4 h0 = lds128(e + 3 * plane), h1 = lds128(e + 3 * plane + 4);
#pragma unroll
        for (int i = 0; i < RT; ++i)
          wb[i] &= ~(static_cast<unsigned>(!in_box<true>(v0[i], v1[i], l0, l1, h0, h1)) << j);
      }
    }
  }
}

__device__ __forceinline__ unsigned live_mask(int live) {  // padding partitions: never in
  return live >= 32 ? 0xffffffffu : (1u << live) - 1u;
}

template <bool CELLS, bool MEMBER, int RT>
__device__ __forceinline__ void ma_sweep(const MaArgs& a, const MaLayout& L, float* smem,
                                         int p0, int pw_live) {
  const int g = a.rows < kThreads ? kThreads / a.rows : 1;
  const int gi = threadIdx.x % g;
  const int stride = kThreads / g;  // between a thread's rows
  const int plane = 32 * a.pw * a.db;
  unsigned* st_k = reinterpret_cast<unsigned*>(smem + L.state);
  unsigned* st_w = st_k + a.rows * a.pw;
  for (int r0 = threadIdx.x / g; r0 < a.rows; r0 += RT * stride) {
    const float* xr[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) xr[i] = smem + L.xm + (r0 + i * stride) * L.xpitch;
    for (int w = 0; w < pw_live; ++w) {
      const int live = min(32, a.p - (p0 + 32 * w));
      unsigned kb[RT], wb[RT];
      ma_word<CELLS, MEMBER, RT>(xr, smem + L.edges, a.db, plane, w, gi, g, live, kb, wb);
      const unsigned mask = live_mask(live);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        for (int o = 1; o < g; o <<= 1) {  // each lane cleared only its own partitions' bits
          kb[i] &= __shfl_xor_sync(0xffffffffu, kb[i], o);
          wb[i] &= __shfl_xor_sync(0xffffffffu, wb[i], o);
        }
        if (gi == 0) {
          const int r = r0 + i * stride;
          st_k[r * a.pw + w] &= kb[i] & mask;
          st_w[r * a.pw + w] &= wb[i] & mask;
        }
      }
    }
  }
}

// The sweep with as many rows per thread (1 or 2) as the CTA's rows give.
template <bool CELLS, bool MEMBER>
__device__ __forceinline__ void ma_sweep_rows(const MaArgs& a, const MaLayout& L, float* smem,
                                              int p0, int pw_live) {
  if (a.rows > kThreads) ma_sweep<CELLS, MEMBER, 2>(a, L, smem, p0, pw_live);
  else ma_sweep<CELLS, MEMBER, 1>(a, L, smem, p0, pw_live);
}

// WANT: 0 reads the want flags at run time (the metric modes, rows <= 256:
// one row per thread; two CTAs per SM: at most 128 registers); 1 cells,
// 2 membership, 3 both, fixed at compile time (the assign-only mode, up to
// 2 rows per thread; three CTAs per SM: at most 85 registers).
template <int WANT>
constexpr int ma_min_blocks() { return WANT == 0 ? 2 : 3; }

template <int KIND, int A, int WANT>
__global__ void __launch_bounds__(kThreads, ma_min_blocks<WANT>()) map_assign_kernel(MaArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kMetric = KIND != kAssignOnly;
  const bool cells = WANT ? (WANT & 1) != 0 : a.want_cells != 0;
  const bool member = WANT ? (WANT & 2) != 0 : a.want_member != 0;
  const MaLayout L = ma_layout(a.rows, a.db, a.pw, kMetric);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * a.rows;
  const int words = a.pp / 32;
  const int n_wb = (words + a.pw - 1) / a.pw;
  const int n_db = (a.nap + a.db - 1) / a.db;
  unsigned* st_k = reinterpret_cast<unsigned*>(smem + L.state);
  unsigned* st_w = st_k + a.rows * a.pw;
  int* cell_s = reinterpret_cast<int*>(smem + L.cell);
  for (int r = tid; r < a.rows; r += kThreads) cell_s[r] = -1;

  for (int wb = 0; wb < n_wb; ++wb) {
    const int pw_live = min(a.pw, words - wb * a.pw);
    __syncthreads();  // the previous word block's answers are read
    for (int e = tid; e < a.rows * a.pw; e += kThreads) st_k[e] = st_w[e] = 0xffffffffu;
    for (int b = 0; b < n_db; ++b) {
      const int d0 = b * a.db;
      if (b > 0) __syncthreads();  // the previous sweep is done with xm_s and the edges
      ma_stage_edges(a, L, smem, wb * a.pw * 32, pw_live, d0, cells, member);
      if (kMetric && wb == 0) {
        if constexpr (kMetric) ma_space_map<KIND, A>(a, L, smem, r0, d0);
      } else if (n_db > 1 || wb == 0) {  // one dim block stays resident across word blocks
        ma_load_xm(a, L, smem, kMetric, r0, d0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (WANT == 0) {
        if (cells && member) ma_sweep<true, true, 1>(a, L, smem, wb * a.pw * 32, pw_live);
        else if (cells) ma_sweep<true, false, 1>(a, L, smem, wb * a.pw * 32, pw_live);
        else if (member) ma_sweep<false, true, 1>(a, L, smem, wb * a.pw * 32, pw_live);
      } else {
        ma_sweep_rows<(WANT & 1) != 0, (WANT & 2) != 0>(a, L, smem, wb * a.pw * 32, pw_live);
      }
    }
    __syncthreads();
    if (cells) {
      for (int r = tid; r < a.rows; r += kThreads) {
        for (int w = 0; w < pw_live && cell_s[r] < 0; ++w) {
          const unsigned bk = st_k[r * a.pw + w];
          if (bk) cell_s[r] = (wb * a.pw + w) * 32 + __ffs(bk) - 1;
        }
      }
    }
    for (int e = tid; e < a.rows * pw_live; e += kThreads) {
      const int r = e / pw_live;
      const int w = e % pw_live;
      if (r0 + r < a.n)
        a.bits[static_cast<size_t>(r0 + r) * words + wb * a.pw + w] =
            member ? static_cast<int>(st_w[r * a.pw + w]) : 0;
    }
  }
  for (int r = tid; r < a.rows; r += kThreads)
    if (r0 + r < a.n) a.cells[r0 + r] = max(cell_s[r], 0);
}

// Once per kernel: let it take up to the card's opt-in shared memory and
// prefer the shared-memory carveout, so as many CTAs fit an SM as the plan's
// bytes allow.
template <class K>
int opt_in(K kernel, int optin) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(e);
}

template <int KIND, int A, int WANT = 0>
int ma_launch(const MaArgs& a, size_t smem, int optin, cudaStream_t s) {
  static int ready = -1;  // opt_in's result, once per kernel
  if (ready < 0) ready = opt_in(map_assign_kernel<KIND, A, WANT>, optin);
  if (ready) return ready;
  const unsigned grid = static_cast<unsigned>((a.n + a.rows - 1) / a.rows);
  map_assign_kernel<KIND, A, WANT><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The assign-only mode when every dimension and every membership word fits
// one block (the main path's): a persistent grid whose CTAs stage the
// edges once and walk tiles of rows = 256 RT rows (tile blockIdx.x, then
// + gridDim.x, ...) with the next tile's rows in flight (cp.async into the
// second of two xm buffers, row pitch db) while this one is swept; each
// thread owns RT whole rows and writes their cells and words straight to
// global memory. kernels/mapassign.py::smem_bytes mirrors the layout.
__host__ __device__ inline int ma_stream_floats(int rows, int db, int pw) {
  return 4 * db * 32 * pw + 2 * rows * db;
}

template <int WANT, int RT>
__global__ void __launch_bounds__(kThreads, 3) map_assign_stream_kernel(MaArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kCells = (WANT & 1) != 0, kMember = (WANT & 2) != 0;
  const int words = a.pp / 32;
  const int plane = 32 * a.pw * a.db;
  const int tiles = (a.n + a.rows - 1) / a.rows;
  MaLayout L{};
  L.edges = 0;
  L.xpitch = a.db;
  ma_stage_edges(a, L, smem, 0, words, 0, kCells, kMember);
  int tile = blockIdx.x;
  L.xm = 4 * plane;
  if (tile < tiles) ma_load_xm(a, L, smem, false, tile * a.rows, 0);
  cp_async_commit();
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    MaLayout next = L;  // the other buffer: the next tile's rows
    next.xm = 4 * plane + ((k + 1) & 1) * a.rows * a.db;
    if (tile + gridDim.x < tiles) ma_load_xm(a, next, smem, false, (tile + gridDim.x) * a.rows, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's rows (and the edges) have landed
    const float* xs = smem + 4 * plane + (k & 1) * a.rows * a.db;
    const float* xr[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) xr[i] = xs + (threadIdx.x + i * kThreads) * a.db;
    int cell[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) cell[i] = -1;
    const long long r0 = static_cast<long long>(tile) * a.rows + threadIdx.x;
    for (int w = 0; w < words; ++w) {
      const int live = min(32, a.p - 32 * w);
      unsigned kb[RT], wb[RT];
      ma_word<kCells, kMember, RT>(xr, smem, a.db, plane, w, 0, 1, live, kb, wb);
      const unsigned mask = live_mask(live);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const long long r = r0 + i * kThreads;
        if (r >= a.n) continue;
        a.bits[r * words + w] = kMember ? static_cast<int>(wb[i] & mask) : 0;
        if (kCells && cell[i] < 0 && (kb[i] & mask)) cell[i] = 32 * w + __ffs(kb[i] & mask) - 1;
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const long long r = r0 + i * kThreads;
      if (r < a.n) a.cells[r] = max(cell[i], 0);
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
}

template <int WANT, int RT>
int ma_stream_launch(const MaArgs& a, int grid, size_t smem, int optin, cudaStream_t s) {
  static int ready = -1;
  if (ready < 0) ready = opt_in(map_assign_stream_kernel<WANT, RT>, optin);
  if (ready) return ready;
  map_assign_stream_kernel<WANT, RT><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int RT>
int ma_stream_want(const MaArgs& a, int grid, size_t smem, int optin, cudaStream_t s) {
  if (a.want_cells && a.want_member) return ma_stream_launch<3, RT>(a, grid, smem, optin, s);
  if (a.want_cells) return ma_stream_launch<1, RT>(a, grid, smem, optin, s);
  return ma_stream_launch<2, RT>(a, grid, smem, optin, s);
}

template <int KIND>
int ma_launch_a(const MaArgs& a, int an, size_t smem, int optin, cudaStream_t s) {
  switch (an) {
    case 1: return ma_launch<KIND, 1>(a, smem, optin, s);
    case 2: return ma_launch<KIND, 2>(a, smem, optin, s);
    case 4: return ma_launch<KIND, 4>(a, smem, optin, s);
    case 8: return ma_launch<KIND, 8>(a, smem, optin, s);
    case 16: return ma_launch<KIND, 16>(a, smem, optin, s);
    case 32: return ma_launch<KIND, 32>(a, smem, optin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Active CTAs per SM of kernel K at `smem` bytes of dynamic shared memory
// (the occupancy its registers and shared memory allow), or a negative
// CUDA error.
template <auto K>
int ma_occupancy(size_t smem, int optin) {
  int blocks = 0;
  cudaError_t e = static_cast<cudaError_t>(opt_in(K, optin));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K, kThreads, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

}  // namespace repro_torch

// Bytes of dynamic shared memory a plan takes (launch_plan checks its own
// count against this one).
extern "C" int map_assign_smem_bytes(int rows, int db, int pw, int metric_mode, int stream) {
  using namespace repro_torch;
  return 4 * (stream ? ma_stream_floats(rows, db, pw) : ma_layout(rows, db, pw, metric_mode != 0).total);
}

// x (n, m) rows, or (n, na) mapped rows when metric < 0; anchors (na, m);
// the four box edges (pp, nap), p of the pp partitions live; xm (n, na),
// cells (n,), bits (n, pp / 32). The plan (rows, a, db, pw, grid, stream)
// comes from kernels/mapassign.py::launch_plan: stream takes the
// persistent assign-only kernel over `grid` CTAs, else one CTA per `rows`
// rows; vec: 16-byte row copies.
extern "C" int map_assign_launch(const float* x, const float* anchors, const float* klo,
                                 const float* khi, const float* wlo, const float* whi,
                                 float* xm, int* cells, int* bits, int n, int m, int na,
                                 int nap, int pp, int metric, int want_cells,
                                 int want_member, int rows, int a_per, int db, int pw, int p,
                                 int grid, int stream, int vec, void* st) {
  using namespace repro_torch;
  if (n <= 0) return 0;
  const bool metric_mode = metric >= 0;
  const bool rows_ok = rows == 32 || rows == 64 || rows == 128 || rows == 256 ||
                       (!metric_mode && rows == 512);
  const long long tiles = (static_cast<long long>(n) + rows - 1) / rows;
  if (!rows_ok || na < 1 || na > nap || nap % 8 || pp < 32 || pp % 32 || db < 8 || db % 8 ||
      pw < 1 || p < 1 || p > pp || p <= pp - 32 || grid < 1 || grid > tiles ||
      (metric_mode && (m < 1 || db != (kThreads / rows) * a_per)) ||
      (stream && (metric_mode || rows < kThreads || db < nap || pw != pp / 32)) ||
      (!stream && grid != tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = static_cast<size_t>(map_assign_smem_bytes(rows, db, pw, metric_mode, stream));
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  MaArgs args{x, anchors, {klo, khi, wlo, whi}, xm, cells, bits, n, m, na, nap, pp, metric,
              rows, db, pw, p, want_cells, want_member, vec};
  cudaStream_t s = static_cast<cudaStream_t>(st);
  if (stream) {
    return rows == 512 ? ma_stream_want<2>(args, grid, smem, optin, s)
                       : ma_stream_want<1>(args, grid, smem, optin, s);
  }
  switch (metric) {
    case kAssignOnly:
      if (want_cells && want_member) return ma_launch<kAssignOnly, 1, 3>(args, smem, optin, s);
      if (want_cells) return ma_launch<kAssignOnly, 1, 1>(args, smem, optin, s);
      return ma_launch<kAssignOnly, 1, 2>(args, smem, optin, s);
    case kL1: return ma_launch_a<kL1>(args, a_per, smem, optin, s);
    case kLinf: return ma_launch_a<kLinf>(args, a_per, smem, optin, s);
    case kL2:
    case kCosine:
    case kDot: return ma_launch_a<kDot>(args, a_per, smem, optin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Active CTAs per SM of the kernel a plan launches, at its shared memory:
// the l1 metric mode with `a_per` anchors per thread, or the assign-only
// mode (metric < 0) for the wanted outputs, persistent with
// rows_per_thread (1 or 2) rows per thread or, at 0, one CTA per tile.
// Negative: a CUDA error.
extern "C" int map_assign_occupancy(int metric, int a_per, int want_cells, int want_member,
                                    int smem, int rows_per_thread) {
  using namespace repro_torch;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int want = (want_cells ? 1 : 0) | (want_member ? 2 : 0);
  const int bad = -static_cast<int>(cudaErrorInvalidValue);
  if (metric >= 0) {
    switch (a_per) {
      case 1: return ma_occupancy<map_assign_kernel<kL1, 1, 0>>(smem, optin);
      case 2: return ma_occupancy<map_assign_kernel<kL1, 2, 0>>(smem, optin);
      case 4: return ma_occupancy<map_assign_kernel<kL1, 4, 0>>(smem, optin);
      case 8: return ma_occupancy<map_assign_kernel<kL1, 8, 0>>(smem, optin);
      case 16: return ma_occupancy<map_assign_kernel<kL1, 16, 0>>(smem, optin);
      case 32: return ma_occupancy<map_assign_kernel<kL1, 32, 0>>(smem, optin);
      default: return bad;
    }
  }
  switch (rows_per_thread * 4 + want) {
    case 1: return ma_occupancy<map_assign_kernel<kAssignOnly, 1, 1>>(smem, optin);
    case 2: return ma_occupancy<map_assign_kernel<kAssignOnly, 1, 2>>(smem, optin);
    case 3: return ma_occupancy<map_assign_kernel<kAssignOnly, 1, 3>>(smem, optin);
    case 5: return ma_occupancy<map_assign_stream_kernel<1, 1>>(smem, optin);
    case 6: return ma_occupancy<map_assign_stream_kernel<2, 1>>(smem, optin);
    case 7: return ma_occupancy<map_assign_stream_kernel<3, 1>>(smem, optin);
    case 9: return ma_occupancy<map_assign_stream_kernel<1, 2>>(smem, optin);
    case 10: return ma_occupancy<map_assign_stream_kernel<2, 2>>(smem, optin);
    case 11: return ma_occupancy<map_assign_stream_kernel<3, 2>>(smem, optin);
    default: return bad;
  }
}

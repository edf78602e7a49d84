// Uniform-grid ray march for Hopper (sm_90a): interaction traces and
// shadow visibility.
//
// Replaces the plain XLA march of the reference, not a Pallas kernel:
// pathtracer_gaussiansplatting_tpu/render/grid_trace.py: trace_grid (:1060)
// and visibility_grid (:1109), i.e. _phase_a (:459), _phase_b (:611) and
// _march (:894). Each ray runs the reference's per-round state machine: for
// each round (M slots, a_max probes) of the schedule it walks the block
// table (empty-block euclidean jumps, a slab test of the occupied block's
// sub-box, up to 4 in-block cell steps per probe, popcount slots), and
// composites each occupied cell as phase A records it: the cell's Kc
// Gaussians respond at their slab-owned peaks (t in [t_enter, t_exit)),
// are weighted front to back in (t, slot) order by the exclusive product
// over the Gaussians before them, and the cell transmittance is chained in
// slot order exactly as phase B's exclusive cumprod over a slot group
// (T_k = T_group * prod_{j<k} ct_j, then T = (T_group * E_last) * ct_last).
// After every 8 recorded cells of a round (a slot group) and at the round's
// end a ray at or below transmittance_min dies; a ray still alive after the
// last round is frozen (its sums are partial) and flagged.
//
// What the kernel leaves out, by choice: the batch-level schedule. The
// plain march's exit fractions stop phase A for the whole batch once few
// rays still probe, and above 32768 rays its later rounds resume only the
// first `cap` survivors. The reference has them because a while-loop
// iteration costs the full batch width on the TPU whatever the live-lane
// count (grid_trace.py:441-448); here a finished ray costs nothing, so
// every ray gets each round's full probe budget. With a schedule that has
// no exit fractions and capacity 1 the kernel follows the plain march ray
// for ray.
//
// What bounds it on this card: not bytes or flops but instruction issue
// and the latency of dependent loads (a probe's 16-byte block row, then a
// cell's packet row). Rays take different numbers of probes and cells, and
// a cell's work (Kc responses, the cell transmittance, each Gaussian's
// exclusive product) is serial within a ray. The design:
// - L lanes per ray: a warp (L = 32, 4 rays a 128-thread block) for a
//   feature trace, half a warp (L = 16, 8 rays a block) for a shadow
//   segment. The traversal (cell lookup, block-table probe, sub-box slab
//   test, in-block steps, the slot groups' transmittance and kill tests)
//   runs identically in each of a ray's lanes on broadcast loads, so they
//   never diverge. Its instructions are issued once per ray, so it skips
//   what it can: an empty block jumps without the sub-box test, and the
//   in-block steps end at the first that would change nothing. Shadow
//   segments are mostly probes, so they take fewer lanes.
// - A cell across the lanes. A cell row is stored column-major with stride
//   Kc, so lane l takes slots l, l + L, ... below Kc (NS = ceil(Kc / L) of
//   them, in registers) and each column is one coalesced load. The cell
//   transmittance and each slot's exclusive product are taken by a walk over
//   the cell's live slots (a ballot of alpha > 0) in slot order, each slot's
//   alpha and peak t broadcast by a shuffle, in every lane: the operands and
//   their order are a serial march's, so the transmittance, the weights and
//   every kill test are too, whatever L.
// - Each lane keeps 15 partial sums over its slots for the whole ray and
//   loads a slot's feature columns only where its weight is positive; the
//   lanes add the partial sums once per ray (a xor-shuffle butterfly). Only
//   this summation order differs from a serial march.
// - No local arrays: every per-lane array has a compile-time size and is
//   indexed by unrolled loops.
// - Kc above kRegSlots (the NS = 0 instantiation, any multiple of 16): a
//   lane's slots would grow as register arrays past what a thread holds,
//   so a feature trace keeps the cell's alpha, peak t and exclusive
//   products in shared memory (12 bytes a slot a ray, beside a ballot word
//   a 32 slots), and a shadow segment, which needs only the cell's product
//   in slot order, takes the cell in passes of L slots with no array at
//   all. Both walk the live slots in the order above, with the same
//   operands, so they give the register path's bits.
// - The wide instantiation bounds a cell's work by the slots it holds, not
//   by Kc. The binning fills a cell's slots as a prefix, [0, fill) with
//   fill = min(count, Kc), and zeroes the rest; a zero slot responds with
//   alpha 0, a factor 1 and a weight 0, so leaving it out changes no bit.
//   Each recorded cell's fill is one broadcast load beside its row. A
//   segment takes ceil(fill / L) passes. A trace takes a cell of at most
//   kWideWalk * L slots on the register walk (composite_cell with NS =
//   ceil(fill / L), at stride Kc: no shared-memory round trip), and a
//   fuller one on the shared-memory walk with every loop bounded by fill;
//   a ray's region holds the table's largest fill (Params::wide_slots),
//   not Kc.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

#include <cuda_runtime.h>

#include "grid_common.cuh"

namespace {

using ptgs_grid::fadd;
using ptgs_grid::fmul;
using ptgs_grid::fsub;
using ptgs_grid::kAccKeys;
using ptgs_grid::Params;
using ptgs_grid::Ray;

constexpr int kThreads = 128;
constexpr int kWarp = 32;
// Kc up to this keeps a lane's NS = ceil(Kc / L) slots in registers;
// above, the NS = 0 instantiation (composite_cell_fill).
constexpr int kRegSlots = 128;
// Above kRegSlots, a trace's cell of at most kWideWalk * L slots takes the
// register walk with ceil(fill / L) slots a lane; a fuller one shared
// memory. Two: most cells of a surface hold at most 64 Gaussians.
constexpr int kWideWalk = 2;
// Lanes a ray: a warp for a feature trace, half a warp for a shadow
// segment, which is mostly probes (about 20 a segment against 1.6 cells
// composited), so fewer lanes repeat them.
constexpr int kTraceLanes = 32;
constexpr int kVisLanes = 16;

template <bool FEAT>
__host__ __device__ constexpr int lanes() {
  return FEAT ? kTraceLanes : kVisLanes;
}

// A ray's L lanes of a warp: this thread's lane among them, and their
// ballot, broadcast and butterfly, which no other lane of the warp joins.
template <int L>
struct RayLanes {
  int lane, base;  // lane in 0 .. L-1; the ray's first lane in the warp
  unsigned mask;   // the ray's lanes in the warp

  __device__ RayLanes() {
    const int wl = threadIdx.x % kWarp;
    lane = wl % L;
    base = wl - lane;
    mask = (0xffffffffu >> (kWarp - L)) << base;
  }
  // Bit i set iff lane i's pred.
  __device__ unsigned ballot(bool pred) const {
    return (__ballot_sync(mask, pred) & mask) >> base;
  }
  __device__ float bcast(float v, int src) const {
    return __shfl_sync(mask, v, src, L);
  }
  __device__ float bxor(float v, int off) const {
    return __shfl_xor_sync(mask, v, off, L);
  }
};

// Adds slot i's weighted features (weight w > 0) to this lane's sums.
__device__ __forceinline__ void add_features(const Ray& r, const float* row,
                                             int kc, int i, float w,
                                             float t_peak, bool deg1,
                                             float* acc) {
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float* f = row + i;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float col = fadd(f[(ptgs_grid::kDc + ch) * kc], 0.5f);
    if (deg1)
      col = fadd(fadd(fadd(col, fmul(dy, f[(ptgs_grid::kBy + ch) * kc])),
                      fmul(dz, f[(ptgs_grid::kBy + 3 + ch) * kc])),
                 fmul(dx, f[(ptgs_grid::kBy + 6 + ch) * kc]));
    acc[ch] = fadd(acc[ch], fmul(w, fmaxf(col, 0.0f)));
    acc[3 + ch] = fadd(acc[3 + ch], fmul(w, f[(ptgs_grid::kEmi + ch) * kc]));
  }
#pragma unroll
  for (int s = 0; s < 5; ++s)  // metallic .. transmission
    acc[6 + s] = fadd(acc[6 + s], fmul(w, f[(ptgs_grid::kMet + s) * kc]));
  const float ax = f[ptgs_grid::kAxis * kc];
  const float ay = f[(ptgs_grid::kAxis + 1) * kc];
  const float az = f[(ptgs_grid::kAxis + 2) * kc];
  const float sgn =
      fadd(fadd(fmul(ax, dx), fmul(ay, dy)), fmul(az, dz)) > 0.0f ? -1.0f
                                                                  : 1.0f;
  acc[11] = fadd(acc[11], fmul(fmul(w, ax), sgn));
  acc[12] = fadd(acc[12], fmul(fmul(w, ay), sgn));
  acc[13] = fadd(acc[13], fmul(fmul(w, az), sgn));
  acc[14] = fadd(acc[14], fmul(w, t_peak));
}

// Composites one recorded cell (packet or geometry row `row`) entered with
// transmittance t_enter, across the ray's L lanes (lane l takes slots l,
// l + L, ... below n <= NS * L; the slots from n on are zero): returns the
// cell transmittance prod (1 - alpha) in slot order (the same value in
// every lane) and, with FEAT, adds this lane's slots' weighted features to
// its partial sums acc.
template <bool FEAT, int NS, int L>
__device__ __forceinline__ float composite_cell(
    const Ray& r, const float* row, int n, float t0, float t1, bool segment,
    float t_cap, float t_enter, float* acc, const Params& prm,
    const RayLanes<L>& rl) {
  const int kc = prm.kc;
  float alpha[NS], tpk[NS], excl[NS];
  unsigned live[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int j = rl.lane + L * s;
    alpha[s] = 0.0f;
    tpk[s] = 0.0f;
    excl[s] = 1.0f;
    if (j < n) {
      const ptgs_grid::Response e =
          ptgs_grid::respond(r, row, kc, j, t0, t1, segment, t_cap, prm);
      // A slot without a positive alpha is a factor 1 and a weight 0.
      if (e.alpha > 0.0f) {
        alpha[s] = e.alpha;
        tpk[s] = e.t_peak;
      }
    }
    live[s] = rl.ballot(alpha[s] > 0.0f);
  }
  // The live slots in slot order, each broadcast to every lane.
  float ct = 1.0f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    unsigned m = live[s];
    while (m != 0u) {
      const int src = __ffs(m) - 1;
      m &= m - 1u;
      const float om = fsub(1.0f, rl.bcast(alpha[s], src));
      ct = fmul(ct, om);
      if (FEAT) {
        // Exclusive product over the Gaussians before each of this lane's
        // slots in (t, slot) order.
        const float tj = rl.bcast(tpk[s], src);
        const int j = src + L * s;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int i = rl.lane + L * k;
          if (tj < tpk[k] || (tj == tpk[k] && j < i))
            excl[k] = fmul(excl[k], om);
        }
      }
    }
  }
  if (FEAT) {
    const bool deg1 = prm.cols >= ptgs_grid::kPktDeg1;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (!(alpha[k] > 0.0f)) continue;
      const float w = fmul(fmul(t_enter, excl[k]), alpha[k]);
      // A zero weight adds exact zeros: skip its loads.
      if (w > 0.0f)
        add_features(r, row, kc, rl.lane + L * k, w, tpk[k], deg1, acc);
    }
  }
  return ct;
}

// composite_cell for any Kc (the NS = 0 instantiation) over the cell's
// fill slots (the rest are zero): the same walk over the cell's live slots
// in slot order, with the same operands, so the same bits. A shadow
// segment multiplies its cell's transmittance in ceil(fill / L) passes of
// L slots, each slot's alpha broadcast from its lane. A feature trace
// first writes each slot's alpha and peak t (0 where not live) to the
// ray's region of shared memory, wide = [alpha (S), t_peak (S), excl (S),
// ballot words (S / 16)] for S = Params::wide_slots >= fill, its lanes
// taking slots l, l + L, ...
template <bool FEAT, int L>
__device__ __forceinline__ float composite_cell_wide(
    const Ray& r, const float* row, int fill, float t0, float t1,
    bool segment, float t_cap, float t_enter, float* acc, const Params& prm,
    const RayLanes<L>& rl, float* wide) {
  const int kc = prm.kc;
  float ct = 1.0f;
  if (!FEAT) {
    for (int s0 = 0; s0 < fill; s0 += L) {
      const int j = s0 + rl.lane;
      float alpha = 0.0f;
      if (j < fill) {
        const ptgs_grid::Response e =
            ptgs_grid::respond(r, row, kc, j, t0, t1, segment, t_cap, prm);
        if (e.alpha > 0.0f) alpha = e.alpha;
      }
      unsigned m = rl.ballot(alpha > 0.0f);
      while (m != 0u) {
        const int src = __ffs(m) - 1;
        m &= m - 1u;
        ct = fmul(ct, fsub(1.0f, rl.bcast(alpha, src)));
      }
    }
    return ct;
  }
  const int slots = prm.wide_slots;
  float* sa = wide;
  float* st = wide + slots;
  float* se = wide + 2 * slots;
  unsigned* sl = reinterpret_cast<unsigned*>(wide + 3 * slots);
  for (int s0 = 0; s0 < fill; s0 += L) {
    const int j = s0 + rl.lane;
    float alpha = 0.0f, tpk = 0.0f;
    if (j < fill) {
      const ptgs_grid::Response e =
          ptgs_grid::respond(r, row, kc, j, t0, t1, segment, t_cap, prm);
      if (e.alpha > 0.0f) {
        alpha = e.alpha;
        tpk = e.t_peak;
      }
      sa[j] = alpha;
      st[j] = tpk;
      se[j] = 1.0f;
    }
    const unsigned live = rl.ballot(alpha > 0.0f);
    if (rl.lane == 0) sl[s0 / L] = live;
  }
  __syncwarp(rl.mask);
  // The live slots in slot order: the cell transmittance in every lane, and
  // each of this lane's live slots' exclusive product over the Gaussians
  // before it in (t, slot) order.
  for (int w = 0; w * L < fill; ++w) {
    unsigned m = sl[w];
    while (m != 0u) {
      const int j = w * L + __ffs(m) - 1;
      m &= m - 1u;
      const float om = fsub(1.0f, sa[j]);
      ct = fmul(ct, om);
      const float tj = st[j];
      for (int i = rl.lane; i < fill; i += L) {
        const float ti = st[i];
        if (sa[i] > 0.0f && (tj < ti || (tj == ti && j < i)))
          se[i] = fmul(se[i], om);
      }
    }
  }
  const bool deg1 = prm.cols >= ptgs_grid::kPktDeg1;
  for (int i = rl.lane; i < fill; i += L) {
    const float alpha = sa[i];
    if (!(alpha > 0.0f)) continue;
    const float w = fmul(fmul(t_enter, se[i]), alpha);
    if (w > 0.0f) add_features(r, row, kc, i, w, st[i], deg1, acc);
  }
  __syncwarp(rl.mask);  // the region is read no more: the next cell may
  return ct;           // write it
}

// A cell of the NS = 0 instantiation, by its fill: a trace's cell of at
// most kWideWalk * L slots on the register walk with the fewest slots a
// lane that hold it, any other cell on composite_cell_wide.
template <bool FEAT, int L, int NS = 1>
__device__ __forceinline__ float composite_cell_fill(
    const Ray& r, const float* row, int fill, float t0, float t1,
    bool segment, float t_cap, float t_enter, float* acc, const Params& prm,
    const RayLanes<L>& rl, float* wide) {
  if constexpr (FEAT && NS <= kWideWalk) {
    if (fill <= NS * L)
      return composite_cell<FEAT, NS, L>(r, row, fill, t0, t1, segment,
                                         t_cap, t_enter, acc, prm, rl);
    return composite_cell_fill<FEAT, L, NS + 1>(
        r, row, fill, t0, t1, segment, t_cap, t_enter, acc, prm, rl, wide);
  } else {
    return composite_cell_wide<FEAT, L>(r, row, fill, t0, t1, segment,
                                        t_cap, t_enter, acc, prm, rl, wide);
  }
}

// Floats of a ray's region of `slots` slots for composite_cell_wide
// (ballot words for L = 16 or 32 lanes).
__host__ __device__ constexpr int wide_floats(int slots) {
  return 3 * slots + (slots + 15) / 16;
}

// The transmittance bookkeeping of one round's slot groups.
struct Groups {
  int m;          // the round's slots
  int n;          // cells recorded so far this round
  int g0;         // first slot of the current group
  float t_group;  // transmittance at the current group's start
  float e_prod;   // prod of the current group's cell transmittances so far
  float e_last;   // e_prod before the last recorded cell
  float ct_last;  // the last recorded cell's transmittance

  __device__ int width() const { return min(ptgs_grid::kSlotGroup, m - g0); }
  // Transmittance after the current group (phase B's rounding).
  __device__ float closed() const {
    const int k = n - g0;
    return k == width() ? fmul(fmul(t_group, e_last), ct_last)
                        : fmul(t_group, e_prod);
  }
};

template <bool FEAT, int NS>
__global__ void __launch_bounds__(kThreads) grid_march_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_end, const unsigned char* __restrict__ active,
    const int4* __restrict__ btab, const float* __restrict__ table,
    const int* __restrict__ fills, const float* __restrict__ lo,
    const float* __restrict__ hi, float* __restrict__ trans_out,
    float* __restrict__ acc_out, unsigned char* __restrict__ frozen_out,
    int n_rays, Params prm) {
  constexpr int L = lanes<FEAT>();
  const RayLanes<L> rl;
  const int ray = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (ray >= n_rays) return;  // all of the ray's lanes
  // Every lane of the ray reads the same addresses (broadcast loads) and
  // computes the same traversal; only the cells' slots are split.
  const Ray r = ptgs_grid::setup_ray(origins + 3 * ray, dirs + 3 * ray, lo,
                                     hi, prm);
  const bool segment = t_end != nullptr;
  const float t_cap = segment ? t_end[ray] : 0.0f;
  const float t_far = segment ? fminf(r.t_far, t_cap) : r.t_far;
  bool alive = r.inside && (active == nullptr || active[ray] != 0);
  float acc[kAccKeys];
#pragma unroll
  for (int c = 0; c < kAccKeys; ++c) acc[c] = 0.0f;
  float trans = 1.0f;
  float t = r.t_entry;

  const int bx_n = (prm.gx + 3) / 4, by_n = (prm.gy + 3) / 4;
  const int n_blocks = bx_n * by_n * ((prm.gz + 3) / 4);
  const size_t row_len = static_cast<size_t>(prm.cols) * prm.kc;

  for (int round = 0; round < prm.n_rounds && alive; ++round) {
    // The round's (M, a_max), picked by constant indices: a runtime index
    // into the parameters would copy them to a local-memory stack.
    int m_round = 0, a_round = 0;
#pragma unroll
    for (int i = 0; i < ptgs_grid::kMaxRounds; ++i)
      if (i == round) {
        m_round = prm.m[i];
        a_round = prm.a_max[i];
      }
    Groups grp{m_round, 0, 0, trans, 1.0f, 1.0f, 1.0f};
    bool dead = false;
    for (int it = 0; it < a_round && !dead; ++it) {
      if (!(t < t_far && grp.n < grp.m)) break;
      float cell[3];
      ptgs_grid::cell_of(r, t, cell);
      const int ix = static_cast<int>(cell[0]), iy = static_cast<int>(cell[1]);
      const int iz = static_cast<int>(cell[2]);
      const int bx = ix >> 2, by = iy >> 2, bz = iz >> 2;
      const int blin =
          min(max((bz * by_n + by) * bx_n + bx, 0), n_blocks - 1);
      const int4 row = btab[blin];
      const int info = row.x, base = row.y;
      const unsigned mlo = static_cast<unsigned>(row.z);
      const unsigned mhi = static_cast<unsigned>(row.w);

      // The block's exit, at least t + eps (taken only where it is used).
      auto block_exit = [&]() {
        const float bcell[3] = {floorf(cell[0] / 4.0f),
                                floorf(cell[1] / 4.0f),
                                floorf(cell[2] / 4.0f)};
        return fmaxf(ptgs_grid::exit_of(r, bcell, r.edge), fadd(t, r.eps));
      };
      // Empty block: euclidean jump, at least to the block exit.
      if (info < 0) {
        const float jump_w =
            fmul(static_cast<float>(-(info + 1)), prm.jump_unit);
        t = fmaxf(block_exit(), fadd(t, jump_w));
        continue;
      }

      // Occupied block: slab-test the tight box of its set cells.
      const int bmin[3] = {info & 3, (info >> 4) & 3, (info >> 8) & 3};
      const int bmax[3] = {(info >> 2) & 3, (info >> 6) & 3,
                           (info >> 10) & 3};
      const int bi[3] = {bx, by, bz};
      float t_in = -3.402823466e38f, t_out = 3.402823466e38f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float borig =
            fadd(r.lo[k], fmul(static_cast<float>(bi[k]), r.edge[k]));
        const float box_lo =
            fadd(borig, fmul(static_cast<float>(bmin[k]), r.cell[k]));
        const float box_hi = fadd(
            borig, fmul(fadd(static_cast<float>(bmax[k]), 1.0f), r.cell[k]));
        const float tb0 = fmul(fsub(box_lo, r.o[k]), r.inv_d[k]);
        const float tb1 = fmul(fsub(box_hi, r.o[k]), r.inv_d[k]);
        t_in = fmaxf(t_in, fminf(tb0, tb1));
        t_out = fminf(t_out, fmaxf(tb0, tb1));
      }
      const float enter = fmaxf(t, t_in);
      if (!(t_out > enter)) {  // the sub-box missed: on to the block exit
        t = fmaxf(block_exit(), t);
        continue;
      }

      // Up to 4 in-block cell steps from this one row. A step that changes
      // nothing (out of the sub-box, or the round's slots full) ends them:
      // the next would repeat it.
      float tk = enter;
      for (int s = 0; s < 4; ++s) {
        float ck[3];
        ptgs_grid::cell_of(r, tk, ck);
        const int jx = static_cast<int>(ck[0]), jy = static_cast<int>(ck[1]);
        const int jz = static_cast<int>(ck[2]);
        const bool same_block =
            (jx >> 2) == bx && (jy >> 2) == by && (jz >> 2) == bz;
        if (!(same_block && tk < t_far && tk < t_out)) break;
        const int rank = (jx & 3) + 4 * (jy & 3) + 16 * (jz & 3);
        const bool hi_word = rank >= 32;
        const int sh = hi_word ? rank - 32 : rank;
        const unsigned word = hi_word ? mhi : mlo;
        const bool bit = (word >> sh) & 1u;
        const float tex =
            fmaxf(ptgs_grid::exit_of(r, ck, r.cell), fadd(tk, r.eps));
        if (bit) {
          if (!(grp.n < grp.m)) break;
          // Record the cell: composite it, close its group when full.
          const unsigned below = (1u << sh) - 1u;
          const unsigned below_lo = hi_word ? mlo : (mlo & below);
          const unsigned below_hi = hi_word ? (mhi & below) : 0u;
          const int slot = base + __popc(below_lo) + __popc(below_hi);
          const float t_enter = fmul(grp.t_group, grp.e_prod);
          const float* cell_row = table + static_cast<size_t>(slot) * row_len;
          float ct;
          if constexpr (NS == 0) {
            // The ray's region of the block's dynamic shared memory, and
            // the cell's filled slots (the rest of its row is zero).
            extern __shared__ float wide_smem[];
            ct = composite_cell_fill<FEAT, L>(
                r, cell_row, fills[slot], tk, tex, segment, t_cap, t_enter,
                acc, prm, rl,
                wide_smem + (threadIdx.x / L) * wide_floats(prm.wide_slots));
          } else {
            ct = composite_cell<FEAT, NS, L>(r, cell_row, prm.kc, tk, tex,
                                             segment, t_cap, t_enter, acc,
                                             prm, rl);
          }
          grp.e_last = grp.e_prod;
          grp.ct_last = ct;
          grp.e_prod = fmul(grp.e_prod, ct);
          ++grp.n;
          if (grp.n - grp.g0 == grp.width()) {
            trans = grp.closed();
            dead = !(trans > prm.transmittance_min);
            grp.g0 = grp.n;
            grp.t_group = trans;
            grp.e_prod = grp.e_last = grp.ct_last = 1.0f;
            if (dead) break;
          }
        }
        tk = tex;
      }
      if (dead) break;

      // Past the sub-box (or the steps stopped inside it).
      t = tk < t_out ? tk : fmaxf(block_exit(), tk);
    }
    if (!dead && grp.n > grp.g0) {  // the round's last, partial group
      trans = grp.closed();
      dead = !(trans > prm.transmittance_min);
    }
    // A ray survives the round iff it paused (traversal unfinished) and
    // its transmittance is still above transmittance_min.
    alive = !dead && t < t_far;
  }

  if (FEAT) {
    // The lanes' partial sums, added once per ray.
#pragma unroll
    for (int c = 0; c < kAccKeys; ++c)
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        acc[c] = fadd(acc[c], rl.bxor(acc[c], off));
  }
  if (rl.lane == 0) {
    trans_out[ray] = trans;
    frozen_out[ray] = alive ? 1 : 0;
    if (FEAT)
#pragma unroll
      for (int c = 0; c < kAccKeys; ++c)
        acc_out[static_cast<size_t>(ray) * kAccKeys + c] = acc[c];
  }
}

// Launches the instantiation for ns = ceil(Kc / L) slots a lane.
template <bool FEAT, int NS = 1, typename... Args>
void launch_ns(int ns, int blocks, cudaStream_t stream, Args... args) {
  if constexpr (NS * lanes<FEAT>() < kRegSlots) {
    if (ns > NS) return launch_ns<FEAT, NS + 1>(ns, blocks, stream, args...);
  }
  grid_march_kernel<FEAT, NS><<<blocks, kThreads, 0, stream>>>(args...);
}

template <bool FEAT>
cudaError_t launch(const float* origins, const float* dirs,
                   const float* t_end, const unsigned char* active,
                   const int* btab, const float* table, const int* fill,
                   const float* lo, const float* hi, float* trans,
                   float* acc, unsigned char* frozen, int n_rays,
                   const Params& prm, cudaStream_t stream) {
  constexpr int L = lanes<FEAT>();
  const int rays_per_block = kThreads / L;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  const int4* bt = reinterpret_cast<const int4*>(btab);
  if (prm.kc <= kRegSlots) {
    launch_ns<FEAT>((prm.kc + L - 1) / L, blocks, stream, origins, dirs,
                    t_end, active, bt, table, fill, lo, hi, trans, acc,
                    frozen, n_rays, prm);
    return cudaGetLastError();
  }
  // Wider cells: the NS = 0 instantiation, with a feature trace's regions
  // of the largest fill's slots (none where every cell takes the
  // register walk).
  const size_t smem =
      FEAT && prm.wide_slots > kWideWalk * L
          ? sizeof(float) * rays_per_block * wide_floats(prm.wide_slots)
          : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        grid_march_kernel<FEAT, 0>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  grid_march_kernel<FEAT, 0><<<blocks, kThreads, smem, stream>>>(
      origins, dirs, t_end, active, bt, table, fill, lo, hi, trans, acc,
      frozen, n_rays, prm);
  return cudaGetLastError();
}

bool make_params(const int* sched, int n_rounds, int gx, int gy, int gz,
                 int kc, int cols, int wide_slots, float t_min, float t_max,
                 float alpha_min, float alpha_max, float gval_cut,
                 float transmittance_min, float jump_unit, Params* prm) {
  if (n_rounds < 0 || n_rounds > ptgs_grid::kMaxRounds || kc <= 0 ||
      gx <= 0 || gy <= 0 || gz <= 0 || wide_slots < 0 || wide_slots > kc)
    return false;
  *prm = Params{t_min, t_max, alpha_min, alpha_max, gval_cut,
                transmittance_min, jump_unit, gx, gy, gz, kc, cols,
                n_rounds, wide_slots, {}, {}};
  for (int i = 0; i < n_rounds; ++i) {
    prm->m[i] = sched[2 * i];
    prm->a_max[i] = sched[2 * i + 1];
  }
  return true;
}

}  // namespace

// origins, dirs (R, 3); t_end (R,) or NULL; active (R,) bool bytes or NULL;
// btab (B, 4) int32 (16-byte aligned rows); table (S, cols * kc) float32
// column-major per row (the packet table for a trace, the geometry table
// for visibility); fill (S,) int32, each row's filled slots (read above
// Kc = 128); lo, hi (3,) device floats; sched: host int pairs (M, a_max)
// per round; wide_slots: the largest fill (above Kc = 128; it sizes a
// trace's shared memory). Out: trans (R,), acc (R, 15) (trace only),
// frozen (R,) bytes. Returns a cudaError_t.
extern "C" int ptgs_grid_trace(
    const float* origins, const float* dirs, const float* t_end,
    const unsigned char* active, const int* btab, const float* table,
    const int* fill, const float* lo, const float* hi, const int* sched,
    float* trans, float* acc, unsigned char* frozen, int n_rays,
    int n_rounds, int gx, int gy, int gz, int kc, int cols, int wide_slots,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, float transmittance_min, float jump_unit, void* stream) {
  Params prm;
  if (n_rays <= 0 || acc == nullptr || fill == nullptr ||
      !make_params(sched, n_rounds, gx, gy, gz, kc, cols, wide_slots, t_min,
                   t_max, alpha_min, alpha_max, gval_cut, transmittance_min,
                   jump_unit, &prm))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(
      origins, dirs, t_end, active, btab, table, fill, lo, hi, trans, acc,
      frozen, n_rays, prm, static_cast<cudaStream_t>(stream)));
}

extern "C" int ptgs_grid_visibility(
    const float* origins, const float* dirs, const float* t_end,
    const unsigned char* active, const int* btab, const float* table,
    const int* fill, const float* lo, const float* hi, const int* sched,
    float* trans, float* acc, unsigned char* frozen, int n_rays,
    int n_rounds, int gx, int gy, int gz, int kc, int cols, int wide_slots,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, float transmittance_min, float jump_unit, void* stream) {
  Params prm;
  if (n_rays <= 0 || t_end == nullptr || fill == nullptr ||
      !make_params(sched, n_rounds, gx, gy, gz, kc, cols, wide_slots, t_min,
                   t_max, alpha_min, alpha_max, gval_cut, transmittance_min,
                   jump_unit, &prm))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(
      origins, dirs, t_end, active, btab, table, fill, lo, hi, trans, acc,
      frozen, n_rays, prm, static_cast<cudaStream_t>(stream)));
}

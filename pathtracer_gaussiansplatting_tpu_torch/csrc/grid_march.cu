// Uniform-grid ray march for Hopper (sm_90a): interaction traces and
// shadow visibility.
//
// Replaces the plain XLA march of the reference, not a Pallas kernel:
// pathtracer_gaussiansplatting_tpu/render/grid_trace.py: trace_grid (:1060)
// and visibility_grid (:1109), i.e. _phase_a (:459), _phase_b (:611) and
// _march (:894). One thread per ray runs the reference's per-round state
// machine: for each round (M slots, a_max probes) of the schedule it walks
// the block table (empty-block euclidean jumps, a slab test of the occupied
// block's sub-box, up to 4 in-block cell steps per probe, popcount slots),
// and composites each occupied cell as phase A records it: the cell's Kc
// Gaussians respond at their slab-owned peaks (t in [t_enter, t_exit)),
// are weighted front to back in (t, slot) order by the exclusive product
// over the Gaussians before them, and the cell transmittance is chained in
// slot order exactly as phase B's exclusive cumprod over a slot group
// (T_k = T_group * prod_{j<k} ct_j, then T = (T_group * E_last) * ct_last).
// After every 8 recorded cells of a round (a slot group) and at the round's
// end a ray at or below transmittance_min dies; a ray still alive after the
// last round is frozen (its sums are partial) and flagged.
//
// What the kernel cannot do: see the batch. The plain march's exit
// fractions stop phase A for the whole batch once few rays still probe, and
// above 32768 rays its later rounds resume only the first `cap` survivors.
// Here every ray gets each round's full probe budget, so a ray the plain
// march paused early meets its kill tests at other cell counts (a
// difference of at most transmittance_min times its remaining
// contributions), and a ray the plain march froze for capacity finishes.
//
// What bounds it on this card: latency of dependent loads and divergence,
// not bytes or flops. A ray reads one 16-byte block row per probe and one
// (cols x Kc) packet row per occupied cell (3 KB at Kc 32), through L1/L2;
// rays of a warp take different numbers of probes and cells. The design
// keeps it simple and right: one thread per ray (128 per block), the
// cell's alpha and peak t in a local array of Kc, the 15 sums in registers.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

#include <cuda_runtime.h>

#include "grid_common.cuh"

namespace {

using ptgs_grid::fadd;
using ptgs_grid::fmul;
using ptgs_grid::kAccKeys;
using ptgs_grid::Params;
using ptgs_grid::Ray;

constexpr int kThreads = 128;

// Composites one recorded cell (packet or geometry row `row`) entered with
// transmittance t_enter; returns the cell transmittance prod (1 - alpha)
// and, with FEAT, adds the cell's weighted features to acc.
template <bool FEAT, int KCMAX>
__device__ float composite_cell(const Ray& r, const float* row, float t0,
                                float t1, bool segment, float t_cap,
                                float t_enter, float* acc,
                                const Params& prm) {
  const int kc = prm.kc;
  float alpha[KCMAX], tpk[KCMAX];
  int idx[KCMAX];
  int n = 0;
  float ct = 1.0f;
  for (int j = 0; j < kc; ++j) {
    const ptgs_grid::Response e =
        ptgs_grid::respond(r, row, kc, j, t0, t1, segment, t_cap, prm);
    if (!(e.alpha > 0.0f)) continue;  // a factor 1 and a weight 0
    ct = fmul(ct, ptgs_grid::fsub(1.0f, e.alpha));
    alpha[n] = e.alpha;
    tpk[n] = e.t_peak;
    idx[n] = j;
    ++n;
  }
  if (FEAT) {
    const bool deg1 = prm.cols >= ptgs_grid::kPktDeg1;
    const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
    for (int i = 0; i < n; ++i) {
      // Exclusive product over the Gaussians before i in (t, slot) order.
      float excl = 1.0f;
      for (int j = 0; j < n; ++j)
        if (tpk[j] < tpk[i] || (tpk[j] == tpk[i] && idx[j] < idx[i]))
          excl = fmul(excl, ptgs_grid::fsub(1.0f, alpha[j]));
      const float w = fmul(fmul(t_enter, excl), alpha[i]);
      const int g = idx[i];
      const float* f = row + g;
      for (int ch = 0; ch < 3; ++ch) {
        float col = fadd(f[(ptgs_grid::kDc + ch) * kc], 0.5f);
        if (deg1)
          col = fadd(fadd(fadd(col, fmul(dy, f[(ptgs_grid::kBy + ch) * kc])),
                          fmul(dz, f[(ptgs_grid::kBy + 3 + ch) * kc])),
                     fmul(dx, f[(ptgs_grid::kBy + 6 + ch) * kc]));
        acc[ch] = fadd(acc[ch], fmul(w, fmaxf(col, 0.0f)));
        acc[3 + ch] = fadd(acc[3 + ch],
                           fmul(w, f[(ptgs_grid::kEmi + ch) * kc]));
      }
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
      acc[14] = fadd(acc[14], fmul(w, tpk[i]));
    }
  }
  return ct;
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

template <bool FEAT, int KCMAX>
__global__ void __launch_bounds__(kThreads) grid_march_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_end, const unsigned char* __restrict__ active,
    const int4* __restrict__ btab, const float* __restrict__ table,
    const float* __restrict__ lo, const float* __restrict__ hi,
    float* __restrict__ trans_out, float* __restrict__ acc_out,
    unsigned char* __restrict__ frozen_out, int n_rays, Params prm) {
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n_rays) return;
  const Ray r = ptgs_grid::setup_ray(origins + 3 * ray, dirs + 3 * ray, lo,
                                     hi, prm);
  const bool segment = t_end != nullptr;
  const float t_cap = segment ? t_end[ray] : 0.0f;
  const float t_far = segment ? fminf(r.t_far, t_cap) : r.t_far;
  bool alive = r.inside && (active == nullptr || active[ray] != 0);
  float acc[kAccKeys];
  for (int c = 0; c < kAccKeys; ++c) acc[c] = 0.0f;
  float trans = 1.0f;
  float t = r.t_entry;

  const int bx_n = (prm.gx + 3) / 4, by_n = (prm.gy + 3) / 4;
  const int n_blocks = bx_n * by_n * ((prm.gz + 3) / 4);
  const size_t row_len = static_cast<size_t>(prm.cols) * prm.kc;

  for (int round = 0; round < prm.n_rounds && alive; ++round) {
    Groups grp{prm.m[round], 0, 0, trans, 1.0f, 1.0f, 1.0f};
    bool dead = false;
    // Records one cell: composite it, close its group when full.
    auto take_cell = [&](int slot, float t0, float t1) {
      const float t_enter = fmul(grp.t_group, grp.e_prod);
      const float ct = composite_cell<FEAT, KCMAX>(
          r, table + static_cast<size_t>(slot) * row_len, t0, t1, segment,
          t_cap, t_enter, acc, prm);
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
      }
    };

    for (int it = 0; it < prm.a_max[round] && !dead; ++it) {
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
      const bool occ_block = info >= 0;

      // Empty block: euclidean jump, at least to the block exit.
      const float bcell[3] = {floorf(cell[0] / 4.0f), floorf(cell[1] / 4.0f),
                              floorf(cell[2] / 4.0f)};
      const float t_bex =
          fmaxf(ptgs_grid::exit_of(r, bcell, r.edge), fadd(t, r.eps));
      const float jump_w =
          fmul(static_cast<float>(-(info + 1)), prm.jump_unit);
      const float t_jump = fmaxf(t_bex, fadd(t, jump_w));

      // Occupied block: slab-test the tight box of its set cells.
      const int b = max(info, 0);
      const int bmin[3] = {b & 3, (b >> 4) & 3, (b >> 8) & 3};
      const int bmax[3] = {(b >> 2) & 3, (b >> 6) & 3, (b >> 10) & 3};
      const int bi[3] = {bx, by, bz};
      float t_in = -3.402823466e38f, t_out = 3.402823466e38f;
      for (int k = 0; k < 3; ++k) {
        const float borig =
            fadd(r.lo[k], fmul(static_cast<float>(bi[k]), r.edge[k]));
        const float box_lo =
            fadd(borig, fmul(static_cast<float>(bmin[k]), r.cell[k]));
        const float box_hi = fadd(
            borig, fmul(fadd(static_cast<float>(bmax[k]), 1.0f), r.cell[k]));
        const float tb0 = fmul(ptgs_grid::fsub(box_lo, r.o[k]), r.inv_d[k]);
        const float tb1 = fmul(ptgs_grid::fsub(box_hi, r.o[k]), r.inv_d[k]);
        t_in = fmaxf(t_in, fminf(tb0, tb1));
        t_out = fminf(t_out, fmaxf(tb0, tb1));
      }
      const float enter = fmaxf(t, t_in);
      const bool box_hit = occ_block && t_out > enter;

      // Up to 4 in-block cell steps from this one row.
      float tk = box_hit ? enter : t;
      for (int s = 0; s < 4 && !dead; ++s) {
        float ck[3];
        ptgs_grid::cell_of(r, tk, ck);
        const int jx = static_cast<int>(ck[0]), jy = static_cast<int>(ck[1]);
        const int jz = static_cast<int>(ck[2]);
        const bool same_block =
            (jx >> 2) == bx && (jy >> 2) == by && (jz >> 2) == bz;
        const bool stepk =
            box_hit && same_block && tk < t_far && tk < t_out;
        if (!stepk) continue;  // no step changes nothing
        const int rank = (jx & 3) + 4 * (jy & 3) + 16 * (jz & 3);
        const bool hi_word = rank >= 32;
        const int sh = hi_word ? rank - 32 : rank;
        const unsigned word = hi_word ? mhi : mlo;
        const bool bit = (word >> sh) & 1u;
        const unsigned below = (1u << sh) - 1u;
        const unsigned below_lo = hi_word ? mlo : (mlo & below);
        const unsigned below_hi = hi_word ? (mhi & below) : 0u;
        const int slot = base + __popc(below_lo) + __popc(below_hi);
        const float tex =
            fmaxf(ptgs_grid::exit_of(r, ck, r.cell), fadd(tk, r.eps));
        const bool take = bit && grp.n < grp.m;
        if (take) take_cell(slot, tk, tex);
        if (!bit || take) tk = tex;
      }
      if (dead) break;

      // Past the sub-box (or never in it): on to the block exit.
      const float t_occ =
          (box_hit && tk < t_out) ? tk : fmaxf(t_bex, tk);
      t = occ_block ? t_occ : t_jump;
    }
    if (!dead && grp.n > grp.g0) {  // the round's last, partial group
      trans = grp.closed();
      dead = !(trans > prm.transmittance_min);
    }
    // A ray survives the round iff it paused (traversal unfinished) and
    // its transmittance is still above transmittance_min.
    alive = !dead && t < t_far;
  }

  trans_out[ray] = trans;
  frozen_out[ray] = alive ? 1 : 0;
  if (FEAT)
    for (int c = 0; c < kAccKeys; ++c)
      acc_out[static_cast<size_t>(ray) * kAccKeys + c] = acc[c];
}

template <bool FEAT>
cudaError_t launch(const float* origins, const float* dirs,
                   const float* t_end, const unsigned char* active,
                   const int* btab, const float* table, const float* lo,
                   const float* hi, float* trans, float* acc,
                   unsigned char* frozen, int n_rays, const Params& prm,
                   cudaStream_t stream) {
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const int4* bt = reinterpret_cast<const int4*>(btab);
#define PTGS_LAUNCH(KC)                                                     \
  grid_march_kernel<FEAT, KC><<<blocks, kThreads, 0, stream>>>(             \
      origins, dirs, t_end, active, bt, table, lo, hi, trans, acc, frozen, \
      n_rays, prm)
  if (prm.kc <= 32)
    PTGS_LAUNCH(32);
  else if (prm.kc <= 64)
    PTGS_LAUNCH(64);
  else
    PTGS_LAUNCH(128);
#undef PTGS_LAUNCH
  return cudaGetLastError();
}

bool make_params(const int* sched, int n_rounds, int gx, int gy, int gz,
                 int kc, int cols, float t_min, float t_max, float alpha_min,
                 float alpha_max, float gval_cut, float transmittance_min,
                 float jump_unit, Params* prm) {
  if (n_rounds < 0 || n_rounds > ptgs_grid::kMaxRounds || kc <= 0 ||
      kc > 128 || gx <= 0 || gy <= 0 || gz <= 0)
    return false;
  *prm = Params{t_min, t_max, alpha_min, alpha_max, gval_cut,
                transmittance_min, jump_unit, gx, gy, gz, kc, cols,
                n_rounds, {}, {}};
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
// for visibility); lo, hi (3,) device floats; sched: host int pairs
// (M, a_max) per round. Out: trans (R,), acc (R, 15) (trace only), frozen
// (R,) bytes. Returns a cudaError_t.
extern "C" int ptgs_grid_trace(
    const float* origins, const float* dirs, const float* t_end,
    const unsigned char* active, const int* btab, const float* table,
    const float* lo, const float* hi, const int* sched, float* trans,
    float* acc, unsigned char* frozen, int n_rays, int n_rounds, int gx,
    int gy, int gz, int kc, int cols, float t_min, float t_max,
    float alpha_min, float alpha_max, float gval_cut,
    float transmittance_min, float jump_unit, void* stream) {
  Params prm;
  if (n_rays <= 0 || acc == nullptr ||
      !make_params(sched, n_rounds, gx, gy, gz, kc, cols, t_min, t_max,
                   alpha_min, alpha_max, gval_cut, transmittance_min,
                   jump_unit, &prm))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(
      origins, dirs, t_end, active, btab, table, lo, hi, trans, acc, frozen,
      n_rays, prm, static_cast<cudaStream_t>(stream)));
}

extern "C" int ptgs_grid_visibility(
    const float* origins, const float* dirs, const float* t_end,
    const unsigned char* active, const int* btab, const float* table,
    const float* lo, const float* hi, const int* sched, float* trans,
    float* acc, unsigned char* frozen, int n_rays, int n_rounds, int gx,
    int gy, int gz, int kc, int cols, float t_min, float t_max,
    float alpha_min, float alpha_max, float gval_cut,
    float transmittance_min, float jump_unit, void* stream) {
  Params prm;
  if (n_rays <= 0 || t_end == nullptr ||
      !make_params(sched, n_rounds, gx, gy, gz, kc, cols, t_min, t_max,
                   alpha_min, alpha_max, gval_cut, transmittance_min,
                   jump_unit, &prm))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(
      origins, dirs, t_end, active, btab, table, lo, hi, trans, acc, frozen,
      n_rays, prm, static_cast<cudaStream_t>(stream)));
}

// Backward (analytic VJP) of the fused tile composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// pathtracer_gaussiansplatting_tpu/kernels/tile_composite.py:_bwd_kernel.
// Given the forward's inputs (count, dirs, geom, feats) and the cotangents
// of its outputs (g_out (T, P, F), g_alpha (T, P), g_depth (T, P)), it
// writes d_geom (T, 16, K), d_feats (T, F, K) and, where asked, d_dirs
// (T, P, 3), with the forward's chunk schedule: slots of chunks the
// forward skipped get no gradient (the caller zero-fills d_geom and
// d_feats; rows 11-15 of d_geom stay zero).
//
// For w_k = T_k alpha_k, T_k = prod_{j<k} (1 - alpha_j), the compositing
// VJP is the suffix-sum form
//
//   d_alpha_k = d_w_k T_k
//               - (sum_{i>k} d_w_i w_i - d_alpha_acc T_last) / (1 - alpha_k)
//
// with d_w_k = g_out . feats_k + d_s t_k (d_s = g_depth / alpha_acc), and
// from d_alpha the chain through the alpha cutoffs, q(t), t = -b/a, and
// a = d^T Q d, b = d^T Q (o - mu) to the packet rows and the ray direction.
//
// What bounds it on this card: instruction issue. Per (pixel, slot) pair
// the VJP is ~230 flops with the forward's evaluation, and each slot's 25
// sums are reduced over the tile's 256 pixels; memory traffic is one read
// of the packets and one write of the gradients. The design:
//
//   * One thread block per tile, one thread per pixel (P <= 256). The
//     slots are staged as the forward stages them (tile_composite_common
//     .cuh: slot-major, 7 float4 broadcasts a pair, stages of 32 slots
//     double-buffered by cp.async).
//   * Phase 1 replays the forward in slot order with its exact arithmetic
//     and chunk skip, so it reaches the same T and the same decisions. It
//     records, per (slot, warp), whether any of the warp's pixels has
//     alpha > 0 (a ballot), and sums in double, over the slots,
//     A = sum_i (g_out . feats_i) w_i and B = sum_i t_i w_i.
//   * Phase 2 walks the same slots in the same order a second time, so T
//     before every slot is the forward's running product, and the suffix
//     sum is (A - A_k) + d_s (B - B_k) from the same double prefix sums:
//     one evaluation per pair in phase 2 (was two, and a reverse walk
//     behind a T rebuild in shared memory).
//   * A (warp, slot) with no pixel at alpha > 0 contributes exactly zero
//     to every output and to the suffix sums (w = 0, d_alpha0 = 0), so
//     phase 2 skips it: no evaluation, no VJP, no reduction.
//   * A live (warp, slot) reduces its 25 per-slot sums (d_q6 (6), d_wb
//     (3), d_c, d_opac, d_feats (F)) through a per-warp scratch in shared
//     memory: each lane stores its 25 values as 7 float4, and lane r adds
//     column r over the 32 rows into a shared-memory partial; after each
//     stage one thread per (row, slot) adds the live warps' partials in
//     warp order and writes the slot. No atomics, so the result is
//     deterministic. (A transposing shuffle butterfly over a 32-float
//     array was 4x slower: its selects between two array entries put the
//     array in local memory.)
//   * d_dirs sums terms of ~1/sigma^2 that cancel, so it runs in double,
//     and only in the DIRS instantiation (the caller asks for it where
//     dirs requires grad; training does not).
//
// Every other tile size (tile_composite_bwd_any_kernel: P not a multiple
// of 32, or above 256): one block a tile of min(P, 256) threads rounded up
// to a warp takes the pixels in groups, as the forward's any-P kernel
// does. Phase 1 runs chunk by chunk, each group in turn, with the block
// max over the whole tile, and keeps each pixel's T, depth sum, A and B in
// a (T, P, 4) double scratch between chunks and phases where the tile has
// more than one group. Phase 2 walks the run slots once a group; a warp
// votes on each slot as it goes (no per-tile list of live flags), and
// each stage's sums are added into d_geom and d_feats group after group:
// the tile's reduction in a fixed order, a block's share after another's.
// The lanes past P repeat pixel P - 1 with zero cotangents, so every
// share they add is exactly zero, and store nothing.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

#include <cuda_runtime.h>

#include "tile_composite_common.cuh"

namespace {

using ptgs::block_max;
using ptgs::kFullWarp;
using ptgs::kGeomRows;
using ptgs::kGeomUsed;
using ptgs::kMaxPixels;
using ptgs::kStage;
using ptgs::Params;

constexpr int kPartStride = kStage + 1;  // a partial row, padded
// A scratch row: one pixel's 25 per-slot values as 7 float4 (28 floats);
// the stride keeps both its float4 stores and its column reads free of
// bank conflicts.
constexpr int kRedRow = 28;

template <int F>
__device__ __forceinline__ float dot_feats(const float* go, const float* fv) {
  float s = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) s = __fmaf_rn(go[f], fv[f], s);
  return s;
}

// The partials' floats, rounded up to whole 16-byte words so that the
// scratch after them stays aligned for its float4 rows.
template <int F>
__host__ __device__ constexpr int part_floats(int n_warps) {
  return (n_warps * (kGeomUsed + F) * kPartStride + 3) / 4 * 4;
}

template <int F>
__host__ __device__ constexpr size_t smem_floats(int n_warps) {
  return 2 * kStage * ptgs::slot_floats<F>()                  // stages
         + part_floats<F>(n_warps)                            // partials
         + static_cast<size_t>(n_warps) * 32 * kRedRow;       // scratch
}

template <int F, bool DIRS>
__global__ void __launch_bounds__(kMaxPixels, DIRS ? 2 : 3)
    tile_composite_bwd_kernel(
        const float* __restrict__ count, const float* __restrict__ dirs,
        const float* __restrict__ geom, const float* __restrict__ feats,
        const float* __restrict__ g_out, const float* __restrict__ g_alpha,
        const float* __restrict__ g_depth, float* __restrict__ d_dirs,
        float* __restrict__ d_geom, float* __restrict__ d_feats, int p, int k,
        int kc, Params prm) {
  constexpr int kS = ptgs::slot_floats<F>();
  constexpr int kSums = kGeomUsed + F;  // per-slot sums: geom rows, feats
  static_assert(F == 14, "the scratch rows are written for 14 features");
  const int n_warps = p >> 5;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                          // [2][kStage * kS]
  float* s_part = smem + 2 * kStage * kS;       // [warp][kSums][kPartStride]
  float* s_red = s_part + part_floats<F>(n_warps);  // [warp][32][kRedRow]
  unsigned char* s_live = reinterpret_cast<unsigned char*>(
      smem + smem_floats<F>(n_warps));          // [K][warp]
  __shared__ float red[32];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31, warp = pix >> 5;
  const size_t px = static_cast<size_t>(tile) * p + pix;
  const ptgs::PixelDir pd = ptgs::load_dir(dirs + px * 3);
  const int n_valid = min(k, max(0, static_cast<int>(ceilf(count[tile]))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;
  float go[F];
#pragma unroll
  for (int f = 0; f < F; ++f) go[f] = g_out[px * F + f];

  // ---- phase 1 (the forward replayed): T, s_depth, A, B, live flags ----
  float trans = 1.0f, s_depth = 0.0f;
  double sum_a = 0.0, sum_b = 0.0;
  int k_run = 0;  // slots of the chunks the forward ran, under count
  ptgs::stage_async<F>(g_tile, f_tile, k, 0, min(kStage, n_valid), stage);
  for (int s0 = 0, buf = 0; s0 < n_valid; s0 += kStage, buf ^= 1) {
    if (s0 > 0 && s0 % kc == 0 &&
        !(block_max(trans, red) > prm.transmittance_min))
      break;
    ptgs::stage_async<F>(g_tile, f_tile, k, s0 + kStage,
                         min(kStage, n_valid - s0 - kStage),
                         stage + (buf ^ 1) * kStage * kS);
    ptgs::cp_async_wait<1>();
    __syncthreads();
    const float* sb = stage + buf * kStage * kS;
    const int n = min(kStage, n_valid - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const ptgs::SlotEval e =
          ptgs::eval_geom(pd, ptgs::stage_geom(sb, kS, j), prm);
      const bool live = __any_sync(kFullWarp, e.live);
      if (lane == 0) s_live[(s0 + j) * n_warps + warp] = live;
      if (live) {
        float fv[F];
        ptgs::stage_feats<F>(sb, j, fv);
        const float w = __fmul_rn(trans, e.alpha);
        trans = ptgs::trans_after(trans, e.alpha);
        s_depth = __fmaf_rn(w, e.t, s_depth);
        sum_a = fma(static_cast<double>(dot_feats<F>(go, fv)),
                    static_cast<double>(w), sum_a);
        sum_b = fma(static_cast<double>(e.t), static_cast<double>(w), sum_b);
      }
    }
    k_run = s0 + n;
    __syncthreads();  // sb is no longer read
  }
  ptgs::cp_async_wait<0>();

  const float t_last = trans;
  const float aa = 1.0f - t_last;
  const float denom = fmaxf(aa, 1e-8f);
  const float gd = g_depth[px];
  const float d_s = gd / denom;
  const float d_aa =
      g_alpha[px] + (aa > 1e-8f ? -gd * s_depth / (denom * denom) : 0.0f);
  const float d_aa_t = d_aa * t_last;  // every slot's share of alpha_acc
  const double d_s64 = d_s;

  // ---- phase 2 (slot order again): the VJP of the live (warp, slot)s ----
  float tr = 1.0f;
  double pre_a = 0.0, pre_b = 0.0;  // prefix sums of phase 1's A and B
  double ddq[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // sum d_a q6 (DIRS)
  double ddb[3] = {0.0, 0.0, 0.0};                 // sum d_b Q(o-mu)
  __syncthreads();  // phase 1's stages are no longer read
  ptgs::stage_async<F>(g_tile, f_tile, k, 0, min(kStage, k_run), stage);
  for (int s0 = 0, buf = 0; s0 < k_run; s0 += kStage, buf ^= 1) {
    ptgs::stage_async<F>(g_tile, f_tile, k, s0 + kStage,
                         min(kStage, k_run - s0 - kStage),
                         stage + (buf ^ 1) * kStage * kS);
    ptgs::cp_async_wait<1>();
    __syncthreads();  // also: the previous stage's partials are read
    const float* sb = stage + buf * kStage * kS;
    const int n = min(kStage, k_run - s0);
    for (int j = 0; j < n; ++j) {
      if (!s_live[(s0 + j) * n_warps + warp]) continue;  // uniform
      const ptgs::SlotGeom g = ptgs::stage_geom(sb, kS, j);
      const ptgs::SlotEval e = ptgs::eval_geom(pd, g, prm);
      float fv[F];
      ptgs::stage_feats<F>(sb, j, fv);
      const float t_ex = tr;
      const float w = __fmul_rn(tr, e.alpha);
      tr = ptgs::trans_after(tr, e.alpha);
      const float gf = dot_feats<F>(go, fv);
      pre_a = fma(static_cast<double>(gf), static_cast<double>(w), pre_a);
      pre_b = fma(static_cast<double>(e.t), static_cast<double>(w), pre_b);
      // sum over later slots of d_w w, from the prefix sums.
      const float carry =
          static_cast<float>((sum_a - pre_a) + d_s64 * (sum_b - pre_b));
      const float d_w = gf + d_s * e.t;
      const float d_t = d_s * w;  // depth chain
      const float d_alpha =
          d_w * t_ex - __fdividef(carry - d_aa_t, fmaxf(1.0f - e.alpha, 1e-6f));
      const bool grad_live = e.live && e.alpha0 <= prm.alpha_max;
      const float d_alpha0 = grad_live ? d_alpha : 0.0f;
      // The clamps pass the gradient at their bounds, as the plain
      // version's do. For q that matters: q = c - b^2/a cancels, and for a
      // ray through a splat's center float32 often rounds it to exactly 0
      // (the JAX kernel's q > 0 drops the term there; float64 keeps it).
      const float d_qv =
          e.qv >= 0.0f ? -0.5f * (d_alpha0 * g.opac) * e.gval : 0.0f;
      // q chain: t picks up 2(a t + b) (zero at the interior peak,
      // nonzero where t is clipped); t = -b/a only where not clipped.
      const bool t_in = e.t_raw >= prm.t_min && e.t_raw <= prm.t_max;
      const float inv_a = __fdividef(1.0f, e.a);
      const float d_t2 = d_t + d_qv * 2.0f * (e.a * e.t + e.b);
      const float d_a =
          d_qv * e.t * e.t + (t_in ? d_t2 * (e.b * inv_a * inv_a) : 0.0f);
      const float d_b = d_qv * 2.0f * e.t + (t_in ? -d_t2 * inv_a : 0.0f);
      if (DIRS) {
#pragma unroll
        for (int r = 0; r < 6; ++r)
          ddq[r] += static_cast<double>(d_a) * g.q[r];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          ddb[r] += static_cast<double>(d_b) * g.w[r];
      }

      // This pixel's share of the slot's sums, in d_geom / d_feats row
      // order: q6 (0-5), Q(o-mu) (6-8), c (9), opac (10), feats (11-),
      // as one row of the warp's scratch; lane r < kSums then adds column
      // r over the warp's 32 rows, in four interleaved chains.
      float* rw = s_red + warp * 32 * kRedRow;
      float4* row = reinterpret_cast<float4*>(rw + lane * kRedRow);
      row[0] = make_float4(pd.dd[0] * d_a, pd.dd[1] * d_a, pd.dd[2] * d_a,
                           pd.dd[3] * d_a);
      row[1] = make_float4(pd.dd[4] * d_a, pd.dd[5] * d_a, pd.dx * d_b,
                           pd.dy * d_b);
      row[2] = make_float4(pd.dz * d_b, d_qv, d_alpha0 * e.gval, go[0] * w);
      row[3] = make_float4(go[1] * w, go[2] * w, go[3] * w, go[4] * w);
      row[4] = make_float4(go[5] * w, go[6] * w, go[7] * w, go[8] * w);
      row[5] = make_float4(go[9] * w, go[10] * w, go[11] * w, go[12] * w);
      row[6] = make_float4(go[13] * w, 0.0f, 0.0f, 0.0f);
      __syncwarp();
      if (lane < kSums) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
        for (int q = 0; q < 32; q += 4) {
          a0 += rw[q * kRedRow + lane];
          a1 += rw[(q + 1) * kRedRow + lane];
          a2 += rw[(q + 2) * kRedRow + lane];
          a3 += rw[(q + 3) * kRedRow + lane];
        }
        s_part[(warp * kSums + lane) * kPartStride + j] = (a0 + a1) + (a2 + a3);
      }
      __syncwarp();  // the scratch is no longer read
    }
    __syncthreads();
    // One thread per (row, slot): add the live warps' partials in warp
    // order and write. A slot no warp reached stays zero-filled.
    for (int i = threadIdx.x; i < kSums * n; i += blockDim.x) {
      const int r = i / n, j = i % n;
      const unsigned char* lv = s_live + (s0 + j) * n_warps;
      float s = 0.0f;
      bool any = false;
      for (int wp = 0; wp < n_warps; ++wp) {
        if (!lv[wp]) continue;
        s += s_part[(wp * kSums + r) * kPartStride + j];
        any = true;
      }
      if (!any) continue;
      if (r < kGeomUsed)
        d_geom[(static_cast<size_t>(tile) * kGeomRows + r) * k + s0 + j] = s;
      else
        d_feats[(static_cast<size_t>(tile) * F + r - kGeomUsed) * k + s0 + j] =
            s;
    }
  }
  ptgs::cp_async_wait<0>();

  if (DIRS) {
    // a = sum_r dd_r q6_r and b = d . Q(o-mu): chain to the direction.
    const double dx = pd.dx, dy = pd.dy, dz = pd.dz;
    float* dd_out = d_dirs + px * 3;
    dd_out[0] = static_cast<float>(2.0 * dx * ddq[0] + dy * ddq[3] +
                                   dz * ddq[4] + ddb[0]);
    dd_out[1] = static_cast<float>(2.0 * dy * ddq[1] + dx * ddq[3] +
                                   dz * ddq[5] + ddb[1]);
    dd_out[2] = static_cast<float>(2.0 * dz * ddq[2] + dx * ddq[4] +
                                   dy * ddq[5] + ddb[2]);
  }
}

// The any-P backward: see the top of this file. scratch is (T, P, 4)
// double where the tile has more than one group (null otherwise).
template <int F, bool DIRS>
__global__ void __launch_bounds__(kMaxPixels, DIRS ? 2 : 3)
    tile_composite_bwd_any_kernel(
        const float* __restrict__ count, const float* __restrict__ dirs,
        const float* __restrict__ geom, const float* __restrict__ feats,
        const float* __restrict__ g_out, const float* __restrict__ g_alpha,
        const float* __restrict__ g_depth, float* __restrict__ d_dirs,
        float* __restrict__ d_geom, float* __restrict__ d_feats,
        double* __restrict__ scratch, int p, int k, int kc, Params prm) {
  constexpr int kS = ptgs::slot_floats<F>();
  constexpr int kSums = kGeomUsed + F;
  static_assert(F == 14, "the scratch rows are written for 14 features");
  const int n_warps = blockDim.x >> 5;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                          // [2][kStage * kS]
  float* s_part = smem + 2 * kStage * kS;       // [warp][kSums][kPartStride]
  float* s_red = s_part + part_floats<F>(n_warps);  // [warp][32][kRedRow]
  unsigned char* s_live = reinterpret_cast<unsigned char*>(
      smem + smem_floats<F>(n_warps));          // [kStage][warp]
  __shared__ float red[32];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_groups = (p + blockDim.x - 1) / blockDim.x;
  const bool multi = n_groups > 1;
  const int n_valid = min(k, max(0, static_cast<int>(ceilf(count[tile]))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;

  // ---- phase 1 (the forward replayed, chunk by chunk, group by group) ----
  float trans = 1.0f, s_depth = 0.0f;
  double sum_a = 0.0, sum_b = 0.0;
  int k_run = 0;
  float t_hi = 1.0f;
  for (int c0 = 0; c0 < n_valid; c0 += kc) {
    if (c0 > 0 && !(block_max(t_hi, red) > prm.transmittance_min)) break;
    const int n = min(kc, n_valid - c0);
    float t_next = 0.0f;
    for (int g = 0; g < n_groups; ++g) {
      const int pix = g * blockDim.x + threadIdx.x;
      const bool real = pix < p;
      const size_t px = static_cast<size_t>(tile) * p + min(pix, p - 1);
      const ptgs::PixelDir pd = ptgs::load_dir(dirs + px * 3);
      float go[F];
#pragma unroll
      for (int f = 0; f < F; ++f) go[f] = real ? g_out[px * F + f] : 0.0f;
      if (multi && c0 > 0) {
        const double* st = scratch + px * 4;
        trans = static_cast<float>(st[0]);
        s_depth = static_cast<float>(st[1]);
        sum_a = st[2];
        sum_b = st[3];
      } else if (multi) {
        trans = 1.0f;
        s_depth = 0.0f;
        sum_a = sum_b = 0.0;
      }
      ptgs::stage_loop<F, false>(
          g_tile + c0, f_tile + c0, k, kc, n, prm.transmittance_min,
          reinterpret_cast<float(*)[kStage * kS]>(stage), red, trans,
          [&](const float* sb, int, int m) {
#pragma unroll 4
            for (int j = 0; j < m; ++j) {
              const ptgs::SlotEval e =
                  ptgs::eval_geom(pd, ptgs::stage_geom(sb, kS, j), prm);
              if (__any_sync(kFullWarp, e.live)) {
                float fv[F];
                ptgs::stage_feats<F>(sb, j, fv);
                const float w = __fmul_rn(trans, e.alpha);
                trans = ptgs::trans_after(trans, e.alpha);
                s_depth = __fmaf_rn(w, e.t, s_depth);
                sum_a = fma(static_cast<double>(dot_feats<F>(go, fv)),
                            static_cast<double>(w), sum_a);
                sum_b = fma(static_cast<double>(e.t), static_cast<double>(w),
                            sum_b);
              }
            }
          });
      t_next = fmaxf(t_next, trans);
      if (multi && real) {
        double* st = scratch + px * 4;
        st[0] = trans;
        st[1] = s_depth;
        st[2] = sum_a;
        st[3] = sum_b;
      }
    }
    t_hi = t_next;
    k_run = c0 + n;
  }

  // ---- phase 2 (slot order again, a group at a time) ---------------------
  for (int g = 0; g < n_groups; ++g) {
    const int pix = g * blockDim.x + threadIdx.x;
    const bool real = pix < p;
    const size_t px = static_cast<size_t>(tile) * p + min(pix, p - 1);
    const ptgs::PixelDir pd = ptgs::load_dir(dirs + px * 3);
    float go[F];
#pragma unroll
    for (int f = 0; f < F; ++f) go[f] = real ? g_out[px * F + f] : 0.0f;
    if (multi && k_run > 0) {
      const double* st = scratch + px * 4;
      trans = static_cast<float>(st[0]);
      s_depth = static_cast<float>(st[1]);
      sum_a = st[2];
      sum_b = st[3];
    }
    if (!real) sum_a = sum_b = 0.0;  // multi: pixel P - 1's, not this lane's
    const float t_last = trans;
    const float aa = 1.0f - t_last;
    const float denom = fmaxf(aa, 1e-8f);
    const float gd = real ? g_depth[px] : 0.0f;
    const float d_s = gd / denom;
    const float d_aa = (real ? g_alpha[px] : 0.0f) +
                       (aa > 1e-8f ? -gd * s_depth / (denom * denom) : 0.0f);
    const float d_aa_t = d_aa * t_last;
    const double d_s64 = d_s;

    float tr = 1.0f;
    double pre_a = 0.0, pre_b = 0.0;
    double ddq[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    double ddb[3] = {0.0, 0.0, 0.0};
    __syncthreads();  // the previous stages are no longer read
    ptgs::stage_async<F>(g_tile, f_tile, k, 0, min(kStage, k_run), stage);
    for (int s0 = 0, buf = 0; s0 < k_run; s0 += kStage, buf ^= 1) {
      ptgs::stage_async<F>(g_tile, f_tile, k, s0 + kStage,
                           min(kStage, k_run - s0 - kStage),
                           stage + (buf ^ 1) * kStage * kS);
      ptgs::cp_async_wait<1>();
      __syncthreads();  // also: the previous stage's partials are read
      const float* sb = stage + buf * kStage * kS;
      const int n = min(kStage, k_run - s0);
      for (int j = 0; j < n; ++j) {
        const ptgs::SlotGeom gm = ptgs::stage_geom(sb, kS, j);
        const ptgs::SlotEval e = ptgs::eval_geom(pd, gm, prm);
        const bool live = __any_sync(kFullWarp, e.live);
        if (lane == 0) s_live[j * n_warps + warp] = live;
        if (!live) continue;  // uniform over the warp
        float fv[F];
        ptgs::stage_feats<F>(sb, j, fv);
        const float t_ex = tr;
        const float w = __fmul_rn(tr, e.alpha);
        tr = ptgs::trans_after(tr, e.alpha);
        const float gf = dot_feats<F>(go, fv);
        pre_a = fma(static_cast<double>(gf), static_cast<double>(w), pre_a);
        pre_b = fma(static_cast<double>(e.t), static_cast<double>(w), pre_b);
        const float carry =
            static_cast<float>((sum_a - pre_a) + d_s64 * (sum_b - pre_b));
        const float d_w = gf + d_s * e.t;
        const float d_t = d_s * w;
        const float d_alpha =
            d_w * t_ex -
            __fdividef(carry - d_aa_t, fmaxf(1.0f - e.alpha, 1e-6f));
        const bool grad_live = e.live && e.alpha0 <= prm.alpha_max;
        const float d_alpha0 = grad_live ? d_alpha : 0.0f;
        const float d_qv =
            e.qv >= 0.0f ? -0.5f * (d_alpha0 * gm.opac) * e.gval : 0.0f;
        const bool t_in = e.t_raw >= prm.t_min && e.t_raw <= prm.t_max;
        const float inv_a = __fdividef(1.0f, e.a);
        const float d_t2 = d_t + d_qv * 2.0f * (e.a * e.t + e.b);
        const float d_a =
            d_qv * e.t * e.t + (t_in ? d_t2 * (e.b * inv_a * inv_a) : 0.0f);
        const float d_b = d_qv * 2.0f * e.t + (t_in ? -d_t2 * inv_a : 0.0f);
        if (DIRS) {
#pragma unroll
          for (int r = 0; r < 6; ++r)
            ddq[r] += static_cast<double>(d_a) * gm.q[r];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            ddb[r] += static_cast<double>(d_b) * gm.w[r];
        }
        float* rw = s_red + warp * 32 * kRedRow;
        float4* row = reinterpret_cast<float4*>(rw + lane * kRedRow);
        row[0] = make_float4(pd.dd[0] * d_a, pd.dd[1] * d_a, pd.dd[2] * d_a,
                             pd.dd[3] * d_a);
        row[1] = make_float4(pd.dd[4] * d_a, pd.dd[5] * d_a, pd.dx * d_b,
                             pd.dy * d_b);
        row[2] = make_float4(pd.dz * d_b, d_qv, d_alpha0 * e.gval, go[0] * w);
        row[3] = make_float4(go[1] * w, go[2] * w, go[3] * w, go[4] * w);
        row[4] = make_float4(go[5] * w, go[6] * w, go[7] * w, go[8] * w);
        row[5] = make_float4(go[9] * w, go[10] * w, go[11] * w, go[12] * w);
        row[6] = make_float4(go[13] * w, 0.0f, 0.0f, 0.0f);
        __syncwarp();
        if (lane < kSums) {
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
          for (int q = 0; q < 32; q += 4) {
            a0 += rw[q * kRedRow + lane];
            a1 += rw[(q + 1) * kRedRow + lane];
            a2 += rw[(q + 2) * kRedRow + lane];
            a3 += rw[(q + 3) * kRedRow + lane];
          }
          s_part[(warp * kSums + lane) * kPartStride + j] =
              (a0 + a1) + (a2 + a3);
        }
        __syncwarp();
      }
      __syncthreads();
      // One thread per (row, slot): this group's live warps' partials in
      // warp order, added to what the earlier groups wrote.
      for (int i = threadIdx.x; i < kSums * n; i += blockDim.x) {
        const int r = i / n, j = i % n;
        const unsigned char* lv = s_live + j * n_warps;
        float sum = 0.0f;
        bool any = false;
        for (int wp = 0; wp < n_warps; ++wp) {
          if (!lv[wp]) continue;
          sum += s_part[(wp * kSums + r) * kPartStride + j];
          any = true;
        }
        if (!any) continue;
        float* dst =
            r < kGeomUsed
                ? d_geom + (static_cast<size_t>(tile) * kGeomRows + r) * k +
                      s0 + j
                : d_feats +
                      (static_cast<size_t>(tile) * F + r - kGeomUsed) * k +
                      s0 + j;
        *dst = g == 0 ? sum : *dst + sum;
      }
    }
    ptgs::cp_async_wait<0>();

    if (DIRS && real) {
      const double dx = pd.dx, dy = pd.dy, dz = pd.dz;
      float* dd_out = d_dirs + px * 3;
      dd_out[0] = static_cast<float>(2.0 * dx * ddq[0] + dy * ddq[3] +
                                     dz * ddq[4] + ddb[0]);
      dd_out[1] = static_cast<float>(2.0 * dy * ddq[1] + dx * ddq[3] +
                                     dz * ddq[5] + ddb[1]);
      dd_out[2] = static_cast<float>(2.0 * dz * ddq[2] + dx * ddq[4] +
                                     dy * ddq[5] + ddb[2]);
    }
  }
}

template <int F, bool DIRS>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, const float* g_out,
                   const float* g_alpha, const float* g_depth, float* d_dirs,
                   float* d_geom, float* d_feats, double* scratch,
                   int n_tiles, int p, int k, int kc, Params prm,
                   cudaStream_t stream) {
  if (p % 32 == 0 && p <= kMaxPixels) {
    const size_t smem = sizeof(float) * smem_floats<F>(p / 32)
                        + static_cast<size_t>(k) * (p / 32);
    if (smem > 40 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          tile_composite_bwd_kernel<F, DIRS>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    tile_composite_bwd_kernel<F, DIRS><<<n_tiles, p, smem, stream>>>(
        count, dirs, geom, feats, g_out, g_alpha, g_depth, d_dirs, d_geom,
        d_feats, p, k, kc, prm);
    return cudaGetLastError();
  }
  const int threads = min(kMaxPixels, (p + 31) / 32 * 32);
  if (p > threads && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats<F>(threads / 32)
                      + static_cast<size_t>(kStage) * (threads / 32);
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_composite_bwd_any_kernel<F, DIRS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  tile_composite_bwd_any_kernel<F, DIRS><<<n_tiles, threads, smem, stream>>>(
      count, dirs, geom, feats, g_out, g_alpha, g_depth, d_dirs, d_geom,
      d_feats, scratch, p, k, kc, prm);
  return cudaGetLastError();
}

}  // namespace

// count (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, F, K),
// g_out (T, P, F), g_alpha (T, P), g_depth (T, P) in; d_geom (T, 16, K),
// d_feats (T, F, K) out, zero-filled by the caller, and d_dirs (T, P, 3)
// out where want_dirs is nonzero (NULL allowed otherwise); all float32,
// contiguous; scratch (T, P, 4) double for P above 256 (NULL allowed
// otherwise). P a multiple of 32 up to 256 launches the 16x16 kernel, any
// other P the any-P kernel. kc must divide K and be K or a multiple of 32,
// and F must be 14 (the packet features). Returns a cudaError_t.
extern "C" int ptgs_tile_composite_bwd(
    const float* count, const float* dirs, const float* geom,
    const float* feats, const float* g_out, const float* g_alpha,
    const float* g_depth, float* d_dirs, float* d_geom, float* d_feats,
    double* scratch, int n_tiles, int p, int k, int f, int kc, int want_dirs,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, float transmittance_min, void* stream) {
  if (n_tiles <= 0 || p <= 0 || kc <= 0 || k % kc != 0 ||
      (kc != k && kc % kStage != 0) ||
      (want_dirs && d_dirs == nullptr) || f != 14)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{t_min, t_max, alpha_min, alpha_max, gval_cut,
                   transmittance_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      want_dirs ? launch<14, true>(count, dirs, geom, feats, g_out, g_alpha,
                                   g_depth, d_dirs, d_geom, d_feats, scratch,
                                   n_tiles, p, k, kc, prm, s)
                : launch<14, false>(count, dirs, geom, feats, g_out, g_alpha,
                                    g_depth, d_dirs, d_geom, d_feats, scratch,
                                    n_tiles, p, k, kc, prm, s));
}

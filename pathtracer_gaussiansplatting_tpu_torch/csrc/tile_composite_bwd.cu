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
// Every other tile size up to 2048 pixels
// (tile_composite_bwd_cluster_kernel: P not a multiple of 32, or above
// 256): one thread-block cluster a tile of G = ceil(P / 256) CTAs, CTA r
// holding pixels [256 r, 256 r + 256) (any_p_plan in
// tile_composite_common.cuh). Each CTA runs phases 1 and 2 as the one-block
// kernel does, with its pixels' state in registers and its own per-(slot,
// warp) live flags; the chunk skip takes the max of T over the cluster
// (cluster_max). After each stage of phase 2, each CTA leaves its sums of
// the stage's 25 x 32 (row, slot) values in shared memory (its live warps'
// partials in warp order) and, after a cluster barrier, the pairs are split
// over the CTAs: each owner reads the CTAs' sums through distributed
// shared memory in rank order, adds them and writes d_geom / d_feats once.
// The order of additions is the group-loop kernel's, so the gradients are
// its bits; no float atomics. The lanes past P repeat pixel P - 1 with
// zero cotangents and store nothing; a warp of such lanes alone skips the
// slot work and counts as not live (its share would be exactly +0). A
// cluster of one CTA (P up to 256) takes no cluster barrier and no group
// sums: it writes its sums as the one-block kernel does.
//
// Above 2048 pixels (tile_composite_bwd_group_kernel): one block of 256
// threads a tile takes the pixels in groups. Phase 1 runs chunk by chunk,
// each group in turn, with the block max over the whole tile, and keeps
// each pixel's T, depth sum, A and B in a (T, P, 4) double scratch between
// chunks and phases. Phase 2 walks the run slots once a group; a warp
// votes on each slot as it goes, and each stage's sums are added into
// d_geom and d_feats group after group: the tile's reduction in a fixed
// order, a group's share after another's.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

#include <cooperative_groups.h>
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

// ---- phase 2's step, shared by the cluster and group-loop kernels --------
//
// The one-block kernel above spells out the same code.

// A pixel's phase-2 state: T before the next live slot, the prefix sums of
// phase 1's A and B, the depth and alpha_acc chains, and d_dirs' sums.
struct Phase2 {
  float tr, d_s, d_aa_t;
  double sum_a, sum_b, pre_a, pre_b, d_s64;
  double ddq[6], ddb[3];
};

// Phase 2's start from phase 1's T, depth sum, A and B and the pixel's
// alpha_acc and depth cotangents.
__device__ __forceinline__ Phase2 phase2_start(float t_last, float s_depth,
                                               double sum_a, double sum_b,
                                               float g_alpha, float gd) {
  Phase2 st;
  const float aa = 1.0f - t_last;
  const float denom = fmaxf(aa, 1e-8f);
  st.d_s = gd / denom;
  const float d_aa =
      g_alpha + (aa > 1e-8f ? -gd * s_depth / (denom * denom) : 0.0f);
  st.d_aa_t = d_aa * t_last;  // every slot's share of alpha_acc
  st.d_s64 = st.d_s;
  st.tr = 1.0f;
  st.sum_a = sum_a;
  st.sum_b = sum_b;
  st.pre_a = st.pre_b = 0.0;
#pragma unroll
  for (int r = 0; r < 6; ++r) st.ddq[r] = 0.0;
#pragma unroll
  for (int r = 0; r < 3; ++r) st.ddb[r] = 0.0;
  return st;
}

// The VJP of one live (pixel, slot) pair with geometry g and evaluation e,
// slot j of the stage sb: advances st, and leaves the warp's 25 per-slot
// sums of slot j in part[r * kPartStride] (r < 25, the d_geom / d_feats
// row order) through the warp's scratch rw. Every lane of the warp calls
// it.
template <int F, bool DIRS>
__device__ __forceinline__ void phase2_pair(
    const ptgs::PixelDir& pd, const ptgs::SlotGeom& g,
    const ptgs::SlotEval& e, const float* sb, int j, const float* go,
    const Params& prm, Phase2& st, float* rw, int lane, float* part) {
  constexpr int kSums = kGeomUsed + F;
  float fv[F];
  ptgs::stage_feats<F>(sb, j, fv);
  const float t_ex = st.tr;
  const float w = __fmul_rn(st.tr, e.alpha);
  st.tr = ptgs::trans_after(st.tr, e.alpha);
  const float gf = dot_feats<F>(go, fv);
  st.pre_a = fma(static_cast<double>(gf), static_cast<double>(w), st.pre_a);
  st.pre_b = fma(static_cast<double>(e.t), static_cast<double>(w), st.pre_b);
  // sum over later slots of d_w w, from the prefix sums.
  const float carry = static_cast<float>((st.sum_a - st.pre_a) +
                                         st.d_s64 * (st.sum_b - st.pre_b));
  const float d_w = gf + st.d_s * e.t;
  const float d_t = st.d_s * w;  // depth chain
  const float d_alpha =
      d_w * t_ex -
      __fdividef(carry - st.d_aa_t, fmaxf(1.0f - e.alpha, 1e-6f));
  const bool grad_live = e.live && e.alpha0 <= prm.alpha_max;
  const float d_alpha0 = grad_live ? d_alpha : 0.0f;
  const float d_qv =
      e.qv >= 0.0f ? -0.5f * (d_alpha0 * g.opac) * e.gval : 0.0f;
  const bool t_in = e.t_raw >= prm.t_min && e.t_raw <= prm.t_max;
  const float inv_a = __fdividef(1.0f, e.a);
  const float d_t2 = d_t + d_qv * 2.0f * (e.a * e.t + e.b);
  const float d_a =
      d_qv * e.t * e.t + (t_in ? d_t2 * (e.b * inv_a * inv_a) : 0.0f);
  const float d_b = d_qv * 2.0f * e.t + (t_in ? -d_t2 * inv_a : 0.0f);
  if (DIRS) {
#pragma unroll
    for (int r = 0; r < 6; ++r)
      st.ddq[r] += static_cast<double>(d_a) * g.q[r];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      st.ddb[r] += static_cast<double>(d_b) * g.w[r];
  }
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
    part[lane * kPartStride] = (a0 + a1) + (a2 + a3);
  }
  __syncwarp();  // the scratch is no longer read
}

// a = sum_r dd_r q6_r and b = d . Q(o-mu): d_dirs from phase 2's sums.
__device__ __forceinline__ void store_d_dirs(const ptgs::PixelDir& pd,
                                             const Phase2& st, float* out) {
  const double dx = pd.dx, dy = pd.dy, dz = pd.dz;
  out[0] = static_cast<float>(2.0 * dx * st.ddq[0] + dy * st.ddq[3] +
                              dz * st.ddq[4] + st.ddb[0]);
  out[1] = static_cast<float>(2.0 * dy * st.ddq[1] + dx * st.ddq[3] +
                              dz * st.ddq[5] + st.ddb[1]);
  out[2] = static_cast<float>(2.0 * dz * st.ddq[2] + dx * st.ddq[4] +
                              dy * st.ddq[5] + st.ddb[2]);
}

// The cluster kernel's shared memory: the one-block kernel's (its live
// flags rounded up to 16 bytes), and for a cluster of more than one CTA
// each stage's group sums and their flags, by stage parity.
template <int F>
__host__ __device__ constexpr int group_sums(int g) {
  return g > 1 ? 2 * (kGeomUsed + F) * kStage : 0;
}

__host__ __device__ constexpr size_t live_bytes(int n_warps, int k) {
  return (static_cast<size_t>(k) * n_warps + 15) / 16 * 16;
}

template <int F>
__host__ __device__ constexpr size_t cluster_smem_bytes(int n_warps, int k,
                                                        int g) {
  return sizeof(float) * smem_floats<F>(n_warps) + live_bytes(n_warps, k)
         + (sizeof(float) + 1) * group_sums<F>(g);
}

// The cluster backward: see the top of this file. Launched with a cluster
// of G CTAs along x, G CTAs a tile.
template <int F, bool DIRS>
__global__ void __launch_bounds__(kMaxPixels, DIRS ? 2 : 3)
    tile_composite_bwd_cluster_kernel(
        const float* __restrict__ count, const float* __restrict__ dirs,
        const float* __restrict__ geom, const float* __restrict__ feats,
        const float* __restrict__ g_out, const float* __restrict__ g_alpha,
        const float* __restrict__ g_depth, float* __restrict__ d_dirs,
        float* __restrict__ d_geom, float* __restrict__ d_feats, int p, int k,
        int kc, Params prm) {
  constexpr int kS = ptgs::slot_floats<F>();
  constexpr int kSums = kGeomUsed + F;
  static_assert(F == 14, "the scratch rows are written for 14 features");
  const int n_warps = blockDim.x >> 5;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                          // [2][kStage * kS]
  float* s_part = smem + 2 * kStage * kS;       // [warp][kSums][kPartStride]
  float* s_red = s_part + part_floats<F>(n_warps);  // [warp][32][kRedRow]
  unsigned char* s_live = reinterpret_cast<unsigned char*>(
      smem + smem_floats<F>(n_warps));          // [K][warp]
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int n_ctas = cluster.num_blocks();
  float* s_gsum = reinterpret_cast<float*>(
      s_live + live_bytes(n_warps, k));         // [2][kSums * kStage]
  unsigned char* s_gany = reinterpret_cast<unsigned char*>(
      s_gsum + group_sums<F>(n_ctas));          // [2][kSums * kStage]
  __shared__ float red[32];
  __shared__ float t_slot[2];  // this CTA's max of T, by chunk parity

  const int rank = cluster.block_rank();
  const int tile = blockIdx.x / n_ctas;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pix = rank * blockDim.x + threadIdx.x;
  const bool real = pix < p;
  const bool warp_real = pix - lane < p;
  const size_t px = static_cast<size_t>(tile) * p + min(pix, p - 1);
  const ptgs::PixelDir pd = ptgs::load_dir(dirs + px * 3);
  const int n_valid = min(k, max(0, static_cast<int>(ceilf(count[tile]))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;
  float go[F];
#pragma unroll
  for (int f = 0; f < F; ++f) go[f] = real ? g_out[px * F + f] : 0.0f;

  // ---- phase 1 (the forward replayed): T, s_depth, A, B, live flags ----
  float trans = 1.0f, s_depth = 0.0f;
  double sum_a = 0.0, sum_b = 0.0;
  int k_run = 0;  // slots of the chunks the forward ran, under count
  ptgs::stage_async<F>(g_tile, f_tile, k, 0, min(kStage, n_valid), stage);
  for (int s0 = 0, buf = 0; s0 < n_valid; s0 += kStage, buf ^= 1) {
    if (s0 > 0 && s0 % kc == 0 &&
        !(ptgs::cluster_max(real ? trans : 0.0f, red, t_slot,
                            (s0 / kc) & 1) > prm.transmittance_min))
      break;
    ptgs::stage_async<F>(g_tile, f_tile, k, s0 + kStage,
                         min(kStage, n_valid - s0 - kStage),
                         stage + (buf ^ 1) * kStage * kS);
    ptgs::cp_async_wait<1>();
    __syncthreads();
    const float* sb = stage + buf * kStage * kS;
    const int n = min(kStage, n_valid - s0);
    if (!warp_real) {  // no pixel: no slot work, and no live flag
      if (lane == 0)
        for (int j = 0; j < n; ++j) s_live[(s0 + j) * n_warps + warp] = 0;
    } else {
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
          sum_b =
              fma(static_cast<double>(e.t), static_cast<double>(w), sum_b);
        }
      }
    }
    k_run = s0 + n;
    __syncthreads();  // sb is no longer read
  }
  ptgs::cp_async_wait<0>();

  // ---- phase 2 (slot order again): the VJP of the live (warp, slot)s ----
  if (!real) sum_a = sum_b = 0.0;
  Phase2 st = phase2_start(trans, s_depth, sum_a, sum_b,
                           real ? g_alpha[px] : 0.0f,
                           real ? g_depth[px] : 0.0f);
  float* rw = s_red + warp * 32 * kRedRow;
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
      phase2_pair<F, DIRS>(pd, g, ptgs::eval_geom(pd, g, prm), sb, j, go,
                           prm, st, rw, lane,
                           s_part + warp * kSums * kPartStride + j);
    }
    __syncthreads();
    // Pair i of the stage, (row r, slot j), in d_geom / d_feats.
    const auto dst = [&](int i) {
      const int r = i / n, j = i % n;
      return r < kGeomUsed
                 ? d_geom + (static_cast<size_t>(tile) * kGeomRows + r) * k +
                       s0 + j
                 : d_feats + (static_cast<size_t>(tile) * F + r - kGeomUsed) *
                                 k + s0 + j;
    };
    // This CTA's sums: one thread per (row, slot) adds the live warps'
    // partials in warp order, with a flag for "some warp was live". A
    // cluster of one CTA writes them; a slot no warp reached stays
    // zero-filled.
    float* gsum = s_gsum + buf * kSums * kStage;
    unsigned char* gany = s_gany + buf * kSums * kStage;
    for (int i = threadIdx.x; i < kSums * n; i += blockDim.x) {
      const int r = i / n, j = i % n;
      const unsigned char* lv = s_live + (s0 + j) * n_warps;
      float sum = 0.0f;
      bool any = false;
      for (int wp = 0; wp < n_warps; ++wp) {
        if (!lv[wp]) continue;
        sum += s_part[(wp * kSums + r) * kPartStride + j];
        any = true;
      }
      if (n_ctas == 1) {
        if (any) *dst(i) = sum;
      } else {
        gsum[i] = sum;
        gany[i] = any;
      }
    }
    if (n_ctas == 1) continue;
    // The tile's sums: the (row, slot) pairs split over the CTAs, each
    // owner adding the CTAs' sums in rank order (the group-loop kernel's
    // order over its groups) and writing once. gsum is double-buffered: a
    // CTA refills this buffer two stages on, past the next stage's
    // barrier, which every CTA reaches after its reads here.
    cluster.sync();
    for (int i = rank * blockDim.x + threadIdx.x; i < kSums * n;
         i += n_ctas * blockDim.x) {
      float v = 0.0f;
      bool wrote = false;
      for (int c = 0; c < n_ctas; ++c) {
        if (!*cluster.map_shared_rank(gany + i, c)) continue;
        const float sum = *cluster.map_shared_rank(gsum + i, c);
        v = c == 0 ? sum : v + sum;
        wrote = true;
      }
      if (wrote) *dst(i) = v;
    }
  }
  ptgs::cp_async_wait<0>();
  // No CTA leaves while another may still read its sums.
  if (n_ctas > 1) cluster.sync();

  if (DIRS && real) store_d_dirs(pd, st, d_dirs + px * 3);
}

// The group-loop backward (above 2048 pixels): see the top of this file.
// scratch is (T, P, 4) double.
template <int F, bool DIRS>
__global__ void __launch_bounds__(kMaxPixels, DIRS ? 2 : 3)
    tile_composite_bwd_group_kernel(
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
    Phase2 st = phase2_start(trans, s_depth, sum_a, sum_b,
                             real ? g_alpha[px] : 0.0f,
                             real ? g_depth[px] : 0.0f);
    float* rw = s_red + warp * 32 * kRedRow;
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
        phase2_pair<F, DIRS>(pd, gm, e, sb, j, go, prm, st, rw, lane,
                             s_part + warp * kSums * kPartStride + j);
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

    if (DIRS && real) store_d_dirs(pd, st, d_dirs + px * 3);
  }
}

// Sets the dynamic shared memory a kernel may take where it is above the
// default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int F, bool DIRS>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, const float* g_out,
                   const float* g_alpha, const float* g_depth, float* d_dirs,
                   float* d_geom, float* d_feats, double* scratch,
                   int n_tiles, int p, int k, int kc, Params prm,
                   cudaStream_t stream) {
  const ptgs::Plan plan = ptgs::any_p_plan(p);
  if (plan.path == ptgs::kOneBlock) {
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
  cudaError_t e;
  const int n_warps = plan.threads / 32;
  if (plan.path == ptgs::kGroupLoop) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * smem_floats<F>(n_warps)
                        + static_cast<size_t>(kStage) * n_warps;
    e = allow_smem(tile_composite_bwd_group_kernel<F, DIRS>, smem);
    if (e != cudaSuccess) return e;
    tile_composite_bwd_group_kernel<F, DIRS>
        <<<n_tiles, plan.threads, smem, stream>>>(
            count, dirs, geom, feats, g_out, g_alpha, g_depth, d_dirs, d_geom,
            d_feats, scratch, p, k, kc, prm);
    return cudaGetLastError();
  }
  const size_t smem = cluster_smem_bytes<F>(n_warps, k, plan.g);
  e = allow_smem(tile_composite_bwd_cluster_kernel<F, DIRS>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ptgs::cluster_config(cfg, attr, n_tiles, plan, smem, stream);
  e = cudaLaunchKernelEx(&cfg, tile_composite_bwd_cluster_kernel<F, DIRS>,
                         count, dirs, geom, feats, g_out, g_alpha, g_depth,
                         d_dirs, d_geom, d_feats, p, k, kc, prm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool DIRS>
cudaError_t bwd_max_clusters(ptgs::Plan plan, int k, int* n,
                             int* smem_bytes) {
  const size_t smem = cluster_smem_bytes<14>(plan.threads / 32, k, plan.g);
  *smem_bytes = static_cast<int>(smem);
  const cudaError_t e =
      allow_smem(tile_composite_bwd_cluster_kernel<14, DIRS>, smem);
  if (e != cudaSuccess) return e;
  return ptgs::max_clusters(tile_composite_bwd_cluster_kernel<14, DIRS>,
                            plan, smem, n);
}

}  // namespace

// count (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, F, K),
// g_out (T, P, F), g_alpha (T, P), g_depth (T, P) in; d_geom (T, 16, K),
// d_feats (T, F, K) out, zero-filled by the caller, and d_dirs (T, P, 3)
// out where want_dirs is nonzero (NULL allowed otherwise); all float32,
// contiguous; scratch (T, P, 4) double for the group-loop kernel (NULL
// allowed otherwise). path, g and threads must be any_p_plan(P)'s: the
// one-block kernel (P a multiple of 32 up to 256), the cluster kernel (up
// to 2048 pixels) or the group-loop kernel. kc must divide K and be K or a
// multiple of 32, and F must be 14 (the packet features). Returns a
// cudaError_t.
extern "C" int ptgs_tile_composite_bwd(
    const float* count, const float* dirs, const float* geom,
    const float* feats, const float* g_out, const float* g_alpha,
    const float* g_depth, float* d_dirs, float* d_geom, float* d_feats,
    double* scratch, int n_tiles, int p, int k, int f, int kc, int want_dirs,
    int path, int g, int threads, float t_min, float t_max, float alpha_min,
    float alpha_max, float gval_cut, float transmittance_min, void* stream) {
  if (n_tiles <= 0 || p <= 0 || kc <= 0 || k % kc != 0 ||
      (kc != k && kc % kStage != 0) ||
      (want_dirs && d_dirs == nullptr) || f != 14 ||
      !ptgs::plan_is(p, path, g, threads))
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

// How many clusters of the backward's cluster kernel (with d_dirs where
// want_dirs is nonzero) the card can hold at once for a tile of P pixels
// and K slots (cudaOccupancyMaxActiveClusters), into *clusters, and a
// CTA's dynamic shared memory into *smem_bytes; with g > 0, for clusters
// of g CTAs instead of any_p_plan(P)'s (above 8, non-portable). Returns a
// cudaError_t (cudaErrorInvalidValue where P takes no cluster).
extern "C" int ptgs_tile_composite_bwd_clusters(int p, int k, int want_dirs,
                                                int g, int* clusters,
                                                int* smem_bytes) {
  ptgs::Plan plan = ptgs::any_p_plan(p);
  if (plan.path != ptgs::kCluster || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0) plan.g = g;
  return static_cast<int>(
      want_dirs ? bwd_max_clusters<true>(plan, k, clusters, smem_bytes)
                : bwd_max_clusters<false>(plan, k, clusters, smem_bytes));
}

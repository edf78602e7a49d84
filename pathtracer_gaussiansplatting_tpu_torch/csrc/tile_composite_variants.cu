// Ablation harness of the forward tile composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// benchmarks/variant_kernel.py:_variant_kernel: the forward kernel
// (tile_composite_fwd.cu, pathtracer_gaussiansplatting_tpu/kernels/
// tile_composite.py:_fwd_kernel) with single stages removed or re-lowered,
// timed to show where the forward's time goes. One kernel template, one
// instantiation per mode (the Mode enum, in the order of
// kernels/tile_composite_variants.MODES), one C entry point.
//
// Every mode runs on the forward's pipeline, the header's stage_loop: one
// block per tile (2 or 4 for skel16 / skel32), one thread per pixel,
// slots [0, count) in stages of kStage = 32 staged slot-major by cp.async
// into a double buffer, one __syncthreads a stage, the transmittance test
// at each chunk of kc slots after the first. Before its composite step a
// warp votes (__any_sync) and skips a slot where none of its pixels has
// alpha > 0 (the modes that call eval_geom vote on its live flag, as the
// forward does): alpha = 0 gives w = 0, T (1 - 0) = T and fma(0, x, s) = s,
// so the vote changes no bit. Modes:
//
//   full      the forward's code itself (the header's forward_tile):
//             bit-equal to tile_composite_fwd
//   hoist     as full: each thread already holds its pixel's direction
//             monomials in registers, so the TPU's pre-broadcast has no
//             counterpart; kept and timed for the table
//   onechunk  full with kc = K: no transmittance test
//   noif      full with neither skip: every slot of every tile staged and
//             composited, no transmittance test, no vote
//   noquad    alpha = min(|dx^2 opac|, 0.03), t = alpha + 1 (no a, b, q)
//   noexp     gval = max(0, 1 - q / 2) (no exp)
//   nodiv     t = 1 (no -b / a and its clamp)
//   noscan    w = T_chunk alpha; T *= 1 - alpha once a chunk, at the
//             chunk's last slot (kc - 1 of the chunk)
//   nodepth   no w t depth sum
//   mxu       a and b from tensor-core products (P,6)x(6,8) and (P,3)x(3,8)
//             per 8 slots, one TF32 pass (mma.sync m16n8k8)
//   mxu3      the same products as a 3xTF32 hi/lo split
//   floor     noquad's alpha, noscan's weights, W@feats, no depth
//   skeleton  noquad's alpha, noscan's weights, acc[f] += w for the
//             chunk's slot f < 16: the cp.async pipeline, the loop and
//             the output alone
//   lowdot    full math, W@feats on the tensor cores per 8 slots, one TF32
//             pass; a warp skips a group none of its pixels has alpha > 0
//             in (a product of zeros adds exactly 0)
//   dot3      lowdot as a 3xTF32 split
//   skel16/32 skeleton with 2 / 4 tiles per thread block (the TPU's 16 / 32
//             tiles per grid step: the per-block overhead share)
//   nodirs    skeleton, dirs never read (alpha from the pixel index)
//   noout     skeleton, out written as 8 channels
//
// What bounds it: as the forward, instruction issue (each pair's ~66
// flops, a division and an exp against 28 staged floats a slot read by
// all 256 pixels). Each mode's time against full's is that stage's share.
// The tensor-core modes move a and b, or W@feats, through a (32 x 17)-float
// shared scratch per warp. A warp writes its 32 output rows through shared
// memory as contiguous float4 stores, where the forward stores a row per
// thread: full's time against the forward's is what that store pattern
// costs the forward. Every buffer is static (at most ~42.1 KB a block).
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "tile_composite_common.cuh"

namespace {

using ptgs::kFeatCol;
using ptgs::kFullWarp;
using ptgs::kGeomRows;
using ptgs::kMaxPixels;
using ptgs::kStage;
using ptgs::Params;
using ptgs::PixelDir;
using ptgs::SlotEval;
using ptgs::SlotGeom;

enum Mode {
  FULL, NOQUAD, NOEXP, NODIV, NOSCAN, NODEPTH, ONECHUNK, HOIST, MXU, MXU3,
  FLOOR, SKELETON, LOWDOT, DOT3, SKEL16, SKEL32, NOIF, NODIRS, NOOUT,
  N_MODES
};

constexpr int kF = 14;                       // packet features
constexpr int kFP = 16;                      // features padded to 8s
constexpr int kS = ptgs::slot_floats<kF>();  // floats a staged slot
constexpr int kScratch = 17;  // floats per pixel row of a warp's scratch

__host__ __device__ constexpr bool forward_mode(int m) {
  return m == FULL || m == HOIST || m == ONECHUNK || m == NOIF;
}
__host__ __device__ constexpr bool skel_alpha(int m) {
  return m == NOQUAD || m == FLOOR || m == SKELETON || m == SKEL16 ||
         m == SKEL32 || m == NODIRS || m == NOOUT;
}
__host__ __device__ constexpr bool no_scan(int m) {
  return m == NOSCAN || m == FLOOR || m == SKELETON || m == SKEL16 ||
         m == SKEL32 || m == NODIRS || m == NOOUT;
}
__host__ __device__ constexpr bool no_dot(int m) {
  return m == SKELETON || m == SKEL16 || m == SKEL32 || m == NODIRS ||
         m == NOOUT;
}
__host__ __device__ constexpr bool no_depth(int m) {
  return m == NODEPTH || m == FLOOR || no_dot(m);
}
__host__ __device__ constexpr bool from_ab(int m) {
  return m == NOEXP || m == NODIV || m == MXU || m == MXU3;
}
__host__ __device__ constexpr bool mxu_ab(int m) { return m == MXU || m == MXU3; }
__host__ __device__ constexpr bool tc_dot(int m) { return m == LOWDOT || m == DOT3; }
__host__ __device__ constexpr bool split3(int m) { return m == MXU3 || m == DOT3; }
__host__ __device__ constexpr bool uses_scratch(int m) { return mxu_ab(m) || tc_dot(m); }
__host__ __device__ constexpr int tiles_per_block(int m) {
  return m == SKEL16 ? 2 : (m == SKEL32 ? 4 : 1);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D = A B + D for one m16n8k8 TF32 tile (fragments in the PTX layout:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (t, g), b1 (t+4, g);
// c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1); g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi = tf32(x), lo = tf32(x - hi), as TF32 bit patterns.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// A B + C with one TF32 pass (SPLIT false) or hi*hi + hi*lo + lo*hi.
template <bool SPLIT>
__device__ __forceinline__ void mma_f32(float c[4], const float a[4],
                                        const float b[2]) {
  if (!SPLIT) {
    const unsigned ua[4] = {to_tf32(a[0]), to_tf32(a[1]), to_tf32(a[2]),
                            to_tf32(a[3])};
    const unsigned ub[2] = {to_tf32(b[0]), to_tf32(b[1])};
    mma_tf32(c, ua, ub);
  } else {
    unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
    mma_tf32(c, ah, bh);
    mma_tf32(c, ah, bl);
    mma_tf32(c, al, bh);
  }
}

// alpha and t of one (pixel, slot) pair from its a (before the clamp) and
// b, in eval_geom's rounding; NODIV and NOEXP drop their stage.
template <int M>
__device__ __forceinline__ SlotEval eval_from_ab(float a, float b,
                                                 const SlotGeom& g,
                                                 const Params& prm) {
  SlotEval e;
  e.a = fmaxf(a, 1e-12f);
  e.b = b;
  e.t_raw = __fdiv_rn(-e.b, e.a);
  e.t = M == NODIV ? 1.0f : fminf(fmaxf(e.t_raw, prm.t_min), prm.t_max);
  e.qv = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(e.a, e.t), __fmul_rn(2.0f, e.b)), e.t),
      g.c);
  e.gval = M == NOEXP ? fmaxf(0.0f, __fsub_rn(1.0f, __fmul_rn(0.5f, e.qv)))
                      : expf(__fmul_rn(-0.5f, fmaxf(e.qv, 0.0f)));
  e.alpha0 = __fmul_rn(g.opac, e.gval);
  e.live = (e.gval >= prm.gval_cut) && (e.alpha0 >= prm.alpha_min);
  e.alpha = e.live ? fminf(e.alpha0, prm.alpha_max) : 0.0f;
  return e;
}

// a (before its clamp) and b of one slot, rank-1 products in eval_geom's
// rounding.
__device__ __forceinline__ void scalar_ab(const PixelDir& p,
                                          const SlotGeom& g, float& a,
                                          float& b) {
  a = __fmul_rn(p.dd[0], g.q[0]);
#pragma unroll
  for (int r = 1; r < 6; ++r) a = __fadd_rn(a, __fmul_rn(p.dd[r], g.q[r]));
  b = __fadd_rn(__fmul_rn(p.dx, g.w[0]), __fmul_rn(p.dy, g.w[1]));
  b = __fadd_rn(b, __fmul_rn(p.dz, g.w[2]));
}

// One mode's step over slot j of a stage (jc: its index in its chunk),
// for the modes that take slots one at a time and are not full's code.
template <int M>
__device__ __forceinline__ void slot_step(const PixelDir& pd, int pix,
                                          const float* sb, int j, int jc,
                                          int kc, const Params& prm,
                                          float& trans, float& s_depth,
                                          float* acc) {
  const SlotGeom g = ptgs::stage_geom(sb, kS, j);
  float alpha, t;
  bool live;
  if constexpr (skel_alpha(M)) {
    const float base =
        M == NODIRS ? __fmul_rn(static_cast<float>(pix), 1e-5f) : pd.dd[0];
    alpha = fminf(fabsf(__fmul_rn(base, g.opac)), 0.03f);
    t = __fadd_rn(alpha, 1.0f);
    live = alpha > 0.0f;
  } else if constexpr (from_ab(M)) {
    float a, b;
    scalar_ab(pd, g, a, b);
    const SlotEval e = eval_from_ab<M>(a, b, g, prm);
    alpha = e.alpha;
    t = e.t;
    live = alpha > 0.0f;
  } else {
    const SlotEval e = ptgs::eval_geom(pd, g, prm);
    alpha = e.alpha;
    t = e.t;
    live = e.live;
  }
  if (!__any_sync(kFullWarp, live)) return;
  const float w = __fmul_rn(trans, alpha);
  // no_scan: T holds the chunk's entry value until the chunk's last slot.
  if (!no_scan(M) || jc == kc - 1) trans = ptgs::trans_after(trans, alpha);
  if constexpr (!no_depth(M)) s_depth = __fmaf_rn(w, t, s_depth);
  if constexpr (no_dot(M)) {
    if (jc < kFP) {
#pragma unroll
      for (int f = 0; f < kFP; ++f)
        if (f == jc) acc[f] = __fadd_rn(acc[f], w);
    }
  } else {
    float fv[kF];
    ptgs::stage_feats<kF>(sb, j, fv);
#pragma unroll
    for (int f = 0; f < kF; ++f) acc[f] = __fmaf_rn(w, fv[f], acc[f]);
  }
}

// mxu, mxu3: slots [j0, j0 + 8) of a stage (n slots staged), a and b of
// all 8 from two tensor-core products per 16 pixels, through the warp's
// scratch ws; am, ad are the pixels' monomial and direction fragments.
template <int M>
__device__ __forceinline__ void mxu_group(const float* sb, int j0, int n,
                                          const float (&am)[2][4],
                                          const float (&ad)[2][4], float* ws,
                                          const Params& prm, float& trans,
                                          float& s_depth, float* acc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  // B fragments from the slot-major stage: row r of slot j at sb[j kS + r];
  // slots past n hold stale floats and read as 0.
  const int js = j0 + g;
  const float* row = sb + js * kS;
  const bool in = js < n;
  const float bq[2] = {in ? row[tg] : 0.0f,
                       in && tg + 4 < 6 ? row[tg + 4] : 0.0f};
  const float bd[2] = {in && tg < 3 ? row[6 + tg] : 0.0f, 0.0f};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float ca[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_f32<split3(M)>(ca, am[mt], bq);
    mma_f32<split3(M)>(cb, ad[mt], bd);
    const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
    ws[r0 + 2 * tg] = ca[0];
    ws[r0 + 2 * tg + 1] = ca[1];
    ws[r1 + 2 * tg] = ca[2];
    ws[r1 + 2 * tg + 1] = ca[3];
    ws[r0 + 8 + 2 * tg] = cb[0];
    ws[r0 + 8 + 2 * tg + 1] = cb[1];
    ws[r1 + 8 + 2 * tg] = cb[2];
    ws[r1 + 8 + 2 * tg + 1] = cb[3];
  }
  __syncwarp();
  float a8[8], b8[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    a8[jj] = ws[lane * kScratch + jj];
    b8[jj] = ws[lane * kScratch + 8 + jj];
  }
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + jj;
    if (j >= n) break;  // uniform over the block
    const SlotEval e =
        eval_from_ab<M>(a8[jj], b8[jj], ptgs::stage_geom(sb, kS, j), prm);
    if (__any_sync(kFullWarp, e.alpha > 0.0f)) {
      float fv[kF];
      ptgs::stage_feats<kF>(sb, j, fv);
      ptgs::composite_step<kF>(e, [&](int f) { return fv[f]; }, trans,
                               s_depth, acc);
    }
  }
}

// lowdot, dot3: slots [j0, j0 + 8) of a stage with full's math for T and
// depth, and W (32 pixels x 8 slots) @ feats (8 slots x 16) on the tensor
// cores into the fragments cacc, unless no pixel of the warp has a live
// slot in the group.
template <int M>
__device__ __forceinline__ void dot_group(const PixelDir& pd,
                                          const float* sb, int j0, int n,
                                          float* ws, const Params& prm,
                                          float& trans, float& s_depth,
                                          float (&cacc)[2][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  float w8[8];
  bool any_live = false;  // uniform over the warp
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + jj;
    w8[jj] = 0.0f;
    if (j >= n) continue;  // uniform over the block
    const SlotEval e = ptgs::eval_geom(pd, ptgs::stage_geom(sb, kS, j), prm);
    if (__any_sync(kFullWarp, e.live)) {
      any_live = true;
      w8[jj] = __fmul_rn(trans, e.alpha);
      trans = ptgs::trans_after(trans, e.alpha);
      s_depth = __fmaf_rn(w8[jj], e.t, s_depth);
    }
  }
  if (!any_live) return;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) ws[lane * kScratch + jj] = w8[jj];
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
    const float aw[4] = {ws[r0 + tg], ws[r1 + tg], ws[r0 + tg + 4],
                         ws[r1 + tg + 4]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // Feature f of slots j0 + tg and j0 + tg + 4; pads and slots past n
      // (stale floats) read as 0.
      const int f = nt * 8 + g;
      const float bf[2] = {
          f < kF && j0 + tg < n ? sb[(j0 + tg) * kS + kFeatCol + f] : 0.0f,
          f < kF && j0 + tg + 4 < n ? sb[(j0 + tg + 4) * kS + kFeatCol + f]
                                    : 0.0f};
      mma_f32<split3(M)>(cacc[mt][nt], aw, bf);
    }
  }
  __syncwarp();
}

template <int M>
__global__ void __launch_bounds__(kMaxPixels) variant_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    float* __restrict__ out, int n_tiles, int p, int k, int kc, Params prm) {
  __shared__ __align__(16) float stage[2][kStage * kS];
  __shared__ float red[32];
  __shared__ float scratch[uses_scratch(M) ? kMaxPixels * kScratch : 1];
  constexpr int kOut = M == NOOUT ? 8 : kFP + 2;  // output channels
  __shared__ __align__(16) float out_rows[kMaxPixels * kOut];
  float* ws = scratch + (uses_scratch(M) ? (threadIdx.x >> 5) * 32 * kScratch
                                         : 0);  // this warp's rows
  constexpr int kAcc = no_dot(M) || tc_dot(M) ? kFP : kF;
  const int pix = threadIdx.x;
  const int lane = pix & 31, g = lane >> 2, tg = lane & 3;

  for (int bi = 0; bi < tiles_per_block(M); ++bi) {
    const int tile = blockIdx.x * tiles_per_block(M) + bi;
    if (tile >= n_tiles) break;  // uniform over the block
    PixelDir pd{};
    if (M != NODIRS)
      pd = ptgs::load_dir(dirs + (static_cast<size_t>(tile) * p + pix) * 3);
    float trans = 1.0f, s_depth = 0.0f;
    float acc[kAcc];
#pragma unroll
    for (int f = 0; f < kAcc; ++f) acc[f] = 0.0f;
    // noif stages every slot; the others stop at the tile's count, as the
    // forward does (slots past it are masked: opacity 0, alpha 0).
    const int n_valid =
        M == NOIF ? k : min(k, max(0, static_cast<int>(ceilf(count[tile]))));
    const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
    const float* f_tile = feats + static_cast<size_t>(tile) * kF * k;

    if constexpr (forward_mode(M)) {
      ptgs::forward_tile<kF, M != NOIF>(pd, g_tile, f_tile, k, kc, n_valid,
                                        prm, stage, red, trans, s_depth, acc);
    } else if constexpr (mxu_ab(M)) {
      // The pixels' monomials [dd0..dd5, 0, 0] and directions [dx, dy, dz,
      // 0 ...] as A fragments, once a tile.
      float am[2][4], ad[2][4];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float v = c < 6 ? pd.dd[c]
                              : (c == 8 ? pd.dx
                                        : (c == 9 ? pd.dy
                                                  : (c == 10 ? pd.dz : 0.0f)));
        ws[lane * kScratch + c] = v;
      }
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
        const int cols[4] = {r0 + tg, r1 + tg, r0 + tg + 4, r1 + tg + 4};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          am[mt][i] = ws[cols[i]];
          ad[mt][i] = ws[cols[i] + 8];
        }
      }
      __syncwarp();
      ptgs::stage_loop<kF, true>(
          g_tile, f_tile, k, kc, n_valid, prm.transmittance_min, stage, red,
          trans, [&](const float* sb, int, int n) {
            for (int j0 = 0; j0 < n; j0 += 8)
              mxu_group<M>(sb, j0, n, am, ad, ws, prm, trans, s_depth, acc);
          });
    } else if constexpr (tc_dot(M)) {
      float cacc[2][2][4] = {};  // W@feats in fragment layout
      ptgs::stage_loop<kF, true>(
          g_tile, f_tile, k, kc, n_valid, prm.transmittance_min, stage, red,
          trans, [&](const float* sb, int, int n) {
            for (int j0 = 0; j0 < n; j0 += 8)
              dot_group<M>(pd, sb, j0, n, ws, prm, trans, s_depth, cacc);
          });
      // The fragments back to one row per pixel.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
          const int c = nt * 8 + 2 * tg;
          ws[r0 + c] = cacc[mt][nt][0];
          ws[r0 + c + 1] = cacc[mt][nt][1];
          ws[r1 + c] = cacc[mt][nt][2];
          ws[r1 + c + 1] = cacc[mt][nt][3];
        }
      __syncwarp();
#pragma unroll
      for (int f = 0; f < kAcc; ++f) acc[f] = ws[lane * kScratch + f];
      __syncwarp();
    } else {
      ptgs::stage_loop<kF, true>(
          g_tile, f_tile, k, kc, n_valid, prm.transmittance_min, stage, red,
          trans, [&](const float* sb, int s0, int n) {
            const int c0 = s0 % kc;  // the stage's first slot in its chunk
#pragma unroll 4
            for (int j = 0; j < n; ++j)
              slot_step<M>(pd, pix, sb, j, c0 + j, kc, prm, trans, s_depth,
                           acc);
          });
    }

    // The pixel's row goes through shared memory, so that a warp stores
    // its 32 rows as one contiguous run of float4s: a row per thread would
    // take kOut 4-byte stores a strided kOut floats apart, each touching
    // ~kOut 128-byte lines.
    float* rows = out_rows + (pix & ~31) * kOut;  // this warp's rows
    const float aa = 1.0f - trans;
#pragma unroll
    for (int f = 0; f < kOut - 2; ++f)
      rows[lane * kOut + f] = f < kAcc ? acc[f < kAcc ? f : 0] : 0.0f;
    rows[lane * kOut + kOut - 2] = aa;
    rows[lane * kOut + kOut - 1] = s_depth / fmaxf(aa, 1e-8f);
    __syncwarp();
    const float4* src = reinterpret_cast<const float4*>(rows);
    float4* dst = reinterpret_cast<float4*>(
        out + (static_cast<size_t>(tile) * p + (pix & ~31)) * kOut);
#pragma unroll
    for (int i = lane; i < 8 * kOut; i += 32) dst[i] = src[i];
    __syncwarp();  // read before the warp's next tile overwrites them
  }
}

template <int M>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, float* out, int n_tiles, int p, int k,
                   int kc, const Params& prm, cudaStream_t stream) {
  const int tpb = tiles_per_block(M);
  variant_kernel<M><<<(n_tiles + tpb - 1) / tpb, p, 0, stream>>>(
      count, dirs, geom, feats, out, n_tiles, p, k, kc, prm);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*,
                                 const float*, float*, int, int, int, int,
                                 const Params&, cudaStream_t);

template <int... Ms>
struct Table {
  static constexpr LaunchFn fns[] = {&launch<Ms>...};
};

}  // namespace

// mode: index into Mode (kernels/tile_composite_variants.MODES). count
// (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, 14, K) in; out
// (T, P, 18), or (T, P, 8) for noout, out; all float32, contiguous. P a
// multiple of 32 and at most 256; kc divides K and is K or a multiple of
// 32, as the forward's (K for onechunk). Returns a cudaError_t.
extern "C" int ptgs_tile_composite_variant(
    int mode, const float* count, const float* dirs, const float* geom,
    const float* feats, float* out, int n_tiles, int p, int k, int kc,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, float transmittance_min, void* stream) {
  if (mode < 0 || mode >= N_MODES || n_tiles <= 0 || p <= 0 ||
      p > kMaxPixels || p % 32 != 0 || kc <= 0 || k % kc != 0 ||
      (kc != k && kc % kStage != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{t_min, t_max, alpha_min, alpha_max, gval_cut,
                   transmittance_min};
  using T = Table<FULL, NOQUAD, NOEXP, NODIV, NOSCAN, NODEPTH, ONECHUNK,
                  HOIST, MXU, MXU3, FLOOR, SKELETON, LOWDOT, DOT3, SKEL16,
                  SKEL32, NOIF, NODIRS, NOOUT>;
  return static_cast<int>(T::fns[mode](count, dirs, geom, feats, out,
                                       n_tiles, p, k, kc, prm,
                                       static_cast<cudaStream_t>(stream)));
}

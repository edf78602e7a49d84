// Per-(pixel, slot) math shared by the forward and backward tile composite
// kernels (tile_composite_fwd.cu, tile_composite_bwd.cu) and the forward's
// ablation harness (tile_composite_variants.cu).
//
// The backward recomputes the forward's alpha, transmittance and chunk
// skip decisions. alpha steps at the sigma_cut and alpha_min cutoffs,
// where one ulp can switch a ~1% contribution on or off, so both kernels
// take the same code from here: a, b, t, q, exp and alpha round op by op
// (no FMA contraction), in the plain PyTorch version's order, and come out
// bit-equal to it and to each other.
#pragma once

#include <cuda_runtime.h>

namespace ptgs {

constexpr int kGeomRows = 16;    // rows of the geom packet
constexpr int kGeomUsed = 11;    // q6 (0-5), Q(o-mu) (6-8), c (9), opac (10)
constexpr int kRowC = 9;
constexpr int kRowOpac = 10;
constexpr int kMaxPixels = 256;  // one 16x16 tile per block

struct Params {
  float t_min, t_max, alpha_min, alpha_max, gval_cut, transmittance_min;
};

// Block-wide max of v, returned to every thread. blockDim.x is a
// multiple of 32; red holds one float per warp.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  const int n_warps = blockDim.x >> 5;
  for (int i = 1; i < n_warps; ++i) m = fmaxf(m, red[i]);
  return m;
}

// One pixel's ray direction and its six quadratic monomials
// [dx2, dy2, dz2, dxdy, dxdz, dydz].
struct PixelDir {
  float dx, dy, dz;
  float dd[6];
};

__device__ __forceinline__ PixelDir load_dir(const float* d) {
  PixelDir p;
  p.dx = d[0];
  p.dy = d[1];
  p.dz = d[2];
  p.dd[0] = p.dx * p.dx;
  p.dd[1] = p.dy * p.dy;
  p.dd[2] = p.dz * p.dz;
  p.dd[3] = p.dx * p.dy;
  p.dd[4] = p.dx * p.dz;
  p.dd[5] = p.dy * p.dz;
  return p;
}

// Everything one (pixel, slot) pair computes on the way to alpha.
struct SlotEval {
  float a, b, t_raw, t, qv, gval, alpha0, alpha;
  bool live;
};

// Evaluates slot j of geometry rows staged as sg[row * stride + j].
__device__ __forceinline__ SlotEval eval_slot(const PixelDir& p,
                                              const float* sg, int stride,
                                              int j, const Params& prm) {
  SlotEval e;
  float a = __fmul_rn(p.dd[0], sg[0 * stride + j]);
  a = __fadd_rn(a, __fmul_rn(p.dd[1], sg[1 * stride + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[2], sg[2 * stride + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[3], sg[3 * stride + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[4], sg[4 * stride + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[5], sg[5 * stride + j]));
  e.a = fmaxf(a, 1e-12f);
  float b = __fadd_rn(__fmul_rn(p.dx, sg[6 * stride + j]),
                      __fmul_rn(p.dy, sg[7 * stride + j]));
  e.b = __fadd_rn(b, __fmul_rn(p.dz, sg[8 * stride + j]));
  e.t_raw = __fdiv_rn(-e.b, e.a);
  e.t = fminf(fmaxf(e.t_raw, prm.t_min), prm.t_max);
  e.qv = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(e.a, e.t), __fmul_rn(2.0f, e.b)), e.t),
      sg[kRowC * stride + j]);
  e.gval = expf(__fmul_rn(-0.5f, fmaxf(e.qv, 0.0f)));
  e.alpha0 = __fmul_rn(sg[kRowOpac * stride + j], e.gval);
  e.live = (e.gval >= prm.gval_cut) && (e.alpha0 >= prm.alpha_min);
  e.alpha = e.live ? fminf(e.alpha0, prm.alpha_max) : 0.0f;
  return e;
}

// Transmittance past a slot: T * (1 - alpha), rounded as the forward does.
__device__ __forceinline__ float trans_after(float trans, float alpha) {
  return __fmul_rn(trans, __fsub_rn(1.0f, alpha));
}

// The forward's step over slot j of a chunk staged as sf[f * kc + j]:
// w = T alpha, T *= 1 - alpha, and w added into the depth and F feature
// sums by explicit FMAs, so every kernel that takes this step (the forward
// and the harness's production modes) rounds it the same way.
template <int F>
__device__ __forceinline__ void composite_slot(const SlotEval& e,
                                               const float* sf, int kc,
                                               int j, float& trans,
                                               float& s_depth, float* acc) {
  const float w = __fmul_rn(trans, e.alpha);
  trans = trans_after(trans, e.alpha);
  s_depth = __fmaf_rn(w, e.t, s_depth);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = __fmaf_rn(w, sf[f * kc + j], acc[f]);
}

}  // namespace ptgs

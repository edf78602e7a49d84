// Per-(ray, Gaussian) math shared by the dense-trace kernels
// (dense_topk.cu, dense_visibility.cu).
//
// Both kernels evaluate the ray-Gaussian quadratic with the operations of
// the plain PyTorch version (ops/gaussians.py: ray_quadratic,
// peak_response, segment_transmittance_alpha, alpha_from_response), in its
// order, each rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction). alpha steps at the sigma_cut and alpha_min cutoffs, where
// one ulp decides whether a Gaussian counts at all, so alpha must come out
// bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>

namespace ptgs_dense {

// Columns of a Gaussian's row in the table: mean (0-2), M = diag(1/s) R^T
// row-major (3-11), opacity (12).
constexpr int kCols = 13;
constexpr int kColM = 3;
constexpr int kColOpac = 12;
constexpr int kRays = 128;   // rays (threads) per block
constexpr int kStage = 128;  // Gaussians staged in shared memory per pass

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int ray) {
  Ray r;
  r.ox = o[3 * ray];
  r.oy = o[3 * ray + 1];
  r.oz = o[3 * ray + 2];
  r.dx = d[3 * ray];
  r.dy = d[3 * ray + 1];
  r.dz = d[3 * ray + 2];
  return r;
}

// (m0 v0 + m1 v1) + m2 v2 for one row of M.
__device__ __forceinline__ float row_dot(const float* g, int stride, int row,
                                         float v0, float v1, float v2) {
  const float* m = g + (kColM + 3 * row) * stride;
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], v0), __fmul_rn(m[stride], v1)),
                   __fmul_rn(m[2 * stride], v2));
}

__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                   __fmul_rn(x2, y2));
}

struct Quadratic {
  float a, b, c;  // a clamped at 1e-12
};

// The quadratic of Gaussian g, whose column `col` is g[col * stride].
__device__ __forceinline__ Quadratic quadratic(const Ray& r, const float* g,
                                               int stride) {
  const float x0 = __fsub_rn(r.ox, g[0]);
  const float x1 = __fsub_rn(r.oy, g[stride]);
  const float x2 = __fsub_rn(r.oz, g[2 * stride]);
  const float og0 = row_dot(g, stride, 0, x0, x1, x2);
  const float og1 = row_dot(g, stride, 1, x0, x1, x2);
  const float og2 = row_dot(g, stride, 2, x0, x1, x2);
  const float dg0 = row_dot(g, stride, 0, r.dx, r.dy, r.dz);
  const float dg1 = row_dot(g, stride, 1, r.dx, r.dy, r.dz);
  const float dg2 = row_dot(g, stride, 2, r.dx, r.dy, r.dz);
  Quadratic q;
  q.a = fmaxf(dot3(dg0, dg1, dg2, dg0, dg1, dg2), 1e-12f);
  q.b = dot3(og0, og1, og2, dg0, dg1, dg2);
  q.c = dot3(og0, og1, og2, og0, og1, og2);
  return q;
}

// exp(-max(q(t), 0) / 2), q(t) = ((a t) t + (2 b) t) + c.
__device__ __forceinline__ float response(const Quadratic& q, float t) {
  const float qv = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(q.a, t), t),
                __fmul_rn(__fmul_rn(2.0f, q.b), t)),
      q.c);
  return expf(__fmul_rn(-0.5f, fmaxf(qv, 0.0f)));
}

struct Peak {
  float t, alpha;
};

// peak_response + alpha_from_response: t clamped into [t_min, t_max],
// alpha with the sigma_cut (gval_cut) and alpha_min cutoffs and the
// alpha_max clamp.
__device__ __forceinline__ Peak peak(const Ray& r, const float* g, int stride,
                                     float t_min, float t_max,
                                     float alpha_min, float alpha_max,
                                     float gval_cut) {
  const Quadratic q = quadratic(r, g, stride);
  Peak p;
  p.t = fminf(fmaxf(__fdiv_rn(-q.b, q.a), t_min), t_max);
  const float gval = response(q, p.t);
  float alpha = __fmul_rn(g[kColOpac * stride], gval);
  if (gval < gval_cut) alpha = 0.0f;
  p.alpha = alpha < alpha_min ? 0.0f : fminf(alpha, alpha_max);
  return p;
}

// segment_transmittance_alpha: the response at the peak clamped into
// [t_start, t_end], the alpha_min cutoff and the alpha_max clamp, no
// sigma_cut.
__device__ __forceinline__ float segment_alpha(const Ray& r, const float* g,
                                               int stride, float t_start,
                                               float t_end, float alpha_min,
                                               float alpha_max) {
  const Quadratic q = quadratic(r, g, stride);
  const float t = fminf(fmaxf(__fdiv_rn(-q.b, q.a), t_start), t_end);
  const float alpha = __fmul_rn(g[kColOpac * stride], response(q, t));
  return alpha < alpha_min ? 0.0f : fminf(alpha, alpha_max);
}

// Stages Gaussians [base, base + cnt) of the row-major (N, kCols) table
// into sg[col * kStage + j], reading the rows as one coalesced run.
__device__ __forceinline__ void stage_rows(const float* table, int base,
                                           int cnt, float* sg) {
  const float* src = table + static_cast<size_t>(base) * kCols;
  for (int i = threadIdx.x; i < cnt * kCols; i += blockDim.x)
    sg[(i % kCols) * kStage + i / kCols] = src[i];
}

}  // namespace ptgs_dense

// Per-(ray, Gaussian) math and table staging shared by the dense-trace
// kernels (dense_topk.cu, dense_visibility.cu).
//
// The exact path evaluates the ray-Gaussian quadratic with the operations
// of the plain PyTorch version (ops/gaussians.py: ray_quadratic,
// peak_response, segment_transmittance_alpha, alpha_from_response), in its
// order, each rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction). alpha steps at the sigma_cut and alpha_min cutoffs, where
// one ulp decides whether a Gaussian counts at all, so alpha must come out
// bit-equal to the plain version's.
//
// The cull (cull_keep) runs before it on every pair and decides, from the
// mean and two per-Gaussian radii of the table (kernels/dense_trace.py:
// cull_radii), that the exact path would give alpha = 0. It tests whether
// the mean lies farther from the ray's line than the Gaussian can reach:
//   |x × d|^2 > |d|^2 (R0 + R1 (|x|^2 + tau^2 |d|^2)),   x = o - mu,
// with |x × d|^2 formed as |x|^2 |d|^2 - (x.d)^2. Why it is conservative:
// a pair has alpha > 0 only if the exact path's q(t*) <= q_lim (K1:
// min(sigma_cut^2, 2 ln(opac / alpha_min)), K2: 2 ln(opac / alpha_min)),
// and the true q at any t is at least d_perp^2 / sigma_max^2. The exact
// path's q can undershoot the true one only by its rounding: the quadratic
// form's cancellation, at most 7 eps (|u| + |t v|)^2 with u = M x, v = M d
// and |t v| <= |u| + tau |v| (tau = t_min, or |t_end| for a segment that
// ends before t_min), and the rounding of u and v, at most 2 sqrt(q) Delta
// <= (delta / 2) q + 2 Delta^2 / delta with Delta = 3 sqrt(3) eps ((1 + rho)
// |x| + tau |d|) / sigma_min. With eps = 2^-24 and rho = sigma_max /
// sigma_min that gives R0 = sigma_max^2 (q_lim + 1e-5) and R1 = rho^2 (56
// eps + 108 eps^2 (1 + rho)^2 / delta) + 16 eps, both times (1 + delta)(1 +
// 32 eps rho): 1e-5 covers expf's 2 ulp and the cutoffs' rounding to
// float, 16 eps the cull test's own rounding (FMA contraction allowed:
// the Lagrange form's cancellation is at most 15 eps |x|^2 |d|^2), the
// (1 + 32 eps rho) the table's M against an exactly orthogonal one, and
// delta = 1% the relative rounding of both sides. A culled pair then has
// alpha = 0 in the exact path too, so skipping it changes no bit: K1 never
// inserts it, and K2's factor for it is exactly 1.
#pragma once

#include <cuda_runtime.h>

namespace ptgs_dense {

// Columns of a Gaussian's 64-byte row in the table: mean (0-2), M =
// diag(1/s) R^T row-major (3-11), opacity (12), the cull radii R0 of the
// trace (13), R1 (14) and R0 of a shadow segment (15).
constexpr int kCols = 16;
constexpr int kColM = 3;
constexpr int kColOpac = 12;
constexpr int kRays = 128;   // rays (threads) per block
constexpr int kStage = 128;  // Gaussians staged in shared memory per pass
constexpr int kStageFloats = kStage * kCols;  // 8 KB a stage
constexpr int kGroupCols = 8;  // a 32-row group's sphere, largest radii
constexpr unsigned kFullWarp = 0xffffffffu;

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

// (m0 v0 + m1 v1) + m2 v2 for one row of M; g is a Gaussian's table row.
__device__ __forceinline__ float row_dot(const float* g, int row, float v0,
                                         float v1, float v2) {
  const float* m = g + kColM + 3 * row;
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], v0), __fmul_rn(m[1], v1)),
                   __fmul_rn(m[2], v2));
}

__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                   __fmul_rn(x2, y2));
}

struct Quadratic {
  float a, b, c;  // a clamped at 1e-12
};

__device__ __forceinline__ Quadratic quadratic(const Ray& r, const float* g) {
  const float x0 = __fsub_rn(r.ox, g[0]);
  const float x1 = __fsub_rn(r.oy, g[1]);
  const float x2 = __fsub_rn(r.oz, g[2]);
  const float og0 = row_dot(g, 0, x0, x1, x2);
  const float og1 = row_dot(g, 1, x0, x1, x2);
  const float og2 = row_dot(g, 2, x0, x1, x2);
  const float dg0 = row_dot(g, 0, r.dx, r.dy, r.dz);
  const float dg1 = row_dot(g, 1, r.dx, r.dy, r.dz);
  const float dg2 = row_dot(g, 2, r.dx, r.dy, r.dz);
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
__device__ __forceinline__ Peak peak(const Ray& r, const float* g,
                                     float t_min, float t_max,
                                     float alpha_min, float alpha_max,
                                     float gval_cut) {
  const Quadratic q = quadratic(r, g);
  Peak p;
  p.t = fminf(fmaxf(__fdiv_rn(-q.b, q.a), t_min), t_max);
  const float gval = response(q, p.t);
  float alpha = __fmul_rn(g[kColOpac], gval);
  if (gval < gval_cut) alpha = 0.0f;
  p.alpha = alpha < alpha_min ? 0.0f : fminf(alpha, alpha_max);
  return p;
}

// segment_transmittance_alpha: the response at the peak clamped into
// [t_start, t_end], the alpha_min cutoff and the alpha_max clamp, no
// sigma_cut.
__device__ __forceinline__ float segment_alpha(const Ray& r, const float* g,
                                               float t_start, float t_end,
                                               float alpha_min,
                                               float alpha_max) {
  const Quadratic q = quadratic(r, g);
  const float t = fminf(fmaxf(__fdiv_rn(-q.b, q.a), t_start), t_end);
  const float alpha = __fmul_rn(g[kColOpac], response(q, t));
  return alpha < alpha_min ? 0.0f : fminf(alpha, alpha_max);
}

// The cull test (see the top of this file): false where the exact path
// surely gives alpha = 0. dd = |d|^2 and tt = tau^2 |d|^2 are the ray's;
// mean, r0 and r1 the Gaussian's. A NaN anywhere keeps the pair.
__device__ __forceinline__ bool cull_keep(const Ray& r, float dd, float tt,
                                          float mx, float my, float mz,
                                          float r0, float r1) {
  const float x0 = r.ox - mx, x1 = r.oy - my, x2 = r.oz - mz;
  const float xd = x0 * r.dx + x1 * r.dy + x2 * r.dz;
  const float xx = x0 * x0 + x1 * x1 + x2 * x2;
  return !(xx * dd - xd * xd > dd * (r0 + r1 * (xx + tt)));
}

// The group test: false where no row of a group of 32 staged rows can be
// kept by this ray, from the group's sphere (center, radius) and its
// largest radii r0 and r1 (kernels/dense_trace.py: dense_table); the same
// for a super-group of 32 groups, whose sphere holds its groups' spheres
// and whose radii are their largest. The
// line's distance to any mean of the group is at least its distance to the
// center less the radius, and each |x| at most |x_c| plus the radius; the
// slack terms cover the float32 rounding of this test (the Lagrange
// form's cancellation, at most 15 eps |x|^2 |d|^2 < 1e-5 |x|^2 |d|^2) and
// of the exact path's x = o - mu (2 eps |x|). A group it drops holds only
// pairs the per-pair cull would drop in exact arithmetic, so only pairs
// whose exact alpha is 0.
__device__ __forceinline__ bool group_keep(const Ray& r, float dd, float tt,
                                           float4 sphere, float r0,
                                           float r1) {
  const float x0 = r.ox - sphere.x, x1 = r.oy - sphere.y,
              x2 = r.oz - sphere.z;
  const float xd = x0 * r.dx + x1 * r.dy + x2 * r.dz;
  const float xx = x0 * x0 + x1 * x1 + x2 * x2;
  const float dist =
      sqrtf(fmaxf(xx * dd - xd * xd - 1e-5f * xx * dd, 0.0f) / dd);
  const float len = sqrtf(xx);
  const float lo =
      dist * (1.0f - 1e-6f) - sphere.w * (1.0f + 1e-6f) - 1e-6f * len;
  const float far = len * (1.0f + 1e-5f) + sphere.w;
  return !(lo > 0.0f && lo * lo > (r0 + r1 * (far * far + tt)) * 1.001f);
}

// cp.async: 16-byte and 4-byte copies from device to shared memory that
// the copying threads do not wait for; a group is committed per stage and
// waited for before the stage is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts copying rows [base, base + cnt) of the row-major (N, kCols) table
// (16-byte aligned) into sg, row for row, 16 bytes a copy: the block's
// threads take consecutive chunks of one contiguous 8 KB run.
__device__ __forceinline__ void stage_rows_async(const float* table, int base,
                                                 int cnt, float* sg) {
  const float4* src =
      reinterpret_cast<const float4*>(table + static_cast<size_t>(base) *
                                                  kCols);
  float4* dst = reinterpret_cast<float4*>(sg);
  for (int i = threadIdx.x; i < cnt * (kCols / 4); i += blockDim.x)
    cp_async16(dst + i, src + i);
}

// The cull over rows [j0, j0 + 32) of a staged buffer (rows past cnt
// masked off), with the shadow segment's R0: bit jj set where the segment
// keeps row j0 + jj. Each row is read as its first and last 16 bytes,
// (mean, M00) and (opacity, R0 of the trace, R1, R0 of a shadow segment);
// every lane of a warp reads the same row (a broadcast, no bank conflict).
// The 32 tests are independent, so the unrolled loop keeps many in flight.
__device__ __forceinline__ unsigned cull_mask(const Ray& r, float dd, float tt,
                                              const float* sg, int j0,
                                              int cnt) {
  unsigned keep = 0;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const float4* row =
        reinterpret_cast<const float4*>(sg + (j0 + jj) * kCols);
    const float4 h = row[0], tl = row[3];
    keep |= static_cast<unsigned>(cull_keep(r, dd, tt, h.x, h.y, h.z, tl.w,
                                            tl.z))
            << jj;
  }
  const int rem = cnt - j0;
  return rem < 32 ? keep & ((1u << rem) - 1u) : keep;
}

}  // namespace ptgs_dense

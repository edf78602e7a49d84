// Per-ray grid traversal and per-Gaussian response of the uniform-grid
// march (grid_march.cu), in the plain march's arithmetic.
//
// Everything that decides which cells a ray records and which Gaussians
// count rounds op by op (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction), in the order of render/grid_trace.py: alpha steps at the
// alpha_min and sigma_cut cutoffs, and the quadratic q = (a t + 2 b) t + c
// cancels for thin surfels, so one ulp can switch a Gaussian on or off.
#pragma once

#include <cuda_runtime.h>

namespace ptgs_grid {

constexpr int kAccKeys = 15;   // render/grid_trace.ACC_KEYS
constexpr int kGeomOpac = 9;   // column of the opacity
constexpr int kDc = 10, kEmi = 13, kMet = 16, kAxis = 21, kBy = 24;
constexpr int kPktDeg1 = 40;   // packet columns of a degree-1 scene
constexpr int kSlotGroup = 8;  // phase B's kill test after each group
constexpr int kMaxRounds = 8;

struct Params {
  float t_min, t_max, alpha_min, alpha_max, gval_cut, transmittance_min;
  float jump_unit;
  int gx, gy, gz, kc, cols, n_rounds;
  int wide_slots;  // slots of a ray's shared region: the largest fill
  int m[kMaxRounds], a_max[kMaxRounds];
};

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}

// One ray's grid quantities (render/grid_trace._ray_setup).
struct Ray {
  float o[3], d[3], inv_d[3], lo[3], cell[3], edge[3], step_pos[3], dims[3];
  float eps, probe, t_entry, t_far;
  bool inside;
};

__device__ __forceinline__ Ray setup_ray(const float* o, const float* d,
                                         const float* lo, const float* hi,
                                         const Params& prm) {
  Ray r;
  const int dims[3] = {prm.gx, prm.gy, prm.gz};
  float t_near = -3.402823466e38f, t_far = 3.402823466e38f;
  float min_delta = 3.402823466e38f;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[k];
    r.d[k] = d[k];
    r.lo[k] = lo[k];
    r.dims[k] = static_cast<float>(dims[k]);
    const float ext = fmaxf(fsub(hi[k], lo[k]), 1e-12f);
    r.cell[k] = __fdiv_rn(ext, r.dims[k]);
    r.edge[k] = fmul(r.cell[k], 4.0f);
    const float dk = fabsf(r.d[k]) < 1e-12f
                         ? (r.d[k] >= 0.0f ? 1e-12f : -1e-12f)
                         : r.d[k];
    r.inv_d[k] = __fdiv_rn(1.0f, dk);
    r.step_pos[k] = r.d[k] >= 0.0f ? 1.0f : 0.0f;
    const float t0 = fmul(fsub(lo[k], r.o[k]), r.inv_d[k]);
    const float t1 = fmul(fsub(hi[k], r.o[k]), r.inv_d[k]);
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
    min_delta = fminf(min_delta, fabsf(fmul(r.cell[k], r.inv_d[k])));
  }
  r.t_entry = fmaxf(t_near, prm.t_min);
  r.t_far = t_far;
  r.inside = t_far > r.t_entry;
  r.eps = fmul(1e-3f, min_delta);
  r.probe = fmul(0.25f, r.eps);
  return r;
}

// The (clamped) cell containing the point at t + probe, as floats.
__device__ __forceinline__ void cell_of(const Ray& r, float t, float c[3]) {
  const float tp = fadd(t, r.probe);
  for (int k = 0; k < 3; ++k) {
    const float p = fadd(r.o[k], fmul(tp, r.d[k]));
    const float v = floorf(__fdiv_rn(fsub(p, r.lo[k]), r.cell[k]));
    c[k] = fminf(fmaxf(v, 0.0f), r.dims[k] - 1.0f);
  }
}

// Exit t of the box (cell index c, edge size): min over axes of the
// boundary crossing in the direction of travel.
__device__ __forceinline__ float exit_of(const Ray& r, const float c[3],
                                         const float size[3]) {
  float t = 3.402823466e38f;
  for (int k = 0; k < 3; ++k) {
    const float bnd = fadd(r.lo[k], fmul(fadd(c[k], r.step_pos[k]), size[k]));
    t = fminf(t, fmul(fsub(bnd, r.o[k]), r.inv_d[k]));
  }
  return t;
}

// The response of Gaussian j of a cell row (flat, column-major with
// stride kc): its peak t (clamped to [t_min, t_max]) and alpha, zero
// unless the peak lies in the slab [t0, t1). With t_cap > 0 the response
// is taken at the peak clamped into [max(t0, t_min), t_cap] and only the
// alpha_min cutoff applies (shadow segments).
struct Response {
  float t_peak, alpha;
};

__device__ __forceinline__ Response respond(const Ray& r, const float* row,
                                            int kc, int j, float t0,
                                            float t1, bool segment,
                                            float t_cap, const Params& prm) {
  const float q00 = row[0 * kc + j], q11 = row[1 * kc + j];
  const float q22 = row[2 * kc + j], q01 = row[3 * kc + j];
  const float q02 = row[4 * kc + j], q12 = row[5 * kc + j];
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float ogx = fsub(r.o[0], row[6 * kc + j]);
  const float ogy = fsub(r.o[1], row[7 * kc + j]);
  const float ogz = fsub(r.o[2], row[8 * kc + j]);
  float a = fadd(fadd(fmul(fmul(dx, dx), q00), fmul(fmul(dy, dy), q11)),
                 fmul(fmul(dz, dz), q22));
  const float cross = fadd(fadd(fmul(fmul(dx, dy), q01),
                                fmul(fmul(dx, dz), q02)),
                           fmul(fmul(dy, dz), q12));
  a = fmaxf(fadd(a, fmul(2.0f, cross)), 1e-12f);
  const float wx = fadd(fadd(fmul(q00, ogx), fmul(q01, ogy)), fmul(q02, ogz));
  const float wy = fadd(fadd(fmul(q01, ogx), fmul(q11, ogy)), fmul(q12, ogz));
  const float wz = fadd(fadd(fmul(q02, ogx), fmul(q12, ogy)), fmul(q22, ogz));
  const float b = fadd(fadd(fmul(dx, wx), fmul(dy, wy)), fmul(dz, wz));
  const float c = fadd(fadd(fmul(wx, ogx), fmul(wy, ogy)), fmul(wz, ogz));
  const float peak = __fdiv_rn(-b, a);
  Response res;
  res.t_peak = fminf(fmaxf(peak, prm.t_min), prm.t_max);
  const float t_resp =
      segment ? fminf(fmaxf(peak, fmaxf(t0, prm.t_min)), t_cap) : res.t_peak;
  const float qv =
      fadd(fmul(fadd(fmul(a, t_resp), fmul(2.0f, b)), t_resp), c);
  const float gval = expf(fmul(-0.5f, fmaxf(qv, 0.0f)));
  const float opac = row[kGeomOpac * kc + j];
  const float a0 = fmul(opac, gval);
  bool live = a0 >= prm.alpha_min;
  if (!segment) live = live && gval >= prm.gval_cut;
  const bool valid = opac > 0.0f && res.t_peak >= t0 && res.t_peak < t1;
  res.alpha = (live && valid) ? fminf(a0, prm.alpha_max) : 0.0f;
  return res;
}

}  // namespace ptgs_grid

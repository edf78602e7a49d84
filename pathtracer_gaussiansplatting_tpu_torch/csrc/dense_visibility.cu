// Dense shadow-ray visibility for Hopper (sm_90a).
//
// Replaces the plain XLA code of the reference's dense shadow rays, not a
// Pallas kernel: pathtracer_gaussiansplatting_tpu/render/reference.py:
// visibility_dense (with ops/gaussians.py: segment_transmittance_alpha)
// and the active mask of render/pipeline.py:_dense_vis. For every segment
// [t_min, t_end] along a ray it returns vis = prod_i (1 - alpha_i) over
// all Gaussians, alpha_i the response at the peak clamped into the
// segment, with the alpha_min cutoff and alpha_max clamp and, unlike the
// trace, no sigma_cut. An inactive ray writes 1.
//
// What bounded it: the issue of the per-pair work, as for dense_topk.cu
// (the exact pair ~110 instructions, a division and an exp, for ~0.1-0.5%
// of pairs that have alpha > 0). So it evaluates fewer pairs in three
// conservative steps (dense_common.cuh derives them), with the shadow
// segment's radii (no sigma_cut; tau = |t_end| where the segment ends
// before t_min):
// a warp skips each group of 32 Morton-ordered rows that none of its
// segments can reach, each segment tests the remaining rows with the
// per-pair cull, and each lane multiplies in its own kept rows while the
// warp loops as long as any lane has one left. A skipped pair's factor is
// exactly 1, so the product over the remaining Gaussians, in Morton order,
// is the unculled product in that order, bit for bit. One thread per
// segment keeps its product in a register; the table's 64-byte rows are
// staged 128 at a time into a double buffer by cp.async. The plain
// version's torch.prod multiplies in index order and its own reduction
// order, so the two agree to rounding, not bit for bit.
//
// What bounds it now (chip_smoke.py 5a on an NVIDIA H100 80GB HBM3,
// 700.00 W; 65536 segments, 50k Gaussians): 1.92 ms on segments to
// emissive surfels and 0.85 ms on segments to the point light, 6.3% and
// 10.9% of the bound by code path (13.8 ms when every pair ran the exact
// path). A chunk is one wave of ~16 warps an SM and a group costs its
// busiest lane's kept rows; past that, not measured.
//
// Where autograd wants the geometry (render/reference.py:
// visibility_dense), the same kernel runs in two more modes, instantiated
// apart so the plain launch keeps its code: kCount writes vis and each
// segment's number of Gaussians with alpha > 0, and kPairs, given each
// segment's offset into a list (the counts' exclusive prefix sum), writes
// those Gaussians' indices there, in the order it met them. Both walk the
// rows as the plain launch does, so they meet the same pairs; torch
// recomputes those pairs' alpha from the scene and differentiates the
// product through them.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dense_common.cuh"

namespace {

using ptgs_dense::kCols;
using ptgs_dense::kFullWarp;
using ptgs_dense::kRays;
using ptgs_dense::kStage;
using ptgs_dense::kStageFloats;

__device__ __forceinline__ void stage_async(const float* table, int n_gauss,
                                            int base, float* sg) {
  if (base < n_gauss)
    ptgs_dense::stage_rows_async(table, base, min(kStage, n_gauss - base),
                                 sg);
  ptgs_dense::cp_async_commit();  // an empty group past the last stage
}

// What a launch writes: vis alone (the plain launch), vis and the pair
// counts, or the pairs' Gaussian indices.
enum Mode { kVis, kCount, kPairs };

template <int M>
__global__ void __launch_bounds__(kRays) dense_visibility_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_end, const float* __restrict__ sorted_rows,
    const float* __restrict__ groups,
    const unsigned char* __restrict__ active, float* __restrict__ vis_out,
    const int* __restrict__ order, int* __restrict__ pair_count,
    const long long* __restrict__ pair_offset, int* __restrict__ pair_gid,
    int n_rays, int n_gauss, float t_min, float alpha_min,
    float alpha_max) {
  __shared__ __align__(16) float sg[2][kStageFloats];

  const int ray = blockIdx.x * kRays + threadIdx.x;
  const bool in_range = ray < n_rays;
  const bool live = in_range && (active == nullptr || active[ray] != 0);
  ptgs_dense::Ray r{};
  float te = 0.0f;
  if (in_range) {
    r = ptgs_dense::load_ray(origins, dirs, ray);
    te = t_end[ray];
  }
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  // The clamped t lies within |t_peak| + tau of 0 (dense_common.cuh).
  const float tau = te >= t_min ? t_min : fmaxf(t_min, fabsf(te));
  const float tt = tau * tau * dd;

  float vis = 1.0f;
  int n_pairs = 0;
  int* gid_out = nullptr;
  if (M == kPairs && in_range) gid_out = pair_gid + pair_offset[ray];
  if (__syncthreads_or(live)) {
    stage_async(sorted_rows, n_gauss, 0, sg[0]);
    for (int base = 0, buf = 0; base < n_gauss; base += kStage, buf ^= 1) {
      const int cnt = min(kStage, n_gauss - base);
      stage_async(sorted_rows, n_gauss, base + kStage, sg[buf ^ 1]);
      ptgs_dense::cp_async_wait<1>();
      __syncthreads();
      const float* g0 = sg[buf];
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        // A warp none of whose segments can reach the 32 rows' sphere
        // skips them.
        bool reach = live;
        if (reach) {
          const float4* sph = reinterpret_cast<const float4*>(
              groups + ((base + j0) / 32) * ptgs_dense::kGroupCols);
          const float4 radii = __ldg(sph + 1);
          reach = ptgs_dense::group_keep(r, dd, tt, __ldg(sph), radii.z,
                                         radii.y);
        }
        if (!__any_sync(kFullWarp, reach)) continue;
        unsigned pend =
            reach ? ptgs_dense::cull_mask(r, dd, tt, g0, j0, cnt) : 0u;
        // Each lane multiplies in its own kept rows in staged order; the
        // warp loops while any lane has one left (a vote).
        while (__any_sync(kFullWarp, pend != 0u)) {
          if (pend == 0u) continue;
          const int j = j0 + __ffs(pend) - 1;
          pend &= pend - 1u;
          const float alpha = ptgs_dense::segment_alpha(
              r, g0 + j * kCols, t_min, te, alpha_min, alpha_max);
          vis = __fmul_rn(vis, __fsub_rn(1.0f, alpha));
          if (M != kVis && alpha > 0.0f) {
            if (M == kPairs) gid_out[n_pairs] = order[base + j];
            ++n_pairs;
          }
        }
      }
      __syncthreads();  // this buffer is no longer read
    }
    ptgs_dense::cp_async_wait<0>();
  }
  if (in_range && M != kPairs) vis_out[ray] = vis;
  if (in_range && M == kCount) pair_count[ray] = n_pairs;
}

template <int M>
int launch(const float* origins, const float* dirs, const float* t_end,
           const float* sorted_rows, const float* groups,
           const unsigned char* active, float* vis, const int* order,
           int* pair_count, const long long* pair_offset, int* pair_gid,
           int n_rays, int n_gauss, float t_min, float alpha_min,
           float alpha_max, void* stream) {
  if (n_rays <= 0 || n_gauss <= 0 || groups == nullptr ||
      reinterpret_cast<size_t>(sorted_rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + kRays - 1) / kRays;
  dense_visibility_kernel<M><<<blocks, kRays, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, t_end, sorted_rows, groups, active, vis, order,
      pair_count, pair_offset, pair_gid, n_rays, n_gauss, t_min, alpha_min,
      alpha_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// origins, dirs (R, 3), t_end (R,), the DenseTable's sorted_rows (N, 16)
// (kernels/dense_trace.py: dense_table; 16-byte aligned) and groups
// (ceil(N / 32), 8), optional active (R,) (bool as bytes; NULL for none)
// in; vis (R,) out; float32, contiguous. Returns a cudaError_t.
extern "C" int ptgs_dense_visibility(const float* origins, const float* dirs,
                                     const float* t_end,
                                     const float* sorted_rows,
                                     const float* groups,
                                     const unsigned char* active, float* vis,
                                     int n_rays, int n_gauss, float t_min,
                                     float alpha_min, float alpha_max,
                                     void* stream) {
  return launch<kVis>(origins, dirs, t_end, sorted_rows, groups, active, vis,
                      nullptr, nullptr, nullptr, nullptr, n_rays, n_gauss,
                      t_min, alpha_min, alpha_max, stream);
}

// As ptgs_dense_visibility, with the DenseTable's order (N,) int32 in;
// vis (R,) and pair_count (R,) int32 out: each segment's number of
// Gaussians with alpha > 0.
extern "C" int ptgs_dense_visibility_count(
    const float* origins, const float* dirs, const float* t_end,
    const float* sorted_rows, const float* groups,
    const unsigned char* active, float* vis, int* pair_count, int n_rays,
    int n_gauss, float t_min, float alpha_min, float alpha_max,
    void* stream) {
  return launch<kCount>(origins, dirs, t_end, sorted_rows, groups, active,
                        vis, nullptr, pair_count, nullptr, nullptr, n_rays,
                        n_gauss, t_min, alpha_min, alpha_max, stream);
}

// As ptgs_dense_visibility_count, with order (N,) int32 and pair_offset
// (R,) int64 (the exclusive prefix sum of the counts) in; pair_gid (the
// counts' total,) int32 out: segment r's Gaussian indices (into the
// table's index order) at [pair_offset[r], pair_offset[r] + count[r]).
extern "C" int ptgs_dense_visibility_pairs(
    const float* origins, const float* dirs, const float* t_end,
    const float* sorted_rows, const float* groups, const int* order,
    const unsigned char* active, const long long* pair_offset,
    int* pair_gid, int n_rays, int n_gauss, float t_min, float alpha_min,
    float alpha_max, void* stream) {
  return launch<kPairs>(origins, dirs, t_end, sorted_rows, groups, active,
                        nullptr, order, nullptr, pair_offset, pair_gid,
                        n_rays, n_gauss, t_min, alpha_min, alpha_max,
                        stream);
}

// Dense top-K ray-Gaussian trace for Hopper (sm_90a).
//
// Replaces the plain XLA code of the reference's dense backend, not a
// Pallas kernel: pathtracer_gaussiansplatting_tpu/render/reference.py:
// dense_topk (with ops/gaussians.py: peak_response). For every ray and
// every Gaussian it computes the peak t* = clip(-b / a, t_min, t_max) and
// alpha = opac * exp(-q(t*) / 2) with the sigma_cut / alpha_min cutoffs,
// and keeps the K contributing Gaussians (alpha > 0) of smallest key
// (t*, or a per-Gaussian sort depth), in ascending key order, equal keys
// in index order (as lax.top_k does). Slots past the contributing ones
// hold idx 0, t = t_max, alpha 0; an inactive ray writes only such slots.
//
// What bounded it: the issue of the per-pair work. The exact pair costs
// ~60 separately rounded float operations, a division and an exp (~110
// instructions), and 3.3e9 pairs of a 65536-ray chunk against 50k
// Gaussians ran within ~2x of the issue limit for that work; yet only
// ~0.1-0.3% of pairs have alpha > 0. So the design evaluates fewer pairs,
// in three steps, each conservative (dense_common.cuh derives them), so
// that the kept list stays bit-equal to the plain version's:
//  - the rows come in Morton order of the means, and a warp skips each
//    group of 32 rows whose bounding sphere none of its rays can reach
//    (group_keep, once per ray and group);
//  - each ray tests each remaining row with the per-pair cull (cull_keep,
//    ~15 instructions from the row's mean and radii; 32 independent tests
//    in flight) into a 32-bit mask of the rows it keeps;
//  - each lane walks its own mask in row order through the exact path, and
//    the warp loops while any lane has a row left (a vote), so it pays for
//    its busiest lane, not for every row some lane keeps.
// A skipped pair has alpha = 0 in the exact path too and is never inserted.
// The list is ordered by (key, index) (the plain version's stable sort),
// since Morton order is not index order. The rest: one thread per ray,
// origin and direction in registers; the table's 64-byte rows staged 128
// at a time into a double buffer by cp.async while the previous stage is
// tested, read as float4 broadcasts in the cull (all lanes the same row);
// each thread keeps its sorted list of K (key, index) pairs in local memory
// and shifts only the entries past the new one (bounce rays insert at
// different rows, so a warp pays for each lane's shifts in turn). t and
// alpha of the K kept Gaussians are recomputed at the end from the table in
// index order (bit-equal: the same operations).
//
// What bounds it now (chip_smoke.py 5a on an NVIDIA H100 80GB HBM3,
// 700.00 W; 65536 rays, 50k Gaussians): 1.28 ms on primary rays, 4.6 ms
// on bounce rays, 7.7 ms on rays from 20x as far, 6.6%, 2.0% and 9.3% of
// the bound by code path (17.3 ms when every pair ran the exact path). A
// chunk is one wave of ~16 warps an SM: four chunks in one launch take
// 0.76 ms a chunk of primary rays, so ~40% of the card's rate goes unused
// at one. Past that, not measured (no profiler of the SM's stalls runs
// there): on bounce rays a lane walks its kept rows alone, so a group costs
// its busiest lane's rows while the other lanes idle.
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense_common.cuh"

namespace {

using ptgs_dense::kCols;
using ptgs_dense::kFullWarp;
using ptgs_dense::kRays;
using ptgs_dense::kStage;
using ptgs_dense::kStageFloats;

struct TopkParams {
  float t_min, t_max, alpha_min, alpha_max, gval_cut;
};

// Starts the copies of stage `base` (its sorted rows, their indices and
// sort depths) into one buffer and commits them as one group.
__device__ __forceinline__ void stage_async(const float* sorted_rows,
                                            const int* order,
                                            const float* sort_depths,
                                            int n_gauss, int base, float* sg,
                                            int* so, float* sk) {
  if (base < n_gauss) {
    const int cnt = min(kStage, n_gauss - base);
    const int j = threadIdx.x;
    ptgs_dense::stage_rows_async(sorted_rows, base, cnt, sg);
    if (j < cnt) {
      ptgs_dense::cp_async4(so + j, order + base + j);
      if (sort_depths != nullptr)
        ptgs_dense::cp_async4(sk + j, sort_depths + base + j);
    }
  }
  ptgs_dense::cp_async_commit();  // an empty group past the last stage
}

template <int KMAX>
__global__ void __launch_bounds__(kRays) dense_topk_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ rows, const float* __restrict__ sorted_rows,
    const int* __restrict__ order, const float* __restrict__ groups,
    const float* __restrict__ sort_depths,
    const unsigned char* __restrict__ active, int* __restrict__ idx_out,
    float* __restrict__ t_out, float* __restrict__ alpha_out, int n_rays,
    int n_gauss, int k, TopkParams prm) {
  __shared__ __align__(16) float sg[2][kStageFloats];
  __shared__ int so[2][kStage];
  __shared__ float sk[2][kStage];

  const int ray = blockIdx.x * kRays + threadIdx.x;
  const bool in_range = ray < n_rays;
  const bool live = in_range && (active == nullptr || active[ray] != 0);

  float keys[KMAX];
  int ids[KMAX];
  for (int s = 0; s < k; ++s) {
    keys[s] = CUDART_INF_F;
    ids[s] = 0;
  }
  ptgs_dense::Ray r{};
  if (in_range) r = ptgs_dense::load_ray(origins, dirs, ray);
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float tt = prm.t_min * prm.t_min * dd;  // tau = t_min

  // A block with no live ray skips the scan (uniform over the block).
  if (__syncthreads_or(live)) {
    float worst = CUDART_INF_F;  // the K-th (key, index) once K are kept
    int worst_id = 0, n_kept = 0;
    stage_async(sorted_rows, order, sort_depths, n_gauss, 0, sg[0], so[0],
                sk[0]);
    for (int base = 0, buf = 0; base < n_gauss; base += kStage, buf ^= 1) {
      const int cnt = min(kStage, n_gauss - base);
      // The next stage loads into the other buffer, which the previous
      // iteration's closing barrier freed, while this one is tested.
      stage_async(sorted_rows, order, sort_depths, n_gauss, base + kStage,
                  sg[buf ^ 1], so[buf ^ 1], sk[buf ^ 1]);
      ptgs_dense::cp_async_wait<1>();
      __syncthreads();
      const float* g0 = sg[buf];
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        // A warp none of whose rays can reach the 32 rows' sphere skips
        // them.
        bool reach = live;
        if (reach) {
          const float4* sph = reinterpret_cast<const float4*>(
              groups + ((base + j0) / 32) * ptgs_dense::kGroupCols);
          const float4 radii = __ldg(sph + 1);
          reach = ptgs_dense::group_keep(r, dd, tt, __ldg(sph), radii.x,
                                         radii.y);
        }
        if (!__any_sync(kFullWarp, reach)) continue;
        unsigned pend =
            reach ? ptgs_dense::cull_mask<1>(r, dd, tt, g0, j0, cnt) : 0u;
        // Each lane walks its own kept rows in staged order; the warp
        // loops while any lane has one left (a vote), so it runs the
        // exact path as often as its busiest lane, not once per row any
        // lane keeps.
        while (__any_sync(kFullWarp, pend != 0u)) {
          if (pend == 0u) continue;
          const int j = j0 + __ffs(pend) - 1;
          pend &= pend - 1u;
          const ptgs_dense::Peak p = ptgs_dense::peak(
              r, g0 + j * kCols, prm.t_min, prm.t_max, prm.alpha_min,
              prm.alpha_max, prm.gval_cut);
          if (!(p.alpha > 0.0f)) continue;
          const float key = sort_depths != nullptr ? sk[buf][j] : p.t;
          const int id = so[buf][j];
          // (key, index) order: the rows come in Morton order, and equal
          // keys go by index, as the plain version's stable sort has them.
          if (!(key < worst || (key == worst && id < worst_id))) continue;
          // Enter past the last entry (or over the K-th) and shift only the
          // entries that sort after the new one: lanes insert at different
          // rows, so the warp pays for every lane's shifts in turn.
          int pos = min(n_kept, k - 1);
          while (pos > 0 && (keys[pos - 1] > key ||
                             (keys[pos - 1] == key && ids[pos - 1] > id))) {
            keys[pos] = keys[pos - 1];
            ids[pos] = ids[pos - 1];
            --pos;
          }
          keys[pos] = key;
          ids[pos] = id;
          n_kept = min(n_kept + 1, k);
          if (n_kept == k) {
            worst = keys[k - 1];
            worst_id = ids[k - 1];
          }
        }
      }
      __syncthreads();  // this buffer is no longer read
    }
    ptgs_dense::cp_async_wait<0>();
  }

  if (!in_range) return;
  const size_t row = static_cast<size_t>(ray) * k;
  for (int s = 0; s < k; ++s) {
    int g = 0;
    float t = prm.t_max, alpha = 0.0f;
    if (keys[s] < CUDART_INF_F) {  // a kept Gaussian (live rays only)
      g = ids[s];
      const ptgs_dense::Peak p = ptgs_dense::peak(
          r, rows + static_cast<size_t>(g) * kCols, prm.t_min, prm.t_max,
          prm.alpha_min, prm.alpha_max, prm.gval_cut);
      t = p.t;
      alpha = p.alpha;
    }
    idx_out[row + s] = g;
    t_out[row + s] = t;
    alpha_out[row + s] = alpha;
  }
}

struct TopkArgs {
  const float *origins, *dirs, *rows, *sorted_rows;
  const int* order;
  const float *groups, *sort_depths;
  const unsigned char* active;
  int* idx;
  float *t, *alpha;
  int n_rays, n_gauss, k;
};

template <int KMAX>
cudaError_t launch(const TopkArgs& a, TopkParams prm, cudaStream_t stream) {
  const int blocks = (a.n_rays + kRays - 1) / kRays;
  dense_topk_kernel<KMAX><<<blocks, kRays, 0, stream>>>(
      a.origins, a.dirs, a.rows, a.sorted_rows, a.order, a.groups,
      a.sort_depths, a.active, a.idx, a.t, a.alpha, a.n_rays, a.n_gauss, a.k,
      prm);
  return cudaGetLastError();
}

}  // namespace

// origins, dirs (R, 3); rows (N, 16) (kernels/dense_trace.py:
// gaussian_table) and its DenseTable: sorted_rows (N, 16) (16-byte
// aligned), order (N,) int32, groups (ceil(N / 32), 8); optional
// sort_depths (N,) in sorted_rows' order and active (R,)
// (bool as bytes; NULL for none) in; idx (R, K) int32, t and alpha (R, K)
// float32 out; all contiguous. 1 <= K <= min(128, N). Returns a
// cudaError_t.
extern "C" int ptgs_dense_topk(const float* origins, const float* dirs,
                               const float* rows, const float* sorted_rows,
                               const int* order, const float* groups,
                               const float* sort_depths,
                               const unsigned char* active, int* idx,
                               float* t, float* alpha, int n_rays,
                               int n_gauss, int k, float t_min, float t_max,
                               float alpha_min, float alpha_max,
                               float gval_cut, void* stream) {
  if (n_rays <= 0 || n_gauss <= 0 || k <= 0 || k > n_gauss ||
      groups == nullptr || reinterpret_cast<size_t>(sorted_rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TopkArgs a{origins, dirs, rows, sorted_rows, order, groups,
                   sort_depths, active, idx, t, alpha, n_rays, n_gauss, k};
  const TopkParams prm{t_min, t_max, alpha_min, alpha_max, gval_cut};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) return static_cast<int>(launch<32>(a, prm, s));
  if (k <= 64) return static_cast<int>(launch<64>(a, prm, s));
  if (k <= 128) return static_cast<int>(launch<128>(a, prm, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

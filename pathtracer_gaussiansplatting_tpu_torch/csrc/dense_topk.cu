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
// What bounds it on this card: arithmetic. Every (ray, Gaussian) pair
// costs ~60 float operations, a division and an exp (640k rays x 50k
// Gaussians = 3.2e10 pairs per full-frame pass), against 52 bytes of
// Gaussian per pair that all rays of a block share. So: one thread per
// ray, with its origin and direction in registers; Gaussians staged
// through shared memory 128 at a time (read by every thread as a
// broadcast; the 50k-row table, 2.6 MB, stays in L2); each thread keeps
// its sorted list of K (key, index) pairs in local memory and inserts
// only when a key beats its current K-th, which after the first few
// hundred Gaussians is rare. Visiting Gaussians in index order and
// inserting only on a strictly smaller key keeps the lower index on a tie.
// t and alpha of the K kept Gaussians are recomputed at the end from the
// table (bit-equal: the same operations), so the list holds two words a
// slot. No culling: every pair is evaluated.
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense_common.cuh"

namespace {

using ptgs_dense::kCols;
using ptgs_dense::kRays;
using ptgs_dense::kStage;

struct TopkParams {
  float t_min, t_max, alpha_min, alpha_max, gval_cut;
};

template <int KMAX>
__global__ void __launch_bounds__(kRays) dense_topk_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ table, const float* __restrict__ sort_depths,
    const unsigned char* __restrict__ active, int* __restrict__ idx_out,
    float* __restrict__ t_out, float* __restrict__ alpha_out, int n_rays,
    int n_gauss, int k, TopkParams prm) {
  __shared__ float sg[kCols * kStage];
  __shared__ float sk[kStage];

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

  // A block with no live ray skips the scan (uniform over the block).
  if (__syncthreads_or(live)) {
    float worst = CUDART_INF_F;
    for (int base = 0; base < n_gauss; base += kStage) {
      const int cnt = min(kStage, n_gauss - base);
      __syncthreads();  // the previous stage is no longer read
      ptgs_dense::stage_rows(table, base, cnt, sg);
      if (sort_depths != nullptr)
        for (int j = threadIdx.x; j < cnt; j += blockDim.x)
          sk[j] = sort_depths[base + j];
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < cnt; ++j) {
        const ptgs_dense::Peak p = ptgs_dense::peak(
            r, sg + j, kStage, prm.t_min, prm.t_max, prm.alpha_min,
            prm.alpha_max, prm.gval_cut);
        if (!(p.alpha > 0.0f)) continue;
        const float key = sort_depths != nullptr ? sk[j] : p.t;
        if (!(key < worst)) continue;
        int pos = k - 1;
        while (pos > 0 && keys[pos - 1] > key) {
          keys[pos] = keys[pos - 1];
          ids[pos] = ids[pos - 1];
          --pos;
        }
        keys[pos] = key;
        ids[pos] = base + j;
        worst = keys[k - 1];
      }
    }
  }

  if (!in_range) return;
  const size_t row = static_cast<size_t>(ray) * k;
  for (int s = 0; s < k; ++s) {
    int g = 0;
    float t = prm.t_max, alpha = 0.0f;
    if (keys[s] < CUDART_INF_F) {  // a kept Gaussian (live rays only)
      g = ids[s];
      const ptgs_dense::Peak p = ptgs_dense::peak(
          r, table + static_cast<size_t>(g) * kCols, 1, prm.t_min,
          prm.t_max, prm.alpha_min, prm.alpha_max, prm.gval_cut);
      t = p.t;
      alpha = p.alpha;
    }
    idx_out[row + s] = g;
    t_out[row + s] = t;
    alpha_out[row + s] = alpha;
  }
}

template <int KMAX>
cudaError_t launch(const float* origins, const float* dirs,
                   const float* table, const float* sort_depths,
                   const unsigned char* active, int* idx, float* t,
                   float* alpha, int n_rays, int n_gauss, int k,
                   TopkParams prm, cudaStream_t stream) {
  const int blocks = (n_rays + kRays - 1) / kRays;
  dense_topk_kernel<KMAX><<<blocks, kRays, 0, stream>>>(
      origins, dirs, table, sort_depths, active, idx, t, alpha, n_rays,
      n_gauss, k, prm);
  return cudaGetLastError();
}

}  // namespace

// origins, dirs (R, 3), table (N, 13) (mean, M row-major, opacity),
// optional sort_depths (N,) and active (R,) (bool as bytes; NULL for
// none) in; idx (R, K) int32, t and alpha (R, K) float32 out; all
// contiguous. 1 <= K <= min(128, N). Returns a cudaError_t.
extern "C" int ptgs_dense_topk(const float* origins, const float* dirs,
                               const float* table, const float* sort_depths,
                               const unsigned char* active, int* idx,
                               float* t, float* alpha, int n_rays,
                               int n_gauss, int k, float t_min, float t_max,
                               float alpha_min, float alpha_max,
                               float gval_cut, void* stream) {
  if (n_rays <= 0 || n_gauss <= 0 || k <= 0 || k > n_gauss)
    return static_cast<int>(cudaErrorInvalidValue);
  const TopkParams prm{t_min, t_max, alpha_min, alpha_max, gval_cut};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    return static_cast<int>(launch<32>(origins, dirs, table, sort_depths,
                                       active, idx, t, alpha, n_rays,
                                       n_gauss, k, prm, s));
  if (k <= 64)
    return static_cast<int>(launch<64>(origins, dirs, table, sort_depths,
                                       active, idx, t, alpha, n_rays,
                                       n_gauss, k, prm, s));
  if (k <= 128)
    return static_cast<int>(launch<128>(origins, dirs, table, sort_depths,
                                        active, idx, t, alpha, n_rays,
                                        n_gauss, k, prm, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

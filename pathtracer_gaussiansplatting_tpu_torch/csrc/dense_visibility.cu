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
// What bounds it on this card: arithmetic, as for dense_topk.cu (~60
// float operations, a division and an exp per pair, 52 bytes of Gaussian
// per pair shared by the block). One thread per segment keeps its product
// in a register; Gaussians are staged through shared memory 128 at a time.
// The product runs in index order; the plain version's torch.prod reduces
// in another order, so the two agree to rounding, not bit for bit.
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dense_common.cuh"

namespace {

using ptgs_dense::kCols;
using ptgs_dense::kRays;
using ptgs_dense::kStage;

__global__ void __launch_bounds__(kRays) dense_visibility_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_end, const float* __restrict__ table,
    const unsigned char* __restrict__ active, float* __restrict__ vis_out,
    int n_rays, int n_gauss, float t_min, float alpha_min,
    float alpha_max) {
  __shared__ float sg[kCols * kStage];

  const int ray = blockIdx.x * kRays + threadIdx.x;
  const bool in_range = ray < n_rays;
  const bool live = in_range && (active == nullptr || active[ray] != 0);
  ptgs_dense::Ray r{};
  float te = 0.0f;
  if (in_range) {
    r = ptgs_dense::load_ray(origins, dirs, ray);
    te = t_end[ray];
  }

  float vis = 1.0f;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_gauss; base += kStage) {
      const int cnt = min(kStage, n_gauss - base);
      __syncthreads();
      ptgs_dense::stage_rows(table, base, cnt, sg);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < cnt; ++j) {
        const float alpha = ptgs_dense::segment_alpha(
            r, sg + j, kStage, t_min, te, alpha_min, alpha_max);
        vis = __fmul_rn(vis, __fsub_rn(1.0f, alpha));
      }
    }
  }
  if (in_range) vis_out[ray] = vis;
}

}  // namespace

// origins, dirs (R, 3), t_end (R,), table (N, 13), optional active (R,)
// (bool as bytes; NULL for none) in; vis (R,) out; float32, contiguous.
// Returns a cudaError_t.
extern "C" int ptgs_dense_visibility(const float* origins, const float* dirs,
                                     const float* t_end, const float* table,
                                     const unsigned char* active, float* vis,
                                     int n_rays, int n_gauss, float t_min,
                                     float alpha_min, float alpha_max,
                                     void* stream) {
  if (n_rays <= 0 || n_gauss <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + kRays - 1) / kRays;
  dense_visibility_kernel<<<blocks, kRays, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, t_end, table, active, vis, n_rays, n_gauss, t_min,
      alpha_min, alpha_max);
  return static_cast<int>(cudaGetLastError());
}

// Forward fused tile composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// pathtracer_gaussiansplatting_tpu/kernels/tile_composite.py:_fwd_kernel.
// For one 16x16 screen tile (P = 256 pixels) and its K depth-sorted
// Gaussian slots, every pixel composites front to back:
//
//   a = d^T Q d, b = d^T Q (o - mu)           (9 FMAs from the packet rows)
//   t = clip(-b / a, t_min, t_max),  q = (a t + 2 b) t + c
//   alpha = opac * exp(-q / 2), with the sigma_cut / alpha_min cutoffs and
//           the alpha_max clamp
//   w = T * alpha,  T *= 1 - alpha,  out += w * feats,  s += w * t
//
// and writes out (T, P, F), alpha_acc = 1 - T and depth = s / alpha_acc.
//
// What bounds it on this card: exp and FMA throughput, not memory. Each
// (pixel, slot) pair costs ~85 flops and one exp, while a slot's 25 packet
// floats are read once per tile and reused by all 256 pixels. The design
// follows from that: one thread block per tile, one thread per pixel, the pixel's
// direction, T, 14 feature sums and depth sum kept in registers; K is
// walked in chunks of 128 slots whose 11 geometry rows and F feature rows
// (~13 KB) are staged in shared memory, where every slot value is read by
// all threads of the block as a broadcast.
//
// The chunk schedule is the reference's: a chunk is skipped when the
// tile's count is at or below its start, and every chunk after the first
// is skipped once the block-wide max of T is at or below
// transmittance_min. Pixels do not stop on their own. Everything is
// float32; no TF32 or bf16 anywhere (exp of the quadratic amplifies
// truncated operands).
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "tile_composite_common.cuh"

namespace {

using ptgs::block_max;
using ptgs::kGeomRows;
using ptgs::kGeomUsed;
using ptgs::kMaxPixels;
using ptgs::Params;

template <int F>
__global__ void __launch_bounds__(kMaxPixels) tile_composite_fwd_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    float* __restrict__ out, float* __restrict__ alpha_acc,
    float* __restrict__ depth, int p, int k, int kc, Params prm) {
  extern __shared__ float smem[];
  float* sg = smem;                   // [kGeomUsed][kc]
  float* sf = smem + kGeomUsed * kc;  // [F][kc]
  __shared__ float red[32];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const ptgs::PixelDir pd =
      ptgs::load_dir(dirs + (static_cast<size_t>(tile) * p + pix) * 3);

  float trans = 1.0f, s_depth = 0.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  const float cnt = count[tile];
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;
  const int n_chunks = k / kc;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int start = ci * kc;
    // count and the block max are uniform over the block, and neither
    // test can pass again once it fails: skipping the rest is exact.
    if (!(cnt > static_cast<float>(start))) break;
    if (ci > 0 && !(block_max(trans, red) > prm.transmittance_min)) break;

    __syncthreads();  // the previous chunk's slots are no longer read
    for (int i = threadIdx.x; i < kGeomUsed * kc; i += blockDim.x)
      sg[i] = g_tile[(i / kc) * k + start + i % kc];
    for (int i = threadIdx.x; i < F * kc; i += blockDim.x)
      sf[i] = f_tile[(i / kc) * k + start + i % kc];
    __syncthreads();

    // Slots at or past count are masked (opacity 0, alpha 0): leaving
    // them out changes nothing.
    const int n = min(kc, static_cast<int>(ceilf(cnt)) - start);
    for (int j = 0; j < n; ++j) {
      // alpha is bit-equal to the plain version's (see the shared header).
      const ptgs::SlotEval e = ptgs::eval_slot(pd, sg, kc, j, prm);
      ptgs::composite_slot<F>(e, sf, kc, j, trans, s_depth, acc);
    }
  }

  const size_t px = static_cast<size_t>(tile) * p + pix;
  const float aa = 1.0f - trans;
  alpha_acc[px] = aa;
  depth[px] = s_depth / fmaxf(aa, 1e-8f);
#pragma unroll
  for (int f = 0; f < F; ++f) out[px * F + f] = acc[f];
}

template <int F>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, float* out, float* alpha_acc,
                   float* depth, int n_tiles, int p, int k, int kc,
                   Params prm, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kGeomUsed + F) * kc * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_composite_fwd_kernel<F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  tile_composite_fwd_kernel<F><<<n_tiles, p, smem, stream>>>(
      count, dirs, geom, feats, out, alpha_acc, depth, p, k, kc, prm);
  return cudaGetLastError();
}

}  // namespace

// count (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, F, K) in;
// out (T, P, F), alpha_acc (T, P), depth (T, P) out; all float32,
// contiguous. P must be a multiple of 32 and at most 256, kc must divide
// K, and F must be 14 (the packet features). Returns a cudaError_t.
extern "C" int ptgs_tile_composite_fwd(
    const float* count, const float* dirs, const float* geom,
    const float* feats, float* out, float* alpha_acc, float* depth,
    int n_tiles, int p, int k, int f, int kc, float t_min, float t_max,
    float alpha_min, float alpha_max, float gval_cut,
    float transmittance_min, void* stream) {
  if (n_tiles <= 0 || p <= 0 || p > kMaxPixels || p % 32 != 0 || kc <= 0 ||
      k % kc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{t_min, t_max, alpha_min, alpha_max, gval_cut,
                   transmittance_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 14:
      return static_cast<int>(launch<14>(count, dirs, geom, feats, out,
                                         alpha_acc, depth, n_tiles, p, k, kc,
                                         prm, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

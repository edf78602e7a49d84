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
// What bounds it on this card: instruction issue, not memory. Each
// (pixel, slot) pair costs ~66 flops, a division and an exp, while a
// slot's 25 packet floats are read once per tile and reused by all 256
// pixels. The design:
//
//   * One thread block per tile, one thread per pixel; the pixel's
//     direction, T, 14 feature sums and depth sum stay in registers.
//   * K is walked in stages of kStage = 32 slots (a compile-time constant)
//     staged slot-major in shared memory (tile_composite_common.cuh), 28
//     floats a slot padded to 16-byte words: a pair reads its slot as 7
//     broadcast float4 loads (was 25 strided 4-byte loads).
//   * The stages are double-buffered: cp.async copies the next stage
//     while the block evaluates this one; the slot loop is unrolled.
//   * A warp none of whose pixels has alpha > 0 at a slot skips the
//     composite step (14 feature FMAs, depth and T): alpha = 0 gives w = 0,
//     T (1 - 0) = T and fma(0, x, s) = s, so no bit changes.
//
// The chunk schedule is the reference's: chunks of kc slots (128, or K
// when 128 does not divide it); one is skipped when the tile's count is at
// or below its start, and every chunk after the first is skipped once the
// block-wide max of T is at or below transmittance_min. Pixels do not stop
// on their own. The per-pixel arithmetic and the slot order are those of
// the shared header, so the outputs are bit-equal to the plain version's
// alpha and to the ablation harness's full mode. Everything is float32;
// no TF32 or bf16 anywhere (exp of the quadratic amplifies truncated
// operands).
//
// Every other tile size up to 2048 pixels (tile_composite_fwd_cluster_kernel:
// P not a multiple of 32, or above 256; tiles up to 45x45): one
// thread-block cluster a tile, of G = ceil(P / 256) CTAs (csrc
// tile_composite_common.cuh, any_p_plan). CTA r holds pixels
// [256 r, 256 r + 256), a thread a pixel with its state in registers as
// above, and stages each stage of slots once into its own buffers. The
// chunk skip needs the max of T over the whole tile: at each chunk
// boundary every CTA puts its block max in shared memory and, after a
// cluster barrier, reads the others' through distributed shared memory
// (cluster_max). Each CTA writes its pixels' outputs once, at the end. The
// lanes past P repeat pixel P - 1 and store nothing; they give T = 0 to
// the max, and a warp of such lanes alone skips the slot work (it still
// copies stages and joins the barriers). A cluster of one CTA (P up to
// 256) takes no cluster barrier. Each pixel's result is the 16x16
// kernel's for the same pixel under the same chunk schedule, bit for bit.
//
// Above 2048 pixels (tile_composite_fwd_group_kernel): one block of 256
// threads a tile takes the tile's pixels in groups of 256, chunk by chunk.
// Each group runs the chunk in turn with the forward's per-pixel code and
// keeps each pixel's T, depth sum and feature sums in its outputs between
// chunks; the block max of T over the groups decides the skip. The lanes
// past P repeat pixel P - 1 and store nothing: their T is a pixel's T, so
// the max does not change.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_composite_common.cuh"

namespace {

using ptgs::kGeomRows;
using ptgs::kMaxPixels;
using ptgs::kStage;
using ptgs::Params;


template <int F>
__global__ void __launch_bounds__(kMaxPixels) tile_composite_fwd_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    float* __restrict__ out, float* __restrict__ alpha_acc,
    float* __restrict__ depth, int p, int k, int kc, Params prm) {
  constexpr int kS = ptgs::slot_floats<F>();
  __shared__ __align__(16) float stage[2][kStage * kS];
  __shared__ float red[32];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const ptgs::PixelDir pd =
      ptgs::load_dir(dirs + (static_cast<size_t>(tile) * p + pix) * 3);

  float trans = 1.0f, s_depth = 0.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  // Slots at or past count are masked (opacity 0, alpha 0): leaving them
  // out changes nothing, and a chunk that starts there is skipped.
  const int n_valid = min(k, max(0, static_cast<int>(ceilf(count[tile]))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;
  ptgs::forward_tile<F, true>(pd, g_tile, f_tile, k, kc, n_valid, prm, stage,
                              red, trans, s_depth, acc);

  const size_t px = static_cast<size_t>(tile) * p + pix;
  const float aa = 1.0f - trans;
  alpha_acc[px] = aa;
  depth[px] = s_depth / fmaxf(aa, 1e-8f);
#pragma unroll
  for (int f = 0; f < F; ++f) out[px * F + f] = acc[f];
}

// The cluster kernel: see the top of this file. Launched with a cluster
// of G CTAs along x, G CTAs a tile.
template <int F>
__global__ void __launch_bounds__(kMaxPixels) tile_composite_fwd_cluster_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    float* __restrict__ out, float* __restrict__ alpha_acc,
    float* __restrict__ depth, int p, int k, int kc, Params prm) {
  constexpr int kS = ptgs::slot_floats<F>();
  __shared__ __align__(16) float stage[2][kStage * kS];
  __shared__ float red[32];
  __shared__ float t_slot[2];  // this CTA's max of T, by chunk parity

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int tile = blockIdx.x / cluster.num_blocks();
  const int pix = cluster.block_rank() * blockDim.x + threadIdx.x;
  const bool real = pix < p;
  const bool warp_real = pix - static_cast<int>(threadIdx.x & 31) < p;
  const size_t px = static_cast<size_t>(tile) * p + min(pix, p - 1);
  const ptgs::PixelDir pd = ptgs::load_dir(dirs + px * 3);

  float trans = 1.0f, s_depth = 0.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  const int n_valid = min(k, max(0, static_cast<int>(ceilf(count[tile]))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;
  ptgs::stage_loop_by<F, true>(
      g_tile, f_tile, k, kc, n_valid, prm.transmittance_min, stage,
      [&](int chunk) {
        return ptgs::cluster_max(real ? trans : 0.0f, red, t_slot, chunk & 1);
      },
      [&](const float* sb, int, int n) {
        if (!warp_real) return;  // uniform over the warp
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const ptgs::SlotEval e =
              ptgs::eval_geom(pd, ptgs::stage_geom(sb, kS, j), prm);
          if (__any_sync(ptgs::kFullWarp, e.live)) {
            float fv[F];
            ptgs::stage_feats<F>(sb, j, fv);
            ptgs::composite_step<F>(e, [&](int f) { return fv[f]; }, trans,
                                    s_depth, acc);
          }
        }
      });
  // No CTA leaves while another may still read its t_slot.
  if (cluster.num_blocks() > 1) cluster.sync();

  if (!real) return;
  const float aa = 1.0f - trans;
  alpha_acc[px] = aa;
  depth[px] = s_depth / fmaxf(aa, 1e-8f);
#pragma unroll
  for (int f = 0; f < F; ++f) out[px * F + f] = acc[f];
}

// The group-loop kernel (above 2048 pixels): see the top of this file.
template <int F>
__global__ void __launch_bounds__(kMaxPixels) tile_composite_fwd_group_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    float* __restrict__ out, float* __restrict__ alpha_acc,
    float* __restrict__ depth, int p, int k, int kc, Params prm) {
  constexpr int kS = ptgs::slot_floats<F>();
  __shared__ __align__(16) float stage[2][kStage * kS];
  __shared__ float red[32];

  const int tile = blockIdx.x;
  const int n_groups = (p + blockDim.x - 1) / blockDim.x;
  const bool multi = n_groups > 1;  // state kept in the outputs between chunks
  const int n_valid = min(k, max(0, static_cast<int>(ceilf(count[tile]))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;

  float trans = 1.0f, s_depth = 0.0f;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  ptgs::PixelDir pd{};
  float t_hi = 1.0f;  // this thread's largest T after the last chunk
  for (int c0 = 0; c0 < n_valid; c0 += kc) {
    if (c0 > 0 && !(ptgs::block_max(t_hi, red) > prm.transmittance_min))
      break;
    const int n = min(kc, n_valid - c0);
    float t_next = 0.0f;
    for (int g = 0; g < n_groups; ++g) {
      const int pix = g * blockDim.x + threadIdx.x;
      const size_t px = static_cast<size_t>(tile) * p + min(pix, p - 1);
      if (multi || c0 == 0) pd = ptgs::load_dir(dirs + px * 3);
      if (multi && c0 > 0) {
        trans = alpha_acc[px];
        s_depth = depth[px];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = out[px * F + f];
      } else if (multi) {
        trans = 1.0f;
        s_depth = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
      }
      ptgs::stage_loop<F, false>(
          g_tile + c0, f_tile + c0, k, kc, n, prm.transmittance_min, stage,
          red, trans, [&](const float* sb, int, int m) {
#pragma unroll 4
            for (int j = 0; j < m; ++j) {
              const ptgs::SlotEval e =
                  ptgs::eval_geom(pd, ptgs::stage_geom(sb, kS, j), prm);
              if (__any_sync(ptgs::kFullWarp, e.live)) {
                float fv[F];
                ptgs::stage_feats<F>(sb, j, fv);
                ptgs::composite_step<F>(e, [&](int f) { return fv[f]; },
                                        trans, s_depth, acc);
              }
            }
          });
      t_next = fmaxf(t_next, trans);
      if (multi && pix < p) {
        alpha_acc[px] = trans;
        depth[px] = s_depth;
#pragma unroll
        for (int f = 0; f < F; ++f) out[px * F + f] = acc[f];
      }
    }
    t_hi = t_next;
  }

  for (int g = 0; g < n_groups; ++g) {
    const int pix = g * blockDim.x + threadIdx.x;
    if (pix >= p) break;
    const size_t px = static_cast<size_t>(tile) * p + pix;
    if (multi && n_valid > 0) {  // this thread stored them
      trans = alpha_acc[px];
      s_depth = depth[px];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = out[px * F + f];
    }
    const float aa = 1.0f - trans;
    alpha_acc[px] = aa;
    depth[px] = s_depth / fmaxf(aa, 1e-8f);
#pragma unroll
    for (int f = 0; f < F; ++f) out[px * F + f] = acc[f];
  }
}

template <int F>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, float* out, float* alpha_acc,
                   float* depth, int n_tiles, int p, int k, int kc,
                   Params prm, cudaStream_t stream) {
  const ptgs::Plan plan = ptgs::any_p_plan(p);
  if (plan.path == ptgs::kOneBlock) {
    tile_composite_fwd_kernel<F><<<n_tiles, p, 0, stream>>>(
        count, dirs, geom, feats, out, alpha_acc, depth, p, k, kc, prm);
  } else if (plan.path == ptgs::kGroupLoop) {
    tile_composite_fwd_group_kernel<F><<<n_tiles, plan.threads, 0, stream>>>(
        count, dirs, geom, feats, out, alpha_acc, depth, p, k, kc, prm);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    ptgs::cluster_config(cfg, attr, n_tiles, plan, 0, stream);
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, tile_composite_fwd_cluster_kernel<F>, count, dirs, geom, feats,
        out, alpha_acc, depth, p, k, kc, prm);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace

// count (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, F, K) in;
// out (T, P, F), alpha_acc (T, P), depth (T, P) out; all float32,
// contiguous. path, g and threads must be any_p_plan(P)'s: the one-block
// kernel (P a multiple of 32 up to 256), the cluster kernel (up to 2048
// pixels) or the group-loop kernel. kc must divide K and be K or a
// multiple of 32, and F must be 14 (the packet features). Returns a
// cudaError_t.
extern "C" int ptgs_tile_composite_fwd(
    const float* count, const float* dirs, const float* geom,
    const float* feats, float* out, float* alpha_acc, float* depth,
    int n_tiles, int p, int k, int f, int kc, int path, int g, int threads,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, float transmittance_min, void* stream) {
  if (n_tiles <= 0 || p <= 0 || kc <= 0 || k % kc != 0 ||
      (kc != k && kc % kStage != 0) || !ptgs::plan_is(p, path, g, threads))
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

// How many clusters of the forward's cluster kernel the card can hold at
// once for a tile of P pixels (cudaOccupancyMaxActiveClusters), into
// *clusters; with g > 0, for clusters of g CTAs instead of any_p_plan(P)'s
// (above 8, non-portable: the attribute that allows them is set first).
// Returns a cudaError_t (cudaErrorInvalidValue where P takes no cluster).
extern "C" int ptgs_tile_composite_fwd_clusters(int p, int g, int* clusters) {
  ptgs::Plan plan = ptgs::any_p_plan(p);
  if (plan.path != ptgs::kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0) plan.g = g;
  return static_cast<int>(ptgs::max_clusters(
      tile_composite_fwd_cluster_kernel<14>, plan, 0, clusters));
}

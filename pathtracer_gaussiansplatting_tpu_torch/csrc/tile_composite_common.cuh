// Per-(pixel, slot) math shared by the forward and backward tile composite
// kernels (tile_composite_fwd.cu, tile_composite_bwd.cu) and the forward's
// ablation harness (tile_composite_variants.cu).
//
// The backward recomputes the forward's alpha, transmittance and chunk
// skip decisions. alpha steps at the sigma_cut and alpha_min cutoffs,
// where one ulp can switch a ~1% contribution on or off, so both kernels
// take the same code from here: a, b, t, q, exp and alpha round op by op
// (no FMA contraction), in the plain PyTorch version's order, and come out
// bit-equal to it and to each other. All three stage their slots
// slot-major and double-buffered (the helpers at the end). The forward
// and the harness share one stage loop (stage_loop) and the forward's
// slot step (forward_tile), so the harness's full mode runs the forward's
// code. The choice of kernel for a tile size (any_p_plan) and the cluster
// kernels' launch and tile-wide max of T (cluster_max) are here too.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace ptgs {

constexpr int kGeomRows = 16;    // rows of the geom packet
constexpr int kGeomUsed = 11;    // q6 (0-5), Q(o-mu) (6-8), c (9), opac (10)
constexpr int kRowC = 9;
constexpr int kRowOpac = 10;
constexpr int kMaxPixels = 256;  // one 16x16 tile per block
constexpr unsigned kFullWarp = 0xffffffffu;

struct Params {
  float t_min, t_max, alpha_min, alpha_max, gval_cut, transmittance_min;
};

// ---- which kernel takes a tile of P pixels --------------------------------
//
// kOneBlock: P a multiple of 32 up to kMaxPixels, one block a tile, a thread
// a pixel. kCluster: any other P up to kMaxClusterCtas * kMaxPixels, one
// thread-block cluster a tile of g = ceil(P / 256) CTAs, CTA r holding
// pixels [256 r, 256 r + 256) with min(P, 256) threads rounded up to a
// warp. kGroupLoop: above that, one block of 256 threads a tile walks its
// pixels in groups of 256. kernels/tile_composite.py's any_p_plan is the
// same rule; the entry points refuse a launch whose (path, g, threads)
// differs from it.
enum Path { kOneBlock = 0, kCluster = 1, kGroupLoop = 2 };
constexpr int kMaxClusterCtas = 8;  // the portable cluster size
struct Plan {
  int path, g, threads;
};

__host__ __device__ constexpr Plan any_p_plan(int p) {
  return p % 32 == 0 && p <= kMaxPixels ? Plan{kOneBlock, 1, p}
         : p <= kMaxClusterCtas * kMaxPixels
             ? Plan{kCluster, (p + kMaxPixels - 1) / kMaxPixels,
                    p < kMaxPixels ? (p + 31) / 32 * 32 : kMaxPixels}
             : Plan{kGroupLoop, 1, kMaxPixels};
}

inline bool plan_is(int p, int path, int g, int threads) {
  const Plan want = any_p_plan(p);
  return want.path == path && want.g == g && want.threads == threads;
}

// A launch of n_tiles clusters of plan.g CTAs along x, plan.threads
// threads each, for cudaLaunchKernelEx. attr holds one attribute.
inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           int n_tiles, const Plan& plan, size_t smem,
                           cudaStream_t stream) {
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles) * plan.g);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// cudaOccupancyMaxActiveClusters of kernel under plan with smem bytes of
// dynamic shared memory (0: none can be scheduled). A cluster above the
// portable size first gets the attribute that allows it.
template <class Kernel>
cudaError_t max_clusters(Kernel kernel, const Plan& plan, size_t smem,
                         int* clusters) {
  if (plan.g > kMaxClusterCtas) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, 1, plan, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

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

// Cluster-wide max of v over the tile's CTAs (the cluster kernels),
// returned to every thread: each CTA's block_max goes to slot[par] of its
// shared memory, and after a cluster barrier every thread reads the CTAs'
// slots through distributed shared memory. A max is exact, so each CTA
// takes the decision one block over the whole tile takes. Callers
// alternate par from one call to the next: a CTA that runs ahead writes
// the other slot, and it can come back to this one only after the next
// call's barrier, which every CTA reaches after its reads. A cluster of
// one CTA takes its block max alone.
__device__ __forceinline__ float cluster_max(float v, float* red, float* slot,
                                             int par) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const float m = block_max(v, red);
  if (cluster.num_blocks() == 1) return m;
  if (threadIdx.x == 0) slot[par] = m;
  cluster.sync();
  float r = *cluster.map_shared_rank(slot + par, 0);
  for (unsigned g = 1; g < cluster.num_blocks(); ++g)
    r = fmaxf(r, *cluster.map_shared_rank(slot + par, g));
  return r;
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

// One slot's geometry: Q's upper triangle q6, Q (o - mu), c and opacity
// (the packet rows 0-10).
struct SlotGeom {
  float q[6], w[3], c, opac;
};

// Evaluates one (pixel, slot) pair. Every kernel takes alpha from here.
__device__ __forceinline__ SlotEval eval_geom(const PixelDir& p,
                                              const SlotGeom& g,
                                              const Params& prm) {
  SlotEval e;
  float a = __fmul_rn(p.dd[0], g.q[0]);
  a = __fadd_rn(a, __fmul_rn(p.dd[1], g.q[1]));
  a = __fadd_rn(a, __fmul_rn(p.dd[2], g.q[2]));
  a = __fadd_rn(a, __fmul_rn(p.dd[3], g.q[3]));
  a = __fadd_rn(a, __fmul_rn(p.dd[4], g.q[4]));
  a = __fadd_rn(a, __fmul_rn(p.dd[5], g.q[5]));
  e.a = fmaxf(a, 1e-12f);
  float b = __fadd_rn(__fmul_rn(p.dx, g.w[0]), __fmul_rn(p.dy, g.w[1]));
  e.b = __fadd_rn(b, __fmul_rn(p.dz, g.w[2]));
  e.t_raw = __fdiv_rn(-e.b, e.a);
  e.t = fminf(fmaxf(e.t_raw, prm.t_min), prm.t_max);
  e.qv = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(e.a, e.t), __fmul_rn(2.0f, e.b)), e.t),
      g.c);
  e.gval = expf(__fmul_rn(-0.5f, fmaxf(e.qv, 0.0f)));
  e.alpha0 = __fmul_rn(g.opac, e.gval);
  e.live = (e.gval >= prm.gval_cut) && (e.alpha0 >= prm.alpha_min);
  e.alpha = e.live ? fminf(e.alpha0, prm.alpha_max) : 0.0f;
  return e;
}

// Transmittance past a slot: T * (1 - alpha), rounded as the forward does.
__device__ __forceinline__ float trans_after(float trans, float alpha) {
  return __fmul_rn(trans, __fsub_rn(1.0f, alpha));
}

// The forward's step over one slot with features feat(f): w = T alpha,
// T *= 1 - alpha, and w added into the depth and F feature sums by
// explicit FMAs, so every kernel that takes this step (the forward, the
// backward's replay and the harness's production modes) rounds it the
// same way.
template <int F, class Feat>
__device__ __forceinline__ void composite_step(const SlotEval& e, Feat feat,
                                               float& trans, float& s_depth,
                                               float* acc) {
  const float w = __fmul_rn(trans, e.alpha);
  trans = trans_after(trans, e.alpha);
  s_depth = __fmaf_rn(w, e.t, s_depth);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = __fmaf_rn(w, feat(f), acc[f]);
}

// ---- slot-major staging (every tile kernel) -----------------------------
//
// A stage of kStage slots lies in shared memory slot by slot, each slot a
// kSlotFloats-float row of 16-byte words: q6 (0-5), Q(o-mu) (6-8), c (9),
// opac (10), a pad (11), then the features (12-), padded to a multiple of
// four. One pair reads its slot as kSlotFloats / 4 broadcast float4 loads.
constexpr int kStage = 32;
constexpr int kFeatCol = 12;
template <int F>
__host__ __device__ constexpr int slot_floats() {
  return kFeatCol + (F + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts copying packet rows 0-10 and the F feature rows of slots
// [s0, s0 + n) (n <= kStage) into the slot-major stage buf, 4 bytes a
// copy: consecutive threads read consecutive slots of one row. Commits a
// group (an empty one where n <= 0), so every thread commits one group a
// stage.
template <int F>
__device__ __forceinline__ void stage_async(const float* g_tile,
                                            const float* f_tile, int k,
                                            int s0, int n, float* buf) {
  constexpr int kS = slot_floats<F>();
  for (int i = threadIdx.x; i < (kGeomUsed + F) * kStage; i += blockDim.x) {
    const int r = i / kStage, j = i % kStage;
    if (j < n) {
      if (r < kGeomUsed)
        cp_async4(buf + j * kS + r, g_tile + r * k + s0 + j);
      else
        cp_async4(buf + j * kS + kFeatCol + r - kGeomUsed,
                  f_tile + (r - kGeomUsed) * k + s0 + j);
    }
  }
  cp_async_commit();
}

// Slot j's geometry from a slot-major stage, as three float4 loads.
__device__ __forceinline__ SlotGeom stage_geom(const float* buf, int kS,
                                               int j) {
  const float4* row = reinterpret_cast<const float4*>(buf + j * kS);
  const float4 v0 = row[0], v1 = row[1], v2 = row[2];
  SlotGeom g;
  g.q[0] = v0.x; g.q[1] = v0.y; g.q[2] = v0.z; g.q[3] = v0.w;
  g.q[4] = v1.x; g.q[5] = v1.y; g.w[0] = v1.z; g.w[1] = v1.w;
  g.w[2] = v2.x; g.c = v2.y; g.opac = v2.z;
  return g;
}

// Slot j's F features from a slot-major stage, as float4 loads.
template <int F>
__device__ __forceinline__ void stage_feats(const float* buf, int j,
                                            float* out) {
  constexpr int kS = slot_floats<F>();
  const float4* row = reinterpret_cast<const float4*>(buf + j * kS + kFeatCol);
#pragma unroll
  for (int q = 0; q < (F + 3) / 4; ++q) {
    const float4 v = row[q];
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < F) out[4 * q + i] = x[i];
  }
}

// ---- the forward's stage loop (the forward kernels and the harness) ------
//
// Walks a tile's slots [0, n_valid) in stages of kStage: cp.async copies
// the next stage into the other half of the double buffer while
// body(sb, s0, n) reads slots [s0, s0 + n) from this one, one
// __syncthreads a stage on each side. With kSkip, each chunk of kc slots
// after the first is skipped once tile_max(chunk), the max of T over the
// tile's pixels, is at or below transmittance_min: the max is uniform over
// the tile and the test cannot pass again once it fails, so the loop ends
// there. kc is K or a multiple of kStage, so a stage never straddles two
// chunks.
template <int F, bool kSkip, class TileMax, class Body>
__device__ __forceinline__ void stage_loop_by(
    const float* g_tile, const float* f_tile, int k, int kc, int n_valid,
    float transmittance_min, float (*stage)[kStage * slot_floats<F>()],
    TileMax tile_max, Body body) {
  stage_async<F>(g_tile, f_tile, k, 0, min(kStage, n_valid), stage[0]);
  for (int s0 = 0, buf = 0; s0 < n_valid; s0 += kStage, buf ^= 1) {
    if (kSkip && s0 > 0 && s0 % kc == 0 &&
        !(tile_max(s0 / kc) > transmittance_min))
      break;
    stage_async<F>(g_tile, f_tile, k, s0 + kStage,
                   min(kStage, n_valid - s0 - kStage), stage[buf ^ 1]);
    cp_async_wait<1>();
    __syncthreads();
    body(static_cast<const float*>(stage[buf]), s0,
         min(kStage, n_valid - s0));
    __syncthreads();  // the stage is no longer read: the next may refill it
  }
  cp_async_wait<0>();
}

// stage_loop_by for a tile held by one block: the block-wide max of trans.
template <int F, bool kSkip, class Body>
__device__ __forceinline__ void stage_loop(
    const float* g_tile, const float* f_tile, int k, int kc, int n_valid,
    float transmittance_min, float (*stage)[kStage * slot_floats<F>()],
    float* red, const float& trans, Body body) {
  stage_loop_by<F, kSkip>(g_tile, f_tile, k, kc, n_valid, transmittance_min,
                          stage, [&](int) { return block_max(trans, red); },
                          body);
}

// The forward's composite of one tile's slots [0, n_valid) into this
// pixel's trans, s_depth and acc[F]. kSkips turns on both skips, the
// chunk test and the warp vote; the forward kernel runs with them. The
// vote: a warp none of whose pixels has alpha > 0 at a slot skips its
// composite step (alpha = 0 gives w = 0, T (1 - 0) = T and
// fma(0, x, s) = s, so no bit changes).
template <int F, bool kSkips>
__device__ __forceinline__ void forward_tile(
    const PixelDir& pd, const float* g_tile, const float* f_tile, int k,
    int kc, int n_valid, const Params& prm,
    float (*stage)[kStage * slot_floats<F>()], float* red, float& trans,
    float& s_depth, float* acc) {
  stage_loop<F, kSkips>(
      g_tile, f_tile, k, kc, n_valid, prm.transmittance_min, stage, red,
      trans, [&](const float* sb, int, int n) {
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const SlotEval e =
              eval_geom(pd, stage_geom(sb, slot_floats<F>(), j), prm);
          if (!kSkips || __any_sync(kFullWarp, e.live)) {
            float fv[F];
            stage_feats<F>(sb, j, fv);
            composite_step<F>(e, [&](int f) { return fv[f]; }, trans,
                              s_depth, acc);
          }
        }
      });
}

}  // namespace ptgs

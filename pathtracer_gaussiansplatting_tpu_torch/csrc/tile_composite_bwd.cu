// Backward (analytic VJP) of the fused tile composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// pathtracer_gaussiansplatting_tpu/kernels/tile_composite.py:_bwd_kernel.
// Given the forward's inputs (count, dirs, geom, feats) and the cotangents
// of its outputs (g_out (T, P, F), g_alpha (T, P), g_depth (T, P)), it
// writes d_dirs (T, P, 3), d_geom (T, 16, K) and d_feats (T, F, K), with
// the forward's chunk schedule: slots of chunks the forward skipped get no
// gradient (the caller zero-fills d_geom and d_feats; rows 11-15 of d_geom
// stay zero).
//
// For w_k = T_k alpha_k, T_k = prod_{j<k} (1 - alpha_j), the compositing
// VJP is the suffix-sum form
//
//   d_alpha_k = d_w_k T_k
//               - (sum_{i>k} d_w_i w_i - d_alpha_acc T_last) / (1 - alpha_k)
//
// with d_w_k = g_out . feats_k + d_s t_k (d_s = g_depth / alpha_acc), and
// from d_alpha the chain through the alpha cutoffs, q(t), t = -b/a, and
// a = d^T Q d, b = d^T Q (o - mu) to the packet rows and the ray direction.
//
// What bounds it on this card: per (pixel, slot) pair it evaluates the
// forward's math three times (phase 1, and twice in phase 2) plus the VJP,
// ~300 flops and three exps, and it reduces 25 per-slot sums over the
// tile's pixels. Memory traffic is one read of the packets and one write
// of the gradients. The design:
//
//   * One thread block per tile, one thread per pixel (P <= 256), as in
//     the forward. Per-pixel state (direction, cotangents, the suffix
//     carry, the d_dirs partial sums) lives in registers.
//   * Phase 1 walks the chunks in forward order with the forward's exact
//     arithmetic (the shared header) and skip tests, so it reaches the same
//     T and the same skip decisions. It records T at the entry of every
//     32-slot sub-block in shared memory and counts the chunks that ran.
//   * Phase 2 walks the sub-blocks of the chunks that ran in reverse. For
//     each it recomputes T before every slot into shared memory (from the
//     recorded entry T, with the forward's products: no division by
//     1 - alpha, which would drift from them), then walks the slots
//     backwards carrying the suffix sum.
//   * Per-slot sums (d_q6 (6), d_wb (3), d_c, d_opac, d_feats (F)) are
//     owned by the block: a transposing butterfly over the warp (31
//     shuffles for 32 values) leaves lane l with value l's warp sum, the
//     warps' partials meet in shared memory, and the block writes each
//     (tile, slot) once. No atomics, so the result is deterministic.
//
// Everything is float32 but the per-pixel sums over slots (double, see
// phase 2). Plain C entry point (bound with ctypes); returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "tile_composite_common.cuh"

namespace {

using ptgs::block_max;
using ptgs::kGeomRows;
using ptgs::kGeomUsed;
using ptgs::kMaxPixels;
using ptgs::Params;

constexpr int kSub = 32;  // slots per sub-block of phase 2

// Leaves in lane l the sum over the warp of v[l]; v is clobbered.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// Stages geometry rows 0-10 and the F feature rows of slots
// [s0, s0 + n) into sg[kGeomUsed][kSub] and sf[F][kSub].
template <int F>
__device__ __forceinline__ void stage(const float* g_tile,
                                      const float* f_tile, int k, int s0,
                                      int n, float* sg, float* sf) {
  for (int i = threadIdx.x; i < (kGeomUsed + F) * kSub; i += blockDim.x) {
    const int r = i / kSub, j = i % kSub;
    float v = 0.0f;
    if (j < n)
      v = r < kGeomUsed ? g_tile[r * k + s0 + j]
                        : f_tile[(r - kGeomUsed) * k + s0 + j];
    (r < kGeomUsed ? sg[r * kSub + j] : sf[(r - kGeomUsed) * kSub + j]) = v;
  }
}

template <int F>
__global__ void __launch_bounds__(kMaxPixels) tile_composite_bwd_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    const float* __restrict__ g_out, const float* __restrict__ g_alpha,
    const float* __restrict__ g_depth, float* __restrict__ d_dirs,
    float* __restrict__ d_geom, float* __restrict__ d_feats, int p, int k,
    int kc, Params prm) {
  constexpr int kSums = kGeomUsed + F;  // per-slot sums: geom rows, feats
  static_assert(kSums <= 32, "one warp lane per per-slot sum");
  const int n_sub = (k + kSub - 1) / kSub;
  const int n_warps = p >> 5;
  extern __shared__ float smem[];
  float* sg = smem;                   // [kGeomUsed][kSub]
  float* sf = sg + kGeomUsed * kSub;  // [F][kSub]
  float* s_tex = sf + F * kSub;       // [kSub][p]: T before each slot
  float* s_tsub = s_tex + kSub * p;   // [n_sub][p]: T at sub-block entry
  float* s_part = s_tsub + n_sub * p; // [kSub][n_warps][kSums]
  __shared__ float red[32];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31, warp = pix >> 5;
  const size_t px = static_cast<size_t>(tile) * p + pix;
  const ptgs::PixelDir pd = ptgs::load_dir(dirs + px * 3);
  const float cnt = count[tile];
  const int n_valid = min(k, max(0, static_cast<int>(ceilf(cnt))));
  const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
  const float* f_tile = feats + static_cast<size_t>(tile) * F * k;

  // ---- phase 1 (forward order): T at sub-block entries, s_depth ------
  float trans = 1.0f, s_depth = 0.0f;
  int n_run = 0;  // chunks the forward ran
  const int n_chunks = k / kc;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int start = ci * kc;
    if (!(cnt > static_cast<float>(start))) break;
    if (ci > 0 && !(block_max(trans, red) > prm.transmittance_min)) break;
    n_run = ci + 1;
    // start is 0 or a multiple of 128, so sub-blocks align with chunks.
    for (int s0 = start; s0 < start + kc; s0 += kSub) {
      s_tsub[(s0 / kSub) * p + pix] = trans;
      // The forward stops at count: slots past it have alpha 0.
      const int n = min(min(kSub, start + kc - s0), n_valid - s0);
      if (n <= 0) continue;  // uniform over the block
      __syncthreads();       // the previous sub-block is no longer read
      stage<F>(g_tile, f_tile, k, s0, n, sg, sf);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const ptgs::SlotEval e = ptgs::eval_slot(pd, sg, kSub, j, prm);
        const float w = trans * e.alpha;
        trans = ptgs::trans_after(trans, e.alpha);
        s_depth += w * e.t;
      }
    }
  }

  const float t_last = trans;
  const float aa = 1.0f - t_last;
  const float denom = fmaxf(aa, 1e-8f);
  const float gd = g_depth[px];
  const float d_s = gd / denom;
  const float d_aa =
      g_alpha[px] + (aa > 1e-8f ? -gd * s_depth / (denom * denom) : 0.0f);
  const float d_aa_t = d_aa * t_last;  // every slot's share of alpha_acc
  float go[F];
#pragma unroll
  for (int f = 0; f < F; ++f) go[f] = g_out[px * F + f];

  // ---- phase 2 (reverse order): recompute + VJP -----------------------
  // The per-pixel sums over up to K slots run in double: their terms are
  // large (q6 ~ 1/sigma^2) and cancel, and a float32 running sum loses
  // the small result (d_dirs) or feeds its error through 1 / (1 - alpha)
  // (the suffix carry). A dozen double adds per slot cost little.
  double carry = 0.0;  // sum over later slots of d_w w
  double ddq[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // sum d_a q6
  double ddb[3] = {0.0, 0.0, 0.0};                 // sum d_b Q(o-mu)
  const int k_run = min(n_run * kc, k);
  for (int sb = (k_run + kSub - 1) / kSub - 1; sb >= 0; --sb) {
    const int s0 = sb * kSub;
    const int n = min(kSub, k_run - s0);
    __syncthreads();  // sg, sf, s_tex and s_part are no longer read
    stage<F>(g_tile, f_tile, k, s0, n, sg, sf);
    __syncthreads();
    float tr = s_tsub[sb * p + pix];
    for (int j = 0; j < n; ++j) {
      s_tex[j * p + pix] = tr;
      tr = ptgs::trans_after(tr, ptgs::eval_slot(pd, sg, kSub, j, prm).alpha);
    }
    for (int j = n - 1; j >= 0; --j) {
      const ptgs::SlotEval e = ptgs::eval_slot(pd, sg, kSub, j, prm);
      const float t_ex = s_tex[j * p + pix];
      const float w = t_ex * e.alpha;
      float d_w = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) d_w += go[f] * sf[f * kSub + j];
      d_w += d_s * e.t;
      const float d_t = d_s * w;  // depth chain
      const float d_log_om = static_cast<float>(carry) - d_aa_t;
      carry += static_cast<double>(d_w) * w;
      const float d_alpha =
          d_w * t_ex - d_log_om / fmaxf(1.0f - e.alpha, 1e-6f);
      const bool grad_live = e.live && e.alpha0 <= prm.alpha_max;
      const float d_alpha0 = grad_live ? d_alpha : 0.0f;
      const float opac = sg[ptgs::kRowOpac * kSub + j];
      // The clamps pass the gradient at their bounds, as the plain
      // version's do. For q that matters: q = c - b^2/a cancels, and for a
      // ray through a splat's center float32 often rounds it to exactly 0
      // (the JAX kernel's q > 0 drops the term there; float64 keeps it).
      const float d_qv =
          e.qv >= 0.0f ? -0.5f * (d_alpha0 * opac) * e.gval : 0.0f;
      // q chain: t picks up 2(a t + b) (zero at the interior peak,
      // nonzero where t is clipped); t = -b/a only where not clipped.
      const bool t_in = e.t_raw >= prm.t_min && e.t_raw <= prm.t_max;
      const float d_t2 = d_t + d_qv * 2.0f * (e.a * e.t + e.b);
      const float d_a =
          d_qv * e.t * e.t + (t_in ? d_t2 * (e.b / (e.a * e.a)) : 0.0f);
      const float d_b = d_qv * 2.0f * e.t + (t_in ? -d_t2 / e.a : 0.0f);
#pragma unroll
      for (int r = 0; r < 6; ++r)
        ddq[r] += static_cast<double>(d_a) * sg[r * kSub + j];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        ddb[r] += static_cast<double>(d_b) * sg[(6 + r) * kSub + j];

      // This pixel's share of the slot's sums, in d_geom / d_feats row
      // order: q6 (0-5), Q(o-mu) (6-8), c (9), opac (10), feats (11-).
      float v[32];
#pragma unroll
      for (int r = 0; r < 6; ++r) v[r] = pd.dd[r] * d_a;
      v[6] = pd.dx * d_b;
      v[7] = pd.dy * d_b;
      v[8] = pd.dz * d_b;
      v[9] = d_qv;
      v[10] = d_alpha0 * e.gval;
#pragma unroll
      for (int f = 0; f < F; ++f) v[kGeomUsed + f] = go[f] * w;
#pragma unroll
      for (int r = kSums; r < 32; ++r) v[r] = 0.0f;
      const float sum = warp_transpose_sum(v, lane);
      if (lane < kSums) s_part[(j * n_warps + warp) * kSums + lane] = sum;
    }
    __syncthreads();
    // One thread per (row, slot): add the warps' partials and write.
    for (int i = threadIdx.x; i < kSums * n; i += blockDim.x) {
      const int r = i / n, j = i % n;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w)
        s += s_part[(j * n_warps + w) * kSums + r];
      if (r < kGeomUsed)
        d_geom[(static_cast<size_t>(tile) * kGeomRows + r) * k + s0 + j] = s;
      else
        d_feats[(static_cast<size_t>(tile) * F + r - kGeomUsed) * k + s0 + j] =
            s;
    }
  }

  // a = sum_r dd_r q6_r and b = d . Q(o-mu): chain to the direction.
  const double dx = pd.dx, dy = pd.dy, dz = pd.dz;
  float* dd_out = d_dirs + px * 3;
  dd_out[0] = static_cast<float>(2.0 * dx * ddq[0] + dy * ddq[3] +
                                 dz * ddq[4] + ddb[0]);
  dd_out[1] = static_cast<float>(2.0 * dy * ddq[1] + dx * ddq[3] +
                                 dz * ddq[5] + ddb[1]);
  dd_out[2] = static_cast<float>(2.0 * dz * ddq[2] + dx * ddq[4] +
                                 dy * ddq[5] + ddb[2]);
}

size_t smem_bytes(int f, int p, int k) {
  const int n_sub = (k + kSub - 1) / kSub;
  return sizeof(float) *
         (static_cast<size_t>(kGeomUsed + f) * kSub            // sg, sf
          + static_cast<size_t>(kSub) * p                      // s_tex
          + static_cast<size_t>(n_sub) * p                     // s_tsub
          + static_cast<size_t>(kSub) * (p / 32) * (kGeomUsed + f));
}

template <int F>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, const float* g_out,
                   const float* g_alpha, const float* g_depth, float* d_dirs,
                   float* d_geom, float* d_feats, int n_tiles, int p, int k,
                   int kc, Params prm, cudaStream_t stream) {
  const size_t smem = smem_bytes(F, p, k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_composite_bwd_kernel<F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  tile_composite_bwd_kernel<F><<<n_tiles, p, smem, stream>>>(
      count, dirs, geom, feats, g_out, g_alpha, g_depth, d_dirs, d_geom,
      d_feats, p, k, kc, prm);
  return cudaGetLastError();
}

}  // namespace

// count (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, F, K),
// g_out (T, P, F), g_alpha (T, P), g_depth (T, P) in; d_dirs (T, P, 3),
// d_geom (T, 16, K), d_feats (T, F, K) out, d_geom and d_feats zero-filled
// by the caller; all float32, contiguous. P must be a multiple of 32 and
// at most 256, kc must divide K and be K or a multiple of 32, and F must
// be 14 (the packet features). Returns a cudaError_t.
extern "C" int ptgs_tile_composite_bwd(
    const float* count, const float* dirs, const float* geom,
    const float* feats, const float* g_out, const float* g_alpha,
    const float* g_depth, float* d_dirs, float* d_geom, float* d_feats,
    int n_tiles, int p, int k, int f, int kc, float t_min, float t_max,
    float alpha_min, float alpha_max, float gval_cut,
    float transmittance_min, void* stream) {
  if (n_tiles <= 0 || p <= 0 || p > kMaxPixels || p % 32 != 0 || kc <= 0 ||
      k % kc != 0 || (kc != k && kc % kSub != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{t_min, t_max, alpha_min, alpha_max, gval_cut,
                   transmittance_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 14:
      return static_cast<int>(launch<14>(
          count, dirs, geom, feats, g_out, g_alpha, g_depth, d_dirs, d_geom,
          d_feats, n_tiles, p, k, kc, prm, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Ablation harness of the forward tile composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// benchmarks/variant_kernel.py:_variant_kernel: copies of the forward
// kernel (tile_composite_fwd.cu, pathtracer_gaussiansplatting_tpu/kernels/
// tile_composite.py:_fwd_kernel) with single stages disabled or re-lowered,
// timed to show where a sample's composite time goes. One kernel template,
// one instantiation per mode (the Mode enum, in the order of
// kernels/tile_composite_variants.MODES), one C entry point. Modes:
//
//   full      the production math: eval_slot + composite_slot from
//             tile_composite_common.cuh, bit-equal to tile_composite_fwd
//   noquad    alpha = min(|dx^2 opac|, 0.03), t = alpha + 1 (no a, b, q)
//   noexp     gval = max(0, 1 - q / 2) (no exp)
//   nodiv     t = 1 (no -b / a and its clamp)
//   noscan    w = T_chunk alpha, T_chunk *= 1 - alpha of the chunk's last
//             slot (no running transmittance)
//   nodepth   no w t depth sum
//   onechunk  one chunk of K slots (no chunk skip but on count)
//   hoist     as full: each thread already holds its pixel's direction
//             monomials in registers, so the TPU's pre-broadcast has no
//             counterpart; kept and timed for the table
//   mxu       a and b from tensor-core products (P,6)x(6,8) and (P,3)x(3,8)
//             per 8 slots, one TF32 pass (mma.sync m16n8k8)
//   mxu3      the same products as a 3xTF32 hi/lo split
//   floor     noquad's alpha, noscan's weights, W@feats, no depth
//   skeleton  noquad's alpha, noscan's weights, acc[f] += w of slot f < 16:
//             the loop, staging and output machinery alone
//   lowdot    full math, W@feats on the tensor cores, one TF32 pass
//   dot3      full math, W@feats as a 3xTF32 split
//   skel16/32 skeleton with 2 / 4 tiles per thread block (the TPU's 16 / 32
//             tiles per grid step: the per-step overhead share; the port
//             runs one tile per block)
//   noif      full math, no chunk skip on count or transmittance
//   nodirs    skeleton, dirs never read (alpha from the pixel index)
//   noout     skeleton, out written as 8 channels
//
// What bounds it: as the forward (exp and FMA throughput); the harness
// measures how much each stage costs. One block per tile (TPB tiles for
// skel16/32), one thread per pixel, chunks of kc slots staged in shared
// memory; the tensor-core modes stage per-warp operands and products
// through a (32 x 17)-float scratch per warp.
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "tile_composite_common.cuh"

namespace {

using ptgs::kGeomRows;
using ptgs::kGeomUsed;
using ptgs::kMaxPixels;
using ptgs::Params;

enum Mode {
  FULL, NOQUAD, NOEXP, NODIV, NOSCAN, NODEPTH, ONECHUNK, HOIST, MXU, MXU3,
  FLOOR, SKELETON, LOWDOT, DOT3, SKEL16, SKEL32, NOIF, NODIRS, NOOUT,
  N_MODES
};

constexpr int kF = 14;       // packet features
constexpr int kFP = 16;      // features padded to a multiple of 8
constexpr int kScratch = 17; // floats per pixel row of a warp's scratch

__host__ __device__ constexpr bool skel_alpha(int m) {
  return m == NOQUAD || m == FLOOR || m == SKELETON || m == SKEL16 ||
         m == SKEL32 || m == NODIRS || m == NOOUT;
}
__host__ __device__ constexpr bool no_scan(int m) {
  return m == NOSCAN || m == FLOOR || m == SKELETON || m == SKEL16 ||
         m == SKEL32 || m == NODIRS || m == NOOUT;
}
__host__ __device__ constexpr bool no_dot(int m) {
  return m == SKELETON || m == SKEL16 || m == SKEL32 || m == NODIRS ||
         m == NOOUT;
}
__host__ __device__ constexpr bool no_depth(int m) {
  return m == NODEPTH || m == FLOOR || no_dot(m);
}
__host__ __device__ constexpr bool mxu_ab(int m) { return m == MXU || m == MXU3; }
__host__ __device__ constexpr bool tc_dot(int m) { return m == LOWDOT || m == DOT3; }
__host__ __device__ constexpr bool split3(int m) { return m == MXU3 || m == DOT3; }
__host__ __device__ constexpr bool uses_scratch(int m) { return mxu_ab(m) || tc_dot(m); }
__host__ __device__ constexpr int tiles_per_block(int m) {
  return m == SKEL16 ? 2 : (m == SKEL32 ? 4 : 1);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D = A B + D for one m16n8k8 TF32 tile (fragments in the PTX layout:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (t, g), b1 (t+4, g);
// c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1); g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi = tf32(x), lo = tf32(x - hi), as TF32 bit patterns.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// A B + C with one TF32 pass (SPLIT false) or hi*hi + hi*lo + lo*hi.
template <bool SPLIT>
__device__ __forceinline__ void mma_f32(float c[4], const float a[4],
                                        const float b[2]) {
  if (!SPLIT) {
    const unsigned ua[4] = {to_tf32(a[0]), to_tf32(a[1]), to_tf32(a[2]),
                            to_tf32(a[3])};
    const unsigned ub[2] = {to_tf32(b[0]), to_tf32(b[1])};
    mma_tf32(c, ua, ub);
  } else {
    unsigned ah[4], al[4], bh[2], bl[2];
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
    for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
    mma_tf32(c, ah, bh);
    mma_tf32(c, ah, bl);
    mma_tf32(c, al, bh);
  }
}

// alpha and t of one (pixel, slot) pair from its a (before the clamp) and
// b, in eval_slot's rounding; NODIV and NOEXP drop their stage.
template <int M>
__device__ __forceinline__ ptgs::SlotEval eval_from_ab(float a, float b,
                                                       const float* sg,
                                                       int kc, int j,
                                                       const Params& prm) {
  ptgs::SlotEval e;
  e.a = fmaxf(a, 1e-12f);
  e.b = b;
  e.t_raw = __fdiv_rn(-e.b, e.a);
  e.t = M == NODIV ? 1.0f : fminf(fmaxf(e.t_raw, prm.t_min), prm.t_max);
  e.qv = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(e.a, e.t), __fmul_rn(2.0f, e.b)), e.t),
      sg[ptgs::kRowC * kc + j]);
  e.gval = M == NOEXP ? fmaxf(0.0f, __fsub_rn(1.0f, __fmul_rn(0.5f, e.qv)))
                      : expf(__fmul_rn(-0.5f, fmaxf(e.qv, 0.0f)));
  e.alpha0 = __fmul_rn(sg[ptgs::kRowOpac * kc + j], e.gval);
  e.live = (e.gval >= prm.gval_cut) && (e.alpha0 >= prm.alpha_min);
  e.alpha = e.live ? fminf(e.alpha0, prm.alpha_max) : 0.0f;
  return e;
}

// a (before its clamp) and b of slot j, rank-1 products in eval_slot's
// rounding.
__device__ __forceinline__ void scalar_ab(const ptgs::PixelDir& p,
                                          const float* sg, int kc, int j,
                                          float& a, float& b) {
  a = __fmul_rn(p.dd[0], sg[0 * kc + j]);
  a = __fadd_rn(a, __fmul_rn(p.dd[1], sg[1 * kc + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[2], sg[2 * kc + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[3], sg[3 * kc + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[4], sg[4 * kc + j]));
  a = __fadd_rn(a, __fmul_rn(p.dd[5], sg[5 * kc + j]));
  b = __fadd_rn(__fmul_rn(p.dx, sg[6 * kc + j]), __fmul_rn(p.dy, sg[7 * kc + j]));
  b = __fadd_rn(b, __fmul_rn(p.dz, sg[8 * kc + j]));
}

template <int M>
__global__ void __launch_bounds__(kMaxPixels) variant_kernel(
    const float* __restrict__ count, const float* __restrict__ dirs,
    const float* __restrict__ geom, const float* __restrict__ feats,
    float* __restrict__ out, int n_tiles, int p, int k, int kc, Params prm) {
  extern __shared__ float smem[];
  float* sg = smem;                           // [kGeomUsed][kc]
  float* sf = smem + kGeomUsed * kc;          // [kF][kc]
  float* ws = sf + kF * kc + (threadIdx.x >> 5) * 32 * kScratch;  // warp's
  __shared__ float red[32];
  constexpr int kAcc = no_dot(M) || tc_dot(M) ? kFP : kF;
  const int pix = threadIdx.x;
  const int lane = pix & 31, g = lane >> 2, tg = lane & 3;

  for (int bi = 0; bi < tiles_per_block(M); ++bi) {
    const int tile = blockIdx.x * tiles_per_block(M) + bi;
    if (tile >= n_tiles) break;  // uniform over the block
    ptgs::PixelDir pd{};
    if (M != NODIRS)
      pd = ptgs::load_dir(dirs + (static_cast<size_t>(tile) * p + pix) * 3);
    float trans = 1.0f, s_depth = 0.0f;
    float acc[kAcc];
#pragma unroll
    for (int f = 0; f < kAcc; ++f) acc[f] = 0.0f;
    float cacc[2][2][4] = {};  // tc_dot: W@feats in fragment layout
    float am[2][4], ad[2][4];  // mxu_ab: monomial and direction fragments
    if (mxu_ab(M)) {
      for (int c = 0; c < 16; ++c) {
        const float v = c < 6 ? pd.dd[c]
                              : (c == 8 ? pd.dx
                                        : (c == 9 ? pd.dy
                                                  : (c == 10 ? pd.dz : 0.0f)));
        ws[lane * kScratch + c] = v;
      }
      __syncwarp();
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
        const float src[2][4] = {{ws[r0 + tg], ws[r1 + tg], ws[r0 + tg + 4],
                                  ws[r1 + tg + 4]},
                                 {ws[r0 + 8 + tg], ws[r1 + 8 + tg],
                                  ws[r0 + 12 + tg], ws[r1 + 12 + tg]}};
        for (int i = 0; i < 4; ++i) {
          am[mt][i] = src[0][i];
          ad[mt][i] = src[1][i];
        }
      }
      __syncwarp();
    }

    const float cnt = count[tile];
    const float* g_tile = geom + static_cast<size_t>(tile) * kGeomRows * k;
    const float* f_tile = feats + static_cast<size_t>(tile) * kF * k;
    const int n_chunks = k / kc;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int start = ci * kc;
      if (M != NOIF) {
        if (!(cnt > static_cast<float>(start))) break;
        if (ci > 0 && !(ptgs::block_max(trans, red) > prm.transmittance_min))
          break;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kGeomUsed * kc; i += blockDim.x)
        sg[i] = g_tile[(i / kc) * k + start + i % kc];
      for (int i = threadIdx.x; i < kF * kc; i += blockDim.x)
        sf[i] = f_tile[(i / kc) * k + start + i % kc];
      __syncthreads();

      const int n = min(kc, max(0, static_cast<int>(ceilf(cnt)) - start));
      const float trans_chunk = trans;  // no_scan: the chunk's entry T
      float last_om = 1.0f;             // no_scan: 1 - alpha of slot kc - 1
      // The tensor-core modes take slots 8 at a time (one k8 step); the
      // others one at a time, as the forward kernel does.
      constexpr int kGroup = uses_scratch(M) ? 8 : 1;
      for (int j0 = 0; j0 < n; j0 += kGroup) {
        float a8[8], b8[8];
        if (mxu_ab(M)) {
          float bq[2], bd[2];
          const int js = j0 + g;
          bq[0] = tg < 6 ? sg[tg * kc + js] : 0.0f;
          bq[1] = tg + 4 < 6 ? sg[(tg + 4) * kc + js] : 0.0f;
          bd[0] = tg < 3 ? sg[(6 + tg) * kc + js] : 0.0f;
          bd[1] = 0.0f;
          for (int mt = 0; mt < 2; ++mt) {
            float ca[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_f32<split3(M)>(ca, am[mt], bq);
            mma_f32<split3(M)>(cb, ad[mt], bd);
            const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
            ws[r0 + 2 * tg] = ca[0];
            ws[r0 + 2 * tg + 1] = ca[1];
            ws[r1 + 2 * tg] = ca[2];
            ws[r1 + 2 * tg + 1] = ca[3];
            ws[r0 + 8 + 2 * tg] = cb[0];
            ws[r0 + 8 + 2 * tg + 1] = cb[1];
            ws[r1 + 8 + 2 * tg] = cb[2];
            ws[r1 + 8 + 2 * tg + 1] = cb[3];
          }
          __syncwarp();
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            a8[jj] = ws[lane * kScratch + jj];
            b8[jj] = ws[lane * kScratch + 8 + jj];
          }
          __syncwarp();
        }
        float w8[8];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int j = j0 + jj;
          w8[jj] = 0.0f;
          if (j >= n) continue;
          float alpha, t;
          if constexpr (skel_alpha(M)) {
            const float base = M == NODIRS
                                   ? __fmul_rn(static_cast<float>(pix), 1e-5f)
                                   : pd.dd[0];
            alpha = fminf(
                fabsf(__fmul_rn(base, sg[ptgs::kRowOpac * kc + j])), 0.03f);
            t = __fadd_rn(alpha, 1.0f);
          } else {
            ptgs::SlotEval e;
            if (M == FULL || M == HOIST || M == ONECHUNK || M == NOIF ||
                M == NODEPTH || M == NOSCAN || tc_dot(M)) {
              e = ptgs::eval_slot(pd, sg, kc, j, prm);
            } else {
              float a, b;
              if (mxu_ab(M)) {
                a = a8[jj];
                b = b8[jj];
              } else {
                scalar_ab(pd, sg, kc, j, a, b);
              }
              e = eval_from_ab<M>(a, b, sg, kc, j, prm);
            }
            if constexpr (M == FULL || M == HOIST || M == ONECHUNK ||
                          M == NOIF) {
              ptgs::composite_slot<kF>(e, sf, kc, j, trans, s_depth, acc);
              continue;
            }
            alpha = e.alpha;
            t = e.t;
          }
          float w;
          if (no_scan(M)) {
            w = __fmul_rn(trans_chunk, alpha);
            if (j == kc - 1) last_om = __fsub_rn(1.0f, alpha);
          } else {
            w = __fmul_rn(trans, alpha);
            trans = ptgs::trans_after(trans, alpha);
          }
          if (!no_depth(M)) s_depth = __fmaf_rn(w, t, s_depth);
          if constexpr (no_dot(M)) {
#pragma unroll
            for (int f = 0; f < kFP; ++f)
              if (f == j) acc[f] = __fadd_rn(acc[f], w);
          } else if constexpr (tc_dot(M)) {
            w8[jj] = w;
          } else {
#pragma unroll
            for (int f = 0; f < kF; ++f)
              acc[f] = __fmaf_rn(w, sf[f * kc + j], acc[f]);
          }
        }
        if (tc_dot(M)) {  // W (32 px x 8 slots) @ feats (8 slots x 16)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) ws[lane * kScratch + jj] = w8[jj];
          __syncwarp();
          for (int mt = 0; mt < 2; ++mt) {
            const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
            const float aw[4] = {ws[r0 + tg], ws[r1 + tg], ws[r0 + tg + 4],
                                 ws[r1 + tg + 4]};
            for (int nt = 0; nt < 2; ++nt) {
              const int f = nt * 8 + g;
              const float bf[2] = {
                  f < kF ? sf[f * kc + j0 + tg] : 0.0f,
                  f < kF ? sf[f * kc + j0 + tg + 4] : 0.0f};
              mma_f32<split3(M)>(cacc[mt][nt], aw, bf);
            }
          }
          __syncwarp();
        }
      }
      if (no_scan(M)) trans = __fmul_rn(trans_chunk, last_om);
    }

    if (tc_dot(M)) {  // the fragments back to one row per pixel
      for (int mt = 0; mt < 2; ++mt)
        for (int nt = 0; nt < 2; ++nt) {
          const int r0 = (mt * 16 + g) * kScratch, r1 = r0 + 8 * kScratch;
          const int c = nt * 8 + 2 * tg;
          ws[r0 + c] = cacc[mt][nt][0];
          ws[r0 + c + 1] = cacc[mt][nt][1];
          ws[r1 + c] = cacc[mt][nt][2];
          ws[r1 + c + 1] = cacc[mt][nt][3];
        }
      __syncwarp();
#pragma unroll
      for (int f = 0; f < kAcc; ++f) acc[f] = ws[lane * kScratch + f];
      __syncwarp();
    }

    const int out_ch = M == NOOUT ? 8 : kFP + 2;
    float* o = out + (static_cast<size_t>(tile) * p + pix) * out_ch;
    const float aa = 1.0f - trans;
    const float depth = s_depth / fmaxf(aa, 1e-8f);
    const int n_feat = M == NOOUT ? 6 : kFP;
#pragma unroll
    for (int f = 0; f < kFP; ++f)
      if (f < n_feat) o[f] = f < kAcc ? acc[f < kAcc ? f : 0] : 0.0f;
    o[n_feat] = aa;
    o[n_feat + 1] = depth;
  }
}

template <int M>
cudaError_t launch(const float* count, const float* dirs, const float* geom,
                   const float* feats, float* out, int n_tiles, int p, int k,
                   int kc, const Params& prm, cudaStream_t stream) {
  size_t smem = static_cast<size_t>(kGeomUsed + kF) * kc * sizeof(float);
  if (uses_scratch(M))
    smem += static_cast<size_t>(p / 32) * 32 * kScratch * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        variant_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int tpb = tiles_per_block(M);
  variant_kernel<M><<<(n_tiles + tpb - 1) / tpb, p, smem, stream>>>(
      count, dirs, geom, feats, out, n_tiles, p, k, kc, prm);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*,
                                 const float*, float*, int, int, int, int,
                                 const Params&, cudaStream_t);

template <int... Ms>
struct Table {
  static constexpr LaunchFn fns[] = {&launch<Ms>...};
};

}  // namespace

// mode: index into Mode (kernels/tile_composite_variants.MODES). count
// (T,), dirs (T, P, 3), geom (T, 16, K), feats (T, 14, K) in; out
// (T, P, 18), or (T, P, 8) for noout, out; all float32, contiguous. P a
// multiple of 32 and at most 256, kc a multiple of 8 dividing K (K for
// onechunk). Returns a cudaError_t.
extern "C" int ptgs_tile_composite_variant(
    int mode, const float* count, const float* dirs, const float* geom,
    const float* feats, float* out, int n_tiles, int p, int k, int kc,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, float transmittance_min, void* stream) {
  if (mode < 0 || mode >= N_MODES || n_tiles <= 0 || p <= 0 ||
      p > kMaxPixels || p % 32 != 0 || kc <= 0 || kc % 8 != 0 ||
      k % kc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{t_min, t_max, alpha_min, alpha_max, gval_cut,
                   transmittance_min};
  using T = Table<FULL, NOQUAD, NOEXP, NODIV, NOSCAN, NODEPTH, ONECHUNK,
                  HOIST, MXU, MXU3, FLOOR, SKELETON, LOWDOT, DOT3, SKEL16,
                  SKEL32, NOIF, NODIRS, NOOUT>;
  return static_cast<int>(T::fns[mode](count, dirs, geom, feats, out,
                                       n_tiles, p, k, kc, prm,
                                       static_cast<cudaStream_t>(stream)));
}

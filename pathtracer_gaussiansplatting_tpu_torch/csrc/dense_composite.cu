// The dense trace's composite for Hopper (sm_90a): each ray's top-K list
// composited front to back with the Gaussians' shading features, in one
// pass over the filled list entries.
//
// Replaces plain XLA code of the reference's dense backend, not a Pallas
// kernel: pathtracer_gaussiansplatting_tpu/render/reference.py:
// _gather_features and the composite of trace_dense (with core/sh.py:
// eval_sh, ops/gaussians.py: surfel_normal and ops/composite.py:
// composite_weights). In the port's plain code that is some ninety
// launches a trace: ten (R, K) gathers of 3- to 4-float rows, the SH
// basis and contraction, the normal's ~35 elementwise launches, a cumprod
// and ten weighted sums, each writing its (R, K, ...) slots to device
// memory and reading them back.
//
// What it computes: for ray r with list idx, t, alpha (K,) (K1's lists:
// slots past the contributors hold alpha 0) and direction d, the weights
// w_j = T_j alpha_j with T_j = prod_{i<j} (1 - alpha_i), and 16 floats:
// the final transmittance prod_j (1 - alpha_j), then the w-weighted sums
// of the SH colour max(sum_k sh_k basis_k(d) + 0.5, 0) (3), the emission
// (3), the surfel normal n flipped to -n where dot(n, d) > 0 (3), t, and
// metallic, roughness, clearcoat, clearcoat roughness and transmission.
// The features come from one row a Gaussian of a table built once a scene
// (kernels/dense_trace.composite_table): the SH coefficients of degree
// DEG, emission, the five materials and the unflipped normal, padded to a
// multiple of 16 bytes (64 bytes at degree 0). kernels/dense_trace
// .dense_composite_plain is the same function in torch.
//
// Same work as the plain code: float32 throughout, every slot composited
// (no early termination). A slot with alpha = 0 has weight exactly 0
// there, so skipping its row changes nothing but the order of the sums.
//
// The design: a warp a ray, eight rays a block. The list is read in steps
// of 64 slots, two adjacent slots a lane (coalesced reads of alpha); the
// exclusive product of (1 - alpha) is a warp scan of each lane's pair
// product, carried from one step to the next. Only lanes whose slot has
// alpha > 0 read its idx, t and feature row (16-byte reads; at 40k
// Gaussians the 2.5 MB table stays in the L2 cache) and evaluate the SH,
// whose basis depends on the ray alone and is computed once. Each lane
// keeps 15 sums; a butterfly of shuffles adds them in a fixed order, so
// one launch equals the next bit for bit (no atomics).
//
// What bounds it: bytes. The function must read every slot's alpha (4 B),
// idx and t of each filled slot (8 B), the table once and a ray's
// direction, and write 64 B a ray: at 65536 rays, K = 64, ~26% filled,
// 40k Gaussians ~30 MB, ~9 us at 3.35 TB/s (chip_smoke.py phase 5f prints
// it beside the time).
//
// Plain C entry point (bound with ctypes); it returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;    // rays a block
constexpr int kStep = 64;    // list slots a warp step, two a lane
constexpr int kOut = 16;     // floats a ray out
constexpr int kSums = 15;    // weighted sums a ray

// core/sh.py's constants, as the plain version rounds them to float32.
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

template <int DEG>
struct Layout {
  static constexpr int kBasis = (DEG + 1) * (DEG + 1);
  static constexpr int kSh = 3 * kBasis;         // coefficient-major
  static constexpr int kEmission = kSh;          // 3 floats
  static constexpr int kMaterials = kSh + 3;     // 5 floats
  static constexpr int kNormal = kSh + 8;        // 3 floats
  static constexpr int kCols = (kSh + 11 + 3) / 4 * 4;
};

// core/sh.py:sh_basis for one direction.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = kC0;
  if (DEG >= 1) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = kC20 * (x * y);
    b[5] = kC21 * (y * z);
    b[6] = kC22 * (2.0f * zz - xx - yy);
    b[7] = kC23 * (x * z);
    b[8] = kC24 * (xx - yy);
  }
  if (DEG >= 3) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[9] = kC30 * y * (3.0f * xx - yy);
    b[10] = kC31 * (x * y) * z;
    b[11] = kC32 * y * (4.0f * zz - xx - yy);
    b[12] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    b[13] = kC34 * x * (4.0f * zz - xx - yy);
    b[14] = kC35 * z * (xx - yy);
    b[15] = kC36 * x * (xx - 3.0f * yy);
  }
}

// Adds slot (g, t) at weight w to the lane's sums: SH colour (0-2),
// emission (3-5), the viewer-facing normal (6-8), t (9), materials (10-14).
template <int DEG>
__device__ __forceinline__ void add_slot(const float* __restrict__ table,
                                         int g, float t, float w,
                                         const float* basis, float dx,
                                         float dy, float dz, float* acc) {
  using L = Layout<DEG>;
  float row[L::kCols];
  const float4* src =
      reinterpret_cast<const float4*>(table + static_cast<long long>(g) *
                                                  L::kCols);
#pragma unroll
  for (int q = 0; q < L::kCols / 4; ++q) {
    const float4 v = __ldg(src + q);
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float col = 0.0f;
#pragma unroll
    for (int k = 0; k < L::kBasis; ++k) col += row[3 * k + c] * basis[k];
    acc[c] += w * fmaxf(col + 0.5f, 0.0f);
    acc[3 + c] += w * row[L::kEmission + c];
  }
  float nx = row[L::kNormal], ny = row[L::kNormal + 1],
        nz = row[L::kNormal + 2];
  // ops/gaussians.surfel_normal's flip, its dot rounded op by op.
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(nx, dx), __fmul_rn(ny, dy)),
                              __fmul_rn(nz, dz));
  if (dot > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  acc[6] += w * nx;
  acc[7] += w * ny;
  acc[8] += w * nz;
  acc[9] += w * t;
#pragma unroll
  for (int m = 0; m < 5; ++m) acc[10 + m] += w * row[L::kMaterials + m];
}

template <int DEG>
__global__ void __launch_bounds__(kWarps * 32)
    dense_composite_kernel(const int* __restrict__ idx,
                           const float* __restrict__ t,
                           const float* __restrict__ alpha,
                           const float* __restrict__ dirs,
                           const float* __restrict__ table, int n_rays, int k,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // whole warps leave together
  const float dx = dirs[3 * ray], dy = dirs[3 * ray + 1],
              dz = dirs[3 * ray + 2];
  float basis[Layout<DEG>::kBasis];
  sh_basis<DEG>(dx, dy, dz, basis);
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;

  const long long base = static_cast<long long>(ray) * k;
  float carry = 1.0f;  // transmittance in front of the step
  for (int s0 = 0; s0 < k; s0 += kStep) {
    const int j0 = s0 + 2 * lane, j1 = j0 + 1;
    const float a0 = j0 < k ? alpha[base + j0] : 0.0f;
    const float a1 = j1 < k ? alpha[base + j1] : 0.0f;
    const float keep0 = 1.0f - a0;
    // Inclusive scan of the lanes' pair products.
    float incl = keep0 * (1.0f - a1);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float t0 = carry * excl;
    if (a0 > 0.0f)
      add_slot<DEG>(table, idx[base + j0], t[base + j0], t0 * a0, basis, dx,
                    dy, dz, acc);
    if (a1 > 0.0f)
      add_slot<DEG>(table, idx[base + j1], t[base + j1], (t0 * keep0) * a1,
                    basis, dx, dy, dz, acc);
    carry *= __shfl_sync(kFull, incl, 31);
  }
  // Butterfly: every lane ends with the same sums (a + b == b + a).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kSums; ++i)
      acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
  if (lane < kOut / 4) {
    float v[kOut];
    v[0] = carry;
#pragma unroll
    for (int i = 0; i < kSums; ++i) v[1 + i] = acc[i];
    float4 o;
    // Lane q stores floats 4q..4q+3 (static indices: no local memory).
#pragma unroll
    for (int q = 0; q < kOut / 4; ++q)
      if (q == lane) o = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                     v[4 * q + 3]);
    reinterpret_cast<float4*>(out + static_cast<long long>(ray) * kOut)[lane] =
        o;
  }
}

template <int DEG>
cudaError_t launch(const int* idx, const float* t, const float* alpha,
                   const float* dirs, const float* table, int n_rays, int k,
                   float* out, cudaStream_t stream) {
  dense_composite_kernel<DEG><<<(n_rays + kWarps - 1) / kWarps, kWarps * 32,
                                0, stream>>>(idx, t, alpha, dirs, table,
                                             n_rays, k, out);
  return cudaGetLastError();
}

}  // namespace

// idx (R, K) int32, t and alpha (R, K) float32, dirs (R, 3), table
// (N, cols(degree)) float32 on a 16-byte boundary, out (R, 16) float32 on
// a 16-byte boundary; every idx where alpha > 0 lies in [0, N).
extern "C" int ptgs_dense_composite(const int* idx, const float* t,
                                    const float* alpha, const float* dirs,
                                    const float* table, int n_rays, int k,
                                    int degree, float* out, void* stream) {
  if (n_rays <= 0 || k < 0 || reinterpret_cast<size_t>(table) % 16 != 0 ||
      reinterpret_cast<size_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: return static_cast<int>(
        launch<0>(idx, t, alpha, dirs, table, n_rays, k, out, st));
    case 1: return static_cast<int>(
        launch<1>(idx, t, alpha, dirs, table, n_rays, k, out, st));
    case 2: return static_cast<int>(
        launch<2>(idx, t, alpha, dirs, table, n_rays, k, out, st));
    case 3: return static_cast<int>(
        launch<3>(idx, t, alpha, dirs, table, n_rays, k, out, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

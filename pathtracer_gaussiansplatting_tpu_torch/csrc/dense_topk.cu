// Dense top-K ray-Gaussian trace for Hopper (sm_90a).
//
// Replaces the plain XLA code of the reference's dense backend, not a
// Pallas kernel: pathtracer_gaussiansplatting_tpu/render/reference.py:
// dense_topk (with ops/gaussians.py: peak_response). For every ray and
// every Gaussian it computes the peak t* = clip(-b / a, t_min, t_max) and
// alpha = opac * exp(-q(t*) / 2) with the sigma_cut / alpha_min cutoffs,
// and keeps the K contributing Gaussians (alpha > 0) of smallest key
// (t*, or a per-Gaussian sort depth), in ascending key order, equal keys
// in index order (as lax.top_k does), for any 1 <= K <= N. Slots past the
// contributing ones hold idx 0, t = t_max, alpha 0; an inactive ray writes
// only such slots.
//
// What bounds the function: the issue of the per-pair work. The exact pair
// costs ~60 separately rounded float operations, a division and an exp
// (~110 instructions), yet only ~0.1-0.3% of pairs have alpha > 0. So the
// kernel evaluates fewer pairs, in conservative steps (dense_common.cuh
// derives them) that keep the list bit-equal to the plain version's:
//  - the rows come in Morton order of the means (kernels/dense_trace.py:
//    DenseTable); each 32 rows have a bounding sphere with their largest
//    cull radii (a group), and each 32 groups a sphere around the groups'
//    spheres (a super-group);
//  - a warp takes one ray. Its lanes test 32 super-groups at a time
//    (group_keep), then the 32 groups of each super-group the ray
//    reaches, then the rows of each group it reaches with the per-pair
//    cull (cull_keep, a row a lane, from the DenseTable's cull columns:
//    mean x, y, z, R0 and R1 as five arrays, so a warp's 32 rows are five
//    128-byte reads);
//  - the rows the cull keeps are appended (a ballot) with their indices
//    to a ring of kPend in shared memory; the exact path takes them 32 at
//    a time, every lane busy, each lane's row as four 16-byte reads, and
//    once more at the end.
// A skipped pair has alpha = 0 in the exact path too and is never inserted.
// The list is ordered by (key, index), since Morton order is not index
// order, after the WarpSelect of Johnson, Douze and Jegou ("Billion-scale
// similarity search with GPUs", 2017): each (key, index) pair is one 64-bit
// integer, the key's order-preserving bits above the index, so every
// comparison is exact and equal keys go by index; the candidates below the
// list's K-th go to a shared queue of kQueue, and when it would overflow
// the warp sorts the queue (a bitonic network) and merges it into the list
// by rank (each entry's place is its index plus its rank in the other
// list). The list lies in shared memory up to the wrapper's
// LIST_SHARED_MAX_K and in a global scratch past it. t and alpha of the
// kept Gaussians are recomputed at the end from the table in index order
// (bit-equal: the same operations). A block holds kWarps = 4 rays (8
// measured up to 20% slower at K = 64 and 256, and nowhere faster);
// shared memory a block: kWarps (8 (kQueue + 2K) + 4 kPend) bytes with the
// list in shared memory.
//
// What bounds it now (tools/dense_topk_turns.py and chip_smoke.py on an
// NVIDIA H100 80GB HBM3, 700.00 W; K = 64; the thread-a-ray kernel it
// replaced in brackets): 65536 rays against 50k Gaussians 0.49-0.53 ms on
// primary rays (1.26-1.28), 0.60-0.65 on bounce rays (4.59-4.62), 5.65-5.69
// on rays from 20x as far (7.71-7.86), 9-13% of the bound by code path;
// 640000 bounce rays 5.97-6.06 (24.3-24.5); 4096 rays through a
// 2M-Gaussian cloud 28.4-28.6 (229.6), 9% of its bound. Each ray reads its
// groups' spheres, 20 bytes a tested row and 64 bytes a kept row from the
// L2 cache or memory on its own: ~1290 tested and ~50 kept rows a primary
// ray, ~15950 and ~5800 a ray from far, ~823000 and ~388000 a ray in the
// cloud (102 GB of rows for that launch, ~3.6 TB/s). Rays that reach the
// same rows do not share them (the old kernel staged rows once for 128
// rays): that is the next step.
//
// Plain C entry point (bound with ctypes); it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense_common.cuh"

namespace {

using ptgs_dense::kCols;
using ptgs_dense::kFullWarp;

struct TopkParams {
  float t_min, t_max, alpha_min, alpha_max, gval_cut;
};

using u64 = unsigned long long;
constexpr int kWarps = 4;      // rays (warps) a block
constexpr int kQueue = 256;    // a ray's queue of candidates
constexpr int kPend = 64;      // a ray's ring of kept rows for the exact path
constexpr u64 kNone = ~0ull;   // above every candidate

// (key, index) as one integer that orders as the pair does: the float key's
// bits made order-preserving (-0 as +0, as the float compare has them)
// above the index.
__device__ __forceinline__ u64 pack(float key, int id) {
  unsigned u = __float_as_uint(key == 0.0f ? 0.0f : key);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(id);
}

// The count of a[0, n) below x, a ascending.
__device__ __forceinline__ int rank_below(const u64* a, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Sorts q[0, n2) ascending across the warp (a bitonic network; n2 a power
// of two).
__device__ void warp_sort(u64* q, int n2, int lane) {
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const u64 a = q[i], b = q[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          q[i] = b;
          q[i + stride] = a;
        }
      }
      __syncwarp();
    }
}

// A ray's sorted list: n entries in cur, nxt the merge's other buffer;
// worst is the K-th entry once K are kept (kNone before).
struct RayList {
  u64 *cur, *nxt;
  int n;
  u64 worst;
};

// Merges the nq queued candidates into the list, keeping its k smallest.
// Every entry is distinct (one a Gaussian), so each lands at its index
// plus its rank in the other list, and no two land on one place.
__device__ void merge_queue(u64* q, int nq, RayList& l, int k, int lane) {
  int n2 = 32;
  while (n2 < nq) n2 <<= 1;
  for (int i = nq + lane; i < n2; i += 32) q[i] = kNone;
  __syncwarp();
  warp_sort(q, n2, lane);
  const int n_new = min(k, l.n + nq);
  for (int i = lane; i < l.n; i += 32) {
    const u64 a = l.cur[i];
    const int pos = i + rank_below(q, nq, a);
    if (pos < n_new) l.nxt[pos] = a;
  }
  for (int j = lane; j < nq; j += 32) {
    const u64 b = q[j];
    const int pos = j + rank_below(l.cur, l.n, b);
    if (pos < n_new) l.nxt[pos] = b;
  }
  __syncwarp();  // orders the list's shared or global writes for the warp
  u64* t = l.cur;
  l.cur = l.nxt;
  l.nxt = t;
  l.n = n_new;
  l.worst = l.n == k ? l.cur[k - 1] : kNone;
}

// The group test (dense_common.cuh: group_keep) on a sphere of a
// DenseTable's groups or supers (8 floats: center, radius, the largest R0
// of the trace, R1, R0 of a shadow segment, 0).
__device__ __forceinline__ bool sphere_keep(const ptgs_dense::Ray& r,
                                            float dd, float tt,
                                            const float* sphere) {
  const float4* sph = reinterpret_cast<const float4*>(sphere);
  const float4 radii = __ldg(sph + 1);
  return ptgs_dense::group_keep(r, dd, tt, __ldg(sph), radii.x, radii.y);
}

// A warp a ray, kWarps rays a block; lists: (R, 2K) in global memory, or
// null for lists in shared memory.
__global__ void __launch_bounds__(kWarps * 32) dense_topk_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ rows, const float* __restrict__ sorted_rows,
    const int* __restrict__ order, const float* __restrict__ groups,
    const float* __restrict__ supers, const float* __restrict__ cull,
    const float* __restrict__ sort_depths,
    const unsigned char* __restrict__ active, u64* __restrict__ lists,
    int* __restrict__ idx_out, float* __restrict__ t_out,
    float* __restrict__ alpha_out, int n_rays, int n_gauss, int k,
    TopkParams prm) {
  extern __shared__ u64 smem_list[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n_rays) return;  // the whole warp: no block barrier follows
  const int per_warp = kQueue + (lists == nullptr ? 2 * k : 0);
  u64* q = smem_list + warp * per_warp;
  int* pend = reinterpret_cast<int*>(smem_list + kWarps * per_warp) +
              warp * kPend;
  RayList l;
  l.cur = lists == nullptr ? q + kQueue
                           : lists + static_cast<size_t>(ray) * 2 * k;
  l.nxt = l.cur + k;
  l.n = 0;
  l.worst = kNone;
  const ptgs_dense::Ray r = ptgs_dense::load_ray(origins, dirs, ray);
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float tt = prm.t_min * prm.t_min * dd;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one

  if (active == nullptr || active[ray] != 0) {
    int nq = 0;
    // The exact path on row j where `has` (every lane takes part): its
    // candidate, if below the list's K-th, goes to the queue, which is
    // merged into the list first if it would overflow.
    auto offer = [&](bool has, int j) {
      u64 cand = kNone;
      if (has) {
        // The row as four 16-byte reads (lanes take rows far apart: one
        // wide read each touches fewer cache lines than four narrow ones).
        const float4* g = reinterpret_cast<const float4*>(
            sorted_rows + static_cast<size_t>(j) * kCols);
        float row[kCols];
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) {
          const float4 v = __ldg(g + c);
          row[4 * c] = v.x;
          row[4 * c + 1] = v.y;
          row[4 * c + 2] = v.z;
          row[4 * c + 3] = v.w;
        }
        const ptgs_dense::Peak p =
            ptgs_dense::peak(r, row, prm.t_min, prm.t_max, prm.alpha_min,
                             prm.alpha_max, prm.gval_cut);
        if (p.alpha > 0.0f) {
          const float key = sort_depths != nullptr ? sort_depths[j] : p.t;
          if (key < CUDART_INF_F) cand = pack(key, order[j]);
        }
      }
      bool want = cand < l.worst;
      unsigned wm = __ballot_sync(kFullWarp, want);
      if (nq + __popc(wm) > kQueue) {  // uniform over the warp
        merge_queue(q, nq, l, k, lane);
        nq = 0;
        want = cand < l.worst;
        wm = __ballot_sync(kFullWarp, want);
      }
      if (want) q[nq + __popc(wm & below)] = cand;
      nq += __popc(wm);
    };
    const int n_groups = (n_gauss + 31) / 32;
    const int n_supers = (n_groups + 31) / 32;
    int head = 0, tail = 0;  // the kept rows pend[head, tail) mod kPend
    for (int s0 = 0; s0 < n_supers; s0 += 32) {
      // Lane l tests super-group s0 + l; the warp then tests the groups of
      // each reached one, a group a lane, and culls the reached groups'
      // rows, a row a lane.
      const bool sreach = s0 + lane < n_supers &&
                          sphere_keep(r, dd, tt, supers + (s0 + lane) *
                                                     ptgs_dense::kGroupCols);
      unsigned stodo = __ballot_sync(kFullWarp, sreach);
      while (stodo != 0u) {
        const int g0 = (s0 + __ffs(stodo) - 1) * 32;
        stodo &= stodo - 1u;
        const bool reach =
            g0 + lane < n_groups &&
            sphere_keep(r, dd, tt, groups + (g0 + lane) *
                                                ptgs_dense::kGroupCols);
        unsigned todo = __ballot_sync(kFullWarp, reach);
        while (todo != 0u) {
          const int j = (g0 + __ffs(todo) - 1) * 32 + lane;
          todo &= todo - 1u;
          const bool keep =
              j < n_gauss &&
              ptgs_dense::cull_keep(r, dd, tt, __ldg(cull + j),
                                    __ldg(cull + n_gauss + j),
                                    __ldg(cull + 2 * n_gauss + j),
                                    __ldg(cull + 3 * n_gauss + j),
                                    __ldg(cull + 4 * n_gauss + j));
          // The kept rows are appended to the pending ring; the exact path
          // takes them 32 at a time, every lane busy.
          const unsigned km = __ballot_sync(kFullWarp, keep);
          if (keep) pend[(tail + __popc(km & below)) & (kPend - 1)] = j;
          tail += __popc(km);
          if (tail - head >= 32) {
            __syncwarp();
            const int jj = pend[(head + lane) & (kPend - 1)];
            __syncwarp();
            head += 32;
            offer(true, jj);
          }
        }
      }
    }
    __syncwarp();
    if (tail > head) {
      const bool has = lane < tail - head;
      offer(has, has ? pend[(head + lane) & (kPend - 1)] : 0);
    }
    __syncwarp();
    if (nq > 0) merge_queue(q, nq, l, k, lane);
  }

  const size_t base = static_cast<size_t>(ray) * k;
  for (int s = lane; s < k; s += 32) {
    int g = 0;
    float t = prm.t_max, alpha = 0.0f;
    if (s < l.n) {
      g = static_cast<int>(l.cur[s] & 0xffffffffull);
      const ptgs_dense::Peak p = ptgs_dense::peak(
          r, rows + static_cast<size_t>(g) * kCols, prm.t_min, prm.t_max,
          prm.alpha_min, prm.alpha_max, prm.gval_cut);
      t = p.t;
      alpha = p.alpha;
    }
    idx_out[base + s] = g;
    t_out[base + s] = t;
    alpha_out[base + s] = alpha;
  }
}

}  // namespace

// origins, dirs (R, 3); rows (N, 16) (kernels/dense_trace.py:
// gaussian_table) and its DenseTable: sorted_rows (N, 16) (16-byte
// aligned), order (N,) int32, groups (ceil(N / 32), 8), supers
// (ceil(groups / 32), 8), cull (5, N) (sorted_rows' mean, R0 of the trace
// and R1, a column each); optional sort_depths (N,) in sorted_rows' order
// and active (R,) (bool as bytes; NULL for none) in; lists: a (R, 2K)
// int64 scratch for the rays' lists, or NULL to keep them in shared
// memory; idx (R, K) int32, t and alpha (R, K) float32 out; all
// contiguous. 1 <= K <= N. Returns a cudaError_t.
extern "C" int ptgs_dense_topk(
    const float* origins, const float* dirs, const float* rows,
    const float* sorted_rows, const int* order, const float* groups,
    const float* supers, const float* cull, const float* sort_depths,
    const unsigned char* active, long long* lists, int* idx, float* t,
    float* alpha, int n_rays, int n_gauss, int k, float t_min, float t_max,
    float alpha_min, float alpha_max, float gval_cut, void* stream) {
  if (n_rays <= 0 || n_gauss <= 0 || k <= 0 || k > n_gauss ||
      groups == nullptr || supers == nullptr || cull == nullptr ||
      reinterpret_cast<size_t>(sorted_rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      kWarps * (sizeof(u64) * (kQueue + (lists == nullptr ? 2 * k : 0)) +
                sizeof(int) * kPend);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const TopkParams prm{t_min, t_max, alpha_min, alpha_max, gval_cut};
  dense_topk_kernel<<<(n_rays + kWarps - 1) / kWarps, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, rows, sorted_rows, order, groups, supers, cull,
      sort_depths, active, reinterpret_cast<u64*>(lists), idx, t, alpha,
      n_rays, n_gauss, k, prm);
  return static_cast<int>(cudaGetLastError());
}

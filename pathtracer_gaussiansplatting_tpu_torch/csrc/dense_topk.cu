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
// K above 128 (dense_topk_list_kernel, up to K = N): a per-thread list in
// local memory would double its shifts with K, so a warp takes one ray
// and keeps its list sorted in shared memory (K <= the wrapper's
// LIST_SHARED_MAX_K) or in a global scratch the wrapper allocates,
// after the WarpSelect of Johnson, Douze and Jegou ("Billion-scale
// similarity search with GPUs", 2017): each (key, index) pair is one
// 64-bit integer, the key's order-preserving bits above the index, so
// every comparison is exact and equal keys go by index; the lanes take a
// ray's rows 32 at a time (the same group test, cull and exact path as
// above, from the rows in global memory), append the pairs below the
// list's K-th into a shared queue of kQueue, and when it would overflow
// the warp sorts the queue (a bitonic network) and merges it into the
// list by rank (each entry's place is its index plus its rank in the
// other list). t and alpha of the kept Gaussians are recomputed from the
// table at the end, as above, so the outputs stay bit-equal to the plain
// version's.
//
// Plain C entry points (bound with ctypes); each returns cudaGetLastError().

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

// ---- K above 128: a warp a ray, its list sorted in shared or global
// memory ------------------------------------------------------------------

using u64 = unsigned long long;
constexpr int kListRays = 4;   // rays (warps) a block
constexpr int kQueue = 256;    // a ray's queue of candidates
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

// lists: (R, 2K) in global memory, or null for lists in shared memory.
__global__ void __launch_bounds__(kListRays * 32) dense_topk_list_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ rows, const float* __restrict__ sorted_rows,
    const int* __restrict__ order, const float* __restrict__ groups,
    const float* __restrict__ sort_depths,
    const unsigned char* __restrict__ active, u64* __restrict__ lists,
    int* __restrict__ idx_out, float* __restrict__ t_out,
    float* __restrict__ alpha_out, int n_rays, int n_gauss, int k,
    TopkParams prm) {
  extern __shared__ u64 smem_list[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kListRays + warp;
  if (ray >= n_rays) return;  // the whole warp: no block barrier follows
  u64* q = smem_list + warp * (kQueue + (lists == nullptr ? 2 * k : 0));
  RayList l;
  l.cur = lists == nullptr ? q + kQueue
                           : lists + static_cast<size_t>(ray) * 2 * k;
  l.nxt = l.cur + k;
  l.n = 0;
  l.worst = kNone;
  const ptgs_dense::Ray r = ptgs_dense::load_ray(origins, dirs, ray);
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float tt = prm.t_min * prm.t_min * dd;

  if (active == nullptr || active[ray] != 0) {
    const int n_groups = (n_gauss + 31) / 32;
    int nq = 0;
    for (int g0 = 0; g0 < n_groups; g0 += 32) {
      // Lane l tests group g0 + l; the warp then takes the reached groups'
      // rows, a row a lane.
      bool reach = false;
      if (g0 + lane < n_groups) {
        const float4* sph = reinterpret_cast<const float4*>(
            groups + (g0 + lane) * ptgs_dense::kGroupCols);
        const float4 radii = __ldg(sph + 1);
        reach = ptgs_dense::group_keep(r, dd, tt, __ldg(sph), radii.x,
                                       radii.y);
      }
      unsigned todo = __ballot_sync(kFullWarp, reach);
      while (todo != 0u) {
        const int j = (g0 + __ffs(todo) - 1) * 32 + lane;
        todo &= todo - 1u;
        u64 cand = kNone;
        if (j < n_gauss) {
          const float* g = sorted_rows + static_cast<size_t>(j) * kCols;
          const float4 h = __ldg(reinterpret_cast<const float4*>(g));
          const float4 tl = __ldg(reinterpret_cast<const float4*>(g) + 3);
          if (ptgs_dense::cull_keep(r, dd, tt, h.x, h.y, h.z, tl.y, tl.z)) {
            const ptgs_dense::Peak p =
                ptgs_dense::peak(r, g, prm.t_min, prm.t_max, prm.alpha_min,
                                 prm.alpha_max, prm.gval_cut);
            if (p.alpha > 0.0f) {
              const float key = sort_depths != nullptr ? sort_depths[j] : p.t;
              if (key < CUDART_INF_F) cand = pack(key, order[j]);
            }
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
        if (want) q[nq + __popc(wm & ((1u << lane) - 1u))] = cand;
        nq += __popc(wm);
      }
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

// The same inputs and outputs for 128 < K <= N, and lists: a (R, 2K)
// int64 scratch for the rays' lists, or NULL to keep them in shared memory
// (kListRays * (kQueue + 2K) * 8 bytes a block). Returns a cudaError_t.
extern "C" int ptgs_dense_topk_list(
    const float* origins, const float* dirs, const float* rows,
    const float* sorted_rows, const int* order, const float* groups,
    const float* sort_depths, const unsigned char* active, long long* lists,
    int* idx, float* t, float* alpha, int n_rays, int n_gauss, int k,
    float t_min, float t_max, float alpha_min, float alpha_max,
    float gval_cut, void* stream) {
  if (n_rays <= 0 || n_gauss <= 0 || k <= 128 || k > n_gauss ||
      groups == nullptr || reinterpret_cast<size_t>(sorted_rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(u64) * kListRays * (kQueue + (lists == nullptr ? 2 * k : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_topk_list_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const TopkParams prm{t_min, t_max, alpha_min, alpha_max, gval_cut};
  dense_topk_list_kernel<<<(n_rays + kListRays - 1) / kListRays,
                           kListRays * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, rows, sorted_rows, order, groups, sort_depths, active,
      reinterpret_cast<u64*>(lists), idx, t, alpha, n_rays, n_gauss, k, prm);
  return static_cast<int>(cudaGetLastError());
}

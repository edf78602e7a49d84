// The packet gather's backward for Hopper (sm_90a): the gradient of the
// Gaussian table from the gradients of the tile packets, a deterministic
// segment sum a Gaussian over the slots that hold it.
//
// Replaces the transpose of the row gather in the JAX package's
// build_tile_packets (pathtracer_gaussiansplatting_tpu/kernels/
// tile_composite.py:137, `padded[idx]` in _gather_rows_pad128 at :163):
// an XLA scatter-add, not a Pallas kernel. In the port's plain version it
// is autograd's transpose of `table[tile_idx]`, index_put_ with accumulate
// (PyTorch's indexing_backward_kernel), which gives each distinct index
// one row of threads that walks all of its duplicates in turn: the
// binning fills every masked slot with Gaussian 0, so one row adds some
// 70,000 zero gradients in series (~20 ms at the fit's 800x800, K=256).
//
// What it computes: for the packets geom (T, 16, K) and featsT (T, F, K)
// that kernels/tile_composite.build_tile_packets gathers from the table
// (N, 11 + F), row g of d_table is, column c < 11, the sum of
// d_geom[t, c, k], and column 11 + j the sum of d_featsT[t, j, k], over
// the live slots (t, k) (tile_mask true) whose tile_idx is g, taken in
// ascending flat slot order t * K + k from 0 in float32. A Gaussian in no
// live slot gets a row of zeros. Masked slots are never read: they are
// padding whose opacity the forward sets to 0, so the tile backward gives
// them zero gradients, and geom's rows 11-15 are constant zeros. That is
// the order in which index_put_ adds the same values (a stable radix sort
// of the indices, then each duplicate in turn from 0), so on cotangents
// that are zero at masked slots the result equals autograd's bit for
// bit, and one launch equals the next: no float atomics.
//
// What bounds it on this card: bytes. The function must read a live
// slot's 25 values (4 bytes each: ~57 MB at the fit cell's ~570k live
// slots) and write d_table once (100 MB at 1M Gaussians); with the
// integer passes' few MB that is ~0.057 ms at 3.35 TB/s. The reads are
// 4-byte gathers in the tile kernels' (T, rows, K) layout, a 32-byte
// sector each where no two share one (~0.46 GB, ~0.17 ms): a slot's
// neighbours in its tile are other Gaussians, read by other warps. On an
// H100 80GB HBM3 the kernels take ~0.36 ms, ~0.33 of it the reduce: a
// warp for each of the 1M rows keeps enough gathers in flight. (A warp
// for 32 rows, staging them in shared memory for one contiguous store
// and visiting only the ~7% with a live slot, took 0.43 ms: too few
// warps to hide the gathers.)
//
// The design, four launches (the wrapper's cumsum between the first two):
//   packet_indexing_backward_count: a thread a slot; live slots count
//     their Gaussian's slots with an integer atomicAdd;
//   (torch.cumsum of the counts: each segment's end);
//   packet_indexing_backward_fill: a thread a live slot writes its flat
//     id into its Gaussian's segment, at a place an integer atomicSub on
//     the count picks (so the counts end at 0; the order within a
//     segment is the atomics', and the reduce puts it right);
//   packet_indexing_backward_kernel: a warp a Gaussian, lane c its column
//     c. A segment of up to 32 ids (the binning's cap is 16 tiles a
//     Gaussian) is ranked in registers, each lane counting the ids below
//     its own; the warp then adds the slots in rank order, four loads in
//     flight. A longer segment is first sorted in place by the warp (a
//     bitonic network whose comparators all point one way, so the padding
//     to a power of two stays past the end and is never stored). Each row
//     is written once, zeros included, so no memset of d_table runs.
//
// Plain C entry points (bound with ctypes); each returns
// cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGeomRows = 16;   // geom's rows; 0-10 come from the table
constexpr int kTableGeom = 11;  // the table's geometry columns
constexpr int kUnroll = 4;      // slots whose loads a warp keeps in flight
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int gaussian_of(int i, int n) {
  return i < 0 ? i + n : i;  // a negative index counts from the end
}

__global__ void __launch_bounds__(kThreads)
    packet_indexing_backward_count(const int* __restrict__ idx,
                                   const uint8_t* __restrict__ mask,
                                   int slots, int n, int* __restrict__ cnt) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= slots || !mask[s]) return;
  atomicAdd(&cnt[gaussian_of(idx[s], n)], 1);
}

__global__ void __launch_bounds__(kThreads)
    packet_indexing_backward_fill(const int* __restrict__ idx,
                                  const uint8_t* __restrict__ mask,
                                  int slots, int n,
                                  const int* __restrict__ ends,
                                  int* __restrict__ cnt,
                                  int* __restrict__ seg) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= slots || !mask[s]) return;
  const int g = gaussian_of(idx[s], n);
  seg[ends[g] - atomicSub(&cnt[g], 1)] = s;
}

// d_geom / d_featsT value of column c (< 11 + F) at flat slot s.
__device__ __forceinline__ float slot_value(const float* __restrict__ d_geom,
                                            const float* __restrict__ d_feats,
                                            int s, int c, int k, int f) {
  const int t = s / k;
  const int kk = s - t * k;
  return c < kTableGeom
             ? __ldg(d_geom + (static_cast<long long>(t) * kGeomRows + c) * k +
                     kk)
             : __ldg(d_feats +
                     (static_cast<long long>(t) * f + (c - kTableGeom)) * k +
                     kk);
}

// Sorts a[0, len) ascending, in place, by the calling warp: a bitonic
// network over the next power of two, every comparator (lo < hi) putting
// the smaller value at lo, so positions at or past len (virtual INT_MAX)
// never take a real value and are never touched.
__device__ void warp_sort(int* a, int len, int lane) {
  int p = 1;
  while (p < len) p <<= 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (p >> 1); i += 32) {
        const int blk = i / stride, off = i - blk * stride;
        int lo, hi;
        if (stride == (size >> 1)) {  // the merge's first step: mirrored
          lo = blk * size + off;
          hi = blk * size + size - 1 - off;
        } else {
          lo = 2 * stride * blk + off;
          hi = lo + stride;
        }
        if (hi < len) {
          const int x = a[lo], y = a[hi];
          if (x > y) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    packet_indexing_backward_kernel(const float* __restrict__ d_geom,
                                    const float* __restrict__ d_feats,
                                    const int* __restrict__ ends,
                                    int* __restrict__ seg, int n, int k,
                                    int f, float* __restrict__ d_table) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n) return;  // a whole warp leaves together
  const int cols = kTableGeom + f;
  const bool mine = lane < cols;
  const int start = g == 0 ? 0 : ends[g - 1];
  const int len = ends[g] - start;
  float acc = 0.0f;
  if (len <= 32) {
    // Flat slot ids are distinct, so the ranks are 0 .. len - 1; lanes
    // past len hold INT_MAX, rank len or more, and are never picked.
    const int id = lane < len ? seg[start + lane] : INT_MAX;
    int rank = 0;
    for (int j = 0; j < len; ++j) rank += __shfl_sync(kFull, id, j) < id;
    for (int r0 = 0; r0 < len; r0 += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned who =
            __ballot_sync(kFull, r0 + u < len && rank == r0 + u);
        const int s = __shfl_sync(kFull, id, who ? __ffs(who) - 1 : 0);
        v[u] = (who && mine) ? slot_value(d_geom, d_feats, s, lane, k, f)
                             : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r0 + u < len) acc += v[u];
    }
  } else {
    int* a = seg + start;
    warp_sort(a, len, lane);
    for (int r0 = 0; r0 < len; r0 += 32) {
      const int m = min(32, len - r0);
      const int id = lane < m ? a[r0 + lane] : 0;
      for (int j0 = 0; j0 < m; j0 += kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(kFull, id, min(j0 + u, m - 1));
          v[u] = (j0 + u < m && mine)
                     ? slot_value(d_geom, d_feats, s, lane, k, f)
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (j0 + u < m) acc += v[u];
      }
    }
  }
  if (mine) d_table[static_cast<long long>(g) * cols + lane] = acc;
}

int blocks_for(long long items, int per_block) {
  return static_cast<int>((items + per_block - 1) / per_block);
}

}  // namespace

// idx (T, K) int32, mask (T, K) bool as bytes; slots = T * K < 2^31;
// cnt (N,) int32, zero on entry: the live slots of each Gaussian on exit.
extern "C" int ptgs_packet_gather_count(const int* idx, const uint8_t* mask,
                                        int slots, int n, int* cnt,
                                        void* stream) {
  if (slots < 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (slots > 0)
    packet_indexing_backward_count<<<blocks_for(slots, kThreads), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        idx, mask, slots, n, cnt);
  return static_cast<int>(cudaGetLastError());
}

// ends (N,) int32: the inclusive cumsum of cnt; cnt as the count pass left
// it (0 on exit); seg: room for every live slot; d_geom (T, 16, K),
// d_feats (T, F, K) float32 with 11 + F <= 32; d_table (N, 11 + F).
extern "C" int ptgs_packet_gather_reduce(const int* idx, const uint8_t* mask,
                                         int slots, int n, int k, int f,
                                         const int* ends, int* cnt, int* seg,
                                         const float* d_geom,
                                         const float* d_feats, float* d_table,
                                         void* stream) {
  if (slots < 0 || n <= 0 || k <= 0 || f < 0 || kTableGeom + f > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slots > 0)
    packet_indexing_backward_fill<<<blocks_for(slots, kThreads), kThreads, 0,
                                    st>>>(idx, mask, slots, n, ends, cnt, seg);
  packet_indexing_backward_kernel<<<blocks_for(n, kWarps), kThreads, 0, st>>>(
      d_geom, d_feats, ends, seg, n, k, f, d_table);
  return static_cast<int>(cudaGetLastError());
}

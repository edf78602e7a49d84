// Threefry-2x32 uniforms for Hopper (sm_90a): every uniform a path-tracing
// bounce draws, or one frame's subpixel jitter, in one launch.
//
// Replaces jax.random.uniform as the reference calls it in
// pathtracer_gaussiansplatting_tpu/core/rng.py:44-56 (ray_uniform and
// subpixel_jitter), plain XLA there, not a Pallas kernel: XLA fuses each
// draw's hash into one loop. The port's plain version, core/rng.py's
// uniforms_plain, runs the same hash op by op on int64 tensors (~194
// launches a draw).
//
// What it computes: a table of up to kMaxDraws draws, draw j an (R, num_j)
// block of float32 uniforms under the key (k1_j, k2_j), folded on the host
// (dim_key(fold_in(key, d), dim)). Element e of a draw is its flat index
// over the draw's own (R, num_j) shape; it hashes the counter
// (e >> 32, e & 0xFFFFFFFF), and the top 23 bits of y1 ^ y2 become the
// mantissa of a float in [1, 2), minus 1 (jax.random's partitionable
// layout). Draw j fills out[off_j, off_j + R * num_j). In jitter mode the
// one draw is (H * W, 2) and each value becomes fmodf(u + r2[e & 1], 1),
// with the frame's two R2 offsets computed on the host in float32. Every
// step is exact integer or IEEE float32 arithmetic (no fast-math), so the
// result equals the plain version bit for bit.
//
// What bounds it on this card: integer issue. An element takes ~78
// integer operations (2 key adds, 20 rounds of add, rotate and xor, five
// key injections, the counter split and the float assembly) and one 4-byte
// store: at 1080p, 2.07M rays x 11 columns is ~1.8e9 operations against
// 91 MB of writes, ~0.053 ms at the card's issue rate (128 lane operations
// a clock an SM: integer adds and logic issue on the INT32 lanes and, as
// IMAD, on the FMA lanes) and ~0.027 ms at the memory rate.
//
// The design: no memory read but the output store. The key table is a
// by-value kernel parameter (a device tensor would need a host-to-device
// copy each call, and a pageable copy drains the stream). Each block
// writes kPerThread * kThreads consecutive elements of one draw, so the
// draw's key and offset are picked once a thread (an unrolled select over
// the table, no dynamic indexing of the parameter), and each thread hashes
// kPerThread elements kThreads apart, so every store is coalesced. The
// rotations are __funnelshift_l with compile-time counts.
//
// Plain C entry point (bound with ctypes); returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDraws = 16;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

struct Draws {
  uint32_t k1[kMaxDraws], k2[kMaxDraws];
  long long off[kMaxDraws];   // first output element of draw j
  long long size[kMaxDraws];  // R * num_j elements
  int first[kMaxDraws];       // first block of draw j; INT_MAX past n
  float r2[2];                // the jitter's R2 offsets
  int jitter;
};

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x1, uint32_t& x2) {
  x1 += x2;
  x2 = __funnelshift_l(x2, x2, R0) ^ x1;
  x1 += x2;
  x2 = __funnelshift_l(x2, x2, R1) ^ x1;
  x1 += x2;
  x2 = __funnelshift_l(x2, x2, R2) ^ x1;
  x1 += x2;
  x2 = __funnelshift_l(x2, x2, R3) ^ x1;
}

// Threefry-2x32, 20 rounds, of the counter (x1, x2) under (k1, k2);
// returns y1 ^ y2.
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k1, uint32_t k2,
                                                 uint32_t x1, uint32_t x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
  rounds<13, 15, 26, 6>(x1, x2);
  x1 += k2;
  x2 += k3 + 1u;
  rounds<17, 29, 16, 24>(x1, x2);
  x1 += k3;
  x2 += k1 + 2u;
  rounds<13, 15, 26, 6>(x1, x2);
  x1 += k1;
  x2 += k2 + 3u;
  rounds<17, 29, 16, 24>(x1, x2);
  x1 += k2;
  x2 += k3 + 4u;
  rounds<13, 15, 26, 6>(x1, x2);
  x1 += k3;
  x2 += k1 + 5u;
  return x1 ^ x2;
}

__global__ void __launch_bounds__(kThreads)
    threefry_uniforms_kernel(const Draws t, float* __restrict__ out) {
  // This block's draw: the last whose first block is at or before it.
  uint32_t k1 = t.k1[0], k2 = t.k2[0];
  long long off = t.off[0], size = t.size[0];
  int first = 0;
#pragma unroll
  for (int s = 1; s < kMaxDraws; ++s) {
    if (static_cast<int>(blockIdx.x) >= t.first[s]) {
      k1 = t.k1[s];
      k2 = t.k2[s];
      off = t.off[s];
      size = t.size[s];
      first = t.first[s];
    }
  }
  const long long start =
      (static_cast<long long>(blockIdx.x) - first) * kPerBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = start + k * kThreads;
    if (e >= size) break;
    const uint32_t bits = threefry_xor(
        k1, k2, static_cast<uint32_t>(static_cast<uint64_t>(e) >> 32),
        static_cast<uint32_t>(e));
    float u = fmaxf(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
    if (t.jitter) u = fmodf(u + ((e & 1) ? t.r2[1] : t.r2[0]), 1.0f);
    out[off + e] = u;
  }
}

}  // namespace

// out: the flat float32 buffer, r * sum(nums) elements, draw j at
// r * (nums[0] + ... + nums[j - 1]); keys: host uint32 pairs (k1, k2) a
// draw; nums: host ints, each >= 1. jitter != 0 takes one draw of num 2
// and adds (r2x, r2y) modulo 1. Returns a cudaError_t.
extern "C" int ptgs_threefry_uniforms(float* out, const uint32_t* keys,
                                      const int* nums, int n_draws,
                                      long long r, int jitter, float r2x,
                                      float r2y, void* stream) {
  if (r <= 0 || n_draws <= 0 || n_draws > kMaxDraws ||
      (jitter && (n_draws != 1 || nums[0] != 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Draws t{};
  long long off = 0, blocks = 0;
  for (int j = 0; j < kMaxDraws; ++j) {
    if (j >= n_draws) {
      t.first[j] = INT_MAX;
      continue;
    }
    if (nums[j] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.k1[j] = keys[2 * j];
    t.k2[j] = keys[2 * j + 1];
    t.off[j] = off;
    t.size[j] = r * nums[j];
    t.first[j] = static_cast<int>(blocks);
    off += t.size[j];
    blocks += (t.size[j] + kPerBlock - 1) / kPerBlock;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.r2[0] = r2x;
  t.r2[1] = r2y;
  t.jitter = jitter;
  threefry_uniforms_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(t, out);
  return static_cast<int>(cudaGetLastError());
}

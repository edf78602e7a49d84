// Host-side grid binning for the uniform-grid trace backend.
//
// The port's own copy of grid_bin_aniso and chebyshev_dist from
// pathtracer_gaussiansplatting_tpu/csrc/native.cpp (same algorithms, same
// arithmetic): built with g++ into a shared library at first use
// (csrc/build.py: build_host) and loaded with ctypes (csrc/grid_bin.py).
// Host code, not a kernel: it runs once per scene, where the reference
// runs it, and at 500k Gaussians numpy's Python loop would take minutes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Bin n axis-aligned boxes (center +- ext per axis: the 3-sigma AABB of each
// Gaussian) into a gx*gy*gz world grid over [lo, hi], cells z-major. Each
// cell keeps up to max_per_cell indices in insertion order; when a cell
// overflows, the LOWEST-priority entry (the first of equal minima) is
// evicted in place if the newcomer's priority is higher. The slot order
// this leaves decides the (t, slot) tie order of the marcher, so it is the
// reference's to the letter. cell_counts report untruncated totals.
void ptgs_grid_bin_aniso(const float* centers, const float* exts,
                         const float* priority, int64_t n, const float* lo,
                         const float* hi, int32_t gx, int32_t gy, int32_t gz,
                         int32_t max_per_cell, int32_t* cell_indices,
                         int32_t* cell_counts) {
  const int64_t n_cells = (int64_t)gx * gy * gz;
  std::memset(cell_counts, 0, n_cells * sizeof(int32_t));
  for (int64_t i = 0; i < n_cells * max_per_cell; ++i) cell_indices[i] = -1;
  std::vector<float> prio(n_cells * (int64_t)max_per_cell);

  float ext[3], inv_cell[3];
  int32_t dims[3] = {gx, gy, gz};
  for (int k = 0; k < 3; ++k) {
    ext[k] = hi[k] - lo[k];
    if (ext[k] < 1e-12f) ext[k] = 1e-12f;
    inv_cell[k] = dims[k] / ext[k];
  }
  for (int64_t i = 0; i < n; ++i) {
    const float* c = centers + i * 3;
    const float* e = exts + i * 3;
    float p = priority ? priority[i] : 1.0f;
    int32_t c0[3], c1[3];
    for (int k = 0; k < 3; ++k) {
      c0[k] = (int32_t)std::floor((c[k] - e[k] - lo[k]) * inv_cell[k]);
      c1[k] = (int32_t)std::floor((c[k] + e[k] - lo[k]) * inv_cell[k]);
      c0[k] = std::max(0, std::min(dims[k] - 1, c0[k]));
      c1[k] = std::max(0, std::min(dims[k] - 1, c1[k]));
    }
    for (int32_t z = c0[2]; z <= c1[2]; ++z)
      for (int32_t y = c0[1]; y <= c1[1]; ++y)
        for (int32_t x = c0[0]; x <= c1[0]; ++x) {
          int64_t cell = ((int64_t)z * gy + y) * gx + x;
          int32_t cnt = cell_counts[cell];
          cell_counts[cell] = cnt + 1;
          int32_t* row = cell_indices + cell * max_per_cell;
          float* prow = prio.data() + cell * max_per_cell;
          if (cnt < max_per_cell) {
            row[cnt] = (int32_t)i;
            prow[cnt] = p;
          } else {
            int32_t lo_slot = 0;
            for (int32_t s = 1; s < max_per_cell; ++s)
              if (prow[s] < prow[lo_slot]) lo_slot = s;
            if (p > prow[lo_slot]) {
              row[lo_slot] = (int32_t)i;
              prow[lo_slot] = p;
            }
          }
        }
  }
}

// Exact chessboard (chebyshev) distance transform of a 3D occupancy grid
// (z-major), two-pass chamfer scan: dist[i] = 0 for occupied cells, else
// the chebyshev distance to the nearest occupied cell, saturated at cap.
// The empty-block jump table's fallback where scipy is missing.
void ptgs_chebyshev_dist(const uint8_t* occupied, int32_t gx, int32_t gy,
                         int32_t gz, int32_t cap, uint8_t* dist) {
  const int64_t n = (int64_t)gx * gy * gz;
  const int32_t big = cap;
  std::vector<int32_t> d(n);
  for (int64_t i = 0; i < n; ++i) d[i] = occupied[i] ? 0 : big;
  auto at = [&](int32_t x, int32_t y, int32_t z) -> int32_t& {
    return d[((int64_t)z * gy + y) * gx + x];
  };
  // forward pass: neighbors with lower scan order
  for (int32_t z = 0; z < gz; ++z)
    for (int32_t y = 0; y < gy; ++y)
      for (int32_t x = 0; x < gx; ++x) {
        int32_t& v = at(x, y, z);
        if (v == 0) continue;
        for (int32_t dz = -1; dz <= 0; ++dz)
          for (int32_t dy = -1; dy <= 1; ++dy)
            for (int32_t dx = -1; dx <= 1; ++dx) {
              if (dz == 0 && (dy > 0 || (dy == 0 && dx >= 0))) continue;
              int32_t nx = x + dx, ny = y + dy, nz = z + dz;
              if (nx < 0 || ny < 0 || nz < 0 || nx >= gx || ny >= gy ||
                  nz >= gz)
                continue;
              int32_t c = at(nx, ny, nz) + 1;
              if (c < v) v = c;
            }
      }
  // backward pass
  for (int32_t z = gz - 1; z >= 0; --z)
    for (int32_t y = gy - 1; y >= 0; --y)
      for (int32_t x = gx - 1; x >= 0; --x) {
        int32_t& v = at(x, y, z);
        if (v == 0) continue;
        for (int32_t dz = 0; dz <= 1; ++dz)
          for (int32_t dy = -1; dy <= 1; ++dy)
            for (int32_t dx = -1; dx <= 1; ++dx) {
              if (dz == 0 && (dy < 0 || (dy == 0 && dx <= 0))) continue;
              int32_t nx = x + dx, ny = y + dy, nz = z + dz;
              if (nx < 0 || ny < 0 || nz < 0 || nx >= gx || ny >= gy ||
                  nz >= gz)
                continue;
              int32_t c = at(nx, ny, nz) + 1;
              if (c < v) v = c;
            }
      }
  for (int64_t i = 0; i < n; ++i) dist[i] = (uint8_t)std::min(d[i], big);
}

}  // extern "C"

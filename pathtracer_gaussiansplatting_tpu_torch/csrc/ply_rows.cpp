// Ascii point-cloud PLY body rows for the dataset writer.
//
// The port's own copy of format_ply_rows from
// pathtracer_gaussiansplatting_tpu/csrc/native.cpp (the same format string,
// so the same bytes): built with g++ into the host library at first use
// (csrc/build.py: build_host) and loaded with ctypes (csrc/ply_rows.py).
// Host code, not a kernel: a capture writes ~1M rows once, and Python's
// per-row %g formatting is the slow part of that.

#include <cstdint>
#include <cstdio>

extern "C" {

// Formats n rows "x y z nx ny nz r g b\n" (each float as %g, each color as
// %u) into out; returns the bytes written, or -1 if fewer than 160 bytes
// are left before a row (no row is longer than 100 bytes).
int64_t ptgs_format_ply_rows(const float* pos, const float* nrm,
                             const uint8_t* rgb, int64_t n, char* out,
                             int64_t capacity) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (capacity - w < 160) return -1;
    int written = snprintf(
        out + w, (size_t)(capacity - w), "%g %g %g %g %g %g %u %u %u\n",
        pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2], nrm[i * 3],
        nrm[i * 3 + 1], nrm[i * 3 + 2], rgb[i * 3], rgb[i * 3 + 1],
        rgb[i * 3 + 2]);
    if (written <= 0) return -1;
    w += written;
  }
  return w;
}

}  // extern "C"

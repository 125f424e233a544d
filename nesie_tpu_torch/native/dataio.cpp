// Native data-loading core for nesie_tpu_torch (a copy of
// nesie_tpu/native/dataio.cpp).
//
// Counterpart of the reference's C++/CUDA-backed data path
// (torch DataLoader workers + .bin parsing): reads a float32 .bin point
// cloud, applies the scene's 4x4 axis alignment, computes the shift-height
// channel (z minus the 0.99-percentile floor, reference
// pipelines/loading.py:86-92), and draws a random subsample — all in one
// pass, exposed through a plain C ABI for ctypes.
//
// Built on first use by nesie_tpu_torch/data/native_loader.py into
// build/nesie_tpu_torch/libdataio.so.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// splitmix64 -> xoshiro-style PRNG; deterministic per seed (the host RNG
// stream is an implementation detail — the reference's np.random draw is a
// different stream too, seeded per worker).
static inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// Load a .bin of `load_dim` float32 columns; keep xyz; apply the 4x4
// row-major `axis_align` (or pass nullptr); append height channel; sample
// `num_points` rows (without replacement when possible).
// Writes (num_points, 4) float32 into `out`. Returns 0 on success.
int load_scene(const char *path, int load_dim, const float *axis_align,
               int num_points, uint64_t seed, float *out) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  long n = bytes / (long)(sizeof(float) * load_dim);
  if (n <= 0) {
    fclose(f);
    return -2;
  }
  std::vector<float> raw((size_t)n * load_dim);
  if (fread(raw.data(), sizeof(float), raw.size(), f) != raw.size()) {
    fclose(f);
    return -3;
  }
  fclose(f);

  // xyz (+ alignment)
  std::vector<float> xyz((size_t)n * 3);
  for (long i = 0; i < n; ++i) {
    const float *p = &raw[(size_t)i * load_dim];
    float x = p[0], y = p[1], z = p[2];
    if (axis_align) {
      const float *m = axis_align;
      float nx = m[0] * x + m[1] * y + m[2] * z + m[3];
      float ny = m[4] * x + m[5] * y + m[6] * z + m[7];
      float nz = m[8] * x + m[9] * y + m[10] * z + m[11];
      x = nx;
      y = ny;
      z = nz;
    }
    xyz[(size_t)i * 3 + 0] = x;
    xyz[(size_t)i * 3 + 1] = y;
    xyz[(size_t)i * 3 + 2] = z;
  }

  // floor = 0.99th percentile of z (numpy 'linear': idx = q/100 * (n-1))
  std::vector<float> zs(n);
  for (long i = 0; i < n; ++i) zs[i] = xyz[(size_t)i * 3 + 2];
  double pos = (0.99 / 100.0) * (double)(n - 1);
  long lo = (long)pos;
  long hi = std::min(lo + 1, n - 1);
  std::nth_element(zs.begin(), zs.begin() + lo, zs.end());
  float zlo = zs[lo];
  std::nth_element(zs.begin(), zs.begin() + hi, zs.end());
  float zhi = zs[hi];
  float frac = (float)(pos - (double)lo);
  float floor_z = zlo + (zhi - zlo) * frac;

  // sample indices
  uint64_t st = seed ? seed : 0x853C49E6748FEA9Bull;
  std::vector<long> idx(num_points);
  if (n >= num_points) {
    // partial Fisher-Yates over an index vector
    std::vector<long> perm(n);
    for (long i = 0; i < n; ++i) perm[i] = i;
    for (int i = 0; i < num_points; ++i) {
      long j = i + (long)(splitmix64(st) % (uint64_t)(n - i));
      std::swap(perm[i], perm[j]);
      idx[i] = perm[i];
    }
  } else {
    for (int i = 0; i < num_points; ++i)
      idx[i] = (long)(splitmix64(st) % (uint64_t)n);
  }

  for (int i = 0; i < num_points; ++i) {
    const float *p = &xyz[(size_t)idx[i] * 3];
    out[(size_t)i * 4 + 0] = p[0];
    out[(size_t)i * 4 + 1] = p[1];
    out[(size_t)i * 4 + 2] = p[2];
    out[(size_t)i * 4 + 3] = p[2] - floor_z;
  }
  return 0;
}

// Number of points in a .bin file (for inspection).
long scene_num_points(const char *path, int load_dim) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fclose(f);
  return bytes / (long)(sizeof(float) * load_dim);
}

}  // extern "C"

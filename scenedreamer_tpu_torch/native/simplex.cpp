// Native fBm simplex-noise grid evaluator.
//
// The reference terrain generator leans on the C `noise` extension
// (snoise3 in terrain_generator.py:89-102); our numpy port
// (scene/noise.py) is vectorized but still burns ~22s/1024^2 map in
// Python. This OpenMP kernel computes whole fBm maps with the exact
// same permutation table, gradient set, and branch identities as
// scene/noise.py, so outputs agree to float64 rounding.
//
// C ABI (ctypes; no pybind11 in this image):
//   fbm3_grid(size, scale, z, octaves, persistence, lacunarity,
//             perm[512], out[size*size])
#include <cmath>
#include <cstdint>

static const double F3 = 1.0 / 3.0;
static const double G3 = 1.0 / 6.0;

static const double GRAD3[12][3] = {
    {1, 1, 0},  {-1, 1, 0},  {1, -1, 0}, {-1, -1, 0},
    {1, 0, 1},  {-1, 0, 1},  {1, 0, -1}, {-1, 0, -1},
    {0, 1, 1},  {0, -1, 1},  {0, 1, -1}, {0, -1, -1}};

static inline int gindex(const int64_t* perm, int64_t i, int64_t j,
                         int64_t k) {
  return (int)(perm[(i + perm[(j + perm[k & 255]) & 255]) & 255] % 12);
}

static inline double simplex3(const int64_t* perm, double x, double y,
                              double z) {
  double s = (x + y + z) * F3;
  int64_t i = (int64_t)std::floor(x + s);
  int64_t j = (int64_t)std::floor(y + s);
  int64_t k = (int64_t)std::floor(z + s);
  double t = (double)(i + j + k) * G3;
  double x0 = x - ((double)i - t);
  double y0 = y - ((double)j - t);
  double z0 = z - ((double)k - t);

  // identical boolean identities to scene/noise.py:46-54
  int gx = x0 >= y0, gy = y0 >= z0, gz = x0 >= z0;
  int i1 = gx & gz;
  int j1 = (1 - gx) & gy;
  int k1 = (1 - gy) & (1 - gz);
  int i2 = gx | (gy & gz);
  int j2 = gy | ((1 - gx) & (1 - gz));
  int k2 = 1 - (gy & gz);

  double xs[4] = {x0, x0 - i1 + G3, x0 - i2 + 2.0 * G3,
                  x0 - 1.0 + 3.0 * G3};
  double ys[4] = {y0, y0 - j1 + G3, y0 - j2 + 2.0 * G3,
                  y0 - 1.0 + 3.0 * G3};
  double zs[4] = {z0, z0 - k1 + G3, z0 - k2 + 2.0 * G3,
                  z0 - 1.0 + 3.0 * G3};
  int ois[4] = {0, i1, i2, 1};
  int ojs[4] = {0, j1, j2, 1};
  int oks[4] = {0, k1, k2, 1};

  double out = 0.0;
  for (int c = 0; c < 4; ++c) {
    double dx = xs[c], dy = ys[c], dz = zs[c];
    double tt = 0.6 - dx * dx - dy * dy - dz * dz;
    if (tt > 0.0) {
      int gi = gindex(perm, i + ois[c], j + ojs[c], k + oks[c]);
      const double* g = GRAD3[gi];
      double t4 = tt * tt * tt * tt;
      out += t4 * (g[0] * dx + g[1] * dy + g[2] * dz);
    }
  }
  return 32.0 * out;
}

extern "C" {

// out[y * size + x] = fbm3((x + 0.1) / scale, y / scale, z)
void fbm3_grid(int size, double scale, double z, int octaves,
               double persistence, double lacunarity,
               const int64_t* perm, double* out) {
  double norm = 0.0, amp = 1.0;
  for (int o = 0; o < octaves; ++o) {
    norm += amp;
    amp *= persistence;
  }
#pragma omp parallel for schedule(static)
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      double fx = ((double)x + 0.1) / scale;
      double fy = (double)y / scale;
      double total = 0.0, a = 1.0, freq = 1.0;
      for (int o = 0; o < octaves; ++o) {
        total += a * simplex3(perm, fx * freq, fy * freq, z * freq);
        a *= persistence;
        freq *= lacunarity;
      }
      out[(int64_t)y * size + x] = total / norm;
    }
  }
}

// generic point evaluator (arbitrary coordinate arrays)
void fbm3_points(int64_t n, const double* xs, const double* ys, double z,
                 int octaves, double persistence, double lacunarity,
                 const int64_t* perm, double* out) {
  double norm = 0.0, amp = 1.0;
  for (int o = 0; o < octaves; ++o) {
    norm += amp;
    amp *= persistence;
  }
#pragma omp parallel for schedule(static)
  for (int64_t idx = 0; idx < n; ++idx) {
    double total = 0.0, a = 1.0, freq = 1.0;
    for (int o = 0; o < octaves; ++o) {
      total += a * simplex3(perm, xs[idx] * freq, ys[idx] * freq,
                            z * freq);
      a *= persistence;
      freq *= lacunarity;
    }
    out[idx] = total / norm;
  }
}

}  // extern "C"

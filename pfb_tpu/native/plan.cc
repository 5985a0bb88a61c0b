// Native uv counts for Briggs weighting.
//
// The sampling density (uv counts) of every visibility, gridded with
// the ES k-stencil onto the image-sized uv grid: the reference's
// numba _compute_counts kernel (pfb/utils/weighting.py:43-103) as
// C++ with OpenMP. Exposed as a plain C ABI consumed via ctypes
// (pfb_tpu/native/__init__.py); all buffers are allocated by the
// caller.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Sampling-density (uv counts) gridding with the ES k-stencil —
// the reference's numba _compute_counts kernel
// (pfb/utils/weighting.py:43-103) as native code: threads accumulate
// into private grids (bounded thread count keeps the nx*ny copies in
// memory), reduced at the end. Per-tap drop semantics for
// out-of-grid taps. Mirrors pfb_tpu/ops/weighting.py exactly.
int pg_compute_counts(const double* uvw, int64_t nrow,
                      const double* freq, int64_t nchan,
                      const uint8_t* mask, int64_t nx, int64_t ny,
                      double cellx, double celly, int k,
                      double* out) {
  const double u_cell = 1.0 / ((double)nx * cellx);
  const double umax = std::fabs(-1.0 / cellx / 2.0 - u_cell / 2.0);
  const double v_cell = 1.0 / ((double)ny * celly);
  const double vmax = std::fabs(-1.0 / celly / 2.0 - v_cell / 2.0);
  const double c0 = 299792458.0;
  const int ko2 = k / 2;
  const int64_t npix = nx * ny;
  const double beta_k = 2.3 * (double)k;
  if (k > 16) return -1;  // the per-row tap buffer holds 16
#pragma omp parallel num_threads(8)
  {
    std::vector<double> loc(npix, 0.0);
    std::vector<double> nf(nchan);
    for (int64_t c = 0; c < nchan; ++c) nf[c] = freq[c] / c0;
#pragma omp for schedule(static) nowait
    for (int64_t r = 0; r < nrow; ++r) {
      const double uu = uvw[3 * r], vv = uvw[3 * r + 1];
      for (int64_t c = 0; c < nchan; ++c) {
        if (!mask[r * nchan + c]) continue;
        const double ug = (uu * nf[c] + umax) / u_cell;
        const double vg = (vv * nf[c] + vmax) / v_cell;
        if (k) {
          const int64_t ui = (int64_t)std::nearbyint(ug);
          const int64_t vi = (int64_t)std::nearbyint(vg);
          double yv[16];
          for (int j = -ko2; j < ko2; ++j) {
            const int64_t y = vi + j;
            const double t = ((double)y - vg + 0.5) / (double)ko2;
            yv[j + ko2] = (std::fabs(t) <= 1.0)
                ? std::exp(beta_k * (std::sqrt(std::max(
                      (1.0 - t) * (1.0 + t), 0.0)) - 1.0))
                : 0.0;
          }
          for (int i = -ko2; i < ko2; ++i) {
            const int64_t x = ui + i;
            if (x < 0 || x >= nx) continue;
            const double tx = ((double)x - ug + 0.5) / (double)ko2;
            if (std::fabs(tx) > 1.0) continue;
            const double xv = std::exp(beta_k * (std::sqrt(std::max(
                (1.0 - tx) * (1.0 + tx), 0.0)) - 1.0));
            double* rowp = loc.data() + x * ny;
            for (int j = -ko2; j < ko2; ++j) {
              const int64_t y = vi + j;
              if (y < 0 || y >= ny) continue;
              rowp[y] += xv * yv[j + ko2];
            }
          }
        } else {
          const int64_t ui = (int64_t)std::floor(ug);
          const int64_t vi = (int64_t)std::floor(vg);
          if (ui >= 0 && ui < nx && vi >= 0 && vi < ny)
            loc[ui * ny + vi] += 1.0;
        }
      }
    }
#pragma omp critical
    {
      for (int64_t i = 0; i < npix; ++i) out[i] += loc[i];
    }
  }
  return 0;
}

}  // extern "C"

// Native doublet (segment) selection for graph preprocessing.
//
// The preprocessing hot loop of the reference is a pandas cross-join per
// layer pair (`/root/reference/gnn/graph.py:44-66`), measured at ~minutes
// per mu200 file (`GraphConstructionDev_mu200.ipynb:cell9`).  The Python
// rewrite (gnn_fpga_jax/data/doublets.py) vectorises it with numpy
// broadcasting; this C++ implementation removes the O(n1*n2) temporary
// matrices entirely (blocked loops, OpenMP across rows) and feeds the same
// ctypes interface.
//
// Exported C ABI (see gnn_fpga_jax/data/native.py):
//   select_segments_f64: count+emit surviving (i1, i2) pairs.
//     Returns the number of pairs written (<= max_out); if the output
//     capacity is insufficient, returns the required count negated.

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
constexpr double kPi = 3.14159265358979323846;

inline double wrap_dphi(double dphi) {
  if (dphi > kPi) return dphi - 2 * kPi;
  if (dphi < -kPi) return dphi + 2 * kPi;
  return dphi;
}
}  // namespace

extern "C" {

// Count-only pass: number of pairs surviving the cuts.
int64_t count_segments_f64(const double* r1, const double* phi1,
                           const double* z1, int64_t n1, const double* r2,
                           const double* phi2, const double* z2, int64_t n2,
                           double phi_slope_max, double z0_max) {
  int64_t total = 0;
#pragma omp parallel for reduction(+ : total) schedule(static)
  for (int64_t i = 0; i < n1; ++i) {
    const double ri = r1[i], pi = phi1[i], zi = z1[i];
    int64_t row = 0;
    for (int64_t j = 0; j < n2; ++j) {
      const double dphi = wrap_dphi(phi2[j] - pi);
      const double dr = r2[j] - ri;
      const double dz = z2[j] - zi;
      const double phi_slope = dphi / dr;
      const double z0 = zi - ri * dz / dr;
      row += (std::fabs(phi_slope) < phi_slope_max) &&
             (std::fabs(z0) < z0_max);
    }
    total += row;
  }
  return total;
}

// Emit pass: write surviving (i1, i2) pairs into out1/out2 (capacity
// max_out).  Returns pairs written, or -(required) if capacity is too
// small (caller re-allocates and retries).
int64_t select_segments_f64(const double* r1, const double* phi1,
                            const double* z1, int64_t n1, const double* r2,
                            const double* phi2, const double* z2, int64_t n2,
                            double phi_slope_max, double z0_max,
                            int64_t* out1, int64_t* out2, int64_t max_out) {
  // Per-row counts for prefix offsets (parallel emit without atomics).
  std::vector<int64_t> row_counts(static_cast<size_t>(n1) + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n1; ++i) {
    const double ri = r1[i], pi = phi1[i], zi = z1[i];
    int64_t c = 0;
    for (int64_t j = 0; j < n2; ++j) {
      const double dphi = wrap_dphi(phi2[j] - pi);
      const double dr = r2[j] - ri;
      const double dz = z2[j] - zi;
      c += (std::fabs(dphi / dr) < phi_slope_max) &&
           (std::fabs(zi - ri * dz / dr) < z0_max);
    }
    row_counts[i + 1] = c;
  }
  for (int64_t i = 0; i < n1; ++i) row_counts[i + 1] += row_counts[i];
  const int64_t total = row_counts[n1];
  if (total > max_out) return -total;

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n1; ++i) {
    const double ri = r1[i], pi = phi1[i], zi = z1[i];
    int64_t k = row_counts[i];
    for (int64_t j = 0; j < n2; ++j) {
      const double dphi = wrap_dphi(phi2[j] - pi);
      const double dr = r2[j] - ri;
      const double dz = z2[j] - zi;
      if ((std::fabs(dphi / dr) < phi_slope_max) &&
          (std::fabs(zi - ri * dz / dr) < z0_max)) {
        out1[k] = i;
        out2[k] = j;
        ++k;
      }
    }
  }
  return total;
}

int num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

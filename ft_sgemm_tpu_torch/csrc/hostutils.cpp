// Native host utilities for ft_sgemm_tpu_torch (reference: utils/utils.cu).
//
// The port's own copy of ft_sgemm_tpu/csrc/hostutils.cpp (the port builds
// nothing of the JAX package), exposed to Python through ctypes (see
// ft_sgemm_tpu_torch/runtime/__init__.py). Two things justify native code:
//
//  1. Bit-exact input parity: the reference seeds libc rand (srand(10),
//     sgemm.cu:12) and draws two rand() calls per element
//     (utils.cu:23-31). Reproducing that stream from Python is fragile;
//     calling the same libc here is exact.
//  2. Host-side verification/generation speed on big sweeps (6144^2
//     matrices) without holding the GIL.
//
// Build: g++ -O3 -shared -fPIC hostutils.cpp -o libftsgemm_hostutils.so

#include <cmath>
#include <cstdint>
#include <cstdlib>

extern "C" {

// Reference utils.cu:23-31 — element = (rand()%10)*0.1, negated when a
// second draw is odd; row-major double loop over (n, m). The reference is
// square (n x n); m generalizes it.
void ftsg_generate_random_matrix(float* target, int n, int m,
                                 unsigned int seed, int reseed) {
  if (reseed) srand(seed);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < m; ++j) {
      float tmp = (float)(rand() % 10) * 0.1f;
      tmp = (rand() % 2 == 0) ? tmp : -tmp;
      target[i * m + j] = tmp;
    }
  }
}

// Reference utils.cu:15-21.
void ftsg_generate_random_vector(float* target, int n, unsigned int seed,
                                 int reseed) {
  if (reseed) srand(seed);
  for (int i = 0; i < n; ++i) {
    float tmp = (float)(rand() % 5) * 0.01f + (float)(rand() % 5) * 0.001f;
    tmp = (rand() % 2 == 0) ? tmp : -tmp;
    target[i] = tmp;
  }
}

// Reference utils.cu:61-77 tolerance: an element fails iff
// abs diff > 0.01 AND relative diff (vs ref) > 0.01. Returns the number of
// failing elements; *first_bad gets the flat index of the first failure
// (or -1). Unlike the reference (early exit, printf), this scans fully.
long long ftsg_verify_matrix(const float* ref, const float* out, int m, int n,
                             double abs_tol, double rel_tol,
                             long long* first_bad) {
  long long bad = 0;
  *first_bad = -1;
  const long long total = (long long)m * n;
  for (long long idx = 0; idx < total; ++idx) {
    double diff = std::fabs((double)ref[idx] - (double)out[idx]);
    double denom = std::fabs((double)ref[idx]);
    double rel = denom > 0.0 ? diff / denom : (diff > 0.0 ? INFINITY : 0.0);
    if (diff > abs_tol && rel > rel_tol) {
      if (*first_bad < 0) *first_bad = idx;
      ++bad;
    }
  }
  return bad;
}

// Reference utils.cu:79-89 — naive triple loop, C = alpha*A@B + beta*C,
// row-major (m x k)(k x n). Double accumulator like the reference's float
// temp widened for orderliness of the oracle.
void ftsg_cpu_gemm(float alpha, float beta, const float* a, const float* b,
                   float* c, int m, int n, int k) {
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) {
      double t = 0.0;
      for (int p = 0; p < k; ++p) {
        t += (double)a[i * k + p] * (double)b[p * n + j];
      }
      c[i * n + j] = alpha * (float)t + beta * c[i * n + j];
    }
  }
}

// Two-pass ABFT residual check on a host buffer (the native analog of the
// checksum math in include/baseline_ft_sgemm.cuh:9-31): returns max
// |rowsum(C) - expected_row| over rows, writing the column-side max via
// *col_residual. expected vectors have length m and n respectively.
double ftsg_checksum_residual(const float* c, const double* expected_row,
                              const double* expected_col, int m, int n,
                              double* col_residual) {
  double max_r = 0.0;
  for (int i = 0; i < m; ++i) {
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += (double)c[i * n + j];
    double r = std::fabs(expected_row[i] - s);
    if (r > max_r) max_r = r;
  }
  double max_c = 0.0;
  for (int j = 0; j < n; ++j) {
    double s = 0.0;
    for (int i = 0; i < m; ++i) s += (double)c[i * n + j];
    double r = std::fabs(expected_col[j] - s);
    if (r > max_c) max_c = r;
  }
  *col_residual = max_c;
  return max_r;
}

}  // extern "C"

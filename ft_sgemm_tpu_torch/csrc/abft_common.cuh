// Device functions shared by the fused-ABFT kernels (ft_sgemm_weighted.cu,
// ft_sgemm_running.cuh), written once. Each is the Hopper form of one JAX
// device function in ft_sgemm_tpu/ops/ft_sgemm.py:
//
//   weighted_localize        <- _weighted_localize      (:498-513)
//   weighted_column          <- _moment_detect_correct  (:287-339), per column
//   EPS8                     <- _correction_pads         (:342-357)
//   variance_bound_threshold <- ops/common.py::variance_bound_threshold
//                               (:148-185), as _adaptive_threshold (:360)
//                               evaluates it per tile and check
//
// The kernels reduce the accumulator's column moments over their own
// fragment maps (gemm_wgmma.cuh) and call weighted_column once per column.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

// FTSG_ADAPTIVE=1 builds B3-B8 for threshold="adaptive": each check derives
// every sub-tile's threshold from that sub-tile's running moments
// (ft_sgemm_running.cuh: SubTileThresholds). The default build reads the
// thresholds from the scalar argument (static and "auto").
#ifndef FTSG_ADAPTIVE
#define FTSG_ADAPTIVE 0
#endif

// The two builds are loaded into one process and share their sources, so
// the adaptive build's C++ symbols live in an inline namespace of their own:
// no mangled name has two bodies (the C entry points are looked up per
// library).
#if FTSG_ADAPTIVE
#define FTSG_NAMESPACE_BEGIN namespace ftsg { inline namespace adaptive {
#define FTSG_NAMESPACE_END } }
#else
#define FTSG_NAMESPACE_BEGIN namespace ftsg {
#define FTSG_NAMESPACE_END }
#endif

FTSG_NAMESPACE_BEGIN

constexpr bool kAdaptive = FTSG_ADAPTIVE != 0;

// The kernels' scalar argument, passed by value. Slot meanings are
// contracts.SCALAR_SLOTS, shared with the JAX kernels' SMEM operand.
struct Scalars {
  float s[8];
};
enum Slot {
  SLOT_ENABLED = 0,
  SLOT_EVERY = 1,
  SLOT_MAGNITUDE = 2,
  SLOT_COL_STRIDE = 3,
  SLOT_THRESHOLD = 4,
  SLOT_THR_M1 = 5,
  SLOT_THR_M2 = 6,
  SLOT_MARGIN = 7,
};

// The clean-residual noise model's host constants (ops/common.py): the
// static log2 of the full padded run's accumulation length, nk * bk *
// max(bm, bn), and the calibrated random-walk and bias coefficients.
// Passed by value; only the adaptive build reads them.
struct NoiseModel {
  float log2_t, c_rand, c_bias;
};

// Thresholds saturate at a finite huge value (ops/common.THRESHOLD_CAP): an
// inf threshold would disable the check it parameterizes.
constexpr float THRESHOLD_CAP = FLT_MAX / 16.0f;

// margin * eps * (c_rand sqrt(t_ab) sigma + c_bias log2_t t_ab |mu|) with
// sigma = sqrt((s_a2 / n_a) (s_b2 / n_b)) and mu = (s_a1 / n_a) (s_b1 / n_b):
// the noise bound of one tile from the sums and sums of squares of the n_a
// A and n_b B elements it has consumed, at accumulation length t_ab. The
// same formula, in the same order, as ops/common.variance_bound_threshold,
// in f32; no transcendental beyond sqrtf.
__device__ __forceinline__ float variance_bound_threshold(
    float s_a1, float s_a2, float s_b1, float s_b2, float n_a, float n_b,
    float t_ab, const NoiseModel& nm, float margin) {
  const float mu = (s_a1 / n_a) * (s_b1 / n_b);
  const float sigma = sqrtf((s_a2 / n_a) * (s_b2 / n_b));
  const float noise = FLT_EPSILON * (nm.c_rand * sqrtf(t_ab) * sigma +
                                     nm.c_bias * nm.log2_t * t_ab * fabsf(mu));
  return fminf(margin * noise, THRESHOLD_CAP);
}

// sqrt of a positive constant, evaluated at compile time (Newton's method in
// double): the adaptive thresholds' fixed factors bm / sqrt(3), bm^2 /
// sqrt(5) and sqrt(bn), rounded to f32 once, as the JAX package's
// float(bm / np.sqrt(3.0)).
__host__ __device__ constexpr double const_sqrt(double x, double r = 1.0,
                                                int it = 64) {
  return it == 0 ? r : const_sqrt(x, 0.5 * (r + x / r), it - 1);
}

// A correction of magnitude |delta| cannot verify tighter than its own f32
// rounding: the re-checks widen each threshold by 8 * eps * sum |delta|
// (times the moment weight), as _correction_pads does.
constexpr float EPS8 = 8.0f * FLT_EPSILON;

// Fault row of a flagged column from the weighted-residual ratio:
// round(res_cw / res_c) - 1, rounding half to even like jnp.round. -1 for a
// column that did not flag.
__device__ __forceinline__ int weighted_localize(float res_c, float res_cw,
                                                 bool det) {
  return det ? __float2int_rn(res_cw / res_c) - 1 : -1;
}

// The per-column decision of the weighted check, for any accumulator layout:
// from a column's expected moments (exp_*) and the accumulator's (cs*), the
// residuals, the fault row by the weighted ratio, the correction `delta` at
// `row` (-1: none) and the three-moment re-check after it (`bad`).
struct ColumnVerdict {
  bool hit, bad;
  float delta;
  int row;
};

__device__ __forceinline__ ColumnVerdict weighted_column(
    float exp_c, float exp_cw, float exp_cw2, float cs, float csw, float csw2,
    int bm, float thr, float thr_m1, float thr_m2) {
  const float res_c = exp_c - cs;
  const float res_cw = exp_cw - csw;
  const bool det = fabsf(res_c) > thr;
  const int loc = weighted_localize(res_c, res_cw, det);
  const bool hit = det && loc >= 0 && loc < bm;
  const float w = hit ? (float)(loc + 1) : 0.f;
  const float delta = hit ? res_c : 0.f;
  const float ad = fabsf(delta);
  const float res_c2 = res_c - delta;
  const float res_cw2 = res_cw - delta * w;
  const float res_cm2 = exp_cw2 - csw2 - delta * (w * w);
  const bool bad = fabsf(res_c2) > thr + EPS8 * ad ||
                   fabsf(res_cw2) > thr_m1 + EPS8 * (ad * w) ||
                   fabsf(res_cm2) > thr_m2 + EPS8 * (ad * (w * w));
  return {hit, bad, delta, hit ? loc : -1};
}

FTSG_NAMESPACE_END  // ftsg

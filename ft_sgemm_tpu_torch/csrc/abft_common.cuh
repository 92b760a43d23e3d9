// Device functions shared by the fused-ABFT kernels (ft_sgemm_weighted.cu,
// ft_sgemm_running.cuh), written once. Each is the Hopper form of one JAX
// device function in ft_sgemm_tpu/ops/ft_sgemm.py:
//
//   weighted_localize       <- _weighted_localize      (:498-513)
//   weighted_column         <- _moment_detect_correct  (:287-339), per column
//   EPS8                    <- _correction_pads         (:342-357)
//
// The kernels reduce the accumulator's column moments over their own
// fragment maps (gemm_wgmma.cuh) and call weighted_column once per column.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace ftsg {

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
};

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

}  // namespace ftsg

// Device functions shared by the fused-ABFT kernels (ft_sgemm_weighted.cu,
// ft_sgemm_running.cuh), written once. Each is the Hopper form of one JAX
// device function in ft_sgemm_tpu/ops/ft_sgemm.py:
//
//   inject                  <- _inject                 (:242-284)
//   col_sum                 <- the whole-tile jnp.sum over rows: warp
//                              shuffles plus a shared-memory pass, the
//                              paper's design (code_gen.py:219-226, 352-424)
//   weighted_localize       <- _weighted_localize      (:498-513)
//   moment_detect_correct   <- _moment_detect_correct  (:287-339)
//   EPS8                    <- _correction_pads         (:342-357)
//
// In B2's FFMA kernel the accumulator lives in registers, TM x TN per
// thread (gemm_mainloop.cuh), so the whole-tile reductions of the Pallas
// kernels become per-thread partial sums, shuffles among the lanes that
// share a column, and one shared-memory pass across warps. The per-tile
// counters are computed with __syncthreads_count; each CTA writes only its
// own det / unc cell. The sub-tiled wgmma kernels' checks
// (ft_sgemm_running.cuh) share Scalars, EPS8 and weighted_column.

#pragma once

#include <cfloat>

#include "gemm_mainloop.cuh"

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

// Add the fault magnitude to one rotating accumulator element when step k is
// scheduled: ordinal k/every + 3i + 5j, row (131*ord + 7) % BM, column
// (col_stride*ord + 3) % BN. Only the thread that holds the element changes
// it, but every thread runs the same branch-free selects: a divergent
// branch around per-register conditional adds here made the whole K loop
// of the FT kernels ~3x slower on an H100 (PERF.md, findings).
template <class L>
__device__ __forceinline__ void inject(Mainloop<L>& ml, const Scalars& sc,
                                       int k, int ti, int tj) {
  if (!(sc.s[SLOT_ENABLED] > 0.f)) return;
  const int every = max((int)sc.s[SLOT_EVERY], 1);
  if (k % every != 0) return;
  const int ord = k / every + 3 * ti + 5 * tj;
  const int m0 = (ord * 131 + 7) % L::BM;
  const int n0 = (ord * (int)sc.s[SLOT_COL_STRIDE] + 3) % L::BN;
  // The element's place in this thread's tile: in range for its owner only.
  const int di = m0 - ml.ty * L::TM, dj = n0 - ml.tx * L::TN;
  const float mag = sc.s[SLOT_MAGNITUDE];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j)
      ml.acc[i][j] += (i == di && j == dj) ? mag : 0.f;
}

// out[c] = sum over the tile's rows of f(i, j), for every tile column c:
// shuffles across the lanes of a warp that share the column, then one
// shared-memory pass over the warps (scratch holds NWARPS * BN floats).
template <class L, class F>
__device__ __forceinline__ void col_sum(const Mainloop<L>& ml, F f,
                                        float* scratch, float* out) {
  float p[L::TN];
#pragma unroll
  for (int j = 0; j < L::TN; ++j) {
    p[j] = 0.f;
#pragma unroll
    for (int i = 0; i < L::TM; ++i) p[j] += f(i, j);
  }
#pragma unroll
  for (int off = L::NTX; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) p[j] += __shfl_xor_sync(0xffffffffu, p[j], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < L::NTX) {
#pragma unroll
    for (int j = 0; j < L::TN; ++j) scratch[warp * L::BN + ml.col(j)] = p[j];
  }
  __syncthreads();
  if (threadIdx.x < L::BN) {
    float s = 0.f;
    for (int w = 0; w < L::NWARPS; ++w) s += scratch[w * L::BN + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Fault row of a flagged column from the weighted-residual ratio:
// round(res_cw / res_c) - 1, rounding half to even like jnp.round. -1 for a
// column that did not flag.
__device__ __forceinline__ int weighted_localize(float res_c, float res_cw,
                                                 bool det) {
  return det ? __float2int_rn(res_cw / res_c) - 1 : -1;
}

template <class L>
struct MomentSmem {
  float scratch[L::NWARPS * L::BN];
  float cs[L::BN], csw[L::BN], csw2[L::BN];
  float delta[L::BN];
  int hit_row[L::BN];
};

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

// Three-moment detect / localize / correct / re-check of the weighted
// strategy. Thread t < BN passes column t's expected moments (exp_c, exp_cw,
// exp_cw2). Each flagged column is corrected at its localized row; the
// re-check counts columns whose plain, w or w^2 residual stays above its
// threshold after correction (n_unc, a LEVEL).
template <class L>
__device__ __forceinline__ void moment_detect_correct(
    Mainloop<L>& ml, MomentSmem<L>& sm, float exp_c, float exp_cw,
    float exp_cw2, float thr, float thr_m1, float thr_m2, int& n_hit,
    int& n_unc) {
  col_sum(ml, [&](int i, int j) { return ml.acc[i][j]; }, sm.scratch, sm.cs);
  col_sum(ml, [&](int i, int j) { return (float)(ml.row(i) + 1) * ml.acc[i][j]; },
          sm.scratch, sm.csw);
  col_sum(ml, [&](int i, int j) {
            const float w = (float)(ml.row(i) + 1);
            return (w * w) * ml.acc[i][j];
          }, sm.scratch, sm.csw2);
  const int t = threadIdx.x;
  bool hit = false, bad = false;
  if (t < L::BN) {
    const ColumnVerdict v =
        weighted_column(exp_c, exp_cw, exp_cw2, sm.cs[t], sm.csw[t],
                        sm.csw2[t], L::BM, thr, thr_m1, thr_m2);
    hit = v.hit;
    bad = v.bad;
    sm.delta[t] = v.delta;
    sm.hit_row[t] = v.row;
  }
  n_hit = __syncthreads_count(hit);
  n_unc = __syncthreads_count(bad);
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j)
      if (sm.hit_row[ml.col(j)] == ml.row(i)) ml.acc[i][j] += sm.delta[ml.col(j)];
  __syncthreads();
}

}  // namespace ftsg

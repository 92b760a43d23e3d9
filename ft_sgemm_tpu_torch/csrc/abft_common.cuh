// Device functions shared by the fused-ABFT kernels (ft_sgemm_weighted.cu,
// ft_sgemm_global.cu, ft_sgemm_aug.cu, ft_sgemm_running.cuh), written once.
// Each is the Hopper form of one JAX device function in
// ft_sgemm_tpu/ops/ft_sgemm.py:
//
//   inject                  <- _inject                 (:242-284)
//   row_sum / col_sum /     <- the whole-tile jnp.sum reductions: warp
//   tile_sum                   shuffles plus a shared-memory pass, the
//                              paper's design (code_gen.py:219-226, 352-424)
//   weighted_localize       <- _weighted_localize      (:498-513)
//   Encoder                 <- the per-K-step checksum encode of
//                              _ft_kernel_rowcol_mxu from staged moment
//                              rows; B3-B6 encode on the tensor cores
//                              (ft_sgemm_running.cuh)
//   moment_detect_correct   <- _moment_detect_correct  (:287-339)
//   rowcol_detect_correct   <- _rowcol_detect_correct  (:406-495)
//   EPS8                    <- _correction_pads         (:342-357)
//
// In the FFMA kernels the accumulator lives in registers, TM x TN per
// thread (gemm_mainloop.cuh),
// so the whole-tile reductions of the Pallas kernels become per-thread
// partial sums, shuffles among the lanes that share a row or a column, and
// one shared-memory pass across warps. The per-tile counters are computed
// with __syncthreads_count; each CTA writes only its own det / unc cell.

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

// out[r] = sum over the tile's columns of f(i, j), for every tile row r.
// The lanes holding one row are the NTX consecutive lanes of one warp.
template <class L, class F>
__device__ __forceinline__ void row_sum(const Mainloop<L>& ml, F f,
                                        float* out) {
  float p[L::TM];
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    p[i] = 0.f;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) p[i] += f(i, j);
  }
#pragma unroll
  for (int off = 1; off < L::NTX; off <<= 1)
#pragma unroll
    for (int i = 0; i < L::TM; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
  if (ml.tx == 0) {
#pragma unroll
    for (int i = 0; i < L::TM; ++i) out[ml.row(i)] = p[i];
  }
  __syncthreads();
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

// The sum of the whole tile's accumulator, returned to every thread (each
// adds the warps' partials in the same order, so all hold the same value).
// scratch holds NWARPS floats.
template <class L>
__device__ __forceinline__ float tile_sum(const Mainloop<L>& ml,
                                          float* scratch) {
  float p = 0.f;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) p += ml.acc[i][j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = p;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < L::NWARPS; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// Fault row of a flagged column from the weighted-residual ratio:
// round(res_cw / res_c) - 1, rounding half to even like jnp.round. -1 for a
// column that did not flag.
__device__ __forceinline__ int weighted_localize(float res_c, float res_cw,
                                                 bool det) {
  return det ? __float2int_rn(res_cw / res_c) - 1 : -1;
}

// Per-chunk checksum encode of the mxu kernels (B7) from the chunk's staged
// moment rows: NMOM A-side column moments s_a (weights 1, w, w^2 with w =
// row + 1) give the expected column checksums c[v][n] += sum_k B[n, k] *
// s_a[v][k]; with ROWS, the B-side sum s_b gives the expected row checksum
// r[m] += sum_k A[m, k] * s_b[k]. Thread t holds row t's r and column t's
// c[]. No reduction and no barrier.
template <class L, int NMOM, bool ROWS>
struct Encoder {
  float r = 0.f;
  float c[NMOM];

  __device__ __forceinline__ Encoder() {
#pragma unroll
    for (int v = 0; v < NMOM; ++v) c[v] = 0.f;
  }

  // r and c[] from the chunk in buffer `buf` and its sums sa[v][kk], sb[kk]
  // (sb is read only with ROWS).
  __device__ __forceinline__ void update(const Stage<L>& st, int buf,
                                         const float (*sa)[L::KS],
                                         const float* sb) {
    const int t = threadIdx.x;
    if (ROWS && t < L::BM) {
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk) r = fmaf(st.As[buf][kk][t], sb[kk], r);
    }
    if (t < L::BN) {
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk) {
        const float b = st.Bs[buf][kk][t];
#pragma unroll
        for (int v = 0; v < NMOM; ++v) c[v] = fmaf(b, sa[v][kk], c[v]);
      }
    }
  }
};

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

template <class L>
struct RowcolSmem {
  float scratch[L::NWARPS * L::BN];
  float rs[L::BM], res_r[L::BM], dr[L::BM], adr[L::BM];
  float cs[L::BN], csw[L::BN], res_c[L::BN], res_cw[L::BN];
  float dc[L::BN], adc[L::BN], dcw[L::BN], adcw[L::BN];
  int loc[L::BN];
  bool det_r[L::BM], det_c[L::BN];
};

// Row/column detect / correct / re-check of the rowcol strategy. Thread
// t < BM passes row t's expected sum r_exp, thread t < BN column t's c_exp
// (and cw_exp, the row-weighted column sum, in multifault mode MF).
// Corrections land where a flagged row meets a flagged column (from the
// column residual when exactly one row and several columns flag); in MF
// mode, >1 flagged rows AND columns localize each column's fault row by the
// weighted ratio instead. n_hit counts corrected elements; n_unc the rows
// and columns still above threshold after correction (a LEVEL).
template <class L, bool MF>
__device__ __forceinline__ void rowcol_detect_correct(
    Mainloop<L>& ml, RowcolSmem<L>& sm, float r_exp, float c_exp,
    float cw_exp, float thr, float thr_m1, int& n_hit, int& n_unc) {
  row_sum(ml, [&](int i, int j) { return ml.acc[i][j]; }, sm.rs);
  col_sum(ml, [&](int i, int j) { return ml.acc[i][j]; }, sm.scratch, sm.cs);
  if (MF)
    col_sum(ml, [&](int i, int j) { return (float)(ml.row(i) + 1) * ml.acc[i][j]; },
            sm.scratch, sm.csw);
  const int t = threadIdx.x;
  bool dr = false, dc = false;
  if (t < L::BM) {
    const float res = r_exp - sm.rs[t];
    dr = fabsf(res) > thr;
    sm.res_r[t] = res;
    sm.det_r[t] = dr;
  }
  if (t < L::BN) {
    const float res = c_exp - sm.cs[t];
    dc = fabsf(res) > thr;
    sm.res_c[t] = res;
    sm.det_c[t] = dc;
    if (MF) {
      const float res_w = cw_exp - sm.csw[t];
      sm.res_cw[t] = res_w;
      sm.loc[t] = weighted_localize(res, res_w, dc);
    }
  }
  const int nr = __syncthreads_count(dr);
  const int nc = __syncthreads_count(dc);
  const bool use_col = nr == 1 && nc > 1;
  const bool ambiguous = MF && nr > 1 && nc > 1;
  auto delta = [&](int r, int c) -> float {
    if (ambiguous) return (sm.det_c[c] && sm.loc[c] == r) ? sm.res_c[c] : 0.f;
    if (!(sm.det_r[r] && sm.det_c[c])) return 0.f;
    return use_col ? sm.res_c[c] : sm.res_r[r];
  };
  const int n_loc = __syncthreads_count(
      ambiguous && t < L::BN && sm.det_c[t] && sm.loc[t] >= 0 && sm.loc[t] < L::BM);
  n_hit = ambiguous ? n_loc : nr * nc;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) ml.acc[i][j] += delta(ml.row(i), ml.col(j));
  // Residual-after-correct re-check: residuals are linear in the
  // accumulator, so subtract delta's row / column sums from them.
  auto d = [&](int i, int j) { return delta(ml.row(i), ml.col(j)); };
  auto ad = [&](int i, int j) { return fabsf(delta(ml.row(i), ml.col(j))); };
  row_sum(ml, d, sm.dr);
  row_sum(ml, ad, sm.adr);
  col_sum(ml, d, sm.scratch, sm.dc);
  col_sum(ml, ad, sm.scratch, sm.adc);
  if (MF) {
    col_sum(ml, [&](int i, int j) { return d(i, j) * (float)(ml.row(i) + 1); },
            sm.scratch, sm.dcw);
    col_sum(ml, [&](int i, int j) { return ad(i, j) * (float)(ml.row(i) + 1); },
            sm.scratch, sm.adcw);
  }
  bool bad_r = false, bad_c = false, bad_w = false;
  if (t < L::BM) bad_r = fabsf(sm.res_r[t] - sm.dr[t]) > thr + EPS8 * sm.adr[t];
  if (t < L::BN) {
    bad_c = fabsf(sm.res_c[t] - sm.dc[t]) > thr + EPS8 * sm.adc[t];
    if (MF)
      bad_w = !bad_c &&
              fabsf(sm.res_cw[t] - sm.dcw[t]) > thr_m1 + EPS8 * sm.adcw[t];
  }
  n_unc = __syncthreads_count(bad_r) + __syncthreads_count(bad_c) +
          __syncthreads_count(bad_w);
}

}  // namespace ftsg

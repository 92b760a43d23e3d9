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
//   Epilogue                 <- ops/common.py::apply_epilogue (:461-500),
//                               which every kernel body applies after its
//                               detect / correct (B1 ops/sgemm.py:98-101,
//                               B2-B8 ops/ft_sgemm.py:632-1162)
//   Variant                  <- ops/common.py::grid_and_maps, grid_ij
//                               (:376-411)
//
// The kernels reduce the accumulator's column moments over their own
// fragment maps (gemm_wgmma.cuh) and call weighted_column once per column.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

// FTSG_ADAPTIVE=1 builds B3-B8 for threshold="adaptive": each check derives
// every sub-tile's threshold from that sub-tile's running moments
// (ft_sgemm_running.cuh: SubTileThresholds). The default build reads the
// thresholds from the scalar argument (static and "auto").
#ifndef FTSG_ADAPTIVE
#define FTSG_ADAPTIVE 0
#endif

// FTSG_BF16=1 compiles a source's bf16 entry points alone: the static bf16
// builds of B2-B8, or with FTSG_ADAPTIVE=1 the adaptive bf16 builds of
// B3-B8 (threshold="adaptive" in bf16, and in fp8 on B3-B5), libraries of
// their own (ops/_build.LIBRARIES) that build beside the others and leave
// every other build as it was: without the macro a source compiles its f32
// builds (and the static ones B3's and B4's int8 builds).
#ifndef FTSG_BF16
#define FTSG_BF16 0
#endif

// FTSG_ONE_PASS=1 builds the f32 kernels for the precision "default": one
// TF32 wgmma per k step, a_hi b_hi, where 3xTF32 issues three
// (gemm_wgmma.cuh: WgMainloop::mma3), for the product and the expected
// sums that ride it; the f32 entry points alone (no int8, bf16 or fp8),
// static or with FTSG_ADAPTIVE=1, libraries of their own (ops/_build
// LIBRARIES, "*_tf32"), so that the 3xTF32 builds keep their code: a
// run-time branch there moved ptxas's allocation and made B5 small 33 %
// slower on an H100 (PERF.md, section 6).
#ifndef FTSG_ONE_PASS
#define FTSG_ONE_PASS 0
#endif
#if FTSG_ONE_PASS && FTSG_BF16
#error "FTSG_ONE_PASS builds the f32 kernels"
#endif

// FTSG_KERNEL=n (2 .. 8) compiles kernel Bn's entry points alone (of those
// the other macros select), so that the heaviest bf16 builds, B2 and B5 of
// one source, B6 and B7 of another, build as libraries of their own, side
// by side; 0, the default, compiles them all.
#ifndef FTSG_KERNEL
#define FTSG_KERNEL 0
#endif
#define FTSG_HAS(n) (FTSG_KERNEL == 0 || FTSG_KERNEL == (n))

// The builds are loaded into one process and share their sources, so the
// adaptive and one-pass builds' C++ symbols live in inline namespaces of
// their own: no mangled name has two bodies (the C entry points are looked
// up per library).
#if FTSG_ADAPTIVE && FTSG_ONE_PASS
#define FTSG_NAMESPACE_BEGIN namespace ftsg { inline namespace adaptive_one_pass {
#define FTSG_NAMESPACE_END } }
#elif FTSG_ADAPTIVE
#define FTSG_NAMESPACE_BEGIN namespace ftsg { inline namespace adaptive {
#define FTSG_NAMESPACE_END } }
#elif FTSG_ONE_PASS
#define FTSG_NAMESPACE_BEGIN namespace ftsg { inline namespace one_pass {
#define FTSG_NAMESPACE_END } }
#else
#define FTSG_NAMESPACE_BEGIN namespace ftsg {
#define FTSG_NAMESPACE_END }
#endif

FTSG_NAMESPACE_BEGIN

constexpr bool kAdaptive = FTSG_ADAPTIVE != 0;
constexpr bool kOnePass = FTSG_ONE_PASS != 0;

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

// The variant axis a launch takes at run time (ops/common.LaunchAxes, the
// JAX package's configs.KernelVariant), passed by value to every kernel.
// `nm`: the grid order "nm", the CTA raster walking M tiles first
// (blockIdx.x, the dimension the hardware walks first, is the M tile;
// tests/test_torch_variants.py reads grid, tile_m and tile_n from here and
// walks them against the JAX grid); "mn" puts the N tile there. A CTA reads its tile
// through tile_m() / tile_n(), so its grid cells land by tile whatever the
// order (grid_ij, ft_sgemm_tpu/ops/common.py:402). The pipeline depth
// reaches the kernels as bk (the K window of one grid step), the dimension
// semantics not at all (a Mosaic scheduling hint, with no CUDA
// counterpart), and the f32 precision "default" as the FTSG_ONE_PASS build.
struct Variant {
  int nm;

  __host__ bool valid() const { return nm == 0 || nm == 1; }
  __host__ dim3 grid(int gm, int gn) const {
    return nm ? dim3(gm, gn) : dim3(gn, gm);
  }
  __device__ __forceinline__ int tile_m() const {
    return nm ? blockIdx.x : blockIdx.y;
  }
  __device__ __forceinline__ int tile_n() const {
    return nm ? blockIdx.y : blockIdx.x;
  }
};

// The fused epilogue, passed by value to every kernel and applied by its one
// store (gemm_wgmma.cuh: WgMainloop::store) to each output element after
// alpha * acc + beta * C, strictly after the kernel's checks, so the
// checksums verify the pre-epilogue accumulator. The order and arithmetic
// are ops/common.apply_epilogue's, op for op (no contraction: every product
// and sum is rounded on its own, as the torch ops round them): + bias[col],
// then relu (negatives to 0, NaN and -0 kept) or the tanh GELU with the
// accurate tanhf, then the quantize: int8 round half to even (rintf) and a
// clamp to [-128, 127] that keeps NaN, or the e4m3 grid of
// ops/common.to_e4m3 (round to nearest even, 464 to 448, NaN past 464 and
// for +-inf), the result in f32. `bias` is the wrapper's padded bias row
// (ops/common.pad_bias), null without one; act and quant are
// ops/common.EPILOGUE_ACT_CODES and EPILOGUE_QUANT_CODES. The identity (all
// zero, scale 1) stores what the kernels stored before the epilogue was
// ported: the store branches on it once, uniformly, after its own loop.
struct Epilogue {
  const float* bias;
  int act, quant;
  float scale;

  __host__ __device__ bool identity() const {
    return bias == nullptr && act == 0 && quant == 0;
  }
  __host__ bool valid() const {
    return act >= 0 && act <= 2 && quant >= 0 && quant <= 2 && scale > 0.f;
  }

  // 0.5 x (1 + tanh(0.7978845608028654 (x + 0.044715 x x x))), left to
  // right as written.
  static __device__ __forceinline__ float gelu(float x) {
    const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
    const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(x, x3)));
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
  }

  // v on float8_e4m3fn's grid, in f32: NaN where |v| > 464 (and for NaN),
  // else rounded to nearest even at the grid step of v's binade, 2^(e - 3)
  // with e = max(floor(log2 |v|), -6) (the subnormals' step below 2^-6).
  // Scaling by powers of two is exact, so the one rounding is rintf's.
  static __device__ __forceinline__ float e4m3(float v) {
    if (!(fabsf(v) <= 464.f)) return __int_as_float(0x7fc00000);
    const int e = max((int)((__float_as_uint(v) >> 23) & 0xff) - 127, -6);
    const float step = __uint_as_float((uint32_t)(e - 3 + 127) << 23);
    const float inv = __uint_as_float((uint32_t)(127 - (e - 3)) << 23);
    return __fmul_rn(rintf(__fmul_rn(v, inv)), step);
  }

  __device__ __forceinline__ float apply(float x, float b) const {
    if (bias) x = __fadd_rn(x, b);
    if (act == 1) {
      x = x < 0.f ? 0.f : x;
    } else if (act == 2) {
      x = gelu(x);
    }
    if (quant == 1) {
      const float r = rintf(__fmul_rn(x, scale));
      x = r < -128.f ? -128.f : (r > 127.f ? 127.f : r);
    } else if (quant == 2) {
      x = e4m3(__fmul_rn(x, scale));
    }
    return x;
  }
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

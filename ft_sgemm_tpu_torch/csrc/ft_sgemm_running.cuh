// Kernels B3-B8 on the 3xTF32 wgmma mainloop (gemm_wgmma.cuh): one kernel
// skeleton over sub-tiles, three checks, and the fault injection and the
// weighted check they share with B2.
//
// B5 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_weighted (:917) and
// B6 _ft_kernel_fused (:1077; pallas_call at ops/ft_sgemm.py:1468): the
// weighted check (column moments 1, w, w^2 with w = row + 1, the fault row
// of each flagged column by the weighted-residual ratio, the correction, the
// three-moment re-check) against expected moments accumulated inside the
// kernel. They differ only in where the expected moments' A side comes
// from: B5 sums A's landed stage over each tile's rows (the running
// encode), B6 loads the wrapper's (gm * 3, K) moment rows
// (ops/ft_sgemm._tile_moments) by TMA as one more box of each stage (the
// mxu encode). B3 replaces _ft_kernel_rowcol (:516): row and column
// checksums, the correction where a flagged row meets a flagged column
// (from the column residual when one row and several columns flag; by the
// weighted ratio when several of each flag, multifault mode), and the
// re-check as a LEVEL. B4 replaces _ft_kernel_global (:832): one checksum
// per tile, detect only, an EVENT when the residual moves by more than the
// threshold. Each check runs after every `check_every` bk steps and after
// the last. B7 (ft_sgemm_aug.cu) and B8 (ft_sgemm_global.cu), the mxu
// encodes of B3 and B4, run B3's and B4's checks with their checksum rows
// loaded by TMA from the wrapper's moment rows instead of summed in the
// kernel (gemm_wgmma.cuh: MomentRows, BandRows).
//
// The paper's (bm, bn) tile is the granularity of the check, not the CTA:
// one 128 x 128 CTA (two consumer warpgroups and the producer) covers
// (128 / bm) x (128 / bn) sub-tiles, each with its own injection ordinal,
// weights, check and cells of the (M / bm, N / bn) detections and
// uncorrectable grids, so the kernel computes what the JAX kernel does per
// tile. Sub-tiles of a CTA past the grid are computed from TMA's zero fill
// and neither checked into the grids nor stored.
//
// What bounds them on an H100: three TF32 tensor-core products per
// multiply-add at 495 TFLOP/s, for C (2 M N K) and for the expected sums:
// the column side E = B_tile . M^T (2 N K * MOM M / bm; MOM = 3 for B5 and
// B6, 19 % more work at the 16-row tile; 1 or 2 for B3 and B7) and the row
// side, A times B's column-band sums (2 M K * N / bn: B3, B4, B7, B8), as 8
// more columns of the product (6 % more). B5 and B3 add their A-side
// moment sums, and B3 and B4 the band sums of B, on the producer's
// splitter warps, beside the products; B6, B7 and B8 load those rows and
// only split them. A check stalls the CTA's pipeline (its k steps land
// first); B3, B4, B7 and B8 check ~20 times per run at the program's
// cadence, B5 and B6 once or twice. B5's, B6's and B8's checks then cost a
// few shuffles per accumulator element and one to three consumer barriers;
// B4's posts its warps' sums and returns. B3's and B7's rowcol check corrects at nearly every check at
// reference-like injection; in its earlier single-phase form the body (a
// correction pass of ~400 shuffles a warp, five consumer barriers) cost
// 0.4-1.4 ms a launch at 4096, more than its drains, and their splitter
// sums 0.4-1.0 ms more for B3 (PERF.md, section 5; NVIDIA H100 80GB HBM3,
// 700 W).
//
// What the design does about it: the products and the expected sums run on
// the tensor cores from the same split stages, each promoted into an f32
// sum once per 32-column stage (so both sides of a residual carry the same
// precision), and the expected sums never leave the SM: a row's sits in
// its own quad of lanes. A check comes between two 8-column k steps, after
// they have landed, wherever the bk step ends (also inside a stage). Sums
// over a sub-tile's columns reduce by warp shuffles (a 16-row sub-tile is
// one warp's band) and one shared-memory pass over the warps of a band;
// the counts per sub-tile are shared-memory atomics. B3 and B7 split their
// check in two (RowcolSplitCheck, RowcolChecker): the consumers post their
// sums and go on issuing wgmma, a producer warp decides, the corrections
// come before the next check; B4 likewise (GlobalSplitCheck,
// GlobalChecker), with nothing to correct. B3, B4, B5 and B7 add their
// faults into the accumulator at stage ends with no drain
// (FragInject::fold). B5's splitter warps sum its moment rows and B4's
// its band rows in lane groups that keep every splitter thread busy, with
// no scratch and no barrier between them (WgSmem::sum_rows, split_bands).
//
// The fused epilogue (bias, relu or gelu, int8 or e4m3 quantize-rescale;
// the JAX kernels' _apply_epilogue) is the kernel's last step: the store
// applies it (abft_common.cuh, Epilogue) to each value after alpha * acc +
// beta * C, once every check has run, so it changes neither the checks nor
// the grids; each thread reads back the elements it has just stored (from
// L2) and writes them again. With gelu that is ~14 FP32 operations an
// element and the CTA's bias floats, yet it measured +0.07-0.14 ms a launch
// at 4096 on an H100, more than a separate pass over C in HBM would take
// (PERF.md, section 6).
//
// Thresholds: the checks take each sub-tile's from SubTileThresholds. The
// default build reads slots 4-6 of the scalar argument (threshold "static",
// or "auto", whose per-call value the wrapper computes from the inputs); the
// build with FTSG_ADAPTIVE (threshold "adaptive") derives them at every
// check from the sub-tile's running sums and sums of squares of A and B,
// which the consumers add up as they issue each k step, with two more
// consumer barriers a check (B3 and B7: the consumers post each warp's
// sums, and the checker derives the thresholds).

#pragma once

#include <climits>

#include "abft_common.cuh"
#include "gemm_wgmma.cuh"

FTSG_NAMESPACE_BEGIN

// Fault injection for the wgmma mainloop, the schedule of
// ft_sgemm_tpu/ops/ft_sgemm.py::_inject (:242-284) counted down in
// 8-column k steps: the fault of bk step k = f * every (f = 0, 1, ..) comes
// before k step next = k * bk / 8 (while next < K / 8). Per sub-tile (ti,
// tj) (global indices: the CTA's first is (ti0, tj0)) at ordinal f + 3 ti +
// 5 tj, row (131 ord + 7) % SBM and column (col_stride ord + 3) % SBN of
// the sub-tile, so no k step divides. Every thread runs the same
// branch-free selects over its fragment: a divergent branch around
// per-register conditional adds made the whole K loop of the first FT
// kernels ~3x slower on an H100 (PERF.md).
//
// The sub-tiles' hit test is unsigned, so that the modulos by the
// power-of-two sub-tile are masks: with the signed test, B6 at the small
// tile under register pressure (its scalar argument read from device
// memory) was compiled by ptxas with a spill around the predicated signed
// modulo (o * col_stride + 3) % SBN that read an accumulator register in
// place of the product (SHF.R.S32.HI Rs, RZ, 0x1f, Rt; LEA.HI Rs, Rs,
// Racc), so the hit failed and two accumulator elements per thread never
// got their faults (ROADMAP, Queue C).
//
// B3, B4, B5 and B7 defer their faults (fold): each goes into `acc` after
// the stage sums before it are promoted, at a stage end or before a check's
// snapshot, so no fault drains the pipeline; the unsigned hit test is the
// same. The forms below are the other kernels'.
//
// In bf16 the fault restarts the stage sum `part` (the steps before it
// promoted into `acc`) and the next wgmma accumulates onto it: ptxas then
// issues the segmented bf16 stages' wgmmas in order, where with the fault
// added into `acc` B3 spilled 2-4 KB and ran 2x slower. (In f32 the same
// form made ptxas serialize B7 and B8, +11-19 %: PERF.md.)
//
// In int8 the fault is the rounded magnitude (round half to even, as
// jnp.round), added into the s32 accumulator, wrapping (_inject with
// exact=True, ops/ft_sgemm.py:277-280).
template <class T>
struct FragInject {
  // B2 checks once, after the loop. Its f32 stages and its bf16 ones at the
  // 64-row and 32-column tiles issue unrolled; at the 128-column CTA the
  // bf16 stages issue in segments, which halved B2 there (the unrolled
  // bf16 stage spilled 2.6-3.4 KB; PERF.md).
  static constexpr bool kSegmented = T::BF16 && T::BN == 128;
  int next, period, nk8, ord, col_stride;
  float mag;

  __device__ __forceinline__ FragInject(const Scalars& sc, int bk, int K,
                                        int ti0, int tj0)
      : next(sc.s[SLOT_ENABLED] > 0.f ? 0 : K / 8),
        period(bk / 8 * max((int)sc.s[SLOT_EVERY], 1)), nk8(K / 8),
        ord(3 * ti0 + 5 * tj0), col_stride((int)sc.s[SLOT_COL_STRIDE]),
        mag(sc.s[SLOT_MAGNITUDE]) {}
  // t < nk8: no fault in the zero columns of a ragged last stage.
  __device__ __forceinline__ bool at(int t) const {
    return t == next && t < nk8;
  }
  __device__ __forceinline__ bool within(int st) const {
    return next < min((st + 1) * T::KK, nk8);
  }
  __device__ __forceinline__ bool check_after(int) const { return false; }
  __device__ __forceinline__ int fault_step() const {
    return next < nk8 ? next : INT_MAX;
  }
  __device__ __forceinline__ int check_step() const { return INT_MAX; }
  __device__ __forceinline__ void apply(WgMainloop<T>& ml, int) {
    if constexpr (T::BF16) {
      const unsigned cs = col_stride;
#pragma unroll
      for (int i = 0; i < T::NACC_W; ++i) {
        const unsigned r = ml.row(i), c = ml.col(i);
        const unsigned o = ord + 3 * (r / T::SBM) + 5 * (c / T::SBN);
        const bool hit = i < T::NACC && r % T::SBM == (o * 131 + 7) % T::SBM &&
                         c % T::SBN == (o * cs + 3) % T::SBN;
        ml.part[i] = hit ? mag : 0.f;
      }
      if constexpr (T::R > 0) {
#pragma unroll
        for (int i = 0; i < T::NACC_E; ++i) ml.part_e[i] = 0.f;
      }
    } else if constexpr (T::S8) {
      const uint32_t im = (uint32_t)__float2int_rn(mag);
      const unsigned cs = col_stride;
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) {
        const unsigned r = ml.row(i), c = ml.col(i);
        const unsigned o = ord + 3 * (r / T::SBM) + 5 * (c / T::SBN);
        const bool hit = r % T::SBM == (o * 131 + 7) % T::SBM &&
                         c % T::SBN == (o * cs + 3) % T::SBN;
        ml.acc[i] += hit ? im : 0u;
      }
    } else if constexpr (T::NSUB == 1) {
      const int r = (ord * 131 + 7) % T::BM, c = (ord * col_stride + 3) % T::BN;
#pragma unroll
      for (int i = 0; i < T::NACC; ++i)
        ml.acc[i] += (ml.row(i) == r && ml.col(i) == c) ? mag : 0.f;
    } else {
      const unsigned cs = col_stride;
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) {
        const unsigned r = ml.row(i), c = ml.col(i);
        const unsigned o = ord + 3 * (r / T::SBM) + 5 * (c / T::SBN);
        const bool hit = r % T::SBM == (o * 131 + 7) % T::SBM &&
                         c % T::SBN == (o * cs + 3) % T::SBN;
        ml.acc[i] += hit ? mag : 0.f;
      }
    }
    next += period;
    ++ord;
  }
  template <class M>
  __device__ __forceinline__ void check(M&) {}
  template <class M, class F>
  __device__ __forceinline__ void kstep(const M&, const F&, const F&, int,
                                        int) {}

  // The deferred form (B3, B4, B5, B7: RunHook whose check folds the
  // faults, kFoldFaults): every fault
  // scheduled before k step `upto` + 1 goes into `acc` (the s32 bits in
  // int8), in every dtype, after the stage sums that precede it have been
  // promoted: at a stage end, or before a check's snapshot. No wgmma waits
  // for it, and the check at or after its k step sees it.
  __device__ __forceinline__ void fold(WgMainloop<T>& ml, int upto) {
    while (fault_step() <= upto) {
      const unsigned cs = col_stride;
      if constexpr (T::S8) {
        const uint32_t im = (uint32_t)__float2int_rn(mag);
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) {
          const unsigned r = ml.row(i), c = ml.col(i);
          const unsigned o = ord + 3 * (r / T::SBM) + 5 * (c / T::SBN);
          const bool hit = r % T::SBM == (o * 131 + 7) % T::SBM &&
                           c % T::SBN == (o * cs + 3) % T::SBN;
          ml.acc[i] += hit ? im : 0u;
        }
      } else {
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) {
          const unsigned r = ml.row(i), c = ml.col(i);
          const unsigned o = ord + 3 * (r / T::SBM) + 5 * (c / T::SBN);
          const bool hit = r % T::SBM == (o * 131 + 7) % T::SBM &&
                           c % T::SBN == (o * cs + 3) % T::SBN;
          ml.acc[i] += hit ? mag : 0.f;
        }
      }
      next += period;
      ++ord;
    }
  }
};

// ------------------------------------------------------ thresholds ----

// The adaptive thresholds' scratch: per consumer warp its threads' running
// moment sums (sum a, sum a^2 over its A rows; sum b, sum b^2 over its B
// rows), and per sub-tile the latest check's three thresholds.
template <int NWARPS, int NSUB>
struct BoundSmem {
  float part[NWARPS][4];
  float thr[NSUB][3];
};

// Bytes of a sub-tiled check's scratch: the check's own (`Smem`), then, in
// the adaptive build, the thresholds' (16-byte aligned). The static build's
// scratch is the check's alone, so its kernels keep their ring.
template <class Smem, int NSUB>
constexpr int check_bytes() {
  return kAdaptive ? ((int)sizeof(Smem) + 15) / 16 * 16 +
                         (int)sizeof(BoundSmem<8, NSUB>)
                   : (int)sizeof(Smem);
}

// The thresholds a check compares with, per sub-tile: get(sub, v) is the
// detection threshold (v = 0) and the w and w^2 re-checks' (v = 1, 2) of
// sub-tile `sub`. This form holds slots 4-6 of the scalar argument for every
// sub-tile (threshold "static" or "auto"): get() returns a register.
template <class T, bool ADAPTIVE, bool GLOBAL>
struct SubTileThresholds {
  static constexpr int BYTES = 0;
  float thr[3];

  __device__ __forceinline__ SubTileThresholds(const Scalars& sc,
                                               const NoiseModel&, void*)
      : thr{sc.s[SLOT_THRESHOLD], sc.s[SLOT_THR_M1], sc.s[SLOT_THR_M2]} {}
  __device__ __forceinline__ float get(int, int v) const { return thr[v]; }
  template <class M, class F>
  __device__ __forceinline__ void kstep(const M&, const F&, const F&, int,
                                        int) {}
  template <class M>
  __device__ __forceinline__ void update(const M&, int) {}
};

// threshold="adaptive" (_adaptive_threshold and _accumulate_moments,
// ops/ft_sgemm.py:360-403): each sub-tile's thresholds at each check come
// from the running sums and sums of squares of the A and B elements it has
// consumed through that check's k step, tk = (t + 1) * 8 columns, counting
// the zero rows of a padded tile (n_a = tk * SBM, n_b = tk * SBN), at
// accumulation length tk * max(SBM, SBN) with the full run's static log2
// (NoiseModel) and slot 7's margin: thr, thr * SBM / sqrt(3) and thr *
// SBM^2 / sqrt(5); the global check's whole-tile residual takes thr *
// sqrt(SBN).
//
// The sums ride the consumers' issue of each k step (kstep), so that at a
// check they cover exactly the columns through its k step, also inside a
// stage: the producer runs up to a ring's depth ahead. Each consumer thread
// adds its four A fragment values of the k step (two rows of one warp band,
// hi + lo as split, the value the product multiplies) and one float4 of B
// (row threadIdx.x / 2, the k step's 4-column chunk threadIdx.x % 2, hi + lo
// from B's split stage), so that the CTA's 256 threads cover A's and B's 128
// x 8 values of the k step once; a warp's threads hold 16 rows of A and 16
// rows of B, inside one sub-tile band. In bf16 (and in fp8, which the
// wrapper widens exactly to bf16) a k step is one 8-column half of a
// 16-deep wgmma step, and the values are the rounded operands as the
// product multiplies them, widened exactly to f32 (_accumulate_moments of
// a_blk.astype(f32), ops/ft_sgemm.py:580-581, 596): A's two fragment
// registers of the half (four bf16: ah[2 kk], ah[2 kk + 1], the registers
// mma_bf_half keeps) and four bf16 of B's landed stage (row threadIdx.x /
// 2, columns 8 kk + 4 (threadIdx.x % 2) .. + 3, through the 128-byte
// swizzle). At a check (update) a warp's butterfly and one shared-memory
// pass give each sub-tile its band sums; thread `sub` < NSUB evaluates the
// bound; two consumer barriers. The sums live in four registers a thread,
// the bands' in the check scratch.
template <class T, bool GLOBAL>
struct SubTileThresholds<T, true, GLOBAL> {
  using Smem = BoundSmem<T::NCONS / 32, T::NSUB>;
  static constexpr int BYTES = (int)sizeof(Smem);
  static_assert(T::NCONS == 2 * T::BN && T::SBN % 16 == 0,
                "two threads a B row, a warp's B rows in one band");
  Smem& sm;
  NoiseModel nm;
  float margin;
  float st[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's sums a, a^2, b, b^2

  __device__ __forceinline__ SubTileThresholds(const Scalars& sc,
                                               const NoiseModel& nm_, void* p)
      : sm(*reinterpret_cast<Smem*>(p)), nm(nm_), margin(sc.s[SLOT_MARGIN]) {}
  __device__ __forceinline__ float get(int sub, int v) const {
    return sm.thr[sub][v];
  }

  template <class M, class F>
  __device__ __forceinline__ void kstep(const M& ml, const F& ah, const F& al,
                                        int kk, int s) {
    if constexpr (T::BF16) {
      kstep_bf16(ml, ah, kk, s);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x =
            __uint_as_float(ah[4 * kk + j]) + __uint_as_float(al[4 * kk + j]);
        st[0] += x;
        st[1] = fmaf(x, x, st[1]);
      }
      const int n = threadIdx.x >> 1, chunk = 2 * kk + (threadIdx.x & 1);
      const int o = n * T::SK + ((chunk ^ (n & 7)) << 2);
      const float4 h = *reinterpret_cast<const float4*>(ml.sm.b(s) + o);
      const float4 l = *reinterpret_cast<const float4*>(ml.sm.blo(s) + o);
      const float xb[4] = {h.x + l.x, h.y + l.y, h.z + l.z, h.w + l.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[2] += xb[j];
        st[3] = fmaf(xb[j], xb[j], st[3]);
      }
    }
  }

  // kstep in bf16: 8-column half step kk of ring slot s.
  template <class M, class F>
  __device__ __forceinline__ void kstep_bf16(const M& ml, const F& ah, int kk,
                                             int s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x[2] = {bf16_lo(ah[2 * kk + j]), bf16_hi(ah[2 * kk + j])};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st[0] += x[i];
        st[1] = fmaf(x[i], x[i], st[1]);
      }
    }
    const int n = threadIdx.x >> 1, p = 4 * kk + 2 * (threadIdx.x & 1);
    const uint2 w = *reinterpret_cast<const uint2*>(ml.sm.bw(s) +
                                                    swz_word(n, p));
    const float xb[4] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                         bf16_hi(w.y)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st[2] += xb[j];
      st[3] = fmaf(xb[j], xb[j], st[3]);
    }
  }

  // Every sub-tile's thresholds at the check after k step t.
  template <class M>
  __device__ void update(const M& ml, int t) {
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int WA = T::SBM / 16, WB = T::SBN / 16;  // warps a band
    constexpr int TMAX = T::SBM > T::SBN ? T::SBM : T::SBN;
    constexpr float W1 = (float)(T::SBM / const_sqrt(3.0));
    constexpr float W2 = (float)((double)T::SBM * T::SBM / const_sqrt(5.0));
    constexpr float SQRT_BN = (float)const_sqrt((double)T::SBN);
    float v[4] = {st[0], st[1], st[2], st[3]};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(FULL, v[i], off);
    const int tid = threadIdx.x;
    if (ml.l == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm.part[tid / 32][i] = v[i];
    }
    consumer_sync<T::NCONS>();
    if (tid < T::NSUB) {
      const int bi = tid / T::NBN, bj = tid % T::NBN;
      float sa1 = 0.f, sa2 = 0.f, sb1 = 0.f, sb2 = 0.f;
#pragma unroll
      for (int w = 0; w < WA; ++w) {
        sa1 += sm.part[bi * WA + w][0];
        sa2 += sm.part[bi * WA + w][1];
      }
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        sb1 += sm.part[bj * WB + w][2];
        sb2 += sm.part[bj * WB + w][3];
      }
      const float tk = (float)((t + 1) * 8);
      float thr = variance_bound_threshold(sa1, sa2, sb1, sb2, tk * T::SBM,
                                           tk * T::SBN, tk * TMAX, nm, margin);
      if constexpr (GLOBAL) thr *= SQRT_BN;
      sm.thr[tid][0] = thr;
      sm.thr[tid][1] = thr * W1;
      sm.thr[tid][2] = thr * W2;
    }
    consumer_sync<T::NCONS>();
  }
};

// The byte offset of the thresholds' scratch after a check's own.
template <class Smem>
__device__ __forceinline__ void* bound_scratch(void* scratch) {
  return static_cast<unsigned char*>(scratch) + (sizeof(Smem) + 15) / 16 * 16;
}

// A residual's magnitude in the threshold's f32 domain (mag() of
// _rowcol_detect_correct, ops/ft_sgemm.py:425-429): |x| of an f32 residual;
// of an int8 check's s32 residual, |x| wrapping (|INT_MIN| = INT_MIN, as
// jnp.abs on int32) and converted to f32 (rounded to nearest).
__device__ __forceinline__ float mag(float x) { return fabsf(x); }
__device__ __forceinline__ float mag(uint32_t x) {
  return (float)(int)((int)x < 0 ? 0u - x : x);
}

// ------------------------------------------------ the weighted check ----

// The weighted check's scratch, beside the ring (the ring is in flight at
// a mid-loop check).
template <int R, int BN, int NWARPS, int NBM, int NSUB>
struct WeightedSmem {
  float e[R][BN];               // expected moments, moment row 3 b + v
  float part[3][NWARPS][BN];    // per warp: moments 1, w, w^2
  float delta[NBM][BN];         // per band and column: the correction
  int hit_row[NBM][BN];         // and its row in the band (-1: none)
  int cnt[2][NSUB];             // per sub-tile: hits, uncorrectable
};

// B5's and B6's check (_moment_detect_correct) of every sub-tile, on
// consumer threads only (named barrier 1): E transposed into shared memory;
// the column moments of each warp's 16 rows by shuffles over the 8 lanes
// that share a column (equal lane % 4); one thread per (band, column) adds
// its band's warps and decides (weighted_column); the correction in place.
// B2 (ft_sgemm_weighted.cu: PrecompCheck) stages the wrapper's moments in
// E's place and decides the same way. `TH` gives each sub-tile's thresholds
// (SubTileThresholds).
template <class T, class TH = SubTileThresholds<T, false, false>>
struct WeightedCheck {
  static constexpr bool kSegmented = false;  // one or two checks per run
  static constexpr bool kPosts = false;
  static constexpr bool kFoldFaults = false;
  // E's R rows, or B2's 3 per band (R = 0: no second product).
  static constexpr int ER = T::R > 0 ? T::R : 3 * T::NBM;
  using Smem = WeightedSmem<ER, T::BN, T::NCONS / 32, T::NBM, T::NSUB>;
  static constexpr int kBytes = check_bytes<Smem, T::NSUB>();
  Smem& cm;
  TH th;
  int n_det = 0, n_unc = 0;  // sub-tile threadIdx.x (< NSUB)

  __device__ __forceinline__ WeightedCheck(const Scalars& sc,
                                           const NoiseModel& nm, void* scratch)
      : cm(*reinterpret_cast<Smem*>(scratch)),
        th(sc, nm, bound_scratch<Smem>(scratch)) {}
  __device__ __forceinline__ int det() const { return n_det; }
  __device__ __forceinline__ int unc() const { return n_unc; }

  __device__ void check(WgMainloop<T>& ml) {
    consumer_sync<T::NCONS>();  // the last check's readers are done
#pragma unroll
    for (int i = 0; i < T::NACC_E; ++i)
      if (ml.col(i) < 3 * T::NBM) cm.e[ml.col(i)][ml.row(i)] = ml.acc_e[i];
    decide(ml);
  }

  // The check against the expected moments in cm.e (row 3 b + v: moment v
  // of row band b), once they are written.
  __device__ __forceinline__ void decide(WgMainloop<T>& ml) {
    constexpr int NQ = T::BN / 8, WPB = T::SBM / 16;
    const int t = threadIdx.x, warp = t / 32;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float p[3][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[0][c] = p[1][c] = p[2][c] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * q + 2 * h + c;
          const float w = (float)(ml.row(i) % T::SBM + 1), x = ml.acc[i];
          p[0][c] += x;
          p[1][c] += w * x;
          p[2][c] += (w * w) * x;
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            p[v][c] += __shfl_xor_sync(0xffffffffu, p[v][c], off);
      if (ml.l < 4) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int v = 0; v < 3; ++v) cm.part[v][warp][ml.col(4 * q + c)] = p[v][c];
      }
    }
    if (t < 2 * T::NSUB) (&cm.cnt[0][0])[t] = 0;
    consumer_sync<T::NCONS>();
    for (int j = t; j < T::NBM * T::BN; j += T::NCONS) {
      const int b = j / T::BN, c = j % T::BN;
      float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp)
#pragma unroll
        for (int v = 0; v < 3; ++v) s[v] += cm.part[v][b * WPB + wp][c];
      const int sub = b * T::NBN + c / T::SBN;
      const ColumnVerdict cv = weighted_column(
          cm.e[3 * b][c], cm.e[3 * b + 1][c], cm.e[3 * b + 2][c], s[0], s[1],
          s[2], T::SBM, th.get(sub, 0), th.get(sub, 1), th.get(sub, 2));
      cm.delta[b][c] = cv.delta;
      cm.hit_row[b][c] = cv.row;
      if (cv.hit) atomicAdd(&cm.cnt[0][sub], 1);
      if (cv.bad) atomicAdd(&cm.cnt[1][sub], 1);
    }
    consumer_sync<T::NCONS>();
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) {
      const int r = ml.row(i), c = ml.col(i), b = r / T::SBM;
      ml.acc[i] += cm.hit_row[b][c] == r % T::SBM ? cm.delta[b][c] : 0.f;
    }
    if (t < T::NSUB) {
      n_det += cm.cnt[0][t];
      n_unc = cm.cnt[1][t];  // LEVEL: the state after the latest check
    }
  }
};

// B5's check: WeightedCheck with its faults taken off the mainloop, into
// `acc` at stage ends and before the check (FragInject::fold), so that no
// fault drains the pipeline.
template <class T, class TH>
struct WeightedFoldCheck : WeightedCheck<T, TH> {
  static constexpr bool kFoldFaults = true;
  using WeightedCheck<T, TH>::WeightedCheck;
};

// B5 (ROWS = kSumRows) and B6 (kLoadRows): 3 moment rows per row band; A
// and B of type IN (InType).
template <int ROWS, int IN = kF32>
struct WeightedOf {
  template <int SBM, int SBN>
  struct At {
    static constexpr int NSUB = (128 / SBM) * (128 / SBN);
    using Smem = WeightedSmem<(3 * 128 / SBM + 7) / 8 * 8, 128, 8, 128 / SBM,
                              NSUB>;
    using type = WgTile<128, 128, SBM, SBN, 3, check_bytes<Smem, NSUB>(),
                        kNoBands, ROWS, IN>;
    using TH = SubTileThresholds<type, kAdaptive, false>;
    using Check = std::conditional_t<ROWS == kSumRows,
                                     WeightedFoldCheck<type, TH>,
                                     WeightedCheck<type, TH>>;
  };
};

// -------------------------------------------------- the rowcol check ----

// N rows of BN floats, or nothing.
template <int N, int BN>
struct RowsOf {
  float v[N][BN];
};
template <int BN>
struct RowsOf<0, BN> {};

// B3's and B7's check slot in shared memory (the 128 x 128 CTA, eight
// consumer warps): what the consumers post at a check, the checker's
// decisions, and the two mbarriers between them; sums and residuals of
// type V (f32, or the s32 bits of the int8 check). One slot serves every
// check: the consumers post check k + 1 only after they have applied check
// k's corrections, which the checker publishes only after it has read
// check k's posts.
template <int NBM, int NBN, bool MF, class V>
struct RowcolSlot {
  static constexpr int BM = 128, BN = 128, NW = 8, NSUB = NBM * NBN;
  static constexpr int MOM = MF ? 2 : 1;
  uint64_t posted;   // every consumer warp arrives once it has posted
  uint64_t decided;  // every checker thread arrives once it has decided
  // Posted by the consumers.
  V e[MOM * NBM][BN];   // expected column sums c_exp (, cw_exp): row MOM b + v
  V sums[MOM][NW][BN];  // per warp: its 16 rows' column sums 1 (, w)
  V res_r[NBN][BM];     // per column band and row: the row residual
  float mom[NW][4];     // adaptive: per warp, the sums of a, a^2, b, b^2
  // The checker's decisions.
  V res_c[NBM][BN];  // per row band and column: the column residual
  RowsOf<MF ? NBM : 0, BN> res_cw;
  float thr[NSUB][2];  // adaptive: the check's thresholds (row/column, w)
  // Per sub-tile: the sums of its flagged columns' and flagged rows'
  // residuals (vs), of their magnitudes and the rows' w-weighted ones (fs),
  // the counts of flagged rows, flagged columns, located columns (MF) and
  // uncorrectable residuals, the grids' cells, and the one flagged row.
  V vs[NSUB][2];
  float fs[NSUB][4];
  int cnt[4][NSUB];
  int det[NSUB], unc[NSUB];
  int rstar[NSUB];      // the highest flagged row in the band (-1: none)
  unsigned gmask[NBM];  // per row band: its 8-column groups to correct
  int flag[2];          // the checker's events (RowcolChecker::land)
  // The flagged columns (row band b, column c as b BN + c) and rows
  // (column band j, row r as j BM + r) of the check, and their counts;
  // whether a sub-tile is ambiguous (MF).
  short clist[NBM * BN];
  short rlist[NBN * BM];
  int ncl, nrl, any_amb;
  // Per row band and column: kUnflagged, -1 (MF: the weighted row falls
  // outside the band) or the fault row; per column band and row: flagged.
  signed char code[NBM][BN];
  unsigned char rflag[NBN][BM];
  // Per sub-tile: 0 no correction, 1 the row residuals, 2 the column
  // residuals (one flagged row, use_col), 3 by the weighted rows (MF,
  // ambiguous).
  unsigned char mode[NSUB];
};

// The rowcol check's second half (_rowcol_detect_correct), on producer
// warps: the splitter warps (T::SPLITTERS threads, named barrier 3)
// between their stages, or, at the tiles of at most four sub-tiles where
// the splitters have work each stage (B3, whose splitter warps sum A's and
// B's rows, and B7 in f32, whose split B), the first warp (32 threads)
// between its TMA loads (kOnLoader). For each check the consumers post:
// the column residuals against E and their flags, the multifault weighted
// localization, in the adaptive build the thresholds from the posted
// moment sums and the row flags (the static build's consumers flag their
// rows), each flag counted per sub-tile by shared-memory atomics and put
// in a list; then, per flag, use_col and ambiguous, the corrections as
// decisions per sub-tile (code and res_c per column, the row flags, the
// mode, and a mask of the 8-column groups they touch), and the re-check as
// a LEVEL from the residuals less the corrections' row and column sums,
// formed from the decisions (the same terms the consumers' accumulator
// pass summed before). Three to six barriers of the checker a check, none
// of the consumers'. It waits suspended (try_wait) where it has nothing to
// do: a spinning warp took issue slots from the consumers beside it (B7
// bf16 at the huge tile 0.97 ms with a checker that decides nothing,
// against 0.59 with no check at all; PERF.md).
template <class T, bool MF, class Slot>
struct RowcolChecker {
  static constexpr bool kOnLoader = T::SPLIT && T::NSUB <= 4;
  static constexpr int NCK = kOnLoader ? 32 : T::SPLITTERS;
  static constexpr int kUnflagged = -2;
  using V = typename T::Acc;
  Slot& cm;
  int k = 0, chk, every8, nk8, it = 0;  // the next check, its k step
  float thr0, thr1;                     // the static thresholds
  NoiseModel nm;
  float margin;

  __device__ __forceinline__ RowcolChecker(const Scalars& sc,
                                           const NoiseModel& nm_, int bk,
                                           int K, int check_every,
                                           void* scratch)
      : cm(*reinterpret_cast<Slot*>(scratch)),
        chk(min(check_every * (bk / 8), K / 8) - 1),
        every8(check_every * (bk / 8)), nk8(K / 8),
        thr0(sc.s[SLOT_THRESHOLD]), thr1(sc.s[SLOT_THR_M1]), nm(nm_),
        margin(sc.s[SLOT_MARGIN]) {}

  // Sub-tile sub's detection threshold (v = 0) and the w re-check's (1).
  __device__ __forceinline__ float thr(int sub, int v) const {
    if constexpr (kAdaptive)
      return cm.thr[sub][v];
    else
      return v == 0 ? thr0 : thr1;
  }
  static __device__ __forceinline__ void sync() {
    if constexpr (kOnLoader)
      __syncwarp();
    else
      checker_sync<NCK>();
  }

  // kOnLoader: the first warp's loop, thread e. try_load(st) issues stage
  // st's loads if its slot is free (the same answer in every lane), park(st)
  // suspends the warp a while on that slot; the warp issues every load it
  // can, decides a check once it is posted (issuing loads between its
  // phases too), and otherwise waits suspended, on the next slot while
  // loads remain and on the next post after, so that it takes no issue
  // slots from the consumers.
  template <class Load, class Park>
  __device__ __forceinline__ void load(int nst, int e, Load&& try_load,
                                       Park&& park) {
    int st = 0;
    const auto service = [&] {
      while (st < nst && try_load(st)) ++st;
    };
    while (st < nst || chk != INT_MAX) {
      service();
      if (chk != INT_MAX &&
          (st == nst || __shfl_sync(0xffffffffu,
                                    mbar_test(&cm.posted, k & 1) ? 1 : 0, 0)))
        decide(e, service);
      else if (st < nst)
        park(st);
    }
  }

  // Wait until `full`'s phase of `parity` completes (a stage has landed),
  // deciding every check posted meanwhile. The first splitter warp watches
  // both barriers, suspended on `full` a while at a time, and tells the
  // others which completed, so all take the same turns.
  __device__ __forceinline__ void land(uint64_t* full, int parity, int e) {
    for (;;) {
      if (e < 32) {
        int ev;
        do {
          const bool pst = chk != INT_MAX && mbar_test(&cm.posted, k & 1);
          const bool fl = !pst && mbar_try(full, parity, 1000);
          ev = __shfl_sync(0xffffffffu, pst ? 2 : fl ? 1 : 0, 0);
        } while (ev == 0);
        if (e == 0) cm.flag[it & 1] = ev;
      }
      checker_sync<NCK>();
      const int ev = *reinterpret_cast<volatile int*>(&cm.flag[it & 1]);
      ++it;
      if (ev == 1) break;
      decide(e, [] {});
    }
    mbar_wait(full, parity);  // each thread's own acquire of the stage
  }
  // After the last stage: every check left, each waited for suspended.
  __device__ __forceinline__ void drain(int e) {
    while (chk != INT_MAX) decide(e, [] {});
  }

  // Check k (after k step chk), once its posts are complete; service()
  // between its phases (the loader's loads). The flags go into lists, so
  // that after the residuals every phase costs per flag, not per row and
  // column.
  template <class Service>
  __device__ __forceinline__ void decide(int e, const Service& service) {
    constexpr int NBM = T::NBM, NBN = T::NBN, NSUB = T::NSUB;
    constexpr int BM = T::BM, BN = T::BN, SBM = T::SBM, SBN = T::SBN;
    constexpr int WPB = SBM / 16, MOM = MF ? 2 : 1;
    mbar_wait(&cm.posted, k & 1);
    if constexpr (kAdaptive) {  // SubTileThresholds::update's bound
      constexpr int WA = SBM / 16, WB = SBN / 16;
      constexpr int TMAX = SBM > SBN ? SBM : SBN;
      constexpr float W1 = (float)(SBM / const_sqrt(3.0));
      for (int sub = e; sub < NSUB; sub += NCK) {
        const int bi = sub / NBN, bj = sub % NBN;
        float sa1 = 0.f, sa2 = 0.f, sb1 = 0.f, sb2 = 0.f;
#pragma unroll
        for (int w = 0; w < WA; ++w) {
          sa1 += cm.mom[bi * WA + w][0];
          sa2 += cm.mom[bi * WA + w][1];
        }
#pragma unroll
        for (int w = 0; w < WB; ++w) {
          sb1 += cm.mom[bj * WB + w][2];
          sb2 += cm.mom[bj * WB + w][3];
        }
        const float tk = (float)((chk + 1) * 8);
        const float t = variance_bound_threshold(
            sa1, sa2, sb1, sb2, tk * SBM, tk * SBN, tk * TMAX, nm, margin);
        cm.thr[sub][0] = t;
        cm.thr[sub][1] = t * W1;
      }
      sync();
      service();
    }
    // Columns: residuals, flags, the weighted row (an unflagged column's
    // weighted residual is re-checked here: nothing corrects it); then, in
    // the adaptive build, the row flags.
    if (e < NBM) cm.gmask[e] = 0u;
    for (int jb = e; jb < NBM * BN; jb += NCK) {
      const int bb = jb / BN, c = jb % BN, sub = bb * NBN + c / SBN;
      V cs = 0;
      float csw = 0.f;
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp) {
        cs += cm.sums[0][bb * WPB + wp][c];
        if constexpr (MF) csw += cm.sums[MOM - 1][bb * WPB + wp][c];
      }
      const V res = cm.e[MOM * bb][c] - cs;
      const bool det = mag(res) > thr(sub, 0);
      int code = det ? 0 : kUnflagged;
      if constexpr (MF) {  // weighted_localize, in range or -1
        const float res_w = cm.e[MOM * bb + MOM - 1][c] - csw;
        cm.res_cw.v[bb][c] = res_w;
        if (det) {
          const int lr = __float2int_rn(res_w / res);
          code = lr < 1 || lr > SBM ? -1 : lr - 1;
          if (code >= 0) atomicAdd(&cm.cnt[2][sub], 1);
        } else if (fabsf(res_w) > thr(sub, 1)) {
          atomicAdd(&cm.cnt[3][sub], 1);
        }
      }
      cm.res_c[bb][c] = res;
      cm.code[bb][c] = (signed char)code;
      if (det) {
        atomicAdd(&cm.cnt[1][sub], 1);
        cm.clist[atomicAdd(&cm.ncl, 1)] = (short)jb;
      }
    }
    if constexpr (kAdaptive) {  // (the static build's consumers flag rows)
      for (int jr = e; jr < NBN * BM; jr += NCK) {
        const int j = jr / BM, r = jr % BM, sub = (r / SBM) * NBN + j;
        const bool det = mag(cm.res_r[j][r]) > thr(sub, 0);
        cm.rflag[j][r] = det;
        if (det) {
          atomicAdd(&cm.cnt[0][sub], 1);
          atomicMax(&cm.rstar[sub], r % SBM);
          cm.rlist[atomicAdd(&cm.nrl, 1)] = (short)jr;
        }
      }
    }
    sync();
    service();
    // Per sub-tile: the mode, the detections, and the sums the re-check
    // subtracts: the flagged rows' residuals (one row: its own; several,
    // in order) and, with one flagged row, the flagged columns' (in order).
    for (int sub = e; sub < NSUB; sub += NCK) {
      const int bb = sub / NBN, j = sub % NBN;
      const int nr = cm.cnt[0][sub], nc = cm.cnt[1][sub];
      const bool use_col = nr == 1 && nc > 1;
      const bool amb = MF && nr > 1 && nc > 1;
      const int m = amb ? 3 : nr > 0 && nc > 0 ? (use_col ? 2 : 1) : 0;
      V sc = 0, sr = 0;
      float sac = 0.f, sar = 0.f, swr = 0.f, swar = 0.f;
      if (m == 1) {
        const int lo = nr == 1 ? cm.rstar[sub] : 0;
        const int hi = nr == 1 ? lo + 1 : SBM;
        for (int x = lo; x < hi; ++x) {
          if (!cm.rflag[j][bb * SBM + x]) continue;
          const V rv = cm.res_r[j][bb * SBM + x];
          sr += rv;
          if constexpr (!T::S8) {
            const float w = (float)(x + 1);
            sar += fabsf(rv);
            swr += w * rv;
            swar += w * fabsf(rv);
          }
        }
      } else if (m == 2) {
        for (int x = 0; x < SBN; ++x) {
          if (cm.code[bb][j * SBN + x] == kUnflagged) continue;
          const V rc = cm.res_c[bb][j * SBN + x];
          sc += rc;
          if constexpr (!T::S8) sac += fabsf(rc);
        }
      }
      if (amb) cm.any_amb = 1;
      cm.mode[sub] = (unsigned char)m;
      cm.vs[sub][0] = sc;
      cm.vs[sub][1] = sr;
      cm.fs[sub][0] = sac;
      cm.fs[sub][1] = sar;
      cm.fs[sub][2] = swr;
      cm.fs[sub][3] = swar;
      cm.det[sub] += amb ? cm.cnt[2][sub] : nr * nc;
    }
    sync();
    service();
    const int ncl = cm.ncl, nrl = cm.nrl;
    // MF, an ambiguous sub-tile: the corrections' row sums by row, in the
    // column sums' place (read by now).
    float(*ars)[BM] = reinterpret_cast<float(*)[BM]>(&cm.sums[0][0][0]);
    bool any_amb = false;
    if constexpr (MF) {
      static_assert(2 * NBN * BM <= MOM * Slot::NW * BN, "room for them");
      any_amb = cm.any_amb != 0;
      if (any_amb) {
        for (int i = e; i < 2 * NBN * BM; i += NCK) (&ars[0][0])[i] = 0.f;
        sync();
        for (int i = e; i < ncl; i += NCK) {
          const int jb = cm.clist[i], bb = jb / BN, c = jb % BN, j = c / SBN;
          const int code = cm.code[bb][c];
          if (cm.mode[bb * NBN + j] == 3 && code >= 0) {
            const float rc = cm.res_c[bb][c];
            atomicAdd(&ars[j][bb * SBM + code], rc);
            atomicAdd(&ars[NBN + j][bb * SBM + code], fabsf(rc));
          }
        }
        sync();
        service();
      }
    }
    // The re-check: each flagged column's residual less its corrections'
    // sum (and w-weighted, MF), with the pads; the 8-column groups the
    // consumers correct ...
    for (int i = e; i < ncl; i += NCK) {
      const int jb = cm.clist[i], bb = jb / BN, c = jb % BN;
      const int sub = bb * NBN + c / SBN, m = cm.mode[sub];
      const int code = cm.code[bb][c];
      const V rc = cm.res_c[bb][c];
      V s0 = 0;
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (m == 3 ? code >= 0 : m != 0) {
        atomicOr(&cm.gmask[bb], 1u << (c / 8));
        if (m == 1) {  // every flagged row's residual
          s0 = cm.vs[sub][1];
          s1 = cm.fs[sub][1];
          s2 = cm.fs[sub][2];
          s3 = cm.fs[sub][3];
        } else {  // res_c, at row `code` (3) or the one flagged row (2)
          s0 = rc;
          if constexpr (!T::S8) {
            const float w = (float)((m == 3 ? code : cm.rstar[sub]) + 1);
            s1 = fabsf(rc);
            s2 = w * rc;
            s3 = w * fabsf(rc);
          }
        }
      }
      bool bad_c;
      if constexpr (T::S8)
        bad_c = mag(rc - s0) > thr(sub, 0);
      else
        bad_c = fabsf(rc - s0) > thr(sub, 0) + EPS8 * s1;
      if (bad_c) atomicAdd(&cm.cnt[3][sub], 1);
      if constexpr (MF) {
        if (!bad_c &&
            fabsf(cm.res_cw.v[bb][c] - s2) > thr(sub, 1) + EPS8 * s3)
          atomicAdd(&cm.cnt[3][sub], 1);
      }
    }
    // ... and each flagged row's, with the pads (the other rows of a
    // sub-tile that is not ambiguous take no correction, and their
    // residuals are under the threshold) ...
    const auto recheck_row = [&](int j, int r) {
      const int sub = (r / SBM) * NBN + j, m = cm.mode[sub];
      const V x = cm.res_r[j][r];
      V ds = 0;
      float ads = 0.f;
      if (m == 3) {
        if constexpr (MF) {
          ds = ars[j][r];
          ads = ars[NBN + j][r];
        }
      } else if (m == 2) {
        ds = cm.vs[sub][0];
        ads = cm.fs[sub][0];
      } else if (m == 1) {
        const int nc = cm.cnt[1][sub];
        ds = V(nc) * x;
        if constexpr (!T::S8) ads = (float)nc * fabsf(x);
      }
      bool bad;
      if constexpr (T::S8)
        bad = mag(x - ds) > thr(sub, 0);
      else
        bad = fabsf(x - ds) > thr(sub, 0) + EPS8 * ads;
      if (bad) atomicAdd(&cm.cnt[3][sub], 1);
    };
    for (int i = e; i < nrl; i += NCK) {
      const int jr = cm.rlist[i];
      recheck_row(jr / BM, jr % BM);
    }
    // ... and, MF, every unflagged row of an ambiguous sub-tile (a located
    // fault may land on it).
    if constexpr (MF) {
      if (any_amb) {
        for (int jr = e; jr < NBN * BM; jr += NCK) {
          const int j = jr / BM, r = jr % BM;
          if (cm.mode[(r / SBM) * NBN + j] == 3 && !cm.rflag[j][r])
            recheck_row(j, r);
        }
      }
    }
    sync();
    for (int sub = e; sub < NSUB; sub += NCK) {
      cm.unc[sub] = cm.cnt[3][sub];  // LEVEL: the state after this check
#pragma unroll
      for (int v = 0; v < 4; ++v) cm.cnt[v][sub] = 0;
      cm.rstar[sub] = -1;
    }
    if (e == 0) cm.ncl = cm.nrl = cm.any_amb = 0;
    chk = chk == nk8 - 1 ? INT_MAX : min(chk + every8, nk8 - 1);
    ++k;
    mbar_arrive(&cm.decided);
    service();
  }
};

// One round of a reduce-scatter over lanes OFF apart: the lane with bit OFF
// set keeps the upper N of its 2 N column groups, the other the lower N,
// each adding its partner's copy.
template <int OFF, int N, int NV, int NQ, class V>
__device__ __forceinline__ void scatter_round(V (&p)[NV][NQ][2], int l) {
  const bool up = l & OFF;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const V send = up ? p[v][i][c] : p[v][i + N][c];
        const V keep = up ? p[v][i + N][c] : p[v][i][c];
        p[v][i][c] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
}

// B3's and B7's check (_rowcol_detect_correct), split in two phases: the
// consumers' half. At a check (post, after the drain that lands the
// product through its k step and the faults up to it) each consumer
// thread posts its part of the residuals into the slot and goes back to
// issuing wgmma: E's fragment; its rows' residuals per column band (the
// row sums over its own columns and two quad shuffles, written by the
// lane that holds the band's expected sums, the product's extra columns);
// its warp's column sums (and w-weighted, multifault), reduce-scattered
// over the 8 lanes of a column (28 shuffles for 32 columns); in the
// adaptive build its warp's moment sums, in the static build its rows'
// flags (into the checker's counts and list of flagged rows). Its warp
// arrives on the slot's posted mbarrier (the first lane, after a warp
// sync); no consumer barrier. The checker (RowcolChecker) decides while
// the consumers issue the next stages; each thread applies the corrections
// that fall on its elements (apply: the 8-column groups the checker marked
// for its row band) just before the next check's post (after that check's
// drain, when `acc` holds the product and faults through its k step) or
// before the store, waiting on the decided mbarrier only there: the whole
// check interval hides the checker. (Applied at the second stage end after
// the check, the consumers waited for the checker: B7 bf16 at the huge
// tile took 1.33 ms, the single-phase check 1.35; PERF.md.)
//
// int8 (T::S8, the exact check of _rowcol_detect_correct(exact=True),
// ops/ft_sgemm.py:458, 469-472): every sum, residual and correction is s32
// and wraps; a residual flags when mag(res) exceeds the threshold; the
// correction is an integer add and the re-check compares the residuals
// after it with no pads. Multifault is not built for int8.
template <class T, bool MF, class Slot, class TH>
struct RowcolSplitCheck {
  static constexpr bool kSegmented = true;  // ~20 checks per run
  static constexpr bool kPosts = true;
  static constexpr bool kFoldFaults = true;
  static constexpr int kBytes = (int)sizeof(Slot);
  static constexpr int MOM = MF ? 2 : 1, NV = MF ? 2 : 1;
  static constexpr int kUnflagged = -2;
  static_assert(!T::S8 || !MF, "int8 localizes nothing by the weighted ratio");
  static_assert(T::BM == Slot::BM && T::BN == Slot::BN &&
                    T::NCONS == 32 * Slot::NW && T::NSUB == Slot::NSUB,
                "the slot's CTA");
  using V = typename T::Acc;
  using Checker = RowcolChecker<T, MF, Slot>;
  Slot& cm;
  TH th;
  int posted = 0;        // checks posted
  bool pending = false;  // the last one's corrections are not in acc yet

  __device__ __forceinline__ RowcolSplitCheck(const Scalars& sc,
                                              const NoiseModel& nm,
                                              void* scratch)
      : cm(*reinterpret_cast<Slot*>(scratch)), th(sc, nm, scratch) {}

  // Thread 0, before the CTA's first barrier: the mbarriers and counts.
  static __device__ __forceinline__ void init_shared(void* scratch) {
    Slot& m = *reinterpret_cast<Slot*>(scratch);
    mbar_init(&m.posted, T::NCONS / 32);
    mbar_init(&m.decided, Checker::NCK);
    for (int i = 0; i < T::NSUB; ++i) {
      m.det[i] = m.unc[i] = 0;
      m.rstar[i] = -1;
#pragma unroll
      for (int v = 0; v < 4; ++v) m.cnt[v][i] = 0;
    }
    m.ncl = m.nrl = m.any_amb = 0;
  }
  // Sub-tile threadIdx.x's cells (< NSUB), after finish().
  __device__ __forceinline__ int det() const { return cm.det[threadIdx.x]; }
  __device__ __forceinline__ int unc() const { return cm.unc[threadIdx.x]; }

  // The latest check's corrections on this thread's elements, once
  // decided: in the marked 8-column groups of its row band (a warp-uniform
  // branch each), res_c or res_r where a flagged row meets a flagged
  // column, res_c at a located row in an ambiguous sub-tile.
  __device__ __forceinline__ void apply(WgMainloop<T>& ml) {
    constexpr int NQ = T::BN / 8;
    mbar_wait(&cm.decided, (posted - 1) & 1);
    pending = false;
    const int r0 = ml.row(0), r1 = ml.row(2), b = r0 / T::SBM;
    const unsigned gm = cm.gmask[b];
    if (gm == 0u) return;
#pragma unroll
    for (int g8 = 0; g8 < NQ; ++g8) {
      if (!((gm >> g8) & 1u)) continue;
      const int j = 8 * g8 / T::SBN, m = cm.mode[b * T::NBN + j];
      const int c = ml.col(4 * g8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0, rr = r % T::SBM;
        const bool rf = cm.rflag[j][r] != 0;
        const V rv = cm.res_r[j][r];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int code = cm.code[b][c + cc];
          const V rc = cm.res_c[b][c + cc];
          const V d = m == 3 ? (code == rr ? rc : V(0))
                             : (rf && code != kUnflagged ? (m == 2 ? rc : rv)
                                                         : V(0));
          ml.acc[4 * g8 + 2 * h + cc] += d;
        }
      }
    }
  }

  // The check after k step `chk`: the previous check's corrections first
  // (waiting for them if still pending), then this thread's posts.
  __device__ __forceinline__ void post(WgMainloop<T>& ml, int chk) {
    constexpr int NQ = T::BN / 8, NBN = T::NBN, GPB = T::SBN / 8;
    constexpr unsigned FULL = 0xffffffffu;
    if (pending) apply(ml);
    __syncwarp();  // the warp's readers of the last decisions are done
    const int warp = threadIdx.x / 32, l = ml.l, q = l & 3;
#pragma unroll
    for (int i = 0; i < WgMainloop<T>::NEC; ++i)
      if (ml.col(i) < MOM * T::NBM) cm.e[ml.col(i)][ml.row(i)] = ml.ecol(i);
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        V rs = 0;
#pragma unroll
        for (int gg = 0; gg < GPB; ++gg)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            rs += ml.acc[4 * (j * GPB + gg) + 2 * h + c];
        rs += __shfl_xor_sync(FULL, rs, 1);
        rs += __shfl_xor_sync(FULL, rs, 2);
        if (q == j >> 1) {
          const int r = ml.row(2 * h);
          const V res = ml.xcol(2 * h + (j & 1)) - rs;
          cm.res_r[j][r] = res;
          if constexpr (!kAdaptive) {  // the static threshold's row flag
            const bool det = mag(res) > th.get(0, 0);
            cm.rflag[j][r] = det;
            if (det) {
              const int sub = (r / T::SBM) * NBN + j;
              atomicAdd(&cm.cnt[0][sub], 1);
              atomicMax(&cm.rstar[sub], r % T::SBM);
              cm.rlist[atomicAdd(&cm.nrl, 1)] = (short)(j * T::BM + r);
            }
          }
        }
      }
    }
    {
      const float w0 = (float)(ml.row(0) % T::SBM + 1);
      const float w1 = (float)(ml.row(2) % T::SBM + 1);
      V p[NV][NQ][2];
#pragma unroll
      for (int g8 = 0; g8 < NQ; ++g8)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const V x0 = ml.acc[4 * g8 + c], x1 = ml.acc[4 * g8 + 2 + c];
          p[0][g8][c] = x0 + x1;
          if constexpr (MF) p[NV - 1][g8][c] = w0 * x0 + w1 * x1;
        }
      static_assert(NQ == 16, "three rounds leave two groups a lane");
      scatter_round<16, 8>(p, l);
      scatter_round<8, 4>(p, l);
      scatter_round<4, 2>(p, l);
      const int g0 = 2 * ((l >> 2) & 7);  // the lane's two groups
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int v = 0; v < NV; ++v)
            cm.sums[v][warp][8 * (g0 + i) + 2 * q + c] = p[v][i][c];
    }
    if constexpr (kAdaptive) {  // the warp's moment sums
      float v[4] = {th.st[0], th.st[1], th.st[2], th.st[3]};
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(FULL, v[i], off);
      if (l == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) cm.mom[warp][i] = v[i];
      }
    }
    __syncwarp();  // the warp's posts, before its first lane's arrival
    if (l == 0) mbar_arrive(&cm.posted);
    ++posted;
    pending = true;
  }

  __device__ __forceinline__ void finish(WgMainloop<T>& ml) {
    if (pending) apply(ml);
  }
};

// B3 (BANDS = kSumBands, ROWS = kSumRowGroups) and B7 (kLoadBands,
// kLoadRows): 1 moment row (2 with multifault) per row band, and B's band
// rows as the product's extra columns; A and B of type IN.
template <bool MF, int BANDS, int ROWS, int IN = kF32>
struct RowcolOf {
  template <int SBM, int SBN>
  struct At {
    using Slot = RowcolSlot<128 / SBM, 128 / SBN, MF, AccOf<IN>>;
    using type = WgTile<128, 128, SBM, SBN, MF ? 2 : 1, (int)sizeof(Slot),
                        BANDS, ROWS, IN>;
    using Check = RowcolSplitCheck<type, MF, Slot,
                                   SubTileThresholds<type, kAdaptive, false>>;
  };
};

// -------------------------------------------------- the global check ----

template <int NWARPS, int NBN, class V = float>
struct GlobalSubSmem {
  V part[2][NWARPS][NBN];  // by check parity: each warp's band sums
};

// B8's check (_ft_kernel_global_mxu; B4 runs it split in two,
// GlobalSplitCheck) of every sub-tile: res = t_exp - the
// sub-tile's total, where t_exp is the total of its rows' expected sums
// (the product's extra columns), taken as one sum of the differences: each
// thread's share per column band, a warp's butterfly, one shared-memory
// pass over the band's warps (double-buffered by check parity, so one
// barrier per check). An EVENT when |res - prev| exceeds the threshold,
// prev = res, kept per sub-tile by thread threadIdx.x < NSUB; nothing is
// corrected, so unc = det. In int8 (exact=True, ops/ft_sgemm.py:842-907)
// t_exp, res and prev are s32 and wrap, and an event is mag(res - prev)
// over the threshold.
template <class T, class TH = SubTileThresholds<T, false, true>>
struct GlobalCheck {
  static constexpr bool kSegmented = true;  // ~20 checks per run
  static constexpr bool kPosts = false;
  static constexpr bool kFoldFaults = false;
  using V = typename T::Acc;
  using Smem = GlobalSubSmem<T::NCONS / 32, T::NBN, V>;
  static constexpr int kBytes = check_bytes<Smem, T::NSUB>();
  Smem& cm;
  TH th;
  V prev = 0;
  int n_det = 0, parity = 0;

  __device__ __forceinline__ GlobalCheck(const Scalars& sc,
                                         const NoiseModel& nm, void* scratch)
      : cm(*reinterpret_cast<Smem*>(scratch)),
        th(sc, nm, bound_scratch<Smem>(scratch)) {}
  __device__ __forceinline__ int det() const { return n_det; }
  __device__ __forceinline__ int unc() const { return n_det; }

  __device__ void check(WgMainloop<T>& ml) {
    constexpr int NBN = T::NBN, GPB = T::SBN / 8, WPB = T::SBM / 16;
    const int t = threadIdx.x, l = ml.l;
    V v[NBN];
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
      v[j] = (l & 3) == j >> 1 ? ml.xcol(j & 1) + ml.xcol(2 + (j & 1)) : V(0);
#pragma unroll
      for (int gg = 0; gg < GPB; ++gg)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j] -= ml.acc[4 * (j * GPB + gg) + e];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < NBN; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    if (l == 0) {
#pragma unroll
      for (int j = 0; j < NBN; ++j) cm.part[parity][t / 32][j] = v[j];
    }
    consumer_sync<T::NCONS>();
    if (t < T::NSUB) {
      const int bb = t / NBN, j = t % NBN;
      V res = 0;
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp) res += cm.part[parity][bb * WPB + wp][j];
      // Fault EVENTS: an uncorrected fault keeps the residual high, so
      // only a move of the residual counts.
      n_det += mag(res - prev) > th.get(t, 0) ? 1 : 0;
      prev = res;
    }
    parity ^= 1;
  }
};

// B4's check slot (the 128 x 128 CTA, NW = 8 consumer warps), by check
// parity: each warp's band sums (and, adaptive, its moment sums of a, a^2,
// b, b^2), the mbarrier its warps arrive on once posted, and the one the
// checker threads arrive on once they have read it.
template <int NW, int NBN, class V>
struct GlobalSlot {
  uint64_t posted[2];
  uint64_t read[2];
  V part[2][NW][NBN];
  float mom[2][NW][4];
};

// B4's check, the checker's half: on the first producer warp, between its
// TMA loads (load; on the splitter warps, whose band sums then shared their
// registers with the checker's state, B4 ran 8-15 % slower in f32 and bf16;
// PERF.md, findings). Lane e keeps sub-tiles e, e + 32, ..'s previous
// residuals and event counts: a residual is the sum of its band's warps'
// posts, an EVENT when mag(res - prev) exceeds the threshold (adaptive: the
// variance bound from the posted moment sums, as SubTileThresholds::update
// forms it, times sqrt(SBN)); after the last check it writes its
// sub-tiles' grid cells (B4 corrects nothing: unc = det). Every lane
// arrives on the slot's `read` once it has passed a check.
template <class T, class Slot>
struct GlobalChecker {
  static constexpr bool kOnLoader = true;
  static constexpr int NCK = 32;
  static constexpr int PER = (T::NSUB + NCK - 1) / NCK;  // sub-tiles a lane
  using V = typename T::Acc;
  Slot& cm;
  int k = 0, every8, nk8, chk;  // the next check, its k step
  float thr0;
  NoiseModel nm;
  float margin;
  V prev[PER];
  int n_det[PER];

  __device__ __forceinline__ GlobalChecker(const Scalars& sc,
                                           const NoiseModel& nm_, int bk,
                                           int K, int check_every,
                                           void* scratch)
      : cm(*reinterpret_cast<Slot*>(scratch)),
        every8(check_every * (bk / 8)), nk8(K / 8),
        chk(min(every8, nk8) - 1), thr0(sc.s[SLOT_THRESHOLD]), nm(nm_),
        margin(sc.s[SLOT_MARGIN]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      prev[i] = V(0);
      n_det[i] = 0;
    }
  }

  // Check k, once posted.
  __device__ __forceinline__ void decide(int e) {
    constexpr int NBN = T::NBN, WPB = T::SBM / 16;
    const int b = k & 1;
    mbar_wait(&cm.posted[b], (k >> 1) & 1);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int sub = e + NCK * i;
      if (sub >= T::NSUB) break;
      const int bb = sub / NBN, j = sub % NBN;
      V res = 0;
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp) res += cm.part[b][bb * WPB + wp][j];
      float thr = thr0;
      if constexpr (kAdaptive) {
        constexpr int WA = T::SBM / 16, WB = T::SBN / 16;
        constexpr int TMAX = T::SBM > T::SBN ? T::SBM : T::SBN;
        constexpr float SQRT_BN = (float)const_sqrt((double)T::SBN);
        float sa1 = 0.f, sa2 = 0.f, sb1 = 0.f, sb2 = 0.f;
#pragma unroll
        for (int w = 0; w < WA; ++w) {
          sa1 += cm.mom[b][bb * WA + w][0];
          sa2 += cm.mom[b][bb * WA + w][1];
        }
#pragma unroll
        for (int w = 0; w < WB; ++w) {
          sb1 += cm.mom[b][j * WB + w][2];
          sb2 += cm.mom[b][j * WB + w][3];
        }
        const float tk = (float)((chk + 1) * 8);
        thr = variance_bound_threshold(sa1, sa2, sb1, sb2, tk * T::SBM,
                                       tk * T::SBN, tk * TMAX, nm, margin);
        thr *= SQRT_BN;
      }
      n_det[i] += mag(res - prev[i]) > thr ? 1 : 0;
      prev[i] = res;
    }
    mbar_arrive(&cm.read[b]);
    chk = chk == nk8 - 1 ? INT_MAX : min(chk + every8, nk8 - 1);
    ++k;
  }
  // The first warp's loop, lane e (RowcolChecker::load): every load it can
  // issue, each check once posted, else suspended on the next slot while
  // loads remain.
  template <class Load, class Park>
  __device__ __forceinline__ void load(int nst, int e, Load&& try_load,
                                       Park&& park) {
    int st = 0;
    while (st < nst || chk != INT_MAX) {
      while (st < nst && try_load(st)) ++st;
      if (chk != INT_MAX &&
          (st == nst ||
           __shfl_sync(0xffffffffu, mbar_test(&cm.posted[k & 1],
                                              (k >> 1) & 1) ? 1 : 0, 0)))
        decide(e);
      else if (st < nst)
        park(st);
    }
  }
  // The grid cells of this lane's sub-tiles, after the last check.
  __device__ __forceinline__ void grids(int* det, int* unc, int M, int N,
                                        int ti0, int tj0) const {
    const int e = (int)threadIdx.x - T::NCONS;
    if (e >= NCK) return;
    const int gn = N / T::SBN;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int sub = e + NCK * i;
      const int ti = ti0 + sub / T::NBN, tj = tj0 + sub % T::NBN;
      if (sub < T::NSUB && ti < M / T::SBM && tj < gn) {
        det[ti * gn + tj] = n_det[i];
        unc[ti * gn + tj] = n_det[i];
      }
    }
  }
};

// B4's check (_ft_kernel_global), the consumers' half: after the drain
// that lands the product and the faults through its k step, each thread's
// (expected - accumulated) share per column band and a warp's butterfly,
// as GlobalCheck forms them (in the adaptive build the warp's moment sums
// too), posted by the warp's first lane into the slot of the check's
// parity, which then arrives on its `posted` mbarrier; the consumers go
// back to issuing wgmma at once. No consumer barrier: the checker
// (GlobalChecker, on the first producer warp) decides while the next
// stages run. A post waits only for
// the checker to have read the slot two checks back.
template <class T, class Slot, class TH>
struct GlobalSplitCheck {
  static constexpr bool kSegmented = true;  // ~20 checks per run
  static constexpr bool kPosts = true;
  static constexpr bool kFoldFaults = true;
  static constexpr bool kCheckerGrids = true;
  static constexpr int kBytes = (int)sizeof(Slot);
  using V = typename T::Acc;
  using Checker = GlobalChecker<T, Slot>;
  Slot& cm;
  TH th;
  int k = 0;  // checks posted

  __device__ __forceinline__ GlobalSplitCheck(const Scalars& sc,
                                              const NoiseModel& nm,
                                              void* scratch)
      : cm(*reinterpret_cast<Slot*>(scratch)), th(sc, nm, scratch) {}

  // Thread 0, before the CTA's first barrier: the mbarriers.
  static __device__ __forceinline__ void init_shared(void* scratch) {
    Slot& m = *reinterpret_cast<Slot*>(scratch);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&m.posted[i], T::NCONS / 32);
      mbar_init(&m.read[i], Checker::NCK);
    }
  }

  __device__ __forceinline__ void post(WgMainloop<T>& ml, int) {
    constexpr int NBN = T::NBN, GPB = T::SBN / 8;
    constexpr unsigned FULL = 0xffffffffu;
    const int l = ml.l, warp = threadIdx.x / 32, b = k & 1;
    V v[NBN];
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
      v[j] = (l & 3) == j >> 1 ? ml.xcol(j & 1) + ml.xcol(2 + (j & 1)) : V(0);
#pragma unroll
      for (int gg = 0; gg < GPB; ++gg)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j] -= ml.acc[4 * (j * GPB + gg) + e];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < NBN; ++j) v[j] += __shfl_xor_sync(FULL, v[j], off);
    float m4[4];
    if constexpr (kAdaptive) {
#pragma unroll
      for (int i = 0; i < 4; ++i) m4[i] = th.st[i];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) m4[i] += __shfl_xor_sync(FULL, m4[i], off);
    }
    if (l == 0) {
      if (k >= 2) mbar_wait(&cm.read[b], ((k - 2) >> 1) & 1);
#pragma unroll
      for (int j = 0; j < NBN; ++j) cm.part[b][warp][j] = v[j];
      if constexpr (kAdaptive) {
#pragma unroll
        for (int i = 0; i < 4; ++i) cm.mom[b][warp][i] = m4[i];
      }
      mbar_arrive(&cm.posted[b]);
    }
    ++k;
  }
  __device__ __forceinline__ void finish(WgMainloop<T>&) {}
};

// B4 (BANDS = kSumBands: GlobalSplitCheck) and B8 (kLoadBands:
// GlobalCheck): no moment rows; B's band rows as the product's extra
// columns; A and B of type IN.
template <int BANDS, int IN = kF32>
struct GlobalOf {
  template <int SBM, int SBN>
  struct At {
    static constexpr bool kSplit = BANDS == kSumBands;
    using Slot = GlobalSlot<8, 128 / SBN, AccOf<IN>>;
    using Smem = GlobalSubSmem<8, 128 / SBN, AccOf<IN>>;
    using type = WgTile<128, 128, SBM, SBN, 0,
                        kSplit ? (int)sizeof(Slot)
                               : check_bytes<Smem, (128 / SBM) * (128 / SBN)>(),
                        BANDS, kNoRows, IN>;
    using TH = SubTileThresholds<type, kAdaptive, true>;
    using Check = std::conditional_t<kSplit, GlobalSplitCheck<type, Slot, TH>,
                                     GlobalCheck<type, TH>>;
  };
};

// ------------------------------------------------------------ kernel ----

// Fault injection and the checks of a sub-tiled kernel: a check (the
// policy `Check`) after the last k step of every check_every-th bk step and
// of the last. The check's cadence decides how the mainloop issues a stage
// with a check or fault in it (kSegmented, WgMainloop::mma_stage). A check
// that folds the faults (kFoldFaults: B3, B4, B5, B7) takes them off the
// mainloop: they go into `acc` at stage ends and before checks
// (FragInject::fold), so only the checks cut a stage (kDeferred, what the
// mainloop sees). A check that posts (kPosts: B3's and B7's
// RowcolSplitCheck, B4's GlobalSplitCheck) hands its sums to the
// producer's checker and returns (B3's and B7's corrections come before
// the next check).
template <class T, class Check>
struct RunHook {
  static constexpr bool kSegmented = Check::kSegmented;
  static constexpr bool kDeferred = Check::kFoldFaults;
  static_assert(Check::kBytes <= T::CHECK_BYTES, "the check fits its scratch");
  FragInject<T> inj;
  Check ck;
  int chk, every8, nk8;

  __device__ __forceinline__ RunHook(const Scalars& sc, const NoiseModel& nm,
                                     int bk, int K, int check_every, int ti0,
                                     int tj0, void* scratch)
      : inj(sc, bk, K, ti0, tj0), ck(sc, nm, scratch),
        chk(min(check_every * (bk / 8), K / 8) - 1),
        every8(check_every * (bk / 8)), nk8(K / 8) {}

  __device__ __forceinline__ bool at(int t) const {
    return !kDeferred && inj.at(t);
  }
  __device__ __forceinline__ bool within(int st) const {
    return (!kDeferred && inj.within(st)) || chk < (st + 1) * T::KK;
  }
  __device__ __forceinline__ bool check_after(int t) const { return t == chk; }
  __device__ __forceinline__ int fault_step() const {
    return kDeferred ? INT_MAX : inj.fault_step();
  }
  __device__ __forceinline__ int check_step() const { return chk; }
  __device__ __forceinline__ void apply(WgMainloop<T>& ml, int t) {
    inj.apply(ml, t);
  }
  template <class F>
  __device__ __forceinline__ void kstep(const WgMainloop<T>& ml, const F& ah,
                                        const F& al, int kk, int s) {
    ck.th.kstep(ml, ah, al, kk, s);
  }
  __device__ __forceinline__ void check(WgMainloop<T>& ml) {
    if constexpr (Check::kPosts) {
      inj.fold(ml, chk);
      ck.post(ml, chk);
    } else {
      if constexpr (kDeferred) inj.fold(ml, chk);
      ck.th.update(ml, chk);
      ck.check(ml);
    }
    chk = chk == nk8 - 1 ? INT_MAX : min(chk + every8, nk8 - 1);
  }
  // kDeferred: stage st's sums are in `acc` (WgMainloop::step).
  __device__ __forceinline__ void stage_end(WgMainloop<T>& ml, int st) {
    inj.fold(ml, (st + 1) * T::KK - 1);
  }
  // After the K loop: the last check's corrections.
  __device__ __forceinline__ void finish(WgMainloop<T>& ml) {
    if constexpr (Check::kPosts) ck.finish(ml);
  }
};

// Whether the check's producer half writes the grids (B4's
// GlobalChecker); else the consumers write them after the K loop.
template <class Check, class = void>
struct CheckerGrids : std::false_type {};
template <class Check>
struct CheckerGrids<Check, std::void_t<decltype(Check::kCheckerGrids)>>
    : std::bool_constant<Check::kCheckerGrids> {};

// B5's producer sums its moment rows (WgSmem::sum_rows) and is faster with
// more registers than the others': at 40, B5 ran 23 % slower in f32 at the
// small tile and 17-27 % in bf16; so is B4's in f32 and int8 (split_bands:
// up to 7 % at 56), not in bf16 (5-8 % slower; PERF.md, findings). (The
// consumers get only what the producer frees of the launch's 168 a thread:
// at 56 they keep 224, at 48 also 224.)
template <class T>
struct RunRegs {
  static constexpr bool kB4 = T::BANDS == kSumBands && T::ROWS == kNoRows;
  static constexpr int PRODUCER =
      T::ROWS == kSumRows || (kB4 && !T::BF16) ? 56 : 40;
  static constexpr int CONSUMER = T::consumer_regs(PRODUCER);
};

// B3-B8 on M x N (padded to the sub-tile) with a check every `check_every`
// bk steps and after the last; `tm` the moment rows' tensor map (B6, B7),
// `tbb` the band rows' (B7, B8).
template <class T, class Check>
__global__ void __launch_bounds__(T::NT, 1) ft_running_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tm,
    const __grid_constant__ CUtensorMap tbb, const float* __restrict__ C,
    float* __restrict__ out, int* __restrict__ det, int* __restrict__ unc,
    int M, int N, int K, int bk, int check_every, float alpha, float beta,
    Scalars sc, NoiseModel nm, Epilogue epi, Variant v) {
  const WgSmem<T> sm;
  const int m0 = v.tile_m() * T::BM, n0 = v.tile_n() * T::BN;
  const int ti0 = v.tile_m() * T::NBM, tj0 = v.tile_n() * T::NBN;
  const int nst = (K + T::SK - 1) / T::SK;
  constexpr bool kCheckerGrids = CheckerGrids<Check>::value;
  if constexpr (Check::kPosts) {
    if (threadIdx.x == 0) Check::init_shared(sm.check());
  }
  sm.init();
  if (threadIdx.x >= T::NCONS) {  // the producer warpgroup
    setmaxnreg_dec<RunRegs<T>::PRODUCER>();
    if constexpr (Check::kPosts) {  // its splitter warps check too
      typename Check::Checker ck(sc, nm, bk, K, check_every, sm.check());
      sm.produce_checked(&ta, &tb, m0, n0, nst, &tm, ti0, &tbb, tj0, ck);
      if constexpr (kCheckerGrids) ck.grids(det, unc, M, N, ti0, tj0);
    } else {
      sm.produce(&ta, &tb, m0, n0, nst, &tm, ti0, &tbb, tj0);
    }
    return;
  }
  setmaxnreg_inc<RunRegs<T>::CONSUMER>();
  WgMainloop<T> ml(sm);
  RunHook<T, Check> hook(sc, nm, bk, K, check_every, ti0, tj0, sm.check());
  ml.run(nst, hook);
  hook.finish(ml);
  const auto grids = [&] {
    if constexpr (!kCheckerGrids) {
      const int t = threadIdx.x, gn = N / T::SBN;
      const int ti = ti0 + t / T::NBN, tj = tj0 + t % T::NBN;
      if (t < T::NSUB && ti < M / T::SBM && tj < gn) {
        det[ti * gn + tj] = hook.ck.det();
        unc[ti * gn + tj] = hook.ck.unc();
      }
    }
  };
  // The grids go out before the store in bf16 and after it otherwise: the
  // two orders keep the allocations these kernels had before the epilogue's
  // call was added (bf16 and f32 respectively; PERF.md, section 6).
  if constexpr (T::BF16 && !kCheckerGrids) grids();
  ml.template store<true>(out, C, N, m0, n0, alpha, beta, epi, M);
  if constexpr (!T::BF16 && !kCheckerGrids) grids();
}

// One launch of a sub-tiled kernel for sub-tile (bm, bn): `Of<bm, bn>`
// names its tile (and where its moment and band rows come from) and its
// check (WeightedOf<ROWS>::At, RowcolOf<MF, BANDS, ROWS>::At,
// GlobalOf<BANDS>::At); `MA` the wrapper's (M / bm, n_rows, K) moment rows
// (kLoadRows: B6, B7; the kernel loads the first MOM of each band's rows),
// `MB` its (N / bn, 1, K) band rows (kLoadBands: B7, B8), both f32, or for
// a bf16 tile bf16 in three terms (ops/ft_sgemm._tile_moments: n_rows = 3 n
// rows, term t's n at rows n t ..; B's (N / bn, 3, K)); A and B f32 or,
// for a bf16 or int8 tile, bf16 or int8 (an int8 operand's rows 16-byte
// aligned, tensor_map); `scalars` the
// host array of the scalar argument, `nm` the noise model's constants (read
// by the adaptive build), `epi` the fused epilogue (abft_common.cuh,
// Epilogue), applied in the store after the last check, `v` the grid order
// (abft_common.cuh, Variant: the CTA raster; `bk` is the K window of one
// grid step). Returns 0 or the
// CUDA error, also when a tensor map cannot be encoded or no sub-tile
// matches.
template <template <int, int> class Of>
int launch_running(const void* A, const void* B, const float* C,
                   const void* MA, const void* MB, int n_rows, float* out,
                   int* det, int* unc, int M, int N, int K, int bm, int bn,
                   int bk, int check_every, float alpha, float beta,
                   const float* scalars, const NoiseModel& nm,
                   const Epilogue& epi, const Variant& v,
                   cudaStream_t stream) {
  Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
  if (K % 8 || bk % 8 || check_every < 1 || !epi.valid() || !v.valid())
    return (int)cudaErrorInvalidValue;
#define FTSG_LAUNCH_SUB(SBM_, SBN_)                                            \
  if (bm == SBM_ && bn == SBN_) {                                              \
    using T = typename Of<SBM_, SBN_>::type;                                   \
    const auto kernel =                                                        \
        ft_running_wgmma_kernel<T, typename Of<SBM_, SBN_>::Check>;            \
    CUtensorMap ta, tb, tm = {}, tbb = {};                                     \
    constexpr int NT_ = T::BF16 ? 3 : 1; /* terms of a moment row */           \
    if (!tensor_map(&ta, A, M, K, T::BM, T::SK, T::ESIZE) ||                   \
        !tensor_map(&tb, B, N, K, T::BN, T::SK, T::ESIZE) ||                   \
        (T::ROWS == kLoadRows &&                                               \
         (n_rows % NT_ || n_rows / NT_ < T::MOM ||                             \
          !tensor_map_rows(&tm, MA, M / SBM_, NT_, n_rows / NT_, K, T::NBM,    \
                           T::MOM, T::SK, T::ESIZE))) ||                       \
        (T::BANDS == kLoadBands &&                                             \
         !(T::BF16 ? tensor_map_rows(&tbb, MB, N / SBN_, 1, 3, K, T::NBN, 1,   \
                                     T::SK, T::ESIZE)                          \
                   : tensor_map(&tbb, MB, N / SBN_, K, T::NBN, T::SK))))       \
      return (int)cudaErrorInvalidValue;                                       \
    if (const cudaError_t e = cudaFuncSetAttribute(                            \
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM))     \
      return (int)e;                                                           \
    kernel<<<v.grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN), T::NT,  \
             T::SMEM, stream>>>(ta, tb, tm, tbb, C, out, det, unc, M, N, K,   \
                                bk, check_every, alpha, beta, sc, nm, epi, v); \
    return (int)cudaGetLastError();                                            \
  }
  FTSG_FOR_EACH_SUBTILE(FTSG_LAUNCH_SUB)
#undef FTSG_LAUNCH_SUB
  return (int)cudaErrorInvalidValue;
}

FTSG_NAMESPACE_END  // ftsg

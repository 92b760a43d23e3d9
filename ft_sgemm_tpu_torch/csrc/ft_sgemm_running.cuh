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
// first) and costs a few shuffles per accumulator element and one to five
// consumer barriers; B3, B4, B7 and B8 check ~20 times per run at the
// program's cadence, B5 and B6 once or twice.
//
// What the design does about it: the products and the expected sums run on
// the tensor cores from the same split stages, each promoted into an f32
// sum once per 32-column stage (so both sides of a residual carry the same
// precision), and the expected sums never leave the SM: a row's sits in
// its own quad of lanes. A check comes between two 8-column k steps, after
// they have landed, wherever the bk step ends (also inside a stage). Sums
// over a sub-tile's columns reduce by warp shuffles (a 16-row sub-tile is
// one warp's band) and one shared-memory pass over the warps of a band;
// the counts per sub-tile are shared-memory atomics; B3 skips its
// correction pass when nothing in the CTA flagged.
//
// Thresholds: the checks take each sub-tile's from SubTileThresholds. The
// default build reads slots 4-6 of the scalar argument (threshold "static",
// or "auto", whose per-call value the wrapper computes from the inputs); the
// build with FTSG_ADAPTIVE (threshold "adaptive") derives them at every
// check from the sub-tile's running sums and sums of squares of A and B,
// which the consumers add up as they issue each k step, with two more
// consumer barriers a check.

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
template <class T>
struct FragInject {
  static constexpr bool kSegmented = false;  // B2 checks once, after the loop
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
  __device__ __forceinline__ void apply(WgMainloop<T>& ml, int) {
    if constexpr (T::NSUB == 1) {
      const int r = (ord * 131 + 7) % T::BM, c = (ord * col_stride + 3) % T::BN;
#pragma unroll
      for (int i = 0; i < T::NACC; ++i)
        ml.acc[i] += (ml.row(i) == r && ml.col(i) == c) ? mag : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) {
        const int r = ml.row(i), c = ml.col(i);
        const int o = ord + 3 * (r / T::SBM) + 5 * (c / T::SBN);
        const bool hit = r % T::SBM == (o * 131 + 7) % T::SBM &&
                         c % T::SBN == (o * col_stride + 3) % T::SBN;
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
// rows of B, inside one sub-tile band. At a check (update) a warp's
// butterfly and one shared-memory pass give each sub-tile its band sums;
// thread `sub` < NSUB evaluates the bound; two consumer barriers. The sums
// live in four registers a thread, the bands' in the check scratch.
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
  // E's R rows, or B2's 3 per band (R = 0: no second product).
  static constexpr int ER = T::R > 0 ? T::R : 3 * T::NBM;
  using Smem = WeightedSmem<ER, T::BN, T::NCONS / 32, T::NBM, T::NSUB>;
  Smem& cm;
  TH th;
  int n_det = 0, n_unc = 0;  // sub-tile threadIdx.x (< NSUB)

  __device__ __forceinline__ WeightedCheck(const Scalars& sc,
                                           const NoiseModel& nm, void* scratch)
      : cm(*reinterpret_cast<Smem*>(scratch)),
        th(sc, nm, bound_scratch<Smem>(scratch)) {}
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

// B5 (ROWS = kSumRows) and B6 (kLoadRows): 3 moment rows per row band.
template <int ROWS>
struct WeightedOf {
  template <int SBM, int SBN>
  struct At {
    static constexpr int NSUB = (128 / SBM) * (128 / SBN);
    using Smem = WeightedSmem<(3 * 128 / SBM + 7) / 8 * 8, 128, 8, 128 / SBM,
                              NSUB>;
    using type = WgTile<128, 128, SBM, SBN, 3, check_bytes<Smem, NSUB>(),
                        kNoBands, ROWS>;
    using Check =
        WeightedCheck<type, SubTileThresholds<type, kAdaptive, false>>;
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

// B3's check scratch, small enough for a four-stage ring with multifault
// off at the 64- and 128-row tiles.
template <int NWARPS, int BN, int NBM, int NSUB, int MROWS, bool MF>
struct RowcolSubSmem {
  union {
    struct {
      float e[MROWS][BN];  // expected column sums c_exp, cw_exp: row MOM b + v
      float sums[MF ? 2 : 1][NWARPS][BN];  // per warp: column sums 1 (, w)
    } in;  // until the column decisions
    // then per warp: the correction's column sums d, |d| (, w d, w |d|)
    float corr[MF ? 4 : 2][NWARPS][BN];
  };
  float res_c[NBM][BN];         // per band and column: the residuals
  RowsOf<MF ? NBM : 0, BN> res_cw;
  // a flagged column's weighted fault row in the band (MF; else 0), -1
  // when it lies outside; kUnflagged: the column did not flag
  signed char code[NBM][BN];
  // per sub-tile: flagged rows, flagged columns, uncorrectable, located
  // columns (MF)
  int cnt[MF ? 4 : 3][NSUB];
};

// One round of a reduce-scatter over lanes OFF apart: the lane with bit OFF
// set keeps the upper N of its 2 N column groups, the other the lower N,
// each adding its partner's copy.
template <int OFF, int N, int NV, int NQ>
__device__ __forceinline__ void scatter_round(float (&p)[NV][NQ][2], int l) {
  const bool up = l & OFF;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float send = up ? p[v][i][c] : p[v][i + N][c];
        const float keep = up ? p[v][i + N][c] : p[v][i][c];
        p[v][i][c] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
}

// B3's and B7's check (_rowcol_detect_correct) of every sub-tile, on consumer
// threads only. The expected row sums of a thread's two rows are the
// product's extra columns, band j at column BN + j in the lane of the quad
// with lane % 4 == j / 2: the row sums over each band come from the thread's
// own columns and two quad shuffles, and every lane of the quad forms all
// its rows' residuals. The column sums of a warp's 16 rows are
// reduce-scattered over the 8 lanes of a column (28 shuffles for 32
// columns), then one shared-memory pass over the band's warps meets E.
// Flags are counted per sub-tile by shared-memory atomics; a popcount
// barrier skips the correction when nothing in the CTA flagged (the clean
// path: three barriers). Otherwise every thread corrects its elements from
// its sub-tiles' counts (use_col, ambiguous), and the re-check subtracts
// the correction's row sums (quad shuffles) and column sums (shuffles, one
// shared-memory pass; a warp with no correction in a column group skips
// them) from the residuals, with the EPS8 pads: five barriers. (A cheaper
// re-check for sub-tiles with one flagged row and column, behind one more
// popcount barrier, was slower: PERF.md.)
template <class T, bool MF, class TH = SubTileThresholds<T, false, false>>
struct RowcolCheck {
  static constexpr bool kSegmented = true;  // ~20 checks per run
  static constexpr int MOM = MF ? 2 : 1, NV = MF ? 2 : 1;
  static constexpr int kUnflagged = -2;  // code of a column that did not flag
  using Smem = RowcolSubSmem<T::NCONS / 32, T::BN, T::NBM, T::NSUB,
                             MOM * T::NBM, MF>;
  Smem& cm;
  TH th;
  int n_det = 0, n_unc = 0;  // sub-tile threadIdx.x (< NSUB)

  __device__ __forceinline__ RowcolCheck(const Scalars& sc,
                                         const NoiseModel& nm, void* scratch)
      : cm(*reinterpret_cast<Smem*>(scratch)),
        th(sc, nm, bound_scratch<Smem>(scratch)) {
    // Ordered before the first check's use by its first barrier.
    if (threadIdx.x < (MF ? 4 : 3) * T::NSUB) (&cm.cnt[0][0])[threadIdx.x] = 0;
  }
  __device__ __forceinline__ int unc() const { return n_unc; }

  __device__ void check(WgMainloop<T>& ml) {
    constexpr int NQ = T::BN / 8, WPB = T::SBM / 16, NBN = T::NBN;
    constexpr int GPB = T::SBN / 8;  // 8-column groups per column band
    constexpr unsigned FULL = 0xffffffffu;
    const int t = threadIdx.x, warp = t / 32, l = ml.l, q = l & 3;
    const int b = ml.row(0) / T::SBM;  // the row band of both rows
    const float w0 = (float)(ml.row(0) % T::SBM + 1);
    const float w1 = (float)(ml.row(2) % T::SBM + 1);
    consumer_sync<T::NCONS>();  // the last check's readers are done
#pragma unroll
    for (int i = 0; i < T::NACC_E; ++i)
      if (ml.col(i) < MOM * T::NBM) cm.in.e[ml.col(i)][ml.row(i)] = ml.acc_e[i];
    // Row residuals per column band (bit 2 j + h of det_r: row h flagged).
    float res_r[2][NBN];
    unsigned det_r = 0u;
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float rs = 0.f;
#pragma unroll
        for (int gg = 0; gg < GPB; ++gg)
#pragma unroll
          for (int c = 0; c < 2; ++c) rs += ml.acc[4 * (j * GPB + gg) + 2 * h + c];
        rs += __shfl_xor_sync(FULL, rs, 1);
        rs += __shfl_xor_sync(FULL, rs, 2);
        const float r_exp = __shfl_sync(
            FULL, ml.acc[T::NACC + 2 * h + (j & 1)], (l & ~3) | (j >> 1));
        res_r[h][j] = r_exp - rs;
        if (fabsf(res_r[h][j]) > th.get(b * NBN + j, 0)) {
          det_r |= 1u << (2 * j + h);
          if (q == j >> 1) atomicAdd(&cm.cnt[0][b * NBN + j], 1);
        }
      }
    }
    // Column sums (and w-weighted) of this warp's 16 rows.
    {
      float p[NV][NQ][2];
#pragma unroll
      for (int g8 = 0; g8 < NQ; ++g8)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x0 = ml.acc[4 * g8 + c], x1 = ml.acc[4 * g8 + 2 + c];
          p[0][g8][c] = x0 + x1;
          if constexpr (MF) p[1][g8][c] = w0 * x0 + w1 * x1;
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
            cm.in.sums[v][warp][8 * (g0 + i) + 2 * q + c] = p[v][i][c];
    }
    consumer_sync<T::NCONS>();
    // One thread per (band, column): residuals, flags, the weighted row.
    bool flag = det_r != 0u;
    for (int jb = t; jb < T::NBM * T::BN; jb += T::NCONS) {
      const int bb = jb / T::BN, c = jb % T::BN, sub = bb * NBN + c / T::SBN;
      float cs = 0.f, csw = 0.f;
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp) {
        cs += cm.in.sums[0][bb * WPB + wp][c];
        if constexpr (MF) csw += cm.in.sums[1][bb * WPB + wp][c];
      }
      const float res = cm.in.e[MOM * bb][c] - cs;
      const bool det = fabsf(res) > th.get(sub, 0);
      int code = det ? 0 : kUnflagged;
      if constexpr (MF) {
        const float res_w = cm.in.e[MOM * bb + 1][c] - csw;
        cm.res_cw.v[bb][c] = res_w;
        flag |= fabsf(res_w) > th.get(sub, 1);
        if (det) {  // weighted_localize, in range or -1
          const int lr = __float2int_rn(res_w / res);
          code = lr < 1 || lr > T::SBM ? -1 : lr - 1;
          if (code >= 0) atomicAdd(&cm.cnt[3][sub], 1);
        }
      }
      cm.res_c[bb][c] = res;
      cm.code[bb][c] = (signed char)code;
      if (det) {
        atomicAdd(&cm.cnt[1][sub], 1);
        flag = true;
      }
    }
    if (consumer_count<T::NCONS>(flag) == 0) {
      if (t < T::NSUB) n_unc = 0;  // nothing flagged, nothing to correct
      return;
    }
    // The correction, band by band, and its row and column sums.
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
      const int sub = b * NBN + j;
      const int nr = cm.cnt[0][sub], nc = cm.cnt[1][sub];
      const bool use_col = nr == 1 && nc > 1;
      const bool amb = MF && nr > 1 && nc > 1;
      float ds[2] = {0.f, 0.f}, ads[2] = {0.f, 0.f};
      bool any_r = false;
#pragma unroll
      for (int gg = 0; gg < GPB; ++gg) {
        const int g8 = j * GPB + gg;
        float d[2][2];
        bool any = false;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = ml.col(4 * g8 + c), code = cm.code[b][col];
          const float rc = code != kUnflagged ? cm.res_c[b][col] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ml.row(2 * h) % T::SBM;
            const bool dr = (det_r >> (2 * j + h)) & 1u;
            const float dd =
                amb ? (code == r ? rc : 0.f)
                    : (dr && code != kUnflagged ? (use_col ? rc : res_r[h][j])
                                                : 0.f);
            d[h][c] = dd;
            ml.acc[4 * g8 + 2 * h + c] += dd;
            ds[h] += dd;
            ads[h] += fabsf(dd);
            any |= dd != 0.f;
          }
        }
        any_r |= any;
        float p[2 * NV][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p[0][c] = d[0][c] + d[1][c];
          p[1][c] = fabsf(d[0][c]) + fabsf(d[1][c]);
          if constexpr (MF) {
            p[2][c] = w0 * d[0][c] + w1 * d[1][c];
            p[3][c] = w0 * fabsf(d[0][c]) + w1 * fabsf(d[1][c]);
          }
        }
        if (__any_sync(FULL, any)) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
#pragma unroll
            for (int c = 0; c < 2; ++c)
#pragma unroll
              for (int v = 0; v < 2 * NV; ++v)
                p[v][c] += __shfl_xor_sync(FULL, p[v][c], off);
        }
        if (l < 4) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int v = 0; v < 2 * NV; ++v)
              cm.corr[v][warp][ml.col(4 * g8 + c)] = p[v][c];
        }
      }
      if (__any_sync(FULL, any_r)) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            ds[h] += __shfl_xor_sync(FULL, ds[h], off);
            ads[h] += __shfl_xor_sync(FULL, ads[h], off);
          }
      }
      if (q == j >> 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (fabsf(res_r[h][j] - ds[h]) > th.get(sub, 0) + EPS8 * ads[h])
            atomicAdd(&cm.cnt[2][sub], 1);
      }
    }
    consumer_sync<T::NCONS>();
    // The column re-check: the residuals after the correction.
    for (int jb = t; jb < T::NBM * T::BN; jb += T::NCONS) {
      const int bb = jb / T::BN, c = jb % T::BN, sub = bb * NBN + c / T::SBN;
      float s[2 * NV];
#pragma unroll
      for (int v = 0; v < 2 * NV; ++v) s[v] = 0.f;
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp)
#pragma unroll
        for (int v = 0; v < 2 * NV; ++v) s[v] += cm.corr[v][bb * WPB + wp][c];
      const bool bad_c =
          fabsf(cm.res_c[bb][c] - s[0]) > th.get(sub, 0) + EPS8 * s[1];
      if (bad_c) atomicAdd(&cm.cnt[2][sub], 1);
      if constexpr (MF) {
        if (!bad_c &&
            fabsf(cm.res_cw.v[bb][c] - s[2]) > th.get(sub, 1) + EPS8 * s[3])
          atomicAdd(&cm.cnt[2][sub], 1);
      }
    }
    consumer_sync<T::NCONS>();
    if (t < T::NSUB) {
      const int nr = cm.cnt[0][t], nc = cm.cnt[1][t];
      n_det += MF && nr > 1 && nc > 1 ? cm.cnt[MF ? 3 : 0][t] : nr * nc;
      n_unc = cm.cnt[2][t];  // LEVEL: the state after the latest check
#pragma unroll
      for (int v = 0; v < (MF ? 4 : 3); ++v) cm.cnt[v][t] = 0;
    }
  }
};

// B3 (BANDS = kSumBands, ROWS = kSumRowGroups) and B7 (kLoadBands,
// kLoadRows): 1 moment row (2 with multifault) per row band, and B's band
// rows as the product's extra columns.
template <bool MF, int BANDS, int ROWS>
struct RowcolOf {
  template <int SBM, int SBN>
  struct At {
    static constexpr int NBM = 128 / SBM, NSUB = NBM * (128 / SBN);
    using Smem = RowcolSubSmem<8, 128, NBM, NSUB, (MF ? 2 : 1) * NBM, MF>;
    using type = WgTile<128, 128, SBM, SBN, MF ? 2 : 1,
                        check_bytes<Smem, NSUB>(), BANDS, ROWS>;
    using Check =
        RowcolCheck<type, MF, SubTileThresholds<type, kAdaptive, false>>;
  };
};

// -------------------------------------------------- the global check ----

template <int NWARPS, int NBN>
struct GlobalSubSmem {
  float part[2][NWARPS][NBN];  // by check parity: each warp's band sums
};

// B4's and B8's check (_ft_kernel_global) of every sub-tile: res = t_exp - the
// sub-tile's total, where t_exp is the total of its rows' expected sums
// (the product's extra columns), taken as one sum of the differences: each
// thread's share per column band, a warp's butterfly, one shared-memory
// pass over the band's warps (double-buffered by check parity, so one
// barrier per check). An EVENT when |res - prev| exceeds the threshold,
// prev = res, kept per sub-tile by thread threadIdx.x < NSUB; nothing is
// corrected, so unc = det.
template <class T, class TH = SubTileThresholds<T, false, true>>
struct GlobalCheck {
  static constexpr bool kSegmented = true;  // ~20 checks per run
  using Smem = GlobalSubSmem<T::NCONS / 32, T::NBN>;
  Smem& cm;
  TH th;
  float prev = 0.f;
  int n_det = 0, parity = 0;

  __device__ __forceinline__ GlobalCheck(const Scalars& sc,
                                         const NoiseModel& nm, void* scratch)
      : cm(*reinterpret_cast<Smem*>(scratch)),
        th(sc, nm, bound_scratch<Smem>(scratch)) {}
  __device__ __forceinline__ int unc() const { return n_det; }

  __device__ void check(WgMainloop<T>& ml) {
    constexpr int NBN = T::NBN, GPB = T::SBN / 8, WPB = T::SBM / 16;
    const int t = threadIdx.x, l = ml.l;
    float v[NBN];
#pragma unroll
    for (int j = 0; j < NBN; ++j) {
      v[j] = (l & 3) == j >> 1 ? ml.acc[T::NACC + (j & 1)] +
                                     ml.acc[T::NACC + 2 + (j & 1)]
                               : 0.f;
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
      float res = 0.f;
#pragma unroll
      for (int wp = 0; wp < WPB; ++wp) res += cm.part[parity][bb * WPB + wp][j];
      // Fault EVENTS: an uncorrected fault keeps the residual high, so
      // only a move of the residual counts.
      n_det += fabsf(res - prev) > th.get(t, 0) ? 1 : 0;
      prev = res;
    }
    parity ^= 1;
  }
};

// B4 (BANDS = kSumBands) and B8 (kLoadBands): no moment rows; B's band
// rows as the product's extra columns.
template <int BANDS>
struct GlobalOf {
  template <int SBM, int SBN>
  struct At {
    using Smem = GlobalSubSmem<8, 128 / SBN>;
    using type = WgTile<128, 128, SBM, SBN, 0,
                        check_bytes<Smem, (128 / SBM) * (128 / SBN)>(), BANDS>;
    using Check = GlobalCheck<type, SubTileThresholds<type, kAdaptive, true>>;
  };
};

// ------------------------------------------------------------ kernel ----

// Fault injection and the checks of a sub-tiled kernel: a check (the
// policy `Check`) after the last k step of every check_every-th bk step and
// of the last. The check's cadence decides how the mainloop issues a stage
// with a check or fault in it (kSegmented, WgMainloop::mma_stage).
template <class T, class Check>
struct RunHook {
  static constexpr bool kSegmented = Check::kSegmented;
  static_assert(check_bytes<typename Check::Smem, T::NSUB>() <= T::CHECK_BYTES,
                "the check fits its scratch");
  FragInject<T> inj;
  Check ck;
  int chk, every8, nk8;

  __device__ __forceinline__ RunHook(const Scalars& sc, const NoiseModel& nm,
                                     int bk, int K, int check_every, int ti0,
                                     int tj0, void* scratch)
      : inj(sc, bk, K, ti0, tj0), ck(sc, nm, scratch),
        chk(min(check_every * (bk / 8), K / 8) - 1),
        every8(check_every * (bk / 8)), nk8(K / 8) {}

  __device__ __forceinline__ bool at(int t) const { return inj.at(t); }
  __device__ __forceinline__ bool within(int st) const {
    return inj.within(st) || chk < (st + 1) * T::KK;
  }
  __device__ __forceinline__ bool check_after(int t) const { return t == chk; }
  __device__ __forceinline__ int fault_step() const { return inj.fault_step(); }
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
    ck.th.update(ml, chk);
    ck.check(ml);
    chk = chk == nk8 - 1 ? INT_MAX : min(chk + every8, nk8 - 1);
  }
};

// B5's producer sums its moment rows (WgSmem::sum_rows) and is faster with
// more registers than the others' (PERF.md, findings).
template <class T>
struct RunRegs {
  static constexpr int PRODUCER = T::ROWS == kSumRows ? 56 : 40;
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
    Scalars sc, NoiseModel nm) {
  const WgSmem<T> sm;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int ti0 = blockIdx.y * T::NBM, tj0 = blockIdx.x * T::NBN;
  const int nst = (K + T::SK - 1) / T::SK;
  sm.init();
  if (threadIdx.x >= T::NCONS) {  // the producer warpgroup
    setmaxnreg_dec<RunRegs<T>::PRODUCER>();
    sm.produce(&ta, &tb, m0, n0, nst, &tm, ti0, &tbb, tj0);
    return;
  }
  setmaxnreg_inc<RunRegs<T>::CONSUMER>();
  WgMainloop<T> ml(sm);
  RunHook<T, Check> hook(sc, nm, bk, K, check_every, ti0, tj0, sm.check());
  ml.run(nst, hook);
  ml.template store<true>(out, C, N, m0, n0, alpha, beta, M);
  const int t = threadIdx.x, gn = N / T::SBN;
  const int ti = ti0 + t / T::NBN, tj = tj0 + t % T::NBN;
  if (t < T::NSUB && ti < M / T::SBM && tj < gn) {
    det[ti * gn + tj] = hook.ck.n_det;
    unc[ti * gn + tj] = hook.ck.unc();
  }
}

// One launch of a sub-tiled kernel for sub-tile (bm, bn): `Of<bm, bn>`
// names its tile (and where its moment and band rows come from) and its
// check (WeightedOf<ROWS>::At, RowcolOf<MF, BANDS, ROWS>::At,
// GlobalOf<BANDS>::At); `MA` the wrapper's (M / bm, n_rows, K) moment rows
// (kLoadRows: B6, B7; the kernel loads the first MOM of each band's rows),
// `MB` its (N / bn, 1, K) band rows (kLoadBands: B7, B8); `scalars` the
// host array of the scalar argument, `nm` the noise model's constants (read
// by the adaptive build). Returns 0 or the CUDA error, also when a tensor
// map cannot be encoded or no sub-tile matches.
template <template <int, int> class Of>
int launch_running(const float* A, const float* B, const float* C,
                   const float* MA, const float* MB, int n_rows, float* out,
                   int* det, int* unc, int M, int N, int K, int bm, int bn,
                   int bk, int check_every, float alpha, float beta,
                   const float* scalars, const NoiseModel& nm,
                   cudaStream_t stream) {
  Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
  if (K % 8 || bk % 8 || check_every < 1) return (int)cudaErrorInvalidValue;
#define FTSG_LAUNCH_SUB(SBM_, SBN_)                                            \
  if (bm == SBM_ && bn == SBN_) {                                              \
    using T = typename Of<SBM_, SBN_>::type;                                   \
    const auto kernel =                                                        \
        ft_running_wgmma_kernel<T, typename Of<SBM_, SBN_>::Check>;            \
    CUtensorMap ta, tb, tm = {}, tbb = {};                                     \
    if (!tensor_map(&ta, A, M, K, T::BM, T::SK) ||                             \
        !tensor_map(&tb, B, N, K, T::BN, T::SK) ||                             \
        (T::ROWS == kLoadRows &&                                               \
         (n_rows < T::MOM || !tensor_map3(&tm, MA, M / SBM_, n_rows, K,        \
                                          T::NBM, T::MOM, T::SK))) ||          \
        (T::BANDS == kLoadBands &&                                             \
         !tensor_map(&tbb, MB, N / SBN_, K, T::NBN, T::SK)))                   \
      return (int)cudaErrorInvalidValue;                                       \
    if (const cudaError_t e = cudaFuncSetAttribute(                            \
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM))     \
      return (int)e;                                                           \
    kernel<<<dim3((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM), T::NT,    \
             T::SMEM, stream>>>(ta, tb, tm, tbb, C, out, det, unc, M, N, K,   \
                                bk, check_every, alpha, beta, sc, nm);         \
    return (int)cudaGetLastError();                                            \
  }
  FTSG_FOR_EACH_SUBTILE(FTSG_LAUNCH_SUB)
#undef FTSG_LAUNCH_SUB
  return (int)cudaErrorInvalidValue;
}

FTSG_NAMESPACE_END  // ftsg

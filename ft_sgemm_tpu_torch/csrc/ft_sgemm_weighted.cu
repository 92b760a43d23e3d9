// Kernels B2 and B5: fused-ABFT SGEMM, weighted strategy.
//
// B2 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_weighted_precomp
// (pallas_call at ops/ft_sgemm.py:1468), what ft_sgemm ids 11-16 run by
// default: expected column moments precomputed outside the kernel
// (ops/ft_sgemm.py::_expected_col_checksums, one fp32 torch.matmul), one
// detect / correct at the last K step.
// B5 replaces _ft_kernel_weighted (ops/ft_sgemm.py:917), the same check
// with the three expected moments encoded inside the kernel as running
// sums, for cadences with intermediate checks. The port's small tile is
// 16 columns wide, narrower than the ~20 faults of the reference-like
// schedule, so the injection clamp gives it intermediate checks and id 11
// runs B5 on ft_sgemm's main path. B5 is ft_sgemm_running.cuh's kernel with
// its moment rows summed from A's stage (kSumRows), at every tile.
//
// B2 adds to B1's product the fault injection of _inject (FragInject) and,
// after the last k step, the three column moments (weights 1, w, w^2 with
// w = row in the tile + 1) of the register accumulator, per-column
// localization by the weighted-residual ratio, the correction, and the
// three-moment re-check (_moment_detect_correct). Correction precedes
// alpha / beta, and the fused epilogue (bias, activation, quantize:
// ops/ft_sgemm.py:1004-1007 for B5, :1063-1073 for B2) follows them in the
// store (abft_common.cuh, Epilogue).
//
// What bounds B2 on an H100: B1's three TF32 tensor-core products per
// multiply-add and split pass (gemm_wgmma.cuh). It adds a per-tile check
// costing about 6 * BM * BN operations, once per run, and, at a scheduled
// fault (~20 per tile at 4096), one wait for the in-flight wgmmas.
//
// What the design does about it: the mainloop is B1's, unchanged; B2's
// check runs once, after it, in the drained ring. A fault is added between
// two k steps' wgmmas, after they have landed, so it takes the same place
// in the sum as in the plain version (ops/ft_sgemm.py::_inject_plain). The
// moments are reduced with warp shuffles over the lanes that share a
// column and one shared-memory pass across the consumer warps. As B1, B2
// runs the tile's own CTA at large, tall, huge and test (wg_moment_check);
// at small, medium and wide the 128 x 128 CTA over (bm, bn) sub-tiles, each
// with its own fault ordinal, weights, check (PrecompCheck: B5's
// WeightedCheck against the wrapper's moments) and grid cells.
//
// bf16 (the _bf16 entry points; ops/ft_sgemm.py:1545-1549 of the JAX
// package): A and B bf16 on the bf16 mainloop (gemm_wgmma.cuh), everything
// else f32 and unchanged. B2 checks against the wrapper's expected moments
// of the rounded operands (their hi / lo / lo2 term products summed); B5's
// splitter warps sum the moment rows from A's bf16 stage in f32 and carry
// each as three bf16 terms. Bound: 2 M N K at 989 TFLOP/s (0.139 ms at
// 4096) and B5's expected moments beside it. The bf16 builds are libraries
// of their own (FTSG_BF16 with FTSG_KERNEL 2 and 5, one each); B5's
// adaptive bf16 build (with FTSG_ADAPTIVE too) sums the rounded operands' moments per 8-column half
// step (SubTileThresholds::kstep_bf16); B2 has none.

#include "abft_common.cuh"
#include "ft_sgemm_running.cuh"
#include "gemm_wgmma.cuh"

FTSG_NAMESPACE_BEGIN

template <class T>
struct WgCheckSmem {
  float part[3][T::NCONS / 32][T::BN];  // per warp: moments 1, w, w^2
  float delta[T::BN];
  int hit_row[T::BN];
};

// B2's check over the wgmma fragment: the column moments 1, w, w^2 (each
// thread's two rows per column, shuffles over the 8 lanes of a warp that
// share a column (equal lane % 4), one shared-memory pass over the
// consumer warps), weighted_column per column, the correction in place.
// Consumer threads only (named barrier 1); `cm` reuses the drained ring.
template <class T>
__device__ __forceinline__ void wg_moment_check(
    WgMainloop<T>& ml, WgCheckSmem<T>& cm, const float* e, int N,
    const Scalars& sc, int& n_hit, int& n_unc) {
  constexpr int NQ = T::BN / 8;
  consumer_sync<T::NCONS>();  // no consumer reads the ring any more
  float p[3][NQ][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      p[0][q][c] = p[1][q][c] = p[2][q][c] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * q + 2 * h + c;
        const float w = (float)(ml.row(i) + 1), x = ml.acc[i];
        p[0][q][c] += x;
        p[1][q][c] += w * x;
        p[2][q][c] += (w * w) * x;
      }
    }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          p[v][q][c] += __shfl_xor_sync(0xffffffffu, p[v][q][c], off);
  const int warp = threadIdx.x / 32;
  if (ml.l < 4) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int v = 0; v < 3; ++v) cm.part[v][warp][ml.col(4 * q + c)] = p[v][q][c];
  }
  consumer_sync<T::NCONS>();
  const int t = threadIdx.x;
  bool hit = false, bad = false;
  if (t < T::BN) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int wp = 0; wp < T::NCONS / 32; ++wp)
      for (int v = 0; v < 3; ++v) s[v] += cm.part[v][wp][t];
    const ColumnVerdict cv = weighted_column(
        e[t], e[N + t], e[2 * (size_t)N + t], s[0], s[1], s[2], T::BM,
        sc.s[SLOT_THRESHOLD], sc.s[SLOT_THR_M1], sc.s[SLOT_THR_M2]);
    hit = cv.hit;
    bad = cv.bad;
    cm.delta[t] = cv.delta;
    cm.hit_row[t] = cv.row;
  }
  n_hit = consumer_count<T::NCONS>(hit);  // also publishes delta / hit_row
  n_unc = consumer_count<T::NCONS>(bad);
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) {
    const int c = ml.col(i);
    ml.acc[i] += cm.hit_row[c] == ml.row(i) ? cm.delta[c] : 0.f;
  }
}

// B2 on the sub-tiles of a 128 x 128 CTA: B5's check (WeightedCheck) of
// every sub-tile, once, against the wrapper's expected moments, which it
// stages in its scratch: expm (gm, 3, N) row band ti0 + b as rows 3 b ..
// 3 b + 2, where B5 stages its product E. A band past gm reads nothing (a
// sub-tile there writes no grid cell).
template <class T>
struct PrecompCheck : WeightedCheck<T> {
  using WeightedCheck<T>::WeightedCheck;

  __device__ void check(WgMainloop<T>& ml, const float* expm, int gm, int N,
                        int ti0, int n0) {
    consumer_sync<T::NCONS>();  // no consumer reads the ring any more
    for (int j = threadIdx.x; j < 3 * T::NBM * T::BN; j += T::NCONS) {
      const int r = j / T::BN, c = j % T::BN;
      this->cm.e[r][c] = ti0 + r / 3 < gm && n0 + c < N
                             ? expm[(size_t)(3 * ti0 + r) * N + n0 + c]
                             : 0.f;
    }
    this->decide(ml);
  }
};

// B2 on tile T: the tile's own CTA (NSUB = 1) or the 128 x 128 CTA over
// (SBM, SBN) sub-tiles; `expm` is the (M / SBM, 3, N) expected moments.
template <class T>
__global__ void __launch_bounds__(T::NT, T::MIN_CTAS) ft_weighted_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ C,
    const float* __restrict__ expm, float* __restrict__ out,
    int* __restrict__ det, int* __restrict__ unc, int M, int N, int K, int bk,
    float alpha, float beta, Scalars sc, Epilogue epi, Variant v) {
  const WgSmem<T> sm;
  const int m0 = v.tile_m() * T::BM, n0 = v.tile_n() * T::BN;
  const int ti0 = v.tile_m() * T::NBM, tj0 = v.tile_n() * T::NBN;
  const int nst = (K + T::SK - 1) / T::SK;
  sm.init();
  if (threadIdx.x >= T::NCONS) {  // the producer warpgroup
    setmaxnreg_dec<T::REGS_PRODUCER>();
    sm.produce(&ta, &tb, m0, n0, nst);
    return;
  }
  setmaxnreg_inc<T::REGS_CONSUMER>();
  WgMainloop<T> ml(sm);
  FragInject<T> inj(sc, bk, K, ti0, tj0);
  ml.run(nst, inj);
  // Every wgmma and TMA write has landed: the ring is free for the check.
  if constexpr (T::NSUB == 1) {
    static_assert(sizeof(WgCheckSmem<T>) <= T::STAGES * T::STAGE_BYTES,
                  "the check fits in the ring");
    int n_hit, n_unc;
    wg_moment_check(ml, *reinterpret_cast<WgCheckSmem<T>*>(sm.base),
                    expm + (size_t)ti0 * 3 * N + n0, N, sc, n_hit, n_unc);
    ml.store(out, C, N, m0, n0, alpha, beta, epi);
    if (threadIdx.x == 0) {  // N is a multiple of BN here: N / BN tiles
      det[ti0 * (N / T::BN) + tj0] = n_hit;
      unc[ti0 * (N / T::BN) + tj0] = n_unc;
    }
  } else {
    static_assert(sizeof(typename PrecompCheck<T>::Smem) <=
                      T::STAGES * T::STAGE_BYTES,
                  "the check fits in the ring");
    const int gm = M / T::SBM, gn = N / T::SBN;
    PrecompCheck<T> ck(sc, NoiseModel{}, sm.base);
    ck.check(ml, expm, gm, N, ti0, n0);
    const auto grids = [&] {
      const int t = threadIdx.x, ti = ti0 + t / T::NBN, tj = tj0 + t % T::NBN;
      if (t < T::NSUB && ti < gm && tj < gn) {
        det[ti * gn + tj] = ck.n_det;
        unc[ti * gn + tj] = ck.unc();
      }
    };
    // As in ft_running_wgmma_kernel: the order that keeps the allocation.
    if constexpr (T::BF16) grids();
    ml.template store<true>(out, C, N, m0, n0, alpha, beta, epi, M);
    if constexpr (!T::BF16) grids();
  }
}

template <class T>
int launch_wgmma(const void* A, const void* B, const float* C,
                 const float* expm, float* out, int* det, int* unc, int M,
                 int N, int K, int bk, float alpha, float beta,
                 const Scalars& sc, const Epilogue& epi, const Variant& v,
                 cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (bk % 8 || !epi.valid() || !v.valid()) return (int)cudaErrorInvalidValue;
  if (const int rc = wgmma_setup<T>(ft_weighted_wgmma_kernel<T>, &ta, &tb, A,
                                    B, M, N, K))
    return rc;
  ft_weighted_wgmma_kernel<T>
      <<<v.grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN), T::NT,
          T::SMEM, stream>>>(ta, tb, C, expm, out, det, unc, M, N, K, bk,
                             alpha, beta, sc, epi, v);
  return (int)cudaGetLastError();
}

FTSG_NAMESPACE_END  // ftsg

#if !FTSG_ADAPTIVE && !FTSG_BF16
// B2 (no adaptive form: its expected moments are the wrapper's, and the
// adaptive weighted strategy runs B5). `scalars` is a host array of 8
// floats (contracts.SCALAR_SLOTS); `expm` the (M / bm, 3, N) expected
// moments; bias, act, quant and scale the fused epilogue (abft_common.cuh,
// Epilogue), applied after the check; grid_nm the grid order
// (abft_common.cuh, Variant). Returns cudaGetLastError()
// (cudaErrorInvalidValue when no tile matches).
extern "C" int ftsg_ft_weighted_precomp(
    const float* A, const float* B, const float* C, const float* expm,
    float* out, int* det, int* unc, int M, int N, int K, int bm, int bn,
    int bk, float alpha, float beta, const float* scalars, const float* bias,
    int act, int quant, float scale, int grid_nm, void* stream) {
  ftsg::Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
  const ftsg::Epilogue epi{bias, act, quant, scale};
  const ftsg::Variant v{grid_nm};
  const auto s = (cudaStream_t)stream;
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTile<BM_, BN_>>(                     \
        A, B, C, expm, out, det, unc, M, N, K, bk, alpha, beta, sc, epi, v, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
#define FTSG_LAUNCH_SUB(BM_, BN_)                                          \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTile<128, 128, BM_, BN_>>(           \
        A, B, C, expm, out, det, unc, M, N, K, bk, alpha, beta, sc, epi, v, s);
  FTSG_FOR_EACH_NARROW_TILE(FTSG_LAUNCH_SUB)
#undef FTSG_LAUNCH_SUB
  return (int)cudaErrorInvalidValue;
}
#endif

#if !FTSG_ADAPTIVE && FTSG_BF16 && FTSG_HAS(2)
// B2 with bf16 A and B; the rest as ftsg_ft_weighted_precomp.
extern "C" int ftsg_ft_weighted_precomp_bf16(
    const void* A, const void* B, const float* C, const float* expm,
    float* out, int* det, int* unc, int M, int N, int K, int bm, int bn,
    int bk, float alpha, float beta, const float* scalars, const float* bias,
    int act, int quant, float scale, int grid_nm, void* stream) {
  ftsg::Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
  const ftsg::Epilogue epi{bias, act, quant, scale};
  const ftsg::Variant v{grid_nm};
  const auto s = (cudaStream_t)stream;
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTileOf<BM_, BN_, ftsg::kBF16>>(      \
        A, B, C, expm, out, det, unc, M, N, K, bk, alpha, beta, sc, epi, v, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
#define FTSG_LAUNCH_SUB(BM_, BN_)                                          \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTile<128, 128, BM_, BN_, 0, 0,       \
                                           ftsg::kNoBands, ftsg::kNoRows,  \
                                           ftsg::kBF16>>(                  \
        A, B, C, expm, out, det, unc, M, N, K, bk, alpha, beta, sc, epi, v, s);
  FTSG_FOR_EACH_NARROW_TILE(FTSG_LAUNCH_SUB)
#undef FTSG_LAUNCH_SUB
  return (int)cudaErrorInvalidValue;
}
#endif

#if FTSG_BF16 && FTSG_HAS(5)
// B5 with bf16 A and B; the rest as ftsg_ft_weighted_running.
extern "C" int ftsg_ft_weighted_running_bf16(
    const void* A, const void* B, const float* C, float* out, int* det,
    int* unc, int M, int N, int K, int bm, int bn, int bk, int check_every,
    float alpha, float beta, const float* scalars, float log2_t,
    float c_rand, float c_bias, const float* bias, int act, int quant,
    float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<
      ftsg::WeightedOf<ftsg::kSumRows, ftsg::kBF16>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

#if !FTSG_BF16
// B5: checks after every `check_every` K steps and after the last, on the
// 128 x 128 wgmma CTA over (bm, bn) sub-tiles; log2_t, c_rand and c_bias
// are the noise model's constants (NoiseModel), read by the adaptive build.
extern "C" int ftsg_ft_weighted_running(
    const float* A, const float* B, const float* C, float* out, int* det,
    int* unc, int M, int N, int K, int bm, int bn, int bk, int check_every,
    float alpha, float beta, const float* scalars, float log2_t,
    float c_rand, float c_bias, const float* bias, int act, int quant,
    float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<ftsg::WeightedOf<ftsg::kSumRows>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

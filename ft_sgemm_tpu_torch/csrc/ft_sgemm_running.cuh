// Kernels B5 and B6 on the 3xTF32 wgmma mainloop (gemm_wgmma.cuh), and the
// fault injection they share with B2.
//
// B5 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_weighted (:917) and
// B6 _ft_kernel_fused (:1077; pallas_call at ops/ft_sgemm.py:1468): the
// weighted check (column moments 1, w, w^2 with w = row + 1, the fault row
// of each flagged column by the weighted-residual ratio, the correction, the
// three-moment re-check) after every `check_every` bk steps and after the
// last, against expected moments accumulated inside the kernel. They differ
// only in where the expected moments' A side comes from: B5 sums A's
// landed stage over each tile's rows (the running encode), B6 loads the
// wrapper's (gm * 3, K) moment rows (ops/ft_sgemm._tile_moments) by TMA as
// one more box of each stage (the mxu encode).
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
// multiply-add, for C (2 M N K) and for the expected moments (2 N K * 3 M /
// bm: E = B_tile . M^T, 19 % more at the 16-row tile, 2 % at 128 rows), at
// 495 TFLOP/s; B5 adds its moment sums (~6 M K operations) on the producer's
// splitter warps, beside the products. A check costs ~10 * 128 * 128
// operations per CTA and four consumer barriers; the program's cadences
// give one or two per run.
//
// What the design does about it: the products and the expected moments both
// run on the tensor cores from the same split stage of B, each promoted into
// an f32 sum once per 32-column stage (so both sides of a residual carry the
// same precision), and the expected moments never leave the SM. A check
// comes between two 8-column k steps, after they have landed, wherever the
// bk step ends (also inside a stage). Its moments reduce by warp shuffles
// (a 16-row sub-tile is one warp's band) and one shared-memory pass over
// the warps of a band; one thread per (band, column) decides; the counts per
// sub-tile are shared-memory atomics.

#pragma once

#include <climits>

#include "abft_common.cuh"
#include "gemm_wgmma.cuh"

namespace ftsg {

// Fault injection for the wgmma mainloop, the schedule of
// abft_common.cuh::inject counted down in 8-column k steps: the fault of bk
// step k = f * every (f = 0, 1, ..) comes before k step next = k * bk / 8
// (while next < K / 8). Per sub-tile (ti, tj) (global indices: the CTA's
// first is (ti0, tj0)) at ordinal f + 3 ti + 5 tj, row (131 ord + 7) % SBM
// and column (col_stride ord + 3) % SBN of the sub-tile, so no k step
// divides. Branch-free selects over the fragment, as inject.
template <class T>
struct FragInject {
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
};

// The check scratch of a running kernel, beside the ring (the ring is in
// flight at a mid-loop check).
template <int R, int BN, int NWARPS, int NBM, int NSUB>
struct RunCheckSmem {
  float e[R][BN];               // expected moments, moment row 3 b + v
  float part[3][NWARPS][BN];    // per warp: moments 1, w, w^2
  float delta[NBM][BN];         // per band and column: the correction
  int hit_row[NBM][BN];         // and its row in the band (-1: none)
  int cnt[2][NSUB];             // per sub-tile: hits, uncorrectable
};

// The 128 x 128 CTA of B5 and B6 over (SBM, SBN) sub-tiles: R moment rows
// (3 per row band, padded to a multiple of 8).
template <int SBM, int SBN>
struct RunTileOf {
  static constexpr int R = (3 * 128 / SBM + 7) / 8 * 8;
  using Smem = RunCheckSmem<R, 128, 8, 128 / SBM, (128 / SBM) * (128 / SBN)>;
  using type = WgTile<128, 128, SBM, SBN, R, (int)sizeof(Smem)>;
};

// Fault injection and the checks of a running kernel: a check after the
// last k step of every check_every-th bk step and of the last.
template <class T>
struct RunHook {
  using Smem = RunCheckSmem<T::R, T::BN, T::NCONS / 32, T::NBM, T::NSUB>;
  static_assert(sizeof(Smem) <= T::CHECK_BYTES, "the check fits its scratch");
  FragInject<T> inj;
  Smem& cm;
  int chk, every8, nk8;
  float thr, thr_m1, thr_m2;
  int n_det = 0, n_unc = 0;  // sub-tile threadIdx.x (< NSUB)

  __device__ __forceinline__ RunHook(const Scalars& sc, int bk, int K,
                                     int check_every, int ti0, int tj0,
                                     void* scratch)
      : inj(sc, bk, K, ti0, tj0), cm(*reinterpret_cast<Smem*>(scratch)),
        chk(min(check_every * (bk / 8), K / 8) - 1),
        every8(check_every * (bk / 8)), nk8(K / 8),
        thr(sc.s[SLOT_THRESHOLD]), thr_m1(sc.s[SLOT_THR_M1]),
        thr_m2(sc.s[SLOT_THR_M2]) {}

  __device__ __forceinline__ bool at(int t) const { return inj.at(t); }
  __device__ __forceinline__ bool within(int st) const {
    return inj.within(st) || chk < (st + 1) * T::KK;
  }
  __device__ __forceinline__ bool check_after(int t) const { return t == chk; }
  __device__ __forceinline__ void apply(WgMainloop<T>& ml, int t) {
    inj.apply(ml, t);
  }

  // The weighted check of every sub-tile, on consumer threads only (named
  // barrier 1): E transposed into shared memory; the column moments of each
  // warp's 16 rows by shuffles over the 8 lanes that share a column (equal
  // lane % 4); one thread per (band, column) adds its band's warps and
  // decides (weighted_column); the correction in place.
  __device__ void check(WgMainloop<T>& ml) {
    constexpr int NQ = T::BN / 8, WPB = T::SBM / 16;
    const int t = threadIdx.x, warp = t / 32;
    consumer_sync<T::NCONS>();  // the last check's readers are done
#pragma unroll
    for (int i = 0; i < T::NACC_E; ++i)
      if (ml.col(i) < 3 * T::NBM) cm.e[ml.col(i)][ml.row(i)] = ml.acc_e[i];
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
      const ColumnVerdict cv = weighted_column(
          cm.e[3 * b][c], cm.e[3 * b + 1][c], cm.e[3 * b + 2][c], s[0], s[1],
          s[2], T::SBM, thr, thr_m1, thr_m2);
      cm.delta[b][c] = cv.delta;
      cm.hit_row[b][c] = cv.row;
      const int sub = b * T::NBN + c / T::SBN;
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
    chk = chk == nk8 - 1 ? INT_MAX : min(chk + every8, nk8 - 1);
  }
};

// B5 (ROWS = kSumRows) and B6 (kLoadRows) on M x N (padded to the sub-tile)
// with a check every `check_every` bk steps and after the last; `tm` the
// moment rows' tensor map (B6).
// B5's producer sums its moment rows (WgSmem::sum_rows) and is faster with
// more registers than B6's, which only splits (PERF.md, findings).
template <class T, int ROWS>
struct RunRegs {
  static constexpr int PRODUCER = ROWS == kSumRows ? 56 : 40;
  static constexpr int CONSUMER = T::consumer_regs(PRODUCER);
};

template <class T, int ROWS>
__global__ void __launch_bounds__(T::NT, 1) ft_running_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tm, const float* __restrict__ C,
    float* __restrict__ out, int* __restrict__ det, int* __restrict__ unc,
    int M, int N, int K, int bk, int check_every, float alpha, float beta,
    Scalars sc) {
  const WgSmem<T> sm;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int ti0 = blockIdx.y * T::NBM, tj0 = blockIdx.x * T::NBN;
  const int nst = (K + T::SK - 1) / T::SK;
  sm.init();
  using Regs = RunRegs<T, ROWS>;
  if (threadIdx.x >= T::NCONS) {  // the producer warpgroup
    setmaxnreg_dec<Regs::PRODUCER>();
    sm.template produce<ROWS>(&ta, &tb, m0, n0, nst, &tm, 3 * ti0);
    return;
  }
  setmaxnreg_inc<Regs::CONSUMER>();
  WgMainloop<T> ml(sm);
  RunHook<T> hook(sc, bk, K, check_every, ti0, tj0, sm.check());
  ml.run(nst, hook);
  ml.template store<true>(out, C, N, m0, n0, alpha, beta, M);
  const int t = threadIdx.x, gn = N / T::SBN;
  const int ti = ti0 + t / T::NBN, tj = tj0 + t % T::NBN;
  if (t < T::NSUB && ti < M / T::SBM && tj < gn) {
    det[ti * gn + tj] = hook.n_det;
    unc[ti * gn + tj] = hook.n_unc;
  }
}

// One launch of B5 or B6 for sub-tile (bm, bn); `MA` the (M / bm * 3, K)
// moment rows (B6 only). Returns 0 or the CUDA error, also when a tensor
// map cannot be encoded or no sub-tile matches.
template <int ROWS>
int launch_running(const float* A, const float* B, const float* C,
                   const float* MA, float* out, int* det, int* unc, int M,
                   int N, int K, int bm, int bn, int bk, int check_every,
                   float alpha, float beta, const float* scalars,
                   cudaStream_t stream) {
  Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
  if (K % 8 || bk % 8 || check_every < 1) return (int)cudaErrorInvalidValue;
#define FTSG_LAUNCH_SUB(SBM_, SBN_)                                            \
  if (bm == SBM_ && bn == SBN_) {                                              \
    using T = typename RunTileOf<SBM_, SBN_>::type;                            \
    CUtensorMap ta, tb, tm;                                                    \
    if (!tensor_map(&ta, A, M, K, T::BM, T::SK) ||                             \
        !tensor_map(&tb, B, N, K, T::BN, T::SK) ||                             \
        !tensor_map(&tm, ROWS == kLoadRows ? MA : A,                           \
                    ROWS == kLoadRows ? M / SBM_ * 3 : M, K, T::R, T::SK))     \
      return (int)cudaErrorInvalidValue;                                       \
    if (const cudaError_t e = cudaFuncSetAttribute(                            \
            ft_running_wgmma_kernel<T, ROWS>,                                  \
            cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM))             \
      return (int)e;                                                           \
    ft_running_wgmma_kernel<T, ROWS>                                           \
        <<<dim3((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM), T::NT,      \
           T::SMEM, stream>>>(ta, tb, tm, C, out, det, unc, M, N, K, bk,       \
                              check_every, alpha, beta, sc);                   \
    return (int)cudaGetLastError();                                            \
  }
  FTSG_FOR_EACH_SUBTILE(FTSG_LAUNCH_SUB)
#undef FTSG_LAUNCH_SUB
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftsg

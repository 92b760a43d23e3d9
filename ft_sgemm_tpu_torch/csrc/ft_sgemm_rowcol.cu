// Kernel B3: fused-ABFT SGEMM, rowcol strategy (reference parity,
// --strategy=rowcol).
//
// Replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_rowcol (:516; pallas_call
// at ops/ft_sgemm.py:1468). Per K step: fault injection, the step's FFMAs,
// and the checksum encode r_exp += A . s_b and c_exp += B . s_a (plus the
// row-weighted cw_exp in multifault mode MF). After every `check_every`
// steps and after the last: row and column residuals, correction where a
// flagged row meets a flagged column, the multifault weighted localization
// when that intersection is ambiguous, and the re-check after correction
// whose count is a LEVEL (rowcol_detect_correct). Correction precedes
// alpha / beta.
//
// What bounds it on an H100: the FP32 FFMA rate at ft_sgemm's sizes, as
// B1. The encode adds, per K chunk of KS columns, the column sums of the
// staged A and B chunk (KS * (BM + BN) adds, or 3 * KS * BM more in
// multifault mode) and two FMAs per chunk column for each owned row /
// column, against KS * BM * BN FFMAs — about 5 % at the huge tile, over a
// third at the 16 x 16 small tile — plus one extra barrier per chunk, whose
// latency costs more than the operations (PERF.md). Each check costs a few
// shuffle-and-shared-memory reductions of the accumulator.
//
// What the design does about it: the encode reads the chunk already staged
// in shared memory for the FFMAs (no second pass over A or B), keeps the
// expected sums in registers of the thread that owns the row / column, and
// reduces with warp shuffles; the mainloop is B1's (gemm_mainloop.cuh).

#include "abft_common.cuh"

namespace ftsg {

template <class L, bool MF>
__global__ void __launch_bounds__(L::NT, L::MIN_CTAS) ft_rowcol_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, float* __restrict__ out,
    int* __restrict__ det, int* __restrict__ unc, int N, int K, int bk,
    int check_every, float alpha, float beta, Scalars sc) {
  using Enc = Encoder<L, MF ? 2 : 1, true>;
  __shared__ Stage<L> st;
  __shared__ RowcolSmem<L> rs;
  __shared__ typename Enc::Smem es;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * L::BM, n0 = tj * L::BN;
  const int nk = K / bk;
  Mainloop<L> ml(A, B, K, m0, n0);
  Enc enc;
  int n_det = 0, n_unc = 0;
  k_loop(
      ml, st, nk, bk / L::KS,
      [&](int s) { inject(ml, sc, s, ti, tj); },
      [&](int buf) { enc.chunk(st, buf, es); },
      [&](int s) {
        if (!((s + 1) % check_every == 0 || s == nk - 1)) return;
        int hit, bad;
        // enc.c[1] (cw_exp) exists and is read only in multifault mode.
        rowcol_detect_correct<L, MF>(ml, rs, enc.r, enc.c[0], enc.c[MF ? 1 : 0],
                                     sc.s[SLOT_THRESHOLD], sc.s[SLOT_THR_M1],
                                     hit, bad);
        n_det += hit;
        n_unc = bad;  // LEVEL: the state after the latest check
      });
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_det;
    unc[ti * gridDim.x + tj] = n_unc;
  }
}

}  // namespace ftsg

// `scalars` is a host array of 8 floats (contracts.SCALAR_SLOTS). Returns
// cudaGetLastError() (cudaErrorInvalidValue when no layout matches).
extern "C" int ftsg_ft_rowcol(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int ks, int mr, int nr,
                              int bk, int check_every, int multifault,
                              float alpha, float beta, const float* scalars,
                              void* stream) {
  ftsg::Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
#define FTSG_LAUNCH_MF(BM_, BN_, KS_, TM_, TN_, MF_)                          \
  ftsg::ft_rowcol_kernel<L, MF_>                                              \
      <<<dim3(N / BN_, M / BM_), L::NT, 0, (cudaStream_t)stream>>>(           \
          A, B, C, out, det, unc, N, K, bk, check_every, alpha, beta, sc);
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                                  \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_) {        \
    using L = ftsg::Layout<BM_, BN_, KS_, TM_, TN_>;                          \
    if (multifault) {                                                         \
      FTSG_LAUNCH_MF(BM_, BN_, KS_, TM_, TN_, true)                           \
    } else {                                                                  \
      FTSG_LAUNCH_MF(BM_, BN_, KS_, TM_, TN_, false)                          \
    }                                                                         \
    return (int)cudaGetLastError();                                           \
  }
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
#undef FTSG_LAUNCH_MF
  return (int)cudaErrorInvalidValue;
}

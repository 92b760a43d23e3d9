// Kernels B4 and B8: fused-ABFT SGEMM, global strategy (one scalar checksum
// per tile, detect only; --strategy=global).
//
// B4 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_global (:832;
// pallas_call at ops/ft_sgemm.py:1468), --encode=vpu. Per K chunk the
// plain column sums of the staged A and B chunk (s_a, s_b: Encoder<L, 1,
// true>::sums) give the tile's expected total t_exp += sum_kk s_a[kk] *
// s_b[kk]. B8 replaces _ft_kernel_global_mxu (:758), --encode=mxu: the same
// t_exp from A's and B's plain moment rows (the wrapper's _tile_moments),
// staged beside each chunk — the (aug_a, aug_b) corner of the TPU's
// augmented dot. At each check (every `check_every` steps and after the
// last) the tile's accumulator is summed to one scalar, res = t_exp -
// sum(acc), and an EVENT is counted when |res - prev| exceeds the
// threshold, prev = res: several faults in one check interval count once.
// Nothing is corrected, so unc = det, as in the reference.
//
// What bounds them on an H100: the FP32 FFMA rate at ft_sgemm's sizes, as
// B1. B4 adds per chunk KS * (BM + BN) adds for the column sums, one extra
// barrier, and KS FMAs per thread for t_exp (every thread keeps its own
// identical copy, so no broadcast is needed); B8 only the KS FMAs and two
// rows of KS floats copied by cp.async. Each check is one block-wide sum.
//
// What the design does about it: the mainloop is B1's (gemm_mainloop.cuh);
// t_exp and prev live in registers, replicated across threads, which sum
// the same values in the same order and so agree bitwise; the tile sum is
// one shuffle pass and one shared-memory pass (tile_sum).

#include <type_traits>

#include "abft_common.cuh"

namespace ftsg {

template <class L, bool MXU>
__global__ void __launch_bounds__(L::NT, L::MIN_CTAS) ft_global_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ MA,
    const float* __restrict__ MB, float* __restrict__ out,
    int* __restrict__ det, int* __restrict__ unc, int N, int K, int bk,
    int check_every, float alpha, float beta, Scalars sc) {
  using Enc = Encoder<L, 1, true>;
  using Rows = MomentStage<L, 1, 1>;
  __shared__ Stage<L> st;
  __shared__ float scratch[L::NWARPS];
  __shared__ typename std::conditional<MXU, typename Rows::Smem,
                                       typename Enc::Smem>::type es;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * L::BM, n0 = tj * L::BN;
  const int nk = K / bk;
  Mainloop<L> ml(A, B, K, m0, n0);
  float t_exp = 0.f, prev = 0.f;
  int n_det = 0;
  auto begin = [&](int s) { inject(ml, sc, s, ti, tj); };
  auto chunk = [&](int buf) {
    const float* sa;
    const float* sb;
    if constexpr (MXU) {
      sa = es.ma[buf][0];
      sb = es.mb[buf][0];
    } else {
      Enc::sums(st, buf, es);
      sa = es.sa[0];
      sb = es.sb;
    }
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) t_exp = fmaf(sa[kk], sb[kk], t_exp);
  };
  auto end = [&](int s) {
    if (!((s + 1) % check_every == 0 || s == nk - 1)) return;
    // Fault EVENTS, not failed checks: an uncorrected fault keeps the
    // residual high, so only a move of the residual counts.
    const float res = t_exp - tile_sum(ml, scratch);
    n_det += fabsf(res - prev) > sc.s[SLOT_THRESHOLD] ? 1 : 0;
    prev = res;
  };
  if constexpr (MXU)
    k_loop(ml, st, nk, bk / L::KS, begin, chunk, end,
           Rows(es, MA, MB, K, ti, tj));
  else
    k_loop(ml, st, nk, bk / L::KS, begin, chunk, end);
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_det;
    unc[ti * gridDim.x + tj] = n_det;  // detect only: nothing is corrected
  }
}

template <bool MXU>
int launch(const float* A, const float* B, const float* C, const float* MA,
           const float* MB, float* out, int* det, int* unc, int M, int N,
           int K, int bm, int bn, int ks, int mr, int nr, int bk,
           int check_every, float alpha, float beta, const float* scalars,
           void* stream) {
  Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                                  \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_) {        \
    using L = Layout<BM_, BN_, KS_, TM_, TN_>;                                \
    ft_global_kernel<L, MXU>                                                  \
        <<<dim3(N / BN_, M / BM_), L::NT, 0, (cudaStream_t)stream>>>(         \
            A, B, C, MA, MB, out, det, unc, N, K, bk, check_every, alpha,     \
            beta, sc);                                                        \
    return (int)cudaGetLastError();                                           \
  }
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftsg

// B4. `scalars` is a host array of 8 floats (contracts.SCALAR_SLOTS).
// Returns cudaGetLastError() (cudaErrorInvalidValue when no layout
// matches).
extern "C" int ftsg_ft_global(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int ks, int mr, int nr,
                              int bk, int check_every, float alpha,
                              float beta, const float* scalars, void* stream) {
  return ftsg::launch<false>(A, B, C, nullptr, nullptr, out, det, unc, M, N,
                             K, bm, bn, ks, mr, nr, bk, check_every, alpha,
                             beta, scalars, stream);
}

// B8: `MA` (M / bm, 1, K) and `MB` (N / bn, 1, K) are A's and B's plain
// moment rows.
extern "C" int ftsg_ft_global_mxu(const float* A, const float* B,
                                  const float* C, const float* MA,
                                  const float* MB, float* out, int* det,
                                  int* unc, int M, int N, int K, int bm,
                                  int bn, int ks, int mr, int nr, int bk,
                                  int check_every, float alpha, float beta,
                                  const float* scalars, void* stream) {
  return ftsg::launch<true>(A, B, C, MA, MB, out, det, unc, M, N, K, bm, bn,
                            ks, mr, nr, bk, check_every, alpha, beta, scalars,
                            stream);
}

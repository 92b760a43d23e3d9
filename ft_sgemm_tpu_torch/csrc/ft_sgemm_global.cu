// Kernels B4 and B8: fused-ABFT SGEMM, global strategy (one scalar checksum
// per tile, detect only; --strategy=global).
//
// B4 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_global (:832;
// pallas_call at ops/ft_sgemm.py:1468), --encode=vpu. B8 replaces
// _ft_kernel_global_mxu (:758), --encode=mxu. Each tile's expected total
// t_exp = sum_k s_a[k] * s_b[k] (s_a, s_b: the plain column sums of the
// tile's A rows and B rows). At each check (every `check_every` steps and
// after the last) res = t_exp - sum(acc) over the tile, and an EVENT is
// counted when |res - prev| exceeds the threshold, prev = res: several
// faults in one check interval count once. Nothing is corrected, so unc =
// det, as in the reference.
//
// B4 is ft_sgemm_running.cuh's sub-tiled kernel with the global check
// (GlobalCheck): 3xTF32 on wgmma, one 128 x 128 CTA over the paper's
// (bm, bn) tile as sub-tiles, at every tile. Its t_exp is the sum, over a
// sub-tile's rows, of the expected row sums that the product's 8 extra
// columns give (A times B's column-band sums, formed by the producer's
// splitter warps). What bounds it on an H100: three TF32 tensor-core
// products per multiply-add for 2 M N K plus the extra columns (2 M K N /
// bn), at 495 TFLOP/s; each of the ~20 checks per run stalls the CTA's
// pipeline for one butterfly per column band and one consumer barrier.
// What the design does about it: the expected sums ride the product on
// the tensor cores, with its precision; the residual is one sum of each
// thread's (expected - accumulated) share, and the per-warp partials are
// double-buffered by check parity so that a check needs one barrier.
//
// B8 takes t_exp from A's and B's plain moment rows (the wrapper's
// _tile_moments), staged beside each chunk — the (aug_a, aug_b) corner of
// the TPU's augmented dot — on the FFMA mainloop (gemm_mainloop.cuh). What
// bounds it on an H100: the FP32 FFMA rate, as B1's FFMA tiles, plus KS
// FMAs per thread and chunk for t_exp (every thread keeps its own identical
// copy, so no broadcast is needed) and two rows of KS floats copied by
// cp.async; each check is one block-wide sum (tile_sum). t_exp and prev
// live in registers, replicated across threads, which sum the same values
// in the same order and so agree bitwise.

#include "abft_common.cuh"
#include "ft_sgemm_running.cuh"

namespace ftsg {

template <class L>
__global__ void __launch_bounds__(L::NT, L::MIN_CTAS) ft_global_mxu_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ MA,
    const float* __restrict__ MB, float* __restrict__ out,
    int* __restrict__ det, int* __restrict__ unc, int N, int K, int bk,
    int check_every, float alpha, float beta, Scalars sc) {
  using Rows = MomentStage<L, 1, 1>;
  __shared__ Stage<L> st;
  __shared__ float scratch[L::NWARPS];
  __shared__ typename Rows::Smem es;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * L::BM, n0 = tj * L::BN;
  const int nk = K / bk;
  Mainloop<L> ml(A, B, K, m0, n0);
  float t_exp = 0.f, prev = 0.f;
  int n_det = 0;
  auto begin = [&](int s) { inject(ml, sc, s, ti, tj); };
  auto chunk = [&](int buf) {
    const float* sa = es.ma[buf][0];
    const float* sb = es.mb[buf][0];
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
  k_loop(ml, st, nk, bk / L::KS, begin, chunk, end,
         Rows(es, MA, MB, K, ti, tj));
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_det;
    unc[ti * gridDim.x + tj] = n_det;  // detect only: nothing is corrected
  }
}

}  // namespace ftsg

// B4. `scalars` is a host array of 8 floats (contracts.SCALAR_SLOTS); ks,
// mr, nr are not read. Returns cudaGetLastError() (cudaErrorInvalidValue
// when no sub-tile matches or a tensor map cannot be encoded).
extern "C" int ftsg_ft_global(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int ks, int mr, int nr,
                              int bk, int check_every, float alpha,
                              float beta, const float* scalars, void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf>(
      A, B, C, nullptr, out, det, unc, M, N, K, bm, bn, bk, check_every,
      alpha, beta, scalars, (cudaStream_t)stream);
}

// B8: `MA` (M / bm, 1, K) and `MB` (N / bn, 1, K) are A's and B's plain
// moment rows. Returns cudaGetLastError() (cudaErrorInvalidValue when no
// layout matches).
extern "C" int ftsg_ft_global_mxu(const float* A, const float* B,
                                  const float* C, const float* MA,
                                  const float* MB, float* out, int* det,
                                  int* unc, int M, int N, int K, int bm,
                                  int bn, int ks, int mr, int nr, int bk,
                                  int check_every, float alpha, float beta,
                                  const float* scalars, void* stream) {
  ftsg::Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                                  \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_) {        \
    using L = ftsg::Layout<BM_, BN_, KS_, TM_, TN_>;                          \
    ftsg::ft_global_mxu_kernel<L>                                             \
        <<<dim3(N / BN_, M / BM_), L::NT, 0, (cudaStream_t)stream>>>(         \
            A, B, C, MA, MB, out, det, unc, N, K, bk, check_every, alpha,     \
            beta, sc);                                                        \
    return (int)cudaGetLastError();                                           \
  }
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Kernels B6 and B7: fused-ABFT SGEMM whose expected checksums come from
// the operands' checksum-moment rows (--encode=mxu).
//
// B6 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_fused (:1077;
// pallas_call at ops/ft_sgemm.py:1468), which runs --strategy=fused and
// --strategy=weighted --encode=mxu: A's moment rows 1, w, w^2 (w = row + 1)
// give the expected column moments E = B_tile . M^T, then B5's weighted
// check at any cadence. B6 is ft_sgemm_running.cuh's kernel with its moment
// rows loaded by TMA (kLoadRows): 3xTF32 on wgmma, one 128 x 128 CTA over
// the paper's (bm, bn) sub-tiles, at every tile.
// B7 replaces _ft_kernel_rowcol_mxu (:648), --strategy=rowcol --encode=mxu:
// A's plain and w rows and B's plain row give r += sum_kk A[t, kk] *
// Mb[kk] and c[0..1] += sum_kk B[t, kk] * Ma[0..1][kk], then B3's rowcol
// check (rowcol_detect_correct). c[1] (cw_exp) is always accumulated and
// read only in multifault mode MF.
// On the TPU the moment rows were appended to the operand blocks so that
// one MXU dot gave the product and the expectations. Here the wrapper
// computes them with torch ops (ops/ft_sgemm._tile_moments) as a separate
// (g, R, K) operand — A and B are never copied — and the kernels stage
// each chunk's rows beside the operand chunk (B7: MomentStage; B6: one more
// TMA box per stage).
//
// What bounds B7 on an H100: the FP32 FFMA rate at ft_sgemm's sizes, as
// B1's FFMA tiles. Against B3, the staged rows remove the per-chunk column
// sums of A and B and the barrier that separates them from the update
// (Encoder::sums); what stays per chunk is the update, 2 FMAs per owned
// column and one per owned row per chunk column, and the cp.async of 3
// rows of KS floats. Each check is B3's shuffle-and-shared-memory
// reductions of the accumulator.
//
// What the design does about it: the mainloop is B1's FFMA one
// (gemm_mainloop.cuh), the rows ride the mainloop's own double buffer and
// barrier, and the expected sums stay in registers of the thread that owns
// the row / column.

#include "abft_common.cuh"
#include "ft_sgemm_running.cuh"

namespace ftsg {

template <class L, bool MF>
__global__ void __launch_bounds__(L::NT, L::MIN_CTAS) ft_rowcol_mxu_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ MA,
    const float* __restrict__ MB, float* __restrict__ out,
    int* __restrict__ det, int* __restrict__ unc, int N, int K, int bk,
    int check_every, float alpha, float beta, Scalars sc) {
  using Rows = MomentStage<L, 2, 1>;
  __shared__ Stage<L> st;
  __shared__ RowcolSmem<L> rcs;
  __shared__ typename Rows::Smem rs;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * L::BM, n0 = tj * L::BN;
  const int nk = K / bk;
  Mainloop<L> ml(A, B, K, m0, n0);
  Encoder<L, 2, true> enc;
  int n_det = 0, n_unc = 0;
  k_loop(
      ml, st, nk, bk / L::KS,
      [&](int s) { inject(ml, sc, s, ti, tj); },
      [&](int buf) { enc.update(st, buf, rs.ma[buf], rs.mb[buf][0]); },
      [&](int s) {
        if (!((s + 1) % check_every == 0 || s == nk - 1)) return;
        int hit, bad;
        rowcol_detect_correct<L, MF>(ml, rcs, enc.r, enc.c[0], enc.c[1],
                                     sc.s[SLOT_THRESHOLD], sc.s[SLOT_THR_M1],
                                     hit, bad);
        n_det += hit;
        n_unc = bad;  // LEVEL: the state after the latest check
      },
      Rows(rs, MA, MB, K, ti, tj));
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_det;
    unc[ti * gridDim.x + tj] = n_unc;
  }
}

}  // namespace ftsg

// B6. `MA` is A's (M / bm, 3, K) moment rows; `scalars` a host array of 8
// floats (contracts.SCALAR_SLOTS); ks, mr, nr are not read. Returns
// cudaGetLastError() (cudaErrorInvalidValue when no sub-tile matches or a
// tensor map cannot be encoded).
extern "C" int ftsg_ft_fused(const float* A, const float* B, const float* C,
                             const float* MA, float* out, int* det, int* unc,
                             int M, int N, int K, int bm, int bn, int ks,
                             int mr, int nr, int bk, int check_every,
                             float alpha, float beta, const float* scalars,
                             void* stream) {
  return ftsg::launch_running<ftsg::WeightedOf<ftsg::kLoadRows>::At>(
      A, B, C, MA, out, det, unc, M, N, K, bm, bn, bk, check_every, alpha,
      beta, scalars, (cudaStream_t)stream);
}

// B7. `MA` is A's (M / bm, 2, K) plain and w rows, `MB` B's (N / bn, 1, K)
// plain rows.
extern "C" int ftsg_ft_rowcol_mxu(const float* A, const float* B,
                                  const float* C, const float* MA,
                                  const float* MB, float* out, int* det,
                                  int* unc, int M, int N, int K, int bm,
                                  int bn, int ks, int mr, int nr, int bk,
                                  int check_every, int multifault,
                                  float alpha, float beta,
                                  const float* scalars, void* stream) {
  ftsg::Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
#define FTSG_LAUNCH_MF(MF_)                                                   \
  ftsg::ft_rowcol_mxu_kernel<L, MF_>                                          \
      <<<dim3(N / L::BN, M / L::BM), L::NT, 0, (cudaStream_t)stream>>>(       \
          A, B, C, MA, MB, out, det, unc, N, K, bk, check_every, alpha, beta, \
          sc);
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                                  \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_) {        \
    using L = ftsg::Layout<BM_, BN_, KS_, TM_, TN_>;                          \
    if (multifault) {                                                         \
      FTSG_LAUNCH_MF(true)                                                    \
    } else {                                                                  \
      FTSG_LAUNCH_MF(false)                                                   \
    }                                                                         \
    return (int)cudaGetLastError();                                           \
  }
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
#undef FTSG_LAUNCH_MF
  return (int)cudaErrorInvalidValue;
}

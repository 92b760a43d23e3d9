// Kernels B6 and B7: fused-ABFT SGEMM whose expected checksums come from
// the operands' checksum-moment rows (--encode=mxu).
//
// B6 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_fused (:1077;
// pallas_call at ops/ft_sgemm.py:1468), which runs --strategy=fused and
// --strategy=weighted --encode=mxu: A's moment rows 1, w, w^2 (w = row + 1)
// give the expected column moments E = B_tile . M^T, then B5's weighted
// check at any cadence. B7 replaces _ft_kernel_rowcol_mxu (:648),
// --strategy=rowcol --encode=mxu: A's plain and w rows and B's plain row
// give r += sum_kk A[t, kk] * Mb[kk] and c[0..1] += sum_kk B[t, kk] *
// Ma[0..1][kk], then B3's rowcol check; the w row (cw_exp) is read only in
// multifault mode.
//
// On the TPU the moment rows were appended to the operand blocks so that
// one MXU dot gave the product and the expectations. Here the wrapper
// computes them with torch ops (ops/ft_sgemm._tile_moments) as separate
// (g, rows, K) operands, A and B are never copied, and each kernel is
// ft_sgemm_running.cuh's sub-tiled kernel (3xTF32 on wgmma, one 128 x 128
// CTA over the paper's (bm, bn) tile as sub-tiles, at every tile) with the
// rows loaded by TMA as more boxes of each pipeline stage: B6 is B5's
// kernel with A's 3 moment rows per row band loaded (kLoadRows); B7 is
// B3's (RowcolCheck) with A's plain row (and, with multifault, its w row)
// per row band loaded as the moment rows of the expected column sums
// (kLoadRows, a 3-D box that takes the first 1 or 2 of the wrapper's 2
// rows per band) and B's plain rows of the CTA's column bands loaded as
// B's rows 128 .. 128 + NBN - 1 (kLoadBands), the extra product columns
// that give the expected row sums.
//
// What bounds B7 on an H100: three TF32 tensor-core products per
// multiply-add for the product (2 M N K), the expected row sums (2 M K N /
// bn, the 8 extra product columns) and the expected column sums (2 N K M /
// bm, twice that with multifault), at 495 TFLOP/s, as B3. Against B3 the
// producer's splitter warps no longer sum A's row bands and B's column
// bands; they only split the loaded rows. What stays is B3's check, ~20
// per run at the program's cadence, each on the correction path at
// reference-like injection: it stalls the CTA's pipeline and costs five
// consumer barriers (three when nothing flagged).
//
// What the design does about it: the rows ride the ring's own stages and
// full barrier (their bytes counted exactly, their padding rows zeroed once
// per ring slot), so the producer's only extra work is their hi / lo split;
// both expected sums come out of the tensor cores beside the product, with
// its precision, and the check is B3's (ft_sgemm_rowcol.cu).

#include "ft_sgemm_running.cuh"

// B6. `MA` is A's (M / bm, 3, K) moment rows; `scalars` a host array of 8
// floats (contracts.SCALAR_SLOTS); log2_t, c_rand and
// c_bias the noise model's constants (NoiseModel), read by the adaptive
// build. Returns cudaGetLastError() (cudaErrorInvalidValue when no sub-tile
// matches or a tensor map cannot be encoded).
extern "C" int ftsg_ft_fused(const float* A, const float* B, const float* C,
                             const float* MA, float* out, int* det, int* unc,
                             int M, int N, int K, int bm, int bn, int bk,
                             int check_every, float alpha, float beta,
                             const float* scalars, float log2_t, float c_rand,
                             float c_bias, void* stream) {
  return ftsg::launch_running<ftsg::WeightedOf<ftsg::kLoadRows>::At>(
      A, B, C, MA, nullptr, 3, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      (cudaStream_t)stream);
}

// B7. `MA` is A's (M / bm, 2, K) plain and w rows, `MB` B's (N / bn, 1, K)
// plain rows. Returns as B6.
extern "C" int ftsg_ft_rowcol_mxu(const float* A, const float* B,
                                  const float* C, const float* MA,
                                  const float* MB, float* out, int* det,
                                  int* unc, int M, int N, int K, int bm,
                                  int bn, int bk, int check_every,
                                  int multifault, float alpha, float beta,
                                  const float* scalars, float log2_t,
                                  float c_rand, float c_bias, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::NoiseModel nm{log2_t, c_rand, c_bias};
  if (multifault)
    return ftsg::launch_running<
        ftsg::RowcolOf<true, ftsg::kLoadBands, ftsg::kLoadRows>::At>(
        A, B, C, MA, MB, 2, out, det, unc, M, N, K, bm, bn, bk, check_every,
        alpha, beta, scalars, nm, s);
  return ftsg::launch_running<
      ftsg::RowcolOf<false, ftsg::kLoadBands, ftsg::kLoadRows>::At>(
      A, B, C, MA, MB, 2, out, det, unc, M, N, K, bm, bn, bk, check_every,
      alpha, beta, scalars, nm, s);
}

// Kernel B3: fused-ABFT SGEMM, rowcol strategy (reference parity,
// --strategy=rowcol).
//
// Replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_rowcol (:516; pallas_call
// at ops/ft_sgemm.py:1468). Per K step: fault injection, the product, and
// the checksum encode r_exp += A . s_b and c_exp += B . s_a (plus the
// row-weighted cw_exp in multifault mode MF). After every `check_every`
// steps and after the last: row and column residuals, correction where a
// flagged row meets a flagged column, the multifault weighted localization
// when that intersection is ambiguous, and the re-check after correction
// whose count is a LEVEL. Correction precedes alpha / beta.
//
// B3 is ft_sgemm_running.cuh's sub-tiled kernel with the rowcol check
// (RowcolCheck): 3xTF32 on wgmma, one 128 x 128 CTA over the paper's
// (bm, bn) tile as sub-tiles, at every tile.
//
// What bounds it on an H100: three TF32 tensor-core products per
// multiply-add for the product (2 M N K), for the expected row sums (the
// product's 8 extra columns, A times B's column-band sums: 2 M K N / bn)
// and for the expected column sums (E = B_tile . M^T, 2 N K M / bm, twice
// that with multifault), at 495 TFLOP/s. The producer's splitter warps sum
// A's row bands and B's column bands beside the products. The program
// checks ~20 times per run and, at reference-like injection, finds a fault
// in nearly every sub-tile at every check, so the correction path is the
// common one: each check stalls the CTA's pipeline, reads every
// accumulator element twice and corrects in place, and costs five consumer
// barriers (three when nothing flagged).
//
// What the design does about it: both expected sums come out of the tensor
// cores beside the product, with its precision, and never leave the SM; a
// row's expected sums land in the quad of lanes that holds the row, so the
// row residuals need two quad shuffles; the counts that decide each
// sub-tile's correction (use_col, ambiguous) are shared-memory atomics;
// the column sums are reduce-scattered (28 shuffles for a thread's 32
// columns); the re-check's sums of the correction skip the warps and
// column groups that made none; stages with a check or a fault are issued
// in segments, so that the check's code is inlined once per call site
// (gemm_wgmma.cuh, WgMainloop::mma_stage). A/B copies put the remaining
// cost in the check and the splitter warps' sums (PERF.md).

#include "ft_sgemm_running.cuh"

// `scalars` is a host array of 8 floats
// (contracts.SCALAR_SLOTS); log2_t, c_rand and c_bias the noise model's
// constants (NoiseModel), read by the adaptive build. Returns
// cudaGetLastError() (cudaErrorInvalidValue when no sub-tile matches or a
// tensor map cannot be encoded).
extern "C" int ftsg_ft_rowcol(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int bk, int check_every,
                              int multifault, float alpha, float beta,
                              const float* scalars, float log2_t,
                              float c_rand, float c_bias, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::NoiseModel nm{log2_t, c_rand, c_bias};
  if (multifault)
    return ftsg::launch_running<
        ftsg::RowcolOf<true, ftsg::kSumBands, ftsg::kSumRowGroups>::At>(
        A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
        check_every, alpha, beta, scalars, nm, s);
  return ftsg::launch_running<
      ftsg::RowcolOf<false, ftsg::kSumBands, ftsg::kSumRowGroups>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, nm, s);
}

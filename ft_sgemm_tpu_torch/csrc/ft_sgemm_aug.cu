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
// B3's (RowcolSplitCheck) with A's plain row (and, with multifault, its w
// row) per row band loaded as the moment rows of the expected column sums
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
// bands; they only split the loaded rows (in bf16 they have nothing to
// do). What stayed was B3's check, ~20 per run, each on the correction
// path at reference-like injection: in its single-phase form its body
// cost 0.59-1.40 ms a launch at 4096 and a fault's drain 0.11 ms a run
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 5).
//
// What the design does about it: the rows ride the ring's own stages and
// full barrier (their bytes counted exactly, their padding rows zeroed once
// per ring slot), so the producer's only extra work is their hi / lo split;
// both expected sums come out of the tensor cores beside the product, with
// its precision, and the check is B3's split-phase check
// (ft_sgemm_rowcol.cu): the consumers post and go on, the splitter warps
// decide (in bf16, where they split nothing) or, in f32 at the tiles of at
// most four sub-tiles, the first producer warp between its loads.
//
// bf16 (ftsg_ft_fused_bf16, ftsg_ft_rowcol_mxu_bf16; FTSG_BF16 with
// FTSG_KERNEL 6 and 7, a library each): A and B bf16 on the bf16 mainloop (one m64nNk16 wgmma a
// 16-deep k step). The wrapper's moment rows are bf16 too: each f32 moment
// of the rounded values as three bf16 terms hi, lo and lo2, term-major
// (ops/ft_sgemm._tile_moments; A's (M / bm, 3 n, K), B's (N / bn, 3, K)),
// as the JAX package augments its bf16 blocks (_augment_tiles, n_terms =
// 3). Each stage loads one box per term: A's MOM rows per band of term t
// (a 4-D map, (K, n, 3, M / bm), which takes the first MOM of the n rows)
// into term buffer t as rows MOM b + v, and B's band rows of term t into
// B's rows 128 + 8 t + j, where B5's and B3's splitter warps write their
// own sums; E sums the three terms' products in one accumulator and the
// extra columns BN + 8 t + j add up at the check (WgMainloop::xcol), so
// the checks are B5's and B3's as they are. Nothing is left to split, so
// the consumers wait for TMA's full barrier alone, and the CTA zeroes the
// padding rows once before the ring starts. Bound: 2 M N K at 989 TFLOP/s
// (0.139 ms at 4096) and the expected sums beside it. Their adaptive bf16
// builds (FTSG_ADAPTIVE with FTSG_BF16 and FTSG_KERNEL 6 and 7, a library
// each) are the same kernels with SubTileThresholds<T, true, ..>: each
// consumer thread sums the rounded A and B values of every 8-column half
// step as it issues it (kstep_bf16: A's fragment registers and four bf16
// of B's landed stage, the product rows only, never the term rows at
// 128 + 8 t + j), and each check derives its sub-tiles' thresholds from
// those sums (_accumulate_moments of a_blk[:bm] and the B block,
// ops/ft_sgemm.py:711-712, 1130-1131).

#include "ft_sgemm_running.cuh"

#if !FTSG_BF16

// B6. `MA` is A's (M / bm, 3, K) moment rows; `scalars` a host array of 8
// floats (contracts.SCALAR_SLOTS); log2_t, c_rand and
// c_bias the noise model's constants (NoiseModel), read by the adaptive
// build; bias, act, quant and scale the fused epilogue (abft_common.cuh,
// Epilogue: ops/ft_sgemm.py:1159-1162 for B6, :750-753 for B7, of the JAX
// package), applied in the store after the last check; grid_nm the
// grid order (abft_common.cuh, Variant). Returns
// cudaGetLastError() (cudaErrorInvalidValue when no sub-tile
// matches or a tensor map cannot be encoded).
extern "C" int ftsg_ft_fused(const float* A, const float* B, const float* C,
                             const float* MA, float* out, int* det, int* unc,
                             int M, int N, int K, int bm, int bn, int bk,
                             int check_every, float alpha, float beta,
                             const float* scalars, float log2_t, float c_rand,
                             float c_bias,
                             const float* bias, int act, int quant,
                             float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<ftsg::WeightedOf<ftsg::kLoadRows>::At>(
      A, B, C, MA, nullptr, 3, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
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
                                  float c_rand, float c_bias,
                                  const float* bias, int act, int quant,
                                  float scale, int grid_nm, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::NoiseModel nm{log2_t, c_rand, c_bias};
  if (multifault)
    return ftsg::launch_running<
        ftsg::RowcolOf<true, ftsg::kLoadBands, ftsg::kLoadRows>::At>(
        A, B, C, MA, MB, 2, out, det, unc, M, N, K, bm, bn, bk, check_every,
        alpha, beta, scalars, nm, {bias, act, quant, scale},
        {grid_nm}, s);
  return ftsg::launch_running<
      ftsg::RowcolOf<false, ftsg::kLoadBands, ftsg::kLoadRows>::At>(
      A, B, C, MA, MB, 2, out, det, unc, M, N, K, bm, bn, bk, check_every,
      alpha, beta, scalars, nm, {bias, act, quant, scale},
      {grid_nm}, s);
}
#endif

#if FTSG_BF16 && FTSG_HAS(6)
// B6 with bf16 A and B: `MA` is the three bf16 terms of A's moment rows,
// (M / bm, 9, K) (term t of moment v at row 3 t + v). Returns as B6.
extern "C" int ftsg_ft_fused_bf16(const void* A, const void* B,
                                  const float* C, const void* MA, float* out,
                                  int* det, int* unc, int M, int N, int K,
                                  int bm, int bn, int bk, int check_every,
                                  float alpha, float beta,
                                  const float* scalars, float log2_t,
                                  float c_rand, float c_bias,
                                  const float* bias, int act, int quant,
                                  float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<
      ftsg::WeightedOf<ftsg::kLoadRows, ftsg::kBF16>::At>(
      A, B, C, MA, nullptr, 9, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

#if FTSG_BF16 && FTSG_HAS(7)
// B7 with bf16 A and B: `MA` (M / bm, 6, K) the three bf16 terms of A's
// plain and w rows (term t of moment v at row 2 t + v), `MB` (N / bn, 3, K)
// those of B's plain rows. Returns as B6.
extern "C" int ftsg_ft_rowcol_mxu_bf16(const void* A, const void* B,
                                       const float* C, const void* MA,
                                       const void* MB, float* out, int* det,
                                       int* unc, int M, int N, int K, int bm,
                                       int bn, int bk, int check_every,
                                       int multifault, float alpha,
                                       float beta, const float* scalars,
                                       float log2_t, float c_rand,
                                       float c_bias,
                                       const float* bias, int act, int quant,
                                       float scale, int grid_nm, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::NoiseModel nm{log2_t, c_rand, c_bias};
  if (multifault)
    return ftsg::launch_running<ftsg::RowcolOf<
        true, ftsg::kLoadBands, ftsg::kLoadRows, ftsg::kBF16>::At>(
        A, B, C, MA, MB, 6, out, det, unc, M, N, K, bm, bn, bk, check_every,
        alpha, beta, scalars, nm, {bias, act, quant, scale},
        {grid_nm}, s);
  return ftsg::launch_running<ftsg::RowcolOf<
      false, ftsg::kLoadBands, ftsg::kLoadRows, ftsg::kBF16>::At>(
      A, B, C, MA, MB, 6, out, det, unc, M, N, K, bm, bn, bk, check_every,
      alpha, beta, scalars, nm, {bias, act, quant, scale},
      {grid_nm}, s);
}
#endif

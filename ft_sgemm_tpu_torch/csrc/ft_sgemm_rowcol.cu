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
// (RowcolSplitCheck and RowcolChecker): 3xTF32 on wgmma, one 128 x 128 CTA
// over the paper's (bm, bn) tile as sub-tiles, at every tile.
//
// What bounds it on an H100: three TF32 tensor-core products per
// multiply-add for the product (2 M N K), for the expected row sums (the
// product's 8 extra columns, A times B's column-band sums: 2 M K N / bn)
// and for the expected column sums (E = B_tile . M^T, 2 N K M / bm, twice
// that with multifault), at 495 TFLOP/s. The producer's splitter warps sum
// A's row bands and B's column bands beside the products. The program
// checks ~20 times per run and, at reference-like injection, finds a fault
// in nearly every sub-tile at every check. In the earlier single-phase
// form the check ran on the consumers with five barriers and a correction
// pass over every accumulator element; measured apart on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md, section 5; scripts/torch_variant_time.py)
// its body cost 0.42-1.17 ms a launch at 4096, the splitter sums 0.42-1.00
// ms, a fault's drain 0.02-0.05 ms a run, in every dtype more than the
// tensor cores' bound.
//
// What the design does about it: the check runs in two phases. At a check
// the consumers drain once (the check reads acc at its k step), post their
// rows' residuals and flags, their warps' column sums and E into a slot in
// shared memory, arrive on an mbarrier (one arrival a warp) and go back to
// issuing wgmma: no consumer barrier. A producer warp decides (the column
// residuals and flags, use_col and ambiguous, the multifault localization,
// the adaptive thresholds, the corrections as decisions per sub-tile, the
// re-check from the decisions): the first warp between its TMA loads at
// the tiles of at most four sub-tiles, the splitter warps between their
// stages at the others. Each consumer thread adds the corrections on its
// elements before the next check's post. Faults go into the accumulator
// at stage ends, with no drain. The splitter sums stay (the next redesign
// of B3's, ROADMAP Queue R). ptxas: 168 registers a thread; spills are in
// PERF.md, section 6.
//
// bf16 (ftsg_ft_rowcol_bf16): A and B bf16 on the bf16 mainloop; the
// splitter warps sum B's bands and A's row bands from the landed bf16
// stages in f32 and carry each sum row as three bf16 terms (24 extra
// product columns, three moment-row buffers), so both expected sums keep
// f32 precision; the check is the same. It is a library of its own
// (FTSG_BF16), and so is its adaptive build (FTSG_ADAPTIVE with FTSG_BF16),
// which sums the rounded operands' moments per 8-column half step
// (SubTileThresholds::kstep_bf16).
//
// int8 (ftsg_ft_rowcol_int8, the exact mode: _ft_kernel_rowcol with
// exact=True, :532-534, 567-581, 606-611, 636-640): A and B int8 on the s8
// wgmma mainloop, the accumulator, both expected sums and the check in s32,
// wrapping mod 2^32 as the JAX package's int32 arithmetic does; the
// splitter warps' band sums ride as two s8 digits each (16 extra product
// columns, 16 moment rows); a fault is the rounded magnitude; clean
// residuals are exactly 0, the correction is an exact integer add and the
// re-check has no pads; out = alpha * f32(acc) + beta * C. Multifault is
// illegal for int8 (the weighted ratio of wrapping sums); threshold
// "adaptive" is the half-ulp 0.5 in slots 4-6 of this static build.

#include "ft_sgemm_running.cuh"

// `scalars` is a host array of 8 floats
// (contracts.SCALAR_SLOTS); log2_t, c_rand and c_bias the noise model's
// constants (NoiseModel), read by the adaptive build; bias, act, quant and
// scale the fused epilogue (abft_common.cuh, Epilogue: ops/ft_sgemm.py:632-643
// of the JAX package), applied in the store after the last check;
// grid_nm the grid order (abft_common.cuh, Variant). Returns
// cudaGetLastError() (cudaErrorInvalidValue when no sub-tile matches or a
// tensor map cannot be encoded).
#if !FTSG_BF16
extern "C" int ftsg_ft_rowcol(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int bk, int check_every,
                              int multifault, float alpha, float beta,
                              const float* scalars, float log2_t,
                              float c_rand, float c_bias,
                              const float* bias, int act, int quant,
                              float scale, int grid_nm, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::NoiseModel nm{log2_t, c_rand, c_bias};
  if (multifault)
    return ftsg::launch_running<
        ftsg::RowcolOf<true, ftsg::kSumBands, ftsg::kSumRowGroups>::At>(
        A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
        check_every, alpha, beta, scalars, nm, {bias, act, quant, scale},
        {grid_nm}, s);
  return ftsg::launch_running<
      ftsg::RowcolOf<false, ftsg::kSumBands, ftsg::kSumRowGroups>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, nm, {bias, act, quant, scale},
      {grid_nm}, s);
}
#endif

#if FTSG_BF16
// B3 with bf16 A and B; the rest as ftsg_ft_rowcol.
extern "C" int ftsg_ft_rowcol_bf16(const void* A, const void* B,
                                   const float* C, float* out, int* det,
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
    return ftsg::launch_running<ftsg::RowcolOf<
        true, ftsg::kSumBands, ftsg::kSumRowGroups, ftsg::kBF16>::At>(
        A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
        check_every, alpha, beta, scalars, nm, {bias, act, quant, scale},
        {grid_nm}, s);
  return ftsg::launch_running<ftsg::RowcolOf<
      false, ftsg::kSumBands, ftsg::kSumRowGroups, ftsg::kBF16>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, nm, {bias, act, quant, scale},
      {grid_nm}, s);
}
#endif

#if !FTSG_ADAPTIVE && !FTSG_BF16 && !FTSG_ONE_PASS
// B3 with int8 A and B (rows 16-byte aligned: tensor_map), exact; the rest
// as ftsg_ft_rowcol, `multifault` 0 (else cudaErrorInvalidValue).
extern "C" int ftsg_ft_rowcol_int8(const void* A, const void* B,
                                   const float* C, float* out, int* det,
                                   int* unc, int M, int N, int K, int bm,
                                   int bn, int bk, int check_every,
                                   int multifault, float alpha, float beta,
                                   const float* scalars, float log2_t,
                                   float c_rand, float c_bias,
                                   const float* bias, int act, int quant,
                                   float scale, int grid_nm, void* stream) {
  if (multifault) return (int)cudaErrorInvalidValue;
  return ftsg::launch_running<ftsg::RowcolOf<
      false, ftsg::kSumBands, ftsg::kSumRowGroups, ftsg::kS8>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

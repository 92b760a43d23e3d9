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
// Both are ft_sgemm_running.cuh's sub-tiled kernel with the global check
// (GlobalCheck): 3xTF32 on wgmma, one 128 x 128 CTA over the paper's
// (bm, bn) tile as sub-tiles, at every tile. t_exp is the sum, over a
// sub-tile's rows, of the expected row sums that the product's 8 extra
// columns give: A times B's column-band sums, which is sum_rows A . s_b =
// s_a . s_b, the (aug_a, aug_b) corner of the TPU's augmented dot. B4's
// splitter warps sum B's landed stage over each band (kSumBands); B8 loads
// the wrapper's (N / bn, 1, K) plain rows of B (ops/ft_sgemm._tile_moments)
// by TMA as B's rows 128 .. 128 + NBN - 1 of each stage (kLoadBands), which
// the splitter warps only split. B8's kernel does not read A's plain rows:
// its C entry point keeps the `MA` argument, unread, and the wrapper still
// builds them, for the plain version (ops/ft_sgemm.ft_global_plain) that
// the kernel is held to.
//
// What bounds them on an H100: three TF32 tensor-core products per
// multiply-add for 2 M N K plus the extra columns (2 M K N / bn), at 495
// TFLOP/s; each of the ~20 checks per run stalls the CTA's pipeline for one
// butterfly per column band and one consumer barrier. B4's producer also
// sums B's bands (8-row sums, a named barrier among the splitter warps and
// a second pass per stage), which held it at 2.07-2.37 ms against 1.49-1.66
// without them (PERF.md); B8's producer only splits.
//
// What the design does about it: the expected sums ride the product on
// the tensor cores, with its precision; the residual is one sum of each
// thread's (expected - accumulated) share, and the per-warp partials are
// double-buffered by check parity so that a check needs one barrier; B8's
// band rows ride the ring's stages and full barrier, their padding rows
// zeroed once per ring slot.
//
// bf16 (ftsg_ft_global_bf16, ftsg_ft_global_mxu_bf16; FTSG_BF16, a library
// of their own): A and B bf16 on the bf16 mainloop; B's band sums (f32
// sums of the bf16 values) ride the product as three bf16 terms, 24 extra
// columns: B4's splitter warps form them, B8 loads the wrapper's three
// term rows per band (ops/ft_sgemm._tile_moments) by TMA, one box a term,
// as B's rows 128 + 8 t .., and its consumers wait for TMA alone. B4's
// adaptive build (FTSG_ADAPTIVE with FTSG_BF16, a library of its own) sums
// the rounded operands' moments per 8-column half step
// (SubTileThresholds::kstep_bf16), and so does B8's, in the same library
// (_accumulate_moments of a_blk[:bm] and the B block,
// ops/ft_sgemm.py:801-802; the term rows are not summed).
//
// int8 (ftsg_ft_global_int8, B4 only, the exact mode: _ft_kernel_global with
// exact=True, :842-907): A and B int8 on the s8 wgmma mainloop; B's band
// sums ride the product as two s8 digits (16 extra columns), so t_exp,
// the tile's total and the residual are s32 and wrap as the JAX package's
// int32 t_exp does; threshold "adaptive" is 0.5 in slot 4 of this build.

#include "ft_sgemm_running.cuh"

// B4. `scalars` is a host array of 8 floats
// (contracts.SCALAR_SLOTS); log2_t, c_rand and c_bias the noise model's
// constants (NoiseModel), read by the adaptive build; bias, act, quant and
// scale the fused epilogue (abft_common.cuh, Epilogue: ops/ft_sgemm.py:902-910
// for B4, :822-825 for B8, of the JAX package), applied in the store after
// the last check, which it does not change (B4 and B8 correct nothing, so
// their faults stay in the output and go through the epilogue); grid_nm
// the grid order (abft_common.cuh, Variant). Returns
// cudaGetLastError() (cudaErrorInvalidValue when no sub-tile matches or a
// tensor map cannot be encoded).
#if !FTSG_BF16
extern "C" int ftsg_ft_global(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int bk, int check_every,
                              float alpha, float beta, const float* scalars,
                              float log2_t, float c_rand, float c_bias,
                              const float* bias, int act, int quant,
                              float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf<ftsg::kSumBands>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

#if FTSG_BF16
// B4 with bf16 A and B; the rest as ftsg_ft_global.
extern "C" int ftsg_ft_global_bf16(const void* A, const void* B,
                                   const float* C, float* out, int* det,
                                   int* unc, int M, int N, int K, int bm,
                                   int bn, int bk, int check_every,
                                   float alpha, float beta,
                                   const float* scalars, float log2_t,
                                   float c_rand, float c_bias,
                                   const float* bias, int act, int quant,
                                   float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf<ftsg::kSumBands, ftsg::kBF16>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

#if !FTSG_ADAPTIVE && !FTSG_BF16 && !FTSG_ONE_PASS
// B4 with int8 A and B (rows 16-byte aligned: tensor_map), exact; the rest
// as ftsg_ft_global.
extern "C" int ftsg_ft_global_int8(const void* A, const void* B,
                                   const float* C, float* out, int* det,
                                   int* unc, int M, int N, int K, int bm,
                                   int bn, int bk, int check_every,
                                   float alpha, float beta,
                                   const float* scalars, float log2_t,
                                   float c_rand, float c_bias,
                                   const float* bias, int act, int quant,
                                   float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf<ftsg::kSumBands, ftsg::kS8>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

#if !FTSG_BF16
// B8: `MB` (N / bn, 1, K) is B's plain moment rows; `MA` (M / bm, 1, K),
// A's, is not read. Returns as B4.
extern "C" int ftsg_ft_global_mxu(const float* A, const float* B,
                                  const float* C, const float* MA,
                                  const float* MB, float* out, int* det,
                                  int* unc, int M, int N, int K, int bm,
                                  int bn, int bk, int check_every,
                                  float alpha, float beta,
                                  const float* scalars, float log2_t,
                                  float c_rand, float c_bias,
                                  const float* bias, int act, int quant,
                                  float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf<ftsg::kLoadBands>::At>(
      A, B, C, nullptr, MB, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

#if FTSG_BF16
// B8 with bf16 A and B: `MB` (N / bn, 3, K) is the three bf16 terms of B's
// plain moment rows; `MA` (M / bm, 3, K), A's, is not read. Returns as B4.
extern "C" int ftsg_ft_global_mxu_bf16(const void* A, const void* B,
                                       const float* C, const void* MA,
                                       const void* MB, float* out, int* det,
                                       int* unc, int M, int N, int K, int bm,
                                       int bn, int bk, int check_every,
                                       float alpha, float beta,
                                       const float* scalars, float log2_t,
                                       float c_rand, float c_bias,
                                       const float* bias, int act, int quant,
                                       float scale, int grid_nm, void* stream) {
  return ftsg::launch_running<
      ftsg::GlobalOf<ftsg::kLoadBands, ftsg::kBF16>::At>(
      A, B, C, nullptr, MB, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      {bias, act, quant, scale}, {grid_nm}, (cudaStream_t)stream);
}
#endif

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

#include "ft_sgemm_running.cuh"

// B4. `scalars` is a host array of 8 floats
// (contracts.SCALAR_SLOTS); log2_t, c_rand and c_bias the noise model's
// constants (NoiseModel), read by the adaptive build. Returns
// cudaGetLastError() (cudaErrorInvalidValue when no sub-tile matches or a
// tensor map cannot be encoded).
extern "C" int ftsg_ft_global(const float* A, const float* B, const float* C,
                              float* out, int* det, int* unc, int M, int N,
                              int K, int bm, int bn, int bk, int check_every,
                              float alpha, float beta, const float* scalars,
                              float log2_t, float c_rand, float c_bias,
                              void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf<ftsg::kSumBands>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      (cudaStream_t)stream);
}

// B8: `MB` (N / bn, 1, K) is B's plain moment rows; `MA` (M / bm, 1, K),
// A's, is not read. Returns as B4.
extern "C" int ftsg_ft_global_mxu(const float* A, const float* B,
                                  const float* C, const float* MA,
                                  const float* MB, float* out, int* det,
                                  int* unc, int M, int N, int K, int bm,
                                  int bn, int bk, int check_every,
                                  float alpha, float beta,
                                  const float* scalars, float log2_t,
                                  float c_rand, float c_bias, void* stream) {
  return ftsg::launch_running<ftsg::GlobalOf<ftsg::kLoadBands>::At>(
      A, B, C, nullptr, MB, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, {log2_t, c_rand, c_bias},
      (cudaStream_t)stream);
}

// Kernel B1: plain SGEMM, C_out = alpha * A @ B^T + beta * C.
//
// Replaces ft_sgemm_tpu/ops/sgemm.py::_matmul_kernel (pallas_call at
// ops/sgemm.py:139), the kernel behind ft_sgemm ids 1-6.
//
// What bounds it on an H100: three TF32 tensor-core products per
// multiply-add, 3 * 2 * M * N * K operations at 495 TFLOP/s (0.83 ms at
// 4096, against 2.05 ms for FP32 FFMA at 67 TFLOP/s), and the split pass
// that makes them: per 32-column stage, every element of A and B goes
// through two cvt.rna.tf32 and one subtraction on the CUDA cores. The bytes
// (each of A, B, C read once, the output written once) are below 10 % of
// the bound from K = 1024 up.
//
// What the design does about it: 3xTF32 on wgmma, TMA-fed (gemm_wgmma.cuh).
// The tensor cores take the products (the result keeps FP32 accuracy: the
// a_lo b_lo term dropped is ~2^-22 of each product, and each stage's wgmma
// sum is added into an f32 accumulator, since the tensor cores' truncating
// sum over all of K loses ~11x cuBLAS's accuracy); TMA feeds a four-stage
// ring with no thread spending registers or instructions on the copy; the
// split runs on the CUDA cores beside the products (the producer's warps
// split B as each stage lands, the consumers split stage s + 1's A while
// stage s's wgmmas run).
//
// Two CTAs, by tile: large, tall, huge and test (ids 3, 4, 6) run the
// tile's own CTA. Small, medium and wide (ids 1, 2, 5), whose 16 or 32 rows
// do not fill a 64-row wgmma, run the 128 x 128 CTA of huge: B1 has no
// check, so its result does not depend on the tile, and the paper's tile is
// only the unit the wrapper pads M and N to. Their grid rounds up, TMA
// zero-fills the rows past M and N, and the store masks them (RAGGED); one
// instantiation serves the three tiles.
//
// bf16 (ftsg_sgemm_bf16; ops/sgemm.py:179-181 of the JAX package): A and B
// bf16, C and the accumulator f32, one m64nNk16 bf16 wgmma per 16-deep k
// step on the operands as TMA landed them (no split pass, no splitter
// work), each stage's sum promoted into f32 as above, with the same two
// CTAs. What bounds it: 2 M N K operations at 989 TFLOP/s (0.139 ms at
// 4096) against ~201 MB (A and B in bf16, C read and written in f32) at
// 3.35 TB/s (0.060 ms): operations.
//
// fp8 (ftsg_sgemm_fp8, the fp8 serving mode; built alone, with FTSG_FP8,
// into a library of its own): A and B e4m3, C and the accumulator f32, one
// m64nNk32 e4m3 wgmma per 32-deep k step on the operands as TMA landed them
// (rows 16 bytes apart), each k step's sum promoted into f32 (the tensor
// cores keep ~13 bits below the largest product of an e4m3 k step; promoted
// once per 128-column stage, B1 had 2.9x the error, PERF.md), with the same
// two CTAs. What bounds it: 2 M N K operations at 1979 TFLOP/s (0.069 ms at
// 4096) against ~168 MB (A and B one byte an element, C read and written
// in f32) at 3.35 TB/s (0.050 ms): operations.

// The fused epilogue (ops/sgemm.py:98-101 of the JAX package: bias, relu or
// gelu, int8 or e4m3 quantize-rescale; abft_common.cuh, Epilogue) is applied
// by the store (WgMainloop::store): each thread reads back the tile elements
// it has just written, from L2, and writes them again through the epilogue,
// with no barrier and no pass over C in HBM. It adds ~14 FP32 operations an
// element with gelu (tanhf as one) and the bias row's N floats of bytes,
// under 1 % of the bound at 4096, but measured +0.07-0.14 ms a launch there
// on an H100 (B1 bf16 0.286 -> 0.356 ms, fp8 0.227 -> 0.324): more than a
// separate pass over C in HBM would take (PERF.md, section 6).

#include "gemm_wgmma.cuh"

// FTSG_FP8=1 compiles ftsg_sgemm_fp8 alone, into a library of its own
// (ops/_build.LIBRARIES), which builds beside the others and leaves every
// other build as it was.
#ifndef FTSG_FP8
#define FTSG_FP8 0
#endif

FTSG_NAMESPACE_BEGIN

template <class T, bool RAGGED>
__global__ void __launch_bounds__(T::NT, T::MIN_CTAS) sgemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ C,
    float* __restrict__ out, int M, int N, int K, float alpha, float beta,
    Epilogue epi, Variant v) {
  const WgSmem<T> sm;
  const int m0 = v.tile_m() * T::BM, n0 = v.tile_n() * T::BN;
  const int nst = (K + T::SK - 1) / T::SK;
  sm.init();
  if (threadIdx.x >= T::NCONS) {  // the producer warpgroup
    setmaxnreg_dec<T::REGS_PRODUCER>();
    sm.produce(&ta, &tb, m0, n0, nst);
    return;
  }
  setmaxnreg_inc<T::REGS_CONSUMER>();
  WgMainloop<T> ml(sm);
  NoInject none;
  ml.run(nst, none);
  ml.template store<RAGGED>(out, C, N, m0, n0, alpha, beta, epi, M);
}

template <class T, bool RAGGED>
int launch_wgmma(const void* A, const void* B, const float* C, float* out,
                 int M, int N, int K, float alpha, float beta,
                 const Epilogue& epi, const Variant& v, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!epi.valid() || !v.valid()) return (int)cudaErrorInvalidValue;
  const auto kernel = sgemm_wgmma_kernel<T, RAGGED>;
  if (const int rc = wgmma_setup<T>(kernel, &ta, &tb, A, B, M, N, K))
    return rc;
  kernel<<<v.grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN), T::NT,
           T::SMEM, stream>>>(ta, tb, C, out, M, N, K, alpha, beta, epi, v);
  return (int)cudaGetLastError();
}

FTSG_NAMESPACE_END  // ftsg

#if FTSG_FP8
// B1 with e4m3 A and B (C and out f32; rows 16 bytes apart: tensor_map), at
// the same tiles and CTAs; returns as ftsg_sgemm.
extern "C" int ftsg_sgemm_fp8(const void* A, const void* B, const float* C,
                              float* out, int M, int N, int K, int bm, int bn,
                              int bk, float alpha, float beta,
                              const float* bias, int act, int quant,
                              float scale, int grid_nm, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::Epilogue epi{bias, act, quant, scale};
  const ftsg::Variant v{grid_nm};
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTileOf<BM_, BN_, ftsg::kE4M3>, false>( \
        A, B, C, out, M, N, K, alpha, beta, epi, v, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
  if (ftsg::narrow_tile(bm, bn))
    return ftsg::launch_wgmma<ftsg::WgTileOf<128, 128, ftsg::kE4M3>, true>(
        A, B, C, out, M, N, K, alpha, beta, epi, v, s);
  return (int)cudaErrorInvalidValue;
}
#else
// Launch on `stream` for one compiled tile (bk is not read), with the fused
// epilogue (bias row or null, activation and quantize codes, quantize
// scale: abft_common.cuh, Epilogue) applied to the output, and the grid
// order (grid_nm 1: "nm"; abft_common.cuh, Variant); returns
// cudaGetLastError() (cudaErrorInvalidValue when no tile matches or the
// epilogue's codes are unknown).
extern "C" int ftsg_sgemm(const float* A, const float* B, const float* C,
                          float* out, int M, int N, int K, int bm, int bn,
                          int bk, float alpha, float beta, const float* bias,
                          int act, int quant, float scale, int grid_nm,
                          void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::Epilogue epi{bias, act, quant, scale};
  const ftsg::Variant v{grid_nm};
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTile<BM_, BN_>, false>(              \
        A, B, C, out, M, N, K, alpha, beta, epi, v, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
  if (ftsg::narrow_tile(bm, bn))
    return ftsg::launch_wgmma<ftsg::WgTile<128, 128>, true>(
        A, B, C, out, M, N, K, alpha, beta, epi, v, s);
  return (int)cudaErrorInvalidValue;
}

#if !FTSG_ONE_PASS
// B1 with bf16 A and B (C and out f32), at the same tiles and CTAs; returns
// as ftsg_sgemm.
extern "C" int ftsg_sgemm_bf16(const void* A, const void* B, const float* C,
                               float* out, int M, int N, int K, int bm,
                               int bn, int bk, float alpha, float beta,
                               const float* bias, int act, int quant,
                               float scale, int grid_nm, void* stream) {
  const auto s = (cudaStream_t)stream;
  const ftsg::Epilogue epi{bias, act, quant, scale};
  const ftsg::Variant v{grid_nm};
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTileOf<BM_, BN_, ftsg::kBF16>, false>( \
        A, B, C, out, M, N, K, alpha, beta, epi, v, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
  if (ftsg::narrow_tile(bm, bn))
    return ftsg::launch_wgmma<ftsg::WgTileOf<128, 128, ftsg::kBF16>, true>(
        A, B, C, out, M, N, K, alpha, beta, epi, v, s);
  return (int)cudaErrorInvalidValue;
}
#endif  // !FTSG_ONE_PASS
#endif

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

#include "gemm_wgmma.cuh"

FTSG_NAMESPACE_BEGIN

template <class T, bool RAGGED>
__global__ void __launch_bounds__(T::NT, T::MIN_CTAS) sgemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ C,
    float* __restrict__ out, int M, int N, int K, float alpha, float beta) {
  const WgSmem<T> sm;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
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
  ml.template store<RAGGED>(out, C, N, m0, n0, alpha, beta, M);
}

template <class T, bool RAGGED>
int launch_wgmma(const float* A, const float* B, const float* C, float* out,
                 int M, int N, int K, float alpha, float beta,
                 cudaStream_t stream) {
  CUtensorMap ta, tb;
  const auto kernel = sgemm_wgmma_kernel<T, RAGGED>;
  if (const int rc = wgmma_setup<T>(kernel, &ta, &tb, A, B, M, N, K))
    return rc;
  kernel<<<dim3((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM), T::NT,
           T::SMEM, stream>>>(ta, tb, C, out, M, N, K, alpha, beta);
  return (int)cudaGetLastError();
}

FTSG_NAMESPACE_END  // ftsg

// Launch on `stream` for one compiled tile (bk is not read); returns
// cudaGetLastError() (cudaErrorInvalidValue when no tile matches).
extern "C" int ftsg_sgemm(const float* A, const float* B, const float* C,
                          float* out, int M, int N, int K, int bm, int bn,
                          int bk, float alpha, float beta, void* stream) {
  const auto s = (cudaStream_t)stream;
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTile<BM_, BN_>, false>(              \
        A, B, C, out, M, N, K, alpha, beta, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
  if (ftsg::narrow_tile(bm, bn))
    return ftsg::launch_wgmma<ftsg::WgTile<128, 128>, true>(
        A, B, C, out, M, N, K, alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}

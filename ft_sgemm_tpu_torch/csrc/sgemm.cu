// Kernel B1: plain SGEMM, C_out = alpha * A @ B^T + beta * C.
//
// Replaces ft_sgemm_tpu/ops/sgemm.py::_matmul_kernel (pallas_call at
// ops/sgemm.py:139), the kernel behind ft_sgemm ids 1-6.
//
// Two mainloops, by tile:
//
// - large, tall, huge and test (ids 3, 4, 6): 3xTF32 on wgmma, TMA-fed
//   (gemm_wgmma.cuh). What bounds it on an H100: three TF32 tensor-core
//   products per multiply-add, 3 * 2 * M * N * K operations at 495 TFLOP/s
//   (0.83 ms at 4096, against 2.05 ms for FP32 FFMA at 67 TFLOP/s), and the
//   split pass that makes them: per 32-column stage, every element of A and
//   B goes through two cvt.rna.tf32 and one subtraction on the CUDA cores.
//   What the design does about it: the tensor cores take the products (the
//   result keeps FP32 accuracy: the a_lo b_lo term dropped is ~2^-22 of each
//   product, and each stage's wgmma sum is added into an f32 accumulator,
//   since the tensor cores' truncating sum over all of K loses ~11x cuBLAS's
//   accuracy); TMA feeds a four-stage ring with no thread spending registers
//   or instructions on the copy; the split runs on the CUDA cores beside the
//   products (the producer's warps split B as each stage lands, the consumers
//   split stage s + 1's A while stage s's wgmmas run).
// - small, medium, wide (ids 1, 2, 5), whose 16 or 32 tile rows do not fill
//   a 64-row wgmma: the register-tiled FP32 FFMA loop of gemm_mainloop.cuh,
//   bound by the 2 * M * N * K FFMAs at 67 TFLOP/s. Each thread holds a TM x
//   TN accumulator, so one k step reads TM + TN operands from shared memory
//   for TM * TN FFMAs, through a two-buffer stage loaded from global memory
//   while the current one is multiplied.
//
// The bytes (each of A, B, C read once, the output written once) are below
// 10 % of either bound from K = 1024 up.

#include "gemm_mainloop.cuh"
#include "gemm_wgmma.cuh"

namespace ftsg {

template <class L>
__global__ void __launch_bounds__(L::NT)
    sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ out, int N,
                 int K, int bk, float alpha, float beta) {
  __shared__ Stage<L> st;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  Mainloop<L> ml(A, B, K, m0, n0);
  auto none = [](int) {};
  k_loop(ml, st, K / bk, bk / L::KS, none, none);
  ml.store(out, C, N, m0, n0, alpha, beta);
}

template <class T>
__global__ void __launch_bounds__(T::NT, T::MIN_CTAS) sgemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ C,
    float* __restrict__ out, int N, int K, float alpha, float beta) {
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
  ml.store(out, C, N, m0, n0, alpha, beta);
}

template <class L>
int launch_ffma(const float* A, const float* B, const float* C, float* out,
                int M, int N, int K, int bk, float alpha, float beta,
                cudaStream_t stream) {
  if constexpr (wgmma_tile<L::BM, L::BN>()) {
    return (int)cudaErrorInvalidValue;  // these tiles run sgemm_wgmma_kernel
  } else {
    sgemm_kernel<L><<<dim3(N / L::BN, M / L::BM), L::NT, 0, stream>>>(
        A, B, C, out, N, K, bk, alpha, beta);
    return (int)cudaGetLastError();
  }
}

template <class T>
int launch_wgmma(const float* A, const float* B, const float* C, float* out,
                 int M, int N, int K, float alpha, float beta,
                 cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (const int rc = wgmma_setup<T>(sgemm_wgmma_kernel<T>, &ta, &tb, A, B, M,
                                    N, K))
    return rc;
  sgemm_wgmma_kernel<T><<<dim3(N / T::BN, M / T::BM), T::NT, T::SMEM,
                          stream>>>(ta, tb, C, out, N, K, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace ftsg

// Launch on `stream` for one compiled tile; returns cudaGetLastError()
// (cudaErrorInvalidValue when no layout matches).
extern "C" int ftsg_sgemm(const float* A, const float* B, const float* C,
                          float* out, int M, int N, int K, int bm, int bn,
                          int ks, int mr, int nr, int bk, float alpha,
                          float beta, void* stream) {
  const auto s = (cudaStream_t)stream;
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                     \
  if (bm == BM_ && bn == BN_)                                           \
    return ftsg::launch_wgmma<ftsg::WgTile<BM_, BN_>>(A, B, C, out, M, N, \
                                                      K, alpha, beta, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                               \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_)       \
    return ftsg::launch_ffma<ftsg::Layout<BM_, BN_, KS_, TM_, TN_>>(       \
        A, B, C, out, M, N, K, bk, alpha, beta, s);
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

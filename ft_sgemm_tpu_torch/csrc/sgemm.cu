// Kernel B1: plain SGEMM, C_out = alpha * A @ B^T + beta * C.
//
// Replaces ft_sgemm_tpu/ops/sgemm.py::_matmul_kernel (pallas_call at
// ops/sgemm.py:139), the kernel behind ft_sgemm ids 1-6.
//
// What bounds it on an H100: at ft_sgemm's sizes (M = N = K >= 1024) the
// 2*M*N*K FP32 FFMAs against the 67 TFLOP/s non-tensor-core FP32 peak; the
// bytes (each of A, B, C read once, the output written once) are below 5 %
// of that time from K = 1024 up. Only at small K do the bytes bound it.
//
// What the design does about it: the result must stay FP32-accurate, so the
// products are FFMA in registers, not TF32 tensor-core MMAs. Each thread
// holds a TM x TN accumulator (8 x 8 for the huge tile), so one K step
// reads TM + TN operands from shared memory for TM * TN FFMAs; A and B pass
// through a two-buffer shared-memory stage whose next chunk is loaded from
// global memory (float4 per thread) while the current one is multiplied
// (gemm_mainloop.cuh). wgmma with 3xTF32 splitting and TMA feeds are left to
// later work.

#include "gemm_mainloop.cuh"

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
  k_loop(ml, st, K / bk, bk / L::KS, none, none, none);
  ml.store(out, C, N, m0, n0, alpha, beta);
}

}  // namespace ftsg

// Launch on `stream` for one compiled layout; returns cudaGetLastError()
// (cudaErrorInvalidValue when no layout matches).
extern "C" int ftsg_sgemm(const float* A, const float* B, const float* C,
                          float* out, int M, int N, int K, int bm, int bn,
                          int ks, int mr, int nr, int bk, float alpha,
                          float beta, void* stream) {
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                                \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_) {      \
    using L = ftsg::Layout<BM_, BN_, KS_, TM_, TN_>;                        \
    ftsg::sgemm_kernel<L><<<dim3(N / BN_, M / BM_), L::NT, 0,               \
                            (cudaStream_t)stream>>>(A, B, C, out, N, K, bk, \
                                                    alpha, beta);           \
    return (int)cudaGetLastError();                                         \
  }
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

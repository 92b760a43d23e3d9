// Kernels B2 and B5: fused-ABFT SGEMM, weighted strategy.
//
// B2 replaces ft_sgemm_tpu/ops/ft_sgemm.py::_ft_kernel_weighted_precomp
// (pallas_call at ops/ft_sgemm.py:1468), what ft_sgemm ids 11-16 run by
// default: expected column moments precomputed outside the kernel
// (ops/ft_sgemm.py::_expected_col_checksums, one fp32 torch.matmul), one
// detect / correct at the last K step.
// B5 replaces _ft_kernel_weighted (ops/ft_sgemm.py:917), the same check
// with the three expected moments encoded inside the kernel as running
// sums, for cadences with intermediate checks. The port's small tile is
// 16 columns wide, narrower than the ~20 faults of the reference-like
// schedule, so the injection clamp gives it intermediate checks and id 11
// runs this body on ft_sgemm's main path.
//
// Both add, per step, the fault injection of abft_common.cuh::inject, and
// at each check the three column moments (weights 1, w, w^2 with w = row
// + 1) of the register accumulator, per-column localization by the
// weighted-residual ratio, the correction, and the three-moment re-check
// (moment_detect_correct). Correction precedes alpha / beta.
//
// What bounds them on an H100: as B1, the FP32 FFMA rate at ft_sgemm's
// sizes. B2 adds a per-tile check costing about 6 * BM * BN operations,
// once per run. B5 adds, per K chunk, the A-side moment sums (~6 * KS * BM
// operations) and the expected-moment update (6 * KS * BN), against the
// chunk's KS * BM * BN FFMAs: 9 % at the huge tile, 19-38 % at the others
// (75 % at 16 x 16), plus one extra barrier per chunk, whose latency costs
// more than the operations (PERF.md).
//
// What the design does about it: the mainloop is B1's register-tiled FFMA
// loop unchanged (gemm_mainloop.cuh), B2's check runs after it; the
// moments are reduced with warp shuffles and one shared-memory pass, and
// only at checks.

#include <type_traits>

#include "abft_common.cuh"

namespace ftsg {

struct NoSmem {};

template <class L, bool RUNNING>
__global__ void __launch_bounds__(L::NT, L::MIN_CTAS) ft_weighted_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ expm,
    float* __restrict__ out, int* __restrict__ det, int* __restrict__ unc,
    int N, int K, int bk, int check_every, float alpha, float beta,
    Scalars sc) {
  using Enc = Encoder<L, 3, false>;
  __shared__ Stage<L> st;
  __shared__ MomentSmem<L> ms;
  __shared__ typename std::conditional<RUNNING, typename Enc::Smem, NoSmem>::type es;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * L::BM, n0 = tj * L::BN;
  const int nk = K / bk;
  Mainloop<L> ml(A, B, K, m0, n0);
  Enc enc;
  int n_det = 0, n_unc = 0;
  auto check = [&]() {
    float ec = 0.f, ecw = 0.f, ecw2 = 0.f;
    const int t = threadIdx.x;
    if (t < L::BN) {
      if constexpr (RUNNING) {
        ec = enc.c[0];
        ecw = enc.c[1];
        ecw2 = enc.c[2];
      } else {
        // expm is (M / BM, 3, N): rows 1, w, w^2 of row tile ti.
        const float* e = expm + (size_t)ti * 3 * N + n0 + t;
        ec = e[0];
        ecw = e[N];
        ecw2 = e[2 * (size_t)N];
      }
    }
    int hit, bad;
    moment_detect_correct(ml, ms, ec, ecw, ecw2, sc.s[SLOT_THRESHOLD],
                          sc.s[SLOT_THR_M1], sc.s[SLOT_THR_M2], hit, bad);
    n_det += hit;
    n_unc = bad;  // LEVEL: the state after the latest check
  };
  k_loop(
      ml, st, nk, bk / L::KS,
      [&](int s) { inject(ml, sc, s, ti, tj); },
      [&](int buf) {
        if constexpr (RUNNING) enc.chunk(st, buf, es);
      },
      [&](int s) {
        if (RUNNING && ((s + 1) % check_every == 0 || s == nk - 1)) check();
      });
  // B2's single check runs after the K loop, outside its code.
  if constexpr (!RUNNING) check();
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_det;
    unc[ti * gridDim.x + tj] = n_unc;
  }
}

template <bool RUNNING>
int launch(const float* A, const float* B, const float* C, const float* expm,
           float* out, int* det, int* unc, int M, int N, int K, int bm,
           int bn, int ks, int mr, int nr, int bk, int check_every,
           float alpha, float beta, const float* scalars, void* stream) {
  Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                                  \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_) {        \
    using L = Layout<BM_, BN_, KS_, TM_, TN_>;                                \
    ft_weighted_kernel<L, RUNNING>                                            \
        <<<dim3(N / BN_, M / BM_), L::NT, 0, (cudaStream_t)stream>>>(         \
            A, B, C, expm, out, det, unc, N, K, bk, check_every, alpha, beta, \
            sc);                                                              \
    return (int)cudaGetLastError();                                           \
  }
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftsg

// B2. `scalars` is a host array of 8 floats (contracts.SCALAR_SLOTS);
// `expm` the (M / bm, 3, N) expected moments. Returns cudaGetLastError().
extern "C" int ftsg_ft_weighted_precomp(
    const float* A, const float* B, const float* C, const float* expm,
    float* out, int* det, int* unc, int M, int N, int K, int bm, int bn,
    int ks, int mr, int nr, int bk, float alpha, float beta,
    const float* scalars, void* stream) {
  return ftsg::launch<false>(A, B, C, expm, out, det, unc, M, N, K, bm, bn, ks,
                             mr, nr, bk, K / bk, alpha, beta, scalars, stream);
}

// B5: checks after every `check_every` K steps and after the last.
extern "C" int ftsg_ft_weighted_running(
    const float* A, const float* B, const float* C, float* out, int* det,
    int* unc, int M, int N, int K, int bm, int bn, int ks, int mr, int nr,
    int bk, int check_every, float alpha, float beta, const float* scalars,
    void* stream) {
  return ftsg::launch<true>(A, B, C, nullptr, out, det, unc, M, N, K, bm, bn,
                            ks, mr, nr, bk, check_every, alpha, beta, scalars,
                            stream);
}

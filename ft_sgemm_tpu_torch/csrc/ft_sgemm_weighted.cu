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
// runs B5 on ft_sgemm's main path. B5 is ft_sgemm_running.cuh's kernel with
// its moment rows summed from A's stage (kSumRows), at every tile.
//
// B2 adds, per step, the fault injection of abft_common.cuh::inject, and
// at its check the three column moments (weights 1, w, w^2 with w = row
// + 1) of the register accumulator, per-column localization by the
// weighted-residual ratio, the correction, and the three-moment re-check
// (moment_detect_correct). Correction precedes alpha / beta.
//
// What bounds B2 on an H100: as B1, by tile. At the large, tall, huge and
// test tiles B2 runs B1's 3xTF32 wgmma mainloop (gemm_wgmma.cuh), bound by
// three TF32 tensor-core products per multiply-add and the split pass; at
// the others the FP32 FFMA rate. It adds a per-tile check costing about 6 *
// BM * BN operations, once per run, and, at a scheduled fault (~20 per
// tile at 4096), one wait for the in-flight wgmmas.
//
// What the design does about it: the mainloop is B1's, unchanged; B2's
// check runs after it. A fault is added between two k steps' wgmmas, after
// they have landed, so it takes the same place in the sum as in the plain
// version (ops/ft_sgemm.py::_inject_plain). The moments are reduced with
// warp shuffles over the lanes that share a column and one shared-memory
// pass across the consumer warps, and only at checks.

#include "abft_common.cuh"
#include "ft_sgemm_running.cuh"
#include "gemm_wgmma.cuh"

namespace ftsg {

template <class T>
struct WgCheckSmem {
  float part[3][T::NCONS / 32][T::BN];  // per warp: moments 1, w, w^2
  float delta[T::BN];
  int hit_row[T::BN];
};

// B2's check over the wgmma fragment: the column moments 1, w, w^2 (each
// thread's two rows per column, shuffles over the 8 lanes of a warp that
// share a column (equal lane % 4), one shared-memory pass over the
// consumer warps), weighted_column per column, the correction in place.
// Consumer threads only (named barrier 1); `cm` reuses the ring.
template <class T>
__device__ __forceinline__ void wg_moment_check(
    WgMainloop<T>& ml, WgCheckSmem<T>& cm, const float* e, int N,
    const Scalars& sc, int& n_hit, int& n_unc) {
  constexpr int NQ = T::BN / 8;
  float p[3][NQ][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      p[0][q][c] = p[1][q][c] = p[2][q][c] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * q + 2 * h + c;
        const float w = (float)(ml.row(i) + 1), x = ml.acc[i];
        p[0][q][c] += x;
        p[1][q][c] += w * x;
        p[2][q][c] += (w * w) * x;
      }
    }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          p[v][q][c] += __shfl_xor_sync(0xffffffffu, p[v][q][c], off);
  const int warp = threadIdx.x / 32;
  if (ml.l < 4) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int v = 0; v < 3; ++v) cm.part[v][warp][ml.col(4 * q + c)] = p[v][q][c];
  }
  consumer_sync<T::NCONS>();
  const int t = threadIdx.x;
  bool hit = false, bad = false;
  if (t < T::BN) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int wp = 0; wp < T::NCONS / 32; ++wp)
      for (int v = 0; v < 3; ++v) s[v] += cm.part[v][wp][t];
    const ColumnVerdict cv = weighted_column(
        e[t], e[N + t], e[2 * (size_t)N + t], s[0], s[1], s[2], T::BM,
        sc.s[SLOT_THRESHOLD], sc.s[SLOT_THR_M1], sc.s[SLOT_THR_M2]);
    hit = cv.hit;
    bad = cv.bad;
    cm.delta[t] = cv.delta;
    cm.hit_row[t] = cv.row;
  }
  n_hit = consumer_count<T::NCONS>(hit);  // also publishes delta / hit_row
  n_unc = consumer_count<T::NCONS>(bad);
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) {
    const int c = ml.col(i);
    ml.acc[i] += cm.hit_row[c] == ml.row(i) ? cm.delta[c] : 0.f;
  }
}

// B2 at the wgmma tiles: `expm` is the (M / BM, 3, N) expected moments.
template <class T>
__global__ void __launch_bounds__(T::NT, T::MIN_CTAS) ft_weighted_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ C,
    const float* __restrict__ expm, float* __restrict__ out,
    int* __restrict__ det, int* __restrict__ unc, int N, int K, int bk,
    float alpha, float beta, Scalars sc) {
  const WgSmem<T> sm;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * T::BM, n0 = tj * T::BN;
  const int nst = (K + T::SK - 1) / T::SK;
  sm.init();
  if (threadIdx.x >= T::NCONS) {  // the producer warpgroup
    setmaxnreg_dec<T::REGS_PRODUCER>();
    sm.produce(&ta, &tb, m0, n0, nst);
    return;
  }
  setmaxnreg_inc<T::REGS_CONSUMER>();
  WgMainloop<T> ml(sm);
  FragInject<T> inj(sc, bk, K, ti, tj);
  ml.run(nst, inj);
  // Every wgmma and TMA write has landed: the ring is free for the check.
  static_assert(sizeof(WgCheckSmem<T>) <= T::STAGES * T::STAGE_BYTES,
                "the check fits in the ring");
  int n_hit, n_unc;
  wg_moment_check(ml, *reinterpret_cast<WgCheckSmem<T>*>(sm.base),
                  expm + (size_t)ti * 3 * N + n0, N, sc, n_hit, n_unc);
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_hit;
    unc[ti * gridDim.x + tj] = n_unc;
  }
}

// B2 at the small, medium and wide tiles (FFMA mainloop): `expm` is the
// (M / BM, 3, N) expected moments.
template <class L>
__global__ void __launch_bounds__(L::NT, L::MIN_CTAS) ft_weighted_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ expm,
    float* __restrict__ out, int* __restrict__ det, int* __restrict__ unc,
    int N, int K, int bk, float alpha, float beta, Scalars sc) {
  __shared__ Stage<L> st;
  __shared__ MomentSmem<L> ms;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int m0 = ti * L::BM, n0 = tj * L::BN;
  Mainloop<L> ml(A, B, K, m0, n0);
  k_loop(ml, st, K / bk, bk / L::KS, [&](int s) { inject(ml, sc, s, ti, tj); },
         [](int) {});
  float ec = 0.f, ecw = 0.f, ecw2 = 0.f;
  const int t = threadIdx.x;
  if (t < L::BN) {
    // expm is (M / BM, 3, N): rows 1, w, w^2 of row tile ti.
    const float* e = expm + (size_t)ti * 3 * N + n0 + t;
    ec = e[0];
    ecw = e[N];
    ecw2 = e[2 * (size_t)N];
  }
  int n_det, n_unc;
  moment_detect_correct(ml, ms, ec, ecw, ecw2, sc.s[SLOT_THRESHOLD],
                        sc.s[SLOT_THR_M1], sc.s[SLOT_THR_M2], n_det, n_unc);
  ml.store(out, C, N, m0, n0, alpha, beta);
  if (threadIdx.x == 0) {
    det[ti * gridDim.x + tj] = n_det;
    unc[ti * gridDim.x + tj] = n_unc;
  }
}

template <class L>
int launch_ffma(const float* A, const float* B, const float* C,
                const float* expm, float* out, int* det, int* unc, int M,
                int N, int K, int bk, float alpha, float beta,
                const Scalars& sc, cudaStream_t stream) {
  if constexpr (wgmma_tile<L::BM, L::BN>()) {
    return (int)cudaErrorInvalidValue;  // B2 runs ft_weighted_wgmma_kernel
  } else {
    ft_weighted_kernel<L><<<dim3(N / L::BN, M / L::BM), L::NT, 0, stream>>>(
        A, B, C, expm, out, det, unc, N, K, bk, alpha, beta, sc);
    return (int)cudaGetLastError();
  }
}

template <class T>
int launch_wgmma(const float* A, const float* B, const float* C,
                 const float* expm, float* out, int* det, int* unc, int M,
                 int N, int K, int bk, float alpha, float beta,
                 const Scalars& sc, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (bk % 8) return (int)cudaErrorInvalidValue;
  if (const int rc = wgmma_setup<T>(ft_weighted_wgmma_kernel<T>, &ta, &tb, A,
                                    B, M, N, K))
    return rc;
  ft_weighted_wgmma_kernel<T><<<dim3(N / T::BN, M / T::BM), T::NT, T::SMEM,
                                stream>>>(ta, tb, C, expm, out, det, unc, N,
                                          K, bk, alpha, beta, sc);
  return (int)cudaGetLastError();
}

}  // namespace ftsg

// B2. `scalars` is a host array of 8 floats (contracts.SCALAR_SLOTS);
// `expm` the (M / bm, 3, N) expected moments. Returns cudaGetLastError()
// (cudaErrorInvalidValue when no tile matches).
extern "C" int ftsg_ft_weighted_precomp(
    const float* A, const float* B, const float* C, const float* expm,
    float* out, int* det, int* unc, int M, int N, int K, int bm, int bn,
    int ks, int mr, int nr, int bk, float alpha, float beta,
    const float* scalars, void* stream) {
  ftsg::Scalars sc;
  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];
  const auto s = (cudaStream_t)stream;
#define FTSG_LAUNCH_WGMMA(BM_, BN_)                                        \
  if (bm == BM_ && bn == BN_)                                              \
    return ftsg::launch_wgmma<ftsg::WgTile<BM_, BN_>>(                     \
        A, B, C, expm, out, det, unc, M, N, K, bk, alpha, beta, sc, s);
  FTSG_FOR_EACH_WGMMA_TILE(FTSG_LAUNCH_WGMMA)
#undef FTSG_LAUNCH_WGMMA
#define FTSG_LAUNCH(BM_, BN_, KS_, TM_, TN_)                               \
  if (bm == BM_ && bn == BN_ && ks == KS_ && mr == TM_ && nr == TN_)       \
    return ftsg::launch_ffma<ftsg::Layout<BM_, BN_, KS_, TM_, TN_>>(       \
        A, B, C, expm, out, det, unc, M, N, K, bk, alpha, beta, sc, s);
  FTSG_FOR_EACH_LAYOUT(FTSG_LAUNCH)
#undef FTSG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// B5: checks after every `check_every` K steps and after the last, on the
// 128 x 128 wgmma CTA over (bm, bn) sub-tiles (ks, mr, nr are not read).
extern "C" int ftsg_ft_weighted_running(
    const float* A, const float* B, const float* C, float* out, int* det,
    int* unc, int M, int N, int K, int bm, int bn, int ks, int mr, int nr,
    int bk, int check_every, float alpha, float beta, const float* scalars,
    void* stream) {
  return ftsg::launch_running<ftsg::WeightedOf<ftsg::kSumRows>::At>(
      A, B, C, nullptr, nullptr, 0, out, det, unc, M, N, K, bm, bn, bk,
      check_every, alpha, beta, scalars, (cudaStream_t)stream);
}

// Register-tiled FFMA mainloop of the port's FFMA kernels: B1 and B2 at the
// small, medium and wide tiles (sgemm.cu, ft_sgemm_weighted.cu).
//
// One CTA computes one (BM, BN) output tile of C = alpha * A @ B^T + beta * C
// with A (M, K) and B (N, K) row-major, all dimensions already zero-padded
// by the Python wrapper (M % BM == N % BN == K % bk == 0). The K loop runs
// inside the CTA (it replaces the sequential K grid axis of the Pallas
// kernels): A and B advance KS columns at a time through a two-buffer
// shared-memory stage, and each of the (BM/TM) x (BN/TN) threads keeps a
// TM x TN accumulator in registers — the paper's register-tiled form
// (code_gen/code_gen.py). Every product is a plain fp32 FFMA: no TF32, no
// tensor cores, so the result keeps full FP32 accuracy.
//
// K is scheduled in steps of bk = cps * KS columns; B2 hooks fault
// injection before a step and its check after the last, the unit that
// InjectionSpec and check_every count.

#pragma once

#include <cuda_runtime.h>

namespace ftsg {

template <int BM_, int BN_, int KS_, int TM_, int TN_>
struct Layout {
  static constexpr int BM = BM_, BN = BN_, KS = KS_, TM = TM_, TN = TN_;
  static constexpr int NTX = BN / TN;  // threads across the tile's columns
  static constexpr int NTY = BM / TM;  // threads across the tile's rows
  static constexpr int NT = NTX * NTY;
  static constexpr int NWARPS = NT / 32;
  // B2 asks for two 256-thread CTAs per SM (at most 128 registers): a
  // second CTA hides its check's barriers.
  static constexpr int MIN_CTAS = NT >= 256 ? 2 : 1;
  static constexpr int A_F4 = BM * KS / 4;  // float4 loads per A chunk
  static constexpr int B_F4 = BN * KS / 4;
  static constexpr int LA = (A_F4 + NT - 1) / NT;
  static constexpr int LB = (B_F4 + NT - 1) / NT;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile not divisible");
  static_assert(NT % 32 == 0 && NT <= 1024, "whole warps only");
  // A warp holds whole rows of threads: row sums need shuffles only.
  static_assert(NTX <= 32 && 32 % NTX == 0, "NTX must divide 32");
  static_assert(KS % 4 == 0, "chunks load as float4");
  // One thread per tile row / column in the checksum passes.
  static_assert(NT >= BM && NT >= BN, "too few threads for the checks");
};

// The compiled (BM, BN, KS, TM, TN) layouts: the paper's small, medium,
// large, tall, wide and huge tiles (configs.SHAPES). The "test" shape runs
// the huge layout with bk = 128.
#define FTSG_FOR_EACH_LAYOUT(X)                            \
  X(16, 16, 16, 2, 2) X(32, 32, 8, 4, 4) X(64, 64, 8, 8, 8) \
  X(128, 32, 8, 8, 4) X(32, 128, 8, 4, 8) X(128, 128, 8, 8, 8)

// Two shared-memory buffers of one K chunk, stored transposed so that a
// thread's TM (TN) operands of one k are contiguous.
template <class L>
struct __align__(16) Stage {
  float As[2][L::KS][L::BM];
  float Bs[2][L::KS][L::BN];
};

// Load T consecutive floats from shared memory, vectorized where the
// alignment allows.
template <int T>
__device__ __forceinline__ void lds(float (&dst)[T], const float* src) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < T; ++q) dst[q] = src[q];
  }
}

template <class L>
struct Mainloop {
  float acc[L::TM][L::TN];
  float4 ra[L::LA];  // the next chunk, in flight from global memory
  float4 rb[L::LB];
  const float* A;  // first row of this CTA's A panel
  const float* B;  // first row of this CTA's B panel
  int K;
  int tx, ty;

  __device__ __forceinline__ Mainloop(const float* A_, const float* B_,
                                      int K_, int m0, int n0)
      : A(A_ + (size_t)m0 * K_), B(B_ + (size_t)n0 * K_), K(K_),
        tx(threadIdx.x % L::NTX), ty(threadIdx.x / L::NTX) {
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
#pragma unroll
      for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;
  }

  // Tile-local row / column of accumulator element (i, j).
  __device__ __forceinline__ int row(int i) const { return ty * L::TM + i; }
  __device__ __forceinline__ int col(int j) const { return tx * L::TN + j; }

  // Global -> registers: the chunk of K columns starting at k0.
  __device__ __forceinline__ void fetch(int k0) {
    constexpr int C4 = L::KS / 4;
#pragma unroll
    for (int l = 0; l < L::LA; ++l) {
      const int f = threadIdx.x + l * L::NT;
      if (L::A_F4 % L::NT == 0 || f < L::A_F4)
        ra[l] = *reinterpret_cast<const float4*>(
            A + (size_t)(f / C4) * K + k0 + (f % C4) * 4);
    }
#pragma unroll
    for (int l = 0; l < L::LB; ++l) {
      const int f = threadIdx.x + l * L::NT;
      if (L::B_F4 % L::NT == 0 || f < L::B_F4)
        rb[l] = *reinterpret_cast<const float4*>(
            B + (size_t)(f / C4) * K + k0 + (f % C4) * 4);
    }
  }

  // Registers -> shared buffer `buf`, transposed.
  __device__ __forceinline__ void stash(Stage<L>& st, int buf) const {
    constexpr int C4 = L::KS / 4;
#pragma unroll
    for (int l = 0; l < L::LA; ++l) {
      const int f = threadIdx.x + l * L::NT;
      if (L::A_F4 % L::NT == 0 || f < L::A_F4) {
        const int r = f / C4, c = (f % C4) * 4;
        st.As[buf][c][r] = ra[l].x;
        st.As[buf][c + 1][r] = ra[l].y;
        st.As[buf][c + 2][r] = ra[l].z;
        st.As[buf][c + 3][r] = ra[l].w;
      }
    }
#pragma unroll
    for (int l = 0; l < L::LB; ++l) {
      const int f = threadIdx.x + l * L::NT;
      if (L::B_F4 % L::NT == 0 || f < L::B_F4) {
        const int r = f / C4, c = (f % C4) * 4;
        st.Bs[buf][c][r] = rb[l].x;
        st.Bs[buf][c + 1][r] = rb[l].y;
        st.Bs[buf][c + 2][r] = rb[l].z;
        st.Bs[buf][c + 3][r] = rb[l].w;
      }
    }
  }

  // acc += A_chunk @ B_chunk^T for the chunk in shared buffer `buf`.
  __device__ __forceinline__ void fma_chunk(const Stage<L>& st, int buf) {
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) {
      float a[L::TM], b[L::TN];
      lds<L::TM>(a, &st.As[buf][kk][ty * L::TM]);
      lds<L::TN>(b, &st.Bs[buf][kk][tx * L::TN]);
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
#pragma unroll
        for (int j = 0; j < L::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // out = alpha * acc + beta * C for this CTA's tile (out never aliases C).
  __device__ __forceinline__ void store(float* out, const float* C, int N,
                                        int m0, int n0, float alpha,
                                        float beta) const {
#pragma unroll
    for (int i = 0; i < L::TM; ++i) {
      const size_t base = (size_t)(m0 + row(i)) * N + n0 + tx * L::TN;
      if constexpr (L::TN % 4 == 0) {
#pragma unroll
        for (int q = 0; q < L::TN / 4; ++q) {
          const float4 c = reinterpret_cast<const float4*>(C + base)[q];
          float4 o;
          o.x = alpha * acc[i][4 * q] + beta * c.x;
          o.y = alpha * acc[i][4 * q + 1] + beta * c.y;
          o.z = alpha * acc[i][4 * q + 2] + beta * c.z;
          o.w = alpha * acc[i][4 * q + 3] + beta * c.w;
          reinterpret_cast<float4*>(out + base)[q] = o;
        }
      } else {
#pragma unroll
        for (int j = 0; j < L::TN; ++j)
          out[base + j] = alpha * acc[i][j] + beta * C[base + j];
      }
    }
  }
};

// The K loop: nk steps of cps chunks each. `begin(s)` runs before step s's
// products (fault injection) and `end(s)` after step s (detect / correct).
// The next chunk's global loads are issued before the current chunk's
// FFMAs, so one __syncthreads per chunk suffices: buffer buf^1 is written
// only after every thread passed the barrier that ended its last read.
template <class L, class Begin, class End>
__device__ __forceinline__ void k_loop(Mainloop<L>& ml, Stage<L>& st, int nk,
                                       int cps, Begin begin, End end) {
  const int nchunks = nk * cps;
  ml.fetch(0);
  ml.stash(st, 0);
  __syncthreads();
  int buf = 0;
  for (int s = 0; s < nk; ++s) {
    begin(s);
    for (int c = 0; c < cps; ++c) {
      const int t = s * cps + c;
      const bool more = t + 1 < nchunks;
      if (more) ml.fetch((t + 1) * L::KS);
      ml.fma_chunk(st, buf);
      if (more) ml.stash(st, buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
    end(s);
  }
}

}  // namespace ftsg

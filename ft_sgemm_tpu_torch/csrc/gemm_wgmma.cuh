// The port's one mainloop, 3xTF32 on wgmma, on one of two CTAs. B1
// (sgemm.cu) and B2 (ft_sgemm_weighted.cu) run the tile's own CTA at the
// tiles whose rows fill wgmma's 64-row granularity, large (64 x 64), tall
// (128 x 32), huge (128 x 128) and test (huge with bk = 128). At every other
// tile, and B3-B8 (ft_sgemm_running.cuh) at every tile, one 128 x 128 CTA
// covers several of the paper's tiles: its (SBM, SBN) sub-tiles, the
// granularity of the checks (B1 has none, so for B1 the paper's tile is
// only the unit the wrapper pads M and N to).
//
// One CTA computes one (BM, BN) tile of C = alpha * A @ B^T + beta * C with
// A (M, K) and B (N, K) row-major: both K-major, the layout wgmma requires
// for tf32. The wrapper pads M and N to the paper's tile and K to bk, a
// multiple of 8, so every row stride is a multiple of 32 bytes (TMA needs
// 16); TMA zero-fills the rows of a CTA past M or N and the ragged last
// stage past K.
//
// Roles: warps 0 .. 4 * NWG - 1 form NWG consumer warpgroups, one per 64
// tile rows; the last warpgroup is the producer, which gives most of its
// registers to the consumers (setmaxnreg), whose first thread issues the
// TMA loads and whose warps 1-3 split B. A stage holds SK = 32 K columns:
// A's (BM, 32) box and B's (BN, 32) box, 128 bytes a row in TMA's 128-byte
// swizzle, and a second buffer of B's shape for B's low part; with R > 0
// also R moment rows, hi and lo (below). STAGES stages form a ring run by
// full / ready / empty mbarriers. Consumer-only synchronisation uses named
// barrier 1, so the producer may exit once its work is issued.
//
// 3xTF32: x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi); every 8-deep k step adds a_lo b_hi, a_hi b_lo and a_hi b_hi, small
// terms first, into the stage's wgmma sum, which goes into the f32
// accumulator once per stage (WgMainloop; the dropped a_lo b_lo is ~2^-22
// of the product). Never bare TF32. wgmma reads B from shared memory only, so
// the producer's warps 1-3 split each landed stage of B in place (hi) and
// into the second buffer (lo), then fence.proxy.async before wgmma reads
// it; A's fragments are split in registers (wgmma takes a tf32 A from
// registers). While stage s's wgmmas run, the consumers split stage s + 1's
// A into the other register set.
//
// Expected column sums (R > 0): the MOM * BM / SBM rows of column moments
// (weights 1, w, w^2 up to MOM, w = row within the sub-tile + 1) of each
// sub-tile row band of A, padded to R, a multiple of 8, ride each stage
// (loaded by TMA for B6 and B7, summed from A's landed stage by the
// splitter warps for B5 and B3) and are split hi / lo like B. A second
// accumulator takes E = B_tile . M^T, one m64nRk8 wgmma per term with both
// operands in shared memory (B's stage as the A operand), with the same
// 3xTF32 terms and per-stage promotion as the product, so both sides of a
// check's residual carry the same precision.
//
// Expected row sums (XN = 8; B3, B4, B7, B8): rows BN .. BN + NBN - 1 of
// B's stage (hi and lo; zero up to BN + 8) hold the sums of B's rows over
// each sub-tile column band, written by the splitter warps (B3, B4) or
// loaded by TMA from the wrapper's band rows and split like B (B7, B8), and
// the product runs as m64n(BN + 8)k8: its extra columns BN + j are A times
// band j's sums, each row's expected sum over band j, from the same 3xTF32
// terms and promotion as the product they check.
//
// Accumulator: wgmma's m64nBN f32 fragment. Consumer thread (warpgroup g,
// warp w of the group, lane l) holds element i at tile row 64g + 16w + l/4
// + 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * (l % 4) + i % 2 (row(),
// col(); ops/tf32x3.wgmma_fragment_map mirrors the map for the CPU tests);
// the extra columns follow the same map, at elements NACC ...
// E's fragment has the same map with B's row for the tile row and the
// moment row for the column (ops/tf32x3.moment_fragment_map). The FT hooks
// use those maps and keep their logic.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "abft_common.cuh"

FTSG_NAMESPACE_BEGIN

// The (BM, BN) tiles on which B1 and B2 run the tile's own CTA;
// ops/_build.wgmma_tiles reads this list.
#define FTSG_FOR_EACH_WGMMA_TILE(X) X(64, 64) X(128, 32) X(128, 128)

// The tiles narrower than wgmma's 64 rows, on which B1 and B2 run the
// 128 x 128 CTA (B2 checking them as its sub-tiles);
// ops/_build.narrow_tiles reads this list.
#define FTSG_FOR_EACH_NARROW_TILE(X) X(16, 16) X(32, 32) X(32, 128)

inline bool narrow_tile(int bm, int bn) {
#define FTSG_IS_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return true;
  FTSG_FOR_EACH_NARROW_TILE(FTSG_IS_TILE)
#undef FTSG_IS_TILE
  return false;
}

// The (SBM, SBN) sub-tiles of the 128 x 128 CTA on which B3-B8 run, the
// paper's tiles; ops/_build.subtiles reads this list.
#define FTSG_FOR_EACH_SUBTILE(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 32) X(32, 128) X(128, 128)

// Where a stage's moment rows come from: none (B1, B2, B4, B8), a TMA box
// of the MOM rows per row band that the check reads out of the wrapper's
// (gm, rows, K) moment rows (B6: 3 of 3; B7: 1, or 2 with multifault, of
// 2), or sums over A's landed stage by the splitter warps, one job per
// sub-tile row band and column after B's split (B5: WgSmem::sum_rows) or
// in 8-row groups beside B's split (B3: WgSmem::split_b). B5 on the 8-row
// groups ran 13-30 % slower at the 16- to 64-row sub-tiles (PERF.md).
enum MomentRows {
  kNoRows = 0,
  kLoadRows = 1,
  kSumRows = 2,
  kSumRowGroups = 3
};

// Where B's band rows (rows BN .. BN + NBN - 1 of B's stage, the operand of
// the expected row sums) come from: none (B1, B2, B5, B6), sums over B's
// landed stage by the splitter warps in 8-row groups (B3, B4:
// WgSmem::split_b), or a TMA box of the wrapper's (N / SBN, K) band rows
// (B7, B8), which the splitter warps only split.
enum BandRows {
  kNoBands = 0,
  kSumBands = 1,
  kLoadBands = 2
};

// A CTA of (BM, BN) checked in (SBM, SBN) sub-tiles, with MOM moment rows
// per sub-tile row band in each stage (0: none, B1, B2, B4, B8; padded to
// R, a multiple of 8) from ROWS, CHECK bytes of check scratch beside the
// ring, and, with BANDS, XN = 8 extra product columns: B's column-band
// sums, so that the product's columns BN .. BN + NBN - 1 are the expected
// row sums of each band (B3, B4, B7, B8). The ring has four stages where
// they fit in the 232448 bytes of shared memory a CTA may have, else three.
template <int BM_, int BN_, int SBM_ = BM_, int SBN_ = BN_, int MOM_ = 0,
          int CHECK_ = 0, int BANDS_ = kNoBands, int ROWS_ = kNoRows>
struct WgTile {
  static constexpr int BM = BM_, BN = BN_, SBM = SBM_, SBN = SBN_;
  static constexpr int NBM = BM / SBM, NBN = BN / SBN, NSUB = NBM * NBN;
  static constexpr int MOM = MOM_, R = (MOM * NBM + 7) / 8 * 8;
  static constexpr int BANDS = BANDS_, ROWS = ROWS_;
  static constexpr int XN = BANDS == kNoBands ? 0 : 8;
  static constexpr int SK = 32;       // K columns per stage: one swizzle row
  static constexpr int KK = SK / 8;   // 8-deep wgmma steps per stage
  static constexpr int NWG = BM / 64;  // consumer warpgroups
  static constexpr int NCONS = 128 * NWG;
  static constexpr int NT = NCONS + 128;  // and the producer warpgroup
  // The 64-row tile is small enough for two CTAs per SM.
  static constexpr int MIN_CTAS = NWG == 1 ? 2 : 1;
  // Registers per thread: REGS at launch (the __launch_bounds__ share of
  // the SM's 65536), then the producer keeps REGS_PRODUCER and hands the
  // rest to the consumers (setmaxnreg).
  static constexpr int REGS = 65536 / (MIN_CTAS * NT) / 8 * 8;
  static constexpr int REGS_PRODUCER = 40;
  // The consumers' share when the producer keeps `producer` registers.
  static constexpr __host__ __device__ int consumer_regs(int producer) {
    return (REGS + (REGS - producer) * 128 / NCONS) / 8 * 8;
  }
  static constexpr int REGS_CONSUMER = consumer_regs(REGS_PRODUCER);
  static constexpr int NACC = BN / 2;  // product floats per thread
  static constexpr int NACC_W = (BN + XN) / 2;  // with the extra columns
  static constexpr int NACC_E = R / 2;  // expected-moment floats per thread
  static constexpr int A_BYTES = BM * SK * 4;
  static constexpr int B_BOX = BN * SK * 4;  // the TMA box of B
  static constexpr int B_BYTES = (BN + XN) * SK * 4;
  static constexpr int M_BYTES = R * SK * 4;  // one buffer of moment rows
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES + 2 * M_BYTES;
  // The rows a stage's TMA boxes fill: where loaded, exactly the NBN band
  // rows and the MOM * NBM moment rows the checks read; the full barrier
  // expects these bytes, and the padding rows past them stay zero.
  static constexpr int BAND_BOX = BANDS == kLoadBands ? NBN * SK * 4 : 0;
  static constexpr int M_BOX = ROWS == kLoadRows ? MOM * NBM * SK * 4 : 0;
  static constexpr int CHECK_BYTES = CHECK_;
  // The splitters' 8-row sums (WgSmem::split_b) of B (kSumBands) and of A's
  // moments (kSumRowGroups), rows of SK floats per stage.
  static constexpr int PROD_ROWS = (BANDS == kSumBands ? BN / 8 : 0) +
                                   (ROWS == kSumRowGroups ? MOM * BM / 8 : 0);
  // The ring's 3 * stages mbarriers, padded to keep what follows 16-byte
  // aligned (float4 stores).
  static constexpr __host__ __device__ int bar_bytes(int stages) {
    return (24 * stages + 15) / 16 * 16;
  }
  // The ring, its mbarriers, `sets` stages of the splitters' scratch, the
  // check scratch, and slack to align the ring to the 1024 bytes of the
  // swizzle pattern.
  static constexpr int smem(int stages, int sets) {
    return stages * STAGE_BYTES + bar_bytes(stages) +
           sets * PROD_ROWS * SK * 4 + CHECK_BYTES + 1024;
  }
  static constexpr int STAGES = smem(4, 1) <= 232448 ? 4 : 3;
  // The scratch for two stages (by stage parity) where it fits beside the
  // ring, else for one, and the splitters then meet once more per stage.
  static constexpr int PROD_SETS = smem(STAGES, 2) <= 232448 ? 2 : 1;
  static constexpr int PROD_BYTES = PROD_SETS * PROD_ROWS * SK * 4;
  static constexpr int SMEM = smem(STAGES, PROD_SETS);
  static constexpr int SPLITTERS = 96;  // producer warps 1-3 split B
  static_assert(BM % 64 == 0 && BN % 8 == 0 && BN + XN <= 256,
                "m64nBNk8 tile");
  static_assert(BM % SBM == 0 && BN % SBN == 0 && SBM % 16 == 0,
                "sub-tiles of whole warp bands");
  static_assert(R <= 24, "m64nRk8 expected-moment product");
  static_assert(XN == 0 || (XN == 8 && NBN <= 8 && SBN % 8 == 0),
                "one extra column per column band");
  static_assert(REGS_CONSUMER <= 256, "setmaxnreg takes at most 256");
  static_assert(B_BYTES % 1024 == 0 && M_BYTES % 1024 == 0,
                "buffers keep the swizzle alignment");
  static_assert(BANDS != kLoadBands || B_BOX % 1024 == 0,
                "the band-row box starts on a swizzle atom");
  static_assert(SMEM <= 232448, "the ring fits in shared memory");
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (rows, SK) box at (k0, row0) of `map` into `dst`, completing on
// `bar` with the box's bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0),
      "r"(row0)
      : "memory");
}

// TMA of a 3-D map: the (groups, planes, SK) box at (k0, plane0, group0).
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int k0, int plane0,
                                          int group0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0),
      "r"(plane0), "r"(group0)
      : "memory");
}

// Generic-proxy shared-memory writes made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier 1 over the NT consumer threads, and its popcount form.
template <int NT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}
template <int NT>
__device__ __forceinline__ int consumer_count(bool pred) {
  int n;
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.popc.u32 %0, 1, %2, p;\n}\n"
      : "=r"(n)
      : "r"((int)pred), "n"(NT)
      : "memory");
  return n;
}

// Move registers between warpgroups (every warp of the group runs it).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: x = hi + lo, both TF32 (ops/tf32x3.split mirrors it).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, stride 1024 bytes between 8-row groups, layout
// type 1. Adding 2 to it advances one 8-deep (32-byte) k step.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d (m64 x N, f32) = A (m64 x k8, tf32 fragment in registers) @ B^T (+ d
// when scale_d is 1), B an (N x k8) tf32 tile in shared memory;
// asynchronous until wgmma_wait_all.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The product widened by B's XN = 8 band-sum rows (B3, B4, B7, B8).
template <>
struct Wgmma<136> {
  static __device__ __forceinline__ void run(float (&d)[68], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67}, "
        "{%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// d (m64 x N, f32) = A (m64 x k8) @ B^T (+ d when scale_d is 1), both
// tf32 tiles in shared memory (descriptors a, b): the expected-moment
// product E = B_tile . M^T, whose A operand is B's stage.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<24> {
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11},"
        " %12, %13, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ------------------------------------------------------------ mainloop ----

extern __shared__ unsigned char ftsg_wg_smem[];

// The ring in dynamic shared memory, aligned to 1024 bytes: stage s holds
// A's box, B's box (hi after the split; with XN > 0 followed by B's band
// rows), B's lo (likewise) and, with R > 0, the moment rows' hi and lo;
// then the mbarriers: full(s) when TMA has landed the stage, ready(s) when
// its B (and moment rows) are split, empty(s) when the consumers are done
// with it; then the splitters' scratch (16-byte aligned) and the check
// scratch.
template <class T>
struct WgSmem {
  unsigned char* base;

  __device__ __forceinline__ WgSmem()
      : base(ftsg_wg_smem + ((1024 - (smem_u32(ftsg_wg_smem) & 1023)) & 1023)) {}
  __device__ __forceinline__ float* a(int s) const {
    return reinterpret_cast<float*>(base + s * T::STAGE_BYTES);
  }
  __device__ __forceinline__ float* b(int s) const {
    return reinterpret_cast<float*>(base + s * T::STAGE_BYTES + T::A_BYTES);
  }
  __device__ __forceinline__ float* blo(int s) const {
    return reinterpret_cast<float*>(base + s * T::STAGE_BYTES + T::A_BYTES +
                                    T::B_BYTES);
  }
  __device__ __forceinline__ float* mhi(int s) const {
    return reinterpret_cast<float*>(base + s * T::STAGE_BYTES + T::A_BYTES +
                                    2 * T::B_BYTES);
  }
  __device__ __forceinline__ float* mlo(int s) const {
    return mhi(s) + T::R * T::SK;
  }
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + T::STAGES * T::STAGE_BYTES) + s;
  }
  __device__ __forceinline__ uint64_t* ready(int s) const {
    return full(T::STAGES) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return full(2 * T::STAGES) + s;
  }
  __device__ __forceinline__ float* prod() const {
    return reinterpret_cast<float*>(base + T::STAGES * T::STAGE_BYTES +
                                    T::bar_bytes(T::STAGES));
  }
  __device__ __forceinline__ void* check() const {
    return reinterpret_cast<unsigned char*>(prod()) + T::PROD_BYTES;
  }

  // Thread 0 initialises the barriers; the whole CTA waits for it.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < T::STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(ready(s), T::SPLITTERS);
        mbar_init(empty(s), T::NCONS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // Split n float4 at p in place (hi) and into lo, over the splitter
  // threads e = 0 .. SPLITTERS - 1.
  static __device__ __forceinline__ void split4(float* p, float* lo, int n,
                                                int e) {
    float4* hi4 = reinterpret_cast<float4*>(p);
    float4* lo4 = reinterpret_cast<float4*>(lo);
    for (; e < n; e += T::SPLITTERS) {
      const float4 v = hi4[e];
      uint32_t h[4], l[4];
      split_tf32(v.x, h[0], l[0]);
      split_tf32(v.y, h[1], l[1]);
      split_tf32(v.z, h[2], l[2]);
      split_tf32(v.w, h[3], l[3]);
      hi4[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                           __uint_as_float(h[2]), __uint_as_float(h[3]));
      lo4[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                           __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  }

  // B5's moment rows of stage s: for each sub-tile row band b and column k,
  // the sums of A's rows with weights 1, w, w^2 (w = row in the band + 1)
  // into rows 3b .. 3b + 2, split hi / lo, in the swizzled K-major layout
  // of a TMA box; the padding rows are zero.
  __device__ __forceinline__ void sum_rows(int s, int e) const {
    const float* a_ = a(s);
    float* hi = mhi(s);
    float* lo = mlo(s);
    for (int j = e; j < T::NBM * T::SK; j += T::SPLITTERS) {
      const int band = j / T::SK, k = j % T::SK;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 8
      for (int rr = 0; rr < T::SBM; ++rr) {
        const int r = band * T::SBM + rr;
        const float x = a_[r * T::SK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)];
        const float w = (float)(rr + 1);
        s0 += x;
        s1 += w * x;
        s2 += (w * w) * x;
      }
      const float sv[3] = {s0, s1, s2};
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int r = 3 * band + v;
        const int o = r * T::SK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
        uint32_t h, l;
        split_tf32(sv[v], h, l);
        hi[o] = __uint_as_float(h);
        lo[o] = __uint_as_float(l);
      }
    }
    for (int j = 3 * T::NBM * T::SK + e; j < T::R * T::SK; j += T::SPLITTERS)
      hi[j] = lo[j] = 0.f;
  }

  // Whether a stage has padding rows that no box and no sum writes: B's
  // band rows past NBN up to BN + XN, and the moment rows past MOM * NBM up
  // to R (B5's sum_rows writes its own zeros).
  static constexpr bool PADS =
      T::XN > T::NBN || (T::R > T::MOM * T::NBM && T::ROWS != kSumRows);

  // Those rows of ring slot s, zeroed once before the first stage. (Zeroed
  // in each slot's first stage instead, inside the splitters' stage loop,
  // they made B6 5-10 % slower; PERF.md.)
  __device__ __forceinline__ void zero_pads(int s, int e) const {
    for (int z = (T::BN + T::NBN) * T::SK + e; z < (T::BN + T::XN) * T::SK;
         z += T::SPLITTERS)
      b(s)[z] = blo(s)[z] = 0.f;
    for (int z = T::MOM * T::NBM * T::SK + e; z < T::R * T::SK;
         z += T::SPLITTERS)
      mhi(s)[z] = mlo(s)[z] = 0.f;
  }

  // B's stage s split like split4: B's box and, where loaded (kLoadBands),
  // its band rows; with kSumBands also B's column-band sums (B3, B4) and,
  // with kSumRowGroups, A's row-band moment sums (B3).
  // Row BN + j (j < NBN; the rest zero) of B's stage is the sum of the rows
  // of column band j (of hi + lo, the value the product multiplies), split
  // hi / lo in the same swizzled layout, so that the product's extra column
  // BN + j is each row's expected sum over band j; moment row MOM b + v
  // (the rest zero) is the sum of A's rows of row band b with weight w^v
  // (w = row in the band + 1). A job takes 8 rows of one 4-column chunk of
  // B (split, and summed with kSumBands) or of A (summed), a whole warp the
  // same kind; the 8-row sums meet in the producer scratch after a named
  // barrier over the splitter warps, and one job per output row and column
  // adds a band's 8-row sums.
  __device__ __forceinline__ void split_b(int st, int e) const {
    const int s = st % T::STAGES;
    constexpr bool SB = T::BANDS == kSumBands, SA = T::ROWS == kSumRowGroups;
    if constexpr (!SB && !SA) {
      split4(b(s), blo(s), (T::B_BOX + T::BAND_BOX) / 16, e);
    } else {
      constexpr int G = T::BN / 8, GA = T::BM / 8;  // 8-row groups
      float4* hi4 = reinterpret_cast<float4*>(b(s));
      float4* lo4 = reinterpret_cast<float4*>(blo(s));
      const float4* a4 = reinterpret_cast<const float4*>(a(s));
      float* pb = prod() + (T::PROD_SETS == 2 ? st & 1 : 0) * T::PROD_ROWS *
                               T::SK;
      float* pa = pb + (SB ? G : 0) * T::SK;
      // B's jobs 0 .. 8 G - 1 and A's 0 .. 8 GA - 1, alternating by warp.
      static_assert(!SA || G == GA, "as many A jobs as B jobs");
      constexpr int NJ = 8 * G + (SA ? 8 * GA : 0);
      for (int job = e; job < NJ; job += T::SPLITTERS) {
        const bool is_a = SA && ((job >> 5) & 1);
        const int idx = SA ? ((job >> 6) << 5) | (job & 31) : job;
        const int grp = idx / 8, c = idx % 8;  // rows 8 grp .., chunk c
        if (!is_a) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            const int o = (8 * grp + rr) * 8 + (c ^ rr);
            const float4 v = hi4[o];
            uint32_t h[4], l[4];
            split_tf32(v.x, h[0], l[0]);
            split_tf32(v.y, h[1], l[1]);
            split_tf32(v.z, h[2], l[2]);
            split_tf32(v.w, h[3], l[3]);
            const float4 vh = make_float4(
                __uint_as_float(h[0]), __uint_as_float(h[1]),
                __uint_as_float(h[2]), __uint_as_float(h[3]));
            const float4 vl = make_float4(
                __uint_as_float(l[0]), __uint_as_float(l[1]),
                __uint_as_float(l[2]), __uint_as_float(l[3]));
            hi4[o] = vh;
            lo4[o] = vl;
            sum.x += vh.x + vl.x;
            sum.y += vh.y + vl.y;
            sum.z += vh.z + vl.z;
            sum.w += vh.w + vl.w;
          }
          if constexpr (SB)
            reinterpret_cast<float4*>(pb)[grp * 8 + c] = sum;
        } else if constexpr (SA) {
          float4 sv[T::MOM];
#pragma unroll
          for (int v = 0; v < T::MOM; ++v)
            sv[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            const int n = 8 * grp + rr;
            const float4 x = a4[n * 8 + (c ^ rr)];
            const float w = (float)(n % T::SBM + 1);
            float wv = 1.f;
#pragma unroll
            for (int v = 0; v < T::MOM; ++v) {
              sv[v].x += wv * x.x;
              sv[v].y += wv * x.y;
              sv[v].z += wv * x.z;
              sv[v].w += wv * x.w;
              wv *= w;
            }
          }
#pragma unroll
          for (int v = 0; v < T::MOM; ++v)
            reinterpret_cast<float4*>(pa)[(v * GA + grp) * 8 + c] = sv[v];
        }
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(T::SPLITTERS) : "memory");
      constexpr int NB = SB ? T::NBN * T::SK : 0;
      constexpr int NA = SA ? T::MOM * T::NBM * T::SK : 0;
      for (int job = e; job < NB + NA; job += T::SPLITTERS) {
        float sum = 0.f;
        int n, k;
        float *hi, *lo;
        if (job < NB) {  // B's band sum j
          const int j = job / T::SK;
          k = job % T::SK;
          n = T::BN + j;
#pragma unroll
          for (int g = 0; g < T::SBN / 8; ++g)
            sum += pb[(j * (T::SBN / 8) + g) * T::SK + k];
          hi = b(s);
          lo = blo(s);
        } else {  // A's moment row n = MOM b + v
          n = (job - NB) / T::SK;
          k = (job - NB) % T::SK;
          const int band = n / T::MOM, v = n % T::MOM;
#pragma unroll
          for (int g = 0; g < T::SBM / 8; ++g)
            sum += pa[((v * GA) + band * (T::SBM / 8) + g) * T::SK + k];
          hi = mhi(s);
          lo = mlo(s);
        }
        uint32_t h, l;
        split_tf32(sum, h, l);
        const int o = n * T::SK + (((k >> 2) ^ (n & 7)) << 2) + (k & 3);
        hi[o] = __uint_as_float(h);
        lo[o] = __uint_as_float(l);
      }
      if constexpr (T::PROD_SETS == 1)  // the scratch is read before reuse
        asm volatile("bar.sync 2, %0;\n" ::"n"(T::SPLITTERS) : "memory");
    }
  }

  // The producer warpgroup, for nst stages of A's rows m0.., B's rows n0..,
  // (kLoadRows) the moment rows of row bands ti0.. of tm, MOM of each band's
  // rows, landing as row MOM * b + v, and (kLoadBands) the band rows tj0..
  // of tbb as B's rows BN..: its first thread streams the TMA loads through
  // the ring, each slot refilled once the consumers released it; warps 1-3
  // split each landed stage's B (and moment rows, or form them: kSumRows,
  // kSumRowGroups), hi in place and lo into the second buffer, so the
  // consumer warpgroups never wait for one another.
  __device__ __forceinline__ void produce(const CUtensorMap* ta,
                                          const CUtensorMap* tb, int m0,
                                          int n0, int nst,
                                          const CUtensorMap* tm = nullptr,
                                          int ti0 = 0,
                                          const CUtensorMap* tbb = nullptr,
                                          int tj0 = 0) const {
    const int p = threadIdx.x - T::NCONS;
    if (p == 0) {
      for (int st = 0; st < nst; ++st) {
        const int s = st % T::STAGES;
        if (st >= T::STAGES) mbar_wait(empty(s), (st / T::STAGES - 1) & 1);
        mbar_expect_tx(full(s),
                       T::A_BYTES + T::B_BOX + T::BAND_BOX + T::M_BOX);
        tma_load(a(s), ta, full(s), st * T::SK, m0);
        tma_load(b(s), tb, full(s), st * T::SK, n0);
        if constexpr (T::BANDS == kLoadBands)
          tma_load(b(s) + T::BN * T::SK, tbb, full(s), st * T::SK, tj0);
        if constexpr (T::ROWS == kLoadRows)
          tma_load3(mhi(s), tm, full(s), st * T::SK, 0, ti0);
      }
    } else if (p >= 32) {
      if constexpr (PADS) {
        for (int s = 0; s < T::STAGES; ++s) zero_pads(s, p - 32);
      }
      for (int st = 0; st < nst; ++st) {
        const int s = st % T::STAGES;
        mbar_wait(full(s), (st / T::STAGES) & 1);
        split_b(st, p - 32);
        if constexpr (T::ROWS == kLoadRows)
          split4(mhi(s), mlo(s), T::M_BOX / 16, p - 32);
        if constexpr (T::ROWS == kSumRows) sum_rows(s, p - 32);
        fence_proxy_async();  // the split is visible to wgmma
        mbar_arrive(ready(s));
      }
    }
  }
};

// No fault injection and no check inside the K loop (B1).
struct NoInject {
  static constexpr bool kSegmented = false;
  __device__ __forceinline__ bool at(int) const { return false; }
  __device__ __forceinline__ bool within(int) const { return false; }
  __device__ __forceinline__ bool check_after(int) const { return false; }
  template <class M>
  __device__ __forceinline__ void apply(M&, int) {}
  template <class M>
  __device__ __forceinline__ void check(M&) {}
  template <class M, class F>
  __device__ __forceinline__ void kstep(const M&, const F&, const F&, int,
                                        int) {}
};

// A consumer thread's part of the K loop and its accumulator. The tensor
// cores truncate when they accumulate, so a long sum inside wgmma drifts by
// up to an ulp per add (~11x cuBLAS's FP32 error at K = 4096); each stage's
// wgmmas therefore sum into `part`, started fresh, and `part` is added into
// `acc` with a rounded f32 add once the stage has landed. With R > 0 the
// expected moments sum the same way, `part_e` into `acc_e`. `Hook` hooks
// fault injection in before an 8-column k step t and a check after one:
// at(t) and check_after(t) say whether either fires there, within(st)
// whether either fires in stage st (the same for the whole CTA), and, for
// a hook whose kSegmented is set, fault_step() and check_step() the next
// such k steps (INT_MAX: none); apply(ml, t) adds the fault to `acc` and
// check(ml) checks `acc` against `acc_e`, each after every earlier product
// has landed and been added there; kstep(ml, ah, al, kk, s) sees each k
// step kk of stage slot s as its wgmmas are issued, in order, before any
// check after it (the adaptive checks' running moments of A and B).
template <class T>
struct WgMainloop {
  static constexpr int NF = 4 * T::KK;  // A fragment registers per stage
  static constexpr int NE = T::R > 0 ? T::NACC_E : 1;
  float acc[T::NACC_W];   // the product, then (XN > 0) its extra columns
  float part[T::NACC_W];  // this stage's wgmma sum
  float acc_e[NE];      // expected moments E[row(i)][col(i)] (R > 0)
  float part_e[NE];
  WgSmem<T> sm;
  int g, w, l;

  __device__ __forceinline__ explicit WgMainloop(const WgSmem<T>& sm_)
      : sm(sm_), g(threadIdx.x / 128),
        w((threadIdx.x / 32) % 4), l(threadIdx.x % 32) {
#pragma unroll
    for (int i = 0; i < T::NACC_W; ++i) acc[i] = part[i] = 0.f;
    if constexpr (T::R > 0) {
#pragma unroll
      for (int i = 0; i < NE; ++i) acc_e[i] = part_e[i] = 0.f;
    }
  }

  // Tile-local row / column of accumulator element i (for acc_e: B's row,
  // i.e. the tile column, and the moment row).
  __device__ __forceinline__ int row(int i) const {
    return 64 * g + 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
  }

  // After wgmma_wait_all: `part` holds its final sum (the empty asm keeps
  // the compiler from reading it earlier); add it into `acc`.
  __device__ __forceinline__ void promote() {
#pragma unroll
    for (int i = 0; i < T::NACC_W; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] += part[i];
    }
    if constexpr (T::R > 0) {
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        asm volatile("" : "+f"(part_e[i])::"memory");
        acc_e[i] += part_e[i];
      }
    }
  }

  // promote() and restart both stage sums at zero.
  __device__ __forceinline__ void promote_clear() {
    promote();
#pragma unroll
    for (int i = 0; i < T::NACC_W; ++i) part[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NE; ++i) part_e[i] = 0.f;
  }

  // Wait until stage st has landed and its B is split; load this thread's
  // A fragments of its KK k steps and split them into hi / lo. A fragment
  // register j of k step kk holds row r0 + 8 * (j % 2), column 8 * kk + 4 *
  // (j / 2) + l % 4, read through the swizzle.
  __device__ __forceinline__ void prepare(int st, uint32_t (&ah)[NF],
                                          uint32_t (&al)[NF]) const {
    const int s = st % T::STAGES;
    mbar_wait(sm.ready(s), (st / T::STAGES) & 1);
    const float* a = sm.a(s);
    const int r0 = 64 * g + 16 * w + (l >> 2);
#pragma unroll
    for (int kk = 0; kk < T::KK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * (j & 1), chunk = 2 * kk + (j >> 1);
        split_tf32(a[r * T::SK + ((chunk ^ (l >> 2)) << 2) + (l & 3)],
                   ah[4 * kk + j], al[4 * kk + j]);
      }
  }

  // One 8-deep k step into `part`: a_lo b_hi, a_hi b_lo, a_hi b_hi; the
  // first of them restarts `part` when `fresh`. With R > 0 the same three
  // terms of B's stage (this warpgroup's 64 rows) times the moment rows
  // into `part_e`.
  __device__ __forceinline__ void mma3(const uint32_t (&ah)[NF],
                                       const uint32_t (&al)[NF], int kk,
                                       uint64_t dh, uint64_t dl, bool fresh,
                                       int s) {
    Wgmma<T::BN + T::XN>::run(part, &al[4 * kk], dh + 2 * kk, fresh ? 0 : 1);
    Wgmma<T::BN + T::XN>::run(part, &ah[4 * kk], dl + 2 * kk, 1);
    Wgmma<T::BN + T::XN>::run(part, &ah[4 * kk], dh + 2 * kk, 1);
    if constexpr (T::R > 0) {
      const uint64_t bh = smem_desc(sm.b(s) + 64 * g * T::SK) + 2 * kk;
      const uint64_t bl = smem_desc(sm.blo(s) + 64 * g * T::SK) + 2 * kk;
      const uint64_t mh = smem_desc(sm.mhi(s)) + 2 * kk;
      const uint64_t ml = smem_desc(sm.mlo(s)) + 2 * kk;
      WgmmaSS<T::R>::run(part_e, bl, mh, fresh ? 0 : 1);
      WgmmaSS<T::R>::run(part_e, bh, ml, 1);
      WgmmaSS<T::R>::run(part_e, bh, mh, 1);
    }
  }

  // Issue stage st's wgmmas (k steps t0 = KK * st ..) as one group; a
  // ragged last stage multiplies TMA's zero fill. At a scheduled fault the
  // steps so far land and go into `acc` before the fault does; at a check,
  // the steps so far land and go into `acc` (and `acc_e`), then the check
  // runs and the stage sums restart from zero. A hook that sets kSegmented
  // (B3's and B4's checks, ~20 per run) has a stage with events issued in
  // segments that each end at one, so that its large check is inlined once
  // per call site of mma_stage and not once per k step (their kernels ran
  // 0.5-0.8 ms faster); the other hooks keep the unrolled form, which
  // segments made slower (B2 at the 64-row tiles 22-44 %; PERF.md).
  template <class Hook>
  __device__ __forceinline__ void mma_stage(int st, const uint32_t (&ah)[NF],
                                            const uint32_t (&al)[NF],
                                            Hook& hook) {
    const int s = st % T::STAGES, t0 = st * T::KK;
    const uint64_t dh = smem_desc(sm.b(s)), dl = smem_desc(sm.blo(s));
    wgmma_fence();
    if (!hook.within(st)) {
#pragma unroll
      for (int kk = 0; kk < T::KK; ++kk) {
        mma3(ah, al, kk, dh, dl, kk == 0, s);
        hook.kstep(*this, ah, al, kk, s);
      }
    } else if constexpr (Hook::kSegmented) {
      int k0 = 0;          // the first k step not issued
      bool fresh = false;  // k0 restarts the stage sum (after a fault)
      for (;;) {
        // The segment k0 .. k1: up to the step before the next fault or up
        // to the next check, whichever comes first.
        const int kf = min(hook.fault_step() - t0, T::KK);
        const int kc = min(hook.check_step() - t0, T::KK);
        const int k1 = min(kf - 1, kc);
#pragma unroll
        for (int kk = 0; kk < T::KK; ++kk)
          if (kk >= k0 && kk <= k1) {
            mma3(ah, al, kk, dh, dl, kk == 0 || (kk == k0 && fresh), s);
            hook.kstep(*this, ah, al, kk, s);
          }
        if (k1 == kc && kc < T::KK) {
          wgmma_commit();
          wgmma_wait_all();
          promote_clear();
          hook.check(*this);
          wgmma_fence();
          k0 = kc + 1;
          fresh = false;
        } else if (kf < T::KK) {
          if (kf > 0) {
            wgmma_commit();
            wgmma_wait_all();
            promote();
          }
          hook.apply(*this, t0 + kf);
          wgmma_fence();
          k0 = kf;
          fresh = true;
        } else {
          break;
        }
        if (k0 >= T::KK) break;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < T::KK; ++kk) {
        const bool fault = hook.at(t0 + kk);
        if (fault) {
          if (kk > 0) {
            wgmma_commit();
            wgmma_wait_all();
            promote();
          }
          hook.apply(*this, t0 + kk);
          wgmma_fence();
        }
        mma3(ah, al, kk, dh, dl, kk == 0 || fault, s);
        hook.kstep(*this, ah, al, kk, s);
        if (hook.check_after(t0 + kk)) {
          wgmma_commit();
          wgmma_wait_all();
          promote_clear();
          hook.check(*this);
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
  }

  // Stage st on registers (ch, cl) while stage st + 1 is prepared into
  // (nh, nl); then add st's sum into acc and release st's slot.
  template <class Hook>
  __device__ __forceinline__ void step(int st, int nst, Hook& hook,
                                       const uint32_t (&ch)[NF],
                                       const uint32_t (&cl)[NF],
                                       uint32_t (&nh)[NF], uint32_t (&nl)[NF]) {
    mma_stage(st, ch, cl, hook);
    if (st + 1 < nst) prepare(st + 1, nh, nl);
    wgmma_wait_all();
    promote();
    mbar_arrive(sm.empty(st % T::STAGES));
  }

  // The whole K loop: nst stages.
  template <class Hook>
  __device__ __forceinline__ void run(int nst, Hook& hook) {
    uint32_t h0[NF], l0[NF], h1[NF], l1[NF];
    prepare(0, h0, l0);
    for (int st = 0; st < nst; st += 2) {
      step(st, nst, hook, h0, l0, h1, l1);
      if (st + 1 < nst) step(st + 1, nst, hook, h1, l1, h0, l0);
    }
  }

  // out = alpha * acc + beta * C for this CTA's tile, a float2 per
  // column pair (out never aliases C); with MASK only the rows below M and
  // columns below N (a CTA larger than the padded operands).
  template <bool MASK = false>
  __device__ __forceinline__ void store(float* out, const float* C, int N,
                                        int m0, int n0, float alpha,
                                        float beta, int M = 0) const {
#pragma unroll
    for (int i = 0; i < T::NACC; i += 2) {
      if (MASK && (m0 + row(i) >= M || n0 + col(i) >= N)) continue;
      const size_t o = (size_t)(m0 + row(i)) * N + n0 + col(i);
      const float2 c = *reinterpret_cast<const float2*>(C + o);
      *reinterpret_cast<float2*>(out + o) = make_float2(
          alpha * acc[i] + beta * c.x, alpha * acc[i + 1] + beta * c.y);
    }
  }
};

// ---------------------------------------------------------------- host ----

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime's
// entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (rows, K) row-major f32 operand at p, in (box_rows, SK) boxes with the
// 128-byte swizzle; out-of-range columns read as zero.
inline bool tensor_map(CUtensorMap* map, const float* p, int rows, int K,
                       int box_rows, int sk) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)sk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (groups, planes, K) row-major f32 operand at p (the wrapper's moment
// rows), in boxes of box_planes rows of each of box_groups groups, SK
// columns, with the 128-byte swizzle: a box's row box_planes * g + v holds
// plane v of group g; out-of-range columns and groups read as zero.
inline bool tensor_map3(CUtensorMap* map, const float* p, int groups,
                        int planes, int K, int box_groups, int box_planes,
                        int sk) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)planes,
                              (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(float),
                                 (cuuint64_t)planes * K * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)sk, (cuuint32_t)box_planes,
                             (cuuint32_t)box_groups};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Before a launch of `kernel` on tile T: A's and B's tensor maps and the
// kernel's dynamic shared-memory limit. Returns 0, or the error the entry
// point reports like a launch error.
template <class T, class Kernel>
inline int wgmma_setup(Kernel kernel, CUtensorMap* ta, CUtensorMap* tb,
                       const float* A, const float* B, int M, int N, int K) {
  if (K % 8 || !tensor_map(ta, A, M, K, T::BM, T::SK) ||
      !tensor_map(tb, B, N, K, T::BN, T::SK))
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
}

FTSG_NAMESPACE_END  // ftsg

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
// of the product). Bare TF32 only in the FTSG_ONE_PASS build (the f32
// precision "default"): each k step adds a_hi b_hi alone, one wgmma where
// 3xTF32 issues three, and the expected sums that ride the product (below)
// likewise; the split runs as before. wgmma reads B from shared memory
// only, so
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
//
// bf16 operands (IN = kBF16; B1-B8): a stage holds SK = 64
// K columns, still one 128-byte swizzle row, and each 16-deep k step is one
// m64nNk16 bf16 wgmma on the operands as TMA landed them, A's fragment
// from registers (no split, no lo buffer); the accumulator and every sum
// stay f32. The hooks still count 8-column k steps: where a fault or a
// check falls between the two halves of a 16-deep step, the step is issued
// as two halves, each with the other half's A registers zero (and, for E,
// B's fragment loaded into registers the same way), so the product stops
// at exactly the bk step the hook names. The sums that ride the product
// (B's band rows, the moment rows) are f32 sums of the bf16 values,
// carried as three bf16 terms hi, lo and lo2 (XN = 24 band rows; three
// moment-row buffers, their products summed into the same `part_e`), so
// the expected sums keep f32 precision; the splitter warps form them (B3,
// B4, B5) and split nothing else. B6, B7 and B8 load the wrapper's rows,
// which come as the same three terms (ops/ft_sgemm._tile_moments), by TMA:
// one box per term into term t's moment buffer and into B's rows BN + 8 t
// .., their padding rows zeroed by the whole CTA before the ring starts
// (WgSmem::init). Those kernels, B1 and B2 have no splitter work: the
// consumers wait for TMA's full barrier directly.
//
// int8 operands (IN = kS8; B3 and B4, the exact mode): a stage holds SK =
// 128 K columns (one 128-byte swizzle row), each 32-deep k step is one
// m64nNk32 s8 wgmma, both operands K-major, into an s32 accumulator with no
// saturation, so that every sum wraps mod 2^32 as the JAX package's int32
// does. The stage sums `part` are not used: exact integer adds need no
// per-stage promotion, and the wgmmas accumulate into `acc` directly (the
// accumulator's s32 bits held as uint32_t, whose wrapping C++ defines). A
// band sum s of B's (or A's) rows, |s| <= 128 * 128, rides the product as
// two s8 digits lo = s & 127 and hi = s >> 7 (s = 128 hi + lo): B's band
// rows BN + j (lo) and BN + 8 + j (hi), XN = 16, so the product runs as
// m64n144k32 and a row's expected sum over band j is P_lo + 128 P_hi, equal
// mod 2^32 to the JAX package's wrapping sum; A's moment rows likewise at
// rows v (lo) and 8 + v (hi) of one 16-row buffer. The hooks still count
// 8-column k steps: a check inside a 32-deep step issues the step in parts,
// each with A's registers of the other 8-column steps zero (and E's A
// operand, B's stage, loaded into registers the same way). A fault is added
// at the start of the part it falls in (after the wgmmas before it land):
// integer adds commute, so the accumulator at every check is the same.
//
// fp8 operands (B1 only; the FT kernels multiply fp8 on their bf16 builds,
// the wrapper widening the e4m3 operands exactly): int8's 1-byte stage (SK
// = 128 K columns, one 128-byte swizzle row, rows 16 bytes apart), one
// m64nNk32 e4m3 wgmma per 32-deep k step (IN = kE4M3) into the f32 stage
// sum `part`, promoted into `acc` after every k step: Hopper's fp8 wgmma
// keeps ~13 bits below the largest product of a k step, so its sum drifts
// even over one stage (promoted once a stage, B1 had 2.9x the error;
// PERF.md).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>
#include <type_traits>

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
// 2; in bf16 one box per term of the wrapper's (gm, 3 rows, K)), or sums
// over A's landed stage by the splitter warps, one job per sub-tile row
// band and column (shared by 8 lanes at the 128-row sub-tile) after B's
// split (B5: WgSmem::sum_rows) or in 8-row groups beside B's split (B3:
// WgSmem::split_b). B5 on the 8-row groups ran 13-30 % slower at the 16-
// to 64-row sub-tiles (PERF.md).
enum MomentRows {
  kNoRows = 0,
  kLoadRows = 1,
  kSumRows = 2,
  kSumRowGroups = 3
};

// Where B's band rows (rows BN .. BN + NBN - 1 of B's stage, the operand of
// the expected row sums) come from: none (B1, B2, B5, B6), sums over B's
// landed stage by the splitter warps, in 8-row groups (B3: WgSmem::split_b)
// or per band by lane groups (B4: WgSmem::split_bands), or a TMA box of the
// wrapper's (N / SBN, K) band rows
// (B7, B8), which the splitter warps only split (in bf16 one box per term
// of the wrapper's (N / SBN, 3, K), not split).
enum BandRows {
  kNoBands = 0,
  kSumBands = 1,
  kLoadBands = 2
};

// The type of A and B (C, the accumulator and every checksum are f32):
// f32 on 3xTF32, bf16 on one bf16 wgmma per 16-deep k step, int8 on one
// s8 wgmma per 32-deep k step (the accumulator and checksums then s32), or
// fp8 (e4m3, B1 only) on one e4m3 wgmma per 32-deep k step.
enum InType { kF32 = 0, kBF16 = 1, kS8 = 2, kE4M3 = 3 };

// The accumulator's element type for A and B of type IN: f32, or the s32
// bits of the int8 mode as uint32_t (wrapping arithmetic, defined in C++).
template <int IN>
using AccOf = std::conditional_t<IN == kS8, uint32_t, float>;

// A CTA of (BM, BN) checked in (SBM, SBN) sub-tiles, with MOM moment rows
// per sub-tile row band in each stage (0: none, B1, B2, B4, B8; padded to
// R, a multiple of 8) from ROWS, CHECK bytes of check scratch beside the
// ring, and, with BANDS, XN = 8 extra product columns (24 in bf16: three
// terms; 16 in int8: two digits): B's column-band sums, so that the
// product's columns BN .. BN + NBN - 1 are the expected row sums of each
// band (B3, B4, B7, B8); A and B of type IN. The ring has four stages where
// they fit in the 232448 bytes of shared memory a CTA may have, else three;
// a bf16, int8 or fp8 ring up to six where they fit beside the CTAs an SM
// holds.
template <int BM_, int BN_, int SBM_ = BM_, int SBN_ = BN_, int MOM_ = 0,
          int CHECK_ = 0, int BANDS_ = kNoBands, int ROWS_ = kNoRows,
          int IN_ = kF32>
struct WgTile {
  static constexpr int BM = BM_, BN = BN_, SBM = SBM_, SBN = SBN_;
  static constexpr int NBM = BM / SBM, NBN = BN / SBN, NSUB = NBM * NBN;
  static constexpr int BANDS = BANDS_, ROWS = ROWS_;
  static constexpr bool BF16 = IN_ == kBF16;
  static constexpr bool S8 = IN_ == kS8;
  static constexpr bool F8 = IN_ == kE4M3;
  using Acc = AccOf<IN_>;
  // Rows that carry one sum row: 1 in f32 (split hi / lo like B), the bf16
  // terms hi, lo and lo2 in bf16, the s8 digits lo and hi in int8.
  static constexpr int NTERM = BF16 ? 3 : S8 ? 2 : 1;
  // Moment rows: MOM per row band, padded to a multiple of 8 (in int8 two
  // such groups, the digits lo and hi).
  static constexpr int MOM = MOM_,
                       R = (MOM * NBM + 7) / 8 * 8 * (S8 ? NTERM : 1);
  static constexpr int XN = BANDS == kNoBands ? 0 : 8 * NTERM;
  // Bytes of an A or B element.
  static constexpr int ESIZE = BF16 ? 2 : S8 || F8 ? 1 : 4;
  static constexpr int SK = 128 / ESIZE;  // K columns per stage: one swizzle row
  static constexpr int KK = SK / 8;   // 8-deep k steps per stage (the hooks')
  static constexpr int KS = BF16 ? 2 : S8 || F8 ? 4 : 1;  // of them per wgmma k step
  static constexpr int KW = KK / KS;       // wgmma k steps per stage
  // Whether the producer's splitter warps work on a landed stage before the
  // consumers take it (the ready barrier): always in f32 (B's split); in
  // bf16, int8 and fp8 only where they form sum rows.
  static constexpr bool SPLIT = (!BF16 && !S8 && !F8) || BANDS == kSumBands ||
                                ROWS == kSumRows || ROWS == kSumRowGroups;
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
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BOX = BN * 128;  // the TMA box of B
  static constexpr int B_BYTES = (BN + XN) * 128;
  static constexpr int M_BYTES = R * 128;  // one buffer of moment rows
  // B's buffers and the moment rows' per stage: hi and lo in f32; B as
  // landed and the moment rows' three terms in bf16; B as landed and one
  // buffer of both digits' rows in int8; B as landed in fp8.
  static constexpr int NB_BUF = BF16 || S8 || F8 ? 1 : 2,
                       NM_BUF = BF16 ? 3 : S8 ? 1 : 2;
  static constexpr int STAGE_BYTES =
      A_BYTES + NB_BUF * B_BYTES + NM_BUF * M_BYTES;
  // The rows a stage's TMA boxes fill: where loaded, exactly the NBN band
  // rows and the MOM * NBM moment rows the checks read, one box of each
  // per term; the full barrier expects these bytes, and the padding rows
  // past them stay zero.
  static constexpr int BAND_BOX = BANDS == kLoadBands ? NBN * 128 : 0;
  static constexpr int M_BOX = ROWS == kLoadRows ? MOM * NBM * 128 : 0;
  static constexpr int TX_BYTES = A_BYTES + B_BOX + NTERM * (BAND_BOX + M_BOX);
  static constexpr int CHECK_BYTES = CHECK_;
  // The splitters' 8-row sums (WgSmem::split_b) of B (B3's kSumBands) and
  // of A's moments (kSumRowGroups), rows of SK floats per stage; B4's band
  // sums need none (WgSmem::split_bands).
  static constexpr int PROD_ROWS =
      (BANDS == kSumBands && ROWS == kSumRowGroups ? BN / 8 : 0) +
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
  // The shared memory a CTA may use when MIN_CTAS share an SM's 233472
  // bytes (1024 of them reserved per CTA).
  static constexpr int SMEM_CAP =
      MIN_CTAS == 1 ? 232448 : 233472 / MIN_CTAS - 1024;
  static constexpr int STAGES =
      !BF16 && !S8 && !F8 ? (smem(4, 1) <= 232448 ? 4 : 3)
            : smem(6, 1) <= SMEM_CAP   ? 6
              : smem(5, 1) <= SMEM_CAP ? 5
              : smem(4, 1) <= SMEM_CAP ? 4
                                       : 3;
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
  static_assert(XN == 0 || (XN == 8 * NTERM && NBN <= 8 && SBN % 8 == 0),
                "one extra column per column band and term");
  static_assert(!F8 || (XN == 0 && R == 0), "e4m3 wgmma: B1, no sum rows");
  static_assert(!S8 || (BANDS == kSumBands && MOM * NBM <= 8 &&
                        (ROWS == kNoRows || ROWS == kSumRowGroups)),
                "int8: B3 and B4, one 8-row group of moment rows per digit");
  static_assert(REGS_CONSUMER <= 256, "setmaxnreg takes at most 256");
  static_assert(B_BYTES % 1024 == 0 && M_BYTES % 1024 == 0,
                "buffers keep the swizzle alignment");
  static_assert(BANDS != kLoadBands || B_BOX % 1024 == 0,
                "the band-row box starts on a swizzle atom");
  static_assert(SMEM <= (BF16 || S8 || F8 ? SMEM_CAP : 232448),
                "the ring fits in shared memory");
};

// The tile's own CTA (no sub-tiles, no sum rows) with A and B of type IN.
template <int BM, int BN, int IN>
using WgTileOf = WgTile<BM, BN, BM, BN, 0, 0, kNoBands, kNoRows, IN>;

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

// Whether the barrier's phase of parity `parity` has completed, without
// waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait up to about `ns` nanoseconds, suspended (no instructions issued),
// for the barrier's phase of parity `parity`; whether it completed.
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity, int ns) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity), "r"(ns)
      : "memory");
  return done != 0;
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

// TMA of a 4-D map: the (groups, 1, planes, SK) box at (k0, plane0, term,
// group0).
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int k0, int plane0,
                                          int term, int group0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0),
      "r"(plane0), "r"(term), "r"(group0)
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

// Named barrier 3 over the producer's NT splitter threads when they
// check (the rowcol kernels' checker warps).
template <int NT>
__device__ __forceinline__ void checker_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(NT) : "memory");
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

// An f32 pair (x, y) as three words of bf16 pairs, terms hi, lo and lo2:
// x = hi + lo + lo2 to f32 precision (each remainder is exact in f32), the
// split of ops/ft_sgemm._tile_moments; x in each word's low half.
__device__ __forceinline__ void bf16x3(float x, float y, uint32_t (&w)[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
    w[t] = (uint32_t)__bfloat16_as_ushort(hx) |
           (uint32_t)__bfloat16_as_ushort(hy) << 16;
    x -= __bfloat162float(hx);
    y -= __bfloat162float(hy);
  }
}

// The two bf16 of a word, exactly as f32 (the lower column in the low half).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Word index of column pair p (columns 2 p, 2 p + 1) of row r of a bf16
// buffer in the 128-byte swizzle: 32 words a row, the 16-byte chunk c of
// row r stored at chunk c ^ (r & 7).
__device__ __forceinline__ int swz_word(int r, int p) {
  return r * 32 + (((p >> 2) ^ (r & 7)) << 2) + (p & 3);
}

// The sums of N values over the G lanes of an aligned lane group (u = the
// lane's index in it), in rounds over the lane bits OFF = G / 2 .. 1, the
// highest first, each adding the partner's copy: every total is the same
// tree over the group's lanes, pairs by the highest bit first
// (ops/tf32x3.lane_tree repeats it). While more than KEEP values are left,
// a round also halves them: the lane with the bit set keeps the upper half.
// After the call v[0 .. KEEP - 1] holds the totals of block (u & G / 2 ? 1 :
// 0) * N / 2 + (u & G / 4 ? 1 : 0) * N / 4 + .. (KEEP values each), the same
// in every lane of the bits below the halving rounds.
template <int OFF, int N, int KEEP, class V, int NV>
__device__ __forceinline__ void lane_rounds(V (&v)[NV], int u) {
  if constexpr (OFF >= 1) {
    if constexpr (N > KEEP) {
      const bool up = (u & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const V send = up ? v[i] : v[i + N / 2];
        const V keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      lane_rounds<OFF / 2, N / 2, KEEP>(v, u);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
      lane_rounds<OFF / 2, N, KEEP>(v, u);
    }
  }
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

// d (m64 x N, f32) = A (m64 x k16, bf16 fragment in registers: two bf16
// a register, registers 0 and 1 the first 8 columns, 2 and 3 the last 8) @
// B^T (+ d when scale_d is 1), B an (N x k16) bf16 tile in shared memory,
// K-major (no transpose); asynchronous until wgmma_wait_all.
template <int N>
struct WgmmaBf;

template <>
struct WgmmaBf<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf<24> {
  static __device__ __forceinline__ void run(float (&d)[12], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
struct WgmmaBf<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

template <>
struct WgmmaBf<152> {
  static __device__ __forceinline__ void run(float (&d)[76], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %81, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75}, "
        "{%76, %77, %78, %79}, %80, p, 1, 1, 0;\n}\n"
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
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// d (m64 x N, f32) = A (m64 x k16) @ B^T (+ d when scale_d is 1), both
// bf16 tiles in shared memory, K-major: the expected-moment product in bf16.
template <int N>
struct WgmmaSSBf;

template <>
struct WgmmaSSBf<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSSBf<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSSBf<24> {
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// d (m64 x N, s32) = A (m64 x k32, s8 fragment in registers: four s8 a
// register, registers 0 and 1 the first 16 columns, 2 and 3 the last 16) @
// B^T (+ d when scale_d is 1), B an (N x k32) s8 tile in shared memory,
// K-major; no .satfinite, so the s32 sums wrap mod 2^32. Asynchronous until
// wgmma_wait_all. N = 144: the product widened by B's 16 digit rows; N = 16:
// E's masked parts (B's stage in registers times the moment rows).
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void run(uint32_t (&d)[8],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<144> {
  static __device__ __forceinline__ void run(uint32_t (&d)[72],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// d (m64 x N, f32) = A (m64 x k32, e4m3 fragment in registers: four e4m3 a
// register, registers 0 and 1 the first 16 columns, 2 and 3 the last 16, as
// in int8) @ B^T (+ d when scale_d is 1), B an (N x k32) e4m3 tile in
// shared memory, K-major; asynchronous until wgmma_wait_all. The tensor
// cores keep ~13 bits below the k step's largest product (B1 promotes the
// sum after every k step).
template <int N>
struct WgmmaE4;

template <>
struct WgmmaE4<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.f32.e4m3.e4m3 "
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
struct WgmmaE4<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
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
struct WgmmaE4<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
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

// d (m64 x N, s32) = A (m64 x k32) @ B^T (+ d when scale_d is 1), both s8
// tiles in shared memory, K-major: the expected column sums in int8.
template <int N>
struct WgmmaSSS8;

template <>
struct WgmmaSSS8<16> {
  static __device__ __forceinline__ void run(uint32_t (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


// ------------------------------------------------------------ mainloop ----

extern __shared__ unsigned char ftsg_wg_smem[];

// The ring in dynamic shared memory, aligned to 1024 bytes: stage s holds
// A's box, B's box (hi after the split; with XN > 0 followed by B's band
// rows), B's lo (likewise; not in bf16 or int8) and, with R > 0, the moment
// rows' hi and lo (in bf16 their three terms, in int8 one buffer of both
// digits' rows);
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
                                    T::NB_BUF * T::B_BYTES);
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
  // bf16 buffers as words (swz_word): A's and B's of stage s, and term t
  // of its moment rows.
  __device__ __forceinline__ uint32_t* aw(int s) const {
    return reinterpret_cast<uint32_t*>(a(s));
  }
  __device__ __forceinline__ uint32_t* bw(int s) const {
    return reinterpret_cast<uint32_t*>(b(s));
  }
  __device__ __forceinline__ uint32_t* mw(int s, int t) const {
    return reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(
                                           mhi(s)) + t * T::M_BYTES);
  }

  // Thread 0 initialises the barriers; the whole CTA waits for it. In
  // bf16 with loaded rows (B6-B8), whose consumers wait on the full barrier
  // alone, the whole CTA first zeroes every ring slot's padding rows, which
  // no box writes.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < T::STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(ready(s), T::SPLITTERS);
        mbar_init(empty(s), T::NCONS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (T::BF16 && !T::SPLIT && PADS) {
      for (int s = 0; s < T::STAGES; ++s)
        zero_pads_bf16<T::NT>(s, threadIdx.x);
      fence_proxy_async();  // the zeros are visible to wgmma
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

  // B5's moment rows (kSumRows): for each sub-tile row band b and column k
  // of the stage, the sums of A's rows with weights 1, w, w^2 (w = row in
  // the band + 1), rows 3 b .. 3 b + 2. A job is one (band, column); at the
  // 128-row sub-tiles G = 8 lanes of a warp share it, lane u summing rows
  // u, u + 8, .. (16 of them, in order), and the lanes' sums meet by
  // shuffles over the lane bits 4, 2, 1 (ops/tf32x3.moment_rows_b5 repeats
  // the order); below, one lane sums the band's rows (G = 1). Warp w takes
  // the jobs' sets x = w, w + 3, .. < ROW_SETS (the band x / G, chunk G (gw
  // / 4) + x % G and column 4 chunk + gw % 4 of the stage for the lane's
  // group gw = lane / G), so that the 32 lanes of a load read 32 banks.
  // (One lane a job summing the band's 128 rows left two of the three warps
  // idle at the 128-row sub-tiles, and the sums set the pace of B5 there;
  // lane groups at the 64- and 32-row sub-tiles made B5 3-9 % slower than
  // one lane a job; PERF.md.)
  static constexpr int ROW_LANES = T::SBM == 128 ? 8 : 1;
  static constexpr int ROW_N = T::SBM / ROW_LANES;  // rows a lane
  static constexpr int ROW_SETS = T::NBM * ROW_LANES;
  __device__ __forceinline__ int row_job(int e, int x, int& band) const {
    constexpr int G = ROW_LANES;
    const int gw = (e & 31) / G;
    band = x / G;
    return 4 * (G * (gw >> 2) + x % G) + (gw & 3);
  }

  // The moment rows of stage s in f32, split hi / lo in the swizzled
  // K-major layout of a TMA box; the padding rows are zero.
  __device__ __forceinline__ void sum_rows(int s, int e) const {
    constexpr int G = ROW_LANES;
    const int u = (e & 31) % G;
    const float* a_ = a(s);
    float* hi = mhi(s);
    float* lo = mlo(s);
    for (int x = e >> 5; x < ROW_SETS; x += 3) {
      int band;
      const int k = row_job(e, x, band);
      float sv[3] = {0.f, 0.f, 0.f};
#pragma unroll 8
      for (int i = 0; i < ROW_N; ++i) {
        const int rr = u + G * i, r = band * T::SBM + rr;
        const float v = a_[r * T::SK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)];
        const float w = (float)(rr + 1);
        sv[0] += v;
        sv[1] = fmaf(w, v, sv[1]);
        sv[2] = fmaf(w * w, v, sv[2]);
      }
#pragma unroll
      for (int off = G / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          sv[v] += __shfl_xor_sync(0xffffffffu, sv[v], off);
      if (u == 0) {
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
    }
    for (int j = 3 * T::NBM * T::SK + e; j < T::R * T::SK; j += T::SPLITTERS)
      hi[j] = lo[j] = 0.f;
  }

  // Whether a stage has padding rows that no box and no sum writes: B's
  // band rows past NBN (of each term) up to BN + XN, and the moment rows
  // past MOM * NBM up to R (B5's sum_rows writes its own zeros).
  static constexpr bool PADS = T::XN > T::NBN * T::NTERM ||
                               (T::R > T::MOM * T::NBM && T::ROWS != kSumRows);

  // bf16: those rows of ring slot s, of every term, zeroed once before the
  // first stage by the STEP threads e = 0 .. STEP - 1 (the splitter warps,
  // or the whole CTA).
  template <int STEP = T::SPLITTERS>
  __device__ __forceinline__ void zero_pads_bf16(int s, int e) const {
    if constexpr (T::XN > 0) {
      for (int z = e; z < T::XN * 32; z += STEP)
        if (z / 32 % 8 >= T::NBN) bw(s)[T::BN * 32 + z] = 0u;
    }
    for (int z = T::MOM * T::NBM * 32 + e; z < T::R * 32; z += STEP)
      mw(s, 0)[z] = mw(s, 1)[z] = mw(s, 2)[z] = 0u;
  }

  // The moment rows of stage s in bf16 (sum_rows' jobs, a job a column
  // pair): the f32 sums of A's bf16 values as the three bf16 terms of
  // rows 3 b .. 3 b + 2 of the term buffers; the padding rows are zero.
  __device__ __forceinline__ void sum_rows_bf16(int s, int e) const {
    constexpr int G = ROW_LANES;
    const int u = (e & 31) % G;
    const uint32_t* a_ = aw(s);
    for (int x = e >> 5; x < ROW_SETS; x += 3) {
      int band;
      const int p = row_job(e, x, band);
      float sv[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int i = 0; i < ROW_N; ++i) {
        const int rr = u + G * i;
        const uint32_t v = a_[swz_word(band * T::SBM + rr, p)];
        const float x0 = bf16_lo(v), x1 = bf16_hi(v);
        const float w = (float)(rr + 1);
        sv[0][0] += x0;
        sv[0][1] += x1;
        sv[1][0] = fmaf(w, x0, sv[1][0]);
        sv[1][1] = fmaf(w, x1, sv[1][1]);
        sv[2][0] = fmaf(w * w, x0, sv[2][0]);
        sv[2][1] = fmaf(w * w, x1, sv[2][1]);
      }
#pragma unroll
      for (int off = G / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sv[v][c] += __shfl_xor_sync(0xffffffffu, sv[v][c], off);
      if (u == 0) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          uint32_t w3[3];
          bf16x3(sv[v][0], sv[v][1], w3);
          const int o = swz_word(3 * band + v, p);
#pragma unroll
          for (int t = 0; t < 3; ++t) mw(s, t)[o] = w3[t];
        }
      }
    }
    for (int z = 3 * T::NBM * 32 + e; z < T::R * 32; z += T::SPLITTERS)
      mw(s, 0)[z] = mw(s, 1)[z] = mw(s, 2)[z] = 0u;
  }

  // bf16 B3's sum rows of stage st: B's column-band sums
  // (kSumBands) as rows BN + 8 t + j (term t, band j) of B's stage, and
  // A's row-band moment sums (kSumRowGroups) as row MOM b + v of the term
  // buffers, all f32 sums of the bf16 values. A job sums 8 rows of one
  // 16-byte chunk (8 columns) of B or of A into the producer scratch, a
  // warp's jobs all of one operand; after a named barrier over the
  // splitter warps, one job per output row and column pair adds its band's
  // 8-row sums and writes their three terms.
  __device__ __forceinline__ void sum_bands_bf16(int st, int e) const {
    const int s = st % T::STAGES;
    constexpr bool SB = T::BANDS == kSumBands, SA = T::ROWS == kSumRowGroups;
    constexpr int G = T::BN / 8, GA = T::BM / 8;  // 8-row groups
    const uint4* b4 = reinterpret_cast<const uint4*>(b(s));
    const uint4* a4 = reinterpret_cast<const uint4*>(a(s));
    float* pb = prod() + (T::PROD_SETS == 2 ? st & 1 : 0) * T::PROD_ROWS *
                             T::SK;
    float* pa = pb + (SB ? G : 0) * T::SK;
    constexpr int NJB = SB ? 8 * G : 0, NJA = SA ? 8 * GA : 0;
    static_assert(NJB % 32 == 0, "a warp's jobs of one operand");
    for (int job = e; job < NJB + NJA; job += T::SPLITTERS) {
      const bool is_a = job >= NJB;
      const int idx = is_a ? job - NJB : job;
      const int grp = idx / 8, c = idx % 8;  // rows 8 grp .., chunk c
      if (!is_a) {
        float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const uint4 v = b4[(8 * grp + rr) * 8 + (c ^ rr)];
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sum[2 * q] += bf16_lo(w4[q]);
            sum[2 * q + 1] += bf16_hi(w4[q]);
          }
        }
        float4* d = reinterpret_cast<float4*>(pb + grp * T::SK + 8 * c);
        d[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
        d[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
      } else if constexpr (SA) {
        float sv[T::MOM][8];
#pragma unroll
        for (int v = 0; v < T::MOM; ++v)
#pragma unroll
          for (int q = 0; q < 8; ++q) sv[v][q] = 0.f;
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int n = 8 * grp + rr;
          const uint4 x4 = a4[n * 8 + (c ^ rr)];
          const uint32_t w4[4] = {x4.x, x4.y, x4.z, x4.w};
          const float w = (float)(n % T::SBM + 1);
          float wv = 1.f;
#pragma unroll
          for (int v = 0; v < T::MOM; ++v) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              sv[v][2 * q] += wv * bf16_lo(w4[q]);
              sv[v][2 * q + 1] += wv * bf16_hi(w4[q]);
            }
            wv *= w;
          }
        }
#pragma unroll
        for (int v = 0; v < T::MOM; ++v) {
          float4* d = reinterpret_cast<float4*>(pa + (v * GA + grp) * T::SK +
                                                8 * c);
          d[0] = make_float4(sv[v][0], sv[v][1], sv[v][2], sv[v][3]);
          d[1] = make_float4(sv[v][4], sv[v][5], sv[v][6], sv[v][7]);
        }
      }
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(T::SPLITTERS) : "memory");
    constexpr int NB = SB ? T::NBN * 32 : 0;
    constexpr int NA = SA ? T::MOM * T::NBM * 32 : 0;
    for (int job = e; job < NB + NA; job += T::SPLITTERS) {
      float2 sum = make_float2(0.f, 0.f);
      uint32_t w3[3];
      if (job < NB) {  // B's band sum j: rows BN + 8 t + j
        const int j = job / 32, p = job % 32;
#pragma unroll
        for (int g = 0; g < T::SBN / 8; ++g) {
          const float2 x = reinterpret_cast<const float2*>(
              pb + (j * (T::SBN / 8) + g) * T::SK)[p];
          sum.x += x.x;
          sum.y += x.y;
        }
        bf16x3(sum.x, sum.y, w3);
#pragma unroll
        for (int t = 0; t < 3; ++t) bw(s)[swz_word(T::BN + 8 * t + j, p)] = w3[t];
      } else {  // A's moment row n = MOM b + v
        const int n = (job - NB) / 32, p = (job - NB) % 32;
        const int band = n / T::MOM, v = n % T::MOM;
#pragma unroll
        for (int g = 0; g < T::SBM / 8; ++g) {
          const float2 x = reinterpret_cast<const float2*>(
              pa + (v * GA + band * (T::SBM / 8) + g) * T::SK)[p];
          sum.x += x.x;
          sum.y += x.y;
        }
        bf16x3(sum.x, sum.y, w3);
        const int o = swz_word(n, p);
#pragma unroll
        for (int t = 0; t < 3; ++t) mw(s, t)[o] = w3[t];
      }
    }
    if constexpr (T::PROD_SETS == 1)  // the scratch is read before reuse
      asm volatile("bar.sync 2, %0;\n" ::"n"(T::SPLITTERS) : "memory");
  }

  // int8: the padding rows of ring slot s, of both digits, zeroed once
  // before the first stage: B's band rows BN + 8 t + j with j >= NBN, and the
  // moment rows 8 t + v with v >= MOM * NBM.
  __device__ __forceinline__ void zero_pads_s8(int s, int e) const {
    for (int z = e; z < T::XN * 32; z += T::SPLITTERS)
      if (z / 32 % 8 >= T::NBN) bw(s)[T::BN * 32 + z] = 0u;
    for (int z = e; z < T::R * 32; z += T::SPLITTERS)
      if (z / 32 % 8 >= T::MOM * T::NBM) mw(s, 0)[z] = 0u;
  }

  // The digits lo = s & 127 and hi = s >> 7 (s = 128 hi + lo, both in s8 for
  // |s| <= 128 * 128) of the four column sums of a 4-byte word, as two words
  // of four s8.
  static __device__ __forceinline__ void digits(const int4& s, uint32_t& lo,
                                                uint32_t& hi) {
    const int v[4] = {s.x, s.y, s.z, s.w};
    lo = hi = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo |= (uint32_t)(v[q] & 127) << (8 * q);
      hi |= (uint32_t)((v[q] >> 7) & 255) << (8 * q);
    }
  }

  // int8 B3's sum rows of stage st: B's column-band sums
  // (kSumBands) as the digit rows BN + j (lo) and BN + 8 + j (hi) of B's
  // stage, and A's row-band sums (kSumRowGroups, MOM = 1) as rows b (lo) and
  // 8 + b (hi) of the moment buffer; exact integer sums. A job sums 8 rows of
  // one 16-byte chunk (16 columns) of B or of A into the producer scratch
  // (int32 per column), a warp's jobs all of one operand: each byte biased
  // to x + 128, two columns a word in 16-bit lanes (8 * 255 < 2^16, so no
  // lane carries into the next). After a named barrier over the splitter
  // warps, one job per output row and 4-column word adds its band's 8-row
  // sums and writes both digits.
  __device__ __forceinline__ void sum_bands_s8(int st, int e) const {
    const int s = st % T::STAGES;
    constexpr bool SB = T::BANDS == kSumBands, SA = T::ROWS == kSumRowGroups;
    constexpr int G = T::BN / 8, GA = T::BM / 8;  // 8-row groups
    const uint4* b4 = reinterpret_cast<const uint4*>(b(s));
    const uint4* a4 = reinterpret_cast<const uint4*>(a(s));
    int* pb = reinterpret_cast<int*>(prod()) +
              (T::PROD_SETS == 2 ? st & 1 : 0) * T::PROD_ROWS * T::SK;
    int* pa = pb + (SB ? G : 0) * T::SK;
    constexpr int NJB = SB ? 8 * G : 0, NJA = SA ? 8 * GA : 0;
    static_assert(NJB % 32 == 0, "a warp's jobs of one operand");
    for (int job = e; job < NJB + NJA; job += T::SPLITTERS) {
      const bool is_a = job >= NJB;
      const int idx = is_a ? job - NJB : job;
      const int grp = idx / 8, c = idx % 8;  // rows 8 grp .., chunk c
      const uint4* src = is_a ? a4 : b4;
      // ev[q]: columns 4 q and 4 q + 2 of word q; od[q]: 4 q + 1, 4 q + 3.
      uint32_t ev[4] = {0u, 0u, 0u, 0u}, od[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const uint4 v = src[(8 * grp + rr) * 8 + (c ^ rr)];
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t u = w4[q] ^ 0x80808080u;  // x + 128 per byte
          ev[q] += u & 0x00ff00ffu;
          od[q] += (u >> 8) & 0x00ff00ffu;
        }
      }
      int4* d = reinterpret_cast<int4*>((is_a ? pa : pb) + grp * T::SK +
                                        16 * c);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[q] = make_int4((int)(ev[q] & 0xffffu) - 1024,
                         (int)(od[q] & 0xffffu) - 1024,
                         (int)(ev[q] >> 16) - 1024, (int)(od[q] >> 16) - 1024);
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(T::SPLITTERS) : "memory");
    constexpr int NB = SB ? T::NBN * 32 : 0;
    constexpr int NA = SA ? T::MOM * T::NBM * 32 : 0;
    for (int job = e; job < NB + NA; job += T::SPLITTERS) {
      int4 sum = make_int4(0, 0, 0, 0);
      uint32_t lo, hi;
      const int p = job % 32;  // the 4-column word
      if (job < NB) {  // B's band sum j: rows BN + j, BN + 8 + j
        const int j = job / 32;
#pragma unroll
        for (int g = 0; g < T::SBN / 8; ++g) {
          const int4 x = reinterpret_cast<const int4*>(
              pb + (j * (T::SBN / 8) + g) * T::SK)[p];
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        digits(sum, lo, hi);
        bw(s)[swz_word(T::BN + j, p)] = lo;
        bw(s)[swz_word(T::BN + 8 + j, p)] = hi;
      } else {  // A's row band n: moment rows n, 8 + n
        const int n = (job - NB) / 32;
#pragma unroll
        for (int g = 0; g < T::SBM / 8; ++g) {
          const int4 x = reinterpret_cast<const int4*>(
              pa + (n * (T::SBM / 8) + g) * T::SK)[p];
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        digits(sum, lo, hi);
        mw(s, 0)[swz_word(n, p)] = lo;
        mw(s, 0)[swz_word(8 + n, p)] = hi;
      }
    }
    if constexpr (T::PROD_SETS == 1)  // the scratch is read before reuse
      asm volatile("bar.sync 2, %0;\n" ::"n"(T::SPLITTERS) : "memory");
  }

  // B4's band rows (kSumBands without moment rows): for each column band j
  // the sums of its SBN rows of B, one job per (band, 16-byte chunk of the
  // stage), G = SBN / 4 lanes of a warp a job, lane u taking rows u, u + G,
  // .. (BAND_ROWS of them) in order, the lanes' sums meeting by lane_rounds (a
  // column's total in one lane of each pair .. group of lanes below the
  // halving rounds), with no scratch and no barrier between the splitter
  // warps: each warp takes the jobs' sets x = warp, warp + 3, .. <
  // BAND_SETS (at G >= 8 jobs x 32 / G + gw, gw = lane / G; at G = 4 band
  // x, chunk 4 (gw % 2) + gw / 2, so that the lanes of a 16-byte phase read
  // 8 banks' chunks).
  // (In 8-row sums through the producer scratch, a named barrier and a
  // second pass a stage, B4 in f32 ran 0.5-0.7 ms slower than B8, which
  // only splits; PERF.md.)
  static constexpr int BAND_LANES = T::SBN / 4;
  // Rows a lane, and the jobs' sets (32 lanes each) of a stage.
  static constexpr int BAND_ROWS = T::SBN / BAND_LANES;
  static constexpr int BAND_SETS = T::NBN * 8 * BAND_LANES / 32;
  __device__ __forceinline__ void band_job(int e, int x, int& j,
                                           int& c) const {
    constexpr int G = BAND_LANES;
    const int gw = (e & 31) / G;
    if constexpr (G < 8) {
      j = x;
      c = 4 * (gw & 1) + (gw >> 1);
    } else {
      const int jb = x * (32 / G) + gw;
      j = jb / 8;
      c = jb % 8;
    }
  }

  // f32: B's stage s split hi / lo in place (as split4) and, in the same
  // pass, row BN + j of the band sums of B's f32 values (as B8's wrapper and
  // the plain version sum them; hi + lo differs by ~2^-22 of a value), split
  // the same way.
  __device__ __forceinline__ void split_bands(int s, int e) const {
    constexpr int G = BAND_LANES;
    const int u = (e & 31) % G;
    float4* hi4 = reinterpret_cast<float4*>(b(s));
    float4* lo4 = reinterpret_cast<float4*>(blo(s));
    for (int x = e >> 5; x < BAND_SETS; x += 3) {
      int j, c;
      band_job(e, x, j, c);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BAND_ROWS; ++i) {
        const int r = j * T::SBN + u + G * i, o = r * 8 + (c ^ (r & 7));
        const float4 x4 = hi4[o];
        uint32_t h[4], l[4];
        split_tf32(x4.x, h[0], l[0]);
        split_tf32(x4.y, h[1], l[1]);
        split_tf32(x4.z, h[2], l[2]);
        split_tf32(x4.w, h[3], l[3]);
        hi4[o] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                             __uint_as_float(h[2]), __uint_as_float(h[3]));
        lo4[o] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                             __uint_as_float(l[2]), __uint_as_float(l[3]));
        v[0] += x4.x;
        v[1] += x4.y;
        v[2] += x4.z;
        v[3] += x4.w;
      }
      lane_rounds<G / 2, 4, 1>(v, u);
      if ((u & (G / 4 - 1)) == 0) {
        const int k = 4 * c + (u & (G / 2) ? 2 : 0) + (u & (G / 4) ? 1 : 0);
        const int n = T::BN + j;
        const int o = n * T::SK + (((k >> 2) ^ (n & 7)) << 2) + (k & 3);
        uint32_t h, l;
        split_tf32(v[0], h, l);
        b(s)[o] = __uint_as_float(h);
        blo(s)[o] = __uint_as_float(l);
      }
    }
  }

  // bf16: the band sums (f32 sums of the bf16 values) of stage s as the
  // three bf16 terms of rows BN + 8 t + j, a lane group's column pair each.
  __device__ __forceinline__ void band_sums_bf16(int s, int e) const {
    constexpr int G = BAND_LANES;
    const int u = (e & 31) % G;
    const uint4* b4 = reinterpret_cast<const uint4*>(b(s));
    for (int x = e >> 5; x < BAND_SETS; x += 3) {
      int j, c;
      band_job(e, x, j, c);
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BAND_ROWS; ++i) {
        const int r = j * T::SBN + u + G * i;
        const uint4 x4 = b4[r * 8 + (c ^ (r & 7))];
        const uint32_t w4[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[2 * q] += bf16_lo(w4[q]);
          v[2 * q + 1] += bf16_hi(w4[q]);
        }
      }
      lane_rounds<G / 2, 8, 2>(v, u);
      if ((u & (G / 4 - 1)) == 0) {
        const int p = 4 * c + (u & (G / 2) ? 2 : 0) + (u & (G / 4) ? 1 : 0);
        uint32_t w3[3];
        bf16x3(v[0], v[1], w3);
#pragma unroll
        for (int t = 0; t < 3; ++t) bw(s)[swz_word(T::BN + 8 * t + j, p)] = w3[t];
      }
    }
  }

  // int8: the band sums of stage s, exact, as the digit rows BN + j (lo) and
  // BN + 8 + j (hi): each byte biased to x + 128, two columns a word in
  // 16-bit lanes (a band's 128 * 255 < 2^16, so no lane carries into the
  // next, also after the lanes' sums), a lane group's 4-column word each.
  __device__ __forceinline__ void band_sums_s8(int s, int e) const {
    constexpr int G = BAND_LANES;
    const int u = (e & 31) % G;
    const uint4* b4 = reinterpret_cast<const uint4*>(b(s));
    for (int x = e >> 5; x < BAND_SETS; x += 3) {
      int j, c;
      band_job(e, x, j, c);
      // v[2 q]: columns 4 q and 4 q + 2 of word q; v[2 q + 1]: 4 q + 1, 4 q + 3.
      uint32_t v[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < BAND_ROWS; ++i) {
        const int r = j * T::SBN + u + G * i;
        const uint4 x4 = b4[r * 8 + (c ^ (r & 7))];
        const uint32_t w4[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t y = w4[q] ^ 0x80808080u;  // x + 128 per byte
          v[2 * q] += y & 0x00ff00ffu;
          v[2 * q + 1] += (y >> 8) & 0x00ff00ffu;
        }
      }
      lane_rounds<G / 2, 8, 2>(v, u);
      if ((u & (G / 4 - 1)) == 0) {
        const int p = 4 * c + (u & (G / 2) ? 2 : 0) + (u & (G / 4) ? 1 : 0);
        constexpr int BIAS = 128 * T::SBN;
        uint32_t lo, hi;
        digits(make_int4((int)(v[0] & 0xffffu) - BIAS,
                         (int)(v[1] & 0xffffu) - BIAS,
                         (int)(v[0] >> 16) - BIAS, (int)(v[1] >> 16) - BIAS),
               lo, hi);
        bw(s)[swz_word(T::BN + j, p)] = lo;
        bw(s)[swz_word(T::BN + 8 + j, p)] = hi;
      }
    }
  }

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
  // its band rows; with kSumBands also B's column-band sums and, with
  // kSumRowGroups, A's row-band moment sums (B3; B4's: split_bands).
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
  // rows, landing as row MOM * b + v (in bf16 term t's into term buffer t),
  // and (kLoadBands) the band rows tj0.. of tbb as B's rows BN.. (in bf16
  // term t's as rows BN + 8 t ..): its first thread streams the TMA loads through
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
        mbar_expect_tx(full(s), T::TX_BYTES);
        tma_load(a(s), ta, full(s), st * T::SK, m0);
        tma_load(b(s), tb, full(s), st * T::SK, n0);
        if constexpr (T::BANDS == kLoadBands && T::BF16) {
#pragma unroll
          for (int t = 0; t < 3; ++t)  // (groups, 3, K): term t of the bands
            tma_load3(bw(s) + (T::BN + 8 * t) * 32, tbb, full(s), st * T::SK,
                      t, tj0);
        } else if constexpr (T::BANDS == kLoadBands) {
          tma_load(b(s) + T::BN * T::SK, tbb, full(s), st * T::SK, tj0);
        }
        if constexpr (T::ROWS == kLoadRows && T::BF16) {
#pragma unroll
          for (int t = 0; t < 3; ++t)  // (groups, 3, planes, K): term t
            tma_load4(mw(s, t), tm, full(s), st * T::SK, 0, t, ti0);
        } else if constexpr (T::ROWS == kLoadRows) {
          tma_load3(mhi(s), tm, full(s), st * T::SK, 0, ti0);
        }
      }
    } else if (p >= 32) {
      // (B3 and B4, the int8 kernels among them, run produce_checked.)
      if constexpr (T::F8) {
        // B1 in fp8: the consumers take B's stage as landed.
      } else if constexpr (!T::BF16) {
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
      } else if constexpr (T::SPLIT) {
        if constexpr (PADS) {
          for (int s = 0; s < T::STAGES; ++s) zero_pads_bf16(s, p - 32);
        }
        for (int st = 0; st < nst; ++st) {
          const int s = st % T::STAGES;
          mbar_wait(full(s), (st / T::STAGES) & 1);
          sum_rows_bf16(s, p - 32);  // B5: the only bf16 splitting here
          fence_proxy_async();  // the sum rows are visible to wgmma
          mbar_arrive(ready(s));
        }
      }
    }
  }

  // produce() for B3, B4 and B7, whose checks the producer decides (`ck`,
  // a RowcolChecker or B4's GlobalChecker): the splitter warps while they
  // wait for a stage to land and after the last stage, or (CK::kOnLoader)
  // the first warp between its loads. The other kernels keep produce(), so that their code stays as
  // it was (with a form shared with this one, B2 bf16 at the tall tile ran
  // 4.9 % slower; PERF.md).
  template <class CK>
  __device__ __forceinline__ void produce_checked(
      const CUtensorMap* ta, const CUtensorMap* tb, int m0, int n0, int nst,
      const CUtensorMap* tm, int ti0, const CUtensorMap* tbb, int tj0,
      CK& ck) const {
    const int p = threadIdx.x - T::NCONS;
    // The TMA loads of stage st, by the first thread, once its slot is free.
    const auto issue = [&](int st) {
      const int s = st % T::STAGES;
      mbar_expect_tx(full(s), T::TX_BYTES);
      tma_load(a(s), ta, full(s), st * T::SK, m0);
      tma_load(b(s), tb, full(s), st * T::SK, n0);
      if constexpr (T::BANDS == kLoadBands && T::BF16) {
#pragma unroll
        for (int t = 0; t < 3; ++t)  // (groups, 3, K): term t of the bands
          tma_load3(bw(s) + (T::BN + 8 * t) * 32, tbb, full(s), st * T::SK,
                    t, tj0);
      } else if constexpr (T::BANDS == kLoadBands) {
        tma_load(b(s) + T::BN * T::SK, tbb, full(s), st * T::SK, tj0);
      }
      if constexpr (T::ROWS == kLoadRows && T::BF16) {
#pragma unroll
        for (int t = 0; t < 3; ++t)  // (groups, 3, planes, K): term t
          tma_load4(mw(s, t), tm, full(s), st * T::SK, 0, t, ti0);
      } else if constexpr (T::ROWS == kLoadRows) {
        tma_load3(mhi(s), tm, full(s), st * T::SK, 0, ti0);
      }
    };
    if (p < 32) {
      if constexpr (CK::kOnLoader) {
        // The first warp loads, and checks between its loads.
        ck.load(
            nst, p,
            [&](int st) {
              const int s = st % T::STAGES;
              const bool free = st < T::STAGES ||
                                mbar_test(empty(s), (st / T::STAGES - 1) & 1);
              if (!__shfl_sync(0xffffffffu, free ? 1 : 0, 0)) return false;
              if (p == 0) issue(st);
              return true;
            },
            [&](int st) {  // suspended a while for stage st's slot
              mbar_try(empty(st % T::STAGES), (st / T::STAGES - 1) & 1, 1000);
            });
      } else if (p == 0) {
        for (int st = 0; st < nst; ++st) {
          if (st >= T::STAGES)
            mbar_wait(empty(st % T::STAGES), (st / T::STAGES - 1) & 1);
          issue(st);
        }
      }
    } else if (p >= 32) {
      const int e = p - 32;
      // Stage st has landed (a checker decides posted checks meanwhile).
      const auto land = [&](int st) {
        if constexpr (!CK::kOnLoader)
          ck.land(full(st % T::STAGES), (st / T::STAGES) & 1, e);
        else
          mbar_wait(full(st % T::STAGES), (st / T::STAGES) & 1);
      };
      constexpr bool LANES = T::ROWS == kNoRows;  // B4's band sums
      if constexpr (T::S8) {
        for (int s = 0; s < T::STAGES; ++s) zero_pads_s8(s, e);
        for (int st = 0; st < nst; ++st) {
          land(st);
          if constexpr (LANES)
            band_sums_s8(st % T::STAGES, e);
          else
            sum_bands_s8(st, e);
          fence_proxy_async();  // the digit rows are visible to wgmma
          mbar_arrive(ready(st % T::STAGES));
        }
      } else if constexpr (!T::BF16) {
        if constexpr (PADS) {
          for (int s = 0; s < T::STAGES; ++s) zero_pads(s, e);
        }
        for (int st = 0; st < nst; ++st) {
          const int s = st % T::STAGES;
          land(st);
          if constexpr (LANES && T::BANDS == kSumBands)
            split_bands(s, e);
          else
            split_b(st, e);
          if constexpr (T::ROWS == kLoadRows)
            split4(mhi(s), mlo(s), T::M_BOX / 16, e);
          if constexpr (T::ROWS == kSumRows) sum_rows(s, e);
          fence_proxy_async();  // the split is visible to wgmma
          mbar_arrive(ready(s));
        }
      } else if constexpr (T::SPLIT) {
        if constexpr (PADS) {
          for (int s = 0; s < T::STAGES; ++s) zero_pads_bf16(s, e);
        }
        for (int st = 0; st < nst; ++st) {
          const int s = st % T::STAGES;
          land(st);
          if constexpr (T::ROWS == kSumRows) {
            sum_rows_bf16(s, e);
          } else if constexpr (LANES) {
            band_sums_bf16(s, e);
          } else {
            sum_bands_bf16(st, e);
          }
          fence_proxy_async();  // the sum rows are visible to wgmma
          mbar_arrive(ready(s));
        }
      }
      if constexpr (!CK::kOnLoader) ck.drain(e);
    }
  }
};

// Whether a hook defers its faults to stage ends (Hook::kDeferred; the
// RunHook of B3, B4, B5 and B7): it then
// reports no fault to the mainloop (at() false, fault_step() INT_MAX), so
// that a stage is cut only at its checks, and takes stage_end(ml, st)
// after each stage's promotion.
template <class Hook, class = void>
struct Deferred : std::false_type {};
template <class Hook>
struct Deferred<Hook, std::void_t<decltype(Hook::kDeferred)>>
    : std::bool_constant<Hook::kDeferred> {};

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

// The fused epilogue's pass over the elements one consumer thread of
// WgMainloop::store has just written (rows r0 and r0 + 8, columns c0 + 8 j
// and c0 + 8 j + 1 of the CTA's tile, j < nacc / 4): each read back (its
// own write, from L2), put through the epilogue and written again, with no
// barrier. It is not inlined: each library compiles it once, and the
// kernels call it at their end, where little of them is live (ptxas still
// allocates each kernel anew; the FT kernels write their grids before or
// after the call, whichever keeps their allocation; PERF.md). Inlined, the
// same loop moved the f32 rowcol kernels' spills (568 to 772 B at the
// medium tile) and their identity times by up to 5 %; applied in registers
// inside the unrolled store, the epilogue's 64 tanhf a thread tripled the
// build.
template <bool MASK>
__device__ __noinline__ void epilogue_pass(float* out, int N, int M, int m0,
                                           int n0, int r0, int c0, int nacc,
                                           Epilogue epi) {
#pragma unroll 4
  for (int i = 0; i < nacc; i += 2) {
    const int r = r0 + 8 * ((i >> 1) & 1), c = c0 + 8 * (i >> 2);
    if (MASK && (m0 + r >= M || n0 + c >= N)) continue;
    const size_t o = (size_t)(m0 + r) * N + n0 + c;
    const float2 v = *reinterpret_cast<const float2*>(out + o);
    const float2 b = epi.bias
                         ? *reinterpret_cast<const float2*>(epi.bias + n0 + c)
                         : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(out + o) =
        make_float2(epi.apply(v.x, b.x), epi.apply(v.y, b.y));
  }
}

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
// check after it (the adaptive checks' running moments of A and B). In
// int8 the wgmmas accumulate into `acc` and `acc_e` directly (s32, exact:
// no per-stage promotion), and `part`, `part_e` stay unused.
template <class T>
struct WgMainloop {
  using Acc = typename T::Acc;
  static constexpr int NF = 4 * T::KW;  // A fragment registers per stage
  static constexpr int NE = T::R > 0 ? T::NACC_E : 1;
  Acc acc[T::NACC_W];   // the product, then (XN > 0) its extra columns
  Acc part[T::NACC_W];  // this stage's wgmma sum
  Acc acc_e[NE];      // expected moments E[row(i)][col(i)] (R > 0)
  Acc part_e[NE];
  WgSmem<T> sm;
  int g, w, l;

  __device__ __forceinline__ explicit WgMainloop(const WgSmem<T>& sm_)
      : sm(sm_), g(threadIdx.x / 128),
        w((threadIdx.x / 32) % 4), l(threadIdx.x % 32) {
#pragma unroll
    for (int i = 0; i < T::NACC_W; ++i) acc[i] = part[i] = Acc(0);
    if constexpr (T::R > 0) {
#pragma unroll
      for (int i = 0; i < NE; ++i) acc_e[i] = part_e[i] = Acc(0);
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
  // Extra element i (0 .. 3) of the band columns: band 2 (l & 3) + i % 2's
  // expected sum of row row(i), the sum of its three terms in bf16, lo +
  // 128 hi of its digits in int8 (wrapping).
  __device__ __forceinline__ Acc xcol(int i) const {
    if constexpr (T::BF16)
      return acc[T::NACC + i] + acc[T::NACC + 4 + i] + acc[T::NACC + 8 + i];
    else if constexpr (T::S8)
      return acc[T::NACC + i] + 128u * acc[T::NACC + 4 + i];
    else
      return acc[T::NACC + i];
  }
  // Expected moment element i (i < NEC) at moment row col(i): in int8 lo +
  // 128 hi of its digits (rows col(i) and 8 + col(i), element i + 4).
  static constexpr int NEC = T::S8 ? NE / 2 : NE;
  __device__ __forceinline__ Acc ecol(int i) const {
    if constexpr (T::S8)
      return acc_e[i] + 128u * acc_e[i + 4];
    else
      return acc_e[i];
  }

  // After wgmma_wait_all: `part` holds its final sum (the empty asm keeps
  // the compiler from reading it earlier); add it into `acc`. In int8 the
  // same empty asm pins `acc` and `acc_e` themselves, which the wgmmas
  // wrote.
  __device__ __forceinline__ void promote() {
    if constexpr (T::S8) {
#pragma unroll
      for (int i = 0; i < T::NACC_W; ++i)
        asm volatile("" : "+r"(acc[i])::"memory");
      if constexpr (T::R > 0) {
#pragma unroll
        for (int i = 0; i < NE; ++i)
          asm volatile("" : "+r"(acc_e[i])::"memory");
      }
    } else {
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
  }

  // promote() and restart both stage sums at zero.
  __device__ __forceinline__ void promote_clear() {
    promote();
    if constexpr (!T::S8) {
#pragma unroll
      for (int i = 0; i < T::NACC_W; ++i) part[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NE; ++i) part_e[i] = 0.f;
    }
  }

  // Wait until stage st has landed and its B is split; load this thread's
  // A fragments of its KK k steps and split them into hi / lo. A fragment
  // register j of k step kk holds row r0 + 8 * (j % 2), column 8 * kk + 4 *
  // (j / 2) + l % 4, read through the swizzle.
  // bf16: no split; register j of k step q holds the column pair 16 q + 8 *
  // (j / 2) + 2 * (l % 4) of row r0 + 8 * (j % 2), and `al` is not used.
  // int8 and fp8: the same bytes, four columns 32 q + 16 (j / 2) + 4 (l % 4)
  // .. + 3 a register.
  __device__ __forceinline__ void prepare(int st, uint32_t (&ah)[NF],
                                          uint32_t (&al)[NF]) const {
    const int s = st % T::STAGES;
    mbar_wait(T::SPLIT ? sm.ready(s) : sm.full(s), (st / T::STAGES) & 1);
    const int r0 = 64 * g + 16 * w + (l >> 2);
    if constexpr (T::BF16 || T::S8 || T::F8) {
      const uint32_t* a = sm.aw(s);
#pragma unroll
      for (int q = 0; q < T::KW; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ah[4 * q + j] = a[swz_word(r0 + 8 * (j & 1), 8 * q + 4 * (j >> 1) +
                                                           (l & 3))];
    } else {
      const float* a = sm.a(s);
#pragma unroll
      for (int kk = 0; kk < T::KK; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + 8 * (j & 1), chunk = 2 * kk + (j >> 1);
          split_tf32(a[r * T::SK + ((chunk ^ (l >> 2)) << 2) + (l & 3)],
                     ah[4 * kk + j], al[4 * kk + j]);
        }
    }
  }

  // One 8-deep k step into `part`: a_lo b_hi, a_hi b_lo, a_hi b_hi; the
  // first of them restarts `part` when `fresh`. With R > 0 the same three
  // terms of B's stage (this warpgroup's 64 rows) times the moment rows
  // into `part_e`. The FTSG_ONE_PASS build (precision "default") issues
  // a_hi b_hi alone, for the product and for `part_e`.
  __device__ __forceinline__ void mma3(const uint32_t (&ah)[NF],
                                       const uint32_t (&al)[NF], int kk,
                                       uint64_t dh, uint64_t dl, bool fresh,
                                       int s) {
    if constexpr (!kOnePass) {
      Wgmma<T::BN + T::XN>::run(part, &al[4 * kk], dh + 2 * kk,
                                fresh ? 0 : 1);
      Wgmma<T::BN + T::XN>::run(part, &ah[4 * kk], dl + 2 * kk, 1);
    }
    Wgmma<T::BN + T::XN>::run(part, &ah[4 * kk], dh + 2 * kk,
                              fresh && kOnePass ? 0 : 1);
    if constexpr (T::R > 0) {
      const uint64_t bh = smem_desc(sm.b(s) + 64 * g * T::SK) + 2 * kk;
      const uint64_t bl = smem_desc(sm.blo(s) + 64 * g * T::SK) + 2 * kk;
      const uint64_t mh = smem_desc(sm.mhi(s)) + 2 * kk;
      const uint64_t ml = smem_desc(sm.mlo(s)) + 2 * kk;
      if constexpr (!kOnePass) {
        WgmmaSS<T::R>::run(part_e, bl, mh, fresh ? 0 : 1);
        WgmmaSS<T::R>::run(part_e, bh, ml, 1);
      }
      WgmmaSS<T::R>::run(part_e, bh, mh, fresh && kOnePass ? 0 : 1);
    }
  }

  // bf16: 16-deep k step q of ring slot s into `part` (restarting it when
  // `fresh`), A from the fragment registers; with R > 0 B's stage (this
  // warpgroup's 64 rows) times the three terms of the moment rows into
  // `part_e`, the terms summed by the accumulator.
  __device__ __forceinline__ void mma_bf(const uint32_t (&ah)[NF], int q,
                                         int s, bool fresh) {
    WgmmaBf<T::BN + T::XN>::run(part, &ah[4 * q],
                                smem_desc(sm.b(s)) + 2 * q, fresh ? 0 : 1);
    if constexpr (T::R > 0) {
      const uint64_t bd = smem_desc(sm.bw(s) + 64 * g * 32) + 2 * q;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        WgmmaSSBf<T::R>::run(part_e, bd, smem_desc(sm.mw(s, t)) + 2 * q,
                             fresh && t == 0 ? 0 : 1);
    }
  }

  // The first (half 1) or last (half 2) 8 columns of k step q: the other
  // half's A registers zero and, with R > 0, E's A operand (B's stage) as
  // register fragments masked the same way; the masked registers are
  // written before the fence that orders them ahead of the wgmmas.
  __device__ __forceinline__ void mma_bf_half(const uint32_t (&ah)[NF], int q,
                                              int s, int half, bool fresh) {
    uint32_t a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = (half >> (j >> 1)) & 1 ? ah[4 * q + j] : 0u;
    uint32_t x[4];
    if constexpr (T::R > 0) {
      const uint32_t* b = sm.bw(s);
      const int r0 = 64 * g + 16 * w + (l >> 2);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = (half >> (j >> 1)) & 1
                   ? b[swz_word(r0 + 8 * (j & 1), 8 * q + 4 * (j >> 1) + (l & 3))]
                   : 0u;
    }
    wgmma_fence();
    WgmmaBf<T::BN + T::XN>::run(part, a, smem_desc(sm.b(s)) + 2 * q,
                                fresh ? 0 : 1);
    if constexpr (T::R > 0) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
        WgmmaBf<T::R>::run(part_e, x, smem_desc(sm.mw(s, t)) + 2 * q,
                           fresh && t == 0 ? 0 : 1);
    }
  }

  // int8: 32-deep k step q of ring slot s into `acc`, A from the fragment
  // registers; with R > 0 B's stage (this warpgroup's 64 rows) times the
  // moment rows' digits into `acc_e`.
  __device__ __forceinline__ void mma_s8(const uint32_t (&ah)[NF], int q,
                                         int s) {
    WgmmaS8<T::BN + T::XN>::run(acc, &ah[4 * q], smem_desc(sm.b(s)) + 2 * q,
                                1);
    if constexpr (T::R > 0)
      WgmmaSSS8<T::R>::run(acc_e, smem_desc(sm.bw(s) + 64 * g * 32) + 2 * q,
                           smem_desc(sm.mw(s, 0)) + 2 * q, 1);
  }

  // int8: the 8-column steps of k step q whose bits are set in `mask` (bit u:
  // step 4 q + u): A's registers of the other steps zero (register j of
  // lane l holds step 2 (j / 2) + (l % 4) / 2) and, with R > 0, E's A
  // operand (B's stage) as register fragments masked the same way; the
  // masked registers are written before the fence that orders them ahead of
  // the wgmmas.
  __device__ __forceinline__ void mma_s8_part(const uint32_t (&ah)[NF], int q,
                                              int s, unsigned mask) {
    const int r0 = 64 * g + 16 * w + (l >> 2);
    uint32_t a[4], x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = (mask >> (2 * (j >> 1) + ((l & 3) >> 1))) & 1u;
      a[j] = keep ? ah[4 * q + j] : 0u;
      if constexpr (T::R > 0)
        x[j] = keep ? sm.bw(s)[swz_word(r0 + 8 * (j & 1),
                                        8 * q + 4 * (j >> 1) + (l & 3))]
                    : 0u;
    }
    wgmma_fence();
    WgmmaS8<T::BN + T::XN>::run(acc, a, smem_desc(sm.b(s)) + 2 * q, 1);
    if constexpr (T::R > 0)
      WgmmaS8<T::R>::run(acc_e, x, smem_desc(sm.mw(s, 0)) + 2 * q, 1);
  }

  // mma_stage in fp8 (B1: no checks and no faults): each 32-deep k step's
  // e4m3 product into `part`, restarted at every k step and promoted into
  // `acc` after each but the stage's last (run() promotes that one).
  template <class Hook>
  __device__ __forceinline__ void mma_stage_f8(int st,
                                               const uint32_t (&ah)[NF],
                                               Hook&) {
    static_assert(std::is_same_v<Hook, NoInject>, "e4m3 wgmma: B1 alone");
    const int s = st % T::STAGES;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < T::KW; ++q) {
      WgmmaE4<T::BN>::run(part, &ah[4 * q], smem_desc(sm.b(s)) + 2 * q, 0);
      if (q + 1 < T::KW) {
        wgmma_commit();
        wgmma_wait_all();
        promote();
        wgmma_fence();
      }
    }
    wgmma_commit();
  }

  // mma_stage in int8 (the checks' hooks, kSegmented): the same events at
  // the same 8-column k steps (B3's deferred hook: the checks alone, its
  // faults added at stage ends). A stage with an event is issued in segments
  // that each end at a check; a 32-deep k step that a check splits is
  // issued in parts (mma_s8_part). A fault goes into `acc` before the part
  // of a k step it falls in, once the wgmmas before it have landed: a part
  // never spans a check, and integer adds commute, so every check sees
  // exactly the faults scheduled up to its k step, as the JAX kernel does.
  template <class Hook>
  __device__ __forceinline__ void mma_stage_s8(int st,
                                               const uint32_t (&ah)[NF],
                                               Hook& hook) {
    static_assert(Hook::kSegmented && !kAdaptive,
                  "int8 runs B3 and B4 under the static thresholds");
    const int s = st % T::STAGES, t0 = st * T::KK;
    wgmma_fence();
    if (!hook.within(st)) {
#pragma unroll
      for (int q = 0; q < T::KW; ++q) mma_s8(ah, q, s);
    } else {
      int k0 = 0;  // the first 8-column k step not issued
      for (;;) {
        // The segment k0 .. k1: up to the next check or the stage's end.
        const int kc = min(hook.check_step() - t0, T::KK);
        const int k1 = min(kc, T::KK - 1);
#pragma unroll
        for (int q = 0; q < T::KW; ++q) {
          const int lo = max(T::KS * q, k0), hi = min(T::KS * q + 3, k1);
          if (lo <= hi) {
            if (hook.fault_step() - t0 <= hi) {
              wgmma_commit();
              wgmma_wait_all();
              promote();
              do {
                hook.apply(*this, hook.fault_step());
              } while (hook.fault_step() - t0 <= hi);
              wgmma_fence();
            }
            if (hi - lo == T::KS - 1) {
              mma_s8(ah, q, s);
            } else {  // steps lo .. hi of the four
              const unsigned n = hi - lo + 1;
              mma_s8_part(ah, q, s, (0xfu >> (4 - n)) << (lo - T::KS * q));
            }
          }
        }
        if (kc >= T::KK) break;
        wgmma_commit();
        wgmma_wait_all();
        promote();
        hook.check(*this);
        wgmma_fence();
        k0 = kc + 1;
        if (k0 >= T::KK) break;
      }
    }
    wgmma_commit();
  }

  // mma_stage in bf16: the same events at the same 8-column k steps (B3's
  // and B7's deferred hooks: the checks alone). A k
  // step that an event splits is issued as its two halves around it; the
  // unrolled form looks one 8-column step ahead for a fault (at(t + 1)) or
  // a check (check_after(t)) inside each 16-deep step. A bf16 fault
  // restarts the stage sum `part` with the fault in it (FragInject::apply),
  // and the next wgmma accumulates onto it. kstep sees each 8-column half
  // step kk = 2 q + h of k step q once its wgmma is issued (the whole step
  // or the half), before a check after it: a check between the halves
  // sees the sums through half 1 only (`ah` stands in for the unused `al`).
  template <class Hook>
  __device__ __forceinline__ void mma_stage_bf16(int st,
                                                 const uint32_t (&ah)[NF],
                                                 Hook& hook) {
    const int s = st % T::STAGES, t0 = st * T::KK;
    wgmma_fence();
    if (!hook.within(st)) {
#pragma unroll
      for (int q = 0; q < T::KW; ++q) {
        mma_bf(ah, q, s, q == 0);
        hook.kstep(*this, ah, ah, 2 * q, s);
        hook.kstep(*this, ah, ah, 2 * q + 1, s);
      }
    } else if constexpr (Hook::kSegmented) {
      int k0 = 0;         // the first 8-column k step not issued
      bool fresh = true;  // the next wgmma restarts the stage sum
      for (;;) {
        const int kf = min(hook.fault_step() - t0, T::KK);
        const int kc = min(hook.check_step() - t0, T::KK);
        const int k1 = min(kf - 1, kc);
#pragma unroll
        for (int q = 0; q < T::KW; ++q) {
          const bool lo = 2 * q >= k0 && 2 * q <= k1;
          const bool hi = 2 * q + 1 >= k0 && 2 * q + 1 <= k1;
          if (lo && hi) {
            mma_bf(ah, q, s, fresh);
            fresh = false;
          } else if (lo || hi) {
            mma_bf_half(ah, q, s, lo ? 1 : 2, fresh);
            fresh = false;
          }
          if (lo) hook.kstep(*this, ah, ah, 2 * q, s);
          if (hi) hook.kstep(*this, ah, ah, 2 * q + 1, s);
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
          fresh = false;
        } else {
          break;
        }
        if (k0 >= T::KK) break;
      }
    } else {
      bool fresh = true;
#pragma unroll
      for (int q = 0; q < T::KW; ++q) {
        const int t = t0 + 2 * q;
        if (hook.at(t)) {
          if (q > 0) {
            wgmma_commit();
            wgmma_wait_all();
            promote();
          }
          hook.apply(*this, t);
          wgmma_fence();
          fresh = false;
        }
        if (!hook.check_after(t) && !hook.at(t + 1)) {
          mma_bf(ah, q, s, fresh);
          hook.kstep(*this, ah, ah, 2 * q, s);
          hook.kstep(*this, ah, ah, 2 * q + 1, s);
        } else {
          mma_bf_half(ah, q, s, 1, fresh);
          hook.kstep(*this, ah, ah, 2 * q, s);
          if (hook.check_after(t)) {
            wgmma_commit();
            wgmma_wait_all();
            promote_clear();
            hook.check(*this);
            wgmma_fence();
          }
          if (hook.at(t + 1)) {
            wgmma_commit();
            wgmma_wait_all();
            promote();
            hook.apply(*this, t + 1);
            wgmma_fence();
          }
          mma_bf_half(ah, q, s, 2, false);
          hook.kstep(*this, ah, ah, 2 * q + 1, s);
        }
        fresh = false;
        if (hook.check_after(t + 1)) {
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

  // Issue stage st's wgmmas (k steps t0 = KK * st ..) as one group; a
  // ragged last stage multiplies TMA's zero fill. At a scheduled fault the
  // steps so far land and go into `acc` before the fault does; at a check,
  // the steps so far land and go into `acc` (and `acc_e`), then the check
  // runs and the stage sums restart from zero. A hook that sets kSegmented
  // (the checks of B3, B4, B7 and B8, ~20 per run) has a stage with events
  // issued in segments that each end at one, so that its large check is
  // inlined once per call site of mma_stage and not once per k step (their
  // kernels ran 0.5-0.8 ms faster); the other hooks keep the unrolled form,
  // which segments made slower (B2 at the 64-row tiles 22-44 %; PERF.md).
  // A hook that defers (Deferred: B3's and B7's) shows the mainloop no
  // fault, so that only its checks cut a stage, each with one drain, and
  // it adds the faults at stage ends (step) and each check's corrections
  // before the next check.
  template <class Hook>
  __device__ __forceinline__ void mma_stage(int st, const uint32_t (&ah)[NF],
                                            const uint32_t (&al)[NF],
                                            Hook& hook) {
    if constexpr (T::F8) {
      mma_stage_f8(st, ah, hook);
    } else if constexpr (T::S8) {
      mma_stage_s8(st, ah, hook);
    } else if constexpr (T::BF16) {
      mma_stage_bf16(st, ah, hook);
    } else {
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
  }

  // Stage st on registers (ch, cl) while stage st + 1 is prepared into
  // (nh, nl); then add st's sum into acc and release st's slot. A hook
  // that defers its faults (kDeferred: B3's, B4's, B5's and B7's RunHook)
  // sees the stage end, once `part` is in `acc` (hook.stage_end).
  template <class Hook>
  __device__ __forceinline__ void step(int st, int nst, Hook& hook,
                                       const uint32_t (&ch)[NF],
                                       const uint32_t (&cl)[NF],
                                       uint32_t (&nh)[NF], uint32_t (&nl)[NF]) {
    mma_stage(st, ch, cl, hook);
    if (st + 1 < nst) prepare(st + 1, nh, nl);
    wgmma_wait_all();
    promote();
    if constexpr (Deferred<Hook>::value) hook.stage_end(*this, st);
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

  // out = epi(alpha * acc + beta * C) for this CTA's tile, a float2 per
  // column pair (out never aliases C); with MASK only the rows below M and
  // columns below N (a CTA larger than the padded operands; the epilogue
  // reads the bias row only there too). int8: alpha * f32(acc) + beta * C
  // with each product and the sum rounded on its own (no FMA contraction),
  // as the plain version's torch ops round them. The fused epilogue
  // (abft_common.cuh: Epilogue) runs after every check of the kernel: the
  // store writes alpha * acc + beta * C as it always did, then, behind one
  // uniform branch, epilogue_pass reads back this thread's elements and
  // writes them through the epilogue.
  template <bool MASK = false>
  __device__ __forceinline__ void store(float* out, const float* C, int N,
                                        int m0, int n0, float alpha,
                                        float beta, const Epilogue& epi,
                                        int M = 0) const {
#pragma unroll
    for (int i = 0; i < T::NACC; i += 2) {
      if (MASK && (m0 + row(i) >= M || n0 + col(i) >= N)) continue;
      const size_t o = (size_t)(m0 + row(i)) * N + n0 + col(i);
      const float2 c = *reinterpret_cast<const float2*>(C + o);
      if constexpr (T::S8) {
        *reinterpret_cast<float2*>(out + o) = make_float2(
            __fadd_rn(__fmul_rn(alpha, (float)(int)acc[i]),
                      __fmul_rn(beta, c.x)),
            __fadd_rn(__fmul_rn(alpha, (float)(int)acc[i + 1]),
                      __fmul_rn(beta, c.y)));
      } else {
        *reinterpret_cast<float2*>(out + o) = make_float2(
            alpha * acc[i] + beta * c.x, alpha * acc[i + 1] + beta * c.y);
      }
    }
    if (!epi.identity())
      epilogue_pass<MASK>(out, N, M, m0, n0, row(0), col(0), T::NACC, epi);
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

// The (rows, K) row-major f32 (esize 4), bf16 (esize 2) or int8 (esize 1)
// operand at p, in (box_rows, sk) boxes with the 128-byte swizzle;
// out-of-range columns read as zero. Rows lie K * esize bytes apart rounded
// up to 16, as TMA needs: the same for f32 and bf16 (K is a multiple of 8),
// and for int8 the wrapper's storage (ops/common.align_rows16) when K is
// not a multiple of 16.
inline bool tensor_map(CUtensorMap* map, const void* p, int rows, int K,
                       int box_rows, int sk, int esize = 4) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {((cuuint64_t)K * esize + 15) / 16 * 16};
  const cuuint32_t box[2] = {(cuuint32_t)sk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                esize == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (groups, terms, planes, K) row-major operand at p (the wrapper's
// moment rows; f32 with esize 4, one term, or bf16 with esize 2), in boxes
// of box_planes rows of one term of each of box_groups groups, SK columns,
// with the 128-byte swizzle: a box's row box_planes * g + v holds plane v of
// group g; out-of-range columns and groups read as zero. The f32 maps have
// rank 3 (tma_load3), the bf16 ones rank 4 (tma_load4, one box per term).
inline bool tensor_map_rows(CUtensorMap* map, const void* p, int groups,
                            int terms, int planes, int K, int box_groups,
                            int box_planes, int sk, int esize = 4) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const int rank = terms == 1 ? 3 : 4;
  const cuuint64_t row = (cuuint64_t)K * esize;
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)planes,
                              (cuuint64_t)(rank == 3 ? groups : terms),
                              (cuuint64_t)groups};
  const cuuint64_t strides[3] = {row, planes * row, terms * planes * row};
  const cuuint32_t box[4] = {(cuuint32_t)sk, (cuuint32_t)box_planes,
                             (cuuint32_t)(rank == 3 ? box_groups : 1),
                             (cuuint32_t)box_groups};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                rank, const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Before a launch of `kernel` on tile T: A's and B's tensor maps and the
// kernel's dynamic shared-memory limit. Returns 0, or the error the entry
// point reports like a launch error.
template <class T, class Kernel>
inline int wgmma_setup(Kernel kernel, CUtensorMap* ta, CUtensorMap* tb,
                       const void* A, const void* B, int M, int N, int K) {
  if (K % 8 || !tensor_map(ta, A, M, K, T::BM, T::SK, T::ESIZE) ||
      !tensor_map(tb, B, N, K, T::BN, T::SK, T::ESIZE))
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
}

FTSG_NAMESPACE_END  // ftsg

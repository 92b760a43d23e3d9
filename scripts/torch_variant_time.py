"""Time the port's kernels of several source trees at 4096, without
checking them.

Each TREE is a directory that holds a copy of the ``ft_sgemm_tpu_torch``
package, as for ``scripts/torch_kernel_ab.py``; unlike that script, this
one does not hold the kernels' output or fault counts to anything, so it
also times copies that break the check on purpose (a check that returns
early, a product without its extra columns) to see what a part costs, and
copies that route a tile to another CTA. Only the sources of the named
kernels are built, all trees in parallel. Each FT kernel runs at the
cadence and multifault setting the program gives its strategy (B2 with
its one final check, also where the program runs B5), with reference-like
injection, on the wrapper-side inputs the program builds for it (B2's
expected moments, the moment rows of B6-B8: ``ops/ft_sgemm.kernel_inputs``,
made once per tile outside the timed launches); each tree is measured in a
fresh process per turn, the trees in order and then reversed
(``torch_kernel_ab.turns``). Needs nvcc and a CUDA device:

    python3 scripts/torch_variant_time.py [--kernels=B1,B2] [--tiles=large,tall] [--threshold=adaptive] [--dtype=bfloat16] TREE [TREE ...]

``--kernels`` (default B3, B4, B6, B7, B8; B5 on request) and ``--tiles``
(default the six program tiles) pick what is built and timed;
``--dtype=bfloat16`` times the bf16 builds of B1-B8 (the ``*_bf16`` entry
points, from the libraries that the tree's ``ops/ft_sgemm.kernel_entry``
names, so a tree must have that table; A and B rounded to bf16);
``--dtype=int8`` the int8 builds of B3 and B4 (static, multifault off) on
the program's ``round(10 x)`` operands;
``--threshold=adaptive`` builds and times the adaptive builds of B3-B8 at
the adaptive cadence (the default margin in slot 7), with
``--dtype=bfloat16`` their adaptive bf16 builds; ``--magnitude=M``
sets the reference-like faults' magnitude (default 1e4; 0: no faults, at
the reference-like schedule's cadence and multifault setting).
Prints the card's name and power limit, then one line per tree and turn:
milliseconds per launch, and the detections and uncorrectable counts each
FT launch reported.

    python3 scripts/torch_variant_time.py --variant=NAME [--from=TREE] DIR

writes this checkout's package (or TREE's) with one named change
(``VARIANTS``) into DIR, a tree for the runs above. ``device-scalars`` hands B3-B8 their
scalar argument through device memory instead of by value: no arithmetic
changes, only where each consumer thread reads it from. On an H100 it made
B6 at the small tile report fewer detections than the by-value build on
the same launch, until the fault injection stopped writing the accumulator
and took unsigned hit tests (a ptxas fault; ROADMAP Queue C);
``device-scalars-small`` builds it at the small tile only:

    python3 scripts/torch_variant_time.py --variant=device-scalars VAR
    python3 scripts/torch_variant_time.py --kernels=B6,B5 --tiles=small,huge . VAR

``rowcol-check-returns`` (the rowcol check returns at once after its
drain) and ``one-final-check`` (every kernel checks once, after the last
k step) split a rowcol kernel's time into its parts
(``rowcol-checker-on-splitters`` moves B3's and B7's f32 checker to the
splitter warps): with ``--magnitude=0``
and without, the mainloop and splitter sums (one final check, no faults),
the drains at the checks (returning check against one final check, no
faults), the fault drains (returning check, faults against none) and the
check body (the tree against its returning check):

    python3 scripts/torch_variant_time.py --variant=rowcol-check-returns RET
    python3 scripts/torch_variant_time.py --variant=one-final-check ONE
    python3 scripts/torch_variant_time.py --kernels=B3,B7,B4 --tiles=huge,small --dtype=bfloat16 --magnitude=0 . RET ONE

The same for B4 and B5: ``splitter-sums-zero`` (B5's moment sums and B4's
band sums write zeros; B4's split of B stays), ``global-check-returns``
(B4's check returns after its drain), ``one-final-check`` and
``adaptive-sums-skipped`` (the adaptive build's running sums of A and B
skipped); they apply to the earlier form of the kernels (B5's moment
sums one lane a job, B4's band sums in 8-row groups, ``GlobalCheck``) and
to the lane-group form that replaced it. ``b5-sums-by-thread`` (the
earlier moment sums, in the lane-group tree), ``b5-lanes-everywhere``,
``producer-40``,
``b4-producer-40``, ``b4-producer-56``, ``faults-at-once`` and
``b4-sums-8-row-groups`` time the redesign's parts:

    python3 scripts/torch_variant_time.py --variant=splitter-sums-zero --from=PARENT ZERO
    python3 scripts/torch_variant_time.py --kernels=B1,B4,B5 --tiles=huge,small --magnitude=0 PARENT ZERO
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import sys

from torch_kernel_ab import _import_port, card, turns

SIZE = 4096
TILES = ("small", "medium", "large", "tall", "wide", "huge")
# kernel -> (ints after the 6 dimensions, the kernel kind, the (strategy,
# encode) whose plan gives its cadence); each kind's library, entry point
# and argument types are the tree's own (``ops/ft_sgemm.kernel_entry``,
# ``_ARGS``); B1 takes no grids and no scalars.
KERNELS = {
    "B1": (0, "sgemm", None),
    "B2": (0, "precomp", ("weighted", "vpu")),
    "B3": (2, "rowcol", ("rowcol", "vpu")),
    "B5": (1, "running", ("weighted", "vpu")),
    "B4": (1, "global", ("global", "vpu")),
    "B6": (1, "fused", ("fused", "mxu")),
    "B7": (2, "rowcol_mxu", ("rowcol", "mxu")),
    "B8": (1, "global_mxu", ("global", "mxu")),
}
DEFAULT_KERNELS = ("B3", "B4", "B6", "B7", "B8")

# Named one-change copies of the package: file -> [(text, replacement)],
# each text found exactly once.
VARIANTS = {
    "device-scalars": {"csrc/ft_sgemm_running.cuh": [
        ("    Scalars sc, NoiseModel nm, Epilogue epi, Variant v) {\n"
         "  const WgSmem<T> sm;\n",
         "    const Scalars* __restrict__ scp, NoiseModel nm, Epilogue epi,\n"
         "    Variant v) {\n"
         "  const Scalars sc = *scp;\n  const WgSmem<T> sm;\n"),
        ("template <template <int, int> class Of>\nint launch_running(",
         "__device__ Scalars g_scalars;\n\n"
         "template <template <int, int> class Of>\nint launch_running("),
        ("  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];\n",
         "  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];\n"
         "  Scalars* scp = nullptr;\n"
         "  if (const cudaError_t e = cudaGetSymbolAddress((void**)&scp,"
         " g_scalars))\n    return (int)e;\n"
         "  if (const cudaError_t e = cudaMemcpyAsync(scp, &sc, sizeof sc,\n"
         "          cudaMemcpyHostToDevice, stream))\n    return (int)e;\n"),
        ("bk, check_every, alpha, beta, sc, nm, epi, v);",
         "bk, check_every, alpha, beta, scp, nm, epi, v);"),
    ]},
}
# The parts of the rowcol kernels (B3, B7), timed apart: a check that
# returns at once after its drain (the consumers drain and post nothing, the
# checker decides nothing, nothing is corrected), and the cadence at one
# final check (every kernel of the tree). A tree with the single-phase
# rowcol check took the first as a `return;` at the top of its
# RowcolCheck::check and the second as RunHook's first check step alone.
_RUNHOOK_CHK = ("ck(sc, nm, scratch),\n"
                "        chk(min(check_every * (bk / 8), K / 8) - 1),")
_CHECKER_CHK = ("cm(*reinterpret_cast<Slot*>(scratch)),\n"
                "        chk(min(check_every * (bk / 8), K / 8) - 1),")
VARIANTS["rowcol-check-returns"] = {"csrc/ft_sgemm_running.cuh": [
    ("      inj.fold(ml, chk);\n      ck.post(ml, chk);\n",
     "      inj.fold(ml, chk);\n"),
    (_CHECKER_CHK, _CHECKER_CHK.replace(
        "min(check_every * (bk / 8), K / 8) - 1", "INT_MAX"))]}
_GLOBAL_CHK = "        chk(min(every8, nk8) - 1), thr0(sc.s[SLOT_THRESHOLD]), nm(nm_),"
VARIANTS["one-final-check"] = {"csrc/ft_sgemm_running.cuh": [
    (x, x.replace("min(check_every * (bk / 8), K / 8) - 1", "K / 8 - 1"))
    for x in (_RUNHOOK_CHK, _CHECKER_CHK)] + [
    [(_GLOBAL_CHK, _GLOBAL_CHK.replace("min(every8, nk8) - 1", "nk8 - 1")),
     ("", "")]]}
# The rowcol checker deciding nothing (it takes each post and publishes no
# correction at once): the consumers' own part of the split-phase check.
VARIANTS["rowcol-checker-decides-nothing"] = {"csrc/ft_sgemm_running.cuh": [
    ("    mbar_wait(&cm.posted, k & 1);\n",
     "    mbar_wait(&cm.posted, k & 1);\n"
     "    if (e < T::NBM) cm.gmask[e] = 0u;\n"
     "    chk = chk == nk8 - 1 ? INT_MAX : min(chk + every8, nk8 - 1);\n"
     "    ++k;\n    mbar_arrive(&cm.decided);\n    return;\n")]}
# The rowcol checker on the splitter warps at every tile (as at the
# small tile and as B7 in bf16), not on the first producer warp.
VARIANTS["rowcol-checker-on-splitters"] = {"csrc/ft_sgemm_running.cuh": [
    ("  static constexpr bool kOnLoader = T::SPLIT && T::NSUB <= 4;\n",
     "  static constexpr bool kOnLoader = false;\n")]}
# ... or on the first producer warp at every tile where the splitter warps
# work (B3, and B7 in f32).
VARIANTS["rowcol-checker-on-loader"] = {"csrc/ft_sgemm_running.cuh": [
    ("  static constexpr bool kOnLoader = T::SPLIT && T::NSUB <= 4;\n",
     "  static constexpr bool kOnLoader = T::SPLIT;\n")]}
# The parts of B4 and B5 (the weighted and global kernels), timed apart.
# An edit that is a list holds alternatives, the first whose text the tree
# holds once applied: the lane-group form (lane groups, GlobalSplitCheck;
# first, since B3 keeps the earlier band-sum functions and B8 GlobalCheck)
# and the earlier one (B5's sums one thread a job, B4's in 8-row groups
# through the producer scratch, GlobalCheck). Their splitter sums
# writing zeros: B5's moment rows (every row band and column, f32 and bf16)
# and B4's band rows of B (B's split alone in f32, as B8's; nothing summed
# in bf16 and int8); B3's own sums stay.
_B4_ZERO_F32 = ("    if constexpr (T::BANDS == kSumBands && T::ROWS != kSumRowGroups) {\n"
                "      split4(b(s), blo(s), T::B_BOX / 16, e);\n"
                "      for (int z = T::BN * T::SK + e; z < (T::BN + T::NBN) * T::SK;\n"
                "           z += T::SPLITTERS)\n"
                "        b(s)[z] = blo(s)[z] = 0.f;\n"
                "      return;\n    }\n")
_B4_ZERO_BF16 = ("    if constexpr (T::ROWS != kSumRowGroups) {\n"
                 "      for (int z = e; z < T::NBN * 32; z += T::SPLITTERS)\n"
                 "        for (int t = 0; t < 3; ++t)\n"
                 "          bw(s)[swz_word(T::BN + 8 * t + z / 32, z % 32)] = 0u;\n"
                 "      return;\n    }\n")
_B4_ZERO_S8 = ("    if constexpr (T::ROWS != kSumRowGroups) {\n"
               "      for (int z = e; z < T::NBN * 32; z += T::SPLITTERS)\n"
               "        bw(s)[swz_word(T::BN + z / 32, z % 32)] =\n"
               "            bw(s)[swz_word(T::BN + 8 + z / 32, z % 32)] = 0u;\n"
               "      return;\n    }\n")
_PR17_SPLIT_B = ("  __device__ __forceinline__ void split_b(int st, int e) const {\n"
                 "    const int s = st % T::STAGES;\n")
_PR17_BANDS_BF16 = ("  __device__ __forceinline__ void sum_bands_bf16(int st, int e)"
                    " const {\n    const int s = st % T::STAGES;\n")
_PR17_BANDS_S8 = ("  __device__ __forceinline__ void sum_bands_s8(int st, int e)"
                  " const {\n    const int s = st % T::STAGES;\n")
_LANES_F32 = "  __device__ __forceinline__ void split_bands(int s, int e) const {\n"
_LANES_BF16 = ("  __device__ __forceinline__ void band_sums_bf16(int s, int e)"
               " const {\n")
_LANES_S8 = "  __device__ __forceinline__ void band_sums_s8(int s, int e) const {\n"
VARIANTS["splitter-sums-zero"] = {"csrc/gemm_wgmma.cuh": [
    [("#pragma unroll 8\n      for (int rr = 0; rr < T::SBM; ++rr) {\n"
      "        const int r = band * T::SBM + rr;\n",
      "#pragma unroll 8\n      for (int rr = 0; rr < 0; ++rr) {\n"
      "        const int r = band * T::SBM + rr;\n"),
     ("      for (int i = 0; i < ROW_N; ++i) {\n"
      "        const int rr = u + G * i, r = band * T::SBM + rr;\n",
      "      for (int i = 0; i < 0; ++i) {\n"
      "        const int rr = u + G * i, r = band * T::SBM + rr;\n")],
    [("      for (int rr = 0; rr < T::SBM; ++rr) {\n"
      "        const uint32_t x = a_[swz_word(band * T::SBM + rr, p)];",
      "      for (int rr = 0; rr < 0; ++rr) {\n"
      "        const uint32_t x = a_[swz_word(band * T::SBM + rr, p)];"),
     ("      for (int i = 0; i < ROW_N; ++i) {\n"
      "        const int rr = u + G * i;\n",
      "      for (int i = 0; i < 0; ++i) {\n"
      "        const int rr = u + G * i;\n")],
    [(_LANES_F32, _LANES_F32 + _B4_ZERO_F32),
     (_PR17_SPLIT_B, _PR17_SPLIT_B + _B4_ZERO_F32)],
    [(_LANES_BF16, _LANES_BF16 + _B4_ZERO_BF16),
     (_PR17_BANDS_BF16, _PR17_BANDS_BF16 + _B4_ZERO_BF16)],
    [(_LANES_S8, _LANES_S8 + _B4_ZERO_S8),
     (_PR17_BANDS_S8, _PR17_BANDS_S8 + _B4_ZERO_S8)],
]}
# B4's check returning at once after its drain (its thresholds too, in the
# adaptive build): the drains alone; in the split form the consumers post
# nothing and the checker waits for nothing.
VARIANTS["global-check-returns"] = {"csrc/ft_sgemm_running.cuh": [
    [("  __device__ __forceinline__ void post(WgMainloop<T>& ml, int) {\n",
      "  __device__ __forceinline__ void post(WgMainloop<T>& ml, int) {\n"
      "    return;\n"),
     ("  __device__ void check(WgMainloop<T>& ml) {\n"
      "    constexpr int NBN = T::NBN, GPB = T::SBN / 8, WPB = T::SBM / 16;\n",
      "  __device__ void check(WgMainloop<T>& ml) {\n    return;\n"
      "    constexpr int NBN = T::NBN, GPB = T::SBN / 8, WPB = T::SBM / 16;\n")],
    [("  template <class M>\n  __device__ void update(const M& ml, int t) {\n",
      "  template <class M>\n  __device__ void update(const M& ml, int t) {\n"
      "    if constexpr (GLOBAL) return;\n")],
    [("        chk(min(every8, nk8) - 1), thr0(sc.s[SLOT_THRESHOLD]), nm(nm_),",
      "        chk(INT_MAX), thr0(sc.s[SLOT_THRESHOLD]), nm(nm_),"),
     ("", "")]]}
# The adaptive build's running sums of A and B skipped (every kernel; the
# thresholds then come from zero sums).
VARIANTS["adaptive-sums-skipped"] = {"csrc/ft_sgemm_running.cuh": [
    ("                                        int kk, int s) {\n"
     "    if constexpr (T::BF16) {\n      kstep_bf16(ml, ah, kk, s);",
     "                                        int kk, int s) {\n    return;\n"
     "    if constexpr (T::BF16) {\n      kstep_bf16(ml, ah, kk, s);")]}
# The parts of the redesign, timed apart: B5's moment sums one lane a job at
# every tile (the earlier form), or in lane groups of SBM / 16 at
# every tile; B4's and B5's producer at 40 registers, B4's at 40, or at 56
# in every dtype; their faults added at once (not folded); B4's band sums
# in the earlier 8-row groups through the producer scratch (with its posted
# check and folded faults).
VARIANTS["b5-sums-by-thread"] = {"csrc/gemm_wgmma.cuh": [
    ("  static constexpr int ROW_LANES = T::SBM == 128 ? 8 : 1;\n",
     "  static constexpr int ROW_LANES = 1;\n")]}
VARIANTS["b5-lanes-everywhere"] = {"csrc/gemm_wgmma.cuh": [
    ("  static constexpr int ROW_LANES = T::SBM == 128 ? 8 : 1;\n",
     "  static constexpr int ROW_LANES = T::SBM / 16;\n")]}
_REGS = ("  static constexpr int PRODUCER =\n"
         "      T::ROWS == kSumRows || (kB4 && !T::BF16) ? 56 : 40;\n")
VARIANTS["producer-40"] = {"csrc/ft_sgemm_running.cuh": [
    (_REGS, "  static constexpr int PRODUCER = 40;\n")]}
VARIANTS["b4-producer-40"] = {"csrc/ft_sgemm_running.cuh": [
    (_REGS, "  static constexpr int PRODUCER = T::ROWS == kSumRows ? 56 : 40;\n")]}
VARIANTS["b4-producer-56"] = {"csrc/ft_sgemm_running.cuh": [
    (_REGS, "  static constexpr int PRODUCER =\n"
            "      T::ROWS == kSumRows || kB4 ? 56 : 40;\n")]}
VARIANTS["faults-at-once"] = {"csrc/ft_sgemm_running.cuh": [
    ("struct WeightedFoldCheck : WeightedCheck<T, TH> {\n"
     "  static constexpr bool kFoldFaults = true;\n",
     "struct WeightedFoldCheck : WeightedCheck<T, TH> {\n"
     "  static constexpr bool kFoldFaults = false;\n"),
    ("  static constexpr bool kFoldFaults = true;\n"
     "  static constexpr bool kCheckerGrids = true;\n",
     "  static constexpr bool kFoldFaults = false;\n"
     "  static constexpr bool kCheckerGrids = true;\n")]}
VARIANTS["b4-sums-8-row-groups"] = {"csrc/gemm_wgmma.cuh": [
    ("      constexpr bool LANES = T::ROWS == kNoRows;  // B4's band sums\n",
     "      constexpr bool LANES = false;\n"),
    ("      (BANDS == kSumBands && ROWS == kSumRowGroups ? BN / 8 : 0) +\n",
     "      (BANDS == kSumBands ? BN / 8 : 0) +\n")]}
# The same with the sub-tiled kernels built at the small tile only (a
# quicker build of the kernel that the change moved: chip_smoke.py's
# regression phase; its C++ symbols in a namespace of their own, so that it
# loads beside the kernels' own library).
VARIANTS["device-scalars-small"] = {
    "csrc/ft_sgemm_running.cuh": VARIANTS["device-scalars"][
        "csrc/ft_sgemm_running.cuh"] + [
        ("  FTSG_FOR_EACH_SUBTILE(FTSG_LAUNCH_SUB)\n#undef FTSG_LAUNCH_SUB",
         "  FTSG_LAUNCH_SUB(16, 16)\n#undef FTSG_LAUNCH_SUB")],
    "csrc/abft_common.cuh": [
        ("#define FTSG_NAMESPACE_BEGIN namespace ftsg {\n"
         "#define FTSG_NAMESPACE_END }\n",
         "#define FTSG_NAMESPACE_BEGIN namespace ftsg { inline namespace v {\n"
         "#define FTSG_NAMESPACE_END } }\n")]}


def write_variant(name: str, dest: str, tree: str = "") -> None:
    """This checkout's package (or the one under ``tree``), with the change
    ``VARIANTS[name]``, in ``dest`` (which must not exist yet); its build
    directory is not copied. An edit that is a list holds alternatives:
    the first whose text the package holds once applies (an empty text:
    none needed)."""
    root = (pathlib.Path(tree) if tree
            else pathlib.Path(__file__).resolve().parents[1])
    src = root / "ft_sgemm_tpu_torch"
    pkg = pathlib.Path(dest) / "ft_sgemm_tpu_torch"
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for rel, edits in VARIANTS[name].items():
        path = pkg / rel
        text = path.read_text()
        for edit in edits:
            for old, new in edit if isinstance(edit, list) else [edit]:
                if not old or text.count(old) == 1:
                    text = text.replace(old, new) if old else text
                    break
            else:
                raise RuntimeError(f"{name}: {rel} does not hold {edit!r} once")
        path.write_text(text)


def _libs(kernels, adaptive: bool, bf16=False) -> dict:
    """Each kernel's (library, entry point) in the imported tree; ``bf16``
    True, False or "int8"."""
    import torch

    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft

    dtype = (torch.int8 if bf16 == "int8" else
             torch.bfloat16 if bf16 else torch.float32)
    return {k: (("sgemm", "ftsg_sgemm" + ("_bf16" if bf16 else ""))
                if KERNELS[k][1] == "sgemm"
                else ft.kernel_entry(KERNELS[k][1], dtype, adaptive))
            for k in kernels}


def build(tree: str, kernels, adaptive: bool = False,
          bf16: bool = False) -> None:
    _import_port(tree)
    from ft_sgemm_tpu_torch.ops import _build

    _build.build(tuple(dict.fromkeys(
        lib for lib, _ in _libs(kernels, adaptive, bf16).values())))


def measure(tree: str, kernels, tiles, adaptive: bool = False,
            magnitude: float = 1e4, bf16: bool = False) -> dict:
    """Milliseconds per launch of each kernel on each tile, and its counts."""
    _import_port(tree)
    import numpy as np
    import torch

    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
    from ft_sgemm_tpu_torch.ops.common import (
        DEFAULT_THRESHOLD_MARGIN,
        NOISE_C_BIAS,
        NOISE_C_RAND,
        full_run_log2,
        scalar_operand,
    )
    from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # A tree with the fused epilogue takes its four arguments before the
    # stream (ops/_build.EPILOGUE_ARGS): the identity's here.
    epi = getattr(_build, "EPILOGUE_ARGS", [])
    identity = (None, 0, 0, 1.0)[:len(epi)]
    # A tree with the variant axes takes two more (ops/_build.
    # VARIANT_ARGS): the default grid order and precision's here.
    var = getattr(_build, "VARIANT_ARGS", [])
    identity += (0, 0)[:len(var)]
    entries = {}
    for kern, (lib, entry) in _libs(kernels, adaptive, bf16).items():
        kind = KERNELS[kern][1]
        entries[kern] = _build.bind(
            _build.library(lib), entry,
            [p] * 4 + [i] * 6 + [f, f] + epi + var + [p]
            if kind == "sgemm" else ft._ARGS[kind])
    gen = np.random.default_rng(1)
    a, b, c = (torch.from_numpy(generate_random_matrix(SIZE, SIZE, rng=gen)).cuda()
               for _ in range(3))
    if bf16 == "int8":
        from ft_sgemm_tpu_torch.ops.common import as_operand

        a, b = (as_operand(torch.round(x * 10.0), torch.int8, x.device)
                for x in (a, b))
    elif bf16:
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream
    row = {}
    for name in tiles:
        sh = SHAPES[name]
        # The plan (cadence, multifault) is the reference-like schedule's
        # also without faults, so that --magnitude=0 removes the faults
        # alone.
        ref = InjectionSpec.reference_like(SIZE, sh.bk,
                                           magnitude=magnitude or 1e4)
        inj = ref if magnitude else InjectionSpec.none()
        sc = (scalar_operand(inj, (0.0,) * 3, DEFAULT_THRESHOLD_MARGIN)
              if adaptive else
              scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3))
        det = torch.empty((SIZE // sh.bm, SIZE // sh.bn), dtype=torch.int32,
                          device="cuda")
        unc = torch.empty_like(det)
        dims = (SIZE, SIZE, SIZE, sh.bm, sh.bn, sh.bk)
        for kern, fn in entries.items():
            n_int, kind, pair = KERNELS[kern]
            if kind == "sgemm":
                def launch(fn=fn, kern=kern):
                    _build.check_launch(
                        fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                           out.data_ptr(), *dims, 1.0, -1.5, *identity,
                           stream), kern)

                row[f"{kern} {name}"] = cuda_ms(launch, reps=5)
                continue
            _, ce, mf = ft._plan(pair[0], None, None, ref, SIZE // sh.bk,
                                 sh.bn, pair[1], adaptive)
            rows = ft.kernel_inputs(kind, a, b, sh)
            ints = (ce, int(mf) if bf16 != "int8" else 0)[:n_int]
            noise = () if kind == "precomp" else (
                full_run_log2(SIZE // sh.bk, sh.bk, sh.bm, sh.bn),
                NOISE_C_RAND, NOISE_C_BIAS)

            def launch(fn=fn, kern=kern, rows=rows, ints=ints, noise=noise):
                _build.check_launch(
                    fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       *(r.data_ptr() for r in rows), out.data_ptr(),
                       det.data_ptr(), unc.data_ptr(), *dims, *ints,
                       1.0, -1.5, sc.ctypes.data, *noise, *identity,
                       stream), kern)

            row[f"{kern} {name}"] = cuda_ms(launch, reps=5)
            launch()
            torch.cuda.synchronize()
            row[f"{kern} {name} det/unc"] = f"{int(det.sum())}/{int(unc.sum())}"
    return row


def main(argv) -> int:
    opts = {a.split("=", 1)[0]: a.split("=", 1)[1] for a in argv[1:]
            if a.startswith("--") and "=" in a}
    kernels = tuple(opts.get("--kernels", ",".join(DEFAULT_KERNELS)).split(","))
    tiles = tuple(opts.get("--tiles", ",".join(TILES)).split(","))
    adaptive = opts.get("--threshold", "static") == "adaptive"
    magnitude = float(opts.get("--magnitude", 1e4))
    dtype = opts.get("--dtype", "float32")
    bf16 = "int8" if dtype == "int8" else dtype == "bfloat16"
    args = [a for a in argv[1:] if not (a.startswith("--") and "=" in a)]
    if "--variant" in opts and len(args) == 1 and opts["--variant"] in VARIANTS:
        write_variant(opts["--variant"], args[0], opts.get("--from", ""))
        return 0
    if len(args) == 2 and args[0] in ("--build", "--measure"):
        if args[0] == "--build":
            build(args[1], kernels, adaptive, bf16)
        else:
            print(json.dumps(measure(args[1], kernels, tiles, adaptive,
                                     magnitude, bf16)))
        return 0
    trees = args
    if (not trees or any(t.startswith("--") for t in trees)
            or not set(kernels) <= set(KERNELS)
            or dtype not in ("float32", "bfloat16", "int8")
            or bf16 == "int8" and (adaptive or set(kernels) - {"B3", "B4"})
            or adaptive and not set(kernels) <= set(KERNELS) - {"B1", "B2"}):
        print(__doc__)
        return 2
    print(card(), flush=True)
    picks = (f"--kernels={','.join(kernels)}",
             f"--threshold={'adaptive' if adaptive else 'static'}",
             f"--tiles={','.join(tiles)}", f"--magnitude={magnitude}",
             f"--dtype={dtype}")
    for name, row in turns(__file__, trees, *picks,
                           build_args=picks[:2] + picks[4:]):
        print(f"{name:19s} " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

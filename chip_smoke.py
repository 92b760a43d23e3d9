"""Chip smoke for the PyTorch / CUDA port (``ft_sgemm_tpu_torch``) on one H100.

Builds the port's hand-written CUDA kernels from ``ft_sgemm_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (at every tile of
the port's table, B3-B8 also with checks inside a pipeline stage, and at
every shape, cadence and multifault setting the paper's program gives it
under every (strategy, encode) pair), holds the 3xTF32 wgmma kernels'
accuracy against a float64 product and cuBLAS FP32 at 4096 and their clean
checksum residuals 100x under the threshold, drives that ``ft_sgemm``
program (verification at 4096 for ids 0-16 under the weighted
and rowcol strategies and for ids 11-16 under global, fused, rowcol with
encode mxu and global with encode mxu; the GFLOPS table at 2048 / 4096 /
6144, and at 4096 for ids 11-16 under rowcol and each of those four
pairs) and shows through the kernels' launch counters that the program
ran them. Prints one line per phase, a
``kernels`` JSON line with each kernel's launches, error and times against
its bound, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
nonzero without the last line; so does a host without a CUDA device or a
directory without the port.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel-vs-plain sizes: aligned, odd, and one that leaves B5's and B6's
# 128 x 128 CTA partly past the operands at every tile narrower than 128.
SIZES = (1024, 1000, 300)
VERIFY_SIZE = 4096
PERF_SIZES = (2048, 6144, 2048)  # start, end, gap
PERF_MINTIME = 0.1            # seconds per timed loop (the CLI default is 1)
TIMING_SIZE = 4096

# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# The tiles on which B1's accuracy is held: every program tile, since every
# kernel runs the 3xTF32 wgmma mainloop at every tile (B1 on the tile's own
# CTA at large, tall and huge, on the 128 x 128 one at small, medium, wide).
WGMMA_TILES = ("small", "medium", "large", "tall", "wide", "huge")
# A check cadence in bk steps that ends checks inside a 32-column stage.
MID_STAGE_EVERY = 3
# The clean weighted residuals must stay this far under the threshold.
RESIDUAL_MARGIN = 100.0

# ops/ft_sgemm._plan's kernel kinds, and "sgemm" for B1.
KIND_NAMES = {"sgemm": "sgemm", "precomp": "ft_sgemm_weighted_precomp",
              "running": "ft_sgemm_weighted_running",
              "rowcol": "ft_sgemm_rowcol", "global": "ft_sgemm_global",
              "fused": "ft_sgemm_fused", "rowcol_mxu": "ft_sgemm_rowcol_mxu",
              "global_mxu": "ft_sgemm_global_mxu"}
DETECT_ONLY = ("global", "global_mxu")
# The (strategy, encode) pairs this slice added to the program; fused
# encodes from moment rows whatever --encode says.
NEW_PAIRS = (("global", "vpu"), ("fused", "mxu"), ("rowcol", "mxu"),
             ("global", "mxu"))
# The pairs whose ids 11-16 get a table of their own at 4096: every pair but
# weighted, whose table runs at every size.
TABLE_PAIRS = (("rowcol", "vpu"),) + NEW_PAIRS


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


class Kernels:
    """The port's kernels: wrapper, plain version, source, TPU original,
    and the largest kernel-vs-plain difference seen."""

    def __init__(self):
        from ft_sgemm_tpu_torch import cli
        from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
        from ft_sgemm_tpu_torch.ops import sgemm as sg

        self.ft, self.sg = ft, sg
        self.alpha, self.beta = cli.ALPHA, cli.BETA
        self.table = {
            "sgemm": dict(
                wrapper=sg.sgemm_kernel, source="ft_sgemm_tpu_torch/csrc/sgemm.cu",
                replaces="ft_sgemm_tpu/ops/sgemm.py:67"),
            "ft_sgemm_weighted_precomp": dict(
                wrapper=ft.ft_weighted_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_weighted.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:1012"),
            "ft_sgemm_weighted_running": dict(
                wrapper=ft.ft_weighted_running_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_weighted.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:917"),
            "ft_sgemm_rowcol": dict(
                wrapper=ft.ft_rowcol_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_rowcol.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:516"),
            "ft_sgemm_global": dict(
                wrapper=ft.ft_global_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_global.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:832"),
            "ft_sgemm_fused": dict(
                wrapper=ft.ft_fused_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_aug.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:1077"),
            "ft_sgemm_rowcol_mxu": dict(
                wrapper=ft.ft_rowcol_mxu_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_aug.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:648"),
            "ft_sgemm_global_mxu": dict(
                wrapper=ft.ft_global_mxu_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_global.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:758"),
        }
        self.max_err = {name: 0.0 for name in self.table}
        self.checked = {name: 0 for name in self.table}

    def zero_counts(self):
        for k in self.table.values():
            k["wrapper"].launches = 0

    def counts(self):
        return {name: k["wrapper"].launches for name, k in self.table.items()}

    def calls(self, kind, shape, a, b, c, scalars=None, check_every=None,
              multifault=False):
        """(kernel thunk, plain thunk) for one launch of ``kind`` on padded
        operands, with the program's alpha and beta. The wrapper-side inputs
        (B2's expected moments, the mxu kernels' moment rows) are made
        here, outside both thunks, as inputs of the kernel."""
        ft, sg, al, be = self.ft, self.sg, self.alpha, self.beta
        if kind == "sgemm":
            return (lambda: sg.sgemm_kernel(a, b, c, shape, al, be),
                    lambda: sg.sgemm_plain(a, b, c, al, be))
        args = (kind, shape, a, b, c, ft.kernel_inputs(kind, a, b, shape), al,
                be, scalars, check_every, multifault)
        return (lambda: ft.run_kernel(*args),
                lambda: ft.run_kernel(*args, plain=True))

    def hold(self, kind, shape, a, b, c, scalars=None, check_every=None,
             multifault=False):
        """One launch against its plain version on the same operands: (det,
        unc) grids equal, C within verify_matrix on every tile the kernel
        reports correctable. A tile reported uncorrectable (the adversarial
        schedule) may be miscorrected differently by the two — the weighted
        ratio can fall on a rounding tie — so its C is not compared. The
        detect-only global kernels correct nothing: both sides keep the
        same faults, and C is compared everywhere."""
        from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

        name = KIND_NAMES[kind]
        run, plain = self.calls(kind, shape, a, b, c, scalars, check_every,
                                multifault)
        got, want = run(), plain()
        torch.cuda.synchronize()
        out, ref = (got, want) if kind == "sgemm" else (got[0], want[0])
        mask = torch.ones_like(out, dtype=torch.bool)
        if kind != "sgemm":
            (_, det, unc), (_, pdet, punc) = got, want
            if not (torch.equal(det, pdet) and torch.equal(unc, punc)):
                raise AssertionError(
                    f"{name} {shape.name} {tuple(a.shape)}: grids differ: det"
                    f" {int(det.sum())} vs {int(pdet.sum())}, unc"
                    f" {int(unc.sum())} vs {int(punc.sum())}")
            if kind not in DETECT_ONLY:
                mask = (unc == 0).repeat_interleave(
                    shape.bm, 0).repeat_interleave(shape.bn, 1)
        ok, nbad, first = verify_matrix(ref[mask].cpu().numpy(),
                                        out[mask].cpu().numpy(), verbose=False)
        if not ok:
            raise AssertionError(
                f"{name} {shape.name} {tuple(a.shape)}: C differs from the"
                f" plain version at {nbad} elements (first {first})")
        err = float((out - ref)[mask].abs().max()) if mask.any() else 0.0
        self.max_err[name] = max(self.max_err[name], err)
        self.checked[name] += 1


def phase_device():
    from ft_sgemm_tpu_torch import runtime
    from ft_sgemm_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    log(f"phase device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | {smi} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    secs = _build.build()
    log(f"phase build: {len(_build.KERNEL_SOURCES)} sources in parallel,"
        f" {secs:.1f} s")
    for name in _build.KERNEL_SOURCES:
        log(f"  ptxas {name}: " + ", ".join(ptxas_summary(_build.ptxas_log(name))))
    # Without a host compiler the verification would silently draw numpy
    # inputs instead of the reference binary's libc-rand stream.
    if runtime.load() is None:
        raise AssertionError("hostutils.cpp did not build: no libc-rand inputs")
    return smi


def ptxas_summary(text: str):
    """``kernel<dims[,flag]>: R regs[, S B spilled]`` for each kernel in one
    source's ``-Xptxas -v`` log (names demangled just enough to tell the
    kernels apart: a wgmma tile's bm, bn, sub-tile bm, bn, moment rows per
    band and the band-row and moment-row sources, ``gemm_wgmma.cuh::BandRows``
    and ``MomentRows``, then B1's ragged-store flag)."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '(\w+)' for 'sm_90a'"
                               r"(.*?)(?=Compiling entry function|$)", text, re.S):
        kind = re.search(r"ftsg\d+(\w+?_kernel)I", fn).group(1)
        dims = re.search(r"WgTileI((?:Li\d+E){5})", fn)
        rows = re.search(r"WgTileI(?:Li\d+E){6}Li(\d+)ELi(\d+)E", fn)
        ragged = re.search(r"EELb(\d)E", fn)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores", body)
        tag = ",".join(re.findall(r"\d+", dims.group(1)) + list(rows.groups())
                       + ([ragged.group(1)] if ragged else []))
        out.append(f"{kind}<{tag}>: {regs} regs"
                   + (f", {spill.group(1)} B spilled"
                      if spill and spill.group(1) != "0" else "")
                   + (", wgmma serialized" if "serialized" in body else ""))
    return sorted(out)


def _padded(host, shape):
    """Host (A, B, C) on the card, padded to the tile as the entry points
    pad them."""
    from ft_sgemm_tpu_torch.ops.common import pad_to

    a, b, c = (torch.from_numpy(x).cuda() for x in host)
    return (pad_to(a, shape.bm, shape.bk), pad_to(b, shape.bn, shape.bk),
            pad_to(c, shape.bm, shape.bn))


def _random(m, n, k, gen):
    from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix

    return tuple(generate_random_matrix(r, s, rng=gen)
                 for r, s in ((m, k), (n, k), (m, n)))


def _scalars(inj):
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD
    from ft_sgemm_tpu_torch.ops.common import scalar_operand

    return scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3)


def phase_kernels(kern: Kernels):
    """Each kernel against its plain version at every tile of the port's
    table, at the sizes of SIZES, clean, with reference-like
    injection and with the adversarial col_stride=0 schedule. Each FT
    kernel runs at the cadence the program gives its strategy; B5 where the
    program does not run it, and B5 and B6 besides, at four checks per run
    and (clean and reference-like) every MID_STAGE_EVERY bk steps (checks
    inside a 32-column stage), so that every tile sees intermediate
    checks; both rowcol kernels with multifault off and on; B3 and B7
    (multifault on) and B4 and B8 besides every MID_STAGE_EVERY bk steps,
    clean and reference-like."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    gen = np.random.default_rng(7)
    t0 = time.perf_counter()
    for shape in SHAPES.values():
        for size in SIZES:
            a, b, c = _padded(_random(size, size, size, gen), shape)
            kern.hold("sgemm", shape, a, b, c)
            nk = a.shape[1] // shape.bk
            quarter = max(1, nk // 4)
            ref = InjectionSpec.reference_like(size, shape.bk)
            for inj in (InjectionSpec.none(), ref,
                        InjectionSpec(True, ref.every, col_stride=0)):
                sc = _scalars(inj)

                def cadence(strategy):
                    return ft._plan(strategy, None, None, inj, nk, shape.bn)[1]

                kern.hold("precomp", shape, a, b, c, sc)
                # Checks inside a stage under the schedules with one fault
                # per column and interval; col_stride=0 puts one or two
                # faults in a column per MID_STAGE_EVERY steps, and two
                # equal faults make the weighted ratio a rounding tie.
                mid = {MID_STAGE_EVERY} if inj.col_stride else set()
                ce = cadence("weighted")
                for ce in sorted({ce if ce < nk else quarter} | mid):
                    kern.hold("running", shape, a, b, c, sc, ce)
                for ce in sorted({cadence("fused"), quarter} | mid):
                    kern.hold("fused", shape, a, b, c, sc, ce)
                for mf in (False, True):
                    kern.hold("rowcol", shape, a, b, c, sc, cadence("rowcol"), mf)
                    kern.hold("rowcol_mxu", shape, a, b, c, sc,
                              cadence("rowcol"), mf)
                for ce in sorted(mid):   # several faults an interval: multifault
                    kern.hold("rowcol", shape, a, b, c, sc, ce, True)
                    kern.hold("rowcol_mxu", shape, a, b, c, sc, ce, True)
                for kind in ("global", "global_mxu"):
                    for ce in sorted({cadence("global")} | mid):
                        kern.hold(kind, shape, a, b, c, sc, ce)
    log(f"phase kernels: {dict(kern.checked)} comparisons with the plain"
        f" versions pass, max |dC| {kern.max_err}"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_accuracy(kern: Kernels):
    """B1 at every program tile against a float64 product of the same operands,
    beside cuBLAS FP32 (``torch.addmm`` with TF32 off): on the program's
    libc-rand verification inputs (C zero) and on the table's inputs at
    4096, the kernel's largest error must be at most twice cuBLAS's."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.ops.common import strict_fp32

    a, b = runtime.generate_reference_driver_inputs(VERIFY_SIZE)
    inputs = {"verification": (a, b, np.zeros_like(a)),
              "table": cli._host_inputs(TIMING_SIZE)}
    al, be = kern.alpha, kern.beta
    strict_fp32()
    for label, host in inputs.items():
        a, b, c = (torch.from_numpy(x).cuda() for x in host)
        exact = al * (a.double() @ b.double().T) + be * c.double()
        cublas = float((torch.addmm(c, a, b.T, beta=be, alpha=al).double()
                        - exact).abs().max())
        errs = {}
        for name in WGMMA_TILES:
            out = kern.sg.sgemm_kernel(*_padded(host, SHAPES[name]),
                                       SHAPES[name], al, be)
            errs[name] = float((out[:a.shape[0], :b.shape[0]].double()
                                - exact).abs().max())
        log(f"phase accuracy ({label} inputs, {a.shape[0]}): max |C - C_f64|"
            f" B1 3xTF32 {errs}, cuBLAS FP32 {cublas}")
        bad = {k: e for k, e in errs.items() if e > 2 * cublas}
        if bad:
            raise AssertionError(f"3xTF32 error {bad} exceeds twice cuBLAS"
                                 f" FP32's {cublas} ({label} inputs)")


def phase_path_shapes(kern: Kernels):
    """Each kernel against its plain version at what the program gives it:
    for every kernel id of 1-16, its tile and the kernel, cadence and
    multifault setting ``make_ft_sgemm`` picks (``ops/ft_sgemm._plan``)
    under the program's injection, on the verification's inputs at 4096
    under every (strategy, encode) pair, on the table's inputs at each of
    its sizes (weighted, as the table runs) and at 4096 under the pairs of
    TABLE_PAIRS. A launch that equals one already held (weighted with encode
    mxu runs fused's kernel at fused's cadence) is held once."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import ENCODE_MODES, KERNEL_TABLE, STRATEGIES, kernel_for_id

    ft = kern.ft
    before = dict(kern.checked)
    t0 = time.perf_counter()
    a, b = runtime.generate_reference_driver_inputs(VERIFY_SIZE)
    verify = (a, b, np.zeros_like(a))
    runs = [(VERIFY_SIZE, s, e, verify) for s in STRATEGIES for e in ENCODE_MODES]
    runs += [(size, "weighted", "vpu", cli._host_inputs(size))
             for size in range(PERF_SIZES[0], PERF_SIZES[1] + 1, PERF_SIZES[2])]
    table = cli._host_inputs(TIMING_SIZE)
    runs += [(TIMING_SIZE, s, e, table) for s, e in TABLE_PAIRS]
    seen = set()
    for size, strategy, encode, host in runs:
        for kid in sorted(KERNEL_TABLE):
            _, shape, is_abft = kernel_for_id(kid)
            if kid in (0, 10):
                continue   # no hand kernel
            if is_abft:
                _, inj = cli._build_ft(kid, size, strategy, encode, "cuda")
                nk = -(-size // shape.bk)
                kind, ce, mf = ft._plan(strategy, None, None, inj, nk,
                                        shape.bn, encode)
            else:
                kind, inj, ce, mf = "sgemm", None, None, False
            key = (id(host), kid, kind, ce, mf)
            if key in seen:
                continue   # B1 does not depend on the strategy
            seen.add(key)
            a, b, c = _padded(host, shape)
            kern.hold(kind, shape, a, b, c,
                      None if inj is None else _scalars(inj), ce, mf)
    done = {k: n - before[k] for k, n in kern.checked.items()}
    log(f"phase path shapes: {done} comparisons with the plain versions pass"
        f" at {VERIFY_SIZE} (verification, every strategy and encode),"
        f" {PERF_SIZES[0]}..{PERF_SIZES[1]} (table) and {TIMING_SIZE}"
        f" (table, {TABLE_PAIRS}), max |dC| {kern.max_err}"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_main_path(kern: Kernels):
    """The ``ft_sgemm`` program: verification at 4096 (ids 0-16 under
    weighted and rowcol, ids 11-16 under each pair of NEW_PAIRS), the
    GFLOPS table (2048..6144, weighted) and the table at 4096 for ids
    11-16 under each pair of TABLE_PAIRS, with the launch counters read
    around it all. A correcting strategy passes with every fault detected
    and none left uncorrectable; the detect-only global strategy with
    every fault event detected (each uncorrected) and a clean run that
    passes the diff (``cli._verify_global_strategy``)."""
    from ft_sgemm_tpu_torch import cli

    kern.zero_counts()
    t0 = time.perf_counter()
    runs = [("weighted", "vpu", 0), ("rowcol", "vpu", 0)]
    runs += [(s, e, 11) for s, e in NEW_PAIRS]
    for strategy, encode, first in runs:
        details = {}
        ok = cli.run_verification(VERIFY_SIZE, first, 16, strategy=strategy,
                                  encode=encode, details=details)
        if not ok:
            raise AssertionError(
                f"run_verification failed under {strategy}/{encode}")
        for kid, d in details.items():
            want_unc = d["detected"] if strategy == "global" else 0
            if d["uncorrectable"] != want_unc or d["detected"] != d["expected"]:
                raise AssertionError(f"{strategy}/{encode} id {kid}: {d}")
        log(f"phase verify {strategy}/{encode}: ids {first}-16 pass at"
            f" {VERIFY_SIZE}; detected/expected faults "
            + ", ".join(f"{k}:{d['detected']}/{d['expected']}"
                        for k, d in sorted(details.items())))
    tables = {("weighted", "vpu"): cli.run_perf_table(
        *PERF_SIZES, 0, 16, min_device_time=PERF_MINTIME)}
    for strategy, encode in TABLE_PAIRS:
        log(f"phase table {strategy}/{encode}: ids 11-16 at {TIMING_SIZE}")
        tables[strategy, encode] = cli.run_perf_table(
            TIMING_SIZE, TIMING_SIZE, 1, 11, 16, min_device_time=PERF_MINTIME,
            strategy=strategy, encode=encode)
    counts = kern.counts()
    log(f"phase main path: {time.perf_counter() - t0:.1f} s, launches {counts}")
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts, tables


# An mxu kernel computes its vpu kernel's function: the same bound.
SAME_FUNCTION = {"fused": "running", "rowcol_mxu": "rowcol",
                 "global_mxu": "global"}


def work(kind, shape, n, check_every=None, multifault=False):
    """(flops, bytes) that one launch's function needs at M = N = K = n.
    An FMA counts as two flops; each input is read once and each output
    written once. Beyond the product and the alpha/beta epilogue: each
    check's sums over the output (weighted: moments 1, w, w^2 by add, FMA,
    FMA; rowcol: row and column sums, plus the w-weighted column sums in
    multifault mode; global: one sum of the tile) and, for the kernels
    with a running encode, the encode of the expected checksums — the A-
    and B-side sums (or, for the mxu kernels, the wrapper's
    ``_tile_moments``, the same sums) once per row or column tile, and the
    per-tile updates once per tile and K column."""
    kind = SAME_FUNCTION.get(kind, kind)
    mn = float(n * n)                       # also M*K and N*K
    gm, gn = n // shape.bm, n // shape.bn
    tiles = gm * gn
    flops = 2.0 * n ** 3 + 3 * mn           # product; alpha*acc + beta*C
    nbytes = 4.0 * 4 * mn                   # A, B, C read; out written
    if kind == "sgemm":
        return flops, nbytes
    nbytes += 4.0 * 2 * tiles               # det, unc
    checks = -(-(n // shape.bk) // check_every) if check_every else 1
    if kind == "precomp":
        flops += 5 * mn
        nbytes += 4.0 * 3 * gm * n          # the expected moments (gm, 3, N)
    elif kind == "running":
        # A's moments 1, w, w^2 (5 * M*K); 3 FMAs per tile, K column, column.
        flops += 5 * mn + tiles * n * 6.0 * shape.bn + 5 * mn * checks
    elif kind == "global":
        # A's and B's plain sums (M*K + N*K); one t_exp FMA per tile and K
        # column; one sum of the output per check.
        flops += 2 * mn + tiles * n * 2.0 + mn * checks
    else:
        # A's and B's plain sums (M*K + N*K); r_exp, c_exp FMAs per tile.
        flops += (2 * mn + tiles * n * 2.0 * (shape.bm + shape.bn)
                  + 2 * mn * checks)
        if multifault:
            flops += 2 * mn + tiles * n * 2.0 * shape.bn + 2 * mn * checks
    return flops, nbytes


def _bound(flops: float, nbytes: float, tc_products: float = 0.0):
    """(ms, bound_by): the larger of the operations over their peak rate
    and the bytes over the memory rate. ``tc_products`` of the flops are
    products that run as three TF32 products each on the tensor cores (the
    3xTF32 wgmma kernels); the rest run at the FP32 rate."""
    t_ops = (3 * tc_products / PEAK_TF32_FLOPS
             + (flops - tc_products) / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tc_products(kind, shape, n, multifault=False):
    """The flops of ``work`` that a 3xTF32 wgmma kernel runs on the tensor
    cores: the product, and the expected sums that the function itself
    needs and the kernel computes beside it as products. For B5 and B6 the
    expected moments E = B_tile . M^T (3 moment rows per row tile: 2 * N *
    K * 3 M / bm, ``work``'s running updates); for B3 the expected column
    sums (1 row per row tile, 2 with multifault: 2 * N * K * M / bm each)
    and the expected row sums, A times B's band sums (2 * M * K * N / bn),
    which are ``work``'s r_exp and c_exp updates. B4 needs only one t_exp
    FMA per tile and K column, which stays at the FP32 rate: its design's
    8 extra product columns are more work than the function needs, so they
    are not counted."""
    kind = SAME_FUNCTION.get(kind, kind)
    return 2.0 * n ** 3 + {
        "running": 6.0 * n ** 3 / shape.bm,
        "rowcol": 2.0 * n ** 3 / shape.bn
        + (4.0 if multifault else 2.0) * n ** 3 / shape.bm}.get(kind, 0.0)


# Which (strategy, encode) runs each kernel kind, for the timing's plan.
KIND_PAIR = {"precomp": ("weighted", "vpu"), "running": ("weighted", "vpu"),
             "rowcol": ("rowcol", "vpu"), "global": ("global", "vpu"),
             "fused": ("fused", "mxu"), "rowcol_mxu": ("rowcol", "mxu"),
             "global_mxu": ("global", "mxu")}

# (kind, tile) of every timing row: each kernel at every tile on which the
# program launches it. The first row of a kernel is its ``kernels`` row.
TIMED = (("sgemm", "huge"), ("precomp", "huge"), ("rowcol", "huge"),
         ("global", "huge"), ("running", "small"), ("fused", "huge"),
         ("rowcol_mxu", "huge"), ("global_mxu", "huge"),
         ("fused", "small"), ("fused", "medium"), ("fused", "large"),
         ("fused", "tall"), ("fused", "wide"),
         ("sgemm", "large"), ("sgemm", "tall"), ("sgemm", "small"),
         ("sgemm", "medium"), ("sgemm", "wide"),
         ("precomp", "large"), ("precomp", "tall"), ("precomp", "medium"),
         ("precomp", "wide"),
         ("rowcol", "small"), ("global", "small"), ("rowcol_mxu", "small"),
         ("global_mxu", "small"))
TIMED += tuple((kind, tile)
               for kind in ("rowcol", "global", "rowcol_mxu", "global_mxu")
               for tile in ("medium", "large", "tall", "wide"))
# Timed though the program does not launch them: B2 at small.
OFF_PATH = (("precomp", "small"),)
TIMED += OFF_PATH


def phase_timing(kern: Kernels, counts):
    """Each kernel at 4096 on every tile, cadence and multifault setting the
    program gives it (``TIMED``): the kernel, its plain version,
    torch.addmm for the same alpha*A@B.T + beta*C, and the bound (3xTF32
    on the tensor cores, counting the expected-sum products that run there,
    ``tc_products``). Rows name their mainloop and carry the FFMA bound
    beside it. B2 at small, which the program does not launch (id 11 runs
    B5 there), is timed too (OFF_PATH)."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    gen = np.random.default_rng(11)
    operands = {}
    rows = {}
    for kind, tile in TIMED:
        shape = SHAPES[tile]
        if tile not in operands:
            operands[tile] = _padded(_random(n, n, n, gen), shape)
        name = KIND_NAMES[kind]
        a, b, c = operands[tile]
        inj = InjectionSpec.reference_like(n, shape.bk)
        ce, mf = None, False
        if kind != "sgemm":
            strategy, encode = KIND_PAIR[kind]
            plan, ce, mf = ft._plan(strategy, None, None, inj, n // shape.bk,
                                    shape.bn, encode)
            if (kind, tile) in OFF_PATH:
                ce, mf = n // shape.bk, False
            elif plan != kind:
                raise AssertionError(f"the program runs {plan} at {shape.name},"
                                     f" not {kind}")
        run, plain = kern.calls(kind, shape, a, b, c, _scalars(inj), ce, mf)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(lambda: torch.addmm(
            c, a, b.T, beta=kern.beta, alpha=kern.alpha), reps=5)
        flops, nbytes = work(kind, shape, n, ce, mf)
        ffma_ms, _ = _bound(flops, nbytes)
        tc_ms, tc_by = _bound(flops, nbytes, tc_products(kind, shape, n, mf))
        mainloop = _build.mainloop(kind, shape)
        bound_ms, bound_by = tc_ms, tc_by
        row = {"name": name, "route": "cuda",
               "source": kern.table[name]["source"],
               "replaces": kern.table[name]["replaces"],
               "launches": counts[name], "max_abs_err": kern.max_err[name],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "tile": shape.name, "mainloop": mainloop,
               "tc_bound_ms": tc_ms, "ffma_bound_ms": ffma_ms}
        rows.setdefault(name, row)
        log(f"phase timing {name} ({shape.name}, {mainloop}, {n}, check every"
            f" {ce}, multifault {mf}): kernel {ms:.3f} ms, plain"
            f" {plain_ms:.3f} ms, torch.addmm {library_ms:.3f} ms, bound"
            f" {bound_ms:.3f} ms ({bound_by}; FFMA {ffma_ms:.3f}, 3xTF32"
            f" {tc_ms:.3f})")
    phase_residual(kern, operands)
    return list(rows.values())


def phase_residual(kern: Kernels, operands):
    """Worst clean checksum residuals at 4096 (C = 0, alpha = 1: the output
    is the accumulator), which must stay RESIDUAL_MARGIN times under the
    threshold: the f32 column moments of B2's (huge, and medium and wide
    on the 128 x 128 CTA) and B5's and B6's (small, huge) accumulators
    against the torch.matmul expectations, and B3's and B7's (small, huge)
    row and column sums against A . s_b and the plain expected column
    checksums; and each tile's total of B4's and B8's accumulators (small,
    huge) against t_exp = s_a . s_b from the moment rows. B3, B5, B6 and B7
    also run clean with the threshold cut RESIDUAL_MARGIN times: their
    in-kernel residuals (the expected sums from the tensor-core products
    against the accumulator's sums) must flag nothing; B4 and B8 flag
    nothing at the threshold."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops.common import scalar_operand

    ft = kern.ft
    n = TIMING_SIZE
    huge = SHAPES["huge"]
    zero = torch.zeros((n, n), device="cuda")
    clean = _scalars(InjectionSpec.none())
    limit = REFERENCE_THRESHOLD / RESIDUAL_MARGIN
    tight = scalar_operand(InjectionSpec.none(), (limit,) * 3)

    def moments_residual(acc, expm, bm):
        t = acc.reshape(n // bm, bm, n)
        w = torch.arange(1, bm + 1, device="cuda",
                         dtype=torch.float32)[None, :, None]
        return [float((expm[:, v] - (t * w ** v).sum(1)).abs().max())
                for v in range(3)]

    worst = {}
    faults = 0
    for kind, tile in (("precomp", "huge"), ("precomp", "medium"),
                       ("precomp", "wide"), ("running", "small"),
                       ("running", "huge"), ("fused", "small"),
                       ("fused", "huge")):
        shape = SHAPES[tile]
        a, b, _ = operands[tile]
        expm = ft._expected_col_checksums(a, b, shape.bm)
        extra = ft.kernel_inputs(kind, a, b, shape)
        nk = n // shape.bk
        ce = ft._plan(KIND_PAIR[kind][0], None, None, InjectionSpec.none(), nk,
                      shape.bn, KIND_PAIR[kind][1])[1]
        if kind != "precomp":
            ce = max(1, nk // 4)   # intermediate checks
        acc, det, unc = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0,
                                      0.0, clean, ce)
        faults += int(det.sum()) + int(unc.sum())
        if kind != "precomp":
            _, tdet, tunc = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0,
                                          0.0, tight, ce)
            if int(tdet.sum()) or int(tunc.sum()):
                raise AssertionError(
                    f"{KIND_NAMES[kind]} {tile}: clean in-kernel residuals"
                    f" above {limit:g} ({int(tdet.sum())} flagged)")
        worst[f"{KIND_NAMES[kind]} {tile}"] = moments_residual(acc, expm,
                                                               shape.bm)
    # B3 and B7: the row sums against A . s_b (B's band sums) and the column
    # sums against the plain expected column checksums; clean, nothing
    # flags, also at the cut threshold.
    for kind, tile in (("rowcol", "small"), ("rowcol", "huge"),
                       ("rowcol_mxu", "small"), ("rowcol_mxu", "huge")):
        shape = SHAPES[tile]
        a, b, _ = operands[tile]
        extra = ft.kernel_inputs(kind, a, b, shape)
        _, ce, mf = ft._plan("rowcol", None, None, InjectionSpec.none(),
                             n // shape.bk, shape.bn, KIND_PAIR[kind][1])
        for sc in (clean, tight):
            acc, det, unc = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0,
                                          0.0, sc, ce, mf)
            if int(det.sum()) or int(unc.sum()):
                raise AssertionError(
                    f"{KIND_NAMES[kind]} {tile}: a clean run flagged"
                    f" {int(det.sum())} at threshold {float(sc[4]):g}")
        r_exp = a @ ft._tile_moments(b, shape.bn, 1)[:, 0].T
        c_exp = ft._expected_col_checksums(a, b, shape.bm)[:, 0]
        worst[f"{KIND_NAMES[kind]} {tile} (rows, columns)"] = [
            float((r_exp - acc.reshape(n, -1, shape.bn).sum(-1)).abs().max()),
            float((c_exp - acc.reshape(-1, shape.bm, n).sum(1)).abs().max())]
    # B4 and B8: each tile's total against t_exp = s_a . s_b from the moment
    # rows.
    worst_global = {}
    for kind, tile in (("global", "small"), ("global", "huge"),
                       ("global_mxu", "small"), ("global_mxu", "huge")):
        shape = SHAPES[tile]
        a, b, _ = operands[tile]
        extra = ft.kernel_inputs(kind, a, b, shape)
        _, ce, _ = ft._plan("global", None, None, InjectionSpec.none(),
                            n // shape.bk, shape.bn, KIND_PAIR[kind][1])
        gacc, gdet, _ = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0, 0.0,
                                      clean, ce)
        faults += int(gdet.sum())
        ma, mb = (ft._tile_moments(x, bt, 1)[:, 0]
                  for x, bt in ((a, shape.bm), (b, shape.bn)))
        t_exp = ma @ mb.T
        totals = gacc.reshape(n // shape.bm, shape.bm, n // shape.bn,
                              shape.bn).sum((1, 3))
        worst_global[f"{KIND_NAMES[kind]} {tile}"] = (
            float((t_exp - totals).abs().max()), float(t_exp.abs().max()))
    if faults:
        raise AssertionError("a clean run reported faults")
    log(f"phase residual: worst clean residual at {n} (weighted: moments 1,"
        f" w, w^2; rowcol: rows, columns; every kernel"
        f" {_build.mainloop('precomp', huge)}): {worst}; global (tile total,"
        f" largest |t_exp|): {worst_global}; threshold 9500, at which B4 and"
        f" B8 flag nothing; B3, B5, B6 and B7 flag nothing at threshold"
        f" {limit:g}")
    bad = {k: v for k, v in worst.items() if max(v) > limit}
    if bad:
        raise AssertionError(f"clean residuals {bad} are not"
                             f" {RESIDUAL_MARGIN:g}x under the threshold")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        kern = Kernels()
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase_device()
    phase_kernels(kern)
    phase_accuracy(kern)
    phase_path_shapes(kern)
    counts, _ = phase_main_path(kern)
    rows = phase_timing(kern, counts)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

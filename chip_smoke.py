"""Chip smoke for the PyTorch / CUDA port (``ft_sgemm_tpu_torch``) on one H100.

Builds the port's hand-written CUDA kernels from ``ft_sgemm_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (at every tile of
the port's table, and at every shape, cadence and multifault setting the
paper's program gives it), drives that ``ft_sgemm`` program (verification
at 4096 for ids 0-16 under the weighted and rowcol strategies, then the
GFLOPS table at 2048 / 4096 / 6144) and shows through the kernels' launch
counters that the program ran them. Prints one line per phase, a
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

SIZES = (1024, 1000)          # kernel-vs-plain sizes: aligned and odd
VERIFY_SIZE = 4096
PERF_SIZES = (2048, 6144, 2048)  # start, end, gap
PERF_MINTIME = 0.1            # seconds per timed loop (the CLI default is 1)
TIMING_SIZE = 4096

# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# ops/ft_sgemm._plan's kernel kinds, and "sgemm" for B1.
KIND_NAMES = {"sgemm": "sgemm", "precomp": "ft_sgemm_weighted_precomp",
              "running": "ft_sgemm_weighted_running",
              "rowcol": "ft_sgemm_rowcol"}


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
        operands, with the program's alpha and beta. B2's expected moments
        are made here, outside both thunks, as an input of the kernel."""
        ft, sg, al, be = self.ft, self.sg, self.alpha, self.beta
        if kind == "sgemm":
            return (lambda: sg.sgemm_kernel(a, b, c, shape, al, be),
                    lambda: sg.sgemm_plain(a, b, c, al, be))
        if kind == "precomp":
            expm = ft._expected_col_checksums(a, b, shape.bm)
            return (lambda: ft.ft_weighted_kernel(a, b, c, expm, shape, al, be,
                                                  scalars),
                    lambda: ft.ft_weighted_plain(a, b, c, shape, al, be,
                                                 scalars, expm=expm))
        if kind == "running":
            return (lambda: ft.ft_weighted_running_kernel(
                        a, b, c, shape, al, be, scalars, check_every),
                    lambda: ft.ft_weighted_plain(a, b, c, shape, al, be, scalars,
                                                 check_every=check_every))
        return (lambda: ft.ft_rowcol_kernel(a, b, c, shape, al, be, scalars,
                                            check_every, multifault),
                lambda: ft.ft_rowcol_plain(a, b, c, shape, al, be, scalars,
                                           check_every, multifault))

    def hold(self, kind, shape, a, b, c, scalars=None, check_every=None,
             multifault=False):
        """One launch against its plain version on the same operands: (det,
        unc) grids equal, C within verify_matrix on every tile the kernel
        reports correctable. A tile reported uncorrectable (the adversarial
        schedule) may be miscorrected differently by the two — the weighted
        ratio can fall on a rounding tie — so its C is not compared."""
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
            mask = (unc == 0).repeat_interleave(shape.bm, 0).repeat_interleave(
                shape.bn, 1)
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
    """``kernel<bm,bn,ks,mr,nr[,flag]>: R regs[, S B spilled]`` for each
    kernel in one source's ``-Xptxas -v`` log (names demangled just enough
    to tell the layouts and the RUNNING / multifault flag apart)."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '(\w+)' for 'sm_90a'"
                               r"(.*?)(?=Compiling entry function|$)", text, re.S):
        kind = re.search(r"ftsg\d+(\w+?_kernel)I", fn).group(1)
        dims = re.search(r"LayoutILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", fn)
        flag = re.search(r"EELb([01])E", fn)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores", body)
        tag = ",".join(dims.groups()) + (f",{flag.group(1)}" if flag else "")
        out.append(f"{kind}<{tag}>: {regs} regs"
                   + (f", {spill.group(1)} B spilled"
                      if spill and spill.group(1) != "0" else ""))
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
    table, at an aligned and an odd size, clean, with reference-like
    injection and with the adversarial col_stride=0 schedule. B5 runs at
    the program's cadence where the program runs it, else at four checks
    per run; rowcol with multifault both off and on."""
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
            ref = InjectionSpec.reference_like(size, shape.bk)
            for inj in (InjectionSpec.none(), ref,
                        InjectionSpec(True, ref.every, col_stride=0)):
                sc = _scalars(inj)
                kern.hold("precomp", shape, a, b, c, sc)
                kind, ce, _ = ft._plan("weighted", None, None, inj, nk, shape.bn)
                kern.hold("running", shape, a, b, c, sc,
                          ce if kind == "running" else max(1, nk // 4))
                _, ce, _ = ft._plan("rowcol", None, None, inj, nk, shape.bn)
                for mf in (False, True):
                    kern.hold("rowcol", shape, a, b, c, sc, ce, mf)
    log(f"phase kernels: {dict(kern.checked)} comparisons with the plain"
        f" versions pass, max |dC| {kern.max_err}"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_path_shapes(kern: Kernels):
    """Each kernel against its plain version at what the program gives it:
    for every kernel id of 1-16, its tile and the kernel, cadence and
    multifault setting ``make_ft_sgemm`` picks (``ops/ft_sgemm._plan``)
    under the program's injection, on the verification's inputs at 4096
    under both strategies and on the table's inputs at each of its sizes
    (weighted, as the table runs)."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import KERNEL_TABLE, kernel_for_id

    ft = kern.ft
    before = dict(kern.checked)
    t0 = time.perf_counter()
    a, b = runtime.generate_reference_driver_inputs(VERIFY_SIZE)
    verify = (a, b, np.zeros_like(a))
    runs = [(VERIFY_SIZE, strategy, verify) for strategy in cli.PORTED_STRATEGIES]
    runs += [(size, "weighted", cli._host_inputs(size))
             for size in range(PERF_SIZES[0], PERF_SIZES[1] + 1, PERF_SIZES[2])]
    for size, strategy, host in runs:
        for kid in sorted(KERNEL_TABLE):
            _, shape, is_abft = kernel_for_id(kid)
            if kid in (0, 10) or (not is_abft and strategy != "weighted"):
                continue   # no hand kernel; B1 does not depend on the strategy
            a, b, c = _padded(host, shape)
            if not is_abft:
                kern.hold("sgemm", shape, a, b, c)
                continue
            _, inj = cli._build_ft(kid, size, strategy, "cuda")
            kind, ce, mf = ft._plan(strategy, None, None, inj,
                                    a.shape[1] // shape.bk, shape.bn)
            kern.hold(kind, shape, a, b, c, _scalars(inj), ce, mf)
    done = {k: n - before[k] for k, n in kern.checked.items()}
    log(f"phase path shapes: {done} comparisons with the plain versions pass"
        f" at {VERIFY_SIZE} (verification, both strategies) and"
        f" {PERF_SIZES[0]}..{PERF_SIZES[1]} (table), max |dC| {kern.max_err}"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_main_path(kern: Kernels):
    """The ``ft_sgemm`` program: verification at 4096 (ids 0-16, weighted
    then rowcol) and the GFLOPS table, with the launch counters read
    around it."""
    from ft_sgemm_tpu_torch import cli

    kern.zero_counts()
    t0 = time.perf_counter()
    for strategy in cli.PORTED_STRATEGIES:
        details = {}
        ok = cli.run_verification(VERIFY_SIZE, 0, 16, strategy=strategy,
                                  details=details)
        if not ok:
            raise AssertionError(f"run_verification failed under {strategy}")
        for kid, d in details.items():
            if d["uncorrectable"] or d["detected"] != d["expected"]:
                raise AssertionError(f"{strategy} id {kid}: {d}")
        log(f"phase verify {strategy}: ids 0-16 pass at {VERIFY_SIZE};"
            f" detected/expected faults "
            + ", ".join(f"{k}:{d['detected']}/{d['expected']}"
                        for k, d in sorted(details.items())))
    table = cli.run_perf_table(*PERF_SIZES, 0, 16,
                               min_device_time=PERF_MINTIME)
    counts = kern.counts()
    log(f"phase main path: {time.perf_counter() - t0:.1f} s, launches {counts}")
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts, table


def work(kind, shape, n, check_every=None, multifault=False):
    """(flops, bytes) that one launch's function needs at M = N = K = n.
    An FMA counts as two flops; each input is read once and each output
    written once. Beyond the product and the alpha/beta epilogue: each
    check's sums over the output (weighted: moments 1, w, w^2 by add, FMA,
    FMA; rowcol: row and column sums, plus the w-weighted column sums in
    multifault mode) and, for the running kernels, the encode of the
    expected checksums — the A- and B-side sums once per row or column
    tile, and the per-tile updates once per tile and K column."""
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
    else:
        # A's and B's plain sums (M*K + N*K); r_exp, c_exp FMAs per tile.
        flops += (2 * mn + tiles * n * 2.0 * (shape.bm + shape.bn)
                  + 2 * mn * checks)
        if multifault:
            flops += 2 * mn + tiles * n * 2.0 * shape.bn + 2 * mn * checks
    return flops, nbytes


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing(kern: Kernels, counts):
    """Each kernel at 4096 on the tile, cadence and multifault setting the
    program gives it (B2, B3 at the huge tile; B5 at the small tile, the
    only one where the weighted strategy runs it): the kernel, its plain
    version, torch.addmm for the same alpha*A@B.T + beta*C, and the bound.
    Also the worst clean checksum residual of the weighted check."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    gen = np.random.default_rng(11)
    huge, small = SHAPES["huge"], SHAPES["small"]
    operands = {s.name: _padded(_random(n, n, n, gen), s) for s in (huge, small)}
    rows = []
    for kind, shape in (("sgemm", huge), ("precomp", huge), ("rowcol", huge),
                        ("running", small)):
        name = KIND_NAMES[kind]
        a, b, c = operands[shape.name]
        inj = InjectionSpec.reference_like(n, shape.bk)
        ce, mf = None, False
        if kind != "sgemm":
            strategy = "rowcol" if kind == "rowcol" else "weighted"
            plan, ce, mf = ft._plan(strategy, None, None, inj, n // shape.bk,
                                    shape.bn)
            if plan != kind:
                raise AssertionError(f"the program runs {plan} at {shape.name},"
                                     f" not {kind}")
        run, plain = kern.calls(kind, shape, a, b, c, _scalars(inj), ce, mf)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(lambda: torch.addmm(
            c, a, b.T, beta=kern.beta, alpha=kern.alpha), reps=5)
        bound_ms, bound_by = _bound(*work(kind, shape, n, ce, mf))
        rows.append({"name": name, "route": "cuda",
                     "source": kern.table[name]["source"],
                     "replaces": kern.table[name]["replaces"],
                     "launches": counts[name],
                     "max_abs_err": kern.max_err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        log(f"phase timing {name} ({shape.name}, {n}, check every {ce},"
            f" multifault {mf}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
            f" torch.addmm {library_ms:.3f} ms, bound {bound_ms:.3f} ms"
            f" ({bound_by})")

    # Worst clean residual of the weighted check at 4096 (C = 0, alpha = 1:
    # the output is the accumulator): f32 column moments of the kernel's
    # accumulator against the torch.matmul expectations.
    a, b, _ = operands["huge"]
    gm = n // huge.bm
    zero = torch.zeros((n, n), device="cuda")
    expm = ft._expected_col_checksums(a, b, huge.bm)
    acc, det, unc = ft.ft_weighted_kernel(a, b, zero, expm, huge, 1.0, 0.0,
                                          _scalars(InjectionSpec.none()))
    t = acc.reshape(gm, huge.bm, n)
    w = torch.arange(1, huge.bm + 1, device="cuda", dtype=torch.float32)[None, :, None]
    worst = [float((expm[:, v] - (t * w ** v).sum(1)).abs().max()) for v in range(3)]
    if int(det.sum()) or int(unc.sum()):
        raise AssertionError("clean weighted run reported faults")
    log(f"phase residual: worst clean weighted residual at {n} (moments 1, w,"
        f" w^2): {worst} against the threshold 9500")
    return rows


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

"""The ``ft_sgemm`` program on the port — argv-compatible with the reference binary.

Reference contract (``kernel/ft_sgemm/sgemm.cu:12-19``, ``README.md:12-17``):

    ./ft_sgemm START_SIZE END_SIZE GAP_SIZE ST_KERNEL END_KERNEL

Two passes, like ``main()`` there and ``ft_sgemm_tpu/cli.py:494-621``:

  1. **Verification** at END_SIZE: every kernel id in [ST_KERNEL, END_KERNEL]
     is checked against the vendor GEMM (cuBLAS through ``torch.matmul``)
     under the ``utils.cu:61`` tolerance. FT kernels run with reference-like
     fault injection ON and must also report ``uncorrectable == 0``; the
     detect-only ``global`` strategy leaves its faults in C by design, so
     its rows must instead detect exactly the injected fault events and
     pass the diff on a clean run (``_verify_global_strategy``).
  2. **Performance**: a GFLOPS table over sizes START..END step GAP, one row
     per kernel id in the 14-row table (``sgemm.cu:235-237``), timed with
     CUDA events (``utils.timing.bench_seconds_per_call``).

Usage:
    python -m ft_sgemm_tpu_torch.cli 1024 6144 512 0 16 \
        [--strategy=weighted|rowcol|global|fused] [--encode=vpu|mxu] \
        [--threshold=static|auto|adaptive|FLOAT] \
        [--dtype=float32|bfloat16|float8_e4m3|int8] \
        [--mintime=SECONDS] [--no-verify] [--no-perf] [--device=cuda|cpu]
    python -m ft_sgemm_tpu_torch.cli roc [--smoke] [--out=ROC.json] \
        [--margin=M] [--device=cuda|cpu]

``--strategy`` picks the checksum design of the FT rows (ids 11-16) and
``--encode`` how their expected checksums are formed: ``vpu`` sums the
staged operand chunks in the kernel, ``mxu`` takes the operands'
precomputed moment rows (``fused`` always does; ``weighted`` with ``mxu``
runs the same kernel). ``--threshold`` picks the FT rows' detection
threshold (``ft_sgemm_tpu/cli.py:2602-2610``): ``static`` (default: the
reference's fixed 9500, or any float), ``auto`` (one threshold per call
from the inputs' moments) or ``adaptive`` (per tile and check, inside the
kernels, from the running moments of the operands). ``--dtype`` takes the
JAX package's spellings and aliases (``ft_sgemm_tpu/cli.py:1141-1148``; an
unknown one exits 2): ``bfloat16`` runs the whole table with A and B
rounded to bf16 (the vendor row as ``torch.matmul`` on bf16 tensors, whose
output is bf16; the hand kernels on bf16 wgmma; the two-pass baseline on
the rounded operands), verified against the f32 product of the rounded
operands. bf16 runs every strategy and encode: weighted, rowcol and
global with ``--encode=vpu`` under every threshold mode (``adaptive`` on
the adaptive bf16 builds of B5, B3 and B4, from the rounded operands'
moments; the verification header then names the mode), and fused,
weighted, rowcol and global with ``--encode=mxu`` (the bf16 builds of
B6-B8, on the wrapper's hi / lo / lo2 moment rows) under every threshold
mode (``adaptive`` on their adaptive bf16 builds). ``float8_e4m3``
(aliases ``fp8``, ``fp8_e4m3``, ``float8_e4m3fn``) runs the fp8 serving
mode (``ft_sgemm_tpu/cli.py:167-169``) the same way: A and B rounded to
e4m3 as the JAX package rounds them (NaN past 464), the whole table on the
fp8 builds (id 0: the library's fp8 GEMM, ``torch._scaled_mm`` with unit
scales and f32 output, then the f32 alpha / beta epilogue), verified
against the f32 product of the rounded operands. ``int8`` runs the
exact mode (``ft_sgemm_tpu/cli.py:167-172``): A and B are scaled to the
integer lattice ±{0..9} (``np.round(x * 10)``, C as generated), the FT
rows (ids 11-16) run rowcol (the default) or global with int32
accumulators and checksums that wrap, under every threshold mode, against
the exact int32 oracle (id 0: ``torch._int_mm`` and the f32 epilogue), and
the rows that accumulate in f32 (ids 1-6 and the baseline, 10) print a
skip line. The other dtypes and combinations raise
``NotImplementedError`` (``configs.check_kernel_legality``). Without
``--strategy`` the dtype's default strategy runs
(``configs.DEFAULT_STRATEGY``). ``--device=cpu`` runs the kernels' plain
PyTorch versions (for tests); the default is the GPU, and the program
raises when there is none.

``roc`` (``ft_sgemm_tpu/cli.py:1328-1389``) runs the static-vs-adaptive
threshold sweep (``injection.roc_sweep``) over every legal (dtype,
strategy, encode) combo: clean false positives and detections of a fault
at every K step at input scales 0.1, 1 and 16, under a threshold
calibrated at scale 1 and under ``threshold="adaptive"``; it prints a
progress line per point and a verdict per combo, ``--out`` writes the JSON
artifact, ``--smoke`` cuts the grid to bf16 and int8 under rowcol and
global, and the exit code is 0 if and only if adaptive Pareto-dominates
static in every combo with no adaptive false positive.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ft_sgemm_tpu_torch import runtime
from ft_sgemm_tpu_torch.configs import (
    DEFAULT_STRATEGY,
    ENCODE_MODES,
    IN_DTYPES,
    KERNEL_TABLE,
    PERF_ROW_IDS,
    STRATEGIES,
    THRESHOLD_MODES,
    canonical_in_dtype,
    check_kernel_legality,
    kernel_for_id,
)
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops.abft_baseline import abft_baseline_sgemm
from ft_sgemm_tpu_torch.ops.common import as_f32, as_operand, resolve_device, resolve_in_dtype
from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.ops.sgemm import make_sgemm
from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix, verify_matrix
from ft_sgemm_tpu_torch.utils.timing import bench_seconds_per_call

ALPHA = 1.0   # sgemm.cu:22
BETA = -1.5   # sgemm.cu:24,234


def _build_ft(kernel_id: int, size: int, strategy: str, encode: str, device,
              threshold="static", in_dtype="float32", precision="highest"):
    """The fused-ABFT kernel + reference-like injection for one kernel id,
    the injection cadence following the tile the kernel runs."""
    _, shape, _ = kernel_for_id(kernel_id)
    ft = make_ft_sgemm(shape.name, alpha=ALPHA, beta=BETA, strategy=strategy,
                       encode=encode, threshold=threshold, in_dtype=in_dtype,
                       precision=precision, device=device)
    return ft, InjectionSpec.reference_like(size, ft.shape_config.bk)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A @ B.T`` of fp8 A (M, K) and B (N, K) in f32 by the library's fp8
    GEMM, ``torch._scaled_mm`` (cuBLASLt) with unit scales and B passed
    column-major; its shapes (multiples of 16) reached by zero padding,
    which the product ignores."""
    (m, k), n = a.shape, b.shape[0]
    pad = [(-x) % 16 for x in (m, n, k)]
    ap = torch.nn.functional.pad(a.view(torch.uint8), (0, pad[2], 0, pad[0]))
    bp = torch.nn.functional.pad(b.view(torch.uint8), (0, pad[2], 0, pad[1]))
    one = torch.ones((), device=a.device)
    return torch._scaled_mm(ap.view(a.dtype), bp.view(b.dtype).T, one, one,
                            out_dtype=torch.float32)[:m, :n]


def _vendor(device, in_dtype="float32"):
    """Id 0, the vendor GEMM: in f32 and int8 the oracle itself (cuBLAS
    through ``torch.matmul``, TF32 off; in int8 ``torch._int_mm`` exact in
    int32); in bf16 ``torch.matmul`` on the rounded bf16 operands, whose
    output is bf16 (the library's bf16 GEMM, the yardstick of speed), in
    fp8 ``torch._scaled_mm`` on the rounded e4m3 operands with f32 output
    (:func:`fp8_matmul`; on the CPU the oracle), then the f32 alpha / beta
    epilogue."""
    dtype = resolve_in_dtype(in_dtype, allow_low_precision=True)
    dev = resolve_device(device)
    if dtype in (torch.float32, torch.int8) or (
            dtype == torch.float8_e4m3fn and dev.type == "cpu"):
        return lambda a, b, c: sgemm_reference(a, b, c, ALPHA, BETA,
                                               in_dtype=in_dtype,
                                               device=device)
    matmul = fp8_matmul if dtype == torch.float8_e4m3fn else (
        lambda a, b: torch.matmul(a, b.T).float())

    def fn(a, b, c):
        a, b = (as_operand(x, dtype, dev) for x in (a, b))
        return ALPHA * matmul(a, b) + BETA * as_f32(c, dev)
    return fn


def _build_callable(kernel_id: int, size: int, inject_ft: bool,
                    strategy: str, encode: str, device, threshold="static",
                    in_dtype="float32", precision="highest"):
    """Return fn(a, b, c) -> (M, N) tensor for one kernel id (``precision``:
    that of ids 1-16; id 0, the oracle's GEMM, stays FP32)."""
    _, shape, is_abft = kernel_for_id(kernel_id)
    if kernel_id == 0:
        return _vendor(device, in_dtype)
    if kernel_id == 10:
        return lambda a, b, c: abft_baseline_sgemm(
            a, b, c, ALPHA, BETA, precision=precision, in_dtype=in_dtype,
            device=device).c
    if not is_abft:
        return make_sgemm(shape.name, alpha=ALPHA, beta=BETA,
                          precision=precision, in_dtype=in_dtype,
                          device=device)
    ft, inj = _build_ft(kernel_id, size, strategy, encode, device, threshold,
                        in_dtype, precision)
    if not inject_ft:
        inj = InjectionSpec.none()
    return lambda a, b, c: ft(a, b, c, inj).c


def _int8_capable(kernel_id: int) -> bool:
    """Whether a kernel id runs in the int8 mode (ft_sgemm_tpu/cli.py:
    386-391): the oracle row and the FT rows, whose kernels carry the exact
    int32 path; the plain rows and the two-pass baseline accumulate in f32
    and are skipped."""
    _, _, is_abft = kernel_for_id(kernel_id)
    return kernel_id == 0 or (is_abft and kernel_id != 10)


def quantize_for_dtype(x: np.ndarray, in_dtype) -> np.ndarray:
    """The int8 mode's inputs (ft_sgemm_tpu/cli.py:435-443): the generator's
    ±{0, .1, .., .9} scaled to the integer lattice ±{0..9} (the int8 cast
    truncates fractions, so the unscaled values would all be 0); other
    dtypes pass through."""
    if canonical_in_dtype(in_dtype) == "int8":
        return np.round(x * 10.0).astype(np.float32)
    return x


def print_device_info(device, out=None) -> None:
    """Hardware line before any results (the reference's ``getDetails``,
    ``utils/utils.cu:8-13``)."""
    out = sys.stdout if out is None else out
    dev = torch.device(device)
    if dev.type == "cuda":
        print(f"Device: cuda | {torch.cuda.get_device_name(dev)}"
              f" x{torch.cuda.device_count()} | torch {torch.__version__}"
              f" | cuda {torch.version.cuda}", file=out)
    else:
        print(f"Device: cpu | torch {torch.__version__}", file=out)


@functools.lru_cache(maxsize=1)
def _host_inputs(size: int, in_dtype: str = "float32"):
    """Host A/B/C for one sweep size, generated once per size (the sweep is
    size-major); A and B on the int8 lattice in the int8 mode."""
    rng = np.random.default_rng(10)
    a, b, c = (generate_random_matrix(size, size, rng=rng) for _ in range(3))
    return quantize_for_dtype(a, in_dtype), quantize_for_dtype(b, in_dtype), c


def _verify_global_strategy(kernel_id: int, end_size: int, a, b, c, want,
                            encode: str, device, threshold="static",
                            in_dtype="float32", precision="highest"):
    """Verification gate of the detect-only ``global`` strategy (the JAX
    package's cli.py:462-491): the output keeps the injected corruption by
    design, so the row passes when (a) the injected run detects exactly
    ``tiles * expected_faults`` fault events and (b) a clean run passes the
    diff against the oracle. Returns (ok, status, injected result, expected
    events)."""
    ft, inj = _build_ft(kernel_id, end_size, "global", encode, device,
                        threshold, in_dtype, precision)
    shape = ft.shape_config
    res = ft(a, b, c, inj)
    tiles = -(-end_size // shape.bm) * -(-end_size // shape.bn)
    expected = tiles * inj.expected_faults(end_size, shape.bk)
    events = int(res.num_detected)
    ok_clean, nbad, first = verify_matrix(want, ft(a, b, c).c, verbose=False)
    parts = []
    if events != expected:
        parts.append(f"detected {events}, expected {expected}")
    if not ok_clean:
        parts.append(f"clean run: {nbad} bad, first at {first}")
    status = ("FAIL (" + "; ".join(parts) + ")" if parts else
              f"pass (detected {events}/{expected}, clean diff ok)")
    return not parts, status, res, expected


def run_verification(end_size: int, st_kernel: int, end_kernel: int,
                     out=None, strategy: str = "weighted", device=None,
                     details: dict | None = None,
                     encode: str = "vpu", threshold="static",
                     in_dtype="float32", precision="highest") -> bool:
    """Pass 1: diff every selected kernel against the ``torch.matmul``
    oracle (in bf16: the f32 product of the bf16-rounded inputs; in int8:
    the exact int32 product of the inputs scaled to the integer lattice;
    after a header line naming the dtype; in int8 the ids that accumulate
    in f32 print a skip line). A and B are the reference binary's
    post-``srand(10)`` buffers (``runtime.generate_reference_driver_inputs``);
    C starts zeroed. The FT rows run under ``threshold`` (a float or a mode
    of ``configs.THRESHOLD_MODES``), ids 1-16 at ``precision`` (f32
    ``"default"``: one TF32 pass, held to the same FP32 oracle and
    tolerance).

    ``details``, when given, receives per FT id the detected, expected and
    uncorrectable fault counts of the injected run, whether the row passed
    and (correcting strategies) the injected run's largest |C - oracle|. Under the detect-only ``global`` strategy ``detected`` counts
    fault events and ``uncorrectable`` equals ``detected`` (nothing is
    corrected).
    """
    out = sys.stdout if out is None else out
    dev = resolve_device(device)
    a, b = (quantize_for_dtype(x, in_dtype)
            for x in runtime.generate_reference_driver_inputs(end_size))
    c = np.zeros((end_size, end_size), np.float32)  # fill_vector(C,0)
    a, b, c = (as_f32(x, dev) for x in (a, b, c))
    want = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype=in_dtype,
                           device=dev)
    dtype = canonical_in_dtype(in_dtype)
    if dtype == "int8":
        print("Verification in int8: A and B on the integer lattice"
              " ±{0..9}, against their exact int32 product", file=out)
    elif dtype != "float32":
        mode = " (threshold adaptive)" if threshold == "adaptive" else ""
        print(f"Verification in {dtype}{mode}: A and B rounded to {dtype},"
              f" against the f32 product of the rounded inputs", file=out)
    elif precision == "default":
        print("Verification at precision default: the products of ids 1-16"
              " in one TF32 pass, against the FP32 product", file=out)
    all_ok = True
    for kernel_id in sorted(KERNEL_TABLE):
        if kernel_id < st_kernel or kernel_id > end_kernel:
            continue
        name, shape, is_abft = kernel_for_id(kernel_id)
        if dtype == "int8" and not _int8_capable(kernel_id):
            print(f"Verification of kernel {kernel_id:2d} ({name:20s}): "
                  "skipped (int8 runs the FT rows' int32-exact kernels"
                  " only)", file=out)
            continue
        if is_abft and kernel_id != 10 and strategy == "global":
            ok, status, res, expected = _verify_global_strategy(
                kernel_id, end_size, a, b, c, want, encode, dev, threshold,
                in_dtype, precision)
            if details is not None:
                details[kernel_id] = {
                    "detected": int(res.num_detected), "expected": expected,
                    "uncorrectable": int(res.num_uncorrectable), "passed": ok}
        elif is_abft and kernel_id != 10:
            # Correcting FT rows: diff gate PLUS the residual-after-correct
            # re-check.
            ft, inj = _build_ft(kernel_id, end_size, strategy, encode, dev,
                                threshold, in_dtype, precision)
            res = ft(a, b, c, inj)
            ok, nbad, first = verify_matrix(want, res.c, verbose=False)
            unc = int(res.num_uncorrectable)
            parts = []
            if not ok:
                parts.append(f"{nbad} bad, first at {first}")
            if unc:
                parts.append(f"{unc} uncorrectable intervals reported")
            ok = ok and unc == 0
            status = "pass" if ok else "FAIL (" + "; ".join(parts) + ")"
            if details is not None:
                tiles = -(-end_size // shape.bm) * -(-end_size // shape.bn)
                details[kernel_id] = {
                    "detected": int(res.num_detected),
                    "expected": tiles * inj.expected_faults(end_size, shape.bk),
                    "uncorrectable": unc, "passed": ok,
                    "max_abs_err": float((res.c - want).abs().max())}
        else:
            fn = _build_callable(kernel_id, end_size, True, strategy, encode,
                                 dev, in_dtype=in_dtype, precision=precision)
            ok, nbad, first = verify_matrix(want, fn(a, b, c), verbose=False)
            status = "pass" if ok else f"FAIL ({nbad} bad, first at {first})"
        all_ok &= ok
        print(f"Verification of kernel {kernel_id:2d} ({name:20s}): {status}",
              file=out)
    return all_ok


def run_perf_table(start_size: int, end_size: int, gap_size: int,
                   st_kernel: int, end_kernel: int,
                   min_device_time: float = 1.0, out=None,
                   strategy: str = "weighted", device=None,
                   encode: str = "vpu", threshold="static",
                   in_dtype="float32") -> dict:
    """Pass 2: the GFLOPS table (format parity with sgemm.cu:240-439),
    measured size-major, printed row-major, its header naming a dtype other
    than float32; per-cell progress on stderr (in int8 also the rows it
    skips)."""
    out = sys.stdout if out is None else out
    dev = resolve_device(device)
    sizes = list(range(start_size, end_size + 1, gap_size))
    row_ids = [kid for kid in PERF_ROW_IDS if st_kernel <= kid <= end_kernel]
    dtype = canonical_in_dtype(in_dtype)
    if dtype == "int8":
        skipped = [kid for kid in row_ids if not _int8_capable(kid)]
        if skipped:
            print(f"ft_sgemm: int8 mode skips rows {skipped} (plain/"
                  "baseline kernels accumulate f32; the FT rows carry the"
                  " int32-exact path)", file=sys.stderr, flush=True)
        row_ids = [kid for kid in row_ids if _int8_capable(kid)]
    cells = {}
    for size in sizes:
        print(f"ft_sgemm: measuring size {size} "
              f"({len(row_ids)} kernel rows)...", file=sys.stderr, flush=True)
        a, b, c = (as_f32(x, dev) for x in _host_inputs(size, dtype))
        for kernel_id in row_ids:
            fn = _build_callable(kernel_id, size, True, strategy, encode, dev,
                                 threshold, in_dtype)
            sec_per_rep = bench_seconds_per_call(
                fn, a, b, c, min_device_time=min_device_time)
            gf = 2.0 * size**3 / 1e9 / sec_per_rep
            cells[(kernel_id, size)] = gf
            name, _, _ = kernel_for_id(kernel_id)
            print(f"ft_sgemm: {name} @ {size}: {gf:8.0f} GFLOPS",
                  file=sys.stderr, flush=True)

    print("################## Performance (GFLOPS) ########################"
          if dtype == "float32" else
          f"################## Performance (GFLOPS, {dtype}) ##############",
          file=out)
    print("Matrix Size         |" + "".join(f"{s:8d}|" for s in sizes),
          file=out)
    results = {}
    for kernel_id in row_ids:
        name, _, _ = kernel_for_id(kernel_id)
        print(f"{name:<20s}|"
              + "".join(f"{cells[(kernel_id, s)]:8.0f}|" for s in sizes),
              file=out, flush=True)
        results[name] = {s: cells[(kernel_id, s)] for s in sizes}
    return results


def run_roc(flags, out=None) -> int:
    """The ``roc`` subcommand (``ft_sgemm_tpu/cli.py:1328``): the ROC sweep
    with a progress line per point, the verdict table and, with
    ``--out=PATH``, the JSON artifact. Exit 0 if and only if adaptive
    Pareto-dominates static in every combo and made no false positive; 2
    for an unknown flag."""
    import json

    from ft_sgemm_tpu_torch.injection import roc_sweep

    out = sys.stdout if out is None else out
    kwargs = {}
    out_path = None
    device = None
    for f in flags:
        if f.startswith("--out="):
            out_path = f.split("=", 1)[1]
        elif f.startswith("--margin="):
            kwargs["margin"] = float(f.split("=", 1)[1])
        elif f.startswith("--device="):
            device = f.split("=", 1)[1]
        elif f == "--smoke":
            kwargs.update(dtypes=("bfloat16", "int8"),
                          strategies=("rowcol", "global"))
        else:
            print(f"ft_sgemm roc: unknown flag {f}", file=sys.stderr)
            return 2
    dev = resolve_device(device)
    print_device_info(dev, out)

    def progress(p):
        print(f"  {p.dtype:>14s}/{p.strategy}/{p.encode} {p.mode:>8s} "
              f"scale={p.scale:<6g} clean_det={p.clean_detections:<4d} "
              f"det={p.detected}/{p.expected_faults}", file=out, flush=True)

    artifact = roc_sweep(progress=progress, device=dev, **kwargs)
    s = artifact["summary"]
    print("\nROC summary (aggregate over scales "
          f"{artifact['config']['scales']}):", file=out)
    for key, v in s["combos"].items():
        a, st = v["adaptive"], v["static"]
        verdict = ("STRICT" if v["strict"]
                   else "dominates" if v["dominates"] else "DOMINATED")
        print(f"  {key:<34s} static fp={st['fp_rate']:.3f}"
              f" det={st['detection_rate']:.3f} | adaptive"
              f" fp={a['fp_rate']:.3f} det={a['detection_rate']:.3f}"
              f"  [{verdict}]", file=out)
    print(f"adaptive false positives: {s['adaptive_false_positives']}",
          file=out)
    print(f"all combos dominated by adaptive: {s['all_dominate']}", file=out)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(artifact, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"roc artifact written to {out_path}", file=out)
    ok = s["all_dominate"] and s["adaptive_false_positives"] == 0
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    args = [a for a in argv[1:] if not a.startswith("--")]
    flags = [a for a in argv[1:] if a.startswith("--")]
    if args and args[0] == "roc":
        return run_roc(flags)
    if len(args) < 5:
        print(__doc__)
        return 2
    try:
        start_size, end_size, gap_size, st_kernel, end_kernel = map(int, args[:5])
    except ValueError:
        print(f"ft_sgemm: arguments must be integers, got {args[:5]}",
              file=sys.stderr)
        return 2
    min_device_time = 1.0
    strategy = None  # the dtype's default, after the flags
    encode = "vpu"
    threshold = "static"
    in_dtype = "float32"
    device = None
    for f in flags:
        if f.startswith("--mintime="):
            min_device_time = float(f.split("=", 1)[1])
        elif f.startswith("--strategy="):
            strategy = f.split("=", 1)[1]
            if strategy not in STRATEGIES:
                print(f"--strategy must be one of {STRATEGIES}, got"
                      f" {strategy!r}", file=sys.stderr)
                return 2
        elif f.startswith("--encode="):
            encode = f.split("=", 1)[1]
            if encode not in ENCODE_MODES:
                print(f"--encode must be one of {ENCODE_MODES}, got"
                      f" {encode!r}", file=sys.stderr)
                return 2
        elif f.startswith("--threshold="):
            threshold = f.split("=", 1)[1]
            if threshold not in THRESHOLD_MODES:
                try:
                    threshold = float(threshold)
                except ValueError:
                    print(f"--threshold must be one of {THRESHOLD_MODES} or"
                          f" a float, got {threshold!r}", file=sys.stderr)
                    return 2
        elif f.startswith("--dtype="):
            in_dtype = f.split("=", 1)[1]
            try:
                in_dtype = canonical_in_dtype(in_dtype)
            except ValueError:
                print(f"--dtype must be one of {IN_DTYPES} (or an fp8"
                      f" alias), got {in_dtype!r}", file=sys.stderr)
                return 2
        elif f.startswith("--device="):
            device = f.split("=", 1)[1]
        elif f not in ("--no-verify", "--no-perf"):
            print(f"ft_sgemm: unknown flag {f}", file=sys.stderr)
            return 2
    if strategy is None:
        strategy = DEFAULT_STRATEGY[in_dtype]
        if in_dtype == "int8":
            print(f"--dtype=int8: defaulting --strategy={strategy}"
                  " (weighted-ratio localization is illegal for int8)",
                  file=sys.stderr)
    # What the port does not run yet raises here, before any work.
    check_kernel_legality(
        strategy=strategy, encode=encode, in_dtype=in_dtype,
        threshold_mode=threshold if isinstance(threshold, str) else "static")
    dev = resolve_device(device)
    print_device_info(dev)
    ok = True
    if "--no-verify" not in flags:
        ok = run_verification(end_size, st_kernel, end_kernel,
                              strategy=strategy, device=dev, encode=encode,
                              threshold=threshold, in_dtype=in_dtype)
    if "--no-perf" not in flags:
        run_perf_table(start_size, end_size, gap_size, st_kernel, end_kernel,
                       min_device_time=min_device_time, strategy=strategy,
                       device=dev, encode=encode, threshold=threshold,
                       in_dtype=in_dtype)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

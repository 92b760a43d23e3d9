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
        [--mintime=SECONDS] [--no-verify] [--no-perf] [--device=cuda|cpu]

``--strategy`` picks the checksum design of the FT rows (ids 11-16) and
``--encode`` how their expected checksums are formed: ``vpu`` sums the
staged operand chunks in the kernel, ``mxu`` takes the operands'
precomputed moment rows (``fused`` always does; ``weighted`` with ``mxu``
runs the same kernel). ``--threshold`` picks the FT rows' detection
threshold (``ft_sgemm_tpu/cli.py:2602-2610``): ``static`` (default: the
reference's fixed 9500, or any float), ``auto`` (one threshold per call
from the inputs' moments) or ``adaptive`` (per tile and check, inside the
kernels, from the running moments of the operands). ``--device=cpu`` runs
the kernels' plain PyTorch versions (for tests); the default is the GPU,
and the program raises when there is none.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ft_sgemm_tpu_torch import runtime
from ft_sgemm_tpu_torch.configs import (
    ENCODE_MODES,
    KERNEL_TABLE,
    PERF_ROW_IDS,
    STRATEGIES,
    THRESHOLD_MODES,
    kernel_for_id,
)
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops.abft_baseline import abft_baseline_sgemm
from ft_sgemm_tpu_torch.ops.common import as_f32, resolve_device
from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.ops.sgemm import make_sgemm
from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix, verify_matrix
from ft_sgemm_tpu_torch.utils.timing import bench_seconds_per_call

ALPHA = 1.0   # sgemm.cu:22
BETA = -1.5   # sgemm.cu:24,234


def _build_ft(kernel_id: int, size: int, strategy: str, encode: str, device,
              threshold="static"):
    """The fused-ABFT kernel + reference-like injection for one kernel id,
    the injection cadence following the tile the kernel runs."""
    _, shape, _ = kernel_for_id(kernel_id)
    ft = make_ft_sgemm(shape.name, alpha=ALPHA, beta=BETA, strategy=strategy,
                       encode=encode, threshold=threshold, device=device)
    return ft, InjectionSpec.reference_like(size, ft.shape_config.bk)


def _build_callable(kernel_id: int, size: int, inject_ft: bool,
                    strategy: str, encode: str, device, threshold="static"):
    """Return fn(a, b, c) -> (M, N) tensor for one kernel id."""
    _, shape, is_abft = kernel_for_id(kernel_id)
    if kernel_id == 0:
        return lambda a, b, c: sgemm_reference(a, b, c, ALPHA, BETA,
                                               device=device)
    if kernel_id == 10:
        return lambda a, b, c: abft_baseline_sgemm(a, b, c, ALPHA, BETA,
                                                   device=device).c
    if not is_abft:
        return make_sgemm(shape.name, alpha=ALPHA, beta=BETA, device=device)
    ft, inj = _build_ft(kernel_id, size, strategy, encode, device, threshold)
    if not inject_ft:
        inj = InjectionSpec.none()
    return lambda a, b, c: ft(a, b, c, inj).c


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
def _host_inputs(size: int):
    """Host A/B/C for one sweep size, generated once per size (the sweep is
    size-major)."""
    rng = np.random.default_rng(10)
    return tuple(generate_random_matrix(size, size, rng=rng) for _ in range(3))


def _verify_global_strategy(kernel_id: int, end_size: int, a, b, c, want,
                            encode: str, device, threshold="static"):
    """Verification gate of the detect-only ``global`` strategy (the JAX
    package's cli.py:462-491): the output keeps the injected corruption by
    design, so the row passes when (a) the injected run detects exactly
    ``tiles * expected_faults`` fault events and (b) a clean run passes the
    diff against the oracle. Returns (ok, status, injected result, expected
    events)."""
    ft, inj = _build_ft(kernel_id, end_size, "global", encode, device,
                        threshold)
    shape = ft.shape_config
    res = ft(a, b, c, inj)
    tiles = -(-end_size // shape.bm) * -(-end_size // shape.bn)
    expected = tiles * inj.expected_faults(end_size, shape.bk)
    events = int(res.num_detected)
    ok_clean, nbad, first = verify_matrix(want, ft(a, b, c).c.cpu().numpy(),
                                          verbose=False)
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
                     encode: str = "vpu", threshold="static") -> bool:
    """Pass 1: diff every selected kernel against the ``torch.matmul``
    oracle. A and B are the reference binary's post-``srand(10)`` buffers
    (``runtime.generate_reference_driver_inputs``); C starts zeroed. The FT
    rows run under ``threshold`` (a float or a mode of
    ``configs.THRESHOLD_MODES``).

    ``details``, when given, receives per FT id the detected, expected and
    uncorrectable fault counts of the injected run and whether the row
    passed. Under the detect-only ``global`` strategy ``detected`` counts
    fault events and ``uncorrectable`` equals ``detected`` (nothing is
    corrected).
    """
    out = sys.stdout if out is None else out
    dev = resolve_device(device)
    a, b = runtime.generate_reference_driver_inputs(end_size)
    c = np.zeros((end_size, end_size), np.float32)  # fill_vector(C,0)
    a, b, c = (as_f32(x, dev) for x in (a, b, c))
    want = sgemm_reference(a, b, c, ALPHA, BETA, device=dev).cpu().numpy()
    all_ok = True
    for kernel_id in sorted(KERNEL_TABLE):
        if kernel_id < st_kernel or kernel_id > end_kernel:
            continue
        name, shape, is_abft = kernel_for_id(kernel_id)
        if is_abft and kernel_id != 10 and strategy == "global":
            ok, status, res, expected = _verify_global_strategy(
                kernel_id, end_size, a, b, c, want, encode, dev, threshold)
            if details is not None:
                details[kernel_id] = {
                    "detected": int(res.num_detected), "expected": expected,
                    "uncorrectable": int(res.num_uncorrectable), "passed": ok}
        elif is_abft and kernel_id != 10:
            # Correcting FT rows: diff gate PLUS the residual-after-correct
            # re-check.
            ft, inj = _build_ft(kernel_id, end_size, strategy, encode, dev,
                                threshold)
            res = ft(a, b, c, inj)
            ok, nbad, first = verify_matrix(want, res.c.cpu().numpy(),
                                            verbose=False)
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
                    "uncorrectable": unc, "passed": ok}
        else:
            fn = _build_callable(kernel_id, end_size, True, strategy, encode,
                                 dev)
            got = fn(a, b, c).cpu().numpy()
            ok, nbad, first = verify_matrix(want, got, verbose=False)
            status = "pass" if ok else f"FAIL ({nbad} bad, first at {first})"
        all_ok &= ok
        print(f"Verification of kernel {kernel_id:2d} ({name:20s}): {status}",
              file=out)
    return all_ok


def run_perf_table(start_size: int, end_size: int, gap_size: int,
                   st_kernel: int, end_kernel: int,
                   min_device_time: float = 1.0, out=None,
                   strategy: str = "weighted", device=None,
                   encode: str = "vpu", threshold="static") -> dict:
    """Pass 2: the GFLOPS table (format parity with sgemm.cu:240-439),
    measured size-major, printed row-major; per-cell progress on stderr."""
    out = sys.stdout if out is None else out
    dev = resolve_device(device)
    sizes = list(range(start_size, end_size + 1, gap_size))
    row_ids = [kid for kid in PERF_ROW_IDS if st_kernel <= kid <= end_kernel]
    cells = {}
    for size in sizes:
        print(f"ft_sgemm: measuring size {size} "
              f"({len(row_ids)} kernel rows)...", file=sys.stderr, flush=True)
        a, b, c = (as_f32(x, dev) for x in _host_inputs(size))
        for kernel_id in row_ids:
            fn = _build_callable(kernel_id, size, True, strategy, encode, dev,
                                 threshold)
            sec_per_rep = bench_seconds_per_call(
                fn, a, b, c, min_device_time=min_device_time)
            gf = 2.0 * size**3 / 1e9 / sec_per_rep
            cells[(kernel_id, size)] = gf
            name, _, _ = kernel_for_id(kernel_id)
            print(f"ft_sgemm: {name} @ {size}: {gf:8.0f} GFLOPS",
                  file=sys.stderr, flush=True)

    print("################## Performance (GFLOPS) ########################",
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


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    args = [a for a in argv[1:] if not a.startswith("--")]
    flags = [a for a in argv[1:] if a.startswith("--")]
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
    strategy = "weighted"
    encode = "vpu"
    threshold = "static"
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
        elif f.startswith("--device="):
            device = f.split("=", 1)[1]
        elif f not in ("--no-verify", "--no-perf"):
            print(f"ft_sgemm: unknown flag {f}", file=sys.stderr)
            return 2
    dev = resolve_device(device)
    print_device_info(dev)
    ok = True
    if "--no-verify" not in flags:
        ok = run_verification(end_size, st_kernel, end_kernel,
                              strategy=strategy, device=dev, encode=encode,
                              threshold=threshold)
    if "--no-perf" not in flags:
        run_perf_table(start_size, end_size, gap_size, st_kernel, end_kernel,
                       min_device_time=min_device_time, strategy=strategy,
                       device=dev, encode=encode, threshold=threshold)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

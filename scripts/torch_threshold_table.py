"""The ``ft_sgemm`` program's GFLOPS table of ids 11-16 under each threshold
mode and (strategy, encode) pair, on the card, in one process.

Runs ``cli.run_perf_table`` (reference-like injection, the table's inputs,
CUDA events) at one size for every pair of the program under ``static``,
``auto`` and ``adaptive``, and prints one line per pair and mode: GFLOPS
and milliseconds per call of ids 11-16. Needs a CUDA device (and nvcc for
the port's kernels):

    python3 scripts/torch_threshold_table.py [SIZE] [--mintime=SECONDS]   # default 4096, 0.1
"""

from __future__ import annotations

import io
import pathlib
import subprocess
import sys

PAIRS = (("weighted", "vpu"), ("rowcol", "vpu"), ("global", "vpu"),
         ("fused", "mxu"), ("rowcol", "mxu"), ("global", "mxu"))
MODES = ("static", "auto", "adaptive")


def main(argv) -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from ft_sgemm_tpu_torch import cli

    args = [a for a in argv[1:] if not a.startswith("--mintime=")]
    mintime = next((float(a.split("=", 1)[1]) for a in argv[1:]
                    if a.startswith("--mintime=")), 0.1)
    size = int(args[0]) if args else 4096
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for strategy, encode in PAIRS:
        for mode in MODES:
            rows = cli.run_perf_table(size, size, 1, 11, 16,
                                      min_device_time=mintime,
                                      out=io.StringIO(), strategy=strategy,
                                      encode=encode, threshold=mode)
            cells = ", ".join(
                f"{name.removeprefix('abft_kernel_')} {gf[size]:.0f}"
                f" ({2.0 * size ** 3 / gf[size] / 1e6:.3f} ms)"
                for name, gf in rows.items())
            print(f"{strategy}/{encode} {mode} at {size}: {cells}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

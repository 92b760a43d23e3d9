"""How far e4m3 wgmma's sums fall from f32's, and what that leaves in a
checksum, on an H100.

B1's fp8 build (one e4m3 wgmma per 32-deep k step, its sum promoted into
f32 after every k step), cuBLASLt's fp8 GEMM (``torch._scaled_mm``, unit
scales, f32 out; its error is that of e4m3 wgmma promoted once per
128-column stage) and B2 in fp8, which multiplies the same e4m3 operands,
widened exactly to bf16 by its wrapper, on its bf16 build (clean, C = 0:
its output is its accumulator), at 4096 on
the program's verification data (libc-rand tenths, rounded to e4m3) and on
data spread over e4m3's range (uniform in ±448, rounded). For each, against
the float64 product of the rounded operands: the largest error over max
|C|, the time, and the largest checksum residual that C's errors alone
leave, over the threshold that ``threshold="auto"`` sets for those
operands: in a column band of bm rows (the weighted and rowcol checks'
column sums; bm = 16, 32, 64, 128) and in a row band of bn columns
(rowcol's row sums; bn = 16, 32, 128). A correction writes such a residual
into the element it corrects. Needs nvcc and a CUDA device:

    python3 scripts/torch_fp8_accumulation.py
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N = 4096


def main() -> int:
    from ft_sgemm_tpu_torch import runtime
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
    from ft_sgemm_tpu_torch.ops import sgemm as sg
    from ft_sgemm_tpu_torch.ops.common import (
        DEFAULT_THRESHOLD_MARGIN, align_rows16, as_operand,
        estimate_noise_floor, scalar_operand)
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    huge = SHAPES["huge"]
    dev = torch.device("cuda")
    gen = np.random.default_rng(53)
    a0, b0 = runtime.generate_reference_driver_inputs(N)
    data = {"program": (a0, b0),
            "±448": tuple(gen.uniform(-448.0, 448.0, (N, N))
                          .astype(np.float32) for _ in range(2))}
    for label, host in data.items():
        a, b = (align_rows16(as_operand(x, torch.float8_e4m3fn, dev))
                for x in host)
        c = torch.zeros((N, N), device=dev)
        thr = DEFAULT_THRESHOLD_MARGIN * float(
            estimate_noise_floor(a, b, None, 1.0, 0.0))
        exact = a.double() @ b.double().T
        one = torch.ones((), device=dev)
        expm = ft.kernel_inputs("precomp", a, b, huge)[0]
        clean = scalar_operand(InjectionSpec.none(), (9500.0,) * 3)

        runs = {
            "B1, e4m3 wgmma promoted every k step":
                lambda: sg.sgemm_kernel(a, b, c, huge, 1.0, 0.0),
            "torch._scaled_mm": lambda: torch._scaled_mm(
                a, b.T, one, one, out_dtype=torch.float32),
            "B2, bf16 wgmma of the widened e4m3":
                lambda: ft.run_kernel("precomp", huge, a, b, c, (expm,), 1.0,
                                      0.0, clean, N // huge.bk)[0],
        }
        print(f"{label} data at {N}: auto threshold {thr:.4g}")
        for name, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            err = out.double() - exact
            rel = float(err.abs().max() / exact.abs().max())
            col = max(float(err.reshape(N // bm, bm, N).sum(1).abs().max())
                      for bm in (16, 32, 64, 128)) / thr
            row = max(float(err.reshape(N, N // bn, bn).sum(-1).abs().max())
                      for bn in (16, 32, 128)) / thr
            ms = cuda_ms(run, reps=5)
            print(f"  {name}: max |C - C_f64| / max |C| {rel:.3g}; largest"
                  f" column-band residual / threshold {col:.3g}, row-band"
                  f" {row:.3g}; {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

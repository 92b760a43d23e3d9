"""Where the device time of one ft_sgemm call goes, per kernel id, on the card.

Builds the ``ft_sgemm`` program's callable for each kernel id (as the GFLOPS
table does: reference-like injection, weighted strategy, encode vpu) at
M = N = K = SIZE on the table's inputs (``cli._host_inputs``), times a
loop of calls with CUDA events, and traces the same loop with
``torch.profiler``. Prints, per id, the milliseconds per call, each device
kernel's milliseconds per call (the port's kernel and the wrapper's torch
ops: padding, the expected moments, allocation fills), their sum, and the
share of the call in which the card ran nothing. Needs a CUDA device (and
nvcc for the port's kernels):

    python3 scripts/torch_call_profile.py [SIZE] [ID ...]   # default 4096, 6 16
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

REPS = 20


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(kernel_id: int, size: int) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ft_sgemm_tpu_torch import cli
    from ft_sgemm_tpu_torch.configs import kernel_for_id
    from ft_sgemm_tpu_torch.ops.common import as_f32

    a, b, c = (as_f32(x, "cuda") for x in cli._host_inputs(size))
    fn = cli._build_callable(kernel_id, size, True, "weighted", "vpu", "cuda")
    for _ in range(3):
        fn(a, b, c)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn(a, b, c)
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / REPS
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn(a, b, c)
        torch.cuda.synchronize()
    # Device kernels only: the aten ops that launched them carry the same
    # device time again.
    kernels = sorted(((_device_us(e) / 1e3 / REPS, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and _device_us(e) > 0),
                     reverse=True)
    name, _, _ = kernel_for_id(kernel_id)
    busy = sum(ms for ms, _ in kernels)
    print(f"id {kernel_id} ({name}) at {size}: {call_ms:.4f} ms per call"
          f" (CUDA events); traced device time {busy:.4f} ms per call,"
          f" idle share {max(0.0, 1 - busy / call_ms):.3f}", flush=True)
    if not kernels:
        print("  the trace holds no device time", flush=True)
    for ms, key in kernels:
        print(f"  {ms:9.4f} ms  {key[:110]}", flush=True)


def main(argv) -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    size = int(argv[1]) if len(argv) > 1 else 4096
    ids = [int(x) for x in argv[2:]] or [6, 16]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for kid in ids:
        profile(kid, size)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

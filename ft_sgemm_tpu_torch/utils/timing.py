"""Timing helpers (reference: cudaEvent timing ``sgemm.cu:253-265``; the
port's ``ft_sgemm_tpu/utils/timing.py:125-201``).

On the card, CUDA events bracket a loop of calls on the current stream, so
the time is the device's; on the CPU, ``time.perf_counter``. The rep count
grows until the loop takes ``min_device_time``, as in the JAX package, and
the best of three loops at that count is kept.
"""

from __future__ import annotations

import time

import torch

NUM_TESTS = 5  # reference num_tests, sgemm.cu:21


def _event_seconds(call, reps: int) -> float:
    """Device seconds of ``reps`` calls of ``call()``, CUDA events around
    the loop on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def cuda_ms(call, reps: int = 1) -> float:
    """Device milliseconds per call of ``call()``: one warmup call, then
    ``reps`` calls between CUDA events."""
    call()
    return _event_seconds(call, reps) * 1e3 / reps


def _loop_seconds(fn, args, reps: int) -> float:
    if args[0].is_cuda:
        return _event_seconds(lambda: fn(*args), reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return time.perf_counter() - t0


def bench_seconds_per_call(fn, a, b, c, *, min_device_time: float = 1.0,
                           max_reps: int = 1 << 16) -> float:
    """Seconds per call of ``fn(a, b, c)`` on the operands' device.

    One warmup call, then ``NUM_TESTS`` reps, growing (at most 8x per
    round) until one loop lasts ``min_device_time``; returns the best of
    three loops at the final count, divided by the count.
    """
    args = (a, b, c)
    _loop_seconds(fn, args, 1)
    reps = NUM_TESTS
    t = _loop_seconds(fn, args, reps)
    while t < min_device_time and reps < max_reps:
        scale = min_device_time / max(t, 1e-4)
        reps = min(max_reps, max(reps + 1, int(reps * min(scale, 8.0)) + 1))
        t = _loop_seconds(fn, args, reps)
    best = min(t, _loop_seconds(fn, args, reps), _loop_seconds(fn, args, reps))
    return max(best / reps, 1e-9)

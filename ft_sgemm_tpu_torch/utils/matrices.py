"""Matrix generation / verification helpers (reference ``utils/utils.cu``;
the port's copy of ``ft_sgemm_tpu/utils/matrices.py``).

Inputs are quantized to ±{0, 0.1, ..., 0.9} (``utils.cu:23-31``) so that
checksum accumulation noise stays far below the fault-detection threshold.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_SEED = 10  # reference: srand(10), sgemm.cu:12


def generate_random_matrix(n: int, m: int | None = None, seed: int | None = None,
                           rng: np.random.Generator | None = None) -> np.ndarray:
    """(n, m) f32 matrix with entries uniform over ±{0, 0.1, ..., 0.9}.

    Mirrors ``utils.cu:23-31``: magnitude ``(rand() % 10) * 0.1``, sign from
    a second draw, drawn from numpy's Generator (``runtime`` gives the
    libc-``rand`` stream).
    """
    m = n if m is None else m
    if rng is None:
        rng = np.random.default_rng(_DEFAULT_SEED if seed is None else seed)
    mag = rng.integers(0, 10, size=(n, m)).astype(np.float32) * np.float32(0.1)
    sign = np.where(rng.integers(0, 2, size=(n, m)) == 0, 1.0, -1.0).astype(np.float32)
    return mag * sign


def verify_matrix(ref: np.ndarray, out: np.ndarray, verbose: bool = True,
                  abs_tol: float = 0.01, rel_tol: float = 0.01):
    """Reference tolerance policy: an element fails iff its absolute error
    > abs_tol AND its relative error (vs ref) > rel_tol (``utils.cu:61-77``).

    Returns (ok, num_bad, first_bad_index_or_None). Two tensors are
    compared on ``ref``'s device, in float64 as on the host: the same
    verdict, without copying C off the card.
    """
    if isinstance(ref, torch.Tensor) and isinstance(out, torch.Tensor):
        ref = ref.to(torch.float64)
        out = out.to(ref.device, torch.float64)
        diff = (ref - out).abs()
        denom = ref.abs()
        rel = torch.where(denom > 0, diff / denom, torch.inf)
        bad = (diff > abs_tol) & (rel > rel_tol)
        num_bad = int(bad.sum())
        first = tuple(bad.nonzero()[0].tolist()) if num_bad else None
    else:
        ref = np.asarray(ref, dtype=np.float64)
        out = np.asarray(out, dtype=np.float64)
        diff = np.abs(ref - out)
        denom = np.abs(ref)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(denom > 0, diff / denom, np.inf)
        bad = (diff > abs_tol) & (rel > rel_tol)
        num_bad = int(bad.sum())
        first = (tuple(int(x) for x in np.argwhere(bad)[0]) if num_bad
                 else None)
    ok = num_bad == 0
    if not ok and verbose:
        i = first
        print(
            f"error is {float(diff[i]):8.5f}, relative error is"
            f" {float(rel[i]):8.5f}, {float(ref[i]):8.5f},"
            f"{float(out[i]):8.5f}. id: {', '.join(map(str, i))}"
        )
    return ok, num_bad, first

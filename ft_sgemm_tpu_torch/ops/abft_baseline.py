"""Non-fused (two-pass) ABFT baseline, kernel id 10, as torch ops.

Port of ``ft_sgemm_tpu/ops/abft_baseline.py:83-154`` (reference
``include/baseline_ft_sgemm.cuh:1-33``): per 256-wide K panel it applies
the panel's partial product to C, then re-reads all of C to recompute its
row/column sums and compares them with checksums derived from the panel
inputs. Detection only. The JAX package builds it from plain XLA ops with
no Pallas kernel; here each panel is one cuBLAS ``addmm_`` plus matrix-
vector products and reductions, and there is no hand kernel either. With
``in_dtype="bfloat16"`` the panels are the bf16-rounded operands, their
products and checksums taken in FP32 (``abft_baseline.py:87-88``), and
likewise with ``in_dtype="float8_e4m3fn"`` on the e4m3-rounded operands
(``common.to_e4m3``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.ops.common import (
    LaunchAxes,
    as_f32,
    as_operand,
    check_precision,
    pad_to,
    resolve_device,
    resolve_in_dtype,
    strict_fp32,
)

PANEL_K = 256  # reference K-panel width, baseline_ft_sgemm.cuh:4


class AbftBaselineResult(NamedTuple):
    c: torch.Tensor                 # (M, N) alpha*A@B.T + beta*C
    max_row_residual: torch.Tensor  # f32 scalar: max |expected - row sum|
    max_col_residual: torch.Tensor  # f32 scalar
    detected: torch.Tensor          # bool scalar: a residual above threshold


def abft_baseline_sgemm(a, b, c, alpha: float = 1.0, beta: float = -1.5, *,
                        inject: InjectionSpec | None = None,
                        panel_k: int = PANEL_K,
                        threshold: float = REFERENCE_THRESHOLD,
                        precision: str = "highest", in_dtype="float32",
                        device=None) -> AbftBaselineResult:
    """Two-pass checksum-verified ``C = alpha*A@B.T + beta*C``.

    ``inject`` adds a fault to one rotating element of C between pass 1 and
    pass 2 of each scheduled panel (``panel % every == 0``). K is zero-padded
    to a multiple of ``panel_k``. ``in_dtype="bfloat16"`` (or
    ``"float8_e4m3fn"``) rounds A and B to bf16 (e4m3) first; everything
    after is f32 (TF32 off). int8 raises ``ValueError``, as in the JAX
    package. ``precision`` (``common.check_precision``): with f32 operands
    ``"default"`` runs every product, the panel's and the checksum
    updates', as one TF32 pass, both operands rounded to TF32 (the JAX
    package runs its dots at that precision); ``"high"`` and ``"highest"``
    are FP32. ``device=None`` runs
    on CUDA; the caller's ``c`` is never written.
    """
    inject = inject or InjectionSpec.none()
    dtype = resolve_in_dtype(in_dtype)
    hi = LaunchAxes(one_pass=check_precision(precision, dtype)).hi
    dev = resolve_device(device)
    strict_fp32()
    a, b = (as_operand(x, dtype, dev).float() for x in (a, b))
    c = as_f32(c, dev)
    m, n = c.shape
    a, b = pad_to(a, 1, panel_k), pad_to(b, 1, panel_k)
    c_acc = beta * c
    # Expected running sums start at the sums of beta*C (the baseline checks
    # full-C checksums after every panel update).
    r_exp, c_exp = c_acc.sum(1), c_acc.sum(0)
    max_r = torch.zeros((), device=dev)
    max_c = torch.zeros((), device=dev)
    for p in range(a.shape[1] // panel_k):
        ap = a[:, p * panel_k:(p + 1) * panel_k]
        bp = b[:, p * panel_k:(p + 1) * panel_k]
        # Pass 1: the panel's partial product, applied to C.
        c_acc.addmm_(hi(ap), hi(bp).T, alpha=alpha)
        if inject.enabled and p % inject.every == 0:
            # SDC between the GEMM pass and the checksum pass.
            c_acc[(p * 131 + 7) % m, (p * 61 + 3) % n] += inject.magnitude
        # Input-side checksum update (the reference's cublasSgemv).
        r_exp += alpha * (hi(ap) @ hi(bp.sum(0)))
        c_exp += alpha * (hi(bp) @ hi(ap.sum(0)))
        # Pass 2: a full re-read of C (the non-fused cost).
        max_r = torch.maximum(max_r, (r_exp - c_acc.sum(1)).abs().max())
        max_c = torch.maximum(max_c, (c_exp - c_acc.sum(0)).abs().max())
    return AbftBaselineResult(c_acc, max_r, max_c,
                              (max_r > threshold) | (max_c > threshold))

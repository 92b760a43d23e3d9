"""Helpers shared by the port's ops: device resolution, padding, the FP32
matmul setting, the correction-pad rule and the scalar argument.

Only what this slice's kernels use of ``ft_sgemm_tpu/ops/common.py`` and
``ft_sgemm_tpu/ops/ft_sgemm.py`` lives here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ft_sgemm_tpu_torch.contracts import N_SCALAR_SLOTS

# _correction_pads (ops/ft_sgemm.py:342-357): a correction of magnitude
# |delta| cannot verify tighter than 8 * eps * sum |delta|.
EPS8 = 8.0 * float(np.finfo(np.float32).eps)

# Thresholds saturate at a finite huge value (ops/ft_sgemm.py:1354): the
# moment scalings could otherwise re-overflow a saturated bound to inf.
THRESHOLD_CAP = np.float32(np.finfo(np.float32).max / 16.0)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Only an explicit ``"cpu"`` runs on the CPU (the plain PyTorch versions
    of the kernels); asking for CUDA on a host without a GPU raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the"
            " plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """A contiguous, 16-byte aligned f32 tensor on ``device`` from a numpy
    array or tensor (the kernels load operands as float4)."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def strict_fp32() -> None:
    """Keep fp32 matmuls and convolutions in full FP32: TF32 keeps a 10-bit
    mantissa, which would move the oracle and the expected checksums by far
    more than the kernels' accumulation noise. Set explicitly at every use,
    whatever the process default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pad_to(x: torch.Tensor, row_mult: int, col_mult: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to multiples of (row_mult, col_mult).

    Zero padding is exact for GEMM and for checksum math: padded rows and
    columns contribute nothing and are sliced off by callers.
    """
    r, c = x.shape
    pr, pc = (-r) % row_mult, (-c) % col_mult
    if pr or pc:
        x = F.pad(x, (0, pc, 0, pr))
    return x


def correction_pads(delta: torch.Tensor, dim: int, *weights):
    """Correction-rounding floors for the residual-after-correct re-check:
    ``EPS8 * sum(|delta| [* weight])`` along ``dim``, the plain pad first,
    then one per weight."""
    ad = delta.abs()
    pads = [EPS8 * ad.sum(dim)]
    for w in weights:
        pads.append(EPS8 * (ad * w).sum(dim))
    return pads


def scalar_operand(inject, thresholds) -> np.ndarray:
    """The FT kernels' (8,) f32 scalar argument (contracts.SCALAR_SLOTS):
    injection in slots 0-3, the saturated thresholds in 4-6, slot 7 (the
    adaptive margin) zero."""
    out = np.zeros(N_SCALAR_SLOTS, np.float32)
    out[:4] = inject.as_operand()
    out[4:7] = np.minimum(np.asarray(thresholds, np.float32), THRESHOLD_CAP)
    return out

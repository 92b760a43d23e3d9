"""Carrying one computation across from the JAX package.

This system has no weights: what crosses between the two packages is the
operands and the FT kernels' scalar operand. :func:`from_reference` takes
them as numpy arrays from the JAX side — ``a``, ``b``, ``c``,
``InjectionSpec.as_operand()`` (slots 0-3) and a threshold triple (slots
4-6) — and returns the port's tensors, an :class:`InjectionSpec` and the
triple, so that both packages compute the same thing.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops.common import as_f32, resolve_device


class Operands(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    inject: InjectionSpec
    thresholds: Tuple[float, float, float]


def from_reference(a, b, c, inj_operand, thresholds, device=None) -> Operands:
    """The port's inputs for a JAX-side call ``ft(a, b, c, inject)``.

    ``inj_operand`` is the (4,) f32 ``[enabled, every, magnitude,
    col_stride]`` of the JAX ``InjectionSpec.as_operand()``; ``thresholds``
    one float or the ``(threshold, thr_m1, thr_m2)`` triple of slots 4-6.
    ``device=None`` puts the tensors on CUDA.
    """
    dev = resolve_device(device)
    op = np.asarray(inj_operand, np.float32)
    if op.shape != (4,):
        raise ValueError(f"inj_operand must have shape (4,), got {op.shape}")
    inject = InjectionSpec(enabled=bool(op[0] > 0.0), every=int(op[1]),
                           magnitude=float(op[2]), col_stride=int(op[3]))
    thr = np.broadcast_to(np.asarray(thresholds, np.float32), (3,))
    return Operands(as_f32(a, dev), as_f32(b, dev), as_f32(c, dev), inject,
                    tuple(float(t) for t in thr))

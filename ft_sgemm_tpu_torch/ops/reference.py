"""Reference GEMM (the "vendor library" oracle).

The reference verifies every kernel against ``cublasSgemm(OP_N, OP_T)``
(``sgemm.cu:108,222``): ``C = alpha * A @ B.T + beta * C`` with A (M, K) and
B (N, K). Here the oracle is ``torch.matmul`` in FP32 with TF32 switched off
(``common.strict_fp32``) — cuBLAS on the card, as XLA's dot was in the JAX
package. It is kernel id 0 ("cublas") of the ``ft_sgemm`` program.

With ``in_dtype="bfloat16"`` the oracle is the f32 product of the
bf16-rounded operands (ft_sgemm_tpu/ops/reference.py:21-60): a bf16 x bf16
product is exact in f32, so rounding the inputs once is the whole
precision difference, and C stays f32. It is not ``torch.matmul`` on bf16
tensors, which rounds its output to bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from ft_sgemm_tpu_torch.ops.common import (
    as_f32,
    as_operand,
    resolve_device,
    resolve_in_dtype,
    strict_fp32,
)


def sgemm_reference(a, b, c, alpha=1.0, beta=-1.5, *, in_dtype="float32",
                    device=None) -> torch.Tensor:
    """``C = alpha * A @ B.T + beta * C`` via ``torch.matmul`` in FP32, on
    A and B rounded to ``in_dtype`` (float32, bfloat16 or float8_e4m3fn;
    the exact int8 oracle comes with the int8 kernels); the product of the
    rounded operands always runs in full FP32, TF32 off.

    A new tensor; ``c`` is not modified. ``device=None`` runs on CUDA.
    """
    dt = resolve_in_dtype(in_dtype, allow_low_precision=True)
    if dt == torch.int8:
        raise NotImplementedError(
            "the exact int32 oracle of in_dtype='int8' is not ported yet")
    dev = resolve_device(device)
    strict_fp32()
    a, b = (as_operand(x, dt, dev).float() for x in (a, b))
    c = as_f32(c, dev)
    return alpha * torch.matmul(a, b.T) + beta * c


def cpu_gemm(alpha, beta, a, b, c):
    """Naive host numpy reference in float64 (reference ``utils.cu:79-89``,
    row-major ``C = alpha*A@B + beta*C``): an oracle independent of torch."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    return (alpha * (a @ b) + beta * c).astype(np.float32)

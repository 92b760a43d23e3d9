"""Reference GEMM (the "vendor library" oracle).

The reference verifies every kernel against ``cublasSgemm(OP_N, OP_T)``
(``sgemm.cu:108,222``): ``C = alpha * A @ B.T + beta * C`` with A (M, K) and
B (N, K). Here the oracle is ``torch.matmul`` in FP32 with TF32 switched off
(``common.strict_fp32``) — cuBLAS on the card, as XLA's dot was in the JAX
package. It is kernel id 0 ("cublas") of the ``ft_sgemm`` program.
"""

from __future__ import annotations

import numpy as np
import torch

from ft_sgemm_tpu_torch.ops.common import as_f32, resolve_device, strict_fp32


def sgemm_reference(a, b, c, alpha=1.0, beta=-1.5, *, device=None
                    ) -> torch.Tensor:
    """``C = alpha * A @ B.T + beta * C`` via ``torch.matmul`` in FP32.

    A new tensor; ``c`` is not modified. ``device=None`` runs on CUDA.
    """
    dev = resolve_device(device)
    strict_fp32()
    a, b, c = (as_f32(x, dev) for x in (a, b, c))
    return alpha * torch.matmul(a, b.T) + beta * c


def cpu_gemm(alpha, beta, a, b, c):
    """Naive host numpy reference in float64 (reference ``utils.cu:79-89``,
    row-major ``C = alpha*A@B + beta*C``): an oracle independent of torch."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    return (alpha * (a @ b) + beta * c).astype(np.float32)

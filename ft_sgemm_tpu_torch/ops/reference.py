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
tensors, which rounds its output to bf16. ``in_dtype="float8_e4m3fn"``
likewise (ft_sgemm_tpu/ops/reference.py:52): the f32 product of the
operands rounded to e4m3 as the JAX package rounds them
(``common.to_e4m3``: NaN past 464, where torch's cast saturates).

With ``in_dtype="int8"`` it is the exact oracle of the int8 mode
(ft_sgemm_tpu/ops/reference.py:24-31): A and B truncated to int8, the
product accumulated exactly in int32 (wrapping, as XLA's int32 dot does),
widened to f32 only for ``alpha * out + beta * C``. On the card the
product is ``torch._int_mm`` (cuBLASLt, int8 in, int32 out), the one
library call that stands in here, as XLA's dot did; on the CPU an int64
matmul reduced mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

from ft_sgemm_tpu_torch.configs import EpilogueSpec
from ft_sgemm_tpu_torch.ops.common import (
    apply_epilogue,
    as_f32,
    as_operand,
    resolve_device,
    resolve_in_dtype,
    strict_fp32,
)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Integers reduced to int32's range mod 2^32, as int64: the value that
    wrapping int32 arithmetic holds."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A @ B.T`` of int8 A (M, K) and B (N, K), accumulated exactly in
    wrapping int32, as an int32 tensor on their device: ``torch._int_mm``
    on the card (its shapes, M > 16 and K and N multiples of 8, reached by
    zero padding, which the product ignores), an int64 matmul reduced mod
    2^32 on the CPU (``torch.matmul`` takes no integer tensors on CUDA)."""
    (m, k), n = a.shape, b.shape[0]
    if a.device.type == "cpu":
        return wrap_int32(a.long() @ b.long().T).to(torch.int32)
    mp, kp, np_ = max(m, 17), k + (-k) % 8, n + (-n) % 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    bp = torch.zeros((np_, kp), dtype=torch.int8, device=a.device)
    ap[:m, :k] = a
    bp[:n, :k] = b
    return torch._int_mm(ap, bp.T)[:m, :n]


def sgemm_reference(a, b, c, alpha=1.0, beta=-1.5, *, in_dtype="float32",
                    device=None) -> torch.Tensor:
    """``C = alpha * A @ B.T + beta * C`` via ``torch.matmul`` in FP32, on
    A and B rounded to ``in_dtype`` (float32, bfloat16 or float8_e4m3fn);
    the product of the rounded operands always runs in full FP32, TF32 off.
    ``in_dtype="int8"``: A and B truncated to int8, their product exact in
    wrapping int32 (:func:`int8_matmul`), then ``alpha * f32(out) + beta *
    C`` in f32.

    A new tensor; ``c`` is not modified. ``device=None`` runs on CUDA.
    """
    dt = resolve_in_dtype(in_dtype, allow_low_precision=True)
    dev = resolve_device(device)
    c = as_f32(c, dev)
    if dt == torch.int8:
        a, b = (as_operand(x, dt, dev) for x in (a, b))
        return alpha * int8_matmul(a, b).float() + beta * c
    strict_fp32()
    a, b = (as_operand(x, dt, dev).float() for x in (a, b))
    return alpha * torch.matmul(a, b.T) + beta * c


def epilogue_reference(x, epilogue, bias=None):
    """The host twin of the kernels' fused epilogue
    (ft_sgemm_tpu/ops/reference.py:63-101): bias -> activation -> quantize
    on an already computed f32 output, through the same arithmetic as the
    kernels' plain versions (``ops/common.apply_epilogue``), so the two
    cannot drift; fp8 rounds as ``ops/common.to_e4m3`` (no ``ml_dtypes``).

    ``epilogue`` is an :class:`~ft_sgemm_tpu_torch.configs.EpilogueSpec` or
    a spelling string; ``bias`` a length-N (or (1, N)) vector when the spec
    fuses one. A tensor ``x`` gives a tensor on its device (``bias`` moved
    there); anything else is taken as a numpy array and gives one. Compose
    with :func:`sgemm_reference` to check an epilogue-fused kernel end to
    end.
    """
    epi = EpilogueSpec.parse(epilogue)
    is_tensor = isinstance(x, torch.Tensor)
    t = (x.to(torch.float32) if is_tensor
         else torch.from_numpy(np.array(x, dtype=np.float32)))
    if epi.bias and bias is None:
        raise ValueError(
            "epilogue_reference: spec fuses a bias but none given")
    row = None
    if epi.bias:
        row = torch.as_tensor(bias, dtype=torch.float32,
                              device=t.device).reshape(1, -1)
    out = apply_epilogue(t, epi, row)
    return out if is_tensor else out.numpy()


# How far a GELU may lie from ``ops/common.apply_epilogue``'s on the same
# input: tanh differs by an ulp or two between libraries (CUDA's tanhf,
# torch's CPU and CUDA tanh, XLA's), and 1 + tanh cancels in the negative
# tail, so the bound is in ulps of the input's magnitude, not the output's
# (the JAX package's GELU on the CPU lies within 2 of the port's).
GELU_TOLERANCE_ULPS = 4


def epilogue_violations(got: torch.Tensor, x: torch.Tensor, epilogue,
                        bias=None) -> torch.Tensor:
    """Where ``got``, an output with the fused epilogue ``epilogue``, is not
    that epilogue applied to ``x``, the same computation's output without
    it (``ops/common.apply_epilogue``, on ``x``'s device): a bool mask.
    Without gelu ``got`` must equal it element by element (NaN where it is
    NaN). With gelu, the GELU may lie within :data:`GELU_TOLERANCE_ULPS`
    ulps of its input's magnitude of the reference's, and a quantized
    output anywhere between the quantize of that interval's two ends (the
    quantize is monotone, so a tie the GELU's last ulps move may round
    either way). ``bias`` is the length-N bias row when the spec fuses one.
    """
    epi = EpilogueSpec.parse(epilogue)
    row = (None if not epi.bias else
           torch.as_tensor(bias, dtype=torch.float32,
                           device=x.device).reshape(1, -1))
    want = apply_epilogue(x, epi, row)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if epi.activation != "gelu":
        return ~same
    g_in = apply_epilogue(x, EpilogueSpec(bias=epi.bias), row).abs()
    tol = GELU_TOLERANCE_ULPS * (torch.nextafter(
        g_in, torch.full_like(g_in, float("inf"))) - g_in)
    g = apply_epilogue(x, EpilogueSpec(bias=epi.bias, activation="gelu"), row)
    quant = EpilogueSpec(quantize=epi.quantize, scale=epi.scale)
    lo, hi = apply_epilogue(g - tol, quant), apply_epilogue(g + tol, quant)
    return ~(same | ((got >= lo) & (got <= hi)))


def cpu_gemm(alpha, beta, a, b, c):
    """Naive host numpy reference in float64 (reference ``utils.cu:79-89``,
    row-major ``C = alpha*A@B + beta*C``): an oracle independent of torch."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    return (alpha * (a @ b) + beta * c).astype(np.float32)

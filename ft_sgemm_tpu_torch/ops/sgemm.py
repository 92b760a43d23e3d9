"""Plain SGEMM: kernel B1 (``csrc/sgemm.cu``), behind kernel ids 1-6.

Port of ``ft_sgemm_tpu/ops/sgemm.py``: ``C = alpha * A @ B.T + beta * C``
with A (M, K), B (N, K) (``sgemm.cu:108``: ``cublasSgemm(OP_N, OP_T)``),
zero-padded to the tile and sliced back. On the card the product runs in
the hand-written kernel, 3xTF32 on wgmma (``ops/_build.mainloop``): one
CTA per tile at the large, tall, huge and test tiles, the 128 x 128 CTA
at the others; on CPU tensors, in its plain PyTorch version (one FP32
matmul: the function is the FP32 product, however the kernel computes
it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ft_sgemm_tpu_torch.configs import SHAPES, KernelShape
from ft_sgemm_tpu_torch.ops._build import bind, check_launch, check_operands, library
from ft_sgemm_tpu_torch.ops.common import as_f32, pad_to, resolve_device, strict_fp32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _entry():
    return bind(library("sgemm"), "ftsg_sgemm",
                [_P] * 4 + [_I] * 9 + [_F] * 2 + [_P])


def sgemm_plain(a, b, c, alpha, beta) -> torch.Tensor:
    """Plain PyTorch version of B1: one FP32 matmul and the alpha/beta
    epilogue."""
    strict_fp32()
    return alpha * torch.matmul(a, b.T) + beta * c


def sgemm_kernel(a, b, c, shape: KernelShape, alpha: float, beta: float
                 ) -> torch.Tensor:
    """B1 on operands already padded to ``shape``'s tile: a new (M, N)
    tensor ``alpha * a @ b.T + beta * c``. A CUDA tensor launches the
    kernel; a CPU tensor runs the plain version."""
    if a.device.type == "cpu":
        return sgemm_plain(a, b, c, alpha, beta)
    dims = check_operands(shape, a, b, c)
    out = torch.empty_like(c)
    rc = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                  *dims, alpha, beta,
                  torch.cuda.current_stream(a.device).cuda_stream)
    sgemm_kernel.launches += 1
    check_launch(rc, "ftsg_sgemm")
    return out


sgemm_kernel.launches = 0


def make_sgemm(shape: KernelShape | str, *, alpha: float = 1.0,
               beta: float = -1.5, device=None):
    """Build the plain SGEMM for one named shape (or an explicit
    ``KernelShape``).

    Returns ``fn(a, b, c) -> C`` with ``C = alpha*A@B.T + beta*C`` for
    inputs of any (M, K)/(N, K)/(M, N) shapes (numpy arrays or tensors),
    zero-padded to the tile and sliced back. ``device=None`` runs on CUDA.
    The caller's ``c`` is never written.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    dev = resolve_device(device)

    def fn(a, b, c):
        a, b, c = (as_f32(x, dev) for x in (a, b, c))
        m, n = c.shape
        out = sgemm_kernel(pad_to(a, shape.bm, shape.bk),
                           pad_to(b, shape.bn, shape.bk),
                           pad_to(c, shape.bm, shape.bn), shape, alpha, beta)
        return out[:m, :n]

    fn.__name__ = f"sgemm_{shape.name}"
    fn.shape_config = shape
    return fn


def sgemm(a, b, c, shape: KernelShape | str = "huge", *, alpha=1.0, beta=-1.5,
          device=None):
    """One-shot plain SGEMM (see :func:`make_sgemm`)."""
    return make_sgemm(shape, alpha=alpha, beta=beta, device=device)(a, b, c)

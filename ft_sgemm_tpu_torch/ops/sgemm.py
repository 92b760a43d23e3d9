"""Plain SGEMM: kernel B1 (``csrc/sgemm.cu``), behind kernel ids 1-6.

Port of ``ft_sgemm_tpu/ops/sgemm.py``: ``C = alpha * A @ B.T + beta * C``
with A (M, K), B (N, K) (``sgemm.cu:108``: ``cublasSgemm(OP_N, OP_T)``),
zero-padded to the tile and sliced back. On the card the product runs in
the hand-written kernel, 3xTF32 on wgmma (``ops/_build.mainloop``): one
CTA per tile at the large, tall, huge and test tiles, the 128 x 128 CTA
at the others; on CPU tensors, in its plain PyTorch version (one FP32
matmul: the function is the FP32 product, however the kernel computes
it).

``in_dtype="bfloat16"`` rounds A and B to bf16 (C and the accumulator stay
f32, as in ``ft_sgemm_tpu/ops/sgemm.py:165-219``): on the card B1's bf16
instantiation runs one bf16 wgmma per 16-deep k step on the operands as
they land; the plain version multiplies the rounded values in FP32.
``in_dtype="float8_e4m3fn"`` (the fp8 serving mode) rounds them to e4m3
(``common.to_e4m3``) and runs B1's fp8 build, one e4m3 wgmma per 32-deep k
step, each k step's sum promoted into the f32 accumulator; its rows lie 16
bytes apart (``common.align_rows16``).

The variant axes (``variant=``): a pipeline depth of 3 pads K to and steps
by the two-panel window (the plain version multiplies per panel), the grid
order "nm" walks B1's CTAs M tile first, and the dimension semantics change
nothing on the card. ``precision="default"`` with f32 runs one TF32 wgmma
per k step on operands rounded to TF32; "high" runs 3xTF32 as "highest".

The fused epilogue (``epilogue=``: bias, relu or gelu, int8 or fp8
quantize-rescale; ft_sgemm_tpu/ops/sgemm.py:98-101) runs inside B1's store on
the card, after alpha * acc + beta * C (``csrc/abft_common.cuh::Epilogue``),
and after the matmul in the plain version (``common.apply_epilogue``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ft_sgemm_tpu_torch.configs import (
    SHAPES,
    EpilogueSpec,
    KernelShape,
    canonical_in_dtype,
    canonical_variant,
    check_variant,
)
from ft_sgemm_tpu_torch.ops._build import (
    EPILOGUE_ARGS,
    VARIANT_ARGS,
    bind,
    check_launch,
    check_operands,
    library,
)
from ft_sgemm_tpu_torch.ops.common import (
    LaunchAxes,
    align_rows16,
    apply_epilogue,
    as_f32,
    as_operand,
    bias_operand,
    check_precision,
    epilogue_args,
    launch_axes,
    pad_to,
    resolve_device,
    resolve_in_dtype,
    step_shape,
    strict_fp32,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype = torch.float32, one_pass: bool = False):
    """B1's entry point for f32, bf16 or fp8 operands (fp8 in a library of
    its own, ``_build.LIBRARIES``), or for f32 in one TF32 pass
    (``one_pass``, the library ``sgemm_tf32``)."""
    if one_pass and dtype != torch.float32:
        raise ValueError(f"one TF32 pass is an f32 build, not {dtype}")
    lib, name = {torch.float32: ("sgemm_tf32" if one_pass else "sgemm",
                                 "ftsg_sgemm"),
                 torch.bfloat16: ("sgemm", "ftsg_sgemm_bf16"),
                 torch.float8_e4m3fn: ("sgemm_fp8", "ftsg_sgemm_fp8")}[dtype]
    return bind(library(lib), name,
                [_P] * 4 + [_I] * 6 + [_F] * 2 + EPILOGUE_ARGS + VARIANT_ARGS
                + [_P])



def sgemm_plain(a, b, c, alpha, beta, epi=None, bias=None, panel: int = 0,
                axes: LaunchAxes = LaunchAxes()) -> torch.Tensor:
    """Plain PyTorch version of B1: one FP32 matmul of the (rounded)
    operands, the alpha/beta epilogue, then the fused epilogue ``epi``
    (an ``EpilogueSpec`` or None) with the padded bias row ``bias``. At a
    pipeline depth of 3 (``axes.unroll`` > 1) one matmul per K panel of
    ``panel`` columns, added in order, as the JAX kernel's ``sub_panels``
    dots; under the f32 precision "default" (``axes.one_pass``) the
    operands rounded to TF32 first, the one-product form of the kernel."""
    strict_fp32()
    a, b = (axes.hi(x.float()) for x in (a, b))
    if axes.unroll > 1 and panel:
        acc = torch.zeros_like(c)
        for k0 in range(0, a.shape[1], panel):
            acc += torch.matmul(a[:, k0:k0 + panel], b[:, k0:k0 + panel].T)
    else:
        acc = torch.matmul(a, b.T)
    return apply_epilogue(alpha * acc + beta * c, epi, bias)


def sgemm_kernel(a, b, c, shape: KernelShape, alpha: float, beta: float,
                 epi=None, bias=None,
                 axes: LaunchAxes = LaunchAxes()) -> torch.Tensor:
    """B1 on operands already padded to ``shape``'s tile: a new (M, N)
    tensor ``epi(alpha * a @ b.T + beta * c)``, A and B both f32, both bf16
    or both fp8; ``epi`` the fused epilogue (an ``EpilogueSpec`` or
    None) and ``bias`` its padded (N,) bias row
    (``common.pad_bias``); ``axes`` the variant axes and precision of the
    launch (``common.LaunchAxes``: the CTA raster, one TF32 pass; ``shape``
    is the grid step's, ``common.step_shape``). A CUDA tensor launches the
    kernel (counted in ``launches``, ``bf16_launches`` or ``fp8_launches``,
    a non-identity epilogue also in ``epilogue_launches``, a one-pass
    launch also in ``one_pass_launches``); a CPU tensor runs the plain
    version."""
    if a.device.type == "cpu":
        return sgemm_plain(a, b, c, alpha, beta, epi, bias,
                           shape.bk // axes.unroll, axes)
    dims = check_operands(shape, a, b, c)
    epi_args = epilogue_args(epi, bias, c.shape[1], c.device)
    out = torch.empty_like(c)
    fn = _entry(a.dtype, axes.one_pass)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), *dims,
            alpha, beta, *epi_args, *axes.args(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if epi is not None and not epi.is_identity:
        sgemm_kernel.epilogue_launches += 1
    if axes.one_pass:
        sgemm_kernel.one_pass_launches += 1
    if a.dtype == torch.bfloat16:
        sgemm_kernel.bf16_launches += 1
    elif a.dtype == torch.float8_e4m3fn:
        sgemm_kernel.fp8_launches += 1
    else:
        sgemm_kernel.launches += 1
    check_launch(rc, fn.__name__)
    return out


sgemm_kernel.launches = 0
sgemm_kernel.bf16_launches = 0
sgemm_kernel.fp8_launches = 0
sgemm_kernel.epilogue_launches = 0
sgemm_kernel.one_pass_launches = 0


def make_sgemm(shape: KernelShape | str, *, alpha: float = 1.0,
               beta: float = -1.5, precision: str = "highest",
               in_dtype="float32", device=None, variant=None, epilogue=None):
    """Build the plain SGEMM for one named shape (or an explicit
    ``KernelShape``).

    Returns ``fn(a, b, c, bias=None) -> C`` with ``C = epilogue(alpha*A@B.T
    + beta*C)`` for inputs of any (M, K)/(N, K)/(M, N) shapes (numpy arrays
    or tensors), zero-padded to the tile and sliced back.
    ``epilogue`` (an :class:`~ft_sgemm_tpu_torch.configs.EpilogueSpec` or
    a spelling like ``"bias+relu"`` or ``"bias+gelu+qint8x0.5"``) fuses a
    bias add, an activation and an int8 or fp8 quantize-rescale into B1's
    store (ft_sgemm_tpu/ops/sgemm.py:160-262); a fused bias is passed per
    call, ``fn(a, b, c, bias=v)`` with ``v`` of length N. ``variant`` (a
    :class:`~ft_sgemm_tpu_torch.configs.KernelVariant`, a dict of its
    fields or None) carries the epilogue too (``epilogue=`` wins) and the
    variant axes: ``pipeline_depth=3`` pads K to and steps by the two-panel
    window ``kwin = 2 bk`` (``common.step_shape``; the plain version
    multiplies each panel on its own, as ``sub_panels`` does),
    ``grid_order="nm"`` walks B1's CTAs M tile first, and
    ``dim_semantics="arbitrary"``, a Mosaic scheduling hint, runs the same
    kernel. ``in_dtype="bfloat16"`` rounds
    A and B to bf16 on the device, ``"float8_e4m3fn"`` (aliases ``fp8``,
    ``fp8_e4m3``, ``float8_e4m3``) to e4m3 as the JAX package does (NaN
    past 464); C and the accumulator stay f32.
    ``precision`` (the JAX package's names; ``common.check_precision``):
    with f32, ``"highest"`` and ``"high"`` run 3xTF32, FP32-accurate, and
    ``"default"`` one TF32 wgmma per k step on operands rounded to TF32
    (``hi . hi``); a bf16 or fp8 product is one pass whatever is asked.
    int8 raises ``ValueError``, as in the JAX package (it needs the FT
    kernels' exact path). ``device=None`` runs on CUDA.
    The caller's ``c`` is never written. The tile is the paper's for every
    dtype (the JAX package's bf16 tile overrides are TPU tuning).
    """
    dtype = resolve_in_dtype(in_dtype)
    one_pass = check_precision(precision, dtype)
    var = canonical_variant(variant)
    if epilogue is not None:
        var = dataclasses.replace(
            var, epilogue=EpilogueSpec.parse(epilogue).spelling)
    check_variant(var)
    epi = var.epilogue_spec
    if isinstance(shape, str):
        shape = SHAPES[shape]
    step = step_shape(shape, var)
    axes = launch_axes(var, one_pass)
    dev = resolve_device(device)

    def fn(a, b, c, bias=None):
        a, b = (as_operand(x, dtype, dev) for x in (a, b))
        c = as_f32(c, dev)
        m, n = c.shape
        row = bias_operand(fn.__name__, epi, bias, n, shape.bn, dev)
        out = sgemm_kernel(align_rows16(pad_to(a, step.bm, step.bk)),
                           align_rows16(pad_to(b, step.bn, step.bk)),
                           pad_to(c, step.bm, step.bn), step, alpha, beta,
                           epi, row, axes)
        return out[:m, :n]

    name = canonical_in_dtype(in_dtype)
    fn.__name__ = f"sgemm_{shape.name}" + (
        "" if name == "float32" else f"_{name}")
    fn.shape_config = shape
    fn.in_dtype = name
    fn.precision = precision
    fn.variant = var
    return fn


def sgemm(a, b, c, shape: KernelShape | str = "huge", *, alpha=1.0, beta=-1.5,
          precision="highest", in_dtype="float32", device=None, variant=None):
    """One-shot plain SGEMM (see :func:`make_sgemm`)."""
    return make_sgemm(shape, alpha=alpha, beta=beta, precision=precision,
                      in_dtype=in_dtype, device=device, variant=variant
                      )(a, b, c)

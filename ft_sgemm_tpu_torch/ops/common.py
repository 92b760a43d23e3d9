"""Helpers shared by the port's ops: device resolution, the input dtype and
the operand casts, padding, the FP32 matmul setting, the correction-pad
rule, the scalar argument, the clean-residual noise model behind
``threshold="auto"`` and ``threshold="adaptive"``, the fused epilogue
(bias, activation, quantize) with its kernel arguments, the variant axes
and the precision of a launch (step shape, CTA raster, one TF32 pass), and
the GEMM cost model.

Only what the port's kernels and reports use of ``ft_sgemm_tpu/ops/
common.py`` and ``ft_sgemm_tpu/ops/ft_sgemm.py`` lives here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ft_sgemm_tpu_torch.configs import EpilogueSpec, canonical_in_dtype
from ft_sgemm_tpu_torch.contracts import N_SCALAR_SLOTS

# _correction_pads (ops/ft_sgemm.py:342-357): a correction of magnitude
# |delta| cannot verify tighter than 8 * eps * sum |delta|.
EPS8 = 8.0 * float(np.finfo(np.float32).eps)

# Thresholds saturate at a finite huge value (ops/ft_sgemm.py:1354): the
# moment scalings could otherwise re-overflow a saturated bound to inf.
THRESHOLD_CAP = np.float32(np.finfo(np.float32).max / 16.0)

# The calibrated constants of the clean-residual noise model (the JAX
# package's ops/common.py:92-97; calibration in analysis.py there): the
# random-walk and bias coefficients, and the default margin between the
# bound and a detection threshold.
NOISE_C_RAND = 32.0
NOISE_C_BIAS = 4.0
DEFAULT_THRESHOLD_MARGIN = 8.0
F32_EPS = float(np.finfo(np.float32).eps)


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


# Matmul precisions (the JAX package's lax.Precision names).
PRECISIONS = ("default", "high", "highest")


def check_precision(precision: str, dtype: torch.dtype) -> bool:
    """Validate a ``precision`` (the JAX package's names) and return whether
    the product runs ONE TF32 pass. An unknown name raises ``ValueError``.
    With float32 operands ``"highest"`` and ``"high"`` run 3xTF32
    (FP32-accurate: the TPU's ``"high"`` is a three-pass bf16 product, and
    3xTF32 is the port's three-pass product, so the two names run the same
    kernels), and ``"default"`` runs one TF32 pass, ``hi . hi`` with ``hi``
    each operand rounded to TF32 as ``cvt.rna`` rounds it
    (:func:`tf32_rna`): one wgmma per k step on the card, where 3xTF32 runs
    three. A bf16, fp8 or int8 product is one pass of its own dtype
    whatever is asked, as the JAX package resolves it
    (ft_sgemm_tpu/ops/common.py:219)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got"
                         f" {precision!r}")
    return dtype == torch.float32 and precision == "default"


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` bit for bit: f32 rounded to TF32's 10 mantissa
    bits, to nearest with ties away from zero, on the bit pattern (so
    subnormals round like normals, and the largest finite f32 rounds up to
    inf). inf stays inf and NaN stays NaN. The ``hi`` of the 3xTF32 split
    (``csrc/gemm_wgmma.cuh::split_tf32``) and the operands of a one-pass
    product (precision ``"default"``)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


class LaunchAxes(NamedTuple):
    """What a kernel variant and a precision change in one launch of a
    kernel or of its plain version (:func:`launch_axes`; the dimension
    semantics change nothing). ``unroll``: the K panels of a grid step
    (the kernels see the depth only as the step shape's bk,
    :func:`step_shape`; the plain versions multiply panel by panel, as the
    JAX kernels' ``sub_panels`` do). ``nm``: the grid order "nm", the
    kernels' CTA raster (``csrc/abft_common.cuh::Variant``). ``one_pass``: the f32
    precision "default" (:func:`check_precision`): the kernels' ``*_tf32``
    builds, and in the plain versions both operands of every product
    rounded to TF32, as the kernels' one hi . hi wgmma takes them."""

    unroll: int = 1
    nm: bool = False
    one_pass: bool = False

    def args(self) -> tuple:
        """The argument every kernel entry point takes after the fused
        epilogue's (``_build.VARIANT_ARGS``; ``csrc/abft_common.cuh::
        Variant``): the grid order ("nm" 1)."""
        return (int(self.nm),)

    def hi(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product as the kernel multiplies it: rounded to
        TF32 in one-pass mode, else as it is."""
        return tf32_rna(x) if self.one_pass else x


def launch_axes(variant, one_pass: bool = False) -> LaunchAxes:
    """The :class:`LaunchAxes` of a ``configs.KernelVariant`` and the
    one-pass flag of :func:`check_precision`."""
    return LaunchAxes(variant.pipeline_depth - 1, variant.grid_order == "nm",
                      bool(one_pass))


def step_shape(shape, variant):
    """The tile of one grid step under ``variant``: ``shape`` with bk the
    K window ``kwin = bk * (pipeline_depth - 1)`` (ft_sgemm_tpu/ops/
    ft_sgemm.py:1725-1735, 1797-1799), the unit the operands are padded
    to, the check cadence and the injection schedule count, and the bk
    the kernels take; ``shape`` itself at depth 2."""
    unroll = variant.pipeline_depth - 1
    if unroll == 1:
        return shape
    return dataclasses.replace(shape, bk=shape.bk * unroll)


def sub_panels(a_blk: torch.Tensor, b_blk: torch.Tensor, unroll: int):
    """One grid step's K window split into ``unroll`` panel operand pairs
    along the last dimension (ft_sgemm_tpu/ops/common.py:414-428);
    ``unroll == 1`` returns the window untouched."""
    if unroll <= 1:
        return [(a_blk, b_blk)]
    sub = a_blk.shape[-1] // unroll
    return [(a_blk[..., s * sub:(s + 1) * sub],
             b_blk[..., s * sub:(s + 1) * sub]) for s in range(unroll)]


def resolve_in_dtype(in_dtype, *, allow_low_precision: bool = False):
    """Validate an input dtype (ft_sgemm_tpu/ops/common.py:196-219) and
    return its torch dtype.

    int8 needs the FT kernels' exact int32 path (``allow_low_precision``),
    as in the JAX package; which dtypes the kernels run yet is
    ``configs.check_kernel_legality``'s call.
    """
    name = canonical_in_dtype(in_dtype)
    if name == "int8" and not allow_low_precision:
        raise ValueError(
            f"in_dtype {name!r} needs the FT kernels' int32-exact"
            " accumulation path (make_ft_sgemm); the plain kernels take"
            " float32/bfloat16/float8_e4m3fn")
    return getattr(torch, name)


# float8_e4m3fn's largest finite value is 448; halfway to the next step of
# its grid (480, which e4m3fn spends on NaN) lies 464.
E4M3_OVERFLOW = 464.0


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to float8_e4m3fn as the JAX package's ``astype``
    (ml_dtypes) rounds it: to nearest even, and NaN where ``|t| > 464``
    (±inf too), where torch's own cast saturates to ±448 (448 is also what
    JAX gives up to 464). Torch ops on ``t``'s device."""
    return torch.where(t.abs() > E4M3_OVERFLOW, torch.nan, t).to(
        torch.float8_e4m3fn)


# The tanh GELU's constants (ft_sgemm_tpu/ops/common.py:495-496): sqrt(2/pi)
# and the cubic term's coefficient, as the kernels take them in f32.
GELU_SQRT_2_OVER_PI = 0.7978845608028654
GELU_CUBIC = 0.044715
# The kernels' codes of the epilogue's activation and quantize modes
# (csrc/abft_common.cuh::Epilogue).
EPILOGUE_ACT_CODES = {"none": 0, "relu": 1, "gelu": 2}
EPILOGUE_QUANT_CODES = {"none": 0, "int8": 1, "float8_e4m3fn": 2}


def pad_bias(bias, n: int, bn: int, device: torch.device) -> torch.Tensor:
    """The fused-bias row (ft_sgemm_tpu/ops/common.py:444-452): ``bias`` as
    a contiguous f32 vector on ``device``, checked against the TRUE output
    width ``n``, zero-padded to the tile's padded N (a multiple of
    ``bn``). The kernels read element ``n0 + col`` of it beside the output
    column; the zero padding sits under the padded columns, which the
    wrapper slices off."""
    b = torch.as_tensor(bias, dtype=torch.float32, device=device).reshape(-1)
    if b.shape[0] != n:
        raise ValueError(
            f"fused bias must have length N={n}, got {b.shape[0]}")
    b = F.pad(b, (0, (-n) % bn)).contiguous()
    return b.clone() if b.data_ptr() % 16 else b


def bias_operand(op_name: str, epi, bias, n: int, bn: int,
                 device: torch.device):
    """The padded bias row of one call of an entry point (:func:`pad_bias`),
    or None, with the JAX package's errors (ft_sgemm_tpu/ops/sgemm.py:
    240-251, ops/ft_sgemm.py:1841-1852): a bias missing where the epilogue
    fuses one, given where it does not, or not of length N."""
    if epi.bias:
        if bias is None:
            raise ValueError(
                f"{op_name}: epilogue {epi.spelling!r} fuses a bias — pass"
                f" the bias=v argument with v of length N={n}")
        return pad_bias(bias, n, bn, device)
    if bias is not None:
        raise ValueError(f"{op_name}: bias given but epilogue"
                         f" {epi.spelling!r} does not fuse one")
    return None


def apply_epilogue(x: torch.Tensor, epi, bias_row=None) -> torch.Tensor:
    """The fused epilogue on a corrected ``alpha*acc + beta*C`` output
    (ft_sgemm_tpu/ops/common.py:461-500), in torch, in the JAX op order:
    ``x + bias_row`` (a row broadcast over the output's rows), then ``relu``
    (negatives to 0, NaN and -0 kept) or the tanh GELU ``0.5 * x * (1.0 +
    tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))`` evaluated left
    to right as written (not ``F.gelu(approximate="tanh")``, whose op
    order differs), then the quantize: int8 ``clamp(round_half_even(x *
    scale), -128, 127)`` (NaN stays NaN, as ``jnp.clip`` keeps it), or fp8
    ``to_e4m3(x * scale)`` (NaN past 464, where torch's cast saturates).
    The result stays f32, on the quantize's grid. The plain versions of the
    kernels apply it to their output, :func:`~ft_sgemm_tpu_torch.ops.
    reference.epilogue_reference` to an oracle's, and ``csrc/
    abft_common.cuh::Epilogue`` is the same arithmetic op for op in every
    kernel's store. ``epi`` is an :class:`EpilogueSpec` or None; the
    identity returns ``x`` itself."""
    if epi is None or epi.is_identity:
        return x
    if epi.bias:
        if bias_row is None:
            raise ValueError(
                "apply_epilogue: epi.bias set but no bias_row operand")
        x = x + bias_row
    if epi.activation == "relu":
        x = torch.where(x < 0.0, torch.zeros_like(x), x)
    elif epi.activation == "gelu":
        x = 0.5 * x * (1.0 + torch.tanh(
            GELU_SQRT_2_OVER_PI * (x + GELU_CUBIC * x * x * x)))
    if epi.quantize == "int8":
        x = torch.clamp(torch.round(x * epi.scale), -128.0, 127.0)
    elif epi.quantize == "float8_e4m3fn":
        x = to_e4m3(x * epi.scale).to(torch.float32)
    return x


def epilogue_args(epi, bias_row=None, n: int = 0, device=None) -> tuple:
    """The four trailing arguments of every kernel entry point before its
    stream (``csrc/abft_common.cuh::Epilogue``): the bias row's address
    (None without a bias), the activation code, the quantize code and the
    quantize scale; ``(None, 0, 0, 1.0)`` for the identity. ``epi`` is an
    :class:`EpilogueSpec` or None (the identity). The bias row is checked
    first: with a bias, a contiguous, 16-byte aligned f32 vector of the
    padded width ``n`` on ``device`` (:func:`pad_bias`); without one,
    none."""
    epi = epi or EpilogueSpec()
    if bias_row is not None and not epi.bias:
        raise ValueError("a bias row was given, but the epilogue"
                         f" {epi.spelling!r} does not fuse one")
    if epi.bias and bias_row is None:
        raise ValueError(f"the epilogue {epi.spelling!r} fuses a bias, but"
                         " no bias row was given")
    if epi.bias and (bias_row.dtype != torch.float32
                     or tuple(bias_row.shape) != (n,)
                     or bias_row.device != device
                     or not bias_row.is_contiguous()
                     or bias_row.data_ptr() % 16):
        raise ValueError(
            f"the bias row must be a contiguous, 16-byte aligned float32"
            f" ({n},) tensor on {device} (ops/common.pad_bias), got"
            f" {bias_row.dtype} {tuple(bias_row.shape)} on {bias_row.device}")
    return (bias_row.data_ptr() if epi.bias else None,
            EPILOGUE_ACT_CODES[epi.activation],
            EPILOGUE_QUANT_CODES[epi.quantize], float(epi.scale))


def as_operand(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An A or B operand in the kernels' input dtype on ``device``: f32 as
    :func:`as_f32`, bf16 rounded to nearest even from f32 on ``device``
    (the rounding the JAX package's ``astype`` does), fp8 likewise with
    JAX's overflow to NaN (:func:`to_e4m3`), int8 truncated toward zero
    from f32 (numpy's ``astype``; the int8 mode's data are integer-valued),
    contiguous and 16-byte aligned. An int8 or fp8 tensor of that dtype is
    taken as it is."""
    if dtype in (torch.int8, torch.float8_e4m3fn) and isinstance(
            x, torch.Tensor) and x.dtype == dtype:
        t = x.to(device).contiguous()
        return t.clone() if t.data_ptr() % 16 else t
    t = as_f32(x, device)
    if dtype == torch.float32:
        return t
    r = (to_e4m3(t) if dtype == torch.float8_e4m3fn else t.to(dtype)).contiguous()
    return r.clone() if r.data_ptr() % 16 else r


def align_rows16(x: torch.Tensor) -> torch.Tensor:
    """A 1-byte (M, K) operand whose rows lie a multiple of 16 bytes apart,
    the row stride TMA takes (``csrc/gemm_wgmma.cuh::tensor_map``): ``x``
    when K is a multiple of 16, else the first K columns of a zero-padded
    (M, K rounded up to 16) copy. K itself, and so the schedule of K
    steps, stays that of the tile's padding (the JAX package pads K to bk
    only); the extra zero columns are storage, never read as data."""
    m, k = x.shape
    if x.element_size() != 1 or k % 16 == 0:
        return x
    buf = torch.zeros((m, k + (-k) % 16), dtype=x.dtype, device=x.device)
    buf[:, :k] = x
    return buf[:, :k]


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


def scalar_operand(inject, thresholds, margin: float = 0.0) -> np.ndarray:
    """The FT kernels' (8,) f32 scalar argument (contracts.SCALAR_SLOTS):
    injection in slots 0-3, the saturated thresholds in 4-6, and in slot 7
    the margin of ``threshold="adaptive"`` (zero otherwise; the adaptive
    kernels read it and not slots 4-6)."""
    out = np.zeros(N_SCALAR_SLOTS, np.float32)
    out[:4] = inject.as_operand()
    out[4:7] = np.minimum(np.asarray(thresholds, np.float32), THRESHOLD_CAP)
    out[7] = margin
    return out


def estimate_noise_floor(a: torch.Tensor, b: torch.Tensor, c, alpha: float,
                         beta: float) -> torch.Tensor:
    """Closed-form bound on a clean run's checksum residual, from the
    inputs' moments (bf16, fp8 and int8 operands as their f32 values, as
    the JAX package reads the rounded inputs), as a 0-d
    f32 tensor on the inputs' device (no host sync): the torch twin of
    ``estimate_noise_floor_jnp``
    (ops/common.py:100-145 of the JAX package), what ``threshold="auto"``
    evaluates per call.

    ``eps * (C_RAND * sqrt(T) * sigma + C_BIAS * log2(T) * T * |mu|)`` for
    the product (T = K * max(M, N), sigma = rms(a) rms(b), mu = mean(a)
    mean(b), times |alpha|) plus the beta * C term (T = max(M, N), rms and
    mean of C, times |beta|). Pass ``c=None`` only with beta = 0. The rms
    is scale-safe (normalised by max |x| before squaring), and the bound
    saturates at a finite value: an inf threshold would disable detection.
    """
    (m, k), n = a.shape, b.shape[0]
    tmax = float(max(m, n))

    def rms(x):
        # max |x|, then y . y of y = x / max |x| (one BLAS dot): three
        # passes over x and one over y.
        xf = x.to(torch.float32)
        scale = torch.clamp(torch.linalg.vector_norm(xf, ord=float("inf")),
                            min=1e-30)
        y = (xf / scale).reshape(-1)
        return scale * torch.sqrt(torch.dot(y, y) / xf.numel())

    def term(t, sigma, mu):
        return F32_EPS * (NOISE_C_RAND * float(np.sqrt(t)) * sigma
                          + NOISE_C_BIAS * float(np.log2(max(t, 2.0))) * t
                          * torch.abs(mu))

    noise = abs(alpha) * term(
        float(k) * tmax, rms(a) * rms(b),
        torch.mean(a.to(torch.float32)) * torch.mean(b.to(torch.float32)))
    if c is not None and beta != 0.0:
        cf = c.to(torch.float32)
        noise = noise + abs(beta) * term(tmax, rms(cf), torch.mean(cf))
    elif beta != 0.0:
        raise ValueError(
            "estimate_noise_floor: pass c (or beta=0): the beta*C term"
            " contributes residual noise the bound must include")
    return torch.clamp(noise, max=float(THRESHOLD_CAP))


def _sqrt(x):
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x)
    return np.sqrt(x) if isinstance(x, np.ndarray) else math.sqrt(x)


def variance_bound_threshold(s_a1, s_a2, s_b1, s_b2, *, n_a, n_b, t_ab,
                             log2_t, margin, c_rand=NOISE_C_RAND,
                             c_bias=NOISE_C_BIAS, eps=None):
    """Per-tile detection threshold from running moments
    (``threshold="adaptive"``; ops/common.py:148-185 of the JAX package):
    the noise model of :func:`estimate_noise_floor` on one tile's sums
    ``s_a1 = sum a``, ``s_a2 = sum a^2`` over its ``n_a`` A elements so far
    (``s_b1``, ``s_b2``, ``n_b`` for B), at the accumulation length
    ``t_ab`` with the static full-run ``log2_t``:

        sigma = sqrt((s_a2 / n_a) (s_b2 / n_b)),  mu = (s_a1 / n_a) (s_b1 / n_b)
        margin * eps * (c_rand sqrt(t_ab) sigma + c_bias log2_t t_ab |mu|)

    saturated at ``THRESHOLD_CAP``. One formula for Python floats, numpy and
    torch (the kernels' plain versions); ``csrc/abft_common.cuh::
    variance_bound_threshold`` is the same formula in f32 on the card.
    """
    eps = F32_EPS if eps is None else eps
    mu_ab = (s_a1 / n_a) * (s_b1 / n_b)
    sigma = _sqrt((s_a2 / n_a) * (s_b2 / n_b))
    noise = eps * (c_rand * _sqrt(t_ab) * sigma
                   + c_bias * log2_t * t_ab * abs(mu_ab))
    cap = float(THRESHOLD_CAP)
    if isinstance(noise, torch.Tensor):
        return torch.clamp(margin * noise, max=cap)
    if isinstance(noise, np.ndarray):
        return np.minimum(margin * noise, cap)
    return min(margin * noise, cap)


def full_run_log2(nk: int, bk: int, bm: int, bn: int) -> float:
    """The static ``log2`` of an adaptive check's bias term: that of the
    full padded run's accumulation length ``nk * bk * max(bm, bn)``
    (ops/ft_sgemm.py:382-388 of the JAX package)."""
    return float(np.log2(max(float(nk * bk) * float(max(bm, bn)), 2.0)))


def _aug_rows(in_itemsize: int) -> int:
    """Sublane-aligned augmented-row count of one operand's checksum rows
    (ft_sgemm_tpu/configs.py:89-91), the unit of the cost model's mxu
    encode."""
    return {4: 8, 2: 16, 1: 32}[in_itemsize]


def gemm_cost_breakdown(m: int, n: int, k: int, in_itemsize: int, *,
                        block=None, strategy=None, multifault: bool = False,
                        check_every=None) -> dict:
    """Component-wise FLOPs / bytes of one ``C = alpha*A@B.T + beta*C``
    pass (ft_sgemm_tpu/ops/common.py:228-312, the same numbers): the plain
    GEMM (``base``) plus, for FT kernels, the checksum-``encode`` work and
    the detect/correct ``check`` epilogue. Returns ``{"flops_base",
    "flops_encode", "flops_check", "bytes_base", "bytes_encode",
    "bytes_check"}``; :func:`gemm_cost_estimate` sums it.

    - Encode flops: the vpu encode (``rowcol``, ``global``, ``weighted``)
      re-reduces each operand block once per grid step,
      ``3 k (streams_a n + streams_b m)``; the mxu encode (``fused``,
      ``*_mxu``) widens the product by the augmented rows,
      ``2 k (aug_a n + aug_b m)``, plus the wrapper's one-time reduction.
    - Check flops: ``2 streams m n`` per check, ``ceil(nk / check_every)``
      checks.
    - Bytes: A and B at ``in_itemsize``, C read and written in f32, the
      augmented rows, the precomp path's expected checksums and the
      per-tile counters.

    ``strategy`` takes the kernel-level value (``ops/ft_sgemm.
    resolve_kernel_strategy``; ``weighted`` with ``check_every >= nk`` is
    costed as the precomp body); ``None`` (plain callers) has no encode or
    check terms. ``block`` is ``(bm, bn, bk)``.
    """
    flops_base = 2 * m * n * k
    bytes_base = in_itemsize * (m * k + n * k) + 4 * 2 * m * n
    flops_encode = flops_check = bytes_encode = bytes_check = 0
    if strategy is not None:
        bm, bn, bk = block
        nk = max(1, -(-k // bk))
        ce = nk if check_every is None else max(1, min(check_every, nk))
        n_checks = -(-nk // ce)
        precomp = strategy == "weighted" and ce >= nk
        aug = _aug_rows(in_itemsize)
        if strategy in ("fused", "rowcol_mxu", "global_mxu"):
            aug_a = aug
            aug_b = aug if strategy in ("rowcol_mxu", "global_mxu") else 0
            flops_encode += 2 * k * (aug_a * n + aug_b * m)
            flops_encode += 2 * (aug_a * m * k // max(bm, 1)
                                 + aug_b * n * k // max(bn, 1))
            bytes_encode += in_itemsize * k * (
                aug_a * (m // bm) + aug_b * (n // bn))
        elif precomp:
            bytes_encode += 4 * 8 * (m // bm) * n
        else:
            streams_a = {"rowcol": 2 if multifault else 1,
                         "global": 1, "weighted": 3}[strategy]
            streams_b = 1
            flops_encode += 3 * k * (streams_a * n + streams_b * m)
        streams = {"rowcol": 3 if multifault else 2, "rowcol_mxu": 3,
                   "global": 1, "global_mxu": 1,
                   "weighted": 3, "fused": 3}.get(strategy, 2)
        flops_check += 2 * streams * m * n * n_checks
        bytes_check += 2 * 4 * (m // bm) * (n // bn)
    return {"flops_base": int(flops_base),
            "flops_encode": int(flops_encode),
            "flops_check": int(flops_check),
            "bytes_base": int(bytes_base),
            "bytes_encode": int(bytes_encode),
            "bytes_check": int(bytes_check)}


class CostEstimate(NamedTuple):
    """The three numbers of the JAX package's ``pl.CostEstimate``."""

    flops: int
    bytes_accessed: int
    transcendentals: int


def gemm_cost_estimate(m: int, n: int, k: int, in_itemsize: int, *,
                       block=None, strategy=None, multifault: bool = False,
                       check_every=None) -> CostEstimate:
    """FLOPs and bytes of one ``C = alpha*A@B.T + beta*C`` pass, the summed
    :func:`gemm_cost_breakdown` (ft_sgemm_tpu/ops/common.py:315-336): the
    ``pl.CostEstimate`` every ``pallas_call`` of the JAX package hands its
    scheduler, here a :class:`CostEstimate` for reports."""
    parts = gemm_cost_breakdown(
        m, n, k, in_itemsize, block=block, strategy=strategy,
        multifault=multifault, check_every=check_every)
    return CostEstimate(
        flops=(parts["flops_base"] + parts["flops_encode"]
               + parts["flops_check"]),
        bytes_accessed=(parts["bytes_base"] + parts["bytes_encode"]
                        + parts["bytes_check"]),
        transcendentals=0)

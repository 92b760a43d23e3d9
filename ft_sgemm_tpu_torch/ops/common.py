"""Helpers shared by the port's ops: device resolution, padding, the FP32
matmul setting, the correction-pad rule, the scalar argument, and the
clean-residual noise model behind ``threshold="auto"`` and
``threshold="adaptive"``.

Only what the port's kernels use of ``ft_sgemm_tpu/ops/common.py`` and
``ft_sgemm_tpu/ops/ft_sgemm.py`` lives here.
"""

from __future__ import annotations

import math

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
    inputs' moments, as a 0-d f32 tensor on the inputs' device (no host
    sync): the torch twin of ``estimate_noise_floor_jnp``
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

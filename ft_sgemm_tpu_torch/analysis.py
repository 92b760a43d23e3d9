"""Detection-rate and threshold-calibration analysis (the port's copy of
``ft_sgemm_tpu/analysis.py``).

Host-side estimates, on numpy arrays with no GEMM run and no device: the
closed-form noise floor behind ``threshold="auto"``
(:func:`estimate_noise_floor`) and the per-tile variance bound behind
``threshold="adaptive"`` (:func:`adaptive_threshold_estimate`,
:func:`adaptive_threshold_grid`); the tests hold the kernels' per-tile
thresholds against them. The adaptive twins take ``in_dtype``: bf16 and
fp8 operands count as their rounded values, as the kernels sum them.

Measurements that run the port (on the card by default, ``device="cpu"``
for the plain versions): :func:`measure_noise_floor`, the largest clean
checksum residual of the two-pass baseline (id 10);
:func:`calibrate_threshold`, that floor times a margin; and
:func:`detection_rate_sweep`, the FT kernels' detections and the output's
correctness as the fault magnitude sweeps across a threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ft_sgemm_tpu_torch.configs import KernelShape
from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.ops.abft_baseline import abft_baseline_sgemm
from ft_sgemm_tpu_torch.ops.common import (
    F32_EPS,
    NOISE_C_BIAS,
    NOISE_C_RAND,
    THRESHOLD_CAP,
    as_operand,
    resolve_in_dtype,
    variance_bound_threshold,
)
from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix


def _rounded(x, in_dtype) -> np.ndarray:
    """An A or B operand as the kernels see its values, f32: rounded to
    ``in_dtype`` as the entry points round it (``ops.common.as_operand``)
    and widened back exactly."""
    x = np.asarray(x, np.float32)
    dtype = resolve_in_dtype(in_dtype, allow_low_precision=True)
    if dtype == torch.float32:
        return x
    return as_operand(x, dtype, torch.device("cpu")).float().numpy()


def estimate_noise_floor(a, b, c=None, *, alpha: float = 1.0,
                         beta: float = -1.5) -> float:
    """Closed-form bound on the clean checksum-residual noise of
    ``alpha * A @ B.T + beta * C`` (``ft_sgemm_tpu/analysis.py:73``): the
    model of ``ops.common.estimate_noise_floor`` in numpy, means in float64.
    Pass ``c=None`` only when beta is 0."""
    a = np.asarray(a)
    b = np.asarray(b)
    (m, k), n = a.shape, b.shape[0]
    tmax = float(max(m, n))

    def rms(x):
        xf = np.asarray(x, np.float32)
        scale = max(float(np.max(np.abs(xf))), 1e-30)
        return scale * float(np.sqrt(np.mean(np.square(xf / scale))))

    def term(t, sigma, mu):
        return F32_EPS * (NOISE_C_RAND * np.sqrt(t) * sigma
                          + NOISE_C_BIAS * np.log2(max(t, 2.0)) * t * abs(mu))

    noise = abs(alpha) * term(
        float(k) * tmax, rms(a) * rms(b),
        float(np.mean(a, dtype=np.float64))
        * float(np.mean(b, dtype=np.float64)))
    if c is not None and beta != 0.0:
        cf = np.asarray(c, np.float32)
        noise += abs(beta) * term(tmax, rms(cf),
                                  float(np.mean(cf, dtype=np.float64)))
    elif beta != 0.0:
        raise ValueError(
            "estimate_noise_floor: pass c (or beta=0): the beta*C term"
            " contributes residual noise the bound must include")
    return float(min(noise, float(THRESHOLD_CAP)))


def adaptive_threshold_estimate(a, b, *, bm: int, bn: int,
                                margin: float = 8.0,
                                tile: Optional[tuple] = None,
                                in_dtype="float32"):
    """The adaptive kernels' threshold at the final check
    (``ft_sgemm_tpu/analysis.py:155``): the variance bound on the moments
    of one (bm, K) row tile of A and one (bn, K) row tile of B (``tile=(i,
    j)``; default the whole operands), in float64, of the operands rounded
    to ``in_dtype`` (``_rounded``). Returns ``(threshold, variance)``,
    ``variance`` the mean-square product ``E[a^2] E[b^2]``."""
    a, b = _rounded(a, in_dtype), _rounded(b, in_dtype)
    if tile is not None:
        i, j = tile
        a = a[i * bm:(i + 1) * bm]
        b = b[j * bn:(j + 1) * bn]
    k = a.shape[1]
    n_a = float(min(bm, a.shape[0]) * k)
    n_b = float(min(bn, b.shape[0]) * k)
    t_ab = float(k) * float(max(bm, bn))
    s_a2 = float(np.sum(np.square(a, dtype=np.float64)))
    s_b2 = float(np.sum(np.square(b, dtype=np.float64)))
    thr = variance_bound_threshold(
        float(np.sum(a, dtype=np.float64)), s_a2,
        float(np.sum(b, dtype=np.float64)), s_b2,
        n_a=n_a, n_b=n_b, t_ab=t_ab, log2_t=float(np.log2(max(t_ab, 2.0))),
        margin=margin)
    return float(thr), float((s_a2 / n_a) * (s_b2 / n_b))


def adaptive_threshold_grid(a, b, *, bm: int, bn: int,
                            k_cols: Optional[int] = None,
                            margin: float = 8.0, global_tile: bool = False,
                            in_dtype="float32"):
    """Every tile's adaptive threshold at the check that closes column
    ``k_cols`` (default all of K), as the kernels derive it
    (``ft_sgemm_tpu/ops/ft_sgemm.py:360-388``): tile (i, j) takes the sum
    and sum of squares of A's rows ``i*bm..`` and B's rows ``j*bn..`` over
    the first ``k_cols`` columns, counts ``k_cols * bm`` and ``k_cols * bn``
    elements (a partial band's zero rows included), the accumulation length
    ``k_cols * max(bm, bn)`` and the static log2 of the whole run's,
    ``K * max(bm, bn)``; ``global_tile`` scales by ``sqrt(bn)``, as the
    detect-only global check does. ``a`` (M, K) and ``b`` (N, K) as the
    kernels see them (K padded to the tile's bk); sums in float64. At
    ``k_cols = K`` tile (i, j) is :func:`adaptive_threshold_estimate` with
    ``tile=(i, j)`` on operands padded to whole bands. bf16 and fp8
    (``in_dtype``) operands count as their rounded values (``_rounded``).
    Returns the (ceil(M / bm), ceil(N / bn)) float64 grid."""
    a, b = _rounded(a, in_dtype), _rounded(b, in_dtype)
    k = a.shape[1]
    tk = k if k_cols is None else int(k_cols)

    def band_sums(x, rows):
        x = x[:, :tk].astype(np.float64)
        x = np.pad(x, ((0, -x.shape[0] % rows), (0, 0))).reshape(-1, rows * tk)
        return x.sum(1), np.square(x).sum(1)

    (sa1, sa2), (sb1, sb2) = band_sums(a, bm), band_sums(b, bn)
    tmax = float(max(bm, bn))
    thr = variance_bound_threshold(
        sa1[:, None], sa2[:, None], sb1[None, :], sb2[None, :],
        n_a=float(tk * bm), n_b=float(tk * bn), t_ab=float(tk) * tmax,
        log2_t=float(np.log2(max(float(k) * tmax, 2.0))), margin=margin)
    return thr * np.sqrt(float(bn)) if global_tile else thr


def measure_noise_floor(a, b, c, *, alpha: float = 1.0, beta: float = -1.5,
                        panel_k: int = 256, precision: str = "highest",
                        in_dtype="float32", device=None) -> float:
    """Max |checksum residual| of a clean run on the given inputs
    (``ft_sgemm_tpu/analysis.py:41``), from the two-pass baseline (id 10),
    whose residuals are outputs: full-matrix row and column sums in f32,
    the worst case of the fused kernels' per-tile residuals. ``precision``
    as :func:`ops.common.check_precision`: f32 ``"default"`` measures the
    floor of one-TF32-pass products (the baseline's products at that
    precision, as the JAX package passes it on)."""
    res = abft_baseline_sgemm(a, b, c, alpha, beta, panel_k=panel_k,
                              precision=precision, in_dtype=in_dtype,
                              threshold=float("inf"), device=device)
    return float(max(res.max_row_residual, res.max_col_residual))


@dataclasses.dataclass(frozen=True)
class ThresholdCalibration:
    noise_floor: float        # max clean residual observed
    threshold: float          # noise_floor * margin
    min_detectable: float     # smallest reliably detectable |fault|:
                              # |fault| - noise > threshold => 2x threshold
    margin: float

    def spec_like(self, K: int, bk: int, magnitude: Optional[float] = None,
                  **kw) -> InjectionSpec:
        """The reference-like schedule at (by default) the minimum
        detectable magnitude: the hardest faults this calibration still
        catches."""
        return InjectionSpec.reference_like(
            K, bk, magnitude=self.min_detectable if magnitude is None
            else magnitude, **kw)


def calibrate_threshold(a, b, c, *, alpha: float = 1.0, beta: float = -1.5,
                        margin: float = 8.0, precision: str = "highest",
                        in_dtype="float32", device=None
                        ) -> ThresholdCalibration:
    """The smallest safe threshold for the given inputs
    (``ft_sgemm_tpu/analysis.py:219``): ``margin`` times the measured
    noise floor (:func:`measure_noise_floor`); a fault is reliably
    detectable at twice that."""
    floor = measure_noise_floor(a, b, c, alpha=alpha, beta=beta,
                                precision=precision, in_dtype=in_dtype,
                                device=device)
    thr = float(max(floor, np.finfo(np.float32).tiny) * margin)
    return ThresholdCalibration(noise_floor=floor, threshold=thr,
                                min_detectable=2.0 * thr, margin=margin)


@dataclasses.dataclass(frozen=True)
class DetectionPoint:
    magnitude: float
    expected_faults: int      # faults injected over the whole run
    detected: int             # faults the kernel reported
    detection_rate: float     # detected / expected
    output_correct: bool      # the corrected C passes verify_matrix
                              # (global: C keeps the faults, so False once
                              # the magnitude breaks the tolerance)


def detection_rate_sweep(
    a, b, c,
    magnitudes: Sequence[float],
    shape: KernelShape | str = "huge",
    *,
    strategy: str = "rowcol",
    threshold: float | str = REFERENCE_THRESHOLD,
    alpha: float = 1.0,
    beta: float = -1.5,
    num_faults: int = 4,
    precision: str = "highest",
    in_dtype="float32",
    device=None,
) -> list:
    """Detections and output correctness as the fault magnitude sweeps the
    threshold (``ft_sgemm_tpu/analysis.py:253``). Per magnitude: a
    reference-like schedule of ``num_faults`` faults per C tile, the
    kernels' detections, and C against the oracle of the same input mode
    (``verify_matrix``). Magnitudes below the threshold are designed
    misses; above it every fault must be caught. A named shape is the
    port's tile (the JAX package's bf16 tile overrides are TPU tuning).
    ``precision`` goes to the kernels (``make_ft_sgemm``)."""
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    k = a.shape[1]
    want = sgemm_reference(a, b, c, alpha, beta, in_dtype=in_dtype,
                           device=device)
    ft = make_ft_sgemm(shape, alpha=alpha, beta=beta, strategy=strategy,
                       threshold=threshold, precision=precision,
                       in_dtype=in_dtype, device=device)
    tile = ft.shape_config
    tiles = -(-a.shape[0] // tile.bm) * -(-b.shape[0] // tile.bn)
    points = []
    for mag in magnitudes:
        inj = InjectionSpec.reference_like(k, tile.bk, num_faults=num_faults,
                                           magnitude=float(mag))
        expected = inj.expected_faults(k, tile.bk) * tiles
        res = ft(a, b, c, inj)
        detected = int(res.num_detected)
        ok, _, _ = verify_matrix(want, res.c, verbose=False)
        points.append(DetectionPoint(
            magnitude=float(mag), expected_faults=expected,
            detected=detected,
            detection_rate=detected / expected if expected else 0.0,
            output_correct=bool(ok)))
    return points

"""Host-side threshold estimates (the port's copy of the two numpy twins in
``ft_sgemm_tpu/analysis.py``): the closed-form noise floor behind
``threshold="auto"`` and the per-tile variance bound behind
``threshold="adaptive"``, evaluated on numpy arrays with no GEMM run and
no device. The tests hold the kernels' per-tile thresholds against them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ft_sgemm_tpu_torch.ops.common import (
    F32_EPS,
    NOISE_C_BIAS,
    NOISE_C_RAND,
    THRESHOLD_CAP,
    variance_bound_threshold,
)


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
                                tile: Optional[tuple] = None):
    """The adaptive kernels' threshold at the final check
    (``ft_sgemm_tpu/analysis.py:155``): the variance bound on the moments
    of one (bm, K) row tile of A and one (bn, K) row tile of B (``tile=(i,
    j)``; default the whole operands), in float64. Returns ``(threshold,
    variance)``, ``variance`` the mean-square product ``E[a^2] E[b^2]``."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
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
                            margin: float = 8.0, global_tile: bool = False):
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
    ``tile=(i, j)`` on operands padded to whole bands. Returns the
    (ceil(M / bm), ceil(N / bn)) float64 grid."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
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

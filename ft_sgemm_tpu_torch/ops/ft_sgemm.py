"""Fused online-ABFT SGEMM: kernels B2, B5 (``csrc/ft_sgemm_weighted.cu``),
B3 (``csrc/ft_sgemm_rowcol.cu``), B4, B8 (``csrc/ft_sgemm_global.cu``) and
B6, B7 (``csrc/ft_sgemm_aug.cu``), behind kernel ids 11-16. B3-B8 run one
128 x 128 CTA over the paper's (bm, bn) tile as sub-tiles
(``csrc/ft_sgemm_running.cuh``): the grids, cadence and fault placement
stay per (bm, bn) tile, as the JAX grid is; padding stays at (bm, bn).

Port of ``ft_sgemm_tpu/ops/ft_sgemm.py`` in f32, under the three threshold
modes: ``"static"`` (one threshold, the reference's 9500 by default),
``"auto"`` (one threshold per call from the inputs' moments, reduced by
torch ops on the inputs' device and read back into the same kernels'
scalar argument) and ``"adaptive"`` (each tile's threshold at each check
from its running moments, inside B3-B8 as built with ``FTSG_ADAPTIVE``).
Each kernel encodes, accumulates, injects, detects and corrects inside one
launch, as the Pallas kernels do (module docstring there):

  - ``weighted`` (default): column checksums with weights 1, w, w^2
    (w = row + 1); the weighted-residual ratio localizes each flagged
    column's fault row, the w^2 moment re-checks the correction. At its
    default cadence (one final check) the expected moments are
    precomputed by one FP32 matmul outside the kernel
    (``_expected_col_checksums``) and B2 runs; a cadence with intermediate
    checks runs B5, which encodes them as running sums.
  - ``rowcol`` (reference parity): row and column checksums encoded per K
    step, corrections at flagged row/column intersections every
    ``check_every`` steps, and the multifault weighted localization when
    the intersection is ambiguous (B3).
  - ``global``: one scalar checksum per tile, detect only (B4): each check
    counts an EVENT when the residual moved by more than the threshold
    since the previous check; ``uncorrectable`` equals ``detections``.
  - ``fused``: the weighted check at any cadence, its expected moments
    encoded from A's moment rows (B6); the same kernel runs ``weighted``
    with ``encode="mxu"``.

``encode="mxu"`` (``configs.ENCODE_MODES``) forms the expected checksums
from the operands' checksum-moment rows (``_tile_moments``, torch ops in
the wrapper, as XLA ops in the reference) instead of summing the staged
operand chunks in the kernel: B6 (weighted / fused), B7 (rowcol) and B8
(global). On the TPU those rows were appended to the operand blocks so one
MXU dot yielded the product and the checksums; on Hopper the kernels load
them by TMA as more boxes of each pipeline stage (A's as the moment rows of
the expected column sums, B's as the extra rows of B's stage that give the
expected row sums), which removes the in-kernel sums of A and B. B8 reads
only B's rows; its A rows are built for its plain version.

Beside each kernel wrapper is its plain PyTorch version, which follows the
tile algorithm over all tiles at once (batched (gm, gn, bm, bn) tensors,
a Python loop over K steps only): the same inject positions, cadence,
residuals, localization and LEVEL counts. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ft_sgemm_tpu_torch.configs import SHAPES, KernelShape, check_kernel_legality
from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.ops._build import bind, build, check_launch, check_operands, library
from ft_sgemm_tpu_torch.ops.common import (
    DEFAULT_THRESHOLD_MARGIN,
    NOISE_C_BIAS,
    NOISE_C_RAND,
    THRESHOLD_CAP,
    as_f32,
    correction_pads,
    estimate_noise_floor,
    full_run_log2,
    pad_to,
    resolve_device,
    scalar_operand,
    strict_fp32,
    variance_bound_threshold,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

FT_LIBS = ("ft_sgemm_weighted", "ft_sgemm_rowcol", "ft_sgemm_global",
           "ft_sgemm_aug")


class FtSgemmResult(NamedTuple):
    """Output of a fused-ABFT GEMM (``ft_sgemm_tpu/ops/ft_sgemm.py::FtSgemmResult``).

    ``detections`` (grid_m, grid_n) int32: corrected accumulator elements
    per C tile, summed over checks (``global``: fault events, see the
    module docstring). ``uncorrectable`` (grid_m, grid_n) int32: checksum
    residuals still above threshold after the LAST check's correction (a
    level, not a sum) — nonzero means the tile may still be corrupted and
    the caller must re-run. The detect-only ``global`` strategy corrects
    nothing, so there every detection is uncorrectable.
    """

    c: torch.Tensor
    detections: torch.Tensor
    uncorrectable: torch.Tensor

    @property
    def num_detected(self) -> torch.Tensor:
        return self.detections.sum()

    @property
    def num_uncorrectable(self) -> torch.Tensor:
        return self.uncorrectable.sum()


# --------------------------------------------------------------------------
# Wrapper-side prep (torch ops, as in the JAX package)
# --------------------------------------------------------------------------


def _weights(bm: int, device) -> torch.Tensor:
    """Row weights w = row + 1 of one tile, (bm,) f32."""
    return torch.arange(1, bm + 1, dtype=torch.float32, device=device)


def _tile_moments(ap: torch.Tensor, bm: int, n_moments: int = 3) -> torch.Tensor:
    """(g, n_moments, K): the first ``n_moments`` of the plain, w and w^2
    column moments of each (bm, K) row tile of a padded operand
    (ops/ft_sgemm.py:1167-1200, f32 path). A gives 3 (B2's expectations,
    B6), 2 (B7) or 1 (B8); B gives 1 (B7, B8)."""
    m, kdim = ap.shape
    af = ap.reshape(m // bm, bm, kdim)
    w = _weights(bm, ap.device)[None, :, None]
    rows = [af.sum(1)]
    if n_moments >= 2:
        rows.append((af * w).sum(1))
    if n_moments >= 3:
        rows.append((af * (w * w)).sum(1))
    return torch.stack(rows, 1)


def _expected_col_checksums(ap: torch.Tensor, bp: torch.Tensor, bm: int
                            ) -> torch.Tensor:
    """(gm, 3, N) expected plain / w / w^2 column checksums of every output
    tile, ``moments(A_i) @ B.T`` (ops/ft_sgemm.py:1224-1256) — one FP32
    ``torch.matmul`` over the stacked moment rows, as XLA's dot was."""
    strict_fp32()
    rows = _tile_moments(ap, bm)
    gm, r, kdim = rows.shape
    return torch.matmul(rows.reshape(gm * r, kdim), bp.T).reshape(gm, r, -1)


def kernel_inputs(kind: str, ap: torch.Tensor, bp: torch.Tensor,
                  shape: KernelShape) -> tuple:
    """The wrapper-side inputs of one launch of ``kind`` (see :func:`_plan`)
    on the padded operands: B2's expected moments, the mxu kernels' moment
    rows (A's 3 for B6, A's 2 and B's 1 for B7, A's 1 and B's 1 for B8);
    none for the others."""
    if kind == "precomp":
        return (_expected_col_checksums(ap, bp, shape.bm),)
    n_a = {"fused": 3, "rowcol_mxu": 2, "global_mxu": 1}.get(kind)
    if n_a is None:
        return ()
    rows = (_tile_moments(ap, shape.bm, n_a),)
    if kind != "fused":
        rows += (_tile_moments(bp, shape.bn, 1),)
    return rows


# --------------------------------------------------------------------------
# Plain versions (tile algorithm over batched tiles)
# --------------------------------------------------------------------------


def _tiles(ap, bp, cp, shape):
    """Padded operands as per-step tile stacks: A (gm, bm, nk, bk),
    B (gn, bn, nk, bk), C (gm, gn, bm, bn)."""
    bm, bn, bk = shape.block
    (m, k), n = ap.shape, bp.shape[0]
    gm, gn, nk = m // bm, n // bn, k // bk
    a4 = ap.reshape(gm, bm, nk, bk)
    b4 = bp.reshape(gn, bn, nk, bk)
    c4 = cp.reshape(gm, bm, gn, bn).permute(0, 2, 1, 3)
    return a4, b4, c4, nk


def _step_rows(rows, nk: int):
    """Moment rows (g, R, K) as (g, R, nk, bk): step k's rows are
    ``[:, :, k]``."""
    g, r, kdim = rows.shape
    return rows.reshape(g, r, nk, kdim // nk)


def _untile(t4: torch.Tensor) -> torch.Tensor:
    gm, gn, bm, bn = t4.shape
    return t4.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)


def _inject_plain(acc, scalars, k: int) -> None:
    """``_inject`` for every tile at step ``k``: the ordinal
    k//every + 3i + 5j picks row (131*ord + 7) % bm and column
    (col_stride*ord + 3) % bn of tile (i, j)."""
    every = max(int(scalars[1]), 1)
    if not scalars[0] > 0.0 or k % every:
        return
    gm, gn, bm, bn = acc.shape
    ii = torch.arange(gm, device=acc.device)[:, None]
    jj = torch.arange(gn, device=acc.device)[None, :]
    ordinal = k // every + 3 * ii + 5 * jj
    rows = (ordinal * 131 + 7) % bm
    cols = (ordinal * int(scalars[3]) + 3) % bn
    acc[ii, jj, rows, cols] += float(scalars[2])


def _accumulate_moments(mom, a_k, b_k) -> list:
    """``_accumulate_moments`` (ops/ft_sgemm.py:394-403) of one K step for
    every tile: the running [sum a, sum a^2] of each (bm, bk) A block, (gm,),
    and [sum b, sum b^2] of each (bn, bk) B block, (gn,), added to ``mom``
    (None before the first step)."""
    step = (a_k.sum((1, 2)), (a_k * a_k).sum((1, 2)), b_k.sum((1, 2)),
            (b_k * b_k).sum((1, 2)))
    return list(step) if mom is None else [m + x for m, x in zip(mom, step)]


def _adaptive_threshold(mom, k: int, shape: KernelShape, nk: int, margin,
                        global_tile: bool = False) -> torch.Tensor:
    """``_adaptive_threshold`` (ops/ft_sgemm.py:360-391) of every tile at
    the check after K step ``k``: the variance bound on the running sums
    ``mom`` = [sum a (gm,), sum a^2, sum b (gn,), sum b^2] over tk = (k + 1)
    bk columns (n_a = tk bm, n_b = tk bn: a padded tile's zero rows count),
    at accumulation length tk max(bm, bn) with the full padded run's static
    log2; times sqrt(bn) for the global check. (gm, gn)."""
    bm, bn, bk = shape.block
    tk = float((k + 1) * bk)
    thr = variance_bound_threshold(
        mom[0][:, None], mom[1][:, None], mom[2][None, :], mom[3][None, :],
        n_a=tk * bm, n_b=tk * bn, t_ab=tk * max(bm, bn),
        log2_t=full_run_log2(nk, bk, bm, bn), margin=margin)
    return thr * float(np.sqrt(bn)) if global_tile else thr


def _recheck_thresholds(thr, bm: int) -> tuple:
    """The detection threshold and the w and w^2 re-checks' from one
    adaptive threshold (gm, gn): thr, thr bm / sqrt(3), thr bm^2 / sqrt(5),
    each (gm, gn, 1) against a tile's residuals."""
    thr = thr[..., None]
    return (thr, thr * float(bm / np.sqrt(3.0)),
            thr * float(bm ** 2 / np.sqrt(5.0)))


def _weighted_localize(res_c, res_cw, det_c, bm: int) -> torch.Tensor:
    """(..., bm, bn) mask of the element to correct in each flagged column:
    row ``round(res_cw / res_c) - 1`` (torch.round is half to even, like
    jnp.round) — exact while a column holds one fault."""
    safe = torch.where(det_c, res_c, torch.ones_like(res_c))
    loc = torch.round(res_cw / safe).to(torch.int64) - 1
    rows = torch.arange(bm, device=res_c.device)[:, None]
    return det_c[..., None, :] & (rows == loc[..., None, :])


def _moment_detect_correct(acc, exp_c, exp_cw, exp_cw2, thresholds):
    """``_moment_detect_correct`` over tiles: returns (corrected acc,
    per-tile hits, per-tile uncorrectable level)."""
    thr, thr_m1, thr_m2 = thresholds
    bm = acc.shape[-2]
    w = _weights(bm, acc.device)[:, None]
    w2 = w * w
    res_c = exp_c - acc.sum(-2)
    res_cw = exp_cw - (acc * w).sum(-2)
    csw2 = (acc * w2).sum(-2)
    det_c = res_c.abs() > thr
    hit = _weighted_localize(res_c, res_cw, det_c, bm)
    delta = torch.where(hit, res_c[..., None, :], torch.zeros_like(acc))
    res_c2 = res_c - delta.sum(-2)
    res_cw2 = res_cw - (delta * w).sum(-2)
    res_cm2 = exp_cw2 - csw2 - (delta * w2).sum(-2)
    pad, pad_w, pad_w2 = correction_pads(delta, -2, w, w2)
    bad = ((res_c2.abs() > thr + pad) | (res_cw2.abs() > thr_m1 + pad_w)
           | (res_cm2.abs() > thr_m2 + pad_w2))
    return acc + delta, hit.sum((-2, -1)), bad.sum(-1)


def _rowcol_detect_correct(acc, res_r, res_c, res_cw, thresholds,
                           multifault: bool):
    """``_rowcol_detect_correct`` over tiles: returns (corrected acc,
    per-tile hits, per-tile uncorrectable level)."""
    thr, thr_m1 = thresholds[:2]
    bm = acc.shape[-2]
    det_r = res_r.abs() > thr                        # (gm, gn, bm)
    det_c = res_c.abs() > thr                        # (gm, gn, bn)
    hit = det_r[..., :, None] & det_c[..., None, :]
    nr, nc = det_r.sum(-1), det_c.sum(-1)
    # One flagged row and several flagged columns: the column residuals
    # carry the per-fault values.
    use_col = ((nr == 1) & (nc > 1))[..., None, None]
    corr = torch.where(use_col, res_c[..., None, :].expand_as(acc),
                       res_r[..., :, None].expand_as(acc))
    w = _weights(bm, acc.device)[:, None]
    if multifault:
        # >1 row AND >1 column flagged: localize each column's fault row by
        # the weighted-residual ratio instead.
        ambiguous = ((nr > 1) & (nc > 1))[..., None, None]
        hit = torch.where(ambiguous, _weighted_localize(res_c, res_cw, det_c, bm),
                          hit)
        corr = torch.where(ambiguous, res_c[..., None, :].expand_as(acc), corr)
    delta = torch.where(hit, corr, torch.zeros_like(acc))
    res_r2 = res_r - delta.sum(-1)
    res_c2 = res_c - delta.sum(-2)
    (pad_r,) = correction_pads(delta, -1)
    (pad_c,) = correction_pads(delta, -2)
    bad_c = res_c2.abs() > thr + pad_c
    bad = (res_r2.abs() > thr + pad_r).sum(-1) + bad_c.sum(-1)
    if multifault:
        res_cw2 = res_cw - (delta * w).sum(-2)
        _, pad_w = correction_pads(delta, -2, w)
        bad = bad + ((res_cw2.abs() > thr_m1 + pad_w) & ~bad_c).sum(-1)
    return acc + delta, hit.sum((-2, -1)), bad


def ft_weighted_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                      check_every: Optional[int] = None, expm=None,
                      moments=None, adaptive: bool = False):
    """Plain PyTorch version of B2 (``expm`` given: precomputed moments, one
    final check), B5 (running moments from the operand, a check every
    ``check_every`` steps and after the last) and B6 (``moments`` given:
    running moments from A's (gm, 3, K) moment rows); ``adaptive``: each
    tile's thresholds at each check from its running moments of A's and B's
    own rows (B5, B6). Returns (out, det, unc)."""
    strict_fp32()
    a4, b4, c4, nk = _tiles(a, b, c, shape)
    gm, gn, bm, bn = c4.shape
    acc = torch.zeros_like(c4)
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    unc = torch.zeros_like(det)
    w = _weights(bm, a.device)[None, :, None]
    exps = [torch.zeros((gm, gn, bn), device=a.device) for _ in range(3)]
    if expm is not None:
        exps = list(expm.reshape(gm, 3, gn, bn).unbind(1))
        check_every = nk
    if moments is not None:
        moments = _step_rows(moments, nk)
    thresholds = [float(t) for t in scalars[4:7]]
    mom = None
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        acc += torch.einsum("imk,jnk->ijmn", a_k, b_k)
        if expm is None:
            s_a = (moments[:, :, k].unbind(1) if moments is not None else
                   (a_k.sum(1), (a_k * w).sum(1), (a_k * (w * w)).sum(1)))
            for e, s in zip(exps, s_a):
                e += torch.einsum("jnk,ik->ijn", b_k, s)
        if adaptive:
            mom = _accumulate_moments(mom, a_k, b_k)
        if (k + 1) % check_every == 0 or k == nk - 1:
            if adaptive:
                thresholds = _recheck_thresholds(_adaptive_threshold(
                    mom, k, shape, nk, float(scalars[7])), bm)
            acc, hits, bad = _moment_detect_correct(acc, *exps, thresholds)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
    return _untile(alpha * acc + beta * c4), det, unc


def ft_rowcol_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, multifault: bool, moments=None,
                    adaptive: bool = False):
    """Plain PyTorch version of B3 and, with ``moments`` = (A's (gm, 2, K),
    B's (gn, 1, K) moment rows), of B7; ``adaptive``: each tile's
    thresholds at each check from its running moments of A's and B's own
    rows. Returns (out, det, unc)."""
    strict_fp32()
    a4, b4, c4, nk = _tiles(a, b, c, shape)
    gm, gn, bm, bn = c4.shape
    acc = torch.zeros_like(c4)
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    unc = torch.zeros_like(det)
    w = _weights(bm, a.device)
    r_exp = torch.zeros((gm, gn, bm), device=a.device)
    c_exp = torch.zeros((gm, gn, bn), device=a.device)
    cw_exp = torch.zeros_like(c_exp)
    if moments is not None:
        ma, mb = (_step_rows(m, nk) for m in moments)
    thresholds = [float(t) for t in scalars[4:6]]
    mom = None
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        acc += torch.einsum("imk,jnk->ijmn", a_k, b_k)
        if moments is None:
            s_a, s_b = a_k.sum(1), b_k.sum(1)
        else:
            s_a, s_b = ma[:, 0, k], mb[:, 0, k]
        r_exp += torch.einsum("imk,jk->ijm", a_k, s_b)
        c_exp += torch.einsum("jnk,ik->ijn", b_k, s_a)
        if multifault:
            s_aw = ((a_k * w[None, :, None]).sum(1) if moments is None
                    else ma[:, 1, k])
            cw_exp += torch.einsum("jnk,ik->ijn", b_k, s_aw)
        if adaptive:
            mom = _accumulate_moments(mom, a_k, b_k)
        if (k + 1) % check_every == 0 or k == nk - 1:
            if adaptive:
                thresholds = _recheck_thresholds(_adaptive_threshold(
                    mom, k, shape, nk, float(scalars[7])), bm)[:2]
            res_cw = cw_exp - (acc * w[:, None]).sum(-2) if multifault else None
            acc, hits, bad = _rowcol_detect_correct(
                acc, r_exp - acc.sum(-1), c_exp - acc.sum(-2), res_cw,
                thresholds, multifault)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
    return _untile(alpha * acc + beta * c4), det, unc


def ft_global_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, moments=None, adaptive: bool = False):
    """Plain PyTorch version of B4 and, with ``moments`` = (A's (gm, 1, K),
    B's (gn, 1, K) plain moment rows), of B8: per step ``t_exp += s_a .
    s_b``; per check the residual ``t_exp - sum(acc)``, one event when it
    moved by more than the threshold since the previous check; ``adaptive``:
    each tile's threshold at each check from its running moments of A's and
    B's own rows, times sqrt(bn). Returns (out, det, unc) with unc equal to
    det."""
    strict_fp32()
    a4, b4, c4, nk = _tiles(a, b, c, shape)
    gm, gn = c4.shape[:2]
    acc = torch.zeros_like(c4)
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    t_exp = torch.zeros((gm, gn), device=a.device)
    prev = torch.zeros_like(t_exp)
    if moments is not None:
        ma, mb = (_step_rows(m, nk) for m in moments)
    thr = float(scalars[4])
    mom = None
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        acc += torch.einsum("imk,jnk->ijmn", a_k, b_k)
        if moments is None:
            s_a, s_b = a_k.sum(1), b_k.sum(1)
        else:
            s_a, s_b = ma[:, 0, k], mb[:, 0, k]
        t_exp += s_a @ s_b.T
        if adaptive:
            mom = _accumulate_moments(mom, a_k, b_k)
        if (k + 1) % check_every == 0 or k == nk - 1:
            if adaptive:
                thr = _adaptive_threshold(mom, k, shape, nk,
                                          float(scalars[7]), global_tile=True)
            res = t_exp - acc.sum((-2, -1))
            det += ((res - prev).abs() > thr).to(torch.int32)
            prev = res
    return _untile(alpha * acc + beta * c4), det, det.clone()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entries(adaptive: bool = False):
    """The C entry points of the static build (``adaptive=False``: B2-B8) or
    of the adaptive build (``FTSG_ADAPTIVE``: B3-B8), by kernel kind."""
    libs = tuple(n + ("_adaptive" if adaptive else "") for n in FT_LIBS)
    build(libs)  # all in parallel, before the first load
    weighted, rowcol, glob, aug = (library(n) for n in libs)
    dims = [_I] * 6  # M, N, K, bm, bn, bk
    # alpha, beta, the scalar argument, the noise model, the stream
    tail = [_F, _F, _P, _F, _F, _F, _P]
    entries = {
        "running": bind(weighted, "ftsg_ft_weighted_running",
                        [_P] * 6 + dims + [_I] + tail),
        "rowcol": bind(rowcol, "ftsg_ft_rowcol",
                       [_P] * 6 + dims + [_I, _I] + tail),
        "global": bind(glob, "ftsg_ft_global", [_P] * 6 + dims + [_I] + tail),
        "global_mxu": bind(glob, "ftsg_ft_global_mxu",
                           [_P] * 8 + dims + [_I] + tail),
        "fused": bind(aug, "ftsg_ft_fused", [_P] * 7 + dims + [_I] + tail),
        "rowcol_mxu": bind(aug, "ftsg_ft_rowcol_mxu",
                           [_P] * 8 + dims + [_I, _I] + tail),
    }
    if not adaptive:
        entries["precomp"] = bind(weighted, "ftsg_ft_weighted_precomp",
                                  [_P] * 7 + dims + [_F, _F, _P, _P])
    return entries


def _check_rows(shape, a, b, ma, mb=None, n_a=1) -> None:
    """The moment-row operands of an mxu kernel: A's (M/bm, n_a, K) and
    B's (N/bn, 1, K)."""
    (m, k), n = a.shape, b.shape[0]
    for rows, want in ((ma, (m // shape.bm, n_a, k)), (mb, (n // shape.bn, 1, k))):
        if rows is not None and tuple(rows.shape) != want:
            raise ValueError(f"moment rows {tuple(rows.shape)}, expected {want}")


def _launch(wrapper, name, shape, a, b, c, extra_in, extra_args, alpha, beta,
            scalars, adaptive=False):
    """Launch entry point ``name`` of the static or the adaptive build on
    validated operands and count it on ``wrapper`` (``launches``, or
    ``adaptive_launches``); raises on a launch error. Returns (out, det,
    unc)."""
    dims = check_operands(shape, a, b, c, *extra_in)
    sc = np.ascontiguousarray(scalars, np.float32)  # taken by value
    if sc.shape != (8,):
        raise ValueError(f"the scalar argument has 8 slots, got {sc.shape}")
    out = torch.empty_like(c)
    grid = (c.shape[0] // shape.bm, c.shape[1] // shape.bn)
    det = torch.empty(grid, dtype=torch.int32, device=c.device)
    unc = torch.empty_like(det)
    fn = _entries(adaptive)[name]
    noise = () if name == "precomp" else (
        full_run_log2(a.shape[1] // shape.bk, shape.bk, shape.bm, shape.bn),
        NOISE_C_RAND, NOISE_C_BIAS)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
            *(t.data_ptr() for t in extra_in), out.data_ptr(), det.data_ptr(),
            unc.data_ptr(), *dims, *extra_args, alpha, beta, sc.ctypes.data,
            *noise, torch.cuda.current_stream(a.device).cuda_stream)
    if adaptive:
        wrapper.adaptive_launches += 1
    else:
        wrapper.launches += 1
    check_launch(rc, fn.__name__ + (" (adaptive build)" if adaptive else ""))
    return out, det, unc


def ft_weighted_kernel(a, b, c, expm, shape: KernelShape, alpha, beta,
                       scalars):
    """B2 on operands padded to the tile, with the (gm, 3, N) expected
    moments ``expm``; ``scalars`` the (8,) f32 scalar argument, a host array
    (the plain versions also take a CPU tensor). Returns (out, det, unc). A
    CPU tensor runs the plain version."""
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 expm=expm)
    return _launch(ft_weighted_kernel, "precomp", shape, a, b, c, (expm,), (),
                   alpha, beta, scalars)


def ft_weighted_running_kernel(a, b, c, shape: KernelShape, alpha, beta,
                               scalars, check_every: int, adaptive=False):
    """B5: the weighted check every ``check_every`` K steps and after the
    last, with running in-kernel moments; ``adaptive`` runs the adaptive
    build (each sub-tile's thresholds from its running moments and slot
    7's margin). Returns (out, det, unc)."""
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 check_every=check_every, adaptive=adaptive)
    return _launch(ft_weighted_running_kernel, "running", shape, a, b, c, (),
                   (check_every,), alpha, beta, scalars, adaptive)


def ft_rowcol_kernel(a, b, c, shape: KernelShape, alpha, beta, scalars,
                     check_every: int, multifault: bool, adaptive=False):
    """B3: the rowcol check every ``check_every`` K steps and after the
    last (``adaptive``: as B5). Returns (out, det, unc)."""
    if a.device.type == "cpu":
        return ft_rowcol_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, multifault, adaptive=adaptive)
    return _launch(ft_rowcol_kernel, "rowcol", shape, a, b, c, (),
                   (check_every, int(multifault)), alpha, beta, scalars,
                   adaptive)


def ft_global_kernel(a, b, c, shape: KernelShape, alpha, beta, scalars,
                     check_every: int, adaptive=False):
    """B4: the detect-only scalar check every ``check_every`` K steps and
    after the last, encoded from the staged chunks (``adaptive``: as B5).
    Returns (out, det, unc), unc equal to det."""
    if a.device.type == "cpu":
        return ft_global_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, adaptive=adaptive)
    return _launch(ft_global_kernel, "global", shape, a, b, c, (),
                   (check_every,), alpha, beta, scalars, adaptive)


def ft_global_mxu_kernel(a, b, c, ma, mb, shape: KernelShape, alpha, beta,
                         scalars, check_every: int, adaptive=False):
    """B8: B4's check with ``t_exp`` from A's and B's plain moment rows
    ``ma`` (M/bm, 1, K) and ``mb`` (N/bn, 1, K) (``adaptive``: as B5, the
    moments of A's and B's own rows). Returns (out, det, unc)."""
    _check_rows(shape, a, b, ma, mb)
    if a.device.type == "cpu":
        return ft_global_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, moments=(ma, mb),
                               adaptive=adaptive)
    return _launch(ft_global_mxu_kernel, "global_mxu", shape, a, b, c,
                   (ma, mb), (check_every,), alpha, beta, scalars, adaptive)


def ft_fused_kernel(a, b, c, ma, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, adaptive=False):
    """B6: B5's weighted check every ``check_every`` K steps and after the
    last, the expected moments encoded from A's moment rows ``ma``
    (M/bm, 3, K) (``adaptive``: as B8). Returns (out, det, unc)."""
    _check_rows(shape, a, b, ma, n_a=3)
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 check_every=check_every, moments=ma,
                                 adaptive=adaptive)
    return _launch(ft_fused_kernel, "fused", shape, a, b, c, (ma,),
                   (check_every,), alpha, beta, scalars, adaptive)


def ft_rowcol_mxu_kernel(a, b, c, ma, mb, shape: KernelShape, alpha, beta,
                         scalars, check_every: int, multifault: bool,
                         adaptive=False):
    """B7: B3's rowcol check, the expected sums encoded from A's plain and
    w moment rows ``ma`` (M/bm, 2, K) and B's plain rows ``mb``
    (N/bn, 1, K) (``adaptive``: as B8). Returns (out, det, unc)."""
    _check_rows(shape, a, b, ma, mb, n_a=2)
    if a.device.type == "cpu":
        return ft_rowcol_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, multifault, moments=(ma, mb),
                               adaptive=adaptive)
    return _launch(ft_rowcol_mxu_kernel, "rowcol_mxu", shape, a, b, c,
                   (ma, mb), (check_every, int(multifault)), alpha, beta,
                   scalars, adaptive)


for _w in (ft_weighted_kernel, ft_weighted_running_kernel, ft_rowcol_kernel,
           ft_global_kernel, ft_global_mxu_kernel, ft_fused_kernel,
           ft_rowcol_mxu_kernel):
    _w.launches = 0
    _w.adaptive_launches = 0


def run_kernel(kind: str, shape: KernelShape, a, b, c, extra, alpha, beta,
               scalars, check_every: int, multifault: bool = False,
               plain: bool = False, adaptive: bool = False):
    """One launch of kernel ``kind`` (:func:`_plan`) on padded operands,
    with its wrapper-side inputs ``extra`` (:func:`kernel_inputs`);
    ``plain=True`` runs its plain version instead, on any device;
    ``adaptive`` the adaptive build of B3-B8 (B2 has none). Returns (out,
    det, unc)."""
    args = (shape, alpha, beta, scalars)
    ad = dict(adaptive=adaptive)
    if kind == "precomp":
        if adaptive:
            raise ValueError("B2 has no adaptive build: the adaptive weighted"
                             " strategy runs B5 (_plan)")
        if plain:
            return ft_weighted_plain(a, b, c, *args, expm=extra[0])
        return ft_weighted_kernel(a, b, c, *extra, *args)
    if kind == "running":
        if plain:
            return ft_weighted_plain(a, b, c, *args, check_every=check_every,
                                     **ad)
        return ft_weighted_running_kernel(a, b, c, *args, check_every, **ad)
    if kind == "fused":
        if plain:
            return ft_weighted_plain(a, b, c, *args, check_every=check_every,
                                     moments=extra[0], **ad)
        return ft_fused_kernel(a, b, c, *extra, *args, check_every, **ad)
    if kind in ("rowcol", "rowcol_mxu"):
        if plain:
            return ft_rowcol_plain(a, b, c, *args, check_every, multifault,
                                   moments=extra or None, **ad)
        if kind == "rowcol":
            return ft_rowcol_kernel(a, b, c, *args, check_every, multifault,
                                    **ad)
        return ft_rowcol_mxu_kernel(a, b, c, *extra, *args, check_every,
                                    multifault, **ad)
    if kind in ("global", "global_mxu"):
        if plain:
            return ft_global_plain(a, b, c, *args, check_every,
                                   moments=extra or None, **ad)
        if kind == "global":
            return ft_global_kernel(a, b, c, *args, check_every, **ad)
        return ft_global_mxu_kernel(a, b, c, *extra, *args, check_every, **ad)
    raise ValueError(f"unknown kernel kind {kind!r}")


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

# (strategy, encode="mxu") -> the kernel family that runs it
# (ops/ft_sgemm.py:1297-1314). The fused strategy IS the weighted design's
# mxu encode, so the two spellings share B6.
_MXU_KERNEL_STRATEGY = {
    "weighted": "fused",
    "fused": "fused",
    "rowcol": "rowcol_mxu",
    "global": "global_mxu",
}


def resolve_kernel_strategy(strategy: str, encode: str) -> str:
    """The kernel family a (strategy, encode) pair runs."""
    if encode == "mxu" or strategy == "fused":
        return _MXU_KERNEL_STRATEGY[strategy]
    return strategy


def _resolve_cadence(strategy, check_every, inject, nk, bn):
    """The check cadence in K steps (ops/ft_sgemm.py:1727-1762): weighted
    and fused check once at the end, rowcol and global ~20 times per run
    like the reference's K/20 cadence. For the column-localized correcting
    strategies (rowcol, weighted, fused), with injection on and a column
    stride coprime to bn, at most bn * every steps, so the interval's
    faults land in distinct columns; the detect-only global counts events
    and is not clamped."""
    if check_every is not None:
        ce = check_every
    elif strategy in ("weighted", "fused"):
        ce = nk
    else:
        ce = max(1, round(nk / 20))
    if (inject.enabled and strategy in ("rowcol", "weighted", "fused")
            and math.gcd(inject.col_stride, bn) == 1):
        ce = min(ce, bn * max(1, inject.every))
    return ce


def _plan(strategy, check_every, multifault, inject, nk, bn, encode="vpu",
          adaptive=False):
    """What :func:`make_ft_sgemm` launches for one call: the kernel
    (``"precomp"`` B2, ``"running"`` B5, ``"rowcol"`` B3, ``"global"`` B4,
    ``"fused"`` B6, ``"rowcol_mxu"`` B7 or ``"global_mxu"`` B8), its cadence
    in K steps, and whether rowcol (either encode) keeps the multifault
    weighted checksum. Under ``threshold="adaptive"`` the weighted strategy
    runs B5 at every cadence: B2 has no encode pass for the moment
    statistics to ride (ops/ft_sgemm.py:1367-1371)."""
    ce = _resolve_cadence(strategy, check_every, inject, nk, bn)
    kind = resolve_kernel_strategy(strategy, encode)
    if kind == "weighted":
        kind = "precomp" if ce >= nk and not adaptive else "running"
    mf = False
    if strategy == "rowcol":
        # Auto multifault: the weighted checksum is dead weight iff the
        # schedule guarantees <= 1 fault per check interval.
        mf = (not (inject.enabled and ce <= max(1, inject.every))
              if multifault is None else multifault)
    return kind, ce, mf


def make_ft_sgemm(
    shape: KernelShape | str,
    *,
    alpha: float = 1.0,
    beta: float = -1.5,
    strategy: str = "weighted",
    encode: str = "vpu",
    threshold=REFERENCE_THRESHOLD,
    threshold_margin: float = DEFAULT_THRESHOLD_MARGIN,
    check_every: Optional[int] = None,
    in_dtype: str = "float32",
    multifault: Optional[bool] = None,
    device=None,
):
    """Build the fused-ABFT SGEMM for one named shape (or ``KernelShape``).

    Returns ``fn(a, b, c, inject=None) -> FtSgemmResult``; ``inject`` is an
    :class:`InjectionSpec` (default: none). ``strategy`` is ``"weighted"``,
    ``"rowcol"``, ``"global"`` (detect only) or ``"fused"``; ``encode``
    ``"vpu"`` or ``"mxu"`` (``"fused"`` always encodes from moment rows).
    ``threshold`` is one static detection threshold (a float, or
    ``"static"`` for the reference's 9500), a ``(threshold, thr_m1,
    thr_m2)`` triple for the detection and the w / w^2 re-checks, or a mode
    (ops/ft_sgemm.py:1577-1599 of the JAX package):

    - ``"auto"``: per call, ``threshold_margin`` times the noise floor of
      the pre-pad inputs (``ops.common.estimate_noise_floor``; C only when
      beta is not 0), times sqrt(bn) for ``global``, and the re-checks at
      bm / sqrt(3) and bm^2 / sqrt(5) times that, reduced by torch ops on
      the inputs' device; the kernels are the static ones, which take the
      thresholds by value, so the launch reads them back (one wait a
      call).
    - ``"adaptive"``: per tile and check, inside the kernels (the adaptive
      build of B3-B8), from the running sums and sums of squares of the A
      and B elements the tile has consumed; ``threshold_margin`` rides
      slot 7. The weighted strategy then runs B5 at every cadence.

    ``check_every`` is the cadence in K steps (default: the strategy's,
    see ``_resolve_cadence``); ``multifault`` (rowcol) defaults to on
    unless the injection schedule proves at most one fault per check
    interval (ops/ft_sgemm.py:1802-1812). ``device=None`` runs on CUDA.

    Not ported yet, and raising ``NotImplementedError``: ``in_dtype`` other
    than float32.
    """
    if isinstance(threshold, str):
        threshold_mode = threshold
    else:
        threshold_mode = "static"
    check_kernel_legality(strategy=strategy, encode=encode, in_dtype=in_dtype,
                          threshold_mode=threshold_mode)
    if strategy == "fused":
        encode = "mxu"  # the fused strategy IS the weighted mxu encode
    adaptive = threshold_mode == "adaptive"
    thresholds = (0.0,) * 3
    if threshold_mode == "static":
        if threshold == "static":
            threshold = REFERENCE_THRESHOLD
        thresholds = (tuple(float(t) for t in threshold)
                      if isinstance(threshold, (tuple, list))
                      else (float(threshold),) * 3)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    dev = resolve_device(device)
    bm, bn, bk = shape.block

    def scalars_for(inject, a, b, c):
        if threshold_mode != "auto":
            return scalar_operand(inject, thresholds,
                                  threshold_margin if adaptive else 0.0)
        # From the pre-pad inputs (padding zeros would dilute the moments),
        # on their device (ops/ft_sgemm.py:1820-1834).
        floor = estimate_noise_floor(a, b, c if beta != 0.0 else None,
                                     alpha, beta)
        thr = threshold_margin * floor
        if strategy == "global":
            thr = thr * float(np.sqrt(bn))
        thr3 = torch.stack((thr, thr * float(bm / np.sqrt(3.0)),
                            thr * float(bm ** 2 / np.sqrt(5.0))))
        base = torch.as_tensor(scalar_operand(inject, (0.0,) * 3),
                               device=a.device)
        return torch.cat((base[:4], torch.clamp(thr3, max=float(THRESHOLD_CAP)),
                          base[7:]))

    # threshold="auto" on the card: the thresholds come back through one
    # pinned buffer, waited for by an event, so that the wrapper's other
    # inputs are queued behind the floor's reductions and run while the
    # host waits.
    readback = {}

    def fn(a, b, c, inject: Optional[InjectionSpec] = None) -> FtSgemmResult:
        inject = inject or InjectionSpec.none()
        a, b, c = (as_f32(x, dev) for x in (a, b, c))
        m, n = c.shape
        ap, bp = pad_to(a, bm, bk), pad_to(b, bn, bk)
        cp = pad_to(c, bm, bn)
        kind, ce, mf = _plan(strategy, check_every, multifault, inject,
                             ap.shape[1] // bk, bn, encode, adaptive)
        scalars = scalars_for(inject, a, b, c)
        if isinstance(scalars, torch.Tensor) and scalars.is_cuda:
            if "host" not in readback:
                readback["host"] = torch.empty(8, pin_memory=True)
            readback["host"].copy_(scalars, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        extra = kernel_inputs(kind, ap, bp, shape)
        if isinstance(scalars, torch.Tensor) and scalars.is_cuda:
            ready.synchronize()
            scalars = readback["host"].numpy().copy()
        out, det, unc = run_kernel(kind, shape, ap, bp, cp, extra, alpha,
                                   beta, scalars, ce, mf, adaptive=adaptive)
        return FtSgemmResult(out[:m, :n], det, unc)

    fn.__name__ = (f"ft_sgemm_{shape.name}_{strategy}"
                   + ("_mxu" if encode == "mxu" and strategy != "fused" else "")
                   + ("_adaptive" if adaptive else ""))
    fn.shape_config = shape
    fn.strategy = strategy
    fn.encode = encode
    fn.threshold_mode = threshold_mode
    return fn


def ft_sgemm(a, b, c, shape: KernelShape | str = "huge", *, alpha=1.0,
             beta=-1.5, inject: Optional[InjectionSpec] = None,
             strategy: str = "weighted", encode: str = "vpu",
             threshold=REFERENCE_THRESHOLD,
             threshold_margin: float = DEFAULT_THRESHOLD_MARGIN,
             check_every: Optional[int] = None,
             multifault: Optional[bool] = None, device=None) -> FtSgemmResult:
    """One-shot fused-ABFT SGEMM (see :func:`make_ft_sgemm`)."""
    return make_ft_sgemm(
        shape, alpha=alpha, beta=beta, strategy=strategy, encode=encode,
        threshold=threshold, threshold_margin=threshold_margin,
        check_every=check_every, multifault=multifault, device=device,
    )(a, b, c, inject)

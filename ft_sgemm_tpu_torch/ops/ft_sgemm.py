"""Fused online-ABFT SGEMM: kernels B2, B5 (``csrc/ft_sgemm_weighted.cu``)
and B3 (``csrc/ft_sgemm_rowcol.cu``), behind kernel ids 11-16.

Port of ``ft_sgemm_tpu/ops/ft_sgemm.py`` for this slice: the ``weighted``
(default) and ``rowcol`` strategies with static thresholds in f32. Each
kernel encodes, accumulates, injects, detects and corrects inside one
launch, as the Pallas kernels do (module docstring there):

  - ``weighted``: column checksums with weights 1, w, w^2 (w = row + 1);
    the weighted-residual ratio localizes each flagged column's fault row,
    the w^2 moment re-checks the correction. At its default cadence (one
    final check) the expected moments are precomputed by one FP32 matmul
    outside the kernel (``_expected_col_checksums``) and B2 runs; a cadence
    with intermediate checks runs B5, which encodes them as running sums.
  - ``rowcol`` (reference parity): row and column checksums encoded per K
    step, corrections at flagged row/column intersections every
    ``check_every`` steps, and the multifault weighted localization when
    the intersection is ambiguous (B3).

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

import torch

from ft_sgemm_tpu_torch.configs import SHAPES, STRATEGIES, THRESHOLD_MODES, KernelShape
from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.ops._build import bind, check_launch, check_operands, library
from ft_sgemm_tpu_torch.ops.common import (
    as_f32,
    correction_pads,
    pad_to,
    resolve_device,
    scalar_operand,
    strict_fp32,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class FtSgemmResult(NamedTuple):
    """Output of a fused-ABFT GEMM (``ft_sgemm_tpu/ops/ft_sgemm.py::FtSgemmResult``).

    ``detections`` (grid_m, grid_n) int32: corrected accumulator elements
    per C tile, summed over checks. ``uncorrectable`` (grid_m, grid_n)
    int32: checksum residuals still above threshold after the LAST check's
    correction (a level, not a sum) — nonzero means the tile may still be
    corrupted and the caller must re-run.
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


def _tile_moments(ap: torch.Tensor, bm: int) -> torch.Tensor:
    """(gm, 3, K): the plain, w and w^2 column moments of each (bm, K) row
    tile of the padded A (ops/ft_sgemm.py:1167-1200, f32 path)."""
    m, kdim = ap.shape
    af = ap.reshape(m // bm, bm, kdim)
    w = _weights(bm, ap.device)[None, :, None]
    return torch.stack([af.sum(1), (af * w).sum(1), (af * (w * w)).sum(1)], 1)


def _expected_col_checksums(ap: torch.Tensor, bp: torch.Tensor, bm: int
                            ) -> torch.Tensor:
    """(gm, 3, N) expected plain / w / w^2 column checksums of every output
    tile, ``moments(A_i) @ B.T`` (ops/ft_sgemm.py:1224-1256) — one FP32
    ``torch.matmul`` over the stacked moment rows, as XLA's dot was."""
    strict_fp32()
    rows = _tile_moments(ap, bm)
    gm, r, kdim = rows.shape
    return torch.matmul(rows.reshape(gm * r, kdim), bp.T).reshape(gm, r, -1)


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
                      check_every: Optional[int] = None, expm=None):
    """Plain PyTorch version of B2 (``expm`` given: precomputed moments, one
    final check) and B5 (``expm`` None: running moments, a check every
    ``check_every`` steps and after the last). Returns (out, det, unc)."""
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
    thresholds = [float(t) for t in scalars[4:7]]
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        acc += torch.einsum("imk,jnk->ijmn", a_k, b_k)
        if expm is None:
            for e, s_a in zip(exps, (a_k.sum(1), (a_k * w).sum(1),
                                     (a_k * (w * w)).sum(1))):
                e += torch.einsum("jnk,ik->ijn", b_k, s_a)
        if (k + 1) % check_every == 0 or k == nk - 1:
            acc, hits, bad = _moment_detect_correct(acc, *exps, thresholds)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
    return _untile(alpha * acc + beta * c4), det, unc


def ft_rowcol_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, multifault: bool):
    """Plain PyTorch version of B3. Returns (out, det, unc)."""
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
    thresholds = [float(t) for t in scalars[4:6]]
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        acc += torch.einsum("imk,jnk->ijmn", a_k, b_k)
        r_exp += torch.einsum("imk,jk->ijm", a_k, b_k.sum(1))
        c_exp += torch.einsum("jnk,ik->ijn", b_k, a_k.sum(1))
        if multifault:
            cw_exp += torch.einsum("jnk,ik->ijn", b_k,
                                   (a_k * w[None, :, None]).sum(1))
        if (k + 1) % check_every == 0 or k == nk - 1:
            res_cw = cw_exp - (acc * w[:, None]).sum(-2) if multifault else None
            acc, hits, bad = _rowcol_detect_correct(
                acc, r_exp - acc.sum(-1), c_exp - acc.sum(-2), res_cw,
                thresholds, multifault)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
    return _untile(alpha * acc + beta * c4), det, unc


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entries():
    weighted = library("ft_sgemm_weighted")
    tail = [_I] * 9
    return {
        "precomp": bind(weighted, "ftsg_ft_weighted_precomp",
                        [_P] * 7 + tail + [_F, _F, _P, _P]),
        "running": bind(weighted, "ftsg_ft_weighted_running",
                        [_P] * 6 + tail + [_I, _F, _F, _P, _P]),
        "rowcol": bind(library("ft_sgemm_rowcol"), "ftsg_ft_rowcol",
                       [_P] * 6 + tail + [_I, _I, _F, _F, _P, _P]),
    }


def _launch(name, shape, a, b, c, extra_in, extra_args, alpha, beta,
            scalars):
    dims = check_operands(shape, a, b, c, *extra_in)
    out = torch.empty_like(c)
    grid = (c.shape[0] // shape.bm, c.shape[1] // shape.bn)
    det = torch.empty(grid, dtype=torch.int32, device=c.device)
    unc = torch.empty_like(det)
    rc = _entries()[name](
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        *(t.data_ptr() for t in extra_in), out.data_ptr(), det.data_ptr(),
        unc.data_ptr(), *dims, *extra_args, alpha, beta,
        scalars.ctypes.data, torch.cuda.current_stream(a.device).cuda_stream)
    return rc, (out, det, unc)


def ft_weighted_kernel(a, b, c, expm, shape: KernelShape, alpha, beta,
                       scalars):
    """B2 on operands padded to the tile, with the (gm, 3, N) expected
    moments ``expm``; ``scalars`` the (8,) f32 scalar argument. Returns
    (out, det, unc). A CPU tensor runs the plain version."""
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 expm=expm)
    rc, res = _launch("precomp", shape, a, b, c, (expm,), (), alpha, beta,
                      scalars)
    ft_weighted_kernel.launches += 1
    check_launch(rc, "ftsg_ft_weighted_precomp")
    return res


def ft_weighted_running_kernel(a, b, c, shape: KernelShape, alpha, beta,
                               scalars, check_every: int):
    """B5: the weighted check every ``check_every`` K steps and after the
    last, with running in-kernel moments. Returns (out, det, unc)."""
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 check_every=check_every)
    rc, res = _launch("running", shape, a, b, c, (), (check_every,), alpha,
                      beta, scalars)
    ft_weighted_running_kernel.launches += 1
    check_launch(rc, "ftsg_ft_weighted_running")
    return res


def ft_rowcol_kernel(a, b, c, shape: KernelShape, alpha, beta, scalars,
                     check_every: int, multifault: bool):
    """B3: the rowcol check every ``check_every`` K steps and after the
    last. Returns (out, det, unc)."""
    if a.device.type == "cpu":
        return ft_rowcol_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, multifault)
    rc, res = _launch("rowcol", shape, a, b, c, (),
                      (check_every, int(multifault)), alpha, beta, scalars)
    ft_rowcol_kernel.launches += 1
    check_launch(rc, "ftsg_ft_rowcol")
    return res


ft_weighted_kernel.launches = 0
ft_weighted_running_kernel.launches = 0
ft_rowcol_kernel.launches = 0


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def _resolve_cadence(strategy, check_every, inject, nk, bn):
    """The check cadence in K steps (ops/ft_sgemm.py:1727-1762): weighted
    checks once at the end, rowcol ~20 times per run like the reference's
    K/20 cadence; with injection on and a column stride coprime to bn, at
    most bn * every steps so the interval's faults land in distinct
    columns."""
    if check_every is not None:
        ce = check_every
    elif strategy == "weighted":
        ce = nk
    else:
        ce = max(1, round(nk / 20))
    if inject.enabled and math.gcd(inject.col_stride, bn) == 1:
        ce = min(ce, bn * max(1, inject.every))
    return ce


def _plan(strategy, check_every, multifault, inject, nk, bn):
    """What :func:`make_ft_sgemm` launches for one call: the kernel
    (``"precomp"`` B2, ``"running"`` B5 or ``"rowcol"`` B3), its cadence in
    K steps, and whether rowcol keeps the multifault weighted checksum."""
    ce = _resolve_cadence(strategy, check_every, inject, nk, bn)
    if strategy == "weighted":
        return ("precomp" if ce >= nk else "running"), ce, False
    # Auto multifault: the weighted checksum is dead weight iff the schedule
    # guarantees <= 1 fault per check interval.
    mf = (not (inject.enabled and ce <= max(1, inject.every))
          if multifault is None else multifault)
    return "rowcol", ce, mf


def make_ft_sgemm(
    shape: KernelShape | str,
    *,
    alpha: float = 1.0,
    beta: float = -1.5,
    strategy: str = "weighted",
    threshold=REFERENCE_THRESHOLD,
    check_every: Optional[int] = None,
    multifault: Optional[bool] = None,
    device=None,
):
    """Build the fused-ABFT SGEMM for one named shape (or ``KernelShape``).

    Returns ``fn(a, b, c, inject=None) -> FtSgemmResult``; ``inject`` is an
    :class:`InjectionSpec` (default: none). ``strategy`` is ``"weighted"``
    or ``"rowcol"``. ``threshold`` is one static detection threshold (a
    float, or ``"static"`` for the reference's 9500) or a
    ``(threshold, thr_m1, thr_m2)`` triple for the detection and the w / w^2
    re-checks. ``check_every`` is the cadence in K steps (default: the
    strategy's, see ``_resolve_cadence``); ``multifault`` (rowcol) defaults
    to on unless the injection schedule proves at most one fault per check
    interval (ops/ft_sgemm.py:1802-1812). ``device=None`` runs on CUDA.

    Not ported yet, and raising: the ``global`` and ``fused`` strategies,
    the ``"auto"`` and ``"adaptive"`` thresholds, and non-f32 inputs.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; pick from {STRATEGIES}")
    if strategy not in ("weighted", "rowcol"):
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet (weighted, rowcol)")
    if isinstance(threshold, str):
        if threshold not in THRESHOLD_MODES:
            raise ValueError(f"threshold must be a float or one of"
                             f" {THRESHOLD_MODES}, got {threshold!r}")
        if threshold != "static":
            raise NotImplementedError(
                f"threshold={threshold!r} is not ported yet (static only)")
        threshold = REFERENCE_THRESHOLD
    thresholds = (tuple(float(t) for t in threshold)
                  if isinstance(threshold, (tuple, list))
                  else (float(threshold),) * 3)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    dev = resolve_device(device)

    def fn(a, b, c, inject: Optional[InjectionSpec] = None) -> FtSgemmResult:
        inject = inject or InjectionSpec.none()
        a, b, c = (as_f32(x, dev) for x in (a, b, c))
        m, n = c.shape
        bm, bn, bk = shape.block
        ap, bp = pad_to(a, bm, bk), pad_to(b, bn, bk)
        cp = pad_to(c, bm, bn)
        kind, ce, mf = _plan(strategy, check_every, multifault, inject,
                             ap.shape[1] // bk, bn)
        scalars = scalar_operand(inject, thresholds)
        if kind == "precomp":
            out, det, unc = ft_weighted_kernel(
                ap, bp, cp, _expected_col_checksums(ap, bp, bm), shape,
                alpha, beta, scalars)
        elif kind == "running":
            out, det, unc = ft_weighted_running_kernel(
                ap, bp, cp, shape, alpha, beta, scalars, ce)
        else:
            out, det, unc = ft_rowcol_kernel(ap, bp, cp, shape, alpha, beta,
                                             scalars, ce, mf)
        return FtSgemmResult(out[:m, :n], det, unc)

    fn.__name__ = f"ft_sgemm_{shape.name}_{strategy}"
    fn.shape_config = shape
    fn.strategy = strategy
    return fn


def ft_sgemm(a, b, c, shape: KernelShape | str = "huge", *, alpha=1.0,
             beta=-1.5, inject: Optional[InjectionSpec] = None,
             strategy: str = "weighted", threshold=REFERENCE_THRESHOLD,
             check_every: Optional[int] = None,
             multifault: Optional[bool] = None, device=None) -> FtSgemmResult:
    """One-shot fused-ABFT SGEMM (see :func:`make_ft_sgemm`)."""
    return make_ft_sgemm(
        shape, alpha=alpha, beta=beta, strategy=strategy, threshold=threshold,
        check_every=check_every, multifault=multifault, device=device,
    )(a, b, c, inject)

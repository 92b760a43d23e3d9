"""Fused online-ABFT SGEMM: kernels B2, B5 (``csrc/ft_sgemm_weighted.cu``),
B3 (``csrc/ft_sgemm_rowcol.cu``), B4, B8 (``csrc/ft_sgemm_global.cu``) and
B6, B7 (``csrc/ft_sgemm_aug.cu``), behind kernel ids 11-16. B3-B8 run one
128 x 128 CTA over the paper's (bm, bn) tile as sub-tiles
(``csrc/ft_sgemm_running.cuh``): the grids, cadence and fault placement
stay per (bm, bn) tile, as the JAX grid is; padding stays at (bm, bn).

Port of ``ft_sgemm_tpu/ops/ft_sgemm.py`` in f32, under the three threshold
modes, in bf16 (``in_dtype="bfloat16"``) for every strategy and encode
(B2-B8 on bf16 wgmma) under the three threshold modes ("adaptive" on
the adaptive bf16 builds of B3-B8), in fp8
(``in_dtype="float8_e4m3fn"``) for the same strategies and modes as bf16
(B2-B5 on bf16 wgmma of the exactly widened e4m3 operands; B1 on e4m3
wgmma), and in int8
(``in_dtype="int8"``, the exact mode) for rowcol and global (B3, B4 on s8
wgmma) under every threshold mode. The
threshold modes are ``"static"`` (one
threshold, the reference's 9500 by default), ``"auto"`` (one threshold per
call from the inputs' moments, reduced by torch ops on the inputs' device
and read back into the same kernels' scalar argument) and ``"adaptive"``
(each tile's threshold at each check from its running moments, inside
B3-B8 as built with ``FTSG_ADAPTIVE``; in bf16 inside B3-B8 and in fp8
inside B3-B5 as built with ``FTSG_ADAPTIVE`` and ``FTSG_BF16``, the
moments those of the rounded operands, summed per 8-column half of each
16-deep k step).
The JAX noise model is dtype-free: the adaptive thresholds of bf16 and
fp8 are f32's formula on the rounded operands' moments.
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

In bf16, A and B are rounded to bf16 and everything else stays f32: the
product of the rounded values, and checksums of the rounded values, as the
tensor cores consume them (ops/ft_sgemm.py:575-582), so the input rounding
cancels out of every residual and the thresholds stay those of f32. The
wrapper's moment rows (B2's expected moments, and the rows B6-B8 load)
split each f32 moment into bf16 hi, lo and lo2 terms (``_tile_moments``),
as the JAX package does: B6-B8 multiply the three terms on the tensor cores
and add their products, as the JAX kernels add their per-term scratch
rows.

In fp8 (the serving mode), A and B are rounded to e4m3 as the JAX package
rounds them (``common.to_e4m3``) and everything else is f32, as in bf16:
the checksums are f32 sums of the rounded values, the wrapper's moment rows
stay f32 (magnitudes ~bm * 448 do not fit e4m3) and B2's expected moments
are their FP32 product with B widened to f32 (ops/ft_sgemm.py:1237-1245).
B2-B5 run their bf16 builds on the e4m3 operands, which ``_launch`` widens
exactly to bf16 (e4m3 wgmma keeps ~13 bits of a k step's sum, and a
correction writes a column's worth of that error into the element), so the
in-kernel sum rows ride as three bf16 terms, as in bf16. The thresholds are
f32's ("auto" from the rounded operands).

In int8 (``in_dtype="int8"``, the exact mode: ``exact=True`` of the JAX
kernels), A and B are truncated to int8 and the rowcol (B3) and global (B4)
strategies run with an int32 accumulator and int32 checksums that wrap mod
2^32, so clean residuals are exactly 0 and every nonzero residual is a
fault: a fault is the rounded magnitude, the correction an exact integer
add, the re-check has no pads, and ``threshold="adaptive"`` is the
constant half-ulp 0.5 (ops/ft_sgemm.py:606-611, 890-893), which the static
kernels take in slots 4-6. Multifault is off. The output is ``alpha *
f32(acc) + beta * C``.

Beside each kernel wrapper is its plain PyTorch version, which follows the
tile algorithm over all tiles at once (batched (gm, gn, bm, bn) tensors,
a Python loop over K steps only): the same inject positions, cadence,
residuals, localization and LEVEL counts. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.

The variant axes (``variant=``, ``configs.KernelVariant``) and the f32
precision run in every body and build: at a pipeline depth of 3 a grid
step is the two-panel K window (the kernels take it as their bk, the plain
versions multiply panel by panel), the grid order is the CTA raster, the
dimension semantics change nothing on the card, and ``precision=
"default"`` runs one TF32 wgmma a k step where "highest" and "high" run
three (``common.LaunchAxes``).

The fused epilogue (``epilogue=``, ``configs.EpilogueSpec``: bias, relu or
gelu, int8 or fp8 quantize-rescale; the JAX kernels' ``_apply_epilogue``)
runs strictly after detect and correct: on the card inside every kernel's
store (``csrc/abft_common.cuh::Epilogue``), in the plain versions on their
output (``common.apply_epilogue``), so the checksums verify the
pre-epilogue accumulator and the grids do not depend on it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ft_sgemm_tpu_torch.configs import (
    SHAPES,
    EpilogueSpec,
    KernelShape,
    canonical_variant,
    check_kernel_legality,
    check_variant,
)
from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.ops._build import (
    EPILOGUE_ARGS,
    VARIANT_ARGS,
    bind,
    build,
    check_launch,
    check_operands,
    library,
)
from ft_sgemm_tpu_torch.ops.common import (
    DEFAULT_THRESHOLD_MARGIN,
    NOISE_C_BIAS,
    NOISE_C_RAND,
    THRESHOLD_CAP,
    LaunchAxes,
    align_rows16,
    apply_epilogue,
    as_f32,
    as_operand,
    bias_operand,
    check_precision,
    correction_pads,
    epilogue_args,
    estimate_noise_floor,
    full_run_log2,
    launch_axes,
    pad_to,
    resolve_device,
    resolve_in_dtype,
    scalar_operand,
    step_shape,
    strict_fp32,
    sub_panels,
    variance_bound_threshold,
)
from ft_sgemm_tpu_torch.ops.reference import wrap_int32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Each FT kernel kind's C entry point (a bf16 build's adds "_bf16", B3's
# and B4's int8 builds' "_int8") and the libraries that hold it
# (ops/_build.LIBRARIES; :func:`kernel_entry`): the static f32 one (with
# the int8 builds; "_adaptive" after its name, the adaptive f32 build),
# and the bf16 builds' own (bf16, and fp8 on the widened operands): the
# static ones of B2-B8 and the adaptive ones of B3-B8 (B2 has none).
ENTRY_POINTS = {"precomp": "ftsg_ft_weighted_precomp",
                "running": "ftsg_ft_weighted_running",
                "rowcol": "ftsg_ft_rowcol", "global": "ftsg_ft_global",
                "global_mxu": "ftsg_ft_global_mxu", "fused": "ftsg_ft_fused",
                "rowcol_mxu": "ftsg_ft_rowcol_mxu"}
F32_LIBS = {"precomp": "ft_sgemm_weighted", "running": "ft_sgemm_weighted",
            "rowcol": "ft_sgemm_rowcol", "global": "ft_sgemm_global",
            "global_mxu": "ft_sgemm_global", "fused": "ft_sgemm_aug",
            "rowcol_mxu": "ft_sgemm_aug"}
FT_LIBS = tuple(dict.fromkeys(F32_LIBS.values()))
BF16_LIBS = {"precomp": "ft_sgemm_precomp_bf16",
             "running": "ft_sgemm_weighted_bf16",
             "rowcol": "ft_sgemm_rowcol_bf16",
             "global": "ft_sgemm_global_bf16",
             "global_mxu": "ft_sgemm_global_bf16",
             "fused": "ft_sgemm_fused_bf16",
             "rowcol_mxu": "ft_sgemm_rowcol_mxu_bf16"}
ADAPTIVE_BF16_LIBS = {"running": "ft_sgemm_weighted_adaptive_bf16",
                      "rowcol": "ft_sgemm_rowcol_adaptive_bf16",
                      "global": "ft_sgemm_global_adaptive_bf16",
                      "global_mxu": "ft_sgemm_global_adaptive_bf16",
                      "fused": "ft_sgemm_fused_adaptive_bf16",
                      "rowcol_mxu": "ft_sgemm_rowcol_mxu_adaptive_bf16"}


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
    """The first ``n_moments`` of the plain, w and w^2 column moments of
    each (bm, K) row tile of a padded operand, in its dtype
    (ops/ft_sgemm.py:1167-1200): f32, (g, n_moments, K); bf16, (g,
    3 n_moments, K), each f32 moment split into bf16 hi, lo and lo2 terms
    at row ``n_moments * t + moment`` (term t), whose sum keeps the f32
    moment's precision (a single bf16 cast would leave ~1 of expectation
    noise in a corrected element). A gives 3 (B2's expectations, B6), 2
    (B7) or 1 (B8); B gives 1 (B7, B8)."""
    m, kdim = ap.shape
    af = ap.reshape(m // bm, bm, kdim).float()
    w = _weights(bm, ap.device)[None, :, None]
    rows = [af.sum(1)]
    if n_moments >= 2:
        rows.append((af * w).sum(1))
    if n_moments >= 3:
        rows.append((af * (w * w)).sum(1))
    moments = torch.stack(rows, 1)
    if ap.dtype != torch.bfloat16:
        return moments
    hi = moments.to(torch.bfloat16)
    rem = moments - hi.float()
    lo = rem.to(torch.bfloat16)
    lo2 = (rem - lo.float()).to(torch.bfloat16)
    return torch.cat((hi, lo, lo2), 1)


def _expected_col_checksums(ap: torch.Tensor, bp: torch.Tensor, bm: int
                            ) -> torch.Tensor:
    """(gm, 3, N) f32 expected plain / w / w^2 column checksums of every
    output tile, ``moments(A_i) @ B.T`` (ops/ft_sgemm.py:1224-1256) — one
    FP32 ``torch.matmul`` over the stacked moment rows, as XLA's dot was;
    in bf16 over the hi / lo / lo2 term rows (exact products), the three
    terms of each moment then summed."""
    strict_fp32()
    rows = _tile_moments(ap, bm)
    gm, r, kdim = rows.shape
    exp = torch.matmul(rows.reshape(gm * r, kdim).float(),
                       bp.float().T).reshape(gm, r, -1)
    if r == 9:  # bf16: the three terms of each moment
        exp = exp[:, 0:3] + exp[:, 3:6] + exp[:, 6:9]
    return exp


def kernel_inputs(kind: str, ap: torch.Tensor, bp: torch.Tensor,
                  shape: KernelShape) -> tuple:
    """The wrapper-side inputs of one launch of ``kind`` (see :func:`_plan`)
    on the padded operands: B2's expected moments, the mxu kernels' moment
    rows (A's 3 for B6, A's 2 and B's 1 for B7, A's 1 and B's 1 for B8;
    in bf16 three bf16 terms of each); none for the others."""
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


def _step_rows(rows, nk: int, n_moments: int):
    """Moment rows (g, T n_moments, K) of ``_tile_moments`` as T terms of
    (g, n_moments, nk, bk) f32, step k's rows at ``[:, :, k]``: one term in
    f32, the bf16 terms hi, lo and lo2 (rows ``n_moments t + v``) in
    bf16."""
    g, r, kdim = rows.shape
    return rows.float().reshape(g, r // n_moments, n_moments, nk,
                                kdim // nk).unbind(1)


def _term_sum(terms):
    """The terms' expected sums added in order, as the JAX kernels add
    their per-term scratch rows at a check (ops/ft_sgemm.py:722-730,
    1138-1143)."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _untile(t4: torch.Tensor) -> torch.Tensor:
    gm, gn, bm, bn = t4.shape
    return t4.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)


def _step_product(acc, dot, a_k, b_k, axes: LaunchAxes) -> None:
    """acc (gm, gn, bm, bn) += one grid step's tile product: one product per
    K panel of the step (``axes.unroll``, as the JAX kernels' ``sub_panels``
    dots, added in order), of operands rounded to TF32 in one-pass mode."""
    for a_s, b_s in sub_panels(axes.hi(a_k), axes.hi(b_k), axes.unroll):
        acc += dot("imk,jnk->ijmn", a_s, b_s)


def _inject_plain(acc, scalars, k: int) -> None:
    """``_inject`` for every tile at step ``k``: the ordinal
    k//every + 3i + 5j picks row (131*ord + 7) % bm and column
    (col_stride*ord + 3) % bn of tile (i, j). An integer accumulator (the
    exact mode) takes the magnitude rounded half to even, as jnp.round."""
    every = max(int(scalars[1]), 1)
    if not scalars[0] > 0.0 or k % every:
        return
    gm, gn, bm, bn = acc.shape
    ii = torch.arange(gm, device=acc.device)[:, None]
    jj = torch.arange(gn, device=acc.device)[None, :]
    ordinal = k // every + 3 * ii + 5 * jj
    rows = (ordinal * 131 + 7) % bm
    cols = (ordinal * int(scalars[3]) + 3) % bn
    mag = float(scalars[2])
    acc[ii, jj, rows, cols] += mag if acc.is_floating_point() else round(mag)


def _mag32(x: torch.Tensor) -> torch.Tensor:
    """``mag`` of the exact checks (ops/ft_sgemm.py:425-429): |x| of wrapped
    int32 values (held as int64) in f32, |INT_MIN| staying INT_MIN as
    jnp.abs wraps it."""
    return torch.where(x == -2 ** 31, x, x.abs()).to(torch.float32)


def _exact_dot(eq: str, *ops) -> torch.Tensor:
    """One K step's einsum of the exact mode as int64, of int8 values held
    in float64: every step's products and checksum updates are exact there
    (|a b| <= 2^14 over bk <= 128 terms, |a s_b| <= 2^28, |s_a s_b| <=
    2^35), on the CPU and on the card alike."""
    return torch.einsum(eq, *ops).to(torch.int64)


def _accumulate_moments(mom, a_k, b_k) -> list:
    """``_accumulate_moments`` (ops/ft_sgemm.py:394-403) of one K step for
    every tile: the running [sum a, sum a^2] of each (bm, bk) A block, (gm,),
    and [sum b, sum b^2] of each (bn, bk) B block, (gn,), added to ``mom``
    (None before the first step). bf16 and fp8 blocks are summed as their
    rounded values widened to f32, as the JAX kernel sums
    ``a_blk.astype(f32)`` (ops/ft_sgemm.py:580-581, 596)."""
    a_k, b_k = a_k.float(), b_k.float()
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
                           multifault: bool, exact: bool = False):
    """``_rowcol_detect_correct`` over tiles: returns (corrected acc,
    per-tile hits, per-tile uncorrectable level). ``exact``: wrapped int32
    residuals (int64), ``mag`` against the f32 threshold, an integer
    correction and a re-check without pads."""
    delta, hits, bad = _rowcol_decide(acc, res_r, res_c, res_cw, thresholds,
                                      multifault, exact)
    return acc + delta, hits, bad


def _rowcol_decide(acc, res_r, res_c, res_cw, thresholds, multifault: bool,
                   exact: bool = False):
    """:func:`_rowcol_detect_correct`'s decisions: (the correction, per-tile
    hits, per-tile uncorrectable level), the correction not yet added to
    ``acc`` (the rowcol kernels add it at a later stage end)."""
    thr, thr_m1 = thresholds[:2]
    bm = acc.shape[-2]
    mag = _mag32 if exact else torch.abs
    det_r = mag(res_r) > thr                         # (gm, gn, bm)
    det_c = mag(res_c) > thr                         # (gm, gn, bn)
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
    if exact:
        res_r2, res_c2 = wrap_int32(res_r2), wrap_int32(res_c2)
        pad_r = pad_c = 0.0
    else:
        (pad_r,) = correction_pads(delta, -1)
        (pad_c,) = correction_pads(delta, -2)
    bad_c = mag(res_c2) > thr + pad_c
    bad = (mag(res_r2) > thr + pad_r).sum(-1) + bad_c.sum(-1)
    if multifault:
        res_cw2 = res_cw - (delta * w).sum(-2)
        _, pad_w = correction_pads(delta, -2, w)
        bad = bad + ((res_cw2.abs() > thr_m1 + pad_w) & ~bad_c).sum(-1)
    return delta, hit.sum((-2, -1)), bad


def ft_weighted_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                      check_every: Optional[int] = None, expm=None,
                      moments=None, adaptive: bool = False, epi=None,
                      bias=None, axes: LaunchAxes = LaunchAxes()):
    """Plain PyTorch version of B2 (``expm`` given: precomputed moments, one
    final check), B5 (running moments from the operand, a check every
    ``check_every`` steps and after the last) and B6 (``moments`` given:
    running moments from A's moment rows, (gm, 3, K) in f32, (gm, 9, K) of
    bf16 terms in bf16, each term's expected moments kept apart and added
    at the check as ``_ft_kernel_fused`` adds them); ``adaptive``: each
    tile's thresholds at each check from its running moments of A's and B's
    own rows (B5, B6). bf16 and fp8 operands are summed as their f32
    values. ``epi`` (with the padded bias row ``bias``): the fused epilogue
    on the output (:func:`_epilogue`). ``axes`` (``common.LaunchAxes``):
    ``shape`` is the grid step's (bk the K window of a pipeline depth), the
    step's product runs per K panel, and in one-pass mode (the f32
    precision "default") both operands of every product, the tile product
    and each expected-moment product, are rounded to TF32, as the kernels'
    one hi . hi wgmma takes them; the adaptive moments stay those of the
    operands. The same ``axes`` for every plain version below.
    Returns (out, det, unc)."""
    strict_fp32()
    a4, b4, c4, nk = _tiles(a.float(), b.float(), c, shape)
    gm, gn, bm, bn = c4.shape
    acc = torch.zeros_like(c4)
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    unc = torch.zeros_like(det)
    w = _weights(bm, a.device)[None, :, None]
    terms = _step_rows(moments, nk, 3) if moments is not None else (None,)
    texps = [[torch.zeros((gm, gn, bn), device=a.device) for _ in range(3)]
             for _ in terms]
    if expm is not None:
        texps = [list(expm.reshape(gm, 3, gn, bn).unbind(1))]
        check_every = nk
    thresholds = [float(t) for t in scalars[4:7]]
    mom = None
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        _step_product(acc, torch.einsum, a_k, b_k, axes)
        if expm is None:
            hb = axes.hi(b_k)
            for exps, rows in zip(texps, terms):
                s_a = (rows[:, :, k].unbind(1) if rows is not None else
                       (a_k.sum(1), (a_k * w).sum(1), (a_k * (w * w)).sum(1)))
                for e, s in zip(exps, s_a):
                    e += torch.einsum("jnk,ik->ijn", hb, axes.hi(s))
        if adaptive:
            mom = _accumulate_moments(mom, a_k, b_k)
        if (k + 1) % check_every == 0 or k == nk - 1:
            if adaptive:
                thresholds = _recheck_thresholds(_adaptive_threshold(
                    mom, k, shape, nk, float(scalars[7])), bm)
            exps = [_term_sum(e) for e in zip(*texps)]
            acc, hits, bad = _moment_detect_correct(acc, *exps, thresholds)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
    return _epilogue(acc, c4, alpha, beta, epi, bias), det, unc


def _check_exact(a, multifault=False, moments=None, adaptive=False) -> bool:
    """Whether the operands run the exact mode (int8), which takes no
    multifault, no moment rows and no adaptive build."""
    exact = a.dtype == torch.int8
    if exact and (multifault or moments is not None or adaptive):
        raise ValueError("int8 runs the vpu encodes of rowcol and global with"
                         " multifault off and the static thresholds (its"
                         " adaptive threshold is the constant 0.5)")
    return exact


def ft_rowcol_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, multifault: bool, moments=None,
                    adaptive: bool = False, epi=None, bias=None,
                    axes: LaunchAxes = LaunchAxes()):
    """Plain PyTorch version of B3 and, with ``moments`` = (A's (gm, 2, K),
    B's (gn, 1, K) moment rows; in bf16 (gm, 6, K) and (gn, 3, K) of bf16
    terms, each term's expected sums kept apart and added at the check as
    ``_ft_kernel_rowcol_mxu`` adds them), of B7; ``adaptive``: each tile's
    thresholds at each check from its running moments of A's and B's own
    rows. bf16 and fp8 operands are summed as their f32 values. int8
    operands run the exact mode step by step (``_ft_kernel_rowcol`` with
    exact=True): the accumulator, checksums, residuals and correction are
    integers reduced mod 2^32 where the JAX kernel's int32 would wrap.
    ``epi``, ``bias``, ``axes``: as :func:`ft_weighted_plain`.
    Returns (out, det, unc)."""
    exact = _check_exact(a, multifault, moments, adaptive)
    strict_fp32()
    a4, b4, c4, nk = _tiles(*(x.double() if exact else x.float()
                              for x in (a, b)), c, shape)
    gm, gn, bm, bn = c4.shape
    acc_t = torch.int64 if exact else c4.dtype
    acc = torch.zeros_like(c4, dtype=acc_t)
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    unc = torch.zeros_like(det)
    w = _weights(bm, a.device)
    ma, mb = ((_step_rows(moments[0], nk, 2), _step_rows(moments[1], nk, 1))
              if moments is not None else ((None,), (None,)))
    r_exp = [torch.zeros((gm, gn, bm), dtype=acc_t, device=a.device)
             for _ in mb]
    c_exp = [torch.zeros((gm, gn, bn), dtype=acc_t, device=a.device)
             for _ in ma]
    cw_exp = [torch.zeros_like(c) for c in c_exp]
    thresholds = [float(t) for t in scalars[4:6]]
    dot = _exact_dot if exact else torch.einsum
    mom = None
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        _step_product(acc, dot, a_k, b_k, axes)
        ha, hb = axes.hi(a_k), axes.hi(b_k)
        for r, rows in zip(r_exp, mb):
            r += dot("imk,jk->ijm", ha, axes.hi(
                b_k.sum(1) if rows is None else rows[:, 0, k]))
        for c_t, cw_t, rows in zip(c_exp, cw_exp, ma):
            c_t += dot("jnk,ik->ijn", hb, axes.hi(
                a_k.sum(1) if rows is None else rows[:, 0, k]))
            if multifault:
                s_aw = ((a_k * w[None, :, None]).sum(1) if rows is None
                        else rows[:, 1, k])
                cw_t += torch.einsum("jnk,ik->ijn", hb, axes.hi(s_aw))
        if adaptive:
            mom = _accumulate_moments(mom, a_k, b_k)
        if (k + 1) % check_every == 0 or k == nk - 1:
            if adaptive:
                thresholds = _recheck_thresholds(_adaptive_threshold(
                    mom, k, shape, nk, float(scalars[7])), bm)[:2]
            res_cw = (_term_sum(cw_exp) - (acc * w[:, None]).sum(-2)
                      if multifault else None)
            res_r = _term_sum(r_exp) - acc.sum(-1)
            res_c = _term_sum(c_exp) - acc.sum(-2)
            if exact:
                res_r, res_c = wrap_int32(res_r), wrap_int32(res_c)
            acc, hits, bad = _rowcol_detect_correct(
                acc, res_r, res_c, res_cw, thresholds, multifault, exact)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
    return _epilogue(acc, c4, alpha, beta, epi, bias), det, unc


def _epilogue(acc, c4, alpha, beta, epi=None, bias=None) -> torch.Tensor:
    """``epi(alpha * acc + beta * C)`` of the tiles, untiled: an integer
    (exact) accumulator wrapped to int32 and widened to f32 first (each
    product and the sum rounded on its own, as the int8 kernels store
    them), then the fused epilogue ``epi`` (``common.apply_epilogue``; the
    padded bias row ``bias``), after every check, as the kernels' store
    applies it."""
    if not acc.is_floating_point():
        acc = wrap_int32(acc).to(torch.float32)
    return apply_epilogue(_untile(alpha * acc + beta * c4), epi, bias)


def ft_global_plain(a, b, c, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, moments=None, adaptive: bool = False,
                    epi=None, bias=None, axes: LaunchAxes = LaunchAxes()):
    """Plain PyTorch version of B4 and, with ``moments`` = (A's (gm, 1, K),
    B's (gn, 1, K) plain moment rows; in bf16 (g, 3, K) of bf16 terms, every
    (A term) . (B term) product added, as ``_ft_kernel_global_mxu`` sums
    its corner), of B8: per step ``t_exp += s_a . s_b``; per check the
    residual ``t_exp - sum(acc)``, one event when it
    moved by more than the threshold since the previous check; ``adaptive``:
    each tile's threshold at each check from its running moments of A's and
    B's own rows, times sqrt(bn). bf16 and fp8 operands are summed as their
    f32 values; int8 operands run the exact mode (``_ft_kernel_global`` with
    exact=True: t_exp, the residual and its move are wrapping int32).
    ``epi``, ``bias``, ``axes``: as :func:`ft_weighted_plain`.
    Returns (out, det, unc) with unc equal to det."""
    exact = _check_exact(a, moments=moments, adaptive=adaptive)
    strict_fp32()
    a4, b4, c4, nk = _tiles(*(x.double() if exact else x.float()
                              for x in (a, b)), c, shape)
    gm, gn = c4.shape[:2]
    acc_t = torch.int64 if exact else c4.dtype
    acc = torch.zeros_like(c4, dtype=acc_t)
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    t_exp = torch.zeros((gm, gn), dtype=acc_t, device=a.device)
    prev = torch.zeros_like(t_exp)
    if moments is not None:
        ma, mb = (_step_rows(m, nk, 1) for m in moments)
    thr = float(scalars[4])
    dot = _exact_dot if exact else torch.einsum
    mom = None
    for k in range(nk):
        _inject_plain(acc, scalars, k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        _step_product(acc, dot, a_k, b_k, axes)
        if moments is None:
            s_a, s_b = a_k.sum(1), b_k.sum(1)
            t_exp += (dot("ik,jk->ij", s_a, s_b) if exact
                      else axes.hi(s_a) @ axes.hi(s_b).T)
        else:
            t_exp += _term_sum([axes.hi(ta[:, 0, k]) @ axes.hi(tb[:, 0, k]).T
                                for ta in ma for tb in mb])
        if adaptive:
            mom = _accumulate_moments(mom, a_k, b_k)
        if (k + 1) % check_every == 0 or k == nk - 1:
            if adaptive:
                thr = _adaptive_threshold(mom, k, shape, nk,
                                          float(scalars[7]), global_tile=True)
            res = t_exp - acc.sum((-2, -1))
            if exact:
                res = wrap_int32(res)
                det += (_mag32(wrap_int32(res - prev)) > thr).to(torch.int32)
            else:
                det += ((res - prev).abs() > thr).to(torch.int32)
            prev = res
    return _epilogue(acc, c4, alpha, beta, epi, bias), det, det.clone()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


# The argument types of B5, B3 and B4, in every dtype: the operands and
# outputs, M, N, K, bm, bn, bk, the cadence (B3: and multifault), then
# alpha, beta, the scalar argument, the noise model, the fused epilogue
# (``_build.EPILOGUE_ARGS``), the variant axes (``_build.VARIANT_ARGS``)
# and the stream.
_DIMS = [_I] * 6
_TAIL = [_F, _F, _P, _F, _F, _F] + EPILOGUE_ARGS + VARIANT_ARGS + [_P]
_VPU_ARGS = {"running": [_P] * 6 + _DIMS + [_I] + _TAIL,
             "rowcol": [_P] * 6 + _DIMS + [_I, _I] + _TAIL,
             "global": [_P] * 6 + _DIMS + [_I] + _TAIL}
# Those of B6-B8: the moment rows after C (B6: A's; B7, B8: A's and B's).
_MXU_ARGS = {"fused": [_P] * 7 + _DIMS + [_I] + _TAIL,
             "rowcol_mxu": [_P] * 8 + _DIMS + [_I, _I] + _TAIL,
             "global_mxu": [_P] * 8 + _DIMS + [_I] + _TAIL}
# Every kind's; B2's with the expected moments after C, no cadence and no
# noise model.
_ARGS = dict(_VPU_ARGS, **_MXU_ARGS,
             precomp=[_P] * 7 + _DIMS + [_F, _F, _P] + EPILOGUE_ARGS
             + VARIANT_ARGS + [_P])


def kernel_entry(kind: str, dtype=torch.float32, adaptive: bool = False,
                 one_pass: bool = False):
    """The library and C entry point of FT kernel kind ``kind``'s build
    for ``dtype`` operands (torch.float32, torch.bfloat16 (fp8 runs it on
    the widened operands) or torch.int8 (B3, B4, static)), static or
    ``adaptive``; f32 in one TF32 pass with ``one_pass`` (the ``*_tf32``
    libraries)."""
    if one_pass and dtype != torch.float32:
        raise ValueError(f"one TF32 pass is an f32 build, not {dtype}")
    if dtype == torch.bfloat16:
        libs = ADAPTIVE_BF16_LIBS if adaptive else BF16_LIBS
        return libs[kind], ENTRY_POINTS[kind] + "_bf16"
    return (F32_LIBS[kind] + ("_adaptive" if adaptive else "")
            + ("_tf32" if one_pass else ""),
            ENTRY_POINTS[kind] + ("_int8" if dtype == torch.int8 else ""))


def _bind_kind(kind, dtype=torch.float32, adaptive=False, one_pass=False):
    lib, entry = kernel_entry(kind, dtype, adaptive, one_pass)
    return bind(library(lib), entry, _ARGS[kind])


@functools.lru_cache(maxsize=None)
def _entries(adaptive: bool = False, one_pass: bool = False):
    """The C entry points of the static f32 build (``adaptive=False``: B2-B8,
    and B3's and B4's int8 builds by (kind, torch.int8)) or of the adaptive
    one (``FTSG_ADAPTIVE``: B3-B8), by kernel kind; with ``one_pass`` those
    of its one-TF32-pass build (``FTSG_ONE_PASS``, f32 alone)."""
    suffix = ("_adaptive" if adaptive else "") + ("_tf32" if one_pass else "")
    build(tuple(n + suffix for n in FT_LIBS))
    entries = {kind: _bind_kind(kind, adaptive=adaptive, one_pass=one_pass)
               for kind in ENTRY_POINTS if not adaptive or kind != "precomp"}
    if not adaptive and not one_pass:  # int8 (the exact mode): B3, B4
        for kind in ("rowcol", "global"):
            entries[kind, torch.int8] = _bind_kind(kind, torch.int8)
    return entries


@functools.lru_cache(maxsize=None)
def _bf16_entries(adaptive: bool = False):
    """The C entry points of the bf16 builds (bf16 operands, and fp8
    widened), by (kind, torch.bfloat16): the static ones of B2-B8
    (``FTSG_BF16``) or the adaptive ones of B3-B8 (``FTSG_ADAPTIVE`` with
    ``FTSG_BF16``), each built and loaded on the first launch of its
    build, apart from :func:`_entries`: an f32 call neither waits on these
    builds nor needs them."""
    libs = ADAPTIVE_BF16_LIBS if adaptive else BF16_LIBS
    build(tuple(dict.fromkeys(libs.values())))  # in parallel, then load
    return {(k, torch.bfloat16): _bind_kind(k, torch.bfloat16, adaptive)
            for k in libs}


def _check_rows(shape, a, b, ma, mb=None, n_a=1) -> None:
    """The moment-row operands of an mxu kernel (``_tile_moments``): with
    f32 A and B, A's (M/bm, n_a, K) and B's (N/bn, 1, K) in f32; with bf16
    A and B, three bf16 terms of each, (M/bm, 3 n_a, K) and (N/bn, 3, K).
    Operands of any other dtype carry no moment rows."""
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{a.dtype} operands carry no moment rows: the mxu"
                         " kernels B6-B8 take float32 or bfloat16 operands")
    (m, k), n = a.shape, b.shape[0]
    t = 3 if a.dtype == torch.bfloat16 else 1
    for rows, want in ((ma, (m // shape.bm, t * n_a, k)),
                       (mb, (n // shape.bn, t, k))):
        if rows is not None and rows.dtype != a.dtype:
            raise ValueError(f"{rows.dtype} moment rows with {a.dtype}"
                             " operands: the rows take the operands' dtype")
        if rows is not None and tuple(rows.shape) != want:
            raise ValueError(f"moment rows {tuple(rows.shape)}, expected {want}")


def _launch(wrapper, name, shape, a, b, c, extra_in, extra_args, alpha, beta,
            scalars, adaptive=False, epi=None, bias=None,
            axes: LaunchAxes = LaunchAxes()):
    """Launch entry point ``name`` of the static or the adaptive build on
    validated operands, A and B f32 or bf16 (B2-B8 of the static build,
    B3-B8 of the adaptive one) or fp8 (B2-B5) or (static build, B3 and B4)
    int8, and count it on ``wrapper``: ``launches`` (f32, static),
    ``adaptive_launches`` (the adaptive build), and ``bf16_launches``,
    ``fp8_launches`` or ``int8_launches`` by dtype; an adaptive bf16 or fp8
    launch counts in both of its counters; a non-identity epilogue ``epi``
    (with its padded bias row ``bias``), applied by the kernel's store after
    its checks, also in ``epilogue_launches``; ``axes`` the CTA raster
    (``common.LaunchAxes.args``; ``shape`` is the grid step's) and the
    build: one TF32 pass (f32 precision "default", the ``*_tf32``
    libraries) with ``axes.one_pass``, a launch also counted in
    ``one_pass_launches``. Raises on a launch error.
    fp8 A and B are widened to bf16, which holds every e4m3 value exactly,
    and run the bf16 build: the same products and checksums as the e4m3
    operands' (e4m3 wgmma keeps ~13 bits of a k step's sum, and a
    correction writes a column's worth of that error into the element).
    Returns (out, det, unc)."""
    more, rows = ((), extra_in) if name in _MXU_ARGS else (extra_in, ())
    dims = check_operands(shape, a, b, c, *more, rows=rows)
    epi_args = epilogue_args(epi, bias, c.shape[1], c.device)
    fp8 = a.dtype == torch.float8_e4m3fn
    dtype = torch.bfloat16 if fp8 else a.dtype
    if axes.one_pass and dtype != torch.float32:
        raise ValueError(f"one TF32 pass is an f32 build, not {a.dtype}")
    entries = (_bf16_entries(adaptive) if dtype == torch.bfloat16
               else _entries(adaptive, axes.one_pass))
    if dtype != torch.float32 and (name, dtype) not in entries:
        raise NotImplementedError(
            f"kernel {name!r} has no {str(a.dtype).removeprefix('torch.')}"
            " build" + (" (adaptive)" if adaptive else "") + ": bf16 runs"
            " B2-B8 (B3-B8 under threshold='adaptive'), fp8 the vpu"
            " encodes' B2-B5, int8 B3 and B4 under the static build")
    if fp8:
        a, b = (x.to(torch.bfloat16, memory_format=torch.contiguous_format)
                for x in (a, b))
    sc = np.ascontiguousarray(scalars, np.float32)  # taken by value
    if sc.shape != (8,):
        raise ValueError(f"the scalar argument has 8 slots, got {sc.shape}")
    out = torch.empty_like(c)
    grid = (c.shape[0] // shape.bm, c.shape[1] // shape.bn)
    det = torch.empty(grid, dtype=torch.int32, device=c.device)
    unc = torch.empty_like(det)
    fn = entries[name] if dtype == torch.float32 else entries[name, dtype]
    noise = () if name == "precomp" else (
        full_run_log2(a.shape[1] // shape.bk, shape.bk, shape.bm, shape.bn),
        NOISE_C_RAND, NOISE_C_BIAS)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
            *(t.data_ptr() for t in extra_in), out.data_ptr(), det.data_ptr(),
            unc.data_ptr(), *dims, *extra_args, alpha, beta, sc.ctypes.data,
            *noise, *epi_args, *axes.args(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if epi is not None and not epi.is_identity:
        wrapper.epilogue_launches += 1
    if axes.one_pass:
        wrapper.one_pass_launches += 1
    if adaptive:
        wrapper.adaptive_launches += 1
    if fp8:
        wrapper.fp8_launches += 1
    elif dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    elif dtype == torch.int8:
        wrapper.int8_launches += 1
    elif not adaptive:
        wrapper.launches += 1
    check_launch(rc, fn.__name__ + (" (adaptive build)" if adaptive else ""))
    return out, det, unc


def ft_weighted_kernel(a, b, c, expm, shape: KernelShape, alpha, beta,
                       scalars, epi=None, bias=None,
                       axes: LaunchAxes = LaunchAxes()):
    """B2 on operands padded to the tile, with the (gm, 3, N) expected
    moments ``expm``; ``scalars`` the (8,) f32 scalar argument, a host array
    (the plain versions also take a CPU tensor); ``epi`` the fused epilogue
    (an ``EpilogueSpec`` or None) and ``bias`` its padded (N,)
    bias row (``common.pad_bias``); ``axes`` the launch's variant axes and
    precision (``common.LaunchAxes``; ``shape`` the grid step's,
    ``common.step_shape``), as for every wrapper below. Returns
    (out, det, unc). A CPU tensor runs the plain version."""
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 expm=expm, epi=epi, bias=bias, axes=axes)
    return _launch(ft_weighted_kernel, "precomp", shape, a, b, c, (expm,), (),
                   alpha, beta, scalars, epi=epi, bias=bias, axes=axes)


def ft_weighted_running_kernel(a, b, c, shape: KernelShape, alpha, beta,
                               scalars, check_every: int, adaptive=False,
                               epi=None, bias=None,
                               axes: LaunchAxes = LaunchAxes()):
    """B5: the weighted check every ``check_every`` K steps and after the
    last, with running in-kernel moments; ``adaptive`` runs the adaptive
    build (each sub-tile's thresholds from its running moments and slot
    7's margin). Returns (out, det, unc)."""
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 check_every=check_every, adaptive=adaptive,
                                 epi=epi, bias=bias, axes=axes)
    return _launch(ft_weighted_running_kernel, "running", shape, a, b, c, (),
                   (check_every,), alpha, beta, scalars, adaptive, epi, bias,
                   axes)


def ft_rowcol_kernel(a, b, c, shape: KernelShape, alpha, beta, scalars,
                     check_every: int, multifault: bool, adaptive=False,
                     epi=None, bias=None, axes: LaunchAxes = LaunchAxes()):
    """B3: the rowcol check every ``check_every`` K steps and after the
    last (``adaptive``: as B5). Returns (out, det, unc)."""
    if a.device.type == "cpu":
        return ft_rowcol_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, multifault, adaptive=adaptive,
                               epi=epi, bias=bias, axes=axes)
    return _launch(ft_rowcol_kernel, "rowcol", shape, a, b, c, (),
                   (check_every, int(multifault)), alpha, beta, scalars,
                   adaptive, epi, bias, axes)


def ft_global_kernel(a, b, c, shape: KernelShape, alpha, beta, scalars,
                     check_every: int, adaptive=False, epi=None, bias=None,
                     axes: LaunchAxes = LaunchAxes()):
    """B4: the detect-only scalar check every ``check_every`` K steps and
    after the last, encoded from the staged chunks (``adaptive``: as B5).
    Returns (out, det, unc), unc equal to det."""
    if a.device.type == "cpu":
        return ft_global_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, adaptive=adaptive,
                               epi=epi, bias=bias, axes=axes)
    return _launch(ft_global_kernel, "global", shape, a, b, c, (),
                   (check_every,), alpha, beta, scalars, adaptive, epi, bias,
                   axes)


def ft_global_mxu_kernel(a, b, c, ma, mb, shape: KernelShape, alpha, beta,
                         scalars, check_every: int, adaptive=False, epi=None,
                         bias=None, axes: LaunchAxes = LaunchAxes()):
    """B8: B4's check with ``t_exp`` from A's and B's plain moment rows
    ``ma`` (M/bm, 1, K) and ``mb`` (N/bn, 1, K) (``adaptive``: as B5, the
    moments of A's and B's own rows). Returns (out, det, unc)."""
    _check_rows(shape, a, b, ma, mb)
    if a.device.type == "cpu":
        return ft_global_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, moments=(ma, mb),
                               adaptive=adaptive, epi=epi,
                               bias=bias, axes=axes)
    return _launch(ft_global_mxu_kernel, "global_mxu", shape, a, b, c,
                   (ma, mb), (check_every,), alpha, beta, scalars, adaptive,
                   epi, bias, axes)


def ft_fused_kernel(a, b, c, ma, shape: KernelShape, alpha, beta, scalars,
                    check_every: int, adaptive=False, epi=None, bias=None,
                    axes: LaunchAxes = LaunchAxes()):
    """B6: B5's weighted check every ``check_every`` K steps and after the
    last, the expected moments encoded from A's moment rows ``ma``
    (M/bm, 3, K) (``adaptive``: as B8). Returns (out, det, unc)."""
    _check_rows(shape, a, b, ma, n_a=3)
    if a.device.type == "cpu":
        return ft_weighted_plain(a, b, c, shape, alpha, beta, scalars,
                                 check_every=check_every, moments=ma,
                                 adaptive=adaptive,
                                 epi=epi, bias=bias, axes=axes)
    return _launch(ft_fused_kernel, "fused", shape, a, b, c, (ma,),
                   (check_every,), alpha, beta, scalars, adaptive, epi, bias,
                   axes)


def ft_rowcol_mxu_kernel(a, b, c, ma, mb, shape: KernelShape, alpha, beta,
                         scalars, check_every: int, multifault: bool,
                         adaptive=False, epi=None, bias=None,
                         axes: LaunchAxes = LaunchAxes()):
    """B7: B3's rowcol check, the expected sums encoded from A's plain and
    w moment rows ``ma`` (M/bm, 2, K) and B's plain rows ``mb``
    (N/bn, 1, K) (``adaptive``: as B8). Returns (out, det, unc)."""
    _check_rows(shape, a, b, ma, mb, n_a=2)
    if a.device.type == "cpu":
        return ft_rowcol_plain(a, b, c, shape, alpha, beta, scalars,
                               check_every, multifault, moments=(ma, mb),
                               adaptive=adaptive, epi=epi,
                               bias=bias, axes=axes)
    return _launch(ft_rowcol_mxu_kernel, "rowcol_mxu", shape, a, b, c,
                   (ma, mb), (check_every, int(multifault)), alpha, beta,
                   scalars, adaptive, epi, bias, axes)


for _w in (ft_weighted_kernel, ft_weighted_running_kernel, ft_rowcol_kernel,
           ft_global_kernel, ft_global_mxu_kernel, ft_fused_kernel,
           ft_rowcol_mxu_kernel):
    _w.launches = 0
    _w.adaptive_launches = 0
    _w.bf16_launches = 0
    _w.fp8_launches = 0
    _w.int8_launches = 0
    _w.epilogue_launches = 0
    _w.one_pass_launches = 0


def run_kernel(kind: str, shape: KernelShape, a, b, c, extra, alpha, beta,
               scalars, check_every: int, multifault: bool = False,
               plain: bool = False, adaptive: bool = False, epi=None,
               bias=None, axes: LaunchAxes = LaunchAxes()):
    """One launch of kernel ``kind`` (:func:`_plan`) on padded operands,
    with its wrapper-side inputs ``extra`` (:func:`kernel_inputs`);
    ``plain=True`` runs its plain version instead, on any device;
    ``adaptive`` the adaptive build of B3-B8 (B2 has none); ``epi`` the
    fused epilogue with its padded bias row ``bias``; ``axes`` the variant
    axes and precision (``common.LaunchAxes``; ``shape`` the grid step's).
    Returns (out, det, unc)."""
    args = (shape, alpha, beta, scalars)
    ad = dict(adaptive=adaptive)
    ep = dict(epi=epi, bias=bias, axes=axes)
    if kind == "precomp":
        if adaptive:
            raise ValueError("B2 has no adaptive build: the adaptive weighted"
                             " strategy runs B5 (_plan)")
        if plain:
            return ft_weighted_plain(a, b, c, *args, expm=extra[0], **ep)
        return ft_weighted_kernel(a, b, c, *extra, *args, **ep)
    if kind == "running":
        if plain:
            return ft_weighted_plain(a, b, c, *args, check_every=check_every,
                                     **ad, **ep)
        return ft_weighted_running_kernel(a, b, c, *args, check_every, **ad,
                                          **ep)
    if kind == "fused":
        if plain:
            return ft_weighted_plain(a, b, c, *args, check_every=check_every,
                                     moments=extra[0], **ad, **ep)
        return ft_fused_kernel(a, b, c, *extra, *args, check_every, **ad, **ep)
    if kind in ("rowcol", "rowcol_mxu"):
        if plain:
            return ft_rowcol_plain(a, b, c, *args, check_every, multifault,
                                   moments=extra or None, **ad, **ep)
        if kind == "rowcol":
            return ft_rowcol_kernel(a, b, c, *args, check_every, multifault,
                                    **ad, **ep)
        return ft_rowcol_mxu_kernel(a, b, c, *extra, *args, check_every,
                                    multifault, **ad, **ep)
    if kind in ("global", "global_mxu"):
        if plain:
            return ft_global_plain(a, b, c, *args, check_every,
                                   moments=extra or None, **ad, **ep)
        if kind == "global":
            return ft_global_kernel(a, b, c, *args, check_every, **ad, **ep)
        return ft_global_mxu_kernel(a, b, c, *extra, *args, check_every, **ad,
                                    **ep)
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
    precision: str = "highest",
    in_dtype="float32",
    multifault: Optional[bool] = None,
    device=None,
    variant=None,
    epilogue=None,
):
    """Build the fused-ABFT SGEMM for one named shape (or ``KernelShape``).

    Returns ``fn(a, b, c, inject=None, bias=None) -> FtSgemmResult``;
    ``inject`` is an :class:`InjectionSpec` (default: none). ``strategy`` is ``"weighted"``,
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

    ``in_dtype="bfloat16"`` rounds A and B to bf16 on the device, and
    ``"float8_e4m3fn"`` (aliases ``fp8``, ``fp8_e4m3``, ``float8_e4m3``)
    to e4m3 as the JAX package does (NaN past 464); C, the accumulator, the
    checksums (of the rounded values), detection and correction stay f32,
    and the thresholds are f32's ("auto" from the rounded operands). The
    tile is the paper's in every dtype; a 1-byte operand's rows are stored
    16 bytes apart (``common.align_rows16``).

    ``in_dtype="int8"`` truncates A and B to int8 (pass integer-valued
    data) and runs the exact mode of the rowcol or global strategy (B3,
    B4): int32 accumulator and checksums wrapping mod 2^32, multifault off
    (ops/ft_sgemm.py:1802-1805), ``"auto"`` from the int8 values, and
    ``"adaptive"`` the constant 0.5 of the exact kernels, on the static
    build. A 1-byte operand's rows are stored 16 bytes aligned
    (``common.align_rows16``).

    ``threshold="adaptive"`` in bf16 and fp8 runs the adaptive bf16 builds
    of B5 (weighted, at every cadence), B3 (rowcol) and B4 (global), the
    thresholds f32's formula on the moments of the rounded operands.

    bf16 runs the mxu encodes too (``encode="mxu"``, ``strategy="fused"``:
    the bf16 builds of B6-B8, which load the wrapper's hi / lo / lo2 moment
    rows) under every threshold mode, ``"adaptive"`` on their adaptive bf16
    builds, which sum the moments of the rounded operands' own rows (not
    the term rows). fp8 with the mxu encodes is illegal (``ValueError``).

    ``epilogue`` (an :class:`~ft_sgemm_tpu_torch.configs.EpilogueSpec` or a
    spelling like ``"bias+relu"`` or ``"bias+gelu+qint8x0.5"``) fuses a
    bias add, relu or gelu, and an int8 or fp8 quantize-rescale into the
    kernel's store, strictly after detect and correct
    (ops/ft_sgemm.py:1614-1621 of the JAX package): the checksums verify
    the pre-epilogue accumulator, so the grids are those of the identity.
    A fused bias is passed per call, ``fn(a, b, c, inject, bias=v)`` with
    ``v`` of length N. ``variant`` (a
    :class:`~ft_sgemm_tpu_torch.configs.KernelVariant`, a dict of its fields
    or None) carries the cadence and the epilogue; an explicit
    ``check_every`` or ``epilogue`` wins over the variant's. It carries the
    variant axes too (ft_sgemm_tpu/ops/ft_sgemm.py:1725-1799):
    ``pipeline_depth=3`` makes a grid step the two-panel K window ``kwin =
    2 bk`` (``common.step_shape``): the operands are padded to it, and the
    cadence, the injection schedule (ordinal ``k // every + 3 i + 5 j`` of
    grid step k) and the adaptive thresholds' run length count grid steps,
    so the checks and faults fall at other columns than at depth 2; the
    kernels take ``kwin`` as their bk, and the plain versions multiply each
    panel of a step on its own (``sub_panels``). ``grid_order="nm"`` walks
    the CTAs M tile first (``csrc/abft_common.cuh::Variant``; the grids land by tile
    all the same), and ``dim_semantics="arbitrary"``, a Mosaic scheduling
    hint with no CUDA counterpart, runs the same kernel. ``ring_overlap``
    is ignored, as the JAX package's single-device factories ignore it.

    ``precision`` (the JAX package's names, ``common.check_precision``):
    with f32, ``"highest"`` and ``"high"`` run the 3xTF32 kernels (the
    TPU's ``"high"`` is a three-pass product, and 3xTF32 is the port's),
    ``"default"`` the same kernels with one TF32 wgmma per k step, ``hi .
    hi``, for the product and for the expected sums that ride it (the
    wrapper's precomputed moments of B2 stay FP32, as the JAX package
    computes them at "highest"); their residuals then carry TF32's
    rounding, so a static threshold suits them and the noise model of
    "auto" and "adaptive" (f32's) does not. A bf16, fp8 or int8 product is
    one pass whatever is asked.
    """
    if isinstance(threshold, str):
        threshold_mode = threshold
    else:
        threshold_mode = "static"
    in_dtype = check_kernel_legality(
        strategy=strategy, encode=encode, in_dtype=in_dtype,
        threshold_mode=threshold_mode, multifault=multifault)
    dtype = resolve_in_dtype(in_dtype, allow_low_precision=True)
    one_pass = check_precision(precision, dtype)
    if strategy == "fused":
        encode = "mxu"  # the fused strategy IS the weighted mxu encode
    adaptive = threshold_mode == "adaptive"
    exact = dtype == torch.int8
    var = canonical_variant(variant)
    if epilogue is not None:
        var = dataclasses.replace(
            var, epilogue=EpilogueSpec.parse(epilogue).spelling)
    check_variant(var)
    if check_every is None:
        check_every = var.check_every
    epi = var.epilogue_spec
    thresholds = (0.0,) * 3
    if exact:
        # Exact integer residuals: clean ones are 0, so "adaptive" is the
        # half-ulp (ops/ft_sgemm.py:606-611, 890-893) in the static build's
        # slots, and no moment rides the weighted checksum.
        multifault = False
        if adaptive:
            thresholds = (0.5,) * 3
    if threshold_mode == "static":
        if threshold == "static":
            threshold = REFERENCE_THRESHOLD
        thresholds = (tuple(float(t) for t in threshold)
                      if isinstance(threshold, (tuple, list))
                      else (float(threshold),) * 3)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    step = step_shape(shape, var)
    axes = launch_axes(var, one_pass)
    dev = resolve_device(device)
    bm, bn, bk = step.block  # bk: the K window of one grid step

    def scalars_for(inject, a, b, c):
        if threshold_mode != "auto":
            return scalar_operand(inject, thresholds,
                                  threshold_margin if adaptive and not exact
                                  else 0.0)
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

    def fn(a, b, c, inject: Optional[InjectionSpec] = None,
           bias=None) -> FtSgemmResult:
        inject = inject or InjectionSpec.none()
        a, b = (as_operand(x, dtype, dev) for x in (a, b))
        c = as_f32(c, dev)
        m, n = c.shape
        row = bias_operand(fn.__name__, epi, bias, n, bn, dev)
        ap, bp = (align_rows16(pad_to(x, t, bk))
                  for x, t in ((a, bm), (b, bn)))
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
        extra = kernel_inputs(kind, ap, bp, step)
        if isinstance(scalars, torch.Tensor) and scalars.is_cuda:
            ready.synchronize()
            scalars = readback["host"].numpy().copy()
        out, det, unc = run_kernel(kind, step, ap, bp, cp, extra, alpha,
                                   beta, scalars, ce, mf,
                                   adaptive=adaptive and not exact, epi=epi,
                                   bias=row, axes=axes)
        return FtSgemmResult(out[:m, :n], det, unc)

    fn.__name__ = (f"ft_sgemm_{shape.name}_{strategy}"
                   + ("_mxu" if encode == "mxu" and strategy != "fused" else "")
                   + ("_adaptive" if adaptive else "")
                   + ("" if in_dtype == "float32" else f"_{in_dtype}")
                   + ("_epi_" + var.epilogue.replace("+", "_")
                      if var.epilogue != "none" else ""))
    fn.shape_config = shape
    fn.strategy = strategy
    fn.encode = encode
    fn.in_dtype = in_dtype
    fn.threshold_mode = threshold_mode
    fn.precision = precision
    fn.variant = var
    fn.epilogue = var.epilogue
    return fn


def ft_sgemm(a, b, c, shape: KernelShape | str = "huge", *, alpha=1.0,
             beta=-1.5, inject: Optional[InjectionSpec] = None,
             strategy: str = "weighted", encode: str = "vpu",
             threshold=REFERENCE_THRESHOLD,
             threshold_margin: float = DEFAULT_THRESHOLD_MARGIN,
             check_every: Optional[int] = None, precision: str = "highest",
             in_dtype="float32", multifault: Optional[bool] = None,
             device=None, variant=None, epilogue=None,
             bias=None) -> FtSgemmResult:
    """One-shot fused-ABFT SGEMM (see :func:`make_ft_sgemm`)."""
    return make_ft_sgemm(
        shape, alpha=alpha, beta=beta, strategy=strategy, encode=encode,
        threshold=threshold, threshold_margin=threshold_margin,
        check_every=check_every, precision=precision, in_dtype=in_dtype,
        multifault=multifault, device=device, variant=variant,
        epilogue=epilogue,
    )(a, b, c, inject, bias=bias)

"""Kernels B7 (``rowcol`` with encode mxu) and B8 (``global`` with encode
mxu) as the 3xTF32 wgmma kernel computes them: B3's and B4's sub-tiled
kernel (``csrc/ft_sgemm_running.cuh``) with the checksum rows that the
wrapper builds (``ops/ft_sgemm.kernel_inputs``: A's (gm, 2, K) plain and w
rows, B's (gn, 1, K) plain rows) loaded by TMA, modelled on the CPU by
``ops/tf32x3.ft_rowcol_tf32x3`` and ``ft_global_tf32x3`` with ``rows``:
the expected row sums from B's loaded f32 band rows split hi / lo, B7's
expected column sums from the first one (two with multifault) of A's rows.

(a) Against the JAX package: ``ft_sgemm_tpu.make_ft_sgemm(strategy=
"rowcol" | "global", encode="mxu")`` (``_ft_kernel_rowcol_mxu``,
``_ft_kernel_global_mxu``) in interpret mode, as its own tests run it, at
128x128x128 and 256x128x128 (the JAX package takes only multiples of 128)
on sizes that are not multiples of the tile, clean, reference-like and
with ``col_stride=0``; the ``detections`` and ``uncorrectable`` grids must
be EQUAL, and C must pass ``verify_matrix`` (0.01 absolute AND relative)
against the JAX oracle on every tile the JAX package reports correctable
(rowcol; multifault off and on) and against the JAX package's own C
everywhere (global keeps its faults). (b) At the port's six program tiles,
which the JAX package cannot run, the models are held to the port's plain
versions (``ft_rowcol_plain`` and ``ft_global_plain`` with ``moments``,
themselves held to the JAX package in tests/test_torch_ft_mxu.py and
tests/test_torch_ft_global.py) with the same grid equality and C
tolerance, at the program's cadence and at one whose checks fall inside a
32-column stage. (c) The layout of the loaded rows: B's band-row box fills
rows 128 .. 128 + NBN - 1 of B's stage with bands tj0 .. in the swizzle
that the splitter warps and wgmma read, the rest zero; A's moment box puts
moment v of row band b at moment row MOM b + v, zero up to R, so that the
check reads each band's expected sums where it looks for them. (d) The
card tests (marker ``cuda``) hold the CUDA kernels against their plain
versions at every tile, ragged sizes, both multifault settings and
mid-stage checks.
"""

import numpy as np
import pytest
import torch
from test_torch_subtile_rowcol import (  # noqa: F401
    JAX_TILES,
    SCHEDULES,
    SUBTILES,
    _hold_c,
    _inputs,
    _jinject,
    _one_torch_thread,
    cuda_device,
)

import ft_sgemm_tpu as jft
from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.interop import from_reference
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import tf32x3
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

PROGRAM_TILES = ("small", "medium", "large", "tall", "wide", "huge")
# (kernel kind, strategy, multifault) of each modelled kernel: B7 both
# ways, B8.
KERNELS = {"rowcol_mxu": ("rowcol_mxu", "rowcol", False),
           "rowcol_mxu_mf": ("rowcol_mxu", "rowcol", True),
           "global_mxu": ("global_mxu", "global", False)}


def _operands(a, b, c, jinj, shape):
    """The port's padded operands, scalar operand and moment rows."""
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    return ap, bp, cp, scalar_operand(ops.inject, ops.thresholds), ops.inject


def _model(kernel, shape, ap, bp, cp, sc, check_every):
    kind, strategy, mf = KERNELS[kernel]
    rows = ft.kernel_inputs(kind, ap, bp, shape)
    if strategy == "global":
        return tf32x3.ft_global_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc,
                                       check_every, rows=rows)
    return tf32x3.ft_rowcol_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc,
                                   check_every, mf, rows=rows)


def _plain(kernel, shape, ap, bp, cp, sc, check_every):
    kind, _, mf = KERNELS[kernel]
    return ft.run_kernel(kind, shape, ap, bp, cp,
                         ft.kernel_inputs(kind, ap, bp, shape), 1.0, -1.5, sc,
                         check_every, mf, plain=True)


@pytest.mark.parametrize("tile", list(JAX_TILES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_mxu_model_matches_jax(tile, kernel, schedule):
    jshape, shape = JAX_TILES[tile]
    _, strategy, mf = KERNELS[kernel]
    dims = (300, 200, 512)
    a, b, c = _inputs(*dims, seed=29)
    jinj = _jinject(schedule, dims[2], jshape.bk)
    check_every = 2   # two checks in the 4 steps, as the program's ~20 do
    kw = dict(multifault=mf) if strategy == "rowcol" else {}
    jres = jft.make_ft_sgemm(jshape, strategy=strategy, encode="mxu",
                             check_every=check_every, **kw)(a, b, c, jinj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    ap, bp, cp, sc, _ = _operands(a, b, c, jinj, shape)
    out, det, unc = _model(kernel, shape, ap, bp, cp, sc, check_every)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(unc.numpy(), junc)
    if strategy == "global":
        # Detect only: both keep the same faults in C.
        _hold_c(np.asarray(jres.c), out.numpy(), np.ones_like(junc, bool),
                shape.bm, shape.bn, dims)
        assert (jdet == junc).all()
    else:
        _hold_c(np.asarray(jft.sgemm_reference(a, b, c)), out.numpy(),
                junc == 0, shape.bm, shape.bn, dims)
    if schedule == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    elif schedule == "reference_like":
        # Every step faults: two faults in an interval need multifault.
        assert (jdet > 0).all() and (not mf or junc.sum() == 0)


@pytest.mark.parametrize("name", PROGRAM_TILES)
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("cadence", ["program", "mid_stage"])
def test_mxu_model_matches_plain_at_port_tiles(name, kernel, schedule,
                                               cadence):
    shape = SHAPES[name]
    _, strategy, _ = KERNELS[kernel]
    dims = (200, 136, 256)
    a, b, c = _inputs(*dims, seed=13)
    ap, bp, cp, sc, inj = _operands(a, b, c,
                                    _jinject(schedule, dims[2], shape.bk),
                                    shape)
    nk = ap.shape[1] // shape.bk
    if cadence == "program":
        ce = ft._plan(strategy, None, None, inj, nk, shape.bn, "mxu")[1]
    else:
        # Three bk steps: a check every 24 (48 at small) K columns, inside
        # the 32-column stages.
        ce = 3
    want = _plain(kernel, shape, ap, bp, cp, sc, ce)
    got = _model(kernel, shape, ap, bp, cp, sc, ce)
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    assert torch.equal(got[2], want[2]), (got[2], want[2])
    mask = (np.ones_like(want[2].numpy(), bool) if strategy == "global"
            else want[2].numpy() == 0)
    _hold_c(want[0].numpy(), got[0].numpy(), mask, shape.bm, shape.bn,
            ap.shape)
    if schedule == "reference_like":
        assert want[1].sum() > 0
        if strategy == "rowcol" and (cadence == "program"
                                     or KERNELS[kernel][2]):
            assert want[2].sum() == 0


def _swizzled(row: int, k: int) -> int:
    """The float offset at which TMA's 128-byte swizzle puts column k of
    row ``row`` of a box that starts on a 1024-byte boundary: the 16-byte
    chunk k / 4 XOR the address bits 7-9 (the row within its 8-row group
    of 128-byte rows)."""
    addr = row * 128 + (k // 4) * 16
    return (addr ^ (((addr >> 7) & 7) << 4)) // 4 + k % 4


def _splitter_offset(n: int, k: int) -> int:
    # WgSmem::split_b / sum_rows: n * SK + (((k >> 2) ^ (n & 7)) << 2) + (k & 3).
    return n * 32 + (((k >> 2) ^ (n & 7)) << 2) + (k & 3)


def test_band_rows_keep_the_swizzle_of_b_stage():
    # B's band-row box lands at row 128 of B's stage (16384 bytes in, a
    # swizzle atom boundary): TMA's swizzle there is the one the splitter
    # warps write for B3 and B4 and wgmma reads for all four kernels.
    for j in range(8):
        for k in range(tf32x3.STAGE):
            assert _swizzled(128 + j, k) == _splitter_offset(128 + j, k)
            box_base = 128 * 32   # the box's own row 0 is B's row 128
            assert box_base + _swizzled(j, k) == _splitter_offset(128 + j, k)


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
def test_band_row_box_fills_the_cta_bands(sub):
    sbm, sbn = sub
    nbn = 128 // sbn
    k = 72   # a ragged last stage: TMA's zero fill past K
    _, b, _ = _inputs(8, 3 * 128 + 40, k, seed=3)
    bp = pad_to(torch.from_numpy(b), sbn, 8)
    mb = ft._tile_moments(bp, sbn, 1)               # (gn, 1, K)
    gn = mb.shape[0]
    for tj0 in range(0, gn, nbn):
        for k0 in range(0, k, tf32x3.STAGE):
            rows = tf32x3.loaded_rows(mb, tj0, nbn, 1, 8, k0)
            assert rows.shape == (8, tf32x3.STAGE)
            for j in range(8):
                want = torch.zeros(tf32x3.STAGE)
                if j < nbn and tj0 + j < gn:
                    cols = mb[tj0 + j, 0, k0:k0 + tf32x3.STAGE]
                    want[:cols.shape[0]] = cols
                assert torch.equal(rows[j], want), (tj0, k0, j)
    # The product's extra column 128 + j is A times band j's sums: each
    # row's expected sum over band tj0 + j (the check's r_exp).
    a = torch.from_numpy(_inputs(16, 8, k, seed=4)[0])
    s_b = tf32x3.loaded_rows(mb, 0, nbn, 1, 8, 0)
    exp_r = a[:, :tf32x3.STAGE] @ s_b.T
    for j in range(nbn):
        band = bp[j * sbn:(j + 1) * sbn, :tf32x3.STAGE]
        assert torch.allclose(exp_r[:, j], a[:, :tf32x3.STAGE] @ band.sum(0),
                              rtol=1e-5, atol=1e-3)
    assert (exp_r[:, nbn:] == 0).all()


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
@pytest.mark.parametrize("mf", [False, True])
def test_moment_box_orders_rows_as_the_check_reads(sub, mf):
    # B7's 3-D box (SK, MOM, NBM) of the wrapper's (gm, 2, K) rows lands
    # moment v of row band b at moment row MOM b + v, where RowcolSplitCheck
    # reads it (cm.e[MOM * bb + v]); rows MOM * NBM .. R stay zero.
    sbm, _ = sub
    nbm, mom = 128 // sbm, 2 if mf else 1
    r = tf32x3.moment_rows(sbm, mom)
    assert r % 8 == 0 and mom * nbm <= r <= 24
    k = 96
    a, _, _ = _inputs(2 * 128 + 16, 8, k, seed=6)
    ap = pad_to(torch.from_numpy(a), sbm, 8)
    ma = ft._tile_moments(ap, sbm, 2)                # (gm, 2, K)
    gm = ma.shape[0]
    for ti0 in range(0, gm, nbm):
        for k0 in range(0, k, tf32x3.STAGE):
            rows = tf32x3.loaded_rows(ma, ti0, nbm, mom, r, k0)
            assert rows.shape == (r, tf32x3.STAGE)
            for b in range(nbm):
                for v in range(mom):
                    want = (ma[ti0 + b, v, k0:k0 + tf32x3.STAGE]
                            if ti0 + b < gm else torch.zeros(tf32x3.STAGE))
                    assert torch.equal(rows[mom * b + v], want)
            assert (rows[mom * nbm:] == 0).all()
    # E = B_tile . M^T: column MOM b + v is B's rows times band b's moment v.
    b_tile = torch.from_numpy(_inputs(8, 128, k, seed=7)[1])[:, :tf32x3.STAGE]
    e = b_tile @ tf32x3.loaded_rows(ma, 0, nbm, mom, r, 0).T
    w = torch.arange(1, sbm + 1, dtype=torch.float32)
    for b in range(nbm):
        band = ap[b * sbm:(b + 1) * sbm, :tf32x3.STAGE]
        for v in range(mom):
            s_a = (band * (w[:, None] ** v)).sum(0)
            assert torch.allclose(e[:, mom * b + v], b_tile @ s_a, rtol=1e-4,
                                  atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("dims,check_every", [
    ((200, 136, 256), 3),     # ragged M, N; checks inside a stage
    ((16, 300, 96), 1),       # M under one CTA; a check every bk step
    ((130, 70, 1000), 5),     # ragged M, N, K
])
def test_mxu_kernels_match_plain_on_card(cuda_device, name, kernel, dims,
                                         check_every):
    shape = SHAPES[name]
    kind, strategy, mf = KERNELS[kernel]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(*dims, seed=sum(dims) + 1),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    nk = a.shape[1] // shape.bk
    extra = ft.kernel_inputs(kind, a, b, shape)
    for inj in (InjectionSpec.none(),
                InjectionSpec.reference_like(dims[2], shape.bk),
                InjectionSpec(enabled=True, every=1, col_stride=0)):
        sc = scalar_operand(inj, (9500.0,) * 3)
        ce = min(check_every, nk)
        got = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, ce, mf)
        want = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, ce,
                             mf, plain=True)
        assert torch.equal(got[1], want[1]), (inj, got[1], want[1])
        assert torch.equal(got[2], want[2]), (inj, got[2], want[2])
        ok = (torch.ones_like(want[2], dtype=torch.bool) if strategy == "global"
              else want[2] == 0)
        ok = ok.repeat_interleave(shape.bm, 0).repeat_interleave(shape.bn, 1)
        assert verify_matrix(want[0][ok].cpu().numpy(), got[0][ok].cpu().numpy(),
                             verbose=False)[0]

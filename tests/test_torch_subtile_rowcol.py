"""Kernels B3 (``rowcol``) and B4 (``global``) as the 3xTF32 wgmma kernel
computes them: the paper's tile checked as a sub-tile of one 128 x 128 CTA
(``csrc/ft_sgemm_running.cuh``), the expected row sums as 8 extra columns
of the product (A times B's column-band sums) and B3's expected column sums
as a second tensor-core product, modelled on the CPU by
``ops/tf32x3.ft_rowcol_tf32x3`` and ``ft_global_tf32x3``.

(a) Against the JAX package: ``ft_sgemm_tpu.make_ft_sgemm(strategy=
"rowcol" | "global")`` in interpret mode, as its own tests run it, at
128x128x128 and 256x128x128 (the JAX package takes only multiples of 128)
on sizes that are not multiples of the tile; the ``detections`` and
``uncorrectable`` grids must be EQUAL, and C must pass ``verify_matrix``
(0.01 absolute AND relative) against the JAX oracle on every tile the JAX
package reports correctable (rowcol; multifault off and on) and against
the JAX package's own C everywhere (global keeps its faults). (b) At the
port's own tiles, which the JAX package cannot run, the model is held to
the port's plain versions (``ft_rowcol_plain``, ``ft_global_plain``, the
JAX tile algorithm, themselves held to the JAX package in
tests/test_torch_ft_sgemm.py and tests/test_torch_ft_global.py) with the
same grid equality, at the program's cadence and at one whose checks fall
inside a 32-column stage. (c) The row sums' fragment map: the extra
columns hold each (row, column band) once, in the quad of lanes that holds
the row, at the lane the check's shuffle reads. (d) The card tests (marker
``cuda``) hold the CUDA kernels against their plain versions at ragged
sizes, both multifault settings and mid-stage checks.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, KernelShape
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.interop import from_reference
from ft_sgemm_tpu_torch.ops import _build
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import tf32x3
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

JAX_TILES = {
    "t128": (JKernelShape("t128", 128, 128, 128, (0,) * 7), SHAPES["test"]),
    "t256x128": (JKernelShape("t256x128", 256, 128, 128, (0,) * 7),
                 KernelShape("t256x128", 256, 128, 128, (0,) * 7)),
}
SUBTILES = sorted(_build.subtiles())
# (strategy, multifault) of each modelled kernel: B3 both ways, B4.
KERNELS = {"rowcol": ("rowcol", False), "rowcol_mf": ("rowcol", True),
           "global": ("global", False)}
SCHEDULES = {
    "clean": None,
    "reference_like": "reference_like",
    "adversarial_same_column": dict(enabled=True, every=1, col_stride=0),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # The models run thousands of small torch ops; with several test
    # workers on one host, intra-op threads only contend.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (generate_random_matrix(m, k, rng=rng),
            generate_random_matrix(n, k, rng=rng),
            generate_random_matrix(m, n, rng=rng))


def _jinject(schedule, k, bk):
    kw = SCHEDULES[schedule]
    if kw == "reference_like":
        return JInjectionSpec.reference_like(k, bk)
    return JInjectionSpec(**(kw or {}))


def _model(kernel, shape, ap, bp, cp, sc, check_every):
    strategy, mf = KERNELS[kernel]
    if strategy == "global":
        return tf32x3.ft_global_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc,
                                       check_every)
    return tf32x3.ft_rowcol_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc,
                                   check_every, mf)


def _plain(kernel, shape, ap, bp, cp, sc, check_every):
    strategy, mf = KERNELS[kernel]
    return ft.run_kernel(strategy, shape, ap, bp, cp, (), 1.0, -1.5, sc,
                         check_every, mf, plain=True)


def _hold_c(want, got, mask, bm, bn, dims):
    ok = np.repeat(np.repeat(mask, bm, 0), bn, 1)[:dims[0], :dims[1]]
    good, nbad, first = verify_matrix(want[ok], got[:dims[0], :dims[1]][ok],
                                      verbose=False)
    assert good, f"{nbad} elements off, first at {first}"


@pytest.mark.parametrize("tile", list(JAX_TILES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_subtile_model_matches_jax(tile, kernel, schedule):
    jshape, shape = JAX_TILES[tile]
    strategy, mf = KERNELS[kernel]
    dims = (300, 200, 512)
    a, b, c = _inputs(*dims, seed=23)
    jinj = _jinject(schedule, dims[2], jshape.bk)
    check_every = 2   # two checks in the 4 steps, as the program's ~20 do
    kw = dict(multifault=mf) if strategy == "rowcol" else {}
    jres = jft.make_ft_sgemm(jshape, strategy=strategy,
                             check_every=check_every, **kw)(a, b, c, jinj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    out, det, unc = _model(kernel, shape, ap, bp, cp,
                           scalar_operand(ops.inject, ops.thresholds),
                           check_every)
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


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("cadence", ["program", "mid_stage"])
def test_subtile_model_matches_plain_at_port_tiles(name, kernel, schedule,
                                                   cadence):
    shape = SHAPES[name]
    strategy, mf = KERNELS[kernel]
    dims = (200, 136, 256)
    a, b, c = _inputs(*dims, seed=5)
    jinj = _jinject(schedule, dims[2], shape.bk)
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    sc = scalar_operand(ops.inject, ops.thresholds)
    nk = ap.shape[1] // shape.bk
    if cadence == "program":
        ce = ft._plan(strategy, None, None, ops.inject, nk, shape.bn)[1]
    else:
        # Three bk steps: a check every 24 (48 at small) K columns, inside
        # the 32-column stages (test's bk of 128 ends on a stage).
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
        # The program's cadence keeps one fault per interval; three bk
        # steps hold several, which rowcol corrects with multifault only.
        if strategy == "rowcol" and (cadence == "program" or mf):
            assert want[2].sum() == 0


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
def test_row_sums_land_in_the_rows_quad(sub):
    # RowcolSplitCheck / GlobalCheck read the expected sum of row h, band
    # j at lane (l & ~3) | (j >> 1) of the quad, extra element 2 h + (j & 1).
    sbm, sbn = sub
    nbn = 128 // sbn
    fm = tf32x3.row_sum_fragment_map(sbn)          # (256, 4, 2)
    rows = tf32x3.wgmma_fragment_map(128, 128)[:, [0, 2], 0]   # rows h = 0, 1
    held = fm[fm[..., 1] >= 0]
    flat = held[:, 0] * nbn + held[:, 1]
    assert torch.equal(flat.sort().values, torch.arange(128 * nbn))
    t = torch.arange(256)
    for j in range(nbn):
        src = (t // 32) * 32 + ((t % 32) & ~3 | (j >> 1))
        for h in range(2):
            got = fm[src, 2 * h + (j & 1)]
            assert (got[:, 1] == j).all()
            assert torch.equal(got[:, 0], rows[:, h])
    # The bands past the CTA's are zero rows of B's stage, never read.
    assert ((fm[..., 1] == -1).sum() == 256 * 4 - 128 * nbn)


@pytest.mark.parametrize("mf", [False, True])
def test_rowcol_moment_rows_fit_the_expected_product(mf):
    # B3's column side is B5's product with 1 (2 with multifault) moment
    # rows per row band; the row side adds 8 columns to the product.
    for sbm in sorted({m for m, _ in SUBTILES}):
        r = tf32x3.moment_rows(sbm, 2 if mf else 1)
        assert r % 8 == 0 and (2 if mf else 1) * 128 // sbm <= r <= 24


def test_mid_stage_cadence_reaches_inside_a_stage_for_rowcol():
    # The program's own rowcol / global cadence (26 bk steps of 8, 13 of
    # 16 at 4096) also ends checks inside a stage: 208 K columns.
    for name in ("small", "medium", "large", "tall", "wide", "huge"):
        shape = SHAPES[name]
        nk = 4096 // shape.bk
        inj = InjectionSpec.reference_like(4096, shape.bk)
        for strategy in ("rowcol", "global"):
            ce = ft._plan(strategy, None, None, inj, nk, shape.bn)[1]
            assert (ce * shape.bk) % tf32x3.STAGE != 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("dims,check_every", [
    ((200, 136, 256), 3),     # ragged M, N; checks inside a stage
    ((16, 300, 96), 1),       # M under one CTA; a check every bk step
    ((130, 70, 1000), 5),     # ragged M, N, K
])
def test_subtile_kernels_match_plain_on_card(cuda_device, name, kernel, dims,
                                             check_every):
    shape = SHAPES[name]
    strategy, mf = KERNELS[kernel]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(*dims, seed=sum(dims)),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    nk = a.shape[1] // shape.bk
    for inj in (InjectionSpec.none(),
                InjectionSpec.reference_like(dims[2], shape.bk),
                InjectionSpec(enabled=True, every=1, col_stride=0)):
        sc = scalar_operand(inj, (9500.0,) * 3)
        ce = min(check_every, nk)
        got = ft.run_kernel(strategy, shape, a, b, c, (), 1.0, -1.5, sc, ce, mf)
        want = ft.run_kernel(strategy, shape, a, b, c, (), 1.0, -1.5, sc, ce,
                             mf, plain=True)
        assert torch.equal(got[1], want[1]), (inj, got[1], want[1])
        assert torch.equal(got[2], want[2]), (inj, got[2], want[2])
        ok = (torch.ones_like(want[2], dtype=torch.bool) if strategy == "global"
              else want[2] == 0)
        ok = ok.repeat_interleave(shape.bm, 0).repeat_interleave(shape.bn, 1)
        assert verify_matrix(want[0][ok].cpu().numpy(), got[0][ok].cpu().numpy(),
                             verbose=False)[0]

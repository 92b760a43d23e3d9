"""Kernels B5 (``running``) and B6 (``fused``) as the 3xTF32 wgmma kernel
computes them: the paper's tile checked as a sub-tile of one 128 x 128 CTA
(``csrc/ft_sgemm_running.cuh``), modelled on the CPU by
``ops/tf32x3.ft_running_tf32x3``.

(a) Against the JAX package: ``ft_sgemm_tpu.make_ft_sgemm`` with a check
cadence under the step count runs ``_ft_kernel_weighted`` (weighted) or
``_ft_kernel_fused`` (fused) in interpret mode, as its own tests do. The
JAX package takes only tiles whose bm, bn and bk are multiples of 128, so
the comparison runs at 128x128x128 and 256x128x128 on sizes that are not
multiples of the tile; the ``detections`` and ``uncorrectable`` grids
must be EQUAL and C must pass ``verify_matrix`` (0.01 absolute AND
relative) against the JAX oracle on every tile the JAX package reports
correctable. (b) At the port's own tiles (small, medium, large, tall,
wide, huge, test), which the JAX package cannot run, the model is held to
the port's plain version (``ops/ft_sgemm.ft_weighted_plain``, the JAX
tile algorithm, itself held to the JAX package in
tests/test_torch_ft_sgemm.py and tests/test_torch_ft_mxu.py) with the same
grid equality, and C to the JAX oracle; the cases include a cadence whose
checks fall inside a 32-column stage. (c) The fragment maps: each
sub-tile's elements tile the CTA, the lanes a column sum combines share
the column and the sub-tile, the weights are sub-tile-local, and the
expected-moment product covers B's rows times the moment rows. (d) The
routing: ``_build.mainloop`` sends every kernel to wgmma at every tile
(B1 and B2 on the tile's own CTA or the 128 x 128 one), and a launch
error raises. The card tests (marker ``cuda``) hold the CUDA
kernels against their plain versions at ragged sizes and mid-stage checks.
"""

import types

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
PROGRAM_TILES = ("small", "medium", "large", "tall", "wide", "huge")
SUBTILES = sorted(_build.subtiles())
KINDS = {"weighted": "running", "fused": "fused"}
# (name, injection kwargs or "reference_like")
SCHEDULES = {
    "clean": None,
    "reference_like": "reference_like",
    "adversarial_same_column": dict(enabled=True, every=1, col_stride=0),
}


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


def _model(kind, shape, ap, bp, cp, sc, check_every):
    moments = ft._tile_moments(ap, shape.bm) if kind == "fused" else None
    return tf32x3.ft_running_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc,
                                    check_every, moments=moments)


def _hold_c(want, got, unc, bm, bn, dims):
    ok = np.repeat(np.repeat(unc == 0, bm, 0), bn, 1)[:dims[0], :dims[1]]
    good, nbad, first = verify_matrix(want[ok], got[:dims[0], :dims[1]][ok],
                                      verbose=False)
    assert good, f"{nbad} elements off, first at {first}"


@pytest.mark.parametrize("tile", list(JAX_TILES))
@pytest.mark.parametrize("strategy", list(KINDS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_running_model_matches_jax(tile, strategy, schedule):
    jshape, shape = JAX_TILES[tile]
    dims = (300, 200, 512)
    a, b, c = _inputs(*dims, seed=21)
    jinj = _jinject(schedule, dims[2], jshape.bk)
    check_every = 2   # under the 4 steps: the JAX package runs the kernel
    jres = jft.make_ft_sgemm(jshape, strategy=strategy,
                             check_every=check_every)(a, b, c, jinj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    out, det, unc = _model(KINDS[strategy], shape, ap, bp, cp,
                           scalar_operand(ops.inject, ops.thresholds),
                           check_every)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(unc.numpy(), junc)
    _hold_c(np.asarray(jft.sgemm_reference(a, b, c)), out.numpy(), junc,
            shape.bm, shape.bn, dims)
    if schedule == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    elif schedule == "reference_like":
        assert junc.sum() == 0 and (jdet > 0).all()
    else:
        assert junc.sum() > 0  # reported, never silent


def _port_case(name, schedule, seed=4):
    """Operands at a port tile: sizes that are not multiples of 128 (the
    CTA), injection, and the cadences the check hook sees."""
    shape = SHAPES[name]
    dims = (200, 136, 256)
    a, b, c = _inputs(*dims, seed=seed)
    jinj = _jinject(schedule, dims[2], shape.bk)
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    sc = scalar_operand(ops.inject, ops.thresholds)
    return shape, dims, (a, b, c), (ap, bp, cp), sc, ops.inject


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind", ["running", "fused"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("cadence", ["program", "mid_stage"])
def test_running_model_matches_plain_at_port_tiles(name, kind, schedule,
                                                   cadence):
    shape, dims, host, (ap, bp, cp), sc, inj = _port_case(name, schedule)
    nk = ap.shape[1] // shape.bk
    if cadence == "program":
        ce = ft._plan("fused", None, None, inj, nk, shape.bn, "mxu")[1]
    else:
        # Three bk steps: a check every 24 (48 at small) K columns, inside
        # the 32-column stages (test's bk of 128 ends on a stage).
        ce = 3
    extra = ft.kernel_inputs(kind, ap, bp, shape)
    want = ft.run_kernel(kind, shape, ap, bp, cp, extra, 1.0, -1.5, sc, ce,
                         plain=True)
    got = _model(kind, shape, ap, bp, cp, sc, ce)
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    assert torch.equal(got[2], want[2]), (got[2], want[2])
    unc = want[2].numpy()
    _hold_c(np.asarray(jft.sgemm_reference(*host)), got[0].numpy(), unc,
            shape.bm, shape.bn, dims)
    if schedule == "reference_like":
        assert unc.sum() == 0 and want[1].sum() > 0


def test_mid_stage_cadence_reaches_inside_a_stage():
    # The cadence above ends bk steps inside a 32-column stage at every
    # tile of the program; the program's own small cadence (208 steps of
    # 16) is stage-aligned.
    for name in PROGRAM_TILES:
        bk = SHAPES[name].bk
        assert (3 * bk) % tf32x3.STAGE != 0
    inj = InjectionSpec.reference_like(4096, 16)
    ce = ft._plan("weighted", None, None, inj, 256, 16)[1]
    assert (ce * 16) % tf32x3.STAGE == 0


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
def test_subtile_map_tiles_the_cta(sub):
    sbm, sbn = sub
    fm = tf32x3.subtile_fragment_map(sbm, sbn).reshape(-1, 4)
    assert fm.shape[0] == 128 * 128
    row = fm[:, 0] * sbm + fm[:, 2]
    col = fm[:, 1] * sbn + fm[:, 3]
    flat = row * 128 + col
    assert torch.equal(flat.sort().values, torch.arange(128 * 128))
    # Every sub-tile holds sbm * sbn elements.
    sub_id = fm[:, 0] * (128 // sbn) + fm[:, 1]
    counts = torch.bincount(sub_id, minlength=(128 // sbm) * (128 // sbn))
    assert (counts == sbm * sbn).all()


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
def test_subtile_column_lanes_share_columns(sub):
    # RunHook::check sums a column over lanes l ^ 4, l ^ 8, l ^ 16 of one
    # warp: the same column of the same sub-tile, in distinct rows of one
    # row band.
    sbm, sbn = sub
    fm = tf32x3.subtile_fragment_map(sbm, sbn)
    t = torch.arange(fm.shape[0])
    for off in (4, 8, 16):
        partner = (t // 32) * 32 + (t % 32 ^ off)
        for k in (0, 1, 3):   # row band, column band, column in the sub-tile
            assert torch.equal(fm[partner, :, k], fm[:, :, k])
        assert not (fm[partner, :, 2] == fm[:, :, 2]).any()
    # A warp's 16 rows lie in one row band (sbm >= 16).
    warp_band = fm[:, :, 0].reshape(8, -1)
    assert (warp_band == warp_band[:, :1]).all()


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
def test_subtile_weights_are_local(sub):
    # Weight w = row inside the sub-tile + 1: every column of every
    # sub-tile sees each weight 1 .. sbm once.
    sbm, sbn = sub
    fm = tf32x3.subtile_fragment_map(sbm, sbn).reshape(-1, 4)
    w = fm[:, 2] + 1
    assert int(w.min()) == 1 and int(w.max()) == sbm
    key = ((fm[:, 0] * (128 // sbn) + fm[:, 1]) * sbn + fm[:, 3]) * sbm + fm[:, 2]
    assert torch.equal(key.sort().values, torch.arange(128 * 128))


@pytest.mark.parametrize("sbm", sorted({m for m, _ in SUBTILES}))
def test_moment_map_covers_b_rows_times_moment_rows(sbm):
    r = tf32x3.moment_rows(sbm)
    assert r % 8 == 0 and r >= 3 * 128 // sbm and r <= 24
    fm = tf32x3.moment_fragment_map(r).reshape(-1, 2)
    flat = fm[:, 0] * r + fm[:, 1]
    assert torch.equal(flat.sort().values, torch.arange(128 * r))
    # Warpgroup g holds B's rows 64 g .. 64 g + 63.
    rows = tf32x3.moment_fragment_map(r)[..., 0]
    assert (rows[:128] < 64).all() and (rows[128:] >= 64).all()


def test_mainloop_routes_running_and_fused_to_wgmma():
    assert _build.mainloop("running", SHAPES["small"]) == "wgmma-3xtf32"
    for name in PROGRAM_TILES + ("test",):
        shape = SHAPES[name]
        assert (shape.bm, shape.bn) in _build.subtiles()
        for kind in ("sgemm", "precomp", "rowcol", "global", "running",
                     "fused", "rowcol_mxu", "global_mxu"):
            assert _build.mainloop(kind, shape) == "wgmma-3xtf32", name
    # B1 and B2 run the tile's own CTA where its rows fill wgmma's 64, the
    # 128 x 128 CTA of the sub-tiled kernels elsewhere.
    own = {(s.bm, s.bn) for s in SHAPES.values() if s.bm >= 64}
    assert _build.wgmma_tiles() == own
    assert _build.narrow_tiles() == _build.subtiles() - own
    with pytest.raises(ValueError):
        _build.mainloop("sgemm", KernelShape("x", 64, 128, 8, (0,) * 7))


def test_a_launch_error_raises(monkeypatch):
    # No fallback: a nonzero return of the entry point (a failed build
    # raises in _build.build first; a refused launch, a tensor map that
    # cannot be encoded or a tile with no instantiation return an error)
    # raises, and the plain version is not run in its place.
    shape = SHAPES["small"]
    a, b, c = (torch.zeros((16, 16)) for _ in range(3))
    calls = []

    def entry(*args):
        calls.append(args)
        return 1   # cudaErrorInvalidValue

    entry.__name__ = "ftsg_ft_weighted_running"
    monkeypatch.setattr(ft, "_entries",
                        lambda adaptive=False: {"running": entry})
    monkeypatch.setattr(ft, "check_operands",
                        lambda shape, *t: (16, 16, 16, 16, 16, 16))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ft, "ft_weighted_plain",
                        lambda *a, **k: pytest.fail("fell back to plain"))
    sc = scalar_operand(InjectionSpec.none(), (9500.0,) * 3)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ft._launch(ft.ft_weighted_running_kernel, "running", shape, a, b, c,
                   (), (4,), 1.0, -1.5, sc)
    assert len(calls) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_operands(shape, dims, seed, device):
    return tuple(pad_to(torch.from_numpy(x).to(device), *mult)
                 for x, mult in zip(_inputs(*dims, seed=seed),
                                    ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                     (shape.bm, shape.bn))))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind", ["running", "fused"])
@pytest.mark.parametrize("dims,check_every", [
    ((200, 136, 256), 3),     # ragged M, N; checks inside a stage
    ((16, 300, 96), 1),       # M under one CTA; a check every bk step
    ((130, 70, 1000), 5),     # ragged M, N, K
])
def test_running_kernels_match_plain_on_card(cuda_device, name, kind, dims,
                                             check_every):
    shape = SHAPES[name]
    a, b, c = _card_operands(shape, dims, sum(dims), cuda_device)
    nk = a.shape[1] // shape.bk
    for inj in (InjectionSpec.none(), InjectionSpec.reference_like(dims[2], shape.bk),
                InjectionSpec(enabled=True, every=1, col_stride=0)):
        sc = scalar_operand(inj, (9500.0,) * 3)
        ce = min(check_every, nk)
        extra = ft.kernel_inputs(kind, a, b, shape)
        got = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, ce)
        want = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, ce,
                             plain=True)
        assert torch.equal(got[1], want[1]), (inj, got[1], want[1])
        assert torch.equal(got[2], want[2]), (inj, got[2], want[2])
        ok = (want[2] == 0).repeat_interleave(shape.bm, 0).repeat_interleave(
            shape.bn, 1)
        assert verify_matrix(want[0][ok].cpu().numpy(), got[0][ok].cpu().numpy(),
                             verbose=False)[0]


@pytest.mark.cuda
def test_unknown_subtile_returns_an_error_on_card(cuda_device):
    # The C entry points return an error for a tile with no instantiation;
    # the wrapper raises on it (test_a_launch_error_raises).
    a, b, c = (torch.zeros((64, 64), device=cuda_device) for _ in range(3))
    out = torch.empty_like(c)
    det = torch.empty((8, 8), dtype=torch.int32, device=cuda_device)
    unc = torch.empty_like(det)
    sc = scalar_operand(InjectionSpec.none(), (9500.0,) * 3)
    rc = ft._entries()["running"](
        a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
        det.data_ptr(), unc.data_ptr(), 64, 64, 64, 8, 8, 8, 1, 1.0, -1.5,
        sc.ctypes.data, 16.0, 32.0, 4.0, torch.cuda.current_stream().cuda_stream)
    assert rc != 0

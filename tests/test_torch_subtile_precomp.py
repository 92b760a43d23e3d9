"""Kernels B1 (plain SGEMM) and B2 (``weighted`` with precomputed moments)
at the small, medium and wide tiles, which run the 128 x 128 3xTF32 wgmma
CTA of the sub-tiled kernels (``csrc/sgemm.cu``,
``csrc/ft_sgemm_weighted.cu``): B1 without a check, B2 with B5's weighted
check of every (bm, bn) sub-tile once after the last k step, against the
wrapper's expected moments ``expm`` (``ops/ft_sgemm._expected_col_checksums``).
Their arithmetic is that of the tile's own CTA, so the CPU models stay
``ops/tf32x3.sgemm_tf32x3`` and ``ft_weighted_tf32x3``: an element's sum
does not depend on the CTA, and every tile's faults fall on the same k
steps.

(a) Against the JAX package: ``ft_sgemm_tpu.make_ft_sgemm(strategy=
"weighted", encode="vpu")`` (``_ft_kernel_weighted_precomp``) in interpret
mode, as its own tests run it, at 128x128x128 and 256x128x128 (the JAX
package takes only multiples of 128) on sizes that are not multiples of
the tile, clean, reference-like and with ``col_stride=0``; the
``detections`` and ``uncorrectable`` grids must be EQUAL, and C must pass
``verify_matrix`` (0.01 absolute AND relative) against the JAX oracle on
every tile the JAX package reports correctable. (b) At the port's six
program tiles, which the JAX package cannot run, B2's model is held to the
plain version ``ft_weighted_plain`` (itself held to the JAX package in
tests/test_torch_ft_sgemm.py) with the same grid equality and C
tolerance, at the program's cadence (one final check), on sizes that leave
the 128 x 128 CTA partly past the operands. (c) B1's model against the JAX
``make_sgemm`` on operands padded to the narrow tile, not to 128. (d) The
expected moments B2's check stages per CTA: row band ti0 + b of ``expm`` as
rows 3 b .. 3 b + 2, nothing read past the tensor. (e) The card tests
(marker ``cuda``) hold both kernels against their plain versions at every
tile, at the smoke's sizes, on the three schedules, with equal grids.
"""

import numpy as np
import pytest
import torch
from test_torch_subtile_mxu import _operands
from test_torch_subtile_rowcol import (  # noqa: F401
    JAX_TILES,
    SCHEDULES,
    _hold_c,
    _inputs,
    _jinject,
    _one_torch_thread,
    cuda_device,
)

import ft_sgemm_tpu as jft
from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import _build
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import tf32x3
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand, strict_fp32
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

PROGRAM_TILES = ("small", "medium", "large", "tall", "wide", "huge")
NARROW = ("small", "medium", "wide")
# Aligned, odd, and partly past the 128 x 128 CTA (chip_smoke.SIZES holds
# 512 for the aligned one).
CARD_SIZES = (1024, 1000, 300)


def _b2_model(shape, ap, bp, cp, sc):
    expm = ft._expected_col_checksums(ap, bp, shape.bm)
    return tf32x3.ft_weighted_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc, expm)


def test_narrow_tiles_are_the_program_tiles_under_64_rows():
    tiles = {(SHAPES[n].bm, SHAPES[n].bn) for n in NARROW}
    assert _build.narrow_tiles() == tiles
    assert all(bm < 64 for bm, _ in tiles)
    assert tiles <= _build.subtiles()


@pytest.mark.parametrize("tile", list(JAX_TILES))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_b2_model_matches_jax(tile, schedule):
    jshape, shape = JAX_TILES[tile]
    dims = (300, 200, 512)
    a, b, c = _inputs(*dims, seed=31)
    jinj = _jinject(schedule, dims[2], jshape.bk)
    jres = jft.make_ft_sgemm(jshape, strategy="weighted", encode="vpu")(
        a, b, c, jinj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    ap, bp, cp, sc, inj = _operands(a, b, c, jinj, shape)
    # The JAX package runs B2 here: one check, after the last step.
    nk = ap.shape[1] // shape.bk
    assert ft._plan("weighted", None, None, inj, nk, shape.bn)[0] == "precomp"
    out, det, unc = _b2_model(shape, ap, bp, cp, sc)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(unc.numpy(), junc)
    _hold_c(np.asarray(jft.sgemm_reference(a, b, c)), out.numpy(), junc == 0,
            shape.bm, shape.bn, dims)
    if schedule == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    elif schedule == "reference_like":
        assert (jdet > 0).all() and junc.sum() == 0
    else:
        assert junc.sum() > 0   # reported, never silent


@pytest.mark.parametrize("name", PROGRAM_TILES)
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_b2_model_matches_plain_at_port_tiles(name, schedule):
    shape = SHAPES[name]
    dims = (200, 136, 256)
    a, b, c = _inputs(*dims, seed=17)
    ap, bp, cp, sc, _ = _operands(a, b, c,
                                  _jinject(schedule, dims[2], shape.bk), shape)
    if name in NARROW:   # the 128 x 128 CTA overhangs M or N
        assert ap.shape[0] % 128 or bp.shape[0] % 128
    expm = ft._expected_col_checksums(ap, bp, shape.bm)
    want = ft.run_kernel("precomp", shape, ap, bp, cp, (expm,), 1.0, -1.5, sc,
                         ap.shape[1] // shape.bk, plain=True)
    got = _b2_model(shape, ap, bp, cp, sc)
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    assert torch.equal(got[2], want[2]), (got[2], want[2])
    _hold_c(want[0].numpy(), got[0].numpy(), want[2].numpy() == 0, shape.bm,
            shape.bn, ap.shape)
    if schedule == "reference_like":
        assert want[1].sum() > 0


@pytest.mark.parametrize("name", NARROW)
@pytest.mark.parametrize("dims", [(200, 136, 300), (40, 290, 72)])
def test_b1_model_at_narrow_padding_matches_jax(name, dims):
    shape = SHAPES[name]
    m, n, _ = dims
    a, b, c = _inputs(*dims, seed=sum(dims))
    jshape = JAX_TILES["t128"][0]
    want = np.asarray(jft.make_sgemm(jshape, alpha=1.0, beta=-1.5)(a, b, c))
    ap, bp, cp = (pad_to(torch.from_numpy(x), *mult) for x, mult in zip(
        (a, b, c), ((shape.bm, shape.bk), (shape.bn, shape.bk),
                    (shape.bm, shape.bn))))
    assert ap.shape[0] % 128 or bp.shape[0] % 128   # not padded to 128
    got = tf32x3.sgemm_tf32x3(ap, bp, cp, 1.0, -1.5)[:m, :n].numpy()
    ok, nbad, first = verify_matrix(want, got, verbose=False)
    assert ok, f"{nbad} elements off, first at {first}"
    # Far inside the tolerance: within FP32 accumulation noise of JAX's.
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def _staged_moments(expm: torch.Tensor, ti0: int, n0: int, nbm: int):
    """PrecompCheck::check's staging of one CTA's expected moments (rows
    ti0 .. of the (gm, 3, N) ``expm``, columns n0 ..), read as the kernel
    reads it from the flat tensor: row r, column c from flat offset
    (3 ti0 + r) N + n0 + c where row band ti0 + r / 3 < gm and n0 + c < N,
    else zero. Returns the (3 nbm, 128) rows and the offsets read."""
    gm, _, n = expm.shape
    flat = expm.reshape(-1)
    rows = torch.zeros((3 * nbm, 128))
    read = []
    for r in range(3 * nbm):
        for c in range(128):
            if ti0 + r // 3 < gm and n0 + c < n:
                off = (3 * ti0 + r) * n + n0 + c
                rows[r, c] = flat[off]
                read.append(off)
    return rows, read


@pytest.mark.parametrize("name", NARROW)
def test_b2_check_stages_each_band_and_reads_inside_expm(name):
    shape = SHAPES[name]
    nbm = 128 // shape.bm
    a, b, _ = _inputs(3 * 128 + 2 * shape.bm, 128 + shape.bn, 16, seed=8)
    ap = pad_to(torch.from_numpy(a), shape.bm, 8)
    bp = pad_to(torch.from_numpy(b), shape.bn, 8)
    expm = ft._expected_col_checksums(ap, bp, shape.bm)   # (gm, 3, N)
    gm, _, n = expm.shape
    assert gm % nbm   # the last CTA's last bands lie past the grid
    for ti0 in range(0, gm, nbm):
        for n0 in range(0, n, 128):
            rows, read = _staged_moments(expm, ti0, n0, nbm)
            assert max(read) < expm.numel()
            for band in range(nbm):
                for v in range(3):
                    want = torch.zeros(128)
                    if ti0 + band < gm:
                        cols = expm[ti0 + band, v, n0:n0 + 128]
                        want[:cols.shape[0]] = cols
                    # WeightedCheck reads moment v of band b at row 3 b + v.
                    assert torch.equal(rows[3 * band + v], want), (ti0, n0)


def _card_operands(device, shape, size, seed):
    return tuple(pad_to(torch.from_numpy(x).to(device), *mult)
                 for x, mult in zip(_inputs(size, size, size, seed=seed),
                                    ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                     (shape.bm, shape.bn))))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("size", CARD_SIZES)
def test_b1_kernel_matches_plain_on_card(cuda_device, name, size):
    from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel, sgemm_plain

    shape = SHAPES[name]
    a, b, c = _card_operands(cuda_device, shape, size, seed=size + 5)
    got = sgemm_kernel(a, b, c, shape, 1.0, -1.5)
    want = sgemm_plain(a, b, c, 1.0, -1.5)
    assert verify_matrix(want.cpu().numpy(), got.cpu().numpy(),
                         verbose=False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("size", CARD_SIZES)
def test_b2_kernel_matches_plain_on_card(cuda_device, name, size):
    shape = SHAPES[name]
    a, b, c = _card_operands(cuda_device, shape, size, seed=size + 6)
    expm = ft._expected_col_checksums(a, b, shape.bm)
    for inj in (InjectionSpec.none(),
                InjectionSpec.reference_like(size, shape.bk),
                InjectionSpec(enabled=True, every=1, col_stride=0)):
        sc = scalar_operand(inj, (9500.0,) * 3)
        got = ft.ft_weighted_kernel(a, b, c, expm, shape, 1.0, -1.5, sc)
        want = ft.ft_weighted_plain(a, b, c, shape, 1.0, -1.5, sc, expm=expm)
        assert torch.equal(got[1], want[1]), (inj, got[1], want[1])
        assert torch.equal(got[2], want[2]), (inj, got[2], want[2])
        ok = (want[2] == 0).repeat_interleave(shape.bm, 0).repeat_interleave(
            shape.bn, 1)
        assert verify_matrix(want[0][ok].cpu().numpy(), got[0][ok].cpu().numpy(),
                             verbose=False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NARROW)
@pytest.mark.parametrize("k", [8, 40, 1000])
def test_narrow_ragged_k_on_card(cuda_device, name, k):
    # K below one 32-column stage, and a last stage that TMA zero-fills, on
    # a CTA that overhangs M and N.
    from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel, sgemm_plain

    shape = SHAPES[name]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(130, 70, k, seed=k),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    assert verify_matrix(sgemm_plain(a, b, c, 1.0, -1.5).cpu().numpy(),
                         sgemm_kernel(a, b, c, shape, 1.0, -1.5).cpu().numpy(),
                         verbose=False)[0]
    sc = scalar_operand(InjectionSpec.reference_like(k, shape.bk), (9500.0,) * 3)
    expm = ft._expected_col_checksums(a, b, shape.bm)
    got = ft.ft_weighted_kernel(a, b, c, expm, shape, 1.0, -1.5, sc)
    want = ft.ft_weighted_plain(a, b, c, shape, 1.0, -1.5, sc, expm=expm)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert verify_matrix(want[0].cpu().numpy(), got[0].cpu().numpy(),
                         verbose=False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NARROW)
def test_narrow_accuracy_gate_on_card(cuda_device, name):
    # B1's error against a float64 product at most twice cuBLAS FP32's.
    from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel

    shape = SHAPES[name]
    a, b, c = _card_operands(cuda_device, shape, 1000, seed=12)
    strict_fp32()
    exact = a.double() @ b.double().T - 1.5 * c.double()
    kernel = (sgemm_kernel(a, b, c, shape, 1.0, -1.5).double() - exact).abs().max()
    cublas = (torch.addmm(c, a, b.T, beta=-1.5).double() - exact).abs().max()
    assert kernel <= 2 * cublas, f"kernel {float(kernel)} vs cuBLAS {float(cublas)}"

"""Kernels B6 (``fused``, and ``weighted`` with encode mxu) and B7
(``rowcol`` with encode mxu), and the wrapper-side prep and dispatch of
every (strategy, encode) pair: the port against the JAX package.

As in tests/test_torch_ft_sgemm.py, the JAX side runs in interpret mode and
the port runs its plain versions (``device="cpu"``); the ``detections`` and
``uncorrectable`` grids must be EQUAL and C must pass ``verify_matrix``
against the oracle on every tile the JAX package reports correctable. The
card test (marker ``cuda``) holds the CUDA kernels against their plain
versions.
"""

import numpy as np
import pytest
import torch
from test_torch_ft_sgemm import CASES, TILES, _inputs, _run_both, cuda_device  # noqa: F401

import ft_sgemm_tpu as jft
from ft_sgemm_tpu_torch import SHAPES, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

MXU_PAIRS = [("fused", "vpu"), ("weighted", "mxu"), ("rowcol", "mxu")]


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("strategy,encode", MXU_PAIRS,
                         ids=[f"{s}-{e}" for s, e in MXU_PAIRS])
@pytest.mark.parametrize("case,dims,inj_kw,check_every", CASES,
                         ids=[c[0] for c in CASES])
def test_mxu_matches_jax(tile, strategy, encode, case, dims, inj_kw,
                         check_every):
    jres, res, want, jshape = _run_both(tile, strategy, dims, inj_kw,
                                        check_every, encode=encode)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    ok_rows = np.repeat(np.repeat(junc == 0, jshape.bm, 0), jshape.bn, 1)
    ok_rows = ok_rows[:dims[0], :dims[1]]
    got = res.c.numpy()
    assert got.shape == want.shape
    ok, nbad, first = verify_matrix(want[ok_rows], got[ok_rows], verbose=False)
    assert ok, f"{nbad} elements off, first at {first}"
    if case == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    elif case != "adversarial_same_column":
        assert junc.sum() == 0 and (jdet > 0).all()
    elif strategy != "rowcol":
        assert junc.sum() > 0  # reported, never silent


@pytest.mark.parametrize("n_moments", [1, 2, 3])
def test_tile_moments_match_jax(n_moments):
    from ft_sgemm_tpu.ops.ft_sgemm import _tile_moments as jmoments

    a, _, _ = _inputs(256, 8, 384, seed=5)
    want = np.asarray(jmoments(a, 128, n_moments))
    got = ft._tile_moments(torch.from_numpy(a), 128, n_moments).numpy()
    assert got.shape == want.shape == (2, n_moments, 384)
    # f32 accumulation-order noise of a sum over 128 rows: ~1e-6 of each
    # moment's scale (the w^2 moment reaches ~1e6).
    for v in range(n_moments):
        scale = np.abs(want[:, v]).max()
        assert np.abs(got[:, v] - want[:, v]).max() <= 1e-5 * scale


def test_cadence_follows_jax_strategy_sets():
    # ops/ft_sgemm.py:1727-1762 of the JAX package: weighted and fused check
    # once, rowcol and global ~20 times; only the column-localizing
    # strategies clamp to bn * every.
    clean = InjectionSpec.none()
    for s in ("weighted", "fused"):
        assert ft._resolve_cadence(s, None, clean, 512, 128) == 512
    for s in ("rowcol", "global"):
        assert ft._resolve_cadence(s, None, clean, 512, 128) == 26
    dense = InjectionSpec(enabled=True, every=1)
    for s in ("rowcol", "weighted", "fused"):
        assert ft._resolve_cadence(s, 32, dense, 512, 16) == 16
    assert ft._resolve_cadence("global", 32, dense, 512, 16) == 32
    # A column stride that is not coprime to bn gets no clamp.
    same_col = InjectionSpec(enabled=True, every=1, col_stride=0)
    assert ft._resolve_cadence("weighted", None, same_col, 512, 16) == 512


@pytest.mark.parametrize("strategy,encode,kind", [
    ("weighted", "vpu", "precomp"), ("rowcol", "vpu", "rowcol"),
    ("global", "vpu", "global"), ("fused", "vpu", "fused"),
    ("fused", "mxu", "fused"), ("weighted", "mxu", "fused"),
    ("rowcol", "mxu", "rowcol_mxu"), ("global", "mxu", "global_mxu"),
])
def test_plan_and_name_of_every_pair(strategy, encode, kind):
    inj = InjectionSpec.reference_like(4096, SHAPES["huge"].bk)
    got, ce, mf = ft._plan(strategy, None, None, inj, 512, 128, encode)
    assert got == kind
    assert ce == (512 if strategy in ("weighted", "fused") else 26)
    assert mf is False  # reference-like: at most one fault per interval
    if strategy == "rowcol":
        dense = InjectionSpec(True, 1)
        assert ft._plan(strategy, 8, None, dense, 512, 128, encode)[2] is True
    fn = make_ft_sgemm("huge", strategy=strategy, encode=encode, device="cpu")
    jfn = jft.make_ft_sgemm("huge", strategy=strategy, encode=encode)
    assert fn.__name__ == jfn.__name__
    assert fn.encode == jfn.encode


def test_legality_raises_for_what_is_not_ported():
    with pytest.raises(ValueError, match="encode"):
        make_ft_sgemm("huge", encode="tensor", device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        make_ft_sgemm("huge", strategy="bogus", device="cpu")
    # The mxu encodes run in bf16 too (B6-B8's bf16 builds): B6 corrects
    # every fault to the oracle of the rounded operands, under the static
    # threshold and under threshold="adaptive" (its adaptive bf16 build).
    fn = make_ft_sgemm("huge", in_dtype="bfloat16", encode="mxu",
                       device="cpu")
    assert fn.encode == "mxu" and fn.in_dtype == "bfloat16"
    a, b, c = _inputs(128, 128, 256, seed=3)
    res = fn(a, b, c, InjectionSpec(enabled=True, every=8))
    assert int(res.num_detected) == 4 and int(res.num_uncorrectable) == 0
    want = jft.sgemm_reference(a, b, c, in_dtype="bfloat16")
    assert verify_matrix(np.asarray(want), res.c.numpy(), verbose=False)[0]
    fn = make_ft_sgemm("huge", in_dtype="bfloat16", encode="mxu",
                       threshold="adaptive", device="cpu")
    assert fn.threshold_mode == "adaptive" and fn.encode == "mxu"
    res = fn(a, b, c, InjectionSpec(enabled=True, every=8, magnitude=5.0))
    assert int(res.num_detected) == 4 and int(res.num_uncorrectable) == 0
    assert verify_matrix(np.asarray(want), res.c.numpy(), verbose=False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind,multifault", [("fused", False),
                                             ("rowcol_mxu", False),
                                             ("rowcol_mxu", True)])
def test_mxu_kernels_match_plain_on_card(cuda_device, name, kind, multifault):
    shape = SHAPES[name]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(250, 250, 256, seed=8),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    sc = scalar_operand(InjectionSpec(enabled=True, every=2), (9500.0,) * 3)
    extra = ft.kernel_inputs(kind, a, b, shape)
    got = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, 2,
                        multifault)
    want = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, 2,
                         multifault, plain=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert verify_matrix(want[0].cpu().numpy(), got[0].cpu().numpy(),
                         verbose=False)[0]


@pytest.mark.parametrize("name", ["device-scalars", "device-scalars-small"])
def test_device_scalars_variants_apply(name, tmp_path):
    # B6's regression variants (scripts/torch_variant_time.py, the smoke's
    # phase variant): each edit still finds its text in the kernels.
    import pathlib
    import sys

    scripts = pathlib.Path(__file__).resolve().parents[1] / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        import torch_variant_time
    finally:
        sys.path.remove(str(scripts))
    torch_variant_time.write_variant(name, str(tmp_path / "v"))
    csrc = tmp_path / "v" / "ft_sgemm_tpu_torch" / "csrc"
    running = (csrc / "ft_sgemm_running.cuh").read_text()
    assert "const Scalars* __restrict__ scp" in running
    assert ("FTSG_FOR_EACH_SUBTILE(FTSG_LAUNCH_SUB)" in running) == (
        name == "device-scalars")
    assert ("inline namespace v" in (csrc / "abft_common.cuh").read_text()) \
        == (name == "device-scalars-small")
    assert not (csrc / "_build").exists()

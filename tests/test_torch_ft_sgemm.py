"""Kernels B2 / B5 (weighted) and B3 (rowcol): the port against the JAX
package, on the same numpy inputs and the same injection.

The JAX side runs ``ft_sgemm_tpu.make_ft_sgemm`` as its own tests do (Pallas
in interpret mode on the CPU); the port runs its plain versions
(``device="cpu"``), which follow the tile algorithm. At the JAX package's
tiles (128x128x128 and 256x128x128) the fault placement, cadence and
localization coincide, so the per-tile ``detections`` and ``uncorrectable``
grids must be EQUAL, and C must pass ``verify_matrix`` (0.01 absolute AND
relative) against the oracle wherever the JAX kernel reports the tile
correctable. The cases mirror tests/test_ft_sgemm.py:35-497. The card test
(marker ``cuda``) holds the CUDA kernels against the plain versions.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, KernelShape, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.interop import from_reference
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

TILES = {
    "t128": (JKernelShape("t128", 128, 128, 128, (0,) * 7), SHAPES["test"]),
    "t256x128": (JKernelShape("t256x128", 256, 128, 128, (0,) * 7),
                 KernelShape("t256x128", 256, 128, 128, (0,) * 7)),
}
DENSE = dict(enabled=True, every=1)
# (name, (m, n, k), injection kwargs or "reference_like", check_every)
CASES = [
    ("clean", (256, 256, 512), None, None),
    ("reference_like", (256, 256, 512), "reference_like", None),
    ("dense_coarse_cadence", (256, 256, 512), DENSE, 4),
    ("adversarial_same_column", (256, 256, 512),
     dict(enabled=True, every=1, col_stride=0), None),
    ("padded_rectangular", (200, 136, 300), dict(enabled=True, every=2), None),
]


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (generate_random_matrix(m, k, rng=rng),
            generate_random_matrix(n, k, rng=rng),
            generate_random_matrix(m, n, rng=rng))


def _run_both(tile, strategy, dims, inj_kw, check_every, seed=0,
              encode="vpu"):
    """The JAX package's and the port's result for one case, and the
    oracle's C (tests/test_torch_ft_global.py and test_torch_ft_mxu.py
    run their cases through it too)."""
    jshape, shape = TILES[tile]
    a, b, c = _inputs(*dims, seed=seed)
    if inj_kw == "reference_like":
        jinj = JInjectionSpec.reference_like(dims[2], jshape.bk)
    else:
        jinj = JInjectionSpec(**(inj_kw or {}))
    jres = jft.make_ft_sgemm(jshape, strategy=strategy, encode=encode,
                             check_every=check_every)(a, b, c, jinj)
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    res = make_ft_sgemm(shape, strategy=strategy, encode=encode,
                        check_every=check_every, threshold=ops.thresholds,
                        device="cpu")(
        ops.a, ops.b, ops.c, ops.inject)
    want = np.asarray(jft.sgemm_reference(a, b, c))
    return jres, res, want, jshape


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("strategy", ["weighted", "rowcol"])
@pytest.mark.parametrize("case,dims,inj_kw,check_every", CASES,
                         ids=[c[0] for c in CASES])
def test_ft_sgemm_matches_jax(tile, strategy, case, dims, inj_kw, check_every):
    jres, res, want, jshape = _run_both(tile, strategy, dims, inj_kw,
                                        check_every)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    # C within verify_matrix on every tile the reference reports correctable.
    ok_rows = np.repeat(np.repeat(junc == 0, jshape.bm, 0), jshape.bn, 1)
    ok_rows = ok_rows[:dims[0], :dims[1]]
    got = res.c.numpy()
    assert got.shape == want.shape
    ok, nbad, first = verify_matrix(want[ok_rows], got[ok_rows], verbose=False)
    assert ok, f"{nbad} elements off, first at {first}"
    if case == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    if case == "adversarial_same_column" and strategy == "weighted":
        assert junc.sum() > 0  # reported, never silent


def test_expected_col_checksums_match_jax():
    from ft_sgemm_tpu.ops.ft_sgemm import _expected_col_checksums as jexp

    a, b, _ = _inputs(256, 128, 256, seed=9)
    want = np.asarray(jexp(a, b, 128, "highest")).reshape(2, 8, 128)[:, :3]
    got = ft._expected_col_checksums(torch.from_numpy(a), torch.from_numpy(b),
                                     128).numpy()
    # f32 accumulation-order noise: ~1e-6 of each moment's scale over K=256.
    for v in range(3):
        scale = np.abs(want[:, v]).max()
        assert np.abs(got[:, v] - want[:, v]).max() <= 1e-5 * scale


def test_weighted_cadence_picks_running_body():
    # The small tile (16 columns) cannot hold ~20 reference-like faults in
    # distinct columns: the injection clamp gives it intermediate checks.
    inj = InjectionSpec.reference_like(4096, SHAPES["small"].bk)
    assert ft._resolve_cadence("weighted", None, inj, 256, 16) < 256
    inj = InjectionSpec.reference_like(4096, SHAPES["huge"].bk)
    assert ft._resolve_cadence("weighted", None, inj, 512, 128) == 512


def test_plan_names_the_launch_of_the_entry_point():
    small, huge = SHAPES["small"], SHAPES["huge"]
    inj = InjectionSpec.reference_like(4096, small.bk)
    kind, ce, _ = ft._plan("weighted", None, None, inj, 4096 // small.bk, 16)
    assert kind == "running" and ce < 4096 // small.bk
    inj = InjectionSpec.reference_like(4096, huge.bk)
    assert ft._plan("weighted", None, None, inj, 512, 128) == ("precomp", 512,
                                                                False)
    # Reference-like faults come at most one per rowcol check interval, so
    # the auto rule drops the multifault checksum; dense faults keep it.
    kind, ce, mf = ft._plan("rowcol", None, None, inj, 512, 128)
    assert (kind, mf) == ("rowcol", False) and ce <= inj.every
    dense = InjectionSpec(True, 1)
    assert ft._plan("rowcol", 8, None, dense, 512, 128) == ("rowcol", 8, True)
    assert ft._plan("rowcol", 8, False, dense, 512, 128)[2] is False


@pytest.mark.parametrize("threshold", ["auto", "adaptive"])
def test_unported_threshold_modes_raise(threshold):
    # Both modes run in f32 (tests/test_torch_ft_adaptive.py); with a dtype
    # the port does not run yet they still raise, and a misspelled mode
    # is refused.
    assert make_ft_sgemm("huge", threshold=threshold,
                         device="cpu").threshold_mode == threshold
    with pytest.raises(NotImplementedError):
        make_ft_sgemm("huge", threshold=threshold, in_dtype="bfloat16",
                      device="cpu")
    with pytest.raises(ValueError, match="threshold"):
        make_ft_sgemm("huge", threshold=threshold + "x", device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kernel", ["precomp", "running", "rowcol"])
def test_kernels_match_plain_on_card(cuda_device, name, kernel):
    shape = SHAPES[name]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(250, 250, 256, seed=8),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    sc = scalar_operand(InjectionSpec(enabled=True, every=2), (9500.0,) * 3)
    if kernel == "precomp":
        expm = ft._expected_col_checksums(a, b, shape.bm)
        got = ft.ft_weighted_kernel(a, b, c, expm, shape, 1.0, -1.5, sc)
        want = ft.ft_weighted_plain(a, b, c, shape, 1.0, -1.5, sc, expm=expm)
    elif kernel == "running":
        got = ft.ft_weighted_running_kernel(a, b, c, shape, 1.0, -1.5, sc, 2)
        want = ft.ft_weighted_plain(a, b, c, shape, 1.0, -1.5, sc, check_every=2)
    else:
        got = ft.ft_rowcol_kernel(a, b, c, shape, 1.0, -1.5, sc, 1, True)
        want = ft.ft_rowcol_plain(a, b, c, shape, 1.0, -1.5, sc, 1, True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert verify_matrix(want[0].cpu().numpy(), got[0].cpu().numpy(),
                         verbose=False)[0]

"""The int8 input mode of the fused-ABFT factory (kernels B3 and B4, the
exact mode), the port against the JAX package on the same numpy inputs.

At the JAX package's 128x128x128 tile (``SHAPES["test"]``) the JAX side runs
``ft_sgemm_tpu.make_ft_sgemm(in_dtype="int8")`` in interpret mode and the
port its plain versions (``device="cpu"``): A and B truncated to int8, the
accumulator, checksums, residuals and correction in wrapping int32. For
rowcol and global under every threshold mode, clean, with reference-like
faults and with unit faults, the ``detections`` and ``uncorrectable`` grids
must be EQUAL. C must equal the JAX package's up to one rounding of beta *
C: XLA on the CPU contracts the JAX epilogue ``alpha * f32(acc) + beta *
C`` into one FMA, where the port rounds ``beta * C`` on its own (as its
kernels do, bit for bit). Wrapping checksums (data near 127, K = 1536),
"adaptive" equal to a static threshold of 0.5, a paper tile with ragged M,
N and K follow (the card tests of the int8 builds are in
``tests/test_torch_int8_card.py``, which does not import JAX).
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu_torch import SHAPES, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, pad_to, scalar_operand
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

ALPHA, BETA = 1.0, -1.5
JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
STRATEGIES = ["rowcol", "global"]
MODES = ["static", "auto", "adaptive"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n, k, seed, lo=-9, hi=9):
    """Integer-valued f32 A and B in [lo, hi], f32 C."""
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi + 1, (m, k)).astype(np.float32)
    b = rng.integers(lo, hi + 1, (n, k)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    return a, b, c


def _injections(kind, k):
    j = {"clean": JInjectionSpec.none(),
         "reference_like": JInjectionSpec.reference_like(k, JTILE.bk),
         "unit": JInjectionSpec(enabled=True, every=1, magnitude=1.0)}[kind]
    return j, InjectionSpec(j.enabled, j.every, j.magnitude, j.col_stride)


def assert_c_matches_jax(got, want, c):
    """C equal to the JAX package's up to one rounding of beta * C: |dC| <=
    ulp(beta * C) / 2 + ulp(C)."""
    got, want = np.asarray(got), np.asarray(want)
    tol = (np.spacing(np.abs(np.float32(BETA) * c)) / 2
           + np.spacing(np.abs(want)))
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} elements off JAX's C, first at"
                           f" {np.argwhere(bad)[0]}")


def _run_both(strategy, threshold, a, b, c, jinj, inj):
    jres = jft.make_ft_sgemm(JTILE, alpha=ALPHA, beta=BETA, strategy=strategy,
                             threshold=threshold, in_dtype="int8")(
        a, b, c, jinj)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        threshold=threshold, in_dtype="int8",
                        device="cpu")(a, b, c, inj)
    return jres, res


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("threshold", MODES)
@pytest.mark.parametrize("inject", ["clean", "reference_like", "unit"])
def test_int8_ft_sgemm_matches_jax(strategy, threshold, inject):
    m, n, k = 256, 256, 512
    a, b, c = _inputs(m, n, k, seed=0)
    jinj, inj = _injections(inject, k)
    jres, res = _run_both(strategy, threshold, a, b, c, jinj, inj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    assert_c_matches_jax(res.c.numpy(), jres.c, c)
    tiles = (m // 128) * (n // 128)
    # Unit faults: under the static 9500 they pass unseen; auto's threshold
    # on these data is 0.33 (rowcol catches them) and 0.33 * sqrt(128) =
    # 3.8 for global (it does not); adaptive's 0.5 catches them.
    caught = inject == "reference_like" or threshold == "adaptive" or (
        threshold == "auto" and strategy == "rowcol")
    if inject == "clean":
        # exact residuals: a clean run flags nothing, even at 0.5
        assert jdet.sum() == 0 and junc.sum() == 0
    elif caught:
        want = tiles * jinj.expected_faults(k, JTILE.bk)
        if strategy == "rowcol":
            assert jdet.sum() == want and junc.sum() == 0
            # every fault corrected exactly: C is the oracle's, within one
            # rounding of beta * C
            assert_c_matches_jax(res.c.numpy(), sgemm_reference(
                a, b, c, ALPHA, BETA, in_dtype="int8", device="cpu").numpy(),
                c)
        else:
            assert 0 < jdet.sum() <= want and np.array_equal(jdet, junc)
    else:
        assert jdet.sum() == 0


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("inject", ["clean", "reference_like"])
def test_int8_wrapping_checksums_match_jax(strategy, inject):
    # Data near 127: a row's expected sum over a 128-wide tile reaches ~2e9
    # at K = 1536, past int32's 2^31, so the checksums wrap (the product
    # itself, ~2e7, does not); clean residuals stay exactly 0 and every
    # fault is found, in both packages alike.
    m, n, k = 256, 256, 1536
    a, b, c = _inputs(m, n, k, seed=3, lo=100, hi=127)
    prod = a.astype(np.int64) @ b.astype(np.int64).T
    # a tile row's sum (the row checksum) wraps; the product does not
    assert prod.reshape(m, n // 128, 128).sum(-1).max() > 2 ** 31
    assert np.abs(prod).max() < 2 ** 31
    jinj, inj = _injections(inject, k)
    jres, res = _run_both(strategy, "static", a, b, c, jinj, inj)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    assert_c_matches_jax(res.c.numpy(), jres.c, c)
    if inject == "clean":
        assert int(res.num_detected) == 0
    elif strategy == "rowcol":
        assert int(res.num_detected) == 4 * jinj.expected_faults(k, JTILE.bk)
        assert int(res.num_uncorrectable) == 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_int8_adaptive_is_static_at_half(strategy):
    # The exact kernels' adaptive threshold is the constant 0.5
    # (ops/ft_sgemm.py:606-611, 890-893): the port runs the static build
    # with 0.5 in slots 4-6 and gives the same result as threshold=0.5.
    a, b, c = _inputs(256, 128, 512, seed=11)
    inj = InjectionSpec(enabled=True, every=1, magnitude=1.0)
    fns = [make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                         threshold=t, in_dtype="int8", device="cpu")
           for t in ("adaptive", 0.5)]
    assert fns[0].threshold_mode == "adaptive"
    assert fns[0].__name__ == f"ft_sgemm_test_{strategy}_adaptive_int8"
    (ra, rs) = (f(a, b, c, inj) for f in fns)
    assert torch.equal(ra.c, rs.c)
    assert torch.equal(ra.detections, rs.detections)
    assert torch.equal(ra.uncorrectable, rs.uncorrectable)
    # 2 tiles x nk = 4 unit faults, each detected (tests/test_low_precision.py
    # :265-287 of the JAX package)
    assert int(ra.num_detected) == 8


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_int8_paper_tile_ragged(strategy):
    # The medium tile (32x32x8) with M, N and K that are not multiples of
    # 128, 32 or 16: K = 200 pads to 200 (bk = 8), whose int8 rows the
    # wrapper stores 208 bytes apart. Every tile sees the schedule's
    # faults; rowcol corrects each exactly.
    m, n, k = 200, 136, 200
    a, b, c = _inputs(m, n, k, seed=31)
    shape = SHAPES["medium"]
    inj = InjectionSpec.reference_like(k, shape.bk)
    res = make_ft_sgemm("medium", alpha=ALPHA, beta=BETA, strategy=strategy,
                        in_dtype="int8", device="cpu")(a, b, c, inj)
    assert tuple(res.detections.shape) == (7, 5)
    want = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="int8",
                           device="cpu").numpy()
    if strategy == "rowcol":
        assert (res.detections.numpy() ==
                inj.expected_faults(k, shape.bk)).all()
        assert int(res.num_uncorrectable) == 0
        np.testing.assert_array_equal(res.c.numpy(), want)
    else:
        assert torch.equal(res.detections, res.uncorrectable)
        assert (res.detections.numpy() > 0).all()
        clean = make_ft_sgemm("medium", alpha=ALPHA, beta=BETA,
                              strategy=strategy, in_dtype="int8",
                              device="cpu")(a, b, c)
        np.testing.assert_array_equal(clean.c.numpy(), want)


def _padded_int8(a, b, c, shape, device):
    ap, bp = (align_rows16(pad_to(as_operand(x, torch.int8, device), mm,
                                  shape.bk))
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(device), shape.bm, shape.bn)
    return ap, bp, cp


@pytest.mark.parametrize("kind", ["rowcol", "global"])
def test_int8_kernel_wrappers_take_plain_on_cpu(kind):
    # A CPU tensor runs the plain version; the int8 mode refuses what it
    # does not have (multifault, an adaptive build), as the kernels do.
    shape = SHAPES["small"]
    a, b, c = _inputs(64, 48, 72, seed=2)
    ap, bp, cp = _padded_int8(a, b, c, shape, torch.device("cpu"))
    sc = scalar_operand(InjectionSpec(enabled=True, every=3), (9500.0,) * 3)
    got = ft.run_kernel(kind, shape, ap, bp, cp, (), ALPHA, BETA, sc, 2)
    want = ft.run_kernel(kind, shape, ap, bp, cp, (), ALPHA, BETA, sc, 2,
                         plain=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(got[1].sum()) > 0
    with pytest.raises(ValueError, match="int8"):
        ft.run_kernel(kind, shape, ap, bp, cp, (), ALPHA, BETA, sc, 2,
                      multifault=kind == "rowcol", adaptive=kind == "global")


def test_int8_names_and_legality():
    fn = make_ft_sgemm("test", strategy="rowcol", in_dtype="int8",
                       device="cpu")
    jfn = jft.make_ft_sgemm(JTILE, strategy="rowcol", in_dtype="int8")
    assert fn.__name__ == "ft_sgemm_test_rowcol_int8"
    assert jfn.__name__ == "ft_sgemm_t128_rowcol_int8"
    assert fn.in_dtype == "int8" and fn.threshold_mode == "static"
    for kw in (dict(), dict(strategy="fused"), dict(strategy="rowcol",
                                                    encode="mxu")):
        with pytest.raises(ValueError):
            make_ft_sgemm("test", in_dtype="int8", device="cpu", **kw)

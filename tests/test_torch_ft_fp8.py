"""The fp8 (float8_e4m3fn) input mode of the fused-ABFT factory (kernels
B2-B5, the vpu encodes), the port against the JAX package on the same
numpy inputs.

At the JAX package's 128x128x128 tile (``SHAPES["test"]``) the JAX side runs
``ft_sgemm_tpu.make_ft_sgemm(in_dtype="float8_e4m3fn")`` in interpret mode
and the port its plain versions (``device="cpu"``): A and B rounded to
e4m3 as the JAX package rounds them, products, checksums, detection and
correction in f32. For every vpu strategy under the static and auto
thresholds, clean, with reference-like faults and with reference-like
faults of magnitude 1 (which the static 9500 misses and "auto" catches),
the ``detections`` and ``uncorrectable`` grids must be EQUAL and C must
pass ``verify_matrix`` (0.01 absolute AND relative) against the JAX
package's C on every tile reported correctable, and against the oracle
(the f32 product of the rounded operands) where no fault is left in C.
Then B2's expected moments in fp8 against the JAX package's, one paper
tile with ragged M and N, and the plain versions as the f32 algorithm on
the rounded values. The card tests are in ``tests/test_torch_fp8_card.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.ops import ft_sgemm as jft_ops
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, make_ft_sgemm, make_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, pad_to, scalar_operand
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

ALPHA, BETA = 1.0, -1.5
F8 = torch.float8_e4m3fn
CPU = torch.device("cpu")
JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
VPU = ["weighted", "rowcol", "global"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (generate_random_matrix(m, k, rng=rng),
            generate_random_matrix(n, k, rng=rng),
            generate_random_matrix(m, n, rng=rng))


def _oracle(a, b, c):
    return sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="fp8",
                           device="cpu").numpy()


def _correctable(unc, shape, m, n):
    return np.repeat(np.repeat(np.asarray(unc) == 0, shape.bm, 0), shape.bn,
                     1)[:m, :n]


@pytest.mark.parametrize("strategy", VPU)
@pytest.mark.parametrize("threshold", ["static", "auto"])
@pytest.mark.parametrize("inject", ["clean", "reference_like", "unit"])
def test_fp8_ft_sgemm_matches_jax(strategy, threshold, inject):
    m, n, k = 256, 256, 512
    a, b, c = _inputs(m, n, k, seed=0)
    jinj = {"clean": JInjectionSpec.none(),
            "reference_like": JInjectionSpec.reference_like(k, JTILE.bk),
            "unit": JInjectionSpec.reference_like(k, JTILE.bk,
                                                  magnitude=1.0)}[inject]
    inj = InjectionSpec(jinj.enabled, jinj.every, jinj.magnitude,
                        jinj.col_stride)
    jres = jft.make_ft_sgemm(JTILE, alpha=ALPHA, beta=BETA, strategy=strategy,
                             threshold=threshold, in_dtype="float8_e4m3fn")(
        a, b, c, jinj)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        threshold=threshold, in_dtype="fp8",
                        device="cpu")(a, b, c, inj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    got = res.c.numpy()
    ok_tiles = _correctable(junc if strategy != "global" else 0 * junc,
                            JTILE, m, n)
    # C against the JAX package's on the same inputs, every strategy ...
    ok, nbad, first = verify_matrix(np.asarray(jres.c)[ok_tiles],
                                    got[ok_tiles], verbose=False)
    assert ok, f"{nbad} elements off JAX's C, first at {first}"
    tiles = (m // 128) * (n // 128)
    faults = tiles * jinj.expected_faults(k, JTILE.bk)
    missed = inject == "unit" and threshold == "static"
    # ... and, where no fault is left in C, against the oracle.
    if inject == "clean" or (strategy != "global" and not missed):
        ok, nbad, first = verify_matrix(_oracle(a, b, c)[ok_tiles],
                                        got[ok_tiles], verbose=False)
        assert ok, f"{nbad} elements off the oracle, first at {first}"
    if inject == "clean" or missed:
        # 9500 misses faults of magnitude 1; both packages keep them in C.
        assert jdet.sum() == 0 and junc.sum() == 0
    else:
        # global counts fault EVENTS, one a check interval at most.
        assert jdet.sum() == faults or strategy == "global"
        assert junc.sum() == (jdet.sum() if strategy == "global" else 0)


@pytest.mark.parametrize("strategy", VPU)
def test_fp8_ft_clean_matches_fp8_plain(strategy):
    a, b, c = _inputs(256, 256, 512, seed=4)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        in_dtype="fp8", device="cpu")(a, b, c)
    plain = make_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="fp8",
                       device="cpu")
    np.testing.assert_allclose(res.c.numpy(), plain(a, b, c).numpy(),
                               rtol=1e-5, atol=1e-4)
    assert int(res.num_detected) == 0


@pytest.mark.parametrize("bm", [16, 128])
def test_expected_col_checksums_fp8_match_jax(bm):
    # B widened to f32 at full precision, as the JAX package does for
    # 1-byte operands (ops/ft_sgemm.py:1237-1245).
    a, b, _ = _inputs(256, 192, 320, seed=14)
    ap, bp = (as_operand(x, F8, CPU) for x in (a, b))
    got = ft._expected_col_checksums(ap, bp, bm)
    ja, jb = (jnp.asarray(x).astype(jnp.float8_e4m3fn) for x in (a, b))
    want = np.asarray(jft_ops._expected_col_checksums(ja, jb, bm, "default"))
    want = want.reshape(-1, 8, want.shape[1])[:, :3]
    # Both f32 over the same rounded values, summed in other orders: within
    # a few f32 ulps of each moment's largest magnitude (w^2 reaches bm^2).
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale).all()


def test_kernel_names_carry_dtype():
    for strategy in VPU:
        fn = make_ft_sgemm("test", strategy=strategy, in_dtype="fp8",
                           device="cpu")
        jfn = jft.make_ft_sgemm("test", strategy=strategy, in_dtype="fp8")
        assert fn.__name__ == jfn.__name__
        assert fn.__name__.endswith("_float8_e4m3fn")
        assert fn.in_dtype == "float8_e4m3fn"
        assert fn.shape_config == SHAPES["test"]  # the paper's tile


@pytest.mark.parametrize("strategy", VPU)
def test_fp8_paper_tile_ragged(strategy):
    # The medium tile (32x32x8) with M, N and K that are not multiples of
    # 128, 32 or 16 (a 7 x 5 grid, the last row and column of tiles padded;
    # rows of K = 96 stored 16 bytes apart): every tile sees the schedule's
    # faults (padding rows included), each detected; C is the rounded
    # oracle's on every tile where the strategy corrects, and JAX's grids.
    m, n, k = 200, 136, 88
    a, b, c = _inputs(m, n, k, seed=31)
    shape = SHAPES["medium"]
    inj = InjectionSpec.reference_like(k, shape.bk)
    res = make_ft_sgemm("medium", alpha=ALPHA, beta=BETA, strategy=strategy,
                        in_dtype="fp8", device="cpu")(a, b, c, inj)
    assert tuple(res.detections.shape) == (7, 5)
    nk = -(-k // shape.bk)
    _, ce, _ = ft._plan(strategy, None, None, inj, nk, shape.bn)
    if strategy == "global":
        events = len({(f * inj.every) // ce for f in range(
            inj.expected_faults(k, shape.bk))})
        assert (res.detections.numpy() == events).all()
        assert torch.equal(res.detections, res.uncorrectable)
    else:
        assert (res.detections.numpy() ==
                inj.expected_faults(k, shape.bk)).all()
        assert int(res.num_uncorrectable) == 0
        ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                    verbose=False)
        assert ok, f"{nbad} elements off"


@pytest.mark.parametrize("kind,multifault", [("precomp", False),
                                             ("running", False),
                                             ("rowcol", True),
                                             ("global", False)])
def test_fp8_plain_versions_are_the_f32_algorithm_on_rounded_values(
        kind, multifault):
    # On CPU tensors each wrapper takes its plain version; with fp8
    # operands (rows 16 bytes apart) that is the f32 tile algorithm on
    # their values, bit for bit.
    shape = SHAPES["medium"]
    a, b, c = _inputs(96, 64, 80, seed=1)
    ab, bb = (align_rows16(pad_to(as_operand(x, F8, CPU), mm, shape.bk))
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c), shape.bm, shape.bn)
    sc = scalar_operand(InjectionSpec(enabled=True, every=3), (9500.0,) * 3)
    runs = []
    for x, y in ((ab, bb), (ab.float(), bb.float())):
        extra = ft.kernel_inputs(kind, x, y, shape)
        runs.append(ft.run_kernel(kind, shape, x, y, cp, extra, ALPHA, BETA,
                                  sc, 3, multifault))
    (out, det, unc), (out32, det32, unc32) = runs
    assert torch.equal(det, det32) and torch.equal(unc, unc32)
    assert int(det.sum()) > 0
    assert torch.equal(out, out32)


@pytest.mark.parametrize("kw", [dict(threshold="adaptive"),
                                dict(strategy="rowcol", threshold="adaptive"),
                                dict(strategy="global", threshold="adaptive")])
def test_fp8_adaptive_is_not_ported(kw):
    # Ported since the adaptive bf16 builds (B5, B3, B4 on the widened
    # operands; tests/test_torch_ft_adaptive_lowp.py holds it against the
    # JAX package): faults of magnitude 5 at every step, which 9500
    # misses, are each caught, and corrected to the oracle where the
    # strategy corrects (global counts one event a check).
    a, b, c = _inputs(128, 128, 256, seed=2)
    fn = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="fp8",
                       device="cpu", **kw)
    assert fn.threshold_mode == "adaptive"
    assert int(fn(a, b, c).num_detected) == 0
    res = fn(a, b, c, InjectionSpec(enabled=True, every=1, magnitude=5.0))
    assert int(res.num_detected) == 2
    if kw.get("strategy") == "global":
        assert int(res.num_uncorrectable) == 2
        return
    assert int(res.num_uncorrectable) == 0
    ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                verbose=False)
    assert ok, f"{nbad} elements off"


@pytest.mark.parametrize("kw", [dict(encode="mxu"), dict(strategy="fused"),
                                dict(strategy="rowcol", encode="mxu")])
def test_fp8_checksum_rows_are_illegal(kw):
    with pytest.raises(ValueError):
        make_ft_sgemm("test", in_dtype="fp8", device="cpu", **kw)

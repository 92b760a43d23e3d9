"""``make_ft_sgemm(threshold="adaptive")`` on the mxu encodes in bf16 (the
adaptive bf16 builds of B6, B7 and B8) on the CPU, the port's plain
versions against the JAX package in interpret mode on the same numpy
inputs.

(a) The thresholds: every tile's adaptive threshold at every check that
the plain versions of B6 (fused), B7 (rowcol/mxu) and B8 (global/mxu)
derive, at the test and medium tiles, equals the JAX package's
``_adaptive_threshold`` on the moments that its ``_accumulate_moments``
sums of the rounded A and B blocks (the operands' own rows, not the
moment rows the mxu kernels also load: ops/ft_sgemm.py:711-712, 801-802,
1130-1131) to 1e-5 relative (f32 sums in two orders), as
tests/test_torch_ft_adaptive_lowp.py holds B3-B5's.
(b) At the JAX package's 128x128x128 tile, on the inputs of
tests/test_low_precision.py:195 (128x128x512, seed 17), under fused,
weighted/mxu, rowcol/mxu and global/mxu: a clean run detects nothing in
either package, and faults of magnitude 5 at every step (which the static
9500 misses) give EQUAL ``detections`` and ``uncorrectable`` grids (4
detected; none uncorrectable where the strategy corrects, 4 under the
detect-only global) and C within ``verify_matrix`` of the JAX package's C
wherever the strategy corrects. At the medium tile, which the JAX package
does not run, the plain versions flag nothing on a clean run and catch
every reference-like fault of magnitude 5, C within ``verify_matrix`` of
the oracle.
(c) The program's verification under "adaptive" (the reference driver's
inputs at 512, reference-like faults of 1e4) at the test tile: both
packages pass fused, weighted/mxu and global/mxu with equal grids and fail
rowcol/mxu (the correction residue of a 1e4 fault cascades at later
checks, ROADMAP Queue C).
(d) Routing: an adaptive bf16 launch of B6-B8 takes the adaptive bf16
build and counts in ``adaptive_launches`` and ``bf16_launches``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.ops import ft_sgemm as jft_ops
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, make_ft_sgemm, runtime
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import DEFAULT_THRESHOLD_MARGIN
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

ALPHA, BETA = 1.0, -1.5
JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
# (strategy, encode) of each mxu program (weighted with mxu runs B6, as fused).
PAIRS = {"fused": ("fused", "mxu"), "weighted-mxu": ("weighted", "mxu"),
         "rowcol-mxu": ("rowcol", "mxu"), "global-mxu": ("global", "mxu")}
TINY = dict(enabled=True, every=1, magnitude=5.0)


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


def _port(shape, strategy, encode, **kw):
    return make_ft_sgemm(shape, alpha=ALPHA, beta=BETA, strategy=strategy,
                         encode=encode, threshold="adaptive",
                         in_dtype="bfloat16", device="cpu", **kw)


# (a) The thresholds from the rounded operands' own rows.


@pytest.mark.parametrize("strategy", ["fused", "rowcol", "global"])
@pytest.mark.parametrize("tile", ["test", "medium"])
def test_adaptive_bf16_mxu_thresholds_like_jax(monkeypatch, tile, strategy):
    shape = SHAPES[tile]
    bm, bn, bk = shape.block
    rng = np.random.default_rng(5)
    m, n, k = 2 * bm, 3 * bn, 4 * bk
    a = rng.uniform(-300.0, 300.0, (m, k)).astype(np.float32)
    b = rng.uniform(-2.0, 2.0, (n, k)).astype(np.float32)
    seen = []
    real = ft._adaptive_threshold

    def spy(mom, step, shape_, nk, margin, global_tile=False):
        thr = real(mom, step, shape_, nk, margin, global_tile)
        seen.append((step, global_tile, thr.numpy().copy()))
        return thr

    monkeypatch.setattr(ft, "_adaptive_threshold", spy)
    fn = _port(shape, strategy, "mxu")
    fn(a, b, np.zeros((m, n), np.float32), InjectionSpec.none())
    nk = k // bk
    _, ce, _ = ft._plan(strategy, None, None, InjectionSpec.none(), nk, bn,
                        "mxu", adaptive=True)
    steps = sorted({min(s, nk - 1) for s in range(ce - 1, nk + ce - 1, ce)})
    assert [s for s, _, _ in seen] == steps
    assert {g for _, g, _ in seen} == {strategy == "global"}
    ja, jb = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
              for x in (a, b))
    jmom = np.zeros((m // bm, n // bn, 4), np.float32)
    got = dict((s, thr) for s, _, thr in seen)
    for step in range(nk):
        cols = slice(step * bk, (step + 1) * bk)
        for i in range(m // bm):
            for j in range(n // bn):
                jft_ops._accumulate_moments(
                    jmom[i, j], ja[i * bm:(i + 1) * bm, cols],
                    jb[j * bn:(j + 1) * bn, cols])
                if step not in got:
                    continue
                want = float(jft_ops._adaptive_threshold(
                    jnp.asarray(jmom[i, j]), jnp.int32(step), bk=bk, bm=bm,
                    bn=bn, nk=nk, margin=DEFAULT_THRESHOLD_MARGIN,
                    global_tile=strategy == "global"))
                assert got[step][i, j] == pytest.approx(want, rel=1e-5)


# (b) Clean runs and magnitude-5 faults.


def _both(a, b, c, strategy, encode, inject):
    jres = jft.make_ft_sgemm(JTILE, alpha=ALPHA, beta=BETA, strategy=strategy,
                             encode=encode, threshold="adaptive",
                             in_dtype="bfloat16")(
        a, b, c, JInjectionSpec(**inject) if inject else None)
    res = _port(SHAPES["test"], strategy, encode)(
        a, b, c, InjectionSpec(**inject) if inject else None)
    return jres, res


@pytest.mark.parametrize("pair", list(PAIRS))
def test_adaptive_bf16_mxu_clean_runs_flag_nothing(pair):
    a, b, c = _inputs(128, 128, 512, seed=17)
    jres, res = _both(a, b, c, *PAIRS[pair], None)
    for r in (jres, res):
        assert int(r.num_detected) == 0 and int(r.num_uncorrectable) == 0
    ok, nbad, _ = verify_matrix(np.asarray(jres.c), res.c.numpy(),
                                verbose=False)
    assert ok, f"{nbad} elements off the JAX package's C"


@pytest.mark.parametrize("pair", list(PAIRS))
def test_adaptive_bf16_mxu_tiny_faults_like_jax(pair):
    strategy, encode = PAIRS[pair]
    a, b, c = _inputs(128, 128, 512, seed=17)
    jres, res = _both(a, b, c, strategy, encode, TINY)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    assert int(res.num_detected) == 4
    assert int(res.num_uncorrectable) == (4 if strategy == "global" else 0)
    if strategy != "global":
        ok, nbad, _ = verify_matrix(np.asarray(jres.c), res.c.numpy(),
                                    verbose=False)
        assert ok, f"{nbad} elements off the JAX package's C"


@pytest.mark.parametrize("pair", list(PAIRS))
def test_adaptive_bf16_mxu_paper_tile(pair):
    strategy, encode = PAIRS[pair]
    shape = SHAPES["medium"]
    m, n, k = 96, 64, 256
    a, b, c = _inputs(m, n, k, seed=23)
    fn = _port(shape, strategy, encode)
    want = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="bfloat16",
                           device="cpu").numpy()
    clean = fn(a, b, c)
    assert int(clean.num_detected) == 0 and int(clean.num_uncorrectable) == 0
    assert verify_matrix(want, clean.c.numpy(), verbose=False)[0]
    inj = InjectionSpec.reference_like(k, shape.bk, magnitude=5.0)
    res = fn(a, b, c, inj)
    expected = (m // shape.bm) * (n // shape.bn) * inj.expected_faults(
        k, shape.bk)
    assert int(res.num_detected) == expected
    if strategy == "global":
        assert int(res.num_uncorrectable) == expected
    else:
        assert int(res.num_uncorrectable) == 0
        assert verify_matrix(want, res.c.numpy(), verbose=False)[0]


# (c) The program's verdicts.


@pytest.mark.parametrize("pair", list(PAIRS))
def test_adaptive_bf16_mxu_program_verdicts_like_jax(pair):
    strategy, encode = PAIRS[pair]
    n = 512
    a, b = runtime.generate_reference_driver_inputs(n)
    c = np.zeros((n, n), np.float32)
    want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA,
                                          in_dtype="bfloat16"))
    inj = InjectionSpec.reference_like(n, SHAPES["test"].bk)
    kw = dict(enabled=True, every=inj.every, magnitude=inj.magnitude)
    jres, res = _both(a, b, c, strategy, encode, kw)
    expected = (n // 128) ** 2 * inj.expected_faults(n, 128)
    verdicts = []
    for c_out, det, unc in ((np.asarray(jres.c), np.asarray(jres.detections),
                             np.asarray(jres.uncorrectable)),
                            (res.c.numpy(), res.detections.numpy(),
                             res.uncorrectable.numpy())):
        if strategy == "global":
            verdicts.append(int(det.sum()) == expected)
        else:
            verdicts.append(int(unc.sum()) == 0 and verify_matrix(
                want, c_out, verbose=False)[0])
    assert verdicts == [strategy != "rowcol"] * 2
    if strategy != "rowcol":
        assert int(res.num_detected) == expected
        np.testing.assert_array_equal(res.detections.numpy(),
                                      np.asarray(jres.detections))
        np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                      np.asarray(jres.uncorrectable))
    else:
        assert int(res.num_uncorrectable) > 0 and int(jres.num_uncorrectable) > 0


# (d) Routing and counting.


@pytest.mark.parametrize("kind,extra", [("fused", 1), ("rowcol_mxu", 2),
                                        ("global_mxu", 2)])
def test_adaptive_bf16_mxu_launch_routes_and_counts(monkeypatch, kind, extra):
    calls = []

    def entry(which):
        def fn(*args):
            calls.append(which)
            return 0
        fn.__name__ = which
        return fn

    monkeypatch.setattr(ft, "_entries", lambda adaptive=False: pytest.fail(
        "an f32 build"))
    monkeypatch.setattr(ft, "_bf16_entries", lambda adaptive=False: (
        {(kind, torch.bfloat16): entry("adaptive bf16")} if adaptive
        else pytest.fail("the static bf16 build")))
    monkeypatch.setattr(ft, "check_operands",
                        lambda shape, *t, **kw: (16, 16, 16, 16, 16, 16))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    a, b = (torch.zeros((16, 16), dtype=torch.bfloat16) for _ in range(2))
    c = torch.zeros((16, 16))
    rows = tuple(torch.zeros((1, 3, 16), dtype=torch.bfloat16)
                 for _ in range(extra))
    wrapper = types.SimpleNamespace(
        launches=0, adaptive_launches=0, bf16_launches=0, fp8_launches=0,
        int8_launches=0)
    sc = ft.scalar_operand(InjectionSpec.none(), (0.0,) * 3,
                           DEFAULT_THRESHOLD_MARGIN)
    ints = (4, 0) if kind == "rowcol_mxu" else (4,)
    ft._launch(wrapper, kind, SHAPES["small"], a, b, c, rows, ints, 1.0,
               -1.5, sc, adaptive=True)
    assert calls == ["adaptive bf16"]
    assert vars(wrapper) == {c: int(c in ("adaptive_launches",
                                          "bf16_launches"))
                             for c in vars(wrapper)}
    assert ft.kernel_entry(kind, torch.bfloat16, True) == (
        ft.ADAPTIVE_BF16_LIBS[kind], ft.ENTRY_POINTS[kind] + "_bf16")

"""``make_ft_sgemm(threshold="adaptive")`` in bf16 and fp8 (the adaptive
bf16 builds of B5, B3 and B4; fp8 on the operands widened to bf16) on the
CPU, the port's plain versions against the JAX package in interpret mode on
the same numpy inputs.

(a) At the JAX package's 128x128x128 tile, on the inputs of
tests/test_low_precision.py:195 (128x128x512, seed 17), for every vpu
strategy: a clean run detects nothing in either package, and faults of
magnitude 5 at every step (which the static 9500 misses) give EQUAL
``detections`` and ``uncorrectable`` grids (4 detected; none uncorrectable
where the strategy corrects, 4 under the detect-only global) and C within
``verify_matrix`` of the JAX package's C wherever the strategy corrects.
(b) The per-tile adaptive thresholds that the plain versions derive at
every check from the rounded operands' running moments equal the JAX
package's ``_adaptive_threshold`` on moments that it sums itself (f32 sums
in two orders) to 1e-5 relative, and the host twins
(``analysis.adaptive_threshold_grid`` and ``adaptive_threshold_estimate``
with ``in_dtype``) equal the JAX twin on the rounded operands.
(c) The driver: ``--threshold=adaptive`` with ``--dtype=bfloat16`` and with
``--dtype=fp8`` runs on the CPU, its header naming the dtype and the mode.
The mxu encodes in bf16 under "adaptive" (B6-B8) are
tests/test_torch_ft_adaptive_bf16_mxu.py.
The program's verdicts at 1024 are
``tests/test_torch_ft_adaptive.py::test_adaptive_program_verdicts_like_jax``.
"""

import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu import analysis as janalysis
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.ops import ft_sgemm as jft_ops
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, analysis, cli, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import DEFAULT_THRESHOLD_MARGIN, as_operand, pad_to
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

ALPHA, BETA = 1.0, -1.5
JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
DTYPES = ["bfloat16", "fp8"]
JAX_DTYPES = {"bfloat16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
VPU = ["weighted", "rowcol", "global"]
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


def _both(a, b, c, strategy, in_dtype, inject):
    """(JAX result, port result) of one adaptive call at the test tile."""
    jres = jft.make_ft_sgemm(JTILE, alpha=ALPHA, beta=BETA, strategy=strategy,
                             threshold="adaptive", in_dtype=in_dtype)(
        a, b, c, JInjectionSpec(**inject) if inject else None)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        threshold="adaptive", in_dtype=in_dtype,
                        device="cpu")(
        a, b, c, InjectionSpec(**inject) if inject else None)
    return jres, res


# (a) Clean runs and magnitude-5 faults at the test tile.


@pytest.mark.parametrize("strategy", VPU)
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_adaptive_lowp_clean_runs_flag_nothing(in_dtype, strategy):
    a, b, c = _inputs(128, 128, 512, seed=17)
    jres, res = _both(a, b, c, strategy, in_dtype, None)
    for r in (jres, res):
        assert int(r.num_detected) == 0 and int(r.num_uncorrectable) == 0
    ok, nbad, _ = verify_matrix(np.asarray(jres.c), res.c.numpy(),
                                verbose=False)
    assert ok, f"{nbad} elements off the JAX package's C"


@pytest.mark.parametrize("strategy", VPU)
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_adaptive_lowp_tiny_faults_like_jax(in_dtype, strategy):
    a, b, c = _inputs(128, 128, 512, seed=17)
    jres, res = _both(a, b, c, strategy, in_dtype, TINY)
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


# (b) The thresholds from the rounded operands' moments.


def _jax_rounded(x, in_dtype):
    return jnp.asarray(x).astype(JAX_DTYPES[in_dtype]).astype(jnp.float32)


@pytest.mark.parametrize("global_tile", [False, True],
                         ids=["correcting", "global"])
@pytest.mark.parametrize("tile", ["test", "medium"])
@pytest.mark.parametrize("in_dtype", DTYPES)
def test_adaptive_lowp_thresholds_like_jax(in_dtype, tile, global_tile):
    """Every tile's threshold at every check: the port's plain versions'
    (``_accumulate_moments`` of the rounded operands' blocks, then
    ``_adaptive_threshold``) against the JAX package's ``_adaptive_threshold``
    on the moments of its own rounding, summed by its own
    ``_accumulate_moments``; data spread over e4m3's range, where rounding
    moves the moments."""
    shape = SHAPES[tile]
    bm, bn, bk = shape.block
    rng = np.random.default_rng(5)
    m, n, k = 2 * bm, 3 * bn, 4 * bk
    a = rng.uniform(-300.0, 300.0, (m, k)).astype(np.float32)
    b = rng.uniform(-2.0, 2.0, (n, k)).astype(np.float32)
    dtype = TORCH_DTYPES[in_dtype]
    a4, b4, _, nk = ft._tiles(
        *(as_operand(x, dtype, torch.device("cpu")) for x in (a, b)),
        torch.zeros((m, n)), shape)
    ja, jb = _jax_rounded(a, in_dtype), _jax_rounded(b, in_dtype)
    np.testing.assert_array_equal(
        np.asarray(ja), a4.float().reshape(m, k).numpy())
    jmom = np.zeros((m // bm, n // bn, 4), np.float32)
    mom = None
    for step in range(nk):
        mom = ft._accumulate_moments(mom, a4[:, :, step], b4[:, :, step])
        plain = ft._adaptive_threshold(mom, step, shape, nk,
                                       DEFAULT_THRESHOLD_MARGIN,
                                       global_tile=global_tile).numpy()
        cols = slice(step * bk, (step + 1) * bk)
        for i in range(m // bm):
            for j in range(n // bn):
                jft_ops._accumulate_moments(
                    jmom[i, j], ja[i * bm:(i + 1) * bm, cols],
                    jb[j * bn:(j + 1) * bn, cols])
                want = float(jft_ops._adaptive_threshold(
                    jnp.asarray(jmom[i, j]), jnp.int32(step), bk=bk, bm=bm,
                    bn=bn, nk=nk, margin=DEFAULT_THRESHOLD_MARGIN,
                    global_tile=global_tile))
                assert plain[i, j] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("in_dtype", DTYPES)
def test_adaptive_lowp_host_twins_round_like_jax(in_dtype):
    """``analysis.adaptive_threshold_estimate`` and
    ``adaptive_threshold_grid`` with ``in_dtype`` on f32 data equal the JAX
    twin on the operands the JAX package rounds, and the f32 twin on the
    operands the port rounds; the f32 twin on the unrounded data differs
    (the rounding moves these moments)."""
    shape = SHAPES["large"]
    rng = np.random.default_rng(9)
    m, n, k = 2 * shape.bm, 2 * shape.bn, 64
    a = rng.uniform(-300.0, 300.0, (m, k)).astype(np.float32)
    b = rng.uniform(-300.0, 300.0, (n, k)).astype(np.float32)
    ja, jb = (np.asarray(_jax_rounded(x, in_dtype)) for x in (a, b))
    grid = analysis.adaptive_threshold_grid(a, b, bm=shape.bm, bn=shape.bn,
                                            in_dtype=in_dtype)
    dtype = TORCH_DTYPES[in_dtype]
    rounded = [as_operand(x, dtype, torch.device("cpu")).float().numpy()
               for x in (a, b)]
    np.testing.assert_array_equal(
        analysis.adaptive_threshold_grid(*rounded, bm=shape.bm, bn=shape.bn),
        grid)
    for i in range(2):
        for j in range(2):
            want = janalysis.adaptive_threshold_estimate(
                ja, jb, bm=shape.bm, bn=shape.bn, tile=(i, j))
            got = analysis.adaptive_threshold_estimate(
                a, b, bm=shape.bm, bn=shape.bn, tile=(i, j),
                in_dtype=in_dtype)
            assert got == pytest.approx(want, rel=1e-12)
            assert grid[i, j] == pytest.approx(want[0], rel=1e-12)
    unrounded = analysis.adaptive_threshold_grid(a, b, bm=shape.bm,
                                                 bn=shape.bn)
    assert not np.allclose(unrounded, grid, rtol=1e-6)


# (c) The driver.

LINE = re.compile(r"^Verification of kernel (?P<id>[ \d]\d) \((?P<name>.{20})\): "
                  r"(?P<status>.*)$")


@pytest.mark.parametrize("spelling,name", [("bfloat16", "bfloat16"),
                                           ("fp8", "float8_e4m3fn")])
def test_adaptive_lowp_driver_runs_on_the_cpu(spelling, name, capsys):
    argv = ["ft_sgemm", "128", "128", "128", "11", "16", "--device=cpu",
            "--no-perf", f"--dtype={spelling}", "--threshold=adaptive",
            "--strategy=global"]
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    assert f"Verification in {name} (threshold adaptive): A and B rounded" in out
    verdicts = {int(mm["id"]): mm["status"].split()[0]
                for mm in map(LINE.match, out.splitlines()) if mm}
    assert sorted(verdicts) == list(range(11, 17))
    # Global counts every fault event of the reference-like schedule.
    assert set(verdicts.values()) == {"pass"} and rc == 0
    assert "not ported" not in err


def test_adaptive_lowp_plans_like_f32():
    # Weighted runs B5 at every cadence under adaptive (B2 has no adaptive
    # build), in every dtype; the legality tables take every mode. The
    # fused strategy under adaptive runs in bf16 (B6's adaptive bf16 build)
    # and is illegal in fp8 (no moment rows in a 1-byte dtype).
    inj = InjectionSpec.reference_like(4096, SHAPES["huge"].bk)
    assert ft._plan("weighted", None, None, inj, 512, 128,
                    adaptive=True)[:2] == ("running", 512)
    for in_dtype in DTYPES:
        for strategy in VPU:
            fn = make_ft_sgemm("huge", strategy=strategy, threshold="adaptive",
                               in_dtype=in_dtype, device="cpu")
            jfn = jft.make_ft_sgemm("huge", strategy=strategy,
                                    threshold="adaptive", in_dtype=in_dtype)
            assert fn.threshold_mode == jfn.threshold_mode == "adaptive"
        if in_dtype == "bfloat16":
            fn = make_ft_sgemm("huge", strategy="fused", threshold="adaptive",
                               in_dtype=in_dtype, device="cpu")
            jfn = jft.make_ft_sgemm("huge", strategy="fused",
                                    threshold="adaptive", in_dtype=in_dtype)
            assert fn.__name__ == jfn.__name__
            assert fn.threshold_mode == jfn.threshold_mode == "adaptive"
            assert ft._plan("fused", None, None, inj, 512, 128, "mxu",
                            adaptive=True)[0] == "fused"
        else:
            with pytest.raises(ValueError):
                make_ft_sgemm("huge", strategy="fused", threshold="adaptive",
                              in_dtype=in_dtype, device="cpu")


def test_adaptive_lowp_grid_twin_matches_the_plain_versions():
    # At the final check the grid twin (float64 sums) is the plain
    # versions' threshold (f32 sums) on the rounded operands.
    shape = SHAPES["tall"]
    a, b, _ = _inputs(2 * shape.bm, 3 * shape.bn, 40, seed=4)
    ap, bp = (pad_to(as_operand(x, torch.bfloat16, torch.device("cpu")), t,
                     shape.bk) for x, t in ((a, shape.bm), (b, shape.bn)))
    a4, b4, _, nk = ft._tiles(ap, bp, torch.zeros((ap.shape[0], bp.shape[0])),
                              shape)
    mom = None
    for step in range(nk):
        mom = ft._accumulate_moments(mom, a4[:, :, step], b4[:, :, step])
    plain = ft._adaptive_threshold(mom, nk - 1, shape, nk,
                                   DEFAULT_THRESHOLD_MARGIN).numpy()
    twin = analysis.adaptive_threshold_grid(
        a, b, bm=shape.bm, bn=shape.bn, margin=DEFAULT_THRESHOLD_MARGIN,
        in_dtype="bfloat16")
    np.testing.assert_allclose(plain, twin, rtol=1e-5)


class _FakeLibrary:
    """A loaded library whose entry points record their names."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, fname):
        return types.SimpleNamespace(library=self.name, fname=fname)


def test_adaptive_bf16_builds_apart_from_f32(monkeypatch):
    # The adaptive f32 entry points build and bind the four f32 adaptive
    # libraries alone; the adaptive bf16 ones the five *_adaptive_bf16
    # libraries alone (B3, B4 with B8, B5, B6, B7), with B3-B8's f32
    # argument types.
    built = []
    monkeypatch.setattr(ft, "build", lambda names: built.append(tuple(names)))
    monkeypatch.setattr(ft, "library", _FakeLibrary)
    f32 = ft._entries.__wrapped__(True)
    assert built == [tuple(n + "_adaptive" for n in ft.FT_LIBS)]
    assert {fn.library for fn in f32.values()}.isdisjoint(
        ft.ADAPTIVE_BF16_LIBS)
    built.clear()
    lowp = ft._bf16_entries.__wrapped__(True)
    libs = tuple(dict.fromkeys(ft.ADAPTIVE_BF16_LIBS.values()))
    assert built == [libs] and len(libs) == 5
    assert sorted(lowp) == [(k, torch.bfloat16) for k in (
        "fused", "global", "global_mxu", "rowcol", "rowcol_mxu", "running")]
    for (kind, _), fn in lowp.items():
        assert fn.library == ft.ADAPTIVE_BF16_LIBS[kind]
        assert fn.fname.endswith("_bf16") and fn.restype is ctypes.c_int
        assert fn.argtypes == f32[kind].argtypes


@pytest.mark.parametrize("in_dtype", ["float32"] + DTYPES)
def test_adaptive_launch_routes_and_counts_by_dtype(monkeypatch, in_dtype):
    # An adaptive launch takes the f32 adaptive build in f32 and the
    # adaptive bf16 build in bf16 and fp8 (widened), and counts in
    # adaptive_launches and, in bf16 and fp8, in its dtype's counter.
    calls = []

    def entry(which):
        def fn(*args):
            calls.append(which)
            return 0
        fn.__name__ = which
        return fn

    monkeypatch.setattr(ft, "_entries", lambda adaptive=False, one_pass=False:
                        ({"rowcol": entry("f32")} if adaptive
                         else pytest.fail("static")))
    monkeypatch.setattr(ft, "_bf16_entries", lambda adaptive=False: (
        {("rowcol", torch.bfloat16): entry("bf16")} if adaptive
        else pytest.fail("static")))
    monkeypatch.setattr(ft, "check_operands",
                        lambda shape, *t, **kw: (16, 16, 16, 16, 16, 16))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    dtype = getattr(torch, "float32" if in_dtype == "float32"
                    else "bfloat16" if in_dtype == "bfloat16"
                    else "float8_e4m3fn")
    a, b = (torch.zeros((16, 16)).to(dtype) for _ in range(2))
    c = torch.zeros((16, 16))
    wrapper = types.SimpleNamespace(
        launches=0, adaptive_launches=0, bf16_launches=0, fp8_launches=0,
        int8_launches=0)
    sc = ft.scalar_operand(InjectionSpec.none(), (0.0,) * 3,
                           DEFAULT_THRESHOLD_MARGIN)
    ft._launch(wrapper, "rowcol", SHAPES["small"], a, b, c, (), (4, 0), 1.0,
               -1.5, sc, adaptive=True)
    assert calls == ["f32" if in_dtype == "float32" else "bf16"]
    label = {"float32": None, "bfloat16": "bf16_launches",
             "fp8": "fp8_launches"}[in_dtype]
    assert vars(wrapper) == {c: int(c in ("adaptive_launches", label))
                             for c in vars(wrapper)}

"""The fused epilogue through the port's entry points, against the JAX
package: ``make_ft_sgemm(..., epilogue=...)(a, b, c, inject, bias=v)`` and
``make_sgemm(..., epilogue=...)(a, b, c, bias=v)`` on the CPU (the kernels'
plain versions, ``device="cpu"``) against ``ft_sgemm_tpu``'s factories in
interpret mode, at the JAX package's own 128 x 128 x 128 tile (the port's
``test`` tile), mirroring tests/test_variants.py:150-238.

Stated tolerances: the ``detections`` and ``uncorrectable`` grids must be
EQUAL (the epilogue runs after the checks); C within 3e-2 of the host
oracle ``epilogue_reference(sgemm_reference(...))`` and of the JAX
package's C (the JAX test's own bound: the two packages sum in different
orders, and gelu's tanh differs by an ulp or two); int8 with
``bias+qint8x0.25`` on integer-lattice data EXACTLY; qfp8 more than 98 %
exact e4m3-grid matches and every value within one e4m3 step (rtol 0.15,
atol 0.02), every output on the grid.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelVariant as JKernelVariant
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu_torch import (
    SHAPES,
    EpilogueSpec,
    KernelVariant,
    epilogue_reference,
    ft_sgemm,
    make_ft_sgemm,
    make_sgemm,
    sgemm_reference,
)
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import sgemm as sg
from ft_sgemm_tpu_torch.ops.common import apply_epilogue, pad_bias, pad_to, scalar_operand
from ft_sgemm_tpu_torch.ops.reference import epilogue_violations

N = 256
TILE = SHAPES["test"]  # the JAX package's "small": 128 x 128 x 128
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, m=N, n=N, k=N, int_lattice=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    if int_lattice:
        a, b, c = np.round(a * 4.0), np.round(b * 4.0), np.round(c * 4.0)
    bias = rng.standard_normal((n,)).astype(np.float32)
    return a, b, c, (np.round(bias * 4.0) if int_lattice else bias)


def _both(strategy, encode, epilogue, a, b, c, bias, inject=True,
          in_dtype="float32"):
    jinj = JInjectionSpec.reference_like(N, 128) if inject else None
    jres = jft.make_ft_sgemm("small", strategy=strategy, encode=encode,
                             in_dtype=in_dtype, tunable=False,
                             epilogue=epilogue)(a, b, c, jinj, bias=bias)
    inj = InjectionSpec.reference_like(N, 128) if inject else None
    res = make_ft_sgemm(TILE, strategy=strategy, encode=encode,
                        in_dtype=in_dtype, epilogue=epilogue,
                        device="cpu")(a, b, c, inj, bias=bias)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    return jres, res


PAIRS = [("weighted", "vpu"), ("weighted", "mxu"), ("rowcol", "vpu"),
         ("rowcol", "mxu"), ("fused", "mxu")]


@pytest.mark.parametrize("strategy,encode", PAIRS,
                         ids=[f"{s}-{e}" for s, e in PAIRS])
@pytest.mark.parametrize("epilogue", ["bias", "bias+relu", "bias+gelu"])
def test_epilogue_after_correction_under_injection(strategy, encode,
                                                   epilogue):
    a, b, c, bias = _operands(0)
    jres, res = _both(strategy, encode, epilogue, a, b, c, bias)
    # Correction happened on the pre-epilogue accumulator...
    assert int(res.num_detected) > 0 and int(res.num_uncorrectable) == 0
    # ...and C equals the host oracle through the epilogue.
    want = epilogue_reference(
        sgemm_reference(a, b, c, 1.0, -1.5, device="cpu"), epilogue, bias)
    got = res.c.numpy()
    np.testing.assert_allclose(got, want.numpy(), atol=3e-2)
    np.testing.assert_allclose(got, np.asarray(jres.c), atol=3e-2)


@pytest.mark.parametrize("encode", ["vpu", "mxu"])
def test_epilogue_detect_only_global(encode):
    # global never corrects: the clean run matches the oracle through the
    # epilogue, the injected run still detects every fault event.
    a, b, c, bias = _operands(1)
    _, res = _both("global", encode, "bias+relu", a, b, c, bias,
                   inject=False)
    want = epilogue_reference(
        sgemm_reference(a, b, c, 1.0, -1.5, device="cpu"), "bias+relu", bias)
    np.testing.assert_allclose(res.c.numpy(), want.numpy(), atol=3e-2)
    _, res_inj = _both("global", encode, "bias+relu", a, b, c, bias)
    assert int(res_inj.num_detected) > 0


@pytest.mark.parametrize("strategy", ["rowcol", "global"])
def test_epilogue_int8_exact_quantize(strategy):
    a, b, c, bias = _operands(2, int_lattice=True)
    jres, res = _both(strategy, "vpu", "bias+qint8x0.25", a, b, c, bias,
                      inject=strategy == "rowcol", in_dtype="int8")
    if strategy == "rowcol":
        assert int(res.num_detected) > 0 and int(res.num_uncorrectable) == 0
    want = epilogue_reference(
        sgemm_reference(a, b, c, 1.0, -1.5, in_dtype="int8", device="cpu"),
        "bias+qint8x0.25", bias)
    # int8-exact: correction and quantize grid are both exact — equality.
    np.testing.assert_array_equal(res.c.numpy(), want.numpy())
    np.testing.assert_array_equal(res.c.numpy(), np.asarray(jres.c))


@pytest.mark.parametrize("strategy,encode", [("weighted", "vpu"),
                                             ("rowcol", "mxu")])
def test_epilogue_fp8_quantize_roundtrip(strategy, encode):
    a, b, c, _ = _operands(3)
    jres, res = _both(strategy, encode, "qfp8", a, b, c, None, inject=False)
    want = epilogue_reference(
        sgemm_reference(a, b, c, 1.0, -1.5, device="cpu"), "qfp8").numpy()
    out = res.c.numpy()
    # A half-ulp f32 summation-order difference can land on the
    # neighbouring e4m3 step: almost all identical, each outlier one step.
    for other in (want, np.asarray(jres.c)):
        assert np.mean(out == other) > 0.98
        np.testing.assert_allclose(out, other, rtol=0.15, atol=0.02)
    import ml_dtypes

    np.testing.assert_array_equal(
        out, out.astype(ml_dtypes.float8_e4m3fn).astype(np.float32))


def test_epilogue_bias_required_and_rejected():
    kern = make_ft_sgemm(TILE, epilogue="bias+relu", device="cpu")
    a = b = c = np.zeros((N, N), np.float32)
    with pytest.raises(ValueError, match="fuses a"):
        kern(a, b, c)
    plain = make_ft_sgemm(TILE, device="cpu")
    with pytest.raises(ValueError, match="does not fuse"):
        plain(a, b, c, None, bias=np.zeros((N,), np.float32))
    with pytest.raises(ValueError, match="length N"):
        kern(a, b, c, None, bias=np.zeros((N + 1,), np.float32))
    for fn in (make_sgemm(TILE, epilogue="bias", device="cpu"),):
        with pytest.raises(ValueError, match="fuses a"):
            fn(a, b, c)
        with pytest.raises(ValueError, match="length N"):
            fn(a, b, c, bias=np.zeros((N - 1,), np.float32))
    with pytest.raises(ValueError, match="does not fuse"):
        make_sgemm(TILE, device="cpu")(a, b, c, bias=np.zeros(N, np.float32))


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16", "fp8"])
@pytest.mark.parametrize("epilogue", ["bias+gelu+qint8x0.25",
                                      "bias+relu+qfp8", "bias"])
def test_make_sgemm_epilogue_matches_jax(in_dtype, epilogue):
    a, b, c, bias = _operands(4, 200, 136, 264)
    jdt = "float8_e4m3fn" if in_dtype == "fp8" else in_dtype
    jout = np.asarray(jft.make_sgemm("small", in_dtype=jdt, tunable=False,
                                     epilogue=epilogue)(a, b, c, bias=bias))
    fn = make_sgemm(TILE, in_dtype=in_dtype, epilogue=epilogue, device="cpu")
    got = fn(a, b, c, bias=bias).numpy()
    assert fn.variant.epilogue == EpilogueSpec.parse(epilogue).spelling
    x = sgemm_reference(a, b, c, 1.0, -1.5, in_dtype=in_dtype, device="cpu")
    want = epilogue_reference(x, epilogue, bias).numpy()
    # The port's plain version is the oracle's arithmetic; against the JAX
    # package (another summation order) a quantized output may sit one
    # grid step apart, an unquantized one within the JAX test's 3e-2.
    assert np.array_equal(got, want, equal_nan=True)
    if fn.variant.epilogue_spec.quantize == "none":
        np.testing.assert_allclose(got, jout, atol=3e-2)
    else:
        assert np.mean(got == jout) > 0.98
        np.testing.assert_allclose(got, jout, rtol=0.15, atol=1.0)


@pytest.mark.parametrize("axis", [dict(pipeline_depth=3),
                                  dict(grid_order="nm"),
                                  dict(dim_semantics="arbitrary")])
def test_unported_variant_axes_raise(axis):
    # Named for the slice in which these axes raised; they run now: the
    # factories take each axis (a variant or its dict) with an epilogue,
    # and give the JAX package's grids and C.
    a, b, c, bias = _operands(11)
    inj, jinj = (InjectionSpec.reference_like(N, 128),
                 JInjectionSpec.reference_like(N, 128))
    v, jv = (KernelVariant(epilogue="bias", **axis),
             JKernelVariant(epilogue="bias", **axis))
    jres = jft.make_ft_sgemm("small", strategy="rowcol", tunable=False,
                             variant=jv)(a, b, c, jinj, bias=bias)
    for var in (v, dict(v.__dict__)):
        res = make_ft_sgemm(TILE, strategy="rowcol", variant=var,
                            device="cpu")(a, b, c, inj, bias=bias)
        np.testing.assert_array_equal(res.detections.numpy(),
                                      np.asarray(jres.detections))
        np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                      np.asarray(jres.uncorrectable))
        np.testing.assert_allclose(res.c.numpy(), np.asarray(jres.c),
                                   atol=3e-2)
    jout = jft.make_sgemm("small", tunable=False, variant=jv)(a, b, c,
                                                               bias=bias)
    out = make_sgemm(TILE, variant=v, device="cpu")(a, b, c, bias=bias)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=3e-2)


def test_ring_overlap_is_accepted_and_ignored():
    a, b, c, bias = _operands(5)
    inj = InjectionSpec.reference_like(N, 128)
    plain = make_ft_sgemm(TILE, strategy="rowcol", epilogue="bias",
                          device="cpu")(a, b, c, inj, bias=bias)
    ring = make_ft_sgemm(TILE, strategy="rowcol", device="cpu",
                         variant=KernelVariant(ring_overlap="overlap",
                                               epilogue="bias"))
    res = ring(a, b, c, inj, bias=bias)
    assert torch.equal(res.c, plain.c)
    assert torch.equal(res.detections, plain.detections)
    assert ring.variant.ring_overlap == "overlap" and ring.epilogue == "bias"


def test_explicit_check_every_wins_over_the_variants():
    # global counts one event per check whose residual moved: with a fault
    # every K step, 8 steps give 4 events at a cadence of 2 and 2 at 4.
    a, b, c, _ = _operands(6, k=1024)
    inj, jinj = InjectionSpec(True, 1), JInjectionSpec(True, 1)
    v, jv = KernelVariant(check_every=4), JKernelVariant(check_every=4)

    def run(**kw):
        return make_ft_sgemm(TILE, strategy="global", device="cpu", **kw)(
            a, b, c, inj).detections

    explicit, both, by_variant = (run(check_every=2),
                                  run(check_every=2, variant=v),
                                  run(variant=v))
    jres = jft.make_ft_sgemm("small", strategy="global", variant=jv,
                             tunable=False)(a, b, c, jinj)
    assert torch.equal(both, explicit) and int(explicit.sum()) == 4 * 4
    assert int(by_variant.sum()) == 4 * 2
    np.testing.assert_array_equal(by_variant.numpy(),
                                  np.asarray(jres.detections))


@pytest.mark.parametrize("kw", [
    dict(strategy="weighted"), dict(strategy="rowcol", encode="mxu"),
    dict(strategy="fused", in_dtype="bfloat16"),
    dict(strategy="global", in_dtype="int8"),
    dict(strategy="rowcol", in_dtype="fp8", threshold="adaptive"),
    dict(strategy="global", encode="mxu", threshold="auto")])
@pytest.mark.parametrize("epilogue", [None, "none", "bias+gelu+qint8x0.25",
                                      "Bias+ReLU+qfp8", "qint8x2"])
def test_epilogue_names_match_jax(kw, epilogue):
    jkw = dict(kw, in_dtype={"fp8": "float8_e4m3fn"}.get(
        kw.get("in_dtype"), kw.get("in_dtype", "float32")))
    jfn = jft.make_ft_sgemm("huge", tunable=False, epilogue=epilogue, **jkw)
    fn = make_ft_sgemm("huge", epilogue=epilogue, device="cpu", **kw)
    assert fn.__name__ == jfn.__name__
    assert fn.epilogue == jfn.epilogue
    assert fn.variant == KernelVariant(epilogue=jfn.variant.epilogue)


KINDS = ["precomp", "running", "rowcol", "global", "fused", "rowcol_mxu",
         "global_mxu"]


@pytest.mark.parametrize("kind", ["sgemm"] + KINDS)
@pytest.mark.parametrize("spelling", ["bias+gelu+qint8x0.25",
                                      "bias+relu+qfp8"])
def test_kernel_wrappers_apply_the_epilogue_after_the_checks(kind, spelling):
    # The wrappers' CPU path (the plain versions): the epilogue's output is
    # apply_epilogue of the identity's, and the grids do not move.
    shape = SHAPES["small"]
    a, b, c, bias = _operands(7, 40, 40, 48)
    ap, bp = (pad_to(torch.from_numpy(x), t, shape.bk)
              for x, t in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c), shape.bm, shape.bn)
    row = pad_bias(bias, 40, shape.bn, CPU)
    epi = EpilogueSpec.parse(spelling)
    if kind == "sgemm":
        ident = sg.sgemm_kernel(ap, bp, cp, shape, 1.0, -1.5)
        got = sg.sgemm_kernel(ap, bp, cp, shape, 1.0, -1.5, epi, row)
        assert sg.sgemm_kernel.epilogue_launches == 0  # no launch on the CPU
    else:
        inj = InjectionSpec(enabled=True, every=2)
        sc = scalar_operand(inj, (9500.0,) * 3)
        extra = ft.kernel_inputs(kind, ap, bp, shape)
        ident, det, unc = ft.run_kernel(kind, shape, ap, bp, cp, extra, 1.0,
                                        -1.5, sc, 3)
        got, edet, eunc = ft.run_kernel(kind, shape, ap, bp, cp, extra, 1.0,
                                        -1.5, sc, 3, epi=epi, bias=row)
        assert torch.equal(det, edet) and torch.equal(unc, eunc)
    assert torch.equal(got.nan_to_num(7.0),
                       apply_epilogue(ident, epi, row).nan_to_num(7.0))
    assert int(epilogue_violations(got, ident, spelling, row).sum()) == 0


def test_one_shot_ft_sgemm_takes_epilogue_and_bias():
    a, b, c, bias = _operands(8)
    res = ft_sgemm(a, b, c, TILE, strategy="rowcol", epilogue="bias+relu",
                   bias=bias, inject=InjectionSpec.reference_like(N, 128),
                   device="cpu")
    want = epilogue_reference(
        sgemm_reference(a, b, c, 1.0, -1.5, device="cpu"), "bias+relu", bias)
    np.testing.assert_allclose(res.c.numpy(), want.numpy(), atol=3e-2)
    assert float(res.c.min()) >= 0.0

"""The bf16 input mode of the fused-ABFT factory (kernels B2-B5, the vpu
encodes), the port against the JAX package on the same numpy inputs.

At the JAX package's 128x128x128 tile (``SHAPES["test"]``) the JAX side runs
``ft_sgemm_tpu.make_ft_sgemm(in_dtype="bfloat16")`` in interpret mode and
the port its plain versions (``device="cpu"``): A and B rounded to bf16,
products, checksums, detection and correction in f32. For every vpu
(strategy, threshold) pair, clean and with reference-like faults, the
``detections`` and ``uncorrectable`` grids must be EQUAL and C must pass
``verify_matrix`` (0.01 absolute AND relative) against the JAX package's C
on every tile reported correctable, and against the oracle (the f32
product of the rounded operands) there too, except where the detect-only
global strategy keeps its faults. The cases of ``tests/test_mixed_precision.py`` for the FT
kernels follow, one paper tile with ragged M and N, and what stays out
(the mxu encodes), which raises ("adaptive" runs:
tests/test_torch_ft_adaptive_lowp.py; int8 runs: the exact mode,
tests/test_torch_ft_int8.py; fp8 runs: tests/test_torch_ft_fp8.py). The card tests
(marker ``cuda``) hold the bf16 builds against their plain versions.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, KernelShape, make_ft_sgemm, make_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import as_operand, pad_to, scalar_operand
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

ALPHA, BETA = 1.0, -1.5
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
    return sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="bfloat16",
                           device="cpu").numpy()


def _correctable(unc, shape, m, n):
    return np.repeat(np.repeat(np.asarray(unc) == 0, shape.bm, 0), shape.bn,
                     1)[:m, :n]


@pytest.mark.parametrize("strategy", VPU)
@pytest.mark.parametrize("threshold", ["static", "auto"])
@pytest.mark.parametrize("inject", ["clean", "reference_like"])
def test_bf16_ft_sgemm_matches_jax(strategy, threshold, inject):
    m, n, k = 256, 256, 512
    a, b, c = _inputs(m, n, k, seed=0)
    jinj = (JInjectionSpec.reference_like(k, JTILE.bk)
            if inject == "reference_like" else JInjectionSpec.none())
    inj = InjectionSpec(jinj.enabled, jinj.every, jinj.magnitude,
                        jinj.col_stride)
    jres = jft.make_ft_sgemm(JTILE, alpha=ALPHA, beta=BETA, strategy=strategy,
                             threshold=threshold, in_dtype="bfloat16")(
        a, b, c, jinj)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        threshold=threshold, in_dtype="bfloat16",
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
    # ... and, where no fault is left in C, against the oracle.
    if strategy != "global" or inject == "clean":
        ok, nbad, first = verify_matrix(_oracle(a, b, c)[ok_tiles],
                                        got[ok_tiles], verbose=False)
        assert ok, f"{nbad} elements off the oracle, first at {first}"
    if inject == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    else:
        tiles = (m // 128) * (n // 128)
        want_det = tiles * jinj.expected_faults(k, JTILE.bk)
        # global counts fault EVENTS, one a check interval at most.
        assert jdet.sum() == want_det or strategy == "global"
        assert junc.sum() == (jdet.sum() if strategy == "global" else 0)


@pytest.mark.parametrize("strategy", VPU)
def test_bf16_ft_clean_matches_bf16_plain(strategy):
    # tests/test_mixed_precision.py:64-73 on the port.
    a, b, c = _inputs(256, 256, 512, seed=4)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        in_dtype="bfloat16", device="cpu")(a, b, c)
    plain = make_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="bfloat16",
                       device="cpu")
    np.testing.assert_allclose(res.c.numpy(), plain(a, b, c).numpy(),
                               rtol=1e-5, atol=1e-4)
    assert int(res.num_detected) == 0


@pytest.mark.parametrize("strategy", ["rowcol", "weighted"])
def test_bf16_ft_corrects_injected_faults(strategy):
    # tests/test_mixed_precision.py:76-92: the same threshold as f32 catches
    # reference-magnitude faults, since the checksums see the rounded
    # values.
    m = n = 256
    k = 1024
    a, b, c = _inputs(m, n, k, seed=5)
    shape = SHAPES["test"]
    inj = InjectionSpec.reference_like(k, shape.bk, num_faults=4)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy=strategy,
                        in_dtype="bfloat16", device="cpu")(a, b, c, inj)
    ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                verbose=False)
    assert ok, f"{strategy}/bf16: {nbad} corrupted elements survived"
    tiles = (m // shape.bm) * (n // shape.bn)
    assert int(res.num_detected) == tiles * inj.expected_faults(k, shape.bk)


def test_bf16_ft_global_detects():
    # tests/test_mixed_precision.py:95-104.
    m = n = 256
    k = 512
    a, b, c = _inputs(m, n, k, seed=6)
    inj = InjectionSpec(enabled=True, every=k // SHAPES["test"].bk,
                        magnitude=10000.0)
    res = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, strategy="global",
                        in_dtype="bfloat16", device="cpu")(a, b, c, inj)
    assert int(res.num_detected) >= 1


def test_kernel_names_carry_dtype():
    # tests/test_mixed_precision.py:116-118, and equal to the JAX names.
    for strategy in VPU:
        fn = make_ft_sgemm("test", strategy=strategy, in_dtype="bfloat16",
                           device="cpu")
        jfn = jft.make_ft_sgemm("test", strategy=strategy,
                                in_dtype="bfloat16")
        assert fn.__name__ == jfn.__name__
        assert fn.__name__.endswith("_bfloat16") and fn.in_dtype == "bfloat16"
        assert fn.shape_config == SHAPES["test"]  # the paper's tile
    assert make_ft_sgemm("test", device="cpu").__name__ == \
        "ft_sgemm_test_weighted"


def test_auto_threshold_bf16_catches_small_faults():
    # tests/test_mixed_precision.py:169-190: the noise bound is taken on the
    # rounded values, and faults of magnitude 5 (invisible at 9500) are
    # detected and corrected within the tolerance, under both of the JAX
    # test's strategies: weighted (B2) and fused (the mxu encode, B6).
    tile = KernelShape("t128", 128, 128, 128, (0,) * 7)
    a, b, c = _inputs(128, 128, 512, seed=23)
    inj = InjectionSpec(enabled=True, every=1, magnitude=5.0)
    for strategy in ("weighted", "fused"):
        res = make_ft_sgemm(tile, alpha=ALPHA, beta=BETA, strategy=strategy,
                            in_dtype="bfloat16", threshold="auto",
                            device="cpu")(a, b, c, inj)
        ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                    verbose=False)
        assert ok, f"bf16/{strategy}: {nbad} small faults survived"
        assert int(res.num_detected) == 4
        assert int(res.num_uncorrectable) == 0


@pytest.mark.parametrize("strategy", VPU)
def test_bf16_paper_tile_ragged(strategy):
    # The medium tile (32x32x8; the JAX package's tiles are multiples of
    # 128) with M and N that are not multiples of 128 or 32: a 7 x 5 grid,
    # the last row and column of tiles padded. Every tile sees the
    # schedule's faults (padding rows included), each detected; C is the
    # rounded oracle's on every tile where the strategy corrects.
    m, n, k = 200, 136, 96
    a, b, c = _inputs(m, n, k, seed=31)
    shape = SHAPES["medium"]
    inj = InjectionSpec.reference_like(k, shape.bk)
    res = make_ft_sgemm("medium", alpha=ALPHA, beta=BETA, strategy=strategy,
                        in_dtype="bfloat16", device="cpu")(a, b, c, inj)
    assert tuple(res.detections.shape) == (7, 5)
    nk = -(-k // shape.bk)
    _, ce, _ = ft._plan(strategy, None, None, inj, nk, shape.bn)
    if strategy == "global":
        # one event per check interval that holds a fault
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


@pytest.mark.parametrize("kw", [
    dict(strategy="weighted", encode="mxu"), dict(strategy="fused"),
    dict(strategy="rowcol", encode="mxu"), dict(strategy="global",
                                                encode="mxu"),
    dict(threshold="adaptive"), dict(strategy="rowcol", threshold="adaptive")])
def test_bf16_unported_combinations_raise(kw):
    # Every slot runs now. The mxu encodes (the bf16 builds of B6-B8,
    # tests/test_torch_ft_bf16_mxu.py holds them against the JAX package):
    # a fault at each of the two bk steps is caught, corrected to the
    # oracle where the strategy corrects, and counted as an event by the
    # detect-only global. "adaptive" (the adaptive bf16 builds of B5 and
    # B3; tests/test_torch_ft_adaptive_lowp.py): faults of magnitude 5 at
    # every step, which 9500 misses, are each caught and corrected to the
    # oracle.
    a, b, c = _inputs(128, 128, 256, seed=2)
    if kw.get("threshold") != "adaptive":
        fn = make_ft_sgemm("test", alpha=ALPHA, beta=BETA,
                           in_dtype="bfloat16", device="cpu", **kw)
        assert fn.encode == "mxu" and fn.in_dtype == "bfloat16"
        res = fn(a, b, c, InjectionSpec(enabled=True, every=1))
        assert int(res.num_detected) == 2
        if kw["strategy"] == "global":
            assert torch.equal(res.detections, res.uncorrectable)
            return
        assert int(res.num_uncorrectable) == 0
        ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                    verbose=False)
        assert ok, f"{nbad} elements off"
        return
    fn = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="bfloat16",
                       device="cpu", **kw)
    assert fn.threshold_mode == "adaptive"
    assert int(fn(a, b, c).num_detected) == 0
    res = fn(a, b, c, InjectionSpec(enabled=True, every=1, magnitude=5.0))
    assert int(res.num_detected) == 2 and int(res.num_uncorrectable) == 0
    ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                verbose=False)
    assert ok, f"{nbad} elements off"


@pytest.mark.parametrize("in_dtype,kw,err", [
    ("float8_e4m3fn", {}, None),                     # ported: runs
    ("fp8", dict(strategy="rowcol"), None),          # ported: runs
    ("int8", dict(strategy="rowcol"), None),         # ported: runs
    ("int8", {}, ValueError),                        # weighted: illegal
    ("int8", dict(strategy="rowcol", multifault=True), ValueError),
    ("float8_e4m3fn", dict(encode="mxu"), ValueError),  # 1-byte rows
    ("float16", {}, ValueError), ("bf16", {}, ValueError)])
def test_other_dtypes_raise(in_dtype, kw, err):
    if err is None and in_dtype != "int8":
        # fp8 is ported (the fp8 slice, tests/test_torch_ft_fp8.py): it
        # builds and corrects injected faults to the rounded oracle.
        fn = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype=in_dtype,
                           device="cpu", **kw)
        a, b, c = _inputs(128, 128, 256, seed=2)
        res = fn(a, b, c, InjectionSpec(enabled=True, every=1))
        assert fn.in_dtype == "float8_e4m3fn" and int(res.num_detected) == 2
        assert int(res.num_uncorrectable) == 0
        ok, nbad, _ = verify_matrix(sgemm_reference(
            a, b, c, ALPHA, BETA, in_dtype="fp8", device="cpu").numpy(),
            res.c.numpy(), verbose=False)
        assert ok, f"{nbad} elements off"
        return
    if err is None:
        # int8 rowcol is ported (the exact mode, tests/test_torch_ft_int8.py):
        # it builds and corrects an injected fault exactly.
        fn = make_ft_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype=in_dtype,
                           device="cpu", **kw)
        a, b, c = (np.round(x * 10) for x in _inputs(128, 128, 256, seed=2))
        res = fn(a, b, c, InjectionSpec(enabled=True, every=1))
        assert fn.in_dtype == "int8" and int(res.num_detected) == 2
        assert int(res.num_uncorrectable) == 0
        np.testing.assert_array_equal(res.c.numpy(), sgemm_reference(
            a, b, c, ALPHA, BETA, in_dtype="int8", device="cpu").numpy())
        return
    with pytest.raises(err):
        make_ft_sgemm("test", in_dtype=in_dtype, device="cpu", **kw)


@pytest.mark.parametrize("kind,multifault", [("precomp", False),
                                             ("running", False),
                                             ("rowcol", True),
                                             ("global", False)])
def test_bf16_plain_versions_are_the_f32_algorithm_on_rounded_values(
        kind, multifault):
    # On CPU tensors each wrapper takes its plain version; with bf16
    # operands that is the f32 tile algorithm on their values, bit for bit.
    shape = SHAPES["medium"]
    a, b, c = _inputs(96, 64, 80, seed=1)
    ab, bb = (pad_to(as_operand(x, torch.bfloat16, torch.device("cpu")), mm,
                     shape.bk) for x, mm in ((a, shape.bm), (b, shape.bn)))
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
    if kind == "precomp":
        # B2's expected moments: three bf16 terms (bf16) or the f32 moment
        # rows (f32) of the same values, equal to an f32 rounding.
        np.testing.assert_allclose(out.numpy(), out32.numpy(), rtol=1e-6,
                                   atol=1e-4)
    else:
        assert torch.equal(out, out32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind,multifault", [("precomp", False),
                                             ("running", False),
                                             ("rowcol", False),
                                             ("rowcol", True),
                                             ("global", False)])
def test_bf16_kernels_match_plain_on_card(cuda_device, name, kind,
                                          multifault):
    shape = SHAPES[name]
    a, b, c = _inputs(250, 250, 264, seed=8)
    ab, bb = (pad_to(as_operand(x, torch.bfloat16, cuda_device), mm,
                     shape.bk) for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(cuda_device), shape.bm, shape.bn)
    sc = scalar_operand(InjectionSpec(enabled=True, every=3), (9500.0,) * 3)
    extra = ft.kernel_inputs(kind, ab, bb, shape)
    got = ft.run_kernel(kind, shape, ab, bb, cp, extra, ALPHA, BETA, sc, 3,
                        multifault)
    want = ft.run_kernel(kind, shape, ab, bb, cp, extra, ALPHA, BETA, sc, 3,
                         multifault, plain=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    ok_tiles = (want[2] == 0).repeat_interleave(shape.bm, 0).repeat_interleave(
        shape.bn, 1) if kind != "global" else torch.ones_like(cp, dtype=bool)
    assert verify_matrix(want[0][ok_tiles].cpu().numpy(),
                         got[0][ok_tiles].cpu().numpy(), verbose=False)[0]

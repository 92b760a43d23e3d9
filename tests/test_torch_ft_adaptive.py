"""``make_ft_sgemm(threshold="auto" | "adaptive")`` of the port against the
JAX package, and the adaptive builds of B3-B8 on the card.

(a) At the JAX package's 128x128x128 tile (``SHAPES["test"]``) the port's
plain versions (``device="cpu"``) and the JAX package in interpret mode run
the same numpy inputs under every (strategy, encode) pair: the
``detections`` and ``uncorrectable`` grids must be EQUAL, and C must pass
``verify_matrix`` (0.01 absolute AND relative) against the JAX package's C
on every tile it reports correctable, and against the oracle where the
mirrored test asks for it. The cases mirror
tests/test_ft_sgemm.py:640-682 (auto: magnitude-5 faults caught where 9500
misses them, clean runs flag nothing), tests/test_encode_mxu.py:220 (auto
under the mxu encode) and tests/test_low_precision.py:168-225 (adaptive:
dense faults at every cadence, magnitude-5 faults under both encodes,
clean runs at three input scales). The program's own verification under
"adaptive" at 1024 gives the same verdict in both packages: rowcol fails.
(b) At a paper tile the JAX package cannot run, operands whose row and
column bands differ in scale by up to 1e4 give every tile its own adaptive
threshold: faults of magnitude 1 are caught exactly where the host twin
(``analysis.adaptive_threshold_estimate`` on the padded operands) puts the
tile's threshold under them, and a partial row band with zero padding rows
(M not a multiple of 128) is caught only because its padded rows count.
(c) The card tests (marker ``cuda``) hold each adaptive build against its
plain version: every tile, ragged sizes, checks inside a stage, and case
(b).
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, analysis, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import DEFAULT_THRESHOLD_MARGIN, pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
ALPHA, BETA = 1.0, -1.5
PAIRS = [("weighted", "vpu"), ("rowcol", "vpu"), ("global", "vpu"),
         ("fused", "vpu"), ("weighted", "mxu"), ("rowcol", "mxu"),
         ("global", "mxu")]
PAIR_IDS = [f"{s}-{e}" for s, e in PAIRS]
TINY = dict(enabled=True, every=1, magnitude=5.0)
DENSE = dict(enabled=True, every=1, magnitude=10000.0)


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


def _both(a, b, c, strategy, encode, threshold, inj_kw, check_every=None,
          alpha=ALPHA, beta=BETA):
    jres = jft.make_ft_sgemm(JTILE, alpha=alpha, beta=beta, strategy=strategy,
                             encode=encode, threshold=threshold,
                             check_every=check_every)(
        a, b, c, JInjectionSpec(**(inj_kw or {})))
    fn = make_ft_sgemm(SHAPES["test"], alpha=alpha, beta=beta,
                       strategy=strategy, encode=encode, threshold=threshold,
                       check_every=check_every, device="cpu")
    res = fn(a, b, c, InjectionSpec(**(inj_kw or {})))
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    ok = np.repeat(np.repeat(junc == 0, 128, 0), 128, 1)[:c.shape[0], :c.shape[1]]
    if strategy == "global":
        ok[:] = True   # detect only: both keep the same faults
    got = res.c.numpy()
    assert verify_matrix(np.asarray(jres.c)[ok], got[ok], verbose=False)[0]
    return res, got, int(jdet.sum()), int(junc.sum())


@pytest.mark.parametrize("strategy,encode", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("threshold", ["auto", "adaptive"])
def test_tiny_faults_caught_like_jax(strategy, encode, threshold):
    """Faults of magnitude 5 sit five orders of magnitude under 9500: the
    static threshold misses them and C keeps them; both modes detect all
    four and the correcting strategies correct them."""
    a, b, c = _inputs(128, 128, 512, seed=17)
    want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA))
    static = make_ft_sgemm(SHAPES["test"], strategy=strategy, encode=encode,
                           device="cpu")(a, b, c, InjectionSpec(**TINY))
    assert int(static.num_detected) == 0
    assert not verify_matrix(want, static.c.numpy(), verbose=False)[0]
    res, got, det, unc = _both(a, b, c, strategy, encode, threshold, TINY)
    assert det == 4   # nk = 4, a fault every step
    if strategy == "global":
        assert unc == det
    else:
        assert unc == 0
        assert verify_matrix(want, got, verbose=False)[0]


@pytest.mark.parametrize("strategy,encode", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("threshold", ["auto", "adaptive"])
def test_clean_runs_flag_nothing_like_jax(strategy, encode, threshold):
    for seed in (1, 2):
        a, b, c = _inputs(256, 128, 512, seed=seed)
        _, got, det, unc = _both(a, b, c, strategy, encode, threshold, None)
        assert det == 0 and unc == 0
        want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA))
        assert verify_matrix(want, got, verbose=False)[0]


@pytest.mark.parametrize("strategy,encode", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("check_every", [1, 2, 4])   # 4 == nk at K = 512
def test_adaptive_cadence_sweep_like_jax(strategy, encode, check_every):
    """Dense faults of 1e4 under "adaptive": the correcting strategies
    restore the oracle and report nothing uncorrectable; global counts one
    event per check interval."""
    a, b, c = _inputs(128, 128, 512, seed=7)
    _, got, det, unc = _both(a, b, c, strategy, encode, "adaptive", DENSE,
                             check_every)
    if strategy == "global":
        assert det == -(-4 // check_every) and unc == det
        return
    want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA))
    assert verify_matrix(want, got, verbose=False)[0]
    assert det == 4 and unc == 0


@pytest.mark.parametrize("strategy,encode", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("scale", [0.1, 1.0, 16.0])
def test_adaptive_clean_across_scales_like_jax(strategy, encode, scale):
    rng = np.random.default_rng(int(scale * 10))
    a = (rng.standard_normal((128, 256)) * scale).astype(np.float32)
    b = (rng.standard_normal((128, 256)) * scale).astype(np.float32)
    c = np.zeros((128, 128), np.float32)
    _, _, det, unc = _both(a, b, c, strategy, encode, "adaptive", None,
                           alpha=1.0, beta=0.0)
    assert det == 0 and unc == 0


PROGRAM_PAIRS = [("weighted", "vpu"), ("rowcol", "vpu"), ("global", "vpu"),
                 ("fused", "mxu"), ("rowcol", "mxu"), ("global", "mxu")]
# f32 in every pair (the cases keep their ids), bf16 and fp8 on the vpu
# encodes (the adaptive bf16 builds of B5, B3 and B4).
PROGRAM_CASES = ([(s, e, "float32") for s, e in PROGRAM_PAIRS]
                 + [(s, "vpu", d) for d in ("bfloat16", "float8_e4m3fn")
                    for s in ("weighted", "rowcol", "global")])


@pytest.mark.parametrize("strategy,encode,in_dtype", PROGRAM_CASES,
                         ids=[f"{s}-{e}" + ("" if d == "float32" else f"-{d}")
                              for s, e, d in PROGRAM_CASES])
def test_adaptive_program_verdicts_like_jax(strategy, encode, in_dtype):
    """The program's own verification under "adaptive" (the reference
    driver's inputs at 1024, reference-like faults of 1e4 at every step)
    at the JAX package's 128x128x128 tile, in f32, bf16 and fp8: both
    packages pass weighted, fused and global, with equal grids (512
    detected), and both fail rowcol under either encode, reporting
    uncorrectable tiles. There the rounding left by each correction is
    flagged as a new fault and cascades, differently for any two summation
    orders, so only the verdicts are compared."""
    from ft_sgemm_tpu_torch import runtime

    n = 1024
    a, b = runtime.generate_reference_driver_inputs(n)
    c = np.zeros((n, n), np.float32)
    want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA,
                                          in_dtype=in_dtype))
    inj = InjectionSpec.reference_like(n, SHAPES["test"].bk)
    kw = dict(enabled=True, every=inj.every, magnitude=inj.magnitude)
    jres = jft.make_ft_sgemm(JTILE, alpha=ALPHA, beta=BETA, strategy=strategy,
                             encode=encode, threshold="adaptive",
                             in_dtype=in_dtype)(a, b, c, JInjectionSpec(**kw))
    res = make_ft_sgemm(SHAPES["test"], alpha=ALPHA, beta=BETA,
                        strategy=strategy, encode=encode,
                        threshold="adaptive", in_dtype=in_dtype,
                        device="cpu")(a, b, c, InjectionSpec(**kw))
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


@pytest.mark.parametrize("threshold", ["auto", "adaptive"])
def test_names_and_modes_match_jax(threshold):
    for strategy, encode in PAIRS:
        fn = make_ft_sgemm("huge", strategy=strategy, encode=encode,
                           threshold=threshold, device="cpu")
        jfn = jft.make_ft_sgemm("huge", strategy=strategy, encode=encode,
                                threshold=threshold)
        assert fn.__name__ == jfn.__name__
        assert fn.threshold_mode == jfn.threshold_mode == threshold
    # Weighted runs B5 at every cadence under adaptive (B2 has no encode
    # pass for the statistics to ride), B2 otherwise at one final check.
    inj = InjectionSpec.reference_like(4096, SHAPES["huge"].bk)
    assert ft._plan("weighted", None, None, inj, 512, 128)[0] == "precomp"
    assert ft._plan("weighted", None, None, inj, 512, 128,
                    adaptive=True)[:2] == ("running", 512)
    with pytest.raises(ValueError, match="no adaptive build"):
        ft.run_kernel("precomp", SHAPES["huge"], None, None, None, None, 1.0,
                      0.0, None, 1, adaptive=True)


# (b) Per-sub-tile thresholds at a paper tile.
GRID_DIMS = (200, 136, 256)   # M, N not multiples of 128 (nor of 16)


def _banded_inputs(shape):
    """A and B whose row bands (A) and column bands (B) carry scales 1e-2,
    1 and 1e2 in turn, so that the tiles' thresholds span 1e-4..1e4 times
    one another; the partial row band is scaled so that its tiles of unit
    B scale sit between the threshold its padded rows give and the one its
    real rows alone would give."""
    rng = np.random.default_rng(31)
    m, n, k = GRID_DIMS
    a = generate_random_matrix(m, k, rng=rng)
    b = generate_random_matrix(n, k, rng=rng)
    scales = np.array([1e-2, 1.0, 1e2], np.float32)
    sa = scales[np.arange(-(-m // shape.bm)) % 3]
    sb = scales[np.arange(-(-n // shape.bn)) % 3]
    sb[1::3] = 1.0
    a *= np.repeat(sa, shape.bm)[:m, None]
    b *= np.repeat(sb, shape.bn)[:n, None]
    ap = pad_to(torch.from_numpy(a), shape.bm, shape.bk).numpy()
    bp = pad_to(torch.from_numpy(b), shape.bn, shape.bk).numpy()
    j, partial = 1, m // shape.bm   # a column band of unit scale
    thr_pad, _ = analysis.adaptive_threshold_estimate(
        ap, bp, bm=shape.bm, bn=shape.bn, tile=(partial, j))
    # 0.85 of the unit fault: caught with the bm counted rows, missed with
    # the 8 real ones (a threshold sqrt(bm / 8) higher).
    s = 0.85 / thr_pad
    rows = slice(partial * shape.bm, m)
    a[rows] *= s
    ap[rows] *= s
    return a, b, ap, bp


def _expected_grid(ap, bp, shape, magnitude, real_rows=None):
    gm, gn = ap.shape[0] // shape.bm, bp.shape[0] // shape.bn
    grid = np.zeros((gm, gn), bool)
    for i in range(gm):
        for j in range(gn):
            a_t = ap[i * shape.bm:(i + 1) * shape.bm]
            if real_rows is not None and i == gm - 1:
                a_t = a_t[:real_rows]
            thr, _ = analysis.adaptive_threshold_estimate(
                a_t, bp[j * shape.bn:(j + 1) * shape.bn], bm=shape.bm,
                bn=shape.bn)
            grid[i, j] = magnitude > thr
    return grid


@pytest.mark.parametrize("name", ["small", "medium"])
def test_adaptive_thresholds_per_sub_tile(name):
    shape = SHAPES[name]
    a, b, ap, bp = _banded_inputs(shape)
    m, n, k = GRID_DIMS
    c = np.zeros((m, n), np.float32)
    inj = InjectionSpec(enabled=True, every=k // shape.bk, magnitude=1.0)
    res = make_ft_sgemm(shape, alpha=1.0, beta=0.0, threshold="adaptive",
                        device="cpu")(a, b, c, inj)
    want = _expected_grid(ap, bp, shape, 1.0)
    np.testing.assert_array_equal(res.detections.numpy() > 0, want)
    assert 0 < want.sum() < want.size
    # The padded rows of the partial band (the last) decide some of its
    # tiles.
    real = _expected_grid(ap, bp, shape, 1.0, real_rows=m % shape.bm)
    assert (want[-1] & ~real[-1]).any()


# (c) The card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


KINDS = [("running", False), ("fused", False), ("rowcol", False),
         ("rowcol", True), ("rowcol_mxu", True), ("global", False),
         ("global_mxu", False)]


def _hold(kind, shape, a, b, c, sc, ce, mf, alpha=1.0, beta=-1.5,
          c_rtol=None):
    """The adaptive build against its plain version: grids equal; C by
    ``verify_matrix`` on the tiles reported correctable, or, with
    ``c_rtol``, each tile within ``c_rtol`` of that tile's largest
    magnitude (the 3xTF32 product against the FP32 one: operands scaled to
    1e2 put an absolute 0.01 inside their rounding) plus 64 eps times the
    fault magnitude (the rounding that correcting a fault leaves, eight
    times ``_correction_pads``' 8 eps: a tile of values ~1e-3 carries it
    from a corrected unit fault)."""
    extra = ft.kernel_inputs(kind, a, b, shape)
    got = ft.run_kernel(kind, shape, a, b, c, extra, alpha, beta, sc, ce, mf,
                        adaptive=True)
    want = ft.run_kernel(kind, shape, a, b, c, extra, alpha, beta, sc, ce, mf,
                         plain=True, adaptive=True)
    assert torch.equal(got[1], want[1]), (kind, got[1], want[1])
    assert torch.equal(got[2], want[2]), (kind, got[2], want[2])
    if c_rtol is not None:
        def tiles(x):
            return x.reshape(x.shape[0] // shape.bm, shape.bm,
                             x.shape[1] // shape.bn, shape.bn).abs().amax((1, 3))
        err, scale = tiles(got[0] - want[0]), tiles(want[0])
        floor = 64 * float(np.finfo(np.float32).eps) * float(sc[2])
        assert bool((err <= c_rtol * scale + floor).all()), (err / scale).max()
        return got
    ok = (want[2] == 0).repeat_interleave(shape.bm, 0).repeat_interleave(
        shape.bn, 1)
    if kind.startswith("global"):
        ok[:] = True
    assert verify_matrix(want[0][ok].cpu().numpy(), got[0][ok].cpu().numpy(),
                         verbose=False)[0]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind,multifault", KINDS,
                         ids=[f"{k}-mf{int(m)}" for k, m in KINDS])
def test_adaptive_kernels_match_plain_on_card(cuda_device, name, kind,
                                              multifault):
    shape = SHAPES[name]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(250, 300, 520, seed=8),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    nk = a.shape[1] // shape.bk
    for inj in (InjectionSpec.none(),
                InjectionSpec(enabled=True, every=2, magnitude=5.0)):
        sc = scalar_operand(inj, (0.0,) * 3, DEFAULT_THRESHOLD_MARGIN)
        for ce in sorted({1, min(3, nk), nk}):   # 3: checks inside a stage
            _hold(kind, shape, a, b, c, sc, ce, multifault)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small", "medium"])
@pytest.mark.parametrize("kind,multifault", KINDS,
                         ids=[f"{k}-mf{int(m)}" for k, m in KINDS])
def test_adaptive_sub_tile_grids_on_card(cuda_device, name, kind, multifault):
    shape = SHAPES[name]
    a, b, _, _ = _banded_inputs(shape)
    m, n, k = GRID_DIMS
    c = np.zeros((m, n), np.float32)
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip((a, b, c), ((shape.bm, shape.bk),
                                              (shape.bn, shape.bk),
                                              (shape.bm, shape.bn))))
    inj = InjectionSpec(enabled=True, every=k // shape.bk, magnitude=1.0)
    sc = scalar_operand(inj, (0.0,) * 3, DEFAULT_THRESHOLD_MARGIN)
    _hold(kind, shape, a, b, c, sc, k // shape.bk, multifault, beta=0.0,
          c_rtol=1e-5)

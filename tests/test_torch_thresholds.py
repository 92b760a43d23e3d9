"""The threshold helpers of the port against the JAX package: the noise floor
behind ``threshold="auto"`` (``ops/common.estimate_noise_floor``, the torch
twin of ``estimate_noise_floor_jnp``), the variance bound behind
``threshold="adaptive"`` (``ops/common.variance_bound_threshold``), the
numpy host twins in ``ft_sgemm_tpu_torch/analysis.py``, the thresholds the
auto mode hands its kernels, the per-tile thresholds of the adaptive plain
versions, the scalar argument's slot 7 and the legality of the modes.

Inputs come from a seed with numpy. Tolerances: the torch and jnp floors
are f32 reductions in different orders, held to ``rtol=1e-5``; the two
numpy twins evaluate the same float64 formula, held to ``rtol=1e-12``.
"""

import numpy as np
import pytest
import torch

from ft_sgemm_tpu import analysis as janalysis
from ft_sgemm_tpu.ops import common as jcommon
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, analysis, configs, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import common
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft

F32_RTOL = 1e-5   # f32 reductions in two orders
F64_RTOL = 1e-12  # one float64 formula twice


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(kind, seed=22):
    rng = np.random.default_rng(seed)
    if kind == "reference":
        a, b, c = (generate_random_matrix(r, s, rng=rng)
                   for r, s in ((320, 256), (192, 256), (320, 192)))
    elif kind == "biased":
        a, b, c = (np.abs(rng.standard_normal(s)).astype(np.float32)
                   for s in ((256, 256), (128, 256), (256, 128)))
    else:  # "huge": squares and moment products past f32's range (the
        # sums stay inside it): the scale-safe rms, then a saturated bound
        big = np.float32(1e30)
        a, b, c = (big * rng.uniform(0.5, 1, s).astype(np.float32)
                   for s in ((64, 96), (80, 96), (64, 80)))
    return a, b, c


@pytest.mark.parametrize("kind", ["reference", "biased", "huge"])
@pytest.mark.parametrize("alpha,beta", [(1.0, -1.5), (2.0, -0.5), (1.0, 0.0)])
def test_noise_floor_matches_jax(kind, alpha, beta):
    a, b, c = _operands(kind)
    want = float(jcommon.estimate_noise_floor_jnp(a, b, c, alpha, beta))
    got = common.estimate_noise_floor(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(c), alpha, beta)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.isfinite(float(got))
    assert float(got) == pytest.approx(want, rel=F32_RTOL)
    if kind == "huge":   # saturated, finite, never inf
        assert float(got) == float(common.THRESHOLD_CAP)
    host = analysis.estimate_noise_floor(a, b, c, alpha=alpha, beta=beta)
    jhost = janalysis.estimate_noise_floor(a, b, c, alpha=alpha, beta=beta)
    assert host == pytest.approx(jhost, rel=F64_RTOL)


def test_noise_floor_needs_c_when_beta_is_nonzero():
    a, b, _ = (torch.from_numpy(x) for x in _operands("reference"))
    with pytest.raises(ValueError, match="beta"):
        common.estimate_noise_floor(a, b, None, 1.0, -1.5)
    with pytest.raises(ValueError, match="beta"):
        analysis.estimate_noise_floor(a.numpy(), b.numpy(), None, beta=-1.5)
    # beta = 0 needs no C, on both sides.
    assert float(common.estimate_noise_floor(a, b, None, 1.0, 0.0)) == \
        pytest.approx(float(jcommon.estimate_noise_floor_jnp(
            a.numpy(), b.numpy(), None, 1.0, 0.0)), rel=F32_RTOL)


# (s_a1, s_a2, s_b1, s_b2, n_a, n_b, t_ab, log2_t, margin): a tile of the
# reference's inputs, a biased one, and one that saturates.
BOUND_CASES = [
    (12.5, 5834.0, -3.25, 4671.0, 2048.0, 2048.0, 2048.0, 19.0, 8.0),
    (9800.0, 15000.0, 4100.0, 7000.0, 16384.0, 8192.0, 16384.0, 14.0, 4.0),
    (0.0, float(np.finfo(np.float32).max), 0.0,
     float(np.finfo(np.float32).max), 1.0, 1.0, 1e30, 100.0, 8.0),
]


@pytest.mark.parametrize("case", range(len(BOUND_CASES)))
@pytest.mark.parametrize("array", ["float", "numpy", "torch"])
def test_variance_bound_matches_jax(case, array):
    s_a1, s_a2, s_b1, s_b2, n_a, n_b, t_ab, log2_t, margin = BOUND_CASES[case]
    kw = dict(n_a=n_a, n_b=n_b, t_ab=t_ab, log2_t=log2_t, margin=margin)
    want = float(jcommon.variance_bound_threshold(
        s_a1, s_a2, s_b1, s_b2, xp=np, **kw))
    sums = (s_a1, s_a2, s_b1, s_b2)
    if array == "numpy":
        sums = tuple(np.asarray([x]) for x in sums)
    elif array == "torch":
        sums = tuple(torch.tensor([x], dtype=torch.float64) for x in sums)
    got = common.variance_bound_threshold(*sums, **kw)
    got = float(got[0]) if array != "float" else float(got)
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=F64_RTOL)


@pytest.mark.parametrize("tile", [None, (0, 0), (1, 2)])
def test_adaptive_estimate_matches_jax(tile):
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((256, 384)) * 3.0).astype(np.float32)
    b = (rng.standard_normal((384, 384)) * 0.5 + 0.1).astype(np.float32)
    got = analysis.adaptive_threshold_estimate(a, b, bm=128, bn=128,
                                               margin=6.0, tile=tile)
    want = janalysis.adaptive_threshold_estimate(a, b, bm=128, bn=128,
                                                 margin=6.0, tile=tile)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL)


@pytest.mark.parametrize("strategy,encode", [
    ("weighted", "vpu"), ("rowcol", "vpu"), ("global", "vpu"),
    ("fused", "mxu"), ("rowcol", "mxu"), ("global", "mxu")])
@pytest.mark.parametrize("beta", [-1.5, 0.0])
def test_auto_thresholds_match_jax(monkeypatch, strategy, encode, beta):
    """The slots 4-6 that threshold="auto" hands its kernel: margin times
    the floor of the pre-pad inputs (C only when beta is not 0), times
    sqrt(bn) for global, and the re-checks at bm / sqrt(3) and
    bm^2 / sqrt(5) times that (ops/ft_sgemm.py:1820-1834)."""
    a, b, c = _operands("reference", seed=3)
    seen = []
    real = ft.run_kernel

    def spy(kind, shape, *args, **kw):
        seen.append(args[6])   # the scalar argument
        return real(kind, shape, *args, **kw)

    monkeypatch.setattr(ft, "run_kernel", spy)
    shape = SHAPES["medium"]
    margin = 6.0
    fn = make_ft_sgemm(shape, beta=beta, strategy=strategy, encode=encode,
                       threshold="auto", threshold_margin=margin,
                       device="cpu")
    inj = InjectionSpec(enabled=True, every=3, magnitude=7.0)
    fn(a, b, c, inj)
    sc = seen[0]
    assert isinstance(sc, torch.Tensor) and tuple(sc.shape) == (8,)
    floor = float(jcommon.estimate_noise_floor_jnp(
        a, b, c if beta else None, 1.0, beta))
    thr = margin * floor * (np.sqrt(shape.bn) if strategy == "global" else 1.0)
    want = [thr, thr * shape.bm / np.sqrt(3.0), thr * shape.bm ** 2 / np.sqrt(5.0)]
    np.testing.assert_allclose(sc[4:7].numpy(), want, rtol=F32_RTOL)
    np.testing.assert_array_equal(sc[:4].numpy(), inj.as_operand())
    assert float(sc[7]) == 0.0


@pytest.mark.parametrize("name", ["small", "medium", "tall", "test"])
def test_adaptive_plain_thresholds_match_host_twin(name):
    """The adaptive plain versions' per-tile thresholds at the final check
    equal the host twin on each tile of the padded operands (the padded
    rows of a partial tile count, as they do in the kernels)."""
    shape = SHAPES[name]
    rng = np.random.default_rng(9)
    m, n, k = 200, 136, 256
    a = common.pad_to(torch.from_numpy(
        (rng.standard_normal((m, k)) * 2.0).astype(np.float32)),
        shape.bm, shape.bk)
    b = common.pad_to(torch.from_numpy(
        (rng.standard_normal((n, k)) + 0.3).astype(np.float32)),
        shape.bn, shape.bk)
    nk = a.shape[1] // shape.bk
    a4 = a.reshape(-1, shape.bm, nk, shape.bk)
    b4 = b.reshape(-1, shape.bn, nk, shape.bk)
    mom = None
    for step in range(nk):
        mom = ft._accumulate_moments(mom, a4[:, :, step], b4[:, :, step])
    got = ft._adaptive_threshold(mom, nk - 1, shape, nk, 8.0).numpy()
    for i in range(got.shape[0]):
        for j in range(got.shape[1]):
            want, _ = analysis.adaptive_threshold_estimate(
                a.numpy(), b.numpy(), bm=shape.bm, bn=shape.bn, margin=8.0,
                tile=(i, j))
            assert got[i, j] == pytest.approx(want, rel=F32_RTOL), (i, j)


@pytest.mark.parametrize("name,steps,global_tile", [
    ("small", None, False), ("tall", None, True), ("medium", 3, False),
    ("wide", 5, True)])
def test_adaptive_threshold_grid_matches_jax(name, steps, global_tile):
    """The grid twin at the final check equals the JAX host twin on every
    tile; at the check after ``steps`` bk steps it equals the JAX formula
    with that check's counts and the full run's log2 (ops/ft_sgemm.py:382-388
    of the JAX package), and the port's plain versions' thresholds."""
    shape = SHAPES[name]
    rng = np.random.default_rng(12)
    a = common.pad_to(torch.from_numpy(
        (rng.standard_normal((200, 256)) * 2.0).astype(np.float32)),
        shape.bm, shape.bk).numpy()
    b = common.pad_to(torch.from_numpy(
        (rng.standard_normal((136, 256)) + 0.3).astype(np.float32)),
        shape.bn, shape.bk).numpy()
    nk = a.shape[1] // shape.bk
    tk = a.shape[1] if steps is None else steps * shape.bk
    got = analysis.adaptive_threshold_grid(a, b, bm=shape.bm, bn=shape.bn,
                                           k_cols=tk, margin=6.0,
                                           global_tile=global_tile)
    scale = np.sqrt(shape.bn) if global_tile else 1.0
    tmax = float(max(shape.bm, shape.bn))
    for i in range(got.shape[0]):
        for j in range(got.shape[1]):
            at = a[i * shape.bm:(i + 1) * shape.bm, :tk].astype(np.float64)
            bt = b[j * shape.bn:(j + 1) * shape.bn, :tk].astype(np.float64)
            if steps is None:
                want, _ = janalysis.adaptive_threshold_estimate(
                    a, b, bm=shape.bm, bn=shape.bn, margin=6.0, tile=(i, j))
            else:
                want = jcommon.variance_bound_threshold(
                    at.sum(), np.square(at).sum(), bt.sum(),
                    np.square(bt).sum(), n_a=float(tk * shape.bm),
                    n_b=float(tk * shape.bn), t_ab=tk * tmax,
                    log2_t=float(np.log2(nk * shape.bk * tmax)), margin=6.0,
                    xp=np)
            assert got[i, j] == pytest.approx(want * scale, rel=F64_RTOL)
    a4 = torch.from_numpy(a).reshape(-1, shape.bm, nk, shape.bk)
    b4 = torch.from_numpy(b).reshape(-1, shape.bn, nk, shape.bk)
    mom = None
    for step in range(tk // shape.bk):
        mom = ft._accumulate_moments(mom, a4[:, :, step], b4[:, :, step])
    plain = ft._adaptive_threshold(mom, tk // shape.bk - 1, shape, nk, 6.0,
                                   global_tile=global_tile)
    np.testing.assert_allclose(plain.numpy(), got, rtol=F32_RTOL)


def test_scalar_operand_carries_the_margin():
    inj = InjectionSpec(enabled=True, every=2, magnitude=3.0, col_stride=5)
    sc = common.scalar_operand(inj, (1.0, 2.0, 3.0), 8.0)
    np.testing.assert_array_equal(sc, [1, 2, 3, 5, 1, 2, 3, 8])
    assert common.scalar_operand(inj, (1.0,) * 3)[7] == 0.0


@pytest.mark.parametrize("mode", configs.THRESHOLD_MODES)
def test_legality_of_threshold_modes(mode):
    for strategy in configs.STRATEGIES:
        for encode in configs.ENCODE_MODES:
            configs.check_kernel_legality(strategy=strategy, encode=encode,
                                          threshold_mode=mode)
    # bf16 and fp8 run every mode on the vpu encodes ("adaptive" on the
    # adaptive bf16 builds of B3-B5).
    for dtype in ("bfloat16", "float8_e4m3fn"):
        assert configs.check_kernel_legality(
            strategy="rowcol", encode="vpu", in_dtype=dtype,
            threshold_mode=mode) == dtype
    with pytest.raises(ValueError):
        configs.check_kernel_legality(strategy="rowcol", encode="vpu",
                                      threshold_mode=mode + "-ish")

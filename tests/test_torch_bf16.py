"""The bf16 input mode's helpers and plain path (kernel B1) in the port,
against the JAX package on the same numpy inputs.

Held: the dtype spellings, the per-dtype legality tables and
``resolve_in_dtype`` (``ft_sgemm_tpu/configs.py``, ``ops/common.py``);
``_tile_moments``' bf16 hi / lo / lo2 rows bit for bit and
``_expected_col_checksums`` in bf16 (``ops/ft_sgemm.py:1167-1256``); the
bf16 oracle (the f32 product of the bf16-rounded operands,
``ops/reference.py``); ``make_sgemm(in_dtype="bfloat16")`` and the two-pass
baseline in bf16, the port's plain versions (``device="cpu"``) against the
JAX package's (Pallas in interpret mode); and the cases of
``tests/test_mixed_precision.py`` that concern the plain kernels. The card
test (marker ``cuda``) holds B1's bf16 build against its plain version.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu import configs as jconfigs
from ft_sgemm_tpu.ops import common as jcommon
from ft_sgemm_tpu.ops import ft_sgemm as jft_ops
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, abft_baseline_sgemm, configs, make_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import common
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import sgemm as sg
from ft_sgemm_tpu_torch.ops.common import pad_to
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

ALPHA, BETA = 1.0, -1.5
SPELLINGS = ["float32", "bfloat16", "float8_e4m3fn", "int8", "fp8",
             "fp8_e4m3", "float8_e4m3", np.float32, np.int8, "float16",
             "float64", "bf16", "fp32"]


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


def _bf16(x):
    """The bf16 rounding of an f32 array, as f32 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float()


@pytest.mark.parametrize("spelling", SPELLINGS, ids=str)
def test_canonical_in_dtype_matches_jax(spelling):
    try:
        want = jconfigs.canonical_in_dtype(spelling)
    except ValueError:
        with pytest.raises(ValueError, match="in_dtype"):
            configs.canonical_in_dtype(spelling)
        return
    assert configs.canonical_in_dtype(spelling) == want


def test_canonical_in_dtype_takes_torch_dtypes():
    assert configs.canonical_in_dtype(torch.bfloat16) == "bfloat16"
    assert configs.canonical_in_dtype(torch.float32) == "float32"
    with pytest.raises(ValueError, match="in_dtype"):
        configs.canonical_in_dtype(torch.float16)


@pytest.mark.parametrize("table", ["IN_DTYPES", "STRATEGY_LEGALITY",
                                   "ENCODE_LEGALITY", "DEFAULT_STRATEGY",
                                   "_IN_DTYPE_ALIASES"])
def test_legality_tables_equal_jax(table):
    assert getattr(configs, table) == getattr(jconfigs, table)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16", "float8_e4m3fn",
                                      "int8", "fp8"])
@pytest.mark.parametrize("allow", [False, True])
def test_resolve_in_dtype_matches_jax(in_dtype, allow):
    try:
        jdt, _ = jcommon.resolve_in_dtype(in_dtype, "highest",
                                          allow_low_precision=allow)
    except ValueError:
        with pytest.raises(ValueError):
            common.resolve_in_dtype(in_dtype, allow_low_precision=allow)
        return
    dt = common.resolve_in_dtype(in_dtype, allow_low_precision=allow)
    assert isinstance(dt, torch.dtype)
    assert str(dt).removeprefix("torch.") == jdt.name


def test_resolve_in_dtype_precision():
    # make_sgemm takes the JAX package's precision names: bf16 is one pass
    # whatever the caller asks, f32 "high" is "highest" (3xTF32), f32
    # "default" is one TF32 pass (the operands rounded to TF32, products
    # exact in f32), and an unknown name is refused.
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal((16, 16)).astype(np.float32)
               for _ in range(3))
    outs = [make_sgemm("test", in_dtype="bfloat16", precision=p,
                       device="cpu")(a, b, c) for p in common.PRECISIONS]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    f32 = {p: make_sgemm("test", precision=p, device="cpu")(a, b, c)
           for p in common.PRECISIONS}
    assert torch.equal(f32["high"], f32["highest"])
    a32, b32 = (common.tf32_rna(torch.from_numpy(x)) for x in (a, b))
    torch.testing.assert_close(f32["default"], a32 @ b32.T - 1.5 * torch.from_numpy(c),
                               rtol=0, atol=1e-5)
    assert not torch.equal(f32["default"], f32["highest"])
    with pytest.raises(ValueError, match="precision"):
        make_sgemm("test", in_dtype="bfloat16", precision="fastest",
                   device="cpu")


def test_as_operand_rounds_like_jax():
    import jax.numpy as jnp

    a, _, _ = _inputs(64, 8, 96, seed=1)
    a[0, :4] = [1.00390625, 1.01171875, -3.0e-39, 65504.5]  # ties, subnormal
    got = common.as_operand(a, torch.bfloat16, torch.device("cpu"))
    want = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


# (bm, moments) whose f32 moment sums are exact on these inputs (bf16
# values are multiples of 2^-11 under 1, so sums under 2^13 fit f32's 24
# bits whatever the summation order): there the hi / lo / lo2 rows must be
# the JAX package's bit for bit.
EXACT = [(16, 3), (32, 3), (128, 2), (32, 1)]


@pytest.mark.parametrize("bm,n_moments", EXACT + [(128, 3)])
def test_tile_moments_bf16_match_jax_bit_for_bit(bm, n_moments):
    import jax.numpy as jnp

    a, _, _ = _inputs(256, 8, 160, seed=2)
    want = np.asarray(jft_ops._tile_moments(jnp.asarray(a, jnp.bfloat16), bm,
                                            n_moments)).astype(np.float32)
    got = ft._tile_moments(torch.from_numpy(a).to(torch.bfloat16), bm,
                           n_moments)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (256 // bm, 3 * n_moments, 160)
    got = got.float().numpy()
    if (bm, n_moments) in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        # The w^2 sums of 128 rows reach ~1.4e5 and round in f32, in another
        # order than XLA's: the terms' sums (in float64) then agree to the
        # f32 accumulation noise of those partial sums, a few ulps of the
        # moment's largest magnitude (2^-20 of it).
        r = n_moments
        g64, w64 = got.astype(np.float64), want.astype(np.float64)
        gsum = g64[:, :r] + g64[:, r:2 * r] + g64[:, 2 * r:]
        wsum = w64[:, :r] + w64[:, r:2 * r] + w64[:, 2 * r:]
        scale = np.abs(wsum).max(axis=(0, 2), keepdims=True)
        assert (np.abs(gsum - wsum) <= 2.0 ** -20 * scale).all()
        exact = [r * term + m for term in range(3) for m in (0, 1)]
        np.testing.assert_array_equal(got[:, exact], want[:, exact])


def test_tile_moments_bf16_terms_sum_to_the_f32_moments():
    a, _, _ = _inputs(256, 8, 64, seed=3)
    rounded = _bf16(a)
    terms = ft._tile_moments(rounded.to(torch.bfloat16), 128).float()
    f32 = ft._tile_moments(rounded, 128)
    summed = terms[:, 0:3] + terms[:, 3:6] + terms[:, 6:9]
    # three bf16 terms carry 24 bits: the f32 moment to half an ulp.
    np.testing.assert_allclose(summed.numpy(), f32.numpy(), rtol=2 ** -23,
                               atol=0)


@pytest.mark.parametrize("bm", [128, 16])
def test_expected_col_checksums_bf16_match_jax(bm):
    import jax.numpy as jnp

    a, b, _ = _inputs(256, 128, 256, seed=4)
    jexp = jft_ops._expected_col_checksums(jnp.asarray(a, jnp.bfloat16),
                                           jnp.asarray(b, jnp.bfloat16), bm,
                                           "default")
    gm = 256 // bm
    want = np.asarray(jexp).reshape(gm, 8, 128)[:, :3]
    got = ft._expected_col_checksums(torch.from_numpy(a).to(torch.bfloat16),
                                     torch.from_numpy(b).to(torch.bfloat16),
                                     bm).numpy()
    # exact products, f32 accumulation-order noise over K = 256: ~1e-6 of
    # each moment's scale.
    for v in range(3):
        scale = np.abs(want[:, v]).max()
        assert np.abs(got[:, v] - want[:, v]).max() <= 1e-5 * scale


def test_bf16_oracle_matches_jax():
    a, b, c = _inputs(192, 160, 320, seed=5)
    want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA,
                                          in_dtype="bfloat16"))
    got = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="bfloat16",
                          device="cpu").numpy()
    # exact products of the rounded operands, f32 accumulation-order noise.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # int8 (ported since the int8 slice, tests/test_torch_int8.py): A and B
    # truncated to int8, the product exact in int32, widened for the
    # epilogue; the same numbers as the JAX oracle.
    a8, b8 = np.round(a * 10), np.round(b * 10)
    np.testing.assert_array_equal(
        sgemm_reference(a8, b8, c, ALPHA, BETA, in_dtype="int8",
                        device="cpu").numpy(),
        np.asarray(jft.sgemm_reference(a8, b8, c, ALPHA, BETA,
                                       in_dtype="int8")))


@pytest.mark.parametrize("dims", [(256, 256, 512), (200, 136, 300)])
def test_bf16_plain_matches_jax(dims):
    a, b, c = _inputs(*dims, seed=6)
    jshape = jconfigs.KernelShape("t128", 128, 128, 128, (0,) * 7)
    want = np.asarray(jft.make_sgemm(jshape, alpha=ALPHA, beta=BETA,
                                     in_dtype="bfloat16")(a, b, c))
    got = make_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="bfloat16",
                     device="cpu")(a, b, c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _rounded_oracle(a, b, c):
    return (ALPHA * (_bf16(a) @ _bf16(b).T) + BETA * torch.from_numpy(c)
            ).numpy()


def test_bf16_plain_matches_rounded_oracle():
    # tests/test_mixed_precision.py:42-47 on the port.
    a, b, c = _inputs(256, 256, 512, seed=10)
    fn = make_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="bfloat16",
                    device="cpu")
    np.testing.assert_allclose(fn(a, b, c).numpy(), _rounded_oracle(a, b, c),
                               rtol=1e-5, atol=1e-4)


def test_bf16_plain_close_to_f32_reference():
    # tests/test_mixed_precision.py:50-61: input rounding dominates the gap
    # (~0.06 max-abs at K = 512); bf16 accumulation would be ~100x worse.
    a, b, c = _inputs(256, 256, 512, seed=3)
    fn = make_sgemm("test", alpha=ALPHA, beta=BETA, in_dtype="bfloat16",
                    device="cpu")
    want = sgemm_reference(a, b, c, ALPHA, BETA, device="cpu").numpy()
    ok, nbad, _ = verify_matrix(want, fn(a, b, c).numpy(), verbose=False,
                                abs_tol=0.1, rel_tol=0.02)
    assert ok, f"{nbad} elements outside the bf16 tolerance"


@pytest.mark.parametrize("shape", ["test", "huge", "small", "wide"])
def test_kernel_names_carry_dtype(shape):
    # tests/test_mixed_precision.py:116-118, and the JAX package's names.
    jshape = jconfigs.SHAPES[shape]
    fn = make_sgemm(shape, in_dtype="bfloat16", device="cpu")
    assert fn.__name__ == jft.make_sgemm(jshape, in_dtype="bfloat16").__name__
    assert fn.__name__.endswith("bfloat16") and fn.in_dtype == "bfloat16"
    assert make_sgemm(shape, device="cpu").__name__ == f"sgemm_{shape}"
    # The port keeps the paper's tile in bf16 (BF16_TILE_OVERRIDES is TPU
    # tuning).
    assert fn.shape_config == SHAPES[shape]


@pytest.mark.parametrize("in_dtype", ["float8_e4m3fn", "int8", "float16"])
def test_plain_sgemm_refuses_what_is_not_ported(in_dtype):
    # fp8 is ported since the fp8 slice (tests/test_torch_fp8.py): it builds
    # and gives the rounded oracle; int8 needs the FT kernels' exact path
    # and float16 is no dtype of the family, as in the JAX package.
    if in_dtype == "float8_e4m3fn":
        fn = make_sgemm("test", in_dtype=in_dtype, device="cpu")
        a, b, c = _inputs(64, 48, 96, seed=9)
        np.testing.assert_allclose(
            fn(a, b, c).numpy(), sgemm_reference(
                a, b, c, ALPHA, BETA, in_dtype=in_dtype, device="cpu").numpy(),
            rtol=1e-5, atol=1e-4)
        return
    with pytest.raises(ValueError):
        make_sgemm("test", in_dtype=in_dtype, device="cpu")


def test_sgemm_kernel_cpu_takes_the_plain_version():
    shape = SHAPES["medium"]
    a, b, c = _inputs(64, 96, 40, seed=7)
    ab, bb = (pad_to(torch.from_numpy(x).to(torch.bfloat16), m, shape.bk)
              for x, m in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c), shape.bm, shape.bn)
    got = sg.sgemm_kernel(ab, bb, cp, shape, ALPHA, BETA)
    want = sg.sgemm_plain(ab.float(), bb.float(), cp, ALPHA, BETA)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(enabled=True, every=2)])
def test_abft_baseline_bf16_matches_jax(kw):
    from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec

    a, b, c = _inputs(192, 192, 600, seed=12)
    want = jft.abft_baseline_sgemm(a, b, c, ALPHA, BETA, in_dtype="bfloat16",
                                   inject=JInjectionSpec(**kw))
    got = abft_baseline_sgemm(a, b, c, ALPHA, BETA, in_dtype="bfloat16",
                              inject=InjectionSpec(**kw), device="cpu")
    np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c), rtol=1e-5,
                               atol=1e-4)
    # f32 residual noise, far below 9500; a fault shows as ~1e4 on both.
    for g, w in ((got.max_row_residual, want.max_row_residual),
                 (got.max_col_residual, want.max_col_residual)):
        assert abs(float(g) - float(w)) < 1e-2 + 1e-5 * abs(float(w))
    assert bool(got.detected) == bool(want.detected) == bool(kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_bf16_sgemm_kernel_matches_plain_on_card(cuda_device, name):
    shape = SHAPES[name]
    a, b, c = _inputs(250, 250, 264, seed=8)
    ab, bb = (pad_to(common.as_operand(x, torch.bfloat16, cuda_device), m,
                     shape.bk) for x, m in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(cuda_device), shape.bm, shape.bn)
    before = sg.sgemm_kernel.bf16_launches
    got = sg.sgemm_kernel(ab, bb, cp, shape, ALPHA, BETA)
    want = sg.sgemm_plain(ab, bb, cp, ALPHA, BETA)
    assert sg.sgemm_kernel.bf16_launches == before + 1
    assert verify_matrix(want.cpu().numpy(), got.cpu().numpy(),
                         verbose=False)[0]

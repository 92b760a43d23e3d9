"""The fp8 (float8_e4m3fn) input mode's helpers and plain path (kernel B1)
in the port, against the JAX package on the same numpy inputs.

Held: the port's e4m3 rounding (``ops/common.to_e4m3``), element by element
against ``jnp.asarray(x).astype(jnp.float8_e4m3fn)`` on a grid of
subnormals, ties, every finite e4m3 value and its neighbours, the overflow
midpoint 464, ±inf and NaN (torch's own cast saturates to ±448 where JAX
gives NaN); the fp8 oracle against ``ft_sgemm_tpu.ops.reference.
sgemm_reference(in_dtype="float8_e4m3fn")``; the legality of fp8 under
every (strategy, encode, threshold mode); the fp8 spellings;
``make_sgemm(in_dtype="fp8")``, the two-pass baseline and ``make_ft_sgemm``'s
prep in fp8 (the f32 moment rows and the noise floor of the rounded
inputs) against the JAX package (Pallas in interpret
mode), the port's plain versions running (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.ops import common as jcommon
from ft_sgemm_tpu.ops import ft_sgemm as jft_ops
from ft_sgemm_tpu.ops.reference import sgemm_reference as jsgemm_reference
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, abft_baseline_sgemm, configs, make_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import _build, common
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import sgemm as sg
from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, pad_to
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

ALPHA, BETA = 1.0, -1.5
F8 = torch.float8_e4m3fn
JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
CPU = torch.device("cpu")


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


def _jax_e4m3(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))


def _e4m3_values():
    """Every finite e4m3fn value, as f32 (codes 0x00-0x7e and their
    negatives; 0x7f and 0xff are NaN)."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    vals = codes.view(F8).float().numpy()
    return vals[np.isfinite(vals)]


def _grid():
    """Subnormals, ties and their neighbours: every finite e4m3 value, the
    midpoints between neighbours (ties, which round to even), one f32 ulp
    either side of each value and midpoint, around the top of the range
    448, 449, 463, 464 (the overflow midpoint, which rounds to 448), 464
    plus an ulp, 470, 480, 1e4, and below the smallest subnormal; ±0,
    ±inf and NaN."""
    v = np.unique(_e4m3_values())
    pos = v[v >= 0]
    mids = (pos[:-1] + pos[1:]) / 2
    base = np.concatenate([pos, mids, [448.0, 449.0, 463.0, 464.0, 470.0,
                                       480.0, 500.0, 1e4, 1e30, 2.0 ** -10,
                                       2.0 ** -11, 1e-30]]).astype(np.float32)
    near = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(0))])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([near, -near, special]).astype(np.float32)


def test_e4m3_rounding_matches_jax_element_by_element():
    x = _grid()
    got = common.to_e4m3(torch.from_numpy(x)).float().numpy()
    want = _jax_e4m3(x)
    np.testing.assert_array_equal(got, want)  # NaN where JAX has NaN
    assert np.isnan(got[np.abs(x) > 464.0]).all()
    # The cases the port's cast had wrong: torch saturates, JAX gives NaN.
    probe = np.array([449.0, 463.0, 464.0, 470.0, 500.0, 1e4, -1e4, np.inf],
                     np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(probe).to(F8).float().numpy(),
        [448.0, 448.0, 448.0, 448.0, 448.0, 448.0, -448.0, 448.0])
    np.testing.assert_array_equal(
        common.to_e4m3(torch.from_numpy(probe)).float().numpy(),
        _jax_e4m3(probe))


@pytest.mark.parametrize("spelling", ["float8_e4m3fn", "fp8", "fp8_e4m3",
                                      "float8_e4m3"])
def test_as_operand_rounds_fp8_as_jax_does(spelling):
    dt = common.resolve_in_dtype(spelling)
    assert dt == F8
    x = _grid()
    x = np.concatenate([x, np.random.default_rng(1).uniform(
        -500, 500, 8 * 200 - x.size % 8).astype(np.float32)]).reshape(-1, 8)
    op = as_operand(x, dt, CPU)
    assert op.dtype == F8 and op.is_contiguous() and op.data_ptr() % 16 == 0
    np.testing.assert_array_equal(op.float().numpy(), _jax_e4m3(x))
    # An fp8 tensor is taken as it is.
    assert torch.equal(as_operand(op, dt, CPU).view(torch.uint8),
                       op.view(torch.uint8))


def test_align_rows16_takes_fp8():
    x = common.to_e4m3(torch.arange(5 * 40, dtype=torch.float32)
                       .reshape(5, 40) / 8)
    y = align_rows16(x)
    assert y.dtype == F8 and y.stride() == (48, 1)
    assert torch.equal(y.float(), x.float())
    assert align_rows16(x[:, :32].contiguous()).stride() == (32, 1)


@pytest.mark.parametrize("shape,seed", [((64, 48, 80), 0), ((33, 17, 5), 1)])
def test_fp8_oracle_matches_jax(shape, seed):
    m, n, k = shape
    a, b, c = _inputs(m, n, k, seed)
    got = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="fp8", device="cpu")
    want = np.asarray(jsgemm_reference(a, b, c, ALPHA, BETA,
                                       in_dtype="float8_e4m3fn"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_fp8_oracle_overflow_is_nan_as_in_jax():
    # A row with a value past the overflow midpoint is NaN in the JAX
    # oracle's C; the port's, with torch's saturating cast, was finite.
    a, b, c = _inputs(16, 16, 32, seed=2)
    a[3, 5] = 470.0
    b[7, 1] = 463.0   # rounds to 448: finite
    got = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="fp8",
                          device="cpu").numpy()
    want = np.asarray(jsgemm_reference(a, b, c, ALPHA, BETA,
                                       in_dtype="float8_e4m3fn"))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]).all() and np.isfinite(np.delete(got, 3, 0)).all()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("strategy", configs.STRATEGIES)
@pytest.mark.parametrize("encode", configs.ENCODE_MODES)
@pytest.mark.parametrize("mode", configs.THRESHOLD_MODES)
def test_fp8_legality(strategy, encode, mode):
    # ValueError where the JAX tables refuse (checksum rows in a 1-byte
    # dtype: encode="mxu", strategy="fused"), the canonical name otherwise,
    # in every threshold mode ("adaptive" since the adaptive bf16 builds).
    kw = dict(strategy=strategy, encode=encode, in_dtype="fp8",
              threshold_mode=mode)
    if encode == "mxu" or strategy == "fused":
        with pytest.raises(ValueError):
            configs.check_kernel_legality(**kw)
    else:
        assert configs.check_kernel_legality(**kw) == "float8_e4m3fn"
    assert configs.DEFAULT_STRATEGY["float8_e4m3fn"] == "weighted"


@pytest.mark.parametrize("spelling", ["float8_e4m3fn", "fp8", "fp8_e4m3",
                                      "float8_e4m3"])
@pytest.mark.parametrize("shape", ["test", "medium"])
def test_make_sgemm_fp8_matches_jax(spelling, shape):
    jshape = JTILE if shape == "test" else jft.SHAPES["small"]
    a, b, c = _inputs(160, 96, 200, seed=3)
    fn = make_sgemm(shape, alpha=ALPHA, beta=BETA, in_dtype=spelling,
                    device="cpu")
    assert fn.in_dtype == "float8_e4m3fn"
    assert fn.__name__ == f"sgemm_{shape}_float8_e4m3fn"
    want = np.asarray(jft.make_sgemm(jshape, alpha=ALPHA, beta=BETA,
                                     in_dtype=spelling)(a, b, c))
    np.testing.assert_allclose(fn(a, b, c).numpy(), want, rtol=1e-5,
                               atol=1e-4)


def test_sgemm_kernel_cpu_takes_the_plain_version():
    shape = SHAPES["wide"]
    a, b, c = _inputs(64, 256, 40, seed=7)
    ab, bb = (align_rows16(pad_to(as_operand(x, F8, CPU), mm, shape.bk))
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c), shape.bm, shape.bn)
    got = sg.sgemm_kernel(ab, bb, cp, shape, ALPHA, BETA)
    assert torch.equal(got, sg.sgemm_plain(ab.float(), bb.float(), cp, ALPHA,
                                           BETA))


def test_check_operands_takes_fp8_rows_16_bytes_apart():
    # The launch validation: fp8 A and B pass the dtype check (the CPU
    # tensors then fail the device check), and an fp8 operand whose rows
    # are not 16 bytes apart is refused like int8's.
    shape = SHAPES["medium"]
    a = torch.zeros((32, 40), dtype=F8)
    c = torch.zeros((32, 32))
    with pytest.raises(ValueError, match="CUDA device"):
        _build.check_operands(shape, a, a[:32], c)
    with pytest.raises(ValueError, match="both float8_e4m3fn"):
        _build.check_operands(shape, a, torch.zeros((32, 40)), c)
    assert _build.mainloop("sgemm", SHAPES["huge"], "float8_e4m3fn") == \
        "wgmma-e4m3"
    assert _build.mainloop("rowcol", SHAPES["small"], "float8_e4m3fn") == \
        "wgmma-bf16"
    fp8_libs = {n for n, (_, d) in _build.LIBRARIES.items()
                if "-DFTSG_FP8=1" in d}
    assert fp8_libs == {"sgemm_fp8"}


@pytest.mark.parametrize("kw", [dict(), dict(enabled=True, every=2)])
def test_abft_baseline_fp8_matches_jax(kw):
    a, b, c = _inputs(192, 192, 600, seed=12)
    want = jft.abft_baseline_sgemm(a, b, c, ALPHA, BETA,
                                   in_dtype="float8_e4m3fn",
                                   inject=JInjectionSpec(**kw))
    got = abft_baseline_sgemm(a, b, c, ALPHA, BETA, in_dtype="fp8",
                              inject=InjectionSpec(**kw), device="cpu")
    np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c), rtol=1e-5,
                               atol=1e-4)
    assert bool(got.detected) == bool(want.detected)
    for x, y in ((got.max_row_residual, want.max_row_residual),
                 (got.max_col_residual, want.max_col_residual)):
        if kw:
            np.testing.assert_allclose(float(x), float(y), rtol=1e-4)
        else:
            assert float(x) < 1e-2 and float(y) < 1e-2


@pytest.mark.parametrize("n_moments", [1, 2, 3])
def test_tile_moments_fp8_are_f32_as_in_jax(n_moments):
    a, _, _ = _inputs(256, 8, 96, seed=13)
    ap = as_operand(a, F8, CPU)
    rows = ft._tile_moments(ap, 128, n_moments)
    want = np.asarray(jft_ops._tile_moments(
        jnp.asarray(a).astype(jnp.float8_e4m3fn), 128, n_moments))
    assert rows.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("beta", [0.0, -1.5])
def test_noise_floor_of_fp8_inputs_matches_jax(beta):
    # threshold="auto" reads the rounded operands in both packages.
    a, b, c = _inputs(128, 96, 256, seed=15)
    ap, bp = (as_operand(x, F8, CPU) for x in (a, b))
    got = float(common.estimate_noise_floor(
        ap, bp, torch.from_numpy(c) if beta else None, ALPHA, beta))
    ja, jb = (jnp.asarray(x).astype(jnp.float8_e4m3fn) for x in (a, b))
    want = float(jcommon.estimate_noise_floor_jnp(
        ja, jb, jnp.asarray(c) if beta else None, ALPHA, beta))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_widening_to_bf16_holds_every_e4m3_value():
    # B2-B5 run their bf16 builds on fp8 operands that the wrapper widens
    # (ft_sgemm._launch): bf16 must hold each of the 256 e4m3 codes as JAX
    # decodes it, NaN for NaN, also from rows stored 16 bytes apart.
    bits = np.arange(256, dtype=np.uint8)
    want = bits.view(jnp.float8_e4m3fn).astype(np.float32)
    codes = align_rows16(torch.from_numpy(bits).view(F8).reshape(32, 8))
    assert codes.stride() == (16, 1)
    wide = codes.to(torch.bfloat16, memory_format=torch.contiguous_format)
    assert wide.is_contiguous()
    got = wide.float().flatten().numpy()
    nan = np.isnan(want)
    assert nan.sum() == 2
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])

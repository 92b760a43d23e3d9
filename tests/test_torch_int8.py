"""The int8 input mode's pieces outside the kernels, the port against the
JAX package: the exact int32 oracle (``ops/reference.sgemm_reference``
with ``in_dtype="int8"``; ft_sgemm_tpu/ops/reference.py:24-31), the int8
cast (truncation toward zero, as numpy's ``astype``), the 16-byte row
alignment of a 1-byte operand, the auto threshold's noise floor of int8
operands, the program's lattice quantization, and the legality and mainloop
tables. All on the CPU.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu import cli as jcli
from ft_sgemm_tpu.ops import common as jcommon
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, cli, configs
from ft_sgemm_tpu_torch.ops import _build
from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, estimate_noise_floor, pad_to
from ft_sgemm_tpu_torch.ops.reference import int8_matmul, sgemm_reference, wrap_int32

ALPHA, BETA = 1.0, -1.5
CPU = torch.device("cpu")


def _lattice(m, n, k, seed, scale=10.0):
    """The program's int8 inputs: the generator's values on the lattice
    ±{0..9} (scale 10), or wider with a larger scale."""
    rng = np.random.default_rng(seed)
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((m, k), (n, k), (m, n)))
    return np.round(a * scale), np.round(b * scale), c


@pytest.mark.parametrize("dims", [(192, 160, 320), (200, 136, 300),
                                  (17, 9, 5)])
@pytest.mark.parametrize("scale", [10.0, 127.0])
def test_int8_oracle_matches_jax(dims, scale):
    a, b, c = _lattice(*dims, seed=1, scale=scale)
    want = np.asarray(jft.sgemm_reference(a, b, c, ALPHA, BETA,
                                          in_dtype="int8"))
    got = sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="int8", device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_matmul_is_exact_and_wraps():
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (40, 24)).astype(np.int8)
    b = rng.integers(-128, 128, (33, 24)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)
    # int32 arithmetic: values reduce mod 2^32 into [-2^31, 2^31)
    x = torch.tensor([2 ** 31, -2 ** 31 - 1, 3 * 2 ** 32 + 5, -7, 2 ** 31 - 1])
    np.testing.assert_array_equal(
        wrap_int32(x).numpy(),
        x.numpy().astype(np.int64).astype(np.int32).astype(np.int64))


def test_int8_cast_truncates_like_numpy():
    x = np.array([[-9.9, -5.5, -0.7, 0.0, 0.7, 2.5, 9.9, 127.0, -128.0,
                   3.0, -3.0, 126.99, 0.49, -0.51, 8.5, -8.5]], np.float32)
    got = as_operand(x, torch.int8, CPU)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int8))
    assert as_operand(got, torch.int8, CPU) is got  # int8 taken as it is


@pytest.mark.parametrize("k", [16, 200, 8, 48, 40])
def test_align_rows16(k):
    x = torch.arange(5 * k, dtype=torch.int64).reshape(5, k).to(torch.int8)
    y = align_rows16(x)
    assert torch.equal(y, x)
    assert y.stride() == (k + (-k) % 16, 1)
    assert (y is x) == (k % 16 == 0)
    if k % 16:
        # the storage past column K is zero
        full = y.as_strided((5, k + (-k) % 16), y.stride())
        assert not full[:, k:].any()
    f = torch.zeros((3, 8))
    assert align_rows16(f) is f  # 4-byte rows are 16-byte aligned at K % 8 == 0


@pytest.mark.parametrize("alpha,beta", [(1.0, -1.5), (1.0, 0.0)])
def test_int8_noise_floor_matches_jax(alpha, beta):
    # threshold="auto" takes the int8 operands as their f32 values.
    a, b, c = _lattice(96, 80, 160, seed=4)
    a8, b8 = (x.astype(np.int8) for x in (a, b))
    want = float(jcommon.estimate_noise_floor_jnp(a8, b8, c, alpha, beta))
    got = estimate_noise_floor(torch.from_numpy(a8), torch.from_numpy(b8),
                               torch.from_numpy(c), alpha, beta)
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_program_quantization_matches_jax():
    x = generate_random_matrix(64, 48, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(cli.quantize_for_dtype(x, "int8"),
                                  jcli._quantize_for_dtype(x, "int8"))
    assert cli.quantize_for_dtype(x, "bfloat16") is x
    assert set(np.unique(cli.quantize_for_dtype(x, "int8"))) <= set(
        range(-9, 10))


@pytest.mark.parametrize("strategy", ["rowcol", "global"])
@pytest.mark.parametrize("mode", configs.THRESHOLD_MODES)
def test_int8_legality(strategy, mode):
    assert configs.check_kernel_legality(
        strategy=strategy, encode="vpu", in_dtype="int8",
        threshold_mode=mode) == "int8"
    for kw in (dict(strategy="weighted"), dict(strategy="fused"),
               dict(encode="mxu"), dict(multifault=True)):
        args = dict(strategy=strategy, encode="vpu", in_dtype="int8",
                    threshold_mode=mode)
        args.update(kw)
        with pytest.raises(ValueError):
            configs.check_kernel_legality(**args)


@pytest.mark.parametrize("name", list(SHAPES))
def test_int8_mainloop(name):
    shape = SHAPES[name]
    assert _build.mainloop("rowcol", shape, "int8") == "wgmma-s8"
    assert _build.mainloop("global", shape, "int8") == "wgmma-s8"
    assert _build.mainloop("rowcol", shape) == "wgmma-3xtf32"
    # the int8 operands the launches take: padded to the tile, rows 16
    # bytes apart
    a = align_rows16(pad_to(as_operand(np.ones((20, 20), np.float32),
                                       torch.int8, CPU), shape.bm, shape.bk))
    assert a.shape[1] % shape.bk == 0 and a.stride(0) % 16 == 0

"""The f32 precisions through the port's entry points, against the JAX
package on the CPU.

``precision="highest"`` and ``"high"`` run 3xTF32 on the card and FP32 in
the plain versions; ``"default"`` runs one TF32 pass, ``hi . hi`` with
``hi`` each operand rounded to TF32 as ``cvt.rna`` rounds it, for the
product and the expected sums that ride it (``ops/common.LaunchAxes``;
``ops/tf32x3`` models the kernels' one-product form). The JAX package on
the CPU computes its f32 products in FP32 at every precision, so the
port's "default" is held to it within TF32's rounding:

- a product of two TF32-rounded operands is off the FP32 product by at
  most ``2^-11 + 2^-11 + 2^-22 < 2^-10`` of ``|a b|``, so a plain GEMM
  element is within ``2^-10 (|A| |B|^T)`` of the JAX package's, plus f32
  summation noise (1e-5 here);
- an FT kernel is held to the JAX package run on the TF32-rounded
  operands (``common.tf32_rna``): its FP32 products of them are the
  one-pass products exactly, so outside the faults' elements C agrees to
  f32 summation noise (1e-4 here); at a fault's element, corrected from a
  checksum residual (an expected sum and a sum of the accumulator over a
  tile row or column of 128 elements, one of them holding the 1e4 fault),
  each side's f32 sums are off by at most ``128 * 2^-24`` of their
  absolute sums, so the two C's are held to four times that of
  ``1e4 + 128 max |C|``; and the ``detections`` and ``uncorrectable``
  grids (faults of 1e4 against the reference threshold 9500, the residual
  noise ~1e-2) must EQUAL the JAX package's.

``"high"`` equals ``"highest"`` bit for bit, and the factories take the
keyword as the JAX package's do.
"""

import inspect

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, ft_sgemm, make_ft_sgemm, make_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import common, tf32x3
from ft_sgemm_tpu_torch.ops.ft_sgemm import _inject_plain
from ft_sgemm_tpu_torch.ops.sgemm import sgemm_plain

JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
TILE = SHAPES["test"]
ALPHA, BETA = 1.0, -1.5
N = 256
TF32_PRODUCT = 2.0 ** -10  # a product of two TF32-rounded operands
PAIRS = [("weighted", "vpu"), ("rowcol", "vpu"), ("global", "vpu"),
         ("fused", "mxu"), ("rowcol", "mxu"), ("global", "mxu")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(k, seed, m=N, n=N):
    rng = np.random.default_rng(seed)
    return (generate_random_matrix(m, k, rng=rng),
            generate_random_matrix(n, k, rng=rng),
            generate_random_matrix(m, n, rng=rng))


def _abs_product(a, b):
    return np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64).T


@pytest.mark.parametrize("k", [128, 384])
def test_default_plain_sgemm_within_tf32_of_jax(k):
    a, b, c = _inputs(k, seed=k)
    jout = np.asarray(jft.make_sgemm(JTILE, precision="default",
                                     tunable=False)(a, b, c))
    out = make_sgemm(TILE, precision="default", device="cpu")(a, b, c).numpy()
    tol = TF32_PRODUCT * abs(ALPHA) * _abs_product(a, b) + 1e-5
    assert np.all(np.abs(out - jout) <= tol)
    # One pass, not FP32: the TF32 rounding shows.
    assert np.abs(out - jout).max() > 1e-4


def _fault_elements(inj, k, m=N, n=N, tile=128):
    """The (m, n) mask of the elements ``inj`` hits over a K sweep of ``k``
    (the plain versions' own ``_inject_plain`` on a zero accumulator)."""
    acc = torch.zeros(m // tile, n // tile, tile, tile)
    for step in range(-(-k // tile)):
        _inject_plain(acc, inj.as_operand(), step)
    return (acc != 0).permute(0, 2, 1, 3).reshape(m, n).numpy()


@pytest.mark.parametrize("strategy,encode", PAIRS)
def test_default_ft_within_tf32_of_jax(strategy, encode):
    k = 384
    a, b, c = _inputs(k, seed=7)
    ar, br = (common.tf32_rna(torch.from_numpy(x)).numpy() for x in (a, b))
    jres = jft.make_ft_sgemm(JTILE, strategy=strategy, encode=encode,
                             precision="default", tunable=False)(
        ar, br, c, JInjectionSpec.reference_like(k, 128))
    inj = InjectionSpec.reference_like(k, 128)
    res = make_ft_sgemm(TILE, strategy=strategy, encode=encode,
                        precision="default", device="cpu")(a, b, c, inj)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    assert int(res.num_detected) > 0
    faults = _fault_elements(inj, k)
    assert faults.sum() == int(res.num_detected)
    diff = np.abs(res.c.numpy() - np.asarray(jres.c))
    assert diff[~faults].max() <= 1e-4
    clean = np.abs(np.asarray(jres.c))[~faults].max()
    assert diff[faults].max() <= 4 * 128 * 2.0 ** -24 * (1e4 + 128 * clean)
    # One pass, not FP32: the TF32 rounding shows against the FP32 product
    # of the unrounded operands.
    full = jft.make_ft_sgemm(JTILE, strategy=strategy, encode=encode,
                             tunable=False)(a, b, c)
    assert np.abs(res.c.numpy() - np.asarray(full.c))[~faults].max() > 1e-4


@pytest.mark.parametrize("strategy,encode", PAIRS)
def test_high_equals_highest(strategy, encode):
    a, b, c = _inputs(256, seed=11)
    inj = InjectionSpec.reference_like(256, 128)
    high, highest = (make_ft_sgemm(TILE, strategy=strategy, encode=encode,
                                   precision=p, device="cpu")(a, b, c, inj)
                     for p in ("high", "highest"))
    for x, y in zip(high, highest):
        assert torch.equal(x, y)
    high, highest = (make_sgemm(TILE, precision=p, device="cpu")(a, b, c)
                     for p in ("high", "highest"))
    assert torch.equal(high, highest)


def test_precision_keyword_as_jax():
    # make_ft_sgemm and ft_sgemm take precision="highest" by default, as
    # the JAX factories do (ft_sgemm_tpu/ops/ft_sgemm.py:1513, 1924).
    for port, jax_fn in ((make_ft_sgemm, jft.make_ft_sgemm),
                         (ft_sgemm, jft.ft_sgemm)):
        assert (inspect.signature(port).parameters["precision"].default
                == inspect.signature(jax_fn).parameters["precision"].default
                == "highest")
    a, b, c = _inputs(128, seed=3)
    for p in common.PRECISIONS:
        res = ft_sgemm(a, b, c, TILE, precision=p, device="cpu")
        assert res.c.shape == (N, N)
    for fn in (lambda: make_ft_sgemm(TILE, precision="fastest", device="cpu"),
               lambda: make_sgemm(TILE, precision="fastest", device="cpu")):
        with pytest.raises(ValueError, match="precision"):
            fn()


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, True), (torch.bfloat16, False),
    (torch.float8_e4m3fn, False), (torch.int8, False)])
def test_one_pass_only_for_f32_default(dtype, want):
    assert common.check_precision("default", dtype) is want
    assert common.check_precision("high", dtype) is False
    assert common.check_precision("highest", dtype) is False


def test_one_product_model():
    # The CPU model of the kernels' one-product form (a_hi b_hi a k step,
    # stage sums promoted every 32 columns) against the plain version's
    # one-pass matmul: the same exact products summed in two orders.
    a, b, c = (torch.from_numpy(x) for x in _inputs(256, seed=5))
    model = tf32x3.sgemm_tf32x3(a, b, c, ALPHA, BETA, one_pass=True)
    plain = sgemm_plain(a, b, c, ALPHA, BETA,
                        axes=common.LaunchAxes(one_pass=True))
    torch.testing.assert_close(model, plain, rtol=0, atol=1e-4)
    three = tf32x3.sgemm_tf32x3(a, b, c, ALPHA, BETA)
    assert (model - three).abs().max() > 1e-4
    hi = common.tf32_rna(a)
    assert torch.equal(tf32x3.split(a)[0], hi)
    assert torch.equal(common.tf32_rna(hi), hi)


def test_baseline_default_runs_one_pass():
    from ft_sgemm_tpu_torch.ops.abft_baseline import abft_baseline_sgemm

    a, b, c = _inputs(256, seed=9)
    one = abft_baseline_sgemm(a, b, c, ALPHA, BETA, precision="default",
                              device="cpu")
    full = abft_baseline_sgemm(a, b, c, ALPHA, BETA, device="cpu")
    want = sgemm_plain(*(torch.from_numpy(x) for x in (a, b, c)), ALPHA, BETA,
                       axes=common.LaunchAxes(one_pass=True))
    torch.testing.assert_close(one.c, want, rtol=0, atol=1e-4)
    assert float(one.max_row_residual) > float(full.max_row_residual)

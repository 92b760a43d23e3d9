"""Kernel B1 (plain SGEMM) and the oracle: the port against the JAX package.

The same numpy inputs go through ``ft_sgemm_tpu.make_sgemm`` (Pallas in
interpret mode on the CPU) at the 128x128x128 ``test`` tile and through the
port's ``make_sgemm(device="cpu")`` (B1's plain version). Tolerance: the
reference's ``verify_matrix`` (0.01 absolute AND relative); inputs on the
±{0, .1, ..., .9} lattice times a power of two are exact in f32, so there
the two must agree to ``rtol=1e-5``. The card test (marker ``cuda``) holds
the CUDA kernel against the plain version; it skips without a GPU.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, make_sgemm, sgemm_reference
from ft_sgemm_tpu_torch.ops.reference import cpu_gemm
from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel, sgemm_plain
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

JTEST = JKernelShape("test", 128, 128, 128, (64, 64, 8, 16, 32, 4, 4))
CASES = [
    ((256, 256, 256), 1.0, -1.5),
    ((256, 128, 384), 1.0, -1.5),
    ((200, 136, 300), 1.0, -1.5),
    ((128, 256, 128), 2.0, 0.0),
    ((130, 70, 129), -0.5, 1.0),
]


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (generate_random_matrix(m, k, rng=rng),
            generate_random_matrix(n, k, rng=rng),
            generate_random_matrix(m, n, rng=rng))


@pytest.mark.parametrize("dims,alpha,beta", CASES)
def test_sgemm_matches_jax(dims, alpha, beta):
    a, b, c = _inputs(*dims, seed=sum(dims))
    want = np.asarray(jft.make_sgemm(JTEST, alpha=alpha, beta=beta)(a, b, c))
    got = make_sgemm(SHAPES["test"], alpha=alpha, beta=beta,
                     device="cpu")(a, b, c)
    assert tuple(got.shape) == want.shape
    ok, nbad, first = verify_matrix(want, got.numpy(), verbose=False)
    assert ok, f"{nbad} elements off, first at {first}"


def test_sgemm_exact_inputs_agree_to_f32_rounding():
    # Entries k/8 with small k: every product and partial sum is exact in f32.
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(-8, 9, size=s).astype(np.float32) / 8
               for s in ((200, 136), (136, 136), (200, 136)))
    want = np.asarray(jft.make_sgemm(JTEST)(a, b, c))
    got = make_sgemm(SHAPES["test"], device="cpu")(a, b, c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["small", "huge", "tall", "wide"])
def test_named_tiles_match_oracle(name):
    a, b, c = _inputs(100, 90, 70, seed=3)
    want = np.asarray(jft.sgemm_reference(a, b, c))
    got = make_sgemm(name, device="cpu")(a, b, c).numpy()
    assert verify_matrix(want, got, verbose=False)[0]


def test_caller_c_is_not_written():
    a, b, c = _inputs(64, 64, 64, seed=4)
    c0 = c.copy()
    ct = torch.from_numpy(c)
    make_sgemm("huge", device="cpu")(a, b, ct)
    np.testing.assert_array_equal(ct.numpy(), c0)


def test_oracle_matches_jax_and_cpu_gemm():
    a, b, c = _inputs(96, 80, 112, seed=5)
    want = np.asarray(jft.sgemm_reference(a, b, c, 1.0, -1.5))
    got = sgemm_reference(a, b, c, 1.0, -1.5, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cpu_gemm(1.0, -1.5, a, b.T, c), want,
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    shape = SHAPES[name]
    a, b, c = (torch.from_numpy(x).to(cuda_device)
               for x in _inputs(256, 256, 256, seed=6))
    got = sgemm_kernel(a, b, c, shape, 1.0, -1.5)
    want = sgemm_plain(a, b, c, 1.0, -1.5)
    assert verify_matrix(want.cpu().numpy(), got.cpu().numpy(),
                         verbose=False)[0]

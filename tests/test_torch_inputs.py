"""The port's inputs, tables and scalar ABI against the JAX package's.

Both packages get the same numpy inputs; the port runs on the CPU.
"""

import shutil

import numpy as np
import pytest
import torch

from ft_sgemm_tpu import configs as jconfigs
from ft_sgemm_tpu import contracts as jcontracts
from ft_sgemm_tpu import runtime as jruntime
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils import matrices as jmatrices
from ft_sgemm_tpu_torch import configs, contracts, interop, runtime
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import _build
from ft_sgemm_tpu_torch.utils import matrices

SPECS = [
    dict(),
    dict(enabled=True),
    dict(enabled=True, every=3, magnitude=123.5),
    dict(enabled=True, every=2, col_stride=0),
]


@pytest.mark.parametrize("shape", [(7, 5), (64, 64), (33, 130)])
def test_generate_random_matrix_bit_equal(shape):
    np.testing.assert_array_equal(matrices.generate_random_matrix(*shape),
                                  jmatrices.generate_random_matrix(*shape))
    np.testing.assert_array_equal(
        matrices.generate_random_matrix(*shape, rng=np.random.default_rng(4)),
        jmatrices.generate_random_matrix(*shape, rng=np.random.default_rng(4)))


def test_verify_matrix_same_verdicts():
    ref = np.linspace(-2.0, 2.0, 64, dtype=np.float32).reshape(8, 8)
    for out in (ref, ref + 0.005, ref * 1.02, ref + 0.5):
        assert (matrices.verify_matrix(ref, out, verbose=False)
                == jmatrices.verify_matrix(ref, out, verbose=False))


VERIFY_OUTS = {
    "equal": lambda r: r,
    "within": lambda r: r + 0.005,
    "relative": lambda r: r * 1.02,
    "off": lambda r: r + 0.5,
    "nan_inf": lambda r: np.where(np.arange(r.size).reshape(r.shape) % 7 == 0,
                                  np.float32(np.nan),
                                  np.where(r > 1.5, np.float32(np.inf), r)),
}


@pytest.mark.parametrize("case", sorted(VERIFY_OUTS))
def test_verify_matrix_tensors_same_verdicts(case):
    # Tensors are compared on their device, in float64: the same verdict,
    # count and first index as the host path and the JAX package's, with
    # zeros in ref (relative error inf) and NaN and inf in out.
    ref = np.linspace(-2.0, 2.0, 99, dtype=np.float32)
    ref = np.concatenate([ref, np.zeros(1, np.float32)]).reshape(10, 10)
    out = VERIFY_OUTS[case](ref).astype(np.float32)
    want = jmatrices.verify_matrix(ref, out, verbose=False)
    assert matrices.verify_matrix(torch.from_numpy(ref), torch.from_numpy(out),
                                  verbose=False) == want
    assert matrices.verify_matrix(ref, out, verbose=False) == want


@pytest.mark.parametrize("kw", SPECS)
def test_injection_operand_and_fault_count_equal(kw):
    spec, jspec = InjectionSpec(**kw), JInjectionSpec(**kw)
    np.testing.assert_array_equal(spec.as_operand(), jspec.as_operand())
    for k, bk in ((512, 128), (300, 128), (4096, 8), (6144, 16)):
        assert spec.expected_faults(k, bk) == jspec.expected_faults(k, bk)


@pytest.mark.parametrize("k,bk", [(512, 128), (4096, 8), (4096, 16), (6144, 8)])
def test_reference_like_equal(k, bk):
    assert (InjectionSpec.reference_like(k, bk).as_operand().tolist()
            == JInjectionSpec.reference_like(k, bk).as_operand().tolist())


def test_kernel_table_and_perf_rows_equal():
    assert sorted(configs.KERNEL_TABLE) == sorted(jconfigs.KERNEL_TABLE)
    assert configs.PERF_ROW_IDS == jconfigs.PERF_ROW_IDS
    for kid, (name, shape, is_abft) in configs.KERNEL_TABLE.items():
        jname, jshape, jabft = jconfigs.KERNEL_TABLE[kid]
        assert (shape, is_abft) == (jshape, jabft)
        assert name == (jname if kid else "cublas")


def test_scalar_slots_equal():
    assert contracts.SCALAR_SLOTS == jcontracts.SCALAR_SLOTS
    assert contracts.N_SCALAR_SLOTS == jcontracts.N_SCALAR_SLOTS


def test_tile_table_is_compiled_and_test_tile_matches():
    for shape in configs.SHAPES.values():
        tile = (shape.bm, shape.bn)
        # B1 and B2 on either CTA, B3-B8 on the sub-tiled one.
        assert tile in _build.wgmma_tiles() | _build.narrow_tiles()
        assert tile in _build.subtiles()
        assert _build.check_tile(shape) == tile
        assert shape.bk % 8 == 0
        if shape.name != "test":
            ms, ns, ks_ref = shape.ref_params[:3]
            assert (shape.bm, shape.bn, shape.bk) == (ms, ns, ks_ref)
            assert shape.ref_params == jconfigs.SHAPES[shape.name].ref_params
    assert configs.SHAPES["test"].block == jconfigs.SHAPES["test"].block


def test_kernel_shape_rejects_bad_layout():
    with pytest.raises(ValueError):
        configs.KernelShape("x", 128, 128, 12, (0,) * 7)
    with pytest.raises(ValueError):
        configs.KernelShape("x", 100, 128, 8, (0,) * 7)


def test_libc_driver_inputs_equal():
    if shutil.which("g++") is None:
        pytest.skip("the libc stream needs g++")
    a, b = runtime.generate_reference_driver_inputs(96)
    ja, jb = jruntime.generate_reference_driver_inputs(96)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    # The draw is made once; a caller that writes into its copy leaves the
    # next call's inputs as they were.
    a[:] = 0.0
    a2, b2 = runtime.generate_reference_driver_inputs(96)
    np.testing.assert_array_equal(a2, ja)
    np.testing.assert_array_equal(b2, jb)


@pytest.mark.parametrize("kw", SPECS)
def test_from_reference_carries_operands_and_scalars(kw):
    rng = np.random.default_rng(1)
    a, b, c = (jmatrices.generate_random_matrix(9, 7, rng=rng) for _ in range(3))
    jspec = JInjectionSpec(**kw)
    ops = interop.from_reference(a, b, c, jspec.as_operand(), 9500.0,
                                 device="cpu")
    np.testing.assert_array_equal(ops.a.numpy(), a)
    np.testing.assert_array_equal(ops.c.numpy(), c)
    np.testing.assert_array_equal(ops.inject.as_operand(), jspec.as_operand())
    assert ops.thresholds == (9500.0, 9500.0, 9500.0)

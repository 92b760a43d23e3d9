"""The fused epilogue's descriptors and arithmetic: the port against the JAX
package on the same inputs.

``configs.EpilogueSpec`` and ``KernelVariant`` (with ``canonical_variant``
and the axis tuples) must spell, parse and refuse exactly as
``ft_sgemm_tpu.configs`` does; ``ops/common.apply_epilogue`` and
``ops/reference.epilogue_reference`` must give the JAX package's
``apply_epilogue`` (jitted on the CPU, as a kernel body runs it in interpret
mode) and ``epilogue_reference`` (numpy with ml_dtypes) element by element
for bias, relu, qint8 and qfp8 — over .5 ties, ±127.5, ±inf, NaN, every
e4m3 value, the midpoints between them and 448-1e4 — and, for gelu, within
``GELU_TOLERANCE_ULPS`` (4) ulps of the GELU input's magnitude (the JAX
package's XLA tanh lies within 2 of torch's), a quantize after it between
the quantize of that interval's ends (``epilogue_violations``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ft_sgemm_tpu.configs as jcfg
from ft_sgemm_tpu.ops.common import apply_epilogue as japply
from ft_sgemm_tpu.ops.reference import epilogue_reference as jreference
from ft_sgemm_tpu_torch import configs as cfg
from ft_sgemm_tpu_torch.ops import common
from ft_sgemm_tpu_torch.ops.reference import (
    GELU_TOLERANCE_ULPS,
    epilogue_reference,
    epilogue_violations,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPELLINGS = [None, "", "none", " None ", "bias", "relu", "gelu", "Bias+ReLU",
             "bias+relu", "bias+gelu", "bias+gelu+qint8", "bias+gelu+qint8x0.25",
             "qint8x1", "qint8x2", "qfp8", "qfp8x0.5", "bias+relu+qfp8",
             "relu+gelu", "qfp8+qint8", "gelu+bias"]
BAD_SPELLINGS = ["bias+swish", "qint8xabc", "qint4", "qint8x-1", "qfp8x0",
                 "x", "bias++relu", " bias + relu", "none+bias", 3, 0.5]


def _parse(mod, spec):
    try:
        e = mod.EpilogueSpec.parse(spec)
    except ValueError as err:
        return ("ValueError", str(err))
    return (e.bias, e.activation, e.quantize, e.scale, e.spelling,
            e.is_identity)


@pytest.mark.parametrize("spec", SPELLINGS + BAD_SPELLINGS,
                         ids=lambda s: repr(s))
def test_epilogue_spec_parse_and_spelling_match_jax(spec):
    got, want = _parse(cfg, spec), _parse(jcfg, spec)
    assert got == want
    if got[0] != "ValueError":
        # The spelling round-trips through the parser, in both packages.
        assert _parse(cfg, got[4]) == got


@pytest.mark.parametrize("kwargs", [
    dict(), dict(bias=True), dict(activation="gelu", quantize="int8",
                                  scale=0.25),
    dict(activation="tanh"), dict(quantize="int4"), dict(scale=2.0),
    dict(quantize="float8_e4m3fn", scale=0.0),
    dict(quantize="float8_e4m3fn", scale=-1.0),
])
def test_epilogue_spec_construction_matches_jax(kwargs):
    def make(mod):
        try:
            e = mod.EpilogueSpec(**kwargs)
        except ValueError as err:
            return ("ValueError", str(err))
        return (e.spelling, e.is_identity)

    assert make(cfg) == make(jcfg)
    assert cfg.DEFAULT_EPILOGUE == cfg.EpilogueSpec()
    assert cfg.DEFAULT_EPILOGUE.spelling == jcfg.DEFAULT_EPILOGUE.spelling


def test_variant_axis_tuples_match_jax():
    for name in ("PIPELINE_DEPTHS", "GRID_ORDERS", "DIM_SEMANTICS",
                 "RING_OVERLAP_MODES", "EPILOGUE_ACTIVATIONS",
                 "EPILOGUE_QUANTIZE"):
        assert getattr(cfg, name) == getattr(jcfg, name), name


VARIANTS = [
    dict(), dict(epilogue="Bias+ReLU"), dict(epilogue="bias+gelu+qint8x0.25"),
    dict(check_every=4), dict(pipeline_depth=3), dict(grid_order="nm"),
    dict(dim_semantics="arbitrary"), dict(ring_overlap="overlap"),
    dict(pipeline_depth=4), dict(grid_order="km"), dict(dim_semantics="x"),
    dict(check_every=0), dict(check_every=2.0), dict(ring_overlap="ring"),
    dict(epilogue="bias+swish"),
]


def _variant(mod, kwargs):
    try:
        v = mod.KernelVariant(**kwargs)
    except ValueError as err:
        return ("ValueError", str(err))
    return (dataclasses.astuple(v), v.is_default, v.grid_spelling,
            v.cadence_spelling, v.epilogue_spec.spelling)


@pytest.mark.parametrize("kwargs", VARIANTS, ids=lambda k: repr(k))
def test_kernel_variant_matches_jax(kwargs):
    assert _variant(cfg, kwargs) == _variant(jcfg, kwargs)


@pytest.mark.parametrize("variant", [
    None, dict(check_every=3, epilogue="relu"), dict(grid_order="nm"),
    dict(tile=3), "mn", 7])
def test_canonical_variant_matches_jax(variant):
    def canon(mod):
        try:
            return dataclasses.astuple(mod.canonical_variant(variant))
        except ValueError as err:
            return ("ValueError", str(err))

    assert canon(cfg) == canon(jcfg)
    assert cfg.canonical_variant(None) is cfg.DEFAULT_VARIANT


def _edge_values() -> np.ndarray:
    """.5 ties and ±127.5 (int8), every finite e4m3 value, the midpoints
    between neighbours, 448-1e4, ±inf, NaN, signed zeros, and a spread of
    ordinary values."""
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    grid = np.unique(codes.astype(np.float32)[np.isfinite(
        codes.astype(np.float32))])
    mids = (grid[:-1] + grid[1:]) / 2
    ties = np.arange(-130.5, 131.0, 1.0, dtype=np.float32)
    big = np.concatenate([np.linspace(448, 1e4, 301), [463.99, 464, 464.01,
                                                       479.9, 480, 481]])
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 127.5, -127.5,
                        128.5, -128.5], np.float32)
    spread = np.random.default_rng(3).standard_normal(4000) * 8
    x = np.concatenate([grid, mids, ties, ties * 4, big, -big, special,
                        spread]).astype(np.float32)
    return x[: x.size - x.size % 8].reshape(8, -1)


def _jax_apply(x, spelling, bias):
    je = jcfg.EpilogueSpec.parse(spelling)
    jb = None if bias is None else jnp.asarray(bias)[None, :]
    return np.array(jax.jit(lambda v, b: japply(v, je, b))(
        jnp.asarray(x), jb))


def _same(a, b):
    return np.array_equal(a, b, equal_nan=True)


EXACT = ["none", "bias", "relu", "qint8", "qint8x0.25", "qfp8", "qfp8x0.5",
         "bias+relu", "bias+relu+qint8x0.25", "bias+relu+qfp8", "qint8x3"]
WITH_GELU = ["gelu", "bias+gelu", "bias+gelu+qint8x0.25", "bias+gelu+qfp8",
             "gelu+qint8"]


@pytest.mark.parametrize("spelling", EXACT + WITH_GELU)
def test_apply_epilogue_matches_jax(spelling):
    x = _edge_values()
    bias = np.random.default_rng(4).standard_normal(x.shape[1]).astype(
        np.float32)
    epi = cfg.EpilogueSpec.parse(spelling)
    row = torch.from_numpy(bias)[None, :] if epi.bias else None
    got = common.apply_epilogue(torch.from_numpy(x), epi, row).numpy()
    want = _jax_apply(x, spelling, bias if epi.bias else None)
    assert got.dtype == np.float32 and got.shape == x.shape
    if "gelu" not in spelling:
        assert _same(got, want)
    else:
        bad = epilogue_violations(torch.from_numpy(want), torch.from_numpy(x),
                                  spelling, bias if epi.bias else None)
        assert int(bad.sum()) == 0
    if epi.quantize == "int8":
        fin = got[np.isfinite(got)]
        assert np.array_equal(fin, np.round(fin)) and np.abs(fin).max() <= 128
    if epi.quantize == "float8_e4m3fn":
        assert _same(got, got.astype(ml_dtypes.float8_e4m3fn).astype(
            np.float32))


def test_gelu_within_stated_ulps_of_jax():
    # The bound behind epilogue_violations, measured directly: the GELU of
    # the two packages on 2e5 values over ±30.
    x = (np.random.default_rng(5).standard_normal((4, 50000)) * 8).astype(
        np.float32)
    got = common.apply_epilogue(torch.from_numpy(x),
                                cfg.EpilogueSpec(activation="gelu")).numpy()
    want = _jax_apply(x, "gelu", None)
    ulp = np.spacing(np.abs(x))
    assert (np.abs(got.astype(np.float64) - want) <= GELU_TOLERANCE_ULPS
            * ulp).all()


@pytest.mark.parametrize("spelling", EXACT + WITH_GELU)
def test_epilogue_reference_matches_jax(spelling):
    x = _edge_values()
    epi = cfg.EpilogueSpec.parse(spelling)
    bias = (np.linspace(-3, 3, x.shape[1]).astype(np.float32)
            if epi.bias else None)
    got = epilogue_reference(x, spelling, bias)
    want = jreference(x, spelling, bias)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    if "gelu" not in spelling:
        assert _same(got, want)
    else:
        assert int(epilogue_violations(torch.from_numpy(want),
                                       torch.from_numpy(x), spelling,
                                       bias).sum()) == 0
    # A tensor in, a tensor out, through the same arithmetic.
    t = epilogue_reference(torch.from_numpy(x), spelling, bias)
    assert isinstance(t, torch.Tensor) and _same(t.numpy(), got)


def test_epilogue_reference_needs_its_bias():
    with pytest.raises(ValueError, match="fuses a bias"):
        epilogue_reference(np.zeros((2, 3), np.float32), "bias+relu")
    with pytest.raises(ValueError, match="no bias_row"):
        common.apply_epilogue(torch.zeros(2, 3), cfg.EpilogueSpec(bias=True))


def test_pad_bias_checks_length_and_pads_with_zeros():
    row = common.pad_bias(np.arange(5, dtype=np.float32), 5, 8,
                          torch.device("cpu"))
    assert row.dtype == torch.float32 and row.is_contiguous()
    assert row.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    with pytest.raises(ValueError, match="length N=5"):
        common.pad_bias(np.zeros(6, np.float32), 5, 8, torch.device("cpu"))
    # The JAX package's operand carries the same row (and sublane padding).
    from ft_sgemm_tpu.ops.common import pad_bias as jpad

    want = np.asarray(jpad(np.arange(5, dtype=np.float32), 5, 8))
    assert np.array_equal(want[0], row.numpy()) and not want[1:].any()


@pytest.mark.parametrize("spelling,args", [
    ("none", (None, 0, 0, 1.0)), ("relu", (None, 1, 0, 1.0)),
    ("gelu+qint8x0.5", (None, 2, 1, 0.5)), ("qfp8x2", (None, 0, 2, 2.0))])
def test_epilogue_args_codes(spelling, args):
    assert common.epilogue_args(cfg.EpilogueSpec.parse(spelling)) == args
    cpu, bias = torch.device("cpu"), cfg.EpilogueSpec(bias=True)
    row = torch.zeros(8)
    assert common.epilogue_args(bias, row, 8, cpu) == (row.data_ptr(), 0, 0,
                                                       1.0)
    with pytest.raises(ValueError, match="no bias row"):
        common.epilogue_args(bias, None, 8, cpu)
    with pytest.raises(ValueError, match="does not fuse one"):
        common.epilogue_args(None, row, 8, cpu)
    with pytest.raises(ValueError, match="16-byte aligned float32"):
        common.epilogue_args(bias, row[:4], 8, cpu)

"""The kernel-variant axes through the port's entry points, against the JAX
package (mirroring tests/test_variants.py:243-276): the pipeline depth 3,
the grid order "nm" and the dimension semantics "arbitrary", each alone and
all three together.

At the JAX package's 128 x 128 x 128 tile (``SHAPES["test"]``) the port's
plain versions (``device="cpu"``) and the JAX package in interpret mode
run the same numpy inputs. Depth 3 makes a grid step the two-panel K
window (256 columns here), so the checks, the faults (the ordinal
``k // every + 3 i + 5 j`` of grid step k) and the adaptive thresholds' run
length count grid steps: for B2-B8 (every (strategy, encode) pair, and B5
at a cadence of one step) under reference-like injection, the
``detections`` and ``uncorrectable`` grids must EQUAL the JAX package's,
and C must pass ``verify_matrix`` (0.01 absolute AND relative) against
the JAX package's C, at K = 256 and K = 384 (which pads to 512, two
steps). "nm" and "arbitrary" change nothing the plain versions compute:
C and the grids are the default axes' bit for bit. int8 (the exact mode)
at depth 3 equals the JAX package bit for bit in the grids and within one
rounding of beta * C (XLA contracts the JAX epilogue into an FMA).
"""

import dataclasses
import pathlib
import re
import types

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.configs import KernelVariant as JKernelVariant
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.ops.common import grid_and_maps
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, KernelVariant, make_ft_sgemm, make_sgemm
from ft_sgemm_tpu_torch.configs import check_variant
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops.common import LaunchAxes, launch_axes, step_shape
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
TILE = SHAPES["test"]
ALPHA, BETA = 1.0, -1.5
N = 256
# (strategy, encode, check_every) -> B2 (weighted, one final check), B5
# (weighted at every grid step), B3, B4, B6, B7, B8.
KERNELS = {"B2": ("weighted", "vpu", None), "B5": ("weighted", "vpu", 1),
           "B3": ("rowcol", "vpu", None), "B4": ("global", "vpu", None),
           "B6": ("fused", "mxu", None), "B7": ("rowcol", "mxu", None),
           "B8": ("global", "mxu", None)}
AXES = [dict(pipeline_depth=3), dict(grid_order="nm"),
        dict(dim_semantics="arbitrary"),
        dict(pipeline_depth=3, grid_order="nm", dim_semantics="arbitrary")]
AXIS_IDS = ["depth3", "nm", "arbitrary", "all"]


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


def _both(kernel, axis, k, seed, in_dtype="float32", threshold=9500.0,
          magnitude=1e4):
    strategy, encode, ce = KERNELS[kernel]
    a, b, c = _inputs(k, seed)
    if in_dtype == "int8":
        a, b = np.round(a * 10.0), np.round(b * 10.0)
    step = 128 * (axis.get("pipeline_depth", 2) - 1)
    jres = jft.make_ft_sgemm(
        JTILE, strategy=strategy, encode=encode, check_every=ce,
        threshold=threshold, in_dtype=in_dtype, tunable=False,
        variant=JKernelVariant(**axis))(
            a, b, c, JInjectionSpec.reference_like(k, step,
                                                   magnitude=magnitude))
    res = make_ft_sgemm(
        TILE, strategy=strategy, encode=encode, check_every=ce,
        threshold=threshold, in_dtype=in_dtype, variant=KernelVariant(**axis),
        device="cpu")(a, b, c, InjectionSpec.reference_like(
            k, step, magnitude=magnitude))
    return jres, res


@pytest.mark.parametrize("k", [256, 384])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_depth3_grids_equal_jax(kernel, k):
    jres, res = _both(kernel, dict(pipeline_depth=3), k, seed=k + 1)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    assert int(res.num_detected) > 0
    if KERNELS[kernel][0] != "global":  # global leaves its faults in C
        assert int(res.num_uncorrectable) == 0
    ok, nbad, first = verify_matrix(np.asarray(jres.c), res.c.numpy(),
                                    verbose=False)
    assert ok, (nbad, first)


def test_depth3_moves_the_schedule():
    # A grid step of two panels: the schedule counts grid steps, so at
    # K = 1024 depth 3 meets fewer faults than depth 2, and its grids
    # differ.
    _, deep = _both("B3", dict(pipeline_depth=3), 1024, seed=5)
    _, flat = _both("B3", {}, 1024, seed=5)
    assert int(deep.num_detected) < int(flat.num_detected)


@pytest.mark.parametrize("kernel", ["B3", "B4"])
def test_depth3_int8_equals_jax(kernel):
    jres, res = _both(kernel, dict(pipeline_depth=3), 384, seed=9,
                      in_dtype="int8")
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    np.testing.assert_allclose(res.c.numpy(), np.asarray(jres.c), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["B3", "B4", "B5", "B6", "B7", "B8"])
def test_depth3_adaptive_grids_equal_jax(kernel):
    # The adaptive thresholds' run length counts grid steps of 256 columns
    # and the static log2 the padded run's: magnitude-5 faults.
    jres, res = _both(kernel, dict(pipeline_depth=3), 384, seed=13,
                      threshold="adaptive", magnitude=5.0)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    assert int(res.num_detected) > 0


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("axis", AXES[1:3], ids=AXIS_IDS[1:3])
def test_grid_order_and_semantics_change_nothing(kernel, axis):
    strategy, encode, ce = KERNELS[kernel]
    a, b, c = _inputs(N, seed=3)
    inj = InjectionSpec.reference_like(N, 128)
    base, got = (make_ft_sgemm(TILE, strategy=strategy, encode=encode,
                               check_every=ce, variant=v, device="cpu")(
                                   a, b, c, inj)
                 for v in (None, KernelVariant(**axis)))
    for x, y in zip(got, base):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", ["B3", "B6", "B8"])
def test_all_axes_grids_equal_jax(kernel):
    jres, res = _both(kernel, AXES[-1], 384, seed=17)
    np.testing.assert_array_equal(res.detections.numpy(),
                                  np.asarray(jres.detections))
    np.testing.assert_array_equal(res.uncorrectable.numpy(),
                                  np.asarray(jres.uncorrectable))
    ok, _, _ = verify_matrix(np.asarray(jres.c), res.c.numpy(), verbose=False)
    assert ok


@pytest.mark.parametrize("axis", AXES, ids=AXIS_IDS)
def test_plain_sgemm_variants_equal_jax(axis):
    a, b, c = _inputs(384, seed=21)
    jout = jft.make_sgemm(JTILE, tunable=False,
                          variant=JKernelVariant(**axis))(a, b, c)
    out = make_sgemm(TILE, variant=KernelVariant(**axis), device="cpu")(
        a, b, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-4)


def test_plain_sgemm_depth3_multiplies_per_panel():
    # One product per K panel, added in order, as the JAX kernel's
    # sub_panels dots: at depth 3 the plain version is the sum of
    # per-panel matmuls, not one matmul.
    a, b, c = _inputs(384, seed=23)
    got = make_sgemm(TILE, variant=KernelVariant(pipeline_depth=3),
                     device="cpu")(a, b, c)
    ta, tb = (torch.nn.functional.pad(torch.from_numpy(x), (0, 128))
              for x in (a, b))
    acc = torch.zeros((N, N))
    for k0 in range(0, 512, 128):
        acc += ta[:, k0:k0 + 128] @ tb[:, k0:k0 + 128].T
    assert torch.equal(got, ALPHA * acc + BETA * torch.from_numpy(c))


@pytest.mark.parametrize("bad", [dict(pipeline_depth=4),
                                 dict(grid_order="km"),
                                 dict(dim_semantics="sequential")])
def test_illegal_axes_raise_jax_errors(bad):
    with pytest.raises(ValueError) as jerr:
        JKernelVariant(**bad)
    with pytest.raises(ValueError) as err:
        KernelVariant(**bad)
    assert str(err.value) == str(jerr.value)
    # A descriptor that bypassed its own check (a frozen dataclass edited
    # in place) is refused by the factories with the same error.
    v = KernelVariant()
    (field, value), = bad.items()
    object.__setattr__(v, field, value)
    with pytest.raises(ValueError) as err:
        check_variant(v)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError):
        make_ft_sgemm(TILE, variant=v, device="cpu")
    with pytest.raises(ValueError):
        make_sgemm(TILE, variant=v, device="cpu")


def test_step_shape_and_launch_axes():
    deep = KernelVariant(pipeline_depth=3, grid_order="nm",
                         dim_semantics="arbitrary")
    assert step_shape(TILE, KernelVariant()) is TILE
    assert step_shape(SHAPES["small"], deep).block == (16, 16, 32)
    assert step_shape(TILE, deep) == dataclasses.replace(TILE, bk=256)
    assert launch_axes(deep) == LaunchAxes(unroll=2, nm=True, one_pass=False)
    assert launch_axes(deep, True).args() == (1,)
    assert LaunchAxes().args() == (0,)


def _variant_raster():
    """The CTA raster as ``csrc/abft_common.cuh::Variant`` writes it: its
    ``grid(gm, gn)``, ``tile_m()`` and ``tile_n()``, each a ternary on
    ``nm``, read from the source and evaluated here, so the test follows
    the kernels' own expressions."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "ft_sgemm_tpu_torch"
           / "csrc" / "abft_common.cuh").read_text()
    body = re.search(r"struct Variant \{(.*?)\n\};", src, re.S).group(1)

    def ternary(head):
        m = re.search(re.escape(head) + r"\s*\{\s*return nm \? (.+?) : (.+?);",
                      body, re.S)
        return m.group(1), m.group(2)

    return (ternary("grid(int gm, int gn) const"), ternary("tile_m() const"),
            ternary("tile_n() const"))


@pytest.mark.parametrize("order", ["mn", "nm"])
def test_cta_raster_walks_tiles_as_the_jax_grid(order):
    # The hardware walks blockIdx.x first; the JAX grid its last parallel
    # dimension first. Both visit every output tile once, in one order, and
    # a CTA's tile is the one the JAX index map gives its program ids.
    gm, gn = 3, 5
    grid, _, _, c_map, _ = grid_and_maps(order, gm, gn, 1)
    jax_walk = [c_map(p, q, 0) for p in range(grid[0])
                for q in range(grid[1])]
    pick = int(order == "nm") ^ 1  # the ternary's branch: 0 when nm
    raster, tile_m, tile_n = (t[pick] for t in _variant_raster())
    x, y = eval(raster, {"dim3": lambda u, v: (u, v), "gm": gm, "gn": gn})
    cuda_walk = []
    for by in range(y):
        for bx in range(x):
            env = {"blockIdx": types.SimpleNamespace(x=bx, y=by)}
            cuda_walk.append((eval(tile_m, env), eval(tile_n, env)))
    assert cuda_walk == jax_walk
    assert sorted(cuda_walk) == [(i, j) for i in range(gm) for j in range(gn)]

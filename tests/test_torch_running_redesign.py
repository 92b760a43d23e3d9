"""Kernels B5 (weighted, ``running``) and B4 (global) in the order of their
Hopper design (``csrc/ft_sgemm_running.cuh``, ``csrc/gemm_wgmma.cuh``),
through the CPU model ``ops/tf32x3``.

(a) Faults folded at stage ends (``FragInject::fold``: each fault added into
the accumulator at the end of the 32-column stage that holds it, or before
a check's snapshot; B5's moment rows summed by lane groups,
``tf32x3.moment_rows_b5``; B4's band rows likewise, ``band_sums_b4``)
against the JAX package's ``make_ft_sgemm(strategy="weighted")`` at
cadences under the step count (so that it runs ``_ft_kernel_weighted``) and
``strategy="global"`` in interpret mode, at 128x128x128 and 256x128x128,
clean, reference-like and with ``col_stride=0``, in f32 and on operands
rounded to bf16 (``in_dtype="bfloat16"``: the products of bf16 values are
exact in 3xTF32): the ``detections`` and ``uncorrectable`` grids EQUAL, C
within ``verify_matrix`` (0.01 absolute AND relative) on the tiles the JAX
package reports correctable (global corrects nothing: there C is held to
the JAX package's own C). (b) int8 B4: integer adds commute, so the folded
order gives the immediate order's C and grids bit for bit
(``ft_global_plain``), also where the checksums wrap. (c) B5's moment-row
order against the JAX package's moment rows (``_tile_moments``): within
64 f32 roundings of the sum of the terms' magnitudes, at every sub-tile
height; the lane tree at the 16-row tile is the plain running sum. (d)
The copies of ``scripts/torch_variant_time.py`` that time B4's and B5's
parts apply, and land on B4's and B5's code.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_subtile_rowcol import (  # noqa: F401
    JAX_TILES,
    SCHEDULES,
    _hold_c,
    _inputs,
    _jinject,
    _one_torch_thread,
)

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.ops import ft_sgemm as jft_ops
from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.interop import from_reference
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import tf32x3
from ft_sgemm_tpu_torch.ops.common import (
    LaunchAxes,
    align_rows16,
    pad_to,
    scalar_operand,
)

DIMS = (300, 200, 512)
STRATEGIES = {"B5": "weighted", "B4": "global"}
DTYPES = ("float32", "bfloat16")
SUB_HEIGHTS = (16, 32, 64, 128)


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    """The operand as the kernel multiplies it: bf16 values as f32."""
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _jax(tile, schedule, strategy, check_every, dtype):
    jshape, _ = JAX_TILES[tile]
    a, b, c = _inputs(*DIMS, seed=43)
    jinj = _jinject(schedule, DIMS[2], jshape.bk)
    jres = jft.make_ft_sgemm(jshape, strategy=strategy,
                             check_every=check_every, in_dtype=dtype)(
        a, b, c, jinj)
    return (np.asarray(jres.detections), np.asarray(jres.uncorrectable),
            np.asarray(jres.c), np.asarray(jft.sgemm_reference(
                _round(a, dtype), _round(b, dtype), c)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("check_every", [1, 2])
@pytest.mark.parametrize("kernel", list(STRATEGIES))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("tile", list(JAX_TILES))
def test_folded_order_matches_jax(tile, schedule, kernel, check_every,
                                  dtype):
    jshape, shape = JAX_TILES[tile]
    strategy = STRATEGIES[kernel]
    jdet, junc, jc, want = _jax(tile, schedule, strategy, check_every, dtype)
    a, b, c = _inputs(*DIMS, seed=43)
    ops = from_reference(_round(a, dtype), _round(b, dtype), c,
                         _jinject(schedule, DIMS[2], jshape.bk).as_operand(),
                         REFERENCE_THRESHOLD, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    sc = scalar_operand(ops.inject, ops.thresholds)
    assert ap.shape[1] // shape.bk > check_every  # JAX runs the running kernel
    model = (tf32x3.ft_running_tf32x3 if kernel == "B5"
             else tf32x3.ft_global_tf32x3)
    out, det, unc = model(ap, bp, cp, shape, 1.0, -1.5, sc, check_every)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(unc.numpy(), junc)
    if kernel == "B5":
        _hold_c(want, out.numpy(), junc == 0, shape.bm, shape.bn, DIMS)
    else:  # detect only: the faults stay in both Cs
        _hold_c(jc, out.numpy(), np.ones_like(junc, bool), shape.bm,
                shape.bn, DIMS)
    if schedule == "reference_like":
        assert (jdet > 0).all()
        if kernel == "B5":
            assert junc.sum() == 0
    elif schedule == "clean":
        assert jdet.sum() == 0


def _folded_global_exact(ap, bp, cp, shape, scalars, check_every):
    """B4's exact mode in the int8 kernel's order: the tile algorithm of
    ``ft_global_plain`` with each bk step's fault added at the end of its
    128-column stage (or before a check)."""
    a4, b4, c4, nk = ft._tiles(ap.double(), bp.double(), cp, shape)
    gm, gn, bm, bn = c4.shape
    acc = torch.zeros_like(c4, dtype=torch.int64)
    t_exp = torch.zeros((gm, gn), dtype=torch.int64)
    prev = torch.zeros((gm, gn), dtype=torch.int64)
    det = torch.zeros((gm, gn), dtype=torch.int32)
    thr = float(scalars[4])
    stage = max(1, 128 // shape.bk)   # bk steps per s8 stage
    pending = []

    def fold():
        for k in pending:
            ft._inject_plain(acc, scalars, k)
        pending.clear()

    for k in range(nk):
        pending.append(k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        ft._step_product(acc, ft._exact_dot, a_k, b_k, LaunchAxes())
        t_exp += ft._exact_dot("ik,jk->ij", a_k.sum(1), b_k.sum(1))
        if (k + 1) % check_every == 0 or k == nk - 1:
            fold()
            res = ft.wrap_int32(t_exp - acc.sum((-1, -2)))
            det += (ft._mag32(ft.wrap_int32(res - prev)) > thr).to(torch.int32)
            prev = res
        if (k + 1) % stage == 0 or k == nk - 1:
            fold()
    return ft._epilogue(acc, c4, 1.0, -1.5), det, det.clone()


INT8_SCHEDULES = {
    "clean": InjectionSpec.none(),
    "reference_like": None,
    "adversarial_same_column": "col_stride0",
    "every_1": InjectionSpec(True, 1),
    "every_3": InjectionSpec(True, 3),
}


@pytest.mark.parametrize("schedule", list(INT8_SCHEDULES))
@pytest.mark.parametrize("data", ["lattice", "wrapping"])
@pytest.mark.parametrize("name", ["small", "huge"])
def test_int8_global_folded_order_is_bit_exact(name, data, schedule):
    shape = SHAPES[name]
    gen = np.random.default_rng(5)
    m, k = (32, 4096) if data == "wrapping" else (128, 512)
    low, high = (100, 127) if data == "wrapping" else (-9, 9)
    a = gen.integers(low, high + 1, (m, k)).astype(np.float32)
    b = gen.integers(low, high + 1, (m, k)).astype(np.float32)
    c = gen.standard_normal((m, m)).astype(np.float32)
    ap, bp = (align_rows16(pad_to(torch.from_numpy(x).to(torch.int8),
                                  shape.bm, shape.bk)) for x in (a, b))
    cp = pad_to(torch.from_numpy(c), shape.bm, shape.bn)
    inj = INT8_SCHEDULES[schedule]
    if inj is None or inj == "col_stride0":
        ref = InjectionSpec.reference_like(k, shape.bk)
        inj = ref if inj is None else InjectionSpec(True, ref.every,
                                                    col_stride=0)
    sc = scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3)
    nk = ap.shape[1] // shape.bk
    program = ft._plan("global", None, None, inj, nk, shape.bn)[1]
    for check_every in sorted({program, 1, 3}):
        want = ft.ft_global_plain(ap, bp, cp, shape, 1.0, -1.5, sc,
                                  check_every)
        got = _folded_global_exact(ap, bp, cp, shape, sc, check_every)
        for x, y in zip(got, want):
            assert torch.equal(x, y), (check_every, x, y)
        if data == "wrapping":
            # The tiles' checksums pass 2^31 (and wrap) in this case.
            assert float(a.sum(0) @ b.sum(0)) > 2 ** 31
        if schedule == "reference_like" and check_every == program:
            assert int(want[1].sum()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sbm", SUB_HEIGHTS)
def test_b5_moment_row_order_against_jax(sbm, dtype):
    gen = np.random.default_rng(sbm)
    a = _round(gen.uniform(-1.0, 1.0, (256, 96)).astype(np.float32), dtype)
    got = tf32x3.moment_rows_b5(torch.from_numpy(a), sbm)
    want = np.asarray(jft_ops._tile_moments(jnp.asarray(a), sbm)).astype(
        np.float64)
    assert got.shape == want.shape == (256 // sbm, 3, 96)
    # The tolerance: 64 f32 roundings of the sum of |w^v x| over the band.
    w = np.arange(1, sbm + 1, dtype=np.float64)
    mag = np.stack([np.abs(a.reshape(-1, sbm, 96)).astype(np.float64)
                    .transpose(0, 2, 1) @ w ** v for v in range(3)], 1)
    exact = np.stack([a.reshape(-1, sbm, 96).astype(np.float64)
                      .transpose(0, 2, 1) @ w ** v for v in range(3)], 1)
    tol = 64 * 2.0 ** -24 * mag
    assert (np.abs(got.double().numpy() - want) <= tol).all()
    assert (np.abs(got.double().numpy() - exact) <= tol).all()


def test_b5_moment_rows_at_16_rows_are_the_running_sum():
    # One lane a column at the 16-row tile: the sums are the running f32
    # sums row by row, in order.
    gen = np.random.default_rng(9)
    a = torch.from_numpy(gen.standard_normal((32, 40)).astype(np.float32))
    got = tf32x3.moment_rows_b5(a, 16)
    for band in range(2):
        s = [torch.zeros(40) for _ in range(3)]
        for rr in range(16):
            x = a[16 * band + rr]
            w = float(rr + 1)
            s[0] = s[0] + x
            s[1] = (w * x.double() + s[1].double()).float()
            s[2] = (w * w * x.double() + s[2].double()).float()
        assert torch.equal(got[band], torch.stack(s))


def test_lane_tree_pairs_the_highest_bit_first():
    x = torch.tensor([[1.0, 2.0 ** 24, 1.0, -(2.0 ** 24)]])
    # (x0 + x2) + (x1 + x3) = 2 + 0; a running sum would give 0 + 1 = 1.
    assert float(tf32x3.lane_tree(x)[0]) == 2.0
    y = torch.arange(8.0)[None]
    assert float(tf32x3.lane_tree(y)[0]) == 28.0


@pytest.mark.parametrize("sbn", [16, 32, 64, 128])
def test_b4_band_sums_within_f32_of_the_plain_sums(sbn):
    gen = np.random.default_rng(sbn + 1)
    bv = torch.from_numpy(gen.standard_normal((128 // sbn, sbn, 64))
                          .astype(np.float32))
    got = tf32x3.band_sums_b4(bv, sbn).double()
    exact = bv.double().sum(1)
    tol = 16 * 2.0 ** -24 * bv.double().abs().sum(1)
    assert got.shape == (128 // sbn, 64)
    assert bool(((got - exact).abs() <= tol).all())


SPLIT_VARIANTS = ("splitter-sums-zero", "global-check-returns",
                  "one-final-check", "adaptive-sums-skipped",
                  "b5-sums-by-thread", "b5-lanes-everywhere", "producer-40",
                  "b4-producer-40", "b4-producer-56", "faults-at-once",
                  "b4-sums-8-row-groups")


@pytest.mark.parametrize("name", SPLIT_VARIANTS)
def test_split_variants_apply_to_b4_and_b5(name, tmp_path):
    # scripts/torch_variant_time.py's copies that time B4's and B5's parts:
    # each edit finds its text, and those with an earlier form as well
    # land on B4's and B5's code here, not on B3's or B8's.
    import pathlib
    import sys

    scripts = pathlib.Path(__file__).resolve().parents[1] / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        import torch_variant_time as tvt
    finally:
        sys.path.remove(str(scripts))
    tvt.write_variant(name, str(tmp_path / "v"))
    csrc = tmp_path / "v" / "ft_sgemm_tpu_torch" / "csrc"
    wgmma = (csrc / "gemm_wgmma.cuh").read_text()
    running = (csrc / "ft_sgemm_running.cuh").read_text()
    if name == "splitter-sums-zero":
        for head, zero in ((tvt._LANES_F32, tvt._B4_ZERO_F32),
                           (tvt._LANES_BF16, tvt._B4_ZERO_BF16),
                           (tvt._LANES_S8, tvt._B4_ZERO_S8)):
            assert head + zero in wgmma
        assert wgmma.count("for (int i = 0; i < 0; ++i) {") == 2
    if name == "global-check-returns":
        assert "void post(WgMainloop<T>& ml, int) {\n    return;" in running
        assert "void check(WgMainloop<T>& ml) {\n    return;" not in running
        assert "chk(INT_MAX), thr0" in running
    assert not (csrc / "_build").exists()

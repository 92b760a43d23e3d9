"""The split-phase rowcol check of kernels B3 and B7 on the CPU
(``csrc/ft_sgemm_running.cuh``: ``RowcolSplitCheck``, the consumers' half,
and ``RowcolChecker``, the checker warps' half), through its CPU model
``ops/tf32x3``.

(a) The deferred order (``ft_rowcol_tf32x3``: each fault added into the
accumulator at the stage end that promotes its stage, or before a check's
snapshot; each check's corrections added before the next check's snapshot
or the output) against the
JAX package's ``make_ft_sgemm(strategy="rowcol")`` in interpret mode, at
128x128x128 and 256x128x128, clean, reference-like and with
``col_stride=0``, multifault off and on, with a check after every bk step
(four stages apart) and after every third, for
B3 (vpu) and B7 (mxu, its loaded rows): the ``detections`` and
``uncorrectable`` grids EQUAL, C within ``verify_matrix`` on every tile the
JAX package reports correctable. (b) The checker's decisions
(``rowcol_split_decide``): the correction, the hits and the re-check
formed from the decisions equal the accumulator-pass re-check
(``ops/ft_sgemm._rowcol_decide``, the JAX package's algorithm) on seeded
residuals with planted faults, in f32 with multifault off and on and on
wrapped int32 residuals. (c) int8: integer adds commute, so the deferred
order gives the immediate order's C and grids bit for bit, also where the
checksums wrap.
"""

import functools

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
# B3 runs the vpu encode, B7 the mxu one (the wrapper's checksum rows).
ENCODES = {"B3": "vpu", "B7": "mxu"}


@functools.lru_cache(maxsize=None)
def _jax(tile, schedule, mf, check_every, encode):
    jshape, _ = JAX_TILES[tile]
    a, b, c = _inputs(*DIMS, seed=41)
    jinj = _jinject(schedule, DIMS[2], jshape.bk)
    jres = jft.make_ft_sgemm(jshape, strategy="rowcol", encode=encode,
                             check_every=check_every,
                             multifault=mf)(a, b, c, jinj)
    return (np.asarray(jres.detections), np.asarray(jres.uncorrectable),
            np.asarray(jft.sgemm_reference(a, b, c)))


@pytest.mark.parametrize("kernel", list(ENCODES))
@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("mf", [False, True], ids=["mf_off", "mf_on"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("tile", list(JAX_TILES))
def test_deferred_order_matches_jax(tile, schedule, mf, check_every, kernel):
    jshape, shape = JAX_TILES[tile]
    jdet, junc, want = _jax(tile, schedule, mf, check_every, ENCODES[kernel])
    a, b, c = _inputs(*DIMS, seed=41)
    ops = from_reference(a, b, c,
                         _jinject(schedule, DIMS[2], jshape.bk).as_operand(),
                         REFERENCE_THRESHOLD, device="cpu")
    ap, bp = pad_to(ops.a, shape.bm, shape.bk), pad_to(ops.b, shape.bn, shape.bk)
    cp = pad_to(ops.c, shape.bm, shape.bn)
    sc = scalar_operand(ops.inject, ops.thresholds)
    rows = (ft.kernel_inputs("rowcol_mxu", ap, bp, shape)
            if kernel == "B7" else None)
    out, det, unc = tf32x3.ft_rowcol_tf32x3(ap, bp, cp, shape, 1.0, -1.5, sc,
                                            check_every, mf, rows=rows)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(unc.numpy(), junc)
    _hold_c(want, out.numpy(), junc == 0, shape.bm, shape.bn, DIMS)
    if schedule == "reference_like":
        assert jdet.sum() > 0


def _planted(gen, gm, gn, bm, bn, n_faults, exact):
    """Residuals of (gm, gn) tiles with faults planted at random elements:
    noise, or (exact) zeros, plus each fault in its row's and its column's
    residual and its weighted column residual."""
    if exact:
        res_r = torch.zeros((gm, gn, bm), dtype=torch.int64)
        res_c = torch.zeros((gm, gn, bn), dtype=torch.int64)
        res_cw = None
    else:
        res_r = torch.from_numpy(gen.standard_normal((gm, gn, bm)).astype(
            np.float32))
        res_c = torch.from_numpy(gen.standard_normal((gm, gn, bn)).astype(
            np.float32))
        res_cw = torch.from_numpy(8 * gen.standard_normal((gm, gn, bn)).astype(
            np.float32))
    for _ in range(n_faults):
        i, j = gen.integers(gm), gen.integers(gn)
        r, col = gen.integers(bm), gen.integers(bn)
        if exact:
            v = int(gen.integers(-2 ** 31, 2 ** 31))
            res_r[i, j, r] += v
            res_c[i, j, col] += v
        else:
            v = float(gen.choice([1e4, -2e4, 3e4, 5e5]))
            res_r[i, j, r] += v
            res_c[i, j, col] += v
            res_cw[i, j, col] += v * (r + 1)
    if exact:
        res_r, res_c = ft.wrap_int32(res_r), ft.wrap_int32(res_c)
    return res_r, res_c, res_cw


@pytest.mark.parametrize("sub", [(16, 16), (32, 128), (128, 128)],
                         ids=["16x16", "32x128", "128x128"])
@pytest.mark.parametrize("mode", ["f32", "f32_mf", "int8"])
def test_recheck_from_decisions_equals_accumulator_pass(mode, sub):
    bm, bn = sub
    exact, mf = mode == "int8", mode == "f32_mf"
    gen = np.random.default_rng(bm + bn + len(mode))
    thresholds = (0.5, 0.5) if exact else (REFERENCE_THRESHOLD,
                                           REFERENCE_THRESHOLD * bm / 3 ** 0.5)
    seen, hits = set(), 0
    for trial in range(60):
        res_r, res_c, res_cw = _planted(gen, 2, 3, bm, bn, trial % 7, exact)
        acc = torch.zeros((2, 3, bm, bn),
                          dtype=torch.int64 if exact else torch.float32)
        want = ft._rowcol_decide(acc, res_r, res_c, res_cw if mf else None,
                                 thresholds, mf, exact)
        got = tf32x3.rowcol_split_decide(res_r, res_c, res_cw if mf else None,
                                         thresholds, mf, exact)
        delta = ft.wrap_int32(want[0]) if exact else want[0]
        assert torch.equal(got[0], delta)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[2])
        seen.update(int(x) for x in want[2].flatten())
        hits += int(want[1].sum())
    # The planted faults are found; without multifault, several faults in a
    # tile leave some of it uncorrectable.
    assert hits > 0 and 0 in seen and (mf or len(seen) > 1)


def _deferred_exact(ap, bp, cp, shape, scalars, check_every):
    """B3's exact mode in the int8 kernel's order: the tile algorithm of
    ``ft_rowcol_plain`` with each bk step's fault added at the end of its
    128-column stage (or before a check) and each check's corrections
    before the next check or the output."""
    a4, b4, c4, nk = ft._tiles(ap.double(), bp.double(), cp, shape)
    gm, gn, bm, bn = c4.shape
    acc = torch.zeros_like(c4, dtype=torch.int64)
    r_exp = torch.zeros((gm, gn, bm), dtype=torch.int64)
    c_exp = torch.zeros((gm, gn, bn), dtype=torch.int64)
    det = torch.zeros((gm, gn), dtype=torch.int32)
    unc = torch.zeros_like(det)
    thresholds = [float(t) for t in scalars[4:6]]
    stage = max(1, 128 // shape.bk)   # bk steps per s8 stage
    pending, delta = [], None

    def fold():
        for k in pending:
            ft._inject_plain(acc, scalars, k)
        pending.clear()

    for k in range(nk):
        pending.append(k)
        a_k, b_k = a4[:, :, k], b4[:, :, k]
        ft._step_product(acc, ft._exact_dot, a_k, b_k, LaunchAxes())
        r_exp += ft._exact_dot("imk,jk->ijm", a_k, b_k.sum(1))
        c_exp += ft._exact_dot("jnk,ik->ijn", b_k, a_k.sum(1))
        if (k + 1) % check_every == 0 or k == nk - 1:
            fold()
            if delta is not None:
                acc += delta
            delta, hits, bad = tf32x3.rowcol_split_decide(
                ft.wrap_int32(r_exp - acc.sum(-1)),
                ft.wrap_int32(c_exp - acc.sum(-2)), None, thresholds, False,
                exact=True)
            det += hits.to(torch.int32)
            unc = bad.to(torch.int32)
        if (k + 1) % stage == 0 or k == nk - 1:
            fold()
    if delta is not None:
        acc += delta
    return ft._epilogue(acc, c4, 1.0, -1.5), det, unc


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
def test_int8_deferred_order_is_bit_exact(name, data, schedule):
    shape = SHAPES[name]
    gen = np.random.default_rng(3)
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
    program = ft._plan("rowcol", None, False, inj, nk, shape.bn)[1]
    for check_every in sorted({program, 1, 3}):
        want = ft.ft_rowcol_plain(ap, bp, cp, shape, 1.0, -1.5, sc,
                                  check_every, False)
        got = _deferred_exact(ap, bp, cp, shape, sc, check_every)
        for x, y in zip(got, want):
            assert torch.equal(x, y), (check_every, x, y)
        if schedule == "reference_like" and check_every == program:
            assert int(want[1].sum()) > 0 and int(want[2].sum()) == 0

"""The bf16 input mode on the mxu encodes (kernels B6, B7 and B8): the port
against the JAX package on the same numpy inputs.

The JAX side runs ``ft_sgemm_tpu.make_ft_sgemm(in_dtype="bfloat16")`` with
``strategy="fused"`` or ``encode="mxu"`` in interpret mode, as its own
tests run it (``_ft_kernel_fused``, ``_ft_kernel_rowcol_mxu``,
``_ft_kernel_global_mxu`` with ``n_terms = 3``: the operands augmented by
their bf16 hi / lo / lo2 moment rows); the port runs its plain versions
(``device="cpu"``) on the wrapper's bf16 term rows
(``ops/ft_sgemm._tile_moments``), each term's expected sums kept apart and
added at the check. At the JAX package's tiles (128x128x128 and
256x128x128), through the cases of tests/test_torch_ft_sgemm.py, the
``detections`` and ``uncorrectable`` grids must be EQUAL; C must pass
``verify_matrix`` (0.01 absolute AND relative) against the bf16 oracle
(the f32 product of the rounded operands) on every tile the JAX package
reports correctable (the detect-only global: against the JAX package's C
everywhere, the oracle when clean). Then: magnitude-5 faults under
``threshold="auto"``, one paper tile with a ragged grid, the wrapper's rows
against the JAX package's bit for bit, and the CPU model of the three term
boxes a bf16 stage of B6-B8 loads (``ops/tf32x3.loaded_term_rows``). The
card tests are in tests/test_torch_bf16_mxu_card.py.
"""

import ctypes
import types

import numpy as np
import pytest
import torch
from test_torch_ft_sgemm import CASES, TILES
from test_torch_subtile_rowcol import SUBTILES

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, make_ft_sgemm
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.interop import from_reference
from ft_sgemm_tpu_torch.ops import _build
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import tf32x3
from ft_sgemm_tpu_torch.ops.common import as_operand, pad_to
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

ALPHA, BETA = 1.0, -1.5
# (strategy, encode, multifault) of each bf16 mxu run: B6 under both of
# its spellings, B7 with multifault off and on, B8.
PAIRS = {"fused": ("fused", "vpu", None),
         "weighted-mxu": ("weighted", "mxu", None),
         "rowcol-mxu": ("rowcol", "mxu", False),
         "rowcol-mxu-mf": ("rowcol", "mxu", True),
         "global-mxu": ("global", "mxu", None)}


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


def _oracle(a, b, c):
    return sgemm_reference(a, b, c, ALPHA, BETA, in_dtype="bfloat16",
                           device="cpu").numpy()


def _mask(unc, bm, bn, dims):
    return np.repeat(np.repeat(np.asarray(unc) == 0, bm, 0), bn,
                     1)[:dims[0], :dims[1]]


def _make(pair, shape, **kw):
    strategy, encode, mf = PAIRS[pair]
    return make_ft_sgemm(shape, alpha=ALPHA, beta=BETA, strategy=strategy,
                         encode=encode, multifault=mf, in_dtype="bfloat16",
                         device="cpu", **kw)


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("case,dims,inj_kw,check_every", CASES,
                         ids=[c[0] for c in CASES])
def test_bf16_mxu_matches_jax(tile, pair, case, dims, inj_kw, check_every):
    jshape, shape = TILES[tile]
    strategy, encode, mf = PAIRS[pair]
    a, b, c = _inputs(*dims, seed=0)
    if inj_kw == "reference_like":
        jinj = JInjectionSpec.reference_like(dims[2], jshape.bk)
    else:
        jinj = JInjectionSpec(**(inj_kw or {}))
    kw = {} if mf is None else dict(multifault=mf)
    jres = jft.make_ft_sgemm(jshape, alpha=ALPHA, beta=BETA,
                             strategy=strategy, encode=encode,
                             check_every=check_every, in_dtype="bfloat16",
                             **kw)(a, b, c, jinj)
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    res = _make(pair, shape, check_every=check_every,
                threshold=ops.thresholds)(ops.a, ops.b, ops.c, ops.inject)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    got = res.c.numpy()
    if strategy == "global":
        # Detect only: both keep the same faults in C.
        ok, nbad, first = verify_matrix(np.asarray(jres.c), got,
                                        verbose=False)
        assert ok, f"{nbad} elements off JAX's C, first at {first}"
        assert (jdet == junc).all()
        if case == "clean":
            assert verify_matrix(_oracle(a, b, c), got, verbose=False)[0]
    else:
        ok_tiles = _mask(junc, jshape.bm, jshape.bn, dims)
        ok, nbad, first = verify_matrix(_oracle(a, b, c)[ok_tiles],
                                        got[ok_tiles], verbose=False)
        assert ok, f"{nbad} elements off the oracle, first at {first}"
    if case == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    elif case == "reference_like":
        assert (jdet > 0).all()
        assert strategy == "global" or junc.sum() == 0


@pytest.mark.parametrize("pair", list(PAIRS))
def test_bf16_mxu_auto_catches_small_faults(pair):
    # tests/test_mixed_precision.py:169-190 on the mxu kernels: faults of
    # magnitude 5 at every step, which the reference's 9500 misses, are each
    # caught under threshold="auto" (noise floor of the rounded operands)
    # and, where the strategy corrects, corrected to the oracle.
    strategy = PAIRS[pair][0]
    a, b, c = _inputs(128, 128, 512, seed=23)
    inj = InjectionSpec(enabled=True, every=1, magnitude=5.0)
    static = _make(pair, "test")(a, b, c, inj)
    assert int(static.num_detected) == 0   # 9500 misses them
    res = _make(pair, "test", threshold="auto")(a, b, c, inj)
    if strategy == "global":
        # one event a check interval: the ~20-a-run cadence checks every step
        assert int(res.num_detected) == 4
        assert torch.equal(res.detections, res.uncorrectable)
        return
    assert int(res.num_detected) == 4 and int(res.num_uncorrectable) == 0
    ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                verbose=False)
    assert ok, f"bf16/{pair}: {nbad} small faults survived"


@pytest.mark.parametrize("pair", list(PAIRS))
def test_bf16_mxu_paper_tile_ragged(pair):
    # The medium tile (32x32x8; the JAX package's tiles are multiples of
    # 128) with M and N that are not multiples of 128 or 32: a 7 x 5 grid,
    # the last row and column of tiles padded. Every tile sees the
    # schedule's faults (padding rows included), each detected; C is the
    # rounded oracle's on every tile where the strategy corrects.
    strategy = PAIRS[pair][0]
    m, n, k = 200, 136, 96
    a, b, c = _inputs(m, n, k, seed=31)
    shape = SHAPES["medium"]
    inj = InjectionSpec.reference_like(k, shape.bk)
    res = _make(pair, "medium")(a, b, c, inj)
    assert tuple(res.detections.shape) == (7, 5)
    nk = -(-k // shape.bk)
    _, ce, _ = ft._plan(strategy, None, None, inj, nk, shape.bn, "mxu")
    if strategy == "global":
        events = len({(f * inj.every) // ce for f in range(
            inj.expected_faults(k, shape.bk))})
        assert (res.detections.numpy() == events).all()
        assert torch.equal(res.detections, res.uncorrectable)
        return
    assert (res.detections.numpy() == inj.expected_faults(k, shape.bk)).all()
    assert int(res.num_uncorrectable) == 0
    ok, nbad, _ = verify_matrix(_oracle(a, b, c), res.c.numpy(),
                                verbose=False)
    assert ok, f"{nbad} elements off"


@pytest.mark.parametrize("pair", list(PAIRS))
def test_bf16_mxu_plain_versions_sum_the_terms(pair):
    # The plain versions on the bf16 term rows give the grids of the f32
    # algorithm on the rounded values (the vpu kernels' plain versions, which
    # sum the rows themselves), and C within an f32 rounding of it: the
    # three terms add up to the f32 moments.
    strategy, encode, mf = PAIRS[pair]
    shape = SHAPES["medium"]
    kind, ce, mf = ft._plan(strategy, 3, mf, InjectionSpec(True, 3), 10,
                            shape.bn, "mxu")
    a, b, c = _inputs(96, 64, 80, seed=1)
    ab, bb = (pad_to(as_operand(x, torch.bfloat16, torch.device("cpu")), mm,
                     shape.bk) for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c), shape.bm, shape.bn)
    sc = ft.scalar_operand(InjectionSpec(enabled=True, every=3),
                           (9500.0,) * 3)
    got = ft.run_kernel(kind, shape, ab, bb, cp,
                        ft.kernel_inputs(kind, ab, bb, shape), ALPHA, BETA,
                        sc, ce, mf)
    vpu = {"fused": "running", "rowcol_mxu": "rowcol",
           "global_mxu": "global"}[kind]
    want = ft.run_kernel(vpu, shape, ab, bb, cp, (), ALPHA, BETA, sc, ce, mf)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[1].sum()) > 0
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("n_moments", [1, 2, 3])
def test_bf16_tile_moments_bit_for_bit(n_moments):
    # The wrapper's bf16 rows are the JAX package's: _tile_moments and the
    # tail rows of _augment_tiles (the rows its mxu kernels multiply), bit
    # for bit, on operands whose moments are exact f32 sums (so that no sum
    # order decides a bit) and which still need all three terms; and on the
    # program's data the three terms add up to JAX's to f32 rounding
    # (tests/test_torch_ft_mxu.py::test_tile_moments_match_jax).
    from ft_sgemm_tpu.ops.ft_sgemm import _augment_tiles, _tile_moments

    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    # bf16 values m 2^e (|m| <= 15) whose moments over 128 rows stay under
    # 2^24 (the w, w^2 weights sum to ~2^13, ~2^19.4: fewer binades for
    # more moments) and exceed 2^16, so every partial sum is exact and the
    # moments need all three bf16 terms.
    binades = {1: 12, 2: 6, 3: 0}[n_moments]
    exact = (rng.integers(-15, 16, (256, 384))
             * 2.0 ** rng.integers(0, binades + 1, (256, 384))
             ).astype(np.float32)
    for a, bitwise in ((exact, True),
                       (_inputs(256, 8, 384, seed=5)[0], False)):
        aj = jnp.asarray(a).astype(jnp.bfloat16)
        want = np.asarray(_tile_moments(aj, 128, n_moments).astype(
            jnp.float32))
        aug = np.asarray(_augment_tiles(aj, 128, 3 * n_moments + 5,
                                        n_moments).astype(jnp.float32))
        got = ft._tile_moments(torch.from_numpy(a).to(torch.bfloat16), 128,
                               n_moments)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert got.shape == want.shape == (2, 3 * n_moments, 384)
        tail = aug.reshape(2, 128 + 3 * n_moments + 5, 384)[:, 128:]
        np.testing.assert_array_equal(tail[:, :3 * n_moments], want)
        assert (tail[:, 3 * n_moments:] == 0).all()
        if bitwise:
            np.testing.assert_array_equal(got, want)
            assert (got[:, 2 * n_moments:] != 0).any()  # lo2 is needed
            continue
        for v in range(n_moments):
            total = got[:, v] + got[:, n_moments + v] + got[:, 2 * n_moments + v]
            ref = (want[:, v] + want[:, n_moments + v]
                   + want[:, 2 * n_moments + v])
            assert np.abs(total - ref).max() <= 1e-5 * np.abs(ref).max()


def _bf16_rows(m, k, bm, n_moments, seed):
    a, _, _ = _inputs(m, 8, k, seed=seed)
    ap = pad_to(torch.from_numpy(a).to(torch.bfloat16), bm, 8)
    return ap, ft._tile_moments(ap, bm, n_moments)


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
@pytest.mark.parametrize("kernel,mom", [("fused", 3), ("rowcol_mxu", 1),
                                        ("rowcol_mxu_mf", 2)])
def test_term_boxes_land_where_the_checks_read(sub, kernel, mom):
    # A's three term boxes of a bf16 stage (64 columns) of B6 or B7: box t
    # puts term t of moment v of row band b at row MOM b + v of term buffer
    # t, where WeightedCheck (cm.e[3 b + v]) and RowcolSplitCheck (cm.e[MOM b
    # + v]) read E; the rows from MOM NBM to R stay zero; past K (a ragged
    # last stage) and past the last band the boxes read zero. E = B . M^T
    # summed over the three terms is B times band b's f32 moment v.
    sbm, _ = sub
    nbm = 128 // sbm
    n_moments = 3 if kernel == "fused" else 2
    r = tf32x3.moment_rows(sbm, mom)
    k = 2 * tf32x3.BF16_STAGE + 24
    ap, ma = _bf16_rows(2 * 128 + 16, k, sbm, n_moments, seed=6)
    gm = ma.shape[0]
    for ti0 in range(0, gm, nbm):
        for k0 in range(0, k, tf32x3.BF16_STAGE):
            boxes = tf32x3.loaded_term_rows(ma, n_moments, ti0, nbm, mom, r,
                                            k0)
            assert boxes.shape == (3, r, tf32x3.BF16_STAGE)
            for t in range(3):
                for b in range(nbm):
                    for v in range(mom):
                        want = torch.zeros(tf32x3.BF16_STAGE,
                                           dtype=torch.bfloat16)
                        if ti0 + b < gm:
                            cols = ma[ti0 + b, n_moments * t + v,
                                      k0:k0 + tf32x3.BF16_STAGE]
                            want[:cols.shape[0]] = cols
                        assert torch.equal(boxes[t, mom * b + v], want)
                assert (boxes[t, mom * nbm:] == 0).all()
    b_tile = torch.from_numpy(_inputs(8, 128, k, seed=7)[1]).to(
        torch.bfloat16).float()[:, :tf32x3.BF16_STAGE]
    boxes = tf32x3.loaded_term_rows(ma, n_moments, 0, nbm, mom, r, 0).float()
    e = sum(b_tile @ boxes[t].T for t in range(3))
    w = torch.arange(1, sbm + 1, dtype=torch.float32)
    for b in range(nbm):
        band = ap[b * sbm:(b + 1) * sbm, :tf32x3.BF16_STAGE].float()
        for v in range(mom):
            s_a = (band * (w[:, None] ** v)).sum(0)
            assert torch.allclose(e[:, mom * b + v], b_tile @ s_a, rtol=1e-4,
                                  atol=1e-2)


@pytest.mark.parametrize("sub", SUBTILES, ids=[f"{m}x{n}" for m, n in SUBTILES])
def test_band_term_boxes_fill_b_stage_rows(sub):
    # B's three term boxes of a bf16 stage of B7 or B8: term t of band tj0
    # + j lands as row 8 t + j of the 24 rows after B's 128 (B's stage row
    # 128 + 8 t + j, where B3's and B4's splitter warps write their band
    # sums), zero for j >= NBN and past K; the product's extra columns 128 +
    # 8 t + j, added over t (WgMainloop::xcol), are each row's expected sum
    # over band j. Each box starts on a 1024-byte swizzle atom: rows 128 +
    # 8 t of a 128-byte-row buffer.
    _, sbn = sub
    nbn = 128 // sbn
    k = tf32x3.BF16_STAGE + 40
    bp, mb = _bf16_rows(3 * 128 + 40, k, sbn, 1, seed=3)
    gn = mb.shape[0]
    for t in range(3):
        assert (128 + 8 * t) * 128 % 1024 == 0
    for tj0 in range(0, gn, nbn):
        for k0 in range(0, k, tf32x3.BF16_STAGE):
            boxes = tf32x3.loaded_term_rows(mb, 1, tj0, nbn, 1, 8, k0)
            rows = boxes.reshape(24, tf32x3.BF16_STAGE)
            for t in range(3):
                for j in range(8):
                    want = torch.zeros(tf32x3.BF16_STAGE, dtype=torch.bfloat16)
                    if j < nbn and tj0 + j < gn:
                        cols = mb[tj0 + j, t, k0:k0 + tf32x3.BF16_STAGE]
                        want[:cols.shape[0]] = cols
                    assert torch.equal(rows[8 * t + j], want), (tj0, k0, t, j)
    a = torch.from_numpy(_inputs(16, 8, k, seed=4)[0]).to(
        torch.bfloat16).float()[:, :tf32x3.BF16_STAGE]
    rows = tf32x3.loaded_term_rows(mb, 1, 0, nbn, 1, 8, 0).float()
    exp_r = sum(a @ rows[t].T for t in range(3))
    for j in range(nbn):
        band = bp[j * sbn:(j + 1) * sbn, :tf32x3.BF16_STAGE].float()
        assert torch.allclose(exp_r[:, j], a @ band.sum(0), rtol=1e-5,
                              atol=1e-3)
    assert (exp_r[:, nbn:] == 0).all()


class _FakeLibrary:
    """A loaded library whose entry points record their names."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, fname):
        return types.SimpleNamespace(library=self.name, fname=fname)


def test_bf16_builds_bind_every_kind(monkeypatch):
    # The static bf16 builds of B2-B8 (bf16, and fp8 widened) come from
    # libraries of their own, built together and apart from the f32 ones:
    # each kind's `*_bf16` entry point with the f32 entry point's argument
    # types, from a library that compiles the kind's source with FTSG_BF16
    # (and, for the heaviest, FTSG_KERNEL naming that kernel alone).
    built = []
    monkeypatch.setattr(ft, "build", lambda names: built.append(tuple(names)))
    monkeypatch.setattr(ft, "library", _FakeLibrary)
    f32 = ft._entries.__wrapped__(False)
    entries = ft._bf16_entries.__wrapped__(False)
    assert built[-1] == tuple(dict.fromkeys(ft.BF16_LIBS.values()))
    assert set(built[-1]).isdisjoint(built[0])
    kinds = ("precomp", "running", "rowcol", "global", "global_mxu", "fused",
             "rowcol_mxu")
    assert sorted(entries) == sorted((k, torch.bfloat16) for k in kinds)
    source = {"precomp": ("ft_sgemm_weighted", 2),
              "running": ("ft_sgemm_weighted", 5),
              "rowcol": ("ft_sgemm_rowcol", None),
              "global": ("ft_sgemm_global", None),
              "global_mxu": ("ft_sgemm_global", None),
              "fused": ("ft_sgemm_aug", 6), "rowcol_mxu": ("ft_sgemm_aug", 7)}
    for (kind, _), fn in entries.items():
        assert fn.fname == f32[kind].fname + "_bf16"
        assert fn.argtypes == f32[kind].argtypes
        assert fn.restype is ctypes.c_int
        src, defines = _build.LIBRARIES[fn.library]
        assert src == source[kind][0] and "-DFTSG_BF16=1" in defines
        assert "-DFTSG_ADAPTIVE=1" not in defines
        only = source[kind][1]
        assert (f"-DFTSG_KERNEL={only}" in defines if only
                else not any("FTSG_KERNEL" in d for d in defines))


@pytest.mark.parametrize("kernel", ["fused", "rowcol_mxu", "global_mxu"])
@pytest.mark.parametrize("operands,rows", [
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("float8_e4m3fn", "float32")])
def test_moment_rows_take_the_operands_dtype(kernel, operands, rows):
    # Each mxu wrapper holds its moment rows to A's dtype (a kernel reads
    # them as its own element type: f32 rows of the bf16 shape would be
    # read as bf16, bf16 rows of the f32 shape past their end), and refuses
    # operands that carry no moment rows (fp8), before any launch.
    shape = SHAPES["medium"]
    m = n = k = 64
    dtype = getattr(torch, operands)
    a, b = (torch.zeros((x, k)).to(dtype) for x in (m, n))
    c = torch.zeros((m, n))
    t = 3 if dtype == torch.bfloat16 else 1
    n_a = {"fused": 3, "rowcol_mxu": 2, "global_mxu": 1}[kernel]
    ma = torch.zeros((m // shape.bm, t * n_a, k), dtype=getattr(torch, rows))
    mb = torch.zeros((n // shape.bn, t, k), dtype=getattr(torch, rows))
    sc = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="moment rows"):
        if kernel == "fused":
            ft.ft_fused_kernel(a, b, c, ma, shape, ALPHA, BETA, sc, 1)
        elif kernel == "rowcol_mxu":
            ft.ft_rowcol_mxu_kernel(a, b, c, ma, mb, shape, ALPHA, BETA, sc,
                                    1, False)
        else:
            ft.ft_global_mxu_kernel(a, b, c, ma, mb, shape, ALPHA, BETA, sc,
                                    1)

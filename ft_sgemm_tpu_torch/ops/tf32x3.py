"""3xTF32 on the CPU: the arithmetic of the wgmma kernels.

Every kernel, B1-B8, at every tile runs ``csrc/gemm_wgmma.cuh``, which
computes the FP32 product on the tensor cores: each operand is split into
two TF32 numbers, ``x = hi + lo``, and every 8-deep k step adds ``a_lo
b_hi``, ``a_hi b_lo`` and ``a_hi b_hi`` into a stage sum that is added to
the f32 accumulator once per 32-column stage (or at a fault, before the
fault; or at a check, before the check). B3 and B5-B7 form their expected
column sums the same way, ``E = B . M^T`` from the split moment rows, and
B3, B4, B7 and B8 their expected row sums as 8 more columns of the product,
A times B's column-band sums (summed from the split B in the kernel for B3
and B4, the wrapper's f32 band rows for B7 and B8).
The helpers here repeat that arithmetic in PyTorch so that the CPU tests
can hold it against the JAX package, and mirror the fragment maps: the
accumulator's, its sub-tiles' (B3-B6 check the paper's tile as a sub-tile
of one 128 x 128 CTA), the expected-moment product's and the row sums'.
Nothing on the main path calls them: the kernels' plain versions stay FP32
(``ops/sgemm.sgemm_plain``, ``ops/ft_sgemm.ft_weighted_plain`` and the
others), since 3xTF32 is how the kernel computes the FP32 function, not
another function. Under the f32 precision "default" the kernels run the
one-product form, ``a_hi b_hi`` alone (``one_pass``): that is another
function, and the plain versions then round both operands of every
product to TF32 (``ops/common.LaunchAxes``).
"""

from __future__ import annotations

import torch

from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import EPS8, pad_to, strict_fp32, tf32_rna

KK = 8       # K depth of one tf32 wgmma
STAGE = 32   # K columns per pipeline stage (gemm_wgmma.cuh WgTile::SK)
BF16_STAGE = 64  # the same in bf16: one 128-byte swizzle row of bf16
CTA = 128    # rows and columns of the sub-tiled kernels' CTA


def split(x: torch.Tensor):
    """The 3xTF32 split ``(hi, lo)``: ``hi = rna(x)``, ``lo = rna(x - hi)``
    (``gemm_wgmma.cuh::split_tf32``)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _fault_steps(scalars, nk: int) -> set:
    """The bk steps that ``_inject_plain`` puts a fault before."""
    every = max(int(scalars[1]), 1)
    return {k for k in range(nk) if scalars[0] > 0.0 and k % every == 0}


def _tile_product(a4, b4, acc, cps: int, on_fault=None, faults=(),
                  one_pass: bool = False):
    """acc (gm, gn, bm, bn) += the 3xTF32 product of A (gm, bm, K) and
    B (gn, bn, K) as the wgmma mainloop sums it: per 8-column k step t
    three products into the stage sum ``part``, ``part`` into ``acc`` at
    every 32-column stage end and, when t starts a bk step (``cps`` k steps
    each) in ``faults``, before ``on_fault(acc, k)``. ``one_pass`` (the f32
    precision "default"): the one-product form, ``a_hi b_hi`` alone, with
    ``hi`` rounded as the splitter rounds it."""
    (ah, al), (bh, bl) = split(a4), split(b4)
    terms = ((ah, bh),) if one_pass else ((al, bh), (ah, bl), (ah, bh))
    nk8 = a4.shape[-1] // KK
    part = torch.zeros_like(acc)
    for t in range(nk8):
        if t % cps == 0 and t // cps in faults:
            acc += part
            part.zero_()
            on_fault(acc, t // cps)
        cols = slice(t * KK, (t + 1) * KK)
        for x, y in terms:
            part += torch.einsum("imk,jnk->ijmn", x[..., cols], y[..., cols])
        if (t + 1) % (STAGE // KK) == 0 or t == nk8 - 1:
            acc += part
            part.zero_()
    return acc


def sgemm_tf32x3(a, b, c, alpha: float, beta: float,
                 one_pass: bool = False) -> torch.Tensor:
    """``alpha * a @ b.T + beta * c`` as B1 computes it, on either CTA at
    every tile (one tile spans the whole output: the sum does not depend on
    tiling); ``one_pass``: one TF32 product a k step (precision
    "default")."""
    strict_fp32()
    ap, bp = pad_to(a, 1, KK), pad_to(b, 1, KK)
    acc = torch.zeros((1, 1) + tuple(c.shape), device=c.device)
    _tile_product(ap[None], bp[None], acc, 1, one_pass=one_pass)
    return alpha * acc[0, 0] + beta * c


def ft_weighted_tf32x3(a, b, c, shape, alpha, beta, scalars, expm):
    """B2 on padded operands: the 3xTF32 tile product with the faults of
    ``scalars`` in place, then ``_moment_detect_correct`` against ``expm``
    (gm, 3, N) and the epilogue. Returns (out, det, unc) like
    ``ops/ft_sgemm.ft_weighted_plain``. The same on both of B2's CTAs: an
    element's sum does not depend on the CTA, and every tile's faults fall
    on the same k steps, so the stage sums are promoted at the same
    places."""
    strict_fp32()
    a4, b4, c4, nk = ft._tiles(a, b, c, shape)
    gm, gn, bm, bn = c4.shape
    acc = torch.zeros_like(c4)
    _tile_product(a4.reshape(gm, bm, -1), b4.reshape(gn, bn, -1), acc,
                  shape.bk // KK,
                  lambda t, k: ft._inject_plain(t, scalars, k),
                  _fault_steps(scalars, nk))
    exps = expm.reshape(gm, 3, gn, bn).unbind(1)
    acc, hits, bad = ft._moment_detect_correct(
        acc, *exps, [float(t) for t in scalars[4:7]])
    return (ft._untile(alpha * acc + beta * c4), hits.to(torch.int32),
            bad.to(torch.int32))


def wgmma_fragment_map(bm: int, bn: int) -> torch.Tensor:
    """(bm // 64 * 128, bn // 2, 2): the tile (row, column) of accumulator
    element i of consumer thread t (``WgMainloop::row`` / ``col``): thread
    t is lane l of warp w of warpgroup g, and holds row 64g + 16w + l/4 +
    8 ((i/2) % 2), column 8 (i/4) + 2 (l % 4) + i % 2."""
    t = torch.arange(bm // 64 * 128)[:, None]
    i = torch.arange(bn // 2)[None, :]
    g, w, l = t // 128, t // 32 % 4, t % 32
    row = 64 * g + 16 * w + l // 4 + 8 * (i // 2 % 2)
    col = 8 * (i // 4) + 2 * (l % 4) + i % 2
    return torch.stack(torch.broadcast_tensors(row, col), -1)


def lane_tree(x: torch.Tensor) -> torch.Tensor:
    """The total over the last dim (G lanes, a power of two) as the kernels'
    lane rounds add it (``gemm_wgmma.cuh::lane_rounds`` and the shuffle
    loops of ``WgSmem::sum_rows``): lane u and lane u + G / 2 first, then
    the halves' totals likewise, in f32."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def moment_rows_b5(ap: torch.Tensor, sbm: int) -> torch.Tensor:
    """(gm, 3, K): B5's moment rows of each (sbm, K) row tile of a padded A
    (f32; bf16 as exact f32 values) in the order B5's splitter warps sum them
    (``WgSmem::sum_rows``, ``sum_rows_bf16``): G lanes a column (8 at sbm =
    128, else 1: ``WgSmem::ROW_LANES``), lane u adding rows u, u + G, .. in
    order, the moments w and
    w^2 as ``fmaf(w, x, s)`` and ``fmaf(w * w, x, s)`` (w = row + 1; here
    in float64, rounded once to f32: the fused result but where that double
    rounding differs, rare and below f32's own rounding), then the lanes'
    sums by :func:`lane_tree`."""
    m, kdim = ap.shape
    g = 8 if sbm == 128 else 1
    n = sbm // g
    x = ap.float().reshape(m // sbm, n, g, kdim)  # row u + g i at [i, u]
    w = torch.arange(1, sbm + 1, dtype=torch.float32).reshape(n, g)
    sums = [torch.zeros((m // sbm, g, kdim)) for _ in range(3)]
    for i in range(n):
        xi = x[:, i]
        wi = w[i][None, :, None]
        sums[0] = sums[0] + xi
        sums[1] = (wi.double() * xi.double() + sums[1].double()).float()
        sums[2] = ((wi * wi).double() * xi.double()
                   + sums[2].double()).float()
    return torch.stack([lane_tree(v.transpose(1, 2)) for v in sums], 1)


def band_sums_b4(bv: torch.Tensor, sbn: int) -> torch.Tensor:
    """(gn, K): B4's column-band sums of B's values bv (gn, sbn, K) in the
    order its splitter warps add them (``WgSmem::split_bands``,
    ``band_sums_bf16``): G = sbn / 4 lanes a column
    (``WgSmem::BAND_LANES``), lane u adding rows u, u + G, u + 2 G, u + 3 G
    in order, then the lanes' sums by :func:`lane_tree`."""
    gn, _, kdim = bv.shape
    g = sbn // 4
    x = bv.reshape(gn, sbn // g, g, kdim)
    s = torch.zeros((gn, g, kdim))
    for i in range(sbn // g):
        s = s + x[:, i]
    return lane_tree(s.transpose(1, 2))


def _subtile_tf32x3(a, b, c, shape, alpha, beta, scalars, check_every: int,
                    check, moments=None, band_sums=False, band_rows=None,
                    deferred=False, fold=False):
    """The sub-tiled wgmma kernel (``csrc/ft_sgemm_running.cuh``) on padded
    operands: per 8-column k step the 3xTF32 product into the stage sum
    and, beside it, the 3xTF32 expected column sums ``B_tile . M^T`` of the
    (gm, MOM, K) moment rows ``moments`` (B3, B5-B7) and the expected row
    sums ``A . s_b`` of B's column-band sums ``s_b`` (the product's extra
    columns): summed from the split B (B3, B4; ``band_sums``) or the
    wrapper's (gn, 1, K) f32 band rows ``band_rows`` (B7, B8), all promoted
    at every 32-column stage
    end, before a fault (``_inject_plain`` at the first k step of its bk
    step) and before a check (after the last k step of every
    ``check_every``-th bk step and of the last, also inside a stage).
    ``check(acc, exp, r_exp)`` with exp (gm, gn, MOM, bn) and r_exp (gm,
    gn, bm) returns (corrected acc, per-tile hits, per-tile uncorrectable
    level). ``deferred`` (B3, B7: ``RowcolSplitCheck``): a fault is added
    into ``acc`` at the stage end that promotes its stage, or before a
    check's snapshot if that comes first, and ``check`` returns the
    correction instead of the corrected acc, added before the next
    check's snapshot (after that check's faults) or before the output.
    ``fold`` (B4, B5): the faults go in at stage ends and before checks as
    with ``deferred``, the checks' corrections at once. ``band_sums`` is
    True (B3: the kernel's 8-row sums, modelled by a plain sum) or "lanes"
    (B4: :func:`band_sums_b4`). Returns (out, det, unc) like
    ``ops/ft_sgemm.ft_weighted_plain``."""
    strict_fp32()
    a4, b4, c4, nk = ft._tiles(a, b, c, shape)
    gm, gn, bm, bn = c4.shape
    (ah, al), (bh, bl) = split(a4.reshape(gm, bm, -1)), split(b4.reshape(gn, bn, -1))
    cps, nk8 = shape.bk // KK, a.shape[1] // KK
    faults = _fault_steps(scalars, nk)
    acc, part = torch.zeros_like(c4), torch.zeros_like(c4)
    sums = [(acc, part)]
    exp = r_exp = None
    if moments is not None:
        mh, ml = split(moments)
        exp = torch.zeros((gm, gn, moments.shape[1], bn), device=a.device)
        part_e = torch.zeros_like(exp)
        sums.append((exp, part_e))
    if band_sums or band_rows is not None:
        # B3: the splitter warps sum the split B (hi + lo, what the
        # product multiplies) over each column band, then split the sums;
        # B4: B's f32 values (band_sums_b4); B7, B8: they split the loaded
        # f32 band rows.
        sh, sl = split(band_rows[:, 0] if band_rows is not None
                       else band_sums_b4(b4.reshape(gn, bn, -1), shape.bn)
                       if band_sums == "lanes" else (bh + bl).sum(1))
        r_exp = torch.zeros((gm, gn, bm), device=a.device)
        part_r = torch.zeros_like(r_exp)
        sums.append((r_exp, part_r))
    det = torch.zeros((gm, gn), dtype=torch.int32, device=a.device)
    unc = torch.zeros_like(det)

    def promote():
        for total, stage in sums:
            total.add_(stage)
            stage.zero_()

    kk_stage = STAGE // KK
    pending, delta = [], None

    def fold_pending():
        # The deferred faults, in their order, into acc.
        for f in pending:
            ft._inject_plain(acc, scalars, f)
        pending.clear()

    for t in range(nk8):
        if t % cps == 0 and t // cps in faults:
            if deferred or fold:
                pending.append(t // cps)
            else:
                promote()
                ft._inject_plain(acc, scalars, t // cps)
        cols = slice(t * KK, (t + 1) * KK)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part += torch.einsum("imk,jnk->ijmn", x[..., cols], y[..., cols])
        if moments is not None:
            for x, y in ((bl, mh), (bh, ml), (bh, mh)):
                part_e += torch.einsum("jnk,ivk->ijvn", x[..., cols], y[..., cols])
        if r_exp is not None:
            for x, y in ((al, sh), (ah, sl), (ah, sh)):
                part_r += torch.einsum("imk,jk->ijm", x[..., cols], y[..., cols])
        s = (t + 1) // cps - 1   # the bk step that k step t ends, if any
        if (t + 1) % cps == 0 and ((s + 1) % check_every == 0 or s == nk - 1):
            promote()
            if deferred or fold:
                fold_pending()
            if deferred:
                if delta is not None:
                    acc += delta
                delta, hits, level = check(acc, exp, r_exp)
            else:
                corrected, hits, level = check(acc, exp, r_exp)
                acc.copy_(corrected)
            det += hits.to(torch.int32)
            unc = level.to(torch.int32)
        if (t + 1) % kk_stage == 0 or t == nk8 - 1:
            promote()
            if deferred or fold:
                fold_pending()
    if delta is not None:
        acc += delta
    return ft._untile(alpha * acc + beta * c4), det, unc


def ft_running_tf32x3(a, b, c, shape, alpha, beta, scalars, check_every: int,
                      moments=None):
    """B5 (``moments`` None: A's moment sums of each tile, formed in the
    kernel, :func:`moment_rows_b5`, its faults folded at stage ends) and B6
    (``moments``: A's (gm, 3, K) moment rows, its faults added at once) as
    the wgmma kernel computes them (:func:`_subtile_tf32x3`); each check is
    ``_moment_detect_correct``. Returns (out, det, unc) like
    ``ops/ft_sgemm.ft_weighted_plain``."""
    b5 = moments is None
    if b5:
        moments = moment_rows_b5(a, shape.bm)
    thresholds = [float(t) for t in scalars[4:7]]
    return _subtile_tf32x3(
        a, b, c, shape, alpha, beta, scalars, check_every,
        lambda acc, exp, _: ft._moment_detect_correct(acc, *exp.unbind(2),
                                                      thresholds),
        moments=moments, fold=b5)


def rowcol_split_decide(res_r, res_c, res_cw, thresholds, multifault: bool,
                        exact: bool = False):
    """The split-phase rowcol check's decisions as the kernels form them
    (``csrc/ft_sgemm_running.cuh``: ``RowcolChecker::decide`` and
    ``RowcolSplitCheck::apply``), over (gm, gn) tiles of residuals: the row
    and column flags, each flagged column's code (its weighted row with
    ``multifault``, -1 outside the tile), the mode of each tile (0 nothing
    to correct, 1 the row residuals, 2 the column residuals: one flagged
    row and several flagged columns, 3 ambiguous: the weighted rows), the
    correction each element takes from those, and the re-check as a LEVEL
    from the residuals less the corrections' row and column sums, formed
    from the decisions (the sums of the flagged columns' and rows'
    residuals) and not from the corrected accumulator. ``exact``: wrapped
    int32 residuals held as int64, as ``_rowcol_detect_correct(exact=
    True)``. Returns (correction, per-tile hits, per-tile uncorrectable),
    as ``ops/ft_sgemm._rowcol_decide``."""
    thr, thr_m1 = thresholds[:2]
    bm, bn = res_r.shape[-1], res_c.shape[-1]
    mag = ft._mag32 if exact else torch.abs
    zero = torch.zeros((), dtype=res_r.dtype)
    rflag, cflag = mag(res_r) > thr, mag(res_c) > thr
    nr, nc = rflag.sum(-1), cflag.sum(-1)
    if multifault:
        safe = torch.where(cflag, res_c, torch.ones_like(res_c))
        lr = torch.round(res_cw / safe).to(torch.int64)
        code = torch.where((lr < 1) | (lr > bm), -1, lr - 1)
        code = torch.where(cflag, code, -2)
    else:
        code = torch.where(cflag, 0, -2)
    use_col = (nr == 1) & (nc > 1)
    amb = multifault & (nr > 1) & (nc > 1)
    mode = torch.where(amb, 3, torch.where((nr > 0) & (nc > 0),
                                           torch.where(use_col, 2, 1), 0))
    hits = torch.where(amb, (code >= 0).sum(-1), nr * nc)
    rows = torch.arange(bm)
    m4 = mode[..., None, None]
    hit_amb = code[..., None, :] == rows[:, None]
    hit_rc = rflag[..., :, None] & (code != -2)[..., None, :]
    val = torch.where(m4 == 2, res_c[..., None, :], res_r[..., :, None])
    delta = torch.where(m4 == 3, torch.where(hit_amb, res_c[..., None, :], zero),
                        torch.where((m4 != 0) & hit_rc, val, zero))
    if exact:
        delta = ft.wrap_int32(delta)
    # The sums the re-check subtracts, per tile.
    w = torch.arange(1, bm + 1, dtype=torch.float32)
    fr = torch.where(rflag, res_r, zero)
    fc = torch.where(cflag, res_c, zero)
    sc, sr = fc.sum(-1), fr.sum(-1)
    rstar = torch.where(rflag, rows, -1).max(-1).values
    # Rows: a flagged row, or any row of an ambiguous tile.
    ds = torch.where(mode[..., None] == 3, torch.where(
        hit_amb, res_c[..., None, :], zero).sum(-1),
        torch.where(mode[..., None] == 2, sc[..., None],
                    torch.where(mode[..., None] == 1,
                                nc[..., None].to(res_r.dtype) * res_r, zero)))
    seen = (mode[..., None] == 3) | rflag
    # Columns: the corrections in a column, at most one but in mode 1.
    col = torch.where(mode[..., None] == 3, code >= 0,
                      (mode[..., None] != 0) & (code != -2))
    s0 = torch.where(col, torch.where(mode[..., None] == 1, sr[..., None],
                                      res_c), zero)
    if exact:
        bad_r = seen & (ft._mag32(ft.wrap_int32(res_r - ds)) > thr)
        bad_c = ft._mag32(ft.wrap_int32(res_c - s0)) > thr
        return delta, hits, bad_r.sum(-1) + bad_c.sum(-1)
    ads = torch.where(mode[..., None] == 3, torch.where(
        hit_amb, res_c[..., None, :].abs(), 0.0).sum(-1),
        torch.where(mode[..., None] == 2, fc.abs().sum(-1)[..., None],
                    torch.where(mode[..., None] == 1,
                                nc[..., None] * res_r.abs(), 0.0)))
    bad_r = seen & ((res_r - ds).abs() > thr + EPS8 * ads)
    s1 = torch.where(col, torch.where(mode[..., None] == 1,
                                      fr.abs().sum(-1)[..., None],
                                      res_c.abs()), 0.0)
    bad_c = (res_c - s0).abs() > thr + EPS8 * s1
    bad = bad_r.sum(-1) + bad_c.sum(-1)
    if multifault:
        wrow = torch.where(mode[..., None] == 3, code + 1,
                           rstar[..., None] + 1).to(torch.float32)
        s2 = torch.where(col, torch.where(
            mode[..., None] == 1, (w * fr).sum(-1)[..., None],
            wrow * res_c), 0.0)
        s3 = torch.where(col, torch.where(
            mode[..., None] == 1, (w * fr.abs()).sum(-1)[..., None],
            wrow * res_c.abs()), 0.0)
        bad = bad + (~bad_c & ((res_cw - s2).abs()
                               > thr_m1 + EPS8 * s3)).sum(-1)
    return delta, hits, bad


def ft_rowcol_tf32x3(a, b, c, shape, alpha, beta, scalars, check_every: int,
                     multifault: bool, rows=None):
    """B3 (``rows`` None) and B7 (``rows`` = A's (gm, 2, K) and B's (gn, 1,
    K) moment rows of ``ops/ft_sgemm.kernel_inputs``) as the wgmma kernel
    computes them (:func:`_subtile_tf32x3`): the expected column sums from
    A's plain (and, with ``multifault``, w) moment rows of each tile, summed
    in the kernel (B3) or the first one or two of the loaded rows (B7); the
    expected row sums from B's column-band sums, summed from the split B
    (B3) or the loaded rows (B7); each check is the checker's decisions
    (:func:`rowcol_split_decide`), its faults and corrections deferred to
    stage ends as the split-phase check defers them. Returns (out, det,
    unc) like ``ops/ft_sgemm.ft_rowcol_plain``."""
    w = ft._weights(shape.bm, a.device)[:, None]
    thresholds = [float(t) for t in scalars[4:6]]

    def check(acc, exp, r_exp):
        res_cw = exp[:, :, 1] - (acc * w).sum(-2) if multifault else None
        return rowcol_split_decide(
            r_exp - acc.sum(-1), exp[:, :, 0] - acc.sum(-2), res_cw,
            thresholds, multifault)

    mom = 2 if multifault else 1
    if rows is None:
        return _subtile_tf32x3(
            a, b, c, shape, alpha, beta, scalars, check_every, check,
            moments=ft._tile_moments(a, shape.bm, mom), band_sums=True,
            deferred=True)
    return _subtile_tf32x3(a, b, c, shape, alpha, beta, scalars, check_every,
                           check, moments=rows[0][:, :mom], band_rows=rows[1],
                           deferred=True)


def ft_global_tf32x3(a, b, c, shape, alpha, beta, scalars, check_every: int,
                     rows=None):
    """B4 (``rows`` None: its band sums :func:`band_sums_b4`, its faults
    folded at stage ends) and B8 (``rows`` = A's and B's (g, 1, K) moment
    rows; only B's are read; its faults added at once) as the wgmma kernel
    computes them (:func:`_subtile_tf32x3`): each tile's residual is the sum
    over its rows of (expected row sum - the row's accumulator sum), one
    event when it moved by more than the threshold since the previous
    check. Returns (out, det, unc) like ``ops/ft_sgemm.ft_global_plain``,
    unc equal to det."""
    thr = float(scalars[4])
    state = {}

    def check(acc, _, r_exp):
        res = (r_exp - acc.sum(-1)).sum(-1)
        prev = state.get("prev", torch.zeros_like(res))
        events = ((res - prev).abs() > thr).to(torch.int32)
        state["prev"] = res
        state["det"] = state.get("det", 0) + events
        return acc, events, state["det"]

    return _subtile_tf32x3(a, b, c, shape, alpha, beta, scalars, check_every,
                           check, band_sums="lanes" if rows is None else False,
                           band_rows=None if rows is None else rows[1],
                           fold=rows is None)


def row_sum_fragment_map(sbn: int) -> torch.Tensor:
    """(256, 4, 2): the (tile row, column band) of the expected row sum that
    B3's and B4's consumer thread t holds at extra accumulator element
    NACC + i (i < 4), the product's column 128 + j for band j; band -1 past
    the CTA's 128 / sbn bands (the zero rows of B's stage)."""
    rc = wgmma_fragment_map(CTA, CTA + KK)[:, CTA // 2:]
    band = rc[..., 1] - CTA
    return torch.stack((rc[..., 0], torch.where(band < CTA // sbn, band, -1)),
                       -1)


def subtile_fragment_map(sbm: int, sbn: int) -> torch.Tensor:
    """(256, 64, 4): for accumulator element i of consumer thread t of B5's
    and B6's 128 x 128 CTA, its sub-tile (row band, column band) and its
    row and column inside that (sbm, sbn) sub-tile; the check's weight is
    the row inside the sub-tile + 1 (``RunHook::check``)."""
    rc = wgmma_fragment_map(CTA, CTA)
    row, col = rc[..., 0], rc[..., 1]
    return torch.stack((row // sbm, col // sbn, row % sbm, col % sbn), -1)


def moment_rows(sbm: int, mom: int = 3) -> int:
    """R, the moment rows of the sub-tiled CTA: ``mom`` per sub-tile row
    band (B5 and B6: 3; B3: 1, or 2 with multifault), padded to a multiple
    of 8 (``WgTile::R``)."""
    return -(-mom * CTA // sbm // 8) * 8


def loaded_rows(rows: torch.Tensor, g0: int, n_groups: int, per_group: int,
                pad: int, k0: int = 0, stage: int = STAGE) -> torch.Tensor:
    """(pad, stage): the rows that one stage's TMA box of the wrapper's
    (g, P, K) checksum rows lands in shared memory (``WgSmem::produce``),
    with the padding rows the splitter warps zero (``WgSmem::zero_pads``):
    row ``per_group * b + v`` holds row v of group g0 + b at K columns k0
    .. k0 + stage, zero past the last group and past K (TMA's fill), and
    the rows from ``n_groups * per_group`` on are zero. B7 and B8 take B's
    band rows (per_group 1, n_groups NBN) as B's stage rows 128 .. 135;
    B6 and B7 A's moment rows (per_group MOM, padded to R)."""
    out = torch.zeros((pad, stage), dtype=rows.dtype)
    for b in range(min(n_groups, rows.shape[0] - g0)):
        for v in range(per_group):
            cols = rows[g0 + b, v, k0:k0 + stage]
            out[per_group * b + v, :cols.shape[0]] = cols
    return out


def loaded_term_rows(rows: torch.Tensor, n_moments: int, g0: int,
                     n_groups: int, per_group: int, pad: int,
                     k0: int = 0) -> torch.Tensor:
    """(3, pad, BF16_STAGE): the three TMA boxes, one per term, that a bf16
    stage of B6-B8 loads from the wrapper's (g, 3 n_moments, K) bf16 rows
    (``_tile_moments``: term t of moment v at row ``n_moments t + v``), with
    the padding rows the CTA zeroes (``WgSmem::init``): box t is
    :func:`loaded_rows` of term t's rows, the first ``per_group`` of its
    ``n_moments`` per group. A's boxes land in term buffer t (``mw(s,
    t)``) as rows ``per_group b + v``, which B5's splitter warps fill in
    B5; B's (``n_moments`` 1, ``per_group`` 1, ``pad`` 8) as B's stage rows
    BN + 8 t .. BN + 8 t + 7, where B3's and B4's splitter warps write
    their band sums."""
    g, r, kdim = rows.shape
    terms = rows.reshape(g, r // n_moments, n_moments, kdim)
    return torch.stack([loaded_rows(terms[:, t], g0, n_groups, per_group,
                                    pad, k0, BF16_STAGE) for t in range(3)])


def moment_fragment_map(r: int) -> torch.Tensor:
    """(256, r // 2, 2): the (B row, moment row) of element i of consumer
    thread t's expected-moment accumulator, E = B_tile . M^T, the m64nRk8
    product whose 64 rows are warpgroup g's rows 64 g .. of B's stage: the
    accumulator's map with B's row for the tile row and the moment row for
    the column; the check writes it transposed into shared memory."""
    t = torch.arange(2 * 128)[:, None]
    i = torch.arange(r // 2)[None, :]
    g, w, l = t // 128, t // 32 % 4, t % 32
    n = 64 * g + 16 * w + l // 4 + 8 * (i // 2 % 2)
    m = 8 * (i // 4) + 2 * (l % 4) + i % 2
    return torch.stack(torch.broadcast_tensors(n, m), -1)

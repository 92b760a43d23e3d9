"""The fused epilogue in the kernels' store, on the card (marker ``cuda``;
skipped without a CUDA device). No JAX here: ``ops/common.apply_epilogue``,
which the CPU tests hold to the JAX package (``tests/test_torch_epilogue.py``),
is the reference.

- Grid bracket: with alpha = 0, beta = 1 and A = B = 0 a kernel's output is
  C, so a C that carries every e4m3 value, the midpoints between them,
  448-1e4, the .5 ties, ±127.5, ±inf and NaN must come out as ``to_e4m3``
  of C (qfp8) and the int8 clamp of C (qint8 at scales 1 and 0.25) element
  by element, for B1 and one FT build of each source (B3 also in int8).
- Each source's kernels at small ragged sizes with faults: the output with
  an epilogue equals the same kernel's identity output through
  ``apply_epilogue`` (``epilogue_violations``: element by element, the GELU
  within ``GELU_TOLERANCE_ULPS`` ulps of its input's magnitude), the grids
  are the identity's, and each such launch counts in ``epilogue_launches``.
- A CUDA tensor launches the kernel or raises: a bias row of the wrong
  width is refused, never applied by torch.

    python -m pytest tests/test_torch_epilogue_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from ft_sgemm_tpu_torch import SHAPES, EpilogueSpec
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import sgemm as sg
from ft_sgemm_tpu_torch.ops.common import (
    align_rows16,
    apply_epilogue,
    as_operand,
    pad_bias,
    pad_to,
    scalar_operand,
)
from ft_sgemm_tpu_torch.ops.reference import epilogue_violations
from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix

ALPHA, BETA = 1.0, -1.5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "fp8": torch.float8_e4m3fn, "int8": torch.int8}
SPELLINGS = ["bias+gelu+qint8x0.25", "bias+relu+qfp8", "bias", "gelu",
             "qint8"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def _bracket_c(quant, m, n):
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0])
    if quant == "fp8":
        codes = torch.arange(256, dtype=torch.uint8).view(
            torch.float8_e4m3fn).float()
        grid = torch.unique(codes[torch.isfinite(codes)])
        big = torch.cat([torch.linspace(448.0, 1e4, 97),
                         torch.tensor([463.99, 464.0, 464.01, 480.0])])
        vals = torch.cat([grid, (grid[1:] + grid[:-1]) / 2, big, -big,
                          special])
    else:
        ties = torch.arange(-130.5, 131.0, 1.0)
        vals = torch.cat([ties, ties * 4, torch.tensor([127.5, -127.5]),
                          special])
    reps = -(-m * n // vals.numel())
    return vals.repeat(reps)[: m * n].reshape(m, n).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,tile", [
    ("sgemm", "float32", "small"), ("sgemm", "bfloat16", "huge"),
    ("sgemm", "fp8", "large"), ("precomp", "float32", "huge"),
    ("rowcol", "float32", "medium"), ("rowcol", "int8", "small"),
    ("global", "float32", "wide"), ("fused", "float32", "tall")])
def test_quantize_grid_bracket(cuda_device, kind, dtype, tile):
    shape = SHAPES[tile]
    m = 256
    z = align_rows16(torch.zeros((m, 64), device=cuda_device).to(
        DTYPES[dtype]))
    sc = scalar_operand(InjectionSpec.none(), (9500.0,) * 3)
    extra = () if kind == "sgemm" else ft.kernel_inputs(kind, z, z, shape)
    for quant, spellings in (("fp8", ("qfp8",)),
                             ("int8", ("qint8", "qint8x0.25"))):
        c = _bracket_c(quant, m, m)
        cd = c.to(cuda_device)
        for spelling in ("none",) + spellings:
            epi = EpilogueSpec.parse(spelling)
            if kind == "sgemm":
                out = sg.sgemm_kernel(z, z, cd, shape, 0.0, 1.0, epi)
            else:
                out = ft.run_kernel(kind, shape, z, z, cd, extra, 0.0, 1.0,
                                    sc, 1, epi=epi)[0]
            torch.cuda.synchronize()
            assert _same(out, apply_epilogue(cd, epi)), spelling
            assert _same(out.cpu(), apply_epilogue(c, epi)), spelling


KINDS = [("sgemm", False), ("precomp", False), ("running", False),
         ("rowcol", True), ("global", False), ("fused", False),
         ("rowcol_mxu", False), ("global_mxu", False)]


def _operands(dtype, dims, shape, dev, seed):
    rng = np.random.default_rng(seed)
    m, n, k = dims
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((m, k), (n, k), (m, n)))
    if dtype == "int8":
        a, b = np.round(a * 10.0), np.round(b * 10.0)
    ap, bp = (align_rows16(pad_to(as_operand(x, DTYPES[dtype], dev), mm,
                                  shape.bk))
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(dev), shape.bm, shape.bn)
    bias = pad_bias(rng.standard_normal(n).astype(np.float32) * 2, n,
                    shape.bn, dev)
    return ap, bp, cp, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,multifault", KINDS,
                         ids=[k for k, _ in KINDS])
@pytest.mark.parametrize("name", ["small", "huge", "wide"])
def test_kernel_epilogue_is_identity_through_apply_epilogue(
        cuda_device, dtype, kind, multifault, name):
    if dtype == "int8" and kind not in ("rowcol", "global"):
        pytest.skip("int8 runs B3 and B4 only (the exact mode)")
    if dtype == "fp8" and kind in ("fused", "rowcol_mxu", "global_mxu"):
        pytest.skip("fp8 carries no moment rows (mxu encodes illegal)")
    shape = SHAPES[name]
    dims = (200, 136, 264)
    ap, bp, cp, bias = _operands(dtype, dims, shape, cuda_device, 3)
    mf = multifault and dtype != "int8"
    inj = InjectionSpec(enabled=True, every=2)
    sc = scalar_operand(inj, (9500.0,) * 3)
    wrapper = (sg.sgemm_kernel if kind == "sgemm" else
               {"precomp": ft.ft_weighted_kernel,
                "running": ft.ft_weighted_running_kernel,
                "rowcol": ft.ft_rowcol_kernel, "global": ft.ft_global_kernel,
                "fused": ft.ft_fused_kernel,
                "rowcol_mxu": ft.ft_rowcol_mxu_kernel,
                "global_mxu": ft.ft_global_mxu_kernel}[kind])

    def run(epi=None, row=None):
        if kind == "sgemm":
            return sg.sgemm_kernel(ap, bp, cp, shape, ALPHA, BETA, epi, row),
        extra = ft.kernel_inputs(kind, ap, bp, shape)
        return ft.run_kernel(kind, shape, ap, bp, cp, extra, ALPHA, BETA, sc,
                             3, mf, epi=epi, bias=row)

    ident = run()
    before = wrapper.epilogue_launches
    for spelling in SPELLINGS:
        epi = EpilogueSpec.parse(spelling)
        got = run(epi, bias if epi.bias else None)
        torch.cuda.synchronize()
        for g, i in zip(got[1:], ident[1:]):
            assert torch.equal(g, i), f"{spelling}: grids moved"
        bad = epilogue_violations(got[0], ident[0], epi, bias)
        assert int(bad.sum()) == 0, f"{spelling}: {int(bad.sum())} elements"
    assert wrapper.epilogue_launches - before == len(SPELLINGS)


@pytest.mark.cuda
def test_cuda_launch_refuses_a_wrong_bias_row(cuda_device):
    shape = SHAPES["huge"]
    ap, bp, cp, bias = _operands("float32", (128, 128, 64), shape,
                                 cuda_device, 4)
    with pytest.raises(ValueError, match="bias row"):
        sg.sgemm_kernel(ap, bp, cp, shape, ALPHA, BETA,
                        EpilogueSpec(bias=True), bias[:64])
    with pytest.raises(ValueError, match="bias row"):
        sg.sgemm_kernel(ap, bp, cp, shape, ALPHA, BETA,
                        EpilogueSpec(bias=True), None)
    with pytest.raises(ValueError, match="bias row"):
        ft.ft_global_kernel(ap, bp, cp, shape, ALPHA, BETA,
                            scalar_operand(InjectionSpec.none(), (9500.0,) * 3),
                            1, epi=EpilogueSpec(activation="relu"), bias=bias)

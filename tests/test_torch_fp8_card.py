"""B1-B5 in fp8 (B1's e4m3 build, B2-B5's bf16 builds on the widened
operands) against their plain versions on the card (marker
``cuda``; skipped without a CUDA device). No JAX here: the plain versions,
which the CPU tests hold to the JAX package (``tests/test_torch_fp8.py``,
``tests/test_torch_ft_fp8.py``), are the reference, and so is the CPU's
e4m3 rounding for the card's. Checks every 3 bk steps (inside a 32-deep
e4m3 k step at bk = 8 and 16) and faults every 5 on the program's ±0.9
data: grids equal, C within ``verify_matrix``'s rule (0.01 absolute AND
relative) on every tile reported correctable.

    python -m pytest tests/test_torch_fp8_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import common
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import sgemm as sg
from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix

ALPHA, BETA = 1.0, -1.5
F8 = torch.float8_e4m3fn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(shape, dev, seed=8):
    rng = np.random.default_rng(seed)
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((250, 264), (250, 264), (250, 250)))
    ap, bp = (align_rows16(pad_to(as_operand(x, F8, dev), mm, shape.bk))
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    return ap, bp, pad_to(torch.from_numpy(c).to(dev), shape.bm, shape.bn)


def _close(got, want, mask):
    diff = (got.double() - want.double()).abs()
    bad = mask & (diff > 0.01) & (diff > 0.01 * want.double().abs())
    return int(bad.sum()) == 0 and bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_e4m3_rounding_on_the_card_is_the_cpus(cuda_device):
    x = torch.linspace(-520.0, 520.0, 1 << 16)
    x = torch.cat([x, x / 1e3, torch.tensor([float("inf"), float("nan")])])
    got = common.to_e4m3(x.to(cuda_device)).float().cpu()
    want = common.to_e4m3(x).float()
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_fp8_b1_matches_plain_on_card(cuda_device, name):
    shape = SHAPES[name]
    a, b, c = _operands(shape, cuda_device)
    got = sg.sgemm_kernel(a, b, c, shape, ALPHA, BETA)
    want = sg.sgemm_plain(a, b, c, ALPHA, BETA)
    assert _close(got, want, torch.ones_like(got, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind,multifault", [("precomp", False),
                                             ("running", False),
                                             ("rowcol", False),
                                             ("rowcol", True),
                                             ("global", False)])
def test_fp8_kernels_match_plain_on_card(cuda_device, name, kind,
                                         multifault):
    shape = SHAPES[name]
    a, b, c = _operands(shape, cuda_device)
    sc = scalar_operand(InjectionSpec(enabled=True, every=5), (9500.0,) * 3)
    extra = ft.kernel_inputs(kind, a, b, shape)
    got = ft.run_kernel(kind, shape, a, b, c, extra, ALPHA, BETA, sc, 3,
                        multifault)
    want = ft.run_kernel(kind, shape, a, b, c, extra, ALPHA, BETA, sc, 3,
                         multifault, plain=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[1].sum()) > 0
    mask = torch.ones_like(got[0], dtype=torch.bool)
    if kind != "global":
        mask = (got[2] == 0).repeat_interleave(shape.bm, 0).repeat_interleave(
            shape.bn, 1)
    assert _close(got[0], want[0], mask)

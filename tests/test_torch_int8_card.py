"""The int8 builds of B3 and B4 (the exact mode) against their plain
versions on the card (marker ``cuda``; skipped without a CUDA device). No
JAX here: the plain versions, which the CPU tests hold to the JAX package
(``tests/test_torch_ft_int8.py``), are the reference. Checks every 3 bk
steps (inside a 32-deep s8 k step at bk = 8 and 16) and faults every 5, on
data of ±9 and ±127: grids and C equal bit for bit.

    python -m pytest tests/test_torch_int8_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, pad_to, scalar_operand

ALPHA, BETA = 1.0, -1.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind", ["rowcol", "global"])
@pytest.mark.parametrize("lim", [9, 127])
def test_int8_kernels_match_plain_on_card(cuda_device, name, kind, lim):
    shape = SHAPES[name]
    rng = np.random.default_rng(8)
    a, b = (rng.integers(-lim, lim + 1, (250, 264)).astype(np.float32)
            for _ in range(2))
    c = rng.standard_normal((250, 250)).astype(np.float32)
    ap, bp = (align_rows16(pad_to(as_operand(x, torch.int8, cuda_device), mm,
                                  shape.bk))
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(cuda_device), shape.bm, shape.bn)
    sc = scalar_operand(InjectionSpec(enabled=True, every=5), (9500.0,) * 3)
    got = ft.run_kernel(kind, shape, ap, bp, cp, (), ALPHA, BETA, sc, 3)
    want = ft.run_kernel(kind, shape, ap, bp, cp, (), ALPHA, BETA, sc, 3,
                         plain=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(got[1].sum()) > 0

"""The adaptive bf16 builds of B6, B7 and B8 (threshold="adaptive" on the
mxu encodes in bf16) against their plain versions on the card (marker
``cuda``; skipped without a CUDA device). No JAX here: the plain versions,
which the CPU tests hold to the JAX package
(``tests/test_torch_ft_adaptive_bf16_mxu.py``), are the reference. Each
entry point binds from its own library (``ftsg_ft_fused_bf16``,
``ftsg_ft_rowcol_mxu_bf16`` and ``ftsg_ft_global_mxu_bf16`` of the
``*_adaptive_bf16`` libraries) and a launch counts in its wrapper's
``adaptive_launches`` and ``bf16_launches`` alone. At every tile, on sizes
ragged in M, N and K, clean and with faults of magnitude 5 (the faults
these thresholds exist to catch), with checks inside a 64-column stage and
(at bk = 8) between the halves of a 16-deep k step: grids equal, and C
within ``verify_matrix`` on every tile the plain version reports
correctable (global: everywhere).

    python -m pytest tests/test_torch_adaptive_bf16_mxu_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import (
    DEFAULT_THRESHOLD_MARGIN,
    as_operand,
    pad_to,
    scalar_operand,
)
from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix, verify_matrix

ALPHA, BETA = 1.0, -1.5
# (kernel kind, multifault, wrapper) of each adaptive bf16 mxu kernel.
KERNELS = {"fused": ("fused", False, ft.ft_fused_kernel),
           "rowcol_mxu": ("rowcol_mxu", False, ft.ft_rowcol_mxu_kernel),
           "rowcol_mxu_mf": ("rowcol_mxu", True, ft.ft_rowcol_mxu_kernel),
           "global_mxu": ("global_mxu", False, ft.ft_global_mxu_kernel)}
COUNTERS = ("launches", "adaptive_launches", "bf16_launches", "fp8_launches",
            "int8_launches")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_adaptive_bf16_mxu_entry_points_bind(cuda_device):
    entries = ft._bf16_entries(True)
    for kind in ("fused", "rowcol_mxu", "global_mxu"):
        fn = entries[kind, torch.bfloat16]
        assert fn.__name__ == ft.ENTRY_POINTS[kind] + "_bf16"
        assert fn.argtypes == ft._ARGS[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("dims,check_every", [
    ((200, 136, 256), 3),     # ragged M, N; checks inside a stage
    ((130, 70, 1000), 5),     # ragged M, N, K
])
def test_adaptive_bf16_mxu_kernels_match_plain_on_card(cuda_device, name,
                                                       kernel, dims,
                                                       check_every):
    shape = SHAPES[name]
    kind, mf, wrapper = KERNELS[kernel]
    rng = np.random.default_rng(sum(dims) + 7)
    m, n, k = dims
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((m, k), (n, k), (m, n)))
    ap, bp = (pad_to(as_operand(x, torch.bfloat16, cuda_device), mm, shape.bk)
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(cuda_device), shape.bm, shape.bn)
    nk = ap.shape[1] // shape.bk
    extra = ft.kernel_inputs(kind, ap, bp, shape)
    for inj in (InjectionSpec.none(),
                InjectionSpec(enabled=True, every=2, magnitude=5.0)):
        sc = scalar_operand(inj, (0.0,) * 3, DEFAULT_THRESHOLD_MARGIN)
        ce = min(check_every, nk)
        before = {c: getattr(wrapper, c) for c in COUNTERS}
        got = ft.run_kernel(kind, shape, ap, bp, cp, extra, ALPHA, BETA, sc,
                            ce, mf, adaptive=True)
        want = ft.run_kernel(kind, shape, ap, bp, cp, extra, ALPHA, BETA, sc,
                             ce, mf, plain=True, adaptive=True)
        assert {c: getattr(wrapper, c) - before[c] for c in COUNTERS} == {
            c: int(c in ("adaptive_launches", "bf16_launches"))
            for c in COUNTERS}
        assert torch.equal(got[1], want[1]), (inj, got[1], want[1])
        assert torch.equal(got[2], want[2]), (inj, got[2], want[2])
        ok = (torch.ones_like(want[2], dtype=torch.bool) if kind == "global_mxu"
              else want[2] == 0)
        ok = ok.repeat_interleave(shape.bm, 0).repeat_interleave(shape.bn, 1)
        assert verify_matrix(want[0][ok].cpu().numpy(),
                             got[0][ok].cpu().numpy(), verbose=False)[0]

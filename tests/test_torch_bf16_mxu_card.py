"""The bf16 builds of B6, B7 and B8 (the mxu encodes in bf16) against their
plain versions on the card (marker ``cuda``; skipped without a CUDA
device). No JAX here: the plain versions, which the CPU tests hold to the
JAX package (``tests/test_torch_ft_bf16_mxu.py``), are the reference. At
every tile, on sizes that are ragged in M, N and K, clean, reference-like
and with every fault in one column, with checks inside a 64-column bf16
stage and (at bk = 8) between the halves of a 16-deep k step: grids equal,
and C within ``verify_matrix`` on every tile the plain version reports
correctable (global: everywhere).

    python -m pytest tests/test_torch_bf16_mxu_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import as_operand, pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix, verify_matrix

ALPHA, BETA = 1.0, -1.5
# (kernel kind, multifault) of each bf16 mxu kernel: B6, B7 both ways, B8.
KERNELS = {"fused": ("fused", False), "rowcol_mxu": ("rowcol_mxu", False),
           "rowcol_mxu_mf": ("rowcol_mxu", True),
           "global_mxu": ("global_mxu", False)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("dims,check_every", [
    ((200, 136, 256), 3),     # ragged M, N; checks inside a stage
    ((16, 300, 96), 1),       # M under one CTA; a check every bk step
    ((130, 70, 1000), 5),     # ragged M, N, K
])
def test_bf16_mxu_kernels_match_plain_on_card(cuda_device, name, kernel, dims,
                                              check_every):
    shape = SHAPES[name]
    kind, mf = KERNELS[kernel]
    rng = np.random.default_rng(sum(dims) + 1)
    m, n, k = dims
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((m, k), (n, k), (m, n)))
    ap, bp = (pad_to(as_operand(x, torch.bfloat16, cuda_device), mm, shape.bk)
              for x, mm in ((a, shape.bm), (b, shape.bn)))
    cp = pad_to(torch.from_numpy(c).to(cuda_device), shape.bm, shape.bn)
    nk = ap.shape[1] // shape.bk
    extra = ft.kernel_inputs(kind, ap, bp, shape)
    assert all(x.dtype == torch.bfloat16 for x in extra)
    for inj in (InjectionSpec.none(), InjectionSpec.reference_like(k, shape.bk),
                InjectionSpec(enabled=True, every=1, col_stride=0)):
        sc = scalar_operand(inj, (9500.0,) * 3)
        ce = min(check_every, nk)
        before = ft.ft_fused_kernel.bf16_launches
        got = ft.run_kernel(kind, shape, ap, bp, cp, extra, ALPHA, BETA, sc,
                            ce, mf)
        want = ft.run_kernel(kind, shape, ap, bp, cp, extra, ALPHA, BETA, sc,
                             ce, mf, plain=True)
        if kind == "fused":
            assert ft.ft_fused_kernel.bf16_launches == before + 1
        assert torch.equal(got[1], want[1]), (inj, got[1], want[1])
        assert torch.equal(got[2], want[2]), (inj, got[2], want[2])
        ok = (torch.ones_like(want[2], dtype=torch.bool) if kind == "global_mxu"
              else want[2] == 0)
        ok = ok.repeat_interleave(shape.bm, 0).repeat_interleave(shape.bn, 1)
        assert verify_matrix(want[0][ok].cpu().numpy(),
                             got[0][ok].cpu().numpy(), verbose=False)[0]


@pytest.mark.cuda
def test_launch_holds_each_input_to_its_dtype(cuda_device):
    # A launch refuses a wrapper-side input in another dtype than the one
    # its kernel reads: B2's expected moments are f32 whatever the operands
    # (a bf16 expm would be read past its end), and bf16 B6's moment rows
    # bf16 (9 f32 rows would be read as bf16).
    shape = SHAPES["medium"]
    a, b = (torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda_device)
            for _ in range(2))
    c = torch.zeros((64, 64), device=cuda_device)
    sc = np.zeros(8, np.float32)
    expm = ft.kernel_inputs("precomp", a, b, shape)[0]
    with pytest.raises(ValueError, match="float32 C and checksum inputs"):
        ft.ft_weighted_kernel(a, b, c, expm.to(torch.bfloat16), shape, ALPHA,
                              BETA, sc)
    (ma,) = ft.kernel_inputs("fused", a, b, shape)
    with pytest.raises(ValueError, match="moment rows"):
        ft.ft_fused_kernel(a, b, c, ma.float(), shape, ALPHA, BETA, sc, 1)
    with pytest.raises(ValueError, match="float32 C and checksum inputs"):
        ft._launch(ft.ft_fused_kernel, "fused", shape, a, b, c, (ma.float(),),
                   (1,), ALPHA, BETA, sc)

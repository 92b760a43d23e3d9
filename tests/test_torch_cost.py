"""The GEMM cost model (``ops/common.gemm_cost_breakdown`` and
``gemm_cost_estimate``), copied into the port, against the JAX package's
(ft_sgemm_tpu/ops/common.py:228-336) on identical arguments: every kernel
strategy (None for the plain GEMM, and the kernel-level weighted, rowcol,
global, fused, rowcol_mxu, global_mxu), every input width (f32, bf16, and
the 1-byte int8 / fp8), multifault off and on, cadences from every step to
one final check, aligned and ragged shapes. The numbers are integers and
must be EQUAL; the estimate's three fields are those of the JAX package's
``pl.CostEstimate``.
"""

import pytest

from ft_sgemm_tpu.ops import common as jcommon
from ft_sgemm_tpu_torch.ops import common

STRATEGIES = [None, "weighted", "rowcol", "global", "fused", "rowcol_mxu",
              "global_mxu"]
DIMS = [(4096, 4096, 4096, (128, 128, 8)), (1000, 300, 700, (32, 128, 8)),
        (512, 512, 384, (128, 128, 128))]


@pytest.mark.parametrize("check_every", [None, 1, 3])
@pytest.mark.parametrize("multifault", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_cost_equals_jax(strategy, itemsize, multifault, check_every):
    for m, n, k, block in DIMS:
        kw = dict(block=block, strategy=strategy, multifault=multifault,
                  check_every=check_every)
        assert (common.gemm_cost_breakdown(m, n, k, itemsize, **kw)
                == jcommon.gemm_cost_breakdown(m, n, k, itemsize, **kw))
        got = common.gemm_cost_estimate(m, n, k, itemsize, **kw)
        want = jcommon.gemm_cost_estimate(m, n, k, itemsize, **kw)
        assert (got.flops, got.bytes_accessed, got.transcendentals) == (
            want.flops, want.bytes_accessed, want.transcendentals)


def test_cost_plain_form():
    # The plain callers' four-argument form: the product and A, B and C's
    # bytes only.
    parts = common.gemm_cost_breakdown(64, 32, 16, 4)
    assert parts == {"flops_base": 2 * 64 * 32 * 16, "flops_encode": 0,
                     "flops_check": 0, "bytes_base": 4 * (64 + 32) * 16
                     + 8 * 64 * 32, "bytes_encode": 0, "bytes_check": 0}
    est = common.gemm_cost_estimate(64, 32, 16, 4)
    assert est == common.CostEstimate(parts["flops_base"],
                                      parts["bytes_base"], 0)

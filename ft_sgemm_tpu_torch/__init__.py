"""ft_sgemm_tpu_torch — the PyTorch / CUDA port of ft_sgemm_tpu for NVIDIA
Hopper (sm_90a).

Fault-tolerant SGEMM with fused online ABFT (arXiv:2305.01024): the plain
SGEMM family and the weighted, rowcol, global and fused checksum kernels
(each strategy with its in-kernel and its moment-row encode, under the
static, auto and adaptive thresholds), each a CUDA C++ kernel written by
hand for Hopper and built at first use
(``ops/_build.py``), with a plain PyTorch version beside it. Entry points
run on the GPU unless given ``device="cpu"``. The JAX package
``ft_sgemm_tpu`` is the reference this port is held against; this package
imports nothing from it.
"""

from ft_sgemm_tpu_torch.configs import KERNEL_TABLE, PERF_ROW_IDS, SHAPES, KernelShape
from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
from ft_sgemm_tpu_torch.ops.abft_baseline import abft_baseline_sgemm
from ft_sgemm_tpu_torch.ops.ft_sgemm import FtSgemmResult, ft_sgemm, make_ft_sgemm
from ft_sgemm_tpu_torch.ops.reference import sgemm_reference
from ft_sgemm_tpu_torch.ops.sgemm import make_sgemm, sgemm

__all__ = [
    "KERNEL_TABLE",
    "PERF_ROW_IDS",
    "SHAPES",
    "KernelShape",
    "REFERENCE_THRESHOLD",
    "InjectionSpec",
    "abft_baseline_sgemm",
    "FtSgemmResult",
    "ft_sgemm",
    "make_ft_sgemm",
    "sgemm_reference",
    "make_sgemm",
    "sgemm",
]

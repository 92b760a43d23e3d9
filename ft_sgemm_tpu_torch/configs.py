"""Kernel shape configuration family, with the port's Hopper tile table.

The reference drives its code generator with a 7-parameter tile
description ``[ms, ns, ks, mw, nw, mr, nr]`` (block tile, K chunk, warp
tile, thread tile — ``code_gen/main.py:8-16``). The JAX package collapsed
that to 128-multiple MXU blocks (``huge`` is 512x512x512), which do not fit
one CTA's registers on Hopper. The port therefore takes each named shape's
``bm x bn`` straight from the paper's CUDA tile: the unit of padding, of
fault placement and of the checks and their grids. Every kernel runs it as
3xTF32 on wgmma (``csrc/gemm_wgmma.cuh``): B1 and B2 in one CTA per tile
at the tiles of 64 rows or more (large, tall, huge, test), every other
launch in one 128 x 128 CTA that covers several tiles
(``ops/_build.mainloop``). The paper's thread layout stays in
``ref_params`` only.

``bk`` is the K depth of one scheduled step — the unit that fault
injection and the check cadence count, like one K grid step of the JAX
kernels. It is a multiple of the kernels' 8-column k step; the paper's
``bk = ks`` gives its own ``K/20`` injection cadence. ``test`` keeps the
JAX package's 128x128x128 tile exactly, so the two packages can be
compared tile for tile; on the card it runs the ``huge`` CTA with 16 k
steps of 8 columns per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelShape:
    """A named block-tiling configuration for the SGEMM kernel family.

    Attributes:
      name: shape family name (reference ``main.py:8-16`` table key).
      bm, bn: output tile of one CTA (rows, columns of C).
      bk: K depth of one scheduled step (injection / check cadence unit).
      ref_params: the reference's ``[ms, ns, ks, mw, nw, mr, nr]``.
    """

    name: str
    bm: int
    bn: int
    bk: int
    ref_params: Tuple[int, int, int, int, int, int, int]

    def __post_init__(self):
        for field in ("bm", "bn", "bk"):
            v = getattr(self, field)
            if v <= 0:
                raise ValueError(f"KernelShape.{field}={v} must be positive")
        if self.bk % 8:
            raise ValueError(
                f"KernelShape.bk={self.bk} must be a multiple of the"
                " kernels' 8-column k step")
        if self.bm % 8 or self.bn % 8:
            raise ValueError(
                f"KernelShape {self.bm}x{self.bn} is not a tile of whole"
                " 8-row groups")

    @property
    def block(self) -> Tuple[int, int, int]:
        return (self.bm, self.bn, self.bk)


# Checksum strategies of the FT family (ops/ft_sgemm.py):
#   "rowcol"   — row and column checksums, periodic intersection correction
#                (the reference's shipped design);
#   "global"   — one scalar checksum per tile, detect only;
#   "weighted" — column moments 1, w, w^2, per-column localization;
#   "fused"    — the weighted check with its expected moments taken from
#                precomputed moment rows ("weighted" with encode="mxu").
STRATEGIES = ("rowcol", "global", "weighted", "fused")
# How a kernel forms its expected checksums: "vpu" sums the staged operand
# chunks inside the kernel; "mxu" takes the operands' checksum-moment rows,
# computed by the wrapper (ops/ft_sgemm._tile_moments), staged beside each
# K chunk. The TPU appended those rows to the operand blocks (sublane-
# padded ``aug_rows``); the port passes them as their own (g, R, K)
# operand, so A and B are never copied.
ENCODE_MODES = ("vpu", "mxu")
THRESHOLD_MODES = ("static", "auto", "adaptive")
IN_DTYPES = ("float32",)


def check_kernel_legality(*, strategy: str, encode: str,
                          in_dtype: str = "float32",
                          threshold_mode: str = "static") -> None:
    """Validate one (strategy, encode, dtype, threshold-mode) combination:
    unknown spellings raise ``ValueError``; every (strategy, encode) pair is
    legal in f32 under every threshold mode, and what the port does not run
    yet (every other dtype) raises ``NotImplementedError``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; pick from {STRATEGIES}")
    if encode not in ENCODE_MODES:
        raise ValueError(f"unknown encode mode {encode!r}; pick from"
                         f" {ENCODE_MODES}")
    if threshold_mode not in THRESHOLD_MODES:
        raise ValueError(f"threshold must be a float or one of"
                         f" {THRESHOLD_MODES}, got {threshold_mode!r}")
    if in_dtype not in IN_DTYPES:
        raise NotImplementedError(
            f"in_dtype={in_dtype!r} is not ported yet ({IN_DTYPES})")

# The port's Hopper tile table: bm x bn and bk = ks are the paper's CUDA
# tiles (code_gen/main.py:8-16). "test" is the JAX package's 128x128x128
# tile.
SHAPES = {
    "small": KernelShape("small", 16, 16, 16, (16, 16, 16, 8, 16, 2, 2)),
    "medium": KernelShape("medium", 32, 32, 8, (32, 32, 8, 16, 32, 4, 4)),
    "large": KernelShape("large", 64, 64, 8, (64, 64, 8, 32, 64, 8, 8)),
    "tall": KernelShape("tall", 128, 32, 8, (128, 32, 8, 64, 16, 8, 4)),
    "wide": KernelShape("wide", 32, 128, 8, (32, 128, 8, 16, 64, 4, 8)),
    "huge": KernelShape("huge", 128, 128, 8, (128, 128, 8, 32, 64, 8, 8)),
    "test": KernelShape("test", 128, 128, 128, (64, 64, 8, 16, 32, 4, 4)),
}

# Kernel-id table, matching the reference binary's dispatch ladder and perf rows
# (reference sgemm.cu:105-199 and sgemm.cu:235-237). Id 0 is the vendor
# library (cuBLAS through torch.matmul); ids 1-6 the plain shapes; id 10
# the non-fused two-pass ABFT baseline; ids 11-16 the fused-ABFT shapes.
# Ids 7-9 are unused, as in the reference.
KERNEL_TABLE = {
    0: ("cublas", None, False),
    1: ("kernel_sgemm_small", "small", False),
    2: ("kernel_sgemm_medium", "medium", False),
    3: ("kernel_sgemm_large", "large", False),
    4: ("kernel_sgemm_tall", "tall", False),
    5: ("kernel_sgemm_wide", "wide", False),
    6: ("kernel_sgemm_huge", "huge", False),
    10: ("abft_baseline", None, True),
    11: ("abft_kernel_small", "small", True),
    12: ("abft_kernel_medium", "medium", True),
    13: ("abft_kernel_large", "large", True),
    14: ("abft_kernel_tall", "tall", True),
    15: ("abft_kernel_wide", "wide", True),
    16: ("abft_kernel_huge", "huge", True),
}

PERF_ROW_IDS = (0, 1, 2, 3, 4, 5, 6, 10, 11, 12, 13, 14, 15, 16)


def kernel_for_id(kernel_id: int) -> Tuple[str, Optional[KernelShape], bool]:
    """Resolve a kernel id to (display name, shape or None, is_abft)."""
    if kernel_id not in KERNEL_TABLE:
        raise KeyError(f"unknown kernel id {kernel_id}")
    name, shape_name, is_abft = KERNEL_TABLE[kernel_id]
    shape = SHAPES[shape_name] if shape_name is not None else None
    return name, shape, is_abft

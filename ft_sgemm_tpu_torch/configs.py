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
# Input dtypes of the kernel family (ft_sgemm_tpu/configs.py:141): A and B
# are rounded to the dtype, while C, the accumulator, the checksums and the
# detect / correct math stay f32 (int32 for int8, exact).
IN_DTYPES = ("float32", "bfloat16", "float8_e4m3fn", "int8")
# What the legality tables below allow and the port does not run yet, by
# dtype and encode ("mxu" also for the fused strategy): the threshold modes
# still to port. Empty: every strategy and encode runs in f32 and bf16
# under every mode (adaptive on the adaptive builds of B3-B8, in bf16 on
# their adaptive bf16 builds), the vpu encodes of fp8 on B1-B5 under every
# mode, and int8's exact mode on B3 and B4 (adaptive: the constant
# half-ulp).
NOT_PORTED: dict = {}

# Accepted spellings of the fp8 dtype (ft_sgemm_tpu/configs.py:431).
_IN_DTYPE_ALIASES = {
    "fp8": "float8_e4m3fn",
    "fp8_e4m3": "float8_e4m3fn",
    "float8_e4m3": "float8_e4m3fn",
}

# Per-dtype legality, the JAX package's static tables
# (ft_sgemm_tpu/configs.py:446-469): 1-byte dtypes cannot carry checksum
# rows (no encode="mxu", no "fused"), and int8 ships only the strategies
# that localize nothing by the weighted ratio.
STRATEGY_LEGALITY = {
    "float32": ("rowcol", "global", "weighted", "fused"),
    "bfloat16": ("rowcol", "global", "weighted", "fused"),
    "float8_e4m3fn": ("rowcol", "global", "weighted"),
    "int8": ("rowcol", "global"),
}
ENCODE_LEGALITY = {
    "float32": ("vpu", "mxu"),
    "bfloat16": ("vpu", "mxu"),
    "float8_e4m3fn": ("vpu",),
    "int8": ("vpu",),
}
# The strategy an entry point takes when the caller names only a dtype.
DEFAULT_STRATEGY = {
    "float32": "weighted",
    "bfloat16": "weighted",
    "float8_e4m3fn": "weighted",
    "int8": "rowcol",
}


def canonical_in_dtype(in_dtype) -> str:
    """The canonical :data:`IN_DTYPES` name of one dtype spelling: a name,
    an fp8 alias, a numpy dtype or a torch dtype (``torch.bfloat16``).
    Anything else raises a ``ValueError`` naming the family."""
    if isinstance(in_dtype, str):
        name = _IN_DTYPE_ALIASES.get(in_dtype, in_dtype)
    else:
        import numpy as np

        try:
            name = np.dtype(in_dtype).name
        except TypeError:
            name = str(in_dtype).removeprefix("torch.")
    if name not in IN_DTYPES:
        raise ValueError(
            f"in_dtype must be one of {IN_DTYPES} (aliases:"
            f" {tuple(sorted(_IN_DTYPE_ALIASES))}), got {in_dtype!r}")
    return name


def check_kernel_legality(*, strategy: str, encode: str,
                          in_dtype="float32", threshold_mode: str = "static",
                          multifault: Optional[bool] = None) -> str:
    """Validate one (strategy, encode, dtype, threshold-mode) combination
    and return the canonical dtype name.

    Unknown spellings raise ``ValueError``, and so do the combinations that
    the JAX package refuses as unrepresentable
    (ft_sgemm_tpu/configs.py:497-547): checksum rows in a 1-byte dtype
    (``encode="mxu"`` or ``strategy="fused"`` with fp8 or int8), and the
    weighted-ratio localization (``weighted``, ``fused``, multifault) on
    int8's wrapping checksums. What is legal but not ported yet would raise
    ``NotImplementedError`` (:data:`NOT_PORTED`, empty now): every legal
    combination runs, under every threshold mode."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; pick from {STRATEGIES}")
    if encode not in ENCODE_MODES:
        raise ValueError(f"unknown encode mode {encode!r}; pick from"
                         f" {ENCODE_MODES}")
    if threshold_mode not in THRESHOLD_MODES:
        raise ValueError(f"threshold must be a float or one of"
                         f" {THRESHOLD_MODES}, got {threshold_mode!r}")
    dtype = canonical_in_dtype(in_dtype)
    if "mxu" not in ENCODE_LEGALITY[dtype] and (
            encode == "mxu" or strategy == "fused"):
        raise ValueError(
            f"encode='mxu' (and strategy='fused') is illegal for {dtype}:"
            " checksum rows of magnitude ~bm * max|x| are not representable"
            " in a 1-byte operand dtype; use encode='vpu'")
    if strategy not in STRATEGY_LEGALITY[dtype]:
        raise ValueError(
            f"strategy {strategy!r} is illegal for {dtype}: weighted-ratio"
            " fault localization needs non-wrapping moment checksums;"
            f" {dtype} supports {STRATEGY_LEGALITY[dtype]}")
    if dtype == "int8" and multifault:
        raise ValueError(
            "multifault=True is illegal for int8: the multifault extension"
            " localizes by the weighted-residual ratio, which wrapping int32"
            " checksums cannot guarantee")
    kind = "mxu" if strategy == "fused" else encode
    if threshold_mode in NOT_PORTED.get((dtype, kind), ()):
        raise NotImplementedError(
            f"{dtype} with strategy={strategy!r}, encode={encode!r} under"
            f" threshold={threshold_mode!r} is not ported yet")
    return dtype

# The kernel-variant axes (ft_sgemm_tpu/configs.py:162-204), kept so the
# port takes and reports the same descriptor. ``PIPELINE_DEPTHS``: K panels
# the pipeline holds per operand stream (2: the historical double buffer;
# 3: a two-panel K window, so a grid step, the unit of the check cadence
# and of the injection schedule, consumes two panels of bk columns; the
# kernels take that window as their bk). ``GRID_ORDERS``: the walk of the
# two output grid dims, "mn" (M-major) or "nm"; K stays innermost. On the
# card the order is the CTA raster: "nm" puts the M tile on blockIdx.x, the
# fastest-walked grid dimension (``csrc/abft_common.cuh::Variant``).
# ``DIM_SEMANTICS``: the Mosaic semantics of the output dims, a scheduling
# hint with no CUDA counterpart (every CTA of a launch is independent):
# "arbitrary" runs the same kernel as "parallel". ``RING_OVERLAP_MODES``:
# the hop schedule of the ring collectives (ignored by the single-device
# factories).
PIPELINE_DEPTHS = (2, 3)
GRID_ORDERS = ("mn", "nm")
DIM_SEMANTICS = ("parallel", "arbitrary")
RING_OVERLAP_MODES = ("serial", "overlap")

# Fused-epilogue axes (ft_sgemm_tpu/configs.py:180-204): the detect-correct
# epilogue of every kernel can fuse a bias add, an activation, and an int8
# or fp8 quantize-rescale, applied strictly AFTER correction, so the ABFT
# checksums verify the pre-epilogue accumulator. Quantized outputs stay in
# f32 storage carrying exactly representable target-grid values (round and
# clamp for int8, the e4m3 rounding of ``ops/common.to_e4m3`` for fp8).
EPILOGUE_ACTIVATIONS = ("none", "relu", "gelu")
EPILOGUE_QUANTIZE = ("none", "int8", "float8_e4m3fn")

# Spelling tokens for the quantize modes in the compact epilogue spelling
# (EpilogueSpec.spelling / .parse): "qint8" / "qfp8".
_EPI_QUANT_TOKENS = {"int8": "qint8", "float8_e4m3fn": "qfp8"}


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """A fused-epilogue request: what the kernel applies to the corrected
    ``alpha*acc + beta*C`` tile before writing it back
    (ft_sgemm_tpu/configs.py:212).

    ``bias`` adds a per-output-column bias row; ``activation`` is one of
    :data:`EPILOGUE_ACTIVATIONS`; ``quantize`` one of
    :data:`EPILOGUE_QUANTIZE` with ``scale`` the quantize-rescale
    multiplier (output = round/clamp of ``x * scale`` onto the target
    grid, in f32 storage). Order of application: bias -> activation ->
    quantize.

    The canonical compact spelling (:meth:`spelling` / :meth:`parse`):
    ``"none"`` for the identity, else ``+``-joined tokens, e.g.
    ``"bias+relu"``, ``"bias+gelu+qint8"``, ``"qfp8x0.5"`` (a non-unit
    scale is appended as ``x<scale>``).
    """

    bias: bool = False
    activation: str = "none"
    quantize: str = "none"
    scale: float = 1.0

    def __post_init__(self):
        if self.activation not in EPILOGUE_ACTIVATIONS:
            raise ValueError(
                f"EpilogueSpec.activation={self.activation!r} must be one"
                f" of {EPILOGUE_ACTIVATIONS}")
        if self.quantize not in EPILOGUE_QUANTIZE:
            raise ValueError(
                f"EpilogueSpec.quantize={self.quantize!r} must be one of"
                f" {EPILOGUE_QUANTIZE}")
        if self.scale != 1.0 and self.quantize == "none":
            raise ValueError(
                "EpilogueSpec.scale is the quantize-rescale multiplier;"
                " set quantize to use it")
        if not self.scale > 0.0:
            raise ValueError(
                f"EpilogueSpec.scale={self.scale!r} must be positive")

    @property
    def is_identity(self) -> bool:
        return (not self.bias and self.activation == "none"
                and self.quantize == "none")

    @property
    def spelling(self) -> str:
        if self.is_identity:
            return "none"
        parts = []
        if self.bias:
            parts.append("bias")
        if self.activation != "none":
            parts.append(self.activation)
        if self.quantize != "none":
            tok = _EPI_QUANT_TOKENS[self.quantize]
            if self.scale != 1.0:
                tok += f"x{self.scale:g}"
            parts.append(tok)
        return "+".join(parts)

    @classmethod
    def parse(cls, spec) -> "EpilogueSpec":
        """An :class:`EpilogueSpec` from a spelling (or pass one through).

        Accepts ``None`` / ``"none"`` (identity) and ``+``-joined tokens
        (see :meth:`spelling`); raises a ValueError naming the legal
        tokens for anything else.
        """
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, str):
            raise ValueError(
                f"epilogue must be an EpilogueSpec or a spelling string,"
                f" got {spec!r}")
        s = spec.strip().lower()
        if s in ("", "none"):
            return cls()
        bias = False
        activation = "none"
        quantize = "none"
        scale = 1.0
        quant_by_token = {v: k for k, v in _EPI_QUANT_TOKENS.items()}
        for tok in s.split("+"):
            if tok == "bias":
                bias = True
            elif tok in EPILOGUE_ACTIVATIONS and tok != "none":
                activation = tok
            else:
                base, _, sc = tok.partition("x")
                if base in quant_by_token:
                    quantize = quant_by_token[base]
                    if sc:
                        try:
                            scale = float(sc)
                        except ValueError:
                            raise ValueError(
                                f"epilogue quantize scale {sc!r} in"
                                f" {spec!r} is not a number") from None
                else:
                    raise ValueError(
                        f"unknown epilogue token {tok!r} in {spec!r};"
                        " legal tokens: bias, "
                        + ", ".join(a for a in EPILOGUE_ACTIVATIONS
                                    if a != "none")
                        + ", " + ", ".join(sorted(quant_by_token))
                        + " (optionally qint8x<scale>)")
        return cls(bias=bias, activation=activation, quantize=quantize,
                   scale=scale)


DEFAULT_EPILOGUE = EpilogueSpec()


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """The kernel-variant descriptor (ft_sgemm_tpu/configs.py:330): the
    pipeline depth (:data:`PIPELINE_DEPTHS`), the output grid's walk
    (:data:`GRID_ORDERS`), the output dims' semantics
    (:data:`DIM_SEMANTICS`), the detect/correct cadence (``check_every``
    in K steps; ``None`` = the strategy's default), the fused epilogue (an
    :class:`EpilogueSpec` SPELLING, kept as a string so the descriptor
    stays hashable) and the ring hop schedule
    (:data:`RING_OVERLAP_MODES`, ignored by the single-device factories).
    ``KernelVariant()`` is the historical behavior. The port's factories
    run every axis but ``ring_overlap``.
    """

    pipeline_depth: int = 2
    grid_order: str = "mn"
    dim_semantics: str = "parallel"
    check_every: Optional[int] = None
    epilogue: str = "none"
    ring_overlap: str = "serial"

    def __post_init__(self):
        if self.pipeline_depth not in PIPELINE_DEPTHS:
            raise ValueError(
                f"KernelVariant.pipeline_depth={self.pipeline_depth!r}"
                f" must be one of {PIPELINE_DEPTHS}")
        if self.grid_order not in GRID_ORDERS:
            raise ValueError(
                f"KernelVariant.grid_order={self.grid_order!r} must be"
                f" one of {GRID_ORDERS}")
        if self.dim_semantics not in DIM_SEMANTICS:
            raise ValueError(
                f"KernelVariant.dim_semantics={self.dim_semantics!r}"
                f" must be one of {DIM_SEMANTICS}")
        if self.check_every is not None and (
                not isinstance(self.check_every, int)
                or self.check_every < 1):
            raise ValueError(
                f"KernelVariant.check_every={self.check_every!r} must be"
                " a positive int (K-grid steps) or None for the"
                " strategy default")
        if self.ring_overlap not in RING_OVERLAP_MODES:
            raise ValueError(
                f"KernelVariant.ring_overlap={self.ring_overlap!r} must"
                f" be one of {RING_OVERLAP_MODES}")
        # Canonicalize the epilogue spelling through the one parser so
        # "Bias+ReLU" and "bias+relu" key identically everywhere.
        object.__setattr__(
            self, "epilogue", EpilogueSpec.parse(self.epilogue).spelling)

    @property
    def is_default(self) -> bool:
        return self == KernelVariant()

    @property
    def epilogue_spec(self) -> EpilogueSpec:
        return EpilogueSpec.parse(self.epilogue)

    @property
    def grid_spelling(self) -> str:
        """``<order>.<semantics>`` (e.g. ``mn.parallel``)."""
        return f"{self.grid_order}.{self.dim_semantics}"

    @property
    def cadence_spelling(self) -> str:
        """``auto`` (strategy default) or the explicit cadence."""
        return "auto" if self.check_every is None else str(self.check_every)


DEFAULT_VARIANT = KernelVariant()


def canonical_variant(variant) -> KernelVariant:
    """A :class:`KernelVariant` from None (the default), a variant, or a
    dict of its fields (the tuner-cache record form)."""
    if variant is None:
        return DEFAULT_VARIANT
    if isinstance(variant, KernelVariant):
        return variant
    if isinstance(variant, dict):
        fields = {f.name for f in dataclasses.fields(KernelVariant)}
        extra = set(variant) - fields
        if extra:
            raise ValueError(
                f"unknown KernelVariant fields {sorted(extra)};"
                f" legal: {sorted(fields)}")
        return KernelVariant(**variant)
    raise ValueError(
        f"variant must be a KernelVariant, a field dict, or None,"
        f" got {variant!r}")


def check_variant(variant: KernelVariant) -> None:
    """Re-validate a variant's axes with the JAX package's ``ValueError``
    (ft_sgemm_tpu/configs.py:357-380): every legal pipeline depth, grid
    order and dimension semantics runs. The cadence and the epilogue run
    too; ``ring_overlap`` is accepted and ignored, as the JAX package's
    single-device factories ignore it."""
    KernelVariant.__post_init__(variant)


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

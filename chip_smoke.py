"""Chip smoke for the PyTorch / CUDA port (``ft_sgemm_tpu_torch``) on one H100.

Builds the port's hand-written CUDA kernels from ``ft_sgemm_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (at every tile of
the port's table, B3-B8 also with checks inside a pipeline stage, and at
every shape, cadence and multifault setting the paper's program gives it
under every (strategy, encode) pair), holds the 3xTF32 wgmma kernels'
accuracy against a float64 product and cuBLAS FP32 at 4096 and their clean
checksum residuals 100x under the threshold, drives that ``ft_sgemm``
program (verification at 4096 for ids 0-16 under the weighted
and rowcol strategies and for ids 11-16 under global, fused, rowcol with
encode mxu and global with encode mxu; the GFLOPS table at 2048 / 4096 /
6144, and at 4096 for ids 11-16 under rowcol and each of those four
pairs) and shows through the kernels' launch counters that the program
ran them. The threshold modes: B3-B8's adaptive builds against their plain
versions at every tile (checks inside a stage too) and, at 4096, against
the host twin's per-tile thresholds, each 0.125-2 times its tile's fault;
then the program under ``--threshold=auto`` and ``--threshold=adaptive``
at 4096 in every pair (verification, clean runs that flag nothing, and
magnitude-5 faults that the static threshold misses and both modes catch),
counted apart, and each adaptive kernel's time beside its static build's.
The same for threshold="adaptive" in bf16 and fp8: the adaptive bf16
builds of B3-B8 in bf16 (B6-B8 on the mxu encodes) and of B5, B3 and B4
in fp8 against their plain versions at every tile (bf16 data and fp8 data
over ±448, faults every 1, 3 and 5 bk steps, checks between the halves of
a 16-deep k step), the bracket against the host twin on the rounded
operands, the program with ``--dtype=bfloat16`` (every (strategy, encode)
pair) and ``--dtype=fp8`` (the vpu pairs) under ``--threshold=adaptive``
at 4096 (each verdict the plain versions', clean runs, magnitude-5
faults, the table beside the static rows, every launch counted as
adaptive and as the dtype's), and each build timed beside its static bf16
build and the library call. The threshold-calibration path: ``ft_sgemm
roc`` over every legal (dtype, strategy, encode) combo (adaptive
dominates the calibrated static threshold in each, no adaptive false
positive), its bf16 points equal to the plain versions' on the host, and
``calibrate_threshold`` with ``detection_rate_sweep`` at 4096 (f32
rowcol, bf16 fused under adaptive).
The bf16 input mode (``--dtype=bfloat16``): B1-B8's bf16 builds (B6-B8,
the mxu encodes, on the wrapper's hi / lo / lo2 moment rows) against
their plain versions at every tile (checks and faults inside a 16-deep k
step too) and, clean, to within BF16_ACCURACY of max |C| of the f32
product of the rounded operands (C must stay f32), then the program in
bf16 at 4096 under the weighted, rowcol and global strategies and under
fused, weighted, rowcol and global with encode mxu, with the static and
auto thresholds (verification, the table, clean runs that flag nothing
and keep that accuracy), counted apart. The
int8 input mode (``--dtype=int8``, the exact mode): B3's and B4's int8
builds against their plain versions at every tile (checks inside a 32-deep
s8 k step, faults every 1, 3 and 5 bk steps, data on ±9 and ±127, and
checksums that wrap at K = 4096), grids and C equal bit for bit; then the
program in int8 at 4096 under rowcol and global with the static, auto and
adaptive thresholds (verification of ids 0 and 11-16, the table, clean
runs that flag nothing, unit faults caught under adaptive and missed under
static), counted apart. The fp8 input mode (``--dtype=fp8``, the vpu
encodes; B1 on e4m3 wgmma, B2-B5 on their bf16 builds, whose wrappers
widen the e4m3 operands exactly): B1-B5 in fp8 against their plain
versions at every tile
(checks and faults inside a 32-deep k step, faults every 1, 3 and 5 bk
steps, the program's data and data spread over e4m3's ±448) and, clean,
to within BF16_ACCURACY of max |C| of the f32 product of the rounded
operands; the program in fp8 at 4096 under the weighted, rowcol and
global strategies with the static and auto thresholds (verification of
ids 0-16, the table, clean runs that flag nothing and keep that
accuracy), counted apart; every FT kernel's clean fp8 residuals
FP8_RESIDUAL_MARGIN times under the auto threshold; and each fp8 kernel
timed beside ``torch._scaled_mm``. The fused epilogue (bias, relu or gelu,
qint8 or qfp8 after detect and correct, in every kernel's store): every
build of every library with ``bias+gelu+qint8x0.25``, ``bias+relu+qfp8``
and ``bias`` equal to its own identity launch through ``apply_epilogue``
(the GELU within a stated ulp bound), grids unchanged; a bracket whose
output is C (alpha 0, beta 1, A = B = 0) carrying the quantizers' edge
values, which must come out as ``to_e4m3`` / the int8 clamp of C element
by element; ``make_ft_sgemm(epilogue=...)`` for every legal (dtype,
strategy, encode) and ``make_sgemm`` at 4096 against
``epilogue_reference(sgemm_reference(...))``, counted in
``epilogue_launches``; and each (body, dtype) timed with the epilogue
beside its identity. And, as a regression, B6 at the small tile built
with its scalar argument read from device memory
(``scripts/torch_variant_time.py --variant=device-scalars-small``) must
count every fault, as its by-value build does.
Prints one line per phase, a ``kernels`` JSON line with each kernel's
launches, error and times against its bound, the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits nonzero without the last line; so does a host without a
CUDA device or a directory without the port.

    python3 chip_smoke.py
"""

from __future__ import annotations

import atexit
import ctypes
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel-vs-plain sizes: aligned, odd, and one that leaves B5's and B6's
# 128 x 128 CTA partly past the operands at every tile narrower than 128.
# The aligned size is 512, no larger, so that the whole script stays well
# inside its 1200 s on a slow host: a multiple of every tile and of the
# CTA, with 4 x 4 CTAs and 64 bk steps of 8 (the program runs the aligned
# 4096 at every tile).
SIZES = (512, 1000, 300)
VERIFY_SIZE = 4096
PERF_SIZES = (2048, 6144, 2048)  # start, end, gap
PERF_MINTIME = 0.05           # seconds per timed loop (the CLI default is 1)
TIMING_SIZE = 4096

# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP8_FLOPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# The tiles on which B1's accuracy is held: every program tile, since every
# kernel runs the 3xTF32 wgmma mainloop at every tile (B1 on the tile's own
# CTA at large, tall and huge, on the 128 x 128 one at small, medium, wide).
WGMMA_TILES = ("small", "medium", "large", "tall", "wide", "huge")
# A check cadence in bk steps that ends checks inside a 32-column stage.
MID_STAGE_EVERY = 3
# The clean weighted residuals must stay this far under the threshold.
RESIDUAL_MARGIN = 100.0
# Adaptive kernel-vs-plain size: not a multiple of the CTA (the aligned
# size went with the bf16 phases, for time).
ADAPTIVE_SIZES = (1000,)
# The adaptive bracket: tile (i, j)'s threshold at BRACKET_A[i % 2] *
# BRACKET_B[j % 2] times the fault (0.5, 0.125, 2 and 0.5).
BRACKET_A = (0.5, 2.0)
BRACKET_B = (1.0, 0.25)
# The adaptive bf16 builds' bracket (phase_lowp_bracket): the scale of each
# 4-column chunk of a 16-deep k step, in A and B (4 of the 7 parts of the
# step's sum of squares in its last chunk, so that the two 8-column halves
# and the two chunks of the second half differ); the faults, as multiples of the
# threshold of the tiles at 0.5 of the band scales; the depth K (M = N =
# VERIFY_SIZE).
LOWP_BRACKET_K = (1.0, 1.0, 1.0, 2.0)
LOWP_BRACKET_FAULT = (0.9, 1.1)
LOWP_BRACKET_DEPTH = 512
# The fault magnitude that the reference's 9500 misses and the auto and
# adaptive thresholds catch (tests/test_ft_sgemm.py:640-682).
TINY_MAGNITUDE = 5.0

# ops/ft_sgemm._plan's kernel kinds, and "sgemm" for B1.
KIND_NAMES = {"sgemm": "sgemm", "precomp": "ft_sgemm_weighted_precomp",
              "running": "ft_sgemm_weighted_running",
              "rowcol": "ft_sgemm_rowcol", "global": "ft_sgemm_global",
              "fused": "ft_sgemm_fused", "rowcol_mxu": "ft_sgemm_rowcol_mxu",
              "global_mxu": "ft_sgemm_global_mxu"}
DETECT_ONLY = ("global", "global_mxu")
WEIGHTED_KINDS = ("running", "fused")
# The (strategy, encode) pairs this slice added to the program; fused
# encodes from moment rows whatever --encode says.
NEW_PAIRS = (("global", "vpu"), ("fused", "mxu"), ("rowcol", "mxu"),
             ("global", "mxu"))
# The pairs whose ids 11-16 get a table of their own at 4096: every pair but
# weighted, whose table runs at every size.
TABLE_PAIRS = (("rowcol", "vpu"),) + NEW_PAIRS
ALL_PAIRS = (("weighted", "vpu"),) + TABLE_PAIRS
# The kernels with an adaptive build (KIND_PAIR names the pair whose program
# runs each under threshold="adaptive"; weighted runs B5 at every tile then).
ADAPTIVE_KINDS = ("running", "fused", "rowcol", "rowcol_mxu", "global",
                  "global_mxu")
PROGRAM_TILES = ("huge", "small", "medium", "large", "tall", "wide")
# The bf16 slice: its (strategy, encode) pairs, the kernels their program
# runs, threshold modes, and kernel-vs-plain sizes (aligned, and not a
# multiple of the CTA). A fault schedule with an odd period puts faults
# between the halves of a 16-deep k step at every tile whose bk is 8. The
# vpu pairs (B1-B5) run in fp8 too and under threshold="adaptive"
# (LOWP_PAIRS); the mxu pairs (B6-B8) in bf16 alone, under the static and
# auto thresholds (BF16_MXU_KINDS).
LOWP_PAIRS = (("weighted", "vpu"), ("rowcol", "vpu"), ("global", "vpu"))
BF16_PAIRS = LOWP_PAIRS + (("fused", "mxu"), ("weighted", "mxu"),
                           ("rowcol", "mxu"), ("global", "mxu"))
BF16_KINDS = ("sgemm", "precomp", "running", "rowcol", "global")
BF16_MXU_KINDS = ("fused", "rowcol_mxu", "global_mxu")
BF16_MODES = ("static", "auto")
BF16_SIZES = (512, 1000)
ODD_EVERY = 5
# bf16 keeps C and the accumulator in f32: B1 and every clean FT launch
# must stay within this share of max |C| of the f32 product of the rounded
# operands (the kernels measured ~1e-6 of it; C or a stage sum rounded to
# bf16 costs ~2e-3, and the smoke checks that such a rounding fails it).
BF16_ACCURACY = 1e-4
# The int8 slice (the exact mode): its kernels (B3, B4), threshold modes,
# extra fault periods in bk steps (every 1 and 3: several faults or one a
# check interval; ODD_EVERY besides), and the data: the program's lattice
# ±9, the full ±127 at INT8_WIDE_SIZE, and [INT8_WRAP_LOW, 127] at K =
# TIMING_SIZE, where the band checksums of the 64- and 128-wide tiles and
# every global tile total pass 2^31 and wrap.
INT8_KINDS = ("rowcol", "global")
INT8_MODES = ("static", "auto", "adaptive")
INT8_EVERY = (1, 3, ODD_EVERY)
INT8_WIDE_SIZE = 1000
INT8_WRAP_LOW = 100
# The fp8 slice (the serving mode, the vpu encodes): its kernels (B1-B5;
# B2-B5 are the bf16 builds on the widened operands), pairs, threshold
# modes and timed tiles are bf16's vpu ones (BF16_KINDS, LOWP_PAIRS,
# BF16_MODES, LOWP_TIMED); extra fault periods in bk steps,
# each held at a cadence that checks once per fault (INT8_EVERY, as int8),
# and the data: the program's ±0.9 at BF16_SIZES, and at FP8_WIDE_SIZE
# data spread over e4m3's range (uniform in ±FP8_WIDE, rounded), whose band
# sums reach 128 * 448, under thresholds and faults scaled to it (the
# reference's 9500 and 1e4 are noise there): FP8_WIDE_THRESHOLD for the
# detection (the w and w^2 re-checks at bm / sqrt 3 and bm^2 / sqrt 5 times
# it, as "auto" scales them) and faults of FP8_WIDE_MAGNITUDE.
FP8_WIDE = 448.0
FP8_WIDE_SIZE = 1000
FP8_WIDE_THRESHOLD = 1e5
FP8_WIDE_MAGNITUDE = 1e7
# Clean in-kernel residuals must stay this far under the "auto" threshold.
FP8_RESIDUAL_MARGIN = 10.0
# threshold="adaptive" in bf16, and in fp8 on the operands the wrappers
# widen to bf16: the adaptive bf16 builds of B5 (the weighted strategy runs
# it at every tile), B3 and B4, and in bf16 alone those of B6, B7 and B8
# (the mxu encodes, BF16_ADAPTIVE_KINDS), each launch counted in
# adaptive_launches and in its dtype's counter (bf16_launches,
# fp8_launches); the dtypes.
LOWP_ADAPTIVE_KINDS = ("running", "rowcol", "global")
BF16_ADAPTIVE_KINDS = LOWP_ADAPTIVE_KINDS + BF16_MXU_KINDS
LOWP_DTYPES = ("bfloat16", "fp8")
# The roc phase: the fault magnitudes of the detection sweep, in units of
# the calibrated threshold (below it a designed miss), and the faults per
# tile of its reference-like schedule.
DETECTION_FACTORS = (0.5, 2.0, 4.0, 64.0)
DETECTION_FAULTS = 4
# The fused epilogue (bias, relu or gelu, qint8 or qfp8 quantize-rescale
# after detect and correct, in every kernel's store): the spellings each
# build launches beside its identity, the one the timing rows time, the
# kernel-vs-identity size (not a multiple of the 128 x 128 CTA, so the
# masked store reads the bias row only where it stores), and the FP32
# operations an element of the timed spelling adds beyond the identity's
# (bias 1, GELU 9 with tanh as one, the quantize's scale and rounding 2,
# its clamp 2).
EPI_SPELLINGS = ("bias+gelu+qint8x0.25", "bias+relu+qfp8", "bias")
EPI_TIMED = "bias+gelu+qint8x0.25"
EPI_SIZE = 1000
EPI_FLOPS = 14.0
# The JAX kernels' epilogue calls that the store replaces, by kernel kind.
EPI_REPLACES = {
    "sgemm": "ft_sgemm_tpu/ops/sgemm.py:98",
    "precomp": "ft_sgemm_tpu/ops/ft_sgemm.py:1063",
    "running": "ft_sgemm_tpu/ops/ft_sgemm.py:1004",
    "rowcol": "ft_sgemm_tpu/ops/ft_sgemm.py:632",
    "global": "ft_sgemm_tpu/ops/ft_sgemm.py:902",
    "fused": "ft_sgemm_tpu/ops/ft_sgemm.py:1159",
    "rowcol_mxu": "ft_sgemm_tpu/ops/ft_sgemm.py:750",
    "global_mxu": "ft_sgemm_tpu/ops/ft_sgemm.py:822"}
FT_KINDS = ("precomp", "running", "rowcol", "global", "fused", "rowcol_mxu",
            "global_mxu")
# Every (kind, dtype, adaptive) build, which together hold every library of
# ops/_build.LIBRARIES: B1 in f32, bf16 and fp8; B2-B8 static in f32 and
# bf16; B2-B5 in fp8 (their bf16 builds on the widened operands); B3 and
# B4 in int8; the adaptive builds of B3-B8 in f32 and bf16, of B3-B5 in fp8.
EPI_BUILDS = tuple(
    [("sgemm", d, False) for d in ("float32", "bfloat16", "fp8")]
    + [(k, d, False) for d in ("float32", "bfloat16") for k in FT_KINDS]
    + [(k, "fp8", False) for k in ("precomp",) + LOWP_ADAPTIVE_KINDS]
    + [(k, "int8", False) for k in INT8_KINDS]
    + [(k, "float32", True) for k in ADAPTIVE_KINDS]
    + [(k, "bfloat16", True) for k in BF16_ADAPTIVE_KINDS]
    + [(k, "fp8", True) for k in LOWP_ADAPTIVE_KINDS])
# The one-pass f32 builds (f32 precision "default", the "*_tf32"
# libraries): B1-B8 static and B3-B8 adaptive, each with the spellings
# against its identity launch too.
EPI_ONE_PASS_BUILDS = tuple(
    [("sgemm", False)] + [(k, False) for k in FT_KINDS]
    + [(k, True) for k in ADAPTIVE_KINDS])
# The grid bracket: B1 and one FT build of each source (and B3's int8
# build, whose store rounds on its own), with alpha = 0, beta = 1 and A = B
# = 0, so the output is C, which carries the quantizers' edge values.
EPI_BRACKET = (("sgemm", "float32", "small"), ("sgemm", "bfloat16", "huge"),
               ("sgemm", "fp8", "huge"), ("precomp", "float32", "medium"),
               ("rowcol", "float32", "huge"), ("rowcol", "int8", "small"),
               ("global", "float32", "wide"), ("fused", "float32", "tall"))
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "fp8": torch.float8_e4m3fn, "int8": torch.int8}
# The variant axes (configs.KernelVariant, ops/common.LaunchAxes): each
# combination of VARIANT_AXES (every axis alone, then all three), every
# body in every dtype it has (VARIANT_BUILDS; the adaptive f32 builds of
# B3-B8 at depth 3, where their thresholds' run length counts grid steps),
# held to its plain version at the tiles of VARIANT_TILES (the 64-row
# tile's own CTA of B1 and B2, the sub-tiled CTA; at depth 3 also "test",
# whose two-panel window is 256 columns, at the aligned size) and sizes
# VARIANT_SIZES (aligned, and K = 300, a multiple of no window); each "nm"
# launch equal bit for bit to its "mn" launch. The f32 precision "default"
# (one TF32 pass) of B1-B8 under the default axes and all three, held to
# its one-product plain version at every program tile (PROGRAM_TILES: each
# is an instantiation of its own, and the program runs them all), the
# adaptive one-pass builds of B3-B8 too, on operands that TF32 holds
# exactly (ONE_PASS_EXACT), where a product's rounding is FP32's, as the
# adaptive noise model has it; "high" equal bit for bit to "highest"
# through the entry points.
VARIANT_AXES = ({"pipeline_depth": 3}, {"grid_order": "nm"},
                {"dim_semantics": "arbitrary"},
                {"pipeline_depth": 3, "grid_order": "nm",
                 "dim_semantics": "arbitrary"})
VARIANT_TILES = ("small", "huge")
VARIANT_SIZES = (512, 300)
# Integers in [-9, 9] over 16: four mantissa bits, so TF32 holds them and
# their products exactly, at the program's magnitude (about +-0.5).
ONE_PASS_EXACT = 16.0
VARIANT_BUILDS = tuple(
    [(k, d) for d in ("float32", "bfloat16") for k in ("sgemm",) + FT_KINDS]
    + [(k, "fp8") for k in BF16_KINDS] + [(k, "int8") for k in INT8_KINDS])
# The f32 precision "default" on the program's path: its verification at
# VERIFY_SIZE under every pair (ids 1-6 and 10 under the first), each
# row's C held to the FP32 oracle within TF32's rounding, element by
# element. A product of two TF32-rounded operands is off the FP32 product
# by less than TF32_PRODUCT (2^-11 + 2^-11 + 2^-22) of |a b|, and each of
# the K f32 additions of the kernel and of the oracle by at most F32_SUM
# of the running sum (rounded or truncated): every element that no fault
# hit within (TF32_PRODUCT + 2 K F32_SUM) of its (|A| |B|^T) element
# (about 1.6 at 4096, where |C| reaches ~90: a zero written or a
# miscorrection shows), a corrected one within three times TF32_PRODUCT of
# its tile row's or column's sum of |A| |B|^T (an expected sum and a sum
# of the accumulator, each that far off). A fault of 1e4 left in C is ~30
# times the second bound at 4096.
TF32_PRODUCT = 2.0 ** -10
F32_SUM = 2.0 ** -23

# The build runs beside the phases, which go in the order of what they load:
# the f32 static libraries, then the f32 adaptive ones, then the bf16 and
# fp8 ones, then the one-TF32-pass ones (``*_tf32``, f32 "default"). The card's machine has 8 cores, and nice levels there left the
# libraries' finishing order as it was, so BUILD_SLOTS compilers run at a
# time, in that order, each tier's longest compile first (the compile times
# in PERF.md section 6): the f32 static libraries are done in about half
# the build, while the others still compile.
BUILD_SLOTS = 8
BUILD_ORDER = (
    "ft_sgemm_aug", "ft_sgemm_rowcol", "ft_sgemm_weighted", "ft_sgemm_global",
    "sgemm", "ft_sgemm_aug_adaptive", "ft_sgemm_rowcol_adaptive",
    "ft_sgemm_weighted_adaptive", "ft_sgemm_global_adaptive",
    "ft_sgemm_fused_adaptive_bf16", "ft_sgemm_fused_bf16",
    "ft_sgemm_weighted_adaptive_bf16", "ft_sgemm_weighted_bf16",
    "ft_sgemm_rowcol_adaptive_bf16", "ft_sgemm_rowcol_mxu_adaptive_bf16",
    "ft_sgemm_rowcol_bf16", "ft_sgemm_rowcol_mxu_bf16",
    "ft_sgemm_global_adaptive_bf16", "ft_sgemm_global_bf16",
    "ft_sgemm_precomp_bf16", "sgemm_fp8", "ft_sgemm_aug_adaptive_tf32",
    "ft_sgemm_aug_tf32", "ft_sgemm_weighted_adaptive_tf32",
    "ft_sgemm_rowcol_tf32", "ft_sgemm_rowcol_adaptive_tf32",
    "ft_sgemm_weighted_tf32", "ft_sgemm_global_adaptive_tf32",
    "ft_sgemm_global_tf32", "sgemm_tf32")

# The regression variant of B6 (the device-memory scalar argument, at the
# small tile), built beside the kernels into this directory.
VARIANT = "device-scalars-small"
VARIANT_DIR = pathlib.Path(__file__).resolve().parent / (
    "ft_sgemm_tpu_torch/csrc/_build/variant")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


class Kernels:
    """The port's kernels: wrapper, plain version, source, TPU original,
    and the largest kernel-vs-plain difference seen."""

    def __init__(self):
        from ft_sgemm_tpu_torch import cli
        from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
        from ft_sgemm_tpu_torch.ops import sgemm as sg

        self.ft, self.sg = ft, sg
        self.alpha, self.beta = cli.ALPHA, cli.BETA
        self.table = {
            "sgemm": dict(
                wrapper=sg.sgemm_kernel, source="ft_sgemm_tpu_torch/csrc/sgemm.cu",
                replaces="ft_sgemm_tpu/ops/sgemm.py:67"),
            "ft_sgemm_weighted_precomp": dict(
                wrapper=ft.ft_weighted_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_weighted.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:1012"),
            "ft_sgemm_weighted_running": dict(
                wrapper=ft.ft_weighted_running_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_weighted.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:917"),
            "ft_sgemm_rowcol": dict(
                wrapper=ft.ft_rowcol_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_rowcol.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:516"),
            "ft_sgemm_global": dict(
                wrapper=ft.ft_global_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_global.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:832"),
            "ft_sgemm_fused": dict(
                wrapper=ft.ft_fused_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_aug.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:1077"),
            "ft_sgemm_rowcol_mxu": dict(
                wrapper=ft.ft_rowcol_mxu_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_aug.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:648"),
            "ft_sgemm_global_mxu": dict(
                wrapper=ft.ft_global_mxu_kernel,
                source="ft_sgemm_tpu_torch/csrc/ft_sgemm_global.cu",
                replaces="ft_sgemm_tpu/ops/ft_sgemm.py:758"),
        }
        for k in self.table.values():
            k["counter"] = "launches"
        # The adaptive builds of B3-B8 and the bf16 builds of B1-B5: the
        # same wrappers, counted apart.
        for kind in ADAPTIVE_KINDS:
            static = self.table[KIND_NAMES[kind]]
            self.table[KIND_NAMES[kind] + "_adaptive"] = dict(
                static, counter="adaptive_launches")
        for kind in BF16_KINDS + BF16_MXU_KINDS:
            static = self.table[KIND_NAMES[kind]]
            self.table[KIND_NAMES[kind] + "_bf16"] = dict(
                static, counter="bf16_launches")
        for kind in INT8_KINDS:
            static = self.table[KIND_NAMES[kind]]
            self.table[KIND_NAMES[kind] + "_int8"] = dict(
                static, counter="int8_launches")
        for kind in BF16_KINDS:
            static = self.table[KIND_NAMES[kind]]
            self.table[KIND_NAMES[kind] + "_fp8"] = dict(
                static, counter="fp8_launches")
        # The adaptive bf16 builds, read by their dtype's counter in a run
        # that launches no static build (phase_threshold_path); B6-B8 in
        # bf16 alone.
        for kind in BF16_ADAPTIVE_KINDS:
            static = self.table[KIND_NAMES[kind]]
            for label in ("bf16", "fp8")[:1 if kind in BF16_MXU_KINDS else 2]:
                self.table[f"{KIND_NAMES[kind]}_adaptive_{label}"] = dict(
                    static, counter=f"{label}_launches")
        # The f32 precision "default" (one TF32 pass) of B1-B8: the same
        # kernels, counted apart too.
        for kind in ("sgemm",) + FT_KINDS:
            static = self.table[KIND_NAMES[kind]]
            self.table[KIND_NAMES[kind] + "_default"] = dict(
                static, counter="one_pass_launches")
        self.max_err = {name: 0.0 for name in self.table}
        # The adaptive one-pass builds of B3-B8, held to their plain
        # versions in phase_variants; their launches count in the static
        # one-pass rows' one_pass_launches, so they have no row of their own.
        for kind in ADAPTIVE_KINDS:
            self.max_err[KIND_NAMES[kind] + "_adaptive_default"] = 0.0
        self.checked = {name: 0 for name in self.max_err}

    def zero_counts(self):
        for k in self.table.values():
            setattr(k["wrapper"], k["counter"], 0)

    def counts(self):
        return {name: getattr(k["wrapper"], k["counter"])
                for name, k in self.table.items()}

    def calls(self, kind, shape, a, b, c, scalars=None, check_every=None,
              multifault=False, adaptive=False, epi=None, bias=None,
              axes=None):
        """(kernel thunk, plain thunk) for one launch of ``kind`` (its
        adaptive build with ``adaptive``) on padded operands, with the
        program's alpha and beta and the fused epilogue ``epi`` (its padded
        bias row ``bias``; None: the identity), and the variant axes and
        precision ``axes`` (``ops/common.LaunchAxes``; None: the defaults;
        ``shape`` is then the grid step's). The wrapper-side inputs (B2's
        expected moments, the mxu kernels' moment rows) are made here,
        outside both thunks, as inputs of the kernel."""
        from ft_sgemm_tpu_torch.ops.common import LaunchAxes

        ft, sg, al, be = self.ft, self.sg, self.alpha, self.beta
        axes = axes or LaunchAxes()
        if kind == "sgemm":
            return (lambda: sg.sgemm_kernel(a, b, c, shape, al, be, epi, bias,
                                            axes),
                    lambda: sg.sgemm_plain(a, b, c, al, be, epi, bias,
                                           shape.bk // axes.unroll, axes))
        args = (kind, shape, a, b, c, ft.kernel_inputs(kind, a, b, shape), al,
                be, scalars, check_every, multifault)
        ep = dict(adaptive=adaptive, epi=epi, bias=bias, axes=axes)
        return (lambda: ft.run_kernel(*args, **ep),
                lambda: ft.run_kernel(*args, plain=True, **ep))

    def hold(self, kind, shape, a, b, c, scalars=None, check_every=None,
             multifault=False, adaptive=False, scale_tol=None, axes=None):
        """One launch against its plain version on the same operands: (det,
        unc) grids equal, C within verify_matrix on every tile the kernel
        reports correctable (its rule, in float64 on the card, and every
        element finite). A tile reported uncorrectable (the adversarial
        schedule) may be miscorrected differently by the two — the weighted
        ratio can fall on a rounding tie — so its C is not compared. The
        detect-only global kernels correct nothing: both sides keep the
        same faults, and C is compared everywhere. The int8 builds are
        exact: C must equal the plain version's bit for bit everywhere
        (both round alpha * f32(acc) and beta * C on their own). With
        ``scale_tol`` (data far from the program's ±0.9, where 0.01 is no
        measure), C must be within scale_tol * max |C| of the plain
        version's instead. ``axes``: as :meth:`calls`."""
        name = kernel_name(kind, a, adaptive, axes is not None and axes.one_pass)
        run, plain = self.calls(kind, shape, a, b, c, scalars, check_every,
                                multifault, adaptive, axes=axes)
        got, want = run(), plain()
        torch.cuda.synchronize()
        self.last = got  # the kernel's result, for a caller's own checks
        out, ref = (got, want) if kind == "sgemm" else (got[0], want[0])
        mask = torch.ones_like(out, dtype=torch.bool)
        if kind != "sgemm":
            (_, det, unc), (_, pdet, punc) = got, want
            if not (torch.equal(det, pdet) and torch.equal(unc, punc)):
                raise AssertionError(
                    f"{name} {shape.name} {tuple(a.shape)}: grids differ: det"
                    f" {int(det.sum())} vs {int(pdet.sum())}, unc"
                    f" {int(unc.sum())} vs {int(punc.sum())}")
            if kind not in DETECT_ONLY:
                mask = (unc == 0).repeat_interleave(
                    shape.bm, 0).repeat_interleave(shape.bn, 1)
        if a.dtype == torch.int8 and not torch.equal(out, ref):
            nbad = int((out != ref).sum())
            raise AssertionError(
                f"{name} {shape.name} {tuple(a.shape)}: C differs from the"
                f" plain version at {nbad} elements (int8: bit for bit)")
        diff = (out.double() - ref.double()).abs()
        off = ((diff > 0.01) & (diff > 0.01 * ref.double().abs())
               if scale_tol is None else
               diff > scale_tol * float(ref.double().abs().max()))
        bad = mask & (off | ~torch.isfinite(out))
        nbad = int(bad.sum())
        if nbad:
            raise AssertionError(
                f"{name} {shape.name} {tuple(a.shape)}: C differs from the"
                f" plain version at {nbad} elements (first"
                f" {tuple(bad.nonzero()[0].tolist())})")
        err = float(diff[mask].max()) if mask.any() else 0.0
        self.max_err[name] = max(self.max_err[name], err)
        self.checked[name] += 1
        return out


def rounded_oracle(kern: Kernels, a, b, c):
    """The bf16 oracle: the f32 product of the bf16-rounded A and B (TF32
    off), with the program's alpha and beta; C stays f32."""
    from ft_sgemm_tpu_torch.ops.common import strict_fp32

    strict_fp32()
    return kern.alpha * torch.matmul(a.float(), b.float().T) + kern.beta * c


def bf16_accuracy(out, oracle, what, worst=None):
    """max |out - oracle| over max |oracle|, raising above BF16_ACCURACY (C
    or a sum rounded to bf16 somewhere). ``worst`` keeps the largest share
    per ``what``'s first word."""
    share = float((out - oracle).abs().max() / oracle.abs().max())
    if not share <= BF16_ACCURACY:
        raise AssertionError(f"{what}: max |dC| is {share:.3g} of max |C|"
                             f" against the rounded operands' f32 product,"
                             f" over {BF16_ACCURACY} (C not kept in f32)")
    if worst is not None:
        key = what.split()[0]
        worst[key] = max(worst.get(key, 0.0), share)
    return share


def bf16_control(oracle, what):
    """The accuracy gate's control: the oracle rounded to bf16 must fail
    it, or the gate could not see a kernel that rounds C."""
    share = float((oracle.bfloat16().float() - oracle).abs().max()
                  / oracle.abs().max())
    if share <= BF16_ACCURACY:
        raise AssertionError(f"{what}: C rounded to bf16 is off by only"
                             f" {share:.3g} of max |C|, within the gate's"
                             f" {BF16_ACCURACY}")
    return share


def kernel_name(kind, a, adaptive=False, one_pass=False):
    """The ``Kernels`` table's name of kernel ``kind`` on A ``a`` (its
    one-TF32-pass launches with ``one_pass``)."""
    return (KIND_NAMES[kind] + ("_adaptive" if adaptive else "")
            + {torch.bfloat16: "_bf16", torch.int8: "_int8",
               torch.float8_e4m3fn: "_fp8"}.get(a.dtype, "")
            + ("_default" if one_pass else ""))


def start_variant_build():
    """Write the B6 regression variant into VARIANT_DIR and start its nvcc
    (only its aug library), beside the kernels' own build; returns the
    process and the library's path. The process is killed if the script
    exits before it is done."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "scripts"))
    import torch_variant_time

    from ft_sgemm_tpu_torch.ops import _build

    shutil.rmtree(VARIANT_DIR, ignore_errors=True)
    torch_variant_time.write_variant(VARIANT, str(VARIANT_DIR))
    so = VARIANT_DIR / "libft_sgemm_aug.so"
    src = VARIANT_DIR / "ft_sgemm_tpu_torch/csrc/ft_sgemm_aug.cu"
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    atexit.register(lambda: proc.poll() is None and os.killpg(
        proc.pid, signal.SIGKILL))
    return proc, so


def phase_device():
    """The card, the toolkit, and the start of every library's build (in
    the background: each phase waits only for the libraries it loads)."""
    from ft_sgemm_tpu_torch import runtime
    from ft_sgemm_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    nvcc_version = subprocess.run([_build.nvcc(), "--version"], check=True,
                                  capture_output=True, text=True).stdout
    log(f"phase device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | {smi} | torch {torch.__version__}"
        f" cuda {torch.version.cuda} | nvcc"
        f" {nvcc_version.strip().splitlines()[-1]}")
    if sorted(BUILD_ORDER) != sorted(_build.KERNEL_LIBS):
        raise AssertionError("BUILD_ORDER must name every library once")
    _build.start(BUILD_ORDER, slots=BUILD_SLOTS)
    variant = start_variant_build()
    # Without a host compiler the verification would silently draw numpy
    # inputs instead of the reference binary's libc-rand stream.
    if runtime.load() is None:
        raise AssertionError("hostutils.cpp did not build: no libc-rand inputs")
    return smi, variant


def phase_build(variant, t0):
    """Wait for every library and the variant; their compile times (each
    from its compiler's start) and ptxas lines."""
    from ft_sgemm_tpu_torch.ops import _build

    secs = _build.build()
    log(f"phase build: {len(_build.KERNEL_LIBS)} libraries, {BUILD_SLOTS}"
        f" at a time, longest {max(secs.values(), default=0.0):.1f} s (each: "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
            secs.items(), key=lambda kv: kv[1]))
        + f"), and the {VARIANT} variant's aug library beside them")
    for name in _build.KERNEL_LIBS:
        log(f"  ptxas {name}: " + ", ".join(ptxas_summary(_build.ptxas_log(name))))
    proc, so = variant
    out, _ = proc.communicate()
    if proc.returncode:
        raise AssertionError(f"the {VARIANT} variant did not build:\n{out}")
    log(f"phase build: all done {time.perf_counter() - t0:.1f} s after its"
        f" start")
    return so


def ptxas_summary(text: str):
    """``kernel<dims[,flag]>: R regs[, S B spilled]`` for each kernel in one
    source's ``-Xptxas -v`` log (names demangled just enough to tell the
    kernels apart: a wgmma tile's bm, bn, sub-tile bm, bn, moment rows per
    band and the band-row and moment-row sources, ``gemm_wgmma.cuh::BandRows``
    and ``MomentRows``, then B1's ragged-store flag, and ``bf16``, ``s8`` or
    ``e4m3`` for a bf16, int8 or fp8 tile), and ``wgmma serialized`` with
    ptxas's warning codes where a warning names the kernel (it comes before
    the kernel's own lines)."""
    out = []
    serialized = {}
    for code, fn in re.findall(r"\((C\d+)\)[^\n']*serialized[^\n']*'(\w+)'",
                               text):
        serialized.setdefault(fn, set()).add(code)
    for fn, body in re.findall(r"Compiling entry function '(\w+)' for 'sm_90a'"
                               r"(.*?)(?=Compiling entry function|$)", text, re.S):
        kind = re.search(r"ftsg\d+(?:[a-z_]+\d+)?(\w+?_kernel)I", fn).group(1)
        dims = re.search(r"WgTileI((?:Li\d+E){5})", fn)
        rows = re.search(r"WgTileI(?:Li\d+E){6}Li(\d+)ELi(\d+)E", fn)
        ragged = re.search(r"EELb(\d)E", fn)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        # The kernel's own properties: a called function's (the epilogue's
        # pass, gemm_wgmma.cuh) may come between its lines.
        spill = (re.search(rf"Function properties for {fn}\s+\d+ bytes stack"
                           r" frame, (\d+) bytes spill stores", body)
                 or re.search(r"(\d+) bytes spill stores", body))
        in_type = re.search(r"WgTileI(?:Li\d+E){8}Li(\d)E", fn)
        in_tag = {"1": ["bf16"], "2": ["s8"], "3": ["e4m3"]}.get(
            in_type.group(1) if in_type else "0", [])
        tag = ",".join(re.findall(r"\d+", dims.group(1)) + list(rows.groups())
                       + ([ragged.group(1)] if ragged else []) + in_tag)
        out.append(f"{kind}<{tag}>: {regs} regs"
                   + (f", {spill.group(1)} B spilled"
                      if spill and spill.group(1) != "0" else "")
                   + (f", wgmma serialized ({'/'.join(sorted(serialized[fn]))})"
                      if fn in serialized else ""))
    return sorted(out)


def _padded(host, shape, dtype=torch.float32):
    """Host (A, B, C) on the card, A and B rounded (int8: truncated) to
    ``dtype``, padded to the tile as the entry points pad them (a 1-byte
    operand's rows 16 bytes apart)."""
    from ft_sgemm_tpu_torch.ops.common import align_rows16, as_operand, pad_to

    a, b = (as_operand(x, dtype, torch.device("cuda")) for x in host[:2])
    c = torch.from_numpy(host[2]).cuda()
    a, b = pad_to(a, shape.bm, shape.bk), pad_to(b, shape.bn, shape.bk)
    return align_rows16(a), align_rows16(b), pad_to(c, shape.bm, shape.bn)


def _random(m, n, k, gen):
    from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix

    return tuple(generate_random_matrix(r, s, rng=gen)
                 for r, s in ((m, k), (n, k), (m, n)))


def _scalars(inj):
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD
    from ft_sgemm_tpu_torch.ops.common import scalar_operand

    return scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3)


def _adaptive_scalars(inj):
    """The adaptive builds' scalar argument: slots 4-6 zero, the default
    margin in slot 7, as ``make_ft_sgemm(threshold="adaptive")`` gives."""
    from ft_sgemm_tpu_torch.ops.common import DEFAULT_THRESHOLD_MARGIN, scalar_operand

    return scalar_operand(inj, (0.0,) * 3, DEFAULT_THRESHOLD_MARGIN)


def phase_kernels(kern: Kernels):
    """Each kernel against its plain version at every tile of the port's
    table, at the sizes of SIZES, clean, with reference-like
    injection and with the adversarial col_stride=0 schedule. Each FT
    kernel runs at the cadence the program gives its strategy; B5 where the
    program does not run it, and B5 and B6 besides, at four checks per run
    and (clean and reference-like) every MID_STAGE_EVERY bk steps (checks
    inside a 32-column stage), so that every tile sees intermediate
    checks; both rowcol kernels with multifault off and on; B3 and B7
    (multifault on) and B4 and B8 besides every MID_STAGE_EVERY bk steps,
    clean and reference-like."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    gen = np.random.default_rng(7)
    t0 = time.perf_counter()
    for shape in SHAPES.values():
        for size in SIZES:
            a, b, c = _padded(_random(size, size, size, gen), shape)
            kern.hold("sgemm", shape, a, b, c)
            nk = a.shape[1] // shape.bk
            quarter = max(1, nk // 4)
            ref = InjectionSpec.reference_like(size, shape.bk)
            for inj in (InjectionSpec.none(), ref,
                        InjectionSpec(True, ref.every, col_stride=0)):
                sc = _scalars(inj)

                def cadence(strategy):
                    return ft._plan(strategy, None, None, inj, nk, shape.bn)[1]

                kern.hold("precomp", shape, a, b, c, sc)
                # Checks inside a stage under the schedules with one fault
                # per column and interval; col_stride=0 puts one or two
                # faults in a column per MID_STAGE_EVERY steps, and two
                # equal faults make the weighted ratio a rounding tie.
                mid = {MID_STAGE_EVERY} if inj.col_stride else set()
                ce = cadence("weighted")
                for ce in sorted({ce if ce < nk else quarter} | mid):
                    kern.hold("running", shape, a, b, c, sc, ce)
                for ce in sorted({cadence("fused"), quarter} | mid):
                    kern.hold("fused", shape, a, b, c, sc, ce)
                for mf in (False, True):
                    kern.hold("rowcol", shape, a, b, c, sc, cadence("rowcol"), mf)
                    kern.hold("rowcol_mxu", shape, a, b, c, sc,
                              cadence("rowcol"), mf)
                for ce in sorted(mid):   # several faults an interval: multifault
                    kern.hold("rowcol", shape, a, b, c, sc, ce, True)
                    kern.hold("rowcol_mxu", shape, a, b, c, sc, ce, True)
                for kind in ("global", "global_mxu"):
                    for ce in sorted({cadence("global")} | mid):
                        kern.hold(kind, shape, a, b, c, sc, ce)
    log(f"phase kernels: {dict(kern.checked)} comparisons with the plain"
        f" versions pass, max |dC| {kern.max_err}"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_bf16_kernels(kern: Kernels):
    """The bf16 builds of B1-B8 against their plain versions (the FP32
    tile algorithm on the same bf16-rounded operands; B6-B8's on the
    wrapper's bf16 term rows) at every tile of the port's table, at
    BF16_SIZES: clean, reference-like, col_stride=0, and (at the mid-stage
    cadence) faults every ODD_EVERY bk steps, which at bk = 8 fall between
    the halves of a 16-deep k step. B2 at its one final check; B5 at the
    program's cadence or four checks a run, and every MID_STAGE_EVERY bk
    steps (checks inside a 64-column bf16 stage and, at bk = 8, inside a
    16-deep k step); B6 at the program's cadence and the mid-stage one; B3
    and B7 with multifault off and on at the program's cadence and on at
    the mid-stage one; B4 and B8 at both. B1 and every clean FT launch are
    also held to BF16_ACCURACY against the f32 product of the rounded
    operands, and that product rounded to bf16 must fail it."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    gen = np.random.default_rng(19)
    before = dict(kern.checked)
    worst, control = {}, 1.0
    t0 = time.perf_counter()
    for shape in SHAPES.values():
        for size in BF16_SIZES:
            a, b, c = _padded(_random(size, size, size, gen), shape,
                              torch.bfloat16)
            oracle = rounded_oracle(kern, a, b, c)
            at = f"{shape.name} {size}"
            control = min(control, bf16_control(oracle, f"B1 {at}"))
            bf16_accuracy(kern.hold("sgemm", shape, a, b, c), oracle,
                          f"sgemm_bf16 {at}", worst)
            nk = a.shape[1] // shape.bk
            quarter = max(1, nk // 4)
            ref = InjectionSpec.reference_like(size, shape.bk)
            for inj in (InjectionSpec.none(), ref,
                        InjectionSpec(True, ref.every, col_stride=0),
                        InjectionSpec(True, ODD_EVERY)):
                sc = _scalars(inj)
                odd = inj.every == ODD_EVERY and inj.enabled

                def cadence(strategy):
                    return ft._plan(strategy, None, None, inj, nk, shape.bn)[1]

                # col_stride=0 puts two equal faults in a column of a
                # mid-stage interval (a weighted-ratio tie): program
                # cadences only there.
                mid = {MID_STAGE_EVERY} if inj.col_stride else set()

                def hold(kind, *args):
                    out = kern.hold(kind, shape, a, b, c, sc, *args)
                    if not inj.enabled:
                        bf16_accuracy(out, oracle, f"{KIND_NAMES[kind]}_bf16"
                                      f" {at} {args}", worst)

                if not odd:
                    hold("precomp")
                    ce = cadence("weighted")
                    for ce in sorted({ce if ce < nk else quarter} | mid):
                        hold("running", ce)
                    hold("fused", cadence("fused"))
                    for mf in (False, True):
                        hold("rowcol", cadence("rowcol"), mf)
                        hold("rowcol_mxu", cadence("rowcol"), mf)
                    hold("global", cadence("global"))
                    hold("global_mxu", cadence("global"))
                for ce in sorted(mid):
                    hold("running", ce)
                    hold("fused", ce)
                    hold("rowcol", ce, True)
                    hold("rowcol_mxu", ce, True)
                    hold("global", ce)
                    hold("global_mxu", ce)
    done = {k: n - before[k] for k, n in kern.checked.items()
            if n - before[k]}
    log(f"phase bf16 kernels: {done} comparisons with the plain versions"
        f" pass (grids equal), max |dC|"
        f" { {k: kern.max_err[k] for k in done} }; B1 and clean launches"
        f" against the rounded operands' f32 product, max |dC| / max |C|"
        f" {worst} (gate {BF16_ACCURACY}; C rounded to bf16 {control:.3g}"
        f" at least) ({time.perf_counter() - t0:.1f} s)")


def phase_float_path(kern: Kernels, in_dtype: str):
    """The ``ft_sgemm`` program with ``--dtype=bfloat16`` (the pairs of
    BF16_PAIRS: the vpu encodes, B1-B5, and the mxu encodes, B6-B8) or
    ``--dtype=fp8`` (LOWP_PAIRS, the vpu encodes; ``in_dtype``), under
    BF16_MODES, at VERIFY_SIZE, with the launch counters set to 0 just
    before and read just after: (b) the verification, every id passing
    with every fault detected (global: every event) and nothing
    uncorrectable where the strategy corrects: of ids 0-16 under weighted
    (vpu) with the static threshold and of ids 11-16 in every other pair
    and mode (ids 0-10 are B1's rows, which no strategy or threshold
    changes); the GFLOPS table at TIMING_SIZE (ids 0-16 weighted, 11-16 in
    every other pair); (c) clean runs of ids 11-16 in every pair and mode,
    which flag nothing and keep C within BF16_ACCURACY of the f32 product
    of the rounded operands. Every kernel of the mode (its counter:
    ``bf16_launches`` or ``fp8_launches``) must have launched. Returns the
    counts and the tables by (strategy, encode)."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import kernel_for_id
    from ft_sgemm_tpu_torch.ops.common import as_f32
    from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
    from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

    label = "fp8" if in_dtype == "fp8" else "bf16"
    pairs = LOWP_PAIRS if in_dtype == "fp8" else BF16_PAIRS
    n = VERIFY_SIZE
    kern.zero_counts()
    t0 = time.perf_counter()
    for mode in BF16_MODES:
        for strategy, encode in pairs:
            first = 0 if (mode, strategy, encode) == (
                "static", "weighted", "vpu") else 11
            details = {}
            ok = cli.run_verification(n, first, 16, strategy=strategy,
                                      encode=encode, threshold=mode,
                                      in_dtype=in_dtype, details=details)
            for kid, d in details.items():
                if d["detected"] != d["expected"] or d["uncorrectable"] != (
                        d["detected"] if strategy == "global" else 0):
                    ok = False
            if not ok:
                raise AssertionError(f"{label} {strategy}/{encode} threshold"
                                     f" {mode}: {details}")
            log(f"phase verify {label} {strategy}/{encode} threshold {mode}:"
                f" ids {first}-16 pass at {n}; detected/expected faults "
                + ", ".join(f"{k}:{d['detected']}/{d['expected']}"
                            for k, d in sorted(details.items())))
    tables = {}
    for strategy, encode in pairs:
        first = 0 if (strategy, encode) == ("weighted", "vpu") else 11
        tables[strategy, encode] = cli.run_perf_table(
            TIMING_SIZE, TIMING_SIZE, 1, first, 16,
            min_device_time=PERF_MINTIME, strategy=strategy, encode=encode,
            in_dtype=in_dtype)
    a, b = runtime.generate_reference_driver_inputs(n)
    a, b, c = (as_f32(x, "cuda") for x in (a, b, np.zeros_like(a)))
    oracle = sgemm_reference(a, b, c, kern.alpha, kern.beta,
                             in_dtype=in_dtype, device="cuda")
    control = bf16_control(oracle, f"{label} clean runs at {n}")
    flagged, worst = {}, {}
    for mode in BF16_MODES:
        for strategy, encode in pairs:
            for kid in range(11, 17):
                _, shape, _ = kernel_for_id(kid)
                res = make_ft_sgemm(shape.name, alpha=kern.alpha,
                                    beta=kern.beta, strategy=strategy,
                                    encode=encode, threshold=mode,
                                    in_dtype=in_dtype, device="cuda")(a, b, c)
                det, unc = int(res.num_detected), int(res.num_uncorrectable)
                what = f"{strategy}/{encode} {mode} id {kid}"
                if det or unc:
                    flagged[what] = (det, unc)
                bf16_accuracy(res.c, oracle, what, worst)
    if flagged:
        raise AssertionError(f"{label} clean runs flagged faults: {flagged}")
    counts = kern.counts()
    log(f"phase {label} clean: ids 11-16 under {pairs}, {BF16_MODES},"
        f" flag nothing at {n}; max |dC| / max |C| against the rounded"
        f" operands' f32 product {worst} (gate {BF16_ACCURACY}; C rounded"
        f" to bf16 {control:.3g})")
    log(f"phase {label} path: {time.perf_counter() - t0:.1f} s, launches"
        f" {counts}")
    missing = [name for name, k in kern.table.items()
               if k["counter"] == f"{label}_launches" and counts[name] == 0]
    if missing:
        raise AssertionError(f"{label} kernels never launched on the {label}"
                             f" path: {missing}")
    return counts, tables


def _int8_host(m, n, k, gen, low, high):
    """Host (A, B, C): A and B integer-valued in [low, high], C standard
    normal."""
    return (gen.integers(low, high + 1, (m, k)).astype(np.float32),
            gen.integers(low, high + 1, (n, k)).astype(np.float32),
            gen.standard_normal((m, n)).astype(np.float32))


def phase_int8_kernels(kern: Kernels):
    """The int8 builds of B3 and B4 against their plain versions (the exact
    tile algorithm on the same int8 operands) at every tile of the port's
    table: at SIZES on the program's lattice ±9 and at INT8_WIDE_SIZE on
    ±127, clean, reference-like, col_stride=0 and with faults every bk step
    of INT8_EVERY, each at the program's cadence and every MID_STAGE_EVERY
    bk steps (at bk = 8 and 16 a check inside a 32-deep s8 k step); then at
    K = TIMING_SIZE on data in [INT8_WRAP_LOW, 127], whose checksums wrap,
    clean and reference-like at the program's cadence. Grids and C equal
    bit for bit; where a check interval holds at most one fault, every
    fault detected (rowcol: each corrected, none uncorrectable; global:
    one event each, uncorrected)."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    gen = np.random.default_rng(37)
    before = dict(kern.checked)
    counted, wraps = 0, {}
    t0 = time.perf_counter()

    def hold(kind, shape, a, b, c, inj, ce):
        nonlocal counted
        kern.hold(kind, shape, a, b, c, _scalars(inj), ce)
        _, det, unc = kern.last
        nk = a.shape[1] // shape.bk
        if inj.enabled and inj.every >= ce:
            tiles = det.numel()
            want = tiles * len(range(0, nk, inj.every))
            ok = int(det.sum()) == want and int(unc.sum()) == (
                want if kind == "global" else 0)
            if not ok:
                raise AssertionError(
                    f"{KIND_NAMES[kind]}_int8 {shape.name} {tuple(a.shape)}"
                    f" every {inj.every}, check every {ce}: detected"
                    f" {int(det.sum())} of {want}, {int(unc.sum())}"
                    f" uncorrectable")
            counted += 1

    for shape in SHAPES.values():
        runs = [(size, -9, 9) for size in SIZES]
        runs += [(INT8_WIDE_SIZE, -127, 127)]
        for size, low, high in runs:
            a, b, c = _padded(_int8_host(size, size, size, gen, low, high),
                              shape, torch.int8)
            nk = a.shape[1] // shape.bk
            ref = InjectionSpec.reference_like(size, shape.bk)
            scheds = [InjectionSpec.none(), ref,
                      InjectionSpec(True, ref.every, col_stride=0)]
            scheds += [InjectionSpec(True, e) for e in INT8_EVERY]
            for inj in scheds:
                for kind in INT8_KINDS:
                    ce = ft._plan(kind, None, False, inj, nk, shape.bn)[1]
                    for every in sorted({ce, MID_STAGE_EVERY}):
                        hold(kind, shape, a, b, c, inj, every)
        host = _int8_host(512, 512, TIMING_SIZE, gen, INT8_WRAP_LOW, 127)
        a, b, c = _padded(host, shape, torch.int8)
        prod = (torch.from_numpy(host[0]).cuda().double()
                @ torch.from_numpy(host[1]).cuda().double().T)
        wraps[shape.name] = (
            float(prod.reshape(512, -1, shape.bn).sum(-1).max()) > 2 ** 31,
            float(prod.reshape(-1, shape.bm, 512).sum(1).max()) > 2 ** 31,
            float(prod.reshape(512 // shape.bm, shape.bm, -1, shape.bn)
                  .sum((1, 3)).min()) > 2 ** 31)
        for inj in (InjectionSpec.none(),
                    InjectionSpec.reference_like(TIMING_SIZE, shape.bk)):
            for kind in INT8_KINDS:
                ce = ft._plan(kind, None, False, inj, a.shape[1] // shape.bk,
                              shape.bn)[1]
                hold(kind, shape, a, b, c, inj, ce)
    done = {k: n - before[k] for k, n in kern.checked.items()
            if n - before[k]}
    log(f"phase int8 kernels: {done} comparisons with the plain versions"
        f" pass (grids and C equal bit for bit), {counted} of them with at"
        f" most one fault a check interval detecting every fault; at K ="
        f" {TIMING_SIZE} on [{INT8_WRAP_LOW}, 127] the checksums that pass"
        f" 2^31 (row band, column band, every tile total) at each tile:"
        f" {wraps} ({time.perf_counter() - t0:.1f} s)")


def phase_int8_path(kern: Kernels):
    """The ``ft_sgemm`` program with ``--dtype=int8`` at VERIFY_SIZE, with
    the launch counters set to 0 just before and read just after: (b) the
    verification (ids 0 and 11-16; 1-6 and 10 print their skip line) under
    rowcol and global with the static, auto and adaptive thresholds, every
    fault detected (global: every event, each uncorrectable; rowcol: none
    uncorrectable); the int8 GFLOPS table at TIMING_SIZE (ids 0 and 11-16)
    under both strategies; (c) clean runs of ids 11-16 in every strategy
    and mode flag nothing and give the exact oracle's C bit for bit; (d)
    reference-like faults of magnitude 1, which the static 9500 misses
    (nothing detected, C keeps them) and adaptive's 0.5 catches (rowcol:
    each corrected, C the oracle's; global: every event), auto's verdict
    logged. Every int8 kernel must have launched."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import kernel_for_id
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops.common import as_f32
    from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
    from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

    n = VERIFY_SIZE
    kern.zero_counts()
    t0 = time.perf_counter()
    for strategy in INT8_KINDS:
        for mode in INT8_MODES:
            details = {}
            ok = cli.run_verification(n, 0, 16, strategy=strategy,
                                      threshold=mode, in_dtype="int8",
                                      details=details)
            for kid, d in details.items():
                if d["detected"] != d["expected"] or d["uncorrectable"] != (
                        d["detected"] if strategy == "global" else 0):
                    ok = False
            if not ok or sorted(details) != list(range(11, 17)):
                raise AssertionError(f"int8 {strategy} threshold {mode}:"
                                     f" {details}")
            log(f"phase verify int8 {strategy} threshold {mode}: ids 0, 11-16"
                f" pass at {n}; detected/expected faults "
                + ", ".join(f"{k}:{d['detected']}/{d['expected']}"
                            for k, d in sorted(details.items())))
    tables = {}
    for strategy in INT8_KINDS:
        tables[strategy] = cli.run_perf_table(
            TIMING_SIZE, TIMING_SIZE, 1, 0, 16, min_device_time=PERF_MINTIME,
            strategy=strategy, in_dtype="int8")
    a, b = (cli.quantize_for_dtype(x, "int8")
            for x in runtime.generate_reference_driver_inputs(n))
    a, b, c = (as_f32(x, "cuda") for x in (a, b, np.zeros_like(a)))
    want = sgemm_reference(a, b, c, kern.alpha, kern.beta, in_dtype="int8",
                           device="cuda")
    unit = {}
    for strategy in INT8_KINDS:
        for kid in range(11, 17):
            _, shape, _ = kernel_for_id(kid)
            inj = InjectionSpec.reference_like(n, shape.bk, magnitude=1.0)
            tiles = -(-n // shape.bm) * -(-n // shape.bn)
            expected = tiles * inj.expected_faults(n, shape.bk)
            for mode in INT8_MODES:
                ft = make_ft_sgemm(shape.name, alpha=kern.alpha,
                                   beta=kern.beta, strategy=strategy,
                                   threshold=mode, in_dtype="int8",
                                   device="cuda")
                what = f"int8 {strategy} id {kid} threshold {mode}"
                clean = ft(a, b, c)
                if (int(clean.num_detected) or int(clean.num_uncorrectable)
                        or not torch.equal(clean.c, want)):
                    raise AssertionError(
                        f"{what}: a clean run flagged"
                        f" {int(clean.num_detected)}, C off the oracle at"
                        f" {int((clean.c != want).sum())} elements")
                res = ft(a, b, c, inj)
                det, unc = int(res.num_detected), int(res.num_uncorrectable)
                nbad = int((res.c != want).sum())
                unit[what] = (det, unc, nbad)
                if mode == "static":
                    ok = det == 0 and nbad > 0
                elif mode == "auto":
                    ok = True   # logged: auto's floor is data's, not 0.5
                elif strategy == "global":
                    ok = det == expected and unc == det
                else:
                    ok = det == expected and unc == 0 and nbad == 0
                if not ok:
                    raise AssertionError(
                        f"{what}, faults of magnitude 1: detected {det} of"
                        f" {expected}, uncorrectable {unc}, {nbad} elements"
                        f" off the oracle")
    counts = kern.counts()
    log(f"phase int8 clean: ids 11-16 under {INT8_KINDS}, {INT8_MODES}, flag"
        f" nothing at {n}, C equal to the exact oracle's bit for bit")
    log(f"phase int8 unit faults (magnitude 1, (detected, uncorrectable,"
        f" elements off)): {unit}")
    log(f"phase int8 path: {time.perf_counter() - t0:.1f} s, launches"
        f" {counts}")
    missing = [name for name, k in kern.table.items()
               if k["counter"] == "int8_launches" and counts[name] == 0]
    if missing:
        raise AssertionError(f"int8 kernels never launched on the int8"
                             f" path: {missing}")
    return counts, tables


def _fp8_wide_host(m, n, k, gen):
    """Host (A, B, C): A and B uniform in ±FP8_WIDE (e4m3's range, rounded
    by the entry points), C standard normal."""
    return (gen.uniform(-FP8_WIDE, FP8_WIDE, (m, k)).astype(np.float32),
            gen.uniform(-FP8_WIDE, FP8_WIDE, (n, k)).astype(np.float32),
            gen.standard_normal((m, n)).astype(np.float32))


def _wide_scalars(inj, kind, shape):
    """The scalar argument for the wide fp8 data: FP8_WIDE_THRESHOLD and the
    re-checks scaled as "auto" scales them (global: times sqrt(bn))."""
    from ft_sgemm_tpu_torch.ops.common import scalar_operand

    t = FP8_WIDE_THRESHOLD * (np.sqrt(shape.bn) if kind == "global" else 1.0)
    return scalar_operand(inj, (t, t * shape.bm / np.sqrt(3.0),
                                t * shape.bm ** 2 / np.sqrt(5.0)))


def _every_fault_detected(kern: Kernels, kind, nk, inj, ce, what) -> bool:
    """Where a check every ``ce`` of the ``nk`` bk steps meets at most one
    fault of ``inj`` (enabled, its period at least ``ce``), the last held launch
    (``kern.last``) must have detected every fault: B3, B5, B6 and B7 each
    corrected and none left uncorrectable, B4 and B8 one event each.
    Returns whether the schedule was such."""
    if not inj.enabled or inj.every < ce or kind == "precomp":
        return False
    _, det, unc = kern.last
    want = det.numel() * len(range(0, nk, inj.every))
    if int(det.sum()) != want or int(unc.sum()) != (
            want if kind in DETECT_ONLY else 0):
        raise AssertionError(
            f"{what} every {inj.every}, check every {ce}: detected"
            f" {int(det.sum())} of {want}, {int(unc.sum())} uncorrectable")
    return True


def phase_fp8_kernels(kern: Kernels):
    """B1-B5 in fp8 against their plain versions (the FP32 tile
    algorithm on the same e4m3-rounded operands) at every tile of the
    port's table: at BF16_SIZES on the program's ±0.9 data, clean,
    reference-like, col_stride=0 (B2, and B5, B3, B4 at the program's
    cadence) and with faults every 1, 3 and ODD_EVERY bk steps (INT8_EVERY)
    at a cadence that checks once per fault (every 1 and 3: as often as
    the faults; ODD_EVERY: every MID_STAGE_EVERY), which puts faults and
    checks inside a 32-deep k step; B5, B3 (multifault on) and B4 also at
    the mid-stage cadence; then at FP8_WIDE_SIZE on data spread over
    ±FP8_WIDE, clean and with faults of FP8_WIDE_MAGNITUDE every 1 and 3 bk
    steps, under FP8_WIDE_THRESHOLD. Grids equal, C within verify_matrix's
    rule on the correctable tiles; where a check interval holds one fault,
    every fault detected (B5 and B3: each corrected, none uncorrectable;
    B4: one event each). B1 and every clean FT launch are held to
    BF16_ACCURACY against the f32 product of the rounded operands, and
    that product rounded to bf16 must fail it."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    gen = np.random.default_rng(43)
    before = dict(kern.checked)
    worst, control, counted = {}, 1.0, 0
    t0 = time.perf_counter()
    f8 = torch.float8_e4m3fn

    def hold(kind, shape, a, b, c, sc, inj, oracle, at, wide, *args):
        nonlocal counted
        out = kern.hold(kind, shape, a, b, c, sc, *args,
                        scale_tol=BF16_ACCURACY if wide else None)
        if not inj.enabled:
            bf16_accuracy(out, oracle, f"{KIND_NAMES[kind]}_fp8 {at} {args}",
                          worst)
            return
        ce = args[0] if args else a.shape[1] // shape.bk
        counted += _every_fault_detected(
            kern, kind, a.shape[1] // shape.bk, inj, ce,
            f"{KIND_NAMES[kind]}_fp8 {at}")

    for shape in SHAPES.values():
        runs = [(size, False) for size in BF16_SIZES] + [(FP8_WIDE_SIZE, True)]
        for size, wide in runs:
            host = (_fp8_wide_host if wide else _random)(size, size, size, gen)
            a, b, c = _padded(host, shape, f8)
            oracle = rounded_oracle(kern, a, b, c)
            at = f"{shape.name} {size}" + (" ±448" if wide else "")
            control = min(control, bf16_control(oracle, f"B1 {at}"))
            bf16_accuracy(kern.hold("sgemm", shape, a, b, c,
                                    scale_tol=BF16_ACCURACY if wide else None),
                          oracle, f"sgemm_fp8 {at}", worst)
            nk = a.shape[1] // shape.bk
            quarter = max(1, nk // 4)
            mag = FP8_WIDE_MAGNITUDE if wide else None
            # (schedule, whether it is one of the periods of INT8_EVERY)
            if wide:
                scheds = [(InjectionSpec.none(), False)] + [
                    (InjectionSpec(True, e, magnitude=mag), True)
                    for e in INT8_EVERY[:2]]
            else:
                ref = InjectionSpec.reference_like(size, shape.bk)
                scheds = [(InjectionSpec.none(), False), (ref, False),
                          (InjectionSpec(True, ref.every, col_stride=0),
                           False)]
                scheds += [(InjectionSpec(True, e), True) for e in INT8_EVERY]
            for inj, dense in scheds:
                def sc(kind):
                    return (_wide_scalars(inj, kind, shape) if wide
                            else _scalars(inj))

                def cadence(strategy):
                    return ft._plan(strategy, None, None, inj, nk, shape.bn)[1]

                args = (shape, a, b, c)
                tail = (inj, oracle, at, wide)
                if dense:
                    # One fault a check interval: checks every `every` bk
                    # steps (ODD_EVERY: every MID_STAGE_EVERY).
                    ce = min(inj.every, MID_STAGE_EVERY)
                    hold("running", *args, sc("running"), *tail, ce)
                    hold("rowcol", *args, sc("rowcol"), *tail, ce, True)
                    hold("global", *args, sc("global"), *tail, ce)
                    continue
                hold("precomp", *args, sc("precomp"), *tail)
                ce = cadence("weighted")
                mid = {MID_STAGE_EVERY} if inj.col_stride else set()
                for ce in sorted({ce if ce < nk else quarter} | mid):
                    hold("running", *args, sc("running"), *tail, ce)
                for mf in (False, True):
                    hold("rowcol", *args, sc("rowcol"), *tail,
                         cadence("rowcol"), mf)
                hold("global", *args, sc("global"), *tail, cadence("global"))
                for ce in sorted(mid):
                    hold("rowcol", *args, sc("rowcol"), *tail, ce, True)
                    hold("global", *args, sc("global"), *tail, ce)
    done = {k: n - before[k] for k, n in kern.checked.items()
            if n - before[k]}
    log(f"phase fp8 kernels: {done} comparisons with the plain versions"
        f" pass (grids equal), {counted} of them with one fault a check"
        f" interval detecting every fault, max |dC|"
        f" { {k: kern.max_err[k] for k in done} }; B1 and clean launches"
        f" against the rounded operands' f32 product, max |dC| / max |C|"
        f" {worst} (gate {BF16_ACCURACY}; C rounded to bf16 {control:.3g}"
        f" at least) ({time.perf_counter() - t0:.1f} s)")
    return worst


def phase_fp8_residual(kern: Kernels):
    """The FT kernels' clean fp8 residuals at VERIFY_SIZE on A and B spread
    over e4m3's range (``_fp8_wide_host``: products of e4m3 values below 1 are
    multiples of 2^-18 and their sums at these sizes exact in f32, so the
    program's data leave residuals of 0) under threshold="auto" (the
    wrapper's thresholds, from the rounded operands; where short
    tensor-core sums would show): each
    FT kernel at every tile the fp8 program launches it on (B2 at its one
    check, B5 at small, B3 and B4 at the program's cadence) runs clean with
    the auto thresholds cut FP8_RESIDUAL_MARGIN times and must flag
    nothing; and, with C = 0 and alpha = 1 (the output is the
    accumulator), the largest residual of the accumulator's checksums
    against float64 expectations of the rounded operands (weighted:
    moments 1, w, w^2; rowcol: row and column sums; global: tile totals)
    over its auto threshold is logged for every build and must stay under
    1 / FP8_RESIDUAL_MARGIN. Returns {kernel: largest share}."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops.common import (
        DEFAULT_THRESHOLD_MARGIN, estimate_noise_floor, scalar_operand)

    ft = kern.ft
    n = VERIFY_SIZE
    host = _fp8_wide_host(n, n, n, np.random.default_rng(47))
    host = (*host[:2], np.zeros_like(host[2]))
    none = InjectionSpec.none()
    shares, flagged = {}, {}
    for kind, tiles in (("precomp", PROGRAM_TILES[2:] + ("huge",)),
                        ("running", ("small",)),
                        ("rowcol", PROGRAM_TILES), ("global", PROGRAM_TILES)):
        for tile in tiles:
            shape = SHAPES[tile]
            a, b, c = _padded(host, shape, torch.float8_e4m3fn)
            strategy = "weighted" if kind in ("precomp", "running") else kind
            plan, ce, mf = ft._plan(strategy, None, None, none,
                                    n // shape.bk, shape.bn)
            if kind == "running":
                ce = max(1, (n // shape.bk) // 4)   # B5's intermediate checks
            elif plan != kind:
                raise AssertionError(f"fp8 {strategy} runs {plan} at {tile}")
            thr = float(DEFAULT_THRESHOLD_MARGIN * estimate_noise_floor(
                a[:n, :n], b[:n, :n], None, 1.0, 0.0))
            if kind == "global":
                thr *= float(np.sqrt(shape.bn))
            thr3 = (thr, thr * shape.bm / np.sqrt(3.0),
                    thr * shape.bm ** 2 / np.sqrt(5.0))
            extra = ft.kernel_inputs(kind, a, b, shape)
            cut = scalar_operand(none, tuple(t / FP8_RESIDUAL_MARGIN
                                             for t in thr3))
            acc, det, unc = ft.run_kernel(kind, shape, a, b, c, extra, 1.0,
                                          0.0, cut, ce, mf)
            name = f"{KIND_NAMES[kind]}_fp8 {tile}"
            if int(det.sum()) or int(unc.sum()):
                flagged[name] = int(det.sum())
            ad, bd, accd = a.double(), b.double(), acc.double()
            if kind in ("precomp", "running"):
                t = accd.reshape(n // shape.bm, shape.bm, -1)
                am = ad.reshape(n // shape.bm, shape.bm, -1)
                w = torch.arange(1, shape.bm + 1, device="cuda",
                                 dtype=torch.float64)[None, :, None]
                share = max(
                    float(((w ** v * am).sum(1) @ bd.T
                           - (w ** v * t).sum(1)).abs().max()) / thr3[v]
                    for v in range(3))
            elif kind == "rowcol":
                r_exp = ad @ bd.reshape(-1, shape.bn, n).sum(1).T
                c_exp = ad.reshape(-1, shape.bm, n).sum(1) @ bd.T
                share = max(
                    float((r_exp - accd.reshape(n, -1, shape.bn).sum(-1))
                          .abs().max()),
                    float((c_exp - accd.reshape(-1, shape.bm, n).sum(1))
                          .abs().max())) / thr
            else:
                t_exp = (ad.reshape(-1, shape.bm, n).sum(1)
                         @ bd.reshape(-1, shape.bn, n).sum(1).T)
                totals = accd.reshape(n // shape.bm, shape.bm, n // shape.bn,
                                      shape.bn).sum((1, 3))
                share = float((t_exp - totals).abs().max()) / thr
            shares[name] = float(share)
    log(f"phase fp8 residual: at {n} under threshold auto, clean launches"
        f" at the threshold / {FP8_RESIDUAL_MARGIN:g} flagged {flagged};"
        f" largest clean residual over its threshold {shares}")
    bad = {k: v for k, v in shares.items() if v > 1.0 / FP8_RESIDUAL_MARGIN}
    if bad or flagged:
        raise AssertionError(f"fp8 clean residuals {bad} are not"
                             f" {FP8_RESIDUAL_MARGIN:g}x under the auto"
                             f" threshold")
    return shares


def phase_variant(kern: Kernels, so):
    """B6 at the small tile from the regression variant's library (its
    scalar argument read from device memory), at 4096 with the program's
    reference-like faults and cadence: it must detect every fault (tiles
    times faults a tile), nothing uncorrectable, and give the by-value
    build's grids and C on the same launch."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops.common import (
        NOISE_C_BIAS,
        NOISE_C_RAND,
        LaunchAxes,
        epilogue_args,
        full_run_log2,
    )

    ft = kern.ft
    n, shape = TIMING_SIZE, SHAPES["small"]
    fn = _build.bind(ctypes.CDLL(str(so)), "ftsg_ft_fused",
                     ft._entries()["fused"].argtypes)
    a, b, c = _padded(_random(n, n, n, np.random.default_rng(23)), shape)
    inj = InjectionSpec.reference_like(n, shape.bk)
    _, ce, _ = ft._plan("fused", None, None, inj, n // shape.bk, shape.bn,
                        "mxu")
    sc = _scalars(inj)
    (ma,) = ft.kernel_inputs("fused", a, b, shape)
    out = torch.empty_like(c)
    grid = (n // shape.bm, n // shape.bn)
    det = torch.empty(grid, dtype=torch.int32, device="cuda")
    unc = torch.empty_like(det)
    _build.check_launch(fn(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), ma.data_ptr(),
        out.data_ptr(), det.data_ptr(), unc.data_ptr(), n, n, n, shape.bm,
        shape.bn, shape.bk, ce, kern.alpha, kern.beta, sc.ctypes.data,
        full_run_log2(n // shape.bk, shape.bk, shape.bm, shape.bn),
        NOISE_C_RAND, NOISE_C_BIAS, *epilogue_args(None),
        *LaunchAxes().args(),
        torch.cuda.current_stream().cuda_stream), VARIANT)
    got = ft.run_kernel("fused", shape, a, b, c, (ma,), kern.alpha, kern.beta,
                        sc, ce)
    torch.cuda.synchronize()
    expected = grid[0] * grid[1] * inj.expected_faults(n, shape.bk)
    found = int(det.sum())
    if (found != expected or int(unc.sum()) or not torch.equal(det, got[1])
            or not torch.equal(unc, got[2])):
        raise AssertionError(
            f"{VARIANT} B6 small: detected {found} of {expected},"
            f" {int(unc.sum())} uncorrectable; by value"
            f" {int(got[1].sum())}, {int(got[2].sum())}")
    dc = float((out - got[0]).abs().max())
    if dc > 1e-2:
        raise AssertionError(f"{VARIANT} B6 small: C off the by-value build's"
                             f" by {dc}")
    log(f"phase variant ({VARIANT}): B6 small at {n}, check every {ce},"
        f" detects {found} of {expected} faults, none uncorrectable, grids"
        f" equal to the by-value build's, max |dC| {dc}")


def _same_launch(got, want) -> bool:
    """Two launches' results (B1: C; B2-B8: (C, det, unc)) equal bit for
    bit, NaN where NaN."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(x, y) if not x.is_floating_point()
               else torch.equal(x.isnan(), y.isnan())
               and torch.equal(x.nan_to_num(), y.nan_to_num())
               for x, y in zip(got, want))


def phase_variants(kern: Kernels):
    """The variant axes and the f32 precision (VARIANT_AXES): every body in
    every dtype it has (VARIANT_BUILDS) under a pipeline depth of 3, the
    grid order "nm", the dimension semantics "arbitrary" and all three
    together, against its plain version at VARIANT_TILES and VARIANT_SIZES
    (and "test" at depth 3), with reference-like faults (the step's bk:
    the schedule counts grid steps) at the cadence the program gives each
    kernel's strategy (B5 at four checks a run, so that it checks inside
    the run): grids equal, C within verify_matrix's rule (int8 bit for
    bit). At depth 3 also the adaptive f32 builds of B3-B8, with
    TINY_MAGNITUDE faults at the adaptive cadence. Each "nm" launch equals
    its "mn" launch bit for bit. Then f32 "default" of B1-B8 (one TF32 pass)
    under the default axes and all three, against the one-product plain
    version at every tile of PROGRAM_TILES, and the adaptive one-pass
    builds of B3-B8 there on ONE_PASS_EXACT operands; and "high" against
    "highest" through make_sgemm and make_ft_sgemm, bit for bit."""
    from ft_sgemm_tpu_torch.configs import SHAPES, KernelVariant
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops.common import launch_axes, step_shape

    ft = kern.ft
    gen = np.random.default_rng(31)
    before = dict(kern.checked)
    t0 = time.perf_counter()
    hosts = {size: (_random(size, size, size, gen),
                    _int8_host(size, size, size, gen, -9, 9))
             for size in VARIANT_SIZES}
    combos = [(KernelVariant(**ax), False) for ax in VARIANT_AXES]
    combos += [(KernelVariant(), True), (combos[-1][0], True)]
    same = 0
    for var, one_pass in combos:
        axes = launch_axes(var, one_pass)
        builds = ([(k, "float32") for k in ("sgemm",) + FT_KINDS]
                  if one_pass else VARIANT_BUILDS)
        deep = var.pipeline_depth == 3 and not one_pass
        tiles = (PROGRAM_TILES if one_pass
                 else VARIANT_TILES + (("test",) if deep else ()))
        for tile in tiles:
            shape = step_shape(SHAPES[tile], var)
            for size in VARIANT_SIZES[:1] if tile == "test" else VARIANT_SIZES:
                inj = InjectionSpec.reference_like(size, shape.bk)
                ops = {}
                runs = [(kind, dt, False) for kind, dt in builds]
                if deep or one_pass:
                    runs += [(kind, "float32", True) for kind in ADAPTIVE_KINDS]
                for kind, dt, adaptive in runs:
                    key = "exact" if one_pass and adaptive else dt
                    if key not in ops:
                        host = hosts[size][dt == "int8" or key == "exact"]
                        if key == "exact":
                            host = tuple(x / ONE_PASS_EXACT for x in host)
                        ops[key] = _padded(host, shape, TORCH_DTYPES[dt])
                    a, b, c = ops[key]
                    nk = a.shape[1] // shape.bk
                    run_inj = (InjectionSpec.reference_like(
                        size, shape.bk, magnitude=TINY_MAGNITUDE)
                        if adaptive else inj)
                    sc = (_adaptive_scalars if adaptive else _scalars)(run_inj)
                    ce, mf = None, False
                    if kind != "sgemm":
                        strategy, encode = KIND_PAIR[kind]
                        _, ce, mf = ft._plan(strategy, None, None, run_inj, nk,
                                             shape.bn, encode, adaptive)
                        ce = {"precomp": nk,
                              "running": max(1, nk // 4)}.get(kind, ce)
                        mf = mf and dt != "int8"
                    kern.hold(kind, shape, a, b, c, sc, ce, mf,
                              adaptive=adaptive, axes=axes)
                    if axes.nm:
                        got = kern.last
                        mn, _ = kern.calls(kind, shape, a, b, c, sc, ce, mf,
                                           adaptive, axes=axes._replace(nm=False))
                        want = mn()
                        torch.cuda.synchronize()
                        if not _same_launch(got, want):
                            raise AssertionError(
                                f"{kernel_name(kind, a, adaptive, one_pass)}"
                                f" {tile}"
                                f" {size} {var}: grid order nm differs from"
                                " mn")
                        same += 1
    done = {k: n - before[k] for k, n in kern.checked.items() if n - before[k]}
    # "high" runs the 3xTF32 kernels as "highest" does.
    from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
    from ft_sgemm_tpu_torch.ops.sgemm import make_sgemm

    size = VARIANT_SIZES[0]
    a, b, c = _random(size, size, size, gen)
    highs = 0
    for tile in VARIANT_TILES:
        inj = InjectionSpec.reference_like(size, SHAPES[tile].bk)
        runs = {"B1": lambda p: make_sgemm(tile, precision=p)(a, b, c)}
        for strategy, encode in ALL_PAIRS:
            runs[f"{strategy}/{encode}"] = (
                lambda p, s=strategy, e=encode: tuple(make_ft_sgemm(
                    tile, strategy=s, encode=e, precision=p)(a, b, c, inj)))
        for what, fn in runs.items():
            if not _same_launch(fn("high"), fn("highest")):
                raise AssertionError(f"{what} {tile}: precision high differs"
                                     " from highest")
            highs += 1
    torch.cuda.synchronize()
    log(f"phase variants: {done} comparisons with the plain versions pass"
        f" (grids equal) under {[dict(ax) for ax in VARIANT_AXES]} and f32"
        f" precision default; {same} nm launches equal to mn bit for bit;"
        f" {highs} high launches equal to highest bit for bit; max |dC|"
        f" { {k: kern.max_err[k] for k in done} }"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_adaptive_kernels(kern: Kernels, lowp=False):
    """The adaptive builds against their plain versions at every tile of the
    port's table: those of B3-B8 in f32, or (``lowp``) the adaptive bf16
    builds of B3-B8 in bf16 (BF16_ADAPTIVE_KINDS) and of B5, B3 and B4 in
    fp8 (the wrappers widen the e4m3 operands to bf16; fp8 carries no
    moment rows). The data: the program's at ADAPTIVE_SIZES, clean,
    with reference-like faults of magnitude TINY_MAGNITUDE, and (f32) the
    same with col_stride=0 or (bf16) TINY_MAGNITUDE faults every 1, 3 and
    ODD_EVERY bk steps (INT8_EVERY); in fp8 also data spread over ±FP8_WIDE
    at FP8_WIDE_SIZE, clean and with FP8_WIDE_MAGNITUDE faults every 1 and
    3 bk steps. The faults have magnitude TINY_MAGNITUDE, the faults these
    thresholds exist to catch: a corrected fault of 1e4 leaves a rounding
    residue of the order of the adaptive thresholds at later checks, where
    any two summation orders decide differently (phase threshold path).
    Each kernel runs at the cadence the program gives it under
    threshold="adaptive" (both rowcol kernels with multifault off and on)
    and, but for col_stride=0, every MID_STAGE_EVERY bk steps (the rowcol
    kernels with multifault on: several faults an interval), checks inside
    a 32-column stage; the dense schedules check once per fault (every 1 or
    MID_STAGE_EVERY bk steps). At bk = 8 those checks fall between the
    halves of a 16-deep bf16 k step, where a check must see the running
    moments through its own 8-column step. Grids equal, C within
    verify_matrix's rule (the wide data: BF16_ACCURACY of max |C|) on the
    correctable tiles; in bf16 and fp8, where a check interval holds one
    fault, every fault detected."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    gen = np.random.default_rng(29 if lowp else 13)
    before = dict(kern.checked)
    counted = 0
    t0 = time.perf_counter()
    for shape in SHAPES.values():
        data = [(size, torch.bfloat16 if lowp else torch.float32)
                for size in ADAPTIVE_SIZES]
        if lowp:
            data.append((FP8_WIDE_SIZE, torch.float8_e4m3fn))
        for size, dtype in data:
            wide = dtype == torch.float8_e4m3fn
            host = (_fp8_wide_host if wide else _random)(size, size, size, gen)
            a, b, c = _padded(host, shape, dtype)
            nk = a.shape[1] // shape.bk
            scheds = [(InjectionSpec.none(), False)]
            if wide:
                scheds += [(InjectionSpec(True, e, FP8_WIDE_MAGNITUDE), True)
                           for e in INT8_EVERY[:2]]
            else:
                ref = InjectionSpec.reference_like(size, shape.bk,
                                                   magnitude=TINY_MAGNITUDE)
                scheds.append((ref, False))
                scheds += ([(InjectionSpec(True, e, TINY_MAGNITUDE), True)
                            for e in INT8_EVERY] if lowp else
                           [(InjectionSpec(True, ref.every, TINY_MAGNITUDE,
                                           0), False)])
            kinds = (ADAPTIVE_KINDS if not lowp else LOWP_ADAPTIVE_KINDS
                     if wide else BF16_ADAPTIVE_KINDS)
            for inj, dense in scheds:
                sc = _adaptive_scalars(inj)
                for kind in kinds:
                    strategy, encode = KIND_PAIR[kind]
                    plan, ce, _ = ft._plan(strategy, None, None, inj, nk,
                                           shape.bn, encode, adaptive=True)
                    if plan != kind:
                        raise AssertionError(f"adaptive {strategy}/{encode}"
                                             f" runs {plan}, not {kind}")
                    multi = kind in ("rowcol", "rowcol_mxu")
                    if dense:
                        runs = {(min(inj.every, MID_STAGE_EVERY), multi)}
                    else:
                        runs = {(ce, False), (ce, multi)}
                        if inj.col_stride:
                            runs.add((MID_STAGE_EVERY, multi))
                    for every, mf in sorted(runs):
                        kern.hold(kind, shape, a, b, c, sc, every, mf,
                                  adaptive=True,
                                  scale_tol=BF16_ACCURACY if wide else None)
                        if lowp:
                            counted += _every_fault_detected(
                                kern, kind, nk, inj, every,
                                f"{kernel_name(kind, a, True)} {shape.name}"
                                f" {size}")
    done = {k: n - before[k] for k, n in kern.checked.items()
            if n - before[k]}
    log(f"phase adaptive kernels{' bf16/fp8' if lowp else ''}: {done}"
        f" comparisons with the plain versions pass (grids equal)"
        + (f", {counted} of them with one fault a check interval detecting"
           f" every fault" if lowp else "")
        + f", max |dC| { {k: kern.max_err[k] for k in done} }"
        f" ({time.perf_counter() - t0:.1f} s)")


def _bracket_operands(base, shape, tk, global_tile):
    """Banded copies of the host operands ``base`` (A's row bands scaled by
    BRACKET_A, B's by BRACKET_B, in turn) and a fault magnitude, the mean
    of the unscaled tiles' adaptive thresholds at the check that closes
    column ``tk`` (host twin, ``analysis.adaptive_threshold_grid``), so
    that tile (i, j)'s threshold sits near BRACKET_A[i % 2] *
    BRACKET_B[j % 2] times the fault: (a, b, the twin's thresholds over the
    magnitude, the magnitude)."""
    from ft_sgemm_tpu_torch import analysis

    def grid(a, b):
        return analysis.adaptive_threshold_grid(
            a, b, bm=shape.bm, bn=shape.bn, k_cols=tk,
            global_tile=global_tile)

    a, b = base
    magnitude = float(np.float32(np.mean(grid(a, b))))
    sa = np.resize(np.asarray(BRACKET_A, np.float32), a.shape[0] // shape.bm)
    sb = np.resize(np.asarray(BRACKET_B, np.float32), b.shape[0] // shape.bn)
    a = a * np.repeat(sa, shape.bm)[:, None]
    b = b * np.repeat(sb, shape.bn)[:, None]
    return a, b, grid(a, b) / magnitude, magnitude


def phase_adaptive_bracket(kern: Kernels):
    """Each adaptive build at every tile at VERIFY_SIZE, at the cadence
    and multifault setting the program gives it under threshold="adaptive"
    (the rowcol kernels with multifault off and on), with one fault in
    every tile at the first bk step, on banded operands that put each
    tile's threshold at the check that catches it (the first) near 0.125,
    0.5 or 2 times the fault by the host twin (``_bracket_operands``). A threshold off by a factor of 2 either way
    changes the grids. The kernel and its plain version must each give:
    rowcol, a detection and its correction in exactly the tiles under the
    fault (C then held to the plain version's); global, a detection,
    uncorrected, in exactly those tiles (C too); weighted, no detection in
    a tile over the fault, and a detection or an uncorrectable report in
    every tile under it. A fault this near the threshold is too small for
    the weighted ratio to place reliably (a re-check may pass a neighbouring
    row), and the w^2 re-check can flag one the detection missed; the
    rounding of either side decides those, so the weighted grids and C are
    not compared with each other."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

    ft = kern.ft
    n = VERIFY_SIZE
    gen = np.random.default_rng(17)
    base = _random(n, n, n, gen)[:2]
    zero = np.zeros((n, n), np.float32)
    launches = {}
    weighted = {}
    t0 = time.perf_counter()
    for tile in PROGRAM_TILES:
        shape = SHAPES[tile]
        nk = n // shape.bk
        operands = {}
        for kind in ADAPTIVE_KINDS:
            strategy, encode = KIND_PAIR[kind]
            _, ce, mf = ft._plan(strategy, None, None,
                                 InjectionSpec.reference_like(n, shape.bk),
                                 nk, shape.bn, encode, adaptive=True)
            glob = kind in DETECT_ONLY
            tk = min(ce, nk) * shape.bk
            if (tk, glob) not in operands:
                a, b, ratio, mag = _bracket_operands(base, shape, tk, glob)
                under = ratio < 1.0
                if ratio[under].max() > 0.7 or ratio[~under].min() < 1.4:
                    raise AssertionError(
                        f"bracket at {tile}, column {tk}: thresholds"
                        f" {ratio.min()}..{ratio.max()} times the fault")
                # one fault a tile, at bk step 0
                sc = _adaptive_scalars(InjectionSpec(True, nk, mag))
                operands[tk, glob] = (_padded((a, b, zero), shape), sc,
                                      torch.from_numpy(under).cuda())
            ops, sc, want = operands[tk, glob]
            for multi in ((False, True) if kind in ("rowcol", "rowcol_mxu")
                          else (mf,)):
                name = KIND_NAMES[kind] + "_adaptive"
                what = f"{name} {tile} (check every {ce}, multifault {multi})"
                run, plain = kern.calls(kind, shape, *ops, sc, ce, multi, True)
                got, ref = run(), plain()
                torch.cuda.synchronize()
                for side, (_, det, unc) in (("kernel", got), ("plain", ref)):
                    det, unc = det > 0, unc > 0
                    if kind in WEIGHTED_KINDS:
                        ok = (not (det & ~want).any()
                              and not (want & ~(det | unc)).any())
                        weighted.setdefault(what, []).append(
                            (int((det != want).sum()), int(unc.sum())))
                    else:
                        ok = (torch.equal(det, want)
                              and torch.equal(unc, want & glob))
                    if not ok:
                        raise AssertionError(
                            f"{what}, {side}: {int(det.sum())} tiles detect,"
                            f" {int(unc.sum())} uncorrectable, where the"
                            f" host twin puts {int(want.sum())} of"
                            f" {want.numel()} faults over the threshold")
                if kind not in WEIGHTED_KINDS:
                    ok, nbad, first = verify_matrix(ref[0], got[0],
                                                    verbose=False)
                    if not ok:
                        raise AssertionError(
                            f"{what}: C differs from the plain version at"
                            f" {nbad} elements (first {first})")
                    kern.max_err[name] = max(kern.max_err[name], float(
                        (got[0] - ref[0]).abs().max()))
                launches[name] = launches.get(name, 0) + 1
    log(f"phase adaptive bracket: {launches} launches at {VERIFY_SIZE} flag"
        f" the faults over their tiles' thresholds (host twin at"
        f" {BRACKET_A} x {BRACKET_B} of the fault) and no other, as the plain"
        f" versions do; weighted (kernel, plain) tiles whose detection is not"
        f" placed, and tiles uncorrectable: {weighted}"
        f" ({time.perf_counter() - t0:.1f} s)")


def _exact_bracket_operands(signs, shape):
    """Host A (M, K) and B (N, K) of the bf16 bracket from ``signs``, A's
    (M, K / 2) and B's (N, K / 2) ±1: A's column pair (2p, 2p + 1) is (x,
    -x) and B's (y, y), so that every pair of products cancels; A's row
    bands scaled by BRACKET_A and B's by BRACKET_B, in turn, at the tile;
    the four 4-column chunks of every 16 columns scaled by LOWP_BRACKET_K in
    both. Every value is ±1 times a power of 2: exact in bf16 and e4m3."""
    sa, sb = signs
    k = 2 * sa.shape[1]
    cols = np.resize(np.repeat(np.float32(LOWP_BRACKET_K), 4), k)

    def banded(x, scales, rows, pair):
        band = np.repeat(np.resize(np.float32(scales), x.shape[0] // rows),
                         rows)
        x = np.repeat(x, 2, axis=1) * np.resize(np.float32(pair), k)
        return (x * band[:, None] * cols).astype(np.float32)

    return (banded(sa, BRACKET_A, shape.bm, (1, -1)),
            banded(sb, BRACKET_B, shape.bn, (1, 1)))


def phase_lowp_bracket(kern: Kernels, in_dtype: str):
    """The adaptive bf16 builds in ``in_dtype``: of B3-B8 in bf16
    (BF16_ADAPTIVE_KINDS; B6-B8 on the wrapper's moment rows of the same
    exact operands), of B5, B3 and B4 in fp8 (widened by the wrappers), at
    every tile, M = N = VERIFY_SIZE and K =
    LOWP_BRACKET_DEPTH, against the host twin's thresholds to about 10 %.
    On ``_exact_bracket_operands`` the product is zero, every checksum
    cancels to zero and every moment sum is exact in f32, so that a tile's
    residual at a check is its one fault (at bk step 0), and the fault is
    caught exactly when it passes the tile's threshold, whose value the
    twin gives from the same sums. The tiles' thresholds at the check
    after column tk fall in the classes 0.125, 0.5 and 2 of tile (0, 0)'s
    T; faults of LOWP_BRACKET_FAULT times T, 0.9 T and 1.1 T, must be
    missed and caught in the 0.5 class, caught in the 0.125 class and
    missed in the 2 class. Each kernel runs at the cadence the program
    gives it at this depth (B3 and B7 with multifault off and on) and, at
    the tiles whose bk is 8, every MID_STAGE_EVERY bk steps: a check between
    the halves of a 16-deep k step, whose sums must end at its own 8
    columns. The columns' scales (LOWP_BRACKET_K) put 4 of the 7 parts of
    the step's sum of squares in its last 4 columns: a kernel that counts
    the whole step at such a check, reads the first 4 columns of B's half
    step for the last, or drops one of A's two fragment registers moves its
    thresholds by a fifth or more. Kernel and plain version each: the tiles that detect are
    the twin's; the detected tiles are corrected, none uncorrectable (B4,
    B8: each an event, uncorrectable); B3 and B7 with multifault off flag
    no tile uncorrectable (the re-checks of B5, B6 and of B3, B7 with
    multifault on may flag a missed fault by its row weight); C equal to
    the plain version's to 2 % of the fault."""
    from ft_sgemm_tpu_torch import analysis
    from ft_sgemm_tpu_torch.configs import SHAPES, canonical_in_dtype
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    ft = kern.ft
    n, k = VERIFY_SIZE, LOWP_BRACKET_DEPTH
    gen = np.random.default_rng(19)
    signs = tuple(gen.choice(np.float32([-1, 1]), (n, k // 2))
                  for _ in range(2))
    zero = np.zeros((n, n), np.float32)
    dtype = getattr(torch, canonical_in_dtype(in_dtype))
    launches, caught = {}, {}
    t0 = time.perf_counter()
    for tile in PROGRAM_TILES:
        shape = SHAPES[tile]
        nk = k // shape.bk
        a, b = _exact_bracket_operands(signs, shape)
        ops = _padded((a, b, zero), shape, dtype)
        for kind in (BF16_ADAPTIVE_KINDS if dtype == torch.bfloat16
                     else LOWP_ADAPTIVE_KINDS):
            glob = kind in DETECT_ONLY
            rowcol = kind in ("rowcol", "rowcol_mxu")
            strategy, encode = KIND_PAIR[kind]
            _, ce, mf = ft._plan(strategy, None, None,
                                 InjectionSpec.reference_like(k, shape.bk),
                                 nk, shape.bn, encode, adaptive=True)
            cadences = {ce, MID_STAGE_EVERY} if shape.bk == 8 else {ce}
            for every in sorted(cadences):
                thr = analysis.adaptive_threshold_grid(
                    a, b, bm=shape.bm, bn=shape.bn,
                    k_cols=min(every, nk) * shape.bk, global_tile=glob,
                    in_dtype=in_dtype)
                for ratio in LOWP_BRACKET_FAULT:
                    mag = float(np.float32(ratio * thr[0, 0]))
                    if np.abs(thr / mag - 1.0).min() < 0.05:
                        raise AssertionError(
                            f"bracket at {tile}, every {every}: thresholds"
                            f" {thr.min()}..{thr.max()}, fault {mag}")
                    want = torch.from_numpy(thr < mag).cuda()
                    sc = _adaptive_scalars(InjectionSpec(True, nk, mag))
                    for multi in (False, True) if rowcol else (mf,):
                        name = kernel_name(kind, ops[0], True)
                        what = (f"{name} {tile} (check every {every},"
                                f" multifault {multi}, fault {ratio} T)")
                        run, plain = kern.calls(kind, shape, *ops, sc, every,
                                                multi, True)
                        got, ref = run(), plain()
                        torch.cuda.synchronize()
                        for side, (_, det, unc) in (("kernel", got),
                                                    ("plain", ref)):
                            det, unc = det > 0, unc > 0
                            ok = torch.equal(det, want) and (
                                torch.equal(unc, det) if glob
                                else not (unc & det).any())
                            if rowcol and not multi:
                                ok = ok and not unc.any()
                            if not ok:
                                raise AssertionError(
                                    f"{what}, {side}: {int(det.sum())} tiles"
                                    f" detect, {int(unc.sum())}"
                                    f" uncorrectable, where the host twin"
                                    f" puts {int(want.sum())} of"
                                    f" {want.numel()} faults over the"
                                    f" threshold")
                        dc = float((got[0] - ref[0]).abs().max())
                        if dc > 0.02 * abs(kern.alpha) * mag:
                            raise AssertionError(
                                f"{what}: C differs from the plain version"
                                f" by {dc}, the fault {mag}")
                        kern.max_err[name] = max(kern.max_err[name], dc)
                        launches[name] = launches.get(name, 0) + 1
                        caught[ratio] = caught.get(ratio, 0) + int(want.sum())
    log(f"phase bracket {in_dtype}: {launches} launches at {n} x {n} x {k}"
        f" detect in exactly the tiles whose host-twin threshold the fault"
        f" passes, as the plain versions do, at {LOWP_BRACKET_FAULT} of the"
        f" 0.5 class's threshold (tiles caught, all launches: {caught})"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_accuracy(kern: Kernels):
    """B1 at every program tile against a float64 product of the same operands,
    beside cuBLAS FP32 (``torch.addmm`` with TF32 off): on the program's
    libc-rand verification inputs (C zero) and on the table's inputs at
    4096, the kernel's largest error must be at most twice cuBLAS's."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.ops.common import strict_fp32

    a, b = runtime.generate_reference_driver_inputs(VERIFY_SIZE)
    inputs = {"verification": (a, b, np.zeros_like(a)),
              "table": cli._host_inputs(TIMING_SIZE)}
    al, be = kern.alpha, kern.beta
    strict_fp32()
    for label, host in inputs.items():
        a, b, c = (torch.from_numpy(x).cuda() for x in host)
        exact = al * (a.double() @ b.double().T) + be * c.double()
        cublas = float((torch.addmm(c, a, b.T, beta=be, alpha=al).double()
                        - exact).abs().max())
        errs = {}
        for name in WGMMA_TILES:
            out = kern.sg.sgemm_kernel(*_padded(host, SHAPES[name]),
                                       SHAPES[name], al, be)
            errs[name] = float((out[:a.shape[0], :b.shape[0]].double()
                                - exact).abs().max())
        log(f"phase accuracy ({label} inputs, {a.shape[0]}): max |C - C_f64|"
            f" B1 3xTF32 {errs}, cuBLAS FP32 {cublas}")
        bad = {k: e for k, e in errs.items() if e > 2 * cublas}
        if bad:
            raise AssertionError(f"3xTF32 error {bad} exceeds twice cuBLAS"
                                 f" FP32's {cublas} ({label} inputs)")


def phase_path_shapes(kern: Kernels):
    """Each kernel against its plain version at what the program gives it:
    for every kernel id of 1-16, its tile and the kernel, cadence and
    multifault setting ``make_ft_sgemm`` picks (``ops/ft_sgemm._plan``)
    under the program's injection, on the verification's inputs at 4096
    under every (strategy, encode) pair, on the table's inputs at each of
    its sizes (weighted, as the table runs: K, and with it the fault period
    and the cadence, differ by size) and at 4096 under the pairs of
    TABLE_PAIRS. A launch that equals one already held (weighted with
    encode mxu runs fused's kernel at fused's cadence) is held once."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import ENCODE_MODES, KERNEL_TABLE, STRATEGIES, kernel_for_id

    ft = kern.ft
    before = dict(kern.checked)
    t0 = time.perf_counter()
    a, b = runtime.generate_reference_driver_inputs(VERIFY_SIZE)
    verify = (a, b, np.zeros_like(a))
    runs = [(VERIFY_SIZE, s, e, verify) for s in STRATEGIES for e in ENCODE_MODES]
    table = cli._host_inputs(TIMING_SIZE)
    runs += [(size, "weighted", "vpu",
              table if size == TIMING_SIZE else cli._host_inputs(size))
             for size in range(PERF_SIZES[0], PERF_SIZES[1] + 1, PERF_SIZES[2])]
    runs += [(TIMING_SIZE, s, e, table) for s, e in TABLE_PAIRS]
    seen = set()
    for size, strategy, encode, host in runs:
        for kid in sorted(KERNEL_TABLE):
            _, shape, is_abft = kernel_for_id(kid)
            if kid in (0, 10):
                continue   # no hand kernel
            if is_abft:
                _, inj = cli._build_ft(kid, size, strategy, encode, "cuda")
                nk = -(-size // shape.bk)
                kind, ce, mf = ft._plan(strategy, None, None, inj, nk,
                                        shape.bn, encode)
            else:
                kind, inj, ce, mf = "sgemm", None, None, False
            key = (id(host), kid, kind, ce, mf)
            if key in seen:
                continue   # B1 does not depend on the strategy
            seen.add(key)
            a, b, c = _padded(host, shape)
            kern.hold(kind, shape, a, b, c,
                      None if inj is None else _scalars(inj), ce, mf)
    done = {k: n - before[k] for k, n in kern.checked.items()}
    log(f"phase path shapes: {done} comparisons with the plain versions pass"
        f" at {VERIFY_SIZE} (verification, every strategy and encode),"
        f" {PERF_SIZES[0]}..{PERF_SIZES[1]} (table) and {TIMING_SIZE}"
        f" (table, {TABLE_PAIRS}), max |dC| {kern.max_err}"
        f" ({time.perf_counter() - t0:.1f} s)")


def phase_main_path(kern: Kernels):
    """The ``ft_sgemm`` program: verification at 4096 (ids 0-16 under
    weighted and rowcol, ids 11-16 under each pair of NEW_PAIRS), the
    GFLOPS table (2048..6144, weighted) and the table at 4096 for ids
    11-16 under each pair of TABLE_PAIRS, with the launch counters read
    around it all. A correcting strategy passes with every fault detected
    and none left uncorrectable; the detect-only global strategy with
    every fault event detected (each uncorrected) and a clean run that
    passes the diff (``cli._verify_global_strategy``)."""
    from ft_sgemm_tpu_torch import cli

    kern.zero_counts()
    t0 = time.perf_counter()
    runs = [("weighted", "vpu", 0), ("rowcol", "vpu", 0)]
    runs += [(s, e, 11) for s, e in NEW_PAIRS]
    for strategy, encode, first in runs:
        details = {}
        ok = cli.run_verification(VERIFY_SIZE, first, 16, strategy=strategy,
                                  encode=encode, details=details)
        if not ok:
            raise AssertionError(
                f"run_verification failed under {strategy}/{encode}")
        for kid, d in details.items():
            want_unc = d["detected"] if strategy == "global" else 0
            if d["uncorrectable"] != want_unc or d["detected"] != d["expected"]:
                raise AssertionError(f"{strategy}/{encode} id {kid}: {d}")
        log(f"phase verify {strategy}/{encode}: ids {first}-16 pass at"
            f" {VERIFY_SIZE}; detected/expected faults "
            + ", ".join(f"{k}:{d['detected']}/{d['expected']}"
                        for k, d in sorted(details.items())))
    tables = {("weighted", "vpu"): cli.run_perf_table(
        *PERF_SIZES, 0, 16, min_device_time=PERF_MINTIME)}
    for strategy, encode in TABLE_PAIRS:
        log(f"phase table {strategy}/{encode}: ids 11-16 at {TIMING_SIZE}")
        tables[strategy, encode] = cli.run_perf_table(
            TIMING_SIZE, TIMING_SIZE, 1, 11, 16, min_device_time=PERF_MINTIME,
            strategy=strategy, encode=encode)
    counts = kern.counts()
    log(f"phase main path: {time.perf_counter() - t0:.1f} s, launches {counts}")
    missing = [name for name, n in counts.items()
               if n == 0 and kern.table[name]["counter"] == "launches"]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts, tables


def phase_default_path(kern: Kernels):
    """The program at the f32 precision "default" (``run_verification(
    precision="default")``, one TF32 pass): its verification at VERIFY_SIZE for ids 1-16 under the
    weighted strategy and ids 11-16 under every other pair of ALL_PAIRS,
    with the launch counters read around it. The verdicts are printed as
    the program prints them: its 0.01 absolute AND relative is an FP32
    gate, which one TF32 pass misses on elements near zero. The run holds
    every FT row to all of its faults detected and none uncorrectable (the
    detect-only global: every fault event detected, each uncorrected), and
    C to the FP32 oracle within TF32's rounding, element by element
    (TF32_PRODUCT, F32_SUM): the injected run's of each correcting FT row
    (launched again through the program's own ``_build_ft``) off its
    faults' elements within the clean bound of each element, at them
    within three times TF32_PRODUCT of the largest tile row or column sum
    of |A| |B|^T (of the huge tile, the widest); the clean run's of ids
    1-6, 10 and each global row within each element's clean bound.
    Returns the counts."""
    import io

    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import KERNEL_TABLE
    from ft_sgemm_tpu_torch.ops.common import strict_fp32
    from ft_sgemm_tpu_torch.ops.ft_sgemm import _inject_plain
    from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

    kern.zero_counts()
    t0 = time.perf_counter()
    n = VERIFY_SIZE
    a, b = (torch.from_numpy(x).cuda()
            for x in runtime.generate_reference_driver_inputs(n))
    c = torch.zeros((n, n), device="cuda")
    want = sgemm_reference(a, b, c, kern.alpha, kern.beta, device="cuda")
    strict_fp32()
    t = abs(kern.alpha) * (a.abs() @ b.abs().T)
    tiles = t.reshape(n // 128, 128, n // 128, 128)
    clean_gate = (TF32_PRODUCT + 2 * n * F32_SUM) * t
    gates = {"clean": 1.0,  # the worst share of an element's clean bound
             "corrected": 3 * TF32_PRODUCT * float(max(
                 tiles.sum(3).max(), tiles.sum(1).max()))}

    def faults_of(ft, inj):
        """The elements ``inj`` hits in a run of ``ft`` (the plain
        versions' ``_inject_plain`` on a zero accumulator)."""
        shape = ft.shape_config
        acc = torch.zeros((n // shape.bm, n // shape.bn, shape.bm, shape.bn),
                          device="cuda")
        for k in range(n // shape.bk):
            _inject_plain(acc, inj.as_operand(), k)
        return (acc != 0).permute(0, 2, 1, 3).reshape(n, n)

    def clean_share(got, off):
        """The worst share of an element's clean bound over ``off``."""
        return float(((got - want).abs()
                      / clean_gate.clamp_min(torch.finfo(t.dtype).tiny))[off]
                     .max())

    verdicts, errs = {}, {}
    for (strategy, encode), first in zip(ALL_PAIRS, [1] + [11] * 5):
        details, out = {}, io.StringIO()
        cli.run_verification(n, first, 16, out=out, strategy=strategy,
                             encode=encode, details=details,
                             precision="default")
        for line in out.getvalue().splitlines():
            log(f"phase default {strategy}/{encode}: {line}")
            m = re.match(r"Verification of kernel\s+(\d+) .*: (\w+)", line)
            if m:
                verdicts[f"{strategy}/{encode} {m.group(1)}"] = m.group(2)
        clean = [k for k in range(first, 11) if k in KERNEL_TABLE]
        for kid, d in details.items():
            want_unc = d["detected"] if strategy == "global" else 0
            if d["uncorrectable"] != want_unc or d["detected"] != d["expected"]:
                raise AssertionError(f"default {strategy}/{encode} id {kid}:"
                                     f" {d}")
            if strategy == "global":
                clean.append(kid)
                continue
            ft, inj = cli._build_ft(kid, n, strategy, encode, "cuda",
                                    precision="default")
            got = ft(a, b, c, inj).c
            hit = faults_of(ft, inj)
            errs[f"{strategy}/{encode} {kid} clean"] = clean_share(got, ~hit)
            errs[f"{strategy}/{encode} {kid} corrected"] = float(
                (got - want).abs()[hit].max())
        for kid in clean:
            if kid > 10:
                ft, _ = cli._build_ft(kid, n, strategy, encode, "cuda",
                                      precision="default")
                got = ft(a, b, c).c
            else:
                got = cli._build_callable(kid, n, True, strategy, encode,
                                          "cuda", precision="default")(a, b, c)
            errs[f"{strategy}/{encode} {kid} clean"] = clean_share(
                got, torch.ones_like(got, dtype=torch.bool))
    bad = {k: e for k, e in errs.items()
           if not e <= gates[k.split()[-1]]}
    if bad:
        raise AssertionError(f"default precision: C past TF32's bounds"
                             f" {gates}: {bad}")
    counts = kern.counts()
    log(f"phase default path: verdicts {verdicts}; worst share of the"
        f" clean elements' bounds (clean) and max |dC| at the faults"
        f" (corrected) {errs} (bounds {gates}, the clean bound"
        f" {float(clean_gate.min())}-{float(clean_gate.max())});"
        f" {time.perf_counter() - t0:.1f} s, launches"
        f" { {k: n for k, n in counts.items() if k.endswith('_default')} }")
    missing = [name for name, k in kern.table.items()
               if k["counter"] == "one_pass_launches" and counts[name] == 0]
    if missing:
        raise AssertionError(f"one-pass kernels never launched on the"
                             f" default path: {missing}")
    return counts


def _device_verify(want, got):
    """``verify_matrix``'s rule on the card: the number of elements off by
    more than 0.01 absolute AND 0.01 relative to ``want``."""
    diff = (got - want).abs()
    return int(((diff > 0.01) & (diff > 0.01 * want.abs())).sum())


def _plain_verdicts(kern: Kernels, host, want, pairs=ALL_PAIRS,
                    in_dtype="float32"):
    """What the plain versions give each FT id of the program under
    threshold="adaptive" on the verification inputs ``host`` (A and B
    rounded to ``in_dtype``), at the launch the program makes (``_plan``,
    reference-like faults), on the card, under each (strategy, encode) of
    ``pairs``: {(strategy, encode, id): (passes the gate, detected,
    uncorrectable, elements off the oracle ``want``)}. The gate is the
    program's: a correcting strategy passes with C within the oracle's
    tolerance and nothing left uncorrectable, global with every fault
    event detected."""
    from ft_sgemm_tpu_torch.configs import canonical_in_dtype, kernel_for_id
    from ft_sgemm_tpu_torch.injection import InjectionSpec

    n = host[0].shape[0]
    dtype = getattr(torch, canonical_in_dtype(in_dtype))
    out = {}
    for strategy, encode in pairs:
        for kid in range(11, 17):
            _, shape, _ = kernel_for_id(kid)
            inj = InjectionSpec.reference_like(n, shape.bk)
            kind, ce, mf = kern.ft._plan(strategy, None, None, inj,
                                         -(-n // shape.bk), shape.bn, encode,
                                         adaptive=True)
            _, plain = kern.calls(kind, shape, *_padded(host, shape, dtype),
                                  _adaptive_scalars(inj), ce, mf, True)
            c, det, unc = plain()
            det, unc = int(det.sum()), int(unc.sum())
            nbad = _device_verify(want, c[:n, :n])
            tiles = -(-n // shape.bm) * -(-n // shape.bn)
            expected = tiles * inj.expected_faults(n, shape.bk)
            ok = (det == expected if strategy == "global"
                  else nbad == 0 and unc == 0)
            out[strategy, encode, kid] = (ok, det, unc, nbad)
    return out


def phase_threshold_path(kern: Kernels, in_dtype="float32",
                         static_tables=None):
    """The program at VERIFY_SIZE under ``--threshold=auto`` and
    ``--threshold=adaptive`` in f32 (every (strategy, encode) pair of
    ALL_PAIRS), or under ``--threshold=adaptive`` with ``--dtype=bfloat16``
    (the pairs of BF16_PAIRS, the adaptive bf16 builds of B3-B8) or
    ``--dtype=fp8`` (LOWP_PAIRS, those of B5, B3 and B4; ``in_dtype``), with
    the launch counters set to 0 just before and read just after:

    (b) the verification of ids 11-16 (``cli.run_verification``, its
    reference-like faults of magnitude 1e4). Under auto every row passes
    with every fault detected (global: every event) and none left
    uncorrectable. Under adaptive every row must give the verdict that the
    kernels' plain versions give the same launch on the card, and, where
    that passes, every fault detected and the plain versions' detected and
    uncorrectable counts exactly. Where it fails (rowcol under either
    encode, and weighted, fused and weighted/mxu at id 11), the counts are
    printed beside the plain versions' and not compared: the reference's
    adaptive thresholds sit near the rounding
    of a corrected 1e4 fault at later checks, which flags the residue as a
    new fault and cascades; any two summation orders cascade differently
    (ROADMAP, Queue C).
    (c) Clean runs of ids 11-16 under each mode flag nothing.
    (d) Reference-like faults of magnitude TINY_MAGNITUDE, which the static
    threshold misses (nothing detected or corrected, C off the oracle: run
    before the counters are set to 0) and each mode catches: the correcting
    pairs detect and correct every one (C within the oracle's tolerance,
    none uncorrectable), global counts every event.
    In bf16 and fp8, the table of ids 11-16 at TIMING_SIZE, printed beside
    the static rows of ``static_tables`` (phase_float_path's).

    Every adaptive build of the dtype must have launched; in bf16 and fp8
    every launch is an adaptive bf16 build's, counted in adaptive_launches
    and in the dtype's counter alike. Returns the launch counts."""
    from ft_sgemm_tpu_torch import cli, runtime
    from ft_sgemm_tpu_torch.configs import kernel_for_id
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops.common import as_f32
    from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm
    from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

    f32 = in_dtype == "float32"
    label = "" if f32 else ("fp8 " if in_dtype == "fp8" else "bf16 ")
    pairs = (ALL_PAIRS if f32 else LOWP_PAIRS if in_dtype == "fp8"
             else BF16_PAIRS)
    modes = ("auto", "adaptive") if f32 else ("adaptive",)
    n = VERIFY_SIZE
    a, b = runtime.generate_reference_driver_inputs(n)
    host = (a, b, np.zeros_like(a))
    a, b, c = (as_f32(x, "cuda") for x in host)
    want = sgemm_reference(a, b, c, kern.alpha, kern.beta, in_dtype=in_dtype,
                           device="cuda")
    t0 = time.perf_counter()
    plain = _plain_verdicts(kern, host, want, pairs, in_dtype)
    log(f"phase {label}threshold plain verdicts (adaptive, {n}; passes,"
        f" detected, uncorrectable, elements off): {plain}"
        f" ({time.perf_counter() - t0:.1f} s)")

    def program(kid, strategy, encode, mode):
        shape = kernel_for_id(kid)[1]
        inj = InjectionSpec.reference_like(n, shape.bk,
                                           magnitude=TINY_MAGNITUDE)
        tiles = -(-n // shape.bm) * -(-n // shape.bn)
        return (make_ft_sgemm(shape.name, alpha=kern.alpha, beta=kern.beta,
                              strategy=strategy, encode=encode,
                              threshold=mode, in_dtype=in_dtype,
                              device="cuda"),
                inj, tiles * inj.expected_faults(n, shape.bk))

    tiny = {}

    def tiny_faults(what, ft, inj):
        res = ft(a, b, c, inj)
        tiny[what] = (int(res.num_detected), int(res.num_uncorrectable),
                      _device_verify(want, res.c))
        return tiny[what]

    for strategy, encode in pairs:
        for kid in range(11, 17):
            # The static control: missed, and C keeps the faults. (The
            # weighted check's w^2 re-check may still report a tile
            # uncorrectable: w^2 times the fault can pass 9500.)
            what = f"{label}{strategy}/{encode} id {kid} threshold static"
            det, unc, nbad = tiny_faults(
                what, *program(kid, strategy, encode, "static")[:2])
            if det or not nbad:
                raise AssertionError(
                    f"{what}, faults of magnitude {TINY_MAGNITUDE}: detected"
                    f" {det}, uncorrectable {unc}, {nbad} elements off the"
                    f" oracle")
    kern.zero_counts()
    t0 = time.perf_counter()
    for mode in modes:
        for strategy, encode in pairs:
            details = {}
            cli.run_verification(n, 11, 16, strategy=strategy, encode=encode,
                                 threshold=mode, in_dtype=in_dtype,
                                 details=details)
            for kid, d in details.items():
                p_ok, p_det, p_unc, _ = plain[strategy, encode, kid]
                want_ok = mode == "auto" or p_ok
                # Where the plain versions pass, the adaptive counts must be
                # theirs exactly.
                counts = mode == "auto" or not p_ok or (
                    d["detected"] == p_det and d["uncorrectable"] == p_unc)
                if d["passed"] != want_ok or not counts or (d["passed"] and (
                        d["detected"] != d["expected"]
                        or d["uncorrectable"] != (
                            d["detected"] if strategy == "global" else 0))):
                    raise AssertionError(
                        f"{label}{strategy}/{encode} threshold {mode} id"
                        f" {kid}: {d}, the plain versions' (verdict,"
                        f" detected, uncorrectable) {(p_ok, p_det, p_unc)}")
            log(f"phase verify {label}{strategy}/{encode} threshold {mode} at"
                f" {n}: ids 11-16 (passed, detected/expected, uncorrectable) "
                + ", ".join(f"{k}:({d['passed']}, {d['detected']}/"
                            f"{d['expected']}, {d['uncorrectable']})"
                            for k, d in sorted(details.items())))
    for strategy, encode in pairs:
        for kid in range(11, 17):
            for mode in modes:
                ft, inj, expected = program(kid, strategy, encode, mode)
                what = f"{label}{strategy}/{encode} id {kid} threshold {mode}"
                clean = ft(a, b, c)
                if int(clean.num_detected) or int(clean.num_uncorrectable):
                    raise AssertionError(
                        f"{what}: a clean run flagged"
                        f" {int(clean.num_detected)}")
                det, unc, nbad = tiny_faults(what, ft, inj)
                if not (det == expected and (
                        unc == det if strategy == "global"
                        else unc == 0 and nbad == 0)):
                    raise AssertionError(
                        f"{what}, faults of magnitude {TINY_MAGNITUDE}:"
                        f" detected {det} of {expected}, uncorrectable {unc},"
                        f" {nbad} elements off the oracle")
    rows = {}
    for strategy, encode in (() if f32 else pairs):
        table = cli.run_perf_table(
            TIMING_SIZE, TIMING_SIZE, 1, 11, 16, min_device_time=PERF_MINTIME,
            strategy=strategy, encode=encode, threshold="adaptive",
            in_dtype=in_dtype)
        for name, cells in table.items():
            rows[f"{strategy}/{encode} {name}"] = (
                round(static_tables[strategy, encode][name][TIMING_SIZE]),
                round(cells[TIMING_SIZE]))
    counts = kern.counts()
    log(f"phase {label}threshold clean: ids 11-16 under {pairs}, {modes},"
        f" flag nothing at {n}")
    log(f"phase {label}threshold tiny faults (magnitude {TINY_MAGNITUDE},"
        f" (detected, uncorrectable, elements off)): {tiny}")
    if rows:
        log(f"phase {label}adaptive table at {TIMING_SIZE} (GFLOPS static,"
            f" adaptive): {rows}")
    log(f"phase {label}threshold path: {time.perf_counter() - t0:.1f} s,"
        f" launches {counts}")
    suffix = "_adaptive" + ("" if f32 else "_" + label.strip())
    missing = [name for name in kern.table
               if name.endswith(suffix) and counts[name] == 0]
    if missing:
        raise AssertionError(f"adaptive kernels never launched on the"
                             f" {label}threshold path: {missing}")
    if not f32:
        wrappers = {kern.table[KIND_NAMES[k]]["wrapper"]
                    for k in (LOWP_ADAPTIVE_KINDS if in_dtype == "fp8"
                              else BF16_ADAPTIVE_KINDS)}
        counter = f"{label.strip()}_launches"
        for k in kern.table.values():
            w = k["wrapper"]
            seen = {c: getattr(w, c, 0) for c in (
                "launches", "adaptive_launches", "bf16_launches",
                "fp8_launches", "int8_launches")}
            want_n = seen["adaptive_launches"] if w in wrappers else 0
            if seen != {c: want_n if c in ("adaptive_launches", counter)
                        else 0 for c in seen}:
                raise AssertionError(f"{label}adaptive path: {w.__name__}"
                                     f" counted {seen}")
    return counts


def phase_roc(kern: Kernels):
    """The threshold-calibration path on the card.

    (a) ``ft_sgemm roc`` (``cli.main``, the whole grid: every legal (dtype,
    strategy, encode), 17 combos, 128 x 128 x 256 at input scales 0.1, 1
    and 16) exits 0: adaptive Pareto-dominates the calibrated static
    threshold in every combo with no adaptive false positive, and detects
    every fault in each. (b) Its bf16 points (the adaptive bf16 builds of
    B3-B8 among them) against the same sweep with ``device="cpu"`` (the
    plain versions on the host): every adaptive point equal field by
    field; the static points' thresholds, magnitudes, checks and expected
    faults equal, their clean and injected detections printed side by side
    (at scale 16 the calibrated threshold lies inside the clean noise,
    where the count depends on the order of the sums). (c)
    ``calibrate_threshold`` on the program's VERIFY_SIZE inputs (the
    two-pass baseline's clean residuals on the card), then
    ``detection_rate_sweep`` at DETECTION_FACTORS times that threshold
    (DETECTION_FAULTS faults a tile) at id 16's tile: f32 rowcol under the
    calibrated threshold and bf16 fused under "adaptive", each also with
    the plain versions on the card (``run_kernel(plain=True)``). Below the
    threshold (the adaptive one: the host twin's) nothing is detected, the
    designed miss; f32 rowcol catches and corrects every fault above it;
    at 64 times every fault is caught with C correct in both; the kernels'
    points are the plain versions' (detections within 1 % of the faults:
    the weighted ratio of a fault near the w-moment's noise localizes it
    or not by the order of the sums)."""
    import contextlib
    import functools
    import io
    import json as _json

    from ft_sgemm_tpu_torch import analysis, cli, runtime
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import roc_sweep

    t0 = time.perf_counter()
    path = VARIANT_DIR.parent / "roc.json"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["ft_sgemm", "roc", f"--out={path}"])
    text = printed.getvalue()
    log("phase roc, ft_sgemm roc's summary:\n"
        + text[text.index("ROC summary"):].rstrip())
    art = _json.loads(path.read_text())
    s = art["summary"]
    combos = s["combos"]
    weak = {k: v["adaptive"] for k, v in combos.items()
            if v["adaptive"]["detection_rate"] != 1.0}
    if rc or len(combos) != 17 or not s["all_dominate"] or weak or s[
            "adaptive_false_positives"]:
        raise AssertionError(f"roc: exit {rc}, {len(combos)} combos, all"
                             f" dominate {s['all_dominate']}, adaptive false"
                             f" positives {s['adaptive_false_positives']},"
                             f" adaptive detection under 1: {weak}")
    log(f"phase roc: ft_sgemm roc exits 0 on {len(combos)} combos, adaptive"
        f" false positives 0, adaptive detection 1.0 in each; static (fp"
        f" rate, detection rate): "
        + ", ".join(f"{k} ({v['static']['fp_rate']:.3f},"
                    f" {v['static']['detection_rate']:.3f})"
                    for k, v in combos.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    card = [p for p in art["points"] if p["dtype"] == "bfloat16"]
    host = roc_sweep(dtypes=("bfloat16",), device="cpu")["points"]
    if len(card) != len(host) or len(card) != 36:
        raise AssertionError(f"roc bf16: {len(card)} points on the card,"
                             f" {len(host)} on the host")
    same = ("threshold", "magnitude", "checks", "expected_faults")
    sides = {}
    for pc, ph in zip(card, host):
        key = (pc["strategy"], pc["encode"], pc["scale"])
        if pc["mode"] == "adaptive" and pc != ph or any(
                pc[f] != ph[f] for f in same):
            raise AssertionError(f"roc bf16 {key} {pc['mode']}: card {pc},"
                                 f" host {ph}")
        if pc["mode"] == "static":
            sides[key] = ((pc["clean_detections"], ph["clean_detections"]),
                          (pc["detected"], ph["detected"]))
    log(f"phase roc bf16: the card's 36 points equal the plain versions' on"
        f" the host (adaptive field by field); static (clean, injected)"
        f" detections (card, host): {sides}")
    n = VERIFY_SIZE
    a, b = runtime.generate_reference_driver_inputs(n)
    c = np.zeros_like(a)
    shape = SHAPES["huge"]
    ft_mod = kern.ft
    run_kernel = ft_mod.run_kernel
    report = {}
    for in_dtype, strategy, mode in (("float32", "rowcol", None),
                                     ("bfloat16", "fused", "adaptive")):
        cal = analysis.calibrate_threshold(a, b, c, alpha=kern.alpha,
                                           beta=kern.beta, in_dtype=in_dtype,
                                           device="cuda")
        mags = [f * cal.threshold for f in DETECTION_FACTORS]
        kw = dict(strategy=strategy, threshold=mode or cal.threshold,
                  alpha=kern.alpha, beta=kern.beta,
                  num_faults=DETECTION_FAULTS, in_dtype=in_dtype,
                  device="cuda")
        got = analysis.detection_rate_sweep(a, b, c, mags, shape, **kw)
        try:
            ft_mod.run_kernel = functools.partial(run_kernel, plain=True)
            want = analysis.detection_rate_sweep(a, b, c, mags, shape, **kw)
        finally:
            ft_mod.run_kernel = run_kernel
        thr = (analysis.adaptive_threshold_grid(
            a, b, bm=shape.bm, bn=shape.bn, in_dtype=in_dtype)
            if mode else np.float64([cal.threshold]))
        what = f"detection sweep {in_dtype} {strategy} {mode or 'static'}"
        for f, pk, pp in zip(DETECTION_FACTORS, got, want):
            below, above = pk.magnitude < thr.min(), pk.magnitude > thr.max()
            ok = (abs(pk.detected - pp.detected) <= 0.01 * pk.expected_faults
                  and pk.output_correct == pp.output_correct
                  and (below or above)
                  and (not below or pk.detected == 0)
                  and (not above or f < 64 and mode
                       or pk.detected == pk.expected_faults
                       and pk.output_correct))
            if not ok:
                raise AssertionError(
                    f"{what} at {f} x {cal.threshold}: kernels {pk}, plain"
                    f" versions {pp}; threshold {thr.min()}..{thr.max()}")
        report[what] = (cal.noise_floor, cal.threshold,
                        [(f, p.detected, p.expected_faults, p.output_correct,
                          q.detected, q.output_correct)
                         for f, p, q in zip(DETECTION_FACTORS, got, want)])
    log(f"phase roc detection (noise floor, calibrated threshold, [(factor,"
        f" detected, expected, C correct; plain: detected, C correct)]):"
        f" {report} ({time.perf_counter() - t0:.1f} s)")


# An mxu kernel computes its vpu kernel's function: the same bound.
SAME_FUNCTION = {"fused": "running", "rowcol_mxu": "rowcol",
                 "global_mxu": "global"}


def work(kind, shape, n, check_every=None, multifault=False, adaptive=False,
         bf16=False, int8=False, fp8=False):
    """(flops, bytes) that one launch's function needs at M = N = K = n.
    An FMA counts as two flops; each input is read once and each output
    written once (A and B two bytes an element with ``bf16``, one with
    ``int8`` or ``fp8``). Beyond the product and the alpha/beta epilogue: each
    check's sums over the output (weighted: moments 1, w, w^2 by add, FMA,
    FMA; rowcol: row and column sums, plus the w-weighted column sums in
    multifault mode; global: one sum of the tile) and, for the kernels
    with a running encode, the encode of the expected checksums — the A-
    and B-side sums (or, for the mxu kernels, the wrapper's
    ``_tile_moments``, the same sums) once per row or column tile, and the
    per-tile updates once per tile and K column. The adaptive thresholds
    add the sums and sums of squares of A and B (4 * n^2)."""
    kind = SAME_FUNCTION.get(kind, kind)
    mn = float(n * n)                       # also M*K and N*K
    gm, gn = n // shape.bm, n // shape.bn
    tiles = gm * gn
    flops = 2.0 * n ** 3 + 3 * mn           # product; alpha*acc + beta*C
    esize = 1 if int8 or fp8 else 2 if bf16 else 4
    nbytes = (2.0 * esize + 4.0 * 2) * mn  # A, B, C; out
    if kind == "sgemm":
        return flops, nbytes
    nbytes += 4.0 * 2 * tiles               # det, unc
    if adaptive:
        flops += 4 * mn
    checks = -(-(n // shape.bk) // check_every) if check_every else 1
    if kind == "precomp":
        flops += 5 * mn
        nbytes += 4.0 * 3 * gm * n          # the expected moments (gm, 3, N)
    elif kind == "running":
        # A's moments 1, w, w^2 (5 * M*K); 3 FMAs per tile, K column, column.
        flops += 5 * mn + tiles * n * 6.0 * shape.bn + 5 * mn * checks
    elif kind == "global":
        # A's and B's plain sums (M*K + N*K); one t_exp FMA per tile and K
        # column; one sum of the output per check.
        flops += 2 * mn + tiles * n * 2.0 + mn * checks
    else:
        # A's and B's plain sums (M*K + N*K); r_exp, c_exp FMAs per tile.
        flops += (2 * mn + tiles * n * 2.0 * (shape.bm + shape.bn)
                  + 2 * mn * checks)
        if multifault:
            flops += 2 * mn + tiles * n * 2.0 * shape.bn + 2 * mn * checks
    return flops, nbytes


def _bound(flops: float, nbytes: float, tc_products: float = 0.0,
           bf16: bool = False, int8: bool = False, fp8: bool = False,
           tf32_passes: int = 3):
    """(ms, bound_by): the larger of the operations over their peak rate
    and the bytes over the memory rate. ``tc_products`` of the flops are
    products that run as ``tf32_passes`` TF32 products each on the tensor
    cores (three in the 3xTF32 wgmma kernels, one under the f32 precision
    "default"), or once at the bf16 rate with ``bf16``, at the int8 rate
    with ``int8``, at the fp8 rate with ``fp8``; the rest run at the FP32
    rate."""
    tc = (tc_products / PEAK_FP8_FLOPS if fp8 else
          tc_products / PEAK_INT8_OPS if int8 else
          tc_products / PEAK_BF16_FLOPS if bf16 else
          tf32_passes * tc_products / PEAK_TF32_FLOPS)
    t_ops = tc + (flops - tc_products) / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tc_products(kind, shape, n, multifault=False):
    """The flops of ``work`` that a 3xTF32 wgmma kernel runs on the tensor
    cores: the product, and the expected sums that the function itself
    needs and the kernel computes beside it as products. For B5 and B6 the
    expected moments E = B_tile . M^T (3 moment rows per row tile: 2 * N *
    K * 3 M / bm, ``work``'s running updates); for B3 the expected column
    sums (1 row per row tile, 2 with multifault: 2 * N * K * M / bm each)
    and the expected row sums, A times B's band sums (2 * M * K * N / bn),
    which are ``work``'s r_exp and c_exp updates. B4 needs only one t_exp
    FMA per tile and K column, which stays at the FP32 rate: its design's
    8 extra product columns are more work than the function needs, so they
    are not counted."""
    kind = SAME_FUNCTION.get(kind, kind)
    return 2.0 * n ** 3 + {
        "running": 6.0 * n ** 3 / shape.bm,
        "rowcol": 2.0 * n ** 3 / shape.bn
        + (4.0 if multifault else 2.0) * n ** 3 / shape.bm}.get(kind, 0.0)


# Which (strategy, encode) runs each kernel kind, for the timing's plan.
KIND_PAIR = {"precomp": ("weighted", "vpu"), "running": ("weighted", "vpu"),
             "rowcol": ("rowcol", "vpu"), "global": ("global", "vpu"),
             "fused": ("fused", "mxu"), "rowcol_mxu": ("rowcol", "mxu"),
             "global_mxu": ("global", "mxu")}

# (kind, tile) of every timing row: each kernel at every tile on which the
# program launches it. The first row of a kernel is its ``kernels`` row.
TIMED = (("sgemm", "huge"), ("precomp", "huge"), ("rowcol", "huge"),
         ("global", "huge"), ("running", "small"), ("fused", "huge"),
         ("rowcol_mxu", "huge"), ("global_mxu", "huge"),
         ("fused", "small"), ("fused", "medium"), ("fused", "large"),
         ("fused", "tall"), ("fused", "wide"),
         ("sgemm", "large"), ("sgemm", "tall"), ("sgemm", "small"),
         ("sgemm", "medium"), ("sgemm", "wide"),
         ("precomp", "large"), ("precomp", "tall"), ("precomp", "medium"),
         ("precomp", "wide"),
         ("rowcol", "small"), ("global", "small"), ("rowcol_mxu", "small"),
         ("global_mxu", "small"))
TIMED += tuple((kind, tile)
               for kind in ("rowcol", "global", "rowcol_mxu", "global_mxu")
               for tile in ("medium", "large", "tall", "wide"))
# Timed though the program does not launch them: B2 at small.
OFF_PATH = (("precomp", "small"),)
TIMED += OFF_PATH
# The bf16 and fp8 builds of B1-B5 at every tile the program launches each
# on (the weighted strategy runs B5 at small, B2 elsewhere), and in bf16
# B6-B8 at every tile.
LOWP_TIMED = tuple(("sgemm", tile) for tile in PROGRAM_TILES)
LOWP_TIMED += (("precomp", "huge"), ("running", "small"))
LOWP_TIMED += tuple(("precomp", tile) for tile in PROGRAM_TILES[2:])
LOWP_TIMED += tuple((kind, tile) for kind in ("rowcol", "global")
                    for tile in PROGRAM_TILES)
BF16_TIMED = LOWP_TIMED + tuple((kind, tile) for kind in BF16_MXU_KINDS
                                for tile in PROGRAM_TILES)
# The WgTile parameters (MOM, BANDS, ROWS) after the sub-tile that tell the
# 128 x 128 CTA's kernels apart in a library (ptxas_summary's tags); rowcol
# with one moment row (two with multifault).
SUM_ROWS = {"running": (3, 0, 2), "fused": (3, 0, 1), "rowcol": (1, 1, 3),
            "rowcol_mxu": (1, 2, 1), "global": (0, 1, 0),
            "global_mxu": (0, 2, 0)}


def float_ptxas(kind, shape, in_dtype, multifault=False, adaptive=False,
                one_pass=False):
    """``-Xptxas -v``'s line (registers, spills) for the kernel that ``kind``
    launches on ``shape`` in ``in_dtype`` ("float32", "bfloat16" or "fp8";
    B2-B5 in fp8
    run the bf16 kernels; each from the library ``ft.kernel_entry`` names;
    ``adaptive``: B3-B8's adaptive bf16 builds): B1 and B2 on the tile's
    own CTA at the 64-row tiles, else the 128 x 128 CTA (B1: the ragged
    one; B2-B8 over the tile as sub-tiles; B3 and B7 with one moment row,
    two with multifault; ``one_pass``: the f32 one-TF32-pass build)."""
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft

    kernel = FLOAT_KERNELS.get(kind, "ft_running_wgmma_kernel")
    e4m3 = in_dtype == "fp8" and kind == "sgemm"
    f32 = in_dtype == "float32"
    if kind == "sgemm":
        lib = "sgemm_fp8" if e4m3 else "sgemm_tf32" if one_pass else "sgemm"
    else:
        lib = ft.kernel_entry(kind, torch.float32 if f32 else torch.bfloat16,
                              adaptive, one_pass)[0]
    own = (shape.bm, shape.bn) in _build.wgmma_tiles()
    if kind == "sgemm":  # with MOM, the sum-row sources and the ragged flag
        dims = [shape.bm, shape.bn] * 2 if own else [128] * 4
        dims += [0, 0, 0, int(not own)]
    elif kind == "precomp" and own:
        dims = [shape.bm, shape.bn, shape.bm, shape.bn]
    else:
        dims = [128, 128, shape.bm, shape.bn]
    if kind in SUM_ROWS:
        mom, bands, rows = SUM_ROWS[kind]
        dims += [2 if multifault else mom, bands, rows]
    tag = kernel + "<" + ",".join(map(str, dims)) + ","
    in_tag = ",e4m3>:" if e4m3 else ",bf16>:"
    lines = [x for x in ptxas_summary(_build.ptxas_log(lib))
             if (x.startswith(tag) or x.startswith(tag[:-1] + ">"))
             and (not any(t in x for t in (",bf16>", ",s8>", ",e4m3>"))
                  if f32 else in_tag in x)]
    if len(lines) != 1:
        raise AssertionError(f"ptxas lines for {tag}...{in_tag}: {lines}")
    return lines[0]


# The f32 precision "default" rows: B1-B8 each on the first tile TIMED
# gives it (the program's path at 4096).
DEFAULT_TIMED = (("sgemm", "huge"), ("precomp", "huge"), ("rowcol", "huge"),
                 ("global", "huge"), ("running", "small"), ("fused", "huge"),
                 ("rowcol_mxu", "huge"), ("global_mxu", "huge"))
# The variant-axis times: each kernel under each axes' variant against the
# default axes, in turns on the same launch.
AXES_TIMED = (("sgemm", "huge"), ("rowcol", "huge"))


def phase_default_timing(kern: Kernels, counts):
    """Each kernel at the f32 precision "default" (one TF32 wgmma a k step)
    at 4096 on the tile and cadence the program gives it (DEFAULT_TIMED):
    the kernel, its one-product plain version, torch.addmm with TF32
    allowed (``torch.backends.cuda.matmul.allow_tf32``; the library's TF32
    GEMM, one pass) for the same alpha*A@B.T + beta*C, the bound (the
    tensor-core products once at the TF32 rate, ``tc_products``), the
    registers (its one-pass build's, ``*_tf32``) and the 3xTF32 launch's
    time beside it (``highest_ms``). Then B1 and B3
    at huge under the grid order "nm" and the pipeline depth 3 against the
    default axes, in turns (default, axis, axis, default). Returns the
    ``kernels`` rows."""
    from ft_sgemm_tpu_torch.configs import SHAPES, KernelVariant
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops.common import (
        LaunchAxes,
        launch_axes,
        step_shape,
        strict_fp32,
    )
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    gen = np.random.default_rng(11)
    host = _random(n, n, n, gen)
    one = LaunchAxes(one_pass=True)
    rows = []

    def plan(kind, shape, nk):
        if kind == "sgemm":
            return None, False
        strategy, encode = KIND_PAIR[kind]
        got, ce, mf = ft._plan(strategy, None, None,
                               InjectionSpec.reference_like(n, shape.bk), nk,
                               shape.bn, encode)
        if got != kind:
            raise AssertionError(f"the program runs {got} at {shape.name},"
                                 f" not {kind}")
        return ce, mf

    for kind, tile in DEFAULT_TIMED:
        shape = SHAPES[tile]
        a, b, c = _padded(host, shape)
        sc = _scalars(InjectionSpec.reference_like(n, shape.bk))
        ce, mf = plan(kind, shape, n // shape.bk)
        run, plain = kern.calls(kind, shape, a, b, c, sc, ce, mf, axes=one)
        highest, _ = kern.calls(kind, shape, a, b, c, sc, ce, mf)
        ms = cuda_ms(run, reps=5)
        highest_ms = cuda_ms(highest, reps=5)
        plain_ms = cuda_ms(plain)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            library_ms = cuda_ms(lambda: torch.addmm(
                c, a, b.T, beta=kern.beta, alpha=kern.alpha), reps=5)
        finally:
            strict_fp32()
        flops, nbytes = work(kind, shape, n, ce, mf)
        bound_ms, bound_by = _bound(flops, nbytes,
                                    tc_products(kind, shape, n, mf),
                                    tf32_passes=1)
        regs = float_ptxas(kind, shape, "float32", mf, one_pass=True)
        name = KIND_NAMES[kind] + "_default"
        rows.append({
            "name": name, "route": "cuda",
            "source": kern.table[name]["source"],
            "replaces": kern.table[name]["replaces"],
            "launches": counts[name], "max_abs_err": kern.max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "tile": tile,
            "mainloop": "wgmma-tf32", "ptxas": regs,
            "highest_ms": highest_ms})
        log(f"phase timing {name} ({tile}, {n}, check every {ce}, multifault"
            f" {mf}): kernel {ms:.3f} ms (3xTF32 {highest_ms:.3f} ms), plain"
            f" {plain_ms:.3f} ms, torch.addmm TF32 {library_ms:.3f} ms, bound"
            f" {bound_ms:.3f} ms ({bound_by}); {regs}")
    for kind, tile in AXES_TIMED:
        times = {}
        for axis in ({"grid_order": "nm"}, {"pipeline_depth": 3}):
            var = KernelVariant(**axis)
            shape = step_shape(SHAPES[tile], var)
            a, b, c = _padded(host, shape)
            sc = _scalars(InjectionSpec.reference_like(n, shape.bk))
            ce, mf = plan(kind, shape, n // shape.bk)
            base, _ = kern.calls(kind, shape, a, b, c, sc, ce, mf)
            if var.pipeline_depth == 3:  # the depth-2 launch on its own step
                a0, b0, c0 = _padded(host, SHAPES[tile])
                ce0, mf0 = plan(kind, SHAPES[tile], n // SHAPES[tile].bk)
                base, _ = kern.calls(kind, SHAPES[tile], a0, b0, c0, sc, ce0,
                                     mf0)
            run, _ = kern.calls(kind, shape, a, b, c, sc, ce, mf,
                                axes=launch_axes(var))
            turns = [cuda_ms(f, reps=5) for f in (base, run, run, base)]
            label = next(iter(axis.items()))
            times[f"{label[0]}={label[1]}"] = (
                (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
        log(f"phase timing axes {KIND_NAMES[kind]} ({tile}, {n}; default"
            f" axes ms, axis ms, in turns): "
            + ", ".join(f"{k}: {d:.4f} vs {v:.4f} ({(v / d - 1) * 100:+.1f} %)"
                        for k, (d, v) in times.items()))
    return rows


def phase_float_timing(kern: Kernels, counts, in_dtype: str):
    """Each bf16 or fp8 (``in_dtype``) kernel at 4096 on every tile,
    cadence and multifault setting the program gives it in that mode
    (BF16_TIMED; fp8: LOWP_TIMED), on the program's table inputs: the kernel (in fp8 B2-B5
    with their wrapper's widening of A and B to bf16), its plain version,
    the library's GEMM on the same operands (bf16: ``torch.matmul``, bf16
    out; fp8: ``torch._scaled_mm``, cuBLASLt, unit scales, f32 out), the
    bound (the product and the expected sums the function needs, once each
    at the mode's rate; the bytes with A and B two bytes an element in
    bf16, one in fp8), and each kernel's registers and spills. Returns the
    ``kernels`` rows, one per kernel (its first row); ``counts`` are the
    mode's path's launches."""
    from ft_sgemm_tpu_torch import cli
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.configs import canonical_in_dtype
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    fp8 = in_dtype == "fp8"
    label, library = (("fp8", "torch._scaled_mm") if fp8 else
                      ("bf16", "torch.matmul bf16"))
    name_dtype = canonical_in_dtype(in_dtype)
    dtype = getattr(torch, name_dtype)
    host = cli._host_inputs(n, name_dtype)
    one = torch.ones((), device="cuda")
    rows = {}
    for kind, tile in LOWP_TIMED if fp8 else BF16_TIMED:
        shape = SHAPES[tile]
        a, b, c = _padded(host, shape, dtype)
        name = KIND_NAMES[kind] + "_" + label
        inj = InjectionSpec.reference_like(n, shape.bk)
        ce, mf = None, False
        if kind != "sgemm":
            strategy, encode = KIND_PAIR[kind]
            plan, ce, mf = ft._plan(strategy, None, None, inj, n // shape.bk,
                                    shape.bn, encode)
            if plan != kind:
                raise AssertionError(f"the {label} program runs {plan} at"
                                     f" {tile}, not {kind}")
        run, plain = kern.calls(kind, shape, a, b, c, _scalars(inj), ce, mf)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms((lambda: torch._scaled_mm(
            a, b.T, one, one, out_dtype=torch.float32)) if fp8 else
            (lambda: torch.matmul(a, b.T)), reps=5)
        flops, nbytes = work(kind, shape, n, ce, mf, bf16=not fp8, fp8=fp8)
        bound_ms, bound_by = _bound(flops, nbytes,
                                    tc_products(kind, shape, n, mf),
                                    bf16=not fp8, fp8=fp8)
        regs = float_ptxas(kind, shape, label, mf)
        mainloop = _build.mainloop(kind, shape, name_dtype)
        rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": kern.table[name]["source"],
            "replaces": kern.table[name]["replaces"],
            "launches": counts[name], "max_abs_err": kern.max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "tile": tile,
            "mainloop": mainloop, "ptxas": regs})
        log(f"phase timing {name} ({tile}, {mainloop}, {n}, check every {ce},"
            f" multifault {mf}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
            f" {library} {library_ms:.3f} ms, bound {bound_ms:.3f} ms"
            f" ({bound_by}); {regs}")
    return list(rows.values())


def phase_lowp_adaptive_timing(kern: Kernels, counts, in_dtype: str):
    """Each adaptive bf16 build at 4096 on every tile, at the cadence and
    multifault setting the program gives it under threshold="adaptive", in
    ``in_dtype`` (bf16: B3-B8; or fp8, B3-B5, on the operands the wrapper
    widens), on the
    program's table inputs: the kernel beside its static bf16 build on the
    same launch (``static_ms``) and the library's GEMM (bf16:
    ``torch.matmul``; fp8: ``torch._scaled_mm``), its plain version at its
    first tile, the bound (``work`` with the sums of A and B, at the mode's
    rate) and its registers and spills. Returns the ``kernels`` rows, one
    per kernel (its first tile); ``counts`` are the dtype's adaptive path's
    launches."""
    from ft_sgemm_tpu_torch import cli
    from ft_sgemm_tpu_torch.configs import SHAPES, canonical_in_dtype
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    fp8 = in_dtype == "fp8"
    label, library = (("fp8", "torch._scaled_mm") if fp8 else
                      ("bf16", "torch.matmul bf16"))
    name_dtype = canonical_in_dtype(in_dtype)
    host = cli._host_inputs(n, name_dtype)
    one = torch.ones((), device="cuda")
    rows = {}
    for kind in LOWP_ADAPTIVE_KINDS if fp8 else BF16_ADAPTIVE_KINDS:
        for tile in PROGRAM_TILES:
            shape = SHAPES[tile]
            a, b, c = _padded(host, shape, getattr(torch, name_dtype))
            inj = InjectionSpec.reference_like(n, shape.bk)
            strategy, encode = KIND_PAIR[kind]
            plan, ce, mf = ft._plan(strategy, None, None, inj, n // shape.bk,
                                    shape.bn, encode, adaptive=True)
            if plan != kind:
                raise AssertionError(f"the {label} adaptive program runs"
                                     f" {plan} at {tile}, not {kind}")
            name = kernel_name(kind, a, True)
            static, _ = kern.calls(kind, shape, a, b, c, _scalars(inj), ce, mf)
            run, plain = kern.calls(kind, shape, a, b, c,
                                    _adaptive_scalars(inj), ce, mf, True)
            static_ms = cuda_ms(static, reps=5)
            ms = cuda_ms(run, reps=5)
            library_ms = cuda_ms((lambda: torch._scaled_mm(
                a, b.T, one, one, out_dtype=torch.float32)) if fp8 else
                (lambda: torch.matmul(a, b.T)), reps=5)
            flops, nbytes = work(kind, shape, n, ce, mf, adaptive=True,
                                 bf16=not fp8, fp8=fp8)
            bound_ms, bound_by = _bound(flops, nbytes,
                                        tc_products(kind, shape, n, mf),
                                        bf16=not fp8, fp8=fp8)
            regs = float_ptxas(kind, shape, label, mf, adaptive=True)
            log(f"phase timing {name} ({tile}, {n}, check every {ce},"
                f" multifault {mf}): kernel {ms:.3f} ms, static build"
                f" {static_ms:.3f} ms ({(ms / static_ms - 1) * 100:+.1f} %),"
                f" {library} {library_ms:.3f} ms, bound {bound_ms:.3f} ms"
                f" ({bound_by}); {regs}")
            if name in rows:
                continue
            rows[name] = {
                "name": name, "route": "cuda",
                "source": kern.table[name]["source"],
                "replaces": kern.table[name]["replaces"],
                "launches": counts[name], "max_abs_err": kern.max_err[name],
                "ms": ms, "plain_ms": cuda_ms(plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "tile": tile,
                "mainloop": _build.mainloop(kind, shape, name_dtype),
                "static_ms": static_ms, "ptxas": regs}
    return list(rows.values())


def phase_int8_timing(kern: Kernels, counts):
    """Each int8 build at 4096 on every tile the int8 program launches it
    on, at its cadence (the program's lattice inputs): the kernel, its plain
    version, ``torch._int_mm`` on the same int8 operands (cuBLASLt, int32
    out) and the bound (the product and the expected sums the function
    needs at the int8 rate; the bytes with A and B one byte an element).
    Returns the ``kernels`` rows, one per kernel (its first row); ``counts``
    are the int8 path's launches."""
    from ft_sgemm_tpu_torch import cli
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    host = cli._host_inputs(n, "int8")
    rows = {}
    for kind in INT8_KINDS:
        for tile in PROGRAM_TILES:
            shape = SHAPES[tile]
            a, b, c = _padded(host, shape, torch.int8)
            name = KIND_NAMES[kind] + "_int8"
            inj = InjectionSpec.reference_like(n, shape.bk)
            plan, ce, mf = ft._plan(kind, None, False, inj, n // shape.bk,
                                    shape.bn)
            if plan != kind or mf:
                raise AssertionError(f"the int8 program runs {plan} (mf {mf})"
                                     f" at {tile}, not {kind}")
            run, plain = kern.calls(kind, shape, a, b, c, _scalars(inj), ce)
            ms = cuda_ms(run, reps=5)
            plain_ms = cuda_ms(plain)
            library_ms = cuda_ms(lambda: torch._int_mm(a, b.T), reps=5)
            flops, nbytes = work(kind, shape, n, ce, int8=True)
            bound_ms, bound_by = _bound(flops, nbytes,
                                        tc_products(kind, shape, n),
                                        int8=True)
            rows.setdefault(name, {
                "name": name, "route": "cuda",
                "source": kern.table[name]["source"],
                "replaces": kern.table[name]["replaces"],
                "launches": counts[name], "max_abs_err": kern.max_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "tile": tile,
                "mainloop": _build.mainloop(kind, shape, "int8")})
            log(f"phase timing {name} ({tile}, wgmma-s8, {n}, check every"
                f" {ce}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
                f" torch._int_mm {library_ms:.3f} ms, bound {bound_ms:.3f} ms"
                f" ({bound_by})")
    return list(rows.values())


# The kernel of B1 and B2 in ptxas_summary's names; B3-B8 run
# ft_running_wgmma_kernel.
FLOAT_KERNELS = {"sgemm": "sgemm_wgmma_kernel",
                 "precomp": "ft_weighted_wgmma_kernel"}


def phase_timing(kern: Kernels, counts, threshold_counts):
    """Each kernel at 4096 on every tile, cadence and multifault setting the
    program gives it (``TIMED``): the kernel, its plain version,
    torch.addmm for the same alpha*A@B.T + beta*C, and the bound (3xTF32
    on the tensor cores, counting the expected-sum products that run there,
    ``tc_products``). Rows name their mainloop and carry the FFMA bound
    beside it. B2 at small, which the program does not launch (id 11 runs
    B5 there), is timed too (OFF_PATH). Then each adaptive build at every
    tile and cadence the program gives it under threshold="adaptive",
    beside its static build on the same launch (``static_ms``); its
    launches are the threshold path's (``threshold_counts``)."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft = kern.ft
    n = TIMING_SIZE
    gen = np.random.default_rng(11)
    operands = {}
    rows = {}
    for kind, tile in TIMED:
        shape = SHAPES[tile]
        if tile not in operands:
            operands[tile] = _padded(_random(n, n, n, gen), shape)
        name = KIND_NAMES[kind]
        a, b, c = operands[tile]
        inj = InjectionSpec.reference_like(n, shape.bk)
        ce, mf = None, False
        if kind != "sgemm":
            strategy, encode = KIND_PAIR[kind]
            plan, ce, mf = ft._plan(strategy, None, None, inj, n // shape.bk,
                                    shape.bn, encode)
            if (kind, tile) in OFF_PATH:
                ce, mf = n // shape.bk, False
            elif plan != kind:
                raise AssertionError(f"the program runs {plan} at {shape.name},"
                                     f" not {kind}")
        run, plain = kern.calls(kind, shape, a, b, c, _scalars(inj), ce, mf)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(lambda: torch.addmm(
            c, a, b.T, beta=kern.beta, alpha=kern.alpha), reps=5)
        flops, nbytes = work(kind, shape, n, ce, mf)
        ffma_ms, _ = _bound(flops, nbytes)
        tc_ms, tc_by = _bound(flops, nbytes, tc_products(kind, shape, n, mf))
        mainloop = _build.mainloop(kind, shape)
        bound_ms, bound_by = tc_ms, tc_by
        row = {"name": name, "route": "cuda",
               "source": kern.table[name]["source"],
               "replaces": kern.table[name]["replaces"],
               "launches": counts[name], "max_abs_err": kern.max_err[name],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "tile": shape.name, "mainloop": mainloop,
               "tc_bound_ms": tc_ms, "ffma_bound_ms": ffma_ms}
        rows.setdefault(name, row)
        log(f"phase timing {name} ({shape.name}, {mainloop}, {n}, check every"
            f" {ce}, multifault {mf}): kernel {ms:.3f} ms, plain"
            f" {plain_ms:.3f} ms, torch.addmm {library_ms:.3f} ms, bound"
            f" {bound_ms:.3f} ms ({bound_by}; FFMA {ffma_ms:.3f}, 3xTF32"
            f" {tc_ms:.3f})")
    for kind in ADAPTIVE_KINDS:
        strategy, encode = KIND_PAIR[kind]
        for tile in PROGRAM_TILES:
            shape = SHAPES[tile]
            a, b, c = operands[tile]
            inj = InjectionSpec.reference_like(n, shape.bk)
            plan, ce, mf = ft._plan(strategy, None, None, inj, n // shape.bk,
                                    shape.bn, encode, adaptive=True)
            if plan != kind:
                raise AssertionError(f"adaptive {strategy}/{encode} runs"
                                     f" {plan} at {tile}, not {kind}")
            name = KIND_NAMES[kind] + "_adaptive"
            static, _ = kern.calls(kind, shape, a, b, c, _scalars(inj), ce, mf)
            run, plain = kern.calls(kind, shape, a, b, c,
                                    _adaptive_scalars(inj), ce, mf, True)
            static_ms = cuda_ms(static, reps=5)
            ms = cuda_ms(run, reps=5)
            flops, nbytes = work(kind, shape, n, ce, mf, adaptive=True)
            bound_ms, bound_by = _bound(flops, nbytes,
                                        tc_products(kind, shape, n, mf))
            log(f"phase timing {name} ({tile}, {n}, check every {ce},"
                f" multifault {mf}): kernel {ms:.3f} ms, static build"
                f" {static_ms:.3f} ms ({(ms / static_ms - 1) * 100:+.1f} %),"
                f" bound {bound_ms:.3f} ms ({bound_by})")
            if name in rows:
                continue
            library_ms = cuda_ms(lambda: torch.addmm(
                c, a, b.T, beta=kern.beta, alpha=kern.alpha), reps=5)
            rows[name] = {
                "name": name, "route": "cuda",
                "source": kern.table[name]["source"],
                "replaces": kern.table[name]["replaces"],
                "launches": threshold_counts[name],
                "max_abs_err": kern.max_err[name], "ms": ms,
                "plain_ms": cuda_ms(plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "tile": tile,
                "mainloop": _build.mainloop(kind, shape),
                "static_ms": static_ms}
    phase_residual(kern, operands)
    return list(rows.values())


def phase_residual(kern: Kernels, operands):
    """Worst clean checksum residuals at 4096 (C = 0, alpha = 1: the output
    is the accumulator), which must stay RESIDUAL_MARGIN times under the
    threshold: the f32 column moments of B2's (huge, and medium and wide
    on the 128 x 128 CTA) and B5's and B6's (small, huge) accumulators
    against the torch.matmul expectations, and B3's and B7's (small, huge)
    row and column sums against A . s_b and the plain expected column
    checksums; and each tile's total of B4's and B8's accumulators (small,
    huge) against t_exp = s_a . s_b from the moment rows. B3, B5, B6 and B7
    also run clean with the threshold cut RESIDUAL_MARGIN times: their
    in-kernel residuals (the expected sums from the tensor-core products
    against the accumulator's sums) must flag nothing; B4 and B8 flag
    nothing at the threshold."""
    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops.common import scalar_operand

    ft = kern.ft
    n = TIMING_SIZE
    huge = SHAPES["huge"]
    zero = torch.zeros((n, n), device="cuda")
    clean = _scalars(InjectionSpec.none())
    limit = REFERENCE_THRESHOLD / RESIDUAL_MARGIN
    tight = scalar_operand(InjectionSpec.none(), (limit,) * 3)

    def moments_residual(acc, expm, bm):
        t = acc.reshape(n // bm, bm, n)
        w = torch.arange(1, bm + 1, device="cuda",
                         dtype=torch.float32)[None, :, None]
        return [float((expm[:, v] - (t * w ** v).sum(1)).abs().max())
                for v in range(3)]

    worst = {}
    faults = 0
    for kind, tile in (("precomp", "huge"), ("precomp", "medium"),
                       ("precomp", "wide"), ("running", "small"),
                       ("running", "huge"), ("fused", "small"),
                       ("fused", "huge")):
        shape = SHAPES[tile]
        a, b, _ = operands[tile]
        expm = ft._expected_col_checksums(a, b, shape.bm)
        extra = ft.kernel_inputs(kind, a, b, shape)
        nk = n // shape.bk
        ce = ft._plan(KIND_PAIR[kind][0], None, None, InjectionSpec.none(), nk,
                      shape.bn, KIND_PAIR[kind][1])[1]
        if kind != "precomp":
            ce = max(1, nk // 4)   # intermediate checks
        acc, det, unc = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0,
                                      0.0, clean, ce)
        faults += int(det.sum()) + int(unc.sum())
        if kind != "precomp":
            _, tdet, tunc = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0,
                                          0.0, tight, ce)
            if int(tdet.sum()) or int(tunc.sum()):
                raise AssertionError(
                    f"{KIND_NAMES[kind]} {tile}: clean in-kernel residuals"
                    f" above {limit:g} ({int(tdet.sum())} flagged)")
        worst[f"{KIND_NAMES[kind]} {tile}"] = moments_residual(acc, expm,
                                                               shape.bm)
    # B3 and B7: the row sums against A . s_b (B's band sums) and the column
    # sums against the plain expected column checksums; clean, nothing
    # flags, also at the cut threshold.
    for kind, tile in (("rowcol", "small"), ("rowcol", "huge"),
                       ("rowcol_mxu", "small"), ("rowcol_mxu", "huge")):
        shape = SHAPES[tile]
        a, b, _ = operands[tile]
        extra = ft.kernel_inputs(kind, a, b, shape)
        _, ce, mf = ft._plan("rowcol", None, None, InjectionSpec.none(),
                             n // shape.bk, shape.bn, KIND_PAIR[kind][1])
        for sc in (clean, tight):
            acc, det, unc = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0,
                                          0.0, sc, ce, mf)
            if int(det.sum()) or int(unc.sum()):
                raise AssertionError(
                    f"{KIND_NAMES[kind]} {tile}: a clean run flagged"
                    f" {int(det.sum())} at threshold {float(sc[4]):g}")
        r_exp = a @ ft._tile_moments(b, shape.bn, 1)[:, 0].T
        c_exp = ft._expected_col_checksums(a, b, shape.bm)[:, 0]
        worst[f"{KIND_NAMES[kind]} {tile} (rows, columns)"] = [
            float((r_exp - acc.reshape(n, -1, shape.bn).sum(-1)).abs().max()),
            float((c_exp - acc.reshape(-1, shape.bm, n).sum(1)).abs().max())]
    # B4 and B8: each tile's total against t_exp = s_a . s_b from the moment
    # rows.
    worst_global = {}
    for kind, tile in (("global", "small"), ("global", "huge"),
                       ("global_mxu", "small"), ("global_mxu", "huge")):
        shape = SHAPES[tile]
        a, b, _ = operands[tile]
        extra = ft.kernel_inputs(kind, a, b, shape)
        _, ce, _ = ft._plan("global", None, None, InjectionSpec.none(),
                            n // shape.bk, shape.bn, KIND_PAIR[kind][1])
        gacc, gdet, _ = ft.run_kernel(kind, shape, a, b, zero, extra, 1.0, 0.0,
                                      clean, ce)
        faults += int(gdet.sum())
        ma, mb = (ft._tile_moments(x, bt, 1)[:, 0]
                  for x, bt in ((a, shape.bm), (b, shape.bn)))
        t_exp = ma @ mb.T
        totals = gacc.reshape(n // shape.bm, shape.bm, n // shape.bn,
                              shape.bn).sum((1, 3))
        worst_global[f"{KIND_NAMES[kind]} {tile}"] = (
            float((t_exp - totals).abs().max()), float(t_exp.abs().max()))
    if faults:
        raise AssertionError("a clean run reported faults")
    log(f"phase residual: worst clean residual at {n} (weighted: moments 1,"
        f" w, w^2; rowcol: rows, columns; every kernel"
        f" {_build.mainloop('precomp', huge)}): {worst}; global (tile total,"
        f" largest |t_exp|): {worst_global}; threshold 9500, at which B4 and"
        f" B8 flag nothing; B3, B5, B6 and B7 flag nothing at threshold"
        f" {limit:g}")
    bad = {k: v for k, v in worst.items() if max(v) > limit}
    if bad:
        raise AssertionError(f"clean residuals {bad} are not"
                             f" {RESIDUAL_MARGIN:g}x under the threshold")


def _epi_label(dtype: str) -> str:
    return {"float32": "", "bfloat16": "_bf16", "fp8": "_fp8",
            "int8": "_int8"}[dtype]


def _epi_host(n, dtype, gen):
    """Host (A, B, C) for the epilogue's kernel-vs-identity launches: the
    int8 lattice ±9 for int8, else the program's ±0.9 data."""
    if dtype == "int8":
        return _int8_host(n, n, n, gen, -9, 9)
    return _random(n, n, n, gen)


def _epi_cadence(ft, kind, shape, inj, nk, adaptive, dtype):
    """The cadence and multifault setting the program gives ``kind`` on
    ``shape``; one check at the end where the program runs another kernel
    there (B2 at small, B5 where weighted runs B2); int8 without
    multifault."""
    if kind == "sgemm":
        return None, False
    strategy, encode = KIND_PAIR[kind]
    plan, ce, mf = ft._plan(strategy, None, None, inj, nk, shape.bn, encode,
                            adaptive)
    if plan != kind:
        ce, mf = nk, False
    return ce, mf and dtype != "int8"


def _epi_same(got, want):
    """Equal element by element, NaN where NaN."""
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def _epi_bracket_c(quant: str, m: int, n: int) -> torch.Tensor:
    """An (m, n) C of the quantizer's edge values, tiled: for fp8 every
    finite e4m3 value, the midpoints between neighbours, 448-1e4 and their
    negatives, ±inf and NaN; for int8 the .5 ties at scales 1 and 0.25,
    ±127.5, ±128.5, ±inf and NaN."""
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0,
                            -0.0])
    if quant == "fp8":
        codes = torch.arange(256, dtype=torch.uint8).view(
            torch.float8_e4m3fn).float()
        grid = torch.unique(codes[torch.isfinite(codes)])
        big = torch.cat([torch.linspace(448.0, 1e4, 401),
                         torch.tensor([463.99, 464.0, 464.01, 479.9, 480.0])])
        vals = torch.cat([grid, (grid[1:] + grid[:-1]) / 2, big, -big,
                          special])
    else:
        ties = torch.arange(-130.5, 131.0, 1.0)
        vals = torch.cat([ties, ties * 4, torch.tensor(
            [127.5, -127.5, 128.5, -128.5, 127.49, -128.51]), special])
    reps = -(-m * n // vals.numel())
    return vals.repeat(reps)[: m * n].reshape(m, n).contiguous()


def phase_epilogue(kern: Kernels):
    """The fused epilogue (bias, relu or gelu, qint8 or qfp8 after detect
    and correct, in every kernel's store), in four parts. (1) Every build
    of EPI_BUILDS (which together hold all the libraries of
    ``ops/_build.LIBRARIES``) at EPI_SIZE on a paper tile with
    reference-like faults: each spelling of EPI_SPELLINGS against the same
    kernel's identity launch pushed through ``apply_epilogue`` on the card
    (``epilogue_violations``: element by element without gelu, the GELU
    within GELU_TOLERANCE_ULPS of its input's magnitude), the grids equal
    to the identity's, one epilogue launch counted a spelling. (2) The grid
    bracket (EPI_BRACKET): alpha = 0, beta = 1, A = B = 0, so the output is
    C; with qfp8 and qint8 (scales 1 and 0.25) it must equal ``to_e4m3`` /
    the int8 clamp of C element by element, on the card and as the CPU
    computes it. (3) The entry points at VERIFY_SIZE: ``make_ft_sgemm(...,
    epilogue=...)(a, b, c, inject, bias=v)`` for every legal (dtype,
    strategy, encode) under the static threshold (the huge tile, and B5 at
    small), and ``make_sgemm`` for B1, against
    ``epilogue_reference(sgemm_reference(...))``: ``bias+gelu`` within
    verify_matrix's rule, ``bias+relu+qfp8`` more than 98 % exact and every
    value within one e4m3 step (the JAX package's tests/test_variants.py
    bounds), int8's ``bias+qint8x0.25`` exactly; every fault detected and
    corrected (global: each event, a clean run for C); the epilogue launch
    counters show each kernel ran it. (4) Each (body, dtype) at huge at
    TIMING_SIZE with EPI_TIMED beside its identity. Returns the
    ``kernels`` rows of (4)."""
    from ft_sgemm_tpu_torch import cli, make_ft_sgemm, make_sgemm
    from ft_sgemm_tpu_torch.configs import SHAPES, EpilogueSpec
    from ft_sgemm_tpu_torch.injection import InjectionSpec
    from ft_sgemm_tpu_torch.ops.common import LaunchAxes, apply_epilogue, pad_bias
    from ft_sgemm_tpu_torch.ops.reference import (
        epilogue_reference,
        epilogue_violations,
        sgemm_reference,
    )
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    ft, sg = kern.ft, kern.sg
    dev = torch.device("cuda")
    wrappers = [("sgemm", sg.sgemm_kernel)] + [
        (k, kern.table[KIND_NAMES[k]]["wrapper"]) for k in FT_KINDS]
    big = {}  # the program's inputs at 4096, once per dtype

    def program_inputs(dtype):
        if dtype not in big:
            big[dtype] = cli._host_inputs(
                VERIFY_SIZE, "float8_e4m3fn" if dtype == "fp8" else dtype)
        return big[dtype]

    t0 = time.perf_counter()
    # (1) every build, each spelling against its identity launch; together
    # the builds launch every library.
    from ft_sgemm_tpu_torch.ops import _build

    builds = ([build + (False,) for build in EPI_BUILDS]
              + [(k, "float32", ad, True) for k, ad in EPI_ONE_PASS_BUILDS])
    libs = {(("sgemm_fp8" if d == "fp8" else "sgemm_tf32" if op else "sgemm")
             if k == "sgemm" else
             ft.kernel_entry(k, torch.bfloat16 if d == "fp8" else
                             TORCH_DTYPES[d], ad, op)[0])
            for k, d, ad, op in builds}
    if set(_build.KERNEL_LIBS) - libs:
        raise AssertionError("libraries no epilogue build launches:"
                             f" {sorted(set(_build.KERNEL_LIBS) - libs)}")
    gen = np.random.default_rng(31)
    n = EPI_SIZE
    hosts = {d: _epi_host(n, d, gen) for d in TORCH_DTYPES}
    bias_host = (gen.standard_normal(n) * 2.0).astype(np.float32)
    errs = {}
    for i, (kind, dtype, adaptive, one_pass) in enumerate(builds):
        shape = SHAPES[PROGRAM_TILES[i % len(PROGRAM_TILES)]]
        axes = LaunchAxes(one_pass=one_pass)
        a, b, c = _padded(hosts[dtype], shape, TORCH_DTYPES[dtype])
        inj = InjectionSpec.reference_like(n, shape.bk)
        ce, mf = _epi_cadence(ft, kind, shape, inj, a.shape[1] // shape.bk,
                              adaptive, dtype)
        sc = _adaptive_scalars(inj) if adaptive else _scalars(inj)
        row = pad_bias(bias_host, n, shape.bn, dev)
        wrapper = kern.table[KIND_NAMES[kind]]["wrapper"]
        ident = kern.calls(kind, shape, a, b, c, sc, ce, mf, adaptive,
                           axes=axes)[0]()
        before = wrapper.epilogue_launches
        for spelling in EPI_SPELLINGS:
            epi = EpilogueSpec.parse(spelling)
            got = kern.calls(kind, shape, a, b, c, sc, ce, mf, adaptive, epi,
                             row, axes)[0]()
            torch.cuda.synchronize()
            what = (f"epilogue {spelling} {kind} {dtype}"
                    f"{' adaptive' if adaptive else ''}"
                    f"{' one-pass' if one_pass else ''} {shape.name}")
            if kind != "sgemm":
                if not (torch.equal(got[1], ident[1])
                        and torch.equal(got[2], ident[2])):
                    raise AssertionError(f"{what}: the epilogue moved the"
                                         " grids")
                out, x = got[0], ident[0]
            else:
                out, x = got, ident
            bad = int(epilogue_violations(out, x, epi, row).sum())
            if bad:
                raise AssertionError(f"{what}: {bad} elements are not the"
                                     " identity's through apply_epilogue")
            want = apply_epilogue(x, epi, row[None, :])
            diff = (out - want)[torch.isfinite(out) & torch.isfinite(want)]
            key = (kind, dtype)
            errs[key] = max(errs.get(key, 0.0), float(diff.abs().max())
                            if diff.numel() else 0.0)
        counted = wrapper.epilogue_launches - before
        if counted != len(EPI_SPELLINGS):
            raise AssertionError(f"{kind} {dtype}: {counted} epilogue"
                                 f" launches counted, not"
                                 f" {len(EPI_SPELLINGS)}")
    log(f"phase epilogue kernels: {len(builds)} builds x"
        f" {len(EPI_SPELLINGS)} spellings at {n} equal to their identity"
        f" launches through apply_epilogue (gelu within the stated ulps),"
        f" grids unchanged; max |dC| {max(errs.values()):.3g};"
        f" {time.perf_counter() - t0:.1f} s")
    # (2) the grid bracket.
    t1 = time.perf_counter()
    nchecked = 0
    m, kdim = 256, 64
    sc = _scalars(InjectionSpec.none())
    for kind, dtype, tile in EPI_BRACKET:
        shape = SHAPES[tile]
        z = torch.zeros((m, kdim), device=dev).to(TORCH_DTYPES[dtype])
        extra = () if kind == "sgemm" else ft.kernel_inputs(kind, z, z, shape)
        for quant, spellings in (("fp8", ("qfp8",)),
                                 ("int8", ("qint8", "qint8x0.25"))):
            c = _epi_bracket_c(quant, m, m)
            cd = c.to(dev)
            for spelling in ("none",) + spellings:
                epi = EpilogueSpec.parse(spelling)
                if kind == "sgemm":
                    out = sg.sgemm_kernel(z, z, cd, shape, 0.0, 1.0, epi)
                else:
                    out = ft.run_kernel(kind, shape, z, z, cd, extra, 0.0,
                                        1.0, sc, 1, epi=epi)[0]
                torch.cuda.synchronize()
                want = apply_epilogue(cd, epi)
                if not (_epi_same(out, want) and _epi_same(
                        out.cpu(), apply_epilogue(c, epi))):
                    nbad = int((~((out == want) | (torch.isnan(out)
                                                    & torch.isnan(want))))
                               .sum())
                    raise AssertionError(
                        f"bracket {kind} {dtype} {tile} {spelling}: {nbad}"
                        " elements differ from the quantize of C")
                nchecked += 1
    log(f"phase epilogue bracket: {nchecked} launches of B1 and B2-B4, B6"
        " (and B3 int8) with alpha 0, beta 1, A = B = 0 give C, to_e4m3(C)"
        " and the int8 clamp of C (scales 1, 0.25) element by element, NaN"
        f" and ±inf included; {time.perf_counter() - t1:.1f} s")
    # (3) the entry points at VERIFY_SIZE.
    t2 = time.perf_counter()
    nv = VERIFY_SIZE
    counts = {}
    for dtype, pairs in (("float32", BF16_PAIRS), ("bfloat16", BF16_PAIRS),
                         ("fp8", LOWP_PAIRS),
                         ("int8", (("rowcol", "vpu"), ("global", "vpu")))):
        a, b, c = (torch.from_numpy(x).to(dev) for x in program_inputs(dtype))
        bias = torch.from_numpy((np.random.default_rng(37).standard_normal(nv)
                                 * 2.0).astype(np.float32)).to(dev)
        if dtype == "int8":
            bias = torch.round(bias * 4.0)
        ref = sgemm_reference(a, b, c, kern.alpha, kern.beta,
                              in_dtype=TORCH_DTYPES[dtype])
        for _, w in wrappers:
            w.epilogue_launches = 0
        runs = [(s, e, "huge") for s, e in pairs]
        if dtype != "int8":  # B1 (int8 has no plain GEMM), and B5 at small
            runs += [("sgemm", None, "huge"), ("weighted", "vpu", "small")]
        spellings = (("bias+qint8x0.25",) if dtype == "int8" else
                     ("bias+gelu", "bias+relu+qfp8"))
        for strategy, encode, tile in runs:
            for spelling in spellings:
                want = epilogue_reference(ref, spelling, bias)
                what = f"entry point {strategy}/{encode} {dtype} {tile} {spelling}"
                if strategy == "sgemm":
                    got = make_sgemm(tile, alpha=kern.alpha, beta=kern.beta,
                                     in_dtype=dtype, epilogue=spelling)(
                        a, b, c, bias=bias)
                else:
                    fn = make_ft_sgemm(tile, alpha=kern.alpha, beta=kern.beta,
                                       strategy=strategy, encode=encode,
                                       in_dtype=dtype, threshold="static",
                                       epilogue=spelling)
                    shape = fn.shape_config
                    inj = InjectionSpec.reference_like(nv, shape.bk)
                    res = fn(a, b, c, inj, bias=bias)
                    tiles = (nv // shape.bm) * (nv // shape.bn)
                    expected = tiles * inj.expected_faults(nv, shape.bk)
                    unc = int(res.num_uncorrectable)
                    if (int(res.num_detected) != expected or unc !=
                            (expected if strategy == "global" else 0)):
                        raise AssertionError(
                            f"{what}: detected {int(res.num_detected)} of"
                            f" {expected}, {unc} uncorrectable")
                    got = (fn(a, b, c, None, bias=bias) if strategy == "global"
                           else res).c
                torch.cuda.synchronize()
                if dtype == "int8":
                    ok = torch.equal(got, want)
                elif spelling == "bias+gelu":
                    ok = _device_verify(want, got) == 0
                else:
                    exact = float((got == want).float().mean())
                    ok = exact > 0.98 and bool(
                        ((got - want).abs() <= 0.02 + 0.15 * want.abs()).all())
                if not ok:
                    raise AssertionError(f"{what}: C is off the oracle through"
                                         " the epilogue")
        for kind, w in wrappers:
            counts[KIND_NAMES[kind] + _epi_label(dtype)] = w.epilogue_launches
    ran = {k: v for k, v in counts.items() if v}
    want_names = ({KIND_NAMES[k] + _epi_label(d) for k, d, ad in EPI_BUILDS
                   if not ad})
    missing = sorted(want_names - set(ran))
    if missing:
        raise AssertionError(f"kernels whose epilogue never launched on the"
                             f" entry points: {missing}")
    log(f"phase epilogue entry points at {nv}: every legal (dtype, strategy,"
        f" encode) and B1 pass against epilogue_reference(sgemm_reference);"
        f" epilogue launches {ran}; {time.perf_counter() - t2:.1f} s")
    # (4) timing: each (body, dtype) at huge, the timed spelling beside the
    # identity on the same launch, its plain version, and the bound.
    t3 = time.perf_counter()
    rows = []
    shape = SHAPES["huge"]
    nt = TIMING_SIZE
    epi = EpilogueSpec.parse(EPI_TIMED)
    row = pad_bias(np.random.default_rng(41).standard_normal(nt).astype(
        np.float32), nt, shape.bn, dev)
    for kind, dtype, adaptive in EPI_BUILDS:
        if adaptive:
            continue
        a, b, c = _padded(program_inputs(dtype), shape, TORCH_DTYPES[dtype])
        inj = InjectionSpec.reference_like(nt, shape.bk)
        ce, mf = _epi_cadence(ft, kind, shape, inj, nt // shape.bk, False,
                              dtype)
        sc = _scalars(inj)
        ident = kern.calls(kind, shape, a, b, c, sc, ce, mf)[0]
        run, plain = kern.calls(kind, shape, a, b, c, sc, ce, mf, False, epi,
                                row)
        ident_ms = cuda_ms(ident, reps=5)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(plain)
        flops, nbytes = work(kind, shape, nt, ce, mf, bf16=dtype == "bfloat16",
                             int8=dtype == "int8", fp8=dtype == "fp8")
        bound_ms, bound_by = _bound(
            flops + EPI_FLOPS * nt * nt, nbytes + 4.0 * nt,
            tc_products(kind, shape, nt, mf), bf16=dtype == "bfloat16",
            int8=dtype == "int8", fp8=dtype == "fp8")
        name = KIND_NAMES[kind] + _epi_label(dtype)
        rows.append({
            "name": name + "_epilogue", "route": "cuda",
            "source": kern.table[KIND_NAMES[kind]]["source"],
            "replaces": EPI_REPLACES[kind], "launches": counts[name],
            "max_abs_err": errs[kind, dtype], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "tile": "huge", "epilogue": EPI_TIMED, "identity_ms": ident_ms})
        log(f"phase epilogue timing {name} (huge, {nt}, check every {ce}):"
            f" {EPI_TIMED} {ms:.3f} ms, identity {ident_ms:.3f} ms"
            f" ({ms - ident_ms:+.3f}), plain {plain_ms:.3f} ms, bound"
            f" {bound_ms:.3f} ms ({bound_by})")
    log(f"phase epilogue: {time.perf_counter() - t0:.1f} s (timing"
        f" {time.perf_counter() - t3:.1f} s)")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        kern = Kernels()
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    spent = {}

    def run(phase, *args):
        """One phase, its seconds logged and kept for the summary."""
        t = time.perf_counter()
        out = phase(*args)
        name = phase.__name__ + "".join(f" {a}" for a in args
                                        if isinstance(a, (str, bool)))
        spent[name] = time.perf_counter() - t
        log(f"phase time {name}: {spent[name]:.1f} s, at"
            f" {time.perf_counter() - t0:.1f} s")
        return out

    smi, variant = run(phase_device)
    # The f32 static libraries' phases, while the rest builds.
    run(phase_kernels, kern)
    run(phase_accuracy, kern)
    run(phase_path_shapes, kern)
    run(phase_int8_kernels, kern)
    counts, _ = run(phase_main_path, kern)
    # The f32 adaptive libraries'.
    run(phase_adaptive_kernels, kern)
    run(phase_adaptive_bracket, kern)
    threshold_counts = run(phase_threshold_path, kern)
    so = run(phase_build, variant, t0)
    run(phase_variant, kern, so)
    default_counts = run(phase_default_path, kern)
    run(phase_variants, kern)
    run(phase_bf16_kernels, kern)
    run(phase_fp8_kernels, kern)
    run(phase_adaptive_kernels, kern, True)
    for in_dtype in LOWP_DTYPES:
        run(phase_lowp_bracket, kern, in_dtype)
    bf16_counts, bf16_tables = run(phase_float_path, kern, "bfloat16")
    int8_counts, _ = run(phase_int8_path, kern)
    fp8_counts, fp8_tables = run(phase_float_path, kern, "fp8")
    lowp_counts = {
        in_dtype: run(phase_threshold_path, kern, in_dtype, tables)
        for in_dtype, tables in zip(LOWP_DTYPES, (bf16_tables, fp8_tables))}
    run(phase_fp8_residual, kern)
    run(phase_roc, kern)
    epilogue_rows = run(phase_epilogue, kern)
    rows = run(phase_timing, kern, counts, threshold_counts)
    rows += run(phase_default_timing, kern, default_counts)
    rows += run(phase_float_timing, kern, bf16_counts, "bfloat16")
    rows += run(phase_int8_timing, kern, int8_counts)
    rows += run(phase_float_timing, kern, fp8_counts, "fp8")
    for in_dtype in LOWP_DTYPES:
        rows += run(phase_lowp_adaptive_timing, kern, lowp_counts[in_dtype],
                    in_dtype)
    rows += epilogue_rows
    log(f"total {time.perf_counter() - t0:.1f} s; by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

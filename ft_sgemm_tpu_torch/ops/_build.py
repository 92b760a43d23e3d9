"""Build and load the port's CUDA kernels.

Every library of :data:`LIBRARIES` is compiled at first use, on the machine
with the card, by ``nvcc`` from one ``csrc/*.cu`` into a shared library with
a plain C interface, loaded with ``ctypes``. The FT sources build twice:
as they are (static thresholds and ``threshold="auto"``) and with
``FTSG_ADAPTIVE=1`` (``threshold="adaptive"``: B3-B8 derive each
sub-tile's threshold in the kernel), two libraries with the same entry
points. Libraries build in parallel, one ``nvcc`` each, into
``csrc/_build/`` (ignored by git); a library's file name carries a digest
of all sources and flags, so an edit rebuilds. ``-Xptxas -v`` output (the
registers, shared memory and spills of every kernel) is kept beside each
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

# Each library: its source and the macros it is compiled with. The
# adaptive libraries hold B3-B8 only (ft_sgemm_weighted.cu leaves B2 out).
ADAPTIVE = ("-DFTSG_ADAPTIVE=1",)
LIBRARIES = {
    "sgemm": ("sgemm", ()),
    "ft_sgemm_weighted": ("ft_sgemm_weighted", ()),
    "ft_sgemm_rowcol": ("ft_sgemm_rowcol", ()),
    "ft_sgemm_global": ("ft_sgemm_global", ()),
    "ft_sgemm_aug": ("ft_sgemm_aug", ()),
    "ft_sgemm_weighted_adaptive": ("ft_sgemm_weighted", ADAPTIVE),
    "ft_sgemm_rowcol_adaptive": ("ft_sgemm_rowcol", ADAPTIVE),
    "ft_sgemm_global_adaptive": ("ft_sgemm_global", ADAPTIVE),
    "ft_sgemm_aug_adaptive": ("ft_sgemm_aug", ADAPTIVE),
}
KERNEL_LIBS = tuple(LIBRARIES)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a"
                           " machine with the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=1)
def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def so_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` reported for one source's kernels."""
    return so_path(name).with_suffix(".ptxas.txt").read_text()


def build(names=KERNEL_LIBS) -> float:
    """Compile the named libraries that are not built yet, all in parallel;
    returns the wall seconds. Raises with the compiler's output on failure."""
    todo = [n for n in names if not so_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        source, defines = LIBRARIES[name]
        proc = subprocess.Popen(
            [exe, *NVCC_FLAGS, *defines, "-o", tmp, str(CSRC / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tmp, proc))
    failures = []
    for name, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failures.append(f"nvcc {name}.cu failed:\n{log}")
            os.unlink(tmp)
            continue
        so_path(name).with_suffix(".ptxas.txt").write_text(log)
        # Rename into place last: a concurrent loader never sees a
        # half-written library.
        os.replace(tmp, so_path(name))
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` of :data:`LIBRARIES`, building it if
    needed."""
    build((name,))
    return ctypes.CDLL(str(so_path(name)))


def bind(lib: ctypes.CDLL, fname: str, argtypes):
    """One C entry point with its argument types; every entry point returns
    ``cudaGetLastError()`` as an int."""
    fn = getattr(lib, fname)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _tile_list(macro: str) -> frozenset:
    """The (bm, bn) pairs of the X-macro ``macro`` in ``csrc/gemm_wgmma.cuh``."""
    text = (CSRC / "gemm_wgmma.cuh").read_text()
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", text, re.S)
    return frozenset(tuple(map(int, x)) for x in re.findall(
        r"X\((\d+), (\d+)\)", body.group(1)))


@functools.lru_cache(maxsize=1)
def wgmma_tiles() -> frozenset:
    """The (bm, bn) tiles on which B1 and B2 run the tile's own CTA
    (``FTSG_FOR_EACH_WGMMA_TILE``): large, tall, huge and test."""
    return _tile_list("FTSG_FOR_EACH_WGMMA_TILE")


@functools.lru_cache(maxsize=1)
def narrow_tiles() -> frozenset:
    """The (bm, bn) tiles narrower than wgmma's 64 rows, on which B1 and B2
    run the 128 x 128 CTA (``FTSG_FOR_EACH_NARROW_TILE``): small, medium
    and wide."""
    return _tile_list("FTSG_FOR_EACH_NARROW_TILE")


@functools.lru_cache(maxsize=1)
def subtiles() -> frozenset:
    """The (bm, bn) tiles on which B3-B8 run: sub-tiles of one 128 x 128
    3xTF32 wgmma CTA (``FTSG_FOR_EACH_SUBTILE``)."""
    return _tile_list("FTSG_FOR_EACH_SUBTILE")


def check_tile(shape) -> tuple:
    """The (bm, bn) that the entry points take for ``shape``; raises for a
    tile that some kernel's source does not instantiate."""
    tile = (shape.bm, shape.bn)
    if tile not in (wgmma_tiles() | narrow_tiles()) or tile not in subtiles():
        raise ValueError(
            f"KernelShape {shape.name!r} tile {tile} is not compiled;"
            f" compiled (bm, bn): {sorted(subtiles())}")
    return tile


def mainloop(kind: str, shape) -> str:
    """The mainloop that kernel ``kind`` (``"sgemm"`` for B1, else an
    ``ops/ft_sgemm._plan`` kind) runs on ``shape``: ``"wgmma-3xtf32"``, for
    every kernel at every compiled tile; raises for another tile. The CTA
    differs: B1 and B2 (``precomp``) run the tile's own CTA at the tiles of
    :func:`wgmma_tiles` and the 128 x 128 CTA at those of
    :func:`narrow_tiles` (B2 checking the tile as its sub-tile); B3
    ``rowcol``, B4 ``global``, B5 ``running``, B6 ``fused``, B7
    ``rowcol_mxu`` and B8 ``global_mxu`` run the 128 x 128 CTA over the
    tile as its sub-tile at every tile of :func:`subtiles`."""
    check_tile(shape)
    return "wgmma-3xtf32"


def check_operands(shape, a, b, c, *more) -> tuple:
    """Validate a kernel launch: f32, contiguous, 16-byte aligned operands
    on one CUDA device, A (M, K), B (N, K) and C (M, N) padded to the tile
    (M % bm == N % bn == K % bk == 0, K >= bk), and a compiled tile.
    Returns (M, N, K, bm, bn, bk)."""
    dev = a.device
    for t in (a, b, c, *more):
        if not t.is_cuda or t.device != dev:
            raise ValueError("kernel operands must lie on one CUDA device,"
                             f" got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"kernels take float32 operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernels take contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("kernels take 16-byte aligned operands")
    (m, k), (n, kb) = a.shape, b.shape
    if kb != k or tuple(c.shape) != (m, n):
        raise ValueError(f"shapes A{tuple(a.shape)} B{tuple(b.shape)}"
                         f" C{tuple(c.shape)} do not form A @ B.T + C")
    if m % shape.bm or n % shape.bn or k % shape.bk or k < shape.bk:
        raise ValueError(f"operands ({m}, {n}, {k}) are not padded to the"
                         f" tile {shape.block}")
    return (m, n, k, *check_tile(shape), shape.bk)

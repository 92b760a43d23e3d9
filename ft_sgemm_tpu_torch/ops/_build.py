"""Build and load the port's CUDA kernels.

Every library of :data:`LIBRARIES` is compiled at first use, on the machine
with the card, by ``nvcc`` from one ``csrc/*.cu`` into a shared library with
a plain C interface, loaded with ``ctypes``; B1's library also holds its
bf16 build (``ftsg_sgemm_bf16``), and the static libraries of B3 and B4
their int8 builds (``*_int8``). The FT sources build twice in f32: as they
are (static thresholds and ``threshold="auto"``) and with
``FTSG_ADAPTIVE=1`` (``threshold="adaptive"``: B3-B8 derive each
sub-tile's threshold in the kernel), two libraries with the same entry
points. Their bf16 builds are the same sources once more with
``FTSG_BF16=1``, which compiles a source's bf16 entry points alone:
libraries of their own, the static ``*_bf16`` (B2-B8, the heaviest, B2,
B5, B6 and B7, one each by ``FTSG_KERNEL``; bf16 and fp8 on the vpu
encodes, bf16 on the mxu encodes) and, with ``FTSG_ADAPTIVE=1`` too,
the adaptive ``*_adaptive_bf16`` (B3-B8: ``threshold="adaptive"`` in bf16,
and B3-B5 in fp8 on the widened operands; B6 and B7 each alone, by
``FTSG_KERNEL``), so that the builds run side by side, none of them the
long pole of them all. B1's fp8 build (``ftsg_sgemm_fp8``) is B1's source once more,
with ``FTSG_FP8=1``, which compiles that entry point alone: a library of its
own, so that it builds beside the others and leaves every other build as it
was (B2-B5 in fp8 run their bf16 builds on the exactly widened operands).
The f32 builds of every source, static and adaptive, build once more with
``FTSG_ONE_PASS=1`` (``*_tf32``: the f32 precision "default", one TF32
wgmma a k step where 3xTF32 issues three), libraries of their own, so that
the 3xTF32 builds keep their code.
Libraries build in parallel, one ``nvcc`` each, into
``csrc/_build/`` (ignored by git); a library's file name carries a digest
of all sources and flags, so an edit rebuilds. ``-Xptxas -v`` output (the
registers, shared memory and spills of every kernel) is kept beside each
library.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import signal
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

# Each library: its source and the macros it is compiled with. The static
# FT libraries hold the f32 builds (and B3's and B4's int8 ones), the
# static bf16 ones B2-B8 in bf16 (B2, B5, B6 and B7 each alone:
# FTSG_KERNEL, so that no library is the long pole of the parallel build),
# the adaptive libraries B3-B8 in f32 (ft_sgemm_weighted.cu leaves B2 out),
# and the adaptive bf16 ones B3-B8 in bf16 (B4 and B8 in one, B6 and B7 each
# alone). The "*_tf32" libraries are the f32 builds, static and adaptive,
# once more with FTSG_ONE_PASS: one TF32 wgmma a k step (the f32 precision
# "default").
BF16 = ("-DFTSG_BF16=1",)
ADAPTIVE = ("-DFTSG_ADAPTIVE=1",)
ADAPTIVE_BF16 = ADAPTIVE + BF16
FP8 = ("-DFTSG_FP8=1",)
ONE_PASS = ("-DFTSG_ONE_PASS=1",)
LIBRARIES = {
    "sgemm": ("sgemm", ()),
    "ft_sgemm_weighted": ("ft_sgemm_weighted", ()),
    "ft_sgemm_rowcol": ("ft_sgemm_rowcol", ()),
    "ft_sgemm_global": ("ft_sgemm_global", ()),
    "ft_sgemm_aug": ("ft_sgemm_aug", ()),
    "ft_sgemm_precomp_bf16": ("ft_sgemm_weighted", BF16 + ("-DFTSG_KERNEL=2",)),
    "ft_sgemm_weighted_bf16": ("ft_sgemm_weighted", BF16 + ("-DFTSG_KERNEL=5",)),
    "ft_sgemm_rowcol_bf16": ("ft_sgemm_rowcol", BF16),
    "ft_sgemm_global_bf16": ("ft_sgemm_global", BF16),
    "ft_sgemm_fused_bf16": ("ft_sgemm_aug", BF16 + ("-DFTSG_KERNEL=6",)),
    "ft_sgemm_rowcol_mxu_bf16": ("ft_sgemm_aug", BF16 + ("-DFTSG_KERNEL=7",)),
    "ft_sgemm_weighted_adaptive": ("ft_sgemm_weighted", ADAPTIVE),
    "ft_sgemm_rowcol_adaptive": ("ft_sgemm_rowcol", ADAPTIVE),
    "ft_sgemm_global_adaptive": ("ft_sgemm_global", ADAPTIVE),
    "ft_sgemm_aug_adaptive": ("ft_sgemm_aug", ADAPTIVE),
    "ft_sgemm_weighted_adaptive_bf16": ("ft_sgemm_weighted", ADAPTIVE_BF16),
    "ft_sgemm_rowcol_adaptive_bf16": ("ft_sgemm_rowcol", ADAPTIVE_BF16),
    "ft_sgemm_global_adaptive_bf16": ("ft_sgemm_global", ADAPTIVE_BF16),
    "ft_sgemm_fused_adaptive_bf16": ("ft_sgemm_aug",
                                     ADAPTIVE_BF16 + ("-DFTSG_KERNEL=6",)),
    "ft_sgemm_rowcol_mxu_adaptive_bf16": ("ft_sgemm_aug",
                                          ADAPTIVE_BF16 + ("-DFTSG_KERNEL=7",)),
    "sgemm_fp8": ("sgemm", FP8),
    "sgemm_tf32": ("sgemm", ONE_PASS),
    "ft_sgemm_weighted_tf32": ("ft_sgemm_weighted", ONE_PASS),
    "ft_sgemm_rowcol_tf32": ("ft_sgemm_rowcol", ONE_PASS),
    "ft_sgemm_global_tf32": ("ft_sgemm_global", ONE_PASS),
    "ft_sgemm_aug_tf32": ("ft_sgemm_aug", ONE_PASS),
    "ft_sgemm_weighted_adaptive_tf32": ("ft_sgemm_weighted",
                                        ADAPTIVE + ONE_PASS),
    "ft_sgemm_rowcol_adaptive_tf32": ("ft_sgemm_rowcol", ADAPTIVE + ONE_PASS),
    "ft_sgemm_global_adaptive_tf32": ("ft_sgemm_global", ADAPTIVE + ONE_PASS),
    "ft_sgemm_aug_adaptive_tf32": ("ft_sgemm_aug", ADAPTIVE + ONE_PASS),
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


# The background build: each library's state ("queued", "running",
# "done"), the queue of those waiting for a compiler slot, the slot count
# (None: no limit), the running compilers, and the seconds and failures of
# those that have exited.
_STATE: dict = {}
_QUEUE: list = []
_SLOTS = [None]
_PROCS: dict = {}
_SECONDS: dict = {}
_FAILURES: dict = {}
_COND = threading.Condition()


def _dispatch() -> None:
    """Start queued compilers while slots are free (``_COND`` held)."""
    running = sum(state == "running" for state in _STATE.values())
    while _QUEUE and (_SLOTS[0] is None or running < _SLOTS[0]):
        name = _QUEUE.pop(0)
        _STATE[name] = "running"
        running += 1
        threading.Thread(target=_compile, args=(name,), daemon=True).start()


def _compile(name: str) -> None:
    """One nvcc into a private file, renamed into place once it is whole;
    then the next queued library takes the slot."""
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    source, defines = LIBRARIES[name]
    proc = None
    try:
        with _COND:
            proc = _PROCS[name] = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, *defines, "-o", tmp,
                 str(CSRC / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)
        log, _ = proc.communicate()
    except OSError as e:
        log = str(e)
    _SECONDS[name] = time.perf_counter() - t0
    if proc is None or proc.returncode:
        _FAILURES[name] = f"nvcc {name} ({source}.cu) failed:\n{log}"
        os.unlink(tmp)
    else:
        so_path(name).with_suffix(".ptxas.txt").write_text(log)
        # Rename into place last: a concurrent loader never sees a
        # half-written library.
        os.replace(tmp, so_path(name))
    with _COND:
        _STATE[name] = "done"
        _dispatch()
        _COND.notify_all()


def start(names=KERNEL_LIBS, slots=None) -> None:
    """Queue one ``nvcc`` for each named library that is neither built nor
    queued, and return at once. At most ``slots`` compilers run at a time
    (None: every one at once); the others start in the order of ``names``
    as slots free up. ``build`` and ``library`` wait for a library, and
    move it to the front of the queue first."""
    nvcc()  # raises here, without a toolkit, not in a compiler's thread
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _COND:
        if slots is not None:
            _SLOTS[0] = slots
        for name in names:
            if name not in _STATE and not so_path(name).exists():
                _STATE[name] = "queued"
                _QUEUE.append(name)
        _dispatch()


def build(names=KERNEL_LIBS) -> dict:
    """Compile the named libraries that are not built yet, in parallel
    (waiting for those that ``start`` queued); returns {library: seconds
    from its compiler's start to its exit} for the ones compiled in this
    process. Raises with the compiler's output on failure."""
    start(names)
    with _COND:
        for name in reversed(names):
            if name in _QUEUE:
                _QUEUE.remove(name)
                _QUEUE.insert(0, name)
        _dispatch()
        _COND.wait_for(lambda: all(_STATE.get(n, "done") == "done"
                                   for n in names))
    failures = [_FAILURES[n] for n in names if n in _FAILURES]
    if failures:
        raise RuntimeError("\n".join(failures))
    return {n: _SECONDS[n] for n in names if n in _SECONDS}


@atexit.register
def _stop() -> None:
    """Kill the compilers still running when the process exits (each
    ``nvcc`` leads a session of its own, with its ``cicc`` and ``ptxas``),
    and start no queued one."""
    with _COND:
        _QUEUE.clear()
        for proc in _PROCS.values():
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` of :data:`LIBRARIES`, building it if
    needed."""
    build((name,))
    return ctypes.CDLL(str(so_path(name)))


# The fused epilogue's arguments of every entry point, just before its
# stream (``csrc/abft_common.cuh::Epilogue``, ``common.epilogue_args``): the
# bias row (or NULL), the activation and quantize codes, the quantize scale.
EPILOGUE_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]

# The variant axis argument of every entry point, after the epilogue's
# (``csrc/abft_common.cuh::Variant``, ``common.LaunchAxes.args``): the grid
# order (1: "nm").
VARIANT_ARGS = [ctypes.c_int]


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


def mainloop(kind: str, shape, in_dtype: str = "float32") -> str:
    """The mainloop that kernel ``kind`` (``"sgemm"`` for B1, else an
    ``ops/ft_sgemm._plan`` kind) runs on ``shape``: ``"wgmma-3xtf32"``, for
    every kernel at every compiled tile, ``"wgmma-bf16"`` for the bf16
    builds (one bf16 wgmma per 16-deep k step: B1-B8, and B2-B5 in fp8 on
    the widened operands), ``"wgmma-e4m3"`` for B1's fp8 build (one e4m3
    wgmma per 32-deep k step, promoted into f32 after each), or
    ``"wgmma-s8"`` for the int8 builds (one s8 wgmma per 32-deep k step,
    s32 accumulator, B3 and B4); raises for another tile. The CTA
    differs: B1 and B2 (``precomp``) run the tile's own CTA at the tiles of
    :func:`wgmma_tiles` and the 128 x 128 CTA at those of
    :func:`narrow_tiles` (B2 checking the tile as its sub-tile); B3
    ``rowcol``, B4 ``global``, B5 ``running``, B6 ``fused``, B7
    ``rowcol_mxu`` and B8 ``global_mxu`` run the 128 x 128 CTA over the
    tile as its sub-tile at every tile of :func:`subtiles`."""
    check_tile(shape)
    if in_dtype == "float8_e4m3fn":
        return "wgmma-e4m3" if kind == "sgemm" else "wgmma-bf16"
    return {"bfloat16": "wgmma-bf16", "int8": "wgmma-s8"}.get(in_dtype,
                                                           "wgmma-3xtf32")


def check_operands(shape, a, b, c, *more, rows=()) -> tuple:
    """Validate a kernel launch: contiguous, 16-byte aligned operands on one
    CUDA device, A (M, K) and B (N, K) both float32, both bfloat16, both
    float8_e4m3fn or both int8 (the kernel's input dtype; a 1-byte
    operand's rows K rounded up to 16 bytes apart,
    ``common.align_rows16``), C (M, N) and the wrapper-side inputs
    ``more`` float32, the mxu kernels' moment ``rows`` in A's dtype (their
    shapes and dtype are ``ft_sgemm._check_rows``' rule), padded to the
    tile (M % bm == N % bn == K % bk == 0, K >= bk), and a compiled tile.
    Returns (M, N, K, bm, bn, bk)."""
    dev = a.device
    if (a.dtype not in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
                        torch.int8) or b.dtype != a.dtype):
        raise ValueError("kernels take A and B both float32, both bfloat16,"
                         " both float8_e4m3fn or both int8, got"
                         f" {a.dtype} and {b.dtype}")
    for t in (a, b, c, *more, *rows):
        if not t.is_cuda or t.device != dev:
            raise ValueError("kernel operands must lie on one CUDA device,"
                             f" got {t.device} and {dev}")
        if t.dtype != (a.dtype if any(t is r for r in (a, b, *rows))
                       else torch.float32):
            raise ValueError(f"kernels take float32 C and checksum inputs"
                             f" and moment rows in the operands' dtype, got"
                             f" {t.dtype}")
        if t.element_size() == 1:
            if t.stride() != (t.shape[1] + (-t.shape[1]) % 16, 1):
                raise ValueError("kernels take 1-byte rows 16 bytes apart"
                                 " (common.align_rows16)")
        elif not t.is_contiguous():
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

"""Native host runtime: ctypes bindings for the port's ``csrc/hostutils.cpp``.

The reference binary draws its inputs from libc ``rand()`` after
``srand(10)`` (``sgemm.cu:12,57-60``; ``utils.cu:23-31``). The port builds
its own copy of the host utilities with ``g++`` into ``csrc/_build/`` at
first use and calls the same libc, so its inputs are the JAX package's
``runtime.generate_reference_driver_inputs`` bit for bit. Without a host
compiler it warns and falls back to the numpy generator (same value set,
different stream), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import warnings
from typing import Optional, Tuple

import numpy as np

from ft_sgemm_tpu_torch.ops._build import BUILD_DIR, CSRC


@functools.lru_cache(maxsize=1)
def load() -> Optional[ctypes.CDLL]:
    """Build (once per source version) and load the host library, or None
    when no host compiler is available."""
    src = CSRC / "hostutils.cpp"
    so = BUILD_DIR / "libftsg_torch_hostutils.so"
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name and rename: concurrent test workers
            # must never load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(src),
                                "-o", tmp], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"native hostutils unavailable ({e}); numpy fallback")
        return None
    lib.ftsg_generate_random_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int]
    lib.ftsg_generate_random_matrix.restype = None
    return lib


def generate_reference_driver_inputs(size: int, seed: int = 10
                                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A and B exactly as the reference binary builds them: one srand(seed),
    then two consecutive full-matrix draws (``sgemm.cu:57-58``). The draw
    (seconds at 4096) is made once per (size, seed); each call returns
    copies of it."""
    a, b = _reference_driver_inputs(size, seed)
    return a.copy(), b.copy()


@functools.lru_cache(maxsize=2)
def _reference_driver_inputs(size: int, seed: int):
    lib = load()
    if lib is None:
        from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix

        rng = np.random.default_rng(seed)
        return (generate_random_matrix(size, size, rng=rng),
                generate_random_matrix(size, size, rng=rng))
    a = np.empty((size, size), dtype=np.float32)
    b = np.empty((size, size), dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ftsg_generate_random_matrix(a.ctypes.data_as(f32p), size, size, seed, 1)
    # reseed=0: B continues A's stream.
    lib.ftsg_generate_random_matrix(b.ctypes.data_as(f32p), size, size, 0, 0)
    return a, b

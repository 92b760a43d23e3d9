"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the GPU and raise without one, and its kernel
wrappers never fall back from a non-CPU tensor to the plain versions."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import ft_sgemm_tpu_torch
from ft_sgemm_tpu_torch import analysis, cli, injection
from ft_sgemm_tpu_torch.configs import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import scalar_operand
from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ft_sgemm_tpu_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_import_leaves_jax_out():
    code = ("import sys, importlib\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'ft_sgemm_tpu' or m.startswith('ft_sgemm_tpu.')]\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(import|from) ft_sgemm_tpu(\.|\s|$)", text, re.M)
    assert not re.search(r"ft_sgemm_tpu\.(?!\w*_torch)", text.replace(
        "ft_sgemm_tpu_torch.", "")), "names a module of the JAX package"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: ft_sgemm_tpu_torch.make_sgemm("huge"),
    lambda: ft_sgemm_tpu_torch.make_ft_sgemm("huge"),
    lambda: ft_sgemm_tpu_torch.sgemm_reference([[1.0]], [[1.0]], [[0.0]]),
    lambda: ft_sgemm_tpu_torch.abft_baseline_sgemm([[1.0]], [[1.0]], [[0.0]]),
    lambda: cli.run_verification(64, 0, 16),
    lambda: cli.main(["ft_sgemm", "64", "64", "64", "0", "1"]),
    lambda: cli.main(["ft_sgemm", "roc", "--smoke"]),
    lambda: injection.roc_sweep(dtypes=("int8",)),
    lambda: analysis.measure_noise_floor([[1.0]], [[1.0]], [[0.0]]),
    lambda: analysis.detection_rate_sweep([[1.0]], [[1.0]], [[0.0]], [1.0]),
])
def test_entry_points_default_to_gpu_and_raise_without_one(no_gpu, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_wrappers_raise_on_non_cpu_tensors():
    # A tensor that is not on the CPU must reach a kernel or raise; the
    # plain versions are taken only for CPU tensors.
    shape = SHAPES["huge"]
    a, b, c = (torch.empty((128, 128), device="meta") for _ in range(3))
    sc = scalar_operand(InjectionSpec.none(), (9500.0,) * 3)
    with pytest.raises(ValueError, match="CUDA device"):
        sgemm_kernel(a, b, c, shape, 1.0, -1.5)
    with pytest.raises(ValueError, match="CUDA device"):
        ft.ft_rowcol_kernel(a, b, c, shape, 1.0, -1.5, sc, 1, False)
    with pytest.raises(ValueError, match="CUDA device"):
        ft.ft_weighted_running_kernel(a, b, c, shape, 1.0, -1.5, sc, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        ft.ft_global_kernel(a, b, c, shape, 1.0, -1.5, sc, 1)
    rows = {r: torch.empty((1, r, 128), device="meta") for r in (1, 2, 3)}
    with pytest.raises(ValueError, match="CUDA device"):
        ft.ft_global_mxu_kernel(a, b, c, rows[1], rows[1], shape, 1.0, -1.5,
                                sc, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        ft.ft_fused_kernel(a, b, c, rows[3], shape, 1.0, -1.5, sc, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        ft.ft_rowcol_mxu_kernel(a, b, c, rows[2], rows[1], shape, 1.0, -1.5,
                                sc, 1, True)


def test_chip_smoke_fails_without_gpu_or_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

"""The port's ``ft_sgemm`` program (ids 0-16) and two-pass baseline on the
CPU, against the JAX package's line format and baseline results."""

import io
import re

import numpy as np
import pytest

import ft_sgemm_tpu as jft
from ft_sgemm_tpu import cli as jcli
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import cli
from ft_sgemm_tpu_torch.configs import KERNEL_TABLE
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops.abft_baseline import abft_baseline_sgemm

LINE = re.compile(r"^Verification of kernel (?P<id>[ \d]\d) \((?P<name>.{20})\): "
                  r"(?P<status>.*)$")


@pytest.mark.parametrize("strategy", ["weighted", "rowcol"])
def test_run_verification_passes_all_ids(strategy):
    out = io.StringIO()
    details = {}
    assert cli.run_verification(256, 0, 16, out=out, strategy=strategy,
                                device="cpu", details=details)
    lines = out.getvalue().splitlines()
    assert len(lines) == len(KERNEL_TABLE)
    for line, kid in zip(lines, sorted(KERNEL_TABLE)):
        m = LINE.match(line)
        assert m, line
        assert int(m["id"]) == kid and m["status"] == "pass"
        assert m["name"].rstrip() == KERNEL_TABLE[kid][0]
    assert sorted(details) == [11, 12, 13, 14, 15, 16]
    for d in details.values():
        assert d["detected"] == d["expected"] > 0 and d["uncorrectable"] == 0


@pytest.mark.parametrize("strategy,encode", [
    ("global", "vpu"), ("fused", "vpu"), ("weighted", "mxu"),
    ("rowcol", "mxu"), ("global", "mxu")])
def test_run_verification_passes_every_pair(strategy, encode):
    out = io.StringIO()
    details = {}
    assert cli.run_verification(256, 0, 16, out=out, strategy=strategy,
                                encode=encode, device="cpu", details=details)
    lines = out.getvalue().splitlines()
    assert len(lines) == len(KERNEL_TABLE)
    assert sorted(details) == [11, 12, 13, 14, 15, 16]
    for d in details.values():
        assert d["detected"] == d["expected"] > 0
        # global is detect only: every event stays uncorrected.
        assert d["uncorrectable"] == (d["detected"] if strategy == "global"
                                      else 0)
    for line in lines[-6:]:
        status = LINE.match(line)["status"]
        assert status.startswith("pass"), line
        if strategy == "global":
            assert status.endswith("clean diff ok)"), line


def test_main_takes_encode(capsys):
    assert cli.main(["ft_sgemm", "64", "128", "64", "11", "16",
                     "--device=cpu", "--no-perf", "--strategy=global",
                     "--encode=mxu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + 6 and all("pass (detected" in ln
                                       for ln in lines[1:])


def test_verification_line_format_matches_jax():
    out, jout = io.StringIO(), io.StringIO()
    cli.run_verification(128, 1, 1, out=out, device="cpu")
    jcli.run_verification(128, 1, 1, out=jout)
    assert out.getvalue() == jout.getvalue()


def test_perf_table_and_main(capsys):
    assert cli.main(["ft_sgemm", "64", "128", "64", "0", "16",
                     "--device=cpu", "--mintime=0.0001",
                     "--strategy=rowcol"]) == 0
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("Device: cpu")
    assert "################## Performance (GFLOPS) ##" in text
    assert "Matrix Size         |      64|     128|" in text
    assert len([ln for ln in text.splitlines() if ln.startswith("abft_")]) == 7


@pytest.mark.parametrize("argv", [["1", "2"], ["a", "b", "c", "d", "e"],
                                  ["64", "64", "64", "0", "1", "--strategy=bogus"],
                                  ["64", "64", "64", "0", "1", "--encode=bogus"]])
def test_main_rejects_bad_arguments(argv, capsys):
    assert cli.main(["ft_sgemm", *argv, "--device=cpu"]) == 2


@pytest.mark.parametrize("kw", [dict(), dict(enabled=True, every=2)])
def test_abft_baseline_matches_jax(kw):
    rng = np.random.default_rng(12)
    a, b = (generate_random_matrix(192, 600, rng=rng) for _ in range(2))
    c = generate_random_matrix(192, 192, rng=rng)
    want = jft.abft_baseline_sgemm(a, b, c, 1.0, -1.5,
                                   inject=JInjectionSpec(**kw))
    got = abft_baseline_sgemm(a, b, c, 1.0, -1.5, inject=InjectionSpec(**kw),
                              device="cpu")
    np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c),
                               rtol=1e-5, atol=1e-4)
    for g, w in ((got.max_row_residual, want.max_row_residual),
                 (got.max_col_residual, want.max_col_residual)):
        # f32 residual noise, far below the 9500 threshold; a fault shows
        # as ~1e4 on both sides.
        assert abs(float(g) - float(w)) < 1e-2 + 1e-5 * abs(float(w))
    assert bool(got.detected) == bool(want.detected) == bool(kw)

"""``--threshold=static|auto|adaptive|FLOAT`` of the port's ``ft_sgemm``
program (``ft_sgemm_tpu_torch/cli.py``, after ``ft_sgemm_tpu/cli.py:2602-
2610``) on the CPU (``--device=cpu``, the kernels' plain versions) at
small sizes: the flag reaches every FT row of both passes, a spelling that
is neither a mode nor a float is refused, and the verification passes in
the configurations where the program's reference-like faults (magnitude
1e4) stay far above the rounding of their own correction: the detect-only
global strategy under both modes, and the weighted strategy under auto.
"""

import io

import pytest
import torch

from ft_sgemm_tpu_torch import cli

IDS = ["11", "16"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(size, *flags):
    return cli.main(["ft_sgemm", str(size), str(size), str(size), *IDS,
                     "--device=cpu", "--mintime=0.001", *flags])


def test_unknown_threshold_is_refused(capsys):
    assert _main(64, "--threshold=often") == 2
    assert "--threshold must be one of" in capsys.readouterr().err


@pytest.mark.parametrize("flag,want", [("auto", "auto"),
                                       ("adaptive", "adaptive"),
                                       ("static", "static"),
                                       ("250.5", 250.5)])
def test_threshold_reaches_every_ft_row(monkeypatch, flag, want):
    seen = []
    real = cli.make_ft_sgemm

    def spy(*args, **kw):
        seen.append(kw["threshold"])
        return real(*args, **kw)

    monkeypatch.setattr(cli, "make_ft_sgemm", spy)
    _main(64, f"--threshold={flag}")
    # Verification and the table, each building ids 11-16.
    assert len(seen) == 12 and set(seen) == {want}


@pytest.mark.parametrize("encode", ["vpu", "mxu"])
@pytest.mark.parametrize("mode", ["auto", "adaptive"])
def test_global_verification_passes_under_modes(encode, mode):
    out = io.StringIO()
    details = {}
    assert cli.run_verification(128, 11, 16, out=out, strategy="global",
                                encode=encode, device="cpu",
                                threshold=mode, details=details)
    for d in details.values():
        assert d["passed"] and d["detected"] == d["expected"] > 0
        assert d["uncorrectable"] == d["detected"]
    assert all(line.split(": ", 1)[1].startswith("pass (detected")
               for line in out.getvalue().splitlines())


def test_weighted_verification_passes_under_auto(capsys):
    assert _main(256, "--threshold=auto", "--no-perf") == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(": pass") for line in lines) == 6


@pytest.mark.parametrize("mode", ["auto", "adaptive"])
def test_perf_table_runs_under_modes(mode, capsys):
    assert _main(64, f"--threshold={mode}", "--no-verify",
                 "--strategy=rowcol") == 0
    out = capsys.readouterr().out
    for name in ("abft_kernel_small", "abft_kernel_huge"):
        assert any(line.startswith(name) for line in out.splitlines())

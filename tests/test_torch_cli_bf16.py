"""``--dtype=`` of the port's ``ft_sgemm`` program
(``ft_sgemm_tpu_torch/cli.py``, after ``ft_sgemm_tpu/cli.py:1141-1148``) on
the CPU (``--device=cpu``, the kernels' plain versions) at small sizes: the
JAX spellings and aliases, an unknown one refused with exit code 2, the
combinations once pinned as unported running (the mxu encodes and fused
under ``--threshold=adaptive`` with the JAX driver's verdicts), and the
bf16 verification passing every id under the weighted, rowcol and global
strategies, its lines in the JAX program's format, with the dtype named in
the verification and table headers.
"""

import io
import re

import pytest
import torch

from ft_sgemm_tpu import cli as jcli
from ft_sgemm_tpu_torch import cli
from ft_sgemm_tpu_torch.configs import KERNEL_TABLE

LINE = re.compile(r"^Verification of kernel (?P<id>[ \d]\d) \((?P<name>.{20})\): "
                  r"(?P<status>.*)$")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("strategy", ["weighted", "rowcol", "global"])
def test_bf16_verification_passes_every_id(strategy):
    out = io.StringIO()
    details = {}
    assert cli.run_verification(128, 0, 16, out=out, strategy=strategy,
                                in_dtype="bfloat16", device="cpu",
                                details=details)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("Verification in bfloat16")
    assert len(lines) == 1 + len(KERNEL_TABLE)
    for line, kid in zip(lines[1:], sorted(KERNEL_TABLE)):
        m = LINE.match(line)
        assert m and int(m["id"]) == kid and m["status"].startswith("pass")
    for d in details.values():
        assert d["detected"] == d["expected"] > 0
        assert d["uncorrectable"] == (d["detected"] if strategy == "global"
                                      else 0)


def test_bf16_verification_lines_match_jax():
    out, jout = io.StringIO(), io.StringIO()
    assert cli.run_verification(128, 1, 1, out=out, in_dtype="bfloat16",
                                device="cpu")
    jcli.run_verification(128, 1, 1, out=jout, in_dtype="bfloat16")
    assert out.getvalue().splitlines()[1:] == jout.getvalue().splitlines()


@pytest.mark.parametrize("spelling", ["bfloat16", "float32"])
def test_main_takes_dtype(spelling, capsys):
    assert cli.main(["ft_sgemm", "64", "64", "64", "0", "16", "--device=cpu",
                     "--mintime=0.0001", f"--dtype={spelling}",
                     "--threshold=auto"]) == 0
    text = capsys.readouterr().out
    bf16 = spelling == "bfloat16"
    assert ("Verification in bfloat16" in text) == bf16
    assert ("Performance (GFLOPS, bfloat16)" in text) == bf16
    assert len([ln for ln in text.splitlines()
                if LINE.match(ln) and "pass" in ln]) == len(KERNEL_TABLE)


@pytest.mark.parametrize("flag", ["--dtype=bf16", "--dtype=float16",
                                  "--dtype="])
def test_unknown_dtype_exits_2(flag, capsys):
    assert cli.main(["ft_sgemm", "64", "64", "64", "0", "1", "--device=cpu",
                     flag]) == 2
    assert "--dtype must be one of" in capsys.readouterr().err


def _verdicts(text):
    return {int(m["id"]): m["status"].split()[0]
            for m in map(LINE.match, text.splitlines()) if m}


@pytest.mark.parametrize("flags", [
    ["--dtype=fp8"], ["--dtype=float8_e4m3fn", "--strategy=rowcol"],
    ["--dtype=int8"], ["--dtype=bfloat16", "--encode=mxu"],
    ["--dtype=bfloat16", "--strategy=fused"],
    ["--dtype=bfloat16", "--threshold=adaptive"],
    ["--dtype=bfloat16", "--encode=mxu", "--threshold=adaptive"],
    ["--dtype=bfloat16", "--strategy=fused", "--threshold=adaptive"]])
def test_unported_dtype_modes_raise(flags, capsys):
    # Nothing runs before the refusal. int8 is ported since the int8 slice
    # (tests/test_torch_cli_int8.py): it defaults to the rowcol strategy
    # (configs.DEFAULT_STRATEGY), as the JAX program does, and its
    # verification passes. fp8 is ported since the fp8 slice
    # (tests/test_torch_cli_fp8.py): it runs (the weighted strategy by
    # default, or rowcol) and its verification passes.
    argv = ["ft_sgemm", "64", "64", "64", "0", "16", "--device=cpu",
            "--no-perf", *flags]
    if flags[0] in ("--dtype=int8", "--dtype=fp8", "--dtype=float8_e4m3fn"):
        assert cli.main(argv) == 0
        out, err = capsys.readouterr()
        if flags == ["--dtype=int8"]:
            assert "defaulting --strategy=rowcol" in err
            assert "Verification in int8" in out
        else:
            assert "Verification in float8_e4m3fn" in out
            assert "FAIL" not in out
        return
    if "--threshold=adaptive" in flags:
        # Ported since the adaptive bf16 builds (B3-B5 on the vpu encodes,
        # tests/test_torch_ft_adaptive_lowp.py; B6-B8 on the mxu encodes and
        # fused, tests/test_torch_ft_adaptive_bf16_mxu.py): it runs, the
        # header names the mode, and on the mxu encodes every id gives the
        # JAX driver's verdict (both pass ids 0-16 at this size).
        rc = cli.main(argv)
        out = capsys.readouterr().out
        assert rc in (0, 1)
        assert "Verification in bfloat16 (threshold adaptive)" in out
        if "--threshold=adaptive" == flags[-1] and len(flags) == 3:
            jout = io.StringIO()
            strategy = "fused" if "--strategy=fused" in flags else "weighted"
            jcli.run_verification(64, 0, 16, out=jout, in_dtype="bfloat16",
                                  strategy=strategy, encode="mxu",
                                  threshold="adaptive")
            assert _verdicts(out) == _verdicts(jout.getvalue())
            assert sorted(_verdicts(out)) == sorted(KERNEL_TABLE)
            assert rc == 0
        return
    if flags[0] == "--dtype=bfloat16":
        # The mxu encodes are ported since the bf16 builds of B6-B8
        # (tests/test_torch_ft_bf16_mxu.py): they run, the header names the
        # dtype, and every id passes.
        assert cli.main(argv) == 0
        out = capsys.readouterr().out
        assert "Verification in bfloat16:" in out and "FAIL" not in out
        return
    with pytest.raises(NotImplementedError):
        cli.main(argv)
    assert "Verification" not in capsys.readouterr().out

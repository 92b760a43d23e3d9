"""``--dtype=fp8`` of the port's ``ft_sgemm`` program (the fp8 serving mode,
after ``ft_sgemm_tpu/cli.py:167-169``) on the CPU (``--device=cpu``, the
kernels' plain versions): every id verified under the weighted, rowcol and
global strategies with the static and auto thresholds at 512, the
verdicts equal to the JAX program's on the same inputs, the dtype named in
the verification and table headers, every fp8 spelling taken, what is
illegal (the mxu encodes) refused before any work, and
``--threshold=adaptive`` run, its header naming the mode.
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


def _verdicts(text):
    """{id: "pass" or "FAIL"} of a verification's lines."""
    return {int(m["id"]): m["status"].split()[0]
            for m in map(LINE.match, text.splitlines()) if m}


@pytest.mark.parametrize("strategy", ["weighted", "rowcol", "global"])
@pytest.mark.parametrize("threshold", ["static", "auto"])
def test_fp8_verification_passes_every_id(strategy, threshold):
    out = io.StringIO()
    details = {}
    assert cli.run_verification(512, 0, 16, out=out, strategy=strategy,
                                threshold=threshold, in_dtype="fp8",
                                device="cpu", details=details)
    lines = out.getvalue().splitlines()
    assert lines[0] == ("Verification in float8_e4m3fn: A and B rounded to"
                        " float8_e4m3fn, against the f32 product of the"
                        " rounded inputs")
    assert len(lines) == 1 + len(KERNEL_TABLE)
    assert set(_verdicts(out.getvalue()).values()) == {"pass"}
    assert sorted(details) == list(range(11, 17))
    for d in details.values():
        assert d["detected"] == d["expected"] > 0 or strategy == "global"
        assert d["uncorrectable"] == (d["detected"] if strategy == "global"
                                      else 0)


@pytest.mark.parametrize("strategy,threshold,size", [
    ("weighted", "static", 128), ("rowcol", "static", 128),
    ("global", "auto", 128),
    # rowcol under auto fails at 256 and below on the paper's tiles in
    # every dtype (the JAX package's tiles are 128 wide); both pass at 512.
    ("rowcol", "auto", 512)])
def test_fp8_verdicts_match_jax(strategy, threshold, size):
    out, jout = io.StringIO(), io.StringIO()
    ok = cli.run_verification(size, 0, 16, out=out, strategy=strategy,
                              threshold=threshold, in_dtype="fp8",
                              device="cpu")
    jok = jcli.run_verification(size, 0, 16, out=jout, strategy=strategy,
                                threshold=threshold, in_dtype="fp8")
    assert ok == jok
    assert _verdicts(out.getvalue()) == _verdicts(jout.getvalue())
    assert len(_verdicts(out.getvalue())) == len(KERNEL_TABLE)


@pytest.mark.parametrize("spelling", ["fp8", "fp8_e4m3", "float8_e4m3",
                                      "float8_e4m3fn"])
def test_main_takes_every_fp8_spelling(spelling, capsys):
    assert cli.main(["ft_sgemm", "128", "128", "128", "0", "16",
                     "--device=cpu", "--mintime=0.0001",
                     f"--dtype={spelling}"]) == 0
    out, err = capsys.readouterr()
    assert "Verification in float8_e4m3fn" in out
    assert "FAIL" not in out
    assert "Performance (GFLOPS, float8_e4m3fn)" in out
    table = out[out.index("Performance (GFLOPS, float8_e4m3fn)"):]
    assert [ln.split("|")[0].strip() for ln in table.splitlines()[2:]] == [
        KERNEL_TABLE[k][0] for k in sorted(KERNEL_TABLE)]
    assert "defaulting" not in err   # weighted, the dtype's default


@pytest.mark.parametrize("flags,err", [
    (["--threshold=adaptive"], None),
    (["--strategy=rowcol", "--threshold=adaptive"], None),
    (["--encode=mxu"], ValueError), (["--strategy=fused"], ValueError)])
def test_fp8_refusals_come_before_any_work(flags, err, capsys):
    # The checksum rows are illegal in fp8 and refused before any work;
    # "adaptive" runs (since the adaptive bf16 builds), its header naming
    # the mode.
    argv = ["ft_sgemm", "64", "64", "64", "11", "16", "--device=cpu",
            "--dtype=fp8", *flags]
    if err is None:
        rc = cli.main(argv + ["--no-perf"])
        out = capsys.readouterr().out
        assert "Verification in float8_e4m3fn (threshold adaptive)" in out
        verdicts = _verdicts(out)
        assert sorted(verdicts) == list(range(11, 17))
        assert rc == (0 if set(verdicts.values()) == {"pass"} else 1)
        return
    with pytest.raises(err):
        cli.main(argv)
    assert "Verification" not in capsys.readouterr().out


def test_fp8_vendor_row_on_the_cpu_is_the_oracle():
    # Id 0 is torch._scaled_mm on the card; on the CPU, the oracle.
    import numpy as np
    from ft_sgemm_tpu_torch.ops.reference import sgemm_reference

    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(-1, 1, shape).astype(np.float32)
               for shape in ((40, 24), (32, 24), (40, 32)))
    got = cli._vendor("cpu", "fp8")(a, b, c)
    want = sgemm_reference(a, b, c, cli.ALPHA, cli.BETA, in_dtype="fp8",
                           device="cpu")
    assert torch.equal(got, want)

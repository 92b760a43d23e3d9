"""``--dtype=int8`` of the port's ``ft_sgemm`` program (the exact mode,
after ``ft_sgemm_tpu/cli.py:167-172, 386-391, 435-443``) on the CPU
(``--device=cpu``, the kernels' plain versions) at 256: A and B on the
integer lattice ±{0..9}, the rows that accumulate in f32 (ids 1-6 and the
baseline, 10) skipped with the JAX program's line, and ids 0 and 11-16
verified against the exact int32 oracle under rowcol and global in every
threshold mode, every fault detected and, under rowcol, corrected.
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
SKIPPED = (1, 2, 3, 4, 5, 6, 10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("strategy", ["rowcol", "global"])
@pytest.mark.parametrize("threshold", ["static", "auto", "adaptive"])
def test_int8_verification_at_256(strategy, threshold):
    out = io.StringIO()
    details = {}
    assert cli.run_verification(256, 0, 16, out=out, strategy=strategy,
                                threshold=threshold, in_dtype="int8",
                                device="cpu", details=details)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("Verification in int8")
    assert len(lines) == 1 + len(KERNEL_TABLE)
    for line, kid in zip(lines[1:], sorted(KERNEL_TABLE)):
        m = LINE.match(line)
        assert m and int(m["id"]) == kid
        if kid in SKIPPED:
            assert m["status"].startswith("skipped")
        else:
            assert m["status"].startswith("pass")
    assert sorted(details) == list(range(11, 17))
    for d in details.values():
        assert d["detected"] == d["expected"] > 0
        assert d["uncorrectable"] == (d["detected"] if strategy == "global"
                                      else 0)


def test_int8_skip_lines_match_jax():
    # ids 1-10: every line a skip line, word for word the JAX program's.
    out, jout = io.StringIO(), io.StringIO()
    assert cli.run_verification(64, 1, 10, out=out, in_dtype="int8",
                                strategy="rowcol", device="cpu")
    jcli.run_verification(64, 1, 10, out=jout, in_dtype="int8",
                          strategy="rowcol")
    lines = out.getvalue().splitlines()
    assert lines[1:] == jout.getvalue().splitlines()
    assert len(lines[1:]) == len(SKIPPED)


@pytest.mark.parametrize("flags", [[], ["--strategy=global",
                                        "--threshold=adaptive"]])
def test_main_int8_table_rows(flags, capsys):
    assert cli.main(["ft_sgemm", "128", "128", "128", "0", "16",
                     "--device=cpu", "--mintime=0.0001", "--dtype=int8",
                     *flags]) == 0
    out, err = capsys.readouterr()
    assert "Performance (GFLOPS, int8)" in out
    table = out[out.index("Performance (GFLOPS, int8)"):].splitlines()[2:]
    assert [ln.split("|")[0].strip() for ln in table] == [
        KERNEL_TABLE[k][0] for k in (0, 11, 12, 13, 14, 15, 16)]
    assert "int8 mode skips rows [1, 2, 3, 4, 5, 6, 10]" in err
    assert ("defaulting --strategy=rowcol" in err) == (not flags)

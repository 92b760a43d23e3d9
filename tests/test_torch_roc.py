"""The static-vs-adaptive threshold ROC sweep of the port
(``ft_sgemm_tpu_torch.injection.roc_sweep``, ``summarize_roc`` and the
``ft_sgemm roc`` subcommand) on the CPU (``device="cpu"``, the kernels'
plain versions) against the JAX package's (``ft_sgemm_tpu/injection.py:
148-356``, ``ft_sgemm_tpu/cli.py:1328-1389``) in interpret mode.

- The grid: the port's ``_roc_combos`` over the default dtypes,
  strategies and encodes lists the JAX package's 17 combos, in order.
- The points of the bf16 sweep (six combos, B6-B8's adaptive bf16 builds
  among them): every adaptive point equal field by field, and every static
  point's threshold, magnitude, checks and expected faults. The static
  detection counts are equal at input scales 0.1 and 1. At scale 16 the
  threshold calibrated at scale 1 lies 32 times under the noise bound
  there, inside the clean residuals' spread, and how many of those pass it
  depends on the order of the sums, which the Pallas kernel in interpret
  mode and the plain version do not share: there the correcting
  strategies flood in both (at least 20 clean detections on each side:
  rowcol 45-50, weighted and fused 30-33) and the detections that the
  summary counts (each run's capped at its expected faults) are equal;
  global's one whole-tile residual a check may or may not pass it (0-2 of
  its two checks on each side).
- The summary: ``summarize_roc`` gives the JAX package's verdict on the
  four cases of tests/test_low_precision.py::test_summarize_roc_verdict_logic.
- The program: ``ft_sgemm roc --smoke --device=cpu`` exits as the JAX
  package's ``run_roc`` does (0) and prints the same verdict per combo.
"""

import io
import re

import pytest
import torch

from ft_sgemm_tpu import cli as jcli
from ft_sgemm_tpu import injection as jinjection
from ft_sgemm_tpu_torch import cli, injection

FIELDS = ("dtype", "strategy", "encode", "mode", "scale", "threshold",
          "magnitude", "checks", "expected_faults")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_roc_combos_like_jax():
    args = (("float32", "bfloat16", "float8_e4m3fn", "int8"),
            ("rowcol", "global", "weighted", "fused"), ("vpu", "mxu"))
    combos = injection._roc_combos(*args)
    assert combos == jinjection._roc_combos(*args)
    assert len(combos) == 17
    assert ("bfloat16", "fused", "mxu") in combos
    assert injection._roc_combos(("fp8",), ("rowcol",), ("vpu", "mxu")) == [
        ("float8_e4m3fn", "rowcol", "vpu")]


def test_roc_bf16_points_like_jax():
    art = injection.roc_sweep(dtypes=("bfloat16",), device="cpu")
    jart = jinjection.roc_sweep(dtypes=("bfloat16",))
    assert art["config"] == jart["config"]
    points, jpoints = art["points"], jart["points"]
    assert len(points) == len(jpoints) == 6 * 2 * 3
    for p, jp in zip(points, jpoints):
        what = (p["strategy"], p["encode"], p["mode"], p["scale"])
        assert {f: p[f] for f in FIELDS} == {f: jp[f] for f in FIELDS}, what
        if p["mode"] == "adaptive":
            assert p == jp, what
            assert p["clean_detections"] == 0
            assert p["detected"] == p["expected_faults"]
        elif p["scale"] < 16:
            assert (p["clean_detections"], p["detected"]) == (
                jp["clean_detections"], jp["detected"]), what
        elif p["strategy"] != "global":
            assert min(p["clean_detections"], jp["clean_detections"]) >= 20
            assert (min(p["detected"], p["expected_faults"])
                    == min(jp["detected"], jp["expected_faults"])), what
        else:
            assert max(p["clean_detections"],
                       jp["clean_detections"]) <= p["checks"], what
            assert p["detected"] == jp["detected"], what
    summary, jsummary = art["summary"], jart["summary"]
    assert summary["adaptive_false_positives"] == 0
    assert summary["all_dominate"] and jsummary["all_dominate"]
    for key, v in summary["combos"].items():
        jv = jsummary["combos"][key]
        assert v["adaptive"] == jv["adaptive"]
        assert v["static"]["detection_rate"] == jv["static"]["detection_rate"]
        assert (v["dominates"], v["strict"]) == (jv["dominates"], jv["strict"])


def _point(mode, clean, det, expected=4):
    return dict(dtype="bfloat16", strategy="rowcol", encode="vpu", mode=mode,
                scale=1.0, threshold=None, magnitude=1.0,
                clean_detections=clean, checks=4, expected_faults=expected,
                detected=det)


@pytest.mark.parametrize("case", [
    # Tie: dominates weakly, not strictly.
    (("static", 0, 4), ("adaptive", 0, 4)),
    # Static floods: strict domination.
    (("static", 7, 4), ("adaptive", 0, 4)),
    # Adaptive misses where static detects: dominated.
    (("static", 0, 4), ("adaptive", 0, 2)),
    # Over-detection (noise) caps at the expected count.
    (("static", 0, 9), ("adaptive", 0, 4)),
])
def test_summarize_roc_like_jax(case):
    got = injection.summarize_roc(
        [injection.RocPoint(**_point(*c)) for c in case])
    want = jinjection.summarize_roc(
        [jinjection.RocPoint(**_point(*c)) for c in case])
    assert got == want
    p = injection.RocPoint(**_point(*case[1]))
    jp = jinjection.RocPoint(**_point(*case[1]))
    assert p.to_dict() == jp.to_dict()


VERDICT = re.compile(r"^  (\S+)\s+static fp=.*\[(\w+)\]$")


def test_roc_smoke_cli_like_jax(tmp_path, capsys):
    out = tmp_path / "roc.json"
    rc = cli.main(["ft_sgemm", "roc", "--smoke", "--device=cpu",
                   f"--out={out}"])
    text = capsys.readouterr().out
    jtext = io.StringIO()
    jrc = jcli.run_roc({"--smoke"}, out=jtext)
    verdicts = dict(m.groups() for m in map(VERDICT.match, text.splitlines())
                    if m)
    jverdicts = dict(m.groups() for m in map(VERDICT.match,
                                             jtext.getvalue().splitlines())
                     if m)
    assert rc == jrc == 0
    assert verdicts == jverdicts and len(verdicts) == 6
    assert "adaptive false positives: 0" in text
    assert out.exists() and "roc artifact written" in text
    assert cli.main(["ft_sgemm", "roc", "--often"]) == 2

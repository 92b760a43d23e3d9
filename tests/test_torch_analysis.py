"""The port's threshold-calibration tooling (``ft_sgemm_tpu_torch/
analysis.py``: ``measure_noise_floor``, ``calibrate_threshold`` with
``ThresholdCalibration``, ``detection_rate_sweep`` with
``DetectionPoint``) on the CPU (``device="cpu"``: the two-pass baseline's
torch ops and the FT kernels' plain versions) against the JAX package's
(``ft_sgemm_tpu/analysis.py:41-318``, interpret mode) on the same numpy
inputs.

- Noise floors: the largest clean checksum residual of the two-pass
  baseline is rounding, the same sums taken in two orders; the port's
  (torch's reductions) and the JAX package's (XLA's) differ by the order,
  so they are held to within 4 f32 ulps of the largest row or column
  checksum (both are a fraction of an ulp of it), in f32, bf16 and fp8.
- ``calibrate_threshold``: the threshold is the floor times the margin and
  the smallest detectable fault twice that, as in the JAX package, whose
  calibration is within the floor's tolerance times the margin; the
  reference-like schedule at that magnitude is the JAX package's.
- ``detection_rate_sweep`` at an explicit KernelShape (the JAX package's
  128 x 128 x 128 tile), in f32 and bf16, under rowcol and fused at the
  port's calibrated threshold, with magnitudes below it (designed misses)
  and 2, 4 and 64 times it: every point equal, field by field.
- ``precision``: passed through to the baseline and the kernels as in the
  JAX package (f32 "default" one TF32 pass); an unknown name raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ft_sgemm_tpu import analysis as janalysis
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES, analysis

ALPHA, BETA = 1.0, -1.5
JTILE = JKernelShape("t128", 128, 128, 128, (0,) * 7)
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (generate_random_matrix(m, k, rng=rng),
            generate_random_matrix(n, k, rng=rng),
            generate_random_matrix(m, n, rng=rng))


def _floor_tolerance(a, b, c):
    """4 f32 ulps of the largest row or column checksum of the output."""
    out = ALPHA * a.astype(np.float64) @ b.astype(np.float64).T + BETA * c
    return 4 * EPS * max(np.abs(out.sum(0)).max(), np.abs(out.sum(1)).max())


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_measure_noise_floor_like_jax(in_dtype, seed):
    a, b, c = _inputs(256, 192, 600, seed)
    got = analysis.measure_noise_floor(a, b, c, in_dtype=in_dtype,
                                       device="cpu")
    want = janalysis.measure_noise_floor(a, b, c, in_dtype=in_dtype)
    assert 0.0 < got and 0.0 < want
    assert abs(got - want) <= _floor_tolerance(a, b, c)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_calibrate_threshold_like_jax(in_dtype):
    a, b, c = _inputs(256, 256, 512, 3)
    cal = analysis.calibrate_threshold(a, b, c, margin=8.0, in_dtype=in_dtype,
                                       device="cpu")
    jcal = janalysis.calibrate_threshold(a, b, c, margin=8.0,
                                         in_dtype=in_dtype)
    assert cal.threshold == cal.noise_floor * 8.0 == cal.min_detectable / 2
    assert cal.margin == jcal.margin == 8.0
    assert abs(cal.threshold - jcal.threshold) <= 8.0 * _floor_tolerance(
        a, b, c)
    spec, jspec = cal.spec_like(512, 8), jcal.spec_like(
        512, 8, magnitude=cal.min_detectable)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    np.testing.assert_array_equal(spec.as_operand(), jspec.as_operand())


@pytest.mark.parametrize("strategy", ["rowcol", "fused"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_detection_rate_sweep_like_jax(in_dtype, strategy):
    a, b, c = _inputs(256, 256, 512, 4)
    thr = analysis.calibrate_threshold(a, b, c, in_dtype=in_dtype,
                                       device="cpu").threshold
    mags = [f * thr for f in (0.25, 0.5, 2.0, 4.0, 64.0)]
    kw = dict(strategy=strategy, threshold=thr, in_dtype=in_dtype)
    got = analysis.detection_rate_sweep(a, b, c, mags, SHAPES["test"],
                                        device="cpu", **kw)
    want = janalysis.detection_rate_sweep(a, b, c, mags, JTILE, **kw)
    assert [dataclasses.asdict(p) for p in got] == [
        dataclasses.asdict(p) for p in want]
    assert [p.detected for p in got[:2]] == [0, 0]
    assert all(p.detection_rate == 1.0 and p.output_correct
               for p in got[2:])
    assert got[0].expected_faults == 4 * 4


def test_precision_raises_where_the_entry_points_do():
    # Named for the slice in which f32 below "highest" raised: every
    # precision runs now, as in the JAX package; an unknown name raises.
    # f32 "default" measures the floor of one-TF32-pass products, far
    # above FP32's (TF32 keeps 11 bits); "high" is FP32's, as "highest".
    a, b, c = _inputs(64, 64, 64, 5)
    for fn in (analysis.measure_noise_floor, analysis.calibrate_threshold):
        with pytest.raises(ValueError, match="precision"):
            fn(a, b, c, precision="fastest", device="cpu")
        assert fn(a, b, c, precision="default", in_dtype="bfloat16",
                  device="cpu")
    floors = {p: analysis.measure_noise_floor(a, b, c, precision=p,
                                              device="cpu")
              for p in ("default", "high", "highest")}
    assert floors["high"] == floors["highest"]
    assert floors["default"] > 16 * floors["highest"]
    (p,) = analysis.detection_rate_sweep(a, b, c, [1e4], "test",
                                         precision="high", device="cpu")
    assert p.detection_rate == 1.0 and p.output_correct
    (p,) = analysis.detection_rate_sweep(a, b, c, [1e4], "test",
                                         precision="default",
                                         in_dtype="bfloat16", device="cpu")
    assert p.detection_rate == 1.0 and p.output_correct
    (p,) = analysis.detection_rate_sweep(a, b, c, [1e4], "test",
                                         precision="default", device="cpu")
    assert p.detection_rate == 1.0
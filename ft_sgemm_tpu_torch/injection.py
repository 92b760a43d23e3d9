"""First-class fault-injection specification (the port's copy of
``ft_sgemm_tpu/injection.py:23-108``) and the static-vs-adaptive
threshold ROC sweep (``ft_sgemm_tpu/injection.py:130-356``).

The reference bakes injection into its generated kernels as compile-time
constants: every ``K/20`` outer iterations one rotating thread adds
``error_inject = 10000.0`` to its accumulator, detected against
``err_bound1 = 9500.0`` (``include_code_gen/ft_sgemm_huge.cuh:49-51,
324-327``). Here injection is a runtime parameter: an :class:`InjectionSpec`
travels to the CUDA kernels in their scalar argument (slots 0-3 of
``contracts.SCALAR_SLOTS``), so one compiled kernel runs clean or injects
any schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

# Reference constants (include_code_gen/ft_sgemm_huge.cuh:49-51).
REFERENCE_MAGNITUDE = 10000.0
REFERENCE_THRESHOLD = 9500.0
REFERENCE_NUM_FAULTS = 20


@dataclasses.dataclass(frozen=True)
class InjectionSpec:
    """Runtime description of accumulator-fault injection.

    At K-step ``k`` (one ``KernelShape.bk`` deep step of the K loop), if
    ``enabled and k % every == 0``, ``magnitude`` is added to one element
    of every output tile's accumulator before the step's products. The
    element rotates with ``k // every`` and the tile coordinates; the
    default ``col_stride`` 61 is coprime to every tile width, so
    consecutive faults land in distinct columns. ``col_stride=0`` pins
    every fault to one column — the adversarial schedule that defeats
    per-column localization and must surface as ``uncorrectable``.
    """

    enabled: bool = False
    every: int = 1
    magnitude: float = REFERENCE_MAGNITUDE
    col_stride: int = 61

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"InjectionSpec.every={self.every} must be >= 1")
        if not np.isfinite(np.float32(self.magnitude)):
            raise ValueError(
                f"InjectionSpec.magnitude={self.magnitude} not finite in f32")
        if self.col_stride < 0:
            raise ValueError(
                f"InjectionSpec.col_stride={self.col_stride} must be >= 0")

    @staticmethod
    def none() -> "InjectionSpec":
        return InjectionSpec(enabled=False)

    @staticmethod
    def reference_like(K: int, bk: int, num_faults: int = REFERENCE_NUM_FAULTS,
                       magnitude: float = REFERENCE_MAGNITUDE) -> "InjectionSpec":
        """About ``num_faults`` faults across the K steps of a (K, bk) run,
        like the reference's ``(k % (K/20)) == 0`` cadence
        (``code_gen.py:333``); the period rounds to nearest."""
        every = max(1, round(_num_k_steps(K, bk) / num_faults))
        return InjectionSpec(enabled=True, every=every, magnitude=magnitude)

    def as_operand(self) -> np.ndarray:
        """The (4,) f32 slots 0-3 of the kernels' scalar argument:
        [enabled, every, magnitude, col_stride]."""
        return np.asarray(
            [1.0 if self.enabled else 0.0, float(self.every),
             float(self.magnitude), float(self.col_stride)],
            dtype=np.float32,
        )

    def expected_faults(self, K: int, bk: int) -> int:
        """Faults this spec injects per output tile over a full K sweep of
        the zero-padded K grid (K rounded up to a multiple of bk)."""
        if not self.enabled:
            return 0
        return len(range(0, _num_k_steps(K, bk), self.every))


def _num_k_steps(K: int, bk: int) -> int:
    """K-step count after the kernels' zero padding: ceil(K / bk)."""
    return max(1, -(-K // bk))


# ---------------------------------------------------------------------------
# The ROC sweep: statically calibrated threshold vs threshold="adaptive"
# ---------------------------------------------------------------------------
#
# Per legal (dtype, strategy, encode) combo and input scale, a clean run
# (its detections are false positives) and a run with a fault at every K
# step, under a static threshold calibrated at one scale and under
# threshold="adaptive". Per combo the summary says whether adaptive
# Pareto-dominates static (fp <= static AND detection >= static;
# ``strict`` when one is a strict improvement). int8's exact arithmetic
# makes both modes perfect: an honest tie.

# Fault magnitude per run: FAULT_FACTOR x the run's noise bound (8x the
# adaptive threshold at margin 8), so adaptive detection has the same
# headroom at every scale; the static threshold, calibrated at
# ROC_CAL_SCALE, overshoots the faults at colder scales and drowns under
# the clean noise at hotter ones.
ROC_FAULT_FACTOR = 64.0
ROC_CAL_SCALE = 1.0


@dataclasses.dataclass(frozen=True)
class RocPoint:
    """One (combo, mode, scale) cell of the ROC sweep."""

    dtype: str
    strategy: str
    encode: str
    mode: str                 # "static" | "adaptive"
    scale: float
    threshold: Optional[float]  # the static threshold (None for adaptive)
    magnitude: float          # injected |fault|
    clean_detections: int     # detections on the CLEAN run (false positives)
    checks: int               # detection opportunities (tiles x K steps)
    expected_faults: int      # faults injected over the run
    detected: int             # detections on the injected run

    @property
    def fp_rate(self) -> float:
        return self.clean_detections / self.checks if self.checks else 0.0

    @property
    def detection_rate(self) -> float:
        if not self.expected_faults:
            return 0.0
        return min(1.0, self.detected / self.expected_faults)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fp_rate"] = self.fp_rate
        d["detection_rate"] = self.detection_rate
        return d


def _roc_combos(dtypes, strategies, encodes) -> list:
    """The legal (dtype, strategy, encode) grid in canonical spellings, each
    program once (``weighted`` with ``mxu`` IS ``fused``)."""
    from ft_sgemm_tpu_torch.configs import canonical_in_dtype, check_kernel_legality

    combos = []
    for dtype in dtypes:
        name = canonical_in_dtype(dtype)
        for strategy in strategies:
            for encode in encodes:
                if strategy == "fused" and encode != "mxu":
                    continue
                if strategy == "weighted" and encode == "mxu":
                    continue  # the fused spelling of the same program
                try:
                    check_kernel_legality(strategy=strategy, encode=encode,
                                          in_dtype=name,
                                          threshold_mode="adaptive")
                except ValueError:
                    continue
                combos.append((name, strategy, encode))
    return combos


def _roc_inputs(m, n, k, scale, dtype_name, seed):
    """Host A (m, k) and B (n, k) at one input scale: continuous
    standard-normal data times ``scale`` for the float dtypes (products that
    really round), integers of magnitude ~9 * scale (at least 1) for
    int8."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    if dtype_name == "int8":
        scale_i = max(1.0, round(9.0 * scale))
        a = np.clip(np.round(a * scale_i / 2.0), -127, 127).astype(np.float32)
        b = np.clip(np.round(b * scale_i / 2.0), -127, 127).astype(np.float32)
    else:
        a = a * np.float32(scale)
        b = b * np.float32(scale)
    return a, b


def roc_sweep(
    *,
    m: int = 128,
    n: int = 128,
    k: int = 256,
    dtypes=("float32", "bfloat16", "float8_e4m3fn", "int8"),
    strategies=("rowcol", "global", "weighted", "fused"),
    encodes=("vpu", "mxu"),
    scales=(0.1, 1.0, 16.0),
    margin: Optional[float] = None,
    seed: int = 10,
    device=None,
    progress: Optional[Callable[[RocPoint], None]] = None,
) -> dict:
    """The static-vs-adaptive ROC sweep; returns the artifact dict.

    Per legal (dtype, strategy, encode) combo and per input ``scale``: one
    clean run and one run with a fault at every K step (magnitude
    ``ROC_FAULT_FACTOR`` times that scale's noise bound, times sqrt(bn) for
    global), under the threshold calibrated at ``ROC_CAL_SCALE`` (the auto
    formula: margin times the noise bound, times sqrt(bn) for global; the
    half-ulp 0.5 for int8) and under ``threshold="adaptive"``, on the
    128 x 128 x 128 tile. ``device`` runs the kernels (default: CUDA;
    ``"cpu"`` their plain versions). ``progress(point)`` streams each
    point. The summary's ``dominates`` per combo is the acceptance
    contract."""
    from ft_sgemm_tpu_torch.analysis import estimate_noise_floor
    from ft_sgemm_tpu_torch.configs import KernelShape
    from ft_sgemm_tpu_torch.ops.common import DEFAULT_THRESHOLD_MARGIN
    from ft_sgemm_tpu_torch.ops.ft_sgemm import make_ft_sgemm

    margin = DEFAULT_THRESHOLD_MARGIN if margin is None else margin
    tile = KernelShape("roc", 128, 128, 128, (0,) * 7)
    bm, bn, bk = tile.block
    tiles = (-(-m // bm)) * (-(-n // bn))
    nk = _num_k_steps(k, bk)
    points = []

    def noise_bound(dtype_name, scale):
        if dtype_name == "int8":
            return 0.0  # exact int32 accumulation: clean residuals are 0
        a, b = _roc_inputs(m, n, k, scale, dtype_name, seed)
        # beta = 0 below: the sweep isolates the product's noise.
        return estimate_noise_floor(a, b, None, alpha=1.0, beta=0.0)

    for dtype_name, strategy, encode in _roc_combos(dtypes, strategies,
                                                    encodes):
        cal = noise_bound(dtype_name, ROC_CAL_SCALE)
        static_thr = margin * cal if cal > 0 else 0.5
        if strategy == "global" and cal > 0:
            static_thr *= float(np.sqrt(bn))
        for mode in ("static", "adaptive"):
            ft = make_ft_sgemm(
                tile, alpha=1.0, beta=0.0, strategy=strategy, encode=encode,
                in_dtype=dtype_name,
                threshold=("adaptive" if mode == "adaptive"
                           else float(static_thr)),
                threshold_margin=margin, device=device)
            for scale in scales:
                a, b = _roc_inputs(m, n, k, scale, dtype_name, seed)
                c = np.zeros((m, n), np.float32)
                if dtype_name == "int8":
                    mag = max(1.0, round(3.0 * scale))
                else:
                    mag = ROC_FAULT_FACTOR * noise_bound(dtype_name, scale)
                    if strategy == "global":
                        # The whole-tile residual carries the sqrt(bn)
                        # aggregation of both modes' thresholds.
                        mag *= float(np.sqrt(bn))
                clean = ft(a, b, c)
                inj = InjectionSpec(enabled=True, every=1,
                                    magnitude=float(mag))
                faulty = ft(a, b, c, inj)
                point = RocPoint(
                    dtype=dtype_name, strategy=strategy, encode=encode,
                    mode=mode, scale=float(scale),
                    threshold=(None if mode == "adaptive"
                               else float(static_thr)),
                    magnitude=float(mag),
                    clean_detections=int(clean.num_detected),
                    checks=tiles * nk,
                    expected_faults=tiles * inj.expected_faults(k, bk),
                    detected=int(faulty.num_detected))
                points.append(point)
                if progress is not None:
                    progress(point)

    return {
        "config": {"m": m, "n": n, "k": k, "tile": list(tile.block),
                   "scales": list(map(float, scales)),
                   "margin": float(margin), "seed": seed,
                   "fault_factor": ROC_FAULT_FACTOR,
                   "cal_scale": ROC_CAL_SCALE},
        "points": [p.to_dict() for p in points],
        "summary": summarize_roc(points),
    }


def summarize_roc(points) -> dict:
    """Per (dtype, strategy, encode) verdicts and the headline.

    Each mode's aggregate false-positive rate (summed clean detections over
    summed checks) and detection rate (summed detections, capped per point
    at its expected count, over summed expected faults). ``dominates``:
    adaptive fp <= static fp AND adaptive detection >= static detection;
    ``strict``: one of them strictly. ``adaptive_false_positives`` totals
    adaptive clean detections over the whole sweep."""
    combos: dict = {}
    for p in points:
        key = f"{p.dtype}|{p.strategy}|{p.encode}"
        combos.setdefault(key, {"static": [], "adaptive": []})[
            p.mode].append(p)

    def agg(ps):
        checks = sum(p.checks for p in ps)
        expected = sum(p.expected_faults for p in ps)
        detected = sum(min(p.detected, p.expected_faults) for p in ps)
        fps = sum(p.clean_detections for p in ps)
        return {"false_positives": fps,
                "fp_rate": fps / checks if checks else 0.0,
                "detection_rate": detected / expected if expected else 0.0}

    summary: dict = {"combos": {}}
    adaptive_fps = 0
    all_dominate = True
    for key, modes in sorted(combos.items()):
        s, a = agg(modes["static"]), agg(modes["adaptive"])
        adaptive_fps += a["false_positives"]
        dominates = (a["fp_rate"] <= s["fp_rate"]
                     and a["detection_rate"] >= s["detection_rate"])
        strict = dominates and (a["fp_rate"] < s["fp_rate"]
                                or a["detection_rate"] > s["detection_rate"])
        all_dominate &= dominates
        summary["combos"][key] = {"static": s, "adaptive": a,
                                  "dominates": dominates, "strict": strict}
    summary["all_dominate"] = all_dominate
    summary["adaptive_false_positives"] = adaptive_fps
    return summary

"""First-class fault-injection specification (the port's copy of
``ft_sgemm_tpu/injection.py:23-108``).

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

"""The scalar-argument slot map of the FT kernels (the port's copy of
``ft_sgemm_tpu/contracts.py:59-72``).

Every FT kernel receives ONE flat f32 scalar argument carrying the
injection spec and the runtime thresholds. The slot assignments are an ABI
shared with the JAX package's kernels: the CUDA kernels read
``csrc/abft_common.cuh::Scalars`` with these indices (``SLOT_*`` there).
"""

SCALAR_SLOTS = {
    0: ("inject_enabled", ("enabled",)),
    1: ("inject_every", ("every",)),
    2: ("inject_magnitude", ("magnitude",)),
    3: ("inject_col_stride", ("col_stride",)),
    4: ("detect_threshold", ("threshold",)),
    5: ("moment1_recheck_threshold", ("thr_m1",)),
    6: ("moment2_recheck_threshold", ("thr_m2",)),
    7: ("adaptive_margin", ("margin",)),
}

# Total scalar-argument length when every slot rides along.
N_SCALAR_SLOTS = 8

"""Time the sub-tiled kernels B3, B4, B6, B7 and B8 of several port trees
at 4096, without checking them.

Each TREE is a directory that holds a copy of the ``ft_sgemm_tpu_torch``
package, as for ``scripts/torch_kernel_ab.py``; unlike that script, this
one does not hold the kernels' output or fault counts to anything, so it
also times copies that break the check on purpose (a check that returns
early, a product without its extra columns) to see what a part costs.
Only ``ft_sgemm_rowcol.cu``, ``ft_sgemm_global.cu`` and
``ft_sgemm_aug.cu`` are built, all trees in parallel. Each kernel runs at
the cadence and multifault setting the program gives it, with
reference-like injection, at the small, medium, large, tall, wide and
huge tiles, on the moment rows the wrapper builds for it (B6-B8,
``ops/ft_sgemm.kernel_inputs``, made once per tile outside the timed
launches); each tree is measured in a
fresh process per turn, the trees in order and then reversed
(``torch_kernel_ab.turns``). Needs nvcc and a CUDA device:

    python3 scripts/torch_variant_time.py TREE [TREE ...]

Prints the card's name and power limit, then one line per tree and turn:
milliseconds per launch, and the detections and uncorrectable counts
each launch reported.
"""

from __future__ import annotations

import ctypes
import json
import sys

from torch_kernel_ab import _import_port, card, turns

SIZE = 4096
TILES = ("small", "medium", "large", "tall", "wide", "huge")
SOURCES = ("ft_sgemm_rowcol", "ft_sgemm_global", "ft_sgemm_aug")
# kernel -> (source, entry point, pointer arguments before out, ints
# after the 9 dimensions, the (strategy, encode) whose plan it runs)
KERNELS = {
    "B3": ("ft_sgemm_rowcol", "ftsg_ft_rowcol", 3, 2, ("rowcol", "vpu")),
    "B4": ("ft_sgemm_global", "ftsg_ft_global", 3, 1, ("global", "vpu")),
    "B6": ("ft_sgemm_aug", "ftsg_ft_fused", 4, 1, ("fused", "mxu")),
    "B7": ("ft_sgemm_aug", "ftsg_ft_rowcol_mxu", 5, 2, ("rowcol", "mxu")),
    "B8": ("ft_sgemm_global", "ftsg_ft_global_mxu", 5, 1, ("global", "mxu")),
}


def build(tree: str) -> None:
    _import_port(tree)
    from ft_sgemm_tpu_torch.ops import _build

    _build.build(SOURCES)


def measure(tree: str) -> dict:
    """Milliseconds per launch of each kernel on each tile, and its counts."""
    _import_port(tree)
    import numpy as np
    import torch

    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
    from ft_sgemm_tpu_torch.ops.common import scalar_operand
    from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {
        kern: _build.bind(_build.library(src), entry,
                          [p] * (n_in + 3) + [i] * (9 + n_int) + [f, f, p, p])
        for kern, (src, entry, n_in, n_int, _) in KERNELS.items()}
    gen = np.random.default_rng(1)
    a, b, c = (torch.from_numpy(generate_random_matrix(SIZE, SIZE, rng=gen)).cuda()
               for _ in range(3))
    out = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream
    row = {}
    for name in TILES:
        sh = SHAPES[name]
        inj = InjectionSpec.reference_like(SIZE, sh.bk)
        sc = scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3)
        det = torch.empty((SIZE // sh.bm, SIZE // sh.bn), dtype=torch.int32,
                          device="cuda")
        unc = torch.empty_like(det)
        dims = (SIZE, SIZE, SIZE, sh.bm, sh.bn, *sh.thread_layout, sh.bk)
        for kern, fn in entries.items():
            strategy, encode = KERNELS[kern][4]
            kind, ce, mf = ft._plan(strategy, None, None, inj, SIZE // sh.bk,
                                    sh.bn, encode)
            rows = ft.kernel_inputs(kind, a, b, sh)
            ints = (ce, int(mf))[:KERNELS[kern][3]]

            def launch(fn=fn, kern=kern, rows=rows, ints=ints):
                _build.check_launch(
                    fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       *(r.data_ptr() for r in rows), out.data_ptr(),
                       det.data_ptr(), unc.data_ptr(), *dims, *ints,
                       1.0, -1.5, sc.ctypes.data, stream), kern)

            row[f"{kern} {name}"] = cuda_ms(launch, reps=5)
            launch()
            torch.cuda.synchronize()
            row[f"{kern} {name} det/unc"] = f"{int(det.sum())}/{int(unc.sum())}"
    return row


def main(argv) -> int:
    if len(argv) == 3 and argv[1] in ("--build", "--measure"):
        if argv[1] == "--build":
            build(argv[2])
        else:
            print(json.dumps(measure(argv[2])))
        return 0
    trees = argv[1:]
    if not trees or any(t.startswith("--") for t in trees):
        print(__doc__)
        return 2
    print(card(), flush=True)
    for name, row in turns(__file__, trees):
        print(f"{name:19s} " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

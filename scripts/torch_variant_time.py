"""Time B3 and B4 of several port trees at 4096, without checking them.

Each TREE is a directory that holds a copy of the ``ft_sgemm_tpu_torch``
package, as for ``scripts/torch_kernel_ab.py``; unlike that script, this
one does not hold the kernels' output or fault counts to anything, so it
also times copies that break the check on purpose (a check that returns
early, a product without its extra columns) to see what a part costs.
Only ``ft_sgemm_rowcol.cu`` and ``ft_sgemm_global.cu`` are built, all
trees in parallel. B3 and B4 run at the cadence and multifault setting
the program gives them, with reference-like injection, at the small,
medium, large, tall, wide and huge tiles; each tree is measured in a
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
SOURCES = ("ft_sgemm_rowcol", "ft_sgemm_global")


def build(tree: str) -> None:
    _import_port(tree)
    from ft_sgemm_tpu_torch.ops import _build

    _build.build(SOURCES)


def measure(tree: str) -> dict:
    """Milliseconds per launch of B3 and B4 on each tile, and their counts."""
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
        "B3": _build.bind(_build.library("ft_sgemm_rowcol"), "ftsg_ft_rowcol",
                          [p] * 6 + [i] * 11 + [f, f, p, p]),
        "B4": _build.bind(_build.library("ft_sgemm_global"), "ftsg_ft_global",
                          [p] * 6 + [i] * 10 + [f, f, p, p]),
    }
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
        _, ce, mf = ft._plan("rowcol", None, None, inj, SIZE // sh.bk, sh.bn)
        extra = {"B3": (ce, int(mf)), "B4": (ce,)}
        for kern, fn in entries.items():
            def launch(fn=fn, kern=kern):
                _build.check_launch(
                    fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                       det.data_ptr(), unc.data_ptr(), *dims, *extra[kern],
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

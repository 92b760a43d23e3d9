"""Time the port's kernels of several source trees at 4096, without
checking them.

Each TREE is a directory that holds a copy of the ``ft_sgemm_tpu_torch``
package, as for ``scripts/torch_kernel_ab.py``; unlike that script, this
one does not hold the kernels' output or fault counts to anything, so it
also times copies that break the check on purpose (a check that returns
early, a product without its extra columns) to see what a part costs, and
copies that route a tile to another CTA. Only the sources of the named
kernels are built, all trees in parallel. Each FT kernel runs at the
cadence and multifault setting the program gives its strategy (B2 with
its one final check, also where the program runs B5), with reference-like
injection, on the wrapper-side inputs the program builds for it (B2's
expected moments, the moment rows of B6-B8: ``ops/ft_sgemm.kernel_inputs``,
made once per tile outside the timed launches); each tree is measured in a
fresh process per turn, the trees in order and then reversed
(``torch_kernel_ab.turns``). Needs nvcc and a CUDA device:

    python3 scripts/torch_variant_time.py [--kernels=B1,B2] [--tiles=large,tall] TREE [TREE ...]

``--kernels`` (default B3, B4, B6, B7, B8) and ``--tiles`` (default the six
program tiles) pick what is built and timed. Prints the card's name and
power limit, then one line per tree and turn: milliseconds per launch, and
the detections and uncorrectable counts each FT launch reported.
"""

from __future__ import annotations

import ctypes
import json
import sys

from torch_kernel_ab import _import_port, card, turns

SIZE = 4096
TILES = ("small", "medium", "large", "tall", "wide", "huge")
# kernel -> (source, entry point, pointer arguments before out, ints
# after the 9 dimensions, the kernel kind, the (strategy, encode) whose
# plan gives its cadence); B1 takes no grids and no scalars.
KERNELS = {
    "B1": ("sgemm", "ftsg_sgemm", 3, 0, "sgemm", None),
    "B2": ("ft_sgemm_weighted", "ftsg_ft_weighted_precomp", 4, 0, "precomp",
           ("weighted", "vpu")),
    "B3": ("ft_sgemm_rowcol", "ftsg_ft_rowcol", 3, 2, "rowcol",
           ("rowcol", "vpu")),
    "B4": ("ft_sgemm_global", "ftsg_ft_global", 3, 1, "global",
           ("global", "vpu")),
    "B6": ("ft_sgemm_aug", "ftsg_ft_fused", 4, 1, "fused", ("fused", "mxu")),
    "B7": ("ft_sgemm_aug", "ftsg_ft_rowcol_mxu", 5, 2, "rowcol_mxu",
           ("rowcol", "mxu")),
    "B8": ("ft_sgemm_global", "ftsg_ft_global_mxu", 5, 1, "global_mxu",
           ("global", "mxu")),
}
DEFAULT_KERNELS = ("B3", "B4", "B6", "B7", "B8")


def build(tree: str, kernels) -> None:
    _import_port(tree)
    from ft_sgemm_tpu_torch.ops import _build

    _build.build(tuple(dict.fromkeys(KERNELS[k][0] for k in kernels)))


def measure(tree: str, kernels, tiles) -> dict:
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
    entries = {}
    for kern in kernels:
        src, entry, n_in, n_int, kind, _ = KERNELS[kern]
        tail = [f, f, p] if kind == "sgemm" else [f, f, p, p]
        grids = 0 if kind == "sgemm" else 2
        entries[kern] = _build.bind(
            _build.library(src), entry,
            [p] * (n_in + 1 + grids) + [i] * (9 + n_int) + tail)
    gen = np.random.default_rng(1)
    a, b, c = (torch.from_numpy(generate_random_matrix(SIZE, SIZE, rng=gen)).cuda()
               for _ in range(3))
    out = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream
    row = {}
    for name in tiles:
        sh = SHAPES[name]
        inj = InjectionSpec.reference_like(SIZE, sh.bk)
        sc = scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3)
        det = torch.empty((SIZE // sh.bm, SIZE // sh.bn), dtype=torch.int32,
                          device="cuda")
        unc = torch.empty_like(det)
        dims = (SIZE, SIZE, SIZE, sh.bm, sh.bn, *sh.thread_layout, sh.bk)
        for kern, fn in entries.items():
            _, _, _, n_int, kind, pair = KERNELS[kern]
            if kind == "sgemm":
                def launch(fn=fn, kern=kern):
                    _build.check_launch(
                        fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                           out.data_ptr(), *dims, 1.0, -1.5, stream), kern)

                row[f"{kern} {name}"] = cuda_ms(launch, reps=5)
                continue
            _, ce, mf = ft._plan(pair[0], None, None, inj, SIZE // sh.bk,
                                 sh.bn, pair[1])
            rows = ft.kernel_inputs(kind, a, b, sh)
            ints = (ce, int(mf))[:n_int]

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
    opts = {a.split("=", 1)[0]: a.split("=", 1)[1] for a in argv[1:]
            if a.startswith("--") and "=" in a}
    kernels = tuple(opts.get("--kernels", ",".join(DEFAULT_KERNELS)).split(","))
    tiles = tuple(opts.get("--tiles", ",".join(TILES)).split(","))
    args = [a for a in argv[1:] if not (a.startswith("--") and "=" in a)]
    if len(args) == 2 and args[0] in ("--build", "--measure"):
        if args[0] == "--build":
            build(args[1], kernels)
        else:
            print(json.dumps(measure(args[1], kernels, tiles)))
        return 0
    trees = args
    if (not trees or any(t.startswith("--") for t in trees)
            or not set(kernels) <= set(KERNELS)):
        print(__doc__)
        return 2
    print(card(), flush=True)
    picks = (f"--kernels={','.join(kernels)}", f"--tiles={','.join(tiles)}")
    for name, row in turns(__file__, trees, *picks, build_args=picks[:1]):
        print(f"{name:19s} " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

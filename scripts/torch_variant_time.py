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

    python3 scripts/torch_variant_time.py [--kernels=B1,B2] [--tiles=large,tall] [--threshold=adaptive] TREE [TREE ...]

``--kernels`` (default B3, B4, B6, B7, B8; B5 on request) and ``--tiles``
(default the six program tiles) pick what is built and timed;
``--threshold=adaptive`` builds and times the adaptive builds of B3-B8 at
the adaptive cadence (the default margin in slot 7); ``--magnitude=M``
sets the reference-like faults' magnitude (default 1e4; 0: no faults).
Prints the card's name and power limit, then one line per tree and turn:
milliseconds per launch, and the detections and uncorrectable counts each
FT launch reported.

    python3 scripts/torch_variant_time.py --variant=NAME DIR

writes this checkout's package with one named change (``VARIANTS``) into
DIR, a tree for the runs above. ``device-scalars`` hands B3-B8 their
scalar argument through device memory instead of by value: no arithmetic
changes, only where each consumer thread reads it from. On an H100 it made
B6 at the small tile report fewer detections than the by-value build on
the same launch (an open fault, ROADMAP Queue C):

    python3 scripts/torch_variant_time.py --variant=device-scalars VAR
    python3 scripts/torch_variant_time.py --kernels=B6,B5 --tiles=small,huge . VAR
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import sys

from torch_kernel_ab import _import_port, card, turns

SIZE = 4096
TILES = ("small", "medium", "large", "tall", "wide", "huge")
# kernel -> (library, entry point, pointer arguments before out, ints
# after the 6 dimensions, the kernel kind, the (strategy, encode) whose
# plan gives its cadence); B1 takes no grids and no scalars, B2 no noise
# model.
KERNELS = {
    "B1": ("sgemm", "ftsg_sgemm", 3, 0, "sgemm", None),
    "B2": ("ft_sgemm_weighted", "ftsg_ft_weighted_precomp", 4, 0, "precomp",
           ("weighted", "vpu")),
    "B3": ("ft_sgemm_rowcol", "ftsg_ft_rowcol", 3, 2, "rowcol",
           ("rowcol", "vpu")),
    "B5": ("ft_sgemm_weighted", "ftsg_ft_weighted_running", 3, 1, "running",
           ("weighted", "vpu")),
    "B4": ("ft_sgemm_global", "ftsg_ft_global", 3, 1, "global",
           ("global", "vpu")),
    "B6": ("ft_sgemm_aug", "ftsg_ft_fused", 4, 1, "fused", ("fused", "mxu")),
    "B7": ("ft_sgemm_aug", "ftsg_ft_rowcol_mxu", 5, 2, "rowcol_mxu",
           ("rowcol", "mxu")),
    "B8": ("ft_sgemm_global", "ftsg_ft_global_mxu", 5, 1, "global_mxu",
           ("global", "mxu")),
}
DEFAULT_KERNELS = ("B3", "B4", "B6", "B7", "B8")

# Named one-change copies of the package: file -> [(text, replacement)],
# each text found exactly once.
VARIANTS = {
    "device-scalars": {"csrc/ft_sgemm_running.cuh": [
        ("    Scalars sc, NoiseModel nm) {\n  const WgSmem<T> sm;\n",
         "    const Scalars* __restrict__ scp, NoiseModel nm) {\n"
         "  const Scalars sc = *scp;\n  const WgSmem<T> sm;\n"),
        ("template <template <int, int> class Of>\nint launch_running(",
         "__device__ Scalars g_scalars;\n\n"
         "template <template <int, int> class Of>\nint launch_running("),
        ("  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];\n",
         "  for (int i = 0; i < 8; ++i) sc.s[i] = scalars[i];\n"
         "  Scalars* scp = nullptr;\n"
         "  if (const cudaError_t e = cudaGetSymbolAddress((void**)&scp,"
         " g_scalars))\n    return (int)e;\n"
         "  if (const cudaError_t e = cudaMemcpyAsync(scp, &sc, sizeof sc,\n"
         "          cudaMemcpyHostToDevice, stream))\n    return (int)e;\n"),
        ("bk, check_every, alpha, beta, sc, nm);",
         "bk, check_every, alpha, beta, scp, nm);"),
    ]},
}


def write_variant(name: str, dest: str) -> None:
    """This checkout's package, with the change ``VARIANTS[name]``, in
    ``dest`` (which must not exist yet); its build directory is not
    copied."""
    src = pathlib.Path(__file__).resolve().parents[1] / "ft_sgemm_tpu_torch"
    pkg = pathlib.Path(dest) / "ft_sgemm_tpu_torch"
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for rel, edits in VARIANTS[name].items():
        path = pkg / rel
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {rel} does not hold {old!r} once")
            text = text.replace(old, new)
        path.write_text(text)


def _libs(kernels, adaptive: bool) -> dict:
    return {k: KERNELS[k][0] + ("_adaptive" if adaptive else "")
            for k in kernels}


def build(tree: str, kernels, adaptive: bool = False) -> None:
    _import_port(tree)
    from ft_sgemm_tpu_torch.ops import _build

    _build.build(tuple(dict.fromkeys(_libs(kernels, adaptive).values())))


def measure(tree: str, kernels, tiles, adaptive: bool = False,
            magnitude: float = 1e4) -> dict:
    """Milliseconds per launch of each kernel on each tile, and its counts."""
    _import_port(tree)
    import numpy as np
    import torch

    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
    from ft_sgemm_tpu_torch.ops import _build
    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
    from ft_sgemm_tpu_torch.ops.common import (
        DEFAULT_THRESHOLD_MARGIN,
        NOISE_C_BIAS,
        NOISE_C_RAND,
        full_run_log2,
        scalar_operand,
    )
    from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {}
    libs = _libs(kernels, adaptive)
    for kern in kernels:
        _, entry, n_in, n_int, kind, _ = KERNELS[kern]
        tail = {"sgemm": [f, f, p], "precomp": [f, f, p, p]}.get(
            kind, [f, f, p, f, f, f, p])
        grids = 0 if kind == "sgemm" else 2
        entries[kern] = _build.bind(
            _build.library(libs[kern]), entry,
            [p] * (n_in + 1 + grids) + [i] * (6 + n_int) + tail)
    gen = np.random.default_rng(1)
    a, b, c = (torch.from_numpy(generate_random_matrix(SIZE, SIZE, rng=gen)).cuda()
               for _ in range(3))
    out = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream
    row = {}
    for name in tiles:
        sh = SHAPES[name]
        inj = (InjectionSpec.reference_like(SIZE, sh.bk, magnitude=magnitude)
               if magnitude else InjectionSpec.none())
        sc = (scalar_operand(inj, (0.0,) * 3, DEFAULT_THRESHOLD_MARGIN)
              if adaptive else
              scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3))
        det = torch.empty((SIZE // sh.bm, SIZE // sh.bn), dtype=torch.int32,
                          device="cuda")
        unc = torch.empty_like(det)
        dims = (SIZE, SIZE, SIZE, sh.bm, sh.bn, sh.bk)
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
                                 sh.bn, pair[1], adaptive)
            rows = ft.kernel_inputs(kind, a, b, sh)
            ints = (ce, int(mf))[:n_int]
            noise = () if kind == "precomp" else (
                full_run_log2(SIZE // sh.bk, sh.bk, sh.bm, sh.bn),
                NOISE_C_RAND, NOISE_C_BIAS)

            def launch(fn=fn, kern=kern, rows=rows, ints=ints, noise=noise):
                _build.check_launch(
                    fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       *(r.data_ptr() for r in rows), out.data_ptr(),
                       det.data_ptr(), unc.data_ptr(), *dims, *ints,
                       1.0, -1.5, sc.ctypes.data, *noise, stream), kern)

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
    adaptive = opts.get("--threshold", "static") == "adaptive"
    magnitude = float(opts.get("--magnitude", 1e4))
    args = [a for a in argv[1:] if not (a.startswith("--") and "=" in a)]
    if "--variant" in opts and len(args) == 1 and opts["--variant"] in VARIANTS:
        write_variant(opts["--variant"], args[0])
        return 0
    if len(args) == 2 and args[0] in ("--build", "--measure"):
        if args[0] == "--build":
            build(args[1], kernels, adaptive)
        else:
            print(json.dumps(measure(args[1], kernels, tiles, adaptive,
                                     magnitude)))
        return 0
    trees = args
    if (not trees or any(t.startswith("--") for t in trees)
            or not set(kernels) <= set(KERNELS)
            or adaptive and not set(kernels) <= set(KERNELS) - {"B1", "B2"}):
        print(__doc__)
        return 2
    print(card(), flush=True)
    picks = (f"--kernels={','.join(kernels)}",
             f"--threshold={'adaptive' if adaptive else 'static'}",
             f"--tiles={','.join(tiles)}", f"--magnitude={magnitude}")
    for name, row in turns(__file__, trees, *picks, build_args=picks[:2]):
        print(f"{name:19s} " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""A/B-time the port's CUDA kernels across source trees on one GPU.

Each TREE is a directory that holds a copy of the ``ft_sgemm_tpu_torch``
package: a ``git archive`` of a commit, or such a copy with one change.
The script builds every tree's kernels at once (the libraries the
dtype's kernels load), then times B1-B8 at
M = N = K = 4096 on the huge, large, tall, small, medium and wide tiles,
after checking each FT kernel's fault counts and output (B4 and B8,
detect only: their event counts), and reports B1's largest error against a float64 product
at each tile beside cuBLAS FP32's (``torch.addmm``, TF32 off). Each tree
is measured in a fresh process per turn, the turns running the trees in
order and then reversed, so a drift of the card shows as a difference
between a tree's two turns. Every FT kernel runs at the
cadence ``make_ft_sgemm`` picks for its strategy; B5 at that cadence where
the weighted strategy runs it (the small tile), else at four checks per
run. A tree whose package predates B4, B6, B7 and B8 is timed on B1, B2,
B3 and B5 only. Needs nvcc and a CUDA device:

    python3 scripts/torch_kernel_ab.py [--tiles=huge,small] [--turns=N] [--dtype=D] [--kernels=B4,B5] PARENT_TREE CHANGED_TREE [TREE ...]

``--tiles`` times only the named tiles; ``--turns=N`` repeats the order
and its reverse N times (default once); ``--kernels`` builds and times
only the named kernels (each tree's libraries of them, as its
``ops/ft_sgemm.kernel_entry`` names them). ``--dtype`` (``float32``, the
default; ``bfloat16``, ``fp8``, ``int8``) times that dtype's builds on A
and B rounded to it (int8: the program's ``np.round(10 x)`` lattice):
B1-B8 in bf16, B1-B5 in fp8 (B2-B5 on their bf16 builds, the wrapper
widening), B3 and B4 in int8, each FT kernel held to its fault counts
and, where it corrects, C to B1's plain version on the same operands.

    python3 scripts/torch_kernel_ab.py --build-only PARENT_TREE CHANGED_TREE [TREE ...]

times the builds instead: each tree whose ``csrc/_build`` is empty builds
all its libraries (in parallel, one ``nvcc`` each, as the package builds
them at first use) in a fresh process, the trees in turn, so that their
builds do not share the machine's cores; one JSON line per tree, with the
whole build's seconds, the slowest library's and each library's (from the
start of the build to its compiler's exit).

Prints the card's name and power limit, then one line per tree and turn:
milliseconds per kernel and tile, and the ``err`` entries. A kernel whose
check fails is printed as ``wrong`` and not timed, and the script then
exits 1.
"""

from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import time

SIZE = 4096
TILES = ("huge", "large", "tall", "small", "medium", "wide")
# The kernels the (strategy, encode) pairs of this slice run.
NEW_KERNELS = {"B4": ("global", "vpu"), "B6": ("fused", "mxu"),
               "B7": ("rowcol", "mxu"), "B8": ("global", "mxu")}


def _import_port(tree: str):
    """The tree's ``ft_sgemm_tpu_torch`` (and nothing else of that name)."""
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    import ft_sgemm_tpu_torch

    if not pathlib.Path(ft_sgemm_tpu_torch.__file__).is_relative_to(root):
        raise RuntimeError(f"{tree} holds no ft_sgemm_tpu_torch package")


# The libraries each dtype's measurement loads (those a tree has): the
# static f32 builds (B3's and B4's int8 builds among them), the static
# bf16 builds (fp8 runs B2-B5 on them) and B1's fp8 build.
F32_LIBS = ("sgemm", "ft_sgemm_weighted", "ft_sgemm_rowcol", "ft_sgemm_global",
            "ft_sgemm_aug")
BF16_LIBS = ("sgemm", "ft_sgemm_precomp_bf16", "ft_sgemm_weighted_bf16",
             "ft_sgemm_rowcol_bf16", "ft_sgemm_global_bf16",
             "ft_sgemm_fused_bf16", "ft_sgemm_rowcol_mxu_bf16")
DTYPE_LIBS = {"float32": F32_LIBS, "bfloat16": BF16_LIBS,
              "fp8": BF16_LIBS + ("sgemm_fp8",),
              "int8": ("ft_sgemm_rowcol", "ft_sgemm_global")}


def build(tree: str, dtype: str = "", kernels: str = "") -> dict:
    """Build the tree's libraries (with ``dtype``, only those its
    measurement loads; with ``kernels``, only those of the named kernels);
    {library: seconds}, as ``_build.build``."""
    _import_port(tree)
    from ft_sgemm_tpu_torch.ops import _build

    if not dtype:
        return _build.build()
    names = DTYPE_LIBS[dtype]
    if kernels:
        names = _kernel_libs(kernels.split(","), dtype)
    return _build.build(tuple(n for n in names if n in _build.LIBRARIES))


# The kind of each FT kernel (ops/ft_sgemm.kernel_entry).
KINDS = {"B2": "precomp", "B3": "rowcol", "B4": "global", "B5": "running",
         "B6": "fused", "B7": "rowcol_mxu", "B8": "global_mxu"}


def _kernel_libs(kernels, dtype: str) -> tuple:
    """The libraries that hold the named kernels' builds in ``dtype``."""
    import torch

    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft

    dt = {"float32": torch.float32, "int8": torch.int8}.get(dtype,
                                                           torch.bfloat16)
    return tuple(dict.fromkeys(
        ("sgemm_fp8" if dtype == "fp8" else "sgemm") if k == "B1"
        else ft.kernel_entry(KINDS[k], dt, False)[0] for k in kernels))


# The kernels each dtype's builds hold (B1 and the FT kernels' ids).
DTYPE_KERNELS = {"float32": ("B1", "B2", "B3", "B5", "B4", "B6", "B7", "B8"),
                 "bfloat16": ("B1", "B2", "B3", "B5", "B4", "B6", "B7", "B8"),
                 "fp8": ("B1", "B2", "B3", "B5", "B4"), "int8": ("B3", "B4")}


def measure(tree: str, tiles=TILES, dtype: str = "float32",
            kernels=None) -> dict:
    """Milliseconds per launch of each kernel on each tile, in one tree,
    in ``dtype`` (``kernels``: only those)."""
    _import_port(tree)
    import numpy as np
    import torch

    from ft_sgemm_tpu_torch.configs import SHAPES
    from ft_sgemm_tpu_torch.injection import REFERENCE_THRESHOLD, InjectionSpec
    from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
    from ft_sgemm_tpu_torch.ops import sgemm as sg
    from ft_sgemm_tpu_torch.ops.common import scalar_operand, strict_fp32
    from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix, verify_matrix
    from ft_sgemm_tpu_torch.utils.timing import cuda_ms

    gen = np.random.default_rng(1)
    a, b, c = (torch.from_numpy(generate_random_matrix(SIZE, SIZE, rng=gen)).cuda()
               for _ in range(3))
    if dtype != "float32":
        from ft_sgemm_tpu_torch.ops.common import as_operand

        if dtype == "int8":
            a, b = (torch.round(x * 10.0) for x in (a, b))
        dt = {"bfloat16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
              "int8": torch.int8}[dtype]
        a, b = (as_operand(x, dt, a.device) for x in (a, b))
    want = sg.sgemm_plain(a, b, c, 1.0, -1.5).cpu().numpy()
    strict_fp32()
    exact = a.double() @ b.double().T - 1.5 * c.double()
    row = {"err cublas": float((torch.addmm(
        c, a.float(), b.float().T, beta=-1.5).double() - exact).abs().max())}
    for name in tiles:
        sh = SHAPES[name]
        nk = SIZE // sh.bk
        inj = InjectionSpec.reference_like(SIZE, sh.bk)
        sc = scalar_operand(inj, (REFERENCE_THRESHOLD,) * 3)
        kind, ce_w, _ = ft._plan("weighted", None, None, inj, nk, sh.bn)
        ce_w = ce_w if kind == "running" else max(1, nk // 4)
        _, ce_r, mf = ft._plan("rowcol", None, None, inj, nk, sh.bn)
        expm = (ft._expected_col_checksums(a, b, sh.bm) if dtype != "int8"
                else None)
        mf = mf and dtype != "int8"
        runs = {
            "B1": lambda: sg.sgemm_kernel(a, b, c, sh, 1.0, -1.5),
            "B2": lambda: ft.ft_weighted_kernel(a, b, c, expm, sh, 1.0, -1.5, sc),
            "B3": lambda: ft.ft_rowcol_kernel(a, b, c, sh, 1.0, -1.5, sc, ce_r, mf),
            "B5": lambda: ft.ft_weighted_running_kernel(a, b, c, sh, 1.0, -1.5,
                                                        sc, ce_w),
        }
        # B2 checks once, so it is held to the count only where the program
        # runs it (a tile wide enough for the faults' distinct columns).
        checked = ["B3", "B5"] + (["B2"] if kind == "precomp" else [])
        if hasattr(ft, "run_kernel"):
            for kern, (strategy, encode) in NEW_KERNELS.items():
                if kern not in DTYPE_KERNELS[dtype]:
                    continue
                knd, ce, mfk = ft._plan(strategy, None, None, inj, nk, sh.bn,
                                        encode)
                args = (knd, sh, a, b, c, ft.kernel_inputs(knd, a, b, sh), 1.0,
                        -1.5, sc, ce, mfk)
                runs[kern] = functools.partial(ft.run_kernel, *args)
            checked += list(NEW_KERNELS)
        runs = {k: f for k, f in runs.items() if k in DTYPE_KERNELS[dtype]
                and (not kernels or k in kernels)}
        checked = [k for k in checked if k in runs]
        expected = (SIZE // sh.bm) * (SIZE // sh.bn) * inj.expected_faults(SIZE, sh.bk)
        for kern in checked:
            out, det, unc = runs[kern]()
            if kern in ("B4", "B8"):  # detect only: faults stay in C
                bad = int(det.sum()) != expected or not torch.equal(det, unc)
            else:
                bad = (int(unc.sum()) or int(det.sum()) != expected
                       or not verify_matrix(want, out.cpu().numpy(),
                                            verbose=False)[0])
            if bad:
                row[f"{kern} {name}"] = "wrong"
        if "B1" in runs:
            row[f"err B1 {name}"] = float(
                (runs["B1"]().double() - exact).abs().max())
        for kern, fn in runs.items():
            if f"{kern} {name}" not in row:
                row[f"{kern} {name}"] = cuda_ms(fn, reps=5)
    return row


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def turns(script: str, trees, *measure_args, build_args=(), n_turns=1):
    """Build every tree at once (``script --build TREE BUILD_ARGS``), then
    measure each in a fresh process per turn (``script --measure TREE
    ARGS``), the trees in order and then reversed, ``n_turns`` times;
    yields (tree's name, the JSON object on the measurement's last line)."""
    t0 = time.perf_counter()
    builds = [(t, subprocess.Popen([sys.executable, script, "--build", t,
                                    *build_args],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
              for t in trees]
    for tree, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tree}: build failed:\n{log}")
    print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for tree in (list(trees) + list(trees)[::-1]) * n_turns:
        res = subprocess.run([sys.executable, script, "--measure", tree,
                              *measure_args], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{tree}: measurement failed:\n{res.stdout}"
                               f"{res.stderr}")
        yield (pathlib.Path(tree).resolve().name,
               json.loads(res.stdout.strip().splitlines()[-1]))


def build_times(trees) -> int:
    """``--build-only``: each tree's build in a fresh process, in turn."""
    for tree in trees:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, __file__, "--build", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(f"{tree}: build failed:\n{res.stdout}{res.stderr}")
            return 1
        secs = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "total": time.perf_counter() - t0,
                          "max": max(secs.values(), default=0.0),
                          "secs": secs}), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) in (3, 4, 5) and argv[1] == "--build":
        print(json.dumps(build(*argv[2:])))
        return 0
    if len(argv) in (5, 6) and argv[1] == "--measure":
        print(json.dumps(measure(argv[2], argv[3].split(","), argv[4],
                                 argv[5].split(",") if len(argv) == 6
                                 else None)))
        return 0
    opts = {a.split("=", 1)[0]: a.split("=", 1)[1] for a in argv[1:]
            if a.startswith("--") and "=" in a}
    tiles = tuple(opts.get("--tiles", ",".join(TILES)).split(","))
    n_turns = int(opts.get("--turns", 1))
    dtype = opts.get("--dtype", "float32")
    kernels = opts.get("--kernels", "")
    trees = [a for a in argv[1:] if not a.startswith("--")]
    if (not trees or set(opts) - {"--tiles", "--turns", "--dtype", "--kernels"}
            or dtype not in DTYPE_KERNELS
            or not set(filter(None, kernels.split(","))) <= set(
                DTYPE_KERNELS[dtype]) or any(
                a.startswith("--") and "=" not in a and a != "--build-only"
                for a in argv[1:])):
        print(__doc__)
        return 2
    if "--build-only" in argv:
        return build_times(trees)
    print(card(), flush=True)
    wrong = 0
    for name, row in turns(__file__, trees, ",".join(tiles), dtype,
                           *([kernels] if kernels else []),
                           build_args=(dtype,) + ((kernels,) if kernels
                                                  else ()),
                           n_turns=n_turns):
        wrong += list(row.values()).count("wrong")
        print(f"{name:19s} " + " ".join(
            f"{k}={v}" if isinstance(v, str) else
            f"{k}={v:.3g}" if k.startswith("err") else f"{k}={v:.3f}"
            for k, v in row.items()), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

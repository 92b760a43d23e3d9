"""Static SASS census of the port's CUDA kernels: instruction counts by class.

Builds the sources of the ``ft_sgemm_tpu_torch`` package found under TREE
(default: the current directory), disassembles each library with
``cuobjdump -sass`` and prints, for every kernel on the named tiles, how
many instructions of each class its code holds: FFMA, shared loads and
stores, global loads, cp.async (LDGSTS), local loads and stores (register
spills), barriers, shuffles, the tensor-core products of the wgmma kernels
(HGMMA), their TMA loads (UTMALDG) and warpgroup fences and waits
(WARPGROUP), and the total. Counts are static (the code as compiled, each
loop body once), so they tell what a kernel carries beside its main loop,
not how often it runs it. A kernel is labelled by its ``WgTile``'s
parameters (CTA bm, bn, sub-tile bm, bn, moment rows per band, check
scratch, band-row and moment-row sources) and its last template flag (B1's
ragged store), and listed when the labels start with one of the named
tiles (default: every kernel). Needs nvcc and cuobjdump:

    python3 scripts/torch_sass_census.py [TREE] [--tiles=128,128,16,16;64,64]
"""

from __future__ import annotations

import collections
import pathlib
import re
import shutil
import subprocess
import sys

CLASSES = ("FFMA", "LDS", "STS", "LDG", "LDGSTS", "LDL", "STL", "BAR", "SHFL",
           "HGMMA", "UTMALDG", "WARPGROUP")


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(path).exists():
        raise RuntimeError("cuobjdump not found")
    return path


def census(sass: str) -> dict:
    """{kernel label: Counter of instruction classes} for one library."""
    out = {}
    for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass,
                               re.S):
        kind = re.search(r"ftsg\d+(\w+?_kernel)I", fn)
        wg = re.search(r"WgTileI((?:Li\d+E)+)E", fn)
        if not (kind and wg):
            continue
        dims = re.findall(r"Li(\d+)E", wg.group(1))
        flag = re.search(r"EELb([01])E", fn)
        label = (f"{kind.group(1)}<{','.join(dims)}"
                 + (f",{flag.group(1)}" if flag else "") + ">")
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                         body)
        counts = collections.Counter(ops)
        out[label] = {c: counts.get(c, 0) for c in CLASSES}
        out[label]["total"] = len(ops)
    return out


def main(argv) -> int:
    tree = next((a for a in argv[1:] if not a.startswith("--")), ".")
    tiles = ("",)
    for a in argv[1:]:
        if a.startswith("--tiles="):
            tiles = tuple(a.split("=", 1)[1].split(";"))
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    from ft_sgemm_tpu_torch.ops import _build

    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"{'kernel':44s}" + "".join(f"{c:>8s}" for c in CLASSES + ("total",)))
    for name in _build.KERNEL_SOURCES:
        print(f"{name}.cu")
        sass = subprocess.run([cuobjdump(), "-sass", str(_build.so_path(name))],
                              capture_output=True, text=True, check=True).stdout
        for label, counts in sorted(census(sass).items()):
            dims = label[label.index("<") + 1:-1] + ","
            if any(dims.startswith(f"{tile},".lstrip(",")) for tile in tiles):
                print(f"{label:44s}" + "".join(
                    f"{counts[c]:8d}" for c in CLASSES + ("total",)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

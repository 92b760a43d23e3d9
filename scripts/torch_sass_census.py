"""Static SASS census of the port's CUDA kernels: instruction counts by class.

Builds the sources of the ``ft_sgemm_tpu_torch`` package found under TREE
(default: the current directory), disassembles each library with
``cuobjdump -sass`` and prints, for every kernel on the named tiles, how
many instructions of each class its code holds: FFMA, shared loads and
stores, global loads, cp.async (LDGSTS), local loads and stores (register
spills), barriers, shuffles, the tensor-core products of the wgmma kernels
(HGMMA; IGMMA for the int8 builds' s8 products, QGMMA for B1's fp8 build's
e4m3 ones), their TMA loads (UTMALDG) and warpgroup fences and waits
(WARPGROUP), and the total. Counts are static (the code as compiled, each
loop body once), so they tell what a kernel carries beside its main loop,
not how often it runs it. A kernel is labelled by its ``WgTile``'s
parameters (CTA bm, bn, sub-tile bm, bn, moment rows per band, check
scratch, band-row and moment-row sources) and its last template flag (B1's
ragged store), "bf16", "s8" or "e4m3" after it for a bf16, int8 or fp8
tile, and listed
when the labels start with one of the named tiles (default: every kernel).
Needs nvcc and cuobjdump:

    python3 scripts/torch_sass_census.py [TREE] [--tiles=128,128,16,16;64,64] [--libs=ft_sgemm_rowcol]

``--libs=a,b`` builds and lists only the named libraries. The column
MISMOD counts the pattern of a signed modulo whose sign fix reads another
register than the one it shifted (``SHF.R.S32.HI Rs, RZ, 0x1f, Rt`` and,
within the next 8 instructions, ``LEA.HI Rd, Rs, Rx, ...`` with Rx not
Rt, and Rx no arithmetic right shift of Rt): the ptxas miscompile that
once lost fault adds (ROADMAP Queue C,
``csrc/ft_sgemm_running.cuh``: FragInject's unsigned hit test); SGNMOD
counts every such shift.

``--diff`` takes two trees instead, builds both, and says for every
kernel of the first tree's libraries, static and adaptive, whether the
second tree's kernel of the same label in the same library (or, for a
kernel that a split moved, in a library the first tree lacks, static or
adaptive alike) has the same instructions in the same order (operands
included, addresses not); ``--libs=a,b`` builds and compares only those
libraries:

    python3 scripts/torch_sass_census.py --diff PARENT_TREE TREE [--libs=a,b]
"""

from __future__ import annotations

import collections
import pathlib
import re
import shutil
import subprocess
import sys

CLASSES = ("FFMA", "LDS", "STS", "LDG", "LDGSTS", "LDL", "STL", "BAR", "SHFL",
           "HGMMA", "IGMMA", "QGMMA", "UTMALDG", "WARPGROUP")
PATTERNS = ("SGNMOD", "MISMOD")


def signed_mods(body: str):
    """(signed-modulo sign shifts, those whose LEA.HI reads another register
    than the one shifted) in one kernel's SASS. A register that is itself
    an arithmetic right shift of the one shifted (``(x >> 5) / 8`` takes
    x's sign) does not count."""
    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([^;]*);", body)
    shifts, bad = 0, 0
    for i, text in enumerate(ins):
        m = re.match(r"SHF\.R\.S32\.HI (R\d+), RZ, 0x1f, (R\d+)", text)
        if not m:
            continue
        shifts += 1
        rs, rt = m.groups()
        for later in ins[i + 1:i + 9]:
            lea = re.match(r"LEA\.HI (?:\S+), (R\d+), (R\d+)", later)
            if lea and lea.group(1) == rs:
                rx = lea.group(2)
                same_sign = any(re.match(
                    rf"SHF\.R\.S32\.HI {rx}, RZ, 0x[0-9a-f]+, {rt}\b", x)
                    for x in ins[max(0, i - 10):i + 9])
                bad += rx != rt and not same_sign
                break
    return shifts, bad


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(path).exists():
        raise RuntimeError("cuobjdump not found")
    return path


def _kernels(sass: str):
    """(label, SASS body) of each wgmma kernel in one library's dump."""
    for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass,
                               re.S):
        kind = re.search(r"ftsg\d+(?:adaptive\d+)?(\w+?_kernel)I", fn)
        wg = re.search(r"WgTileI((?:Li\d+E)+)E", fn)
        if not (kind and wg):
            continue
        dims = re.findall(r"Li(\d+)E", wg.group(1))
        # A ninth parameter is the operand type: f32 (0) keeps the labels of
        # trees from before it, bf16 (1), int8 (2) and fp8 (3) are marked.
        in_type = dims.pop() if len(dims) == 9 else "0"
        flag = re.search(r"EELb([01])E", fn)
        yield (f"{kind.group(1)}<{','.join(dims)}"
               + (f",{flag.group(1)}" if flag else "") + ">"
               + {"1": " bf16", "2": " s8", "3": " e4m3"}.get(in_type,
                                                              "")), body


def census(sass: str) -> dict:
    """{kernel label: Counter of instruction classes} for one library."""
    out = {}
    for label, body in _kernels(sass):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                         body)
        counts = collections.Counter(ops)
        out[label] = {c: counts.get(c, 0) for c in CLASSES}
        out[label].update(zip(PATTERNS, signed_mods(body)))
        out[label]["total"] = len(ops)
    return out


def _dump(so: pathlib.Path) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def instructions(sass: str) -> dict:
    """{kernel label: its instructions in order, without addresses}."""
    return {label: re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
            for label, body in _kernels(sass)}


def diff(old_tree: str, new_tree: str, names=None) -> int:
    """Print, per kernel of OLD_TREE's libraries (or of the libraries
    ``names``), whether NEW_TREE compiles it to the same instruction
    sequence."""
    roots = [pathlib.Path(t).resolve() for t in (old_tree, new_tree)]
    # Each tree's libraries, built in a process of its own (the packages
    # share their module names), both at once.
    arg = "" if names is None else repr(tuple(names))
    builds = [subprocess.Popen([
        sys.executable, "-c", f"import sys; sys.path.insert(0, {str(r)!r});"
        f" from ft_sgemm_tpu_torch.ops import _build; _build.build({arg})"])
        for r in roots]
    if any(b.wait() for b in builds):
        raise RuntimeError("a tree did not build")
    # Each tree's built libraries, by name (the newest build of a name).
    libs = {tree: {so.name.split("-")[0]: so for so in sorted(
                (r / "ft_sgemm_tpu_torch/csrc/_build").glob("lib*.so"),
                key=lambda so: so.stat().st_mtime)
                if names is None or so.name[3:].split("-")[0] in names}
            for tree, r in zip((old_tree, new_tree), roots)}
    for lib, so in sorted(libs[old_tree].items()):
        if "hostutils" in lib or lib not in libs[new_tree]:
            continue
        new = instructions(_dump(libs[new_tree][lib]))
        for name, moved in libs[new_tree].items():
            # The builds that moved into libraries of their own: those the
            # first tree lacks, static or adaptive as `lib` is.
            if (name not in libs[old_tree] and "hostutils" not in name
                    and ("adaptive" in name) == ("adaptive" in lib)):
                new = {**instructions(_dump(moved)), **new}
        for label, old in instructions(_dump(so)).items():
            if label not in new:
                print(f"{lib} {label}: not in {new_tree}")
            elif new[label] == old:
                print(f"{lib} {label}: identical, {len(old)} instructions")
            else:
                print(f"{lib} {label}: differs, {len(old)} -> "
                      f"{len(new[label])} instructions")
    return 0


def main(argv) -> int:
    if "--diff" in argv:
        libs = next((tuple(a.split("=", 1)[1].split(",")) for a in argv[1:]
                     if a.startswith("--libs=")), None)
        return diff(*(a for a in argv[1:] if not a.startswith("--")),
                    names=libs)
    tree = next((a for a in argv[1:] if not a.startswith("--")), ".")
    tiles, names = ("",), None
    for a in argv[1:]:
        if a.startswith("--tiles="):
            tiles = tuple(a.split("=", 1)[1].split(";"))
        if a.startswith("--libs="):
            names = tuple(a.split("=", 1)[1].split(","))
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    from ft_sgemm_tpu_torch.ops import _build

    # A tree from before the adaptive libraries names its sources instead.
    names = names or getattr(_build, "KERNEL_LIBS", None) or _build.KERNEL_SOURCES
    _build.build(names)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cols = CLASSES + PATTERNS + ("total",)
    print(f"{'kernel':48s}" + "".join(f"{c:>8s}" for c in cols))
    for name in names:
        print(name)
        sass = _dump(_build.so_path(name))
        for label, counts in sorted(census(sass).items()):
            dims = label[label.index("<") + 1:label.index(">")] + ","
            if any(dims.startswith(f"{tile},".lstrip(",")) for tile in tiles):
                print(f"{label:48s}" + "".join(f"{counts[c]:8d}" for c in cols))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""Mutation check of the bf16 bracket (``chip_smoke.phase_lowp_bracket``).

Copies the port (``ft_sgemm_tpu_torch/`` and ``chip_smoke.py`` of TREE,
default the current directory) into a temporary directory four times,
breaks the per-half-step moment sums of the adaptive bf16 builds
(``SubTileThresholds::kstep_bf16``, ``csrc/ft_sgemm_running.cuh``) in
three of the copies, builds the adaptive bf16 libraries of all four in
parallel and runs the bracket in bf16 on each, once for each build (B5,
B3, B4: ``chip_smoke.LOWP_ADAPTIVE_KINDS`` one at a time):

- ``whole_step``: a check between the halves of a 16-deep k step also
  counts the step's second half;
- ``b_cols``: both threads of a B row read the first 4 columns of the half
  step (the last 4 are never counted);
- ``a_reg``: one of A's two fragment registers of the half step is dropped.

Each broken copy must fail the bracket with each build and the unbroken
one pass it; one line per copy and build, exit code 1 otherwise. Needs the card and nvcc:

    python3 scripts/torch_bracket_mutants.py [TREE]
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

HEADER = "ft_sgemm_tpu_torch/csrc/ft_sgemm_running.cuh"
SIGNATURE = """\
  __device__ __forceinline__ void kstep_bf16(const M& ml, const F& ah, int kk,
                                             int s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {"""
BODY_END = """\
      st[3] = fmaf(xb[j], xb[j], st[3]);
    }
  }

  // Every sub-tile's thresholds"""
# Each mutant: (text, replacement) pairs, each text found once in HEADER.
MUTANTS = {
    "none": [],
    "whole_step": [
        (SIGNATURE, """\
  __device__ __forceinline__ void kstep_bf16(const M& ml, const F& ah, int k0,
                                             int s) {
    if (k0 & 1) return;
    for (int kk = k0; kk < k0 + 2; ++kk) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {"""),
        (BODY_END, BODY_END.replace("    }\n  }\n", "    }\n    }\n  }\n", 1))],
    "b_cols": [("p = 4 * kk + 2 * (threadIdx.x & 1);", "p = 4 * kk;")],
    "a_reg": [("for (int j = 0; j < 2; ++j) {\n      const float x[2]",
               "for (int j = 0; j < 1; ++j) {\n      const float x[2]")],
}
BUILD = ("import sys; sys.path.insert(0, '.');"
         " from ft_sgemm_tpu_torch.ops import _build, ft_sgemm;"
         " _build.build(tuple(dict.fromkeys(ft_sgemm.ADAPTIVE_BF16_LIBS.values())))")
BRACKET = ("import sys; sys.path.insert(0, '.'); import chip_smoke as cs;"
           " cs.LOWP_ADAPTIVE_KINDS = (sys.argv[1],);"
           " cs.phase_lowp_bracket(cs.Kernels(), 'bfloat16')")
KINDS = ("running", "rowcol", "global")


def copy_tree(tree: pathlib.Path, dest: pathlib.Path, edits) -> None:
    shutil.copytree(tree / "ft_sgemm_tpu_torch", dest / "ft_sgemm_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(tree / "chip_smoke.py", dest / "chip_smoke.py")
    path = dest / HEADER
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{HEADER}: the text to break is not found once:"
                             f" {old!r}")
        text = text.replace(old, new)
    path.write_text(text)


def main(argv) -> int:
    tree = pathlib.Path(argv[0] if argv else ".").resolve()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, edits in MUTANTS.items():
            dest = pathlib.Path(tmp) / name
            copy_tree(tree, dest, edits)
            builds[name] = subprocess.Popen(
                [sys.executable, "-c", BUILD], cwd=dest, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        ok = True
        for name, proc in builds.items():
            out, _ = proc.communicate()
            if proc.returncode:
                print(f"{name}: the build failed\n{out[-3000:]}", flush=True)
                ok = False
                continue
            for kind in KINDS:
                run = subprocess.run([sys.executable, "-c", BRACKET, kind],
                                     cwd=pathlib.Path(tmp) / name, text=True,
                                     capture_output=True)
                last = (run.stderr.strip().splitlines() or [""])[-1]
                if run.returncode and "AssertionError" in last:
                    verdict, detail = "fails", last
                elif run.returncode == 0:
                    verdict = "passes"
                    detail = (run.stdout.strip().splitlines() or [""])[-1]
                else:
                    verdict, detail = "errs", last
                good = verdict == ("passes" if name == "none" else "fails")
                print(f"{name} {kind}: {verdict} the bf16 bracket"
                      f" ({'as wanted' if good else 'NOT as wanted'}):"
                      f" {detail}", flush=True)
                ok = ok and good
    print(f"bracket mutants: {'as wanted' if ok else 'FAILED'}"
          f" ({time.perf_counter() - t0:.1f} s)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Print the ring of every sub-tiled FT kernel (B3-B8) as compiled: its
pipeline stages, the splitters' scratch sets and its dynamic shared
memory, per tile, dtype (f32, bf16) and build (static, adaptive).

The numbers are ``WgTile``'s own constants (``csrc/gemm_wgmma.cuh``:
STAGES, PROD_SETS, SMEM) of the tile type each kernel's policy names
(``csrc/ft_sgemm_running.cuh``: ``WeightedOf``, ``RowcolOf``,
``GlobalOf``), read by a small host program that includes the sources and
is compiled with ``nvcc`` once per build (``-DFTSG_ADAPTIVE=0`` and
``1``): the adaptive build adds the thresholds' scratch to each check's,
which can cost a stage. Needs nvcc (no GPU):

    python3 scripts/torch_ring_stages.py
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "ft_sgemm_tpu_torch" / "csrc"
# kernel -> the policy's tile type, with SBM, SBN and IN left open.
KINDS = {
    "B3": "RowcolOf<false, ftsg::kSumBands, ftsg::kSumRowGroups, IN>",
    "B3 mf": "RowcolOf<true, ftsg::kSumBands, ftsg::kSumRowGroups, IN>",
    "B4": "GlobalOf<ftsg::kSumBands, IN>",
    "B5": "WeightedOf<ftsg::kSumRows, IN>",
    "B6": "WeightedOf<ftsg::kLoadRows, IN>",
    "B7": "RowcolOf<false, ftsg::kLoadBands, ftsg::kLoadRows, IN>",
    "B7 mf": "RowcolOf<true, ftsg::kLoadBands, ftsg::kLoadRows, IN>",
    "B8": "GlobalOf<ftsg::kLoadBands, IN>",
}
SOURCE = """#include <cstdio>
#include "ft_sgemm_running.cuh"
template <int IN, int SBM, int SBN>
void row(const char* kind) {{
{rows}
}}
int main() {{
#define ROW(SBM_, SBN_) row<ftsg::kF32, SBM_, SBN_>("f32"); \\
                        row<ftsg::kBF16, SBM_, SBN_>("bf16");
  FTSG_FOR_EACH_SUBTILE(ROW)
  return 0;
}}
"""
ROW = """  {{
    using T = typename ftsg::{policy}::template At<SBM, SBN>::type;
    std::printf("%s %s %dx%d stages %d prod_sets %d smem %d\\n", "{name}",
                kind, SBM, SBN, T::STAGES, T::PROD_SETS, T::SMEM);
  }}"""


def main() -> int:
    nvcc = "/usr/local/cuda/bin/nvcc"
    rows = "\n".join(ROW.format(policy=p, name=n) for n, p in KINDS.items())
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "stages.cu"
        src.write_text(SOURCE.format(rows=rows))
        for adaptive in (0, 1):
            exe = pathlib.Path(tmp) / f"stages{adaptive}"
            subprocess.run([nvcc, "-std=c++17", "-arch=sm_90a",
                            f"-DFTSG_ADAPTIVE={adaptive}", f"-I{CSRC}",
                            "-o", str(exe), str(src)], check=True)
            out = subprocess.run([str(exe)], check=True, capture_output=True,
                                 text=True).stdout
            build = "adaptive" if adaptive else "static"
            for line in out.splitlines():
                print(build, line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the bank scans' screen path spends its time: ``scan_times.py`` on
copies of this package whose ``csrc/scan_tile.cuh`` has one more part of
``screen_kernel`` taken out per variant (cumulative), on the card:

    python3 cslam_tpu_torch/tools/scan_ablation.py --out <scratch dir>

1. ``full``: the kernel as it is;
2. ``no rescore``: survivors are collected but never rescored (the threshold
   stays at the first tile's seed, so more rows survive than in ``full``);
3. ``no survivors``: the filter's test never passes;
4. ``no mma``: each ``mma.sync`` replaced by one add of its operands;
5. ``no fragments``: no k-loop (no fragment loads, norms, TF32 conversions);
6. ``no filter``: no filter arithmetic; what is left is the tile loads, the
   barriers, the seed and the merge kernel.

Every variant but ``full`` returns wrong results by design; only its time
means something. The anchors below are lines of ``scan_tile.cuh``; the tool
stops if one is not found exactly once. ``--out`` names a directory that
does not exist yet (e.g. under the git-ignored ``archive_check/``).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

_PKG = pathlib.Path(__file__).resolve().parent.parent
_RESCORE = "      total += c[j];\n    }\n"
_FILTER = "if (r < rows && q0 + q < B && s + e >= tau[q]) {"
_MMA = ("            mma_tf32(acc[nt], a0, a1, a2, a3, br[nt * 8 * W + kw],\n"
        "                     br[nt * 8 * W + kw + 4]);")
_KLOOP = "      for (int kw = 0; kw < DW; kw += 8) {"
_FLOOP = ("      // ---- filter: s~ + eps >= tau_q, survivors to the candidate "
          "lists\n#pragma unroll\n      for (int nt = 0; nt < 4; ++nt)")
#: (name, the edit it adds to the previous variant's)
VARIANTS = [
    ("full", None),
    ("no rescore", (_RESCORE, _RESCORE + "    total = 0;\n")),
    ("no survivors", (_FILTER, _FILTER.replace(">= tau[q]", "== -1234.5f"))),
    ("no mma", (_MMA, "            acc[nt][0] = __fadd_rn(acc[nt][0], "
                      "__uint_as_float(a0 ^ br[nt * 8 * W + kw] ^ "
                      "br[nt * 8 * W + kw + 4]));")),
    ("no fragments", (_KLOOP, _KLOOP.replace("kw < DW", "kw < 0"))),
    ("no filter", (_FLOOP, _FLOOP.replace("nt < 4", "nt < 0"))),
]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, type=pathlib.Path)
    args = parser.parse_args()
    if args.out.exists():
        sys.exit(f"scan_ablation: {args.out} exists")
    header = (_PKG / "csrc" / "scan_tile.cuh").read_text()
    trees = []
    for v, (name, edit) in enumerate(VARIANTS):
        if edit is not None:
            if header.count(edit[0]) != 1:
                sys.exit(f"scan_ablation: anchor of '{name}' not found once")
            header = header.replace(edit[0], edit[1])
        tree = args.out / f"v{v}"
        shutil.copytree(_PKG, tree / _PKG.name, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        (tree / _PKG.name / "csrc" / "scan_tile.cuh").write_text(header)
        trees.append((name, tree))
    timer = _PKG / "tools" / "scan_times.py"
    for name, tree in trees + trees[:1]:   # the full kernel again, last
        out = subprocess.run(
            [sys.executable, str(timer), "--label", name], check=True,
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(tree)})
        print(json.dumps(json.loads(out.stdout.strip().splitlines()[-1])))


if __name__ == "__main__":
    main()

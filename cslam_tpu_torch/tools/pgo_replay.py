#!/usr/bin/env python3
"""Replay aggregate pose graphs dumped from a live pipeline run.

The port's twin of ``benchmarks/pgo_replay_probe.py``. Run any pipeline
with ``CSLAM_TPU_DUMP_PGO=<dir>`` (the back end then saves every aggregate
graph it solves, ``pgo_r{robot}_{seq:03d}.npz``: one key per
``PoseGraphArrays`` field, int32 indices and float32 values, the same
files in both packages), then replay them here one by one: the graph's
size, tier and robust residuals, then ``lm_optimize`` (``rel_tol`` 1e-5,
as the probe), ``gnc_optimize(max_outer=100)`` and ``gnc_reoptimize`` warm
from that result, each timed after warm runs. On the card the solves run
through the tier's captured step programs (CUDA events time them);
``--eager`` launches the same programs one by one.

    CSLAM_TPU_DUMP_PGO=/tmp/pgo python3 \\
        cslam_tpu_torch/tools/lidar_e2e_scale.py --robots 5 --steps 210
    python3 cslam_tpu_torch/tools/pgo_replay.py --dir /tmp/pgo
    python3 cslam_tpu_torch/tools/pgo_replay.py --dir /tmp/pgo --device cpu

Prints one JSON line per dump, then one naming the slowest solve, and on
the card the ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cslam_tpu_torch import resolve_device  # noqa: E402
from cslam_tpu_torch.pgo import solver  # noqa: E402
from cslam_tpu_torch.pgo.factor_graph import (PoseGraphArrays,  # noqa: E402
                                              arrays_from_numpy)
from cslam_tpu_torch.tools.harness import card_line, timed  # noqa: E402

#: the dump files' keys, in ``PoseGraphArrays``' field order
FIELDS = tuple(f.name for f in dataclasses.fields(PoseGraphArrays))


def load(path, device=None) -> PoseGraphArrays:
    """A dump file (either package's) as the port's ``PoseGraphArrays`` on
    ``device`` (CUDA unless the caller passes another)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        return arrays_from_numpy({name: z[name] for name in FIELDS}, device)


def graph_row(a: PoseGraphArrays) -> dict:
    """The probe's description of one graph: valid nodes and edges, the
    padded tier, robust edges and their chi2 at the dumped poses."""
    chi2 = solver._edge_chi2(a.poses, a).cpu().numpy()
    rb = (a.robust * a.edge_valid).cpu().numpy() > 0
    return {"nodes": int(a.node_valid.sum()),
            "edges": int(a.edge_valid.sum()),
            "tier": [a.num_nodes, a.num_edges],
            "robust_edges": int(rb.sum()),
            "chi2_med": round(float(np.median(chi2[rb])), 1)
            if rb.any() else 0,
            "chi2_max": round(float(chi2[rb].max()), 1) if rb.any() else 0}


def replay(a: PoseGraphArrays, lm_iters: int = 50, cg_iters: int = 150,
           eager: bool = False, warm: int = 2):
    """The probe's three solves of one graph, each run ``warm`` times
    before the timed run. Returns (row, the timed ``GncResult``)."""
    device = a.poses.device
    ones = torch.ones(a.num_edges, dtype=a.poses.dtype, device=device)

    def lm():
        r = solver.lm_optimize(a, ones, max_iters=lm_iters,
                               cg_iters=cg_iters, rel_tol=1e-5, eager=eager)
        return r.iterations

    def gnc():
        r = solver.gnc_optimize(a, max_outer=100, lm_iters=lm_iters,
                                cg_iters=cg_iters, eager=eager)
        float(r.final_cost)
        return r

    row = {}
    for _ in range(warm):
        lm()
    row["lm_iters"], row["lm_s"] = timed(lm, device)
    for _ in range(warm):
        gnc()
    res, row["gnc_s"] = timed(gnc, device)
    row["gnc_outer"] = int(res.outer_iterations)
    row["rejected"] = len(rejected_edges(a, res))
    warm_graph = dataclasses.replace(a, poses=res.poses)

    def reopt():
        r = solver.gnc_reoptimize(warm_graph, res.weights, lm_iters=lm_iters,
                                  cg_iters=cg_iters, eager=eager)
        float(r.final_cost)

    for _ in range(warm):
        reopt()
    row["reopt_s"] = timed(reopt, device)[1]
    return row, res


def rejected_edges(a: PoseGraphArrays, result) -> list:
    """Slots of the robust edges a GNC result rejects (weight < 0.5)."""
    rb = (a.robust * a.edge_valid).cpu().numpy() > 0
    w = result.weights.cpu().numpy()
    return np.nonzero((w < 0.5) & rb)[0].tolist()


def replay_dir(dump_dir, device=None, lm_iters: int = 50,
               cg_iters: int = 150, eager: bool = False, warm: int = 2):
    """One row per dump in ``dump_dir`` (sorted by name), printed as it
    comes; returns the rows."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dump_dir, "*.npz"))):
        a = load(path, device)
        row = {"file": os.path.basename(path), **graph_row(a)}
        row.update(replay(a, lm_iters, cg_iters, eager, warm)[0])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--lm-iters", type=int, default=50)
    ap.add_argument("--cg-iters", type=int, default=150)
    ap.add_argument("--eager", action="store_true",
                    help="launch the step programs one by one (no capture)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    rows = replay_dir(args.dir, device, args.lm_iters, args.cg_iters,
                      args.eager)
    if not rows:
        print(f"no dumps in {args.dir}")
        return 1
    slow = max(rows, key=lambda r: r["gnc_s"])
    print(json.dumps({"dumps": len(rows), "device": device.type,
                      "eager": args.eager, "slowest": slow["file"],
                      "slowest_gnc_s": slow["gnc_s"],
                      "total_gnc_s": sum(r["gnc_s"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

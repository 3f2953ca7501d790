#!/usr/bin/env python3
"""Randomized GNC robustness sweep: the guard-rail for solver changes.

The port's twin of ``benchmarks/gnc_scenario_sweep.py``, with the same
worlds, tiers and scores. GNC changes that look identical on small graphs
can regress at scale, so every solver change must pass this sweep,
including its 2,048-pose tier (8 x 256), which takes the PCG tier. It
builds multi-robot circle worlds with randomized loop closures and gross
outliers (inter- and intra-robot), runs ``gnc_optimize`` and scores:

- false rejections (genuine loop closures with final TLS weight < 0.5)
- missed outliers (gross outliers with final weight >= 0.5)
- final ATE against ground truth (must beat the dead-reckoned init)

The worlds are drawn as the JAX script draws them (the same
``np.random.default_rng(1000 * seed + n_out)`` stream, the noise composed
through ``ops/se3`` in float32 on the CPU), so both sweeps solve the same
graphs. On the card the solves replay the tier's captured step programs;
``--eager`` launches the same programs one by one, and ``--both`` runs
both per scenario and reports whether they reject the same edges.

    python3 cslam_tpu_torch/tools/gnc_scenario_sweep.py            # card
    python3 cslam_tpu_torch/tools/gnc_scenario_sweep.py --both
    python3 cslam_tpu_torch/tools/gnc_scenario_sweep.py --quick --device cpu

One JSON line per scenario (and mode), then a summary line per mode, and
on the card the ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cslam_tpu_torch import resolve_device  # noqa: E402
from cslam_tpu_torch.ops import se3  # noqa: E402
from cslam_tpu_torch.pgo import FactorGraph, gnc_optimize  # noqa: E402
from cslam_tpu_torch.tools.harness import card_line, synchronize  # noqa: E402

TIERS = [
    # (nb_robots, nb_poses, loop_every, outlier_counts, intra, seeds)
    (3, 80, 10, (0, 1, 2), 1, (0, 1)),
    (5, 100, 10, (0, 2), 2, (2, 3)),
    (5, 150, 12, (2, 4), 2, (4, 5)),
    (8, 256, 10, (0, 2, 4), 3, (6, 7)),
]
QUICK_TIERS = TIERS[:2]


def _se3_exp(xi: np.ndarray) -> np.ndarray:
    return se3.exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()


def build_scenario(rng, nb_robots, nb_poses, loop_every, n_outliers,
                   intra_loops):
    """N robots on concentric circles; inter-robot loops at randomized
    keyframe offsets; optional intra-robot loop closures; gross outliers
    between random far-apart pose pairs. Returns (graph, ground truth,
    genuine loops, outliers); the robust edges are added genuine first."""
    sigmas = np.array([0.01] * 3 + [0.1] * 3)

    gt = {}
    for r in range(nb_robots):
        radius = 10.0 + 0.4 * r
        for k in range(nb_poses):
            a = 2 * np.pi * k / nb_poses
            T = np.eye(4)
            T[:3, :3] = [[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1.0]]
            T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.05 * r]
            gt[(r, k)] = T

    def noisy(z):
        n = np.concatenate([rng.normal(scale=0.01, size=3),
                            rng.normal(scale=0.1, size=3)])
        return se3.compose(torch.as_tensor(z, dtype=torch.float32),
                           torch.as_tensor(_se3_exp(n))).numpy()

    graph = FactorGraph()
    for r in range(nb_robots):
        cur = gt[(r, 0)]
        graph.add_variable((r, 0), cur)
        for k in range(nb_poses - 1):
            z = noisy(np.linalg.inv(gt[(r, k)]) @ gt[(r, k + 1)])
            cur = cur @ z
            graph.add_variable((r, k + 1), cur)
            graph.add_between((r, k), (r, k + 1), z, sigmas)

    genuine = []
    for r in range(nb_robots - 1):
        for k in range(0, nb_poses, loop_every):
            k2 = int(np.clip(k + rng.integers(-loop_every // 2,
                                              loop_every // 2 + 1),
                             0, nb_poses - 1))
            z = noisy(np.linalg.inv(gt[(r, k)]) @ gt[(r + 1, k2)])
            graph.add_between((r, k), (r + 1, k2), z, sigmas, robust=True)
            genuine.append(((r, k), (r + 1, k2)))
    for _ in range(intra_loops):
        r = int(rng.integers(nb_robots))
        k = int(rng.integers(nb_poses // 2))
        k2 = int(rng.integers(nb_poses // 2, nb_poses))
        z = noisy(np.linalg.inv(gt[(r, k)]) @ gt[(r, k2)])
        graph.add_between((r, k), (r, k2), z, sigmas, robust=True)
        genuine.append(((r, k), (r, k2)))

    outliers = []
    for _ in range(n_outliers):
        ra, rb_ = rng.choice(nb_robots, 2, replace=n_outliers > nb_robots)
        ka, kb = int(rng.integers(nb_poses)), int(rng.integers(nb_poses))
        bad = _se3_exp(np.concatenate([rng.uniform(-2, 2, 3),
                                       rng.uniform(-20, 20, 3)]))
        graph.add_between((int(ra), ka), (int(rb_), kb), bad, sigmas,
                          robust=True)
        outliers.append(((int(ra), ka), (int(rb_), kb)))

    graph.add_prior((0, 0), gt[(0, 0)], sigmas)
    return graph, gt, len(genuine), len(outliers)


def run_scenario(graph, gt, n_genuine, n_outliers, device=None,
                 eager: bool = False):
    """``gnc_optimize`` with its defaults on one scenario, scored as the
    JAX script scores it; ``rejected`` lists the robust edges' slots with
    final weight < 0.5."""
    device = resolve_device(device)
    arrays = graph.to_arrays(device=device)

    def ate(poses):
        est = {tuple(v.key.as_tuple()): v.pose
               for v in graph.values_from_arrays(poses)}
        return float(np.sqrt(np.mean(
            [np.linalg.norm(est[k][:3, 3] - gt[k][:3, 3]) ** 2 for k in gt])))

    synchronize(device)
    t0 = time.perf_counter()
    res = gnc_optimize(arrays, eager=eager)
    final_cost = float(res.final_cost)  # a host read: the solve has ended
    dt = time.perf_counter() - t0

    w = res.weights.cpu().numpy()
    rb = ((arrays.robust > 0) & (arrays.edge_valid > 0)).cpu().numpy()
    ridx = np.nonzero(rb)[0]
    # robust edges were added genuine-first, outliers last (build order)
    genuine_w = w[ridx[:n_genuine]]
    outlier_w = w[ridx[n_genuine:]]
    return {
        "ate_init_m": round(ate(arrays.poses), 3),
        "ate_final_m": round(ate(res.poses), 3),
        "false_rejected": int((genuine_w < 0.5).sum()),
        "genuine_total": n_genuine,
        "outliers_rejected": int((outlier_w < 0.5).sum()),
        "outliers_total": n_outliers,
        "outer_iterations": int(res.outer_iterations),
        "final_cost": round(final_cost, 2),
        "wallclock_s": round(dt, 3),
        "rejected": ridx[w[ridx] < 0.5].tolist(),
    }


def scenarios(tiers):
    """(tier row, n_out, seed) of every scenario of ``tiers``, in the JAX
    script's order."""
    for tier in tiers:
        for n_out in tier[3]:
            for seed in tier[5]:
                yield tier, n_out, seed


def sweep(tiers=TIERS, device=None, modes=("graphed",), emit=print):
    """Run every scenario of ``tiers`` in each of ``modes`` ("graphed",
    "eager"). Returns {"rows": [...], "summary": {mode: totals},
    "same_rejected": [per scenario, where both modes ran]}; each row is
    also passed to ``emit`` as a JSON line."""
    device = resolve_device(device)
    totals = {m: {"scenarios": 0, "false_rejected": 0, "missed_outliers": 0,
                  "ate_regressions": 0, "wallclock_s": 0.0} for m in modes}
    rows, same = [], []
    for (nr, npo, le, _, intra, _), n_out, seed in scenarios(tiers):
        rng = np.random.default_rng(1000 * seed + n_out)
        graph, gt, ng, no = build_scenario(rng, nr, npo, le, n_out, intra)
        rejected = {}
        for mode in modes:
            row = run_scenario(graph, gt, ng, no, device,
                               eager=mode == "eager")
            row.update({"robots": nr, "poses_per_robot": npo, "seed": seed,
                        "mode": mode})
            rejected[mode] = row["rejected"]
            rows.append(row)
            emit(json.dumps(row))
            t = totals[mode]
            t["scenarios"] += 1
            t["false_rejected"] += row["false_rejected"]
            t["missed_outliers"] += (row["outliers_total"]
                                     - row["outliers_rejected"])
            t["ate_regressions"] += int(
                row["ate_final_m"] > max(row["ate_init_m"], 0.5))
            t["wallclock_s"] += row["wallclock_s"]
        if len(rejected) > 1:
            same.append(len({tuple(v) for v in rejected.values()}) == 1)
    return {"rows": rows, "summary": totals, "same_rejected": same}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the two small tiers only (10 scenarios)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true",
                      help="launch the step programs one by one")
    mode.add_argument("--both", action="store_true",
                      help="graphed and eager per scenario")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    modes = (("graphed", "eager") if args.both
             else ("eager",) if args.eager else ("graphed",))
    out = sweep(QUICK_TIERS if args.quick else TIERS, device, modes,
                emit=lambda line: print(line, flush=True))
    for m, totals in out["summary"].items():
        print(json.dumps({"summary": totals, "mode": m,
                          "device": device.type}), flush=True)
    if args.both:
        print(json.dumps({"same_rejected": sum(out["same_rejected"]),
                          "scenarios": len(out["same_rejected"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

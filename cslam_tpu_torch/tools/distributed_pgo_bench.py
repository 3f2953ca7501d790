#!/usr/bin/env python3
"""Distributed (robot-sharded) PGO: the sweeps-to-centralized-parity curve.

The port's twin of ``benchmarks/distributed_pgo_bench.py``, with the same
world, keywords and rows. Robots on concentric circles with noisy odometry,
a separator every ``--sep-every`` poses between neighbouring robots and two
gross outlier separators; the world is drawn as the JAX script draws it
(``np.random.default_rng(0)``, the same draw order, the measurements
through the port's ``ops/se3`` in float32 on the CPU), so both scripts
solve the same graph. Rows:

- ``central``: the centralized ``gnc_optimize`` on the whole graph (the
  reference the distributed mode is held to), its ATE and seconds;
- ``curve``: ATE after each of 20 ``make_distributed_step`` sweeps at a
  growing mu (0.05, x 1.6 per sweep), and the first sweep within 0.05 m of
  the centralized ATE;
- ``solve``: ``distributed_optimize`` cold, timed on its second call (the
  first captures on the card), with sweeps, LM iterations, outliers
  rejected and genuine separators cut;
- ``warm``: the steady-state round, from the cold solution with its
  carried separator weights, timed the same way;
- ``summary``: the JAX script's last line's keys.

    python3 cslam_tpu_torch/tools/distributed_pgo_bench.py            # card
    python3 cslam_tpu_torch/tools/distributed_pgo_bench.py --device cpu \\
        --robots 3 --poses 64

One JSON line per row; on the card first the ``nvidia-smi`` name and power
limit.
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
from cslam_tpu_torch.pgo.distributed import (ShardedPoseGraph,  # noqa: E402
                                             distributed_optimize,
                                             make_distributed_step)
from cslam_tpu_torch.tools.harness import card_line, synchronize  # noqa: E402
from cslam_tpu_torch.types import PoseGraphEdge, PoseKey  # noqa: E402
from cslam_tpu_torch.utils.robot_mesh import StackedMesh  # noqa: E402

SIGMAS = np.array([0.01] * 3 + [0.1] * 3)
#: the script's solver keywords
KWARGS = {"lm_iters": 8, "cg_iters": 60}


def circle(robot, n, radius):
    out = {}
    for k in range(n):
        a = 2 * np.pi * k / n
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0],
                     [np.sin(a), np.cos(a), 0], [0, 0, 1.0]]
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.1 * robot]
        out[(robot, k)] = T
    return out


def _between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return se3.between(torch.as_tensor(a, dtype=torch.float32),
                       torch.as_tensor(b, dtype=torch.float32)).numpy()


def build(nb_robots, nb_poses, rng, sep_every, nb_outliers=2,
          noise_scale=0.02):
    """(ground truth, the sharded problem, the same graph centralized,
    genuine separators); the outliers are the last separators."""
    gt = {}
    for r in range(nb_robots):
        gt.update(circle(r, nb_poses, 10.0 + 0.3 * r))
    problem = ShardedPoseGraph(nb_robots)
    central = FactorGraph()
    for r in range(nb_robots):
        cur = gt[(r, 0)]
        problem.add_variable(r, 0, cur)
        central.add_variable((r, 0), cur)
        for k in range(nb_poses - 1):
            z = _between(gt[(r, k)], gt[(r, k + 1)])
            noise = np.eye(4)
            noise[:3, 3] = rng.normal(scale=noise_scale, size=3)
            z = z @ noise
            cur = cur @ z
            problem.add_variable(r, k + 1, cur)
            central.add_variable((r, k + 1), cur)
            problem.add_local_between(r, k, k + 1, z, SIGMAS)
            central.add_between((r, k), (r, k + 1), z, SIGMAS)
    n_sep = 0
    for r in range(nb_robots - 1):
        for k in range(0, nb_poses, sep_every):
            z = _between(gt[(r, k)], gt[(r + 1, k)])
            problem.add_separator(PoseGraphEdge(
                key_from=PoseKey(r, k), key_to=PoseKey(r + 1, k),
                measurement=z, noise_sigmas=SIGMAS))
            central.add_between((r, k), (r + 1, k), z, SIGMAS, robust=True)
            n_sep += 1
    for i in range(nb_outliers):
        bad = np.eye(4)
        bad[:3, 3] = [12.0 + 3 * i, -9.0, 5.0]
        problem.add_separator(PoseGraphEdge(
            key_from=PoseKey(0, 3 + i), key_to=PoseKey(nb_robots - 1, 7 + i),
            measurement=bad, noise_sigmas=SIGMAS))
        central.add_between((0, 3 + i), (nb_robots - 1, 7 + i), bad, SIGMAS,
                            robust=True)
    central.add_prior((0, 0), gt[(0, 0)], SIGMAS)
    return gt, problem, central, n_sep


def ate(est, gt) -> float:
    keys = sorted(set(est) & set(gt))
    errs = [np.linalg.norm(est[k][:3, 3] - gt[k][:3, 3]) for k in keys]
    return float(np.sqrt(np.mean(np.square(errs))))


def set_poses(problem: ShardedPoseGraph, est) -> None:
    """The next round starts from ``est`` (a solve's values)."""
    for g in problem.local_graphs:
        for key, i in g._index.items():
            g._poses[i] = est[key]


def _scores(info, n_sep) -> dict:
    w = info.sep_weights
    return {"sweeps_used": info.sweeps_used,
            "lm_iterations": info.lm_iterations,
            "outliers_rejected": int(np.sum(w[n_sep:n_sep + 2] < 0.01)),
            "false_rejections": int(np.sum(w[:n_sep] < 0.5))}


def _timed_twice(fn, device):
    """(result, seconds) of the second of two calls (the first captures
    on the card)."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def run(robots=8, poses=256, sep_every=16, device=None,
        curve_sweeps=20, emit=print) -> dict:
    """Every row of the script (see the module note); returns the
    summary."""
    device = resolve_device(device)
    gt, problem, central, n_sep = build(robots, poses,
                                        np.random.default_rng(0), sep_every)
    init = {k: central.get_pose(k) for k in gt}
    ate_init = ate(init, gt)

    arrays = central.to_arrays(device=device)
    res, t_central = _timed_twice(lambda: gnc_optimize(arrays), device)
    central_est = {tuple(v.key.as_tuple()): v.pose
                   for v in central.values_from_arrays(res.poses)}
    ate_central = ate(central_est, gt)
    emit(json.dumps({"row": "central", "ate_m": ate_central,
                     "seconds": t_central,
                     "outer_iterations": res.outer_iterations}))

    mesh = StackedMesh(robots, device)
    step = make_distributed_step(mesh, **KWARGS)
    local, sep = problem.to_device_arrays(mesh)
    mu, curve, parity = 0.05, [], None
    for i in range(1, curve_sweeps + 1):
        local = step(local, sep, mu)
        mu = min(mu * 1.6, 1e6)
        a = ate(problem.values_from_arrays(local.poses), gt)
        curve.append(a)
        if parity is None and a < ate_central + 0.05:
            parity = i
    emit(json.dumps({"row": "curve", "ate_m": curve,
                     "parity_sweep": parity}))

    (est, info), t_cold = _timed_twice(lambda: distributed_optimize(
        problem, mesh, sweeps=30, return_info=True, **KWARGS),
        device)
    cold = {"ate_m": ate(est, gt), "seconds": t_cold,
            **_scores(info, n_sep)}
    emit(json.dumps({"row": "solve", **cold}))
    set_poses(problem, est)
    (est_w, info_w), t_warm = _timed_twice(lambda: distributed_optimize(
        problem, mesh, sweeps=30, warm=True,
        carried_weights=info.sep_weight_by_key, return_info=True,
        **KWARGS), device)
    warm = {"ate_m": ate(est_w, gt), "seconds": t_warm,
            **_scores(info_w, n_sep)}
    emit(json.dumps({"row": "warm", **warm}))
    summary = {
        "metric": "distributed_pgo_sweeps_to_centralized_parity",
        "value": parity if parity is not None else -1, "unit": "sweeps",
        "ate_init_m": round(ate_init, 3),
        "ate_central_m": round(ate_central, 3),
        "ate_distributed_m": round(cold["ate_m"], 3),
        "sweeps_used": cold["sweeps_used"],
        "outliers_rejected": cold["outliers_rejected"],
        "false_rejections": cold["false_rejections"],
        "warm_wall_clock_s": round(t_cold, 3),
        "steady_state_sweeps": warm["sweeps_used"],
        "steady_state_wall_clock_s": round(t_warm, 3),
        "steady_state_ate_m": round(warm["ate_m"], 3),
        "steady_state_outliers_rejected": warm["outliers_rejected"],
        "steady_state_false_rejections": warm["false_rejections"],
        "robots": robots, "poses": poses,
        "device": device.type}
    emit(json.dumps(summary))
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=8)
    ap.add_argument("--poses", type=int, default=256)
    ap.add_argument("--sep-every", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    run(args.robots, args.poses, args.sep_every, device,
        emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

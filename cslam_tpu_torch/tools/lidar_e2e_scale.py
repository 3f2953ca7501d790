#!/usr/bin/env python3
"""Lidar swarm end to end at scale: 5 robots x 210 keyframes.

The port's twin of ``benchmarks/lidar_e2e_scale_bench.py``, with its world,
its per-robot config pins and its flags. It drives the full node stack —
``LidarFrontEnd`` (voxel downsampling, odometry keyframe gating),
``DetectionFrontEnd`` (scan context, the scan-context banks, gossip, MAC
selection, the broker), verification (multi-start robust ICP, one CUDA
graph per pair tier), ``DecentralizedPGO`` (GNC-TLS) — for ``--robots``
robots walking a shared loop of 40 structured scenes (walls, ground,
pillars) with drifting odometry. The port's one addition: the scan-context
banks run their fused stage 1 (K1 on the augmented ring keys, exact, from
a capacity of 4096) on the card.

    python3 cslam_tpu_torch/tools/lidar_e2e_scale.py          # card, 5 x 210
    python3 cslam_tpu_torch/tools/lidar_e2e_scale.py --device cpu --sync \\
        --robots 2 --steps 6 --no-warmup

Reports what the bench reports (keyframes, steady wall, kf/s, real-time
factor, verified inter-robot loops, ATE of robot 0 before and after, the
span table) and the port's counters (CUDA graph captures after the warmup
per program set, verification pairs and ICP-gate passes, K1, E1, E2 and
WHILE-node launches, ``mac.fw_dispatch`` and ``pgo.optimize`` seconds) as
one JSON line, after the card's ``nvidia-smi`` name and power limit.
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

from cslam_tpu_torch import resolve_device  # noqa: E402
from cslam_tpu_torch.tools import harness  # noqa: E402


def scene_cloud(seed, n):
    """Structured scene: walls + ground + pillars (pillars pin ICP)."""
    rng = np.random.default_rng(seed)
    a1, a2 = rng.uniform(0, 2 * np.pi, 2)
    d1, d2 = rng.uniform(6, 18, 2)
    n3 = n // 3
    wall1 = np.stack([np.cos(a1) * d1 + rng.uniform(-6, 6, n3),
                      np.sin(a1) * d1 + rng.normal(0, 0.1, n3),
                      rng.uniform(0, 3, n3)], 1)
    wall2 = np.stack([np.cos(a2) * d2 + rng.normal(0, 0.1, n3),
                      np.sin(a2) * d2 + rng.uniform(-6, 6, n3),
                      rng.uniform(0, 2, n3)], 1)
    rest = n - 2 * n3
    ground = np.stack([rng.uniform(-20, 20, rest // 2),
                       rng.uniform(-20, 20, rest // 2),
                       rng.uniform(-0.2, 0.2, rest // 2)], 1)
    m = rest - rest // 2
    centers = rng.uniform(-15, 15, (5, 2))
    which = rng.integers(0, 5, m)
    pillars = np.stack([centers[which, 0] + rng.normal(0, 0.08, m),
                        centers[which, 1] + rng.normal(0, 0.08, m),
                        rng.uniform(0, 4, m)], 1)
    return np.concatenate([wall1, wall2, ground, pillars]).astype(np.float32)


def robot_config(rid, robots, pins=True, sync=False, mac_max_iters=None):
    """The bench's per-robot config (``lidar_e2e_scale_bench.py:122-170``)
    and the fused stage 1 of the scan-context banks."""
    from cslam_tpu_torch.config import CslamConfig
    cfg = CslamConfig(robot_id=rid, max_nb_robots=robots)
    f = cfg.frontend
    f.sensor_type = "lidar"
    f.global_descriptor_technique = "scancontext"
    f.similarity_threshold = 0.7
    f.keyframe_generation_ratio_distance = 0.5
    f.voxel_size = 0.4
    f.registration_min_inliers = 40
    f.scancontext_fused_stage1 = True
    f.bank_initial_capacity = 4096
    harness.pin_config(cfg, pins, sync, mac_max_iters)
    return cfg.flatten()


def _warmup(nodes, robots, steps, points, device) -> None:
    """The tiers this mission can reach, as the bench warms them: the
    scan-context model, the bank's query-batch and multi-bank searches at
    its capacity, the verification graph of each pair tier (1, 2, 4, 8)
    at pad 1024, MAC's selection programs and the back end's GNC tiers."""
    from cslam_tpu_torch.matching.scancontext_bank import warmup_search_tiers
    _, lidar, det, backend = nodes[0]
    det.model.warmup(points)
    cap = int(det.params["frontend.bank_initial_capacity"])
    while cap < steps:
        cap *= 2
    fused = bool(det.params["frontend.scancontext_fused_stage1"])
    warmup_search_tiers(cap, batch_tiers=(1, 2, 4, 8, 16, 32),
                        multi_bank_counts=tuple(range(1, robots)),
                        fused_stage1=fused, device=device)
    lidar.warmup(pair_tiers=(1, 2, 4, 8))
    harness.warm_solvers(det, backend, robots, steps, device)


def run_mission(robots=5, steps=210, scenes=40, points=4096, device=None,
                pins=True, sync=False, dump_dir=None, *, warmup=True,
                drain=60, mac_max_iters=None, log=print) -> dict:
    """The bench's mission on ``device`` (CUDA unless the caller passes
    another): ``robots`` x ``steps`` keyframes of ``points``-point scans of
    ``scenes`` scenes, the bench's tier pins where ``pins``, detection and
    verification in this thread where ``sync``, every aggregate graph
    dumped to ``dump_dir`` (``CSLAM_TPU_DUMP_PGO``) where given. Returns
    the report (:func:`harness.run_nodes`) with the mission's settings,
    ``warmup_s`` and the nodes (``nodes``, not serializable)."""
    from cslam_tpu_torch.runtime import (DecentralizedPGO, DetectionFrontEnd,
                                         LidarFrontEnd, MessageBus,
                                         RobotContext, VirtualClock)
    from cslam_tpu_torch.types import Odometry
    device = resolve_device(device)
    bus, clock = MessageBus(), VirtualClock()
    nodes = []
    for rid in range(robots):
        ctx = RobotContext(bus, clock, rid, robot_config(
            rid, robots, pins, sync, mac_max_iters))
        nodes.append((ctx, LidarFrontEnd(ctx, device=device),
                      DetectionFrontEnd(ctx, device=device),
                      DecentralizedPGO(ctx, synchronous_optimization=True,
                                       device=device)))
    scene_pose = harness.scene_grid(scenes)
    world = [scene_cloud(1000 + s, points) @ p[:3, :3].T + p[:3, 3]
             for s, p in enumerate(scene_pose)]
    rng = np.random.default_rng(3)
    gt, drifted = harness.drift_tracks(
        robots, steps, scene_pose,
        lambda r: harness.pose_xyz_yaw(0.3 * r, 0.2 * r, 0.0, 0.1 * r), rng)

    def intake(r, i):
        s, pose = gt[r][i]
        inv = np.linalg.inv(pose)
        pts = world[s] @ inv[:3, :3].T + inv[:3, 3]
        scan = (pts + rng.normal(scale=0.03, size=pts.shape)).astype(
            np.float32)
        nodes[r][1].lidar_callback(scan, Odometry(pose=drifted[r][i]))

    t0 = time.perf_counter()
    if warmup:
        _warmup(nodes, robots, steps, points, device)
        harness.synchronize(device)
    warm_s = time.perf_counter() - t0
    log(f"# warmup {warm_s:.1f} s")
    out = {"robots": robots, "steps": steps, "scenes": scenes,
           "points": points, "device": device.type, "pins": pins,
           "sync": sync, "drain_steps": drain, "warmup_s": warm_s}
    out.update(harness.run_nodes(nodes, bus, clock, steps, intake, gt,
                                 drifted, device, drain, dump_dir, log))
    out["nodes"] = nodes
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=5)
    ap.add_argument("--steps", type=int, default=210,
                    help="keyframes per robot (total = robots * steps)")
    ap.add_argument("--scenes", type=int, default=40,
                    help="distinct places in the shared world loop")
    ap.add_argument("--points", type=int, default=4096,
                    help="raw points per scan before voxel downsampling")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup (captures then happen mid-mission)")
    ap.add_argument("--no-pins", action="store_true",
                    help="the config's default tier floors")
    ap.add_argument("--sync", action="store_true",
                    help="detection and verification in the caller's thread")
    ap.add_argument("--dump-loops", default=None, metavar="PATH",
                    help="write the verified inter-robot loops (sorted edge "
                         "keys) to PATH")
    ap.add_argument("--dump-g2o", default=None, metavar="BASE",
                    help="write BASE_optimized.g2o (every robot's odometry "
                         "factors, the verified inter-robot loops, the final "
                         "estimates)")
    ap.add_argument("--mac-max-iters", type=int, default=None,
                    help="override the Frank-Wolfe iteration budget")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(harness.card_line(), flush=True)
    out = run_mission(args.robots, args.steps, args.scenes, args.points,
                      device, pins=not args.no_pins, sync=args.sync,
                      warmup=not args.no_warmup,
                      mac_max_iters=args.mac_max_iters,
                      log=lambda line: print(line, flush=True))
    nodes = out.pop("nodes")
    be0 = nodes[0][3]
    if args.dump_loops:
        with open(args.dump_loops, "w") as f:
            f.write("\n".join(harness.loop_keys(be0)) + "\n")
    if args.dump_g2o:
        from cslam_tpu_torch.evaluation.g2o import write_g2o
        factors = [e for n in nodes for e in n[3].local_factors]
        for edges in be0.inter_robot_loop_closures.values():
            factors.extend(edges)
        write_g2o(f"{args.dump_g2o}_optimized.g2o",
                  dict(be0.current_pose_estimates), factors)
    print(f"# {out['total_keyframes']} keyframes in "
          f"{out['steady_wall_clock_s']:.1f} s = "
          f"{out['keyframes_per_s']:.2f} kf/s, loops "
          f"{out['inter_robot_loops']}, ATE robot 0 "
          f"{out['ate_odometry_m']:.3f} -> {out['ate_optimized_m']:.3f} m")
    print(json.dumps({"metric": "lidar_e2e_keyframes_per_sec",
                      "value": out["keyframes_per_s"], "unit": "kf/s",
                      **{k: v for k, v in out.items() if k != "spans"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Visual (RGB-D) swarm end to end at scale: 5 robots x 210 keyframes.

The port's twin of ``benchmarks/visual_e2e_scale_bench.py``, with its
rendered world, its per-robot config pins and its flags. It drives the
full node stack — ``RGBDFrontEnd`` (the port's C++ FAST-9 + steered BRIEF,
keyframe publication, compressed descriptor exchange), CosPlace global
descriptors (the seeded golden weights) through ``DetectionFrontEnd``
(descriptor banks on K1, gossip, MAC selection, the broker), batched GNC
verification (one CUDA graph per pair tier), ``DecentralizedPGO`` — for
``--robots`` robots revisiting a shared loop of 40 rendered scenes with
drifting odometry. ``sensor="stereo"`` renders a second view 0.2 m to the
right and runs ``StereoFrontEnd`` instead (``make_map_manager``).

Untrained GeM features separate scenes only by global appearance, so the
scenes carry distinct ambient levels and texture bands and the similarity
threshold is high; cross-scene candidates that slip through are rejected
by geometric verification.

    python3 cslam_tpu_torch/tools/visual_e2e_scale.py         # card, 5 x 210
    python3 cslam_tpu_torch/tools/visual_e2e_scale.py --device cpu --sync \\
        --robots 2 --steps 6 --no-warmup

Reports as ``tools/lidar_e2e_scale.py`` does, as one JSON line after the
card's ``nvidia-smi`` name and power limit.
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

W, H = 320, 240
CAM = {"fx": 300.0, "fy": 300.0, "cx": 160.0, "cy": 120.0}
BASELINE = 0.2      # the stereo variant's second view, m


def make_scene(seed, n=None, size=(W, H)):
    """Textured landmark field with a scene-distinct global appearance
    (background ramp, ambient level, texture band, stamp size and count):
    untrained GeM pooling separates global statistics, not layout.
    Returns (points, textures, background of ``size`` = (width, height),
    half stamp size)."""
    rng = np.random.default_rng(seed)
    if n is None:
        n = int(rng.integers(60, 220))
    pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 11, n)], axis=1)
    a0, a1 = rng.integers(0, 150, 2)  # vertical background ramp
    width, height = size
    bg = ((a0 + (a1 - a0) * np.linspace(0, 1, height))[:, None]
          * np.ones((1, width)))
    lo = int(rng.integers(30, 150))
    hi = lo + int(rng.integers(40, 105))
    half = int(rng.integers(3, 8))
    tex = rng.integers(lo, hi, (n, 2 * half + 1, 2 * half + 1),
                       dtype=np.int64)
    return pts, tex, bg.astype(np.uint8), half


def render(scene, pose, cam=None):
    """Painter's-algorithm stamp render in the camera at ``pose`` (``cam``:
    fx, fy, cx, cy; the bench's by default) at the size of the scene's
    background; returns (grayscale image, metric depth)."""
    pts, tex, bg, half = scene
    fx, fy, cx, cy = ((cam or CAM)[k] for k in ("fx", "fy", "cx", "cy"))
    height, width = bg.shape
    img = bg.copy()
    dep = np.zeros((height, width), np.float32)
    inv = np.linalg.inv(pose)
    cpts = pts @ inv[:3, :3].T + inv[:3, 3]
    for i in np.argsort(-cpts[:, 2]):
        x, y, z = cpts[i]
        if z < 0.5:
            continue
        u = int(round(fx * x / z + cx))
        v = int(round(fy * y / z + cy))
        if not (20 <= u < width - 20 and 20 <= v < height - 20):
            continue
        img[v - half:v + half + 1, u - half:u + half + 1] = \
            tex[i].astype(np.uint8)
        dep[v - half:v + half + 1, u - half:u + half + 1] = z
    return img, dep


def robot_config(rid, robots, pins=True, sync=False, warmup=True,
                 threshold=0.998, sensor="rgbd"):
    """The bench's per-robot config (``visual_e2e_scale_bench.py:134-160``:
    CosPlace ResNet18 + GeM, fc 64, crop 224, the port's seeded golden
    weights)."""
    from cslam_tpu_torch.config import CslamConfig
    cfg = CslamConfig(robot_id=rid, max_nb_robots=robots)
    f = cfg.frontend
    f.sensor_type = sensor
    f.global_descriptor_technique = "cosplace"
    f.nn_checkpoint = "random"
    f.image_crop_size = 224
    f.similarity_threshold = threshold
    f.keyframe_generation_ratio_threshold = 1.0
    f.pnp_min_inliers = 10
    f.warmup_verification_tiers = (1, 2, 4, 8, 16) if warmup else ()
    harness.pin_config(cfg, pins, sync)
    return cfg.flatten()


def _warmup(nodes, robots, steps, frame, device) -> None:
    """The tiers this mission can reach, as the bench warms them (the
    verification tiers are warmed by the front ends' constructors): the
    embedding (twice), the descriptor bank's batch, k and multi-bank
    searches, MAC's selection programs and the back end's GNC tiers."""
    from cslam_tpu_torch.matching.nns_bank import warmup_bank_tiers
    det, backend = nodes[0][2], nodes[0][3]
    for _ in range(2):
        det.model.compute_embedding(frame)
    dim = int(det.params.get("frontend.cosplace.descriptor_dim", 64))
    kv = (1, int(det.params["frontend.nb_best_matches"]))
    cap = 1024
    while cap < steps:
        cap *= 2
    for c in {1024, cap}:
        warmup_bank_tiers(c, dim, batch_tiers=(1, 2, 4, 8, 16, 32, 64, 128,
                                               256),
                          multi_bank_counts=tuple(range(1, robots)),
                          k_values=kv, device=device)
    harness.warm_solvers(det, backend, robots, steps, device)


def run_mission(robots=5, steps=210, scenes=40, device=None, pins=True,
                sync=False, dump_dir=None, *, warmup=True, drain=60,
                threshold=0.998, sensor="rgbd", log=print) -> dict:
    """The bench's mission on ``device`` (CUDA unless the caller passes
    another): ``robots`` x ``steps`` rendered 320 x 240 frames of
    ``scenes`` scenes, every frame a keyframe, with ``sensor`` "rgbd" or
    "stereo"; ``pins``, ``sync`` and ``dump_dir`` as in
    ``tools/lidar_e2e_scale.run_mission``. Returns the report
    (:func:`harness.run_nodes`) with the settings, ``warmup_s``,
    ``native_available`` (the C++ feature library loaded) and the nodes
    (``nodes``, not serializable)."""
    from cslam_tpu_torch import native
    from cslam_tpu_torch.runtime import (CameraModel, DecentralizedPGO,
                                         DetectionFrontEnd, MessageBus,
                                         RobotContext, VirtualClock,
                                         make_map_manager)
    from cslam_tpu_torch.types import Odometry
    from cslam_tpu_torch.utils import profiling
    device = resolve_device(device)
    cam = CameraModel(**CAM, baseline=BASELINE)
    bus, clock = MessageBus(), VirtualClock()
    nodes = []
    for rid in range(robots):
        ctx = RobotContext(bus, clock, rid, robot_config(
            rid, robots, pins, sync, warmup, threshold, sensor))
        nodes.append((ctx, make_map_manager(ctx, cam, device=device),
                      DetectionFrontEnd(ctx, device=device),
                      DecentralizedPGO(ctx, synchronous_optimization=True,
                                       device=device)))
    scene_pose = harness.scene_grid(scenes)
    world = []
    for s in range(scenes):
        pts, tex, bg, half = make_scene(1000 + s)
        # landmarks live in the scene's world cell
        pts = pts @ scene_pose[s][:3, :3].T + scene_pose[s][:3, 3]
        world.append((pts, tex, bg, half))
    rng = np.random.default_rng(3)
    gt, drifted = harness.drift_tracks(
        robots, steps, scene_pose,
        lambda r: harness.pose_xyz_yaw(0.25 * r, 0.15 * r, 0.1 * r, 0.06 * r),
        rng)

    right = harness.pose_xyz_yaw(BASELINE, 0.0)

    def intake(r, i):
        s, pose = gt[r][i]
        fe = nodes[r][1]
        with profiling.span("rgbd.render"):
            img, dep = render(world[s], pose)
            if sensor == "stereo":      # (left, right) for the callback
                dep = render(world[s], pose @ right)[0]
        intake_fn = (fe.stereo_callback if sensor == "stereo"
                     else fe.rgbd_callback)
        intake_fn(np.stack([img] * 3, axis=-1), dep,
                  Odometry(pose=drifted[r][i]))

    native_available = native.available()      # builds the library once
    t0 = time.perf_counter()
    if warmup:
        frame = render(world[0], scene_pose[0])[0]
        _warmup(nodes, robots, steps, np.stack([frame] * 3, axis=-1),
                device)
        harness.synchronize(device)
    warm_s = time.perf_counter() - t0
    log(f"# warmup {warm_s:.1f} s")
    out = {"robots": robots, "steps": steps, "scenes": scenes,
           "frame": f"{W}x{H}", "sensor": sensor,
           "front_end": type(nodes[0][1]).__name__, "device": device.type,
           "pins": pins, "sync": sync, "drain_steps": drain,
           "similarity_threshold": threshold,
           "native_available": native_available, "warmup_s": warm_s}
    out.update(harness.run_nodes(nodes, bus, clock, steps, intake, gt,
                                 drifted, device, drain, dump_dir, log))
    out["nodes"] = nodes
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=5)
    ap.add_argument("--steps", type=int, default=210,
                    help="frames per robot (every frame becomes a keyframe)")
    ap.add_argument("--scenes", type=int, default=40,
                    help="distinct places in the shared world loop")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--no-pins", action="store_true",
                    help="the config's default tier floors")
    ap.add_argument("--sync", action="store_true",
                    help="detection and verification in the caller's thread")
    ap.add_argument("--stereo", action="store_true",
                    help="rendered stereo pairs through StereoFrontEnd")
    ap.add_argument("--dump-loops", default=None, metavar="PATH")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(harness.card_line(), flush=True)
    out = run_mission(args.robots, args.steps, args.scenes, device,
                      pins=not args.no_pins, sync=args.sync,
                      warmup=not args.no_warmup,
                      sensor="stereo" if args.stereo else "rgbd",
                      log=lambda line: print(line, flush=True))
    nodes = out.pop("nodes")
    if args.dump_loops:
        with open(args.dump_loops, "w") as f:
            f.write("\n".join(harness.loop_keys(nodes[0][3])) + "\n")
    print(f"# {out['total_keyframes']} keyframes in "
          f"{out['steady_wall_clock_s']:.1f} s = "
          f"{out['keyframes_per_s']:.2f} kf/s, loops "
          f"{out['inter_robot_loops']}, ATE robot 0 "
          f"{out['ate_odometry_m']:.3f} -> {out['ate_optimized_m']:.3f} m")
    print(json.dumps({"metric": "visual_e2e_keyframes_per_sec",
                      "value": out["keyframes_per_s"], "unit": "kf/s",
                      **{k: v for k, v in out.items() if k != "spans"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The lidar path end to end in both packages, on the CPU: the two-robot
pipeline of ``tests/test_lidar_e2e.py`` (point clouds -> voxel keyframes ->
ScanContext detection -> MAC selection -> robust verification -> PGO over
the in-process bus) run once by the JAX package and once by the port, with
``frontend.async_detection`` and ``frontend.async_verification`` off (the
JAX package's async harvest timing depends on its dispatch threads).

Limits: the same keyframes, bank contents, fixed edges and verified
inter-robot loop closures; loop-closure transforms within 1e-3 rad and
1e-2 m; robot 0's ATE within 1e-3 m of the reference's.
"""
import importlib
import math

import numpy as np
import pytest

from test_lidar_e2e import scene_cloud
from torch_threads import one_torch_thread  # noqa: F401

ATE_TOL = 1e-3


def _pose_at(x, y, yaw=0.0):
    T = np.eye(4)
    T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0],
                 [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]]
    T[:3, 3] = [x, y, 0]
    return T


def _gt_pose(robot_id, kf_id):
    if robot_id == 0:
        return _pose_at(5 * kf_id, 0.0)
    return _pose_at(5 * kf_id + 0.8, 0.6, yaw=0.4)


def _run(pkg: str) -> dict:
    """The reference test's mission through package ``pkg``'s nodes."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    port = pkg == "cslam_tpu_torch"
    dev = {"device": "cpu"} if port else {}
    bus_mod, clock_mod = mod("runtime.bus"), mod("runtime.clock")
    bus, clock = bus_mod.MessageBus(), clock_mod.VirtualClock()
    robots = []
    for rid in range(2):
        cfg = mod("config").CslamConfig(robot_id=rid, max_nb_robots=2)
        cfg.frontend.sensor_type = "lidar"
        cfg.frontend.global_descriptor_technique = "scancontext"
        cfg.frontend.similarity_threshold = 0.7
        cfg.frontend.keyframe_generation_ratio_distance = 0.5
        cfg.frontend.voxel_size = 0.4
        cfg.frontend.registration_min_inliers = 40
        cfg.frontend.inter_robot_detection_period_sec = 3.0
        cfg.frontend.detection_publication_period_sec = 1.0
        cfg.frontend.async_detection = False
        cfg.frontend.async_verification = False
        cfg.backend.pose_graph_optimization_start_period_ms = 4000
        cfg.neighbor_management.enable_neighbor_monitoring = False
        cfg.evaluation.enable_gps_recording = True
        ctx = bus_mod.RobotContext(bus, clock, rid, cfg.flatten())
        robots.append((
            ctx, mod("runtime.lidar_frontend").LidarFrontEnd(ctx, **dev),
            mod("runtime.lcd_node").DetectionFrontEnd(ctx, **dev),
            mod("runtime.backend_node").DecentralizedPGO(
                ctx, synchronous_optimization=True, **dev)))
    Odometry = mod("types").Odometry
    rng = np.random.default_rng(0)

    def observe(scene, pose):
        inv = np.linalg.inv(pose)
        pts = scene @ inv[:3, :3].T + inv[:3, 3]
        return pts + rng.normal(scale=0.03, size=pts.shape)

    def cycle():
        clock.advance(0.25)
        for ctx, *_ in robots:
            ctx.poll_timers()
        bus.deliver()

    for i, scene in enumerate([scene_cloud(s) for s in range(6)]):
        bus.publish("/r0/gps/fix", (45.5 + 0.001 * i, -73.6))
        bus.publish("/r1/gps/fix", (45.5 + 0.001 * i, -73.601))
        bus.deliver()
        for rid in range(2):
            pose = _gt_pose(rid, i)
            robots[rid][1].lidar_callback(observe(scene, pose),
                                          Odometry(pose=pose))
        for _ in range(4):
            cycle()
    for _ in range(60):
        cycle()

    det0, be0 = robots[0][2], robots[0][3]
    loops = {}
    for edges in be0.inter_robot_loop_closures.values():
        for e in edges:
            loops[(e.key_from.robot_id, e.key_from.keyframe_id,
                   e.key_to.robot_id, e.key_to.keyframe_id)] = np.asarray(
                e.measurement, np.float64)
    est = {k[1]: p for k, p in be0.current_pose_estimates.items()
           if k[0] == 0}
    ate = math.sqrt(np.mean([np.sum((p[:3, 3] - _gt_pose(0, k)[:3, 3]) ** 2)
                             for k, p in est.items()]))
    return {
        "keyframes": [r[1].nb_local_keyframes for r in robots],
        "bank_items": [det0.lcm.local_nnsm.nb_items,
                       det0.lcm.other_robots_nnsm[1].nb_items],
        "gps": [be0.gps_data[k] for k in sorted(be0.gps_data)],
        "fixed": sorted(e.key() for e in
                        det0.lcm.candidate_selector.fixed_edges),
        "loops": loops, "ate": ate, "estimates": len(est),
        "optimizations": be0.optimization_count,
    }


@pytest.fixture(scope="module")
def runs():
    return _run("cslam_tpu"), _run("cslam_tpu_torch")


def test_keyframes_gossip_and_gps_match(runs):
    ref, port = runs
    assert port["keyframes"] == ref["keyframes"] == [6, 6]
    assert port["bank_items"] == ref["bank_items"]
    assert port["gps"] == ref["gps"] and len(port["gps"]) == 6
    assert port["gps"][0] == (45.5, -73.6)
    assert port["estimates"] == ref["estimates"] == 6


def test_fixed_edges_match(runs):
    ref, port = runs
    assert port["fixed"] == ref["fixed"]
    assert len(port["fixed"]) >= 1


def test_verified_loop_closures_match(runs):
    ref, port = runs
    assert sorted(port["loops"]) == sorted(ref["loops"])
    assert len(port["loops"]) >= 1
    for key, Z in port["loops"].items():
        Zr = ref["loops"][key]
        dR = Z[:3, :3].T @ Zr[:3, :3]
        angle = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1) / 2)))
        assert angle <= 1e-3 and np.abs(Z[:3, 3] - Zr[:3, 3]).max() <= 1e-2
        # and metrically sane against ground truth (the reference's bar)
        gt = np.linalg.inv(_gt_pose(key[0], key[1])) @ _gt_pose(key[2],
                                                                key[3])
        assert np.linalg.norm(Z[:3, 3] - gt[:3, 3]) < 0.3


def test_ate_matches_reference(runs):
    ref, port = runs
    assert port["optimizations"] > 0 and ref["optimizations"] > 0
    assert abs(port["ate"] - ref["ate"]) <= ATE_TOL

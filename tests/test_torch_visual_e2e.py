"""The visual path end to end in both packages, on the CPU: two robots
revisit rendered scenes (``benchmarks/visual_e2e_scale_bench.py``'s, as
``tools/visual_e2e_scale.py`` draws them; its per-robot config at the
config's tier floors) with drifting odometry, and each package runs
``RGBDFrontEnd`` (or, with ``frontend.sensor_type: stereo``, the
``StereoFrontEnd`` that ``make_map_manager`` builds, on rendered stereo
pairs with a 0.2 m baseline) -> ``DetectionFrontEnd`` (CosPlace ResNet18 +
GeM, the visual bank) -> ``DecentralizedPGO`` over its in-process bus, with
``frontend.async_detection`` off (the JAX package's async harvest timing
depends on its dispatch threads). CosPlace runs at a 64-pixel crop to stay
cheap; the JAX package's flax ``PRNGKey(0)`` variables are carried into the
port by ``cosplace_state_dict_from_jax``.

Limits: the same keyframes, descriptors within cosine 0.9999, the same
fixed edges and verified inter-robot loop closures (their transforms
within 1e-3 rad and 1e-3 m), robot 0's ATE within 1e-3 m of the
reference's.
"""
import importlib
import math

import numpy as np
import pytest

from chip_smoke import _pose_xyz_yaw, _vis_render, _vis_scene
from cslam_tpu_torch.tools.visual_e2e_scale import robot_config
from torch_threads import one_torch_thread  # noqa: F401

ROBOTS, STEPS, SCENES = 2, 8, 4
BASELINE = 0.2
ATE_TOL = 1e-3


def _mission():
    """Ground truth and drifted odometry of the bench's mission at
    ``ROBOTS`` x ``STEPS`` over ``SCENES`` scenes, and its frames: (RGB,
    depth, right image of the stereo pair)."""
    scene_pose = [_pose_xyz_yaw(7.0 * s, 0.0) for s in range(SCENES)]
    world = []
    for s in range(SCENES):
        pts, tex, bg, half = _vis_scene(1000 + s)
        world.append((pts @ scene_pose[s][:3, :3].T + scene_pose[s][:3, 3],
                      tex, bg, half))
    rng = np.random.default_rng(3)
    gt, drifted, frames = {}, {}, {}
    for r in range(ROBOTS):
        gt[r], drifted[r], cur = [], [], None
        for i in range(STEPS):
            s = (i + r) % SCENES
            p = scene_pose[s] @ _pose_xyz_yaw(0.25 * r, 0.15 * r, 0.1 * r,
                                              yaw=0.06 * r)
            gt[r].append(p)
            if cur is None:
                cur = p.copy()
            else:
                z = np.linalg.inv(gt[r][i - 1]) @ p
                z[:3, 3] += rng.normal(scale=0.05, size=3)
                cur = cur @ z
            drifted[r].append(cur.copy())
            img, dep = _vis_render(world[s], p)
            right, _ = _vis_render(world[s],
                                   p @ _pose_xyz_yaw(BASELINE, 0.0))
            frames[(r, i)] = (np.stack([img] * 3, axis=-1), dep, right)
    return gt, drifted, frames


def _run(pkg, sensor, mission, variables=None):
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    port = pkg == "cslam_tpu_torch"
    dev = {"device": "cpu"} if port else {}
    gt, drifted, frames = mission
    bus_mod = mod("runtime.bus")
    bus, clock = bus_mod.MessageBus(), mod("runtime.clock").VirtualClock()
    cam = mod("runtime.rgbd_frontend").CameraModel(
        fx=300.0, fy=300.0, cx=160.0, cy=120.0, baseline=BASELINE)
    robots, model = [], None
    for rid in range(ROBOTS):
        params = robot_config(rid, ROBOTS, pins=False)
        params.update({"frontend.sensor_type": sensor,
                       "frontend.image_crop_size": 64,
                       "frontend.warmup_verification_tiers": (),
                       "frontend.async_detection": False})
        if port:
            from cslam_tpu_torch.convert import cosplace_state_dict_from_jax
            from cslam_tpu_torch.models.cosplace import CosPlace
            model = model or CosPlace(
                params, cosplace_state_dict_from_jax(variables), **dev)
        ctx = bus_mod.RobotContext(bus, clock, rid, params)
        robots.append((ctx, mod("runtime.map_manager").make_map_manager(
                           ctx, cam, **dev),
                       mod("runtime.lcd_node").DetectionFrontEnd(
                           ctx, model=model, **dev),
                       mod("runtime.backend_node").DecentralizedPGO(
                           ctx, synchronous_optimization=True, **dev)))
    Odometry = mod("types").Odometry
    for i in range(STEPS):
        for r in range(ROBOTS):
            rgb, dep, right = frames[(r, i)]
            odom = Odometry(pose=drifted[r][i])
            if sensor == "stereo":
                robots[r][1].stereo_callback(rgb, right, odom)
            else:
                robots[r][1].rgbd_callback(rgb, dep, odom)
        clock.advance(1.0)
        for ctx, *_ in robots:
            ctx.poll_timers()
        bus.deliver()
    for _ in range(40):
        clock.advance(1.0)
        for ctx, *_ in robots:
            ctx.poll_timers()
        bus.deliver()
    det0, be0 = robots[0][2], robots[0][3]
    loops = {}
    for edges in be0.inter_robot_loop_closures.values():
        for e in edges:
            loops[(e.key_from.robot_id, e.key_from.keyframe_id,
                   e.key_to.robot_id, e.key_to.keyframe_id)] = np.asarray(
                e.measurement, np.float64)
    est = {k[1]: p for k, p in be0.current_pose_estimates.items()
           if k[0] == 0}
    ate = math.sqrt(np.mean([np.sum((p[:3, 3] - gt[0][k][:3, 3]) ** 2)
                             for k, p in est.items()]))
    return {
        "front_end": type(robots[0][1]).__name__,
        "keyframes": [r[1].nb_local_keyframes for r in robots],
        "fixed": sorted(e.key() for e in
                        det0.lcm.candidate_selector.fixed_edges),
        "loops": loops, "ate": ate, "estimates": len(est),
        "optimizations": be0.optimization_count,
        "descriptor": np.asarray(det0.model.compute_embedding(
            frames[(0, 0)][0]), np.float64),
        "variables": None if port else det0.model.variables,
    }


@pytest.fixture(scope="module")
def mission():
    return _mission()


@pytest.fixture(scope="module", params=["rgbd", "stereo"])
def runs(request, mission):
    ref = _run("cslam_tpu", request.param, mission)
    return ref, _run("cslam_tpu_torch", request.param, mission,
                     ref["variables"])


def test_keyframes_and_descriptors_match(runs):
    ref, port = runs
    assert port["front_end"] == ref["front_end"]
    assert port["keyframes"] == ref["keyframes"] == [STEPS] * ROBOTS
    assert port["estimates"] == ref["estimates"] == STEPS
    a, b = port["descriptor"], ref["descriptor"]
    assert a.shape == b.shape == (64,)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999


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
        assert angle <= 1e-3 and np.abs(Z[:3, 3] - Zr[:3, 3]).max() <= 1e-3


def test_ate_matches_reference(runs):
    ref, port = runs
    assert port["optimizations"] > 0 and ref["optimizations"] > 0
    assert abs(port["ate"] - ref["ate"]) <= ATE_TOL

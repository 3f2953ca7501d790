"""In-process multi-robot swarm simulator.

Replaces the reference's external integration-test repo (tests/README.md:4
points at ``cslam_tests``) with a deterministic, dependency-free harness: N
robots — each a (sensor front end, detection front end, PGO back end) triple,
exactly the reference's three-process layout — share one message bus and one
virtual clock. A synthetic world provides stable per-place descriptors and
ground-truth poses, so geometric verification can run from ground truth
(SURVEY.md §7's minimum slice) while the full detection/gossip/PGO planes are
exercised for real.

The port's twin of ``cslam_tpu/runtime/simulator.py``: the same world,
trajectories, sensor stand-in and node wiring, with every robot's
detection and back-end nodes on one torch device (``device``: CUDA unless
the caller passes another).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.config import CslamConfig
from cslam_tpu_torch.runtime.backend_node import DecentralizedPGO
from cslam_tpu_torch.runtime.bus import MessageBus, RobotContext
from cslam_tpu_torch.runtime.clock import VirtualClock
from cslam_tpu_torch.runtime.lcd_node import DetectionFrontEnd
from cslam_tpu_torch.types import (InterRobotLoopClosure, KeyframeOdom,
                             KeyframeRGB, LocalDescriptorsRequest, Odometry)


class IdentityDescriptorModel:
    """Pass-through 'model': keyframe data already is the descriptor
    (analogous to the reference's 'disable' testing mode, but deterministic)."""

    def compute_embedding(self, keyframe) -> np.ndarray:
        return np.asarray(keyframe, np.float64)


@dataclass
class SimKeyframe:
    gt_pose: np.ndarray
    place_id: Optional[int]


@dataclass
class SimLocalDescriptors:
    """Simulated local-feature payload: ground truth stands in for the
    keypoint data of ``LocalImageDescriptors`` until a real visual front end
    supplies features."""

    keyframe_id: int
    robot_id: int
    gt_pose: np.ndarray
    place_id: Optional[int]
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)


class SyntheticWorld:
    """Shared set of places with stable descriptors."""

    def __init__(self, nb_places: int, descriptor_dim: int = 32,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        codes = rng.normal(size=(nb_places, descriptor_dim))
        self.place_codes = codes / np.linalg.norm(codes, axis=1,
                                                  keepdims=True)
        self.descriptor_dim = descriptor_dim
        self._rng = rng

    def observe(self, place_id: Optional[int],
                noise: float = 0.02) -> np.ndarray:
        if place_id is None:
            d = self._rng.normal(size=self.descriptor_dim)
        else:
            d = (self.place_codes[place_id]
                 + self._rng.normal(scale=noise, size=self.descriptor_dim))
        return d / np.linalg.norm(d)


class SimulatedSensorFrontEnd:
    """Sensor front end fed by a scripted trajectory.

    Emits keyframes (descriptor data + noisy odometry chain) on a timer, and
    serves descriptor requests / geometric verification from ground truth:
    candidates pointing at the same world place verify successfully with the
    true relative pose (+ measurement noise); others fail — driving the
    promote/demote logic exactly like the reference's RANSAC/TEASER stage.
    """

    def __init__(self, ctx, world: SyntheticWorld,
                 trajectory: Sequence[SimKeyframe],
                 keyframe_period: float = 1.0, odom_noise: float = 0.01,
                 verification_noise: float = 0.005, seed: int = 0):
        self.ctx = ctx
        self.world = world
        self.robot_id = ctx.params["robot_id"]
        self.trajectory = list(trajectory)
        self.keyframes: List[SimKeyframe] = []
        self._cursor = 0
        self._rng = np.random.default_rng(seed + 100 * self.robot_id)
        self.odom_noise = odom_noise
        self.verification_noise = verification_noise
        self._odom_pose = None

        self.keyframe_data_publisher = ctx.create_publisher(
            "cslam/keyframe_data")
        self.keyframe_odom_publisher = ctx.create_publisher(
            "cslam/keyframe_odom")
        self.descriptors_publisher = ctx.create_publisher(
            "/cslam/local_descriptors")
        ctx.create_subscription("cslam/local_descriptors_request",
                                self.on_descriptors_request)
        ctx.create_subscription("/cslam/local_descriptors",
                                self.on_local_descriptors)
        ctx.create_subscription("cslam/local_keyframe_match",
                                self.on_local_keyframe_match)
        self.inter_lc_publisher = ctx.create_publisher(
            "/cslam/inter_robot_loop_closure")
        self.intra_lc_publisher = ctx.create_publisher(
            "cslam/intra_robot_loop_closure")
        ctx.create_timer(keyframe_period, self.emit_keyframe)

    # ------------------------------------------------------------------

    def _noisy_odom_step(self, prev_gt: np.ndarray,
                         cur_gt: np.ndarray) -> np.ndarray:
        rel = np.linalg.inv(prev_gt) @ cur_gt
        noise = np.eye(4)
        noise[:3, 3] = self._rng.normal(scale=self.odom_noise, size=3)
        return rel @ noise

    def emit_keyframe(self) -> None:
        if self._cursor >= len(self.trajectory):
            return
        kf = self.trajectory[self._cursor]
        kf_id = self._cursor
        self._cursor += 1
        self.keyframes.append(kf)

        if self._odom_pose is None:
            self._odom_pose = kf.gt_pose.copy()
        else:
            prev = self.keyframes[-2]
            self._odom_pose = self._odom_pose @ self._noisy_odom_step(
                prev.gt_pose, kf.gt_pose)

        descriptor = self.world.observe(kf.place_id)
        self.keyframe_data_publisher.publish(
            KeyframeRGB(id=kf_id, image=descriptor))
        self.keyframe_odom_publisher.publish(KeyframeOdom(
            id=kf_id,
            odom=Odometry(pose=self._odom_pose.copy(),
                          stamp=self.ctx.clock.now())))

    # ------------------------------------------------------------------
    # Verification plane (ground-truth stand-in for RANSAC/TEASER)
    # ------------------------------------------------------------------

    def on_descriptors_request(self, request: LocalDescriptorsRequest) -> None:
        if request.keyframe_id >= len(self.keyframes):
            return
        kf = self.keyframes[request.keyframe_id]
        self.descriptors_publisher.publish(SimLocalDescriptors(
            keyframe_id=request.keyframe_id, robot_id=self.robot_id,
            gt_pose=kf.gt_pose, place_id=kf.place_id,
            matches_robot_id=list(request.matches_robot_id),
            matches_keyframe_id=list(request.matches_keyframe_id)))

    def on_local_keyframe_match(self, msg) -> None:
        """Intra-robot verification from ground truth (the lidar/rgbd
        front ends do this with real registration)."""
        from cslam_tpu_torch.types import IntraRobotLoopClosure
        if (msg.keyframe0_id >= len(self.keyframes)
                or msg.keyframe1_id >= len(self.keyframes)):
            return
        a = self.keyframes[msg.keyframe0_id]
        b = self.keyframes[msg.keyframe1_id]
        success = (a.place_id is not None and a.place_id == b.place_id)
        transform = None
        if success:
            transform = np.linalg.inv(a.gt_pose) @ b.gt_pose
        self.intra_lc_publisher.publish(IntraRobotLoopClosure(
            keyframe0_id=msg.keyframe0_id, keyframe1_id=msg.keyframe1_id,
            success=success, transform=transform))

    def on_local_descriptors(self, msg) -> None:
        if not isinstance(msg, SimLocalDescriptors):
            return
        for rid, kf_id in zip(msg.matches_robot_id, msg.matches_keyframe_id):
            if rid != self.robot_id or kf_id >= len(self.keyframes):
                continue
            local = self.keyframes[kf_id]
            success = (local.place_id is not None
                       and local.place_id == msg.place_id)
            transform = None
            if success:
                transform = np.linalg.inv(local.gt_pose) @ msg.gt_pose
                noise = np.eye(4)
                noise[:3, 3] = self._rng.normal(
                    scale=self.verification_noise, size=3)
                transform = transform @ noise
            self.inter_lc_publisher.publish(InterRobotLoopClosure(
                robot0_id=self.robot_id, robot0_keyframe_id=kf_id,
                robot1_id=msg.robot_id, robot1_keyframe_id=msg.keyframe_id,
                success=success, transform=transform))


class SimRobot:
    def __init__(self, ctx: RobotContext, frontend, detection, backend):
        self.ctx = ctx
        self.frontend = frontend
        self.detection = detection
        self.backend = backend


class SwarmSimulator:
    """N robots on one bus + one virtual clock, stepped deterministically."""

    def __init__(self, nb_robots: int, world: SyntheticWorld,
                 trajectories: Sequence[Sequence[SimKeyframe]],
                 config_overrides: Optional[dict] = None,
                 keyframe_period: float = 1.0,
                 synchronous_pgo: bool = True, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.bus = MessageBus()
        self.clock = VirtualClock()
        self.world = world
        self.robots: List[SimRobot] = []
        for rid in range(nb_robots):
            cfg = CslamConfig(robot_id=rid, max_nb_robots=nb_robots)
            cfg.neighbor_management.enable_neighbor_monitoring = True
            cfg.neighbor_management.init_delay_sec = 0.0
            cfg.frontend.similarity_threshold = 0.8
            cfg.frontend.nn_checkpoint = "disable"
            if config_overrides:
                for k, v in config_overrides.items():
                    cfg.set_dotted(k, v)
            params = cfg.flatten()
            ctx = RobotContext(self.bus, self.clock, rid, params)
            frontend = SimulatedSensorFrontEnd(
                ctx, world, trajectories[rid],
                keyframe_period=keyframe_period, seed=seed)
            detection = DetectionFrontEnd(ctx,
                                          model=IdentityDescriptorModel(),
                                          device=self.device)
            logger = None
            if params.get("evaluation.enable_logs", False):
                from cslam_tpu_torch.evaluation.logger import ExperimentLogger
                logger = ExperimentLogger(
                    ctx, params.get("evaluation.log_folder", os.path.join(
                        tempfile.gettempdir(), "cslam_logs")),
                    device=self.device)
            backend = DecentralizedPGO(
                ctx, logger=logger, synchronous_optimization=synchronous_pgo,
                device=self.device)
            self.robots.append(SimRobot(ctx, frontend, detection, backend))

    def step(self, dt: float = 0.1) -> None:
        self.clock.advance(dt)
        for robot in self.robots:
            robot.ctx.poll_timers()
            self.bus.deliver()
        self.bus.deliver()

    def run(self, duration: float, dt: float = 0.1) -> None:
        for _ in range(int(round(duration / dt))):
            self.step(dt)

    # -- evaluation helpers --

    def ate(self, robot_id: int) -> Tuple[float, float]:
        """(odometry ATE, optimized ATE) for one robot vs ground truth,
        aligned at the first pose."""
        robot = self.robots[robot_id]
        backend = robot.backend
        gt = {i: kf.gt_pose for i, kf in enumerate(robot.frontend.keyframes)}
        est = {k[1]: p for k, p in backend.current_pose_estimates.items()
               if k[0] == robot_id}
        odo = {k[1]: p for k, p in backend.odometry_pose_estimates.items()
               if k[0] == robot_id}

        def rmse(est_map):
            common = sorted(set(gt) & set(est_map))
            if not common:
                return float("nan")
            base_gt = np.linalg.inv(gt[common[0]])
            base_est = np.linalg.inv(est_map[common[0]])
            errs = []
            for k in common:
                g = (base_gt @ gt[k])[:3, 3]
                e = (base_est @ est_map[k])[:3, 3]
                errs.append(np.linalg.norm(g - e))
            return float(np.sqrt(np.mean(np.square(errs))))

        return rmse(odo), rmse(est)


def circle_trajectory(n_keyframes: int, radius: float, nb_places: int,
                      place_offset: int = 0, start_angle: float = 0.0,
                      z: float = 0.0) -> List[SimKeyframe]:
    """Keyframes around a circle, assigned to world places by angle."""
    out = []
    for k in range(n_keyframes):
        a = start_angle + 2 * np.pi * k / n_keyframes
        T = np.eye(4)
        T[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0],
                              [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), z]
        place = place_offset + int((a % (2 * np.pi))
                                   / (2 * np.pi) * nb_places) % nb_places
        out.append(SimKeyframe(gt_pose=T, place_id=place))
    return out

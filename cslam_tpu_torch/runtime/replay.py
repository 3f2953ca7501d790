"""KITTI-format dataset replay driver for the full visual pipeline.

SURVEY.md §7's minimum end-to-end slice names KITTI/GrAco keyframe replay;
this module provides the dataset loader and a multi-robot replay harness
that feeds REAL (on-disk) stereo frames through the complete product path:
StereoFrontEnd (FAST + steered BRIEF + disparity depth + GNC geometric
verification) -> DetectionFrontEnd (global descriptors, gossip, MAC
selection, brokerage) -> DecentralizedPGO, with ATE reported against the
dataset's ground-truth poses.

KITTI odometry layout understood (the standard benchmark format):

    sequence_dir/
      calib.txt    # "P0: <12 floats>" ... rectified projection matrices
      times.txt    # one timestamp per frame (optional)
      poses.txt    # ground truth, 12 floats per line (3x4 row-major);
                   # the official benchmark keeps these in poses/<seq>.txt —
                   # either location works (optional)
      image_0/     # left grayscale PNGs, 000000.png ...
      image_1/     # right grayscale PNGs (optional; without it the replay
                   # falls back to RGB-D-style ground-truth depth = none)

The stereo camera model comes from calib.txt exactly as the reference's
stereo handler builds it from the camera infos: baseline = -P1(0,3)/P1(0,0)
(``stereo_handler.cpp:119-205``). No real dataset ships in this repo
(offline environment); ``write_kitti_sequence`` renders/serializes
sequences in the same format so the loader and driver are exercised by
tests and examples, and a user points :class:`ReplayDriver` at a real
sequence directory unchanged.

Counterpart of ``cslam_tpu/runtime/replay.py``. Two differences: the
drivers take ``device`` (CUDA unless the caller passes another) and hand
it to every node they build, and PNGs are read and written by the port's
own codec (``utils/png.py``, 8-bit grayscale or RGB, no Pillow). RGB
images are reduced to 8-bit luma with Pillow's ``convert("L")`` rounding,
so both packages see the same pixels.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.config import CslamConfig
from cslam_tpu_torch.evaluation.ate import absolute_trajectory_error
from cslam_tpu_torch.runtime.backend_node import DecentralizedPGO
from cslam_tpu_torch.runtime.bus import MessageBus, RobotContext
from cslam_tpu_torch.runtime.clock import VirtualClock
from cslam_tpu_torch.runtime.lcd_node import DetectionFrontEnd
from cslam_tpu_torch.runtime.rgbd_frontend import (CameraInfo,
                                                   StereoCameraModel,
                                                   StereoFrontEnd)
from cslam_tpu_torch.types import Odometry
from cslam_tpu_torch.utils import png


def _parse_projection(line: str) -> np.ndarray:
    vals = [float(x) for x in line.split(":", 1)[1].split()]
    return np.array(vals, np.float64).reshape(3, 4)


class KittiCalib:
    """calib.txt: rectified projection matrices P0 (left), P1 (right)."""

    def __init__(self, p0: np.ndarray, p1: Optional[np.ndarray]):
        self.p0 = p0
        self.p1 = p1

    @classmethod
    def load(cls, path: str) -> "KittiCalib":
        mats: Dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or ":" not in line:
                    continue
                key = line.split(":", 1)[0].strip()
                mats[key] = _parse_projection(line)
        return cls(mats["P0"], mats.get("P1"))

    def camera_infos(self) -> Tuple[CameraInfo, Optional[CameraInfo]]:
        def info(P):
            return CameraInfo(fx=float(P[0, 0]), fy=float(P[1, 1]),
                              cx=float(P[0, 2]), cy=float(P[1, 2]),
                              tx=float(P[0, 3]))
        return info(self.p0), (info(self.p1) if self.p1 is not None
                               else None)

    def stereo_model(self) -> StereoCameraModel:
        left, right = self.camera_infos()
        assert right is not None, "calib.txt has no P1 (right camera)"
        return StereoCameraModel.from_camera_infos(left, right)


class KittiSequence:
    """Lazy loader for one KITTI-odometry-format sequence directory."""

    def __init__(self, path: str):
        self.path = path
        calib_file = os.path.join(path, "calib.txt")
        self.calib = (KittiCalib.load(calib_file)
                      if os.path.isfile(calib_file) else None)
        left_dir = os.path.join(path, "image_0")
        self._left = (sorted(
            os.path.join(left_dir, f) for f in os.listdir(left_dir)
            if f.endswith(".png")) if os.path.isdir(left_dir) else [])
        right_dir = os.path.join(path, "image_1")
        self._right = (sorted(
            os.path.join(right_dir, f) for f in os.listdir(right_dir)
            if f.endswith(".png")) if os.path.isdir(right_dir) else None)
        velo_dir = os.path.join(path, "velodyne")
        self._scans = (sorted(
            os.path.join(velo_dir, f) for f in os.listdir(velo_dir)
            if f.endswith(".bin")) if os.path.isdir(velo_dir) else [])
        if not self._left and not self._scans:
            raise FileNotFoundError(
                f"{path!r} is not a KITTI sequence directory: no "
                "image_0/*.png and no velodyne/*.bin found")

        poses_file = os.path.join(path, "poses.txt")
        self.gt_poses: Optional[List[np.ndarray]] = None
        if os.path.isfile(poses_file):
            rows = np.loadtxt(poses_file).reshape(-1, 3, 4)
            self.gt_poses = [np.vstack([r, [0, 0, 0, 1]]) for r in rows]

        times_file = os.path.join(path, "times.txt")
        self.times: Optional[np.ndarray] = (
            np.loadtxt(times_file) if os.path.isfile(times_file) else None)

    def __len__(self) -> int:
        return len(self._left) if self._left else len(self._scans)

    @property
    def nb_scans(self) -> int:
        return len(self._scans)

    @staticmethod
    def _load_png(path: str) -> np.ndarray:
        return png.to_luma(png.read_png(path))

    def frame(self, i: int) -> Tuple[np.ndarray, Optional[np.ndarray],
                                     Optional[np.ndarray], float]:
        """(left, right-or-None, gt 4x4-or-None, timestamp)."""
        left = self._load_png(self._left[i])
        right = (self._load_png(self._right[i])
                 if self._right is not None else None)
        gt = self.gt_poses[i] if self.gt_poses is not None else None
        t = float(self.times[i]) if self.times is not None else 0.1 * i
        return left, right, gt, t

    def scan(self, i: int) -> np.ndarray:
        """Velodyne scan ``i`` as ``[N, 4]`` float32 (x, y, z, intensity) —
        the KITTI odometry ``velodyne/NNNNNN.bin`` layout."""
        return np.fromfile(self._scans[i], np.float32).reshape(-1, 4)

    def scan_cloud(self, i: int):
        """Scan ``i`` as a binary-layout :class:`PointCloud2` (x/y/z/
        intensity float32 fields), the message form the lidar front end
        accepts directly."""
        from cslam_tpu_torch.utils import point_cloud2 as pc2
        raw = self.scan(i)
        rec = np.zeros(raw.shape[0], dtype=[("x", "<f4"), ("y", "<f4"),
                                            ("z", "<f4"),
                                            ("intensity", "<f4")])
        rec["x"], rec["y"], rec["z"] = raw[:, 0], raw[:, 1], raw[:, 2]
        rec["intensity"] = raw[:, 3]
        t = float(self.times[i]) if self.times is not None else 0.1 * i
        return pc2.make_cloud(rec, frame_id="velodyne", stamp=t)


def write_kitti_sequence(path: str,
                         left_images: Optional[Sequence[np.ndarray]],
                         right_images: Optional[Sequence[np.ndarray]],
                         poses: Sequence[np.ndarray], fx: float = 0.0,
                         fy: float = 0.0, cx: float = 0.0, cy: float = 0.0,
                         baseline: float = 0.0,
                         times: Optional[Sequence[float]] = None,
                         scans: Optional[Sequence[np.ndarray]] = None
                         ) -> None:
    """Serialize a sequence in the KITTI odometry layout (used by tests
    and examples to exercise the loader; also an export path).

    ``scans`` writes ``velodyne/NNNNNN.bin`` lidar frames ([N, 3] or
    [N, 4] float arrays; a missing intensity column is zero-filled).
    Pass ``left_images=None`` for a lidar-only sequence (no calib.txt /
    image dirs are written).
    """
    os.makedirs(path, exist_ok=True)
    if left_images is not None:
        os.makedirs(os.path.join(path, "image_0"), exist_ok=True)
        os.makedirs(os.path.join(path, "image_1"), exist_ok=True)
        with open(os.path.join(path, "calib.txt"), "w") as f:
            f.write(f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n")
            f.write(f"P1: {fx} 0 {cx} {-fx * baseline} "
                    f"0 {fy} {cy} 0 0 0 1 0\n")
        for i, (li, ri) in enumerate(zip(left_images, right_images)):
            png.write_png(os.path.join(path, "image_0", f"{i:06d}.png"),
                          np.asarray(li, np.uint8))
            png.write_png(os.path.join(path, "image_1", f"{i:06d}.png"),
                          np.asarray(ri, np.uint8))
    if scans is not None:
        os.makedirs(os.path.join(path, "velodyne"), exist_ok=True)
        for i, pts in enumerate(scans):
            pts = np.asarray(pts, np.float32)
            if pts.shape[1] == 3:
                pts = np.concatenate(
                    [pts, np.zeros((pts.shape[0], 1), np.float32)], axis=1)
            pts.tofile(os.path.join(path, "velodyne", f"{i:06d}.bin"))
    rows = [np.asarray(p, np.float64)[:3].reshape(-1) for p in poses]
    np.savetxt(os.path.join(path, "poses.txt"), np.stack(rows))
    if times is not None:
        np.savetxt(os.path.join(path, "times.txt"), np.asarray(times))


class TinyImageDescriptor:
    """Checkpoint-free global descriptor: block-mean downsample + L2
    normalize (the classic tiny-image baseline). Deterministic, so
    revisits of the same place match — lets the replay pipeline run
    end-to-end without any downloaded VPR weights (pass a CosPlace /
    NetVLAD instance instead when checkpoints are available)."""

    def __init__(self, grid: int = 8):
        self.grid = grid

    def compute_embedding(self, image: np.ndarray) -> np.ndarray:
        img = np.asarray(image, np.float32)
        if img.ndim == 3:
            img = img.mean(axis=2)
        h, w = img.shape
        gh, gw = h // self.grid, w // self.grid
        img = img[:gh * self.grid, :gw * self.grid]
        blocks = img.reshape(self.grid, gh, self.grid, gw).mean(axis=(1, 3))
        v = blocks.reshape(-1)
        v = v - v.mean()
        n = np.linalg.norm(v)
        return (v / n if n > 0 else v).astype(np.float32)


class ReplayRobot:
    def __init__(self, ctx, frontend, detection, backend, sequence,
                 frame_ids):
        self.ctx = ctx
        self.frontend = frontend
        self.detection = detection
        self.backend = backend
        self.sequence = sequence
        self.frame_ids = list(frame_ids)
        self.cursor = 0
        self.kf_gt: Dict[int, np.ndarray] = {}
        self.odom_pose = np.eye(4)
        self.prev_gt: Optional[np.ndarray] = None


class ReplayDriver:
    """Replay KITTI-format sequences through the full visual pipeline.

    Each robot replays one sequence (or one frame range of a shared
    sequence). Odometry fed to the front end is dead-reckoned from the
    ground truth with configurable per-step noise — the replay equivalent
    of the odometry topic the reference synchronizes with its images
    (``stereo_handler.cpp:38-44``).
    """

    def __init__(self, sequences: Sequence[KittiSequence],
                 frame_ranges: Optional[Sequence[Sequence[int]]] = None,
                 odom_noise: float = 0.02, seed: int = 0,
                 config_overrides: Optional[dict] = None,
                 model=None, device=None):
        nb_robots = len(sequences)
        self.device = resolve_device(device)
        self.bus = MessageBus()
        self.clock = VirtualClock()
        self.rng = np.random.default_rng(seed)
        self.odom_noise = odom_noise
        self.robots: List[ReplayRobot] = []
        for rid, seq in enumerate(sequences):
            cfg = CslamConfig(robot_id=rid, max_nb_robots=nb_robots)
            cfg.neighbor_management.enable_neighbor_monitoring = True
            cfg.neighbor_management.init_delay_sec = 0.0
            self._configure(cfg)
            if config_overrides:
                for k, v in config_overrides.items():
                    cfg.set_dotted(k, v)
            params = cfg.flatten()
            ctx = RobotContext(self.bus, self.clock, rid, params)
            frontend = self._make_frontend(ctx, seq)
            detection = DetectionFrontEnd(ctx, model=model,
                                          device=self.device)
            backend = DecentralizedPGO(ctx, synchronous_optimization=True,
                                       device=self.device)
            ids = (frame_ranges[rid] if frame_ranges is not None
                   else self._default_frame_ids(seq))
            self.robots.append(ReplayRobot(ctx, frontend, detection,
                                           backend, seq, ids))

    # sensor hooks (overridden by LidarReplayDriver) -------------------

    def _configure(self, cfg: CslamConfig) -> None:
        cfg.frontend.sensor_type = "stereo"

    def _make_frontend(self, ctx, seq: KittiSequence):
        if seq.calib is None:
            raise FileNotFoundError(
                f"{seq.path!r} has no calib.txt — stereo replay needs the "
                "projection matrices (use LidarReplayDriver for "
                "velodyne-only sequences)")
        return StereoFrontEnd(ctx, seq.calib.stereo_model(),
                              device=self.device)

    def _default_frame_ids(self, seq: KittiSequence):
        return range(len(seq))

    def _push_sensor(self, robot: ReplayRobot, i: int,
                     odom: Odometry) -> None:
        left, right, _gt, _t = robot.sequence.frame(i)
        assert right is not None, "stereo replay needs image_1/"
        robot.frontend.stereo_callback(left, right, odom)

    # ------------------------------------------------------------------

    def _feed_frame(self, robot: ReplayRobot) -> bool:
        if robot.cursor >= len(robot.frame_ids):
            return False
        i = robot.frame_ids[robot.cursor]
        robot.cursor += 1
        gt = (robot.sequence.gt_poses[i]
              if robot.sequence.gt_poses is not None else np.eye(4))
        if robot.prev_gt is None:
            robot.odom_pose = gt.copy()
        else:
            z = np.linalg.inv(robot.prev_gt) @ gt
            z[:3, 3] += self.rng.normal(scale=self.odom_noise, size=3)
            robot.odom_pose = robot.odom_pose @ z
        robot.prev_gt = gt
        before = robot.frontend.nb_local_keyframes
        self._push_sensor(robot, i, Odometry(pose=robot.odom_pose))
        # drain synchronously so the keyframe id <-> ground truth mapping
        # is exact (the keyframe gate may drop the frame)
        robot.frontend.process_new_sensor_data()
        if robot.frontend.nb_local_keyframes > before:
            robot.kf_gt[before] = gt
        return True

    def step(self, dt: float = 0.25) -> bool:
        any_fed = False
        for robot in self.robots:
            any_fed |= self._feed_frame(robot)
        self.clock.advance(dt)
        for robot in self.robots:
            robot.ctx.poll_timers()
            self.bus.deliver()
        self.bus.deliver()
        return any_fed

    def run(self, extra_steps: int = 30, dt: float = 0.25) -> None:
        """Feed every frame, then keep the planes running for
        ``extra_steps`` so detection/PGO rounds drain."""
        while self.step(dt):
            pass
        for _ in range(extra_steps):
            self.step(dt)

    def ate(self, robot_id: int) -> Tuple[float, float]:
        """(odometry ATE, optimized ATE) vs the sequence ground truth."""
        robot = self.robots[robot_id]
        backend = robot.backend
        gt = {(robot_id, k): p for k, p in robot.kf_gt.items()}
        est = {k: p for k, p in backend.current_pose_estimates.items()
               if k[0] == robot_id}
        odo = {k: p for k, p in backend.odometry_pose_estimates.items()
               if k[0] == robot_id}
        ate_odo = absolute_trajectory_error(odo, gt) if odo else float("nan")
        ate_opt = absolute_trajectory_error(est, gt) if est else float("nan")
        return ate_odo, ate_opt


class LidarReplayDriver(ReplayDriver):
    """Replay KITTI ``velodyne/*.bin`` sequences through the lidar
    pipeline: scans decoded to binary-layout :class:`PointCloud2`
    messages -> ``LidarFrontEnd`` (voxel downsample + odometry keyframe
    gate) -> scan-context detection -> multi-start robust ICP
    verification -> decentralized PGO. The lidar analogue of the stereo
    replay — the reference's primary demo path
    (``/root/reference/cslam/lidar_handler_node.py``).
    """

    def _configure(self, cfg: CslamConfig) -> None:
        cfg.frontend.sensor_type = "lidar"
        cfg.frontend.global_descriptor_technique = "scancontext"

    def _make_frontend(self, ctx, seq: KittiSequence):
        if seq.nb_scans == 0:
            raise FileNotFoundError(
                f"{seq.path!r} has no velodyne/*.bin scans — lidar replay "
                "needs them (use ReplayDriver for image-only sequences)")
        from cslam_tpu_torch.runtime.lidar_frontend import LidarFrontEnd
        return LidarFrontEnd(ctx, device=self.device)

    def _default_frame_ids(self, seq: KittiSequence):
        return range(seq.nb_scans)

    def _push_sensor(self, robot: ReplayRobot, i: int,
                     odom: Odometry) -> None:
        robot.frontend.lidar_callback(robot.sequence.scan_cloud(i), odom)

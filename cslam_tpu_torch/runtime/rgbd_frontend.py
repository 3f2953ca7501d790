"""RGB-D and stereo sensor front ends (per-robot nodes).

Behavior parity with the reference's C++ map_manager stack
(``src/front_end/rgbd_handler.cpp`` / ``stereo_handler.cpp``): synchronized
sensor intake with an odometry-failure gate (cpp:180), a bounded queue that
drops oldest (cpp:246-255), per-frame local features (host C++ FAST+BRIEF
via ``cslam_tpu_torch.native``, rtabmap Feature2D's role, cpp:266-312),
keyframe gating by registration-inlier ratio against the previous keyframe
(cpp:314-351), keyframe publication (cpp:556-611), a descriptor-request
service shipping compressed keypoints/descriptors with byte-accurate comm
logging (cpp:404-431: keypoint 28 B + 3D point 12 B + descriptor bytes),
and intra/inter geometric verification — rtabmap's RANSAC-PnP replaced by
descriptor matching + GNC 3D alignment
(``cslam_tpu_torch.ops.visual_registration``).

The stereo variant computes sparse depth by left/right descriptor matching
along epipolar rows (the role of the reference's stereo camera model,
``stereo_handler.cpp:119-205``).

Counterpart of ``cslam_tpu/runtime/rgbd_frontend.py``. The host work stays
on the host: feature extraction through the port's C++ library
(``cslam_tpu_torch.native``, built at first use, no fallback), the stereo
disparity loop, payload compression and comm-byte accounting. Only the
verification runs on the node's torch device (CUDA unless the caller
passes another), one chunk per incoming descriptor message.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple
from collections import deque

import numpy as np

from cslam_tpu_torch import native, resolve_device
from cslam_tpu_torch.ops import visual_registration as vreg
from cslam_tpu_torch.utils import compression, profiling
from cslam_tpu_torch.runtime.visualization import create_colored_pointcloud
from cslam_tpu_torch.types import (InterRobotLoopClosure,
                                   IntraRobotLoopClosure, KeyframeOdom,
                                   KeyframeRGB, KeyValue,
                                   LocalDescriptorsRequest,
                                   LocalImageDescriptors, Odometry,
                                   VizPointCloud)

KEYPOINT_BYTES = 28   # reference comm accounting, rgbd_handler.cpp:423-425
POINT3D_BYTES = 12


@dataclass
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float = 0.0  # stereo only (meters)


@dataclass
class CameraInfo:
    """Pinhole projection of one (rectified) camera — the subset of the
    ROS CameraInfo message the reference consumes. ``tx`` is P(0,3) of the
    projection matrix: 0 for a left/mono camera, ``-fx * baseline`` for the
    right camera of a rectified horizontal stereo pair."""
    fx: float
    fy: float
    cx: float
    cy: float
    tx: float = 0.0
    width: int = 0
    height: int = 0


class StereoBaselineError(ValueError):
    """Raised when a stereo pair's camera infos imply a non-positive
    baseline (reference drops the frame with an error,
    ``stereo_handler.cpp:185-194``)."""


class StereoCameraModel:
    """Rectified horizontal stereo camera model with the reference's
    baseline sanity logic (``stereo_handler.cpp:119-205``).

    Assumes the input pair is already rectified (the reference hardcodes
    ``alreadyRectified = true``, stereo_handler.cpp:120). Baseline is
    derived from the right camera info as ``-P(0,3)/P(0,0) = -tx/fx``;
    when the right info has no Tx, an explicit ``fallback_baseline``
    (the stand-in for the reference's TF lookup, cpp:152-182) may supply
    it. Non-positive baselines raise :class:`StereoBaselineError`;
    baselines over 10 m log a once-only warning (cpp:196-205).
    """

    MAX_SANE_BASELINE = 10.0
    _warned_large = False
    _warned_fallback = False

    def __init__(self, left: CameraInfo, right: CameraInfo,
                 baseline: float):
        self.left = left
        self.right = right
        self.baseline = float(baseline)

    @classmethod
    def from_camera_infos(cls, left: CameraInfo, right: CameraInfo,
                          fallback_baseline: Optional[float] = None
                          ) -> "StereoCameraModel":
        baseline = -right.tx / right.fx if right.fx else 0.0
        if baseline == 0.0 and fallback_baseline is not None \
                and fallback_baseline > 0:
            # reference: TF-derived baseline convenience path with a
            # once-only warning (stereo_handler.cpp:152-182)
            if not cls._warned_fallback:
                logging.getLogger(__name__).warning(
                    "right camera info carries no Tx; falling back to the "
                    "configured baseline of %.3f m — a rectified right "
                    "camera info with Tx set is preferable (warned once)",
                    fallback_baseline)
                cls._warned_fallback = True
            baseline = float(fallback_baseline)
        if baseline <= 0.0:
            # reference: error + drop frame (stereo_handler.cpp:185-194)
            raise StereoBaselineError(
                f"computed stereo baseline {baseline} m is not positive; "
                "for a horizontal rectified pair the right camera's "
                "P(0,3) (= Tx) must be negative so that -Tx/fx > 0")
        if baseline > cls.MAX_SANE_BASELINE and not cls._warned_large:
            # reference: once-only plausibility warning (cpp:196-205)
            logging.getLogger(__name__).warning(
                "stereo baseline of %f m (from -P(0,3)/P(0,0)) exceeds "
                "the %.0f m plausibility bound — check the right camera "
                "projection matrix (warned once)",
                baseline, cls.MAX_SANE_BASELINE)
            cls._warned_large = True
        return cls(left, right, baseline)

    def as_camera_model(self) -> CameraModel:
        """Collapse to the left-camera pinhole + baseline used by the
        feature pipeline (rtabmap StereoCameraModel's role)."""
        return CameraModel(self.left.fx, self.left.fy, self.left.cx,
                           self.left.cy, self.baseline)

    def disparity_to_depth(self, disparity: np.ndarray) -> np.ndarray:
        """z = fx * B / d (rectified horizontal pair)."""
        d = np.asarray(disparity, np.float32)
        return np.where(d > 0, self.left.fx * self.baseline
                        / np.maximum(d, 1e-9), 0.0).astype(np.float32)


@dataclass
class KeyframeFeatures:
    keypoints: np.ndarray    # [N, 2] int32 pixel coords
    keypoints3d: np.ndarray  # [N, 3] float32 camera-frame points
    descriptors: np.ndarray  # [N, 32] uint8


class RGBDFrontEnd:
    """Front-end handler for RGB-D frames; verification runs on
    ``device``."""

    def __init__(self, ctx, camera: CameraModel, device=None):
        self.ctx = ctx
        self.device = resolve_device(device)
        self.params = ctx.params
        self.camera = camera
        self.robot_id = self.params["robot_id"]

        self.keyframe_data_publisher = ctx.create_publisher(
            "cslam/keyframe_data")
        self.keyframe_odom_publisher = ctx.create_publisher(
            "cslam/keyframe_odom")
        ctx.create_subscription("cslam/local_descriptors_request",
                                self.send_local_descriptors_request)
        ctx.create_subscription("cslam/local_keyframe_match",
                                self.receive_local_keyframe_match)
        self.descriptors_publisher = ctx.create_publisher(
            "/cslam/local_descriptors")
        ctx.create_subscription("/cslam/local_descriptors",
                                self.receive_local_image_descriptors)
        self.intra_lc_publisher = ctx.create_publisher(
            "cslam/intra_robot_loop_closure")
        self.inter_lc_publisher = ctx.create_publisher(
            "/cslam/inter_robot_loop_closure")
        self.log_publisher = ctx.create_publisher("cslam/log_info")
        self.viz_publisher = ctx.create_publisher(
            "/cslam/viz/keyframe_pointcloud")
        ctx.create_timer(
            self.params.get("frontend.map_manager_process_period_ms", 100)
            / 1000.0, self.process_new_sensor_data)

        self.queue: Deque[Tuple] = deque(
            maxlen=self.params.get("frontend.max_queue_size", 10))
        self.features: Dict[int, KeyframeFeatures] = {}
        self.nb_local_keyframes = 0
        self.previous_features: Optional[KeyframeFeatures] = None
        self.log_comm_bytes = 0

        self.min_inliers = self.params.get("frontend.pnp_min_inliers", 6)
        self.keyframe_ratio = self.params.get(
            "frontend.keyframe_generation_ratio_threshold", 1.0)
        self.fast_threshold = int(self.params.get(
            "frontend.fast_threshold", 25))
        self.max_keypoints = int(self.params.get(
            "frontend.max_keypoints", 512))
        # ORB-style steered BRIEF (intensity-centroid orientation): robust
        # to in-plane rotation between robots' viewpoints, like rtabmap's
        # default ORB features (reference rgbd_handler.cpp:266-312).
        # Unsteered BRIEF silently kills loop closures beyond ~15 deg.
        self.steered_brief = bool(self.params.get(
            "frontend.steered_brief", True))

        # capture the verification's graph of each pair tier before the
        # first frame, as the JAX package precompiles the tiers here
        warmup_tiers = self.params.get("frontend.warmup_verification_tiers",
                                       ())
        if warmup_tiers:
            vreg.warmup_verification(tuple(warmup_tiers), device=self.device)

    # ------------------------------------------------------------------
    # Intake (rgbd_handler.cpp:173-255)
    # ------------------------------------------------------------------

    def rgbd_callback(self, rgb: np.ndarray, depth: np.ndarray,
                      odom: Odometry) -> None:
        if odom.covariance0 > 1000:
            return  # odom tracking failed, skip frame
        self.queue.append((rgb, depth, odom))  # deque drops oldest when full

    @staticmethod
    def _grayscale(rgb: np.ndarray) -> np.ndarray:
        if rgb.ndim == 2:
            return rgb.astype(np.uint8)
        return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2]).astype(np.uint8)

    def _describe(self, gray: np.ndarray, kp: np.ndarray) -> np.ndarray:
        if self.steered_brief:
            desc, _angles = native.steered_brief_describe(gray, kp)
            return desc
        return native.brief_describe(gray, kp)

    def _compute_local_features(self, rgb: np.ndarray,
                                depth: Optional[np.ndarray]
                                ) -> KeyframeFeatures:
        gray = self._grayscale(rgb)
        kp, _scores = native.fast_detect(gray, self.fast_threshold,
                                         self.max_keypoints)
        desc = self._describe(gray, kp)
        kp3d = vreg.project_to_3d(kp, depth, self.camera.fx, self.camera.fy,
                                  self.camera.cx, self.camera.cy)
        return KeyframeFeatures(kp, kp3d, desc)

    def _generate_new_keyframe(self, feats: KeyframeFeatures) -> bool:
        """Inlier-ratio keyframe gate (rgbd_handler.cpp:314-351): a frame
        becomes a keyframe when registration against the previous keyframe
        drops below the ratio threshold (or fails)."""
        if self.keyframe_ratio >= 1.0 or self.previous_features is None:
            return True
        prev = self.previous_features
        with profiling.span("rgbd.keyframe_gate"):
            _, success, inliers = vreg.verify_keyframe_pair(
                feats.keypoints3d, feats.descriptors,
                prev.keypoints3d, prev.descriptors,
                min_inliers=self.min_inliers, device=self.device)
        if not success:
            return True
        ratio = inliers / max(len(feats.keypoints), 1)
        return ratio < self.keyframe_ratio

    def process_new_sensor_data(self) -> None:
        if not self.queue:
            return
        rgb, depth, odom = self.queue.popleft()
        with profiling.span("rgbd.features"):
            feats = self._compute_local_features(rgb, depth)
        if not self._generate_new_keyframe(feats):
            return
        kf_id = self.nb_local_keyframes
        self.features[kf_id] = feats
        self.previous_features = feats
        self.keyframe_data_publisher.publish(KeyframeRGB(id=kf_id, image=rgb))
        self.keyframe_odom_publisher.publish(KeyframeOdom(id=kf_id,
                                                          odom=odom))
        self._publish_viz(kf_id, rgb, depth)
        self.nb_local_keyframes += 1

    def _publish_viz(self, kf_id: int, rgb: np.ndarray,
                     depth: Optional[np.ndarray]) -> None:
        """Per-keyframe colored cloud on the viz plane (parity with
        ``rgbd_handler.cpp:613-682``, which back-projects and publishes a
        subsampled cloud for each new keyframe when visualization is on)."""
        if depth is None or not self.params.get("visualization.enable",
                                                False):
            return
        stride = int(self.params.get("visualization.stride", 4))
        cloud = create_colored_pointcloud(
            depth, rgb, self.camera.fx, self.camera.fy,
            self.camera.cx, self.camera.cy,
            max_depth=self.params.get("visualization.max_depth_m", 50.0),
            stride=max(stride, 1))
        self.viz_publisher.publish(VizPointCloud(
            robot_id=self.robot_id, keyframe_id=kf_id, points=cloud))

    # ------------------------------------------------------------------
    # Descriptor exchange (rgbd_handler.cpp:404-431)
    # ------------------------------------------------------------------

    def send_local_descriptors_request(self,
                                       request: LocalDescriptorsRequest) -> None:
        feats = self.features.get(request.keyframe_id)
        if feats is None:
            return
        # Ship compressed payloads like the reference's rtabmap-compressed
        # features (rgbd_handler.cpp:404-431); binary BRIEF descriptors
        # stay lossless, coordinates optionally f16-quantized.
        if self.params.get("frontend.compress_payloads", True):
            q = bool(self.params.get("frontend.compress_quantize_f16",
                                     False))
            kp = compression.compress_array(feats.keypoints,
                                            quantize_f16=q)
            kp3 = compression.compress_array(feats.keypoints3d,
                                             quantize_f16=q)
            desc = compression.compress_array(feats.descriptors)
        else:
            kp, kp3, desc = (feats.keypoints, feats.keypoints3d,
                             feats.descriptors)
        msg = LocalImageDescriptors(
            keyframe_id=request.keyframe_id, robot_id=self.robot_id,
            keypoints=kp, keypoints3d=kp3, descriptors=desc,
            matches_robot_id=list(request.matches_robot_id),
            matches_keyframe_id=list(request.matches_keyframe_id))
        self.descriptors_publisher.publish(msg)
        if self.params.get("evaluation.enable_logs", False):
            # reference accounting formula (rgbd_handler.cpp:423-425):
            # keypoint/point constants + ACTUAL descriptor payload bytes
            n = len(feats.keypoints)
            self.log_comm_bytes += (n * KEYPOINT_BYTES + n * POINT3D_BYTES
                                    + compression.payload_nbytes(desc))
            self.log_publisher.publish(KeyValue(
                key="local_descriptors_cumulative_communication",
                value=str(self.log_comm_bytes)))

    # ------------------------------------------------------------------
    # Geometric verification (rgbd_handler.cpp:433-554)
    # ------------------------------------------------------------------

    def _projective(self) -> bool:
        """frontend.verification_residual == 'projective': verify with the
        reference's reprojection-error decision surface (RANSAC-PnP parity,
        rgbd_handler.cpp:493-554) instead of 3D-3D alignment — local depth
        then only seeds the initialization, so degraded/sparse local depth
        does not bias the estimate."""
        return self.params.get("frontend.verification_residual",
                               "3d3d") == "projective"

    def _verify(self, a: KeyframeFeatures, b: KeyframeFeatures
                ) -> Tuple[np.ndarray, bool]:
        if self._projective():
            T, success, _ = vreg.verify_keyframe_pairs_projective(
                [(a.keypoints.astype(np.float32), a.keypoints3d,
                  a.descriptors, b.keypoints3d, b.descriptors)],
                self.camera.fx, self.camera.fy, self.camera.cx,
                self.camera.cy, min_inliers=self.min_inliers,
                device=self.device)[0]
            return T, success
        T, success, _ = vreg.verify_keyframe_pair(
            a.keypoints3d, a.descriptors, b.keypoints3d, b.descriptors,
            min_inliers=self.min_inliers, device=self.device)
        return T, success

    def receive_local_image_descriptors(self,
                                        msg: LocalImageDescriptors) -> None:
        if not isinstance(msg, LocalImageDescriptors):
            return
        # transparent to senders with compression on OR off
        msg = LocalImageDescriptors(
            keyframe_id=msg.keyframe_id, robot_id=msg.robot_id,
            keypoints=compression.maybe_decompress(msg.keypoints),
            keypoints3d=compression.maybe_decompress(msg.keypoints3d),
            descriptors=compression.maybe_decompress(msg.descriptors),
            matches_robot_id=msg.matches_robot_id,
            matches_keyframe_id=msg.matches_keyframe_id)
        # One incoming keyframe may match several local keyframes; verify
        # them all in ONE batched chunk (gnc_align_batch) instead of the
        # reference's per-pair RANSAC loop (rgbd_handler.cpp:493-554).
        jobs = []
        for rid, kf_id in zip(msg.matches_robot_id, msg.matches_keyframe_id):
            if rid != self.robot_id:
                continue
            local = self.features.get(kf_id)
            if local is None:
                continue
            jobs.append((kf_id, local))
        if not jobs:
            return
        with profiling.span("rgbd.verify_batch"):
            if self._projective():
                results = vreg.verify_keyframe_pairs_projective(
                    [(local.keypoints.astype(np.float32), local.keypoints3d,
                      local.descriptors, msg.keypoints3d, msg.descriptors)
                     for _, local in jobs],
                    self.camera.fx, self.camera.fy, self.camera.cx,
                    self.camera.cy, min_inliers=self.min_inliers,
                    device=self.device)
            else:
                results = vreg.verify_keyframe_pairs(
                    [(local.keypoints3d, local.descriptors,
                      msg.keypoints3d, msg.descriptors) for _, local in jobs],
                    min_inliers=self.min_inliers, device=self.device)
        for (kf_id, _), (transform, success, _) in zip(jobs, results):
            self.inter_lc_publisher.publish(InterRobotLoopClosure(
                robot0_id=self.robot_id, robot0_keyframe_id=kf_id,
                robot1_id=msg.robot_id, robot1_keyframe_id=msg.keyframe_id,
                success=success,
                transform=transform if success else None))

    def receive_local_keyframe_match(self, msg) -> None:
        a = self.features.get(msg.keyframe0_id)
        b = self.features.get(msg.keyframe1_id)
        if a is None or b is None:
            return
        with profiling.span("rgbd.verify_intra"):
            transform, success = self._verify(a, b)
        self.intra_lc_publisher.publish(IntraRobotLoopClosure(
            keyframe0_id=msg.keyframe0_id, keyframe1_id=msg.keyframe1_id,
            success=success, transform=transform if success else None))


class StereoFrontEnd(RGBDFrontEnd):
    """Stereo variant: sparse depth from left/right descriptor matching.

    Mirrors the reference StereoHandler's 5-way sync of
    left+right+2 camera infos+odom (``stereo_handler.cpp:38-44``): the
    callback optionally takes per-frame camera infos, rebuilds the
    :class:`StereoCameraModel` with the baseline sanity checks
    (cpp:119-205), and drops the frame when the model is invalid —
    exactly the reference's early returns.
    """

    def __init__(self, ctx, camera,
                 fallback_baseline: Optional[float] = None, device=None):
        if isinstance(camera, StereoCameraModel):
            self.stereo_model: Optional[StereoCameraModel] = camera
            camera = camera.as_camera_model()
        else:
            self.stereo_model = None
        super().__init__(ctx, camera, device=device)
        self.fallback_baseline = fallback_baseline
        self.dropped_invalid_model = 0

    def stereo_callback(self, left: np.ndarray, right: np.ndarray,
                        odom: Odometry,
                        left_info: Optional[CameraInfo] = None,
                        right_info: Optional[CameraInfo] = None) -> None:
        if odom.covariance0 > 1000:
            return
        if left_info is not None and right_info is not None:
            try:
                self.stereo_model = StereoCameraModel.from_camera_infos(
                    left_info, right_info,
                    fallback_baseline=self.fallback_baseline)
            except StereoBaselineError as exc:
                # reference: RCLCPP_ERROR + return (cpp:185-194)
                self.dropped_invalid_model += 1
                logging.getLogger(__name__).error("%s", exc)
                return
            self.camera = self.stereo_model.as_camera_model()
        self.queue.append((left, right, odom))

    def _compute_local_features(self, left: np.ndarray,
                                right: np.ndarray) -> KeyframeFeatures:
        gray_l = self._grayscale(left)
        gray_r = self._grayscale(right)
        kp_l, _ = native.fast_detect(gray_l, self.fast_threshold,
                                     self.max_keypoints)
        kp_r, _ = native.fast_detect(gray_r, self.fast_threshold,
                                     self.max_keypoints)
        # intra-pair disparity matching uses UNSTEERED BRIEF: a rectified
        # pair has zero relative rotation, so steering only injects
        # orientation-estimate noise into the correspondence (stereo block
        # matchers are never rotation invariant); the keyframe's outgoing
        # descriptors (inter-robot verification) are steered below.
        desc_l = native.brief_describe(gray_l, kp_l)
        desc_r = native.brief_describe(gray_r, kp_r)

        kp3d = np.zeros((len(kp_l), 3), np.float32)
        # Lowe ratio test on top of mutual NN: an ambiguous best match
        # (close second-best) produces a wrong disparity and a grossly
        # wrong metric depth — worse than no depth for that keypoint
        pairs = native.hamming_match(desc_l, desc_r, max_dist=40,
                                     ratio=0.8)
        for i, j in pairs:
            xl, yl = kp_l[i]
            xr, yr = kp_r[j]
            if abs(int(yl) - int(yr)) > 2:      # epipolar row check
                continue
            disparity = float(xl) - float(xr)
            if disparity <= 0.5:                 # behind / at infinity
                continue
            z = self.camera.fx * self.camera.baseline / disparity
            kp3d[i] = [(xl - self.camera.cx) * z / self.camera.fx,
                       (yl - self.camera.cy) * z / self.camera.fy, z]
        out_desc = (self._describe(gray_l, kp_l) if self.steered_brief
                    else desc_l)  # unsteered: the disparity descriptors ARE
        return KeyframeFeatures(kp_l, kp3d, out_desc)

    def _publish_viz(self, kf_id: int, left: np.ndarray,
                     right: Optional[np.ndarray]) -> None:
        """Stereo has no dense depth image; publish the triangulated sparse
        keypoints colored from the left frame instead of a dense
        back-projection."""
        if not self.params.get("visualization.enable", False):
            return
        feats = self.features.get(kf_id)
        if feats is None:
            return
        valid = feats.keypoints3d[:, 2] > 0
        pts = feats.keypoints3d[valid]
        kp = feats.keypoints[valid]
        img = np.asarray(left)
        samples = img[kp[:, 1], kp[:, 0]]
        colors = (np.stack([samples] * 3, axis=1) if samples.ndim == 1
                  else samples).astype(np.float32)
        self.viz_publisher.publish(VizPointCloud(
            robot_id=self.robot_id, keyframe_id=kf_id,
            points=np.concatenate([pts.astype(np.float32), colors], axis=1)))

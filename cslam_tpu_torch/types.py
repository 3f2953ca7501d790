"""Core typed records: edges, poses, and the message schema.

This is the TPU-era equivalent of the reference's edge containers
(``cslam/algebraic_connectivity_maximization.py:9-31``, ``cslam/mac/utils.py:13``)
and of the ~20 ROS message types from the external ``cslam_common_interfaces``
package (imported at reference ``global_descriptor_loop_closure_detection.py:11-15``,
``lidar_handler_node.py:6-8``, ``include/cslam/back_end/decentralized_pgo.h:15-21``).
Messages here are plain dataclasses carried over the in-process/host bus
(``cslam_tpu.runtime.bus``); arrays are numpy on the host side and only enter
jitted device code in batched, fixed-shape form.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Graph edges
# ---------------------------------------------------------------------------


class Edge(NamedTuple):
    """A weighted undirected edge between two (rekeyed, single-graph) nodes.

    Mirrors the solver-side edge container (reference ``cslam/mac/utils.py:13``).
    """

    i: int
    j: int
    weight: float


class EdgeInterRobot(NamedTuple):
    """An inter-robot loop-closure edge keyed by (robot, keyframe) pairs.

    Equality is symmetric and ignores the weight, matching the reference
    semantics (``cslam/algebraic_connectivity_maximization.py:18-31``): the
    same candidate observed from either endpoint compares equal.
    """

    robot0_id: int
    robot0_keyframe_id: int
    robot1_id: int
    robot1_keyframe_id: int
    weight: float

    def key(self) -> Tuple[int, int, int, int]:
        """Canonical (direction-independent) identity of this edge."""
        a = (self.robot0_id, self.robot0_keyframe_id)
        b = (self.robot1_id, self.robot1_keyframe_id)
        lo, hi = (a, b) if a[0] < b[0] else (b, a)
        return (lo[0], lo[1], hi[0], hi[1])

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, EdgeInterRobot):
            return NotImplemented
        return self.key() == other.key()

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:  # keep hash consistent with symmetric __eq__
        return hash(self.key())


# ---------------------------------------------------------------------------
# Poses
# ---------------------------------------------------------------------------


def identity_pose() -> np.ndarray:
    """A 4x4 identity SE(3) transform."""
    return np.eye(4, dtype=np.float64)


@dataclass
class PoseKey:
    """Global pose-graph variable key: (robot_id, keyframe_id).

    The TPU-era replacement for GTSAM ``LabeledSymbol('g', 'A'+robot, kf)``
    (reference ``src/back_end/gtsam_utils.h:20-22``).
    """

    robot_id: int
    keyframe_id: int

    def __hash__(self) -> int:
        return hash((self.robot_id, self.keyframe_id))

    def as_tuple(self) -> Tuple[int, int]:
        return (self.robot_id, self.keyframe_id)


# ---------------------------------------------------------------------------
# Message schema (host bus payloads)
# ---------------------------------------------------------------------------


@dataclass
class Odometry:
    """Minimal odometry record: pose + covariance trace gate.

    Stand-in for ``nav_msgs/Odometry``; ``covariance0`` mirrors the
    odom-failure gate ``pose.covariance[0] > 1000`` used at reference
    ``src/front_end/rgbd_handler.cpp:180`` and ``cslam/lidar_handler_node.py:79``.
    """

    pose: np.ndarray = field(default_factory=identity_pose)  # 4x4
    covariance0: float = 0.0
    stamp: float = 0.0


@dataclass
class KeyframeRGB:
    id: int = 0
    image: Optional[np.ndarray] = None  # HxWx3 uint8


@dataclass
class KeyframePointCloud:
    id: int = 0
    points: Optional[np.ndarray] = None  # Nx3 float32


@dataclass
class KeyframeOdom:
    id: int = 0
    odom: Odometry = field(default_factory=Odometry)
    gps: Optional[Any] = None


@dataclass
class GlobalDescriptor:
    keyframe_id: int = 0
    robot_id: int = 0
    descriptor: Optional[np.ndarray] = None


@dataclass
class GlobalDescriptors:
    descriptors: List[GlobalDescriptor] = field(default_factory=list)


@dataclass
class InterRobotMatch:
    robot0_id: int = 0
    robot0_keyframe_id: int = 0
    robot1_id: int = 0
    robot1_keyframe_id: int = 0
    weight: float = 0.0

    def to_edge(self) -> EdgeInterRobot:
        return EdgeInterRobot(self.robot0_id, self.robot0_keyframe_id,
                              self.robot1_id, self.robot1_keyframe_id,
                              self.weight)

    @staticmethod
    def from_edge(e: EdgeInterRobot) -> "InterRobotMatch":
        return InterRobotMatch(e.robot0_id, e.robot0_keyframe_id,
                               e.robot1_id, e.robot1_keyframe_id, e.weight)


@dataclass
class InterRobotMatches:
    robot_id: int = 0
    matches: List[InterRobotMatch] = field(default_factory=list)


@dataclass
class LocalKeyframeMatch:
    keyframe0_id: int = 0
    keyframe1_id: int = 0


@dataclass
class LocalDescriptorsRequest:
    keyframe_id: int = 0
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)


@dataclass
class LocalImageDescriptors:
    """Compressed local visual features of one keyframe (RGB/stereo path).

    On the wire the array fields are deflate blobs when
    ``frontend.compress_payloads`` is on (``cslam_tpu.utils.compression``,
    parity with the reference's rtabmap-compressed features,
    ``rgbd_handler.cpp:404-431``); receivers decompress transparently.
    """

    keyframe_id: int = 0
    robot_id: int = 0
    keypoints: Optional[np.ndarray] = None      # Kx2 float32 (pixel coords)
    keypoints3d: Optional[np.ndarray] = None    # Kx3 float32 (camera frame)
    descriptors: Optional[np.ndarray] = None    # KxD
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)


@dataclass
class LocalPointCloudDescriptors:
    """Downsampled point cloud of one keyframe (lidar path)."""

    keyframe_id: int = 0
    robot_id: int = 0
    points: Optional[np.ndarray] = None  # Nx3
    matches_robot_id: List[int] = field(default_factory=list)
    matches_keyframe_id: List[int] = field(default_factory=list)


@dataclass
class IntraRobotLoopClosure:
    keyframe0_id: int = 0
    keyframe1_id: int = 0
    success: bool = False
    transform: Optional[np.ndarray] = None  # 4x4


@dataclass
class InterRobotLoopClosure:
    robot0_id: int = 0
    robot0_keyframe_id: int = 0
    robot1_id: int = 0
    robot1_keyframe_id: int = 0
    success: bool = False
    transform: Optional[np.ndarray] = None  # 4x4


@dataclass
class PoseGraphValue:
    key: PoseKey = field(default_factory=lambda: PoseKey(0, 0))
    pose: np.ndarray = field(default_factory=identity_pose)


@dataclass
class PoseGraphEdge:
    key_from: PoseKey = field(default_factory=lambda: PoseKey(0, 0))
    key_to: PoseKey = field(default_factory=lambda: PoseKey(0, 0))
    measurement: np.ndarray = field(default_factory=identity_pose)  # 4x4
    noise_sigmas: np.ndarray = field(
        default_factory=lambda: np.full(6, 0.1))  # 6-vector, rot(3)+trans(3)


@dataclass
class PoseGraph:
    robot_id: int = 0
    origin_robot_id: int = 0
    values: List[PoseGraphValue] = field(default_factory=list)
    edges: List[PoseGraphEdge] = field(default_factory=list)
    connected_robots: List[int] = field(default_factory=list)
    gps_values_idx: List[int] = field(default_factory=list)
    gps_values: List[Any] = field(default_factory=list)
    # evaluation extras (reference Logger::fill_msg, src/back_end/utils/logger.cpp:325-334)
    log_info: Dict[str, float] = field(default_factory=dict)


@dataclass
class OptimizationResult:
    success: bool = False
    origin_robot_id: int = 0
    estimates: List[PoseGraphValue] = field(default_factory=list)
    factors: List[PoseGraphEdge] = field(default_factory=list)


@dataclass
class OptimizerStateMsg:
    state: int = 0


@dataclass
class RobotIds:
    ids: List[int] = field(default_factory=list)


@dataclass
class RobotIdsAndOrigin:
    robots: RobotIds = field(default_factory=RobotIds)
    origins: RobotIds = field(default_factory=RobotIds)


@dataclass
class ReferenceFrames:
    robot_id: int = 0
    origin_to_local: Optional[np.ndarray] = None  # 4x4


@dataclass
class VizPointCloud:
    robot_id: int = 0
    keyframe_id: int = 0
    points: Optional[np.ndarray] = None


@dataclass
class KeyValue:
    key: str = ""
    value: str = ""


@dataclass
class Heartbeat:
    """Liveness beacon carrying the origin robot id (reference publishes a
    ``UInt32`` with that payload, ``src/back_end/decentralized_pgo.cpp:683-694``)."""

    origin_robot_id: int = 0


def copy_msg(msg):
    """Deep-ish copy of a message for bus delivery isolation."""
    return dataclasses.replace(msg) if dataclasses.is_dataclass(msg) else msg

"""Host-side runtime: the thin messaging/orchestration plane.

The reference runs on ROS 2 pub/sub (DDS) with namespaced topics
(``/r{i}/cslam/...``), heartbeat liveness, windowed-resend gossip, and an
elected-optimizer PGO state machine. Here that plane is an explicit,
dependency-free runtime: a typed in-process message bus with the same topic
semantics (swappable for a networked transport), virtual or wall clocks,
and node objects (front end / detection / back end) that mirror the
reference processes. Device code never blocks on this plane.
"""

from cslam_tpu_torch.runtime.bus import MessageBus, RobotContext  # noqa: F401
from cslam_tpu_torch.runtime.clock import VirtualClock, WallClock  # noqa: F401
from cslam_tpu_torch.runtime.backend_node import DecentralizedPGO  # noqa: F401
from cslam_tpu_torch.runtime.lcd_node import DetectionFrontEnd  # noqa: F401
from cslam_tpu_torch.runtime.lidar_frontend import LidarFrontEnd  # noqa: F401
from cslam_tpu_torch.runtime.rgbd_frontend import (  # noqa: F401
    CameraModel, RGBDFrontEnd, StereoFrontEnd)
from cslam_tpu_torch.runtime.map_manager import make_map_manager  # noqa: F401

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

# the nodes import torch; they load at first use, so that the host-only
# modules (bus, clock, transport) start without it
_NODES = {"DecentralizedPGO": "backend_node",
          "DetectionFrontEnd": "lcd_node",
          "LidarFrontEnd": "lidar_frontend",
          "CameraModel": "rgbd_frontend", "RGBDFrontEnd": "rgbd_frontend",
          "StereoFrontEnd": "rgbd_frontend",
          "make_map_manager": "map_manager"}
__all__ = ["MessageBus", "RobotContext", "VirtualClock", "WallClock",
           *_NODES]


def __getattr__(name):
    if name in _NODES:
        import importlib
        module = importlib.import_module(f"{__name__}.{_NODES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

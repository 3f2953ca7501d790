"""Map-manager factory: pick the sensor handler from configuration.

Parity with the reference's map_manager executable
(``src/front_end/map_manager_node.cpp:34-45``): ``frontend.sensor_type``
selects stereo / rgbd / lidar; each handler pumps its own fixed-rate
processing timer (``map_manager.cpp:17-27``). Counterpart of
``cslam_tpu/runtime/map_manager.py``; the handler's verification runs on
``device`` (CUDA unless the caller passes another).
"""
from __future__ import annotations

from typing import Optional

from cslam_tpu_torch.runtime.lidar_frontend import LidarFrontEnd
from cslam_tpu_torch.runtime.rgbd_frontend import (CameraModel, RGBDFrontEnd,
                                                   StereoFrontEnd)


def make_map_manager(ctx, camera: Optional[CameraModel] = None, device=None):
    """Instantiate the configured sensor front end for one robot."""
    sensor_type = str(ctx.params.get("frontend.sensor_type",
                                     "stereo")).lower()
    if sensor_type == "lidar":
        return LidarFrontEnd(ctx, device=device)
    if camera is None:
        raise ValueError(
            f"sensor_type '{sensor_type}' requires a CameraModel")
    if sensor_type == "stereo":
        return StereoFrontEnd(ctx, camera, device=device)
    if sensor_type in ("rgbd", "rgb_d", "depth"):
        return RGBDFrontEnd(ctx, camera, device=device)
    raise ValueError(f"unknown frontend.sensor_type: {sensor_type}")

"""Visualization helpers.

Equivalent of the reference's visualization plane
(``src/front_end/visualization_utils.cpp``: depth + RGB -> colored point
cloud for RViz; ``rgbd_handler.cpp:613-682``; pose-graph publishers). Here
clouds are numpy arrays on ``/cslam/viz/*`` topics and pose graphs can be
dumped to PLY for any viewer. A copy of ``cslam_tpu/runtime/visualization.py``
(host-only numpy) on the port's ``utils.point_cloud2``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def create_colored_pointcloud(depth: np.ndarray, rgb: np.ndarray,
                              fx: float, fy: float, cx: float, cy: float,
                              max_depth: float = 50.0,
                              stride: int = 1) -> np.ndarray:
    """Back-project a depth image into a colored cloud: ``[N, 6]`` (xyz, rgb).

    Mirrors ``visualization_utils.cpp:8-101`` (templated uint16/float depth):
    invalid (zero / too-far / non-finite) depths are dropped; uint16 depths
    are interpreted as millimeters.
    """
    depth = np.asarray(depth)
    if depth.dtype == np.uint16:
        depth = depth.astype(np.float32) / 1000.0
    depth = depth[::stride, ::stride].astype(np.float32)
    rgb = np.asarray(rgb)[::stride, ::stride]
    h, w = depth.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    z = depth
    valid = np.isfinite(z) & (z > 0) & (z < max_depth)
    z = z[valid]
    u = (us[valid] * stride).astype(np.float32)
    v = (vs[valid] * stride).astype(np.float32)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    if rgb.ndim == 2:
        colors = np.stack([rgb[valid]] * 3, axis=1).astype(np.float32)
    else:
        colors = rgb[valid].astype(np.float32)
    return np.concatenate([np.stack([x, y, z], axis=1), colors], axis=1)


def colored_cloud_to_pointcloud2(cloud: np.ndarray, frame_id: str = "",
                                 stamp: float = 0.0):
    """``[N, 6]`` (xyz, rgb 0-255) -> binary :class:`PointCloud2` with the
    RViz-conventional packed-``rgb`` float field.

    The reference publishes its colored clouds as exactly this layout
    (``visualization_utils.cpp:8-56``: ``pcl::PointXYZRGB`` -> 16-byte
    stride with the three color bytes packed into one word). Bridges the
    ``/cslam/viz/*`` numpy clouds to any ROS/RViz consumer.
    """
    from cslam_tpu_torch.utils.point_cloud2 import make_cloud

    cloud = np.asarray(cloud, np.float32)
    rec = np.zeros(cloud.shape[0],
                   dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                          ("rgb", "<f4")])
    rec["x"], rec["y"], rec["z"] = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    rgb8 = np.clip(cloud[:, 3:6], 0, 255).astype(np.uint32)
    packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
    rec["rgb"] = packed.view(np.float32)
    return make_cloud(rec, frame_id=frame_id, stamp=stamp)


def pointcloud2_to_colored_cloud(cloud) -> np.ndarray:
    """Inverse of :func:`colored_cloud_to_pointcloud2` (round-trip tested)."""
    from cslam_tpu_torch.utils.point_cloud2 import read_points

    pts = read_points(cloud, ["x", "y", "z", "rgb"])
    packed = np.ascontiguousarray(pts["rgb"]).view(np.uint32)
    rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                    packed & 0xFF], axis=1).astype(np.float32)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], axis=1)
    return np.concatenate([xyz, rgb], axis=1)


def pose_graph_to_ply(path: str,
                      values: Dict[Tuple[int, int], np.ndarray],
                      edges=None) -> None:
    """Dump pose positions (+ optional edges) as an ASCII PLY file."""
    keys = sorted(values)
    index = {k: i for i, k in enumerate(keys)}
    edge_rows = []
    for e in (edges or []):
        a, b = e.key_from.as_tuple(), e.key_to.as_tuple()
        if a in index and b in index:
            edge_rows.append((index[a], index[b]))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(keys)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edge_rows)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        palette = [(228, 26, 28), (55, 126, 184), (77, 175, 74),
                   (152, 78, 163), (255, 127, 0), (255, 255, 51)]
        for k in keys:
            t = np.asarray(values[k])[:3, 3]
            r, g, b = palette[k[0] % len(palette)]
            f.write(f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {r} {g} {b}\n")
        for a, b in edge_rows:
            f.write(f"{a} {b}\n")

"""Scan Context descriptor wrapper (the lidar technique's model).

Counterpart of ``cslam_tpu/models/scancontext.py`` (reference
``cslam/lidar_pr/scancontext.py``): fixed 20x60 shape, 80 m max radius,
flattened output. The default path bins on the host
(``frontend.scancontext_host_binning``); otherwise the cloud is binned on
the model's device by ``ops.scancontext.points_to_scancontext``. The JAX
model padded clouds to power-of-two point tiers so that the jitted binning
compiled once per tier; eager PyTorch compiles nothing per shape, so the
cloud goes as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.ops import scancontext as sc_ops


class ScanContext:
    """Scan Context descriptor for point clouds."""

    def __init__(self, params: dict, node=None, device=None):
        self.params = params
        self.shape = [sc_ops.NUM_RING, sc_ops.NUM_SECTOR]
        self.max_length = sc_ops.MAX_LENGTH
        self.host_binning = bool(params.get(
            "frontend.scancontext_host_binning", True))
        self.device = resolve_device(device)

    def warmup(self, max_points: int) -> None:
        """Run the device binning once (no-op on the host-binning path):
        the one-time CUDA context and allocator set-up."""
        if not self.host_binning:
            self.compute_embedding(np.zeros((max_points, 3), np.float32))

    def compute_embedding(self, keyframe: np.ndarray) -> np.ndarray:
        """``[N, 3]`` points -> flattened ``[1200]`` descriptor."""
        pts = np.asarray(keyframe, np.float32).reshape(-1, 3)
        if self.host_binning:
            return sc_ops.points_to_scancontext_np(pts).reshape(-1)
        sc = sc_ops.points_to_scancontext(
            torch.from_numpy(pts).to(self.device))
        return sc.cpu().numpy().reshape(-1)

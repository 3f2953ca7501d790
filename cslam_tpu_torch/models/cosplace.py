"""CosPlace global descriptor (the reference's default technique) in PyTorch.

Counterpart of ``cslam_tpu/models/cosplace.py``; architecture parity with
``cslam/vpr/cosplace_utils/network.py:19-35``: backbone trunk ->
L2Norm(channel) -> GeM pooling -> Linear(features, dim) -> L2Norm, with the
reference's module names (``backbone.*``, ``aggregation.{1,3}.*``) so its
state_dicts load as they are.

Checkpoint modes (``frontend.nn_checkpoint``):

- a path: the reference's ``.pth`` state_dict;
- ``"disable"``: random descriptors, from the same numpy generator as the
  JAX package (``cosplace.py:102-105`` of the reference), so both packages
  return identical descriptors;
- ``"random"`` (or empty): the seeded reference-layout state_dict
  :func:`~cslam_tpu_torch.models.golden.golden_cosplace_state_dict`. The
  JAX package draws flax ``PRNGKey(0)`` weights here, which torch cannot
  reproduce; tests that compare the two packages carry weights across
  explicitly (``cslam_tpu_torch.convert.cosplace_state_dict_from_jax``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.models import preprocess
from cslam_tpu_torch.models.backbones import make_backbone
from cslam_tpu_torch.utils import device_read


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x / max(||x||, 1e-12)`` along ``dim``."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=1e-12)


class L2Norm(nn.Module):
    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return l2_normalize(x, self.dim)


class GeM(nn.Module):
    """Generalized-mean pooling over the spatial dims (reference
    ``layers.py:8-9``): ``[N, C, H, W] -> [N, C]``."""

    def __init__(self, p: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.ones(1) * p)
        self.eps = eps

    def forward(self, x):
        x = torch.clamp(x, min=self.eps) ** self.p
        return x.mean(dim=(2, 3)) ** (1.0 / self.p)


class GeoLocalizationNet(nn.Module):
    """Backbone + CosPlace aggregation head, NCHW input.

    ``compute_dtype=torch.bfloat16`` keeps the convolutional trunk's weights
    and input in bf16; the head (normalizations, GeM, final projection)
    stays float32 so descriptor similarity ranking is stable.
    """

    def __init__(self, backbone: str = "resnet18", fc_output_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone, features = make_backbone(backbone)
        self.backbone.to(compute_dtype)
        self.compute_dtype = compute_dtype
        self.aggregation = nn.Sequential(
            L2Norm(), GeM(), nn.Flatten(),
            nn.Linear(features, fc_output_dim), L2Norm())

    def forward(self, x):
        x = self.backbone(x.to(self.compute_dtype)).float()
        return self.aggregation(x)


def compute_dtype(params: dict) -> torch.dtype:
    """The trunk's type from ``frontend.compute_dtype``."""
    name = str(params.get("frontend.compute_dtype", "float32"))
    return torch.bfloat16 if "bfloat16" in name else torch.float32


class CosPlace:
    """CosPlace matcher with the reference's duck-typed interface."""

    def __init__(self, params: dict, torch_state_dict: Optional[dict] = None,
                 device=None):
        self.params = params
        self.descriptor_dim = params.get("frontend.cosplace.descriptor_dim",
                                         64)
        self.crop = params.get("frontend.image_crop_size", 376)
        self.enable = str(params.get("frontend.nn_checkpoint",
                                     "disable")).lower() != "disable"
        self._rng = np.random.default_rng(params.get("robot_id", 0))
        if not self.enable:
            return
        self.device = resolve_device(device)
        backbone = params.get("frontend.cosplace.backbone", "resnet18")
        self.model = GeoLocalizationNet(backbone, self.descriptor_dim,
                                        compute_dtype(params))
        ckpt = params.get("frontend.nn_checkpoint", "")
        if torch_state_dict is None and ckpt and ckpt.lower() != "random":
            torch_state_dict = torch.load(ckpt, map_location="cpu")
        if torch_state_dict is None:
            from cslam_tpu_torch.models.golden import \
                golden_cosplace_state_dict
            torch_state_dict = golden_cosplace_state_dict(
                fc_output_dim=self.descriptor_dim, backbone=backbone)
        from cslam_tpu_torch.models.convert import load_cosplace
        load_cosplace(self.model, torch_state_dict)
        self.model.to(self.device).eval()

    # ------------------------------------------------------------------

    def compute_embedding(self, keyframe: np.ndarray) -> np.ndarray:
        """Global image descriptor of one image (reference ``cosplace.py:81-105``)."""
        if not self.enable:
            return self._rng.random(self.descriptor_dim)
        return self.compute_embeddings(keyframe[None])[0]

    def compute_embeddings(self, images: np.ndarray) -> np.ndarray:
        """Batched descriptors: ``[B, H, W, 3] -> [B, dim]`` (throughput path;
        the reference runs one image at a time)."""
        if not self.enable:
            return self._rng.random((images.shape[0], self.descriptor_dim))
        return device_read.to_numpy(self._compute_device(images))

    @torch.inference_mode()
    def _compute_device(self, images: np.ndarray) -> torch.Tensor:
        x = preprocess.preprocess(images, self.crop, self.device)
        return self.model(x.permute(0, 3, 1, 2))

    def compute_embedding_begin(self, keyframe: np.ndarray):
        """Dispatch one image's descriptor inference WITHOUT the blocking
        device read; ``compute_embedding_finish`` reads it one poll cycle
        later, when the prefetched copy has landed."""
        if not self.enable:
            return self._rng.random(self.descriptor_dim)
        out = self._compute_device(keyframe[None])
        device_read.prefetch((out,))
        return out

    @staticmethod
    def compute_embedding_finish(pending) -> np.ndarray:
        out = device_read.to_numpy(pending)
        return out[0] if out.ndim == 2 else out

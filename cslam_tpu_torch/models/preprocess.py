"""Image preprocessing matching the reference's torchvision transform.

Counterpart of ``cslam_tpu/models/preprocess.py``: CenterCrop(crop) on the
host, then on the device: scale to [0, 1], Resize(224, bicubic), ImageNet
normalization (reference ``cosplace.py:73-79``, ``netvlad.py:202-208``).

The bicubic resize antialiases when it shrinks, as ``jax.image.resize``
does by default: ``F.interpolate(..., antialias=True)`` matches it to a few
1e-6, while ``antialias=False`` is off by more than 0.5 for a 376 -> 224
crop. Images come in and go out in the JAX package's NHWC layout; the
returned tensor is an NHWC view of NCHW storage, so the models' NCHW
convolutions read it without a copy.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
TARGET = 224


def center_crop(images: np.ndarray, crop: int) -> np.ndarray:
    """Host-side center crop (sizes vary per dataset; crop before batching)."""
    h, w = images.shape[-3:-1]
    ch, cw = min(crop, h), min(crop, w)
    top, left = (h - ch) // 2, (w - cw) // 2
    return images[..., top:top + ch, left:left + cw, :]


def normalize_and_resize(images: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` uint8/float -> ``[B, 224, 224, 3]`` normalized
    float32, on the images' device."""
    x = images.float().permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=(TARGET, TARGET), mode="bicubic",
                      align_corners=False, antialias=True)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)


def preprocess(images: np.ndarray, crop: int,
               device: torch.device) -> torch.Tensor:
    """Full pipeline for a batch (adds the batch dim for single images)."""
    if images.ndim == 3:
        images = images[None]
    host = torch.from_numpy(np.ascontiguousarray(center_crop(images, crop)))
    return normalize_and_resize(host.to(device, non_blocking=True))

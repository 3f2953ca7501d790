"""NetVLAD global descriptor in PyTorch.

Counterpart of ``cslam_tpu/models/netvlad.py``; architecture parity with
the reference (``cslam/vpr/netvlad.py``): VGG16 conv trunk + NetVLAD
pooling (64 clusters x 512 dims) + PCA projection + L2 normalization, with
the reference's module names (``encoder.*``, ``pool.conv``,
``pool.centroids``). The reference's per-cluster residual loop
(``netvlad.py:119-124``) is two batched products:

    vlad[n,k,c] = sum_p soft[n,k,p] * (x[n,c,p] - centroid[k,c])
                = (soft @ x^T)[n,k,c] - (sum_p soft[n,k,p]) * centroid[k,c]

Checkpoint modes as in :mod:`cslam_tpu_torch.models.cosplace`:
``"disable"`` returns 128-dim random descriptors from the JAX package's
numpy generator (``netvlad.py:242-245``); ``"random"`` (or empty) loads the
seeded :func:`~cslam_tpu_torch.models.golden.golden_netvlad_state_dict`
(the JAX package's flax ``PRNGKey(0)`` weights cannot be reproduced).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.models import preprocess
from cslam_tpu_torch.models.backbones import vgg16_features
from cslam_tpu_torch.models.cosplace import (CosPlace, compute_dtype,
                                              l2_normalize)
from cslam_tpu_torch.utils import device_read


class NetVLADLayer(nn.Module):
    """Soft-assignment VLAD pooling (reference ``netvlad.py:28-130``),
    ``[N, C, H, W] -> [N, K * C]``."""

    def __init__(self, num_clusters: int = 64, dim: int = 512,
                 normalize_input: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(dim, num_clusters, 1, bias=False)
        self.centroids = nn.Parameter(torch.rand(num_clusters, dim))
        self.normalize_input = normalize_input

    def forward(self, x):
        N, C = x.shape[:2]
        if self.normalize_input:
            x = l2_normalize(x, 1)
        soft = torch.softmax(self.conv(x).reshape(N, self.conv.out_channels,
                                                  -1), dim=1)   # [N, K, P]
        feats = x.reshape(N, C, -1)                             # [N, C, P]
        vlad = (torch.bmm(soft, feats.transpose(1, 2))
                - soft.sum(dim=2)[..., None] * self.centroids[None])
        vlad = l2_normalize(vlad, 2).reshape(N, -1)
        return l2_normalize(vlad, 1)


class NetVLADNet(nn.Module):
    """``compute_dtype=torch.bfloat16`` keeps the VGG16 trunk in bf16 (as
    CosPlace's GeoLocalizationNet does); the VLAD pooling, normalizations
    and PCA stay float32."""

    def __init__(self, num_clusters: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = vgg16_features().to(compute_dtype)
        self.compute_dtype = compute_dtype
        self.pool = NetVLADLayer(num_clusters, 512)

    def forward(self, x):
        return self.pool(self.encoder(x.to(self.compute_dtype)).float())


class NetVLAD:
    """NetVLAD matcher with the reference's duck-typed interface."""

    RAW_DIM = 64 * 512
    DISABLED_DIM = 128  # reference returns 128-dim random when disabled

    def __init__(self, params: dict, torch_state_dict: Optional[dict] = None,
                 pca: Optional[dict] = None, device=None):
        self.params = params
        self.crop = params.get("frontend.image_crop_size", 376)
        self.enable = str(params.get("frontend.nn_checkpoint",
                                     "disable")).lower() != "disable"
        self._rng = np.random.default_rng(params.get("robot_id", 0))
        if not self.enable:
            return
        self.device = resolve_device(device)
        self.model = NetVLADNet(compute_dtype=compute_dtype(params))
        ckpt = params.get("frontend.nn_checkpoint", "")
        if torch_state_dict is None and ckpt and ckpt.lower() != "random":
            payload = torch.load(ckpt, map_location="cpu")
            torch_state_dict = payload.get("state_dict", payload)
        if torch_state_dict is None:
            from cslam_tpu_torch.models.golden import \
                golden_netvlad_state_dict
            torch_state_dict = golden_netvlad_state_dict()
        from cslam_tpu_torch.models.convert import load_netvlad
        load_netvlad(self.model, torch_state_dict)
        self.model.to(self.device).eval()

        # PCA projection: components [out_dim, RAW_DIM], mean [RAW_DIM]
        # (the reference unpickles a fitted sklearn PCA, ``netvlad.py:209-210``)
        pca_path = params.get("frontend.netvlad.pca_checkpoint", "")
        if pca is None and pca_path:
            import pickle

            from cslam_tpu_torch.models.pca import from_sklearn
            with open(pca_path, "rb") as f:
                pca = from_sklearn(pickle.load(f))
        if pca is None:
            pca = {"components": np.eye(self.DISABLED_DIM, self.RAW_DIM,
                                        dtype=np.float32),
                   "mean": np.zeros(self.RAW_DIM, np.float32)}
        self._pca_components = torch.as_tensor(
            np.asarray(pca["components"], np.float32), device=self.device)
        self._pca_mean = torch.as_tensor(np.asarray(pca["mean"], np.float32),
                                         device=self.device)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """VLAD + PCA + L2 on preprocessed NHWC input."""
        vlad = self.model(x.permute(0, 3, 1, 2))
        reduced = (vlad - self._pca_mean) @ self._pca_components.T
        return l2_normalize(reduced, 1)

    def compute_embedding(self, keyframe: np.ndarray) -> np.ndarray:
        if not self.enable:
            return self._rng.random(self.DISABLED_DIM)
        return self.compute_embeddings(keyframe[None])[0]

    def compute_embeddings(self, images: np.ndarray) -> np.ndarray:
        if not self.enable:
            return self._rng.random((images.shape[0], self.DISABLED_DIM))
        x = preprocess.preprocess(images, self.crop, self.device)
        return device_read.to_numpy(self._forward(x))

    def compute_embedding_begin(self, keyframe: np.ndarray):
        """Dispatch one image's descriptor WITHOUT the blocking device read
        (see ``CosPlace.compute_embedding_begin``)."""
        if not self.enable:
            return self._rng.random(self.DISABLED_DIM)
        out = self._forward(preprocess.preprocess(keyframe[None], self.crop,
                                                  self.device))
        device_read.prefetch((out,))
        return out

    compute_embedding_finish = staticmethod(CosPlace.compute_embedding_finish)

    def forward_preprocessed(self, x: np.ndarray) -> np.ndarray:
        """Full forward (VLAD + PCA + normalize) on already-preprocessed
        NHWC input."""
        return device_read.to_numpy(self._forward(
            torch.as_tensor(np.asarray(x, np.float32), device=self.device)))

    @torch.inference_mode()
    def compute_vlad(self, x: np.ndarray) -> np.ndarray:
        """Raw (pre-PCA) VLAD descriptors for preprocessed NHWC input."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return device_read.to_numpy(self.model(x.permute(0, 3, 1, 2)))

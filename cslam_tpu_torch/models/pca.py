"""PCA fitting/projection for NetVLAD descriptor reduction.

Counterpart of ``cslam_tpu/models/pca.py``. The reference loads a
pre-fitted sklearn PCA from a pickle (``netvlad.py:209-210``,
``netvlad_pca.pkl`` from ``models/download.sh``). This module (a) fits an
equivalent projection from a sample of raw VLAD descriptors, so a
deployment can whiten on its own data without sklearn, and (b) converts a
fitted sklearn PCA into the dict ``cslam_tpu_torch.models.netvlad.NetVLAD``
consumes, reading its attributes only (sklearn is not imported).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cslam_tpu_torch import resolve_device


def fit_pca(descriptors: np.ndarray, out_dim: int, whiten: bool = False,
            device=None) -> Dict[str, np.ndarray]:
    """Fit a PCA projection: ``[N, D] -> {components [out_dim, D], mean [D]}``.

    Matches sklearn semantics (components = right singular vectors of the
    centered data, up to sign); one SVD on ``device``.
    """
    x = torch.as_tensor(np.asarray(descriptors, np.float32),
                        device=resolve_device(device))
    mean = x.mean(dim=0)
    _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    components = vt[:out_dim].cpu().numpy()
    if whiten:
        n = descriptors.shape[0]
        scale = np.sqrt(n - 1) / np.maximum(s[:out_dim].cpu().numpy(), 1e-12)
        components = components * scale[:, None]
    return {"components": components.astype(np.float32),
            "mean": mean.cpu().numpy().astype(np.float32)}


def from_sklearn(pca) -> Dict[str, np.ndarray]:
    """Convert a fitted ``sklearn.decomposition.PCA`` (what the reference
    pickles) into the projection dict. Folds ``whiten=True`` (sklearn's
    transform divides by sqrt(explained_variance_)) into the components so
    the projection matches ``pca.transform`` exactly."""
    components = np.asarray(pca.components_, np.float32)
    if getattr(pca, "whiten", False):
        scale = np.sqrt(np.asarray(pca.explained_variance_, np.float32))
        components = components / np.maximum(scale, 1e-12)[:, None]
    return {"components": components,
            "mean": np.asarray(pca.mean_, np.float32)}

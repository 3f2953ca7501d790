"""Reference-layout torch checkpoints into the port's VPR models.

Counterpart of ``cslam_tpu/models/convert.py``. The reference ships torch
state_dicts (``models/download.sh``: CosPlace ``resnet18_64.pth`` = a
GeoLocalizationNet state_dict, NetVLAD ``netvlad.pth.tar`` =
``{'state_dict': ...}``). The port's modules keep the reference's key
layout, so no transposes are needed here: only the DataParallel
``module.`` prefixes and NetVLAD's ``encoder.module.`` / ``pool.module.``
wrappers come off, and numpy arrays become tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def strip_prefix(sd: Dict, prefix: str = "module.") -> Dict:
    """Remove DataParallel wrapping prefixes (reference ``netvlad.py:182-185``)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def _tensors(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_cosplace(model: nn.Module, sd: Dict) -> nn.Module:
    """Load a reference GeoLocalizationNet state_dict (reference model
    structure at ``network.py:19-35``) into ``model``, strictly."""
    model.load_state_dict(_tensors(strip_prefix(sd)))
    return model


def load_netvlad(model: nn.Module, sd: Dict) -> nn.Module:
    """Load a reference NetVLAD state_dict (modules 'encoder' + 'pool',
    ``netvlad.py:171-177``) into ``model``, strictly."""
    sd = strip_prefix(sd)
    sd = {k.replace("encoder.module.", "encoder.")
           .replace("pool.module.", "pool."): v for k, v in sd.items()}
    model.load_state_dict(_tensors(sd))
    return model

"""Carry state from the JAX package into the port, as numpy arrays.

The port never imports ``cslam_tpu``; a caller that holds the reference's
state (the parity tests do) passes its fields as numpy arrays:

- :func:`pose_graph_arrays_from_numpy` takes the fields of a ``cslam_tpu``
  ``PoseGraphArrays`` (``{field name: np.ndarray}``) and returns the port's
  ``PoseGraphArrays`` on ``device``;
- :func:`bank_from_numpy` builds a port ``DescriptorBank`` from the host
  rows, the valid count ``n`` and the item records of a reference bank;
- :func:`cosplace_state_dict_from_jax` and :func:`netvlad_state_dict_from_jax`
  take the reference's flax variables (``{"params": ...}``, leaves as
  arrays) and return the port model's reference-layout ``state_dict`` as
  numpy: the inverse of ``cslam_tpu/models/convert.py`` (conv HWIO -> OIHW,
  dense kernel transposed, BatchNorm ``scale/bias/mean/var`` ->
  ``weight/bias/running_mean/running_var``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.matching.nns_bank import DescriptorBank
from cslam_tpu_torch.models.backbones import _VGG16_PLAN
from cslam_tpu_torch.pgo.factor_graph import PoseGraphArrays, arrays_from_numpy


def pose_graph_arrays_from_numpy(fields: Mapping[str, np.ndarray],
                                 device=None) -> PoseGraphArrays:
    """The port's ``PoseGraphArrays`` from a reference graph's fields."""
    return arrays_from_numpy(dict(fields), resolve_device(device))


def bank_from_numpy(rows: np.ndarray, n: int, items: Dict[int, Any],
                    capacity: Optional[int] = None, dtype: str = "float32",
                    device=None) -> DescriptorBank:
    """A port ``DescriptorBank`` holding the first ``n`` host ``rows`` (the
    reference bank's ``data``) with their ``items``; ``capacity`` defaults
    to the rows' length."""
    rows = np.asarray(rows, np.float32)
    bank = DescriptorBank(dim=rows.shape[1],
                          capacity=capacity or max(len(rows), 1),
                          dtype=dtype, device=device)
    bank.add_items(rows[:n], [items[i] for i in range(n)])
    return bank


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _conv_from_jax(kernel) -> np.ndarray:
    return np.ascontiguousarray(_np(kernel).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _bn_from_jax(sd: Dict, prefix: str, bn: Mapping) -> None:
    sd[prefix + ".weight"] = _np(bn["scale"])
    sd[prefix + ".bias"] = _np(bn["bias"])
    sd[prefix + ".running_mean"] = _np(bn["mean"])
    sd[prefix + ".running_var"] = _np(bn["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _resnet_from_jax(sd: Dict, trunk: Mapping, prefix: str) -> None:
    """flax ``ResNetFeatures`` params -> torchvision ``Sequential`` keys
    (0 = conv1, 1 = bn1, 4..7 = layer1..4)."""
    sd[f"{prefix}0.weight"] = _conv_from_jax(trunk["conv1"]["kernel"])
    _bn_from_jax(sd, f"{prefix}1", trunk["bn1"])
    for name, block in trunk.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        bp = f"{prefix}{int(stage) + 3}.{b}."
        for key, value in block.items():
            if key == "downsample_conv":
                sd[bp + "downsample.0.weight"] = _conv_from_jax(
                    value["kernel"])
            elif key == "downsample_bn":
                _bn_from_jax(sd, bp + "downsample.1", value)
            elif key.startswith("conv"):
                sd[bp + key + ".weight"] = _conv_from_jax(value["kernel"])
            else:
                _bn_from_jax(sd, bp + key, value)


def _vgg16_from_jax(sd: Dict, trunk: Mapping, prefix: str) -> None:
    """flax ``VGG16Features`` params (conv0..conv12) -> ``features[:-2]``
    Sequential indices (0, 2, 5, ..., 28)."""
    conv_idx = seq_idx = 0
    for item in _VGG16_PLAN:
        if item == "M":
            seq_idx += 1
            continue
        conv = trunk[f"conv{conv_idx}"]
        sd[f"{prefix}{seq_idx}.weight"] = _conv_from_jax(conv["kernel"])
        sd[f"{prefix}{seq_idx}.bias"] = _np(conv["bias"])
        conv_idx += 1
        seq_idx += 2


def cosplace_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The reference's ``GeoLocalizationNet`` flax variables -> the port's
    ``GeoLocalizationNet`` state_dict (any backbone)."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    if "ResNetFeatures_0" in params:
        _resnet_from_jax(sd, params["ResNetFeatures_0"], "backbone.")
    else:
        _vgg16_from_jax(sd, params["VGG16Features_0"], "backbone.")
    sd["aggregation.1.p"] = _np(params["gem_p"]).reshape(1)
    sd["aggregation.3.weight"] = np.ascontiguousarray(
        _np(params["fc"]["kernel"]).T)
    sd["aggregation.3.bias"] = _np(params["fc"]["bias"])
    return sd


def netvlad_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The reference's ``NetVLADNet`` flax variables -> the port's
    ``NetVLADNet`` state_dict."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    _vgg16_from_jax(sd, params["encoder"], "encoder.")
    sd["pool.conv.weight"] = _conv_from_jax(params["pool"]["conv"]["kernel"])
    sd["pool.centroids"] = _np(params["pool"]["centroids"])
    return sd

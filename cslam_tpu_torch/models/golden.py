"""Deterministic synthetic VPR checkpoints, numpy only.

Counterpart of ``cslam_tpu/models/golden.py``, byte for byte the same
state_dicts and images from the same seeds. The reference's descriptor
quality rests on downloaded torch weights; those are unreachable offline,
so these full-architecture state_dicts (the exact key names and shapes of
the reference checkpoints: torchvision ``Sequential`` layout for the
trunks, ``aggregation.*`` / ``pool.*`` heads) stand in for them. The torch
oracle's descriptors for them are stored in ``tests/data/vpr_goldens.npz``.

Weight scales keep activations O(1) through the deep conv stacks
(He-style fan-in scaling; BN statistics near identity).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from cslam_tpu_torch.models.backbones import _RESNET_LAYERS, _VGG16_PLAN


def _conv_w(rng, cout, cin, kh, kw):
    fan_in = cin * kh * kw
    return rng.normal(0.0, np.sqrt(2.0 / fan_in),
                      (cout, cin, kh, kw)).astype(np.float32)


def _bn(rng, sd: Dict, prefix: str, c: int) -> None:
    sd[prefix + ".weight"] = rng.uniform(0.7, 1.3, c).astype(np.float32)
    sd[prefix + ".bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    sd[prefix + ".running_mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    sd[prefix + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def golden_resnet18_trunk(rng, sd: Dict, prefix: str) -> None:
    """torchvision resnet18 trunk as nn.Sequential (0=conv1, 1=bn1,
    4..7=layer1..4)."""
    sd[f"{prefix}0.weight"] = _conv_w(rng, 64, 3, 7, 7)
    _bn(rng, sd, f"{prefix}1", 64)
    blocks, _ = _RESNET_LAYERS["resnet18"]
    cin = 64
    for stage, (n_blocks, feats) in enumerate(
            zip(blocks, (64, 128, 256, 512))):
        seq = stage + 4
        for b in range(n_blocks):
            stride_block = stage > 0 and b == 0
            bp = f"{prefix}{seq}.{b}."
            sd[bp + "conv1.weight"] = _conv_w(rng, feats, cin, 3, 3)
            _bn(rng, sd, bp + "bn1", feats)
            sd[bp + "conv2.weight"] = _conv_w(rng, feats, feats, 3, 3)
            _bn(rng, sd, bp + "bn2", feats)
            if stride_block or cin != feats:
                sd[bp + "downsample.0.weight"] = _conv_w(rng, feats, cin,
                                                         1, 1)
                _bn(rng, sd, bp + "downsample.1", feats)
            cin = feats


def golden_bottleneck_trunk(rng, sd: Dict, prefix: str,
                            variant: str = "resnet50") -> None:
    """torchvision resnet50/101/152 trunk as nn.Sequential (Bottleneck
    blocks: conv1/conv2/conv3 + downsample on every stage's first block,
    including layer1 where the expansion 64 -> 256 forces one)."""
    sd[f"{prefix}0.weight"] = _conv_w(rng, 64, 3, 7, 7)
    _bn(rng, sd, f"{prefix}1", 64)
    blocks, _ = _RESNET_LAYERS[variant]
    cin = 64
    for stage, (n_blocks, width) in enumerate(
            zip(blocks, (64, 128, 256, 512))):
        seq = stage + 4
        cout = width * 4
        for b in range(n_blocks):
            bp = f"{prefix}{seq}.{b}."
            sd[bp + "conv1.weight"] = _conv_w(rng, width, cin, 1, 1)
            _bn(rng, sd, bp + "bn1", width)
            sd[bp + "conv2.weight"] = _conv_w(rng, width, width, 3, 3)
            _bn(rng, sd, bp + "bn2", width)
            sd[bp + "conv3.weight"] = _conv_w(rng, cout, width, 1, 1)
            _bn(rng, sd, bp + "bn3", cout)
            if b == 0:  # stride (stages 2-4) or expansion (stage 1)
                sd[bp + "downsample.0.weight"] = _conv_w(rng, cout, cin,
                                                         1, 1)
                _bn(rng, sd, bp + "downsample.1", cout)
            cin = cout


def golden_vgg16_trunk(rng, sd: Dict, prefix: str) -> None:
    """torchvision vgg16.features[:-2] as nn.Sequential (conv indices
    0,2,5,...,28)."""
    cin, seq_idx = 3, 0
    for item in _VGG16_PLAN:
        if item == "M":
            seq_idx += 1
            continue
        sd[f"{prefix}{seq_idx}.weight"] = _conv_w(rng, item, cin, 3, 3)
        sd[f"{prefix}{seq_idx}.bias"] = rng.normal(
            0.0, 0.05, item).astype(np.float32)
        cin = item
        seq_idx += 2


_COSPLACE_TRUNKS = {
    "resnet18": (golden_resnet18_trunk, 512),
    "resnet50": (golden_bottleneck_trunk, 2048),
    "resnet101": (functools.partial(golden_bottleneck_trunk,
                                    variant="resnet101"), 2048),
    "resnet152": (functools.partial(golden_bottleneck_trunk,
                                    variant="resnet152"), 2048),
    "vgg16": (golden_vgg16_trunk, 512),
}


def golden_cosplace_state_dict(seed: int = 7, fc_output_dim: int = 64,
                               backbone: str = "resnet18") -> Dict:
    """Reference-layout CosPlace state_dict from a seed, for any backbone
    the config accepts (reference ``network.py:38-68``)."""
    rng = np.random.default_rng(seed)
    trunk, features_dim = _COSPLACE_TRUNKS[backbone]
    sd: Dict = {}
    trunk(rng, sd, "backbone.")
    sd["aggregation.1.p"] = np.asarray([3.0], np.float32)
    sd["aggregation.3.weight"] = rng.normal(
        0.0, np.sqrt(1.0 / features_dim),
        (fc_output_dim, features_dim)).astype(np.float32)
    sd["aggregation.3.bias"] = rng.normal(
        0.0, 0.01, fc_output_dim).astype(np.float32)
    return sd


def golden_netvlad_state_dict(seed: int = 11) -> Dict:
    """Reference-layout NetVLAD state_dict (modules 'encoder' + 'pool')."""
    rng = np.random.default_rng(seed)
    sd: Dict = {}
    golden_vgg16_trunk(rng, sd, "encoder.")
    sd["pool.conv.weight"] = rng.normal(
        0.0, np.sqrt(2.0 / 512), (64, 512, 1, 1)).astype(np.float32)
    sd["pool.centroids"] = rng.normal(0.0, 0.1, (64, 512)).astype(np.float32)
    return sd


def golden_pca(seed: int = 13, out_dim: int = 128,
               in_dim: int = 64 * 512) -> Dict:
    """Deterministic PCA dict in the internal {components, mean} format."""
    rng = np.random.default_rng(seed)
    comp = rng.normal(0.0, 1.0, (out_dim, in_dim)).astype(np.float32)
    comp /= np.linalg.norm(comp, axis=1, keepdims=True)
    return {"components": comp,
            "mean": rng.normal(0.0, 0.01, in_dim).astype(np.float32)}


def golden_images(seed: int = 3, batch: int = 2,
                  size: int = 64) -> np.ndarray:
    """Deterministic NHWC float32 test images."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)).astype(np.float32)

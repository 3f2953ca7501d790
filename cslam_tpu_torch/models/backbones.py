"""Inference-only CNN backbones (ResNet / VGG16) as PyTorch modules, NCHW.

Counterpart of ``cslam_tpu/models/backbones.py``; these replace the
torchvision backbones the reference loads
(``cslam/vpr/cosplace_utils/network.py:38-68``, ``cslam/vpr/netvlad.py:162-171``)
without importing ``torchvision``. Module and parameter names follow
torchvision's ``nn.Sequential`` layout (0 = conv1, 1 = bn1, 4..7 =
layer1..4; VGG16 ``features`` indices), so reference-layout state_dicts
load without remapping.

BatchNorm runs in inference mode with its stored statistics, folded the way
the JAX package writes it: ``inv = weight * rsqrt(var + 1e-5)``, then
``x * inv + (bias - mean * inv)`` (``BatchNorm2d.eval()`` rounds
differently).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch import nn

FEATURES_DIM = {
    "resnet18": 512,
    "resnet50": 2048,
    "resnet101": 2048,
    "resnet152": 2048,
    "vgg16": 512,
}

_RESNET_LAYERS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}

# VGG16 'features' conv plan (torchvision indices); 'M' = maxpool.
_VGG16_PLAN: Sequence[Any] = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                              512, 512, 512, "M", 512, 512, 512)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics only (inference mode); the
    ``BatchNorm2d`` state_dict keys."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def _conv(cin, cout, kernel, stride=1, padding=0):
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)


def _downsample(cin, cout, stride):
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(features)
        self.downsample = (_downsample(cin, features, stride)
                           if stride != 1 or cin != features else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5: stride on the 3x3 conv2); output is
    4x the bottleneck width."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride, 1)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = (_downsample(cin, out, stride)
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + identity)


def resnet_features(variant: str = "resnet18") -> nn.Sequential:
    """ResNet trunk without avgpool/fc (what CosPlace keeps,
    ``network.py:55``). Input NCHW float, output ``[N, C, H/32, W/32]``.
    The max pool pads with -inf, as flax's ``nn.max_pool`` does."""
    blocks, bottleneck = _RESNET_LAYERS[variant]
    block_cls = Bottleneck if bottleneck else BasicBlock
    expansion = 4 if bottleneck else 1
    layers = [_conv(3, 64, 7, 2, 3), FrozenBatchNorm(64), nn.ReLU(),
              nn.MaxPool2d(3, 2, 1)]
    cin = 64
    for stage, (n_blocks, feats) in enumerate(zip(blocks, (64, 128, 256,
                                                          512))):
        stage_blocks = []
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            stage_blocks.append(block_cls(cin, feats, stride))
            cin = feats * expansion
        layers.append(nn.Sequential(*stage_blocks))
    return nn.Sequential(*layers)


def vgg16_features() -> nn.Sequential:
    """VGG16 convolutional trunk truncated like the reference: both NetVLAD
    and CosPlace drop the last ReLU + maxpool (``netvlad.py:164-165``,
    ``network.py:57-59``), ending at conv5_3 *pre-activation*."""
    layers, cin = [], 3
    for item in _VGG16_PLAN:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
            cin = item
    return nn.Sequential(*layers[:-1])


def make_backbone(name: str) -> Tuple[nn.Sequential, int]:
    """(module, feature channels) for a backbone name
    (reference ``network.py:38-68``)."""
    name = name.lower()
    if name.startswith("resnet"):
        return resnet_features(name), FEATURES_DIM[name]
    if name == "vgg16":
        return vgg16_features(), FEATURES_DIM[name]
    raise ValueError(f"unknown backbone: {name}")

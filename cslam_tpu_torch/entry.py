"""The flagship per-keyframe step of the visual front end, the twin of
``__graft_entry__.entry``.

One step: CosPlace (ResNet18 + GeM, fc 64) global-descriptor inference,
then the top-k cosine search of the new descriptors against the
device-resident bank — the reference's two ranked-hottest loops (the VPR
forward and the ``nns_matching`` scan). The search is the tile scan K2
(:func:`cslam_tpu_torch.ops.nns.cosine_topk_fused`), the kernel the JAX
package wrote for this contract: for ``n >= k`` it returns what
``ops.topk.cosine_topk`` returns.

    fn, args = entry()          # CUDA unless device="cpu"
    descriptors, sims, idx = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.models.convert import load_cosplace
from cslam_tpu_torch.models.cosplace import GeoLocalizationNet
from cslam_tpu_torch.models.golden import golden_cosplace_state_dict
from cslam_tpu_torch.ops import nns


@torch.inference_mode()
def frontend_step(model: torch.nn.Module, images: torch.Tensor,
                  bank: torch.Tensor, inv_norms: torch.Tensor, n: int,
                  k: int = 8):
    """Descriptors of preprocessed NHWC ``images`` (the JAX package's
    layout) and their top-``k`` rows among the first ``n`` of ``bank``.
    Returns ``(descriptors [B, dim], sims [B, k], idx [B, k])``."""
    descriptors = model(images.permute(0, 3, 1, 2))
    sims, idx = nns.cosine_topk_fused(bank, inv_norms, n, descriptors, k)
    return descriptors, sims, idx


def entry(device=None):
    """``(frontend_step, example_args)``: the seeded golden CosPlace
    ResNet18 fc-64 model and the JAX entry's example arguments from the same
    numpy generator (a 224 x 224 image, a 1024 x 64 bank, unit inverse
    norms, n = 512), on ``device``."""
    device = resolve_device(device)
    model = GeoLocalizationNet(backbone="resnet18", fc_output_dim=64)
    load_cosplace(model, golden_cosplace_state_dict())
    model.to(device).eval()

    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.random((1, 224, 224, 3)).astype(np.float32)).to(device)
    bank = torch.from_numpy(rng.random((1024, 64)).astype(np.float32)).to(
        device)
    inv_norms = torch.ones(1024, dtype=torch.float32, device=device)
    return frontend_step, (model, images, bank, inv_norms, 512)

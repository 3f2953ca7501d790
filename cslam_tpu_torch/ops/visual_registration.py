"""Robust alignment of corresponded 3D points (GNC-TLS around Kabsch).

Counterpart of ``cslam_tpu/ops/visual_registration.py``, so far only its
robust core, :func:`_gnc_align_core`, which the lidar path's prior-free
registration uses on FPFH correspondences
(``ops.registration._fpfh_alignment``).
The rest of that module, the visual front end's matching and verification,
is ROADMAP.md item 12.
"""
from __future__ import annotations

from typing import Tuple

import torch

from cslam_tpu_torch.ops.registration import _to_T, _weighted_kabsch


def _gnc_align_core(src: torch.Tensor, dst: torch.Tensor,
                    valid: torch.Tensor, inlier_dist, iters: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GNC-TLS rigid alignment of corresponded points ``src[..., i] <->
    dst[..., i]`` (``[..., N, 3]``, ``valid [..., N]``).

    Returns (T ``[..., 4, 4]`` mapping src -> dst, inlier count ``[...]``).
    The surrogate's control parameter starts from the largest valid
    residual and grows by 1.4 per iteration, a fixed count of them."""
    eps_sq = inlier_dist * inlier_dist

    def residual_sq(R, t):
        moved = src @ R.transpose(-1, -2) + t[..., None, :]
        return ((moved - dst) ** 2).sum(-1)

    R, t = _weighted_kabsch(src, dst, valid)
    r2 = residual_sq(R, t)
    max_r2 = torch.where(valid > 0, r2, torch.zeros_like(r2)).amax(-1)
    mu = torch.clamp(eps_sq / torch.clamp(2.0 * max_r2 - eps_sq, min=1e-9),
                     min=1e-6)[..., None]
    for _ in range(iters):
        r2 = residual_sq(R, t)
        upper = (mu + 1.0) / mu * eps_sq
        lower = mu / (mu + 1.0) * eps_sq
        mid = torch.sqrt(eps_sq * mu * (mu + 1.0)
                         / torch.clamp(r2, min=1e-12)) - mu
        w = torch.where(r2 >= upper, torch.zeros_like(r2),
                        torch.where(r2 <= lower, torch.ones_like(r2),
                                    torch.clamp(mid, 0.0, 1.0)))
        R, t = _weighted_kabsch(src, dst, w * valid)
        mu = mu * 1.4
    r2 = residual_sq(R, t)
    inliers = ((r2 < eps_sq) * valid).sum(-1)
    return _to_T(R, t), inliers

"""Scan Context descriptors as batched PyTorch ops.

Counterpart of ``cslam_tpu/ops/scancontext.py`` (reference
``cslam/lidar_pr/scancontext_utils.py``): polar (ring x sector) max-height
binning as one scatter-max, and the rotation-invariant distance over every
circular shift as one batched product.

Semantics kept:
- descriptor shape (num_ring=20, num_sector=60), max radius 80 m, heights
  offset by +2 m and clamped at 0 by the zero-filled grid,
- out-of-range radii clamp to the outermost ring; points with a non-finite
  coordinate are left out,
- column pairs where either column is all-zero are excluded from the mean
  cosine similarity,
- ``distance = 1 - max_shift mean_cossim``; shift s compares
  ``roll(candidate, s+1)`` against the query, yaw_diff = argmax + 1, ties
  to the first shift (``torch.argmax`` returns the first maximum, as
  ``jnp.argmax`` does).

The JAX op's ``.at[ring, sector].max(height, mode="drop")`` becomes
``scatter_reduce_("amax", include_self=True)`` on a zero grid; the invalid
points (the JAX op's ``ring == num_ring``, dropped) go to one extra cell
that is cut off, so no point past the grid is written into it. Its
``jnp.degrees(...) % 360.0`` is a floor-mod: ``torch.remainder``, never
``torch.fmod``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cslam_tpu_torch.ops import highest_precision

NUM_RING = 20
NUM_SECTOR = 60
MAX_LENGTH = 80.0
HEIGHT_OFFSET = 2.0


def points_to_scancontext(points: torch.Tensor, num_ring: int = NUM_RING,
                          num_sector: int = NUM_SECTOR,
                          max_length: float = MAX_LENGTH) -> torch.Tensor:
    """Polar max-height descriptor of a (padded) point cloud on its device.

    Args:
        points: ``[N, 3]`` float32; invalid/padding points marked by any
            non-finite coordinate (reference ``scancontext_utils.py:58``).

    Returns:
        ``[num_ring, num_sector]`` float32 descriptor.
    """
    points = points.float()
    finite = torch.isfinite(points).all(dim=-1)
    one = torch.ones_like(points[:, 0])
    x = torch.where(finite, points[:, 0], one)
    y = torch.where(finite, points[:, 1], one)
    z = torch.where(finite, points[:, 2], torch.zeros_like(one))
    r = torch.sqrt(x * x + y * y)
    deg = torch.tensor(np.float32(180.0 / math.pi), device=points.device)
    theta = torch.remainder(torch.atan2(y, x) * deg, 360.0)
    gap_ring = max_length / num_ring
    gap_sector = 360.0 / num_sector
    ring = torch.clamp((r / gap_ring).to(torch.int64), 0, num_ring - 1)
    sector = torch.clamp((theta / gap_sector).to(torch.int64), 0,
                         num_sector - 1)
    height = z + HEIGHT_OFFSET
    # invalid points go to one extra cell past the grid, cut off below
    # (no boolean selection: that would read the count on the host)
    cells = num_ring * num_sector
    flat = torch.where(finite, ring * num_sector + sector,
                       torch.full_like(ring, cells))
    grid = torch.zeros(cells + 1, dtype=torch.float32, device=points.device)
    grid.scatter_reduce_(0, flat, height, reduce="amax", include_self=True)
    grid = grid[:cells]
    return grid.view(num_ring, num_sector)


def points_to_scancontext_np(points, num_ring: int = NUM_RING,
                             num_sector: int = NUM_SECTOR,
                             max_length: float = MAX_LENGTH) -> np.ndarray:
    """Host (numpy) twin of :func:`points_to_scancontext`, a copy of the
    JAX package's. Same math in the same float32 precision; a 20 x 60
    max-binning over a few thousand points is cheaper on the host than a
    device round trip, so the per-keyframe embedding defaults to this path
    (``frontend.scancontext_host_binning``)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    finite = np.all(np.isfinite(pts), axis=-1)
    x = np.where(finite, pts[:, 0], np.float32(1.0))
    y = np.where(finite, pts[:, 1], np.float32(1.0))
    z = np.where(finite, pts[:, 2], np.float32(0.0))

    r = np.sqrt(x * x + y * y)
    theta = np.degrees(np.arctan2(y, x)) % np.float32(360.0)

    gap_ring = np.float32(max_length / num_ring)
    gap_sector = np.float32(360.0 / num_sector)
    ring = np.clip((r / gap_ring).astype(np.int32), 0, num_ring - 1)
    sector = np.clip((theta / gap_sector).astype(np.int32), 0,
                     num_sector - 1)
    height = (z + np.float32(HEIGHT_OFFSET)).astype(np.float32)

    grid = np.zeros((num_ring, num_sector), np.float32)
    np.maximum.at(grid, (ring[finite], sector[finite]), height[finite])
    return grid


def ring_key(sc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant ring key: per-ring mean over sectors
    (reference ``scancontext_utils.py:75-76``); ``[..., R, S] -> [..., R]``."""
    return sc.mean(dim=-1)


def _shift_index(num_sector: int, device) -> torch.Tensor:
    """``src[s, j] = (j - (s + 1)) mod S``: column j of
    ``roll(candidate, s+1)`` is column ``src[s, j]`` of the candidate."""
    j = torch.arange(num_sector, device=device)
    return torch.remainder(j[None, :] - (j[:, None] + 1), num_sector)


def _shifted_similarities(candidates: torch.Tensor,
                          query: torch.Tensor) -> torch.Tensor:
    """Mean column cosine similarity for every circular shift.

    ``candidates [..., R, S]`` against ``query [..., R, S]`` (broadcast)
    gives ``[..., S_shift]``. The JAX package gathers every rolled copy
    (``[S, R, S]``) and contracts over rings; here the ring contraction is
    one ``[S, S]`` product of candidate and query columns, from which
    shift s reads its diagonal ``src[s, :]`` (the same sums in another
    order)."""
    S = candidates.shape[-1]
    src = _shift_index(S, candidates.device)
    col = torch.arange(S, device=candidates.device)
    # cross[..., i, j] = sum_r candidate[r, i] * query[r, j]
    cross = candidates.transpose(-1, -2) @ query
    dots = cross[..., src, col[None, :]]                  # [..., s, j]
    q_norm = torch.linalg.vector_norm(query, dim=-2)      # [..., S]
    c_norm = torch.linalg.vector_norm(candidates, dim=-2)
    r_norm = c_norm[..., src]                             # [..., s, j]
    engaged = (q_norm[..., None, :] > 0) & (r_norm > 0)
    denom = torch.clamp(r_norm * q_norm[..., None, :], min=1e-30)
    cos = torch.where(engaged, dots / denom, torch.zeros_like(dots))
    count = engaged.sum(dim=-1)
    mean = cos.sum(dim=-1) / torch.clamp(count, min=1)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


@highest_precision
def scancontext_distance(candidate: torch.Tensor, query: torch.Tensor):
    """(distance, yaw_diff) for one pair, matching reference
    ``distance_sc`` (``scancontext_utils.py:78-114``)."""
    sims = _shifted_similarities(candidate, query)
    return 1.0 - sims.max(), torch.argmax(sims) + 1


@highest_precision
def scancontext_distances_batch(candidates: torch.Tensor,
                                query: torch.Tensor):
    """Batched (distances, yaw_diffs) of ``[..., B, R, S]`` candidates
    against a query broadcast over them (``[R, S]``, or ``[..., 1, R, S]``
    for one query per leading index)."""
    sims = _shifted_similarities(candidates, query)
    return 1.0 - sims.max(dim=-1).values, torch.argmax(sims, dim=-1) + 1

"""Fiedler (algebraic-connectivity) eigensolver, dense tier.

Counterpart of the dense tier of ``cslam_tpu/ops/fiedler.py`` (which
replaces the reference's networkx ``tracemin_lu``, ``cslam/mac/mac.py:35-59``):
one symmetric eigendecomposition (``torch.linalg.eigh``) over a padded
Laplacian with a deflation shift.

Padding + deflation: graphs are embedded in a tier size ``P`` with an
``active`` mask; padded nodes get a large diagonal shift ``sigma`` and the
trivial constant eigenvector is deflated by ``sigma * u u^T`` with
``u = active/sqrt(p)`` (valid since ``L @ 1 = 0``). With
``sigma > lambda_max(L)`` the smallest eigenvalue of the shifted matrix is
exactly ``lambda_2(L)``; a disconnected graph gives ``lambda_2 = 0``.

The chain + low-rank (Woodbury shift-invert + LOBPCG) tier that serves
graphs above 512 poses is not ported yet (ROADMAP.md item 16).
"""
from __future__ import annotations

import torch

from cslam_tpu_torch.ops import highest_precision


def laplacian_from_edges(idx_i: torch.Tensor, idx_j: torch.Tensor,
                         weights: torch.Tensor, size: int) -> torch.Tensor:
    """Dense weighted graph Laplacian from (padded) edge lists.

    Padding edges must carry weight 0 (they then contribute nothing).
    """
    L = torch.zeros((size, size), dtype=torch.float32, device=weights.device)
    w = weights.float()
    L.index_put_((idx_i, idx_i), w, accumulate=True)
    L.index_put_((idx_j, idx_j), w, accumulate=True)
    L.index_put_((idx_i, idx_j), -w, accumulate=True)
    L.index_put_((idx_j, idx_i), -w, accumulate=True)
    return L


def rayleigh_quotient(idx_i: torch.Tensor, idx_j: torch.Tensor,
                      weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x^T L x computed straight from edge lists: sum_e w_e (v_i - v_j)^2."""
    diff = v[idx_i] - v[idx_j]
    return torch.sum(weights * diff * diff)


@highest_precision
def fiedler_pair(L: torch.Tensor, active: torch.Tensor):
    """(lambda_2, Fiedler vector) via dense eigh on the deflated Laplacian.

    Args:
        L: ``[P, P]`` dense Laplacian (rows/cols of inactive nodes all zero).
        active: ``[P]`` float32 0/1 mask of real nodes.
    """
    active = active.float()
    p = torch.clamp(torch.sum(active), min=1.0)
    sigma = 2.0 * torch.max(torch.diagonal(L)) + 1.0
    u = active / torch.sqrt(p)
    B = (L
         + sigma * torch.diag(1.0 - active)
         + sigma * torch.outer(u, u))
    B = 0.5 * (B + B.T)  # enforce symmetry for eigh stability
    eigvals, eigvecs = torch.linalg.eigh(B)
    return eigvals[0], eigvecs[:, 0] * active


def algebraic_connectivity(idx_i: torch.Tensor, idx_j: torch.Tensor,
                           weights: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Convenience: lambda_2 of the graph given by weighted edge lists."""
    L = laplacian_from_edges(idx_i, idx_j, weights, active.shape[0])
    return fiedler_pair(L, active)[0]

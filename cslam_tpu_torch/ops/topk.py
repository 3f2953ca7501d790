"""Batched cosine top-k search over padded descriptor banks (plain PyTorch).

Counterpart of ``cslam_tpu/ops/topk.py``: one matmul over the whole bank
followed by an exact top-k. The hand-written bank-scan kernel that the
visual bank uses on the card lives in :mod:`cslam_tpu_torch.ops.nns`; the
functions here are the plain paths (k above the kernel's limit, the stacked
multi-bank top-1 of the detection front end).

Tie order: ``lax.top_k`` breaks ties by ascending index, and ``torch.topk``
promises no order among equal values. :func:`topk_ties_ascending` therefore
takes the top-k from a stable descending sort, which keeps equal values in
their original (ascending-index) order.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def topk_ties_ascending(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by ascending index (the
    ``lax.top_k`` rule). Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _q_inv(queries: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(torch.linalg.vector_norm(queries, dim=-1),
                             min=_EPS)


def cosine_topk(bank: torch.Tensor, inv_norms: torch.Tensor, n: int,
                queries: torch.Tensor, k: int):
    """Top-k cosine similarity of each query against the first ``n`` bank
    rows.

    Args:
        bank: ``[capacity, dim]`` descriptor bank (rows >= n are padding).
        inv_norms: ``[capacity]`` float32 ``1/max(||row||, eps)``.
        n: number of valid rows.
        queries: ``[B, dim]`` query descriptors.
        k: number of neighbors to return (``k <= capacity``).

    Returns:
        (sims, idx): ``[B, k]`` similarities (descending) and int64 row
        indices. Entries beyond ``n`` valid rows carry similarity ``-inf``.
    """
    bank = bank.float()
    queries = queries.float()
    dots = queries @ bank.T
    sims = dots * inv_norms[None, :] * _q_inv(queries)[:, None]
    valid = torch.arange(bank.shape[0], device=bank.device)[None, :] < n
    sims = torch.where(valid, sims, torch.full_like(sims, -float("inf")))
    return topk_ties_ascending(sims, k)


def update_rows(bank: torch.Tensor, inv_norms: torch.Tensor,
                rows: torch.Tensor, start: int):
    """Write a chunk of new descriptor rows at ``start`` and their inverse
    norms. Updates ``bank`` and ``inv_norms`` in place (the JAX original
    returns new arrays) and returns them."""
    rows = rows.float()
    bank[start:start + rows.shape[0]] = rows.to(bank.dtype)
    inv_norms[start:start + rows.shape[0]] = _q_inv(rows)
    return bank, inv_norms


def update_rows_unit(bank: torch.Tensor, rows: torch.Tensor,
                     start: int) -> torch.Tensor:
    """Write new rows L2-normalized (UNIT rows) at ``start``.

    Rows are normalized in float32 and stored in the bank's dtype — a
    bfloat16 bank halves the bank scan's memory traffic. Updates ``bank``
    in place and returns it.
    """
    rows = rows.float()
    inv = 1.0 / torch.clamp(
        torch.linalg.vector_norm(rows, dim=-1, keepdim=True), min=_EPS)
    bank[start:start + rows.shape[0]] = (rows * inv).to(bank.dtype)
    return bank


def cosine_top1_multi(banks: torch.Tensor, inv_norms: torch.Tensor,
                      ns: torch.Tensor, query: torch.Tensor):
    """Best match of ONE query against R stacked banks.

    Args:
        banks: ``[R, capacity, dim]`` stacked banks.
        inv_norms: ``[R, capacity]``.
        ns: ``[R]`` valid-row counts (0 allowed; its sim is ``-inf``).
        query: ``[dim]`` descriptor.

    Returns:
        (sims, idx): ``[R]`` best similarity and row index per bank
        (``argmax`` returns the first maximal index, as ``jnp.argmax``).
    """
    banks = banks.float()
    query = query.float()
    q_inv = 1.0 / torch.clamp(torch.linalg.vector_norm(query), min=_EPS)
    dots = torch.einsum("rcd,d->rc", banks, query)
    sims = dots * inv_norms * q_inv
    valid = (torch.arange(banks.shape[1], device=banks.device)[None, :]
             < ns[:, None])
    sims = torch.where(valid, sims, torch.full_like(sims, -float("inf")))
    return torch.max(sims, dim=1).values, torch.argmax(sims, dim=1)


def euclidean_topk(bank: torch.Tensor, sq_norms: torch.Tensor, n: int,
                   queries: torch.Tensor, k: int):
    """Top-k *smallest* euclidean distances (returned as negated distances,
    ``2 q.b - ||b||^2``; the query norm does not change the order).

    The ScanContext ring-key shortlist (reference
    ``cslam/lidar_pr/scancontext_matching.py:59-65`` builds a host KDTree
    per query). The product runs in full float32: call it with TF32 off
    (``ops.highest_precision``), or the ``||b||^2`` term swamps the
    distances. Ties go to the lower row index, as ``lax.top_k`` breaks
    them. Returns ``([B, k] f32, [B, k] int64)``; rows past ``n`` are
    ``-inf``."""
    bank = bank.float()
    queries = queries.float()
    neg_sq_dist = 2.0 * (queries @ bank.T) - sq_norms[None, :]
    valid = torch.arange(bank.shape[0], device=bank.device)[None, :] < n
    neg_sq_dist = torch.where(valid, neg_sq_dist,
                              torch.full_like(neg_sq_dist, -float("inf")))
    return topk_ties_ascending(neg_sq_dist, k)

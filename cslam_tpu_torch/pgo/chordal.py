"""Chordal initialization for pose graphs (rotation averaging + linear t).

Counterpart of ``cslam_tpu/pgo/chordal.py`` (the equivalent of GTSAM's
``InitializePose3``):

1. **Rotation averaging, chordally relaxed**: solve the linear least squares
   ``min sum_e || M_j - M_i R_ij ||_F^2`` over unconstrained 3x3 matrices,
   then project to SO(3) by SVD.
2. **Translations**: with rotations fixed, ``t_j - t_i = R_i t_ij`` is
   linear; the three coordinates decouple, so ONE graph-Laplacian Cholesky
   serves three right-hand sides.

The rotation normal matrix keeps the JAX package's de-interleaved unknown
ordering ``x[b * Np + n]``; its ``[Np, Np]`` component blocks are assembled
here by segment sums in an order fixed per graph (``ops.segment_sum``; the
TPU needed one-hot matmuls, and the card's atomic scatter-adds change
their order from run to run): one sum per index pair ``(i, i)``, ``(j, i)``,
``(i, j)``, ``(j, j)``, each carrying every component block that pair
feeds as a column.

Anchored at the first prior's node and pose. Works straight on the padded
``PoseGraphArrays`` (masks keep inactive nodes inert).
"""
from __future__ import annotations

from typing import Optional

import torch

from cslam_tpu_torch.ops import cholesky_solve, highest_precision
from cslam_tpu_torch.ops.segment_sum import segment_plan, segment_sum
from cslam_tpu_torch.pgo.factor_graph import PoseGraphArrays

#: the index pairs of the normal matrix's sums, and the translation rhs
_PAIRS = {"ii": ("edge_i", "edge_i"), "ji": ("edge_j", "edge_i"),
          "ij": ("edge_i", "edge_j"), "jj": ("edge_j", "edge_j")}


def _plans(g: PoseGraphArrays) -> dict:
    """The chordal sums' segment plans, built from ``g``'s index fields
    once and cached on it (padded edges left out)."""
    cache = g.__dict__.setdefault("_segment_plans", {})
    if ("chordal", 1) not in cache:
        Np = g.poses.shape[0]
        ev = g.edge_valid > 0
        plans = {name: segment_plan(getattr(g, a) * Np + getattr(g, b), ev,
                                    Np * Np, compact=True)
                 for name, (a, b) in _PAIRS.items()}
        plans["rhs"] = segment_plan(torch.cat([g.edge_j, g.edge_i]),
                                    torch.cat([ev, ev]), Np)
        cache["chordal", 1] = plans
    return cache["chordal", 1]


def _quads(plan, columns, Np):
    """``Si^T diag(v) Sj`` (entry (i_e, j_e) += v_e) for each column ``v``
    of ``columns`` ``[E, C]`` over one index pair, summed in one pass:
    ``quad(c)`` places column ``c``'s as an ``[Np, Np]`` matrix."""
    sums = segment_sum(columns, plan)

    def quad(c):
        M = sums.new_zeros(Np * Np + sums.shape[0])
        return M.index_copy_(0, plan.dest, sums[:, c])[:Np * Np].reshape(
            Np, Np)
    return quad


@highest_precision
def chordal_initialize(g: PoseGraphArrays,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Chordally-initialized poses ``[Np, 4, 4]`` for the given graph.

    ``weights`` (optional, per-edge) robustifies the otherwise plain
    linear least squares: chordal relaxation at weight 1 has NO outlier
    protection, so callers with a robust-weight estimate (e.g. the GNC
    de-masking phase) must pass it.
    """
    Np = g.poses.shape[0]
    dev = g.poses.device
    dtype = torch.float32
    R_meas = g.meas[:, :3, :3]
    t_meas = g.meas[:, :3, 3]
    w = g.edge_valid.to(dtype)
    if weights is not None:
        w = w * weights.to(dtype)
    anchor = g.prior_idx[0]
    anchor_pose = g.prior_pose[0]
    big = 1e4
    ei, ej = g.edge_i, g.edge_j

    A = torch.zeros(Np, dtype=dtype, device=dev)
    A[anchor] = 1.0
    pad = (1.0 - g.node_valid) + 1e-6               # inert padded nodes

    # rotation block. Constraint per edge: x_j - Q x_i with Q = R_ij^T.
    # De-interleaved component blocks:
    #   (b,c):  d_bc L_j  +  Si^T diag(w (Q^T Q)_bc) Si
    #          - Sj^T diag(w Q_bc) Si  -  Si^T diag(w Q_cb) Sj
    Q = R_meas.transpose(1, 2)                       # [E, 3, 3]
    QtQ = torch.einsum("eab,eac->ebc", Q, Q)
    plans = _plans(g)
    # column 9 of the first three: w alone, the translation Laplacian's
    ii = _quads(plans["ii"], torch.cat(
        [(w[:, None, None] * QtQ).reshape(-1, 9), w[:, None]], 1), Np)
    ji = _quads(plans["ji"], torch.cat(
        [(w[:, None, None] * Q).reshape(-1, 9), w[:, None]], 1), Np)
    ij = _quads(plans["ij"], torch.cat(
        [(w[:, None, None] * Q.transpose(1, 2)).reshape(-1, 9),
         w[:, None]], 1), Np)
    L_j = _quads(plans["jj"], w[:, None], Np)(0)
    anchor_block = big * torch.outer(A, A) + torch.diag(pad)
    rows = []
    for b in range(3):
        row = []
        for c in range(3):
            blk = ii(3 * b + c) - ji(3 * b + c) - ij(3 * b + c)
            if b == c:
                blk = blk + L_j + anchor_block
            row.append(blk)
        rows.append(torch.cat(row, dim=1))
    N = torch.cat(rows, dim=0)                       # [3Np, 3Np]

    # de-interleaved rhs[(b, n), s] = big * A_n * (anchor_R^T)[b, s]
    anchor_R = anchor_pose[:3, :3]
    rhs = torch.einsum("n,bs->bns", A, anchor_R.T).reshape(3 * Np, 3) * big
    X = cholesky_solve(N, rhs)                        # [3Np, 3]
    # [b, n, s] -> M[n, s, b] (row s of M_n across components b)
    M = X.reshape(3, Np, 3).permute(1, 2, 0)
    # not positive definite: NaN poses, which the caller's cost comparison
    # rejects; chosen on the device (no host read), the SVD below fed
    # identities instead (it would raise on NaN)
    finite = torch.isfinite(M).all()
    M = torch.where(finite, M, torch.eye(3, dtype=dtype, device=dev))

    # project to SO(3)
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.zeros((Np, 3, 3), dtype=dtype, device=dev)
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = det
    R = U @ D @ Vt

    # translation block: t_j - t_i = R_i t_ij. One [Np, Np] weighted
    # Laplacian Cholesky, three right-hand sides.
    L = L_j + ii(9) - ji(9) - ij(9) + anchor_block
    b_e = torch.einsum("eij,ej->ei", R[ei], t_meas) * w[:, None]
    bt = segment_sum(torch.cat([b_e, -b_e]), plans["rhs"])
    bt = bt + big * torch.outer(A, anchor_pose[:3, 3])
    t = cholesky_solve(L, bt)                        # [Np, 3]

    poses = torch.eye(4, dtype=dtype, device=dev).repeat(Np, 1, 1)
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    # keep padded nodes at identity
    poses = torch.where(g.node_valid[:, None, None] > 0, poses,
                        torch.eye(4, dtype=dtype, device=dev)[None])
    return torch.where(finite, poses, torch.full_like(poses, float("nan")))

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
here with ``index_put_`` scatter-adds (the TPU needed one-hot matmuls).

Anchored at the first prior's node and pose. Works straight on the padded
``PoseGraphArrays`` (masks keep inactive nodes inert).
"""
from __future__ import annotations

from typing import Optional

import torch

from cslam_tpu_torch.ops import cholesky_solve, highest_precision
from cslam_tpu_torch.pgo.factor_graph import PoseGraphArrays


def _quad(i_idx, j_idx, v, Np):
    """``Si^T diag(v) Sj``: entry (i_e, j_e) += v_e, an [Np, Np] matrix."""
    M = torch.zeros((Np, Np), dtype=v.dtype, device=v.device)
    M.index_put_((i_idx, j_idx), v, accumulate=True)
    return M


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
    L_j = _quad(ej, ej, w, Np)
    anchor_block = big * torch.outer(A, A) + torch.diag(pad)
    rows = []
    for b in range(3):
        row = []
        for c in range(3):
            blk = (_quad(ei, ei, w * QtQ[:, b, c], Np)
                   - _quad(ej, ei, w * Q[:, b, c], Np)
                   - _quad(ei, ej, w * Q[:, c, b], Np))
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
    L = (_quad(ej, ej, w, Np) + _quad(ei, ei, w, Np)
         - _quad(ej, ei, w, Np) - _quad(ei, ej, w, Np) + anchor_block)
    b_e = torch.einsum("eij,ej->ei", R[ei], t_meas) * w[:, None]
    bt = torch.zeros((Np, 3), dtype=dtype, device=dev)
    bt.index_add_(0, ej, b_e)
    bt.index_add_(0, ei, -b_e)
    bt = bt + big * torch.outer(A, anchor_pose[:3, 3])
    t = cholesky_solve(L, bt)                        # [Np, 3]

    poses = torch.eye(4, dtype=dtype, device=dev).repeat(Np, 1, 1)
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    # keep padded nodes at identity
    poses = torch.where(g.node_valid[:, None, None] > 0, poses,
                        torch.eye(4, dtype=dtype, device=dev)[None])
    return torch.where(finite, poses, torch.full_like(poses, float("nan")))

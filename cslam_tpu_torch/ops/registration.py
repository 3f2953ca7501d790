"""Robust point-cloud registration in PyTorch (lidar geometric verification).

Counterpart of ``cslam_tpu/ops/registration.py``, the functional
replacement for the reference's TEASER++ GNC-TLS + ICP pipeline
(``cslam/lidar_pr/icp_utils.py:68-139``): a candidate loop closure is
verified by estimating the relative SE(3) transform between two
downsampled clouds and gating its inlier count
(``registration_min_inliers``, reference ``icp_utils.py:121``).

Two candidate solvers, both run for every pair of a chunk, arbitrated on
the device (:func:`_verify_pair_batch`):
- multi-start robust ICP over yaw hypotheses (nearest neighbours through
  one distance product, Welsch/GNC reweighting, weighted Kabsch), coarse on
  a strided source subset and refined for the best hypotheses;
- prior-free global registration: occupancy-grid yaw x translation
  correlation by FFT and FPFH mutual-NN correspondences filtered by
  spectral distance consistency and aligned by the GNC-TLS Kabsch core,
  both refined by robust ICP.

What differs from the JAX package, and why:
- ``jax.vmap`` over pairs and yaw hypotheses becomes explicit batch axes:
  the solvers take a leading pair axis (``[P, N, 3]`` clouds, ``[P, N]``
  masks), and the ICP runs ``[P, H, Ns, Nd]`` distance blocks. The public
  names are the JAX package's: ``robust_registration`` and
  ``global_registration`` take one pair (``[N, 3]``, ``[N]``) and run it as
  ``P = 1``; ``robust_registration_batch`` and
  ``global_registration_batch`` take ``[P, N, 3]``.
- The ``fori_loop``s are fixed-count Python loops; nothing in
  :func:`_verify_pair_batch` reads a tensor on the host, and the chunk's
  one read is at :func:`compute_transform_batch_step`.
- The weighted Kabsch step solves its 3 x 3 SVD in closed form
  (:func:`_rotation_from_cross_covariance`, float64) instead of by
  ``torch.linalg.svd``, whose error check reads a flag on the host at every
  call on the card. The rotation is the same (``R = V diag(1, 1, d) U^T``,
  ``d`` the determinant sign fix), and it does not depend on the signs an
  SVD gives its singular vectors.
- Every solver entry point runs with TF32 off (``ops.highest_precision``):
  the nearest-neighbour distances use ``|a|^2 - 2 a.b + |b|^2``, which TF32
  would put off by about 1e-3 |p|^2, tenths of m^2 at 10 m.
- Ties follow the JAX rules: ``lax.top_k`` (hypothesis refinement, kNN) by
  a stable descending sort, ``jnp.argmax``/``argmin`` by the first extreme.
- A pair chunk is padded to its power-of-two tier by repeating its last
  pair, as in the JAX package, and :func:`_verify_pair_batch` runs through
  ``utils.tier_graphs``: one CUDA graph per tier on the card, captured at
  the front end's warmup (or at a tier's first use) where the JAX package
  compiles one program per tier; eagerly on the CPU. Its thresholds are
  float32 tensor operands, as the JAX package's ``np.float32`` arguments,
  so one graph serves every voxel size and gate.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.ops import highest_precision
from cslam_tpu_torch.ops.topk import topk_ties_ascending
from cslam_tpu_torch.utils.tier_graphs import TierGraphs, host_operands

_FPFH_BINS = 11
_GRID = 64


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Host-side voxel-grid downsampling (centroid per voxel), replacing
    Open3D's ``voxel_down_sample`` (reference ``icp_utils.py:93-100``); a
    copy of the JAX package's."""
    points = np.asarray(points, np.float64)
    points = points[np.all(np.isfinite(points), axis=1)]
    if len(points) == 0:
        return points.astype(np.float32)
    keys = np.floor(points / voxel_size).astype(np.int64)
    # pack voxel coords into one key (22 bits each, offset to positive)
    packed = ((keys[:, 0] + (1 << 20)) << 42 | (keys[:, 1] + (1 << 20)) << 21
              | (keys[:, 2] + (1 << 20)))
    order = np.argsort(packed, kind="stable")
    packed, points = packed[order], points[order]
    uniq, start, counts = np.unique(packed, return_index=True,
                                    return_counts=True)
    sums = np.add.reduceat(points, start, axis=0)
    return (sums / counts[:, None]).astype(np.float32)


def pad_cloud(points: np.ndarray, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate to a fixed size; returns (points [size,3], mask [size])."""
    points = np.asarray(points, np.float32)
    n = min(len(points), size)
    out = np.zeros((size, 3), np.float32)
    mask = np.zeros(size, np.float32)
    if n:
        idx = (np.arange(n) if len(points) <= size else
               np.linspace(0, len(points) - 1, size).astype(int))
        out[:n] = points[idx][:n]
        mask[:n] = 1.0
    return out, mask


# ---------------------------------------------------------------------------
# Small batched linear algebra
# ---------------------------------------------------------------------------


def _yaw_matrix(angle: torch.Tensor) -> torch.Tensor:
    """Rotations about z: ``[...]`` angles -> ``[..., 3, 3]``."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], -1),
                        torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of ``[..., 3, 3]`` matrices, ``col0 . (col1 x col2)``."""
    return (M[..., :, 0] * torch.linalg.cross(M[..., :, 1], M[..., :, 2],
                                              dim=-1)).sum(-1)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _smallest_eigvec3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric ``[..., 3,
    3]`` matrices, in closed form (the JAX package's, line for line).

    Eigenvalues from the trigonometric solution of the characteristic
    cubic (Smith '61); the eigenvector from Cayley-Hamilton:
    ``(A - l1 I)(A - l2 I) = (l3-l1)(l3-l2) v3 v3^T``, so the nonzero
    column of largest norm of that product is the smallest-eigenvalue
    direction. Degenerate neighbourhoods (isotropic, or collinear with two
    equal small eigenvalues) zero the product and fall back to +z."""
    I3 = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0)[..., None, None]
    Aq = A - q * I3
    p = torch.sqrt(torch.clamp(
        (Aq * Aq).sum((-2, -1))[..., None, None] / 6.0, min=1e-30))
    r = torch.clamp(_det3(Aq / p)[..., None, None] / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)                           # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)     # smallest
    lam2 = 3.0 * q - lam1 - lam3
    M = (A - lam1 * I3) @ (A - lam2 * I3)
    col = torch.argmax((M * M).sum(-2), dim=-1)                   # [...]
    idx = col[..., None, None].expand(M.shape[:-1] + (1,))
    v = torch.gather(M, -1, idx)[..., 0]
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ez = torch.zeros_like(v)
    ez[..., 2] = 1.0
    return torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=1e-30), ez)


def _unit_or(v: torch.Tensor, fallback: torch.Tensor,
             tiny: float = 1e-30) -> torch.Tensor:
    """``v / |v|`` where ``|v|^2 > tiny``, else ``fallback``."""
    n2 = (v * v).sum(-1, keepdim=True)
    return torch.where(n2 > tiny, v / torch.sqrt(torch.clamp(n2, min=tiny)),
                       fallback)


def _rotation_from_cross_covariance(H: torch.Tensor) -> torch.Tensor:
    """The Kabsch rotation ``R = V diag(1, 1, d) U^T`` of ``H = U S V^T``,
    ``d = sign(det(V U^T))``, for ``[..., 3, 3]`` matrices, in closed form
    and float64.

    With ``U' = [u1, u2, u1 x u2]`` and ``V' = [v1, v2, v1 x v2]`` (both
    proper) ``H = U' diag(s1, s2, +-s3) V'^T``, and the proper rotation
    the determinant fix picks is ``V' U'^T``: it needs only the two leading
    singular pairs. ``v3`` is the smallest eigenvector of ``H^T H``
    (:func:`_smallest_eigvec3`); ``v1, v2`` the 2 x 2 eigenvectors of the
    Gram matrix in the plane normal to it (a closed-form angle, exact also
    when ``s1 = s2``); ``u_i = H v_i / s_i``, orthonormalized. A zero
    ``H`` gives the identity, as an SVD of zeros does (``U = V = I``)."""
    H = H.double()
    # R does not depend on the scale of H; at unit norm the closed form's
    # thresholds are relative ones
    H = H / torch.clamp(torch.linalg.matrix_norm(H)[..., None, None],
                        min=1e-150)
    v3 = _smallest_eigvec3(H.transpose(-1, -2) @ H)
    ex = torch.zeros_like(v3)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v3)
    ey[..., 1] = 1.0
    a = torch.where(v3[..., :1].abs() < 0.9, ex, ey)
    e1 = _unit_or(a - (a * v3).sum(-1, keepdim=True) * v3, ey)
    e2 = torch.linalg.cross(v3, e1, dim=-1)
    h1, h2 = _matvec(H, e1), _matvec(H, e2)
    g11, g22 = (h1 * h1).sum(-1), (h2 * h2).sum(-1)
    g12 = (h1 * h2).sum(-1)
    theta = 0.5 * torch.atan2(2.0 * g12, g11 - g22)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    v1, v2 = c * e1 + s * e2, c * e2 - s * e1
    u1 = _unit_or(_matvec(H, v1), v1)
    w2 = _matvec(H, v2)
    w2 = w2 - (u1 * w2).sum(-1, keepdim=True) * u1
    fb = v2 - (u1 * v2).sum(-1, keepdim=True) * u1
    u2 = _unit_or(w2, _unit_or(fb, e2))
    v12 = torch.linalg.cross(v1, v2, dim=-1)
    u12 = torch.linalg.cross(u1, u2, dim=-1)
    return (v1[..., :, None] * u1[..., None, :]
            + v2[..., :, None] * u2[..., None, :]
            + v12[..., :, None] * u12[..., None, :])


def _weighted_kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Closed-form weighted rigid alignment src -> dst over the last point
    axis (``src``/``dst`` ``[..., N, 3]``, broadcast; ``w`` ``[..., N]``):
    returns (R ``[..., 3, 3]``, t ``[..., 3]``)."""
    wsum = torch.clamp(w.sum(-1), min=1e-6)[..., None]
    cs = (src * w[..., None]).sum(-2) / wsum
    cd = (dst * w[..., None]).sum(-2) / wsum
    H = ((src - cs[..., None, :]) * w[..., None]).transpose(-1, -2) @ (
        dst - cd[..., None, :])
    R = _rotation_from_cross_covariance(H).to(src.dtype)
    return R, cd - _matvec(R, cs)


def _to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]``, ``[..., 3]`` -> homogeneous ``[..., 4, 4]``."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[p, idx[p, ...]]`` along axis 1 for every p (``x`` ``[P, M,
    *rest]``, ``idx`` ``[P, *sel]`` int64) -> ``[P, *sel, *rest]``."""
    P = x.shape[0]
    b = torch.arange(P, device=x.device).view((P,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


# ---------------------------------------------------------------------------
# Multi-start robust ICP
# ---------------------------------------------------------------------------


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a|^2 - 2 a.b + |b|^2`` over the last two axes (the JAX package's
    matmul identity, in its order): ``[..., M, 3]``, ``[..., N, 3]`` ->
    ``[..., M, N]``."""
    return ((a * a).sum(-1)[..., :, None] - 2.0 * (a @ b.transpose(-1, -2))
            + (b * b).sum(-1)[..., None, :])


def _nearest(moved, dst, dst_mask):
    """Nearest valid destination point of every moved source point:
    (index, squared distance), the first of equal distances."""
    d2 = _sq_dists(moved, dst)
    d2 = torch.where(dst_mask[..., None, :] > 0, d2,
                     torch.full_like(d2, float("inf")))
    nn_d2, nn = d2.min(dim=-1)
    return nn, nn_d2


def _icp_once(src, src_mask, dst, dst_mask, R, t, scale_sq):
    """One robust ICP step for every hypothesis: correspond, reweight
    (Welsch/GNC), realign. ``src [..., Ns, 3]`` and ``dst [..., Nd, 3]``
    broadcast against ``R [..., 3, 3]``, ``t [..., 3]``."""
    moved = src @ R.transpose(-1, -2) + t[..., None, :]
    nn, nn_d2 = _nearest(moved, dst, dst_mask)
    dst_b = dst.expand(nn.shape[:-1] + dst.shape[-2:])
    matched = torch.gather(dst_b, -2, nn[..., None].expand(nn.shape + (3,)))
    w = torch.exp(-nn_d2 / torch.clamp(scale_sq, min=1e-12)) * src_mask
    R_new, t_new = _weighted_kabsch(src, matched, w)
    return R_new, t_new


def _robust_icp(src, src_mask, dst, dst_mask, R0, t0, corr_dist, iters: int,
                start_scale: float = 8.0):
    """Graduated robust ICP from a batch of initial poses; returns
    (R, t, inliers) per hypothesis.

    ``start_scale`` sets the initial robust-kernel radius (x corr_dist):
    wide (8x) for the coarse yaw sweep, tight (2x) when the initial pose is
    already trusted (a wide kernel under partial overlap drags the pose
    toward unrelated structure; see the JAX package's note)."""
    R, t = R0, t0
    for i in range(iters):
        frac = np.float32(i) / np.float32(max(iters - 1, 1))
        scale = corr_dist * float(np.float32(start_scale)
                                  * (np.float32(1.0) - frac)
                                  + np.float32(1.0))
        R, t = _icp_once(src, src_mask, dst, dst_mask, R, t, scale * scale)
    moved = src @ R.transpose(-1, -2) + t[..., None, :]
    _, nn_d2 = _nearest(moved, dst, dst_mask)
    inliers = ((nn_d2 < corr_dist * corr_dist) * src_mask).sum(-1)
    return R, t, inliers


def _centroid(points, mask):
    w = torch.clamp(mask.sum(-1), min=1.0)[..., None]
    return (points * mask[..., None]).sum(-2) / w


def _gather_hyp(x, idx):
    """``x [P, H, ...]`` at hypothesis ``idx [P, K]`` -> ``[P, K, ...]``."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


def _corr(corr_dist, like: torch.Tensor) -> torch.Tensor:
    """``corr_dist`` (a float or a scalar tensor) as a float32 scalar on
    ``like``'s device, as the JAX package's ``jnp.float32(corr_dist)``. A
    float becomes a fill on the device, never a host copy (which a CUDA
    graph capture refuses); the graphed chunks pass a tensor."""
    if isinstance(corr_dist, torch.Tensor):
        return corr_dist.to(like.device, torch.float32)
    return torch.full((), float(np.float32(corr_dist)), dtype=torch.float32,
                      device=like.device)


@highest_precision
def robust_registration_batch(src, src_mask, dst, dst_mask, corr_dist,
                              iters: int = 24, num_yaw_hypotheses: int = 8,
                              coarse_stride: int = 4, refine_top: int = 2):
    """Multi-start robust ICP, src -> dst, for ``P`` pairs at once.

    ``src, dst [P, N, 3]``, masks ``[P, N]``, ``corr_dist`` a float or a
    float32 scalar tensor. Returns (T ``[P, 4, 4]`` point map src -> dst,
    inliers ``[P]``) of each pair's best yaw hypothesis. The yaw sweep runs
    on a ``coarse_stride``-strided source subset; the ``refine_top`` best
    hypotheses by coarse inlier count (ties to the lower index) are refined
    at full resolution with a tight kernel; the final count is always full
    resolution."""
    P, dev = src.shape[0], src.device
    corr_dist = _corr(corr_dist, src)
    yaws = torch.arange(num_yaw_hypotheses, dtype=torch.float32,
                        device=dev) * (2 * math.pi / num_yaw_hypotheses)
    cs, cd = _centroid(src, src_mask), _centroid(dst, dst_mask)
    src_c = src[:, ::coarse_stride]
    mask_c = src_mask[:, ::coarse_stride]
    R0 = _yaw_matrix(yaws).expand(P, -1, 3, 3)
    t0 = cd[:, None] - _matvec(R0, cs[:, None])
    Rs, ts, inl_c = _robust_icp(src_c[:, None], mask_c[:, None],
                                dst[:, None], dst_mask[:, None], R0, t0,
                                corr_dist, iters)
    _, top = topk_ties_ascending(inl_c, refine_top)
    # the init is a converged coarse pose: keep the kernel tight
    Rf, tf, inliers = _robust_icp(
        src[:, None], src_mask[:, None], dst[:, None], dst_mask[:, None],
        _gather_hyp(Rs, top), _gather_hyp(ts, top), corr_dist,
        max(iters // 3, 4), start_scale=2.0)
    best = torch.argmax(inliers, dim=1, keepdim=True)
    return (_to_T(_gather_hyp(Rf, best)[:, 0], _gather_hyp(tf, best)[:, 0]),
            inliers.gather(1, best)[:, 0])


def robust_registration(src, src_mask, dst, dst_mask, corr_dist,
                        iters: int = 24, num_yaw_hypotheses: int = 8,
                        coarse_stride: int = 4, refine_top: int = 2):
    """:func:`robust_registration_batch` of one pair: ``src, dst [N, 3]``,
    masks ``[N]``. Returns (T ``[4, 4]`` point map src -> dst, inliers)."""
    T, inliers = robust_registration_batch(
        src[None], src_mask[None], dst[None], dst_mask[None], corr_dist,
        iters, num_yaw_hypotheses, coarse_stride, refine_top)
    return T[0], inliers[0]


# ---------------------------------------------------------------------------
# Correspondence-based global registration (no pose prior)
# ---------------------------------------------------------------------------


def _knn(points: torch.Tensor, mask: torch.Tensor, k: int):
    """k nearest neighbours by squared distance, self and invalid points
    excluded, ties to the lower index: (idx ``[P, N, k]``, d2 ``[P, N,
    k]``)."""
    d2 = _sq_dists(points, points)
    inf = torch.full_like(d2, float("inf"))
    d2 = torch.where(mask[:, None, :] > 0, d2, inf)
    eye = torch.eye(points.shape[1], dtype=torch.bool, device=points.device)
    d2 = torch.where(eye, inf, d2)
    neg_d2, idx = topk_ties_ascending(-d2, k)
    return idx, -neg_d2


def _normals(points, mask, nn_idx):
    """Per-point normals from neighbourhood PCA, oriented toward the sensor
    origin (the clouds are in the sensor frame)."""
    nbrs = _take(points, nn_idx)                          # [P, N, k, 3]
    centered = nbrs - nbrs.mean(dim=2, keepdim=True)
    cov = centered.transpose(-1, -2) @ centered
    cov = cov + 1e-9 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    n = _smallest_eigvec3(cov)
    flip = torch.sign(-(n * points).sum(-1, keepdim=True))
    n = n * torch.where(flip == 0, torch.ones_like(flip), flip)
    return n * mask[..., None]


def _spfh(points, normals, nn_idx, nn_d2, mask):
    """Simplified point feature histograms: the FPFH Darboux-angle triplet
    (alpha, phi, theta) hard-binned (one-hot sums)."""
    p = points[:, :, None, :]
    n_p = normals[:, :, None, :]
    q = _take(points, nn_idx)                             # [P, N, k, 3]
    n_q = _take(normals, nn_idx)
    d = q - p
    dist = torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-12))
    du = d / dist
    u = n_p.expand(du.shape)
    v = torch.linalg.cross(du, u, dim=-1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-9)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = (v * n_q).sum(-1)
    phi = (u * du).sum(-1)
    theta = torch.atan2((w * n_q).sum(-1), (u * n_q).sum(-1))
    valid = (mask[:, :, None] * _take(mask, nn_idx)
             * (nn_d2 < float("inf")))

    def hist(x, lo, hi):
        b = torch.clamp(((x - lo) / (hi - lo) * _FPFH_BINS).to(torch.int64),
                        0, _FPFH_BINS - 1)
        one_hot = torch.nn.functional.one_hot(b, _FPFH_BINS).to(x.dtype)
        return (one_hot * valid[..., None]).sum(2)       # [P, N, BINS]

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)], dim=-1)
    return h / torch.clamp(h.sum(-1, keepdim=True), min=1e-9)


def _fpfh(points, mask, k: int):
    """FPFH: SPFH re-aggregated over the neighbourhood with 1/dist weights
    (Rusu et al.; the reference takes them from Open3D, icp_utils.py:26-40)."""
    nn_idx, nn_d2 = _knn(points, mask, k)
    normals = _normals(points, mask, nn_idx)
    spfh = _spfh(points, normals, nn_idx, nn_d2, mask)
    wgt = 1.0 / torch.clamp(torch.sqrt(torch.clamp(nn_d2, min=1e-12)),
                            min=1e-6)
    wgt = wgt * (nn_d2 < float("inf"))
    neighbor = ((_take(spfh, nn_idx) * wgt[..., None]).sum(2)
                / torch.clamp(wgt.sum(2, keepdim=True), min=1e-9))
    return (spfh + neighbor) * mask[..., None]


def _occupancy2d(pts, mask, cell, half_extent):
    """Binarized XY occupancy grids ``[..., G, G]`` of ``pts [..., N, 3]``
    (``cell``, ``half_extent``: ``[...]``)."""
    ij = torch.floor((pts[..., :2] + half_extent[..., None, None])
                     / cell[..., None, None]).to(torch.int64)
    inb = (mask > 0) & ((ij >= 0) & (ij < _GRID)).all(-1)
    flat = torch.clamp(ij[..., 0] * _GRID + ij[..., 1], 0, _GRID * _GRID - 1)
    h = torch.zeros(flat.shape[:-1] + (_GRID * _GRID,), dtype=pts.dtype,
                    device=pts.device)
    h.scatter_add_(-1, flat, inb.to(pts.dtype))
    return (h > 0).to(pts.dtype).view(flat.shape[:-1] + (_GRID, _GRID))


def _yaw_correlation_candidates(src, src_mask, dst, dst_mask, n_yaw: int):
    """Dense global SE(2)-ish search: for each yaw hypothesis, the best XY
    translation by cross-correlating binarized occupancy grids. Returns per
    pair and yaw (R ``[P, Y, 3, 3]``, t ``[P, Y, 3]``, score ``[P, Y]``).

    The linear cross-correlation runs in the frequency domain,
    ``irfft2(rfft2(Hd_pad) * conj(rfft2(Hs_pad)))`` over a 2G zero-padded
    grid, with the destination spectrum shared across the yaws. Scores are
    integer counts up to FFT rounding (about 1e-3), so only exact ties can
    choose differently from the JAX package's FFT; the ICP refine
    arbitrates those."""
    cs, cd = _centroid(src, src_mask), _centroid(dst, dst_mask)

    def extent(pts, mask, c):
        r = (pts[..., :2] - c[:, None, :2]).abs() * mask[..., None]
        return r.amax(dim=(-2, -1))

    half = torch.maximum(extent(src, src_mask, cs),
                         extent(dst, dst_mask, cd)) * 1.05 + 1e-3
    cell = 2.0 * half / _GRID
    Hd = _occupancy2d(dst - cd[:, None], dst_mask, cell, half)
    pad = 2 * _GRID
    Fd = torch.fft.rfft2(Hd, s=(pad, pad))               # shared over yaws
    yaws = torch.arange(n_yaw, dtype=torch.float32, device=src.device) * (
        2.0 * math.pi / n_yaw)
    R = _yaw_matrix(yaws)                                 # [Y, 3, 3]
    moved = (src - cs[:, None])[:, None] @ R.transpose(-1, -2)
    Hs = _occupancy2d(moved, src_mask[:, None], cell[:, None], half[:, None])
    # c[s_u, s_v] = sum_xy Hs[x, y] * Hd[x + s_u, y + s_v], the shift taken
    # mod 2G; the aliased row/col s = G is masked out
    c = torch.fft.irfft2(Fd[:, None] * torch.conj(torch.fft.rfft2(
        Hs, s=(pad, pad))), s=(pad, pad))
    c[..., _GRID, :] = -float("inf")
    c[..., :, _GRID] = -float("inf")
    flat = c.flatten(-2)
    best = torch.argmax(flat, dim=-1)                     # [P, Y]
    su, sv = best // pad, best % pad
    su = torch.where(su > _GRID, su - pad, su)
    sv = torch.where(sv > _GRID, sv - pad, sv)
    dxy = torch.stack([su, sv], -1).to(src.dtype) * cell[:, None, None]
    t = (cd[:, None] - _matvec(R, cs[:, None])
         + torch.cat([dxy, torch.zeros_like(dxy[..., :1])], -1))
    return (R.expand(src.shape[0], -1, 3, 3), t,
            flat.gather(-1, best[..., None])[..., 0])


def _spectral_inliers(p, q, cand, eps, min_sep, iters: int = 50):
    """Pairwise-distance-consistency inlier selection (spectral matching,
    Leordeanu & Hebert '05), the stand-in for TEASER++'s max-clique filter
    (reference icp_utils.py:68-83): true correspondences form a dense
    block of the compatibility matrix, on which its principal eigenvector
    (power iteration) localizes. ``cand [P, N]`` masks the candidate
    correspondences ``p[i] -> q[i]``. Returns 0/1 weights ``[P, N]``
    (``cand`` where fewer than 3 survive)."""
    def pdist(x):
        diff = x[:, :, None, :] - x[:, None, :, :]
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))

    dp, dq = pdist(p), pdist(q)
    C = (((dp - dq).abs() < eps) & (dp > min_sep)).to(p.dtype)
    C = C * cand[:, :, None] * cand[:, None, :]
    C = C * (1.0 - torch.eye(p.shape[1], dtype=p.dtype, device=p.device))
    v = (cand + 1e-3)[..., None]
    for _ in range(iters):
        v = C @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                            min=1e-12)
    v = v[..., 0]
    sel = (v > 0.3 * v.amax(dim=1, keepdim=True)).to(p.dtype) * cand
    return torch.where(sel.sum(1, keepdim=True) >= 3.0, sel, cand)


def _fpfh_alignment(src, src_mask, dst, dst_mask, corr_dist, k: int):
    """FPFH mutual-NN correspondences, spectral distance-consistency
    filtering, then the GNC-TLS Kabsch core: the reference's TEASER++
    recipe (icp_utils.py:103-139). Returns the point-map hypothesis
    ``T0 [P, 4, 4]`` (src -> dst)."""
    from cslam_tpu_torch.ops.visual_registration import _gnc_align_core

    fa = _fpfh(src, src_mask, k)
    fb = _fpfh(dst, dst_mask, k)
    d2 = _sq_dists(fa, fb)
    both = (src_mask[:, :, None] > 0) & (dst_mask[:, None, :] > 0)
    d2 = torch.where(both, d2, torch.full_like(d2, float("inf")))
    j_of_i = torch.argmin(d2, dim=2)                      # [P, N]
    i_of_j = torch.argmin(d2, dim=1)
    arange = torch.arange(src.shape[1], device=src.device)
    mutual = ((torch.gather(i_of_j, 1, j_of_i) == arange)
              & (src_mask > 0)).to(src.dtype)
    dst_m = _take(dst, j_of_i)                            # [P, N, 3]
    w = _spectral_inliers(src, dst_m, mutual, eps=corr_dist * 0.5,
                          min_sep=corr_dist * 2.0)
    T0, _ = _gnc_align_core(src, dst_m, w, inlier_dist=corr_dist * 2.0,
                            iters=16)
    return T0


@highest_precision
def global_registration_batch(src, src_mask, dst, dst_mask, corr_dist,
                              k: int = 16, icp_iters: int = 24,
                              n_yaw: int = 32):
    """Prior-free global registration + robust ICP refinement of ``P``
    pairs. The top-correlation yaw/translation hypothesis and the FPFH
    hypothesis are both refined by robust ICP; the inlier count picks the
    winner. Same contract as :func:`robust_registration_batch`."""
    corr_dist = _corr(corr_dist, src)
    Rs, ts, scores = _yaw_correlation_candidates(src, src_mask, dst,
                                                 dst_mask, n_yaw)
    T0 = _fpfh_alignment(src, src_mask, dst, dst_mask, corr_dist, k)
    top = torch.argmax(scores, dim=1, keepdim=True)
    R_init = torch.cat([_gather_hyp(Rs, top), T0[:, None, :3, :3]], 1)
    t_init = torch.cat([_gather_hyp(ts, top), T0[:, None, :3, 3]], 1)
    Rf, tf, inl = _robust_icp(src[:, None], src_mask[:, None], dst[:, None],
                              dst_mask[:, None], R_init, t_init, corr_dist,
                              icp_iters, start_scale=2.0)
    best = torch.argmax(inl, dim=1, keepdim=True)
    return (_to_T(_gather_hyp(Rf, best)[:, 0], _gather_hyp(tf, best)[:, 0]),
            inl.gather(1, best)[:, 0])


def global_registration(src, src_mask, dst, dst_mask, corr_dist, k: int = 16,
                        icp_iters: int = 24, n_yaw: int = 32):
    """:func:`global_registration_batch` of one pair (``[N, 3]`` clouds,
    ``[N]`` masks); same contract as :func:`robust_registration`."""
    T, inliers = global_registration_batch(
        src[None], src_mask[None], dst[None], dst_mask[None], corr_dist, k,
        icp_iters, n_yaw)
    return T[0], inliers[0]


@highest_precision
def _verify_pair_batch(src, sm, dst, dm, corr_dist, min_inliers,
                       min_inlier_ratio):
    """Fused geometric verification of a pair chunk: multi-start ICP,
    prior-free global registration, inlier gating and arbitration, all on
    the device with no host read. The ICP result wins if it passes the
    gate; otherwise the higher-inlier candidate is taken and re-gated.
    ``corr_dist``, ``min_inliers`` and ``min_inlier_ratio`` are float32
    scalar tensors (or floats, eagerly). Returns (T ``[P, 4, 4]``, inliers
    ``[P]``, success ``[P]``, ICP-gate pass ``[P]``)."""
    T0, inl0 = robust_registration_batch(src, sm, dst, dm, corr_dist)
    Tg, inlg = global_registration_batch(src, sm, dst, dm, corr_dist)
    n_src = torch.clamp(sm.sum(1), min=1.0)

    def gate(inl):
        return (inl > min_inliers) & (inl / n_src > min_inlier_ratio)

    ok0 = gate(inl0)
    use_g = ~ok0 & (inlg > inl0)
    T = torch.where(use_g[:, None, None], Tg, T0)
    inl = torch.where(use_g, inlg, inl0)
    success = torch.where(use_g, gate(inlg), ok0)
    return T, inl, success, ok0


# one graph per (pair tier, pad size) on the card; eager on the CPU
VERIFY_GRAPHS = TierGraphs(_verify_pair_batch,
                           "registration._verify_pair_batch")


class VerifyBatchHandle:
    """One launched verification of a (<= max_pair_tier) pair chunk.

    :func:`compute_transform_batch_begin` launches the whole decision
    (:func:`_verify_pair_batch`); one :func:`compute_transform_batch_step`
    materializes ``results`` as the (Z, success) list. ``arrays`` exposes
    the pending device results for ``device_read.prefetch``."""

    __slots__ = ("p", "T_dev", "inl_dev", "ok_dev", "ok_icp_dev", "results")

    @property
    def arrays(self):
        if self.results is None:
            return (self.T_dev, self.inl_dev, self.ok_dev, self.ok_icp_dev)
        return ()

    @property
    def done(self) -> bool:
        return self.results is not None


def _pair_arrays(pairs, pad_size: int):
    """Padded ``[P, pad_size, 3]`` clouds and ``[P, pad_size]`` masks of
    (src, dst) pairs, as numpy arrays (src, src mask, dst, dst mask)."""
    src = [pad_cloud(s, pad_size) for s, _ in pairs]
    dst = [pad_cloud(d, pad_size) for _, d in pairs]
    return (np.stack([p for p, _ in src]), np.stack([m for _, m in src]),
            np.stack([p for p, _ in dst]), np.stack([m for _, m in dst]))


def _pair_tensors(pairs, pad_size: int, device):
    """:func:`_pair_arrays` as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _pair_arrays(pairs, pad_size))


def _pair_tier(p: int) -> int:
    """The power-of-two pair tier of a chunk of ``p`` pairs."""
    tier = 1
    while tier < p:
        tier *= 2
    return tier


def compute_transform_batch_begin(pairs, voxel_size: float, min_inliers: int,
                                  pad_size: int = 1024,
                                  min_inlier_ratio: float = 0.6,
                                  max_pair_tier: int = 8,
                                  device=None) -> list:
    """Launch batched verification without waiting for it. Returns one
    :class:`VerifyBatchHandle` per chunk of up to ``max_pair_tier`` pairs
    (the chunk bounds the device memory of one verification). A chunk is
    padded to its power-of-two pair tier by repeating its last pair (as in
    the JAX package; ``h.p`` stays the live count, and padded slots reach
    neither ``results`` nor the counters), uploaded from pinned host memory
    and run through :data:`VERIFY_GRAPHS`."""
    from cslam_tpu_torch.utils import device_read, profiling
    device = resolve_device(device)
    gates = (float(voxel_size) * 1.5, min_inliers, min_inlier_ratio)
    handles = []
    for c in range(0, len(pairs), max_pair_tier):
        chunk = pairs[c:c + max_pair_tier]
        h = VerifyBatchHandle()
        h.p = len(chunk)
        h.results = None
        padded = list(chunk) + [chunk[-1]] * (_pair_tier(h.p) - h.p)
        operands = host_operands(device, *_pair_arrays(padded, pad_size),
                                 *(np.float32(g) for g in gates))
        with profiling.span("verify.dispatch"):
            h.T_dev, h.inl_dev, h.ok_dev, h.ok_icp_dev = VERIFY_GRAPHS(
                device, *operands)
            device_read.prefetch(
                (h.T_dev, h.inl_dev, h.ok_dev, h.ok_icp_dev))
        handles.append(h)
    return handles


def compute_transform_batch_step(h: VerifyBatchHandle) -> bool:
    """Materialize a launched verification chunk (its one host read);
    returns True once ``h.results`` is final."""
    from cslam_tpu_torch.utils import device_read, profiling
    if h.results is None:
        with profiling.span("verify.read"):
            T, ok, ok_icp = device_read.fetch((h.T_dev, h.ok_dev,
                                               h.ok_icp_dev))
        T = T.astype(np.float64)
        # what fraction of pairs the multi-start ICP gate passes on its own
        # (the complement is the global-registration fallback rate)
        profiling.counter("verify.pairs", h.p)
        profiling.counter("verify.icp_gate_pass", int(ok_icp[:h.p].sum()))
        h.results = [(np.linalg.inv(T[i]), bool(ok[i]))
                     for i in range(h.p)]
    return True


def compute_transform_batch(pairs, voxel_size: float, min_inliers: int,
                            pad_size: int = 1024,
                            min_inlier_ratio: float = 0.6,
                            max_pair_tier: int = 8, device=None):
    """Batched :func:`compute_transform`: the decisions and (Z, success)
    per pair of a per-pair loop, in one verification per chunk."""
    if not pairs:
        return []
    out = []
    for h in compute_transform_batch_begin(
            pairs, voxel_size, min_inliers, pad_size=pad_size,
            min_inlier_ratio=min_inlier_ratio, max_pair_tier=max_pair_tier,
            device=device):
        compute_transform_batch_step(h)
        out.extend(h.results)
    return out


def compute_transform(src_points: np.ndarray, dst_points: np.ndarray,
                      voxel_size: float, min_inliers: int,
                      pad_size: int = 1024,
                      min_inlier_ratio: float = 0.6, device=None
                      ) -> Tuple[np.ndarray, bool]:
    """Verify a candidate loop closure between two clouds.

    Same contract as reference ``icp_utils.compute_transform``
    (``icp_utils.py:178-196``): returns (transform, success). The transform
    uses the back end's BetweenFactor convention, Z = X_src^-1 X_dst, the
    inverse of the point map the registration estimates. Success needs an
    absolute count and a ratio of inliers; a pair the multi-start ICP fails
    falls back to the prior-free global registration (the role TEASER++
    plays in the reference, icp_utils.py:103-139)."""
    device = resolve_device(device)
    src, src_mask, dst, dst_mask = _pair_tensors([(src_points, dst_points)],
                                                 pad_size, device)
    corr = torch.tensor(np.float32(float(voxel_size) * 1.5), device=device)
    T_pointmap, inliers = robust_registration_batch(src, src_mask, dst,
                                                    dst_mask, corr)
    n_src = max(float(src_mask.sum()), 1.0)

    def gate(count):
        return (int(count) > min_inliers
                and float(count) / n_src > min_inlier_ratio)

    inliers = float(inliers[0])
    success = gate(inliers)
    if not success:
        T_g, inl_g = global_registration_batch(src, src_mask, dst, dst_mask,
                                               corr)
        inl_g = float(inl_g[0])
        if int(inl_g) > int(inliers):
            T_pointmap, inliers = T_g, inl_g
            success = gate(inl_g)
    Z = np.linalg.inv(T_pointmap[0].cpu().numpy().astype(np.float64))
    return Z, success

"""Visual geometric verification: robust alignment of matched 3D keypoints.

Counterpart of ``cslam_tpu/ops/visual_registration.py``, the replacement
for the reference's rtabmap ``RegistrationVis::computeTransformation``
(RANSAC PnP, ``src/front_end/rgbd_handler.cpp:433-554``, gated by
``Vis/MinInliers``): candidate loop closures are verified by matching binary
descriptors (host C++, ``cslam_tpu_torch.native``) and robustly aligning
the matched keypoints, either their 3D positions (graduated non-convexity,
TLS, around the closed-form weighted Kabsch; also the robust core of the
lidar path's prior-free registration) or, with the projective residual,
the remote keyframe's 3D points against the local keyframe's pixels
(GNC-TLS perspective-n-point).

What differs from the JAX package, and why:
- ``jax.vmap`` over pairs becomes a leading pair axis: the cores take
  ``[P, N, ...]`` and every per-pair decision is a ``[P]`` mask, broadcast
  to ``[P, 1, 1]`` for rotations and ``[P, 1]`` for translations.
- The ``fori_loop``s are fixed-count Python loops, and a chunk makes no
  host read until its results are fetched, once. The PnP step's 6 x 6
  system is an LU solve (``torch.linalg.solve_ex`` with
  ``check_errors=False``, as ``jnp.linalg.solve``): ``torch.linalg.solve``
  would read its error flag on the host at every call on the card.
- The weighted Kabsch rotation is the port's closed form in float64
  (``ops.registration._rotation_from_cross_covariance``); the JAX package
  takes a float32 SVD, so an inlier count can differ by one where a
  residual sits on the threshold.
- The pair chunks keep the JAX package's power-of-two pair tiers, and
  ``gnc_align_batch`` / ``gnc_pnp_batch`` run through
  ``utils.tier_graphs``: one CUDA graph per tier on the card, captured by
  the warmups (or at a tier's first use) where the JAX package compiles
  one program per tier; eagerly on the CPU. As in the JAX package, where
  only ``iters`` is static, the inlier thresholds and the camera
  intrinsics are float32 tensor operands, so one graph serves them all.
- Every entry point takes ``device`` (CUDA unless the caller passes
  another) and runs with TF32 off (``ops.highest_precision``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.native import hamming_match
from cslam_tpu_torch.ops import highest_precision
from cslam_tpu_torch.ops.registration import (_matvec, _pair_tier, _to_T,
                                              _weighted_kabsch)
from cslam_tpu_torch.utils import device_read
from cslam_tpu_torch.utils.tier_graphs import TierGraphs, host_operands

MAX_CORRESPONDENCES = 512


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
        R, t = _weighted_kabsch(src, dst, _tls_weights(r2, mu, eps_sq)
                                * valid)
        mu = mu * 1.4
    r2 = residual_sq(R, t)
    inliers = ((r2 < eps_sq) * valid).sum(-1)
    return _to_T(R, t), inliers


def _tls_weights(r2: torch.Tensor, mu: torch.Tensor, eps_sq) -> torch.Tensor:
    """The GNC-TLS surrogate's weights of squared residuals ``r2`` at
    control parameter ``mu`` (broadcast against ``r2``)."""
    upper = (mu + 1.0) / mu * eps_sq
    lower = mu / (mu + 1.0) * eps_sq
    mid = torch.sqrt(eps_sq * mu * (mu + 1.0)
                     / torch.clamp(r2, min=1e-12)) - mu
    return torch.where(r2 >= upper, torch.zeros_like(r2),
                       torch.where(r2 <= lower, torch.ones_like(r2),
                                   torch.clamp(mid, 0.0, 1.0)))


def _f32(x) -> float:
    """A host scalar rounded to float32, as a traced JAX argument is."""
    return float(np.float32(x))


def _tensors(device, *arrays):
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@highest_precision
def gnc_align(src, dst, valid, inlier_dist: float, iters: int = 12,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pair GNC-TLS alignment (see ``_gnc_align_core``): ``src,
    dst [N, 3]``, ``valid [N]`` (arrays or tensors) -> (T ``[4, 4]``,
    inliers) on ``device``."""
    src, dst, valid = _tensors(resolve_device(device), src, dst, valid)
    return _gnc_align_core(src, dst, valid, _f32(inlier_dist), iters)


ALIGN_GRAPHS = TierGraphs(highest_precision(_gnc_align_core),
                          "visual_registration.gnc_align_batch")


def gnc_align_batch(src, dst, valid, inlier_dist: float, iters: int = 12,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GNC-TLS alignment over ``P`` candidate pairs at once.

    ``src/dst [P, N, 3]``, ``valid [P, N]`` (arrays or tensors),
    ``inlier_dist`` a float or a float32 scalar tensor. Returns (T ``[P, 4,
    4]``, inliers ``[P]``) on ``device``, one graph replay per call on the
    card (:data:`ALIGN_GRAPHS`, keyed by ``P`` and ``iters``). One keyframe
    message can request verification against many local keyframes (the
    reference loops over them one RANSAC-PnP call at a time,
    rgbd_handler.cpp:493-554); here they are one chunk."""
    device = resolve_device(device)
    return ALIGN_GRAPHS(device, *host_operands(device, src, dst, valid,
                                               inlier_dist), iters=iters)


def warmup_verification(tiers=(1, 2, 4, 8, 16), inlier_dist: float = 0.3,
                        device=None) -> None:
    """Capture ``gnc_align_batch``'s graph of each pair tier (default
    ``iters``) before the first frame, as the JAX package precompiles the
    tiers here. Any ``inlier_dist`` serves: it is an operand of the graph.
    On the CPU the same calls run eagerly."""
    device = resolve_device(device)
    for tier in tiers:
        z3 = torch.zeros((tier, MAX_CORRESPONDENCES, 3), device=device)
        v = torch.ones((tier, MAX_CORRESPONDENCES), device=device)
        device_read.fetch(gnc_align_batch(z3, z3, v, inlier_dist,
                                          device=device))


def _build_correspondences(kp3d_a: np.ndarray, desc_a: np.ndarray,
                           kp3d_b: np.ndarray, desc_b: np.ndarray,
                           min_inliers: int, max_hamming: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      bool]:
    """Host matching + fixed-shape padding for one candidate pair.

    Returns (src [N,3], dst [N,3], valid [N], enough): ``enough`` is False
    when descriptor matching alone cannot reach ``min_inliers`` (no device
    work needed for that pair)."""
    src = np.zeros((MAX_CORRESPONDENCES, 3), np.float32)
    dst = np.zeros((MAX_CORRESPONDENCES, 3), np.float32)
    valid = np.zeros(MAX_CORRESPONDENCES, np.float32)
    pairs = hamming_match(desc_a, desc_b, max_dist=max_hamming)
    if len(pairs) < max(min_inliers, 3):
        return src, dst, valid, False
    n = min(len(pairs), MAX_CORRESPONDENCES)
    src[:n] = kp3d_a[pairs[:n, 0]]
    dst[:n] = kp3d_b[pairs[:n, 1]]
    valid[:n] = 1.0
    # drop correspondences with invalid depth (zeros / non-finite)
    finite = np.isfinite(src).all(1) & np.isfinite(dst).all(1)
    nonzero = (np.abs(src).sum(1) > 1e-9) & (np.abs(dst).sum(1) > 1e-9)
    valid *= (finite & nonzero).astype(np.float32)
    return src, dst, valid, True


def verify_keyframe_pair(kp3d_a: np.ndarray, desc_a: np.ndarray,
                         kp3d_b: np.ndarray, desc_b: np.ndarray,
                         min_inliers: int = 6, inlier_dist: float = 0.3,
                         max_hamming: int = 64, device=None
                         ) -> Tuple[np.ndarray, bool, int]:
    """Full verification: descriptor matching + robust 3D alignment.

    Returns (T mapping a-frame points into b-frame, success, inliers),
    the reference's success gate ``Vis/MinInliers``
    (rgbd_handler.cpp:115-118: pnp_min_inliers)."""
    return verify_keyframe_pairs(
        [(kp3d_a, desc_a, kp3d_b, desc_b)], min_inliers=min_inliers,
        inlier_dist=inlier_dist, max_hamming=max_hamming, device=device)[0]


def _padded(built, live, tier, width):
    """Stack the live pairs' host arrays ``built[i][:width]`` into
    ``tier`` slots (zero slots pad the tier)."""
    cols = []
    for c in range(width):
        first = built[live[0]][c]
        col = np.zeros((tier,) + first.shape, np.float32)
        for slot, i in enumerate(live):
            col[slot] = built[i][c]
        cols.append(col)
    return cols


def verify_keyframe_pairs(pairs_abab, min_inliers: int = 6,
                          inlier_dist: float = 0.3, max_hamming: int = 64,
                          device=None):
    """Verify many candidate pairs in one chunk on ``device``.

    ``pairs_abab``: sequence of ``(kp3d_a, desc_a, kp3d_b, desc_b)``.
    Returns a list of ``(T_ab, success, inliers)`` in input order.
    Descriptor matching stays on the host (C++ hamming); the alignment of
    all pairs runs as one GNC solve over the pairs padded to a power-of-two
    pair tier, and its results come back in one host read."""
    device = resolve_device(device)
    P = len(pairs_abab)
    if P == 0:
        return []
    built = [_build_correspondences(a3, ad, b3, bd, min_inliers, max_hamming)
             for a3, ad, b3, bd in pairs_abab]
    live = [i for i in range(P) if built[i][3]]
    results = [(np.eye(4), False, 0)] * P
    if not live:
        return results
    src, dst, valid = _padded(built, live, _pair_tier(len(live)), 3)
    Ts, inliers = device_read.fetch(gnc_align_batch(
        src, dst, valid, inlier_dist, device=device))
    Ts = Ts.astype(np.float64)
    for slot, i in enumerate(live):
        n_in = int(inliers[slot])
        # Ts[slot] maps a->b in point coordinates: p_b = R p_a + t. As a pose
        # transform (X_a^-1 X_b) convention used by the back end, the relative
        # pose of b's camera in a's frame is the inverse of the point map.
        results[i] = (np.linalg.inv(Ts[slot]), n_in >= min_inliers, n_in)
    return results


# ---------------------------------------------------------------------------
# Projective (PnP-parity) residual
# ---------------------------------------------------------------------------
#
# The reference verifies with RANSAC-PnP minimizing REPROJECTION error
# (rgbd_handler.cpp:493-554 via rtabmap RegistrationVis; gate
# Vis/MinInliers ll.115-118). The 3D-3D GNC above needs valid depth on
# BOTH sides and weights far points poorly (stereo depth error grows
# quadratically with range). This projective variant is the parity
# option: it consumes the remote keyframe's 3D points and only the LOCAL
# keyframe's 2D pixels, minimizing robust pixel error; the local side's
# depth only seeds the initialization, never the residual.


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues of ``[..., 3]`` rotation vectors with a small-angle guard
    (float32-safe) -> ``[..., 3, 3]``."""
    theta = torch.linalg.vector_norm(w, dim=-1)[..., None]
    k = torch.where(theta > 1e-8, w / torch.clamp(theta, min=1e-8),
                    torch.zeros_like(w))
    K = _skew(k)
    theta = theta[..., None]
    I3 = torch.eye(3, dtype=w.dtype, device=w.device)
    R = I3 + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta > 1e-8, R, I3 + K * theta)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> the cross-product matrices ``[..., 3, 3]``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _gnc_pnp_core(p3d: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                  init_dst3d: torch.Tensor, fx, fy, cx, cy, inlier_px,
                  iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GNC-TLS perspective-n-point of ``P`` pairs: find ``T`` with
    ``project(T p3d[i]) ~ uv[i]``.

    p3d: ``[P, N, 3]`` points in the REMOTE keyframe's camera frame.
    uv: ``[P, N, 2]`` observed pixels in the LOCAL camera.
    valid: ``[P, N]`` correspondence mask.
    init_dst3d: ``[P, N, 3]`` local back-projections (possibly coarse or
        noisy depth; zero rows where depth is missing), initialization only.
    fx, fy, cx, cy, inlier_px: float32 scalar tensors.

    Returns (T ``[P, 4, 4]`` = X_local^-1 X_remote, reprojection-inlier
    count ``[P]``). One Gauss-Newton step on the robustly weighted pixel
    residual per GNC graduation round; each pair accepts or rejects its
    own step."""
    eps_sq = inlier_px * inlier_px
    dev = p3d.device
    I3 = torch.eye(3, dtype=torch.float32, device=dev)

    # init: Kabsch over pairs whose LOCAL depth exists (noisy depth still
    # gives a pose within GN's basin); identity when too few such pairs
    has_dst = (init_dst3d.abs().sum(-1) > 1e-9).to(torch.float32)
    w_init = valid * has_dst
    R_k, t_k = _weighted_kabsch(p3d, init_dst3d, w_init)
    enough = w_init.sum(-1) >= 3.0
    R = torch.where(enough[:, None, None], R_k, I3)
    t = torch.where(enough[:, None], t_k, torch.zeros_like(t_k))

    def reproj_r2(R, t):
        q = p3d @ R.transpose(-1, -2) + t[:, None, :]
        z = torch.clamp(q[..., 2], min=1e-3)
        u = fx * q[..., 0] / z + cx
        v = fy * q[..., 1] / z + cy
        r = torch.stack([u, v], -1) - uv
        r2 = (r * r).sum(-1)
        # points behind the camera can never be inliers
        return torch.where(q[..., 2] > 1e-3, r2,
                           torch.full_like(r2, 1e12)), r, q

    r2, _, _ = reproj_r2(R, t)
    max_r2 = torch.where(valid > 0, torch.clamp(r2, max=1e8),
                         torch.zeros_like(r2)).amax(-1)
    mu = torch.clamp(eps_sq / torch.clamp(2.0 * max_r2 - eps_sq, min=1e-9),
                     min=1e-6)[:, None]
    I6 = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r2, r, q = reproj_r2(R, t)
        upper = (mu + 1.0) / mu * eps_sq
        w = _tls_weights(r2, mu, eps_sq) * valid
        # one weighted GN step on se(3), tangent order [rotation, trans]
        z = torch.clamp(q[..., 2], min=1e-3)
        zero = torch.zeros_like(z)
        # d(residual)/dq  [P, N, 2, 3]
        drdq = torch.stack([
            torch.stack([fx / z, zero, -fx * q[..., 0] / (z * z)], -1),
            torch.stack([zero, fy / z, -fy * q[..., 1] / (z * z)], -1)], -2)
        # dq/dxi = [-[q]x | I]  (left-multiplicative update)
        J = torch.cat([-(drdq @ _skew(q)), drdq], -1)       # [P, N, 2, 6]
        Jw = J * w[..., None, None]
        H = torch.einsum("pnij,pnik->pjk", Jw, J) + 1e-6 * I6
        g = torch.einsum("pnij,pni->pj", Jw, r)
        dx = -torch.linalg.solve_ex(H, g[..., None],
                                    check_errors=False)[0][..., 0]
        dR = _so3_exp(dx[:, :3])
        R_new = dR @ R
        t_new = _matvec(dR, t) + dx[:, 3:]
        # reject a diverging step (robust cost is only a proxy here), pair
        # by pair
        r2_new, _, _ = reproj_r2(R_new, t_new)
        cost_old = (w * torch.minimum(r2, upper)).sum(-1)
        cost_new = (w * torch.minimum(r2_new, upper)).sum(-1)
        ok = cost_new <= cost_old                            # [P]
        R = torch.where(ok[:, None, None], R_new, R)
        t = torch.where(ok[:, None], t_new, t)
        mu = mu * 1.4
    r2, _, _ = reproj_r2(R, t)
    inliers = ((r2 < eps_sq) * valid).sum(-1)
    return _to_T(R, t), inliers


PNP_GRAPHS = TierGraphs(highest_precision(_gnc_pnp_core),
                        "visual_registration.gnc_pnp_batch")


def gnc_pnp_batch(p3d, uv, valid, init_dst3d, fx, fy, cx, cy,
                  inlier_px: float = 4.0, iters: int = 24, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched GNC-TLS PnP over ``P`` candidate pairs at once.

    ``p3d/init_dst3d [P, N, 3]``, ``uv [P, N, 2]``, ``valid [P, N]``
    (arrays or tensors); the intrinsics and ``inlier_px`` floats or float32
    scalar tensors. Returns (T ``[P, 4, 4]`` = X_local^-1 X_remote,
    reprojection inliers ``[P]``) on ``device``, one graph replay per call
    on the card (:data:`PNP_GRAPHS`, keyed by ``P`` and ``iters``; a tier
    no warmup captured is captured at its first use)."""
    device = resolve_device(device)
    return PNP_GRAPHS(device, *host_operands(
        device, p3d, uv, valid, init_dst3d, fx, fy, cx, cy, inlier_px),
        iters=iters)


def warmup_verification_projective(tiers=(1, 2, 4, 8, 16),
                                   fx: float = 300.0, fy: float = 300.0,
                                   cx: float = 160.0, cy: float = 120.0,
                                   device=None) -> None:
    """Capture ``gnc_pnp_batch``'s graph of each pair tier (see
    :func:`warmup_verification`; any camera serves)."""
    device = resolve_device(device)
    for tier in tiers:
        z3 = torch.zeros((tier, MAX_CORRESPONDENCES, 3), device=device)
        z3[..., 2] = 1.0
        uv = torch.zeros((tier, MAX_CORRESPONDENCES, 2), device=device)
        v = torch.ones((tier, MAX_CORRESPONDENCES), device=device)
        device_read.fetch(gnc_pnp_batch(z3, uv, v, z3, fx, fy, cx, cy,
                                        device=device))


def verify_keyframe_pairs_projective(pairs, fx: float, fy: float,
                                     cx: float, cy: float,
                                     min_inliers: int = 6,
                                     inlier_px: float = 4.0,
                                     max_hamming: int = 64, device=None):
    """Projective-residual verification of many candidate pairs in one
    chunk (the reference's RANSAC-PnP decision surface,
    rgbd_handler.cpp:493-554, as a GNC-TLS program).

    ``pairs``: sequence of ``(kp_a_uv, kp3d_a, desc_a, kp3d_b, desc_b)``
    where ``a`` is the LOCAL keyframe (2D pixels + possibly degraded depth
    back-projections) and ``b`` the remote one (3D points). Returns
    ``(T_ab, success, inliers)`` per pair with the back end's convention
    T_ab = X_a^-1 X_b: for the projective map this IS the estimated pose
    (remote points land in the local camera through it), no inverse."""
    device = resolve_device(device)
    P = len(pairs)
    if P == 0:
        return []
    built = []
    for uv_a, a3, ad, b3, bd in pairs:
        uv = np.zeros((MAX_CORRESPONDENCES, 2), np.float32)
        src = np.zeros((MAX_CORRESPONDENCES, 3), np.float32)
        dst = np.zeros((MAX_CORRESPONDENCES, 3), np.float32)
        valid = np.zeros(MAX_CORRESPONDENCES, np.float32)
        m = hamming_match(ad, bd, max_dist=max_hamming)
        if len(m) < max(min_inliers, 3):
            built.append((uv, src, dst, valid, False))
            continue
        n = min(len(m), MAX_CORRESPONDENCES)
        uv[:n] = uv_a[m[:n, 0]]
        src[:n] = b3[m[:n, 1]]          # remote 3D (the residual's source)
        dst[:n] = a3[m[:n, 0]]          # local 3D (init only; zeros OK)
        finite = np.isfinite(src).all(1)
        nonzero = np.abs(src).sum(1) > 1e-9   # remote depth must exist
        valid[:n] = 1.0
        valid *= (finite & nonzero).astype(np.float32)
        built.append((uv, src, dst, valid, True))
    live = [i for i in range(P) if built[i][4]]
    results = [(np.eye(4), False, 0)] * P
    if not live:
        return results
    uv, src, dst, valid = _padded(built, live, _pair_tier(len(live)), 4)
    Ts, inl = device_read.fetch(gnc_pnp_batch(
        src, uv, valid, dst, fx, fy, cx, cy, inlier_px=inlier_px,
        device=device))
    Ts = Ts.astype(np.float64)
    for slot, i in enumerate(live):
        n_in = int(inl[slot])
        results[i] = (Ts[slot], n_in >= min_inliers, n_in)
    return results


def project_to_3d(kp_xy: np.ndarray, depth: np.ndarray, fx: float, fy: float,
                  cx: float, cy: float) -> np.ndarray:
    """Back-project pixel keypoints through a depth image (RGB-D path).

    Returns [N, 3] camera-frame points; zero depth yields zero points
    (filtered downstream)."""
    if len(kp_xy) == 0:
        return np.zeros((0, 3), np.float32)
    z = depth[kp_xy[:, 1], kp_xy[:, 0]].astype(np.float32)
    x = (kp_xy[:, 0].astype(np.float32) - cx) * z / fx
    y = (kp_xy[:, 1].astype(np.float32) - cy) * z / fy
    return np.stack([x, y, z], axis=1)

"""Batched SE(3) Lie-group operations in PyTorch.

Counterpart of ``cslam_tpu/ops/se3.py`` (the replacement for the GTSAM
``Pose3`` machinery of the reference back end). Everything is expressed
over ``[..., 4, 4]`` homogeneous matrices and ``[..., 6]`` tangent vectors.

Conventions kept from the JAX package:
- tangent order ``xi = [omega(3), v(3)]`` — rotation first, then
  translation (GTSAM's order and that of the reference's noise sigmas);
- BetweenFactor measurement ``Z = X_from^-1 X_to``;
- float32 cancellation guards: every ratio switches to a 3-4 term Taylor
  branch for ``theta < 0.5`` (``theta^2 < _TAYLOR_SQ``), where the series
  truncation error is far below f32 eps.
"""
from __future__ import annotations

import torch

_SMALL = 1e-8
_TAYLOR_SQ = 0.25


def _eye3(like: torch.Tensor, batch) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        *batch, 3, 3)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """Cancellation-safe (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_SMALL ** 2))
    small = theta_sq < _SMALL
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    # (1 - cos t)/t^2 = 0.5 (sin(t/2)/(t/2))^2 — exact, no subtraction
    half_sinc = torch.where(small, 1.0 - theta_sq / 24.0,
                            torch.sin(0.5 * theta) / (0.5 * theta))
    b = 0.5 * half_sinc * half_sinc
    t4 = theta_sq * theta_sq
    c = torch.where(theta_sq < _TAYLOR_SQ,
                    1.0 / 6.0 - theta_sq / 120.0 + t4 / 5040.0
                    - t4 * theta_sq / 362880.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta_sq * theta, min=_SMALL ** 3))
    return a, b, c


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ``[..., 3] -> [..., 3, 3]`` rotation matrices."""
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    eye = _eye3(w, W.shape[:-2])
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: ``[..., 3, 3] -> [..., 3]`` via the quaternion
    route (accurate near pi), branch-free over the four Shepperd
    candidates."""
    m = R
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    q0 = torch.stack([safe_sqrt(t0),
                      (m[..., 2, 1] - m[..., 1, 2]) / safe_sqrt(t0),
                      (m[..., 0, 2] - m[..., 2, 0]) / safe_sqrt(t0),
                      (m[..., 1, 0] - m[..., 0, 1]) / safe_sqrt(t0)], dim=-1)
    q1 = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / safe_sqrt(t1),
                      safe_sqrt(t1),
                      (m[..., 0, 1] + m[..., 1, 0]) / safe_sqrt(t1),
                      (m[..., 0, 2] + m[..., 2, 0]) / safe_sqrt(t1)], dim=-1)
    q2 = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / safe_sqrt(t2),
                      (m[..., 0, 1] + m[..., 1, 0]) / safe_sqrt(t2),
                      safe_sqrt(t2),
                      (m[..., 1, 2] + m[..., 2, 1]) / safe_sqrt(t2)], dim=-1)
    q3 = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / safe_sqrt(t3),
                      (m[..., 0, 2] + m[..., 2, 0]) / safe_sqrt(t3),
                      (m[..., 1, 2] + m[..., 2, 1]) / safe_sqrt(t3),
                      safe_sqrt(t3)], dim=-1)
    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4 candidates, 4]
    best = torch.argmax(ts, dim=-1)
    q = torch.take_along_dim(
        qs, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)[..., 0, :]
    q = 0.5 * q
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # ensure w >= 0 for the shortest arc
    q = q * torch.sign(torch.where(q[..., :1] == 0, torch.ones_like(q[..., :1]),
                                   q[..., :1]))

    qw = torch.clamp(q[..., 0], -1.0, 1.0)
    qv = q[..., 1:]
    qv_sq = torch.sum(qv * qv, dim=-1)
    sin_half = torch.sqrt(torch.clamp(qv_sq, min=1e-24))
    half = torch.atan2(sin_half, qw)
    scale = torch.where(sin_half < _SMALL,
                        2.0 + 2.0 * half * half / 3.0,
                        2.0 * half / torch.clamp(sin_half, min=_SMALL))
    return qv * scale[..., None]


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: ``[..., 6] (omega, v) -> [..., 4, 4]``."""
    w, v = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_coeffs(theta_sq)
    W = hat(w)
    eye = _eye3(w, W.shape[:-2])
    WW = W @ W
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return _rt_to_matrix(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: ``[..., 4, 4] -> [..., 6] (omega, v)``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta_sq = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_coeffs(theta_sq)
    W = hat(w)
    eye = _eye3(w, W.shape[:-2])
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    # solve_ex: no error check, so no host read (V is invertible)
    v = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]
    return torch.cat([w, v], dim=-1)


def _rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = R.shape[:-2]
    # the identity's last row, made on the device (no host copy)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        *batch, 1, 4)
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _rt_to_matrix(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def between(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Relative transform A^-1 B (GTSAM ``between``)."""
    return inverse(A) @ B


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction: ``T * Exp(xi)``."""
    return T @ exp(xi)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint as a ``[..., 6, 6]`` matrix in (omega, v) ordering:
    ``Ad(T) [w; u] = [R w; t x (R w) + R u]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    zero = torch.zeros_like(R)
    top = torch.cat([R, zero], dim=-1)
    bottom = torch.cat([hat(t) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _so3_jl_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse LEFT Jacobian of SO(3): ``I - W/2 + e W^2`` with
    ``e = 1/theta^2 - cot(theta/2)/(2 theta)``."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_SMALL ** 2))
    half = 0.5 * theta
    t4 = theta_sq * theta_sq
    e = torch.where(
        theta_sq < _TAYLOR_SQ,
        1.0 / 12.0 + theta_sq / 720.0 + t4 / 30240.0
        + t4 * theta_sq / 1209600.0,
        1.0 / torch.clamp(theta_sq, min=_SMALL ** 2)
        - torch.cos(half) / torch.clamp(2.0 * theta * torch.sin(half),
                                        min=_SMALL ** 2))
    W = hat(w)
    eye = _eye3(w, W.shape[:-2])
    return eye - 0.5 * W + e[..., None, None] * (W @ W)


def _se3_Q(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Coupling block of the SE(3) LEFT Jacobian (Barfoot eq. 7.86)."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_SMALL ** 2))
    small = theta_sq < _TAYLOR_SQ
    t3 = torch.clamp(theta_sq * theta, min=_SMALL ** 3)
    t4 = torch.clamp(theta_sq * theta_sq, min=_SMALL ** 4)
    t5 = torch.clamp(t4 * theta, min=_SMALL ** 5)
    ts4 = theta_sq * theta_sq
    ts6 = ts4 * theta_sq
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(small,
                     1.0 / 6.0 - theta_sq / 120.0 + ts4 / 5040.0
                     - ts6 / 362880.0,
                     (theta - sin_t) / t3)
    c2 = torch.where(small,
                     1.0 / 24.0 - theta_sq / 720.0 + ts4 / 40320.0
                     - ts6 / 3628800.0,
                     (0.5 * theta_sq + cos_t - 1.0) / t4)
    c5 = torch.where(small,
                     -1.0 / 120.0 + theta_sq / 5040.0 - ts4 / 362880.0
                     + ts6 / 39916800.0,
                     (theta - sin_t - theta_sq * theta / 6.0) / t5)
    c4 = 0.5 * (c2 + 3.0 * c5)
    W, V = hat(w), hat(v)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    return (0.5 * V
            + c1[..., None, None] * (WV + VW + WVW)
            + c2[..., None, None] * (W @ WV + VW @ W - 3.0 * WVW)
            + c4[..., None, None] * (WVW @ W + W @ WVW))


def se3_jr_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse RIGHT Jacobian of SE(3) as ``[..., 6, 6]`` (omega, v order):
    ``Log(Exp(xi) Exp(eps)) ~= xi + Jr_inv(xi) eps``, computed as
    ``Jl_inv(-xi)`` with the block structure
    ``[[Jl_inv, 0], [-Jl_inv Q Jl_inv, Jl_inv]]``."""
    w, v = -xi[..., :3], -xi[..., 3:]
    Jinv = _so3_jl_inv(w)
    Q = _se3_Q(w, v)
    corner = -Jinv @ Q @ Jinv
    zero = torch.zeros_like(Jinv)
    top = torch.cat([Jinv, zero], dim=-1)
    bottom = torch.cat([corner, Jinv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block (symmetric orthogonalization)."""
    R = T[..., :3, :3]
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    fix = torch.cat([torch.ones(det.shape + (2,), dtype=T.dtype,
                                device=T.device), det[..., None]], dim=-1)
    Rn = (u * fix[..., None, :]) @ vt
    return _rt_to_matrix(Rn, T[..., :3, 3])

"""Trajectory accuracy metrics: ATE / RPE with Umeyama alignment.

The comparison harness the reference defers to external tooling for: align
an estimated trajectory to ground truth with the closed-form SE(3) Umeyama
fit, then report translational RMSE (ATE) and relative pose error (RPE).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares rigid transform T with dst ~ T @ src (points [N, 3])."""
    cs, cd = src.mean(0), dst.mean(0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def absolute_trajectory_error(
        estimates: Dict[Tuple[int, int], np.ndarray],
        ground_truth: Dict[Tuple[int, int], np.ndarray],
        align: bool = True) -> float:
    """Translational RMSE over common keys after optional rigid alignment."""
    keys = sorted(set(estimates) & set(ground_truth))
    if not keys:
        return float("nan")
    est = np.stack([np.asarray(estimates[k])[:3, 3] for k in keys])
    gt = np.stack([np.asarray(ground_truth[k])[:3, 3] for k in keys])
    if align and len(keys) >= 3:
        T = umeyama_alignment(est, gt)
        est = est @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def relative_pose_error(
        estimates: Dict[Tuple[int, int], np.ndarray],
        ground_truth: Dict[Tuple[int, int], np.ndarray],
        delta: int = 1) -> float:
    """Translational RMSE of consecutive (delta-separated) relative motions,
    computed per robot."""
    by_robot: Dict[int, list] = {}
    for (rid, kf) in sorted(set(estimates) & set(ground_truth)):
        by_robot.setdefault(rid, []).append(kf)
    errs = []
    for rid, kfs in by_robot.items():
        for a, b in zip(kfs[:-delta], kfs[delta:]):
            e_rel = (np.linalg.inv(estimates[(rid, a)])
                     @ estimates[(rid, b)])
            g_rel = (np.linalg.inv(ground_truth[(rid, a)])
                     @ ground_truth[(rid, b)])
            errs.append(np.linalg.norm(e_rel[:3, 3] - g_rel[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")

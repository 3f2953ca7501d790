"""Pure-NumPy versions of the native feature library.

A copy of ``cslam_tpu/native/fallback.py``: functionally identical to
``features.cpp`` beside it (same FAST ring, same LCG-generated BRIEF
pattern) but slower. In the port it is the differential-testing oracle of
the C++ code only; ``cslam_tpu_torch.native`` never falls back to it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
    (-1, -3)], np.int32)


def brief_pattern(pairs: int = 256) -> np.ndarray:
    """Regenerate the deterministic LCG pattern from features.cpp."""
    state = np.uint64(0x853C49E6748FEA9B)
    out = np.zeros(pairs * 4, np.int32)
    mul = np.uint64(6364136223846793005)
    add = np.uint64(1442695040888963407)
    with np.errstate(over="ignore"):  # uint64 wraparound is the LCG
        for i in range(pairs * 4):
            state = state * mul + add
            out[i] = int((state >> np.uint64(33)) % np.uint64(27)) - 13
    return out.reshape(pairs, 4)


def fast_detect(image: np.ndarray, threshold: int = 25,
                max_kp: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    img = image.astype(np.int32)
    h, w = img.shape
    if h < 9 or w < 9:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.int32)
    center = img[3:h - 3, 3:w - 3]
    ring = np.stack([img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx]
                     for dx, dy in _RING])           # [16, H', W']
    bright = ring > (center + threshold)[None]
    dark = ring < (center - threshold)[None]

    def max_run(mask):
        doubled = np.concatenate([mask, mask], axis=0).astype(np.int32)
        run = np.zeros_like(doubled[0])
        best = np.zeros_like(run)
        for i in range(32):
            run = (run + 1) * doubled[i]
            best = np.maximum(best, run)
        return best

    is_corner = (max_run(bright) >= 9) | (max_run(dark) >= 9)
    score = np.abs(ring - center[None]).sum(0) * is_corner
    # 3x3 NMS
    padded = np.pad(score, 1)
    neigh = np.stack([padded[1 + dy:1 + dy + score.shape[0],
                             1 + dx:1 + dx + score.shape[1]]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                      if (dx, dy) != (0, 0)])
    keep = (score > 0) & (score >= neigh.max(0))
    # exclude the 1px band the C++ NMS skips
    keep[0, :] = keep[-1, :] = False
    keep[:, 0] = keep[:, -1] = False
    ys, xs = np.nonzero(keep)
    scores = score[ys, xs]
    order = np.argsort(-scores)[:max_kp]
    xy = np.stack([xs[order] + 3, ys[order] + 3], axis=1).astype(np.int32)
    return xy, scores[order].astype(np.int32)


def _box_means(image: np.ndarray, points: np.ndarray, r: int = 2
               ) -> np.ndarray:
    integral = np.zeros((image.shape[0] + 1, image.shape[1] + 1), np.uint32)
    integral[1:, 1:] = image.astype(np.uint32).cumsum(0).cumsum(1)
    x, y = points[:, 0], points[:, 1]
    area = (2 * r + 1) ** 2
    return ((integral[y + r + 1, x + r + 1] - integral[y - r, x + r + 1]
             - integral[y + r + 1, x - r] + integral[y - r, x - r])
            // area).astype(np.int32)


def brief_describe(image: np.ndarray, kp_xy: np.ndarray) -> np.ndarray:
    n = len(kp_xy)
    out = np.zeros((n, 32), np.uint8)
    if n == 0:
        return out
    h, w = image.shape
    pattern = brief_pattern()
    valid = ((kp_xy[:, 0] >= 16) & (kp_xy[:, 1] >= 16)
             & (kp_xy[:, 0] < w - 16) & (kp_xy[:, 1] < h - 16))
    idx = np.nonzero(valid)[0]
    if not len(idx):
        return out
    kps = kp_xy[idx]
    for b in range(256):
        pa = kps + pattern[b, :2]
        pb = kps + pattern[b, 2:]
        bit = _box_means(image, pa) < _box_means(image, pb)
        out[idx[bit], b >> 3] |= np.uint8(1 << (b & 7))
    return out


_ORB_RADIUS = 15
_yy, _xx = np.mgrid[-_ORB_RADIUS:_ORB_RADIUS + 1,
                    -_ORB_RADIUS:_ORB_RADIUS + 1]
_ORB_MASK = (_xx * _xx + _yy * _yy) <= _ORB_RADIUS * _ORB_RADIUS


def keypoint_angles(image: np.ndarray, kp_xy: np.ndarray) -> np.ndarray:
    """Intensity-centroid orientations (ORB), radius-15 circular patch.
    Matches ``keypoint_angle`` in features.cpp exactly (integer moments,
    double atan2). Border keypoints get angle 0."""
    h, w = image.shape
    angles = np.zeros(len(kp_xy), np.float64)
    img = image.astype(np.int64)
    for i, (x, y) in enumerate(kp_xy):
        if x < 24 or y < 24 or x >= w - 24 or y >= h - 24:
            continue
        patch = img[y - _ORB_RADIUS:y + _ORB_RADIUS + 1,
                    x - _ORB_RADIUS:x + _ORB_RADIUS + 1]
        m10 = int(np.sum(_xx * patch * _ORB_MASK))
        m01 = int(np.sum(_yy * patch * _ORB_MASK))
        angles[i] = np.arctan2(float(m01), float(m10))
    return angles


def steered_brief_describe(image: np.ndarray, kp_xy: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """ORB-style steered BRIEF-256: pattern rotated per keypoint by the
    intensity-centroid angle. Returns (descriptors [N,32] uint8,
    angles [N] float32). Bit-identical to cslam_steered_brief_describe
    (same floor(v+0.5) rounding)."""
    n = len(kp_xy)
    out = np.zeros((n, 32), np.uint8)
    if n == 0:
        return out, np.zeros(0, np.float32)
    h, w = image.shape
    pattern = brief_pattern().astype(np.float64)  # [256, 4]
    angles = keypoint_angles(image, kp_xy)
    valid = ((kp_xy[:, 0] >= 24) & (kp_xy[:, 1] >= 24)
             & (kp_xy[:, 0] < w - 24) & (kp_xy[:, 1] < h - 24))
    for i in np.nonzero(valid)[0]:
        x, y = int(kp_xy[i, 0]), int(kp_xy[i, 1])
        c, s = np.cos(angles[i]), np.sin(angles[i])
        ax = x + np.floor(c * pattern[:, 0] - s * pattern[:, 1]
                          + 0.5).astype(np.int64)
        ay = y + np.floor(s * pattern[:, 0] + c * pattern[:, 1]
                          + 0.5).astype(np.int64)
        bx = x + np.floor(c * pattern[:, 2] - s * pattern[:, 3]
                          + 0.5).astype(np.int64)
        by = y + np.floor(s * pattern[:, 2] + c * pattern[:, 3]
                          + 0.5).astype(np.int64)
        va = _box_means(image, np.stack([ax, ay], axis=1))
        vb = _box_means(image, np.stack([bx, by], axis=1))
        bits = va < vb
        for b in np.nonzero(bits)[0]:
            out[i, b >> 3] |= np.uint8(1 << (b & 7))
    return out, angles.astype(np.float32)


def hamming_match(desc_a: np.ndarray, desc_b: np.ndarray,
                  max_dist: int = 64, ratio: float = 0.0) -> np.ndarray:
    if len(desc_a) == 0 or len(desc_b) == 0:
        return np.zeros((0, 2), np.int32)
    a = np.unpackbits(desc_a, axis=1).astype(np.int32)
    b = np.unpackbits(desc_b, axis=1).astype(np.int32)
    dist = (a[:, None, :] != b[None, :, :]).sum(-1)
    # all-zero descriptors are the border sentinel — exclude them (they
    # would mutually match at distance 0), mirroring features.cpp
    dist = np.where(a.sum(1)[:, None] == 0, 1 << 30, dist)
    dist = np.where(b.sum(1)[None, :] == 0, 1 << 30, dist)
    best_ab = dist.argmin(1)
    best_ba = dist.argmin(0)
    i = np.arange(len(desc_a))
    mutual = best_ba[best_ab] == i
    ok = mutual & (dist[i, best_ab] <= max_dist)
    if ratio > 0.0 and dist.shape[1] > 1:
        part = np.partition(dist, 1, axis=1)
        second = part[:, 1].astype(np.float64)
        ok &= dist[i, best_ab] <= ratio * second
    return np.stack([i[ok], best_ab[ok]], axis=1).astype(np.int32)

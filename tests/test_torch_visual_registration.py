"""The port's visual verification against the JAX package, on the CPU.

Both packages get the same seeded inputs: random rigid problems with 20%
outliers at ``benchmarks/verification_bench.py``'s widths (200 live of 512
correspondence slots), the rendered landmark scenes of
``tests/test_visual_frontend.py`` and its synthetic PnP pairs.

Tolerances: transforms within 1e-3 rad and 1e-3 m of the JAX package's,
inlier counts and success flags equal. The port's Kabsch rotation is a
float64 closed form where the JAX package takes a float32 SVD, so a count
could differ by one for a residual that sits on the inlier distance; the
data here keep every count clear of it and of ``min_inliers``.
``project_to_3d`` is exact. A mixed batch of PnP pairs (each accepting or
rejecting its own Gauss-Newton steps) equals the same pairs run one at a
time within 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import visual_registration as J
from cslam_tpu.native import brief_describe as j_brief
from cslam_tpu.native import fast_detect as j_fast
from cslam_tpu_torch.ops import visual_registration as T
from test_visual_frontend import CAM, make_world, pose_xyz_yaw, render
from torch_threads import one_torch_thread  # noqa: F401

ROT_TOL, TRANS_TOL = 1e-3, 1e-3
N = T.MAX_CORRESPONDENCES
FX, FY, CX, CY = (np.float32(v) for v in (CAM.fx, CAM.fy, CAM.cx, CAM.cy))


def _assert_close_T(got, want, rot_tol=ROT_TOL, trans_tol=TRANS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    dR = got[:3, :3].T @ want[:3, :3]
    angle = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1.0) / 2.0)))
    assert angle <= rot_tol, angle
    assert np.abs(got[:3, 3] - want[:3, 3]).max() <= trans_tol


def _rigid_batch(rng, P=4, n=200):
    """``verification_bench.make_batch``: P rigid problems, 20% outliers,
    padded to ``MAX_CORRESPONDENCES``."""
    src = np.zeros((P, N, 3), np.float32)
    dst = np.zeros((P, N, 3), np.float32)
    valid = np.zeros((P, N), np.float32)
    for i in range(P):
        pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        angle = rng.uniform(-0.5, 0.5)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        moved = pts @ R.T + rng.uniform(-1, 1, 3).astype(np.float32)
        moved[::5] += rng.uniform(2, 5, (len(moved[::5]), 3))
        src[i, :n], dst[i, :n], valid[i, :n] = pts, moved, 1.0
    return src, dst, valid


@pytest.fixture(scope="module")
def rigid():
    return _rigid_batch(np.random.default_rng(0))


def test_gnc_align_matches_reference(rigid):
    src, dst, valid = rigid
    want_T, want_inl = J.gnc_align(jnp.asarray(src[0]), jnp.asarray(dst[0]),
                                   jnp.asarray(valid[0]), 0.3)
    got_T, got_inl = T.gnc_align(src[0], dst[0], valid[0], 0.3,
                                 device="cpu")
    assert got_T.shape == (4, 4)
    _assert_close_T(got_T.numpy(), want_T)
    assert int(got_inl) == int(want_inl) == 160


def test_gnc_align_batch_matches_reference(rigid):
    src, dst, valid = rigid
    want_T, want_inl = J.gnc_align_batch(jnp.asarray(src), jnp.asarray(dst),
                                         jnp.asarray(valid), 0.3)
    got_T, got_inl = T.gnc_align_batch(torch.from_numpy(src), dst, valid,
                                       0.3, device="cpu")
    for i in range(len(src)):
        _assert_close_T(got_T[i].numpy(), np.asarray(want_T)[i])
    assert got_inl.tolist() == np.asarray(want_inl).tolist()


def _features(img, dep):
    kp, _ = j_fast(img, 25, 300)
    return (J.project_to_3d(kp, dep, CAM.fx, CAM.fy, CAM.cx, CAM.cy),
            j_brief(img, kp))


@pytest.fixture(scope="module")
def keyframe_pairs():
    """The JAX package's batched-verification scene: two overlapping pairs
    and one unrelated pair (descriptors from the JAX package's library;
    ``tests/test_torch_visual_features.py`` holds the port's equal)."""
    rng = np.random.default_rng(6)
    pts, tex = make_world(rng)
    pts_o, tex_o = make_world(np.random.default_rng(123))
    views = [_features(*render(pts, tex, pose)) for pose in (
        np.eye(4), pose_xyz_yaw(0.3, 0.1, 0, yaw=0.05),
        pose_xyz_yaw(-0.2, 0.3, 0, yaw=-0.1))]
    unrelated = _features(*render(pts_o, tex_o, np.eye(4)))
    return [(*views[0], *views[1]), (*views[0], *unrelated),
            (*views[1], *views[2])]


def test_verify_keyframe_pairs_matches_reference(keyframe_pairs):
    want = J.verify_keyframe_pairs(keyframe_pairs, min_inliers=10)
    got = T.verify_keyframe_pairs(keyframe_pairs, min_inliers=10,
                                  device="cpu")
    assert [g[1] for g in got] == [w[1] for w in want] == [True, False, True]
    for (Tg, sg, ng), (Tw, sw, nw) in zip(got, want):
        assert ng == nw
        if sw:
            assert ng >= 20           # clear of min_inliers
            _assert_close_T(Tg, Tw)


def test_three_live_pairs_pad_to_tier_four(keyframe_pairs):
    """Three live pairs run in the tier of four (one zero slot, as in the
    JAX package): flags and inlier counts equal, transforms within the
    file's limits."""
    pairs = [keyframe_pairs[0], keyframe_pairs[2], keyframe_pairs[0]]
    got = T.verify_keyframe_pairs(pairs, min_inliers=10, device="cpu")
    want = J.verify_keyframe_pairs(pairs, min_inliers=10)
    assert any(key[0] == "cpu" and key[1][0][0] == (4, N, 3)
               for key in T.ALIGN_GRAPHS.keys)
    assert [(g[1], g[2]) for g in got] == [(w[1], w[2]) for w in want]
    assert [g[1] for g in got] == [True] * 3
    for (Tg, _, _), (Tw, _, _) in zip(got, want):
        _assert_close_T(Tg, Tw)


def test_verify_keyframe_pair_matches_reference(keyframe_pairs):
    pair = keyframe_pairs[2]
    Tw, sw, nw = J.verify_keyframe_pair(*pair, min_inliers=10)
    Tg, sg, ng = T.verify_keyframe_pair(*pair, min_inliers=10, device="cpu")
    assert (sg, ng) == (sw, nw) and sg
    _assert_close_T(Tg, Tw)


def _pnp_pair(seed, n=220, outlier_frac=0.2, depth_noise=0.0):
    """``TestProjectiveVerification._synthetic_pair``, padded to N: points
    in b's frame, their noisy projections in a, 20% pixel outliers, a's
    depth optionally scaled by multiplicative noise."""
    rng = np.random.default_rng(seed)
    Z = pose_xyz_yaw(0.5, 0.3, 0.1, yaw=0.15)
    p_b = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 12, n)], axis=1).astype(np.float32)
    p_a = (p_b @ Z[:3, :3].T + Z[:3, 3]).astype(np.float32)
    uv = np.stack([CAM.fx * p_a[:, 0] / p_a[:, 2] + CAM.cx,
                   CAM.fy * p_a[:, 1] / p_a[:, 2] + CAM.cy],
                  axis=1).astype(np.float32)
    uv += rng.normal(scale=0.3, size=uv.shape).astype(np.float32)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(40, 200, (n_out, 2)).astype(np.float32)
    a3 = p_a.copy()
    if depth_noise:
        a3 *= (1.0 + rng.normal(scale=depth_noise, size=(n, 1))
               ).astype(np.float32)

    def pad(a):
        out = np.zeros((N,) + a.shape[1:], np.float32)
        out[:len(a)] = a
        return out
    return pad(p_b), pad(uv), pad(np.ones(n, np.float32)), pad(a3)


@pytest.fixture(scope="module")
def pnp_batch():
    """Three pairs that take different steps: clean depth, 25% depth noise,
    and no local depth at all (identity init)."""
    pairs = [_pnp_pair(0), _pnp_pair(1, outlier_frac=0.1, depth_noise=0.25),
             _pnp_pair(2, outlier_frac=0.1)]
    pairs[2][3][:] = 0.0
    return [np.stack(col) for col in zip(*pairs)]


def test_gnc_pnp_batch_matches_reference(pnp_batch):
    p3d, uv, valid, a3 = pnp_batch
    want_T, want_inl = J.gnc_pnp_batch(p3d, uv, valid, a3, FX, FY, CX, CY)
    got_T, got_inl = T.gnc_pnp_batch(p3d, uv, valid, a3, FX, FY, CX, CY,
                                     device="cpu")
    truth = pose_xyz_yaw(0.5, 0.3, 0.1, yaw=0.15)
    for i in range(3):
        _assert_close_T(got_T[i].numpy(), np.asarray(want_T)[i])
        _assert_close_T(got_T[i].numpy(), truth, 0.02, 0.05)
    assert got_inl.tolist() == np.asarray(want_inl).tolist()


def test_gnc_pnp_mixed_batch_equals_single_pairs(pnp_batch):
    """Each pair accepts or rejects its own Gauss-Newton step: the batch's
    results are the pairs' results one at a time."""
    got_T, got_inl = T.gnc_pnp_batch(*pnp_batch, FX, FY, CX, CY,
                                     device="cpu")
    for i in range(3):
        one_T, one_inl = T.gnc_pnp_batch(*(a[i:i + 1] for a in pnp_batch),
                                         FX, FY, CX, CY, device="cpu")
        torch.testing.assert_close(got_T[i], one_T[0], rtol=0, atol=1e-5)
        assert int(got_inl[i]) == int(one_inl[0])


@pytest.fixture(scope="module")
def projective_pairs():
    """The JAX package's projective bus-flow scene (rendered views 0.45 m
    apart) and an unrelated view, as ``(kp_a_uv, kp3d_a, desc_a, kp3d_b,
    desc_b)``."""
    rng = np.random.default_rng(3)
    pts, tex = make_world(rng)
    pts_o, tex_o = make_world(np.random.default_rng(99))
    out = []
    for a_scene, b_scene, Xb in (((pts, tex), (pts, tex),
                                  pose_xyz_yaw(0.4, 0.2, 0.0, yaw=0.1)),
                                 ((pts, tex), (pts_o, tex_o), np.eye(4))):
        img_a, dep_a = render(*a_scene, np.eye(4))
        kp_a, _ = j_fast(img_a, 25, 300)
        a3 = J.project_to_3d(kp_a, dep_a, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
        b3, db = _features(*render(*b_scene, Xb))
        out.append((kp_a.astype(np.float32), a3, j_brief(img_a, kp_a), b3,
                    db))
    return out


def test_verify_keyframe_pairs_projective_matches_reference(
        projective_pairs):
    args = (CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    want = J.verify_keyframe_pairs_projective(projective_pairs, *args,
                                              min_inliers=8)
    got = T.verify_keyframe_pairs_projective(projective_pairs, *args,
                                             min_inliers=8, device="cpu")
    assert [g[1] for g in got] == [w[1] for w in want] == [True, False]
    assert [g[2] for g in got] == [w[2] for w in want]
    assert got[0][2] >= 20
    _assert_close_T(got[0][0], want[0][0])
    truth = pose_xyz_yaw(0.4, 0.2, 0.0, yaw=0.1)
    np.testing.assert_allclose(got[0][0][:3, 3], truth[:3, 3], atol=0.1)


def test_project_to_3d_is_exact():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0, 9, (48, 64)).astype(np.float32)
    depth[::3, ::5] = 0.0
    kp = np.stack([rng.integers(0, 64, 90), rng.integers(0, 48, 90)],
                  axis=1).astype(np.int32)
    got = T.project_to_3d(kp, depth, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    want = J.project_to_3d(kp, depth, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert T.project_to_3d(kp[:0], depth, 1, 1, 0, 0).shape == (0, 3)


def test_warmups_run_on_the_named_device():
    T.warmup_verification(tiers=(1, 2), device="cpu")
    T.warmup_verification_projective(tiers=(1,), device="cpu")

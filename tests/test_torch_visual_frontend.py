"""The port's visual front end against the JAX package's, on the CPU: the
cases of ``tests/test_visual_frontend.py`` (native features, 3D-3D and
projective verification, stereo depth and the stereo camera model, steered
BRIEF, perspective realism, the RGB-D handler's bus flows, viz clouds and
payload bytes) and the visualization cases of ``tests/test_evaluation.py``
and ``tests/test_point_cloud2.py``, each run through both packages on the
same seeded scenes.

Limits: what is host code in both packages (features, stereo depth, camera
model, viz clouds, payloads and their byte counts) is equal exactly;
verification flags and inlier counts are equal, and transforms within
1e-3 rad and 1e-3 m of the JAX package's; each case also keeps the JAX
test's own bar on the port's result.
"""
import importlib
import logging
import math
from types import SimpleNamespace

import numpy as np
import pytest

import test_visual_frontend as ref
from torch_threads import one_torch_thread  # noqa: F401

ROT_TOL, TRANS_TOL = 1e-3, 1e-3


def _pkg(name):
    def mod(sub):
        return importlib.import_module(f"{name}.{sub}")
    ns = SimpleNamespace(
        name=name, native=mod("native"),
        fallback=mod("native.fallback"),
        vreg=mod("ops.visual_registration"),
        rgbd=mod("runtime.rgbd_frontend"), bus=mod("runtime.bus"),
        clock=mod("runtime.clock"), types=mod("types"),
        compression=mod("utils.compression"),
        viz=mod("runtime.visualization"),
        dev={"device": "cpu"} if name == "cslam_tpu_torch" else {})
    ns.cam = ns.rgbd.CameraModel(**vars(ref.CAM))
    return ns


J, T = _pkg("cslam_tpu"), _pkg("cslam_tpu_torch")
CAM = ref.CAM


def both(fn):
    """``fn(pkg)`` for the JAX package, then for the port."""
    return fn(J), fn(T)


def _assert_close_T(got, want, rot_tol=ROT_TOL, trans_tol=TRANS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    dR = got[:3, :3].T @ want[:3, :3]
    angle = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1.0) / 2.0)))
    assert angle <= rot_tol, angle
    assert np.abs(got[:3, 3] - want[:3, 3]).max() <= trans_tol


def _assert_same_results(got, want):
    """(T, success, inliers) lists: flags and counts equal, transforms of
    the verified pairs close."""
    assert [g[1:] for g in got] == [w[1:] for w in want]
    for (Tg, sg, _), (Tw, _, _) in zip(got, want):
        if sg:
            _assert_close_T(Tg, Tw)


def _ctx(P, rid=0, **extra):
    bus, clock = P.bus.MessageBus(), P.clock.VirtualClock()
    params = {"robot_id": rid, "max_nb_robots": 2,
              "frontend.map_manager_process_period_ms": 100, **extra}
    return bus, clock, P.bus.RobotContext(bus, clock, rid, params)


def _features(P, img, dep, thr=25, max_kp=300, steered=False):
    kp, _ = P.native.fast_detect(img, thr, max_kp)
    desc = (P.native.steered_brief_describe(img, kp)[0] if steered
            else P.native.brief_describe(img, kp))
    return (P.vreg.project_to_3d(kp, dep, CAM.fx, CAM.fy, CAM.cx, CAM.cy),
            desc)


# ---------------------------------------------------------------------------
# TestNativeFeatures
# ---------------------------------------------------------------------------


def test_native_matches_fallback_oracle():
    img, _ = ref.render(*ref.make_world(np.random.default_rng(0)), np.eye(4))

    def run(P):
        xy_n, _ = P.native.fast_detect(img, 25, 300)
        xy_f, _ = P.fallback.fast_detect(img, 25, 10000)
        assert {tuple(p) for p in xy_n.tolist()} <= \
            set(map(tuple, xy_f.tolist()))
        desc = P.native.brief_describe(img, xy_n)
        np.testing.assert_array_equal(desc,
                                      P.fallback.brief_describe(img, xy_n))
        return xy_n, desc
    (xy_j, d_j), (xy_t, d_t) = both(run)
    assert len(xy_t) > 30
    np.testing.assert_array_equal(xy_t, xy_j)
    np.testing.assert_array_equal(d_t, d_j)


def test_ratio_match_native_matches_fallback():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (70, 32), dtype=np.uint8)
    b[5] = a[3]
    b[11] = a[3]
    a[7] = 0
    b[9] = 0
    for ratio in (0.0, 0.8, 1.0):
        m_j, m_t = both(lambda P: P.native.hamming_match(
            a, b, max_dist=200, ratio=ratio))
        np.testing.assert_array_equal(m_t, m_j)
        np.testing.assert_array_equal(
            m_t, T.fallback.hamming_match(a, b, 200, ratio))
        for i, j in m_t:
            assert a[i].any() and b[j].any()


def test_matching_across_translated_view():
    pts, tex = ref.make_world(np.random.default_rng(1))
    img_a, _ = ref.render(pts, tex, np.eye(4))
    img_b, _ = ref.render(pts, tex, ref.pose_xyz_yaw(0.2, 0.1, 0.0))

    def run(P):
        kp_a, _ = P.native.fast_detect(img_a, 25, 300)
        kp_b, _ = P.native.fast_detect(img_b, 25, 300)
        return P.native.hamming_match(P.native.brief_describe(img_a, kp_a),
                                      P.native.brief_describe(img_b, kp_b),
                                      max_dist=40)
    pj, pt = both(run)
    np.testing.assert_array_equal(pt, pj)
    assert len(pt) > 20


# ---------------------------------------------------------------------------
# TestVisualVerification
# ---------------------------------------------------------------------------


def test_gnc_align_with_outliers():
    rng = np.random.default_rng(2)
    src = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    Tgt = ref.pose_xyz_yaw(1.0, -0.5, 0.2, yaw=0.4)
    dst = (src @ Tgt[:3, :3].T + Tgt[:3, 3]).astype(np.float32)
    dst[::7] += rng.uniform(3, 6, (len(dst[::7]), 3))
    (Tj, nj), (Tt, nt) = both(lambda P: P.vreg.gnc_align(
        src, dst, np.ones(100, np.float32), inlier_dist=0.2, **P.dev))
    _assert_close_T(np.asarray(Tt), np.asarray(Tj))
    np.testing.assert_allclose(np.asarray(Tt), Tgt, atol=0.02)
    assert int(nt) == int(nj) and 80 <= int(nt) <= 90


def test_verify_keyframe_pair_convention():
    pts, tex = ref.make_world(np.random.default_rng(3))
    Xa, Xb = ref.pose_xyz_yaw(0, 0, 0), ref.pose_xyz_yaw(0.4, 0.2, 0.0,
                                                         yaw=0.1)
    views = [ref.render(pts, tex, X) for X in (Xa, Xb)]

    def run(P):
        fa, fb = (_features(P, *v) for v in views)
        return P.vreg.verify_keyframe_pair(*fa, *fb, min_inliers=6,
                                           inlier_dist=0.3, **P.dev)
    want, got = both(run)
    _assert_same_results([got], [want])
    Z, success, inliers = got
    assert success and inliers > 10
    Z_gt = np.linalg.inv(Xa) @ Xb
    np.testing.assert_allclose(Z[:3, 3], Z_gt[:3, 3], atol=0.1)
    np.testing.assert_allclose(Z[:3, :3], Z_gt[:3, :3], atol=0.05)


def test_batched_verification_matches_single():
    pts, tex = ref.make_world(np.random.default_rng(6))
    other = ref.make_world(np.random.default_rng(123))
    renders = [ref.render(pts, tex, pose) for pose in (
        np.eye(4), ref.pose_xyz_yaw(0.3, 0.1, 0, yaw=0.05),
        ref.pose_xyz_yaw(-0.2, 0.3, 0, yaw=-0.1))]
    unrelated = ref.render(*other, np.eye(4))

    def run(P):
        v = [_features(P, *r) for r in renders]
        u = _features(P, *unrelated)
        pairs = [(*v[0], *v[1]), (*v[0], *u), (*v[1], *v[2])]
        batched = P.vreg.verify_keyframe_pairs(pairs, min_inliers=10,
                                               **P.dev)
        singles = [P.vreg.verify_keyframe_pair(*p, min_inliers=10, **P.dev)
                   for p in pairs]
        return batched, singles
    (bj, _), (bt, st) = both(run)
    for (Tb, sb, nb), (Ts, ss, ns) in zip(bt, st):
        assert sb == ss and nb == ns
        np.testing.assert_allclose(Tb, Ts, atol=1e-5)
    assert bt[0][1] and bt[2][1] and not bt[1][1]
    _assert_same_results(bt, bj)


def test_unrelated_scenes_fail():
    scenes = [ref.make_world(np.random.default_rng(4)),
              ref.make_world(np.random.default_rng(99))]
    renders = [ref.render(*s, np.eye(4)) for s in scenes]

    def run(P):
        fa, fb = (_features(P, *r) for r in renders)
        return P.vreg.verify_keyframe_pair(*fa, *fb, min_inliers=20,
                                           inlier_dist=0.3, **P.dev)
    want, got = both(run)
    assert got[1:] == want[1:] and not got[1]


# ---------------------------------------------------------------------------
# TestStereo, TestStereoCameraModel
# ---------------------------------------------------------------------------


def _stereo_pair(seed, n):
    pts, tex = ref.make_world(np.random.default_rng(seed), n=n)
    left = ref.render(pts, tex, np.eye(4), depth_too=False)
    right = ref.render(pts, tex, ref.pose_xyz_yaw(CAM.baseline, 0, 0),
                       depth_too=False)
    _, gt_depth = ref.render(pts, tex, np.eye(4))
    return left, right, gt_depth


def _assert_same_features(got, want):
    for name in ("keypoints", "keypoints3d", "descriptors"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_stereo_depth_accuracy():
    left, right, _ = _stereo_pair(5, 60)

    def run(P):
        fe = P.rgbd.StereoFrontEnd(_ctx(P)[2], P.cam, **P.dev)
        return fe._compute_local_features(left, right)
    want, got = both(run)
    _assert_same_features(got, want)
    have = got.keypoints3d[:, 2] > 0
    assert have.sum() > 15
    z = got.keypoints3d[have, 2]
    assert np.all(z > 2.0) and np.all(z < 13.0)


def _infos(P, tx):
    left = P.rgbd.CameraInfo(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy)
    right = P.rgbd.CameraInfo(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy,
                              tx=tx)
    return left, right


def test_baseline_from_right_tx():
    def run(P):
        model = P.rgbd.StereoCameraModel.from_camera_infos(
            *_infos(P, -CAM.fx * 0.12))
        cm = model.as_camera_model()
        return model.baseline, (cm.fx, cm.fy, cm.cx, cm.cy, cm.baseline)
    want, got = both(run)
    assert got == want and got[0] == pytest.approx(0.12)


def test_nonpositive_baseline_rejected():
    for P in (J, T):
        for tx in (CAM.fx * 0.12, 0.0):
            with pytest.raises(P.rgbd.StereoBaselineError,
                               match="is not positive"):
                P.rgbd.StereoCameraModel.from_camera_infos(*_infos(P, tx))


def test_missing_tx_fallback_baseline():
    want, got = both(lambda P: P.rgbd.StereoCameraModel.from_camera_infos(
        *_infos(P, 0.0), fallback_baseline=0.2).baseline)
    assert got == want == pytest.approx(0.2)


def test_large_baseline_warns_once(caplog, monkeypatch):
    def run(P):
        monkeypatch.setattr(P.rgbd.StereoCameraModel, "_warned_large", False)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=P.rgbd.__name__):
            m = P.rgbd.StereoCameraModel.from_camera_infos(
                *_infos(P, -CAM.fx * 25.0))
            P.rgbd.StereoCameraModel.from_camera_infos(
                *_infos(P, -CAM.fx * 25.0))
        return m.baseline, [r.message for r in caplog.records
                            if r.name == P.rgbd.__name__]
    (bj, mj), (bt, mt) = both(run)
    assert bt == bj == pytest.approx(25.0)
    assert mt == mj and sum("plausibility bound" in m for m in mt) == 1


def test_disparity_to_depth():
    d = np.array([CAM.fx * 0.12 / 4.0, 0.0, -2.0])
    zj, zt = both(lambda P: P.rgbd.StereoCameraModel.from_camera_infos(
        *_infos(P, -CAM.fx * 0.12)).disparity_to_depth(d))
    np.testing.assert_array_equal(zt, zj)
    assert zt[0] == pytest.approx(4.0, rel=1e-5)
    assert zt[1] == 0.0 and zt[2] == 0.0


def test_invalid_model_drops_frame():
    img = np.zeros((64, 64), np.uint8)

    def run(P):
        fe = P.rgbd.StereoFrontEnd(_ctx(P)[2], P.cam, **P.dev)
        odom = P.types.Odometry(pose=np.eye(4))
        fe.stereo_callback(img, img, odom,
                           *_infos(P, CAM.fx * 0.12))
        dropped = (len(fe.queue), fe.dropped_invalid_model)
        fe.stereo_callback(img, img, odom, *_infos(P, -CAM.fx * 0.12))
        return dropped, len(fe.queue), fe.stereo_model.baseline, \
            fe.camera.baseline
    want, got = both(run)
    assert got == want
    assert got[:2] == ((0, 1), 1) and got[2] == pytest.approx(0.12)


def test_metric_depth_from_camera_infos():
    left, right, gt_depth = _stereo_pair(11, 80)

    def run(P):
        model = P.rgbd.StereoCameraModel.from_camera_infos(
            *_infos(P, -CAM.fx * CAM.baseline))
        fe = P.rgbd.StereoFrontEnd(_ctx(P)[2], model, **P.dev)
        return fe._compute_local_features(left, right)
    want, got = both(run)
    _assert_same_features(got, want)
    have = got.keypoints3d[:, 2] > 0
    assert have.sum() > 15
    errs = [abs(Z - gt_depth[int(y), int(x)]) / gt_depth[int(y), int(x)]
            for (x, y), (_, _, Z) in zip(got.keypoints[have],
                                         got.keypoints3d[have])
            if gt_depth[int(y), int(x)] > 0]
    assert len(errs) > 10 and np.median(errs) < 0.05


# ---------------------------------------------------------------------------
# TestSteeredBrief
# ---------------------------------------------------------------------------


def test_steered_native_matches_fallback():
    img, _ = ref.render(*ref.make_world(np.random.default_rng(3), n=80),
                        np.eye(4))

    def run(P):
        kp, _ = P.native.fast_detect(img, 20, 128)
        d_n, a_n = P.native.steered_brief_describe(img, kp)
        d_f, a_f = P.fallback.steered_brief_describe(img, kp)
        assert np.array_equal(d_n, d_f)
        np.testing.assert_allclose(a_n, a_f, atol=1e-6)
        return d_n, a_n
    (dj, aj), (dt, at) = both(run)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("deg", [30, 60, 90])
def test_rotation_sweep(deg):
    img, _ = ref.render(*ref.make_world(np.random.default_rng(17), n=120),
                        np.eye(4))
    rot = ref.TestSteeredBrief._rotate(img, deg)
    correct = ref.TestSteeredBrief._correct_matches

    def run(P):
        nat = P.native
        kp_a, _ = nat.fast_detect(img, 20, 256)
        kp_b, _ = nat.fast_detect(rot, 20, 256)
        pairs_s = nat.hamming_match(nat.steered_brief_describe(img, kp_a)[0],
                                    nat.steered_brief_describe(rot, kp_b)[0],
                                    max_dist=50)
        pairs_u = nat.hamming_match(nat.brief_describe(img, kp_a),
                                    nat.brief_describe(rot, kp_b),
                                    max_dist=50)
        return (len(kp_a), len(kp_b),
                correct(kp_a, kp_b, pairs_s, deg, img.shape),
                correct(kp_a, kp_b, pairs_u, deg, img.shape))
    want, got = both(run)
    assert got == want
    n_a, n_b, good_s, good_u = got
    assert n_a > 30 and n_b > 30
    assert good_s >= 10 and good_s > 2 * good_u


# ---------------------------------------------------------------------------
# TestPerspectiveRealism
# ---------------------------------------------------------------------------

PR = ref.TestPerspectiveRealism


@pytest.fixture(scope="module")
def quads():
    return {seed: PR._make_quads(np.random.default_rng(seed))
            for seed in (21, 22, 23)}


def _pr_features(P, img, dep):
    return _features(P, img, dep, thr=18, max_kp=400, steered=True)


@pytest.mark.parametrize("roll", [15, 30])
def test_verification_survives_roll_and_perspective(quads, roll):
    Xa = PR._pose_roll(0, 0, 0, 0)
    Xb = PR._pose_roll(0.35, -0.2, 0.3, roll)
    ra = PR._render(quads[21], Xa)
    rb = PR._render(quads[21], Xb, gain=1.15, bias=-8.0)

    def run(P):
        pa, da = _pr_features(P, *ra)
        pb, db = _pr_features(P, *rb)
        assert len(pa) > 60 and len(pb) > 60
        return P.vreg.verify_keyframe_pair(pa, da, pb, db, min_inliers=8,
                                           inlier_dist=0.35, **P.dev)
    want, got = both(run)
    _assert_same_results([got], [want])
    Z, success, inliers = got
    assert success and inliers >= 12
    Z_gt = np.linalg.inv(Xa) @ Xb
    np.testing.assert_allclose(Z[:3, 3], Z_gt[:3, 3], atol=0.15)
    dR = Z[:3, :3].T @ Z_gt[:3, :3]
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) \
        < 5.0


def test_steered_beats_unsteered_at_30deg(quads):
    Xa, Xb = PR._pose_roll(0, 0, 0, 0), PR._pose_roll(0.15, 0.1, 0.0, 30)
    img_a, dep_a = PR._render(quads[22], Xa)
    img_b, dep_b = PR._render(quads[22], Xb)
    Z_gt = np.linalg.inv(Xa) @ Xb

    def run(P):
        nat = P.native
        kp_a, _ = nat.fast_detect(img_a, 18, 400)
        kp_b, _ = nat.fast_detect(img_b, 18, 400)
        pa = P.vreg.project_to_3d(kp_a, dep_a, CAM.fx, CAM.fy, CAM.cx,
                                  CAM.cy)
        pb = P.vreg.project_to_3d(kp_b, dep_b, CAM.fx, CAM.fy, CAM.cx,
                                  CAM.cy)

        def good(da, db):
            pairs = nat.hamming_match(da, db, max_dist=55)
            return sum(1 for i, j in pairs
                       if pa[i][2] > 0 and pb[j][2] > 0
                       and np.linalg.norm(Z_gt[:3, :3] @ pb[j] + Z_gt[:3, 3]
                                          - pa[i]) < 0.3)
        return (good(nat.steered_brief_describe(img_a, kp_a)[0],
                     nat.steered_brief_describe(img_b, kp_b)[0]),
                good(nat.brief_describe(img_a, kp_a),
                     nat.brief_describe(img_b, kp_b)))
    want, got = both(run)
    assert got == want
    assert got[0] >= 10 and got[0] >= 2 * max(got[1], 1)


def test_lighting_only_change_is_not_a_new_keyframe(quads):
    X = PR._pose_roll(0, 0, 0, 0)
    ra = PR._render(quads[23], X)
    rb = PR._render(quads[23], X, gain=0.75, bias=12.0)

    def run(P):
        return P.vreg.verify_keyframe_pair(
            *_pr_features(P, *ra), *_pr_features(P, *rb), min_inliers=10,
            inlier_dist=0.25, **P.dev)
    want, got = both(run)
    _assert_same_results([got], [want])
    assert got[1] and got[2] > 20
    np.testing.assert_allclose(got[0][:3, 3], np.zeros(3), atol=0.05)


# ---------------------------------------------------------------------------
# TestRGBDHandlerFlow, TestProjectiveVerification (bus flow)
# ---------------------------------------------------------------------------


def _two_robot_exchange(P, poses0, X1, scene, matches, **extra):
    """Robot 0 keyframes ``poses0``, robot 1 one keyframe at ``X1``; robot
    1 ships its keyframe 0 to robot 0's keyframes ``matches``. Returns the
    inter-robot loop closures, sorted by robot 0's keyframe."""
    bus, clock = P.bus.MessageBus(), P.clock.VirtualClock()
    params = {"max_nb_robots": 2,
              "frontend.map_manager_process_period_ms": 100, **extra}
    fes = [P.rgbd.RGBDFrontEnd(P.bus.RobotContext(
        bus, clock, rid, dict(params, robot_id=rid)), P.cam, **P.dev)
        for rid in (0, 1)]
    for rid, poses in ((0, poses0), (1, [X1])):
        for X in poses:
            img, dep = ref.render(*scene, X)
            fes[rid].rgbd_callback(img, dep, P.types.Odometry(pose=X))
            clock.advance(0.2)
            fes[rid].ctx.poll_timers()
    bus.deliver()
    assert [fe.nb_local_keyframes for fe in fes] == [len(poses0), 1]
    closures = []
    bus.subscribe("/cslam/inter_robot_loop_closure", closures.append)
    bus.publish("/r1/cslam/local_descriptors_request",
                P.types.LocalDescriptorsRequest(
                    keyframe_id=0, matches_robot_id=[0] * len(matches),
                    matches_keyframe_id=list(matches)))
    bus.deliver()
    return sorted(closures, key=lambda c: c.robot0_keyframe_id)


def _assert_same_closures(got, want):
    assert [(c.robot0_id, c.robot0_keyframe_id, c.robot1_id,
             c.robot1_keyframe_id, c.success) for c in got] == \
        [(c.robot0_id, c.robot0_keyframe_id, c.robot1_id,
          c.robot1_keyframe_id, c.success) for c in want]
    for g, w in zip(got, want):
        if g.success:
            _assert_close_T(g.transform, w.transform)


def test_inter_robot_verification_over_bus():
    scene = ref.make_world(np.random.default_rng(6))
    X0 = ref.pose_xyz_yaw(0, 0, 0)
    X1 = ref.pose_xyz_yaw(0.3, -0.2, 0.0, yaw=0.08)
    want, got = both(lambda P: _two_robot_exchange(P, [X0], X1, scene, [0]))
    _assert_same_closures(got, want)
    assert len(got) == 1 and got[0].success
    assert (got[0].robot0_id, got[0].robot1_id) == (0, 1)
    np.testing.assert_allclose(got[0].transform[:3, 3],
                               (np.linalg.inv(X0) @ X1)[:3, 3], atol=0.12)


def test_multi_match_message_batched_verification():
    scene = ref.make_world(np.random.default_rng(8))
    poses0 = [ref.pose_xyz_yaw(0, 0, 0), ref.pose_xyz_yaw(0.4, 0.2, 0,
                                                          yaw=0.1)]
    X1 = ref.pose_xyz_yaw(0.2, -0.1, 0.0, yaw=0.05)
    want, got = both(lambda P: _two_robot_exchange(P, poses0, X1, scene,
                                                   [0, 1]))
    _assert_same_closures(got, want)
    assert len(got) == 2
    for lc, X0 in zip(got, poses0):
        assert lc.success
        np.testing.assert_allclose(lc.transform[:3, 3],
                                   (np.linalg.inv(X0) @ X1)[:3, 3],
                                   atol=0.12)


def test_projective_flow_over_bus():
    scene = ref.make_world(np.random.default_rng(3))
    Xa = ref.pose_xyz_yaw(0, 0, 0)
    Xb = ref.pose_xyz_yaw(0.4, 0.2, 0.0, yaw=0.1)
    want, got = both(lambda P: _two_robot_exchange(
        P, [Xa], Xb, scene, [0],
        **{"frontend.verification_residual": "projective",
           "frontend.pnp_min_inliers": 8}))
    _assert_same_closures(got, want)
    assert got and got[0].success
    np.testing.assert_allclose(got[0].transform[:3, 3],
                               (np.linalg.inv(Xa) @ Xb)[:3, 3], atol=0.1)


def test_keyframe_gating_by_inlier_ratio():
    pts, tex = ref.make_world(np.random.default_rng(7))
    frames = [ref.render(pts, tex, np.eye(4))] * 2 + [
        ref.render(pts, tex, ref.pose_xyz_yaw(3.0, 1.5, 0, yaw=0.6))]

    def run(P):
        _, clock, ctx = _ctx(
            P, **{"frontend.keyframe_generation_ratio_threshold": 0.5})
        fe = P.rgbd.RGBDFrontEnd(ctx, P.cam, **P.dev)
        counts = []
        for img, dep in frames:
            fe.rgbd_callback(img, dep, P.types.Odometry(pose=np.eye(4)))
            clock.advance(0.2)
            ctx.poll_timers()
            counts.append(fe.nb_local_keyframes)
        return counts
    want, got = both(run)
    assert got == want == [1, 1, 2]


# ---------------------------------------------------------------------------
# TestProjectiveVerification (solver cases)
# ---------------------------------------------------------------------------

PV = ref.TestProjectiveVerification()
N = 512


def _pnp(P, p_b, uv, valid, a3):
    pad = PV._pad
    T_, inl = P.vreg.gnc_pnp_batch(
        pad(p_b, N)[None], pad(uv, N)[None], pad(valid, N)[None],
        pad(a3, N)[None], np.float32(CAM.fx), np.float32(CAM.fy),
        np.float32(CAM.cx), np.float32(CAM.cy), **P.dev)
    return np.asarray(T_)[0], int(np.asarray(inl)[0])


def test_pnp_convention_and_outliers():
    Z, p_b, uv, a3, valid, out_idx = PV._synthetic_pair(0)
    (Tj, nj), (Tt, nt) = both(lambda P: _pnp(P, p_b, uv, valid, a3))
    _assert_close_T(Tt, Tj)
    assert nt == nj
    np.testing.assert_allclose(Tt[:3, 3], Z[:3, 3], atol=0.03)
    np.testing.assert_allclose(Tt[:3, :3], Z[:3, :3], atol=0.02)
    assert nt > 0.9 * (len(p_b) - len(out_idx))


def test_projective_beats_3d3d_under_degraded_depth():
    Z, p_b, uv, a3, valid, _ = PV._synthetic_pair(1, outlier_frac=0.1,
                                                  depth_noise=0.25)
    pad = PV._pad

    def run(P):
        T_pnp, _ = _pnp(P, p_b, uv, valid, a3)
        T3, _ = P.vreg.gnc_align(pad(p_b, N), pad(a3, N), pad(valid, N),
                                 0.3, **P.dev)
        return T_pnp, np.asarray(T3)
    (pj, tj), (pt, tt) = both(run)
    _assert_close_T(pt, pj)
    _assert_close_T(tt, tj)
    err_pnp = np.linalg.norm(pt[:3, 3] - Z[:3, 3])
    err_3d = np.linalg.norm(tt[:3, 3] - Z[:3, 3])
    assert err_pnp < 0.05 and err_pnp < 0.5 * err_3d


def test_missing_local_depth_still_verifies():
    Z, p_b, uv, a3, valid, _ = PV._synthetic_pair(2, outlier_frac=0.1)
    a3[:] = 0.0
    (Tj, nj), (Tt, nt) = both(lambda P: _pnp(P, p_b, uv, valid, a3))
    _assert_close_T(Tt, Tj)
    assert nt == nj
    np.testing.assert_allclose(Tt[:3, 3], Z[:3, 3], atol=0.05)


# ---------------------------------------------------------------------------
# TestVizPublishing, TestPayloadCompression
# ---------------------------------------------------------------------------


def _keyframe_viz(P, stereo, **extra):
    bus, clock, ctx = _ctx(P, **extra)
    cls = P.rgbd.StereoFrontEnd if stereo else P.rgbd.RGBDFrontEnd
    fe = cls(ctx, P.cam, **P.dev)
    viz = []
    bus.subscribe("/cslam/viz/keyframe_pointcloud", viz.append)
    if stereo:
        left, right, _ = _stereo_pair(5, 60)
        fe.stereo_callback(left, right, P.types.Odometry(pose=np.eye(4)))
    else:
        img, dep = ref.render(*ref.make_world(np.random.default_rng(11)),
                              np.eye(4))
        fe.rgbd_callback(img, dep, P.types.Odometry(pose=np.eye(4)))
    clock.advance(0.2)
    ctx.poll_timers()
    bus.deliver()
    return fe.nb_local_keyframes, [(m.robot_id, m.keyframe_id, m.points)
                                   for m in viz]


def test_rgbd_keyframe_publishes_colored_cloud():
    want, got = both(lambda P: _keyframe_viz(
        P, False, **{"visualization.enable": True,
                     "visualization.stride": 2}))
    assert len(got[1]) == len(want[1]) == 1
    rid, kf, cloud = got[1][0]
    assert (rid, kf) == (0, 0) and cloud.shape[1] == 6
    np.testing.assert_array_equal(cloud, want[1][0][2])
    _, dep = ref.render(*ref.make_world(np.random.default_rng(11)),
                        np.eye(4))
    assert cloud.shape[0] == int((dep[::2, ::2] > 0).sum())
    np.testing.assert_allclose(np.sort(cloud[:, 2]),
                               np.sort(dep[::2, ::2][dep[::2, ::2] > 0]),
                               atol=1e-5)


def test_viz_disabled_publishes_nothing():
    want, got = both(lambda P: _keyframe_viz(P, False))
    assert got == want == (1, [])


def test_stereo_keyframe_publishes_sparse_cloud():
    want, got = both(lambda P: _keyframe_viz(
        P, True, **{"visualization.enable": True}))
    assert len(got[1]) == len(want[1]) == 1
    cloud = got[1][0][2]
    np.testing.assert_array_equal(cloud, want[1][0][2])
    assert cloud.shape[1] == 6 and cloud.shape[0] > 15
    assert np.all(cloud[:, 2] > 0)


def _shipped(P, **extra):
    """One robot-1 keyframe shipped on request: (messages sent, comm-byte
    log values, the keyframe's features)."""
    scene = ref.make_world(np.random.default_rng(9))
    bus, clock, ctx = _ctx(P, rid=1, **{"evaluation.enable_logs": True,
                                        **extra})
    fe = P.rgbd.RGBDFrontEnd(ctx, P.cam, **P.dev)
    img, dep = ref.render(*scene, ref.pose_xyz_yaw(0, 0, 0))
    fe.rgbd_callback(img, dep, P.types.Odometry(pose=np.eye(4)))
    clock.advance(0.2)
    ctx.poll_timers()
    bus.deliver()
    sent, logs = [], []
    bus.subscribe("/cslam/local_descriptors", sent.append)
    bus.subscribe("/r1/cslam/log_info", logs.append)
    bus.publish("/r1/cslam/local_descriptors_request",
                P.types.LocalDescriptorsRequest(keyframe_id=0,
                                                matches_robot_id=[0],
                                                matches_keyframe_id=[0]))
    bus.deliver()
    comm = [int(kv.value) for kv in logs
            if kv.key == "local_descriptors_cumulative_communication"]
    return sent, comm, fe


def test_wire_payload_is_compressed_bytes():
    (sj, cj, _), (st, ct, fe) = both(_shipped)
    assert len(st) == len(sj) == 1
    msg = st[0]
    assert isinstance(msg.descriptors, bytes)
    assert isinstance(msg.keypoints3d, bytes)
    for name in ("keypoints", "keypoints3d", "descriptors"):
        assert getattr(msg, name) == getattr(sj[0], name)
    assert ct == cj and ct[-1] > 0
    np.testing.assert_array_equal(
        T.compression.decompress_array(msg.descriptors),
        fe.features[0].descriptors)


def test_receiver_accepts_uncompressed_peer():
    (sj, _, _), (st, _, fe) = both(
        lambda P: _shipped(P, **{"frontend.compress_payloads": False}))
    assert len(st) == 1 and isinstance(st[0].descriptors, np.ndarray)
    np.testing.assert_array_equal(st[0].descriptors, sj[0].descriptors)
    fe.receive_local_image_descriptors(st[0])


# ---------------------------------------------------------------------------
# Visualization (tests/test_evaluation.py, tests/test_point_cloud2.py)
# ---------------------------------------------------------------------------


def test_colored_pointcloud():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 10, (48, 64)).astype(np.float32)
    depth[0, 0] = 0.0
    depth[1, 1] = np.inf
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    d16 = (depth * 1000).astype(np.uint16)

    def run(P):
        f = P.viz.create_colored_pointcloud
        return (f(depth, rgb, fx=100, fy=100, cx=32, cy=24),
                f(d16, rgb, 100, 100, 32, 24))
    (cj, c16j), (ct, c16t) = both(run)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(c16t, c16j)
    assert ct.shape == (48 * 64 - 2, 6) and np.all(ct[:, 2] > 0)
    assert abs(len(c16t) - len(ct)) < 5


def test_pose_graph_ply(tmp_path):
    values = {(r, k): np.array([[1, 0, 0, k], [0, 1, 0, r], [0, 0, 1, 0],
                                [0, 0, 0, 1.0]])
              for r in range(2) for k in range(3)}

    def run(P):
        edges = [P.types.PoseGraphEdge(key_from=P.types.PoseKey(0, 0),
                                       key_to=P.types.PoseKey(1, 2))]
        path = tmp_path / f"{P.name}.ply"
        P.viz.pose_graph_to_ply(str(path), values, edges)
        return path.read_text()
    want, got = both(run)
    assert got == want
    assert "element vertex 6" in got and "element edge 1" in got


def test_packed_rgb_round_trip():
    rng = np.random.default_rng(12)
    cloud = np.concatenate(
        [rng.standard_normal((50, 3)).astype(np.float32),
         rng.integers(0, 256, (50, 3)).astype(np.float32)], axis=1)

    def run(P):
        msg = P.viz.colored_cloud_to_pointcloud2(cloud, frame_id="map")
        return msg, P.viz.pointcloud2_to_colored_cloud(msg)
    (mj, bj), (mt, bt) = both(run)
    assert mt.point_step == 16 and mt.frame_id == "map"
    assert bytes(mt.data) == bytes(mj.data)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_allclose(bt[:, :3], cloud[:, :3])
    np.testing.assert_array_equal(bt[:, 3:], cloud[:, 3:])


def test_depth_backprojection_to_wire():
    depth = np.full((8, 8), 2.0, np.float32)
    rgb = np.zeros((8, 8, 3), np.uint8)
    rgb[..., 0] = 200

    def run(P):
        cloud = P.viz.create_colored_pointcloud(depth, rgb, 10, 10, 4, 4)
        return P.viz.colored_cloud_to_pointcloud2(cloud)
    mj, mt = both(run)
    assert mt.nb_points == mj.nb_points == 64
    assert bytes(mt.data) == bytes(mj.data)

"""KITTI-format replay in the port (``cslam_tpu_torch/runtime/replay.py``),
on the CPU: the cases of ``tests/test_replay.py`` on the port, and parity
with the JAX package.

One stereo sequence (``tests/test_replay.py``'s rendered sweep that
revisits itself, 14 frames) and two velodyne sequences (its scene loop,
two robots x 10 scans) are made from seeds with numpy and written once
per module. The stereo directory is written twice: by the port's writer
(its own PNG codec) and by the JAX package's (Pillow). Both packages' drivers
run over the port-written directories with ``frontend.async_detection``
and ``frontend.async_verification`` off (the JAX package's async harvest
timing depends on its dispatch threads).

Limits: ``KittiSequence`` frames equal byte for byte in both packages and
for both writers; ``utils/png.py`` equal to Pillow byte for byte both
ways, on every filter type; keyframe counts, fixed edges and verified
inter-robot loops equal to the JAX package's, ATE within 1e-3 m.
"""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cslam_tpu_torch.runtime.replay import (KittiCalib, KittiSequence,
                                            LidarReplayDriver, ReplayDriver,
                                            TinyImageDescriptor,
                                            write_kitti_sequence)
from cslam_tpu_torch.utils import png
from torch_threads import one_torch_thread  # noqa: F401

ATE_TOL = 1e-3
N_FRAMES = 14

STEREO_OVERRIDES = {
    "frontend.similarity_threshold": 0.95,
    "frontend.inter_robot_detection_period_sec": 1.0,
    "frontend.detection_publication_period_sec": 0.5,
    "backend.pose_graph_optimization_start_period_ms": 1500,
    "frontend.async_detection": False,
    "frontend.async_verification": False,
}
LIDAR_OVERRIDES = {
    "frontend.similarity_threshold": 0.7,
    "frontend.keyframe_generation_ratio_distance": 0.5,
    "frontend.voxel_size": 0.4,
    "frontend.registration_min_inliers": 30,
    "frontend.inter_robot_detection_period_sec": 1.0,
    "frontend.detection_publication_period_sec": 0.5,
    "backend.pose_graph_optimization_start_period_ms": 1500,
    "frontend.async_detection": False,
    "frontend.async_verification": False,
}


def _stereo_frames(n_frames=N_FRAMES, seed=2):
    """``tests/test_replay.make_sequence_dir``'s sweep (two passes over the
    same poses, the second jittered by 3 cm): (lefts, rights, poses)."""
    from test_visual_frontend import CAM, make_world, pose_xyz_yaw, render
    rng = np.random.default_rng(seed)
    pts, tex = make_world(rng, n=140)
    n_unique = n_frames // 2
    poses = [pose_xyz_yaw(0.25 * (k % n_unique) + 0.03 * (k >= n_unique),
                          0.02 * (k % n_unique), 0.0)
             for k in range(n_frames)]
    shift = np.eye(4)
    shift[0, 3] = CAM.baseline
    lefts = [render(pts, tex, T, depth_too=False) for T in poses]
    rights = [render(pts, tex, T @ shift, depth_too=False) for T in poses]
    return lefts, rights, poses


def _lidar_scans(nb_robots=2, n_steps=10, n_scenes=5, seed=11):
    """``tests/test_replay.make_lidar_sequence_dirs``'s data: robots
    traverse a shared loop of structured scenes. Returns per robot
    (poses, scans)."""
    from test_lidar_e2e import scene_cloud
    rng = np.random.default_rng(seed)
    scenes = [scene_cloud(500 + s, n=700) for s in range(n_scenes)]

    def pose_at(x, y):
        T = np.eye(4)
        T[:3, 3] = [x, y, 0.0]
        return T
    scene_pose = [pose_at(6.0 * s, 0.0) for s in range(n_scenes)]
    out = []
    for rid in range(nb_robots):
        poses, scans = [], []
        for i in range(n_steps):
            s = (i + 2 * rid) % n_scenes
            p = scene_pose[s] @ pose_at(0.2 * rid, 0.15 * rid)
            world = scenes[s] @ scene_pose[s][:3, :3].T + scene_pose[s][:3, 3]
            inv = np.linalg.inv(p)
            local = world @ inv[:3, :3].T + inv[:3, 3]
            scans.append((local + rng.normal(scale=0.02, size=local.shape)
                          ).astype(np.float32))
            poses.append(p)
        out.append((poses, scans))
    return out


@pytest.fixture(scope="module")
def stereo_dirs(tmp_path_factory):
    """{"port": dir written by the port, "pillow": by the JAX package}."""
    from test_visual_frontend import CAM

    from cslam_tpu.runtime import replay as ref_replay
    lefts, rights, poses = _stereo_frames()
    times = [0.1 * k for k in range(N_FRAMES)]
    dirs = {}
    for name, writer in (("port", write_kitti_sequence),
                         ("pillow", ref_replay.write_kitti_sequence)):
        d = tmp_path_factory.mktemp(f"stereo_{name}") / "seq00"
        writer(str(d), lefts, rights, poses, CAM.fx, CAM.fy, CAM.cx, CAM.cy,
               CAM.baseline, times=times)
        dirs[name] = d
    return dirs


@pytest.fixture(scope="module")
def lidar_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lidar")
    dirs = []
    for rid, (poses, scans) in enumerate(_lidar_scans()):
        d = root / f"lidar_seq{rid}"
        write_kitti_sequence(str(d), None, None, poses, scans=scans,
                             times=[0.1 * i for i in range(len(scans))])
        dirs.append(d)
    return dirs


def _summary(driver):
    """What the parity tests compare, per robot."""
    out = []
    for rid, robot in enumerate(driver.robots):
        out.append({
            "keyframes": robot.frontend.nb_local_keyframes,
            "fixed": sorted(e.key() for e in robot.detection.lcm
                            .candidate_selector.fixed_edges),
            "loops": sorted(
                (e.key_from.robot_id, e.key_from.keyframe_id,
                 e.key_to.robot_id, e.key_to.keyframe_id)
                for v in robot.backend.inter_robot_loop_closures.values()
                for e in v),
            "optimizations": robot.backend.optimization_count,
            "ate": driver.ate(rid)})
    return out


@pytest.fixture(scope="module")
def stereo_runs(stereo_dirs):
    """(port driver, JAX package summary) of the two-robot stereo replay
    over the port-written directory."""
    from cslam_tpu.runtime import replay as ref_replay
    runs = {}
    for name, mod, kw in (("port", None, {"device": "cpu"}),
                          ("ref", ref_replay, {})):
        seq_cls = KittiSequence if mod is None else mod.KittiSequence
        drv_cls = ReplayDriver if mod is None else mod.ReplayDriver
        tiny = (TinyImageDescriptor if mod is None
                else mod.TinyImageDescriptor)
        seq = seq_cls(str(stereo_dirs["port"]))
        driver = drv_cls([seq, seq], frame_ranges=[range(0, 7),
                                                   range(7, 14)],
                         odom_noise=0.01, model=tiny(),
                         config_overrides=STEREO_OVERRIDES, **kw)
        driver.run(extra_steps=40, dt=0.25)
        runs[name] = driver
    return runs["port"], _summary(runs["ref"])


@pytest.fixture(scope="module")
def lidar_runs(lidar_dirs):
    from cslam_tpu.runtime import replay as ref_replay
    runs = {}
    for name, mod, kw in (("port", None, {"device": "cpu"}),
                          ("ref", ref_replay, {})):
        seq_cls = KittiSequence if mod is None else mod.KittiSequence
        drv_cls = (LidarReplayDriver if mod is None
                   else mod.LidarReplayDriver)
        driver = drv_cls([seq_cls(str(d)) for d in lidar_dirs],
                         odom_noise=0.01, config_overrides=LIDAR_OVERRIDES,
                         **kw)
        driver.run(extra_steps=40, dt=0.25)
        runs[name] = driver
    return runs["port"], _summary(runs["ref"])


# -- the cases of tests/test_replay.py on the port ---------------------------

class TestKittiLoader:

    def test_roundtrip(self, stereo_dirs):
        from test_visual_frontend import CAM
        _, _, poses = _stereo_frames()
        seq = KittiSequence(str(stereo_dirs["port"]))
        assert len(seq) == N_FRAMES
        left, right, gt, t = seq.frame(2)
        assert left.shape == (240, 320) and right.shape == (240, 320)
        np.testing.assert_allclose(gt, poses[2], atol=1e-9)
        assert t == pytest.approx(0.2)
        model = seq.calib.stereo_model()
        assert model.baseline == pytest.approx(CAM.baseline)
        assert model.left.fx == pytest.approx(CAM.fx)

    def test_calib_without_right_camera(self, tmp_path):
        (tmp_path / "calib.txt").write_text(
            "P0: 300 0 160 0 0 300 120 0 0 0 1 0\n")
        calib = KittiCalib.load(str(tmp_path / "calib.txt"))
        left, right = calib.camera_infos()
        assert right is None and left.fx == 300.0


class TestReplayDriver:

    def test_two_robot_replay_end_to_end(self, stereo_runs):
        """Two robots replay overlapping halves of one on-disk sequence:
        keyframes form, inter-robot loop closures verify geometrically,
        PGO produces finite estimates with ATE near the odometry's."""
        driver, _ = stereo_runs
        assert driver.device.type == "cpu"
        r0, r1 = driver.robots
        assert r0.frontend.nb_local_keyframes >= 5
        assert r1.frontend.nb_local_keyframes >= 5
        inter0 = sum(len(v) for v in
                     r0.backend.inter_robot_loop_closures.values())
        inter1 = sum(len(v) for v in
                     r1.backend.inter_robot_loop_closures.values())
        assert inter0 + inter1 > 0, "no inter-robot loop closure verified"
        assert (r0.backend.optimization_count
                + r1.backend.optimization_count) > 0
        ate_odo, ate_opt = driver.ate(0)
        assert np.isfinite(ate_opt)
        assert ate_opt < max(2.0 * ate_odo, 0.2)


class TestLidarReplay:

    def test_velodyne_loader_roundtrip(self, lidar_dirs):
        seq = KittiSequence(str(lidar_dirs[0]))
        assert seq.nb_scans == 10 and len(seq) == 10
        raw = seq.scan(1)
        assert raw.shape[1] == 4 and raw.dtype == np.float32
        cloud = seq.scan_cloud(1)
        assert cloud.point_step == 16
        from cslam_tpu_torch.utils.point_cloud2 import xyz_array
        np.testing.assert_allclose(xyz_array(cloud), raw[:, :3])

    def test_two_robot_lidar_replay_end_to_end(self, lidar_runs):
        """Full lidar product path from on-disk KITTI velodyne data:
        PointCloud2 decode -> voxel/keyframe gate -> scan-context match ->
        robust ICP verification -> PGO estimates."""
        driver, _ = lidar_runs
        r0, r1 = driver.robots
        assert r0.frontend.nb_local_keyframes >= 5
        assert r1.frontend.nb_local_keyframes >= 5
        inter = sum(len(v) for v in
                    r0.backend.inter_robot_loop_closures.values()) + \
            sum(len(v) for v in
                r1.backend.inter_robot_loop_closures.values())
        assert inter > 0, "no inter-robot loop closure verified"
        ate_odo, ate_opt = driver.ate(0)
        assert np.isfinite(ate_opt)
        assert ate_opt < max(2.0 * ate_odo, 0.2)


# -- parity with the JAX package ---------------------------------------------

@pytest.mark.parametrize("writer", ["port", "pillow"])
def test_kitti_sequence_frames_equal_reference(stereo_dirs, writer):
    """Both packages' loaders give the same frames, byte for byte, whether
    Pillow or the port's codec wrote the PNGs."""
    from cslam_tpu.runtime import replay as ref_replay
    ours = KittiSequence(str(stereo_dirs[writer]))
    ref = ref_replay.KittiSequence(str(stereo_dirs[writer]))
    lefts, rights, _ = _stereo_frames()
    assert len(ours) == len(ref) == N_FRAMES
    for i in range(N_FRAMES):
        (l0, r0, g0, t0), (l1, r1, g1, t1) = ours.frame(i), ref.frame(i)
        assert l0.dtype == l1.dtype == np.uint8
        assert l0.tobytes() == l1.tobytes() == lefts[i].tobytes()
        assert r0.tobytes() == r1.tobytes() == rights[i].tobytes()
        assert np.array_equal(g0, g1) and t0 == t1


def test_velodyne_scans_equal_reference(lidar_dirs):
    from cslam_tpu.runtime import replay as ref_replay
    from cslam_tpu.utils.point_cloud2 import xyz_array as ref_xyz

    from cslam_tpu_torch.utils.point_cloud2 import xyz_array
    ours = KittiSequence(str(lidar_dirs[1]))
    ref = ref_replay.KittiSequence(str(lidar_dirs[1]))
    assert ours.nb_scans == ref.nb_scans == 10
    for i in (0, 9):
        assert ours.scan(i).tobytes() == ref.scan(i).tobytes()
        assert (xyz_array(ours.scan_cloud(i)).tobytes()
                == ref_xyz(ref.scan_cloud(i)).tobytes())
    assert all(np.array_equal(a, b)
               for a, b in zip(ours.gt_poses, ref.gt_poses))


@pytest.fixture(params=["stereo", "lidar"])
def runs(request):
    return request.getfixturevalue(f"{request.param}_runs")


def test_keyframes_match_reference(runs):
    driver, ref = runs
    port = _summary(driver)
    assert [r["keyframes"] for r in port] == [r["keyframes"] for r in ref]
    assert all(r["keyframes"] >= 5 for r in port)


def test_fixed_edges_match_reference(runs):
    driver, ref = runs
    port = _summary(driver)
    assert [r["fixed"] for r in port] == [r["fixed"] for r in ref]
    assert sum(len(r["fixed"]) for r in port) >= 1


def test_verified_loops_match_reference(runs):
    driver, ref = runs
    port = _summary(driver)
    assert [r["loops"] for r in port] == [r["loops"] for r in ref]
    assert sum(len(r["loops"]) for r in port) >= 1
    assert ([r["optimizations"] for r in port]
            == [r["optimizations"] for r in ref])


def test_ate_matches_reference(runs):
    driver, ref = runs
    for port_r, ref_r in zip(_summary(driver), ref):
        for a, b in zip(port_r["ate"], ref_r["ate"]):
            assert abs(a - b) <= ATE_TOL, (port_r["ate"], ref_r["ate"])


# -- the PNG codec against Pillow --------------------------------------------

def _encode_with_filter(img, ftypes):
    """A PNG whose row ``r`` is filtered with ``ftypes[r % len(ftypes)]``
    (PNG 1.2 section 6: none, sub, up, average, Paeth)."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    x = img.reshape(h, w * bpp).astype(np.int32)
    rows = []
    for r in range(h):
        cur = x[r]
        prev = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        t = ftypes[r % len(ftypes)]
        pred = [0 * cur, left, prev, (left + prev) >> 1, paeth][t]
        rows.append(bytes([t]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
    return _png_file(w, h, 0 if bpp == 1 else 2, 8, 0,
                     zlib.compress(b"".join(rows)))


def _png_file(w, h, colour, depth, interlace, idat):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                         0, interlace))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _pixels(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", [(24, 31), (17, 29, 3)])
@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4],
                                    [0, 1, 2, 3, 4]])
def test_png_decodes_each_filter_as_pillow(shape, ftypes):
    img = _pixels(shape)
    data = _encode_with_filter(img, ftypes)
    ours = png.decode_png(data)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert ours.tobytes() == pil.tobytes() == img.tobytes()
    assert ours.shape == pil.shape


@pytest.mark.parametrize("shape", [(240, 320), (37, 53, 3)])
def test_png_both_ways_with_pillow(shape):
    """Pillow's own files (its adaptive filter choice) read as Pillow reads
    them; the port's files read in Pillow as written."""
    img = _pixels(shape, seed=3)
    img[::2] = (np.arange(img[::2].size) % 256).astype(np.uint8).reshape(
        img[::2].shape)       # smooth rows, so Pillow mixes its filters
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert png.decode_png(buf.getvalue()).tobytes() == img.tobytes()
    ours = png.encode_png(img)
    assert np.asarray(Image.open(io.BytesIO(ours))).tobytes() == \
        img.tobytes()


def test_png_luma_matches_pillow():
    img = _pixels((33, 45, 3), seed=4)
    assert (png.to_luma(img).tobytes()
            == np.asarray(Image.fromarray(img).convert("L")).tobytes())


@pytest.mark.parametrize("colour,depth,interlace,words", [
    (3, 8, 0, "colour type 3 (palette), bit depth 8, interlace method 0"),
    (0, 16, 0, "colour type 0 (grayscale), bit depth 16"),
    (6, 8, 0, "colour type 6 (RGBA)"),
    (0, 8, 1, "interlace method 1")])
def test_png_other_formats_raise(colour, depth, interlace, words):
    data = _png_file(4, 4, colour, depth, interlace, zlib.compress(b"\0" * 80))
    with pytest.raises(png.PngFormatError, match=words.replace("(", r"\(")
                       .replace(")", r"\)")):
        png.decode_png(data)
    with pytest.raises(png.PngFormatError, match="CRC"):
        png.decode_png(data[:20] + bytes([data[20] ^ 1]) + data[21:])

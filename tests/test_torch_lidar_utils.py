"""The port's host-only lidar utilities (copies of the JAX package's) and
the lidar front end's intake and exchange, against the JAX package: the
same bytes on the wire, the same decoded points, the same keyframes.
Exact comparisons: both sides are numpy."""
import numpy as np
import pytest

from cslam_tpu.utils import compression as j_comp
from cslam_tpu.utils import point_cloud2 as j_pc2
from cslam_tpu_torch.utils import compression as t_comp
from cslam_tpu_torch.utils import point_cloud2 as t_pc2
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("quantize_f16", [False, True])
def test_compression_same_bytes_both_ways(quantize_f16):
    cloud = np.random.default_rng(0).uniform(-40, 40, (1500, 3)).astype(
        np.float32)
    blob = t_comp.compress_array(cloud, quantize_f16=quantize_f16)
    assert blob == j_comp.compress_array(cloud, quantize_f16=quantize_f16)
    for decode in (t_comp.maybe_decompress, j_comp.maybe_decompress):
        out = decode(blob)
        tol = 0.02 if quantize_f16 else 0.0
        np.testing.assert_allclose(out, cloud, atol=tol)
    assert t_comp.payload_nbytes(blob) == j_comp.payload_nbytes(blob)
    assert t_comp.maybe_decompress(cloud) is cloud


def test_point_cloud2_round_trip_matches_reference():
    rng = np.random.default_rng(1)
    rec = np.zeros(64, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                              ("intensity", "<f4")])
    for name in ("x", "y", "z", "intensity"):
        rec[name] = rng.standard_normal(64).astype(np.float32)
    rec["y"][5] = np.nan
    for pc2 in (t_pc2, j_pc2):
        cloud = pc2.make_cloud(rec, frame_id="r0/lidar")
        want = j_pc2.xyz_array(cloud)
        got = t_pc2.xyz_array(cloud)
        assert got.shape == (63, 3) and np.array_equal(got, want)
        assert np.array_equal(
            t_pc2.read_points_numpy(cloud, skip_nans=False),
            j_pc2.read_points_numpy(cloud, skip_nans=False), equal_nan=True)
    xyz = rng.standard_normal((10, 3))
    assert (t_pc2.make_cloud_xyz32(xyz).data
            == j_pc2.make_cloud_xyz32(xyz).data)


def _front_end(pkg):
    import importlib
    cfg = importlib.import_module(f"{pkg}.config").CslamConfig(
        robot_id=0, max_nb_robots=2)
    cfg.frontend.voxel_size = 0.4
    bus_mod = importlib.import_module(f"{pkg}.runtime.bus")
    clock = importlib.import_module(f"{pkg}.runtime.clock").VirtualClock()
    bus = bus_mod.MessageBus()
    ctx = bus_mod.RobotContext(bus, clock, 0, cfg.flatten())
    pc2 = importlib.import_module(f"{pkg}.utils.point_cloud2")
    kwargs = {"device": "cpu"} if pkg == "cslam_tpu_torch" else {}
    fe = importlib.import_module(f"{pkg}.runtime.lidar_frontend"
                                 ).LidarFrontEnd(ctx, **kwargs)
    sent = []
    ctx.create_subscription("/cslam/local_descriptors", sent.append)
    return fe, importlib.import_module(f"{pkg}.types"), pc2, bus, sent


def test_front_end_keyframes_and_exchange_match_reference():
    """PointCloud2 intake, odometry keyframe gating and the compressed
    cloud the descriptor-request service ships: equal in both packages."""
    rng = np.random.default_rng(2)
    scans = [rng.uniform(-30, 30, (2000, 3)).astype(np.float32)
             for _ in range(4)]
    out = {}
    for pkg in ("cslam_tpu", "cslam_tpu_torch"):
        fe, types, pc2, bus, sent = _front_end(pkg)
        for i, pts in enumerate(scans):
            pose = np.eye(4)
            pose[0, 3] = 0.3 * i                 # gate at 0.5 m: 0, 2
            fe.lidar_callback(pc2.make_cloud_xyz32(pts),
                              types.Odometry(pose=pose))
            fe.process_new_sensor_data()
        fe.send_local_descriptors_request(types.LocalDescriptorsRequest(
            keyframe_id=1, matches_robot_id=[1], matches_keyframe_id=[3]))
        bus.deliver()
        out[pkg] = (fe.nb_local_keyframes, fe.local_descriptors_map,
                    [m.points for m in sent])
    (n_ref, maps_ref, sent_ref), (n, maps, sent) = out.values()
    assert n == n_ref == 2
    for k in maps_ref:
        assert np.array_equal(maps[k], maps_ref[k])
    assert len(sent) == len(sent_ref) == 1 and sent[0] == sent_ref[0]

"""The port's mirror of ``tests/test_no_retrace.py``'s verification case:
a warmup must cover every verification chunk that production runs, so
that on the card no live chunk pays a CUDA graph capture.

On the CPU the graphed functions (``registration.VERIFY_GRAPHS``,
``visual_registration.ALIGN_GRAPHS``) run eagerly and ``TierGraphs`` still
records the keys (input shapes and dtypes, device, static keywords) it
would capture on the card; the check is that production sees no key the
warmup did not. A second call with other thresholds sees no new key either
(they are operands of the graph, as they are traced arguments in the JAX
package) and still decides as the JAX package does for those values: the
success flags equal, the visual inlier counts within one (the port's
Kabsch rotation is a float64 closed form, the JAX package's a float32 SVD,
so a residual on the inlier distance can count differently).
"""
import numpy as np
import pytest

from cslam_tpu.native import brief_describe as j_brief
from cslam_tpu.native import fast_detect as j_fast
from cslam_tpu.ops import registration as J
from cslam_tpu.ops import visual_registration as JV
from cslam_tpu_torch.ops import registration as T
from cslam_tpu_torch.ops import visual_registration as TV
from cslam_tpu_torch.runtime import (LidarFrontEnd, MessageBus, RobotContext,
                                     VirtualClock)
from test_visual_frontend import CAM, make_world, pose_xyz_yaw, render
from torch_threads import one_torch_thread  # noqa: F401

PAD = 96


@pytest.fixture(scope="module")
def lidar_pairs():
    """``test_no_retrace``'s case: ``LidarFrontEnd.warmup(pair_tiers=(1,
    2), pad_size=96)``, then 3 near-identical cloud pairs (with the cap at
    2: chunks of 2 and 1, both warmed tiers). Returns (pairs, the keys
    seen after the warmup)."""
    fe = LidarFrontEnd(RobotContext(
        MessageBus(), VirtualClock(), 0,
        {"robot_id": 0, "max_nb_robots": 2, "frontend.voxel_size": 0.5}),
        device="cpu")
    fe.warmup(pair_tiers=(1, 2), pad_size=PAD)
    rng = np.random.default_rng(1)
    cloud = rng.normal(size=(80, 3)).astype(np.float32) * 4
    pairs = [(cloud, cloud + rng.normal(scale=0.01, size=cloud.shape)
              .astype(np.float32)) for _ in range(3)]
    return pairs, set(T.VERIFY_GRAPHS.keys)


def test_registration_batch_no_new_key_after_warmup(lidar_pairs):
    pairs, warmed = lidar_pairs
    res = T.compute_transform_batch(pairs, 0.5, 10, pad_size=PAD,
                                    max_pair_tier=2, device="cpu")
    assert len(res) == 3 and all(ok for _, ok in res)
    assert set(T.VERIFY_GRAPHS.keys) == warmed


@pytest.mark.parametrize("voxel,min_inliers", [(0.5, 10), (0.3, 200)])
def test_registration_thresholds_are_operands(lidar_pairs, voxel,
                                              min_inliers):
    """Another voxel size and gate after the warmup: no new key, and the
    JAX package's decisions (all pass at 10, all fail at 200 > the 80
    points)."""
    pairs, warmed = lidar_pairs
    got = T.compute_transform_batch(pairs, voxel, min_inliers, pad_size=PAD,
                                    max_pair_tier=2, device="cpu")
    want = J.compute_transform_batch(pairs, voxel, min_inliers,
                                     pad_size=PAD, max_pair_tier=2)
    assert [ok for _, ok in got] == [ok for _, ok in want] == [
        min_inliers < 80] * 3
    assert set(T.VERIFY_GRAPHS.keys) == warmed


def _features(img, dep):
    kp, _ = j_fast(img, 25, 300)
    return (JV.project_to_3d(kp, dep, CAM.fx, CAM.fy, CAM.cx, CAM.cy),
            j_brief(img, kp))


@pytest.fixture(scope="module")
def camera_pairs():
    """``warmup_verification((1, 2, 4))``, then three live keyframe pairs
    of one rendered scene (a tier of 4 with one zero slot). Returns (pairs,
    the keys seen after the warmup)."""
    TV.warmup_verification((1, 2, 4), device="cpu")
    pts, tex = make_world(np.random.default_rng(6))
    views = [_features(*render(pts, tex, pose)) for pose in (
        np.eye(4), pose_xyz_yaw(0.3, 0.1, 0, yaw=0.05),
        pose_xyz_yaw(-0.2, 0.3, 0, yaw=-0.1))]
    pairs = [(*views[0], *views[1]), (*views[1], *views[2]),
             (*views[0], *views[2])]
    return pairs, set(TV.ALIGN_GRAPHS.keys)


@pytest.mark.parametrize("inlier_dist,min_inliers", [(0.3, 6), (0.02, 40)])
def test_visual_warmup_covers_live_pairs(camera_pairs, inlier_dist,
                                         min_inliers):
    pairs, warmed = camera_pairs
    got = TV.verify_keyframe_pairs(pairs, min_inliers=min_inliers,
                                   inlier_dist=inlier_dist, device="cpu")
    assert set(TV.ALIGN_GRAPHS.keys) == warmed
    want = JV.verify_keyframe_pairs(pairs, min_inliers=min_inliers,
                                    inlier_dist=inlier_dist)
    assert [g[1] for g in got] == [w[1] for w in want]
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= 1


def test_backend_warmup_covers_a_swarms_solves():
    """The back end's warmup (``backend.warmup_poses``, run when each
    robot's ``DecentralizedPGO`` is built), then a 2 x 20 swarm's solves
    (cold GNC and warm re-solves, the tiers pinned by
    ``backend.pgo_np_floor`` / ``pgo_ne_floor`` as deployments pin them):
    the LM step programs see no key the warmup did not, so on the card no
    solve pays a capture."""
    from cslam_tpu_torch.pgo import solver
    from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    world = SyntheticWorld(nb_places=40, descriptor_dim=32, seed=0)
    trajs = [circle_trajectory(20, radius=10.0 + 0.3 * r, nb_places=40,
                               start_angle=0.05 * r, z=0.2 * r)
             for r in range(2)]
    sim = SwarmSimulator(2, world, trajs, config_overrides={
        "frontend.inter_robot_detection_period_sec": 3.0,
        "frontend.inter_robot_loop_closure_budget": 5,
        "backend.pose_graph_optimization_start_period_ms": 2000,
        "backend.pgo_np_floor": 64, "backend.pgo_ne_floor": 128,
        "backend.warmup_poses": 64, "backend.warmup_edges": 128},
        keyframe_period=0.5, device="cpu")
    warmed = set(solver.DENSE_GRAPHS.keys)
    assert any(key[1][0][1] == (64, 4, 4) for key in warmed)
    sim.run(20.0, dt=0.25)
    assert sum(r.backend.optimization_count for r in sim.robots) >= 2
    assert set(solver.DENSE_GRAPHS.keys) == warmed


def test_backend_warmup_covers_solves_with_a_non_power_of_two_edge_floor():
    """The back end's warmup with ``backend.pgo_ne_floor`` not a power of
    two (48: solves pad their edges to 48, 96, 192, ...), then the same
    2 x 20 swarm: every LM step program key was warmed (no capture
    mid-mission on the card)."""
    from cslam_tpu_torch.pgo import solver
    from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    world = SyntheticWorld(nb_places=40, descriptor_dim=32, seed=0)
    trajs = [circle_trajectory(20, radius=10.0 + 0.3 * r, nb_places=40,
                               start_angle=0.05 * r, z=0.2 * r)
             for r in range(2)]
    sim = SwarmSimulator(2, world, trajs, config_overrides={
        "frontend.inter_robot_detection_period_sec": 3.0,
        "frontend.inter_robot_loop_closure_budget": 5,
        "backend.pose_graph_optimization_start_period_ms": 2000,
        "backend.pgo_np_floor": 64, "backend.pgo_ne_floor": 48,
        "backend.warmup_poses": 64, "backend.warmup_edges": 128},
        keyframe_period=0.5, device="cpu")
    warmed = set(solver.DENSE_GRAPHS.keys)
    sim.run(20.0, dt=0.25)
    assert sum(r.backend.optimization_count for r in sim.robots) >= 2
    assert set(solver.DENSE_GRAPHS.keys) == warmed


@pytest.mark.parametrize("floors,graph,tier", [
    ((1024, 1536), (2048, 3000), (2048, 3072)),
    ((4096, 3000), (4096, 6000), (4096, 6000)),
    ((64, 128), (64, 128), (64, 128)),
    # mid-mission: a pose tier above the floor with fewer edges than poses
    ((1024, 1536), (1100, 1200), (2048, 1536)),
    ((1024, 1024), (1025, 1024), (2048, 1024)),
])
def test_backend_warmup_grid_holds_the_tier_a_solve_pads_to(floors, graph,
                                                            tier):
    """``DecentralizedPGO.warmup_tier_grid`` for a mission of ``graph``
    (poses, edges) under the floors (``pgo_np_floor``, ``pgo_ne_floor``)
    holds the tier the factor graph pads that graph to."""
    from cslam_tpu_torch.pgo.factor_graph import FactorGraph
    from cslam_tpu_torch.runtime.backend_node import DecentralizedPGO
    poses, edges = graph
    fg = FactorGraph()
    for k in range(poses):
        fg.add_variable((0, k), np.eye(4))
    for e in range(edges):
        fg.add_between((0, e % (poses - 1)), (0, e % (poses - 1) + 1),
                       np.eye(4), np.ones(6))
    arrays = fg.to_arrays(np_floor=floors[0], ne_floor=floors[1],
                          device="cpu")
    assert (arrays.num_nodes, arrays.num_edges) == tier
    node = DecentralizedPGO.__new__(DecentralizedPGO)
    node._np_floor, node._ne_floor = floors
    assert tier in node.warmup_tier_grid(poses, edges)


@pytest.mark.parametrize("p_floor", [64, 1024])
def test_selection_warmup_covers_acm_selections(p_floor):
    """``warmup_selection_tiers`` (the config-default kwargs with the
    deployment's floors), then ACM selections of a 3-robot graph on the
    dense tiers (``p_floor`` 64) and on the Woodbury tier (1024): MAC's
    Frank-Wolfe programs see no key the warmup did not, so on the card no
    selection pays a capture."""
    from helpers import all_considered, multi_robot_graph

    from cslam_tpu_torch import types as ttypes
    from cslam_tpu_torch.selection import acm as tacm
    from cslam_tpu_torch.selection import mac as tmac
    params = {"frontend.mac_p_floor": p_floor, "frontend.mac_e_floor": 256,
              "frontend.mac_mf_floor": 64}
    tmac.warmup_selection_tiers(3 * 30, 100, device="cpu",
                                **tmac.mac_kwargs_from_params(params))
    graphs = (tmac.DENSE_FW_GRAPHS, tmac.WOODBURY_FW_GRAPHS)
    warmed = [set(g.keys) for g in graphs]
    fixed, cands = multi_robot_graph(30, 40, 3, seed=2)
    acm = tacm.AlgebraicConnectivityMaximization(0, 3, extra_params=params,
                                                 device="cpu")
    acm.set_graph([ttypes.EdgeInterRobot(*e) for e in fixed],
                  [ttypes.EdgeInterRobot(*e) for e in cands])
    assert len(acm.select_candidates(4, all_considered(3))) > 0
    assert [set(g.keys) for g in graphs] == warmed
    assert warmed[p_floor == 1024]

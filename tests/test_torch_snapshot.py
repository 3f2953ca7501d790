"""Robot snapshot / restore in the port (``cslam_tpu_torch/utils/snapshot.py``),
on the CPU: the snapshot cases of ``tests/test_utils.py`` on the port, and
parity with the JAX package.

The same two-robot simulation (``tests/test_utils.py``'s mid-run case, with
``frontend.async_detection`` off in both packages: the JAX package's async
harvest timing depends on its dispatch threads) runs in each package;
robot 0 is snapshot at the same point, and the two state dicts are
compared field by field. Limits: banks, edge sets, buffers and counters
equal; poses and edge weights within 1e-4. A snapshot holds no
``torch.Tensor``, and a restored bank uploads its rows again at its next
search.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from cslam_tpu_torch.utils.snapshot import restore_robot, snapshot_robot
from torch_threads import one_torch_thread  # noqa: F401

POSE_TOL = 1e-4
CFG = {"frontend.inter_robot_detection_period_sec": 3.0,
       "backend.pose_graph_optimization_start_period_ms": 2000,
       "frontend.async_detection": False}
#: wall-clock timings, not state
TIMING_STATS = {"sparsification_cumulative_computation_time"}


def _sim(pkg, **kw):
    import importlib
    sim_mod = importlib.import_module(f"{pkg}.runtime.simulator")
    world = sim_mod.SyntheticWorld(nb_places=30, descriptor_dim=16, seed=0)
    trajs = [sim_mod.circle_trajectory(16, 10.0, 30),
             sim_mod.circle_trajectory(16, 10.0, 30, start_angle=0.05)]
    return sim_mod.SwarmSimulator(2, world, trajs, config_overrides=CFG,
                                  keyframe_period=0.5, **kw), (world, trajs)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{package: (the simulation, its snapshot path, the state dict)} after
    20 s of the same mission."""
    out = {}
    root = tmp_path_factory.mktemp("snap")
    for pkg, kw in (("cslam_tpu_torch", {"device": "cpu"}),
                    ("cslam_tpu", {})):
        sim, _ = _sim(pkg, **kw)
        sim.run(20.0, dt=0.25)
        r0 = sim.robots[0]
        path = str(root / f"{pkg}_r0.ckpt")
        if pkg == "cslam_tpu":
            from cslam_tpu.utils.snapshot import snapshot_robot as ref_snap
            ref_snap(r0.detection, r0.backend, path)
        else:
            snapshot_robot(r0.detection, r0.backend, path)
        with open(path, "rb") as f:
            out[pkg] = (sim, path, pickle.load(f))
    return out


def _compare(a, b, path="state"):
    """Field-by-field comparison of two snapshot values from different
    packages (their classes differ by module): numbers within
    ``POSE_TOL``, everything else equal. Returns the differences."""
    if dataclasses.is_dataclass(a) or hasattr(a, "_fields"):
        if type(a).__name__ != type(b).__name__:
            return [f"{path}: {type(a).__name__} vs {type(b).__name__}"]
        fields = (a._fields if hasattr(a, "_fields")
                  else [f.name for f in dataclasses.fields(a)])
        return [d for f in fields
                for d in _compare(getattr(a, f), getattr(b, f),
                                  f"{path}.{f}")]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b), key=str)}"]
        return [d for k in a for d in _compare(a[k], b[k], f"{path}[{k!r}]")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} vs {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _compare(x, y, f"{path}[{i}]")]
    if isinstance(a, (np.ndarray, float, np.floating)) and not isinstance(
            a, bool):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape or not np.allclose(a, b, rtol=0,
                                                 atol=POSE_TOL):
            return [f"{path}: {a} vs {b}"]
        return []
    return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


def _edge_keys(edges):
    return sorted((e.robot0_id, e.robot0_keyframe_id, e.robot1_id,
                   e.robot1_keyframe_id) for e in edges)


# -- the cases of tests/test_utils.py::TestSnapshot on the port --------------

class TestSnapshot:

    def test_roundtrip_mid_run(self, snapshots):
        """Snapshot a robot mid-simulation; a freshly constructed robot
        restored from it continues with identical state and keeps working."""
        sim, path, _ = snapshots["cslam_tpu_torch"]
        r0 = sim.robots[0]

        # fresh nodes (a "restarted" robot process)
        sim2, _ = _sim("cslam_tpu_torch", device="cpu")
        d2, b2 = sim2.robots[0].detection, sim2.robots[0].backend
        restore_robot(d2, b2, path)

        # bank contents identical
        assert d2.lcm.local_nnsm.n == r0.detection.lcm.local_nnsm.n
        np.testing.assert_array_equal(
            d2.lcm.local_nnsm.data[:d2.lcm.local_nnsm.n],
            r0.detection.lcm.local_nnsm.data[:r0.detection.lcm.local_nnsm.n])
        # selector bookkeeping identical
        assert (d2.lcm.candidate_selector.candidate_edges
                == r0.detection.lcm.candidate_selector.candidate_edges)
        assert (len(d2.lcm.candidate_selector.fixed_edges)
                == len(r0.detection.lcm.candidate_selector.fixed_edges))
        # back-end graph identical
        assert (set(b2.odometry_pose_estimates)
                == set(r0.backend.odometry_pose_estimates))
        assert len(b2.local_factors) == len(r0.backend.local_factors)
        assert b2.optimization_count == r0.backend.optimization_count

        # the restored robot still functions: search its bank
        probe = r0.detection.lcm.local_nnsm.data[3]
        item, sim_val = d2.lcm.local_nnsm.search_best(probe)
        assert item == 3
        assert sim_val == pytest.approx(1.0, abs=1e-5)

    def test_wrong_robot_snapshot_rejected(self, tmp_path):
        from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                       SyntheticWorld,
                                                       circle_trajectory)
        world = SyntheticWorld(nb_places=10, descriptor_dim=8, seed=0)
        trajs = [circle_trajectory(4, 10.0, 10)] * 2
        sim = SwarmSimulator(2, world, trajs, keyframe_period=0.5,
                             device="cpu")
        sim.run(3.0, dt=0.5)
        path = str(tmp_path / "r0.ckpt")
        snapshot_robot(sim.robots[0].detection, sim.robots[0].backend, path)
        with pytest.raises(AssertionError):
            restore_robot(sim.robots[1].detection, sim.robots[1].backend,
                          path)


# -- no device state ----------------------------------------------------------

def test_snapshot_holds_no_tensor(snapshots):
    from test_torch_transport import _tensors_in
    _, _, state = snapshots["cslam_tpu_torch"]
    assert _tensors_in(state) == 0
    assert state["local_bank"]["data"].dtype == np.float32


def test_snapshot_refuses_device_state(snapshots, tmp_path):
    """A tensor left in a snapshotted field is refused, not pickled."""
    sim, _, _ = snapshots["cslam_tpu_torch"]
    r0 = sim.robots[0]
    kept = r0.backend.current_pose_estimates
    r0.backend.current_pose_estimates = {**kept, (0, 999): torch.eye(4)}
    try:
        with pytest.raises(TypeError, match="torch.Tensor"):
            snapshot_robot(r0.detection, r0.backend,
                           str(tmp_path / "bad.ckpt"))
    finally:
        r0.backend.current_pose_estimates = kept
    assert not (tmp_path / "bad.ckpt").exists()


def test_restored_bank_uploads_at_next_search(snapshots):
    """A restored bank has no device copy; its next search uploads every
    row (the port's banks mirror the host lazily)."""
    _, path, state = snapshots["cslam_tpu_torch"]
    sim2, _ = _sim("cslam_tpu_torch", device="cpu")
    d2, b2 = sim2.robots[0].detection, sim2.robots[0].backend
    restore_robot(d2, b2, path)
    bank = d2.lcm.local_nnsm
    assert bank._bank is None and bank._device_n == 0
    bank.search_best(state["local_bank"]["data"][0])
    assert bank._device_n == bank.n == state["local_bank"]["n"] > 0


# -- parity with the JAX package ----------------------------------------------

def test_state_keys_match_reference(snapshots):
    ours = snapshots["cslam_tpu_torch"][2]
    ref = snapshots["cslam_tpu"][2]
    assert set(ours) == set(ref)


def test_banks_match_reference(snapshots):
    ours = snapshots["cslam_tpu_torch"][2]
    ref = snapshots["cslam_tpu"][2]
    for a, b in [(ours["local_bank"], ref["local_bank"])] + [
            (ours["other_banks"][r], ref["other_banks"][r])
            for r in ref["other_banks"]]:
        assert (a["kind"], a["n"], a["dim"]) == (b["kind"], b["n"], b["dim"])
        assert a["data"].tobytes() == b["data"].tobytes()
        assert a["items"] == b["items"]
    assert set(ours["other_banks"]) == set(ref["other_banks"])
    assert ours["local_bank"]["n"] > 0


def test_edge_sets_match_reference(snapshots):
    ours = snapshots["cslam_tpu_torch"][2]
    ref = snapshots["cslam_tpu"][2]
    assert _edge_keys(ours["fixed_edges"]) == _edge_keys(ref["fixed_edges"])
    assert len(ours["fixed_edges"]) >= 1
    assert set(ours["candidate_edges"]) == set(ref["candidate_edges"])
    assert ours["already_considered"] == ref["already_considered"]
    assert _compare(ours["candidate_edges"], ref["candidate_edges"]) == []
    assert _compare(ours["match_buffer"], ref["match_buffer"]) == []


def test_bookkeeping_matches_reference(snapshots):
    ours = snapshots["cslam_tpu_torch"][2]
    ref = snapshots["cslam_tpu"][2]
    for key in ("nb_poses", "initial_fixed_edge_exists", "gd_buffer",
                "nb_inter_robot_matches", "monitor_windows",
                "connected_robots", "latest_local_key", "origin_robot_id",
                "optimization_count", "robot_id"):
        assert _compare(ours[key], ref[key], key) == []
    stats = {k: v for k, v in ours["stats"].items() if k not in TIMING_STATS}
    assert _compare(stats, {k: ref["stats"][k] for k in stats}) == []
    assert ours["optimization_count"] >= 1


def test_back_end_poses_match_reference(snapshots):
    ours = snapshots["cslam_tpu_torch"][2]
    ref = snapshots["cslam_tpu"][2]
    for key in ("odometry_pose_estimates", "last_optimized_values",
                "last_edge_weights", "current_pose_estimates",
                "local_factors", "inter_robot_loop_closures",
                "latest_local_pose", "origin_to_first_pose"):
        assert _compare(ours[key], ref[key], key) == []
    assert len(ours["last_optimized_values"]) > 0

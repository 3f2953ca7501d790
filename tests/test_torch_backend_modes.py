"""``backend.pgo_mode: distributed`` in the port, on the CPU: the mode is not
ported yet (ROADMAP.md item 14), so the elected optimizer takes the
centralized GNC solve, as the JAX package does when it has fewer devices
than robots (``tests/test_runtime.py::test_falls_back_below_device_count``,
mirrored here in both packages with one device).

Limits: the port's poses equal its own centralized solve exactly, and
match the JAX package's fallback within ``POSE_ATOL`` of
``tests/test_torch_pgo.py``.
"""
import jax
import numpy as np
import pytest

import test_runtime
from test_torch_pgo import POSE_ATOL


def _solve(pkg, graph_of, mode):
    bus_mod = pytest.importorskip(f"{pkg}.runtime.bus")
    clock_mod = pytest.importorskip(f"{pkg}.runtime.clock")
    backend = pytest.importorskip(f"{pkg}.runtime.backend_node")
    port = pkg == "cslam_tpu_torch"
    params = {"robot_id": 0, "max_nb_robots": 3, "backend.pgo_mode": mode}
    be = backend.DecentralizedPGO(
        bus_mod.RobotContext(bus_mod.MessageBus(), clock_mod.VirtualClock(),
                             0, params),
        **({"device": "cpu"} if port else {}))
    graph = graph_of(pkg)
    _, poses = be._optimize(graph)
    return np.asarray(poses, np.float64)[:len(graph)]


def _graph_of(pkg):
    """The JAX test's 3-robot x 6-pose aggregate graph, built in ``pkg``."""
    from cslam_tpu_torch import pgo as tpgo

    import cslam_tpu.pgo as jpgo
    g, _ = test_runtime.TestDistributedBackendMode._aggregate_graph(
        np.random.default_rng(6), nb_robots=3, nb_poses=6)
    if pkg == "cslam_tpu":
        return g
    out = tpgo.FactorGraph()
    assert isinstance(g, jpgo.FactorGraph)
    for key in g.keys():
        out.add_variable(key, g.get_pose(key))
    inv = {v: k for k, v in g._index.items()}
    for (i, j, z, s, robust) in g._edges:
        out.add_between(inv[i], inv[j], z, s, robust=robust)
    for (i, z, s) in g._priors:
        out.add_prior(inv[i], z, s)
    return out


def test_distributed_mode_falls_back_to_centralized(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])
    want = _solve("cslam_tpu", _graph_of, "distributed")
    got = _solve("cslam_tpu_torch", _graph_of, "distributed")
    central = _solve("cslam_tpu_torch", _graph_of, "centralized")
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, central)
    np.testing.assert_allclose(got, want, atol=POSE_ATOL)

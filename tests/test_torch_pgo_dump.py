"""The back end's PGO dump hook (``CSLAM_TPU_DUMP_PGO``) in the port against
the JAX package's, and ``tools/pgo_replay`` on a file the JAX package wrote.

The same seeded graph (2 robots x 12 poses, robust inter-robot loops, two
gross outliers) is solved by a back end of each package, each writing into
its own directory: the files must have the same names, keys, dtypes (int32
indices, float32 values) and arrays, exactly. Replayed through the port's
tool, a JAX file gives the JAX solver's rejections and outer iterations
exactly and its poses within ``tests/test_torch_pgo.py``'s 2e-3. (GNC's
outer count is a decision of the stop test, so a graph can sit on its
edge: with ``_graph_spec(seed=5)`` one inlier's chi2 lies on the TLS
band's lower edge after the third outer iteration, the port's weight there
is 1.0 and JAX's 0.91, and the port stops one iteration earlier, 3 against
4, with the same rejections and poses within 2.1e-5.)
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cslam_tpu.pgo import FactorGraph as JFactorGraph
from cslam_tpu.pgo import solver as jsolver
from cslam_tpu.pgo.factor_graph import PoseGraphArrays as JArrays
from cslam_tpu.runtime.backend_node import DecentralizedPGO as JBackend
from cslam_tpu.runtime.bus import MessageBus as JBus
from cslam_tpu.runtime.bus import RobotContext as JContext
from cslam_tpu.runtime.clock import VirtualClock as JClock
from cslam_tpu_torch.pgo import FactorGraph as TFactorGraph
from cslam_tpu_torch.runtime import (DecentralizedPGO, MessageBus,
                                     RobotContext, VirtualClock)
from cslam_tpu_torch.tools import pgo_replay
from torch_threads import one_torch_thread  # noqa: F401

SIGMAS = np.array([0.01] * 3 + [0.1] * 3)
POSE_ATOL = 2e-3
PARAMS = {"robot_id": 0, "max_nb_robots": 2}


def _graph_spec(seed=0, robots=2, poses=12):
    """(variables, between factors, prior) of a seeded two-robot loop."""
    rng = np.random.default_rng(seed)
    gt = {}
    for r in range(robots):
        for k in range(poses):
            a = 2 * np.pi * k / poses
            T = np.eye(4)
            T[:3, :3] = [[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]]
            T[:3, 3] = [(6 + r) * np.cos(a), (6 + r) * np.sin(a), 0.2 * r]
            gt[(r, k)] = T

    def noisy(z):
        z = z.copy()
        z[:3, 3] += rng.normal(scale=0.05, size=3)
        return z

    variables, factors = [], []
    for r in range(robots):
        cur = gt[(r, 0)]
        variables.append(((r, 0), cur))
        for k in range(poses - 1):
            z = noisy(np.linalg.inv(gt[(r, k)]) @ gt[(r, k + 1)])
            cur = cur @ z
            variables.append(((r, k + 1), cur))
            factors.append(((r, k), (r, k + 1), z, False))
    for k in range(0, poses, 3):
        z = noisy(np.linalg.inv(gt[(0, k)]) @ gt[(1, k)])
        factors.append(((0, k), (1, k), z, True))
    for a, b in (((0, 2), (1, 8)), ((0, 7), (1, 1))):
        bad = np.eye(4)
        bad[:3, 3] = rng.uniform(-8, 8, 3)
        factors.append((a, b, bad, True))
    return variables, factors, ((0, 0), gt[(0, 0)])


def _build(cls, spec):
    variables, factors, (pk, pp) = spec
    g = cls()
    for key, pose in variables:
        g.add_variable(key, pose)
    for a, b, z, robust in factors:
        g.add_between(a, b, z, SIGMAS, robust=robust)
    g.add_prior(pk, pp, SIGMAS)
    return g


def _jax_backend():
    return JBackend(JContext(JBus(), JClock(), 0, dict(PARAMS)),
                    synchronous_optimization=True)


def _port_backend(**params):
    return DecentralizedPGO(RobotContext(MessageBus(), VirtualClock(), 0,
                                         {**PARAMS, **params}),
                            synchronous_optimization=True, device="cpu")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Each package's back end solves the graph twice with the variable
    pointed at its own directory."""
    spec = _graph_spec()
    dirs = {}
    saved = os.environ.get("CSLAM_TPU_DUMP_PGO")
    try:
        for name, backend, cls in (("jax", _jax_backend(), JFactorGraph),
                                   ("port", _port_backend(), TFactorGraph)):
            dirs[name] = tmp_path_factory.mktemp(name)
            os.environ["CSLAM_TPU_DUMP_PGO"] = str(dirs[name])
            for _ in range(2):
                backend._optimize(_build(cls, spec))
    finally:
        if saved is None:
            os.environ.pop("CSLAM_TPU_DUMP_PGO", None)
        else:
            os.environ["CSLAM_TPU_DUMP_PGO"] = saved
    return dirs


def test_dumps_equal_the_jax_packages(dumps):
    names = sorted(os.listdir(dumps["jax"]))
    assert names == ["pgo_r0_000.npz", "pgo_r0_001.npz"]
    assert sorted(os.listdir(dumps["port"])) == names
    for name in names:
        with np.load(dumps["jax"] / name, allow_pickle=False) as j, \
                np.load(dumps["port"] / name, allow_pickle=False) as t:
            assert sorted(t.files) == sorted(j.files) == sorted(
                pgo_replay.FIELDS)
            for key in j.files:
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
            for key in ("edge_i", "edge_j", "prior_idx"):
                assert t[key].dtype == np.int32


def test_no_dump_when_unset_or_distributed(tmp_path, monkeypatch):
    spec = _graph_spec()
    monkeypatch.delenv("CSLAM_TPU_DUMP_PGO", raising=False)
    monkeypatch.chdir(tmp_path)
    _port_backend()._optimize(_build(TFactorGraph, spec))
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("CSLAM_TPU_DUMP_PGO", str(tmp_path / "d"))
    graph, poses = _port_backend(**{"backend.pgo_mode": "distributed"}
                                 )._optimize(_build(TFactorGraph, spec))
    assert np.isfinite(poses[:len(spec[0])]).all()
    assert not (tmp_path / "d").exists()


def test_replay_of_a_jax_dump_matches_the_jax_solver(dumps):
    path = dumps["jax"] / "pgo_r0_000.npz"
    with np.load(path, allow_pickle=False) as z:
        ja = JArrays(**{f.name: jnp.asarray(z[f.name])
                        for f in dataclasses.fields(JArrays)})
    with jax.default_matmul_precision("highest"):
        jr = jsolver.gnc_optimize(ja, max_outer=100, lm_iters=50,
                                  cg_iters=150)
    a = pgo_replay.load(path, "cpu")
    row, res = pgo_replay.replay(a, warm=0)
    rb = (np.asarray(ja.robust) * np.asarray(ja.edge_valid)) > 0
    jw = np.asarray(jr.weights)
    assert row["rejected"] == int(((jw < 0.5) & rb).sum()) == 2
    assert pgo_replay.rejected_edges(a, res) == np.nonzero(
        (jw < 0.5) & rb)[0].tolist()
    assert row["gnc_outer"] == int(jr.outer_iterations)
    n = int(np.asarray(ja.node_valid).sum())
    np.testing.assert_allclose(res.poses.numpy()[:n],
                               np.asarray(jr.poses)[:n], atol=POSE_ATOL)
    info = pgo_replay.graph_row(a)
    assert (info["nodes"], info["edges"]) == (
        n, int(np.asarray(ja.edge_valid).sum()))
    assert info["robust_edges"] == int(rb.sum())

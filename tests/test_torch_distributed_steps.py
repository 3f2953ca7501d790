"""The distributed solve as step programs (``pgo/distributed.py``:
``DIST_GRAPHS`` run as one plan by ``_solve_steps``) and the batched PCG
tier (``_batched_pcg_lm``), on the CPU, where the plan's programs run
eagerly and the host reads each loop flag.

- The step-program route against the host-driven sweeps (``_solve_host``,
  its plain version): bit for bit (the same ops in the same order) on
  ``tests/test_torch_distributed_pgo.py``'s 3 x 16 problem, cold and
  warm-carried, and on the PCG tier (``solver._DENSE_SOLVE_MAX_NODES``
  lowered to 16, so 32 local poses take it).
- The batched PCG LM against ``solver.lm_optimize`` on each robot alone:
  the same LM and CG iterations at GNC's ``rel_tol`` 1e-5 with robots
  stopping apart, poses within ``POSE_ATOL``; and the distributed solve on
  the PCG tier against the route that runs each robot's ``lm_optimize`` in
  turn: the same sweeps and separator sides, poses within ``POSE_ATOL``.
- ``StepGraphs.run_plan``'s eager loops, a solve's key, and a dropped
  ``StepGraphs`` freeing its loops by reference count.
- ``tools/distributed_pgo_bench.build`` against the JAX script's
  (``benchmarks/distributed_pgo_bench.py``, loaded by its path): the same
  edges and separators, poses and measurements within 1e-5 (each
  composes its measurements in float32 through its own se3).
"""
import dataclasses
import gc
import importlib.util
import os
import pathlib
import weakref

import numpy as np
import pytest
import torch

from test_torch_distributed_pgo import R, _problem, _set_poses, _to_port
from test_torch_pgo import POSE_ATOL
from torch_threads import one_torch_thread  # noqa: F401

from cslam_tpu_torch.pgo import distributed as td, solver
from cslam_tpu_torch.pgo.factor_graph import PoseGraphArrays
from cslam_tpu_torch.tools import distributed_pgo_bench as tbench
from cslam_tpu_torch.utils.robot_mesh import StackedMesh
from cslam_tpu_torch.utils import tier_graphs
from cslam_tpu_torch.utils.tier_graphs import StepGraphs

REPO = pathlib.Path(__file__).resolve().parent.parent
SIGMAS = np.array([0.05] * 3 + [0.01] * 3)


def _routes(problem, mesh, routes=("steps", "host"), **kwargs):
    return [td.distributed_optimize(problem, mesh, return_info=True,
                                    _route=r, **kwargs) for r in routes]


def _assert_same(a, b):
    (ea, ia), (eb, ib) = a, b
    assert ia.sweeps_used == ib.sweeps_used
    assert ia.lm_iterations == ib.lm_iterations
    np.testing.assert_array_equal(ia.sep_weights, ib.sep_weights)
    assert ia.final_delta == ib.final_delta
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=str(k))


def test_steps_route_bit_for_bit_with_host_cold_and_warm():
    """Cold, then warm from drifted cold poses with the cold round's
    carried weights: every output of the two routes equal."""
    _, problem = _problem()
    port = _to_port(problem)
    mesh = StackedMesh(R, "cpu")
    steps, host = _routes(port, mesh, sweeps=30)
    _assert_same(steps, host)
    assert steps[1].sweeps_used >= 3
    _set_poses(port, steps[0], np.random.default_rng(77))
    carried = steps[1].sep_weight_by_key
    _assert_same(*_routes(port, mesh, sweeps=30, warm=True,
                          carried_weights=carried))
    # warm without a carried classification: mu0 given (1e6)
    _assert_same(*_routes(port, mesh, sweeps=30, warm=True))


def test_steps_route_bit_for_bit_on_pcg_tier(monkeypatch):
    monkeypatch.setattr(solver, "_DENSE_SOLVE_MAX_NODES", 16)
    _, problem, _, _ = tbench.build(3, 32, np.random.default_rng(0), 8)
    steps, host = _routes(problem, StackedMesh(3, "cpu"), sweeps=30,
                          lm_iters=8, cg_iters=60)
    _assert_same(steps, host)


def test_pcg_tier_matches_robots_in_turn(monkeypatch):
    """The batched PCG tier against each robot's ``lm_optimize`` in turn
    (the sweeps' plain version): the same sweeps, separators on the same
    side of 0.5, both outliers out, poses within ``POSE_ATOL``."""
    monkeypatch.setattr(solver, "_DENSE_SOLVE_MAX_NODES", 16)
    _, problem, _, n_sep = tbench.build(3, 32, np.random.default_rng(0), 8)
    (es, is_), (et, it) = _routes(problem, StackedMesh(3, "cpu"),
                                  ("steps", "in_turn"), sweeps=30,
                                  lm_iters=8, cg_iters=60)
    assert is_.sweeps_used == it.sweeps_used
    np.testing.assert_array_equal(is_.sep_weights > 0.5,
                                  it.sep_weights > 0.5)
    assert np.all(is_.sep_weights[n_sep:n_sep + 2] < 0.01)
    assert max(np.abs(es[k] - et[k]).max() for k in es) <= POSE_ATOL


def _stagger(robots=3, n=40, seed=3):
    """Robots whose local LM solves stop at different iterations (more
    init noise on later robots, an intra loop closure every 7 poses)."""
    rng = np.random.default_rng(seed)
    p = td.ShardedPoseGraph(robots)
    for r in range(robots):
        cur = np.eye(4)
        p.add_variable(r, 0, cur)
        for k in range(n - 1):
            z = np.eye(4)
            z[0, 3] = 1.0
            z[:3, 3] += rng.normal(scale=0.02 * (r + 1), size=3)
            init = cur @ z
            init[:3, 3] += rng.normal(scale=0.05 * (r + 1), size=3)
            p.add_variable(r, k + 1, init)
            p.add_local_between(r, k, k + 1, z, SIGMAS)
            cur = init
        for k in range(0, n - 9, 7):
            z = np.eye(4)
            z[0, 3] = 8.0
            p.add_local_between(r, k, k + 8, z, SIGMAS, robust=True)
    return p


def test_batched_pcg_lm_matches_per_robot_lm(monkeypatch):
    monkeypatch.setattr(solver, "_DENSE_SOLVE_MAX_NODES", 16)
    local, _ = _stagger().to_device_arrays(StackedMesh(3, "cpu"))
    assert local.poses.shape[1] == 64          # 2 coarse segments each
    w = torch.ones(local.edge_i.shape, dtype=torch.float32)
    w[1, 16] = 0.25                            # a down-weighted closure
    poses, iters, cg = td._batched_pcg_lm(local, w, max_iters=30,
                                          cg_iters=150, rel_tol=1e-5)
    want = []
    for r in range(3):
        g = PoseGraphArrays(**{f.name: getattr(local, f.name)[r]
                               for f in dataclasses.fields(local)})
        res = solver.lm_optimize(g, w[r], max_iters=30, cg_iters=150,
                                 rel_tol=1e-5)
        want.append((res.iterations, res.cg_iterations))
        np.testing.assert_allclose(poses[r].numpy(), res.poses.numpy(),
                                   atol=POSE_ATOL, err_msg=f"robot {r}")
    assert list(zip(iters.tolist(), cg.tolist())) == want
    assert len({it for it, _ in want}) > 1, want       # they stop apart


def test_run_plan_eager_nested_loops():
    def init(s, o):
        zero = torch.zeros((), dtype=torch.int64)
        return {"i": zero, "total": zero, "outer": o["n"] > 0}

    def start(s, o):
        return {"j": torch.zeros_like(s["i"]), "inner": s["i"] >= 0}

    def step(s, o):
        j = s["j"] + 1
        return {"j": j, "total": s["total"] + s["i"] * j,
                "inner": j <= s["i"]}

    def end(s, o):
        i = s["i"] + 1
        return {"i": i, "outer": i < o["n"]}

    graphs = StepGraphs("plan_cpu", {"init": init, "start": start,
                                     "step": step, "end": end})
    plan = ("init", ("outer", ("start", ("inner", ("step",)), "end")))
    for n in (0, 1, 5):
        with graphs.solve("cpu", {"n": torch.tensor(n)}) as loop:
            loop.run_plan(plan)
            i, total = loop.take("i", "total")
        assert (int(i), int(total)) == (n, sum(
            a * b for a in range(n) for b in range(1, a + 2)))
    assert graphs.keys_seen == 1


def test_dropped_step_graphs_frees_its_loops_without_the_collector():
    """A ``StepGraphs`` and its ``_GraphLoop``s form no reference cycle:
    when a set is dropped, its captured graphs (here a stand-in) go at
    once, with the garbage collector off, never later inside another
    capture."""
    graphs = StepGraphs("drop_cpu", {"init": lambda s, o: {}})
    key = ("cpu", (), ())
    loop = graphs._loops[key] = tier_graphs._GraphLoop(
        graphs, key, torch.device("cpu"), {"n": torch.tensor(1)}, {})
    captured = loop._captured["init"] = torch.zeros(1)
    assert loop.graphs.name == "drop_cpu"
    gone = weakref.ref(captured)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del graphs, loop, captured
        assert gone() is None
    finally:
        if enabled:
            gc.enable()


def test_solve_key_is_the_problems_shapes():
    """Caps, tolerances, mu0 and the warm flag are operands: solves of
    one problem's shapes (cold, warm, warm carried, other keywords) share
    one key."""
    _, problem = _problem()
    port = _to_port(problem)
    mesh = StackedMesh(R, "cpu")
    seen = td.DIST_GRAPHS.keys_seen
    est, info = td.distributed_optimize(port, mesh, sweeps=2, lm_iters=3,
                                        return_info=True)
    _set_poses(port, est)
    td.distributed_optimize(port, mesh, sweeps=3, lm_iters=2, warm=True,
                            carried_weights=info.sep_weight_by_key)
    td.distributed_optimize(port, mesh, sweeps=1, lm_iters=2, mu0=0.5,
                            tol=1e-2)
    assert td.DIST_GRAPHS.keys_seen - seen <= 1


@pytest.fixture(scope="module")
def jbench():
    """The JAX script, loaded by its path; it sets ``XLA_FLAGS`` and
    ``JAX_PLATFORMS`` when imported, which are put back."""
    saved = {k: os.environ.get(k) for k in ("XLA_FLAGS", "JAX_PLATFORMS")}
    spec = importlib.util.spec_from_file_location(
        "jax_distributed_pgo_bench",
        REPO / "benchmarks" / "distributed_pgo_bench.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return module


def test_bench_world_matches_the_jax_script(jbench):
    jgt, jp, jc, jn = jbench.build(3, 32, np.random.default_rng(0), 8)
    tgt, tp, tc, tn = tbench.build(3, 32, np.random.default_rng(0), 8)
    assert tn == jn
    assert jgt.keys() == tgt.keys()
    assert all(np.array_equal(jgt[k], tgt[k]) for k in jgt)
    for jg, tg in zip(jp.local_graphs, tp.local_graphs):
        assert jg.keys() == tg.keys()
        for k in jg.keys():
            np.testing.assert_allclose(tg.get_pose(k), jg.get_pose(k),
                                       atol=1e-5)
        assert len(jg._edges) == len(tg._edges)
        for (ji, jj, jz, js, jr), (ti, tj, tz, ts, tr) in zip(jg._edges,
                                                              tg._edges):
            assert (ti, tj, tr) == (ji, jj, jr)
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_allclose(tz, jz, atol=1e-5)
    assert len(jp.separators) == len(tp.separators)
    for je, te in zip(jp.separators, tp.separators):
        assert te.key_from.as_tuple() == je.key_from.as_tuple()
        assert te.key_to.as_tuple() == je.key_to.as_tuple()
        np.testing.assert_allclose(te.measurement, je.measurement,
                                   atol=1e-5)
        np.testing.assert_array_equal(te.noise_sigmas, je.noise_sigmas)
    assert jc.keys() == tc.keys()
    assert len(jc._edges) == len(tc._edges)
    assert [e[4] for e in jc._edges] == [e[4] for e in tc._edges]

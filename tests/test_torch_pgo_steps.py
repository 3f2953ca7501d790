"""The port's LM and PCG loops as step programs (``pgo/solver.py``,
``pgo/distributed.py::_batched_lm``, ``utils/tier_graphs.StepGraphs``),
on the CPU, where the programs run eagerly with the masking and blocking
that the CUDA graphs replay on the card.

- Block invariance: the CG block size (``solver._CG_BLOCK``) and the LM
  steps per replay (``solver._LM_STEPS``) at 1, 3 and 16 give poses bit
  for bit equal and the same LM and CG iteration counts (on the CPU every
  op is deterministic with one torch thread), on a dense-tier graph, on a
  graph padded past 512 nodes (the PCG tier) and in ``_batched_lm``.
- A program run after the stop (one more dense step, CG block or tail)
  leaves every state tensor bit for bit as it was.
- LM iterations equal the JAX package's exactly, at GNC's ``lm_iters`` 30
  and ``rel_tol`` 1e-5. (At the default ``rel_tol`` 1e-7 the stop test
  ``|dcost| < 1e-7 cost`` lies below float32's resolution of the cost,
  eps = 1.2e-7, so both packages stop where rounding says and their counts
  differ, 16 against 18 on the dense graph; that is not pinned here.)
- Caps, tolerances and weights are operands, not keys: solves with other
  values add no key.
- ``ops.cholesky_solve`` and ``chordal_initialize`` return all NaN on a
  matrix that is not positive definite, with no host read.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _two_by_288
from test_torch_distributed_pgo import R, _stagger_problem
from test_torch_pgo import _to_port, _two_robot_graph

from cslam_tpu.pgo import solver as jsolver
from cslam_tpu.pgo.factor_graph import PoseGraphArrays as JPoseGraphArrays
from cslam_tpu_torch.ops import cholesky_solve
from cslam_tpu_torch.pgo import distributed as td
from cslam_tpu_torch.pgo import solver as tsolver
from cslam_tpu_torch.pgo.chordal import chordal_initialize
from cslam_tpu_torch.utils.robot_mesh import StackedMesh
from torch_threads import one_torch_thread  # noqa: F401

GNC_SOLVE = {"max_iters": 30, "rel_tol": 1e-5}   # gnc_optimize's first solve
BLOCKS = (1, 3, 16)


def _to_jax(ta):
    """Port arrays as the JAX package's (int32 indices)."""
    return JPoseGraphArrays(**{
        n: jnp.asarray(t.numpy().astype(np.int32) if t.dtype == torch.int64
                       else t.numpy())
        for n, t in ((n, getattr(ta, n)) for n in tsolver._GRAPH_FIELDS)})


@pytest.fixture(scope="module")
def graphs():
    """The dense two-robot graph (64 nodes) and ``tests/test_pgo.py``'s
    2 x 288 construction (576 poses, a 1024-node tier: the PCG tier, as
    ``chip_smoke.py`` builds it with the port's float64 se3, in a third of
    a second), with the JAX package's LM iterations at ``GNC_SOLVE``."""
    out = {}
    for name, ta in (("dense", _to_port(_two_robot_graph().to_arrays())),
                     ("pcg", _two_by_288("cpu"))):
        jr = jsolver.lm_optimize(_to_jax(ta), jnp.ones(ta.num_edges),
                                 **GNC_SOLVE)
        out[name] = (ta, int(jr.iterations))
    assert out["dense"][0].num_nodes <= tsolver._DENSE_SOLVE_MAX_NODES
    assert out["pcg"][0].num_nodes > tsolver._DENSE_SOLVE_MAX_NODES
    return out


@pytest.fixture(scope="module")
def solves(graphs):
    """``lm_optimize`` at ``GNC_SOLVE`` on both graphs for each block
    size."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for block in BLOCKS:
            mp.setattr(tsolver, "_CG_BLOCK", block)
            mp.setattr(tsolver, "_LM_STEPS", block)
            for name, (ta, _) in graphs.items():
                out[name, block] = tsolver.lm_optimize(
                    ta, torch.ones(ta.num_edges), **GNC_SOLVE)
    return out


@pytest.mark.parametrize("name", ["dense", "pcg"])
@pytest.mark.parametrize("block", BLOCKS[1:])
def test_block_size_changes_no_bit(solves, name, block):
    base, got = solves[name, BLOCKS[0]], solves[name, block]
    assert torch.equal(got.poses, base.poses)
    assert torch.equal(got.final_cost, base.final_cost)
    assert (got.iterations, got.cg_iterations) == (base.iterations,
                                                   base.cg_iterations)
    if name == "pcg":
        assert base.cg_iterations > base.iterations
    else:
        assert base.cg_iterations == 0


@pytest.mark.parametrize("name", ["dense", "pcg"])
def test_lm_iterations_equal_the_jax_package(graphs, solves, name):
    assert solves[name, 16].iterations == graphs[name][1]


def _batched_problem():
    local, _ = _stagger_problem().to_device_arrays(StackedMesh(R, "cpu"))
    w = torch.ones(local.edge_i.shape, dtype=torch.float32)
    w[1, 16] = 0.25
    return local, w


def test_batched_lm_block_size_changes_no_bit(monkeypatch):
    """``tests/test_torch_distributed_pgo.py``'s staggered robots (they
    stop at different iterations)."""
    local, w = _batched_problem()
    runs = []
    for block in BLOCKS:
        monkeypatch.setattr(tsolver, "_LM_STEPS", block)
        runs.append(td._batched_lm(local, w, max_iters=30))
    assert len(set(runs[0][1].tolist())) > 1
    for poses, iters in runs[1:]:
        assert torch.equal(poses, runs[0][0])
        assert torch.equal(iters, runs[0][1])


def _state(loop):
    return {k: v.clone() for k, v in loop.state.items()}


def _assert_same(before, after):
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k


def _operands(g, weights, max_iters=30):
    return tsolver._lm_operands(g, weights, max_iters, 150, 1e-4, 1e-6, 1e-5)


def test_dense_step_after_the_stop_changes_nothing(graphs):
    ta = graphs["dense"][0]
    with tsolver.DENSE_GRAPHS.solve(
            "cpu", _operands(ta, torch.ones(ta.num_edges)),
            steps=1) as loop:
        status = tsolver._run_steps(loop)
        assert status[0] == 1 and 0 < status[1] < 30
        before = _state(loop)
        loop.run("step")
        _assert_same(before, _state(loop))


def test_cg_block_and_tail_after_the_stop_change_nothing():
    """The padded two-robot graph (PCG tier, a short solve): after the
    stop, ``_run_pcg`` has queued one more head and CG block; a further CG
    block and a tail change no state tensor."""
    ta = _to_port(_two_robot_graph().to_arrays(np_floor=1024))
    with tsolver.PCG_GRAPHS.solve(
            "cpu", _operands(ta, torch.ones(ta.num_edges), max_iters=3),
            coarse=True, steps=tsolver._CG_BLOCK) as loop:
        status = tsolver._run_pcg(loop)
        assert status[0] == 1 and status[1] == 3 and status[2] > 0
        before = _state(loop)
        for name in ("cg", "tail"):
            loop.run(name)
            _assert_same(before, _state(loop))


def test_batched_step_after_the_stop_changes_nothing():
    local, w = _batched_problem()
    gf = td._flatten(local)
    tols, caps = tsolver._scalar_operands("cpu", torch.float32,
                                          [1e-4, 1e-7], [30])
    ops = {n: getattr(gf, n) for n in tsolver._GRAPH_FIELDS}
    ops.update(weights=w.reshape(-1), tols=tols, caps=caps)
    with td.BATCHED_GRAPHS.solve("cpu", ops, robots=R, steps=1) as loop:
        tsolver._run_steps(loop)
        before = _state(loop)
        loop.run("step")
        _assert_same(before, _state(loop))


@pytest.mark.parametrize("name", ["dense", "pcg"])
def test_caps_tolerances_and_weights_are_operands(graphs, name):
    """After one solve of a tier, solves with other caps, tolerances and
    weights add no key."""
    ta = graphs[name][0]
    graphs_of = tsolver.DENSE_GRAPHS if name == "dense" else \
        tsolver.PCG_GRAPHS
    w = torch.ones(ta.num_edges)
    tsolver.lm_optimize(ta, w, max_iters=1)
    seen = set(graphs_of.keys)
    w2 = w.clone()
    w2[-1] = 0.5
    for kw in ({"max_iters": 2, "cg_iters": 20}, {"rel_tol": 1e-3},
               {"cg_tol": 1e-3, "init_lambda": 1e-2, "max_iters": 2}):
        res = tsolver.lm_optimize(ta, w2, **kw)
        assert res.iterations <= kw.get("max_iters", 50)
    assert set(graphs_of.keys) == seen


class _NoHostRead:
    """Raises on a Python-level read of a tensor's value while entered."""

    NAMES = ("__bool__", "__int__", "__float__", "item", "tolist")

    def __enter__(self):
        self._saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*args, **kwargs):
            raise AssertionError("host read")
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self._saved.items():
            setattr(torch.Tensor, n, f)


def test_cholesky_solve_not_positive_definite_is_nan_without_a_read():
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]])      # eigenvalues 3, -1
    b = torch.ones(2, 3)
    with _NoHostRead():
        bad = cholesky_solve(A, b)
        good = cholesky_solve(A @ A.T + torch.eye(2), b)
    assert bad.shape == b.shape and torch.isnan(bad).all()
    torch.testing.assert_close((A @ A.T + torch.eye(2)) @ good, b)


def test_chordal_not_positive_definite_is_nan():
    """Negative edge weights make the chordal normal matrix indefinite:
    all poses NaN (the caller's cost comparison rejects them), chosen
    without a read before the SVD."""
    ta = _to_port(_two_robot_graph().to_arrays())
    with _NoHostRead():
        out = chordal_initialize(ta, -torch.ones(ta.num_edges))
    assert out.shape == ta.poses.shape and torch.isnan(out).all()
    ok = chordal_initialize(ta, torch.ones(ta.num_edges))
    assert torch.isfinite(ok).all()


def test_gnc_reports_lm_iterations_of_its_solves(graphs):
    """``gnc_optimize`` on the dense graph: the LM results it is built
    from carry the device counters (CG iterations 0 on the dense tier)."""
    ta = graphs["dense"][0]
    calls = []
    orig = tsolver.lm_optimize

    def counted(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append((res.iterations, res.cg_iterations))
        return res
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsolver, "lm_optimize", counted)
        res = tsolver.gnc_optimize(dataclasses.replace(ta))
    assert res.outer_iterations > 0 and len(calls) >= 2
    assert all(it > 0 and cg == 0 for it, cg in calls)

"""Parity of the port's PGO stack (se3, chordal init, LM, GNC-TLS) with the
JAX package. Graphs are built with the JAX package's FactorGraph and handed
to the port through ``convert.pose_graph_arrays_from_numpy``.

Tolerances: se3 maps within 1e-5 absolute (float32 transcendental and 3x3
solve rounding); optimized poses within 2e-3 absolute per entry (rotation
and metres) — both solvers run float32 LM with dense Cholesky whose
rounding differs, over tens of iterations on a 50-pose graph with metre
-scale translations; the rejected-outlier sets exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import se3 as jse3
from cslam_tpu.pgo import FactorGraph
from cslam_tpu.pgo import solver as jsolver
from cslam_tpu.pgo.chordal import chordal_initialize as jchordal
from cslam_tpu_torch.convert import pose_graph_arrays_from_numpy
from cslam_tpu_torch.ops import se3 as tse3
from cslam_tpu_torch.pgo import solver as tsolver
from cslam_tpu_torch.pgo.chordal import chordal_initialize as tchordal
from torch_threads import one_torch_thread  # noqa: F401

SIGMAS = np.array([0.01] * 3 + [0.1] * 3)
POSE_ATOL = 2e-3


def _tangents(seed):
    """Random tangents spanning both sides of the theta < 0.5 Taylor
    switch, down to 1e-4 rad."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    scale = np.logspace(-4, 0.4, 64).astype(np.float32)
    xi[:, :3] *= scale[:, None] / np.linalg.norm(xi[:, :3], axis=1,
                                                  keepdims=True)
    return xi


def test_se3_exp_log_jacobians_match():
    xi = _tangents(0)
    T_j = np.asarray(jax.jit(jse3.exp)(xi))
    T_t = tse3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-5)
    np.testing.assert_allclose(tse3.log(T_t).numpy(),
                               np.asarray(jax.jit(jse3.log)(T_j)), atol=1e-5)
    np.testing.assert_allclose(tse3.log(T_t).numpy(), xi, atol=1e-4)
    np.testing.assert_allclose(tse3.se3_jr_inv(torch.from_numpy(xi)).numpy(),
                               np.asarray(jax.jit(jse3.se3_jr_inv)(xi)),
                               atol=1e-5)
    A, B = T_t[:32], T_t[32:]
    np.testing.assert_allclose(
        tse3.between(A, B).numpy(),
        np.asarray(jax.jit(jse3.between)(T_j[:32], T_j[32:])), atol=1e-5)
    np.testing.assert_allclose(
        tse3.adjoint(A).numpy(), np.asarray(jax.jit(jse3.adjoint)(T_j[:32])),
        atol=1e-5)


def _circle(n, radius, robot, z=0.0):
    out = {}
    for k in range(n):
        a = 2 * np.pi * k / n
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), z]
        out[(robot, k)] = T
    return out


def _exp(xi):
    """SE(3) exp of one tangent in float64 (input construction only)."""
    return tse3.exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()


def _noisy(Ta, Tb, rng):
    z = np.linalg.inv(Ta) @ Tb
    noise = np.concatenate([rng.normal(scale=0.01, size=3),
                            rng.normal(scale=0.1, size=3)])
    return z @ _exp(noise)


def _two_robot_graph(seed=5, n=25):
    """Two robots on shifted circles, dead-reckoned inits, 5 genuine
    inter-robot loops and 2 gross outliers (the last two robust edges)."""
    rng = np.random.default_rng(seed)
    gt = {**_circle(n, 10.0, 0), **_circle(n, 10.5, 1, z=0.3)}
    g = FactorGraph()
    for r in (0, 1):
        cur = gt[(r, 0)]
        g.add_variable((r, 0), cur)
        zs = [_noisy(gt[(r, k)], gt[(r, k + 1)], rng) for k in range(n - 1)]
        for k, z in enumerate(zs):
            cur = cur @ z
            g.add_variable((r, k + 1), cur)
        for k, z in enumerate(zs):
            g.add_between((r, k), (r, k + 1), z, SIGMAS)
    for k in range(0, n, 5):
        g.add_between((0, k), (1, k), _noisy(gt[(0, k)], gt[(1, k)], rng),
                      SIGMAS, robust=True)
    for a, b in (((0, 3), (1, 17)), ((1, 8), (0, 21))):
        bad = _exp(np.concatenate([rng.uniform(-2, 2, 3),
                                   rng.uniform(-20, 20, 3)]))
        g.add_between(a, b, bad, SIGMAS, robust=True)
    g.add_prior((0, 0), gt[(0, 0)], SIGMAS)
    return g


def _to_port(arrays):
    return pose_graph_arrays_from_numpy(
        {f.name: np.asarray(getattr(arrays, f.name))
         for f in dataclasses.fields(arrays)}, device="cpu")


@pytest.fixture(scope="module")
def graph_pair():
    arrays = _two_robot_graph().to_arrays()
    return arrays, _to_port(arrays)


def test_convert_carries_every_field(graph_pair):
    ja, ta = graph_pair
    for f in dataclasses.fields(ja):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(),
                                      np.asarray(getattr(ja, f.name)))
    assert ta.edge_i.dtype == torch.int64 and ta.poses.dtype == torch.float32


def test_gnc_rejects_the_same_outliers(graph_pair):
    ja, ta = graph_pair
    jr = jsolver.gnc_optimize(ja)
    tr = tsolver.gnc_optimize(ta)
    robust = np.nonzero(np.asarray(ja.robust) * np.asarray(ja.edge_valid))[0]
    jw, tw = np.asarray(jr.weights)[robust], tr.weights.numpy()[robust]
    j_rejected = set(robust[jw < 0.5].tolist())
    t_rejected = set(robust[tw < 0.5].tolist())
    assert t_rejected == j_rejected == set(robust[-2:].tolist())
    n = int(np.asarray(ja.node_valid).sum())
    np.testing.assert_allclose(tr.poses.numpy()[:n],
                               np.asarray(jr.poses)[:n], atol=POSE_ATOL)
    assert int(tr.outer_iterations) == int(jr.outer_iterations)


def test_reoptimize_matches(graph_pair):
    """The backend's steady-state solve, warm-started from the previous
    round's solution and weights: weighted LM, the hard TLS refresh, and a
    polish."""
    ja, ta = graph_pair
    n = int(np.asarray(ja.node_valid).sum())
    prev = jsolver.gnc_optimize(ja)
    w = np.asarray(prev.weights)
    ja2 = dataclasses.replace(ja, poses=prev.poses)
    ta2 = dataclasses.replace(ta, poses=torch.tensor(np.asarray(prev.poses)))
    jro = jsolver.gnc_reoptimize(ja2, jnp.asarray(w))
    tro = tsolver.gnc_reoptimize(ta2, torch.tensor(w))
    np.testing.assert_array_equal(tro.weights.numpy(), np.asarray(jro.weights))
    assert int((tro.weights.numpy() == 0).sum()) == 2
    np.testing.assert_allclose(tro.poses.numpy()[:n],
                               np.asarray(jro.poses)[:n], atol=POSE_ATOL)
    assert float(tro.final_cost) == pytest.approx(float(jro.final_cost),
                                                  rel=1e-3)


def test_chordal_initialize_matches(graph_pair):
    ja, ta = graph_pair
    w = np.ones(ja.edge_i.shape[0], np.float32)
    robust = np.nonzero(np.asarray(ja.robust) * np.asarray(ja.edge_valid))[0]
    w[robust[-2:]] = 1e-4
    jp = np.asarray(jchordal(ja, jnp.asarray(w)))
    tp = tchordal(ta, torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(tp, jp, atol=POSE_ATOL)


def test_dense_tier_limit_raises():
    """Above the dense tier's 512 nodes LM no longer raises: it takes the
    PCG tier (parity with the JAX package is in
    tests/test_torch_pgo_pcg.py). A 600-pose chain with exact odometry,
    started 5 cm off at one pose, comes back to it (float32 positions
    out to 60 m)."""
    g = FactorGraph()
    step = np.eye(4)
    step[0, 3] = 0.1
    for k in range(600):
        pose = np.eye(4)
        pose[0, 3] = 0.1 * k + (0.05 if k == 300 else 0.0)
        g.add_variable((0, k), pose)
        if k:
            g.add_between((0, k - 1), (0, k), step, SIGMAS)
    g.add_prior((0, 0), np.eye(4), SIGMAS)
    ta = _to_port(g.to_arrays())
    assert ta.poses.shape[0] == 1024
    res = tsolver.lm_optimize(ta, torch.ones(ta.edge_i.shape[0]))
    np.testing.assert_allclose(res.poses[:600, 0, 3].numpy(),
                               0.1 * np.arange(600), atol=1e-3)

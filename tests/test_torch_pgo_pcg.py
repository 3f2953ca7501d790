"""Parity of the port's PGO PCG tier (graphs padded above 512 nodes) with the
JAX package: the implicit-Hessian matvec, the segment-rigid coarse
correction, coarse-corrected PCG, LM and GNC on it.

Tolerances:
- matvec against the dense ``(H + lam diag H) x`` in float64: 1e-4 of
  max|.|;
- the coarse correction's Galerkin identity below 5e-3, as the JAX
  package's own test holds it (``tests/test_pgo.py``), and its apply within
  1e-4 of max|.| of the reference's (the port sums ``H_c`` block by block,
  the reference by one-hot matmuls);
- PCG with the coarse correction within 1e-4 of max|.| of the reference's
  solution (the same iteration count; float32 reductions in another
  order);
- LM poses within ``POSE_ATOL`` = 2e-3 (rotation entries and metres) of
  the reference's, as ``tests/test_torch_pgo.py`` holds the dense tier;
  GNC's rejected-outlier set exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pgo import build_graph, circle_trajectory
from test_torch_pgo import _to_port, _two_robot_graph

from cslam_tpu.ops import se3 as jse3
from cslam_tpu.pgo import solver as jsolver
from cslam_tpu_torch.pgo import solver as tsolver
from torch_threads import one_torch_thread  # noqa: F401

POSE_ATOL = 2e-3


@jax.jit
def _reference_outputs(ja, x):
    """The JAX package's matvec, coarse apply and coarse-corrected PCG
    solution on ``ja`` at lam = 1e-4, unit weights (one compiled call)."""
    w = jnp.ones(ja.num_edges, ja.poses.dtype)
    r, Ji, Jj, rp, Jp = jsolver._linearize(ja.poses, ja)
    oh = jsolver._one_hots(ja, ja.poses.dtype)
    D = jsolver._hessian_blocks(ja, Ji, Jj, Jp, w, oh)
    dh = jnp.maximum(jnp.einsum("nii->ni", D), 1e-8)
    lam = jnp.asarray(1e-4, ja.poses.dtype)
    matvec = jsolver._make_matvec(ja, Ji, Jj, Jp, w, lam, dh, oh)
    coarse = jsolver._coarse_correction(ja, ja.poses, Ji, Jj, Jp, w, lam, dh)
    grad = jsolver._assemble_grad(ja, Ji, Jj, Jp, r * w[:, None], rp, oh)
    M_inv = jnp.linalg.inv(D + lam * dh[:, None]
                           * jnp.eye(6, dtype=ja.poses.dtype)[None])
    return (matvec(x), coarse(x),
            jsolver._pcg(matvec, -grad, M_inv, 150, 1e-6, coarse))


@pytest.fixture(scope="module")
def linear_system():
    """tests/test_pgo.py's coarse-PCG system (two 128-pose robots, 256
    nodes) linearized by both packages at the same poses."""
    rng = np.random.default_rng(3)
    n = 128
    gt = {**circle_trajectory(n, robot=0),
          **circle_trajectory(n, radius=11.0, robot=1)}
    graph = build_graph(gt, rng, loops=[((0, k), (1, k))
                                        for k in range(0, n, 8)])
    ja = graph.to_arrays()
    ta = _to_port(ja)
    x = np.random.default_rng(1).normal(size=(ta.num_nodes, 6)).astype(
        np.float32)
    ref = dict(zip(("matvec", "coarse", "pcg"), (np.asarray(a) for a in
                   _reference_outputs(ja, jnp.asarray(x)))))

    lam = 1e-4
    tw = torch.ones(ta.num_edges)
    tr, tJi, tJj, trp, tJp = tsolver._linearize(ta.poses, ta)
    tD = tsolver._hessian_blocks(ta, tJi, tJj, tJp, tw)
    tdh = torch.clamp(torch.diagonal(tD, dim1=1, dim2=2), min=1e-8)
    tlam = torch.tensor(lam)
    port = {"matvec": tsolver._make_matvec(ta, tJi, tJj, tJp, tw, tlam, tdh),
            "coarse": tsolver._coarse_correction(ta, ta.poses, tJi, tJj,
                                                 tJp, tw, tlam, tdh),
            "grad": tsolver._assemble_grad(ta, tJi, tJj, tJp,
                                           tr * tw[:, None], trp),
            "M_inv": torch.linalg.inv(tD + tlam * tdh[:, None]
                                      * torch.eye(6)[None]),
            "J": (tJi, tJj, tJp), "diag_h": tdh, "lam": lam}
    return ja, ta, x, ref, port


def _dense_hessian(ta, Ji, Jj, Jp, lam, diag_h):
    """(H + lam diag H) as a dense float64 [6Np, 6Np] matrix, padded nodes
    at identity (the matvec's convention), from the port's Jacobians."""
    Np = ta.num_nodes
    w = (ta.edge_valid.double())[:, None, None]
    J = np.zeros((ta.num_edges, 6, Np * 6))
    e = np.arange(ta.num_edges)
    for idx, Je in ((ta.edge_i.numpy(), Ji), (ta.edge_j.numpy(), Jj)):
        for c in range(6):
            np.add.at(J, (e, slice(None), idx * 6 + c),
                      (Je.double() * w)[:, :, c].numpy())
    H = np.einsum("eri,erj->ij", J, J)
    Jpr = np.zeros((ta.prior_idx.shape[0], 6, Np * 6))
    for b, (node, Jb) in enumerate(zip(ta.prior_idx.numpy(), Jp.double())):
        Jpr[b, :, node * 6:node * 6 + 6] = (
            Jb.numpy() * float(ta.prior_valid[b]))
    H += np.einsum("bri,brj->ij", Jpr, Jpr)
    H += np.diag(lam * diag_h.double().numpy().reshape(-1))
    valid = np.repeat(ta.node_valid.numpy() > 0, 6)
    H[~valid, :] = 0.0
    H[:, ~valid] = 0.0
    H[~valid, ~valid] = 1.0
    return H


def test_matvec_matches_dense_hessian(linear_system):
    ja, ta, x, ref, port = linear_system
    H = _dense_hessian(ta, *port["J"], port["lam"], port["diag_h"])
    want = (H @ x.astype(np.float64).reshape(-1)).reshape(-1, 6)
    got = port["matvec"](torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(got - ref["matvec"]).max() <= 1e-4 * np.abs(
        ref["matvec"]).max()


def test_coarse_correction_galerkin_and_reference(linear_system):
    ja, ta, x, ref, port = linear_system
    Np = ta.num_nodes
    nseg = max(1, Np // tsolver._COARSE_SEG)
    seg = np.minimum(np.arange(Np) // tsolver._COARSE_SEG, nseg - 1)
    A = np.asarray(jse3.adjoint(jse3.inverse(ja.poses))) * np.asarray(
        ja.node_valid)[:, None, None]
    y = np.random.default_rng(0).normal(size=(nseg, 6)).astype(np.float32)
    Py = torch.from_numpy(np.einsum("nab,nb->na", A, y[seg]))
    lhs = port["coarse"](port["matvec"](Py))
    assert float((lhs - Py).abs().max() / Py.abs().max()) < 5e-3
    got = port["coarse"](torch.from_numpy(x)).numpy()
    assert np.abs(got - ref["coarse"]).max() <= 1e-4 * np.abs(
        ref["coarse"]).max()


def test_pcg_with_coarse_correction_matches(linear_system):
    ja, ta, x, ref, port = linear_system
    want = ref["pcg"]
    b = -port["grad"]
    got = tsolver._pcg(port["matvec"], b, port["M_inv"], 150, 1e-6,
                       port["coarse"])
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    resid = torch.linalg.norm(b - port["matvec"](got))
    assert float(resid) < 1e-5 * float(torch.linalg.norm(b))
    # block-Jacobi alone is still far off after as many iterations
    x_bj = tsolver._pcg(port["matvec"], b, port["M_inv"], 150, 1e-6)
    assert float(torch.linalg.norm(b - port["matvec"](x_bj))) > 10 * float(
        resid)


def test_lm_optimize_pcg_tier_matches():
    """tests/test_pgo.py's 2 x 288 construction (576 poses, a 1024 tier)."""
    rng = np.random.default_rng(7)
    n = 288
    gt = {**circle_trajectory(n, robot=0),
          **circle_trajectory(n, radius=11.0, robot=1)}
    graph = build_graph(gt, rng, loops=[((0, k), (1, k))
                                        for k in range(0, n, 16)],
                        drift_init=False, rot_std=0.002, trans_std=0.02)
    ja = graph.to_arrays()
    ta = _to_port(ja)
    assert ta.num_nodes > tsolver._DENSE_SOLVE_MAX_NODES
    jr = jsolver.lm_optimize(ja, jnp.ones(ja.num_edges), max_iters=15)
    tr = tsolver.lm_optimize(ta, torch.ones(ta.num_edges), max_iters=15)
    np.testing.assert_allclose(tr.poses.numpy()[:2 * n],
                               np.asarray(jr.poses)[:2 * n], atol=POSE_ATOL)
    assert float(tr.final_cost) == pytest.approx(float(jr.final_cost),
                                                 rel=1e-3)
    cost0 = float(tsolver.cost(ta.poses, ta, torch.ones(ta.num_edges)))
    assert float(tr.final_cost) < cost0


def test_gnc_padded_past_dense_tier_rejects_the_same_outliers():
    """tests/test_torch_pgo.py's two-robot graph (50 poses, 5 genuine
    loops, 2 gross outliers) padded to 1024 nodes: the PCG tier."""
    ja = _two_robot_graph().to_arrays(np_floor=1024)
    ta = _to_port(ja)
    assert ta.num_nodes == 1024
    jr = jsolver.gnc_optimize(ja)
    tr = tsolver.gnc_optimize(ta)
    robust = np.nonzero(np.asarray(ja.robust) * np.asarray(ja.edge_valid))[0]
    j_rejected = set(robust[np.asarray(jr.weights)[robust] < 0.5].tolist())
    t_rejected = set(robust[tr.weights.numpy()[robust] < 0.5].tolist())
    assert t_rejected == j_rejected == set(robust[-2:].tolist())
    n = int(np.asarray(ja.node_valid).sum())
    np.testing.assert_allclose(tr.poses.numpy()[:n],
                               np.asarray(jr.poses)[:n], atol=POSE_ATOL)
    # the warm re-solve on the PCG tier agrees with the same re-solve of
    # the unpadded graph on the dense tier (padding invariance)
    small = _to_port(_two_robot_graph().to_arrays())
    outs = [tsolver.gnc_reoptimize(
        dataclasses.replace(g, poses=torch.cat(
            [tr.poses[:n], g.poses[n:]])), tr.weights[:g.num_edges])
        for g in (ta, small)]
    np.testing.assert_array_equal(outs[0].weights.numpy()[:small.num_edges],
                                  outs[1].weights.numpy())
    np.testing.assert_allclose(outs[0].poses.numpy()[:n],
                               outs[1].poses.numpy()[:n], atol=POSE_ATOL)

"""Parity of the port's selection stack (Fiedler eigensolver, MAC, ACM,
sparse matching, broker) with the JAX package on the same seeded inputs.

Tolerances: lambda_2 within 1e-4 relative (two float32 ``eigh``
implementations, LAPACK through XLA vs through PyTorch, on the same deflated
Laplacian); selections, edge sets and vertex covers exactly. The graphs are
connected with distinct candidate scores, so the Fiedler vector is unique up
to sign and the float32 differences cannot reorder the supergradient.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (all_considered, multi_robot_graph, simple_graph,
                     unit_vectors)

from cslam_tpu.ops import fiedler as jfd
from cslam_tpu.selection import acm as jacm
from cslam_tpu.selection import mac as jmac
from cslam_tpu.selection.broker import Broker as JBroker
from cslam_tpu import types as jtypes
from cslam_tpu_torch.ops import fiedler as tfd
from cslam_tpu_torch.selection import acm as tacm
from cslam_tpu_torch.selection import mac as tmac
from cslam_tpu_torch.selection.broker import Broker as TBroker
from cslam_tpu_torch import types as ttypes
from torch_threads import one_torch_thread  # noqa: F401


def _random_graph(seed, P=64, nodes=40, extra=30):
    rng = np.random.default_rng(seed)
    i = list(range(nodes - 1)) + list(rng.integers(0, nodes, extra))
    j = list(range(1, nodes)) + list(rng.integers(0, nodes, extra))
    w = rng.uniform(0.2, 1.0, len(i)).astype(np.float32)
    active = (np.arange(P) < nodes).astype(np.float32)
    return np.array(i, np.int32), np.array(j, np.int32), w, active


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fiedler_pair_lambda2(seed):
    i, j, w, active = _random_graph(seed)
    P = active.shape[0]
    jl, jv = jfd.fiedler_pair(jfd.laplacian_from_edges(
        jnp.asarray(i), jnp.asarray(j), jnp.asarray(w), P),
        jnp.asarray(active))
    tl, tv = tfd.fiedler_pair(tfd.laplacian_from_edges(
        torch.from_numpy(i).long(), torch.from_numpy(j).long(),
        torch.from_numpy(w), P), torch.from_numpy(active))
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    # same vector up to sign
    jv, tv = np.asarray(jv), tv.numpy()
    assert min(np.abs(jv - tv).max(), np.abs(jv + tv).max()) < 1e-3
    assert float(tfd.algebraic_connectivity(
        torch.from_numpy(i).long(), torch.from_numpy(j).long(),
        torch.from_numpy(w), torch.from_numpy(active))) == pytest.approx(
            float(jl), rel=1e-4)


def _chain_case():
    """The misleading-weights chain of test_selection's MAC test."""
    n = 40
    fixed = [(i, i + 1, 1.0) for i in range(n - 1)]
    cands = [(i, i + 2, 1.0) for i in range(0, n - 2, 2)]
    cands += [(0, n - 1, 0.5), (5, n - 5, 0.5), (3, 30, 0.7), (12, 37, 0.6)]
    return n, fixed, cands


def _helpers_case(seed):
    """tests/helpers.py's seeded single-robot graph: its candidate
    self-edges on an odometry chain, weights drawn from the same seed."""
    n = 48
    _, cands = simple_graph(n, 30, seed=seed)
    rng = np.random.default_rng(seed)
    cands = [(c.robot0_keyframe_id, c.robot1_keyframe_id, float(w))
             for c, w in zip(cands, rng.uniform(0.5, 1.0, len(cands)))
             if c.robot0_keyframe_id != c.robot1_keyframe_id]
    return n, [(i, i + 1, 1.0) for i in range(n - 1)], cands


@pytest.mark.parametrize("case,best_rounding", [
    ("chain", False), ("chain", True), ("helpers_3", True),
    ("helpers_8", True), ("helpers_8", False)])
def test_mac_fw_subset_selects_the_same_edges(case, best_rounding):
    n, fixed, cands = (_chain_case() if case == "chain"
                       else _helpers_case(int(case.split("_")[1])))
    kw = dict(best_rounding=best_rounding)
    jm = jmac.MAC([jtypes.Edge(*e) for e in fixed],
                  [jtypes.Edge(*e) for e in cands], n, **kw)
    tm = tmac.MAC([ttypes.Edge(*e) for e in fixed],
                  [ttypes.Edge(*e) for e in cands], n, device="cpu", **kw)
    w0 = np.zeros(len(cands))
    w0[:3] = 1.0
    jsel, jw, jdual = jm.fw_subset(w0, 3, max_iters=20)
    tsel, tw, tdual = tm.fw_subset(w0, 3, max_iters=20)
    np.testing.assert_array_equal(tsel, jsel)
    assert tm.last_fw_iters == jm.last_fw_iters
    np.testing.assert_allclose(tw, jw, atol=1e-4)
    assert tm.evaluate_objective(tsel) == pytest.approx(
        jm.evaluate_objective(jsel), rel=1e-4)
    # the host-loop oracle agrees with the fused loop in the port too
    np.testing.assert_array_equal(tm.fw_subset_host(w0, 3, max_iters=20)[0],
                                  tsel)


def test_mac_above_dense_tier_raises():
    """Above the dense tier's 512 poses the MAC no longer raises: it builds
    the chain + low-rank tier and selects (parity with the JAX package is
    in tests/test_torch_mac_woodbury.py)."""
    fixed = [ttypes.Edge(i, i + 1, 1.0) for i in range(599)]
    mac = tmac.MAC(fixed, [ttypes.Edge(1, 300, 1.0), ttypes.Edge(2, 5, 1.0)],
                   600, device="cpu")
    assert not mac._dense and mac._P == 1024 and mac.num_lr_fixed == 0
    sel, _, _ = mac.fw_subset(np.zeros(2), 1, max_iters=5)
    np.testing.assert_array_equal(sel, [1.0, 0.0])   # the long edge


@pytest.mark.parametrize("seed,nb_robots", [(0, 2), (1, 3), (4, 4)])
def test_acm_selection_matches_reference(seed, nb_robots):
    """Seeded multi-robot graphs from tests/helpers.py through the whole
    ACM -> MAC selection (the production kwargs), then the broker."""
    fixed, cands = multi_robot_graph(12, 25, nb_robots, seed=seed)
    rng = np.random.default_rng(seed)
    cands = [c._replace(weight=float(w))
             for c, w in zip(cands, rng.uniform(0.8, 1.0, len(cands)))]
    j = jacm.AlgebraicConnectivityMaximization(0, nb_robots)
    t = tacm.AlgebraicConnectivityMaximization(0, nb_robots, device="cpu")
    j.set_graph(fixed, cands)
    t.set_graph([ttypes.EdgeInterRobot(*e) for e in fixed],
                [ttypes.EdgeInterRobot(*e) for e in cands])
    jsel = j.select_candidates(6, all_considered(nb_robots))
    tsel = t.select_candidates(6, all_considered(nb_robots))
    assert [e.key() for e in tsel] == [e.key() for e in jsel]
    assert len(tsel) == 6
    assert t.last_fw_iters == j.last_fw_iters
    assert sorted(t.candidate_edges) == sorted(j.candidate_edges)
    jb = JBroker(jsel, list(range(nb_robots))).brokerage(True)
    tb = TBroker(tsel, list(range(nb_robots))).brokerage(True)
    assert tb == jb


def _detection_round(pkg):
    """One detection round of robot 0 in a 3-robot swarm: local keyframes,
    gossip from the other two, two verified links, a budgeted selection and
    the broker's vertex cover."""
    if pkg == "jax":
        from cslam_tpu.matching.sparse_matching import \
            LoopClosureSparseMatching as LCSM
        from cslam_tpu.selection.broker import Broker
        from cslam_tpu.types import EdgeInterRobot, GlobalDescriptor
        kw = {}
    else:
        from cslam_tpu_torch.matching.sparse_matching import \
            LoopClosureSparseMatching as LCSM
        from cslam_tpu_torch.selection.broker import Broker
        from cslam_tpu_torch.types import EdgeInterRobot, GlobalDescriptor
        kw = {"device": "cpu"}
    from helpers import matching_params
    params = matching_params(max_nb_robots=3, similarity_threshold=0.9)
    rng = np.random.default_rng(11)
    places = unit_vectors(30, 32, rng)
    lcsm = LCSM(params, **kw)
    for kf in range(30):
        lcsm.add_local_global_descriptor(places[kf], kf)
    matches = []
    for rid in (1, 2):
        visits = rng.choice(30, 12, replace=False)
        chunk = []
        for kf, p in enumerate(visits):
            d = places[p] + rng.normal(scale=0.03, size=32)
            chunk.append(GlobalDescriptor(kf, rid, (d / np.linalg.norm(d))
                                          .tolist()))
        matches += lcsm.add_other_robot_global_descriptors(chunk)
    # a new local keyframe searched against both other banks (stacked top-1)
    matches += lcsm.add_local_global_descriptor(places[3], 30)
    acm = lcsm.candidate_selector
    verified = sorted(acm.candidate_edges.values())[:2]
    acm.candidate_edges_to_fixed([verified[0]])
    acm.candidate_edges_to_fixed(
        [e for e in verified if e.robot1_id != verified[0].robot1_id][:1]
        or [EdgeInterRobot(0, 0, 2, 0, 1.0)])
    selection = lcsm.select_candidates(5, all_considered(3))
    cover = Broker(selection, [0, 1, 2]).brokerage(True)
    return ([m.key() for m in matches], [m.weight for m in matches],
            [e.key() for e in selection], cover,
            sorted(acm.candidate_edges))


def test_detection_round_with_broker_matches_reference():
    jm, jw, jsel, jcover, jpool = _detection_round("jax")
    tm, tw, tsel, tcover, tpool = _detection_round("torch")
    assert tm == jm and len(tm) > 10
    np.testing.assert_allclose(tw, jw, atol=1e-5)
    assert tsel == jsel and len(tsel) == 5
    assert tcover == jcover
    assert tpool == jpool

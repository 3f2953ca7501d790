"""Parity of the port's MAC on its chain + low-rank (Woodbury/LOBPCG) tier
with the JAX package, above the dense tier's 512 poses.

Tolerances: selections exactly (the rounded masks), lambda_2 of the
selection within 1e-3 relative (two float32 LOBPCG runs from the same start
block, the port's Woodbury factors from a float64 inverse, the reference's
from a float32 tridiagonal solve). Where the port starts LOBPCG from the
reference's draw, ``fiedler._start_block`` is patched to return it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import all_considered, multi_robot_graph
from test_torch_cuda import _slam_mac_inputs

from cslam_tpu import types as jtypes
from cslam_tpu.selection import acm as jacm
from cslam_tpu.selection import mac as jmac
from cslam_tpu_torch import types as ttypes
from cslam_tpu_torch.ops import fiedler as tfd
from cslam_tpu_torch.selection import acm as tacm
from cslam_tpu_torch.selection import mac as tmac
from torch_threads import one_torch_thread  # noqa: F401

_FLOORS = {"frontend.mac_p_floor": 1024, "frontend.mac_e_floor": 256,
           "frontend.mac_mf_floor": 64}


@pytest.fixture
def reference_start_block(monkeypatch):
    def start(P, block, active):
        X = jax.random.normal(jax.random.PRNGKey(7), (P, block), jnp.float32)
        return torch.from_numpy(np.array(X)).to(active.device) \
            * active[:, None]
    monkeypatch.setattr(tfd, "_start_block", start)


def _macs(fixed, cands, n, params):
    jm = jmac.MAC([jtypes.Edge(*e) for e in fixed],
                  [jtypes.Edge(*e) for e in cands], n,
                  **jmac.mac_kwargs_from_params(params))
    tm = tmac.MAC([ttypes.Edge(*e) for e in fixed],
                  [ttypes.Edge(*e) for e in cands], n, device="cpu",
                  **tmac.mac_kwargs_from_params(params))
    return jm, tm


def test_floored_woodbury_matches_reference_and_dense_tier():
    """tests/test_selection.py's floored graph (P = 1024): the same
    selection as the JAX package's Woodbury tier and the port's dense
    tier."""
    fixed = [(i, i + 1, 1.0) for i in range(49)] + [(0, 25, 1.0)]
    cands = [(i, (i + 20) % 50, 1.0) for i in range(8)]
    jm, tm = _macs(fixed, cands, 50, _FLOORS)
    assert (tm._P, tm._E, tm._mf) == (1024, 256, 64) and not tm._dense
    assert tm.num_lr_fixed == jm.num_lr_fixed == 1
    w0 = np.full(8, 0.5)
    jsel, _, jdual = jm.fw_subset(w0, 3, max_iters=5)
    tsel, _, tdual = tm.fw_subset(w0, 3, max_iters=5)
    dense = tmac.MAC([ttypes.Edge(*e) for e in fixed],
                     [ttypes.Edge(*e) for e in cands], 50, device="cpu",
                     **tmac.mac_kwargs_from_params({}))
    assert dense._dense
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_array_equal(dense.fw_subset(w0, 3, max_iters=5)[0],
                                  tsel)
    assert tdual == pytest.approx(jdual, rel=1e-3)


@pytest.mark.usefixtures("reference_start_block")
def test_slam_shaped_default_kwargs_match_reference():
    """Config-default kwargs (warm Ritz block, best rounding) on about 600
    poses: the same selection and lambda_2 as the JAX package."""
    n, fixed, cands = _slam_mac_inputs()
    jm, tm = _macs(fixed, cands, n, {})
    assert tm._P == 1024 and not tm._dense and tm._fw_warm_ritz
    w0 = np.zeros(len(cands))
    w0[:5] = 1.0
    jsel, _, jdual = jm.fw_subset(w0, 5, max_iters=20)
    tsel, _, tdual = tm.fw_subset(w0, 5, max_iters=20)
    np.testing.assert_array_equal(tsel, jsel)
    assert tsel.sum() == 5
    assert tm.evaluate_objective(tsel) == pytest.approx(
        jm.evaluate_objective(jsel), rel=1e-3)
    assert tdual == pytest.approx(jdual, rel=1e-3)
    # the host-driven loop (one device step per iteration) agrees
    np.testing.assert_array_equal(tm.fw_subset_host(w0, 5, max_iters=20)[0],
                                  tsel)


@pytest.mark.usefixtures("reference_start_block")
def test_acm_selection_on_woodbury_tier_matches_reference():
    """The detection path's ACM with ``frontend.mac_p_floor`` pinned to
    1024 selects on the Woodbury tier (not silently on the dense one) and
    matches the JAX package's ACM."""
    fixed, cands = multi_robot_graph(12, 25, 3, seed=1)
    rng = np.random.default_rng(1)
    cands = [c._replace(weight=float(w))
             for c, w in zip(cands, rng.uniform(0.8, 1.0, len(cands)))]
    j = jacm.AlgebraicConnectivityMaximization(0, 3, extra_params=_FLOORS)
    t = tacm.AlgebraicConnectivityMaximization(0, 3, extra_params=_FLOORS,
                                               device="cpu")
    j.set_graph(fixed, cands)
    t.set_graph([ttypes.EdgeInterRobot(*e) for e in fixed],
                [ttypes.EdgeInterRobot(*e) for e in cands])
    macs = []
    dispatch = t.run_mac_solver_dispatch

    def record(*args, **kwargs):
        mac, pending = dispatch(*args, **kwargs)
        macs.append(mac)
        return mac, pending
    t.run_mac_solver_dispatch = record
    jsel = j.select_candidates(6, all_considered(3))
    tsel = t.select_candidates(6, all_considered(3))
    assert [e.key() for e in tsel] == [e.key() for e in jsel]
    assert len(tsel) == 6
    assert len(macs) == 1 and not macs[0]._dense and macs[0]._P == 1024
    assert t.last_fw_iters == j.last_fw_iters

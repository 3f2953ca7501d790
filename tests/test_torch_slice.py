"""The whole slice: the reference's two-robot swarm (``overlapping_two_robot_sim``
of tests/test_runtime.py) against the port's twin on the same seed, both on
the CPU.

Both runs use ``frontend.async_detection: False``. With async detection the
reference harvests a MAC solve only once ``jax.Array.is_ready()`` says so,
which depends on JAX's dispatch threads; the harvest cycle then decides when
verification requests reach the other robot, whose one noise generator
serves both odometry and verification noise — so the noise sequence, and
with it every pose, would differ for reasons of timing alone. Synchronous
detection harvests in the cycle that dispatched, in both packages. The PGO
tier floors are pinned (``backend.pgo_np_floor/ne_floor``) so the reference
compiles one solver program instead of one per tier; padding is inert.

Tolerances: fixed-edge sets and inter-robot loop-closure counts exactly;
odometry ATE exactly (same noise); optimized ATE within 1e-3 m — both
solvers run float32 LM with differently rounded Cholesky factors over ~20
optimization rounds, and the resulting pose differences stay at the 1e-5 m
level measured when this test was written.
"""
import numpy as np
import pytest

from cslam_tpu.runtime import simulator as jsim
from cslam_tpu_torch.runtime import simulator as tsim
from torch_threads import one_torch_thread  # noqa: F401

ATE_TOL = 1e-3
OVERRIDES = {"frontend.inter_robot_detection_period_sec": 3.0,
             "frontend.inter_robot_loop_closure_budget": 5,
             "backend.pose_graph_optimization_start_period_ms": 2000,
             "frontend.async_detection": False,
             "backend.pgo_np_floor": 64, "backend.pgo_ne_floor": 128}


def _run(mod, nb_keyframes=30, **kw):
    world = mod.SyntheticWorld(nb_places=40, descriptor_dim=32, seed=0)
    trajs = [mod.circle_trajectory(nb_keyframes, radius=10.0, nb_places=40),
             mod.circle_trajectory(nb_keyframes, radius=10.0, nb_places=40,
                                   start_angle=0.1, z=0.5)]
    sim = mod.SwarmSimulator(2, world, trajs, config_overrides=OVERRIDES,
                             keyframe_period=0.5, **kw)
    sim.run(40.0, dt=0.25)
    return sim


def _summary(sim):
    out = []
    for rid, robot in enumerate(sim.robots):
        acm = robot.detection.lcm.candidate_selector
        out.append({
            "fixed": sorted(e.key() for e in acm.fixed_edges),
            "inter_lc": sum(len(v) for v in
                            robot.backend.inter_robot_loop_closures.values()),
            "optimizations": robot.backend.optimization_count,
            "ate": sim.ate(rid),
            "bank_n": robot.detection.lcm.local_nnsm.n,
            "gossip_n": {r: b.n for r, b in
                         robot.detection.lcm.other_robots_nnsm.items()},
        })
    return out


@pytest.fixture(scope="module")
def runs():
    return _summary(_run(jsim)), _summary(_run(tsim, device="cpu"))


@pytest.mark.parametrize("rid", [0, 1])
def test_same_fixed_edges_and_loop_closures(runs, rid):
    ref, port = runs[0][rid], runs[1][rid]
    assert port["fixed"] == ref["fixed"]
    assert port["inter_lc"] == ref["inter_lc"]
    assert port["optimizations"] == ref["optimizations"]
    assert port["bank_n"] == ref["bank_n"] == 30
    assert port["gossip_n"] == ref["gossip_n"]
    assert len(runs[1][0]["fixed"]) > 0 and runs[1][0]["inter_lc"] > 0


@pytest.mark.parametrize("rid", [0, 1])
def test_ate_matches_reference(runs, rid):
    (ref_odo, ref_opt), (odo, opt) = runs[0][rid]["ate"], runs[1][rid]["ate"]
    assert odo == ref_odo
    assert abs(opt - ref_opt) <= ATE_TOL
    if rid == 0:
        assert np.isfinite(opt) and opt <= odo + 0.05

"""Parity of the port's GNC scenario sweep (``tools/gnc_scenario_sweep.py``)
with ``benchmarks/gnc_scenario_sweep.py``, loaded by its path (``benchmarks/``
is no package; the script parses its arguments only in ``main()``).

Tolerances: the worlds' measurements within 1e-5 (the noise is composed
through se3 in float32 in each package), edge lists and robust flags
exactly; the scores exactly, ATE within 1e-3 m (both solvers run float32
LM whose rounding differs).
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

from cslam_tpu_torch.tools import gnc_scenario_sweep as tsweep
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jsweep():
    spec = importlib.util.spec_from_file_location(
        "jax_gnc_scenario_sweep",
        REPO / "benchmarks" / "gnc_scenario_sweep.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scenario(build, seed, n_out, tier):
    nr, npo, le, _, intra, _ = tier
    return build(np.random.default_rng(1000 * seed + n_out), nr, npo, le,
                 n_out, intra)


def test_tiers_are_the_scripts(jsweep):
    assert tsweep.TIERS == jsweep.TIERS
    assert tsweep.QUICK_TIERS == jsweep.QUICK_TIERS


@pytest.mark.parametrize("seed,n_out", [(0, 2), (1, 1)])
def test_build_scenario_matches(jsweep, seed, n_out):
    """One seed of the 3 x 80 tier: the same graph from the same stream."""
    jg, jgt, jn, jo = _scenario(jsweep.build_scenario, seed, n_out,
                                jsweep.TIERS[0])
    tg, tgt, tn, to = _scenario(tsweep.build_scenario, seed, n_out,
                                tsweep.TIERS[0])
    assert (tn, to) == (jn, jo)
    assert jgt.keys() == tgt.keys()
    assert all(np.array_equal(jgt[k], tgt[k]) for k in jgt)
    assert tg.keys() == jg.keys()
    assert len(tg._edges) == len(jg._edges)
    for (ti, tj, tz, ts, trb), (ji, jj, jz, js, jrb) in zip(tg._edges,
                                                            jg._edges):
        assert (ti, tj, trb) == (ji, jj, jrb)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_allclose(tz, jz, atol=1e-5)
    np.testing.assert_allclose(np.stack(tg._poses), np.stack(jg._poses),
                               atol=1e-5)
    assert [p[0] for p in tg._priors] == [p[0] for p in jg._priors]


#: a small world of the sweep's kind (3 robots x 30 poses, a loop every 5
#: poses, one intra-robot loop, 3 gross outliers), so that the JAX
#: package's GNC compiles in seconds
SMALL_TIER = (3, 30, 5, (3,), 1, (0,))


def test_run_scenario_scores_match(jsweep):
    jg, jgt, jn, jo = _scenario(jsweep.build_scenario, 0, 3, SMALL_TIER)
    tg, tgt, tn, to = _scenario(tsweep.build_scenario, 0, 3, SMALL_TIER)
    with jax.default_matmul_precision("highest"):
        jrow = jsweep.run_scenario(jg, jgt, jn, jo)
    trow = tsweep.run_scenario(tg, tgt, tn, to, device="cpu")
    for key in ("false_rejected", "genuine_total", "outliers_rejected",
                "outliers_total", "outer_iterations"):
        assert trow[key] == jrow[key], key
    assert trow["outliers_rejected"] == 3
    assert trow["outer_iterations"] > 0
    for key in ("ate_init_m", "ate_final_m"):
        assert abs(trow[key] - jrow[key]) <= 1e-3, key
    assert len(trow["rejected"]) == (trow["false_rejected"]
                                     + trow["outliers_rejected"])


def test_sweep_summary_counts_each_mode():
    """``sweep`` on the CPU in both modes: the eager programs are the
    graphed ones launched one by one, so on the CPU (where both run
    eagerly) they reject the same edges and score alike."""
    tier = (2, 20, 5, (1,), 0, (0,))
    lines = []
    out = tsweep.sweep([tier], "cpu", ("graphed", "eager"),
                       emit=lines.append)
    assert len(out["rows"]) == len(lines) == 2
    assert out["same_rejected"] == [True]
    g, e = out["summary"]["graphed"], out["summary"]["eager"]
    assert g["scenarios"] == e["scenarios"] == 1
    for key in ("false_rejected", "missed_outliers", "ate_regressions"):
        assert g[key] == e[key]

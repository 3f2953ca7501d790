"""The port's experiment logger (``cslam_tpu_torch/evaluation/logger.py``), on
the CPU: ``tests/test_evaluation.py::TestExperimentLogger`` on the port, and
parity with the JAX package.

The same two-robot simulation with ``evaluation.enable_logs`` (the JAX
package's logging case, with ``frontend.async_detection`` off in both
packages: the JAX package's async harvest timing depends on its dispatch
threads) runs in each package, each into a log folder of its own. Limits:
the same experiment folders and files; ``metrics.csv`` with the same keys
and rows, ``graph_error`` within a relative 1e-4 (where the reference's is
below 1e-6, a graph without a loop that fits exactly, both are float32
round-off and only that is checked); every initial and
optimized g2o dump with the same vertices and edges, values within 1e-4.
Timings (``total_pgo_time``, the sparsification time) are not compared.
"""
import csv
import importlib
import os

import numpy as np
import pytest

from cslam_tpu_torch.evaluation import g2o as g2o_io
from torch_threads import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
#: below this, a graph error is float32 round-off of an exact fit
EXACT_FIT = 1e-6
VALUE_TOL = 1e-4
PARITY_S = 12.0
TIMINGS = {"total_pgo_time", "sparsification_cumulative_computation_time"}


def _run(pkg, folder, duration=25.0, **kw):
    sim_mod = importlib.import_module(f"{pkg}.runtime.simulator")
    world = sim_mod.SyntheticWorld(nb_places=20, descriptor_dim=16, seed=0)
    trajs = [sim_mod.circle_trajectory(10, 10.0, 20),
             sim_mod.circle_trajectory(10, 10.0, 20, start_angle=0.05)]
    sim = sim_mod.SwarmSimulator(
        2, world, trajs,
        config_overrides={
            "evaluation.enable_logs": True,
            "evaluation.log_folder": str(folder),
            "frontend.inter_robot_detection_period_sec": 3.0,
            "backend.pose_graph_optimization_start_period_ms": 2000,
            "frontend.async_detection": False,
        }, keyframe_period=0.5, **kw)
    sim.run(duration, dt=0.25)
    return sim


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: (simulation, log folder)} of the parity run: the first
    PARITY_S seconds of the mission (five optimizations; the JAX package's
    logger costs about 0.7 s per dump on the CPU)."""
    out = {}
    for pkg, kw in (("cslam_tpu_torch", {"device": "cpu"}),
                    ("cslam_tpu", {})):
        folder = tmp_path_factory.mktemp(pkg)
        out[pkg] = (_run(pkg, folder, PARITY_S, **kw), folder)
    return out


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class TestExperimentLogger:

    def test_end_to_end_logging(self, tmp_path):
        """Run a 2-robot sim with logs enabled; experiment folder must
        contain metrics.csv and g2o dumps."""
        sim = _run("cslam_tpu_torch", tmp_path, device="cpu")
        folders = sorted(os.listdir(tmp_path))
        assert len(folders) == 2  # one per robot
        r0 = os.path.join(tmp_path,
                          [f for f in folders if f.endswith("r0")][0])
        files = os.listdir(r0)
        assert "metrics.csv" in files
        assert any(f.startswith("optimized_global") for f in files)
        assert any(f.startswith("initial_global") for f in files)
        with open(os.path.join(r0, "metrics.csv")) as f:
            content = f.read()
        assert "total_pgo_time" in content
        assert "graph_error" in content
        # comm-byte metrics flowed over the log_info bus
        logger = sim.robots[0].backend.logger
        assert logger.metrics["detection_cumulative_communication"] > 0
        assert logger.total_pgo_time > 0
        assert logger.device.type == "cpu"


def _folders(runs):
    (_, ours), (_, ref) = runs["cslam_tpu_torch"], runs["cslam_tpu"]
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(ref))
    return [(os.path.join(ours, n), os.path.join(ref, n)) for n in names]


def test_same_files_as_reference(runs):
    folders = _folders(runs)
    for ours, ref in folders:
        assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    assert any(f.startswith("optimized_global")
               for ours, _ in folders for f in os.listdir(ours))


def test_metrics_match_reference(runs):
    """Same keys and rows; ``graph_error`` (the port's ``solver.cost`` on
    its device) within a relative 1e-4; the counters equal."""
    n_errors = 0
    for ours, ref in _folders(runs):
        a, b = (_rows(os.path.join(d, "metrics.csv")) for d in (ours, ref))
        assert len(a) == len(b) >= 1
        assert list(a[0]) == list(b[0])
        for ra, rb in zip(a, b):
            for key in set(ra) - TIMINGS - {"graph_error"}:
                assert float(ra[key]) == float(rb[key]), key
            ea, eb = float(ra["graph_error"]), float(rb["graph_error"])
            if np.isnan(eb):
                assert np.isnan(ea)
                continue
            if eb < EXACT_FIT:
                # a graph without a loop fits exactly: both errors are
                # float32 round-off (about 1e-11), no relative agreement
                assert 0 <= ea < EXACT_FIT
                continue
            n_errors += 1
            assert np.isfinite(ea) and abs(ea - eb) <= REL_TOL * abs(eb)
    assert n_errors >= 1


@pytest.mark.parametrize("kind", ["initial_global", "optimized_global"])
def test_g2o_dumps_match_reference(runs, kind):
    n_files = 0
    for ours, ref in _folders(runs):
        for name in sorted(f for f in os.listdir(ref) if f.startswith(kind)):
            n_files += 1
            va, ea = g2o_io.read_g2o(os.path.join(ours, name))
            vb, eb = g2o_io.read_g2o(os.path.join(ref, name))
            assert sorted(va) == sorted(vb) and len(va) >= 1
            for k in vb:
                np.testing.assert_allclose(va[k], vb[k], rtol=0,
                                           atol=VALUE_TOL)
            assert len(ea) == len(eb) >= 1
            for x, y in zip(ea, eb):
                assert ((x.key_from.as_tuple(), x.key_to.as_tuple())
                        == (y.key_from.as_tuple(), y.key_to.as_tuple()))
                np.testing.assert_allclose(x.measurement, y.measurement,
                                           rtol=0, atol=VALUE_TOL)
                np.testing.assert_allclose(x.noise_sigmas, y.noise_sigmas,
                                           rtol=VALUE_TOL)
    assert n_files >= 1

"""Sums in a fixed order (``cslam_tpu_torch/ops/segment_sum.py``) on the CPU.

- ``segment_sum_ref``, the kernel's plain version, equals the CPU's
  ``index_add_`` (per-node plans) and ``index_put_(accumulate=True)``
  (compact plans) bit for bit on seeded graphs with parallel edges, a hub
  node and padded edges, at the solvers' row widths (6, 36, 3).
- A graph's plans do not depend on its tier's padding, and neither do the
  sums they give on its real nodes.
- No ``index_add_`` or accumulating ``index_put_`` is left on the PGO or
  MAC dense-tier paths unless ``PERF.md`` names it as exact or as
  repeating on the card.
- The coarse alignment's Cholesky (fault F5) with every separator
  TLS-cut at a hard mu, the case ``cslam_tpu/pgo/distributed.py:397-404``
  names: no failed factorization, and each Gauss-Newton step within 1e-5
  of the JAX package's LU (``jnp.linalg.solve``) on the same matrix.

The CUDA kernel itself is held against ``segment_sum_ref`` bit for bit by
``chip_smoke.py``'s ``segment_sum`` phase on the card.
"""
import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_distributed_pgo import _problem, _to_port
from torch_threads import one_torch_thread  # noqa: F401

from cslam_tpu_torch.ops.segment_sum import (segment_plan, segment_sum,
                                             segment_sum_ref)
from cslam_tpu_torch.pgo import distributed as td, solver
from cslam_tpu_torch.pgo.factor_graph import FactorGraph
from cslam_tpu_torch.utils.robot_mesh import StackedMesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEP_ATOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    """Seeded index arrays: 48 real nodes padded to 64, 150 real edges
    padded to 256 (padding at node 0, as ``to_arrays`` pads), 40 of them
    parallel to earlier edges, node 7 a hub of 60 edges; 5 priors padded
    to 8."""
    rng = np.random.default_rng(11)
    n, Np, m, Ne = 48, 64, 150, 256
    ei = rng.integers(0, n, m)
    ej = (ei + rng.integers(1, n, m)) % n
    ei[:60] = 7
    ei[110:], ej[110:] = ei[:40], ej[:40]        # parallel edges
    pi = rng.integers(0, n, 5)
    pad = lambda a, k: np.concatenate([a, np.zeros(k - len(a), a.dtype)])
    return {"n": n, "Np": Np, "m": m,
            "ei": torch.from_numpy(pad(ei, Ne)),
            "ej": torch.from_numpy(pad(ej, Ne)),
            "pi": torch.from_numpy(pad(pi, 8)),
            "ev": torch.arange(Ne) < m, "pv": torch.arange(8) < 5,
            "rng": rng}


def _sources(graphs, rows, width, valid):
    """Seeded float32 rows with widely spread magnitudes, exact zeros
    where not ``valid`` (a padded edge's terms)."""
    x = graphs["rng"].normal(size=(rows, width)) * np.exp(
        4.0 * graphs["rng"].normal(size=(rows, 1)))
    return torch.from_numpy(x.astype(np.float32)) * valid[:, None]


@pytest.mark.parametrize("width", [6, 36, 3])
def test_ref_equals_cpu_index_add(graphs, width):
    ei, ej, pi, ev, pv = (graphs[k] for k in ("ei", "ej", "pi", "ev", "pv"))
    Np = graphs["Np"]
    a = _sources(graphs, ei.shape[0], width, ev)
    b = _sources(graphs, ei.shape[0], width, ev)
    p = _sources(graphs, pi.shape[0], width, pv)
    # per node, as solver._hessian_blocks / _assemble_grad / the matvec
    want = torch.zeros((Np, width))
    want.index_add_(0, ei, a)
    want.index_add_(0, ej, b)
    want.index_add_(0, pi, p)
    plan = segment_plan(torch.cat([ei, ej, pi]), torch.cat([ev, ev, pv]), Np)
    got = segment_sum_ref(torch.cat([a, b, p]), plan)
    assert torch.equal(got, want)
    assert torch.equal(segment_sum(torch.cat([a, b, p]), plan), want)
    # per block pair, as the dense tier's off-diagonal blocks
    want = torch.zeros((Np, Np, width))
    want.index_put_((ei, ej), a, accumulate=True)
    want.index_put_((ej, ei), b, accumulate=True)
    plan = segment_plan(torch.cat([ei * Np + ej, ej * Np + ei]),
                        torch.cat([ev, ev]), Np * Np, compact=True)
    got = segment_sum_ref(torch.cat([a, b]), plan, rows=Np * Np)
    assert torch.equal(got.reshape(Np, Np, width), want)


def _chain_graph(np_floor, ne_floor):
    """A two-robot chain with loops, parallel loops and a prior, at the
    given tier floors."""
    rng = np.random.default_rng(4)
    g = FactorGraph()
    for r in range(2):
        for k in range(20):
            pose = np.eye(4)
            pose[:3, 3] = [k, 3.0 * r, 0.0]
            g.add_variable((r, k), pose)
        for k in range(19):
            z = np.eye(4)
            z[:3, 3] = [1.0, 0.0, 0.0] + rng.normal(scale=0.05, size=3)
            g.add_between((r, k), (r, k + 1), z, np.full(6, 0.1))
    for k in (0, 5, 5, 9, 12, 12, 12):
        z = np.eye(4)
        z[:3, 3] = [0.0, 3.0, 0.0]
        g.add_between((0, k), (1, k), z, np.full(6, 0.2), robust=True)
    g.add_prior((0, 0), g.get_pose((0, 0)), np.full(6, 0.1))
    return g.to_arrays(np_floor=np_floor, ne_floor=ne_floor, device="cpu")


def _source_ids(a, plan, n_valid):
    """The valid part of a node plan's order as (block, index) pairs: a
    source's block (edge_i, edge_j, prior_idx) and its row in it."""
    Ne, B = a.edge_i.shape[0], a.prior_idx.shape[0]
    bounds = torch.tensor([Ne, 2 * Ne, 2 * Ne + B])
    perm = plan.perm[:n_valid]
    block = torch.bucketize(perm, bounds, right=True)
    start = torch.cat([torch.zeros(1, dtype=torch.int64), bounds])[block]
    return torch.stack([block, perm - start], 1)


def test_plan_invariant_to_padding():
    small, large = _chain_graph(16, 16), _chain_graph(256, 256)
    n = int(small.node_valid.sum())
    assert large.poses.shape[0] > small.poses.shape[0]
    plans = [solver.segment_plans(a)["node"] for a in (small, large)]
    n_valid = int(plans[0].offsets[n])
    assert int(plans[1].offsets[n]) == n_valid
    assert torch.equal(plans[0].offsets[:n + 1], plans[1].offsets[:n + 1])
    # past the real nodes every range is empty
    for plan in plans:
        assert torch.all(plan.offsets[n:] == n_valid)
    assert torch.equal(_source_ids(small, plans[0], n_valid),
                       _source_ids(large, plans[1], n_valid))
    # and the sums on the real nodes keep their bits
    sums = []
    for a in (small, large):
        w = torch.ones(a.num_edges)
        r, Ji, Jj, rp, Jp = solver._linearize(a.poses, a)
        sums.append((solver._hessian_blocks(a, Ji, Jj, Jp, w)[:n],
                     solver._assemble_grad(a, Ji, Jj, Jp, r, rp)[:n]))
    for x, y in zip(*sums):
        assert torch.equal(x, y)


#: a scatter-add call: ``index_add_`` / ``index_add`` / ``scatter_add_`` /
#: ``scatter_add``, or ``index_put_`` / ``index_put`` with accumulate=True
_ADDS = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
_PUTS = {"index_put_", "index_put"}
_GUARDED = sorted(p.relative_to(ROOT) for p in
                  list((ROOT / "cslam_tpu_torch/pgo").glob("*.py"))
                  + [ROOT / "cslam_tpu_torch/ops/fiedler.py"])


def _scatter_adds(path):
    source = (ROOT / path).read_text()
    lines = source.splitlines()
    for node in ast.walk(ast.parse(source)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        accumulate = any(k.arg == "accumulate" and isinstance(
            k.value, ast.Constant) and k.value.value is True
            for k in node.keywords)
        if name in _ADDS or (name in _PUTS and accumulate):
            yield node.lineno, " ".join(lines[node.lineno - 1].split())


def test_no_unnamed_atomic_sum_on_the_pgo_and_mac_paths():
    """Every scatter-add left under ``pgo/`` and in ``ops/fiedler.py`` is
    named in PERF.md on a line that says it is exact or that it repeats:
    the file's path and the call's first line, whitespace collapsed."""
    perf = [" ".join(line.split()) for line in
            (ROOT / "PERF.md").read_text().splitlines()]
    unnamed = []
    for path in _GUARDED:
        for lineno, code in _scatter_adds(path):
            named = [line for line in perf
                     if str(path) in line and code in line]
            if not any(re.search(r"\b(exact|repeats)\b", line)
                       for line in named):
                unnamed.append(f"{path}:{lineno}: {code}")
    assert not unnamed, "\n".join(unnamed)


def test_coarse_alignment_every_separator_cut(monkeypatch):
    """F5: every separator TLS-cut (weight 0) at a hard mu, so only the
    crossing intra edges and the gauge prior hold the coarse system."""
    _, problem = _problem()
    t_local, t_sep = _to_port(problem).to_device_arrays(StackedMesh(3, "cpu"))
    M, seg_len = t_sep["coarse_segments"], t_sep["coarse_seg_len"]
    mu = 1e6
    systems = []
    step = td._coarse_step

    def recorded(Hmat, b):
        out = step(Hmat, b)
        systems.append((Hmat.clone(), b.clone(), out[0].clone()))
        return out
    monkeypatch.setattr(td, "_coarse_step", recorded)
    got, failures = td._coarse_alignment_counted(
        t_local.poses, t_sep, torch.zeros_like(t_sep["valid"]),
        t_sep["cross"], 3, M, seg_len,
        mu=torch.tensor(mu, dtype=torch.float32))
    assert int(failures) == 0
    assert len(systems) == 3
    for Hmat, b, port_step in systems:
        want = np.asarray(jnp.linalg.solve(jnp.asarray(Hmat.numpy()),
                                           jnp.asarray(b.numpy())))
        assert np.all(np.isfinite(want))
        np.testing.assert_allclose(port_step.numpy(), want, atol=STEP_ATOL)
    assert torch.isfinite(got).all()

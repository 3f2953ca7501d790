"""Parity of the port's chain + low-rank Fiedler tier (LOBPCG, the Woodbury
precompute, the two-stage eigensolve) with the JAX package.

Tolerances:
- LOBPCG on one SPD matrix from the same start block: eigenvalues within
  1e-4 relative, |cos| of each pair of eigenvectors above 0.999 (two
  float32 runs of the same algorithm; the small ``eigh`` calls differ in
  LAPACK path, so iterates drift in the last digits).
- Precompute: ``Tinv``, ``Y`` and ``G`` within 1e-3 of the reference's
  max|.|. The reference inverts ``T~`` by a float32 tridiagonal solve, the
  port by a float64 Cholesky; the gap is the reference's own rounding
  (the port is held to 1e-6 of a float64 inverse of the same matrix).
- Fiedler pair at P = 2048 from the reference's start block: lambda_2
  within 1e-3 relative of the reference, the Rayleigh quotient of the
  returned vector within 2% of scipy's sparse eigensolver.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import lobpcg_standard as jlobpcg

from cslam_tpu.ops import fiedler as jfd
from cslam_tpu_torch.ops import fiedler as tfd
from cslam_tpu_torch.ops.lobpcg import lobpcg_standard as tlobpcg
from torch_threads import one_torch_thread  # noqa: F401


def _reference_start_block(monkeypatch):
    """Make the port start LOBPCG from the JAX package's draw."""
    def start(P, block, active):
        X = jax.random.normal(jax.random.PRNGKey(7), (P, block), jnp.float32)
        return torch.from_numpy(np.array(X)).to(active.device) \
            * active[:, None]
    monkeypatch.setattr(tfd, "_start_block", start)


@pytest.mark.parametrize("m", [3, 40])
def test_lobpcg_matches_jax(m):
    rng = np.random.default_rng(0)
    n = 200
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    spectrum = np.concatenate([[10.0, 8.0, 6.0, 5.0],
                               np.linspace(0.1, 3.0, n - 4)])
    A = (Q * spectrum) @ Q.T
    A = (0.5 * (A + A.T)).astype(np.float32)
    X0 = rng.standard_normal((n, 4)).astype(np.float32)
    jt, jU, ji = jlobpcg(jnp.asarray(A), jnp.asarray(X0), m=m)
    At = torch.from_numpy(A)
    tt, tU, ti = tlobpcg(lambda x: At @ x, torch.from_numpy(X0), m=m)
    assert ti == int(ji)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4)
    cos = np.abs(np.sum(np.asarray(jU) * tU.numpy(), axis=0))
    assert cos.min() > 0.999
    if m == 40:   # converged: the top of the known spectrum
        np.testing.assert_allclose(tt.numpy(), spectrum[:4], rtol=1e-4)


def test_lobpcg_rejects_a_block_too_wide():
    with pytest.raises(ValueError, match="search dim"):
        tlobpcg(lambda x: x, torch.zeros((10, 2)))


def _multi_chain(R, n, P, m, seed):
    """R robot chains of n poses in a P tier and m random loop edges."""
    rng = np.random.default_rng(seed)
    p = R * n
    chain_w = np.zeros(P - 1, np.float32)
    for r in range(R):
        chain_w[r * n:(r + 1) * n - 1] = 1.0
    lr_i = rng.integers(0, p, m).astype(np.int32)
    lr_j = ((lr_i + rng.integers(5, p // 2, m)) % p).astype(np.int32)
    lr_w = rng.uniform(0.2, 1.0, m).astype(np.float32)
    active = (np.arange(P) < p).astype(np.float32)
    sigma = np.float32(2.0 * (2.0 + 2 * lr_w.sum()) + 1.0)
    return chain_w, lr_i, lr_j, lr_w, active, sigma


def _precompute_both(chain_w, lr_i, lr_j, active, sigma):
    jpre = jfd.chain_lowrank_precompute(
        jnp.asarray(chain_w), jnp.asarray(lr_i), jnp.asarray(lr_j),
        jnp.asarray(active), jnp.float32(sigma))
    tpre = tfd.chain_lowrank_precompute(
        torch.from_numpy(chain_w), torch.from_numpy(lr_i).long(),
        torch.from_numpy(lr_j).long(), torch.from_numpy(active),
        float(sigma))
    return jpre, tpre


def test_chain_lowrank_precompute_matches():
    chain_w, lr_i, lr_j, _, active, sigma = _multi_chain(2, 400, 1024, 40, 0)
    jpre, tpre = _precompute_both(chain_w, lr_i, lr_j, active, sigma)
    for key in ("Tinv", "U", "Y", "G"):
        ref = np.asarray(jpre[key])
        assert np.abs(tpre[key].numpy() - ref).max() <= 1e-3 * np.abs(
            ref).max(), key
    # T~ exactly as the reference sums it in float32, inverted in float64
    P = active.shape[0]
    diag = np.zeros(P, np.float32)
    diag[:-1] += chain_w
    diag[1:] += chain_w
    diag = diag + np.float32(1e-5) + sigma * (np.float32(1.0) - active)
    T = np.diag(diag.astype(np.float64))
    T[np.arange(P - 1), np.arange(1, P)] = -chain_w
    T[np.arange(1, P), np.arange(P - 1)] = -chain_w
    Tinv = np.linalg.inv(T)
    assert np.abs(tpre["Tinv"].numpy() - Tinv).max() <= 1e-6 * np.abs(
        Tinv).max()


def test_fiedler_pair_chain_lowrank_matches(monkeypatch):
    """The graph of tests/test_fiedler.py's scipy check: one 1500-pose
    chain in a 2048 tier plus 64 loop closures."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    rng = np.random.default_rng(0)
    p, P, m = 1500, 2048, 64
    chain_w = np.zeros(P - 1, np.float32)
    chain_w[:p - 1] = 1.0
    lr_i = rng.integers(0, p, m).astype(np.int32)
    lr_j = ((lr_i + rng.integers(5, p // 2, m)) % p).astype(np.int32)
    lr_w = rng.uniform(0.2, 1.0, m).astype(np.float32)
    active = (np.arange(P) < p).astype(np.float32)
    sigma = np.float32(2.0 * (2.0 + 2 * lr_w.sum()) + 1.0)
    jpre, tpre = _precompute_both(chain_w, lr_i, lr_j, active, sigma)
    jl, jv = jfd.fiedler_pair_chain_lowrank(jpre, jnp.asarray(lr_w),
                                            jnp.asarray(active))
    _reference_start_block(monkeypatch)
    tl, tv = tfd.fiedler_pair_chain_lowrank(tpre, torch.from_numpy(lr_w),
                                            torch.from_numpy(active))
    assert float(tl) == pytest.approx(float(jl), rel=1e-3)
    assert abs(float(np.asarray(jv) @ tv.numpy())) > 0.999

    rows = list(range(p - 1)) + lr_i.tolist()
    cols = list(range(1, p)) + lr_j.tolist()
    w = [1.0] * (p - 1) + lr_w.tolist()
    A = sp.coo_matrix((w + w, (rows + cols, cols + rows)), shape=(p, p))
    L = sp.diags(np.asarray(A.sum(1)).ravel()) - A
    vals = spla.eigsh(L.tocsc(), k=2, sigma=-1e-4, which="LM",
                      return_eigenvectors=False)
    v = tv.numpy()[:p].astype(np.float64)
    assert float(v @ (L @ v)) == pytest.approx(float(np.sort(vals)[1]),
                                               rel=0.02)


def test_start_block_is_seeded_and_masked():
    active = (torch.arange(64) < 40).float()
    X = tfd._start_block(64, 4, active)
    assert torch.equal(X, tfd._start_block(64, 4, active))
    assert X.shape == (64, 4) and bool((X[40:] == 0).all())
    assert bool((X[:40] != 0).all())

"""LOBPCG's small dense linear algebra and the Woodbury apply of MAC's
chain + low-rank tier, on the CPU.

- ``small_linalg.eigh_jacobi_ref``, the float64 torch mirror of the
  parallel-order Jacobi kernel (``csrc/small_eigh.cu``; the card holds the
  kernel to it bit for bit), against ``torch.linalg.eigh`` at n = 1 .. 16
  on seeded matrices with spread, clustered, repeated and widely ranged
  eigenvalues, under ``chip_smoke.py``'s limits for the kernel:
  eigenvalues within 16 float32 eps of max |lambda|, eigenvector overlaps
  >= 1 - 1e-4 where the gap to the neighbours is >= 1e-3 max |lambda|.
  Its NaN rules (a non-finite input, the sweep cap) and its order.
- ``small_linalg.svd_jacobi_ref``, the float64 torch mirror of the
  round-robin one-sided Jacobi SVD kernel (the card holds the kernel to it
  bit for bit), against ``torch.linalg.svd`` and the JAX package's
  ``jnp.linalg.svd`` at n = 1 .. 16 on seeded Gaussian, orthonormal-top,
  clustered and graded blocks: singular values within 16 float32 eps of
  the largest, the polar factor ``U Vh`` within 1e-5 where sigma_min >
  1e-3 sigma_max, ``U`` and ``Vh`` orthonormal within 1e-5. Rank-deficient
  blocks and the completion of a zero singular value's left vector, its
  NaN and sign rules, its pair order for odd n, and the port's
  ``lobpcg._extend_basis`` on the mirror against
  ``jax.experimental.sparse.linalg._extend_basis``.
- ``fiedler.woodbury_inverse`` (``Tinv x - Z (Z^T x)``, ``Z = Y L^-T``)
  against ``woodbury_inverse_ref`` (two triangular solves per apply), the
  JAX package's apply (``cho_solve`` on its own precompute) and a float64
  solve, at two robots in a 128 tier with 64 loop closures. Both forms
  subtract terms of the size of ``Tinv x`` (up to 1e4 times the result:
  each chain's constant mode has eigenvalue 1 / (1e-5 ridge x nodes)), so
  their rounding is counted in float32 eps of max |Tinv x|: 32 against
  each other and against float64 (about 5 measured). The JAX package
  inverts ``T~`` by a float32 tridiagonal solve, the port by a float64
  Cholesky (within 1e-3 of each other's max, tests/test_torch_fiedler.py),
  so against it the limit is 1e-5 of max |Tinv x| (7e-7 measured).
- A failed capacitance factorization still ends in a failed selection.

About 13 s on one worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import fiedler as jfd
from cslam_tpu_torch.ops import fiedler as tfd
from cslam_tpu_torch.ops import highest_precision
from cslam_tpu_torch.ops import small_linalg as sl
from cslam_tpu_torch.selection import mac as tmac
from cslam_tpu_torch.types import Edge
from torch_threads import one_torch_thread  # noqa: F401

_EPS = float(np.finfo(np.float32).eps)


def _spectra(n, rng):
    """Spread, clustered, repeated and widely ranged eigenvalues (the
    cases ``chip_smoke.py`` gives the kernel)."""
    return (rng.standard_normal(n) * 10.0,
            1.0 + 1e-4 * rng.standard_normal(n),
            np.repeat([3.0, -1.0], (n + 1) // 2)[:n],
            np.logspace(-6, 5, n))


def _symmetric(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return np.stack([((Q * lam) @ Q.T).astype(np.float32)
                     for lam in _spectra(n, rng)])


@pytest.mark.parametrize("n", range(1, 17))
def test_eigh_jacobi_ref_matches_library(n):
    A = torch.from_numpy(_symmetric(n, 100 + n))
    w, V, sweeps = sl.eigh_jacobi_ref(A, return_sweeps=True)
    wr, Vr = sl.eigh_descending_ref(A)
    assert w.dtype == V.dtype == torch.float32
    assert bool((sweeps < sl.MAX_SWEEPS).all())
    eye = torch.eye(n)
    for b in range(A.shape[0]):
        scale = float(wr[b].abs().max())
        assert float((w[b] - wr[b]).abs().max()) <= 16 * _EPS * scale
        assert bool((w[b][:-1] >= w[b][1:]).all())
        assert torch.allclose(V[b].T @ V[b], eye, atol=1e-5)
        # each vector's largest-magnitude entry positive
        idx = V[b].abs().argmax(dim=0)
        assert bool((V[b][idx, torch.arange(n)] > 0).all())
        for j in range(n):
            gaps = [abs(float(wr[b, j] - wr[b, i])) for i in (j - 1, j + 1)
                    if 0 <= i < n]
            if all(g >= 1e-3 * scale for g in gaps):
                assert abs(float(V[b][:, j] @ Vr[b][:, j])) >= 1 - 1e-4


def test_eigh_jacobi_ref_is_per_matrix_and_reads_the_lower_triangle():
    """A batch gives each matrix's own result bit for bit (the kernel runs
    one warp per matrix), and the upper triangle is never read."""
    A = torch.from_numpy(_symmetric(12, 7))
    w, V = sl.eigh_jacobi_ref(A)
    for b in range(A.shape[0]):
        wb, Vb = sl.eigh_jacobi_ref(A[b])
        assert torch.equal(wb, w[b]) and torch.equal(Vb, V[b])
    junk = A.clone()
    upper = torch.ones(12, 12, dtype=torch.bool).triu(1)
    junk[:, upper] = float("nan")
    w2, V2 = sl.eigh_jacobi_ref(junk)
    assert torch.equal(w2, w) and torch.equal(V2, V)


def test_eigh_jacobi_ref_nan_rules():
    """NaN outputs for a NaN or infinite input (in the lower triangle) and
    for a matrix stopped at the sweep cap; the other matrices of the batch
    are untouched."""
    A = torch.from_numpy(_symmetric(12, 8))
    w, V = sl.eigh_jacobi_ref(A)
    bad = A.clone()
    bad[1, 5, 2] = float("nan")
    bad[2, 11, 0] = float("inf")
    wb, Vb = sl.eigh_jacobi_ref(bad)
    for b in (1, 2):
        assert bool(wb[b].isnan().all()) and bool(Vb[b].isnan().all())
    for b in (0, 3):
        assert torch.equal(wb[b], w[b]) and torch.equal(Vb[b], V[b])
    # one sweep is not enough for a dense 12 x 12 matrix; a diagonal one
    # passes the test before its first rotation
    wc, Vc = sl.eigh_jacobi_ref(A[0], max_sweeps=1)
    assert bool(wc.isnan().all()) and bool(Vc.isnan().all())
    D = torch.diag(torch.tensor([3.0, -1.0, 2.0, 2.0]))
    wd, Vd = sl.eigh_jacobi_ref(D, max_sweeps=1)
    assert wd.tolist() == [3.0, 2.0, 2.0, -1.0]
    assert torch.equal(Vd, torch.eye(4)[:, [0, 2, 3, 1]])


def test_eigh_jacobi_ref_rounds_as_ieee_float64():
    """The mirror's square root is correctly rounded, as the card's
    (``torch.sqrt`` on the CPU may miss by one ulp), and a rotation's
    tangent equals the scalar formula bit for bit."""
    import math
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(1.0, 1e4, 4000),
                        np.exp(rng.uniform(-300, 300, 4000))])
    got = sl._sqrt(torch.from_numpy(x)).numpy()
    assert all(g == math.sqrt(v) for g, v in zip(got.tolist(), x.tolist()))
    app, aqq, apq = (rng.standard_normal(500) for _ in range(3))
    t = sl._rotation_tan(*(torch.from_numpy(v) for v in (app, aqq, apq)))
    for i in range(500):
        theta = (aqq[i] - app[i]) / (2.0 * apq[i])
        want = (0.5 / theta if abs(theta) > 1e150 else
                (1.0 if theta >= 0.0 else -1.0)
                / (abs(theta) + math.sqrt(theta * theta + 1.0)))
        assert float(t[i]) == want


@pytest.mark.parametrize("N", [2, 4, 6, 8, 10, 12, 14, 16])
def test_round_robin_order_meets_every_pair_once_per_sweep(N):
    steps = sl._round_robin(N)
    assert len(steps) == N - 1
    seen = set()
    for partner in steps:
        assert sorted(partner) == list(range(N))
        for j, q in enumerate(partner):
            assert q != j and partner[q] == j     # N/2 disjoint pairs
            seen.add((min(j, q), max(j, q)))
    assert len(seen) == N * (N - 1) // 2


# -- the SVD mirror -----------------------------------------------------------

def _svd_blocks(n, seed):
    """Gaussian, the top block of an orthonormal 200 x n basis (what
    ``_extend_basis`` decomposes), clustered and graded singular values."""
    rng = np.random.default_rng(seed)
    P, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    X, _ = np.linalg.qr(rng.standard_normal((200, n)))
    blocks = [rng.standard_normal((n, n)), X[:n],
              (P * (1.0 + 1e-4 * rng.standard_normal(n))) @ Q.T,
              (P * np.logspace(-6, 0, n)) @ Q.T]
    return np.stack(blocks).astype(np.float32)


@pytest.fixture(scope="module")
def svd_cases():
    """Each size's blocks and their mirror SVD, computed once."""
    out = {}
    for n in range(1, 17):
        A = torch.from_numpy(_svd_blocks(n, 200 + n))
        out[n] = (A, sl.svd_jacobi_ref(A, return_sweeps=True))
    return out


@pytest.mark.parametrize("n", range(1, 17))
def test_svd_jacobi_ref_matches_torch_and_jax(svd_cases, n):
    A, (U, S, Vh, sweeps) = svd_cases[n]
    assert U.dtype == S.dtype == Vh.dtype == torch.float32
    assert bool((sweeps < sl.MAX_SWEEPS).all())
    Ur, Sr, Vhr = torch.linalg.svd(A)
    ju, js, jvh = (torch.from_numpy(np.array(x))
                   for x in jnp.linalg.svd(jnp.asarray(A.numpy())))
    eye = torch.eye(n)
    for b in range(A.shape[0]):
        scale = float(Sr[b].max())
        assert bool((S[b][:-1] >= S[b][1:]).all())
        for u, s, vh in ((Ur[b], Sr[b], Vhr[b]), (ju[b], js[b], jvh[b])):
            assert float((S[b] - s).abs().max()) <= 16 * _EPS * scale
            if float(s.min()) > 1e-3 * scale:
                assert float((U[b] @ Vh[b] - u @ vh).abs().max()) <= 1e-5
        assert float((U[b].T @ U[b] - eye).abs().max()) <= 1e-5
        assert float((Vh[b] @ Vh[b].T - eye).abs().max()) <= 1e-5
        # each row of Vh has its largest-magnitude entry positive
        idx = Vh[b].abs().argmax(dim=1)
        assert bool((Vh[b][torch.arange(n), idx] > 0).all())


def test_svd_jacobi_ref_rank_deficient_blocks_and_completion():
    """A zero column, a zero block and two equal columns (rotated by
    exactly 45 degrees, t = 1, so one of them becomes exactly zero) give
    exact zero singular values, whose left vectors the completion makes
    orthonormal (U stays orthogonal, A = U diag(S) Vh); a float32 rank-1
    block gives tiny nonzero ones. The completion is deterministic: unit
    vectors in order, Gram-Schmidt against the earlier columns."""
    rng = np.random.default_rng(4)
    zero_col = rng.standard_normal((4, 4)).astype(np.float32)
    zero_col[:, 3] = 0.0
    twin = rng.standard_normal((6, 6)).astype(np.float32)
    twin[:, 4] = twin[:, 1]
    rank1 = np.outer(rng.standard_normal(5), rng.standard_normal(5))
    for a, zeros in ((zero_col, 1), (np.zeros((3, 3), np.float32), 3),
                     (rank1.astype(np.float32), 0), (twin, 1)):
        A = torch.from_numpy(a)
        U, S, Vh = sl.svd_jacobi_ref(A)
        n = a.shape[0]
        eye = torch.eye(n)
        assert int((S == 0.0).sum()) == zeros
        assert float((U.T @ U - eye).abs().max()) <= 1e-5
        assert float((Vh @ Vh.T - eye).abs().max()) <= 1e-5
        assert float(((U * S) @ Vh - A).abs().max()) <= 1e-5 * max(
            1.0, float(S.max()))
        Sr = torch.linalg.svdvals(A)
        assert float((S - Sr).abs().max()) <= 16 * _EPS * max(
            float(Sr.max()), 1e-30)
    U0, S0, Vh0 = sl.svd_jacobi_ref(torch.zeros(3, 3))
    assert torch.equal(U0, torch.eye(3)) and torch.equal(Vh0, torch.eye(3))
    # the zero column's left vector: e_0 with the other three projected
    # out, normalized (its norm is well above 0.5 here); the zero column
    # never rotates, so its right vector is +e_3
    U, S, Vh = sl.svd_jacobi_ref(torch.from_numpy(zero_col))
    assert torch.equal(Vh[3], torch.eye(4)[3])
    rest = U[:, :3].double()
    e0 = torch.eye(4, dtype=torch.float64)[:, 0]
    want = e0 - rest @ (rest.T @ e0)
    assert float(want.norm()) > 0.5
    assert float((U[:, 3].double() - want / want.norm()).abs().max()) <= 1e-6


def test_svd_jacobi_ref_nan_and_sign_rules():
    """NaN outputs for a NaN or infinite input and at the sweep cap, the
    batch's other matrices untouched (each matrix is one warp's); the
    sign rule on a diagonal block, which needs no rotation."""
    A = torch.from_numpy(_svd_blocks(12, 9))
    U, S, Vh = sl.svd_jacobi_ref(A)
    bad = A.clone()
    bad[1, 5, 2] = float("nan")
    bad[2, 0, 11] = float("inf")
    Ub, Sb, Vhb = sl.svd_jacobi_ref(bad)
    for b in (1, 2):
        assert all(bool(x[b].isnan().all()) for x in (Ub, Sb, Vhb))
    for b in (0, 3):
        assert torch.equal(Ub[b], U[b]) and torch.equal(Sb[b], S[b])
        assert torch.equal(Vhb[b], Vh[b])
        one = sl.svd_jacobi_ref(A[b])
        assert all(torch.equal(x, y[b]) for x, y in zip(one, (U, S, Vh)))
    # a dense 12 x 12 block still rotates in its first sweep
    Uc, Sc, Vhc = sl.svd_jacobi_ref(A[0], max_sweeps=1)
    assert all(bool(x.isnan().all()) for x in (Uc, Sc, Vhc))
    D = torch.diag(torch.tensor([3.0, -1.0, 2.0, 2.0]))
    Ud, Sd, Vhd, sw = sl.svd_jacobi_ref(D, max_sweeps=1, return_sweeps=True)
    assert int(sw) == 1 and Sd.tolist() == [3.0, 2.0, 2.0, 1.0]
    perm = torch.eye(4)[[0, 2, 3, 1]]
    assert torch.equal(Vhd, perm)
    assert torch.equal(Ud, perm.T * torch.tensor([1.0, 1.0, 1.0, -1.0]))


@pytest.mark.parametrize("n", [1, 3, 5, 7, 9, 11, 13, 15])
def test_round_robin_order_meets_every_pair_once_for_odd_n(n):
    """Odd n runs the order of N = n + 1 with a dummy index n: each sweep
    meets every pair of real columns once, and each real column meets the
    dummy (its rest step) once."""
    steps = sl._round_robin(n + 1)
    real, rest = set(), []
    for partner in steps:
        for j, q in enumerate(partner[:n]):
            if q == n:
                rest.append(j)
            else:
                real.add((min(j, q), max(j, q)))
    assert len(real) == n * (n - 1) // 2
    assert sorted(rest) == list(range(n))


def test_extend_basis_on_the_mirror_matches_jax(monkeypatch):
    """The port's ``_extend_basis`` with ``small_linalg.svd`` routed to the
    kernel's mirror against ``jax.experimental.sparse.linalg._extend_basis``
    (``jnp.linalg.svd``) on an orthonormal 200 x 4 block: within 1e-5, and
    ``[X, h]`` orthonormal."""
    from jax.experimental.sparse import linalg as jsl

    from cslam_tpu_torch.ops import lobpcg
    rng = np.random.default_rng(12)
    X = np.linalg.qr(rng.standard_normal((200, 4)))[0].astype(np.float32)
    monkeypatch.setattr(sl, "svd", sl.svd_jacobi_ref)
    h = lobpcg._extend_basis(torch.from_numpy(X), 4)
    want = torch.from_numpy(np.array(jsl._extend_basis(jnp.asarray(X), 4)))
    assert float((h - want).abs().max()) <= 1e-5
    basis = torch.cat([torch.from_numpy(X), h], dim=1)
    assert float((basis.T @ basis - torch.eye(8)).abs().max()) <= 1e-5


# -- the Woodbury apply -------------------------------------------------------

def _two_robots(P=128, n=60, m=64, seed=0):
    rng = np.random.default_rng(seed)
    p = 2 * n
    chain_w = np.zeros(P - 1, np.float32)
    for r in range(2):
        chain_w[r * n:(r + 1) * n - 1] = 1.0
    lr_i = rng.integers(0, p, m).astype(np.int32)
    lr_j = ((lr_i + rng.integers(5, p // 2, m)) % p).astype(np.int32)
    lr_w = rng.uniform(0.2, 1.0, m).astype(np.float32)
    lr_w[::4] = 0.0                       # absent edges: C^-1 = 1e12
    active = (np.arange(P) < p).astype(np.float32)
    sigma = np.float32(2.0 * (2.0 + 2 * lr_w.sum()) + 1.0)
    x = rng.standard_normal((P, 12)).astype(np.float32)
    return chain_w, lr_i, lr_j, lr_w, active, sigma, x


@pytest.fixture(scope="module")
def woodbury():
    chain_w, lr_i, lr_j, lr_w, active, sigma, x = _two_robots()
    pre = tfd.chain_lowrank_precompute(
        torch.from_numpy(chain_w), torch.from_numpy(lr_i).long(),
        torch.from_numpy(lr_j).long(), torch.from_numpy(active),
        float(sigma))
    w = torch.from_numpy(lr_w)
    chol = tfd.woodbury_factor(pre["G"], w, w.new_full((1,), 1.0 / sigma))
    jpre = jfd.chain_lowrank_precompute(
        jnp.asarray(chain_w), jnp.asarray(lr_i), jnp.asarray(lr_j),
        jnp.asarray(active), jnp.float32(sigma))
    return {"pre": pre, "chol": chol, "lr_w": lr_w, "sigma": sigma,
            "x": torch.from_numpy(x), "jpre": jpre}


def _jax_apply(jpre, lr_w, sigma, x):
    """The JAX package's apply (``cslam_tpu/ops/fiedler.py``'s
    ``b_inverse``), rebuilt on its own precompute."""
    lr_w = jnp.asarray(lr_w)
    cinv = jnp.where(lr_w > 0, 1.0 / jnp.maximum(lr_w, 1e-30), 1e12)
    cinv = jnp.concatenate([cinv, jnp.array([1.0]) / jnp.float32(sigma)])
    chol = jax.scipy.linalg.cho_factor(jpre["G"] + jnp.diag(cinv),
                                       lower=True)
    with jax.default_matmul_precision("highest"):
        t = jpre["Tinv"] @ jnp.asarray(x)
        out = t - jpre["Y"] @ jax.scipy.linalg.cho_solve(
            chol, jpre["U"].T @ t)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("k", [1, 4, 12])
def test_woodbury_apply_matches_plain_jax_and_float64(woodbury, k):
    pre, chol = woodbury["pre"], woodbury["chol"]
    x = woodbury["x"][:, :k]
    args = (pre["Tinv"], pre["U"], pre["Y"], chol)
    new = highest_precision(lambda: tfd.woodbury_inverse(*args)(x))()
    ref = highest_precision(lambda: tfd.woodbury_inverse_ref(*args)(x))()
    jx = _jax_apply(woodbury["jpre"], woodbury["lr_w"], woodbury["sigma"],
                    x.numpy())
    # float64 from the same Tinv and U
    Ti, U = pre["Tinv"].double(), pre["U"].double()
    lr_w = torch.from_numpy(woodbury["lr_w"]).double()
    cinv = torch.cat([torch.where(lr_w > 0, 1.0 / lr_w.clamp(min=1e-30),
                                  torch.full_like(lr_w, 1e12)),
                      torch.tensor([1.0 / float(woodbury["sigma"])],
                                   dtype=torch.float64)])
    t64 = Ti @ x.double()
    exact = t64 - Ti @ U @ torch.linalg.solve(U.T @ Ti @ U + torch.diag(cinv),
                                              U.T @ t64)
    scale = float(t64.abs().max())
    assert float((new - ref).abs().max()) <= 32 * _EPS * scale
    assert float((new.double() - exact).abs().max()) <= 32 * _EPS * scale
    assert float((ref.double() - exact).abs().max()) <= 32 * _EPS * scale
    assert float((new - jx).abs().max()) <= 1e-5 * scale


def test_woodbury_z_is_formed_once_and_carries_nan(woodbury):
    """``woodbury_inverse`` is ``woodbury_apply`` on ``woodbury_z``, bit for
    bit (what MAC's programs run, ``Z`` in the loop state); a NaN factor
    gives a NaN ``Z`` and NaN applies, with no exception."""
    pre, chol, x = woodbury["pre"], woodbury["chol"], woodbury["x"]
    Z = tfd.woodbury_z(pre["Y"], chol)
    assert Z.shape == pre["Y"].shape
    assert torch.equal(tfd.woodbury_apply(pre["Tinv"], Z)(x),
                       tfd.woodbury_inverse(pre["Tinv"], pre["U"], pre["Y"],
                                            chol)(x))
    # Z Z^T is the correction Y S^-1 Y^T
    S = chol.double() @ chol.double().T
    Y = pre["Y"].double()
    corr = Y @ torch.linalg.solve(S, Y.T)
    zz = Z.double() @ Z.double().T
    assert float((zz - corr).abs().max()) <= 1e-4 * float(corr.abs().max())
    nan = tfd.woodbury_z(pre["Y"], torch.full_like(chol, float("nan")))
    assert bool(nan.isnan().all())
    assert bool(tfd.woodbury_apply(pre["Tinv"], nan)(x).isnan().all())


def test_failed_capacitance_factorization_fails_the_selection(monkeypatch):
    """A Cholesky that reports failure (``info`` != 0) gives a NaN factor,
    a NaN ``Z`` and NaN LOBPCG states inside the loop, with no exception
    and no host read there; ``fw_subset_finish`` raises
    ``np.linalg.LinAlgError`` at the loop's one read."""
    per = 190
    fixed = [Edge(r * per + i, r * per + i + 1, 1.0)
             for r in range(4) for i in range(per - 1)]
    fixed += [Edge(r * per + per - 1, (r + 1) * per + 3, 0.8)
              for r in range(3)]
    rng = np.random.default_rng(3)
    cands = []
    while len(cands) < 40:
        i, j = (int(v) for v in rng.integers(0, 4 * per, 2))
        if abs(i - j) > 1:
            cands.append(Edge(i, j, float(rng.uniform(0.1, 1.0))))
    m = tmac.MAC(fixed, cands, 4 * per, device="cpu",
                 **tmac.mac_kwargs_from_params({
                     "frontend.mac_e_floor": 256,
                     "frontend.mac_mf_floor": 64,
                     "frontend.mac_p_floor": 1024}))
    assert not m._dense
    sel, _, _ = m.fw_subset(np.zeros(m._m), 3, max_iters=2)
    assert int(sel.sum()) == 3
    cholesky_ex = torch.linalg.cholesky_ex

    def failed(S, *args, **kwargs):
        L, info = cholesky_ex(S, *args, **kwargs)
        return L, torch.ones_like(info)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", failed)
    pending = m.fw_subset_dispatch(np.zeros(m._m), 3, max_iters=2)
    with pytest.raises(np.linalg.LinAlgError):
        m.fw_subset_finish(pending)

"""Fiedler (algebraic-connectivity) eigensolvers.

Counterpart of ``cslam_tpu/ops/fiedler.py`` (which replaces the reference's
networkx ``tracemin_lu``, ``cslam/mac/mac.py:35-59``), with its two tiers:

1. **Dense tier** (small graphs): one symmetric eigendecomposition
   (``torch.linalg.eigh``) over a padded Laplacian with a deflation shift.
2. **Chain + low-rank tier** (large graphs): odometry chains (tridiagonal)
   plus sparse loop closures (low rank), inverted exactly by Woodbury,

       B^-1 x = t - Y S^-1 U^T t   (t = T~^-1 x, Y = T~^-1 U,
                                    S = C^-1 + U^T Y),

   and LOBPCG (:mod:`cslam_tpu_torch.ops.lobpcg`) on ``B^-1``, whose
   leading eigenvalues are well separated where the Laplacian's smallest
   are clustered. With ``Tinv`` symmetric, ``B^-1 x = Tinv x - Z (Z^T x)``
   for ``Z = Y L^-T`` (``L`` the Cholesky factor of ``S``), formed once
   per evaluation; an apply is then three products.

Padding + deflation: graphs are embedded in a tier size ``P`` with an
``active`` mask; padded nodes get a large diagonal shift ``sigma`` and the
trivial constant eigenvector is deflated by ``sigma * u u^T`` with
``u = active/sqrt(p)`` (valid since ``L @ 1 = 0``). With
``sigma > lambda_max(L)`` the smallest eigenvalue of the shifted matrix is
exactly ``lambda_2(L)``; a disconnected graph gives ``lambda_2 = 0``.
"""
from __future__ import annotations

import torch

from cslam_tpu_torch.ops import highest_precision
from cslam_tpu_torch.ops.lobpcg import lobpcg_standard

_EPS_SHIFT = 1e-5   # epsilon ridge on the whole spectrum (subtracted exactly)
_BIG_CINV = 1e12    # 1/weight stand-in for absent (zero-weight) edges
RESID_TOL = 1e-4    # the second LOBPCG stage's residual gate


def laplacian_from_edges(idx_i: torch.Tensor, idx_j: torch.Tensor,
                         weights: torch.Tensor, size: int) -> torch.Tensor:
    """Dense weighted graph Laplacian from (padded) edge lists.

    Padding edges must carry weight 0 (they then contribute nothing).
    """
    L = torch.zeros((size, size), dtype=torch.float32, device=weights.device)
    w = weights.float()
    L.index_put_((idx_i, idx_i), w, accumulate=True)
    L.index_put_((idx_j, idx_j), w, accumulate=True)
    L.index_put_((idx_i, idx_j), -w, accumulate=True)
    L.index_put_((idx_j, idx_i), -w, accumulate=True)
    return L


def rayleigh_quotient(idx_i: torch.Tensor, idx_j: torch.Tensor,
                      weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x^T L x computed straight from edge lists: sum_e w_e (v_i - v_j)^2."""
    diff = v[idx_i] - v[idx_j]
    return torch.sum(weights * diff * diff)


def deflated_laplacian(L: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The matrix whose smallest eigenpair is (lambda_2, Fiedler vector):
    ``L`` with ``sigma`` on the padded nodes' diagonal and the constant
    mode deflated by ``sigma u u^T``, symmetrized."""
    active = active.float()
    p = torch.clamp(torch.sum(active), min=1.0)
    sigma = 2.0 * torch.max(torch.diagonal(L)) + 1.0
    u = active / torch.sqrt(p)
    B = (L
         + sigma * torch.diag(1.0 - active)
         + sigma * torch.outer(u, u))
    return 0.5 * (B + B.T)  # enforce symmetry for eigh stability


@highest_precision
def fiedler_pair(L: torch.Tensor, active: torch.Tensor):
    """(lambda_2, Fiedler vector) via dense eigh on the deflated Laplacian.

    Args:
        L: ``[P, P]`` dense Laplacian (rows/cols of inactive nodes all zero).
        active: ``[P]`` float32 0/1 mask of real nodes.
    """
    eigvals, eigvecs = torch.linalg.eigh(deflated_laplacian(L, active))
    return eigvals[0], eigvecs[:, 0] * active.float()


def algebraic_connectivity(idx_i: torch.Tensor, idx_j: torch.Tensor,
                           weights: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Convenience: lambda_2 of the graph given by weighted edge lists."""
    L = laplacian_from_edges(idx_i, idx_j, weights, active.shape[0])
    return fiedler_pair(L, active)[0]


# ---------------------------------------------------------------------------
# Chain + low-rank tier (Woodbury shift-invert)
# ---------------------------------------------------------------------------


@highest_precision
def chain_lowrank_precompute(chain_w: torch.Tensor, lr_i: torch.Tensor,
                             lr_j: torch.Tensor, active: torch.Tensor,
                             sigma: float) -> dict:
    """Weight-independent factor setup for the Woodbury solver.

    Args:
        chain_w: ``[P-1]`` weights of the consecutive-node (odometry) edges,
            0 where no chain edge exists (robot boundaries, padding).
        lr_i, lr_j: ``[M]`` endpoints of the non-chain (loop-closure) edges;
            padding entries point at node 0.
        active: ``[P]`` 0/1 mask of real nodes.
        sigma: spectral shift (> lambda_max) for padding and deflation.

    Returns the dense ``Tinv = T~^-1`` ``[P, P]``, the column block ``U``
    ``[P, M+1]`` (edge incidences and the deflation vector), ``Y = Tinv U``
    and ``G = U^T Y``; they stay fixed while the Frank-Wolfe loop changes
    the candidate weights.

    ``T~`` (chain Laplacian + 1e-5 I + sigma on padded nodes) is inverted
    by a float64 Cholesky: each robot's chain keeps an eigenvalue near 1e-5
    against a largest near 4, a condition number of 1e5-1e6 that a float32
    factorization would pay in digits. The JAX package takes the same
    inverse from a tridiagonal solve against the identity, which torch
    lacks. The inverse is symmetrized in float32 as there.
    """
    P = active.shape[0]
    dev = active.device
    # the diagonal is summed in float32 as the JAX package sums it (the
    # 1e-5 ridge rounds differently per node, and the chains' constant
    # modes, 1 / (ridge * nodes), feel it); the factorization is float64
    cw = chain_w.float()
    diag = torch.zeros(P, dtype=torch.float32, device=dev)
    diag[:-1] += cw
    diag[1:] += cw
    diag = diag + _EPS_SHIFT + torch.tensor(
        sigma, dtype=torch.float32, device=dev) * (1.0 - active.float())
    T = torch.diag(diag.double())
    off = torch.arange(P - 1, device=dev)
    T[off, off + 1] = -cw.double()
    T[off + 1, off] = -cw.double()
    Tinv = torch.cholesky_inverse(torch.linalg.cholesky(T)).float()
    Tinv = 0.5 * (Tinv + Tinv.T)

    p = torch.clamp(torch.sum(active), min=1.0)
    M = lr_i.shape[0]
    cols = torch.arange(M, device=dev)
    U = torch.zeros((P, M + 1), dtype=torch.float32, device=dev)
    U.index_put_((lr_i, cols), torch.ones(M, device=dev), accumulate=True)
    U.index_put_((lr_j, cols), -torch.ones(M, device=dev), accumulate=True)
    U[:, M] = active.float() / torch.sqrt(p)
    Y = Tinv @ U
    G = U.T @ Y
    return {"Tinv": Tinv, "U": U, "Y": Y, "G": G, "sigma": float(sigma)}


#: the unmasked start draw per (P, block, device), made once
_START_DRAWS: dict = {}


def _start_block(P: int, block: int, active: torch.Tensor) -> torch.Tensor:
    """The deterministic LOBPCG start block: standard normals from a
    generator seeded with 7, drawn on the CPU (so every device starts from
    the same block) and masked to the active nodes. The draw is copied to
    each device once and kept there. The JAX package draws
    ``jax.random.normal(PRNGKey(7), (P, block))``, which torch cannot
    reproduce; parity tests substitute that draw here."""
    key = (P, block, str(active.device))
    X = _START_DRAWS.get(key)
    if X is None:
        gen = torch.Generator().manual_seed(7)
        X = _START_DRAWS[key] = torch.randn(
            (P, block), generator=gen, dtype=torch.float32).to(active.device)
    return X * active[:, None]


def woodbury_factor(G: torch.Tensor, lr_w: torch.Tensor,
                    cinv_sigma: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of the capacitance ``S = G + diag(C^-1)``
    for the low-rank weights ``lr_w`` (``cinv_sigma``: ``[1]``, the
    deflation column's ``1 / sigma``). A failed factorization yields NaN,
    as the JAX package's ``cho_factor`` does, without a host read."""
    lr_w = lr_w.float()
    cinv = torch.where(lr_w > 0, 1.0 / torch.clamp(lr_w, min=1e-30),
                       torch.full_like(lr_w, _BIG_CINV))
    S = G + torch.diag(torch.cat([cinv, cinv_sigma]))
    chol, info = torch.linalg.cholesky_ex(S)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def woodbury_z(Y: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """``Z = Y L^-T`` for :func:`woodbury_factor`'s ``chol = L``: one
    triangular solve with ``P`` right-hand sides per evaluation (cuBLAS's
    ``trsm`` on the card, at its rate, no host read). Since ``Tinv`` is
    exactly symmetric and ``Y = Tinv U``, ``Y S^-1 U^T Tinv = Z Z^T``, so
    every apply after this is plain products. A NaN factor (a failed
    factorization) gives a NaN ``Z``."""
    return torch.linalg.solve_triangular(chol.T, Y, upper=True, left=False)


def woodbury_apply(Tinv: torch.Tensor, Z: torch.Tensor):
    """``x -> B^-1 x = Tinv x - Z (Z^T x)`` (``Z`` from :func:`woodbury_z`):
    three products that read ``Tinv`` once and ``Z`` twice, with no
    sequential pass. A LOBPCG stage of ``i`` iterations applies it twice
    per iteration, so its least time on the card is its bytes, ``2 i (P^2
    + 2 P (M + 1)) x 4`` at 3.35 TB/s."""
    def apply(x):
        return Tinv @ x - Z @ (Z.T @ x)
    return apply


def woodbury_inverse(Tinv: torch.Tensor, U: torch.Tensor, Y: torch.Tensor,
                     chol: torch.Tensor):
    """``x -> B^-1 x`` in the form every caller runs: :func:`woodbury_z`
    once, then :func:`woodbury_apply`. ``U`` is not read (the arguments are
    :func:`woodbury_inverse_ref`'s)."""
    return woodbury_apply(Tinv, woodbury_z(Y, chol))


def woodbury_inverse_ref(Tinv: torch.Tensor, U: torch.Tensor,
                         Y: torch.Tensor, chol: torch.Tensor):
    """Plain version, for the tests and ``chip_smoke.py`` only: ``x -> t -
    Y S^-1 U^T t``, ``t = Tinv x``, ``S^-1`` by two triangular solves
    against ``chol`` per apply, as the JAX package's ``cho_solve``."""
    def apply(x):
        t = Tinv @ x
        z = torch.linalg.solve_triangular(chol, U.T @ t, upper=False)
        return t - Y @ torch.linalg.solve_triangular(chol.T, z, upper=True)
    return apply


def residual_ratio(b_inverse, theta: torch.Tensor,
                   V: torch.Tensor) -> torch.Tensor:
    """The leading Ritz pair's relative residual ``||B^-1 v - theta v|| /
    theta`` (one operator apply): the gate of the second LOBPCG stage."""
    resid = torch.linalg.norm(b_inverse(V[:, :1]) - theta[0] * V[:, :1])
    return resid / torch.clamp(theta[0], min=1e-30)


def fiedler_from_ritz(theta: torch.Tensor, V: torch.Tensor,
                      active: torch.Tensor):
    """(lambda_2, unit Fiedler vector) from the leading Ritz pair of
    ``B^-1``; lambda_2 shift-corrected from the Ritz value."""
    v = V[:, 0] * active
    v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    lam2 = torch.clamp(1.0 / torch.clamp(theta[0], min=1e-30) - _EPS_SHIFT,
                       min=0.0)
    return lam2, v


@highest_precision
def fiedler_pair_chain_lowrank(pre: dict, lr_w: torch.Tensor,
                               active: torch.Tensor,
                               lobpcg_iters: int = 48, block: int = 4,
                               short_iters: int = 14,
                               resid_tol: float = RESID_TOL,
                               X0: torch.Tensor | None = None,
                               return_block: bool = False):
    """(lambda_2, Fiedler vector) via LOBPCG on the Woodbury-inverted
    operator.

    Two stages: ``short_iters`` iterations, then one extra apply measures
    the leading Ritz pair's relative residual ``||B^-1 v - theta v|| /
    theta``; only above ``resid_tol`` does LOBPCG continue from that block
    for the rest of the ``lobpcg_iters`` budget (``short_iters >=
    lobpcg_iters`` runs one stage). ``X0`` is an optional ``[P, block]``
    warm start (the Frank-Wolfe loop's carried Ritz block); without it the
    start is :func:`_start_block`. ``return_block`` also returns the Ritz
    block. lambda_2 is returned shift-corrected from the leading Ritz
    value; MAC takes its objective from a Rayleigh quotient over the edges
    instead.

    This is the eager form (its stops read on the host); MAC's Frank-Wolfe
    loop runs the same stages as captured step programs
    (``selection/mac.py``).
    """
    P = active.shape[0]
    chol = woodbury_factor(pre["G"], lr_w, lr_w.new_full(
        (1,), 1.0 / pre["sigma"]))
    b_inverse = woodbury_inverse(pre["Tinv"], pre["U"], pre["Y"], chol)
    if X0 is None:
        X0 = _start_block(P, block, active)
    if short_iters >= lobpcg_iters:
        theta, V, _ = lobpcg_standard(b_inverse, X0, m=lobpcg_iters)
    else:
        theta, V, _ = lobpcg_standard(b_inverse, X0, m=short_iters)
        if bool(residual_ratio(b_inverse, theta, V) > resid_tol):
            theta, V, _ = lobpcg_standard(b_inverse, V,
                                          m=lobpcg_iters - short_iters)
    lam2, v = fiedler_from_ritz(theta, V, active)
    if return_block:
        return lam2, v, V
    return lam2, v

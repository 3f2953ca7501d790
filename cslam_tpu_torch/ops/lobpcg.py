"""LOBPCG for the top-k eigenpairs of a symmetric operator.

A translation to PyTorch of ``jax.experimental.sparse.linalg.lobpcg_standard``
(JAX 0.9.0, ``jax/experimental/sparse/linalg.py``; Copyright 2022 The JAX
Authors, Apache License 2.0), which the JAX package's Woodbury MAC tier
calls. The port may not import JAX, so it carries its own copy with the
same contract and the same arithmetic:

- an always-orthonormal block basis ``[X, P, R]`` (SVQB twice, "twice is
  enough" projection), Rayleigh-Ritz on it each iteration;
- the search directions ``P`` from a QR of the Ritz coefficients;
- the JAX convergence test: an eigenpair is converged when its residual norm
  is below ``tol * 10 * n * (|A v| + theta)``, ``tol`` the dtype's epsilon
  by default; all ``k`` converged ends the loop.

The JAX ``lax.while_loop`` becomes step functions over a state dict:
:func:`lobpcg_init` (the state before the loop) and :func:`lobpcg_step`
(one iteration, every update a ``torch.where`` on the state's ``active``
flag, so a step run after the stop changes no bit). MAC's Frank-Wolfe loop
runs them as captured step programs (``selection/mac.py``);
:func:`lobpcg_standard` drives them eagerly, reading ``active`` on the host
once per iteration. The small eigensolves and the SVD go through
:mod:`cslam_tpu_torch.ops.small_linalg` (hand-written kernels on the card,
no host read); the ``2k x k`` QR is ``torch.linalg.qr``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from cslam_tpu_torch.ops import small_linalg


def _check_shape(n: int, k: int) -> None:
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")


def lobpcg_init(A: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor,
                m, enabled: Optional[torch.Tensor] = None) -> dict:
    """The loop state before the first iteration: ``X`` (``[n, k]``, ``0 <
    5k < n``, numerically independent columns) orthonormalized, ``P``,
    ``R``, ``theta`` (``[1, k]``), the iteration count ``i``, the converged
    count ``conv``, the budget ``m`` (an int or a 0-d tensor) and
    ``active``, which ``enabled`` (a 0-d bool tensor) may clear."""
    n, k = X.shape
    _check_shape(n, k)
    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    m = (m.to(torch.int32) if isinstance(m, torch.Tensor)
         else torch.full((), m, dtype=torch.int32, device=X.device))
    active = m > 0
    if enabled is not None:
        active = active & enabled
    zero = torch.zeros((), dtype=torch.int32, device=X.device)
    return {"X": X, "P": P, "R": R, "theta": theta, "i": zero,
            "conv": zero.clone(), "m": m, "active": active}


def lobpcg_step(A: Callable[[torch.Tensor], torch.Tensor], st: dict,
                tol: Optional[float] = None) -> dict:
    """One LOBPCG iteration of the state ``st`` (see :func:`lobpcg_init`),
    returned as a new state; where ``st["active"]`` is clear the state comes
    back unchanged."""
    X, P, R, theta = st["X"], st["P"], st["R"], st["theta"]
    n, k = X.shape
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    # X, P, R kept orthonormal; R and P columns may be 0 after basis
    # truncation, X columns never
    R = _project_out(torch.cat((X, P), dim=1), R)
    XPR = torch.cat((X, P, R), dim=1)
    th, Q = _rayleigh_ritz_orth(A, XPR)

    B = Q[:, :k]
    B = B / torch.linalg.norm(B, dim=0, keepdim=True)
    Xn = XPR @ B
    Xn = Xn / torch.linalg.norm(Xn, dim=0, keepdim=True)

    # span(X, P) == span(X, previous X): orthogonalize (0, Q[k:, :k])
    # against Q[:, :k] in the standard basis before mapping with XPR
    q, _ = torch.linalg.qr(Q[:k, k:].T)
    Pn = XPR @ (Q[:, k:] @ q)
    normP = torch.linalg.norm(Pn, dim=0, keepdim=True)
    Pn = Pn / torch.where(normP == 0, torch.ones_like(normP), normP)

    AX = A(Xn)
    Rn = AX - th[None, :k] * Xn
    resid_norms = torch.linalg.norm(Rn, dim=0)
    reltol = (torch.linalg.norm(AX, dim=0) + th[:k]) * n * 10
    conv = torch.sum(resid_norms < tol * reltol).to(torch.int32)

    act = st["active"]
    i = st["i"] + act.to(torch.int32)
    conv = torch.where(act, conv, st["conv"])
    return {"X": torch.where(act, Xn, X), "P": torch.where(act, Pn, P),
            "R": torch.where(act, Rn, st["R"]),
            "theta": torch.where(act, th[None, :k], theta),
            "i": i, "conv": conv, "m": st["m"],
            "active": act & (i < st["m"]) & (conv < k)}


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor],
                    X: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None):
    """Top-k eigenpairs of the symmetric operator ``A`` (a callable on
    ``[n, j]`` blocks) from the start block ``X`` (``[n, k]``, ``0 < 5k <
    n``, numerically independent columns).

    Returns ``(theta [k], U [n, k], iterations)``, eigenvalues descending.
    At most ``m`` iterations, the stop read on the host after each. Callers
    that need float32 products run it under
    :func:`cslam_tpu_torch.ops.highest_precision` (the JAX code uses
    ``Precision.HIGHEST``).
    """
    st = lobpcg_init(A, X, m)
    while bool(st["active"]):
        st = lobpcg_step(A, st, tol)
    return st["theta"][0, :], st["X"], int(st["i"])


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """Truncated orthonormal basis of ``X`` by SVQB (an eigenbasis of
    ``X^T X``); columns of a rank-deficient direction come back zero."""
    norms = torch.linalg.norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = small_linalg.eigh_descending(inner)
    # an eigenvalue below max * eps marks a degenerate direction
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    # tau == 0 when X was all zeros
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** -0.5
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, torch.ones_like(norms))


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The component of ``U`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``; nonzero columns orthonormal. Ends on a subtraction
    and zeroes any column whose norm fell below 0.99, so ``[basis, U]``
    stays zero-or-orthogonal near convergence."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S: torch.Tensor):
    """Eigenpairs (descending) of ``A`` projected onto the orthonormal
    (zero columns allowed) ``S``."""
    return small_linalg.eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` more orthonormal columns for the orthonormal ``X`` (``[n, k]``,
    ``k + m <= n``) by a block Householder reflector: deterministic, and
    never overlapping ``X``."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = small_linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat(
        [torch.eye(m, dtype=X.dtype, device=X.device),
         torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h

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

The JAX ``lax.while_loop`` becomes a Python loop that reads the converged
count on the host once per iteration.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor],
                    X: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None):
    """Top-k eigenpairs of the symmetric operator ``A`` (a callable on
    ``[n, j]`` blocks) from the start block ``X`` (``[n, k]``, ``0 < 5k <
    n``, numerically independent columns).

    Returns ``(theta [k], U [n, k], iterations)``, eigenvalues descending.
    At most ``m`` iterations. Callers that need float32 products run it
    under :func:`cslam_tpu_torch.ops.highest_precision` (the JAX code uses
    ``Precision.HIGHEST``).
    """
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i = 0
    converged = 0
    while i < m and converged < k:
        # X, P, R kept orthonormal; R and P columns may be 0 after basis
        # truncation, X columns never
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / torch.linalg.norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.norm(X, dim=0, keepdim=True)

        # span(X, P) == span(X, previous X): orthogonalize (0, Q[k:, :k])
        # against Q[:, :k] in the standard basis before mapping with XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)

        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.norm(R, dim=0)
        reltol = (torch.linalg.norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _check_inputs(A, X) -> None:
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were "
                         f"{test_output.dtype}, {X.dtype})")
    if test_output.shape != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output "
                         f"{tuple(test_output.shape)}")


def _eigh_descending(A: torch.Tensor):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """Truncated orthonormal basis of ``X`` by SVQB (an eigenbasis of
    ``X^T X``); columns of a rank-deficient direction come back zero."""
    norms = torch.linalg.norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
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
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` more orthonormal columns for the orthonormal ``X`` (``[n, k]``,
    ``k + m <= n``) by a block Householder reflector: deterministic, and
    never overlapping ``X``."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat(
        [torch.eye(m, dtype=X.dtype, device=X.device),
         torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h

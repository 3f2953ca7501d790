"""Robust SE(3) pose-graph optimizer: GNC-TLS around Levenberg-Marquardt.

Counterpart of ``cslam_tpu/pgo/solver.py`` (the replacement for the
reference's GTSAM ``GncOptimizer<GncParams<LevenbergMarquardtParams>>`` at
``src/back_end/decentralized_pgo.cpp:796-856``):

- residuals and exact analytic Jacobians batched over edges,
- up to 512 padded nodes, the ``[6Np, 6Np]`` normal equations assembled
  with ``index_put_`` / ``index_add_`` scatter-adds (the JAX package used
  one-hot matmuls because TPU scatters serialize) and solved by dense
  Cholesky,
- above 512 nodes, PCG on the implicit Hessian (applied edge-wise, never
  formed), preconditioned by block-Jacobi plus a segment-rigid coarse
  correction,
- Levenberg-Marquardt damping with accept/reject,
- GNC-TLS outer loop (Yang et al., arXiv:1909.08605) reweighting the edges
  flagged ``robust`` (loop closures); odometry and priors stay weight 1,
  with the Geman-McClure de-masking phase and the chordal restart.

The JAX package jits each solve, its LM and PCG loops ``lax.while_loop``s:
one device dispatch per ``lm_optimize``. Here the LM iteration is a few
step programs (:func:`_lm_dense_step` on the dense tier; :func:`_lm_head`,
:func:`_cg_block`, :func:`_lm_tail` on the PCG tier) whose loop state and
stop tests stay on the device, captured as CUDA graphs once per
pose-graph tier (``utils.tier_graphs.StepGraphs``) and replayed; the host
reads one status per replayed block (``_CG_BLOCK`` CG iterations, or one
dense step), with the next block queued before it reads. The GNC outer
loops stay host loops on a few reads per outer iteration.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cslam_tpu_torch.ops import cholesky_solve, highest_precision, se3
from cslam_tpu_torch.pgo.factor_graph import PoseGraphArrays
from cslam_tpu_torch.utils.tier_graphs import StepGraphs, host_operands

_DENSE_SOLVE_MAX_NODES = 512  # below this, one Cholesky beats iterative PCG
_DEMASK_IRLS_MAX = 4          # GM de-masking IRLS iteration cap
_COARSE_SEG = 32    # nodes per segment of the two-level PCG coarse space
_USE_COARSE = True  # the coarse correction in the PCG tier (A/B switch)
_CG_BLOCK = 16      # CG iterations per replayed block (chosen: PERF.md §6)
_LM_STEPS = 1       # LM iterations per replayed dense step
# LM defaults, shared by every local solve (``lm_optimize`` and the
# distributed mode's batched tiers must stop alike)
_LM_INIT_LAMBDA = 1e-4
_LM_REL_TOL = 1e-7
_CG_TOL = 1e-6


# ---------------------------------------------------------------------------
# Residuals and linearization
# ---------------------------------------------------------------------------


def edge_residuals(poses: torch.Tensor, g: PoseGraphArrays) -> torch.Tensor:
    """Whitened residuals of all (padded) edges:
    ``sqrt_info * Log(Z^-1 Xi^-1 Xj)``, ``[Ne, 6]``."""
    Xi = poses[g.edge_i]
    Xj = poses[g.edge_j]
    r = se3.log(se3.between(g.meas, se3.between(Xi, Xj))) * g.sqrt_info
    return r * g.edge_valid[:, None]


def prior_residuals(poses: torch.Tensor, g: PoseGraphArrays) -> torch.Tensor:
    """Whitened residuals of all (padded) pose priors: ``[B, 6]``."""
    r = se3.log(se3.between(g.prior_pose, poses[g.prior_idx]))
    return r * g.prior_sqrt_info * g.prior_valid[:, None]


def cost(poses: torch.Tensor, g: PoseGraphArrays,
         weights: torch.Tensor) -> torch.Tensor:
    """0.5 * sum of weighted squared whitened residuals (+ priors)."""
    r = edge_residuals(poses, g)
    rp = prior_residuals(poses, g)
    return 0.5 * (torch.sum(weights[:, None] * r * r) + torch.sum(rp * rp))


def _linearize(poses: torch.Tensor, g: PoseGraphArrays):
    """Batched residuals + exact ANALYTIC Jacobians at the current estimate.

    Returns (r [Ne,6], Ji [Ne,6,6], Jj [Ne,6,6], rp [B,6], Jp [B,6,6]).
    With right perturbations X -> X Exp(xi) and raw residual
    ``e = Log(Z^-1 Xi^-1 Xj)``: ``de/dxi_j = Jr_inv(e)`` and
    ``de/dxi_i = -Jr_inv(e) Ad(Xj^-1 Xi)``, rows scaled by sqrt information.
    """
    Xi = poses[g.edge_i]
    Xj = poses[g.edge_j]
    E = se3.inverse(g.meas) @ se3.inverse(Xi) @ Xj
    r_raw = se3.log(E)
    Jr_inv = se3.se3_jr_inv(r_raw)
    Jj = g.sqrt_info[:, :, None] * Jr_inv
    Ad = se3.adjoint(se3.inverse(Xj) @ Xi)
    Ji = -(Jj @ Ad)
    r = (r_raw * g.sqrt_info) * g.edge_valid[:, None]
    Ji = Ji * g.edge_valid[:, None, None]
    Jj = Jj * g.edge_valid[:, None, None]

    Xp = poses[g.prior_idx]
    rp_raw = se3.log(se3.inverse(g.prior_pose) @ Xp)
    Jp = g.prior_sqrt_info[:, :, None] * se3.se3_jr_inv(rp_raw)
    rp = (rp_raw * g.prior_sqrt_info) * g.prior_valid[:, None]
    Jp = Jp * g.prior_valid[:, None, None]
    return r, Ji, Jj, rp, Jp


# ---------------------------------------------------------------------------
# Normal equations (scatter-add assembly)
# ---------------------------------------------------------------------------


def _hessian_blocks(g, Ji, Jj, Jp, weights):
    """Block-diagonal of H = J^T W J: ``[Np, 6, 6]``."""
    Np = g.poses.shape[0]
    w = (weights * g.edge_valid)[:, None, None]
    D = torch.zeros((Np, 6, 6), dtype=Ji.dtype, device=Ji.device)
    D.index_add_(0, g.edge_i, Ji.transpose(1, 2) @ Ji * w)
    D.index_add_(0, g.edge_j, Jj.transpose(1, 2) @ Jj * w)
    D.index_add_(0, g.prior_idx, Jp.transpose(1, 2) @ Jp)
    # identity on padded nodes keeps them inert and invertible
    return D + ((1.0 - g.node_valid)[:, None, None]
                * torch.eye(6, dtype=Ji.dtype, device=Ji.device))


def _assemble_grad(g, Ji, Jj, Jp, rw, rp):
    """grad = J^T W r: ``[Np, 6]``."""
    Np = g.poses.shape[0]
    grad = torch.zeros((Np, 6), dtype=Ji.dtype, device=Ji.device)
    grad.index_add_(0, g.edge_i, torch.einsum("eij,ei->ej", Ji, rw))
    grad.index_add_(0, g.edge_j, torch.einsum("eij,ei->ej", Jj, rw))
    grad.index_add_(0, g.prior_idx, torch.einsum("bij,bi->bj", Jp, rp))
    return grad * g.node_valid[:, None]


def _dense_normal_solve(g, Ji, Jj, weights, lam, diag_h, grad, D_blocks):
    """Solve (H + lam*diag(H)) delta = -grad by dense Cholesky.

    Off-diagonal blocks ``Ji^T W Jj`` land at (i, j) and their transposes at
    (j, i); the block diagonal is ``D_blocks`` (edge + prior terms and the
    padded-node identity) plus the damping.
    """
    Np = g.poses.shape[0]
    dtype, dev = Ji.dtype, Ji.device
    w3 = (weights * g.edge_valid)[:, None, None]
    JiT_Jj = Ji.transpose(1, 2) @ Jj * w3
    H = torch.zeros((Np, Np, 6, 6), dtype=dtype, device=dev)
    H.index_put_((g.edge_i, g.edge_j), JiT_Jj, accumulate=True)
    H.index_put_((g.edge_j, g.edge_i), JiT_Jj.transpose(1, 2),
                 accumulate=True)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    nodes = torch.arange(Np, device=dev)
    H[nodes, nodes] += D_blocks + lam * diag_h[:, :, None] * eye6[None]
    Hm = H.permute(0, 2, 1, 3).reshape(Np * 6, Np * 6)
    delta = cholesky_solve(Hm, -grad.reshape(Np * 6, 1))
    return delta.reshape(Np, 6)


# ---------------------------------------------------------------------------
# Implicit-Hessian PCG (graphs above _DENSE_SOLVE_MAX_NODES)
# ---------------------------------------------------------------------------


def _make_matvec(g, Ji, Jj, Jp, weights, lam, diag_h):
    """x -> (H + lam*diag(H)) x with H applied edge-wise (never formed)."""
    w = (weights * g.edge_valid)[:, None]
    Np = g.poses.shape[0]

    def matvec(x):
        aw = (torch.einsum("eij,ej->ei", Ji, x[g.edge_i])
              + torch.einsum("eij,ej->ei", Jj, x[g.edge_j])) * w
        y = torch.zeros((Np, 6), dtype=x.dtype, device=x.device)
        y.index_add_(0, g.edge_i, torch.einsum("eij,ei->ej", Ji, aw))
        y.index_add_(0, g.edge_j, torch.einsum("eij,ei->ej", Jj, aw))
        ap = torch.einsum("bij,bj->bi", Jp, x[g.prior_idx])
        y.index_add_(0, g.prior_idx, torch.einsum("bij,bi->bj", Jp, ap))
        y = y + lam * diag_h * x
        # padded nodes stay at identity so PCG stays well-posed
        return (y * g.node_valid[:, None]
                + x * (1.0 - g.node_valid)[:, None])

    return matvec


def _coarse_factor(g, poses, Ji, Jj, Jp, weights, lam, diag_h):
    """Two-level (segment-rigid) coarse correction for the PCG tier.

    Block-Jacobi alone moves long-wavelength error one hop per CG
    iteration. The coarse space holds one SE(3) *left* increment per
    contiguous ``_COARSE_SEG``-node segment; with the right retraction
    ``X -> X Exp(xi)`` that is ``xi_n = Ad(X_n^-1) eta`` per node, so the
    prolongation is ``P[n] = Ad(X_n^-1)`` (zero on padded nodes). Edges
    inside a segment are invariant under it, so the Galerkin operator
    ``H_c = P^T (H + lam diag H) P`` couples segments only through crossing
    edges and priors. Applied additively with block-Jacobi: ``z =
    M_bj^-1 r + P H_c^-1 P^T r``.

    ``H_c`` is summed block by block (``[S, S, 6, 6]``, ``index_put_``)
    where the JAX package forms the coarse residual Jacobian with one-hot
    matmuls. Returns ``(seg, A, chol)``: each node's segment, ``P`` and
    the Cholesky factor of ``H_c`` (NaN where it failed), the operands of
    :func:`_coarse_apply`.
    """
    Np = g.poses.shape[0]
    S = max(1, Np // _COARSE_SEG)
    dtype, dev = Ji.dtype, Ji.device
    seg = torch.clamp(torch.arange(Np, device=dev) // _COARSE_SEG, max=S - 1)
    A = se3.adjoint(se3.inverse(poses)) * g.node_valid[:, None, None]
    si, sj, sp = seg[g.edge_i], seg[g.edge_j], seg[g.prior_idx]
    Gi = Ji @ A[g.edge_i]
    Gj = Jj @ A[g.edge_j]
    w = (weights * g.edge_valid)[:, None, None]
    Gp = Jp @ A[g.prior_idx]
    Hc = torch.zeros((S, S, 6, 6), dtype=dtype, device=dev)
    for a, Ga in ((si, Gi), (sj, Gj)):
        for b, Gb in ((si, Gi), (sj, Gj)):
            Hc.index_put_((a, b), Ga.transpose(1, 2) @ Gb * w,
                          accumulate=True)
    Hc.index_put_((sp, sp), Gp.transpose(1, 2) @ Gp, accumulate=True)
    # damping P^T (lam diag H) P lands on the block diagonal
    T = torch.einsum("nai,na,naj->nij", A, lam * diag_h, A)
    Dc = torch.zeros((S, 6, 6), dtype=dtype, device=dev)
    Dc.index_add_(0, seg, T)
    segs = torch.arange(S, device=dev)
    Hc[segs, segs] += Dc
    Hc = Hc.permute(0, 2, 1, 3).reshape(S * 6, S * 6)
    # ridge: keeps all-padded segments (zero rows) and near-singular coarse
    # blocks factorable without biasing active ones
    ridge = 1e-7 * torch.max(torch.diagonal(Hc)) + 1e-12
    Hc = Hc + ridge * torch.eye(S * 6, dtype=dtype, device=dev)
    chol, info = torch.linalg.cholesky_ex(Hc)
    # NaN on a failed factorization, as cho_factor gives, without a read
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    return seg, A, chol


def _coarse_apply(seg, A, chol, r):
    """``P H_c^-1 P^T r`` from :func:`_coarse_factor`'s operands."""
    S = chol.shape[0] // 6
    c = torch.zeros((S, 6), dtype=r.dtype, device=r.device)
    c.index_add_(0, seg, torch.einsum("nba,nb->na", A, r))
    y = torch.cholesky_solve(c.reshape(S * 6, 1), chol).reshape(S, 6)
    return torch.einsum("nab,nb->na", A, y[seg])


def _coarse_correction(g, poses, Ji, Jj, Jp, weights, lam, diag_h):
    """:func:`_coarse_factor` as ``apply(r) -> z_coarse``, ``H_c``
    factored once."""
    factor = _coarse_factor(g, poses, Ji, Jj, Jp, weights, lam, diag_h)
    return lambda r: _coarse_apply(*factor, r)


def _preconditioner(M_inv_blocks, coarse_apply=None):
    """Block-Jacobi, plus the coarse correction where given."""

    def apply_prec(r):
        z = torch.einsum("nij,nj->ni", M_inv_blocks, r)
        if coarse_apply is not None:
            z = z + coarse_apply(r)
        return z

    return apply_prec


def _cg_more(i, r, b_norm, max_iters, tol):
    """The JAX loop's condition (``cslam_tpu/pgo/solver.py:354-357``),
    tested on the device: another iteration while ``i < max_iters`` and
    ``||r|| > tol * ||b||``."""
    return (i < max_iters) & (torch.sqrt(torch.sum(r * r)) > tol * b_norm)


def _pcg_start(b, apply_prec, max_iters, tol):
    """PCG's initial state: x = 0, r = b, z = p = M^-1 b, and whether the
    first iteration runs (``cg_active``)."""
    z = apply_prec(b)
    b_norm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-30)
    i = torch.zeros((), dtype=torch.int64, device=b.device)
    return {"x": torch.zeros_like(b), "r": b, "z": z, "p": z,
            "rz": torch.sum(b * z), "b_norm": b_norm, "cg_i": i,
            "cg_active": _cg_more(i, b, b_norm, max_iters, tol)}


def _cg_iteration(s, matvec, apply_prec, max_iters, tol):
    """One CG iteration where ``s["cg_active"]``, else none: every update
    is selected by the flag, so a stopped state stays bit for bit."""
    on = s["cg_active"]
    x, r, p, rz = s["x"], s["r"], s["p"], s["rz"]
    Ap = matvec(p)
    alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
    r_new = r - alpha * Ap
    z_new = apply_prec(r_new)
    rz_new = torch.sum(r_new * z_new)
    p_new = z_new + rz_new / torch.clamp(rz, min=1e-30) * p
    out = {"x": torch.where(on, x + alpha * p, x),
           "r": torch.where(on, r_new, r),
           "z": torch.where(on, z_new, s["z"]),
           "p": torch.where(on, p_new, p),
           "rz": torch.where(on, rz_new, rz),
           "cg_i": s["cg_i"] + on.to(torch.int64)}
    out["cg_active"] = on & _cg_more(out["cg_i"], out["r"], s["b_norm"],
                                     max_iters, tol)
    return out


def _pcg(matvec, b, M_inv_blocks, max_iters: int, tol: float,
         coarse_apply=None):
    """Preconditioned conjugate gradients on ``[Np, 6]`` unknowns. Stops
    after ``max_iters`` or once ``||r|| <= tol * ||b||``, tested on the
    device before every iteration as the JAX loop's condition tests it;
    the host reads the flag once per ``_CG_BLOCK`` iterations. (The LM
    solve runs the same iterations as the graphed :func:`_cg_block`.)"""
    apply_prec = _preconditioner(M_inv_blocks, coarse_apply)
    s = _pcg_start(b, apply_prec, max_iters, tol)
    while bool(s["cg_active"]):
        for _ in range(_CG_BLOCK):
            s.update(_cg_iteration(s, matvec, apply_prec, max_iters, tol))
    return s["x"]


# ---------------------------------------------------------------------------
# Levenberg-Marquardt as step programs
# ---------------------------------------------------------------------------
#
# The JAX package runs one LM solve as one ``lax.while_loop`` (the PCG
# loop nested in its body): one device program. Here the body is cut into
# programs of ``(state, operands) -> state updates`` with every update
# masked by the loop's own flags (``done``, ``cg_active``), so that a
# program run after the stop changes nothing. ``utils.tier_graphs.
# StepGraphs`` captures each once per pose-graph tier and replays it; the
# host reads one small status tensor per replayed block, with the next
# block already queued behind it. Caps and tolerances are operands
# (``caps`` = [max_iters, cg_iters], ``tols`` = [init_lambda, cg_tol,
# rel_tol]), as the JAX package traces them, so every solve of a tier
# shares one capture.

_GRAPH_FIELDS = tuple(f.name for f in dataclasses.fields(PoseGraphArrays))


def _graph_of(o) -> PoseGraphArrays:
    return PoseGraphArrays(**{n: o[n] for n in _GRAPH_FIELDS})


def _status(done, it, cg_total, cg_active) -> torch.Tensor:
    """The host's one read: [done, LM iterations, CG iterations,
    cg_active] as int64."""
    return torch.stack([done.to(torch.int64), it, cg_total,
                        cg_active.to(torch.int64)])


def _lm_init(s, o, **_):
    g, w = _graph_of(o), o["weights"]
    zero = torch.zeros((), dtype=torch.int64, device=g.poses.device)
    done = o["caps"][0] <= 0
    return {"poses": g.poses, "cost": cost(g.poses, g, w),
            "lam": o["tols"][0], "it": zero, "done": done,
            "cg_total": zero,
            "status": _status(done, zero, zero, torch.zeros_like(done))}


def _linearized(s, o):
    """Residuals, Jacobians, gradient and Hessian block diagonal at the
    state's poses."""
    g, w = _graph_of(o), o["weights"]
    r, Ji, Jj, rp, Jp = _linearize(s["poses"], g)
    grad = _assemble_grad(g, Ji, Jj, Jp, r * (w * g.edge_valid)[:, None], rp)
    D = _hessian_blocks(g, Ji, Jj, Jp, w)
    diag_h = torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-8)
    return g, w, Ji, Jj, Jp, grad, D, diag_h


def _lm_update(s, o, delta):
    """Retract, cost, accept/reject, damping and the stop test of one LM
    iteration, each selected by ``~done``."""
    g, w = _graph_of(o), o["weights"]
    on = ~s["done"]
    poses, current, lam = s["poses"], s["cost"], s["lam"]
    delta = delta * g.node_valid[:, None]
    candidate = se3.retract(poses, delta)
    new_cost = cost(candidate, g, w)
    accept = new_cost < current
    take = accept & on
    step_small = torch.max(torch.abs(delta)) < 1e-7
    # converged when the cost stops moving — whether or not the step was
    # accepted
    converged = (torch.abs(current - new_cost)
                 < o["tols"][2] * (current + 1e-12))
    it = s["it"] + on.to(torch.int64)
    return {"poses": torch.where(take, candidate, poses),
            "cost": torch.where(take, new_cost, current),
            "lam": torch.where(on, torch.clamp(
                torch.where(accept, lam * 0.3, lam * 5.0), 1e-9, 1e7), lam),
            "it": it,
            "done": s["done"] | step_small | converged | (it >= o["caps"][0])}


def _lm_dense_step(s, o, steps=1, **_):
    """``steps`` LM iterations of the dense tier (padded nodes <=
    ``_DENSE_SOLVE_MAX_NODES``): dense Cholesky normal equations (NaN where
    not positive definite, which the cost test rejects)."""
    s = dict(s)
    for _ in range(steps):
        g, w, Ji, Jj, Jp, grad, D, diag_h = _linearized(s, o)
        delta = _dense_normal_solve(g, Ji, Jj, w, s["lam"], diag_h, grad, D)
        s.update(_lm_update(s, o, delta))
    return {"poses": s["poses"], "cost": s["cost"], "lam": s["lam"],
            "it": s["it"], "done": s["done"],
            "status": _status(s["done"], s["it"], s["cg_total"],
                              torch.zeros_like(s["done"]))}


def _lm_head(s, o, coarse=True, **_):
    """The PCG tier's LM iteration up to its solve: linearization,
    block-Jacobi inverses (``inv_ex``: no error read; the damped blocks are
    positive definite), the coarse factor, and PCG's initial state for
    ``(H + lam diag H) delta = -grad`` (none to run once ``done``)."""
    g, w, Ji, Jj, Jp, grad, D, diag_h = _linearized(s, o)
    lam = s["lam"]
    M_inv = torch.linalg.inv_ex(
        D + lam * diag_h[:, None] * torch.eye(6, dtype=D.dtype,
                                              device=D.device)[None])[0]
    out = {"Ji": Ji, "Jj": Jj, "Jp": Jp, "diag_h": diag_h, "M_inv": M_inv}
    if coarse:
        out["seg"], out["A"], out["chol"] = _coarse_factor(
            g, s["poses"], Ji, Jj, Jp, w, lam, diag_h)
    out.update(_pcg_start(-grad, _cg_preconditioner(out, coarse),
                          o["caps"][1], o["tols"][1]))
    out["cg_active"] = out["cg_active"] & ~s["done"]
    out["status"] = _status(s["done"], s["it"], s["cg_total"],
                            out["cg_active"])
    return out


def _cg_preconditioner(s, coarse):
    return _preconditioner(s["M_inv"], (lambda r: _coarse_apply(
        s["seg"], s["A"], s["chol"], r)) if coarse else None)


def _cg_block(s, o, coarse=True, steps=_CG_BLOCK, **_):
    """``steps`` masked CG iterations (:func:`_cg_iteration`) on the
    implicit Hessian of :func:`_lm_head`'s linearization."""
    g, w = _graph_of(o), o["weights"]
    matvec = _make_matvec(g, s["Ji"], s["Jj"], s["Jp"], w, s["lam"],
                          s["diag_h"])
    apply_prec = _cg_preconditioner(s, coarse)
    s = dict(s)
    for _ in range(steps):
        out = _cg_iteration(s, matvec, apply_prec, o["caps"][1],
                            o["tols"][1])
        s.update(out)
    out["status"] = _status(s["done"], s["it"], s["cg_total"],
                            s["cg_active"])
    return out


def _lm_tail(s, o, **_):
    """The PCG tier's LM iteration after its solve: :func:`_lm_update`
    with the CG solution, and the CG iterations added to the count."""
    out = _lm_update(s, o, s["x"])
    out["cg_total"] = s["cg_total"] + torch.where(
        s["done"], torch.zeros_like(s["cg_i"]), s["cg_i"])
    out["status"] = _status(out["done"], out["it"], out["cg_total"],
                            torch.zeros_like(out["done"]))
    return out


DENSE_GRAPHS = StepGraphs("lm_dense", {"init": _lm_init,
                                       "step": _lm_dense_step})
PCG_GRAPHS = StepGraphs("lm_pcg", {"init": _lm_init, "head": _lm_head,
                                   "cg": _cg_block, "tail": _lm_tail})


def _run_steps(loop) -> list:
    """Drive an ``init`` + ``step`` loop to its stop with one step in
    flight: step k + 1 is queued before step k's status is read (a step
    after the stop is a no-op). One host read per step. Returns the last
    status."""
    loop.run("init")
    loop.run("step")
    pending = loop.status()
    while True:
        loop.run("step")
        ahead = loop.status()
        status = pending.wait()
        if status[0]:
            return status
        pending = ahead


def _run_pcg(loop) -> list:
    """Drive the PCG tier's head / CG blocks / tail to the LM stop. CG
    blocks run until one's status says the solve is done, the next block
    always queued before that read; the next iteration's head and first
    block are queued before the tail's status is read. Host reads: one per
    block plus one per LM iteration."""
    loop.run("init")
    loop.run("head")
    loop.run("cg")
    block = loop.status()
    while True:
        while True:
            loop.run("cg")
            ahead = loop.status()
            if not block.wait()[3]:
                break
            block = ahead
        loop.run("tail")
        tail = loop.status()
        loop.run("head")
        loop.run("cg")
        block = loop.status()
        status = tail.wait()
        if status[0]:
            return status


def _scalar_operands(device, dtype, floats, ints):
    """A solve's tolerances (``dtype``) and caps (int64) as host tensors
    (``tier_graphs.host_operands``: pinned on CUDA)."""
    return (host_operands(device, floats, dtype=dtype)[0],
            host_operands(device, ints, dtype=torch.int64)[0])


def _lm_operands(g: PoseGraphArrays, weights: torch.Tensor, max_iters,
                 cg_iters, init_lambda, cg_tol, rel_tol) -> dict:
    """The operands of one LM solve: the graph's tensors, the weights,
    ``tols`` = [init_lambda, cg_tol, rel_tol] and ``caps`` = [max_iters,
    cg_iters]."""
    tols, caps = _scalar_operands(g.device, g.poses.dtype,
                                  [init_lambda, cg_tol, rel_tol],
                                  [max_iters, cg_iters])
    operands = {n: getattr(g, n) for n in _GRAPH_FIELDS}
    operands.update(weights=weights, tols=tols, caps=caps)
    return operands


class LMResult(NamedTuple):
    poses: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    cg_iterations: int = 0


@highest_precision
def lm_optimize(g: PoseGraphArrays, weights: torch.Tensor,
                max_iters: int = 50, cg_iters: int = 150,
                init_lambda: float = _LM_INIT_LAMBDA,
                cg_tol: float = _CG_TOL, rel_tol: float = _LM_REL_TOL, *,
                eager: bool = False) -> LMResult:
    """Levenberg-Marquardt: dense Cholesky steps up to
    ``_DENSE_SOLVE_MAX_NODES`` padded nodes, coarse-corrected PCG steps
    (at most ``cg_iters`` iterations to ``cg_tol``) above.

    ``weights`` are per-edge robust weights (1.0 = plain least squares).
    On CUDA the steps replay the tier's captured programs
    (:data:`DENSE_GRAPHS`, :data:`PCG_GRAPHS`); ``eager`` launches the same
    programs one by one instead (a test's comparison, never a config
    setting). ``iterations`` and ``cg_iterations`` are device counters,
    read with the last status.
    """
    dense = g.num_nodes <= _DENSE_SOLVE_MAX_NODES
    operands = _lm_operands(g, weights, max_iters, cg_iters, init_lambda,
                            cg_tol, rel_tol)
    if dense:
        with DENSE_GRAPHS.solve(g.device, operands, eager=eager,
                                steps=_LM_STEPS) as loop:
            status = _run_steps(loop)
            poses, final = loop.take("poses", "cost")
    else:
        with PCG_GRAPHS.solve(g.device, operands, eager=eager,
                              coarse=_USE_COARSE, steps=_CG_BLOCK) as loop:
            status = _run_pcg(loop)
            poses, final = loop.take("poses", "cost")
    return LMResult(poses, final, status[1], status[2])


# ---------------------------------------------------------------------------
# GNC-TLS outer loop
# ---------------------------------------------------------------------------


def _edge_chi2(poses: torch.Tensor, g: PoseGraphArrays) -> torch.Tensor:
    r = edge_residuals(poses, g)
    return torch.sum(r * r, dim=-1)


def _tls_weights(chi2: torch.Tensor, mu, barc_sq: float) -> torch.Tensor:
    """Closed-form GNC-TLS weight update (arXiv:1909.08605, Prop. 4)."""
    upper = (mu + 1.0) / mu * barc_sq
    lower = mu / (mu + 1.0) * barc_sq
    mid = torch.sqrt(barc_sq * mu * (mu + 1.0)
                     / torch.clamp(chi2, min=1e-12)) - mu
    return torch.where(chi2 >= upper, torch.zeros_like(chi2),
                       torch.where(chi2 <= lower, torch.ones_like(chi2),
                                   torch.clamp(mid, 0.0, 1.0)))


class GncResult(NamedTuple):
    poses: torch.Tensor
    weights: torch.Tensor
    final_cost: torch.Tensor
    outer_iterations: int


def _replace_poses(g: PoseGraphArrays, poses: torch.Tensor):
    return dataclasses.replace(g, poses=poses)


@highest_precision
def gnc_optimize(g: PoseGraphArrays, max_outer: int = 100,
                 lm_iters: int = 30, cg_iters: int = 150,
                 barc_sq: float = 16.81, mu_step: float = 2.0,
                 graduation_lm_iters: int = 4,
                 mu0_chi2_cap: float = 50.0, *,
                 eager: bool = False) -> GncResult:
    """Graduated non-convexity (TLS) robust PGO.

    Edges with ``g.robust == 1`` are reweighted; others stay weight 1.
    ``barc_sq`` defaults to the chi-square(6) 99% quantile. The schedule and
    its defaults (``mu_step`` 2.0, ``graduation_lm_iters`` 4, the capped
    ``mu0``) are the JAX package's, validated there.

    Phases: an unweighted LM solve; a Geman-McClure de-masking IRLS (when
    some robust edge exceeds ``barc_sq``) followed by a weighted chordal
    restart that keeps whichever solution has the lower robust cost; the
    TLS graduation with short warm-started LM solves; a final LM polish
    with the converged weights. Each phase's LM solve is the tier's
    captured step programs on CUDA (``eager``: see :func:`lm_optimize`);
    the outer loops read a few flags per outer iteration.
    """
    ones = torch.ones(g.edge_i.shape[0], dtype=g.poses.dtype,
                      device=g.poses.device)
    poses0 = lm_optimize(g, ones, max_iters=lm_iters, cg_iters=cg_iters,
                         rel_tol=1e-5, eager=eager).poses
    chi2 = _edge_chi2(poses0, g)
    robust_mask = g.robust * g.edge_valid > 0

    c2 = 4.0 * barc_sq

    def gm_weights(chi2_now):
        return torch.where(robust_mask, c2 / (c2 + chi2_now),
                           torch.ones_like(chi2_now))

    def suspicious(chi2_now):
        return robust_mask & (chi2_now > 2.0 * barc_sq)

    needs_irls = bool(torch.any(robust_mask & (chi2 > barc_sq)))
    if needs_irls:
        # de-masking IRLS: soft GM weights unmask gross outliers that the
        # unweighted init accommodated; stops when the suspicious set is
        # stable. cut_prev starts as the complement of cut0, so the first
        # GM solve always runs.
        cut_cur = suspicious(chi2)
        cut_prev = ~cut_cur
        i = 0
        while i < _DEMASK_IRLS_MAX and bool(torch.any(cut_prev != cut_cur)):
            chi2_i = _edge_chi2(poses0, g)
            poses0 = lm_optimize(_replace_poses(g, poses0),
                                 gm_weights(chi2_i), max_iters=lm_iters,
                                 cg_iters=cg_iters, rel_tol=1e-5,
                                 eager=eager).poses
            cut_prev, cut_cur = cut_cur, suspicious(_edge_chi2(poses0, g))
            i += 1

        # chordal restart, robustified by the de-masked GM weights; keep
        # whichever solution has lower robust cost
        from cslam_tpu_torch.pgo.chordal import chordal_initialize
        w_gm = gm_weights(_edge_chi2(poses0, g))
        poses_c = chordal_initialize(g, w_gm)
        poses_c = lm_optimize(_replace_poses(g, poses_c), w_gm,
                              max_iters=lm_iters, cg_iters=cg_iters,
                              rel_tol=1e-5, eager=eager).poses
        if bool(cost(poses_c, g, w_gm) < cost(poses0, g, w_gm)):
            poses0 = poses_c

    chi2 = _edge_chi2(poses0, g)
    masked_chi2 = torch.where(robust_mask, chi2, torch.zeros_like(chi2))
    max_chi2 = torch.clamp(torch.max(masked_chi2), max=mu0_chi2_cap * barc_sq)
    # TLS mu init (GTSAM GncOptimizer::initializeMu): barc^2/(2 r_max^2 - barc^2)
    mu = torch.where(max_chi2 > barc_sq,
                     barc_sq / (2.0 * max_chi2 - barc_sq),
                     torch.full_like(max_chi2, 1e6))
    mu = torch.clamp(mu, min=1e-6)
    done = bool(torch.max(masked_chi2) <= barc_sq)  # all inliers

    poses, weights = poses0, ones
    iters = 0
    while iters < max_outer and not done:
        w_prev = weights
        w_tls = _tls_weights(_edge_chi2(poses, g), mu, barc_sq)
        weights = torch.where(g.robust > 0, w_tls, torch.ones_like(w_tls))
        poses = lm_optimize(_replace_poses(g, poses), weights,
                            max_iters=graduation_lm_iters,
                            cg_iters=cg_iters, rel_tol=1e-5,
                            eager=eager).poses
        # stop when weights are binary OR have stopped moving (GTSAM's
        # weight-convergence criterion for TLS)
        binary = torch.all((weights < 1e-3) | (weights > 1.0 - 1e-3))
        stable = torch.max(torch.abs(weights - w_prev)) < 1e-3
        mu = mu * mu_step
        iters += 1
        done = bool(binary | stable)
    res_f = lm_optimize(_replace_poses(g, poses), weights, max_iters=lm_iters,
                        cg_iters=cg_iters, eager=eager)
    return GncResult(res_f.poses, weights, cost(res_f.poses, g, weights),
                     iters)


@highest_precision
def gnc_reoptimize(g: PoseGraphArrays, warm_weights: torch.Tensor,
                   lm_iters: int = 30, cg_iters: int = 150,
                   barc_sq: float = 16.81, *,
                   eager: bool = False) -> GncResult:
    """Incremental robust re-solve carrying the previous round's TLS
    weights: gate robust edges by their residual at the warm init (TLS at
    mu = 1), solve weighted LM, refresh the weights with the hard TLS rule,
    and polish once (``eager``: see :func:`lm_optimize`)."""
    chi2_init = _edge_chi2(g.poses, g)
    init_gate = _tls_weights(chi2_init, 1.0, barc_sq)
    warm_weights = torch.as_tensor(warm_weights, dtype=g.poses.dtype,
                                   device=g.poses.device)
    w0 = torch.where(g.robust > 0, torch.minimum(warm_weights, init_gate),
                     torch.ones_like(init_gate))
    res1 = lm_optimize(g, w0, max_iters=lm_iters, cg_iters=cg_iters,
                       rel_tol=1e-6, eager=eager)
    chi2 = _edge_chi2(res1.poses, g)
    w1 = torch.where(g.robust > 0, (chi2 < barc_sq).to(g.poses.dtype),
                     torch.ones_like(chi2))
    res2 = lm_optimize(_replace_poses(g, res1.poses), w1, max_iters=lm_iters,
                       cg_iters=cg_iters, eager=eager)
    chi2 = _edge_chi2(res2.poses, g)
    w2 = torch.where(g.robust > 0, (chi2 < barc_sq).to(g.poses.dtype),
                     torch.ones_like(chi2))
    return GncResult(res2.poses, w2, cost(res2.poses, g, w2), 2)

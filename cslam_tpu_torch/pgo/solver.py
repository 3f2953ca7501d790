"""Robust SE(3) pose-graph optimizer: GNC-TLS around Levenberg-Marquardt.

Counterpart of ``cslam_tpu/pgo/solver.py`` (the replacement for the
reference's GTSAM ``GncOptimizer<GncParams<LevenbergMarquardtParams>>`` at
``src/back_end/decentralized_pgo.cpp:796-856``):

- residuals and exact analytic Jacobians batched over edges,
- up to 512 padded nodes, the ``[6Np, 6Np]`` normal equations assembled
  by segment sums in an order fixed per problem (``ops.segment_sum``: the
  JAX package used one-hot matmuls because TPU scatters serialize; the
  card's atomic scatter-adds would change the order from run to run) and
  solved by dense Cholesky,
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
from typing import Dict, NamedTuple, Optional

import torch

from cslam_tpu_torch.ops import cholesky_solve, highest_precision, se3
from cslam_tpu_torch.ops.segment_sum import (plan_from, plan_operands,
                                             segment_plan, segment_sum)
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
# Normal equations (segment sums in a fixed order)
# ---------------------------------------------------------------------------
#
# Every sum over edges runs in an order fixed once per problem
# (``ops.segment_sum``): each destination adds its sources in the order of
# the concatenated source blocks, which is the order the CPU's
# ``index_add_`` / ``index_put_(accumulate=True)`` calls added them in, so
# CPU results keep their bits and the card's runs repeat. The plans of a
# graph (:func:`segment_plans`) are built from its index fields at their
# first use (cached on the arrays, shared with the GNC's pose-replaced
# copies) and enter the step programs as operands ``plan_<name>_*``:
#
# - ``node``: ``[edge_i; edge_j; prior_idx]`` into nodes (``D``, ``grad``,
#   the PCG matvec);
# - ``pair`` (dense tier): the off-diagonal blocks, ``(i, j)`` then
#   ``(j, i)`` of every edge, into ``[Np * Np]`` (robot-major for a
#   flattened batch of robots: ``(r, i, j)``);
# - ``seg``, ``seg_pair`` (PCG tier): nodes into their coarse segments,
#   and the Galerkin blocks ``(si, si), (si, sj), (sj, si), (sj, sj)`` of
#   every edge, then ``(sp, sp)`` of every prior, into ``[S * S]`` per
#   robot.
#
# Padded edges and priors are left out of every plan (their terms are
# exact zeros).

_PLAN_NAMES = ("node", "pair", "seg", "seg_pair")


def _coarse_segments(N: int, robots: int, device) -> torch.Tensor:
    """Each node's coarse segment in ``[robots * S]``: ``_COARSE_SEG``
    consecutive nodes of its robot's ``Np = N / robots``, the rest in the
    last of the robot's ``S = max(1, Np // _COARSE_SEG)``."""
    Np = N // robots
    S = max(1, Np // _COARSE_SEG)
    n = torch.arange(N, device=device)
    return (n // Np) * S + torch.clamp((n % Np) // _COARSE_SEG, max=S - 1)


def _build_plan(g: PoseGraphArrays, name: str, robots: int):
    N = g.poses.shape[0]
    Np = N // robots
    ei, ej, pi = g.edge_i, g.edge_j, g.prior_idx
    ev, pv = g.edge_valid > 0, g.prior_valid > 0
    if name == "node":
        return segment_plan(torch.cat([ei, ej, pi]),
                            torch.cat([ev, ev, pv]), N)
    if name == "pair":
        return segment_plan(torch.cat([ei * Np + ej % Np,
                                       ej * Np + ei % Np]),
                            torch.cat([ev, ev]), N * Np, compact=True)
    S = max(1, Np // _COARSE_SEG)
    seg = _coarse_segments(N, robots, g.poses.device)
    if name == "seg":
        return segment_plan(seg, g.node_valid > 0, robots * S)
    si, sj, sp = seg[ei], seg[ej], seg[pi]
    return segment_plan(
        torch.cat([si * S + si % S, si * S + sj % S, sj * S + si % S,
                   sj * S + sj % S, sp * S + sp % S]),
        torch.cat([ev, ev, ev, ev, pv]), robots * S * S, compact=True)


def segment_plans(g: PoseGraphArrays, robots: int = 1,
                  names=None) -> Dict:
    """The segment plans ``names`` of ``g``'s normal-equation sums (by
    default its tier's: ``node``, and ``pair`` up to
    ``_DENSE_SOLVE_MAX_NODES`` nodes per robot, ``seg`` and ``seg_pair``
    above), for ``robots`` robots flattened into one graph
    (``pgo.distributed``'s batched tiers). Built from the index fields
    once and cached on ``g`` (outside any capture)."""
    if names is None:
        Np = g.poses.shape[0] // robots
        names = ("node", "pair") if Np <= _DENSE_SOLVE_MAX_NODES else \
            ("node", "seg", "seg_pair")
    cache = g.__dict__.setdefault("_segment_plans", {})
    for name in names:
        if (name, robots) not in cache:
            cache[name, robots] = _build_plan(g, name, robots)
    return {name: cache[name, robots] for name in names}


def _plan_operands(plans: Dict) -> Dict[str, torch.Tensor]:
    out = {}
    for name, plan in plans.items():
        out.update(plan_operands(f"plan_{name}", plan))
    return out


def _plan(plans: Optional[Dict], g: PoseGraphArrays, name: str,
          robots: int = 1):
    """``plans[name]`` where the caller passed it, else ``g``'s own (for
    ``robots`` robots flattened into ``g``)."""
    if plans is not None and name in plans:
        return plans[name]
    return segment_plans(g, robots, names=(name,))[name]


def _plans_of(o) -> Dict:
    """The plans a step program's operands hold (:func:`_plan_operands`)."""
    return {name: plan for name in _PLAN_NAMES
            if (plan := plan_from(o, f"plan_{name}")) is not None}


def _node_sum(parts, plan, width):
    """Per-node sums of the concatenated ``parts`` (``[edge_i; edge_j;
    prior_idx]`` rows), ``[N, *width]``."""
    src = torch.cat([p.reshape(p.shape[0], -1) for p in parts])
    return segment_sum(src, plan).reshape(-1, *width)


def _hessian_blocks(g, Ji, Jj, Jp, weights, plans: Optional[Dict] = None):
    """Block-diagonal of H = J^T W J: ``[Np, 6, 6]``."""
    w = (weights * g.edge_valid)[:, None, None]
    D = _node_sum((Ji.transpose(1, 2) @ Ji * w, Jj.transpose(1, 2) @ Jj * w,
                   Jp.transpose(1, 2) @ Jp), _plan(plans, g, "node"), (6, 6))
    # identity on padded nodes keeps them inert and invertible
    return D + ((1.0 - g.node_valid)[:, None, None]
                * torch.eye(6, dtype=Ji.dtype, device=Ji.device))


def _assemble_grad(g, Ji, Jj, Jp, rw, rp, plans: Optional[Dict] = None):
    """grad = J^T W r: ``[Np, 6]``."""
    grad = _node_sum((torch.einsum("eij,ei->ej", Ji, rw),
                      torch.einsum("eij,ei->ej", Jj, rw),
                      torch.einsum("bij,bi->bj", Jp, rp)),
                     _plan(plans, g, "node"), (6,))
    return grad * g.node_valid[:, None]


def _off_diagonal_blocks(g, Ji, Jj, weights, plans, robots: int = 1):
    """The off-diagonal blocks of H, ``Ji^T W Jj`` at (i, j) and its
    transpose at (j, i): ``[N, Np, 6, 6]`` for ``robots`` robots of ``Np
    = N / robots`` nodes flattened into ``g`` (row ``r * Np + i``, column
    ``j`` of robot ``r``)."""
    N = g.poses.shape[0]
    Np = N // robots
    JiT_Jj = Ji.transpose(1, 2) @ Jj * (weights * g.edge_valid)[:, None, None]
    src = torch.cat([JiT_Jj, JiT_Jj.transpose(1, 2)]).reshape(-1, 36)
    return segment_sum(src, _plan(plans, g, "pair", robots),
                       rows=N * Np).reshape(N, Np, 6, 6)


def _dense_normal_solve(g, Ji, Jj, weights, lam, diag_h, grad, D_blocks,
                        plans: Optional[Dict] = None):
    """Solve (H + lam*diag(H)) delta = -grad by dense Cholesky.

    Off-diagonal blocks ``Ji^T W Jj`` land at (i, j) and their transposes at
    (j, i); the block diagonal is ``D_blocks`` (edge + prior terms and the
    padded-node identity) plus the damping.
    """
    Np = g.poses.shape[0]
    dtype, dev = Ji.dtype, Ji.device
    H = _off_diagonal_blocks(g, Ji, Jj, weights, plans)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    nodes = torch.arange(Np, device=dev)
    H[nodes, nodes] += D_blocks + lam * diag_h[:, :, None] * eye6[None]
    Hm = H.permute(0, 2, 1, 3).reshape(Np * 6, Np * 6)
    delta = cholesky_solve(Hm, -grad.reshape(Np * 6, 1))
    return delta.reshape(Np, 6)


# ---------------------------------------------------------------------------
# Implicit-Hessian PCG (graphs above _DENSE_SOLVE_MAX_NODES)
# ---------------------------------------------------------------------------


def _make_matvec(g, Ji, Jj, Jp, weights, lam, diag_h,
                 plans: Optional[Dict] = None):
    """x -> (H + lam*diag(H)) x with H applied edge-wise (never formed):
    one segment sum per product."""
    w = (weights * g.edge_valid)[:, None]
    node = _plan(plans, g, "node")

    def matvec(x):
        aw = (torch.einsum("eij,ej->ei", Ji, x[g.edge_i])
              + torch.einsum("eij,ej->ei", Jj, x[g.edge_j])) * w
        ap = torch.einsum("bij,bj->bi", Jp, x[g.prior_idx])
        y = _node_sum((torch.einsum("eij,ei->ej", Ji, aw),
                       torch.einsum("eij,ei->ej", Jj, aw),
                       torch.einsum("bij,bi->bj", Jp, ap)), node, (6,))
        y = y + lam * diag_h * x
        # padded nodes stay at identity so PCG stays well-posed
        return (y * g.node_valid[:, None]
                + x * (1.0 - g.node_valid)[:, None])

    return matvec


def _coarse_factor(g, poses, Ji, Jj, Jp, weights, lam, diag_h,
                   plans: Optional[Dict] = None):
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

    ``H_c`` is summed block by block (``[S, S, 6, 6]``, the ``seg_pair``
    and ``seg`` plans) where the JAX package forms the coarse residual
    Jacobian with one-hot matmuls. Returns ``(seg, A, chol, failed)``:
    each node's segment, ``P``, the Cholesky factor of ``H_c`` (NaN where
    it failed) and whether it failed (a 0-d bool), the first three the
    operands of :func:`_coarse_apply`.
    """
    Np = g.poses.shape[0]
    S = max(1, Np // _COARSE_SEG)
    dtype, dev = Ji.dtype, Ji.device
    seg = _coarse_segments(Np, 1, dev)
    A = se3.adjoint(se3.inverse(poses)) * g.node_valid[:, None, None]
    Hc, T = _galerkin_blocks(g, A, Ji, Jj, Jp, weights, lam * diag_h,
                             plans, S * S)
    Dc = segment_sum(T.reshape(Np, 36), _plan(plans, g, "seg")).reshape(
        S, 6, 6)
    Hc = Hc.reshape(S, S, 6, 6)
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
    return seg, A, chol, info != 0


def _galerkin_blocks(g, A, Ji, Jj, Jp, weights, damping, plans, rows,
                     robots: int = 1):
    """The coarse operator's edge and prior blocks, ``[rows, 36]`` (the
    ``seg_pair`` plan's ``S * S`` blocks per robot), and each node's
    damping block ``T = A^T diag(damping) A``, ``[N, 6, 6]``."""
    Gi = Ji @ A[g.edge_i]
    Gj = Jj @ A[g.edge_j]
    w = (weights * g.edge_valid)[:, None, None]
    Gp = Jp @ A[g.prior_idx]
    src = torch.cat([Ga.transpose(1, 2) @ Gb * w for Ga in (Gi, Gj)
                     for Gb in (Gi, Gj)] + [Gp.transpose(1, 2) @ Gp])
    Hc = segment_sum(src.reshape(-1, 36),
                     _plan(plans, g, "seg_pair", robots), rows=rows)
    # damping P^T (lam diag H) P lands on the block diagonal
    T = torch.einsum("nai,na,naj->nij", A, damping, A)
    return Hc, T


def _coarse_apply(seg, A, chol, r, plan):
    """``P H_c^-1 P^T r`` from :func:`_coarse_factor`'s operands and the
    ``seg`` plan."""
    S = chol.shape[0] // 6
    c = segment_sum(torch.einsum("nba,nb->na", A, r), plan)
    y = torch.cholesky_solve(c.reshape(S * 6, 1), chol).reshape(S, 6)
    return torch.einsum("nab,nb->na", A, y[seg])


def _coarse_correction(g, poses, Ji, Jj, Jp, weights, lam, diag_h):
    """:func:`_coarse_factor` as ``apply(r) -> z_coarse``, ``H_c``
    factored once."""
    seg, A, chol, _ = _coarse_factor(g, poses, Ji, Jj, Jp, weights, lam,
                                     diag_h)
    plan = _plan(None, g, "seg")
    return lambda r: _coarse_apply(seg, A, chol, r, plan)


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


def _status(done, it, cg_total, cg_active, coarse_fail=None) -> torch.Tensor:
    """The host's one read: [done, LM iterations, CG iterations,
    cg_active, failed coarse factorizations] as int64."""
    return torch.stack([done.to(torch.int64), it, cg_total,
                        cg_active.to(torch.int64),
                        torch.zeros_like(it) if coarse_fail is None
                        else coarse_fail])


def _lm_init(s, o, **_):
    g, w = _graph_of(o), o["weights"]
    zero = torch.zeros((), dtype=torch.int64, device=g.poses.device)
    done = o["caps"][0] <= 0
    return {"poses": g.poses, "cost": cost(g.poses, g, w),
            "lam": o["tols"][0], "it": zero, "done": done,
            "cg_total": zero, "coarse_fail": zero,
            "status": _status(done, zero, zero, torch.zeros_like(done))}


def _linearized(s, o):
    """Residuals, Jacobians, gradient and Hessian block diagonal at the
    state's poses."""
    g, w, plans = _graph_of(o), o["weights"], _plans_of(o)
    r, Ji, Jj, rp, Jp = _linearize(s["poses"], g)
    grad = _assemble_grad(g, Ji, Jj, Jp, r * (w * g.edge_valid)[:, None], rp,
                          plans)
    D = _hessian_blocks(g, Ji, Jj, Jp, w, plans)
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
        delta = _dense_normal_solve(g, Ji, Jj, w, s["lam"], diag_h, grad, D,
                                    _plans_of(o))
        s.update(_lm_update(s, o, delta))
    return {"poses": s["poses"], "cost": s["cost"], "lam": s["lam"],
            "it": s["it"], "done": s["done"],
            "status": _status(s["done"], s["it"], s["cg_total"],
                              torch.zeros_like(s["done"]))}


def _lm_head(s, o, coarse=True, **_):
    """The PCG tier's LM iteration up to its solve: linearization,
    block-Jacobi inverses (``inv_ex``: no error read; the damped blocks are
    positive definite), the coarse factor (a failed one counted in
    ``coarse_fail``), and PCG's initial state for ``(H + lam diag H) delta
    = -grad`` (none to run once ``done``)."""
    g, w, Ji, Jj, Jp, grad, D, diag_h = _linearized(s, o)
    lam = s["lam"]
    M_inv = torch.linalg.inv_ex(
        D + lam * diag_h[:, None] * torch.eye(6, dtype=D.dtype,
                                              device=D.device)[None])[0]
    out = {"Ji": Ji, "Jj": Jj, "Jp": Jp, "diag_h": diag_h, "M_inv": M_inv,
           "coarse_fail": s["coarse_fail"]}
    if coarse:
        out["seg"], out["A"], out["chol"], failed = _coarse_factor(
            g, s["poses"], Ji, Jj, Jp, w, lam, diag_h, _plans_of(o))
        out["coarse_fail"] = s["coarse_fail"] + (
            failed & ~s["done"]).to(torch.int64)
    out.update(_pcg_start(-grad, _cg_preconditioner(out, o, coarse),
                          o["caps"][1], o["tols"][1]))
    out["cg_active"] = out["cg_active"] & ~s["done"]
    out["status"] = _status(s["done"], s["it"], s["cg_total"],
                            out["cg_active"], out["coarse_fail"])
    return out


def _cg_preconditioner(s, o, coarse):
    plan = _plan(_plans_of(o), _graph_of(o), "seg") if coarse else None
    return _preconditioner(s["M_inv"], (lambda r: _coarse_apply(
        s["seg"], s["A"], s["chol"], r, plan)) if coarse else None)


def _cg_block(s, o, coarse=True, steps=_CG_BLOCK, **_):
    """``steps`` masked CG iterations (:func:`_cg_iteration`) on the
    implicit Hessian of :func:`_lm_head`'s linearization."""
    g, w = _graph_of(o), o["weights"]
    matvec = _make_matvec(g, s["Ji"], s["Jj"], s["Jp"], w, s["lam"],
                          s["diag_h"], _plans_of(o))
    apply_prec = _cg_preconditioner(s, o, coarse)
    s = dict(s)
    for _ in range(steps):
        out = _cg_iteration(s, matvec, apply_prec, o["caps"][1],
                            o["tols"][1])
        s.update(out)
    out["status"] = _status(s["done"], s["it"], s["cg_total"],
                            s["cg_active"], s["coarse_fail"])
    return out


def _lm_tail(s, o, **_):
    """The PCG tier's LM iteration after its solve: :func:`_lm_update`
    with the CG solution, and the CG iterations added to the count."""
    out = _lm_update(s, o, s["x"])
    out["cg_total"] = s["cg_total"] + torch.where(
        s["done"], torch.zeros_like(s["cg_i"]), s["cg_i"])
    out["status"] = _status(out["done"], out["it"], out["cg_total"],
                            torch.zeros_like(out["done"]), s["coarse_fail"])
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
    operands.update(weights=weights, tols=tols, caps=caps,
                    **_plan_operands(segment_plans(g)))
    return operands


class LMResult(NamedTuple):
    poses: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    cg_iterations: int = 0
    #: LM iterations whose coarse factorization failed (PCG tier)
    coarse_failures: int = 0


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
    return LMResult(poses, final, status[1], status[2], status[4])


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
    """``g`` at ``poses``, sharing its segment plans (the index fields are
    the same)."""
    out = dataclasses.replace(g, poses=poses)
    out._segment_plans = g.__dict__.setdefault("_segment_plans", {})
    return out


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

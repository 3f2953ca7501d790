"""Robot-sharded distributed pose-graph optimization (block Gauss-Seidel).

Counterpart of ``cslam_tpu/pgo/distributed.py``. The reference always
centralizes PGO at one elected robot (``decentralized_pgo.cpp:884-905``);
here per-robot subgraphs are blocks of a
:class:`~cslam_tpu_torch.utils.robot_mesh.RobotMesh` (one robot's poses,
odometry chain and intra-robot loop closures per block) and each
Gauss-Seidel sweep exchanges only the pose blocks through ``all_gather``:

    repeat:
        all_gather current pose blocks
        coarse level: segment-rigid SE(3) corrections from the separator
            graph + segment-crossing intra edges (replicated tiny GN)
        turn incident inter-robot edges into absolute pose priors,
            damped to the geodesic midpoint (parallel-update stability):
            edge (r0,k0)-(r1,k1) with Z = X0^-1 X1:
                on r0:  prior  X0(k0) <- midpoint(X0(k0), X1(k1) Z^-1)
                on r1:  prior  X1(k1) <- midpoint(X1(k1), X0(k0) Z)
        every robot runs its local LM solve with those priors fixed

Gauge: robot 0 keeps a strong anchor on its first pose; every other robot
gets a weak self-anchor so isolated robots stay well-posed while connected
ones defer to their separators.

What the JAX package ran as one ``shard_map``-ped jitted program runs here
as eager PyTorch over the mesh: on a ``StackedMesh`` (every robot in one
process) the local solves of one sweep are ONE batched Levenberg-Marquardt
(:func:`_batched_lm`: one linearization over the R blocks and one batched
Cholesky per iteration, each robot with its own damping, accept/reject and
stop, as each device's ``while_loop`` had), a step program captured once
per tier as ``pgo.solver``'s LM steps are; on a ``ProcessGroupMesh`` each
rank runs ``pgo.solver.lm_optimize`` on its own block. The JAX package's
outer ``lax`` loop becomes a Python loop with one host read per sweep (the
stop test); the batched LM reads one status per step, with the next step
already queued; nothing is read per robot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch.ops import highest_precision, se3
from cslam_tpu_torch.pgo import solver
from cslam_tpu_torch.pgo.factor_graph import (FactorGraph, PoseGraphArrays,
                                              _tier)
from cslam_tpu_torch.types import PoseGraphEdge, PoseKey
from cslam_tpu_torch.utils.robot_mesh import AXIS, RobotMesh  # noqa: F401
from cslam_tpu_torch.utils.tier_graphs import StepGraphs

# warm-mode mu0: intra-robot robust chi2 above this multiple of barc_sq at
# the carried (previously converged) poses counts as a previous-round
# reject and is excluded from the adaptive-mu0 max (see the derivation in
# _solve). 25x sits between "new genuine edge with rough alignment"
# (single-digit multiples after a converged round) and "persistent gross
# outlier" (hundreds+).
_WARM_INTRA_GROSS = 25.0


def _stack(arrays: List[PoseGraphArrays]) -> PoseGraphArrays:
    return PoseGraphArrays(**{
        f.name: torch.stack([getattr(a, f.name) for a in arrays])
        for f in dataclasses.fields(PoseGraphArrays)})


class ShardedPoseGraph:
    """Host-side builder for the robot-sharded multi-robot problem.

    Inputs are per-robot FactorGraphs (local chains + intra-robot loop
    closures, keys local keyframe ids) plus the inter-robot separator edges.
    """

    def __init__(self, nb_robots: int):
        self.nb_robots = nb_robots
        self.local_graphs: List[FactorGraph] = [FactorGraph()
                                                for _ in range(nb_robots)]
        self.separators: List[PoseGraphEdge] = []

    def add_variable(self, robot_id: int, keyframe_id: int,
                     pose: np.ndarray) -> None:
        self.local_graphs[robot_id].add_variable((robot_id, keyframe_id),
                                                 pose)

    def add_local_between(self, robot_id: int, kf0: int, kf1: int,
                          measurement: np.ndarray, sigmas: np.ndarray,
                          robust: bool = False) -> None:
        self.local_graphs[robot_id].add_between(
            (robot_id, kf0), (robot_id, kf1), measurement, sigmas,
            robust=robust)

    def add_separator(self, edge: PoseGraphEdge) -> None:
        if edge.key_from.robot_id == edge.key_to.robot_id:
            raise ValueError("a separator joins two robots")
        self.separators.append(edge)

    # ------------------------------------------------------------------

    def to_device_arrays(self, mesh: RobotMesh,
                         separator_sigma_scale: float = 1.0,
                         weak_anchor_scale: float = 1000.0,
                         coarse_segments: int = 16):
        """The owned robots' PoseGraphArrays stacked on a leading axis (in
        ``mesh.owned`` order) + the replicated separator dict (with the
        coarse-level metadata: segment length + the intra-robot edges that
        cross segment boundaries, see :func:`_coarse_alignment`), all on
        ``mesh.device``."""
        R = self.nb_robots
        if mesh.size != R:
            raise ValueError(f"mesh has {mesh.size} robots on '{AXIS}', "
                             f"need {R} (one per robot)")
        dev = mesh.device

        # Uniform tiers across robots
        np_tier = _tier(max(max(len(g), 1) for g in self.local_graphs))
        ne_tier = _tier(max(max(len(g._edges), 1) for g in self.local_graphs))
        nb_sep = _tier(max(len(self.separators), 1), minimum=8)
        # priors tier: every separator can contribute one prior per side
        # + 1 self-anchor
        prior_tier = _tier(nb_sep + 1, minimum=2)

        owned_arrays = {}
        for rid, graph in enumerate(self.local_graphs):
            # weak/strong self-anchor on the first pose; the reset keeps a
            # second solve of the same problem (a warm round) from
            # stacking a second anchor
            first = graph.keys()[0] if len(graph) else (rid, 0)
            scale = 1.0 if rid == 0 else weak_anchor_scale
            if len(graph):
                graph._priors = []
                graph.add_prior(first, graph.get_pose(first),
                                np.full(6, 0.1) * scale)
            if rid in mesh.owned:
                owned_arrays[rid] = _repad(graph.to_arrays(device=dev),
                                           np_tier, ne_tier, prior_tier)
        stacked = _stack([owned_arrays[r] for r in mesh.owned])

        # separator edge arrays (replicated)
        sep_r0 = np.zeros(nb_sep, np.int64)
        sep_k0 = np.zeros(nb_sep, np.int64)
        sep_r1 = np.zeros(nb_sep, np.int64)
        sep_k1 = np.zeros(nb_sep, np.int64)
        sep_meas = np.tile(np.eye(4, dtype=np.float32), (nb_sep, 1, 1))
        sep_info = np.ones((nb_sep, 6), np.float32)
        sep_valid = np.zeros(nb_sep, np.float32)
        for i, e in enumerate(self.separators):
            r0, k0 = e.key_from.robot_id, e.key_from.keyframe_id
            r1, k1 = e.key_to.robot_id, e.key_to.keyframe_id
            sep_r0[i], sep_r1[i] = r0, r1
            sep_k0[i] = self.local_graphs[r0].index_of((r0, k0))
            sep_k1[i] = self.local_graphs[r1].index_of((r1, k1))
            sep_meas[i] = e.measurement.astype(np.float32)
            sep_info[i] = 1.0 / np.maximum(
                np.asarray(e.noise_sigmas) * separator_sigma_scale, 1e-9)
            sep_valid[i] = 1.0

        # coarse-level metadata: segment partition + boundary-crossing
        # intra-robot edges (rigid segment motions change only these)
        M = max(int(coarse_segments), 1)
        seg_len = max((np_tier + M - 1) // M, 1)
        crossing = []
        for rid, graph in enumerate(self.local_graphs):
            for (i, j, z, s, rb) in graph._edges:
                if min(i // seg_len, M - 1) != min(j // seg_len, M - 1):
                    crossing.append((rid, i, j, z, s, rb))
        nc = _tier(max(len(crossing), 1), minimum=8)
        cr_r = np.zeros(nc, np.int64)
        cr_ki = np.zeros(nc, np.int64)
        cr_kj = np.zeros(nc, np.int64)
        cr_meas = np.tile(np.eye(4, dtype=np.float32), (nc, 1, 1))
        cr_info = np.ones((nc, 6), np.float32)
        cr_valid = np.zeros(nc, np.float32)
        cr_robust = np.zeros(nc, np.float32)
        for i, (rid, ki, kj, z, s, rb) in enumerate(crossing):
            cr_r[i], cr_ki[i], cr_kj[i] = rid, ki, kj
            cr_meas[i] = z.astype(np.float32)
            cr_info[i] = (1.0 / np.maximum(s, 1e-9)).astype(np.float32)
            cr_valid[i] = 1.0
            cr_robust[i] = 1.0 if rb else 0.0

        def t(x):
            return torch.from_numpy(x).to(dev)

        separators = {
            "r0": t(sep_r0), "k0": t(sep_k0), "r1": t(sep_r1),
            "k1": t(sep_k1), "meas": t(sep_meas), "sqrt_info": t(sep_info),
            "valid": t(sep_valid),
            # carried-classification slots (steady-state warm solves fill
            # these from the previous round; neutral defaults otherwise)
            "w_carry": torch.ones(nb_sep, dtype=torch.float32, device=dev),
            "carry_known": torch.zeros(nb_sep, dtype=torch.float32,
                                       device=dev),
            "carry_on": torch.zeros((), dtype=torch.float32, device=dev),
            "coarse_segments": M, "coarse_seg_len": seg_len,
            "cross": {
                "r": t(cr_r), "ki": t(cr_ki), "kj": t(cr_kj),
                "meas": t(cr_meas), "sqrt_info": t(cr_info),
                "valid": t(cr_valid), "robust": t(cr_robust),
            },
        }
        return stacked, separators

    def separator_keys(self) -> List[Tuple[Tuple[int, int],
                                           Tuple[int, int]]]:
        """Stable identity of each separator (array slot i <-> key i):
        ((robot_from, kf_from), (robot_to, kf_to)). Used to carry TLS
        classification across rounds as the graph grows."""
        return [((e.key_from.robot_id, e.key_from.keyframe_id),
                 (e.key_to.robot_id, e.key_to.keyframe_id))
                for e in self.separators]

    def values_from_arrays(self, poses_stacked
                           ) -> Dict[Tuple[int, int], np.ndarray]:
        """``[R, Np, 4, 4]`` poses (all robots) -> {(robot, kf): pose}."""
        if isinstance(poses_stacked, torch.Tensor):
            poses_stacked = poses_stacked.detach().cpu().numpy()
        out: Dict[Tuple[int, int], np.ndarray] = {}
        poses_stacked = np.asarray(poses_stacked)
        for rid, graph in enumerate(self.local_graphs):
            for key, idx in graph._index.items():
                out[key] = poses_stacked[rid, idx].astype(np.float64)
        return out


def split_factor_graph(graph: FactorGraph, first_robot: int
                       ) -> Tuple[ShardedPoseGraph, Dict[int, int]]:
    """Split an aggregate multi-robot graph as the back end's distributed
    mode does: robots slotted with ``first_robot`` first (slot 0 gets the
    strong anchor, matching the centralized prior on the local robot's
    first pose), same-robot edges into local chains (keeping their robust
    flag), cross-robot edges into separators. The graph's own priors are
    not carried (the sharded problem anchors itself). Returns the problem
    and ``{robot_id: slot}``."""
    keys = graph.keys()
    rids = sorted({k[0] for k in keys},
                  key=lambda r: (r != first_robot, r))
    slot = {r: i for i, r in enumerate(rids)}
    problem = ShardedPoseGraph(len(rids))
    for key in keys:
        problem.add_variable(slot[key[0]], key[1], graph.get_pose(key))
    inv = {v: k for k, v in graph._index.items()}
    for (i, j, z, s, robust) in graph._edges:
        kf, kt = inv[i], inv[j]
        if kf[0] == kt[0]:
            problem.add_local_between(slot[kf[0]], kf[1], kt[1], z, s,
                                      robust=robust)
        else:
            problem.add_separator(PoseGraphEdge(
                key_from=PoseKey(slot[kf[0]], kf[1]),
                key_to=PoseKey(slot[kt[0]], kt[1]),
                measurement=z, noise_sigmas=s))
    return problem, slot


def _repad(g: PoseGraphArrays, np_tier: int, ne_tier: int,
           nb_tier: int) -> PoseGraphArrays:
    """Pad one robot's arrays up to the shared tiers."""

    def pad_to(x, n, identity=False):
        cur = x.shape[0]
        if cur >= n:
            return x
        if identity:
            # repeat over a leading axis: (k, 1, 1) reps -- a bare (k,) rep
            # spreads eye(4) along the LAST axis, and the reshape scrambles
            # it into rank-deficient non-SE(3) filler (the JAX package's
            # review caught it; the garbage only survived because every
            # downstream op happened to be masked)
            filler = torch.eye(4, dtype=x.dtype, device=x.device).repeat(
                n - cur, 1, 1)
        else:
            filler = torch.zeros((n - cur,) + tuple(x.shape[1:]),
                                 dtype=x.dtype, device=x.device)
        return torch.cat([x, filler])

    return PoseGraphArrays(
        poses=pad_to(g.poses, np_tier, identity=True),
        node_valid=pad_to(g.node_valid, np_tier),
        edge_i=pad_to(g.edge_i, ne_tier),
        edge_j=pad_to(g.edge_j, ne_tier),
        meas=pad_to(g.meas, ne_tier, identity=True),
        sqrt_info=pad_to(g.sqrt_info, ne_tier),
        edge_valid=pad_to(g.edge_valid, ne_tier),
        robust=pad_to(g.robust, ne_tier),
        prior_idx=pad_to(g.prior_idx, nb_tier),
        prior_pose=pad_to(g.prior_pose, nb_tier, identity=True),
        prior_sqrt_info=pad_to(g.prior_sqrt_info, nb_tier),
        prior_valid=pad_to(g.prior_valid, nb_tier))


# ---------------------------------------------------------------------------
# Per-edge helpers
# ---------------------------------------------------------------------------


def _separator_priors(me: torch.Tensor, all_poses: torch.Tensor, sep: dict):
    """Turn inter-robot edges incident to each robot of ``me`` ``[n]`` into
    absolute priors. Returns (idx [n, S], target [n, S, 4, 4], sqrt_info
    [n, S, 6], valid [n, S])."""
    on_r0 = sep["r0"][None] == me[:, None]
    on_r1 = sep["r1"][None] == me[:, None]
    incident = (on_r0 | on_r1) & (sep["valid"] > 0)

    other_rid = torch.where(on_r0, sep["r1"], sep["r0"])
    other_idx = torch.where(on_r0, sep["k1"], sep["k0"])
    my_idx = torch.where(on_r0, sep["k0"], sep["k1"])
    other_pose = all_poses[other_rid, other_idx]
    # Z = X0^-1 X1  ->  X0 = X1 Z^-1  /  X1 = X0 Z
    target_r0 = other_pose @ se3.inverse(sep["meas"])
    target_r1 = other_pose @ sep["meas"]
    target = torch.where(on_r0[..., None, None], target_r0, target_r1)
    eye = torch.eye(4, dtype=target.dtype, device=target.device)
    target = torch.where(incident[..., None, None], target, eye)
    info = sep["sqrt_info"].expand(me.shape[0], -1, -1)
    return my_idx, target, info, incident.to(torch.float32)


def _tls(chi2, mu, barc_sq):
    """GNC-TLS weights: the centralized solver's own, so the two modes can
    never silently diverge."""
    return solver._tls_weights(chi2, mu, barc_sq)


def _sep_residuals(all_poses: torch.Tensor, sep: dict):
    """Whitened separator residuals from the global pose blocks:
    e_s = Log(Z^-1 X0^-1 X1) * sqrt_info. Returns ([S, 6], chi2 [S])."""
    X0 = all_poses[sep["r0"], sep["k0"]]
    X1 = all_poses[sep["r1"], sep["k1"]]
    r = se3.log(se3.inverse(sep["meas"]) @ se3.inverse(X0) @ X1) \
        * sep["sqrt_info"]
    return r, torch.sum(r * r, dim=-1)


def _coarse_alignment(all_poses: torch.Tensor, sep: dict,
                      w_sep: torch.Tensor, cross: Optional[dict],
                      nb_robots: int, segments: int, seg_len: int, mu=None,
                      barc_sq: float = 16.81, iters: int = 3) -> torch.Tensor:
    """Aggregation-multigrid coarse level: one rigid SE(3) correction per
    CHAIN SEGMENT (``segments`` per robot), solved as a replicated tiny
    Gauss-Newton problem and applied to the gathered pose blocks.

    The coarse objective is the full objective restricted to the coarse
    space: rigid segment motions leave within-segment odometry invariant,
    so only (a) the weighted separators and (b) the intra-robot edges that
    CROSS a segment boundary (precomputed in ``cross``) appear, which
    makes the joint optimum a stationary point of the coarse problem
    (H = I): the accelerator is bias-free and can run every sweep.

    The normal equations are summed block by block with ``index_put_``
    (the JAX package formed the ``[E, 6, V, 6]`` Jacobian with one-hot
    matmuls) and solved by ``linalg.solve_ex``; a failed solve (non-finite
    step) leaves that iteration's correction at identity without a host
    read. ``6 * R * segments`` unknowns, a dense solve.
    """
    R = nb_robots
    M = segments
    V = R * M
    dtype, dev = all_poses.dtype, all_poses.device
    if cross is None:  # problems built before the coarse metadata existed
        cross = {"r": torch.zeros(1, dtype=torch.int64, device=dev),
                 "ki": torch.zeros(1, dtype=torch.int64, device=dev),
                 "kj": torch.zeros(1, dtype=torch.int64, device=dev),
                 "meas": torch.eye(4, dtype=dtype, device=dev)[None],
                 "sqrt_info": torch.ones((1, 6), dtype=dtype, device=dev),
                 "valid": torch.zeros(1, dtype=dtype, device=dev)}

    # TLS-reweight robust crossing edges (intra-robot loop closures that
    # cross segment boundaries) from their current chi2 at the same mu the
    # fine level uses: an outlier intra loop closure the local solve has
    # cut must not drag the segments toward it every sweep. Non-robust
    # odometry crossing edges keep weight 1.
    w_cross = cross["valid"]
    if mu is not None and "robust" in cross:
        r_cr = se3.log(se3.inverse(cross["meas"])
                       @ se3.inverse(all_poses[cross["r"], cross["ki"]])
                       @ all_poses[cross["r"], cross["kj"]]) \
            * cross["sqrt_info"]
        chi2_cr = torch.sum(r_cr * r_cr, dim=-1)
        w_cross = torch.where(cross["robust"] > 0,
                              _tls(chi2_cr, mu, barc_sq),
                              torch.ones_like(chi2_cr)) * cross["valid"]

    # unified coarse edge list: separators + crossing intra edges
    # endpoints as (robot, local pose index); separator weights dynamic
    r0 = torch.cat([sep["r0"], cross["r"]])
    k0 = torch.cat([sep["k0"], cross["ki"]])
    r1 = torch.cat([sep["r1"], cross["r"]])
    k1 = torch.cat([sep["k1"], cross["kj"]])
    meas = torch.cat([sep["meas"], cross["meas"]])
    si = torch.cat([sep["sqrt_info"], cross["sqrt_info"]])
    w = torch.cat([w_sep, w_cross])
    s0 = torch.clamp(k0 // seg_len, max=M - 1)
    s1 = torch.clamp(k1 // seg_len, max=M - 1)
    v0 = r0 * M + s0
    v1 = r1 * M + s1
    sqrt_w = torch.sqrt(w)
    si_w = si * sqrt_w[:, None]
    meas_inv = se3.inverse(meas)
    P0 = all_poses[r0, k0]
    P1 = all_poses[r1, k1]
    eye = torch.eye(4, dtype=dtype, device=dev)
    prior_strong = torch.full((6,), 1e6, dtype=dtype, device=dev)

    H = eye.expand(R, M, 4, 4)
    for _ in range(iters):
        # current corrected endpoint poses: pose k of robot r moves by
        # H[r, k // seg_len]
        X0 = H[r0, s0] @ P0
        X1 = H[r1, s1] @ P1
        e_raw = se3.log(meas_inv @ se3.inverse(X0) @ X1)
        # J1 = Jr_inv(e) Ad(X1^-1); J0 = -J1
        J1 = se3.se3_jr_inv(e_raw) @ se3.adjoint(se3.inverse(X1))
        J1w = si_w[:, :, None] * J1                       # [E, 6, 6]
        ew = e_raw * si_w
        A = J1w.transpose(1, 2) @ J1w
        g = torch.einsum("eai,ea->ei", J1w, ew)
        Hb = torch.zeros((V, V, 6, 6), dtype=dtype, device=dev)
        Hb.index_put_((v1, v1), A, accumulate=True)
        Hb.index_put_((v0, v0), A, accumulate=True)
        Hb.index_put_((v0, v1), -A, accumulate=True)
        Hb.index_put_((v1, v0), -A, accumulate=True)
        b = torch.zeros((V, 6), dtype=dtype, device=dev)
        b.index_add_(0, v1, g)
        b.index_add_(0, v0, -g)
        Hmat = Hb.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
        # gauge prior: pin robot 0 segment 0 hard, weak pull to I
        # elsewhere. The weak jitter scales with the Hessian: crossing-edge
        # rows contribute O(1e8) diagonal entries, and a FIXED 1e-3 sits
        # below f32 epsilon relative to that, so with every separator
        # TLS-cut the inter-robot blocks are exactly singular and the f32
        # solve returns NaN.
        weak = torch.clamp(1e-6 * torch.max(torch.abs(torch.diagonal(Hmat))),
                           min=1e-3)
        prior = torch.cat([prior_strong,
                           torch.ones(6 * (V - 1), dtype=dtype, device=dev)
                           * weak])
        Hmat = Hmat + torch.diag(prior)
        step = torch.linalg.solve_ex(Hmat, b.reshape(6 * V))[0]
        delta = -step.reshape(V, 6)
        # the coarse level is a bias-free accelerator: a numerically failed
        # solve must degrade to "no correction", never poison the state
        delta = torch.where(torch.all(torch.isfinite(delta)), delta,
                            torch.zeros_like(delta))
        H = (se3.exp(delta) @ H.reshape(V, 4, 4)).reshape(R, M, 4, 4)

    Np = all_poses.shape[1]
    seg_of = torch.clamp(torch.arange(Np, device=dev) // seg_len, max=M - 1)
    return H[:, seg_of] @ all_poses


# ---------------------------------------------------------------------------
# Local solves: one batched LM over the robots of a StackedMesh
# ---------------------------------------------------------------------------


def _flatten(g: PoseGraphArrays) -> PoseGraphArrays:
    """R stacked subgraphs as ONE graph of R*Np nodes (node indices offset
    by r*Np): the robots' edges never meet, so the centralized solver's
    per-edge linearization and scatter-add assembly serve them as they
    are."""
    R, Np = g.poses.shape[:2]
    off = (torch.arange(R, device=g.poses.device) * Np)[:, None]
    return PoseGraphArrays(
        poses=g.poses.reshape(R * Np, 4, 4),
        node_valid=g.node_valid.reshape(-1),
        edge_i=(g.edge_i + off).reshape(-1),
        edge_j=(g.edge_j + off).reshape(-1),
        meas=g.meas.reshape(-1, 4, 4),
        sqrt_info=g.sqrt_info.reshape(-1, 6),
        edge_valid=g.edge_valid.reshape(-1),
        robust=g.robust.reshape(-1),
        prior_idx=(g.prior_idx + off).reshape(-1),
        prior_pose=g.prior_pose.reshape(-1, 4, 4),
        prior_sqrt_info=g.prior_sqrt_info.reshape(-1, 6),
        prior_valid=g.prior_valid.reshape(-1))


def _robot_costs(poses: torch.Tensor, gf: PoseGraphArrays,
                 weights: torch.Tensor, R: int) -> torch.Tensor:
    """``solver.cost`` of each robot of a flattened graph: ``[R]``."""
    r = solver.edge_residuals(poses, gf)
    rp = solver.prior_residuals(poses, gf)
    return 0.5 * (torch.sum((weights[:, None] * r * r).reshape(R, -1), 1)
                  + torch.sum((rp * rp).reshape(R, -1), 1))


def _batched_init(s, o, robots, **_):
    gf, w = solver._graph_of(o), o["weights"]
    dev = gf.poses.device
    iters = torch.zeros(robots, dtype=torch.int64, device=dev)
    active = iters < o["caps"][0]
    return {"poses": gf.poses, "current": _robot_costs(gf.poses, gf, w,
                                                       robots),
            "lam": o["tols"][:1].repeat(robots), "active": active,
            "iters": iters, "status": _batched_status(active, iters)}


def _batched_status(active, iters):
    zero = torch.zeros_like(iters[0])
    return solver._status(~torch.any(active), torch.amax(iters), zero, zero)


def _batched_step(s, o, robots, steps=1, **_):
    """``steps`` iterations of every robot's LM, each update selected by
    the robot's ``active`` flag (cleared at its stop or its cap)."""
    gf, w = solver._graph_of(o), o["weights"]
    R = robots
    N, Ne = gf.poses.shape[0], gf.edge_i.shape[0]
    Np = N // R
    dtype, dev = gf.poses.dtype, gf.poses.device
    we = w * gf.edge_valid
    node_robot = torch.arange(N, device=dev) // Np
    edge_robot = torch.arange(Ne, device=dev) // (Ne // R)
    ei, ej = gf.edge_i % Np, gf.edge_j % Np
    nodes = torch.arange(Np, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    poses, current, lam = s["poses"], s["current"], s["lam"]
    active, iters = s["active"], s["iters"]
    for _ in range(steps):
        r, Ji, Jj, rp, Jp = solver._linearize(poses, gf)
        grad = solver._assemble_grad(gf, Ji, Jj, Jp, r * we[:, None], rp)
        D = solver._hessian_blocks(gf, Ji, Jj, Jp, w)
        diag_h = torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-8)
        # the dense normal equations of every robot: solver's
        # _dense_normal_solve with a leading robot axis
        JiT_Jj = Ji.transpose(1, 2) @ Jj * we[:, None, None]
        H = torch.zeros((R, Np, Np, 6, 6), dtype=dtype, device=dev)
        H.index_put_((edge_robot, ei, ej), JiT_Jj, accumulate=True)
        H.index_put_((edge_robot, ej, ei), JiT_Jj.transpose(1, 2),
                     accumulate=True)
        damp = (lam[node_robot][:, None, None] * diag_h[:, :, None]
                * eye6[None])
        H[:, nodes, nodes] += (D + damp).reshape(R, Np, 6, 6)
        Hm = H.permute(0, 1, 3, 2, 4).reshape(R, Np * 6, Np * 6)
        L, info = torch.linalg.cholesky_ex(Hm)
        # two triangular solves (cuBLAS), not the batched cholesky_solve
        # (MAGMA on the card, which a CUDA graph may not capture)
        y = torch.linalg.solve_triangular(L, -grad.reshape(R, Np * 6, 1),
                                          upper=False)
        delta = torch.linalg.solve_triangular(L.mT, y, upper=True)
        delta = torch.where((info == 0)[:, None, None], delta,
                            torch.full_like(delta, float("nan")))
        delta = delta.reshape(R * Np, 6) * gf.node_valid[:, None]

        candidate = se3.retract(poses, delta)
        new = _robot_costs(candidate, gf, w, R)
        accept = new < current
        take = accept & active
        poses = torch.where(take[node_robot][:, None, None], candidate,
                            poses)
        step_small = torch.amax(torch.abs(delta).reshape(R, -1), 1) < 1e-7
        # converged when the cost stops moving, whether or not the step
        # was accepted
        converged = (torch.abs(current - new)
                     < o["tols"][1] * (current + 1e-12))
        current = torch.where(take, new, current)
        lam = torch.where(active, torch.clamp(
            torch.where(accept, lam * 0.3, lam * 5.0), 1e-9, 1e7), lam)
        iters = iters + active.to(torch.int64)
        active = active & ~(step_small | converged) & (iters < o["caps"][0])
    return {"poses": poses, "current": current, "lam": lam,
            "active": active, "iters": iters,
            "status": _batched_status(active, iters)}


BATCHED_GRAPHS = StepGraphs("batched_lm", {"init": _batched_init,
                                           "step": _batched_step})


@highest_precision
def _batched_lm(g: PoseGraphArrays, weights: torch.Tensor,
                max_iters: int = 50, init_lambda: float = 1e-4,
                rel_tol: float = 1e-7, *, eager: bool = False):
    """``solver.lm_optimize`` on each of R stacked subgraphs (dense tier,
    ``Np <= solver._DENSE_SOLVE_MAX_NODES``) at once.

    Each robot keeps its own damping, cost, accept/reject and stop, as the
    JAX package's per-device ``while_loop`` did: a stopped robot is frozen
    by a mask, so its poses and iteration count are those ``lm_optimize``
    gives on that robot alone. Per iteration: one linearization over the R
    blocks, one batched Cholesky of ``[R, 6Np, 6Np]`` (a robot whose
    matrix is not positive definite gets a NaN step and rejects it, without
    a host read). The iteration is a step program (:data:`BATCHED_GRAPHS`,
    captured once per tier on CUDA) driven as ``solver.lm_optimize``'s
    dense steps: one step in flight, one host read per step (have all
    robots stopped?); ``eager`` launches the step unreplayed (a test's
    comparison). Returns (poses ``[R, Np, 4, 4]``, iterations ``[R]``
    int64 tensor).
    """
    R, Np = g.poses.shape[:2]
    gf = _flatten(g)
    tols, caps = solver._scalar_operands(g.poses.device, g.poses.dtype,
                                         [init_lambda, rel_tol], [max_iters])
    operands = {n: getattr(gf, n) for n in solver._GRAPH_FIELDS}
    operands.update(weights=weights.reshape(-1), tols=tols, caps=caps)
    with BATCHED_GRAPHS.solve(g.poses.device, operands, eager=eager,
                              robots=R, steps=solver._LM_STEPS) as loop:
        solver._run_steps(loop)
        poses, iters = loop.take("poses", "iters")
    return poses.reshape(R, Np, 4, 4), iters


def _local_solve(g: PoseGraphArrays, weights: torch.Tensor, lm_iters: int,
                 cg_iters: int):
    """The local LM solves of one sweep, over the owned robots ``[n, ...]``:
    :func:`_batched_lm` on the dense tier with more than one robot, else
    ``solver.lm_optimize`` per robot (a rank's one block; the PCG tier
    above 512 nodes, whose batching is later work). Returns (poses
    ``[n, Np, 4, 4]``, iterations ``[n]``)."""
    n, Np = g.poses.shape[:2]
    if n > 1 and Np <= solver._DENSE_SOLVE_MAX_NODES:
        return _batched_lm(g, weights, max_iters=lm_iters)
    poses, iters = [], []
    for j in range(n):
        res = solver.lm_optimize(
            PoseGraphArrays(**{f.name: getattr(g, f.name)[j]
                               for f in dataclasses.fields(g)}),
            weights[j], max_iters=lm_iters, cg_iters=cg_iters)
        poses.append(res.poses)
        iters.append(res.iterations)
    return torch.stack(poses), torch.tensor(iters, device=g.poses.device)


def _local_chi2(poses: torch.Tensor, g: PoseGraphArrays) -> torch.Tensor:
    """Whitened squared residuals of the owned robots' edges: ``[n, Ne]``."""
    n, Np = poses.shape[:2]
    gf = _flatten(dataclasses.replace(g, poses=poses))
    r = solver.edge_residuals(gf.poses, gf)
    return torch.sum(r * r, dim=-1).reshape(n, -1)


# ---------------------------------------------------------------------------
# The Gauss-Seidel sweep
# ---------------------------------------------------------------------------


def _sweep(mesh: RobotMesh, local: PoseGraphArrays, sep: dict,
           mu: torch.Tensor, coarse_on: bool, *, lm_iters: int,
           cg_iters: int, barc_sq: float, coarse_iters: int = 3):
    """One sweep: (owned blocks, separators, mu, coarse_on) -> (new owned
    poses ``[n, Np, 4, 4]``, replicated separator TLS weights ``[S]``, LM
    iterations ``[n]``).

    Coarse segment-rigid alignment (replicated tiny GN over the separator
    graph + segment-crossing intra edges, :func:`_coarse_alignment`), then
    the local robust LM block solve of every owned robot.
    """
    segments = int(sep.get("coarse_segments", 1))
    seg_len = int(sep.get("coarse_seg_len", 1 << 30))
    dev = local.poses.device
    me = torch.tensor(mesh.owned, dtype=torch.int64, device=dev)
    all_poses = mesh.all_gather(local.poses)          # [R, Np, 4, 4]

    # GNC weights at the current estimate (for the coarse stage).
    # NOTE: the TLS surrogate's mid-zone weight goes to ~0 as mu -> 0, NOT
    # to 1: any phase needing weight 1 must run at mu where
    # lower = mu/(mu+1)*barc_sq covers the expected chi2 (the init sweeps
    # use mu = 1).
    def _sep_weights(chi2):
        """TLS weights at the current mu, optionally overridden by a
        previous round's carried classification (``carry_on`` is 1 only
        during the init gating sweep, and only separators present last
        round, ``carry_known``, are overridden)."""
        w = _tls(chi2, mu, barc_sq)
        if "w_carry" in sep:
            carried = torch.where(sep["carry_known"] > 0, sep["w_carry"], w)
            w = torch.where(sep["carry_on"] > 0, carried, w)
        return torch.where(sep["valid"] > 0, w, torch.zeros_like(w))

    _, chi2_pre = _sep_residuals(all_poses, sep)
    w_pre = _sep_weights(chi2_pre)
    # coarse two-level accelerator (identical replicated computation for
    # every holder); bias-free, so it can run every sweep
    if coarse_iters > 0 and coarse_on:
        all_poses = _coarse_alignment(
            all_poses, sep, w_pre, sep.get("cross"), mesh.size, segments,
            seg_len, mu=mu, barc_sq=barc_sq, iters=coarse_iters)
    my_poses = all_poses[me]

    idx, target, info, valid = _separator_priors(me, all_poses, sep)
    # re-derive TLS weights post-alignment. chi2 is the CANONICAL whitened
    # residual from the global pose blocks, identical for both endpoints
    # (the two per-endpoint prior residuals are Ad(Z)-conjugate, not
    # equal, so weighting each endpoint by its own chi2 can cut an edge on
    # one side and keep it on the other near the TLS boundary)
    _, chi2_canon = _sep_residuals(all_poses, sep)
    w_canon = _sep_weights(chi2_canon)
    w_sep = torch.where(valid > 0, w_canon[None], torch.zeros_like(valid))
    info = info * torch.sqrt(w_sep)[..., None]
    # damped consensus: pull each endpoint only to the geodesic midpoint
    # between its current pose and the neighbor-implied pose. Both
    # endpoints update at once (Jacobi), so undamped targets overshoot and
    # the sweep two-cycles; the half-step makes the symmetric exchange
    # exact in one sweep, and the sqrt(2) info scaling restores the exact
    # force balance so the fixed point is the undamped joint optimum.
    rows = torch.arange(me.shape[0], device=dev)[:, None]
    mine = my_poses[rows, idx]
    target = mine @ se3.exp(0.5 * se3.log(se3.between(mine, target)))
    info = info * math.sqrt(2.0)

    B = local.prior_idx.shape[1]
    S = idx.shape[1]
    if S > B - 1:
        raise ValueError(f"{S} separator slots do not fit the prior tier "
                         f"{B} (one slot is the self-anchor)")
    g_local = dataclasses.replace(
        local, poses=my_poses,
        prior_idx=torch.cat([local.prior_idx[:, :1], idx,
                             local.prior_idx[:, 1 + S:]], 1),
        prior_pose=torch.cat([local.prior_pose[:, :1], target,
                              local.prior_pose[:, 1 + S:]], 1),
        prior_sqrt_info=torch.cat([local.prior_sqrt_info[:, :1], info,
                                   local.prior_sqrt_info[:, 1 + S:]], 1),
        prior_valid=torch.cat([local.prior_valid[:, :1], valid,
                               local.prior_valid[:, 1 + S:]], 1))
    # GNC over robust local edges (intra-robot loop closures)
    chi2_loc = _local_chi2(my_poses, g_local)
    weights = torch.where(g_local.robust > 0, _tls(chi2_loc, mu, barc_sq),
                          torch.ones_like(chi2_loc))
    poses, iters = _local_solve(g_local, weights, lm_iters, cg_iters)
    return poses, w_canon, iters


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_distributed_step(mesh: RobotMesh, lm_iters: int = 15,
                          cg_iters: int = 100, barc_sq: float = 16.81):
    """The one-sweep function over the given mesh.

    The returned callable maps (owned stacked arrays, separators, mu,
    coarse=True) -> updated owned arrays; call it in a loop for
    Gauss-Seidel iterations with a growing GNC ``mu``. Each robot
    TLS-reweights its incident separator priors and its robust local edges
    from their current chi2, so gross outlier inter-robot loop closures
    are rejected without any central aggregation.

    Prefer :func:`make_distributed_solve` (the whole robust solve with a
    convergence criterion); this per-sweep form remains for diagnostics
    like the sweeps-to-parity curve.
    """
    @highest_precision
    def step(local: PoseGraphArrays, sep: dict, mu,
             coarse: bool = True) -> PoseGraphArrays:
        poses, _, _ = _sweep(mesh, local, sep, _f32(mu, mesh.device),
                             bool(coarse), lm_iters=lm_iters,
                             cg_iters=cg_iters, barc_sq=barc_sq)
        return dataclasses.replace(local, poses=poses)

    return step


def make_distributed_solve(mesh: RobotMesh, max_sweeps: int = 30,
                           lm_iters: int = 15, cg_iters: int = 100,
                           barc_sq: float = 16.81,
                           mu0: Optional[float] = None,
                           mu_step: float = 1.6, tol: float = 1e-3,
                           final_lm_iters: int = 25, init_sweeps: int = 2,
                           mu0_chi2_cap: float = 500.0,
                           coarse_sweeps: int = 1 << 30):
    """The FULL robust distributed solve.

    Runs Gauss-Seidel sweeps until converged (bounded by ``max_sweeps``),
    mirroring the centralized ``gnc_optimize``'s stopping semantics plus
    the block-coordinate one:

    - separator TLS weights are binary (all 0/1 within 1e-3) or stable
      (max change < 1e-3 from the previous sweep), AND
    - the pose blocks have stopped moving (max |entry change| < ``tol``
      over every robot).

    A final full-budget sweep polishes the blocks at the converged weights
    (the analogue of gnc_optimize's final LM polish). Returns
    ``(poses [R, Np, 4, 4] of every robot, sweeps_used, final_delta,
    sep_weights)``.
    """
    def solve(local: PoseGraphArrays, sep: dict):
        return _solve(mesh, local, sep, max_sweeps=max_sweeps,
                      lm_iters=lm_iters, cg_iters=cg_iters,
                      final_lm_iters=final_lm_iters, barc_sq=barc_sq,
                      mu0=mu0, mu_step=mu_step, tol=tol,
                      init_sweeps=init_sweeps, mu0_chi2_cap=mu0_chi2_cap,
                      coarse_sweeps=coarse_sweeps)[:4]

    return solve


@highest_precision
def _solve(mesh: RobotMesh, local: PoseGraphArrays, sep: dict, *,
           max_sweeps, lm_iters, cg_iters, barc_sq, mu0, mu_step, tol,
           init_sweeps, final_lm_iters=25, mu0_chi2_cap=500.0,
           coarse_sweeps=1 << 30):
    """:func:`make_distributed_solve`'s body; also returns the LM
    iterations of every owned robot summed over the sweeps (a tensor).

    Under ``highest_precision``: every product here (coarse normal
    equations, canonical separator chi2, geodesic midpoints, adaptive mu0)
    must run at full f32, since TF32 passes degrade chi2 enough to flip
    TLS weights near the inlier boundary."""
    dev = local.poses.device

    def sweep(poses, sep_, mu, coarse_on, iters):
        return _sweep(mesh, dataclasses.replace(local, poses=poses), sep_,
                      mu, coarse_on, lm_iters=iters, cg_iters=cg_iters,
                      barc_sq=barc_sq)

    nb_sep = sep["valid"].shape[0]

    def _with_carry(on):
        """Enable the carried-classification override (warm steady state)
        only during the init gating sweep(s)."""
        if "w_carry" not in sep:
            return sep
        return {**sep, "carry_on": _f32(on, dev)}

    sep_init, sep_run = _with_carry(1.0), _with_carry(0.0)
    lm_total = torch.zeros(len(mesh.owned), dtype=torch.int64, device=dev)

    # phase 0: ROBUST init sweeps at mu = 1: TLS weight 1 for edges with
    # chi2 below barc_sq/2, smoothly to 0 beyond 2*barc_sq, i.e. plausible
    # edges count fully while gross outliers are excluded (forcing weight
    # 1 on everything lets an outlier separator yank two blocks together).
    # A genuine edge cut here re-enters later: mu0 below comes from its
    # post-init chi2 with a wide cap.
    poses = local.poses
    for _ in range(init_sweeps):
        poses, _w, it = sweep(poses, sep_init, _f32(1.0, dev), True,
                              lm_iters)
        lm_total += it

    # adaptive mu0 from the initialized estimate, GTSAM-style, over EVERY
    # robust residual (separators AND robust intra-robot loop closures,
    # since the same mu drives TLS on both)
    if mu0 is None:
        _, chi2_sep = _sep_residuals(mesh.all_gather(poses), sep)
        sep_keep = sep["valid"] > 0
        if "w_carry" in sep:
            # warm steady state: separators the previous round already
            # classified as outliers must not drive mu0 down (their huge,
            # expected chi2 would force a full re-graduation every round);
            # a falsely-carried classification leaves genuine separators
            # with large chi2, so graduation re-runs and self-corrects
            known_out = (sep["carry_known"] > 0) & (sep["w_carry"] < 0.5)
            sep_keep = sep_keep & ~known_out
        sep_max = torch.max(torch.where(sep_keep, chi2_sep,
                                        torch.zeros_like(chi2_sep)))
        chi2_loc = _local_chi2(poses, local)                 # [n, Ne]
        loc_keep = local.robust * local.edge_valid > 0
        if "w_carry" in sep:
            # intra-robot loop closures GROSS at the warm poses were
            # hard-TLS-cut by the previous round; moderate chi2 stays in
            # the max so a NEW genuine edge still graduates
            loc_keep = loc_keep & (chi2_loc <= _WARM_INTRA_GROSS * barc_sq)
        loc_max = mesh.all_reduce_max(torch.max(torch.where(
            loc_keep, chi2_loc, torch.zeros_like(chi2_loc))))
        max_chi2 = torch.clamp(torch.maximum(sep_max, loc_max),
                               max=mu0_chi2_cap * barc_sq)
        mu = torch.where(max_chi2 > barc_sq,
                         barc_sq / (2.0 * max_chi2 - barc_sq),
                         _f32(1e6, dev))
        mu = torch.clamp(mu, min=1e-6).to(torch.float32)
    else:
        mu = _f32(mu0, dev)

    sweeps = 0
    w = torch.zeros(nb_sep, dtype=torch.float32, device=dev)
    delta = _f32(float("inf"), dev)
    while sweeps < max_sweeps:
        w_prev = w
        new_poses, w, it = sweep(poses, sep_run, mu, sweeps < coarse_sweeps,
                                 lm_iters)
        lm_total += it
        # over every robot: a holder that stopped one sweep early would
        # deadlock the next all_gather
        delta = mesh.all_reduce_max(torch.max(torch.abs(new_poses - poses)))
        binary = torch.all((w < 1e-3) | (w > 1.0 - 1e-3))
        stable = torch.max(torch.abs(w - w_prev)) < 1e-3
        done = (binary | stable) & (delta < tol)
        poses = new_poses
        mu = torch.clamp(mu * mu_step, max=1e6)
        sweeps += 1
        if bool(done):
            break
    # final polish sweep at full LM budget and the converged mu
    poses, w, it = sweep(poses, sep_run, mu, False, final_lm_iters)
    lm_total += it
    return mesh.all_gather(poses), sweeps, delta, w, lm_total


class DistributedInfo:
    """Convergence diagnostics of one distributed solve."""

    def __init__(self, sweeps_used: int, final_delta: float,
                 sep_weights: np.ndarray,
                 sep_weight_by_key: Optional[Dict] = None,
                 lm_iterations: int = 0):
        self.sweeps_used = sweeps_used
        self.final_delta = final_delta
        self.sep_weights = sep_weights
        #: {((r0, kf0), (r1, kf1)): weight}: feed back into the next
        #: round's ``distributed_optimize(carried_weights=...)``
        self.sep_weight_by_key = sep_weight_by_key or {}
        #: LM iterations of this process's robots, summed over the sweeps
        self.lm_iterations = lm_iterations

    def __repr__(self):
        return (f"DistributedInfo(sweeps_used={self.sweeps_used}, "
                f"final_delta={self.final_delta:.2e})")


def distributed_optimize(problem: ShardedPoseGraph, mesh: RobotMesh,
                         sweeps: int = 30, lm_iters: int = 15,
                         cg_iters: int = 100, mu0: Optional[float] = None,
                         mu_step: float = 1.6, barc_sq: float = 16.81,
                         tol: float = 1e-3, return_info: bool = False,
                         warm: bool = False,
                         carried_weights: Optional[Dict] = None):
    """Run robust block Gauss-Seidel PGO over the mesh.

    The whole robust solve (GNC mu schedule, separator reweighting,
    Gauss-Seidel sweeps, convergence check, final polish, see
    :func:`make_distributed_solve`); ``sweeps`` is the upper bound.

    ``warm=True`` is the incremental steady-state mode: the problem's
    variable poses are a previous round's solution, so one robust gating
    sweep replaces the two init sweeps and graduation starts at saturated
    mu (hard TLS), the distributed analogue of the centralized
    ``gnc_reoptimize``.

    ``carried_weights`` (warm mode) maps separator identity
    ``((r0, kf0), (r1, kf1))`` (see :meth:`ShardedPoseGraph.separator_keys`)
    to the previous round's TLS weight. During the warm gating sweep those
    separators use the carried classification directly; separators not in
    the map get the normal mu = 1 gate. Afterwards every weight is
    re-derived from the current estimate (mu0 from the post-gating chi2
    EXCLUDING known outliers), so a falsely-carried classification
    self-corrects rather than persisting.

    Every process of a process-group mesh calls this with the same
    problem; each returns every robot's values. Returns the optimized
    values dict, or ``(values, DistributedInfo)`` when ``return_info`` is
    set.
    """
    local, sep = problem.to_device_arrays(mesh)
    sep_keys = problem.separator_keys()
    if carried_weights:
        nb_sep = sep["valid"].shape[0]
        w_carry = np.ones(nb_sep, np.float32)
        known = np.zeros(nb_sep, np.float32)
        for i, k in enumerate(sep_keys):
            if k in carried_weights:
                w_carry[i] = carried_weights[k]
                known[i] = 1.0
        sep = {**sep, "w_carry": torch.from_numpy(w_carry).to(mesh.device),
               "carry_known": torch.from_numpy(known).to(mesh.device)}
    if warm:
        if mu0 is not None:
            raise ValueError("warm=True derives mu0 itself; don't mix")
        init_sweeps = 1
        if not carried_weights:
            mu0 = 1e6
    else:
        init_sweeps = 2
    poses, sweeps_used, delta, w, lm_total = _solve(
        mesh, local, sep, max_sweeps=sweeps, lm_iters=lm_iters,
        cg_iters=cg_iters, barc_sq=barc_sq, mu0=mu0, mu_step=mu_step,
        tol=tol, init_sweeps=init_sweeps)
    values = problem.values_from_arrays(poses)
    if return_info:
        w_np = w.cpu().numpy()
        info = DistributedInfo(
            int(sweeps_used), float(delta), w_np,
            {k: float(w_np[i]) for i, k in enumerate(sep_keys)},
            int(lm_total.sum()))
        return values, info
    return values

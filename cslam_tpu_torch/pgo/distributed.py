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
as follows. On a ``StackedMesh`` (every robot in one process) the local
solves of one sweep are ONE batched Levenberg-Marquardt, each robot with
its own damping, accept/reject and stop, as each device's ``while_loop``
had: one linearization over the R blocks and one batched Cholesky per
iteration up to 512 local poses (:func:`_batched_lm`), a batched
coarse-corrected PCG with per-robot CG scalars above
(:func:`_batched_pcg_lm`). The whole robust solve (init sweeps, adaptive
mu0, sweep loop with its stop test, polish) is one plan of step programs
(:data:`DIST_GRAPHS`, :func:`_solve_steps`): on CUDA one launch of a
graph whose sweep, LM and CG loops are nested WHILE nodes, with no host
read until the results are read. On a ``ProcessGroupMesh`` (host
collectives) the host drives the sweeps (:func:`_solve_host`, one read
per sweep) and each rank runs ``pgo.solver.lm_optimize`` on its own
block; :func:`_solve_host` is also the plain version of the plan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch.ops import highest_precision, se3
from cslam_tpu_torch.ops.segment_sum import (plan_from, plan_operands,
                                             segment_plan, segment_sum)
from cslam_tpu_torch.pgo import solver
from cslam_tpu_torch.pgo.factor_graph import (FactorGraph, PoseGraphArrays,
                                              _tier)
from cslam_tpu_torch.types import PoseGraphEdge, PoseKey
from cslam_tpu_torch.utils.robot_mesh import (AXIS, RobotMesh,  # noqa: F401
                                              StackedMesh)
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


def _separator_slots(me: torch.Tensor, sep: dict):
    """Which separators are incident to each robot of ``me`` ``[n]``, and
    at which of its poses: (on_r0 [n, S], incident [n, S], my_idx [n,
    S]). Fixed per problem (no pose enters)."""
    on_r0 = sep["r0"][None] == me[:, None]
    on_r1 = sep["r1"][None] == me[:, None]
    incident = (on_r0 | on_r1) & (sep["valid"] > 0)
    return on_r0, incident, torch.where(on_r0, sep["k0"], sep["k1"])


def _separator_priors(me: torch.Tensor, all_poses: torch.Tensor, sep: dict):
    """Turn inter-robot edges incident to each robot of ``me`` ``[n]`` into
    absolute priors. Returns (idx [n, S], target [n, S, 4, 4], sqrt_info
    [n, S, 6], valid [n, S])."""
    on_r0, incident, my_idx = _separator_slots(me, sep)
    other_rid = torch.where(on_r0, sep["r1"], sep["r0"])
    other_idx = torch.where(on_r0, sep["k1"], sep["k0"])
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


def _coarse_edges(sep: dict, cross: dict, segments: int, seg_len: int):
    """The coarse level's edge list, separators then crossing intra edges:
    endpoints (r0, k0, r1, k1), their coarse vertices ``r * segments +
    segment`` (v0, v1) and their segments (s0, s1)."""
    M = segments
    r0 = torch.cat([sep["r0"], cross["r"]])
    k0 = torch.cat([sep["k0"], cross["ki"]])
    r1 = torch.cat([sep["r1"], cross["r"]])
    k1 = torch.cat([sep["k1"], cross["kj"]])
    s0 = torch.clamp(k0 // seg_len, max=M - 1)
    s1 = torch.clamp(k1 // seg_len, max=M - 1)
    return r0, k0, r1, k1, r0 * M + s0, r1 * M + s1, s0, s1


def _no_cross(dtype, dev) -> dict:
    """The crossing-edge slot of problems built before the coarse
    metadata existed: one invalid edge."""
    return {"r": torch.zeros(1, dtype=torch.int64, device=dev),
            "ki": torch.zeros(1, dtype=torch.int64, device=dev),
            "kj": torch.zeros(1, dtype=torch.int64, device=dev),
            "meas": torch.eye(4, dtype=dtype, device=dev)[None],
            "sqrt_info": torch.ones((1, 6), dtype=dtype, device=dev),
            "valid": torch.zeros(1, dtype=dtype, device=dev)}


def _coarse_plans(sep: dict, nb_robots: int, segments: int,
                  seg_len: int) -> dict:
    """The coarse alignment's segment plans (``ops.segment_sum``), fixed
    per problem: ``pair``, the ``[V, V]`` blocks (v1, v1), (v0, v0), (v0,
    v1), (v1, v0) of every valid coarse edge into ``[V * V]``; ``node``,
    the right-hand side's (v1; v0) into ``[V]`` (V = robots x
    segments)."""
    cross = sep.get("cross") or _no_cross(sep["meas"].dtype,
                                          sep["meas"].device)
    *_, v0, v1, _, _ = _coarse_edges(sep, cross, segments, seg_len)
    V = nb_robots * segments
    valid = torch.cat([sep["valid"], cross["valid"]]) > 0
    return {"pair": segment_plan(
                torch.cat([v1 * V + v1, v0 * V + v0, v0 * V + v1,
                           v1 * V + v0]), valid.repeat(4), V * V,
                compact=True),
            "node": segment_plan(torch.cat([v1, v0]), valid.repeat(2), V)}


def _coarse_alignment(all_poses: torch.Tensor, sep: dict,
                      w_sep: torch.Tensor, cross: Optional[dict],
                      nb_robots: int, segments: int, seg_len: int, mu=None,
                      barc_sq: float = 16.81, iters: int = 3) -> torch.Tensor:
    """:func:`_coarse_alignment_counted`'s aligned blocks alone."""
    return _coarse_alignment_counted(all_poses, sep, w_sep, cross, nb_robots,
                                     segments, seg_len, mu, barc_sq,
                                     iters)[0]


def _coarse_alignment_counted(all_poses: torch.Tensor, sep: dict,
                              w_sep: torch.Tensor, cross: Optional[dict],
                              nb_robots: int, segments: int, seg_len: int,
                              mu=None, barc_sq: float = 16.81,
                              iters: int = 3):
    """Aggregation-multigrid coarse level: one rigid SE(3) correction per
    CHAIN SEGMENT (``segments`` per robot), solved as a replicated tiny
    Gauss-Newton problem and applied to the gathered pose blocks.

    The coarse objective is the full objective restricted to the coarse
    space: rigid segment motions leave within-segment odometry invariant,
    so only (a) the weighted separators and (b) the intra-robot edges that
    CROSS a segment boundary (precomputed in ``cross``) appear, which
    makes the joint optimum a stationary point of the coarse problem
    (H = I): the accelerator is bias-free and can run every sweep.

    The normal equations are summed block by block in a fixed order
    (``sep["plans"]``, which the step programs pass, or
    :func:`_coarse_plans` made here; the JAX package formed the
    ``[E, 6, V, 6]`` Jacobian with one-hot matmuls) and solved by
    Cholesky (:func:`_coarse_step`; the JAX package: ``linalg.solve``); a
    failed solve (non-finite step) leaves that iteration's correction at
    identity without a host read. ``6 * R * segments`` unknowns, a dense
    solve. Returns (the aligned blocks, the iterations whose Cholesky
    failed as a 0-d int64).
    """
    R = nb_robots
    M = segments
    V = R * M
    dtype, dev = all_poses.dtype, all_poses.device
    if cross is None:  # problems built before the coarse metadata existed
        cross = _no_cross(dtype, dev)
    plans = sep.get("plans")
    if plans is None:
        plans = _coarse_plans({**sep, "cross": cross}, R, M, seg_len)

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
    r0, k0, r1, k1, _, _, s0, s1 = _coarse_edges(sep, cross, M, seg_len)
    meas = torch.cat([sep["meas"], cross["meas"]])
    si = torch.cat([sep["sqrt_info"], cross["sqrt_info"]])
    w = torch.cat([w_sep, w_cross])
    sqrt_w = torch.sqrt(w)
    si_w = si * sqrt_w[:, None]
    meas_inv = se3.inverse(meas)
    P0 = all_poses[r0, k0]
    P1 = all_poses[r1, k1]
    eye = torch.eye(4, dtype=dtype, device=dev)
    prior_strong = torch.full((6,), 1e6, dtype=dtype, device=dev)

    H = eye.expand(R, M, 4, 4)
    failures = torch.zeros((), dtype=torch.int64, device=dev)
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
        A = (J1w.transpose(1, 2) @ J1w).reshape(-1, 36)
        g = torch.einsum("eai,ea->ei", J1w, ew)
        Hb = segment_sum(torch.cat([A, A, -A, -A]), plans["pair"],
                         rows=V * V).reshape(V, V, 6, 6)
        b = segment_sum(torch.cat([g, -g]), plans["node"])
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
        step, failed = _coarse_step(Hmat, b.reshape(6 * V, 1))
        failures = failures + failed.to(torch.int64)
        delta = -step.reshape(V, 6)
        # the coarse level is a bias-free accelerator: a numerically failed
        # solve must degrade to "no correction", never poison the state
        delta = torch.where(torch.all(torch.isfinite(delta)), delta,
                            torch.zeros_like(delta))
        H = (se3.exp(delta) @ H.reshape(V, 4, 4)).reshape(R, M, 4, 4)

    Np = all_poses.shape[1]
    seg_of = torch.clamp(torch.arange(Np, device=dev) // seg_len, max=M - 1)
    return H[:, seg_of] @ all_poses, failures


def _coarse_step(Hmat: torch.Tensor, b: torch.Tensor):
    """``Hmat^-1 b`` of the coarse alignment's system, symmetric positive
    definite by its gauge prior: Cholesky and two triangular solves
    (cuBLAS), which a CUDA graph WHILE body may hold; cuSOLVER's LU
    (``solve_ex``, the JAX package's ``linalg.solve``) allocates memory
    inside the graph at this size, which a WHILE body may not. Returns
    (the step, NaN where the factorization failed; whether it failed, a
    0-d bool)."""
    L, info = torch.linalg.cholesky_ex(Hmat)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True), info != 0


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


def _robot_sum(x: torch.Tensor, R: int) -> torch.Tensor:
    """Each robot's sum of a flattened per-node array: ``[R]``."""
    return torch.sum(x.reshape(R, -1), 1)


def _node_robot(gf: PoseGraphArrays, R: int) -> torch.Tensor:
    N = gf.poses.shape[0]
    return torch.arange(N, device=gf.poses.device) // (N // R)


def _batched_init(s, o, robots, **_):
    gf, w = solver._graph_of(o), o["weights"]
    dev = gf.poses.device
    iters = torch.zeros(robots, dtype=torch.int64, device=dev)
    active = iters < o["caps"][0]
    return {"poses": gf.poses, "current": _robot_costs(gf.poses, gf, w,
                                                       robots),
            "lam": o["tols"][:1].repeat(robots), "active": active,
            "iters": iters, "cg_total": torch.zeros_like(iters),
            "coarse_fail": torch.zeros_like(iters[0]),
            "lm_on": torch.any(active),
            "status": _batched_status(active, iters)}


def _batched_status(active, iters, cg_total=None, cg_active=None,
                    coarse_fail=None):
    zero = torch.zeros_like(iters[0])
    return solver._status(
        ~torch.any(active), torch.amax(iters),
        zero if cg_total is None else torch.amax(cg_total),
        torch.zeros_like(active[0]) if cg_active is None
        else torch.any(cg_active), coarse_fail)


def _batched_update(s, gf, w, delta, cap, rel_tol, R):
    """Every robot's retract, cost, accept/reject, damping and stop test
    for the step ``delta`` ``[R * Np, 6]``, each selected by the robot's
    ``active`` flag (cleared at its stop or its cap): ``solver._lm_update``
    with a leading robot axis."""
    node_robot = _node_robot(gf, R)
    poses, current, lam = s["poses"], s["current"], s["lam"]
    active, iters = s["active"], s["iters"]
    delta = delta * gf.node_valid[:, None]
    candidate = se3.retract(poses, delta)
    new = _robot_costs(candidate, gf, w, R)
    accept = new < current
    take = accept & active
    poses = torch.where(take[node_robot][:, None, None], candidate, poses)
    step_small = torch.amax(torch.abs(delta).reshape(R, -1), 1) < 1e-7
    # converged when the cost stops moving, whether or not the step was
    # accepted
    converged = torch.abs(current - new) < rel_tol * (current + 1e-12)
    current = torch.where(take, new, current)
    lam = torch.where(active, torch.clamp(
        torch.where(accept, lam * 0.3, lam * 5.0), 1e-9, 1e7), lam)
    iters = iters + active.to(torch.int64)
    active = active & ~(step_small | converged) & (iters < cap)
    return {"poses": poses, "current": current, "lam": lam,
            "active": active, "iters": iters, "lm_on": torch.any(active)}


def _batched_step(s, o, robots, steps=1, **_):
    """``steps`` iterations of every robot's LM (dense tier), each update
    selected by the robot's ``active`` flag (cleared at its stop or its
    cap)."""
    gf, w, plans = solver._graph_of(o), o["weights"], solver._plans_of(o)
    R = robots
    N = gf.poses.shape[0]
    Np = N // R
    dtype, dev = gf.poses.dtype, gf.poses.device
    we = w * gf.edge_valid
    node_robot = _node_robot(gf, R)
    nodes = torch.arange(Np, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    s = dict(s)
    for _ in range(steps):
        r, Ji, Jj, rp, Jp = solver._linearize(s["poses"], gf)
        grad = solver._assemble_grad(gf, Ji, Jj, Jp, r * we[:, None], rp,
                                     plans)
        D = solver._hessian_blocks(gf, Ji, Jj, Jp, w, plans)
        diag_h = torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-8)
        # the dense normal equations of every robot: solver's
        # _dense_normal_solve with a leading robot axis
        H = solver._off_diagonal_blocks(gf, Ji, Jj, w, plans, R).reshape(
            R, Np, Np, 6, 6)
        damp = (s["lam"][node_robot][:, None, None] * diag_h[:, :, None]
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
        s.update(_batched_update(s, gf, w, delta.reshape(R * Np, 6),
                                 o["caps"][0], o["tols"][1], R))
    out = {k: s[k] for k in ("poses", "current", "lam", "active", "iters",
                             "lm_on")}
    out["status"] = _batched_status(s["active"], s["iters"])
    return out


BATCHED_GRAPHS = StepGraphs("batched_lm", {"init": _batched_init,
                                           "step": _batched_step})


@highest_precision
def _batched_lm(g: PoseGraphArrays, weights: torch.Tensor,
                max_iters: int = 50,
                init_lambda: float = solver._LM_INIT_LAMBDA,
                rel_tol: float = solver._LM_REL_TOL, *, eager: bool = False):
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
    operands.update(weights=weights.reshape(-1), tols=tols, caps=caps,
                    **solver._plan_operands(solver.segment_plans(gf, R)))
    with BATCHED_GRAPHS.solve(g.poses.device, operands, eager=eager,
                              robots=R, steps=solver._LM_STEPS) as loop:
        solver._run_steps(loop)
        poses, iters = loop.take("poses", "iters")
    return poses.reshape(R, Np, 4, 4), iters


# -- the PCG tier, batched ---------------------------------------------------
#
# ``solver``'s PCG-tier LM (``_lm_head``, ``_cg_block``, ``_lm_tail``) over
# the flattened ``[R * Np]`` graph, every scalar per robot: the CG's
# alpha, beta, residual norms and stop, the LM's damping, accept/reject
# and stop. Dot products and norms are summed over each robot's own nodes
# (:func:`_robot_sum`), and the coarse correction holds one ``[6S, 6S]``
# block per robot (its own segments, its own ridge and Cholesky), so no
# robot's numbers reach another's. Operands as ``_batched_lm``'s, with
# ``tols`` = [init_lambda, rel_tol, cg_tol] and ``caps`` = [max_iters,
# cg_iters].


def _batched_coarse_factor(gf, poses, Ji, Jj, Jp, weights, lam_n, diag_h,
                           R, plans):
    """``solver._coarse_factor`` of every robot at once: the Galerkin
    operator of each robot's own ``S`` segments (``solver._COARSE_SEG``
    nodes each), ``[R, 6S, 6S]``, ridged by its own largest diagonal entry
    and factored by one batched Cholesky (NaN where it failed), its blocks
    summed by ``plans`` (``seg``, ``seg_pair`` for ``R`` robots). Returns
    ``(seg, A, chol, failed)``: each node's segment in ``[R * S]``, the
    prolongation ``Ad(X_n^-1)``, the factors and which failed ``[R]``."""
    N = gf.poses.shape[0]
    Np = N // R
    S = max(1, Np // solver._COARSE_SEG)
    dtype, dev = Ji.dtype, Ji.device
    seg = solver._coarse_segments(N, R, dev)
    A = se3.adjoint(se3.inverse(poses)) * gf.node_valid[:, None, None]
    Hc, T = solver._galerkin_blocks(gf, A, Ji, Jj, Jp, weights,
                                    lam_n[:, None] * diag_h, plans,
                                    R * S * S, R)
    Hc = Hc.reshape(R, S, S, 6, 6)
    Dc = segment_sum(T.reshape(N, 36), solver._plan(plans, gf, "seg", R))
    segs = torch.arange(S, device=dev)
    Hc[:, segs, segs] += Dc.reshape(R, S, 6, 6)
    Hc = Hc.permute(0, 1, 3, 2, 4).reshape(R, S * 6, S * 6)
    ridge = (1e-7 * torch.amax(torch.diagonal(Hc, dim1=1, dim2=2), 1)
             + 1e-12)
    Hc = Hc + ridge[:, None, None] * torch.eye(S * 6, dtype=dtype,
                                               device=dev)
    chol, info = torch.linalg.cholesky_ex(Hc)
    chol = torch.where((info == 0)[:, None, None], chol,
                       torch.full_like(chol, float("nan")))
    return seg, A, chol, info != 0


def _batched_coarse_apply(seg, A, chol, r, plan):
    """``P H_c^-1 P^T r`` with every robot's own coarse block (two
    triangular solves: the batched ``cholesky_solve`` is MAGMA on the
    card), ``P^T r`` summed by the ``seg`` plan."""
    R, S6 = chol.shape[:2]
    c = segment_sum(torch.einsum("nba,nb->na", A, r), plan)
    y = torch.linalg.solve_triangular(chol, c.reshape(R, S6, 1),
                                      upper=False)
    y = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return torch.einsum("nab,nb->na", A, y.reshape(-1, 6)[seg])


def _batched_preconditioner(s, o, coarse, robots):
    plan = solver._plan(solver._plans_of(o), solver._graph_of(o), "seg",
                        robots) if coarse else None
    return solver._preconditioner(s["M_inv"], (lambda r: _batched_coarse_apply(
        s["seg"], s["A"], s["chol"], r, plan)) if coarse else None)


def _batched_cg_more(i, r, b_norm, max_iters, tol, R):
    """``solver._cg_more`` per robot."""
    return (i < max_iters) & (torch.sqrt(_robot_sum(r * r, R))
                              > tol * b_norm)


def _batched_head(s, o, robots, coarse=True, **_):
    """Every robot's LM iteration up to its solve (``solver._lm_head``):
    linearization, block-Jacobi inverses, the coarse factors and PCG's
    initial state, none to run for a robot that has stopped."""
    gf, w, plans = solver._graph_of(o), o["weights"], solver._plans_of(o)
    R = robots
    node_robot = _node_robot(gf, R)
    r, Ji, Jj, rp, Jp = solver._linearize(s["poses"], gf)
    grad = solver._assemble_grad(gf, Ji, Jj, Jp,
                                 r * (w * gf.edge_valid)[:, None], rp, plans)
    D = solver._hessian_blocks(gf, Ji, Jj, Jp, w, plans)
    diag_h = torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-8)
    lam_n = s["lam"][node_robot]
    M_inv = torch.linalg.inv_ex(
        D + lam_n[:, None, None] * diag_h[:, None]
        * torch.eye(6, dtype=D.dtype, device=D.device)[None])[0]
    out = {"Ji": Ji, "Jj": Jj, "Jp": Jp, "diag_h": diag_h, "M_inv": M_inv,
           "coarse_fail": s["coarse_fail"]}
    if coarse:
        out["seg"], out["A"], out["chol"], failed = _batched_coarse_factor(
            gf, s["poses"], Ji, Jj, Jp, w, lam_n, diag_h, R, plans)
        out["coarse_fail"] = s["coarse_fail"] + torch.sum(
            failed & s["active"])
    b = -grad
    z = _batched_preconditioner(out, o, coarse, R)(b)
    b_norm = torch.clamp(torch.sqrt(_robot_sum(b * b, R)), min=1e-30)
    cg_i = torch.zeros(R, dtype=torch.int64, device=b.device)
    cg_active = _batched_cg_more(cg_i, b, b_norm, o["caps"][1],
                                 o["tols"][2], R) & s["active"]
    out.update(x=torch.zeros_like(b), r=b, z=z, p=z,
               rz=_robot_sum(b * z, R), b_norm=b_norm, cg_i=cg_i,
               cg_active=cg_active, cg_on=torch.any(cg_active),
               status=_batched_status(s["active"], s["iters"],
                                      s["cg_total"], cg_active,
                                      out["coarse_fail"]))
    return out


def _batched_cg(s, o, robots, coarse=True, steps=solver._CG_BLOCK, **_):
    """``steps`` masked CG iterations of every robot (``solver.
    _cg_iteration`` with per-robot scalars)."""
    gf, w = solver._graph_of(o), o["weights"]
    R = robots
    node_robot = _node_robot(gf, R)
    matvec = solver._make_matvec(gf, s["Ji"], s["Jj"], s["Jp"], w,
                                 s["lam"][node_robot][:, None], s["diag_h"],
                                 solver._plans_of(o))
    apply_prec = _batched_preconditioner(s, o, coarse, R)
    max_iters, tol = o["caps"][1], o["tols"][2]
    x, r, z, p, rz = s["x"], s["r"], s["z"], s["p"], s["rz"]
    cg_i, on = s["cg_i"], s["cg_active"]
    for _ in range(steps):
        on_n = on[node_robot][:, None]
        Ap = matvec(p)
        alpha = rz / torch.clamp(_robot_sum(p * Ap, R), min=1e-30)
        a_n = alpha[node_robot][:, None]
        r_new = r - a_n * Ap
        z_new = apply_prec(r_new)
        rz_new = _robot_sum(r_new * z_new, R)
        p_new = z_new + (rz_new / torch.clamp(rz, min=1e-30))[
            node_robot][:, None] * p
        x = torch.where(on_n, x + a_n * p, x)
        r = torch.where(on_n, r_new, r)
        z = torch.where(on_n, z_new, z)
        p = torch.where(on_n, p_new, p)
        rz = torch.where(on, rz_new, rz)
        cg_i = cg_i + on.to(torch.int64)
        on = on & _batched_cg_more(cg_i, r, s["b_norm"], max_iters, tol, R)
    return {"x": x, "r": r, "z": z, "p": p, "rz": rz, "cg_i": cg_i,
            "cg_active": on, "cg_on": torch.any(on),
            "status": _batched_status(s["active"], s["iters"],
                                      s["cg_total"], on, s["coarse_fail"])}


def _batched_tail(s, o, robots, **_):
    """Every robot's LM iteration after its solve (``solver._lm_tail``)."""
    gf, w = solver._graph_of(o), o["weights"]
    out = _batched_update(s, gf, w, s["x"], o["caps"][0], o["tols"][1],
                          robots)
    out["cg_total"] = s["cg_total"] + torch.where(
        s["active"], s["cg_i"], torch.zeros_like(s["cg_i"]))
    out["status"] = _batched_status(out["active"], out["iters"],
                                    out["cg_total"], None, s["coarse_fail"])
    return out


BATCHED_PCG_GRAPHS = StepGraphs("batched_pcg", {
    "init": _batched_init, "head": _batched_head, "cg": _batched_cg,
    "tail": _batched_tail})


@highest_precision
def _batched_pcg_lm(g: PoseGraphArrays, weights: torch.Tensor,
                    max_iters: int = 50, cg_iters: int = 150,
                    init_lambda: float = solver._LM_INIT_LAMBDA,
                    cg_tol: float = solver._CG_TOL,
                    rel_tol: float = solver._LM_REL_TOL, *,
                    eager: bool = False, with_failures: bool = False):
    """``solver.lm_optimize`` on each of R stacked subgraphs of the PCG
    tier (``Np > solver._DENSE_SOLVE_MAX_NODES``) at once: every robot
    with its own CG and LM scalars and stops, frozen by a mask once it has
    stopped, so each robot takes the iterations ``lm_optimize`` takes on it
    alone. The programs (:data:`BATCHED_PCG_GRAPHS`) are driven as
    ``lm_optimize``'s PCG tier drives its own (``solver._run_pcg``: one
    host read per CG block and per LM iteration). Returns (poses ``[R,
    Np, 4, 4]``, LM iterations ``[R]``, CG iterations ``[R]``), and with
    ``with_failures`` the LM iterations whose coarse factorization failed
    (an int, read with the last status)."""
    R, Np = g.poses.shape[:2]
    gf = _flatten(g)
    tols, caps = solver._scalar_operands(
        g.poses.device, g.poses.dtype, [init_lambda, rel_tol, cg_tol],
        [max_iters, cg_iters])
    operands = {n: getattr(gf, n) for n in solver._GRAPH_FIELDS}
    operands.update(weights=weights.reshape(-1), tols=tols, caps=caps,
                    **solver._plan_operands(solver.segment_plans(gf, R)))
    with BATCHED_PCG_GRAPHS.solve(g.poses.device, operands, eager=eager,
                                  robots=R, coarse=solver._USE_COARSE,
                                  steps=solver._CG_BLOCK) as loop:
        status = solver._run_pcg(loop)
        poses, iters, cg = loop.take("poses", "iters", "cg_total")
    out = poses.reshape(R, Np, 4, 4), iters, cg
    return out + (status[4],) if with_failures else out


def _local_solve(g: PoseGraphArrays, weights: torch.Tensor, lm_iters: int,
                 cg_iters: int, in_turn: bool = False):
    """The local LM solves of one sweep, over the owned robots ``[n, ...]``:
    with more than one robot, one batched LM (:func:`_batched_lm` on the
    dense tier, :func:`_batched_pcg_lm` above
    ``solver._DENSE_SOLVE_MAX_NODES`` nodes); with one (a rank's block), or
    ``in_turn`` (the plain version of the batching), ``solver.lm_optimize``
    per robot. Returns (poses ``[n, Np, 4, 4]``, iterations ``[n]``, the
    LM iterations whose coarse factorization failed, an int read with the
    solves' last statuses)."""
    n, Np = g.poses.shape[:2]
    if n > 1 and not in_turn:
        if Np <= solver._DENSE_SOLVE_MAX_NODES:
            return _batched_lm(g, weights, max_iters=lm_iters) + (0,)
        poses, iters, _, failed = _batched_pcg_lm(
            g, weights, max_iters=lm_iters, cg_iters=cg_iters,
            with_failures=True)
        return poses, iters, failed
    poses, iters, failed = [], [], 0
    for j in range(n):
        res = solver.lm_optimize(
            PoseGraphArrays(**{f.name: getattr(g, f.name)[j]
                               for f in dataclasses.fields(g)}),
            weights[j], max_iters=lm_iters, cg_iters=cg_iters)
        poses.append(res.poses)
        iters.append(res.iterations)
        failed += res.coarse_failures
    return (torch.stack(poses), torch.tensor(iters, device=g.poses.device),
            failed)


def _local_chi2(poses: torch.Tensor, g: PoseGraphArrays) -> torch.Tensor:
    """Whitened squared residuals of the owned robots' edges: ``[n, Ne]``."""
    n, Np = poses.shape[:2]
    gf = _flatten(dataclasses.replace(g, poses=poses))
    r = solver.edge_residuals(gf.poses, gf)
    return torch.sum(r * r, dim=-1).reshape(n, -1)


# ---------------------------------------------------------------------------
# The Gauss-Seidel sweep
# ---------------------------------------------------------------------------


def _sweep_inputs(all_poses: torch.Tensor, local: PoseGraphArrays,
                  sep: dict, mu: torch.Tensor, coarse_on, me: torch.Tensor,
                  *, nb_robots: int, barc_sq: float, coarse_iters: int = 3):
    """A sweep up to its local solves, from the gathered blocks ``[R, Np,
    4, 4]``: the coarse alignment (where ``coarse_on``, a bool or a 0-d
    bool tensor, selected on the device as the JAX package's
    ``jnp.where(coarse_on, ...)``), the separator priors of the robots
    ``me`` at their geodesic midpoints, the canonical separator TLS
    weights and the local chi2 weights. Returns (the owned robots' local
    problems ``[n, ...]``, their edge weights ``[n, Ne]``, the replicated
    separator weights ``[S]``, the coarse alignment's failed
    factorizations, a 0-d int64 tensor, 0 where ``coarse_on`` is
    False)."""
    segments = int(sep.get("coarse_segments", 1))
    seg_len = int(sep.get("coarse_seg_len", 1 << 30))
    dev = local.poses.device

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
    align_fail = torch.zeros((), dtype=torch.int64, device=dev)
    # coarse two-level accelerator (identical replicated computation for
    # every holder); bias-free, so it can run every sweep
    if coarse_iters > 0 and (isinstance(coarse_on, torch.Tensor)
                             or coarse_on):
        aligned, align_fail = _coarse_alignment_counted(
            all_poses, sep, w_pre, sep.get("cross"), nb_robots, segments,
            seg_len, mu=mu, barc_sq=barc_sq, iters=coarse_iters)
        if isinstance(coarse_on, torch.Tensor):
            all_poses = torch.where(coarse_on, aligned, all_poses)
            align_fail = align_fail * coarse_on.to(torch.int64)
        else:
            all_poses = aligned
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

    S = idx.shape[1]
    _check_prior_tier(S, local.prior_idx.shape[1])
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
    return g_local, weights, w_canon, align_fail


def _check_prior_tier(S: int, B: int) -> None:
    if S > B - 1:
        raise ValueError(f"{S} separator slots do not fit the prior tier "
                         f"{B} (one slot is the self-anchor)")


def _sweep(mesh: RobotMesh, local: PoseGraphArrays, sep: dict,
           mu: torch.Tensor, coarse_on: bool, *, lm_iters: int,
           cg_iters: int, barc_sq: float, coarse_iters: int = 3,
           in_turn: bool = False):
    """One sweep: (owned blocks, separators, mu, coarse_on) -> (new owned
    poses ``[n, Np, 4, 4]``, replicated separator TLS weights ``[S]``, LM
    iterations ``[n]``, failed factorizations [coarse alignment, local
    coarse factors] ``[2]`` int64).

    Coarse segment-rigid alignment (replicated tiny GN over the separator
    graph + segment-crossing intra edges, :func:`_coarse_alignment`), then
    the local robust LM block solve of every owned robot
    (:func:`_local_solve`).
    """
    me = torch.tensor(mesh.owned, dtype=torch.int64,
                      device=local.poses.device)
    g_local, weights, w_canon, align_fail = _sweep_inputs(
        mesh.all_gather(local.poses), local, sep, mu, coarse_on, me,
        nb_robots=mesh.size, barc_sq=barc_sq, coarse_iters=coarse_iters)
    poses, iters, factor_fail = _local_solve(g_local, weights, lm_iters,
                                             cg_iters, in_turn)
    return poses, w_canon, iters, torch.stack(
        [align_fail, torch.full_like(align_fail, factor_fail)])


def _adaptive_mu0(all_poses: torch.Tensor, poses: torch.Tensor,
                  local: PoseGraphArrays, sep: dict, barc_sq: float,
                  mu0_chi2_cap: float, reduce_max=lambda x: x):
    """mu0 from the initialized estimate, GTSAM-style, over EVERY robust
    residual (separators AND robust intra-robot loop closures, since the
    same mu drives TLS on both): the gathered blocks ``all_poses``, the
    owned ones ``poses`` and their problems ``local``; ``reduce_max`` is
    the mesh's maximum over every process."""
    _, chi2_sep = _sep_residuals(all_poses, sep)
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
    loc_max = reduce_max(torch.max(torch.where(
        loc_keep, chi2_loc, torch.zeros_like(chi2_loc))))
    max_chi2 = torch.clamp(torch.maximum(sep_max, loc_max),
                           max=mu0_chi2_cap * barc_sq)
    mu = torch.where(max_chi2 > barc_sq,
                     barc_sq / (2.0 * max_chi2 - barc_sq),
                     torch.full_like(max_chi2, 1e6))
    return torch.clamp(mu, min=1e-6).to(torch.float32)


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
        poses, _, _, _ = _sweep(mesh, local, sep, _f32(mu, mesh.device),
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
    (the analogue of gnc_optimize's final LM polish). On a
    :class:`~cslam_tpu_torch.utils.robot_mesh.StackedMesh` the whole solve
    is :data:`DIST_GRAPHS`' plan (one launch on CUDA), elsewhere the host
    drives the sweeps (:func:`_solve_host`). Returns ``(poses [R, Np, 4,
    4] of every robot, sweeps_used, final_delta, sep_weights)``.
    """
    def solve(local: PoseGraphArrays, sep: dict):
        return _solve(mesh, local, sep, max_sweeps=max_sweeps,
                      lm_iters=lm_iters, cg_iters=cg_iters,
                      final_lm_iters=final_lm_iters, barc_sq=barc_sq,
                      mu0=mu0, mu_step=mu_step, tol=tol,
                      init_sweeps=init_sweeps, mu0_chi2_cap=mu0_chi2_cap,
                      coarse_sweeps=coarse_sweeps)[:4]

    return solve


#: ``distributed_optimize``'s routes: the main path, and the host-driven
#: plain versions (batched local solves; each robot's ``lm_optimize`` in
#: turn)
_ROUTES = ("steps", "host", "in_turn")


def _solve(mesh: RobotMesh, local: PoseGraphArrays, sep: dict, *,
           route: Optional[str] = None, eager: bool = False, **kwargs):
    """The solve by ``route`` (default: :func:`_solve_steps` on a
    ``StackedMesh`` whose separators hold the coarse metadata, else
    :func:`_solve_host`). Returns (poses of every robot, sweeps, final
    delta, separator weights, LM iterations of every owned robot summed
    over the sweeps, failed factorizations [coarse alignment, local coarse
    factors] ``[2]`` int64 summed over the sweeps)."""
    if route is None:
        route = ("steps" if isinstance(mesh, StackedMesh) and "cross" in sep
                 else "host")
    if route not in _ROUTES:
        raise ValueError(f"route {route!r} is none of {_ROUTES}")
    if route == "steps":
        if not isinstance(mesh, StackedMesh):
            raise ValueError("the step programs run on a StackedMesh")
        return _solve_steps(local, sep, eager=eager, **kwargs)
    return _solve_host(mesh, local, sep, in_turn=route == "in_turn",
                       **kwargs)


@highest_precision
def _solve_host(mesh: RobotMesh, local: PoseGraphArrays, sep: dict, *,
                max_sweeps, lm_iters, cg_iters, barc_sq, mu0, mu_step, tol,
                init_sweeps, final_lm_iters=25, mu0_chi2_cap=500.0,
                coarse_sweeps=1 << 30, in_turn=False):
    """:func:`make_distributed_solve`'s body driven from the host (the
    plain version of :func:`_solve_steps`, and the route of a
    ``ProcessGroupMesh``, whose gathers are host collectives): one host
    read per sweep (the stop test) and the local solves' own
    (:func:`_local_solve`, ``in_turn`` as there).

    Under ``highest_precision``: every product here (coarse normal
    equations, canonical separator chi2, geodesic midpoints, adaptive mu0)
    must run at full f32, since TF32 passes degrade chi2 enough to flip
    TLS weights near the inlier boundary."""
    dev = local.poses.device

    def sweep(poses, sep_, mu, coarse_on, iters):
        return _sweep(mesh, dataclasses.replace(local, poses=poses), sep_,
                      mu, coarse_on, lm_iters=iters, cg_iters=cg_iters,
                      barc_sq=barc_sq, in_turn=in_turn)

    nb_sep = sep["valid"].shape[0]

    def _with_carry(on):
        """Enable the carried-classification override (warm steady state)
        only during the init gating sweep(s)."""
        if "w_carry" not in sep:
            return sep
        return {**sep, "carry_on": _f32(on, dev)}

    sep_init, sep_run = _with_carry(1.0), _with_carry(0.0)
    lm_total = torch.zeros(len(mesh.owned), dtype=torch.int64, device=dev)
    fails = torch.zeros(2, dtype=torch.int64, device=dev)

    # phase 0: ROBUST init sweeps at mu = 1: TLS weight 1 for edges with
    # chi2 below barc_sq/2, smoothly to 0 beyond 2*barc_sq, i.e. plausible
    # edges count fully while gross outliers are excluded (forcing weight
    # 1 on everything lets an outlier separator yank two blocks together).
    # A genuine edge cut here re-enters later: mu0 below comes from its
    # post-init chi2 with a wide cap.
    poses = local.poses
    for _ in range(init_sweeps):
        poses, _w, it, f = sweep(poses, sep_init, _f32(1.0, dev), True,
                                 lm_iters)
        lm_total += it
        fails += f

    if mu0 is None:
        mu = _adaptive_mu0(mesh.all_gather(poses), poses, local, sep,
                           barc_sq, mu0_chi2_cap, mesh.all_reduce_max)
    else:
        mu = _f32(mu0, dev)

    sweeps = 0
    w = torch.zeros(nb_sep, dtype=torch.float32, device=dev)
    delta = _f32(float("inf"), dev)
    while sweeps < max_sweeps:
        w_prev = w
        new_poses, w, it, f = sweep(poses, sep_run, mu,
                                    sweeps < coarse_sweeps, lm_iters)
        lm_total += it
        fails += f
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
    poses, w, it, f = sweep(poses, sep_run, mu, False, final_lm_iters)
    lm_total += it
    fails += f
    return mesh.all_gather(poses), sweeps, delta, w, lm_total, fails


# -- the whole solve as step programs -------------------------------------
#
# The JAX package jits the whole robust solve (``cslam_tpu/pgo/
# distributed.py:644-761``): the init sweeps as a ``fori_loop``, the
# adaptive mu0, the Gauss-Seidel sweeps as a ``while_loop`` with its stop
# test on the device, the polish sweep, each sweep's local LM solves
# ``while_loop``s of their own. Here that program is :data:`DIST_GRAPHS`
# over one loop state, run as the plan :func:`_solve_plan`: the sweep loop
# (``sweeping``) over ``pre``, the batched local LM (``lm_init``, then
# ``lm_step`` while ``lm_on``; on the PCG tier ``head``, the CG blocks
# while ``cg_on``, ``tail``) and ``post``, three times: the init sweeps
# (``init`` sets phase 0: mu = 1, the carried classification on, coarse
# on), the run (``mu0`` sets phase 1) and the polish (``polish`` sets
# phase 2: one sweep, coarse off, the polish's LM cap). On CUDA the plan
# is one launch, its loops WHILE nodes (``utils.tier_graphs.StepGraphs.
# run_plan``), with no host read until the results are read; eagerly
# (the CPU, ``eager``) the host reads each flag, and every op is
# :func:`_solve_host`'s, in its order, so the two agree bit for bit.
# The state's ``blocks`` are the sweeps' poses ``[R, Np, 4, 4]``; the local
# LM's programs keep their own names. Operands: the stacked local problems
# under ``PoseGraphArrays``' names,
# the separators as ``sep_*`` and their crossing edges as ``cross_*``,
# ``tols`` = [init_lambda, rel_tol, cg_tol, tol, mu0, mu0 given] and
# ``caps`` = [init_sweeps, max_sweeps, coarse_sweeps, lm_iters,
# final_lm_iters, cg_iters]. Static: the robots, the coarse partition
# (``segments``, ``seg_len``, the JAX package's cache key), ``barc_sq``,
# ``mu_step``, ``mu0_chi2_cap`` (closure constants there), whether the
# separators carry a classification, and the CG block.

_SEP_FIELDS = ("r0", "k0", "r1", "k1", "meas", "sqrt_info", "valid")
_CARRY_FIELDS = ("w_carry", "carry_known")
_CROSS_FIELDS = ("r", "ki", "kj", "meas", "sqrt_info", "valid", "robust")
# the local problem's entries a sweep's ``pre`` rewrites
_LOCAL_STATE = ("poses", "prior_idx", "prior_pose", "prior_sqrt_info",
                "prior_valid")
#: CG iterations per program inside a sweep's WHILE node (each program
#: run is a device-side iteration, so a short block wastes few masked
#: iterations past the stop)
_SWEEP_CG_BLOCK = 4


def _local_of(o) -> PoseGraphArrays:
    return solver._graph_of(o)


def _sep_of(s, o, carry, segments, seg_len) -> dict:
    sep = {k: o[f"sep_{k}"] for k in _SEP_FIELDS}
    sep["plans"] = {n: plan_from(o, f"cplan_{n}") for n in ("pair", "node")}
    if carry:
        sep.update({k: o[f"sep_{k}"] for k in _CARRY_FIELDS},
                   carry_on=s["carry_on"])
    sep.update(coarse_segments=segments, coarse_seg_len=seg_len,
               cross={k: o[f"cross_{k}"] for k in _CROSS_FIELDS})
    return sep


def _full(like, value, dtype):
    return torch.full((), value, dtype=dtype, device=like.device)


def _dist_init(s, o, robots, **_):
    """Phase 0, the init sweeps: mu = 1 with the carried classification
    on, ``caps[0]`` sweeps from the problem's poses."""
    x = o["poses"]
    zero = _full(x, 0, torch.int64)
    return {"blocks": x, "mu": _full(x, 1.0, torch.float32),
            "carry_on": _full(x, 1.0, torch.float32), "phase": zero,
            "fails": torch.zeros(2, dtype=torch.int64, device=x.device),
            "sweeps": zero, "sweeping": o["caps"][0] > 0,
            "lm_cap": o["caps"][3],
            "lm_total": torch.zeros(robots, dtype=torch.int64,
                                    device=x.device),
            "w": torch.zeros_like(o["sep_valid"]),
            "delta": _full(x, float("inf"), torch.float32),
            "done": _full(x, False, torch.bool)}


def _dist_pre(s, o, robots, barc_sq, carry, segments, seg_len, **_):
    """A sweep up to its local solves (:func:`_sweep_inputs`), coarse on in
    phase 0, in phase 1 for the first ``caps[2]`` sweeps, off in phase
    2."""
    phase = s["phase"]
    coarse_on = (phase == 0) | ((phase == 1) & (s["sweeps"] < o["caps"][2]))
    me = torch.arange(robots, device=s["blocks"].device)
    g, weights, w_canon, align_fail = _sweep_inputs(
        s["blocks"], _local_of(o), _sep_of(s, o, carry, segments, seg_len),
        s["mu"], coarse_on, me, nb_robots=robots, barc_sq=barc_sq)
    out = {f"local_{n}": getattr(g, n) for n in _LOCAL_STATE}
    out.update(lm_weights=weights.reshape(-1), w_new=w_canon,
               fails=s["fails"] + torch.stack(
                   [align_fail, torch.zeros_like(align_fail)]))
    return out


def _in_sweep(fn, block=False):
    """A program of the batched local LM run inside a sweep: its graph (the
    flattened local problems of ``pre``), weights and caps come from the
    sweep's state, its tolerances from the solve's (``tols`` begins as
    the local LM's)."""
    def program(s, o, robots, cg_steps, **_):
        g = dataclasses.replace(_local_of(o), **{
            n: s[f"local_{n}"] for n in _LOCAL_STATE})
        view = {n: getattr(_flatten(g), n) for n in solver._GRAPH_FIELDS}
        view.update({n: t for n, t in o.items() if n.startswith("plan_")})
        view.update(weights=s["lm_weights"], tols=o["tols"],
                    caps=torch.stack([s["lm_cap"], o["caps"][5]]))
        return fn(s, view, robots=robots, coarse=solver._USE_COARSE,
                  steps=cg_steps if block else 1)
    return program


def _dist_post(s, o, robots, mu_step, **_):
    """A sweep after its local solves: the new blocks and the LM count;
    in phase 1 the stop test (weights binary or stable, and delta <
    ``tols[3]``), mu's step and the sweep count; the sweep flag."""
    phase = s["phase"]
    init, run = phase == 0, phase == 1
    new = s["poses"].reshape(s["blocks"].shape)
    w = s["w_new"]
    delta = torch.max(torch.abs(new - s["blocks"]))
    binary = torch.all((w < 1e-3) | (w > 1.0 - 1e-3))
    stable = torch.max(torch.abs(w - s["w"])) < 1e-3
    done = (binary | stable) & (delta < o["tols"][3])
    sweeps = torch.where(phase == 2, s["sweeps"], s["sweeps"] + 1)
    factor_fail = s["coarse_fail"]
    return {"blocks": new, "lm_total": s["lm_total"] + s["iters"],
            "fails": s["fails"] + torch.stack(
                [torch.zeros_like(factor_fail), factor_fail]),
            "w": torch.where(init, s["w"], w),
            "delta": torch.where(run, delta, s["delta"]),
            "done": torch.where(run, done, s["done"]),
            "mu": torch.where(run, torch.clamp(s["mu"] * mu_step, max=1e6),
                              s["mu"]),
            "sweeps": sweeps,
            "sweeping": torch.where(init, sweeps < o["caps"][0],
                                    run & ~done & (sweeps < o["caps"][1]))}


def _dist_mu0(s, o, robots, barc_sq, mu0_chi2_cap, carry, segments,
              seg_len, **_):
    """Phase 1, the sweeps: mu0 given (``tols[5]``) or adaptive
    (:func:`_adaptive_mu0`), the carried classification off, up to
    ``caps[1]`` sweeps."""
    x = s["blocks"]
    sep = _sep_of(s, o, carry, segments, seg_len)
    mu = torch.where(o["tols"][5] > 0, o["tols"][4], _adaptive_mu0(
        x, x, _local_of(o), sep, barc_sq, mu0_chi2_cap))
    return {"mu": mu, "phase": _full(x, 1, torch.int64),
            "carry_on": _full(x, 0.0, torch.float32),
            "sweeps": _full(x, 0, torch.int64),
            "w": torch.zeros_like(s["w"]),
            "delta": _full(x, float("inf"), torch.float32),
            "done": _full(x, False, torch.bool),
            "sweeping": o["caps"][1] > 0, "lm_cap": o["caps"][3]}


def _dist_polish(s, o, **_):
    """Phase 2, the polish: one sweep at the converged mu, coarse off, LM
    cap ``caps[4]``."""
    x = s["blocks"]
    return {"phase": _full(x, 2, torch.int64), "lm_cap": o["caps"][4],
            "sweeping": _full(x, True, torch.bool)}


DIST_GRAPHS = StepGraphs("dist_sweep", {
    "init": _dist_init, "pre": _dist_pre,
    "lm_init": _in_sweep(_batched_init), "lm_step": _in_sweep(_batched_step),
    "head": _in_sweep(_batched_head), "cg": _in_sweep(_batched_cg, True),
    "tail": _in_sweep(_batched_tail), "post": _dist_post,
    "mu0": _dist_mu0, "polish": _dist_polish})


def _solve_plan(pcg: bool) -> tuple:
    """The whole solve as a plan of :data:`DIST_GRAPHS` (see
    ``StepGraphs.run_plan``)."""
    lm = (("head", ("cg_on", ("cg",)), "tail") if pcg else ("lm_step",))
    sweep = ("sweeping", ("pre", "lm_init", ("lm_on", lm), "post"))
    return ("init", sweep, "mu0", sweep, "polish", sweep)


@highest_precision
def _solve_steps(local: PoseGraphArrays, sep: dict, *, max_sweeps,
                 lm_iters, cg_iters, barc_sq, mu0, mu_step, tol,
                 init_sweeps, final_lm_iters=25, mu0_chi2_cap=500.0,
                 coarse_sweeps=1 << 30, eager=False):
    """:func:`_solve_host` on a ``StackedMesh`` as :data:`DIST_GRAPHS`'
    plan: captured once per key and launched once per solve on CUDA
    (``eager``: the same programs launched one by one, as on the CPU).
    The local solves are batched at both tiers. Returns the results as
    device tensors."""
    R, Np = local.poses.shape[:2]
    dev, dtype = local.poses.device, local.poses.dtype
    nb_sep = sep["valid"].shape[0]
    _check_prior_tier(nb_sep, local.prior_idx.shape[1])
    carry = "w_carry" in sep
    tols, caps = solver._scalar_operands(
        dev, dtype, [solver._LM_INIT_LAMBDA, solver._LM_REL_TOL,
                     solver._CG_TOL, tol, 0.0 if mu0 is None else mu0,
                     float(mu0 is not None)],
        [init_sweeps, max_sweeps, coarse_sweeps, lm_iters, final_lm_iters,
         cg_iters])
    operands = {n: getattr(local, n) for n in solver._GRAPH_FIELDS}
    operands.update({f"sep_{k}": sep[k] for k in _SEP_FIELDS
                     + (_CARRY_FIELDS if carry else ())})
    operands.update({f"cross_{k}": sep["cross"][k] for k in _CROSS_FIELDS})
    operands.update(tols=tols, caps=caps)
    # the sums' orders: the local LM's, on the sweeps' flattened problems
    # (their separator priors in the slots ``pre`` fills), and the coarse
    # alignment's
    operands.update(solver._plan_operands(solver.segment_plans(
        _flatten(_sweep_layout(local, sep)), R)))
    plans = _coarse_plans(sep, R, int(sep.get("coarse_segments", 1)),
                          int(sep.get("coarse_seg_len", 1 << 30)))
    for name, plan in plans.items():
        operands.update(plan_operands(f"cplan_{name}", plan))
    with DIST_GRAPHS.solve(
            dev, operands, eager=eager, robots=R,
            segments=int(sep.get("coarse_segments", 1)),
            seg_len=int(sep.get("coarse_seg_len", 1 << 30)),
            barc_sq=float(barc_sq), mu_step=float(mu_step),
            mu0_chi2_cap=float(mu0_chi2_cap), carry=carry,
            cg_steps=_SWEEP_CG_BLOCK) as loop:
        loop.run_plan(_solve_plan(Np > solver._DENSE_SOLVE_MAX_NODES))
        return loop.take("blocks", "sweeps", "delta", "w", "lm_total",
                         "fails")


def _sweep_layout(local: PoseGraphArrays, sep: dict) -> PoseGraphArrays:
    """``local`` with the prior slots a sweep fills (:func:`_sweep_inputs`:
    the self-anchor, then each separator incident to the robot at its
    pose) and their validity, which no pose changes: the index fields of
    every sweep's local problems."""
    R = local.poses.shape[0]
    S = sep["valid"].shape[0]
    _, incident, idx = _separator_slots(
        torch.arange(R, device=local.poses.device), sep)
    return dataclasses.replace(
        local,
        prior_idx=torch.cat([local.prior_idx[:, :1], idx,
                             local.prior_idx[:, 1 + S:]], 1),
        prior_valid=torch.cat([local.prior_valid[:, :1],
                               incident.to(local.prior_valid.dtype),
                               local.prior_valid[:, 1 + S:]], 1))


class DistributedInfo:
    """Convergence diagnostics of one distributed solve."""

    def __init__(self, sweeps_used: int, final_delta: float,
                 sep_weights: np.ndarray,
                 sep_weight_by_key: Optional[Dict] = None,
                 lm_iterations: int = 0,
                 coarse_failures: Optional[Dict] = None):
        self.sweeps_used = sweeps_used
        self.final_delta = final_delta
        self.sep_weights = sep_weights
        #: {((r0, kf0), (r1, kf1)): weight}: feed back into the next
        #: round's ``distributed_optimize(carried_weights=...)``
        self.sep_weight_by_key = sep_weight_by_key or {}
        #: LM iterations of this process's robots, summed over the sweeps
        self.lm_iterations = lm_iterations
        #: failed Cholesky factorizations over the solve: the coarse
        #: alignment's (its Gauss-Newton iterations) and the local PCG
        #: tier's coarse factors (LM iterations)
        self.coarse_failures = coarse_failures or {"alignment": 0,
                                                   "local_coarse": 0}

    def __repr__(self):
        return (f"DistributedInfo(sweeps_used={self.sweeps_used}, "
                f"final_delta={self.final_delta:.2e})")


def distributed_optimize(problem: ShardedPoseGraph, mesh: RobotMesh,
                         sweeps: int = 30, lm_iters: int = 15,
                         cg_iters: int = 100, mu0: Optional[float] = None,
                         mu_step: float = 1.6, barc_sq: float = 16.81,
                         tol: float = 1e-3, return_info: bool = False,
                         warm: bool = False,
                         carried_weights: Optional[Dict] = None, *,
                         _route: Optional[str] = None, _eager: bool = False):
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
    problem; each returns every robot's values. ``_route`` (one of
    :data:`_ROUTES`) picks a plain version instead of the main path (the
    step programs' plan on a ``StackedMesh``, the host-driven sweeps on a
    process group); ``_eager`` launches the plan's programs one by one.
    Both are for tests and the card's checks, not for callers. Returns the optimized values dict, or
    ``(values, DistributedInfo)`` when ``return_info`` is set.
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
    poses, sweeps_used, delta, w, lm_total, fails = _solve(
        mesh, local, sep, route=_route, eager=_eager, max_sweeps=sweeps,
        lm_iters=lm_iters, cg_iters=cg_iters, barc_sq=barc_sq, mu0=mu0,
        mu_step=mu_step, tol=tol, init_sweeps=init_sweeps)
    values = problem.values_from_arrays(poses)
    if return_info:
        w_np = w.cpu().numpy()
        # one read for the LM count and the failure counts
        counts = torch.cat([lm_total.sum().reshape(1), fails]).tolist()
        info = DistributedInfo(
            int(sweeps_used), float(delta), w_np,
            {k: float(w_np[i]) for i, k in enumerate(sep_keys)},
            counts[0], {"alignment": counts[1], "local_coarse": counts[2]})
        return values, info
    return values

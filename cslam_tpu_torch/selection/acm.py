"""Algebraic-connectivity-maximization candidate bookkeeping and selection.

Counterpart of ``cslam_tpu/selection/acm.py``; host code around the port's
MAC (``cslam_tpu_torch.selection.mac``). Host-side orchestration with the same behavior contract as the reference
``cslam/algebraic_connectivity_maximization.py``: it maintains fixed /
candidate inter-robot edges, rekeys the multi-robot (robot, keyframe) id
space into one contiguous node index space, infers odometry chain edges for
free, and runs the budgeted MAC selection (``selection.mac``, whose
Fiedler eigensolves run on the selected torch device).

Graph bookkeeping stays on the host on purpose: it is tiny, dynamic, and
gossip-driven; only the numeric core (Frank-Wolfe + eigensolve) is device
code.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from cslam_tpu_torch.selection.mac import MAC
from cslam_tpu_torch.types import Edge, EdgeInterRobot

_DEFAULT_PARAMS = {
    "frontend.enable_sparsification": True,
    "evaluation.enable_sparsification_comparison": False,
}


class AlgebraicConnectivityMaximization:
    """Budget-constrained inter-robot loop-closure candidate selector."""

    def __init__(self, robot_id: int = 0, max_nb_robots: int = 1,
                 max_iters: int = 20, fixed_weight: float = 1.0,
                 extra_params: Optional[dict] = None, device=None):
        self.device = device
        self.fixed_weight = fixed_weight
        self.params = dict(_DEFAULT_PARAMS)
        if extra_params:
            self.params.update(extra_params)
        self.max_iters = max_iters
        self.robot_id = robot_id
        self.max_nb_robots = max_nb_robots
        # bounded candidate pool (frontend.max_candidate_pool, 0 = the
        # reference's unbounded growth): evictions are weight-ordered and
        # NON-permanent — unlike failed verification, an evicted edge
        # re-enters whenever it is re-matched
        self.max_pool = int(self.params.get(
            "frontend.max_candidate_pool", 0) or 0)

        self.fixed_edges: List[EdgeInterRobot] = []
        self.candidate_edges: Dict[Tuple[int, int, int, int],
                                   EdgeInterRobot] = {}
        self.already_considered_matches: Set[Tuple[int, int, int, int]] = set()

        self.total_nb_poses = 0
        self.nb_poses: Dict[int, int] = {i: 0 for i in range(max_nb_robots)}
        self.initial_fixed_edge_exists: Dict[int, bool] = {
            i: False for i in range(max_nb_robots)}
        self.offsets: Dict[int, int] = {i: 0 for i in range(max_nb_robots)}

        # side-by-side greedy-vs-MAC logging (reference acm.py:526-557)
        self.log_greedy_edges: List[EdgeInterRobot] = []
        self.log_mac_edges: List[EdgeInterRobot] = []
        self.mac_solver_failures = 0
        self.last_fw_iters = -1  # FW iterations of the last MAC solve
        # relaxed FW solution by candidate key from the previous detection
        # round (``frontend.mac_fw_warm_start``): persisting candidates
        # re-enter the next solve near their converged weight, so the
        # duality gap closes in a handful of FW iterations instead of the
        # full budget — the cross-round analogue of the solver's
        # carried-TLS-weights trick
        self.last_relaxed_w: Dict[Tuple[int, int, int, int], float] = {}
        # monotone count of candidate-pool mutations (adds, weight
        # upgrades, removals, fixed promotions) — lets the detection
        # plane skip a round's MAC solve when nothing changed since the
        # last dispatched solve (``frontend.mac_min_new_candidates``)
        self.pool_mutations = 0

    # ------------------------------------------------------------------
    # Edge bookkeeping
    # ------------------------------------------------------------------

    def edge_key(self, edge: EdgeInterRobot) -> Tuple[int, int, int, int]:
        """Canonical direction-independent key (reference acm.py:76-90)."""
        return edge.key()

    def replace_weight(self, edge, weight: float):
        if isinstance(edge, EdgeInterRobot):
            return edge._replace(weight=weight)
        return Edge(edge.i, edge.j, weight)

    def _track_poses(self, edge: EdgeInterRobot) -> None:
        """Pose counts are the max keyframe id seen per robot (acm.py:110-119)."""
        self.nb_poses[edge.robot0_id] = max(self.nb_poses[edge.robot0_id],
                                            edge.robot0_keyframe_id + 1)
        self.nb_poses[edge.robot1_id] = max(self.nb_poses[edge.robot1_id],
                                            edge.robot1_keyframe_id + 1)

    def _track_fixed_link(self, edge: EdgeInterRobot) -> None:
        """Remember robots that own at least one verified inter-robot edge
        (acm.py:121-130) — required before MAC can run safely."""
        if edge.robot0_id != edge.robot1_id:
            self.initial_fixed_edge_exists[edge.robot0_id] = True
            self.initial_fixed_edge_exists[edge.robot1_id] = True

    def set_graph(self, fixed_edges: List[EdgeInterRobot],
                  candidate_edges: Iterable[EdgeInterRobot]) -> None:
        self.fixed_edges = list(fixed_edges)
        for e in self.fixed_edges:
            self._track_poses(e)
            self._track_fixed_link(e)
            self.pool_mutations += 1
        for e in candidate_edges:
            self._track_poses(e)
            self.candidate_edges[self.edge_key(e)] = e
            self.pool_mutations += 1

    def add_fixed_edge(self, edge: EdgeInterRobot) -> None:
        self.fixed_edges.append(edge)
        self.pool_mutations += 1  # the fixed graph shapes the solve too
        self._track_poses(edge)
        self._track_fixed_link(edge)

    def add_candidate_edge(self, edge: EdgeInterRobot) -> None:
        """Add unless it was already verified or permanently demoted
        (``already_considered_matches``, acm.py:163-176)."""
        if self.edge_key(edge) in self.already_considered_matches:
            return
        self.candidate_edges[self.edge_key(edge)] = edge
        self.pool_mutations += 1
        self._track_poses(edge)
        if self.max_pool and len(self.candidate_edges) > self.max_pool:
            # evict the weakest candidate (O(pool) scan, only while at
            # capacity). Not marked already-considered: a stronger
            # re-match re-adds it.
            weakest = min(self.candidate_edges,
                          key=lambda k: self.candidate_edges[k].weight)
            del self.candidate_edges[weakest]

    def add_match(self, match: EdgeInterRobot) -> None:
        """Keep the max-weight observation of a repeated match (acm.py:559-572)."""
        key = self.edge_key(match)
        existing = self.candidate_edges.get(key)
        if existing is None or match.weight > existing.weight:
            self.add_candidate_edge(match)

    def remove_candidate_edges(self, edges: Sequence[EdgeInterRobot],
                               failed: bool = False) -> None:
        for edge in edges:
            if self.candidate_edges.pop(self.edge_key(edge), None) is not None:
                self.pool_mutations += 1
            self.already_considered_matches.add(self.edge_key(edge))

    def candidate_edges_to_fixed(self, edges: List[EdgeInterRobot]) -> None:
        """Promote verified candidates to fixed measurements (acm.py:192-203)."""
        promoted = [self.replace_weight(e, self.fixed_weight) for e in edges]
        for e in promoted:
            self._track_fixed_link(e)
        self.fixed_edges.extend(promoted)
        self.pool_mutations += len(promoted)
        self.remove_candidate_edges(edges)

    # ------------------------------------------------------------------
    # Rekeying: (robot, keyframe) ids <-> one contiguous node index space
    # ------------------------------------------------------------------

    def check_graph_disconnections(
            self, is_other_robot_considered: Dict[int, bool]) -> Dict[int, bool]:
        """Which robots appear in the match graph at all (acm.py:391-417)."""
        included = {i: i == self.robot_id for i in range(self.max_nb_robots)}
        for edge in list(self.fixed_edges) + list(self.candidate_edges.values()):
            for rid in (edge.robot0_id, edge.robot1_id):
                if is_other_robot_considered.get(rid, False):
                    included[rid] = True
        return included

    def compute_offsets(self, is_robot_included: Dict[int, bool]) -> None:
        """Prefix-sum node offsets over included robots (acm.py:291-310)."""
        self.offsets = {i: 0 for i in range(self.max_nb_robots)}
        cursor = 0
        for rid in range(self.max_nb_robots):
            if is_robot_included.get(rid, False):
                self.offsets[rid] = cursor
                cursor += self.nb_poses[rid]

    def rekey_edges(self, edges: Iterable[EdgeInterRobot],
                    is_robot_included: Dict[int, bool]) -> List[Edge]:
        out = []
        for e in edges:
            if (is_robot_included.get(e.robot0_id, False)
                    and is_robot_included.get(e.robot1_id, False)):
                out.append(Edge(self.offsets[e.robot0_id] + e.robot0_keyframe_id,
                                self.offsets[e.robot1_id] + e.robot1_keyframe_id,
                                e.weight))
        return out

    def get_included_edges(self, edges: Iterable[EdgeInterRobot],
                           is_robot_included: Dict[int, bool]
                           ) -> List[EdgeInterRobot]:
        return [e for e in edges
                if is_robot_included.get(e.robot0_id, False)
                and is_robot_included.get(e.robot1_id, False)]

    def fill_odometry(self) -> List[Edge]:
        """Odometry chain edges inferred from pose counts, no comms needed
        (acm.py:348-362)."""
        odom = []
        for rid in range(self.max_nb_robots):
            base = self.offsets[rid]
            for k in range(self.nb_poses[rid] - 1):
                odom.append(Edge(base + k, base + k + 1, self.fixed_weight))
        return odom

    def _owner_of_node(self, node_id: int,
                       is_robot_included: Dict[int, bool]) -> int:
        """Inverse of rekeying: the included robot whose offset range holds
        ``node_id`` (largest included robot id with offset <= node_id,
        matching reference acm.py:364-389 iteration semantics)."""
        owner = 0
        for rid in range(self.max_nb_robots):
            if is_robot_included.get(rid, False) and self.offsets[rid] <= node_id:
                owner = rid
        return owner

    def recover_inter_robot_edges(self, edges: Sequence[Edge],
                                  is_robot_included: Dict[int, bool]
                                  ) -> List[EdgeInterRobot]:
        recovered = []
        for e in edges:
            r0 = self._owner_of_node(e.i, is_robot_included)
            r1 = self._owner_of_node(e.j, is_robot_included)
            recovered.append(EdgeInterRobot(r0, e.i - self.offsets[r0],
                                            r1, e.j - self.offsets[r1],
                                            e.weight))
        return recovered

    # ------------------------------------------------------------------
    # Initial guesses (reference acm.py:205-289)
    # ------------------------------------------------------------------

    def greedy_initialization(self, nb_to_choose: int,
                              edges: Sequence[Edge]) -> np.ndarray:
        """One-hot selection of the top-weight edges."""
        w = np.zeros(len(edges))
        if nb_to_choose <= 0 or not edges:
            return w
        weights = np.array([e.weight for e in edges])
        top = np.argsort(weights)[-nb_to_choose:]
        w[top] = 1.0
        return w

    def pseudo_greedy_initialization(self, nb_to_choose: int, nb_random: int,
                                     edges: Sequence[Edge]) -> np.ndarray:
        """Greedy for the first (k - nb_random), then random extras."""
        w = self.greedy_initialization(nb_to_choose - nb_random, edges)
        chosen, trials = 0, 0
        max_trials = 2 * nb_random
        while chosen < nb_random and trials < max_trials:
            j = int(np.random.rand() * len(edges))
            if w[j] < 0.5:
                w[j] = 1.0
                chosen += 1
            trials += 1
        if trials >= max_trials:
            return self.greedy_initialization(nb_to_choose, edges)
        return w

    def random_initialization(self, nb_to_choose: int,
                              edges: List[Edge]) -> np.ndarray:
        randomized = [self.replace_weight(e, float(np.random.rand()))
                      for e in edges]
        return self.greedy_initialization(nb_to_choose, randomized)

    def connection_biased_greedy_selection(
            self, nb_to_choose: int, edges: List[EdgeInterRobot],
            is_robot_included: Dict[int, bool]) -> np.ndarray:
        """Greedy selection that first connects robots with no verified link
        yet (reference acm.py:257-289) — used until MAC has a connected base
        graph to work with."""
        edges_copy = list(edges)
        forced: List[int] = []
        for rid, included in is_robot_included.items():
            if not included or self.initial_fixed_edge_exists[rid]:
                continue
            best_idx, best_w = None, -1.0
            for i, e in enumerate(edges_copy):
                if rid in (e.robot0_id, e.robot1_id) and e.weight > best_w:
                    best_idx, best_w = i, e.weight
            if best_idx is not None:
                forced.append(best_idx)
                edges_copy[best_idx] = self.replace_weight(
                    edges_copy[best_idx], 0.0)
        w = np.zeros(len(edges))
        remaining = nb_to_choose - len(forced)
        if remaining > 0:
            w = self.greedy_initialization(
                remaining, self.rekey_edges(edges_copy, is_robot_included))
            if len(w) < len(edges):  # some edges excluded by rekeying
                w = np.pad(w, (0, len(edges) - len(w)))
        for i in forced:
            w[i] = 1.0
        return w

    def check_initial_fixed_measurements_exists(
            self, is_robot_included: Dict[int, bool]) -> bool:
        return all(self.initial_fixed_edge_exists[rid]
                   for rid, inc in is_robot_included.items() if inc)

    # ------------------------------------------------------------------
    # Selection pipeline (reference acm.py:436-543)
    # ------------------------------------------------------------------

    def run_mac_solver(self, fixed_edges: List[Edge],
                       candidate_edges: List[Edge], w_init: np.ndarray,
                       nb_to_choose: int) -> np.ndarray:
        mac, pending = self.run_mac_solver_dispatch(
            fixed_edges, candidate_edges, w_init, nb_to_choose)
        return self.run_mac_solver_finish(mac, pending, candidate_edges,
                                          w_init, nb_to_choose)

    def run_mac_solver_dispatch(self, fixed_edges: List[Edge],
                                candidate_edges: List[Edge],
                                w_init: np.ndarray, nb_to_choose: int):
        """Construct the MAC and dispatch its fused FW program; returns
        ``(mac, device_futures)`` without blocking on the solve."""
        from cslam_tpu_torch.selection.mac import mac_kwargs_from_params
        from cslam_tpu_torch.utils import profiling
        mac_kwargs = mac_kwargs_from_params(self.params)
        with profiling.span("mac.construct"):
            mac = MAC(fixed_edges, candidate_edges, self.total_nb_poses,
                      device=self.device, **mac_kwargs)
        # Background-compile the NEXT shape tier when a growth counter
        # passes 60% of its pad, so a mid-mission tier crossing never
        # stalls the detection plane on a foreground remote compile
        # (measured 105 s for one tier in the round-3 lidar e2e; 75% left
        # too little lead time — round 4 measured an 83 s foreground stall
        # when candidates crossed their tier before the prefetch landed).
        from cslam_tpu_torch.selection.mac import \
            prefetch_selection_tier_async
        # Each growth axis that passed 60% contributes its next tier; the
        # CROSS-PRODUCT of hot axes is prefetched too — in the round-4
        # lidar e2e, poses and candidates crossed their tiers within 40 s
        # of each other, so the one-axis prefetches (nextP, curE) and
        # (curP, nextE) both landed yet the tier actually needed was
        # (nextP, nextE): a 16-45 s foreground stall per combination.
        # A bounded pool (max_candidate_pool <= current E tier) makes the
        # next candidate tier UNREACHABLE — prefetching it would burn the
        # serialized compile service and starve the 1-core host for
        # nothing (measured 103 s of bg stall in the round-5 lidar e2e).
        cand_can_grow = not (self.max_pool and self.max_pool <= mac._E)
        cand_next = (mac._E + 1
                     if cand_can_grow and len(candidate_edges) * 5 >= mac._E * 3
                     else len(candidate_edges))
        pose_next = (mac._P + 1 if self.total_nb_poses * 5 >= mac._P * 3
                     else self.total_nb_poses)
        mf_next = (mac._mf + 1
                   if not mac._dense and mac.num_lr_fixed * 5 >= 3 * mac._mf
                   else mac.num_lr_fixed)
        nexts = {(p, e, mf)
                 for p in {self.total_nb_poses, pose_next}
                 for e in {len(candidate_edges), cand_next}
                 for mf in {mac.num_lr_fixed, mf_next}}
        nexts.discard((self.total_nb_poses, len(candidate_edges),
                       mac.num_lr_fixed))  # the tier already in use
        for nxt in nexts:
            prefetch_selection_tier_async(
                *nxt, max_iters=self.max_iters, device=self.device,
                **mac_kwargs)
        if mac._m == 0:
            return mac, None
        return mac, mac.fw_subset_dispatch(w_init, nb_to_choose,
                                           max_iters=self.max_iters)

    def run_mac_solver_finish(self, mac, pending,
                              candidate_edges: List[Edge],
                              w_init: np.ndarray,
                              nb_to_choose: int,
                              cand_keys=None) -> np.ndarray:
        """Materialize a dispatched MAC solve (blocks on the device read).

        Retry ladder with increasingly random initializations, the
        reference's recovery semantics (acm.py:448-465: singular-matrix
        failures happen when the selected measurements disconnect the
        graph; re-initializing with `trial` random picks escapes it).
        Our dense deflated eigensolver cannot hit the reference's LU
        failure mode, but a genuinely numeric failure walks the same
        ladder before degrading to the initial guess — counted and
        logged so a degraded selection plane is visible. Programming
        errors (anything else) propagate.
        """
        if pending is None:
            return np.zeros(0)
        last_exc = None
        for trial in range(max(nb_to_choose, 1)):
            try:
                result, w_relaxed, _ = mac.fw_subset_finish(pending)
                self.last_fw_iters = mac.last_fw_iters
                if cand_keys is not None and self.params.get(
                        "frontend.mac_fw_warm_start", False):
                    self.last_relaxed_w = dict(
                        zip(cand_keys, np.asarray(w_relaxed, np.float64)))
                if trial:
                    logging.getLogger(__name__).warning(
                        "MAC solver recovered at retry %d", trial)
                return result
            except (np.linalg.LinAlgError, FloatingPointError) as exc:
                last_exc = exc
                w_try = self.pseudo_greedy_initialization(
                    nb_to_choose, trial + 1, candidate_edges)
                pending = mac.fw_subset_dispatch(w_try, nb_to_choose,
                                                 max_iters=self.max_iters)
        self.mac_solver_failures += 1
        logging.getLogger(__name__).warning(
            "MAC solver numeric failure #%d (%s) after %d retries; "
            "selection degraded to the initial guess",
            self.mac_solver_failures, last_exc, max(nb_to_choose, 1) - 1)
        return w_init.copy()

    def select_candidates_begin(self, nb_candidates_to_choose: int,
                                is_other_robot_considered: Dict[int, bool],
                                greedy_initialization: bool = True):
        """Start a selection round: bookkeeping + the MAC solve DISPATCH.

        Returns an opaque pending handle for
        :meth:`select_candidates_finish`, or None when there is nothing to
        select. The device solve proceeds concurrently with whatever the
        host does next — the pattern that keeps the detection plane off
        the keyframe critical path (the reference gets the same isolation
        from its separate LCD process,
        ``loop_closure_detection_node.py:99``).

        The handle snapshots the round's rekeyed bookkeeping. Between
        begin and finish the live candidate pool may gain matches (they
        join the NEXT round) or lose them to verification outcomes
        (finish drops selections that are no longer candidates); offsets
        must not be recomputed in between, i.e. finish() before the next
        begin().
        """
        is_robot_included = self.check_graph_disconnections(
            is_other_robot_considered)
        self.compute_offsets(is_robot_included)
        rekeyed_fixed = self.rekey_edges(self.fixed_edges, is_robot_included)
        rekeyed_fixed.extend(self.fill_odometry())
        rekeyed_candidates = self.rekey_edges(self.candidate_edges.values(),
                                              is_robot_included)

        nb_to_choose = min(nb_candidates_to_choose, len(rekeyed_candidates))
        if not rekeyed_candidates:
            return None

        self.total_nb_poses = sum(self.nb_poses[r]
                                  for r in range(self.max_nb_robots))

        if greedy_initialization:
            w_init = self.greedy_initialization(nb_to_choose,
                                                rekeyed_candidates)
        else:
            w_init = self.random_initialization(nb_to_choose,
                                                rekeyed_candidates)

        cand_keys = [self.edge_key(e) for e in self.get_included_edges(
            self.candidate_edges.values(), is_robot_included)]
        if (self.params.get("frontend.mac_fw_warm_start", False)
                and self.last_relaxed_w):
            # overlay the previous round's converged relaxed weights on
            # persisting candidates (new candidates keep their init value),
            # then rescale into the |w| <= k constraint set if the overlay
            # overshoots it (FW iterates are convex combinations with
            # budget-k vertices, so a feasible start stays feasible)
            w_init = np.asarray(w_init, np.float64).copy()
            for i, key in enumerate(cand_keys):
                carried = self.last_relaxed_w.get(key)
                if carried is not None:
                    w_init[i] = carried
            total = float(w_init.sum())
            if nb_to_choose > 0 and total > nb_to_choose:
                w_init *= nb_to_choose / total

        mac = pending = None
        if (self.params["frontend.enable_sparsification"]
                and self.check_initial_fixed_measurements_exists(
                    is_robot_included)):
            mac, pending = self.run_mac_solver_dispatch(
                rekeyed_fixed, rekeyed_candidates, w_init, nb_to_choose)
            result = None
        else:
            result = self.connection_biased_greedy_selection(
                nb_to_choose,
                self.get_included_edges(self.candidate_edges.values(),
                                        is_robot_included),
                is_robot_included)
        return {"mac": mac, "pending": pending, "result": result,
                "w_init": w_init, "nb_to_choose": nb_to_choose,
                "rekeyed_candidates": rekeyed_candidates,
                "cand_keys": cand_keys,
                "is_robot_included": is_robot_included}

    def select_candidates_finish(self, handle) -> List[EdgeInterRobot]:
        """Materialize a selection round started by
        :meth:`select_candidates_begin`: read the solve, round, map back
        to inter-robot edges, and remove them from the candidate pool."""
        if handle is None:
            return []
        rekeyed_candidates = handle["rekeyed_candidates"]
        is_robot_included = handle["is_robot_included"]
        result = handle["result"]
        if result is None:
            result = self.run_mac_solver_finish(
                handle["mac"], handle["pending"], rekeyed_candidates,
                handle["w_init"], handle["nb_to_choose"],
                cand_keys=handle.get("cand_keys"))
        if len(result) == 0:
            return []

        if self.params.get("evaluation.enable_sparsification_comparison",
                           False):
            self._log_sparsification_comparison(rekeyed_candidates,
                                                is_robot_included,
                                                handle["w_init"], result)

        selected = [rekeyed_candidates[i]
                    for i in np.nonzero(result.astype(int))[0]]
        inter_robot_edges = self.recover_inter_robot_edges(
            selected, is_robot_included)
        # verification outcomes may have consumed a candidate between
        # begin and finish — selecting it again would resurrect a demoted
        # edge (reference keeps these phases synchronous; we must filter)
        inter_robot_edges = [e for e in inter_robot_edges
                             if self.edge_key(e) in self.candidate_edges]
        self.remove_candidate_edges(inter_robot_edges)
        return inter_robot_edges

    def select_candidates(self, nb_candidates_to_choose: int,
                          is_other_robot_considered: Dict[int, bool],
                          greedy_initialization: bool = True
                          ) -> List[EdgeInterRobot]:
        """Select up to the budget of candidate edges, remove them from the
        candidate pool, and return them (reference acm.py:468-543)."""
        return self.select_candidates_finish(self.select_candidates_begin(
            nb_candidates_to_choose, is_other_robot_considered,
            greedy_initialization=greedy_initialization))

    def _log_sparsification_comparison(self, rekeyed_candidates, included,
                                       greedy_result, mac_result) -> None:
        self.log_greedy_edges = self.recover_inter_robot_edges(
            [rekeyed_candidates[i]
             for i in np.nonzero(greedy_result.astype(int))[0]], included)
        self.log_mac_edges = self.recover_inter_robot_edges(
            [rekeyed_candidates[i]
             for i in np.nonzero(mac_result.astype(int))[0]], included)

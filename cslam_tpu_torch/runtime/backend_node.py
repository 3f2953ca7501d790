"""Decentralized pose-graph-optimization back end (per-robot node).

State-machine parity with the reference ``src/back_end/decentralized_pgo.cpp``:

    IDLE -> WAITING_FOR_NEIGHBORS_INFO -> POSEGRAPH_COLLECTION
         -> WAITING_FOR_NEIGHBORS_POSEGRAPHS -> START_OPTIMIZATION
         -> OPTIMIZATION -> IDLE

The lowest (origin_id, robot_id) among current neighbors is elected optimizer
(cpp:347-368); it gathers neighbors' pose graphs (request/response topic pair,
cpp:370-462), BFS-filters to the connected subset (cpp:464-508), aggregates
with loop-closure dedup (cpp:555-634), anchors its own first pose (cpp:836-845),
runs the robust optimizer off-thread (cpp:796-856 used GTSAM GNC in
std::async; here it is the GNC-TLS solver in a worker thread), and
redistributes per-robot slices of the solution (cpp:665-681). Waiting states
time out back to IDLE (cpp:515-542). Heartbeats are gated by the simulated
rendezvous schedule when enabled (cpp:683-694).

Counterpart of ``cslam_tpu/runtime/backend_node.py``: the solver runs on
the node's torch device (CUDA unless the caller passes another), in the
centralized GNC mode or, with ``backend.pgo_mode: distributed``, in the
robot-sharded block Gauss-Seidel mode (``pgo/distributed.py``) with every
robot's block stacked on that one device.
"""
from __future__ import annotations

import enum
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from cslam_tpu_torch import config, resolve_device
from cslam_tpu_torch.pgo import FactorGraph
from cslam_tpu_torch.pgo.distributed import (distributed_optimize,
                                             split_factor_graph)
from cslam_tpu_torch.pgo.factor_graph import _tier, arrays_to_numpy
from cslam_tpu_torch.pgo.solver import gnc_optimize, gnc_reoptimize
from cslam_tpu_torch.runtime.rendezvous import SimulatedRendezVous
from cslam_tpu_torch.utils import profiling
from cslam_tpu_torch.utils.robot_mesh import StackedMesh
from cslam_tpu_torch.types import (Heartbeat, InterRobotLoopClosure,
                             IntraRobotLoopClosure, KeyframeOdom,
                             OptimizationResult, OptimizerStateMsg, PoseGraph,
                             PoseGraphEdge, PoseGraphValue, PoseKey,
                             ReferenceFrames, RobotIds, RobotIdsAndOrigin)


class OptimizerState(enum.IntEnum):
    IDLE = 0
    WAITING_FOR_NEIGHBORS_INFO = 1
    POSEGRAPH_COLLECTION = 2
    WAITING_FOR_NEIGHBORS_POSEGRAPHS = 3
    START_OPTIMIZATION = 4
    OPTIMIZATION = 5


class DecentralizedPGO:
    """Back-end node: odometry/loop-closure intake + decentralized PGO."""

    def __init__(self, ctx, logger=None, synchronous_optimization: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.ctx = ctx
        p = ctx.params
        self.params = p
        self.robot_id = p["robot_id"]
        self.max_nb_robots = p["max_nb_robots"]
        self.origin_robot_id = self.robot_id
        self.logger = logger
        self.synchronous = synchronous_optimization

        self.default_sigmas = np.array(
            [p.get("backend.rotation_default_noise_std", 0.01)] * 3
            + [p.get("backend.translation_default_noise_std", 0.1)] * 3)

        # local state (mirrors cpp members)
        self.odometry_pose_estimates: Dict[Tuple[int, int], np.ndarray] = {}
        self._last_optimized_values: Dict[Tuple[int, int], np.ndarray] = {}
        self._last_edge_weights: Dict[Tuple, float] = {}
        self.current_pose_estimates: Dict[Tuple[int, int], np.ndarray] = {}
        self.local_factors: List[PoseGraphEdge] = []   # odometry + intra LC
        self.inter_robot_loop_closures: Dict[Tuple[int, int],
                                             List[PoseGraphEdge]] = {}
        for i in range(self.max_nb_robots):
            for j in range(i + 1, self.max_nb_robots):
                self.inter_robot_loop_closures[(i, j)] = []
        self.connected_robots: Set[int] = set()
        self.latest_local_key: Optional[Tuple[int, int]] = None
        self.latest_local_pose = np.eye(4)
        self.origin_to_first_pose = np.eye(4)
        self.latest_optimized_pose = np.eye(4)
        self.local_pose_at_latest_optimization = np.eye(4)
        self._tentative_local_pose_at_latest_optimization = np.eye(4)
        self.gps_data: Dict[int, object] = {}

        # optimizer machinery
        self.optimizer_state = OptimizerState.IDLE
        self.optimization_count = 0
        #: solves of the distributed mode (``backend.pgo_mode``)
        self.distributed_solves = 0
        self.is_waiting = False
        self.start_waiting_time = 0.0
        self.max_waiting_time_sec = p.get("backend.max_waiting_time_sec", 60.0)
        self.current_neighbors = RobotIdsAndOrigin()
        self.received_pose_graphs: Dict[int, bool] = {}
        self.other_robots_graphs: Dict[int, PoseGraph] = {}
        self.received_connectivity: Dict[int, List[int]] = {}
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._optimization_future: Optional[Future] = None
        self._aggregate: Optional[FactorGraph] = None

        # comms
        ctx.create_subscription("cslam/keyframe_odom", self.odometry_callback)
        ctx.create_subscription("cslam/intra_robot_loop_closure",
                                self.intra_robot_loop_closure_callback)
        ctx.create_subscription("/cslam/inter_robot_loop_closure",
                                self.inter_robot_loop_closure_callback)
        self.get_current_neighbors_publisher = ctx.create_publisher(
            "cslam/get_current_neighbors")
        ctx.create_subscription("cslam/current_neighbors",
                                self.current_neighbors_callback)
        self.get_pose_graph_publishers = {
            i: ctx.create_publisher(f"/r{i}/cslam/get_pose_graph")
            for i in range(self.max_nb_robots)}
        ctx.create_subscription("cslam/get_pose_graph",
                                self.get_pose_graph_callback)
        self.pose_graph_publisher = ctx.create_publisher("/cslam/pose_graph")
        ctx.create_subscription("/cslam/pose_graph", self.pose_graph_callback)
        self.optimized_estimates_publishers = {
            i: ctx.create_publisher(f"/r{i}/cslam/optimized_estimates")
            for i in range(self.max_nb_robots)}
        ctx.create_subscription("cslam/optimized_estimates",
                                self.optimized_estimates_callback)
        self.heartbeat_publisher = ctx.create_publisher("cslam/heartbeat")
        # transient-local, like the reference (decentralized_pgo.cpp:
        # 194-196): tools/robots subscribing late get the current frame
        self.reference_frames_publisher = ctx.create_publisher(
            "cslam/reference_frames", latch=True)
        self.current_pose_publisher = ctx.create_publisher(
            f"/r{self.robot_id}/cslam/current_pose_estimate")
        self.viz_pose_graph_publisher = ctx.create_publisher(
            "/cslam/viz/pose_graph")
        self.optimizer_state_publisher = ctx.create_publisher(
            "cslam/optimizer_state")
        self.debug_optimization_result_publisher = ctx.create_publisher(
            "cslam/debug_optimization_result")
        ctx.create_subscription("cslam/print_current_estimates",
                                self.write_current_estimates_callback)

        # timers (reference cpp:76-82, 183-192)
        ctx.create_timer(
            p.get("backend.pose_graph_optimization_start_period_ms", 500)
            / 1000.0, self.optimization_callback)
        ctx.create_timer(
            p.get("backend.pose_graph_optimization_loop_period_ms", 100)
            / 1000.0, self.optimization_loop_callback)
        ctx.create_timer(
            p.get("neighbor_management.heartbeat_period_sec", 0.5),
            self.heartbeat_timer_callback)
        if p.get("visualization.enable", False):
            ctx.create_timer(
                p.get("visualization.publishing_period_ms", 1000) / 1000.0,
                self.visualization_callback)
        self.tf_publisher = ctx.create_publisher("tf")
        if p.get("backend.enable_broadcast_tf_frames", True):
            ctx.create_timer(
                p.get("backend.pose_graph_optimization_loop_period_ms", 100)
                / 1000.0, self.broadcast_tf_callback)

        # Mission-bound (pose, edge) tier floors: pad every aggregate
        # graph to at least these tiers so the WHOLE mission runs on one
        # compiled GNC program (same design as frontend.mac_e_floor).
        self._np_floor = int(p.get("backend.pgo_np_floor", 0) or 0)
        self._ne_floor = int(p.get("backend.pgo_ne_floor", 0) or 0)
        if p.get("backend.warmup_poses", 0) > 0:
            self.warmup(p["backend.warmup_poses"],
                        max(p.get("backend.warmup_edges", 0),
                            p["backend.warmup_poses"]))

        self.sim_rendezvous: Optional[SimulatedRendezVous] = None
        if p.get("evaluation.enable_simulated_rendezvous", False):
            sched = p.get("evaluation.rendezvous_schedule_file", "")
            if sched:
                self.sim_rendezvous = SimulatedRendezVous.from_schedule_file(
                    ctx.clock, sched, self.robot_id)

    def warmup(self, expected_poses: int, expected_edges: int) -> None:
        """Run the GNC solver once on every padded tier up to the given
        sizes (``backend.warmup_poses``). On CUDA this captures each tier's
        LM step programs (``pgo.solver.DENSE_GRAPHS`` / ``PCG_GRAPHS``), as
        the JAX package compiles its solver per tier, so no solve of the
        mission pays a capture; one that does (a tier the grid missed) is
        captured then, counted in the programs' ``captures``. It also pays
        the one-time costs (CUDA context, solver library handles) before
        the mission starts."""
        for np_tier, ne_tier in self.warmup_tier_grid(expected_poses,
                                                      expected_edges):
            self.warmup_tier(np_tier, ne_tier)

    def warmup_tier_grid(self, expected_poses: int, expected_edges: int):
        """The (pose tier, edge tier) pairs :meth:`warmup` covers —
        exposed so callers can spread the tier compiles over a thread
        pool (serial warmup pays each remote compile end to end).

        With ``backend.pgo_np_floor``/``pgo_ne_floor`` pinned to the
        mission bound the grid collapses to the one or two programs the
        run can actually reach (tiers below a floor never occur — every
        graph pads up to it)."""
        from cslam_tpu_torch.pgo.factor_graph import _tier
        np_floor = max(16, self._np_floor)
        ne_floor = max(16, self._ne_floor)

        def tiers(n, minimum):
            t = minimum
            while True:
                yield t
                if t >= _tier(max(n, 1), minimum=minimum):
                    return
                t *= 2

        grid = []
        for np_tier in tiers(expected_poses, np_floor):
            # realistic SLAM graphs have edges ~ nodes + loop closures:
            # warm the edge tiers a solve pads to (``ne_floor`` times a
            # power of two, not a power of two itself when the floor is
            # not) from n / 2 to 2n. A graph that pads to a pose tier
            # above the floor holds more than n / 2 poses, so, connected,
            # at least n / 2 edges; on the floor pose tier, where a
            # mission's first small graphs pad, from the floor.
            hi = _tier(min(2 * np_tier, max(expected_edges, np_tier)),
                       minimum=ne_floor)
            lo = _tier(np_tier // 2, minimum=ne_floor)
            for ne_tier in tiers(hi, ne_floor):
                if np_tier == np_floor or ne_tier >= lo:
                    grid.append((np_tier, ne_tier))
        return grid

    def warmup_tier(self, np_tier: int, ne_tier: int) -> None:
        """Run BOTH solvers on ONE (pose, edge) tier, without going
        through _optimize (which would pollute the carried TLS weights
        with the dummy graph's edges), through the same
        _gnc_call/_reopt_call chokepoints as real optimizations. The
        poses are bumped with a clone-and-add (the JAX original's
        ``.at[].add``)."""
        g = FactorGraph()
        for k in range(np_tier):
            g.add_variable((self.robot_id, k), np.eye(4))
        for k in range(ne_tier):
            a = k % np_tier
            b = (k + 1) % np_tier
            if a == b:
                b = (b + 1) % np_tier
            g.add_between((self.robot_id, a), (self.robot_id, b),
                          np.eye(4), self.default_sigmas,
                          robust=k % 2 == 0)
        g.add_prior((self.robot_id, 0), np.eye(4), self.default_sigmas)
        import dataclasses as _dc
        arrays = g.to_arrays(np_floor=self._np_floor,
                             ne_floor=self._ne_floor, device=self.device)
        for bump in (0.0, 1e-7):
            poses = arrays.poses.clone()
            poses[:, 0, 3] += bump
            a = _dc.replace(arrays, poses=poses)
            self._gnc_call(a).poses.cpu()
            self._reopt_call(a, np.ones(arrays.num_edges)).poses.cpu()

    # ------------------------------------------------------------------
    # Intake (cpp:233-320)
    # ------------------------------------------------------------------

    def odometry_callback(self, msg: KeyframeOdom) -> None:
        pose = np.asarray(msg.odom.pose, np.float64)
        key = (self.robot_id, msg.id)
        self.odometry_pose_estimates[key] = pose
        if msg.id == 0:
            self.current_pose_estimates[key] = pose
        if self.latest_local_key is not None:
            odom_diff = np.linalg.inv(self.latest_local_pose) @ pose
            self.local_factors.append(PoseGraphEdge(
                key_from=PoseKey(*self.latest_local_key),
                key_to=PoseKey(*key), measurement=odom_diff,
                noise_sigmas=self.default_sigmas))
        if msg.gps is not None:
            self.gps_data[msg.id] = msg.gps
        self.latest_local_pose = pose
        self.latest_local_key = key
        if (self.logger is not None and self.params.get(
                "evaluation.enable_pose_timestamps_recording", False)):
            self.logger.log_pose_timestamp(key, msg.odom.stamp)

    def intra_robot_loop_closure_callback(self,
                                          msg: IntraRobotLoopClosure) -> None:
        if not msg.success:
            return
        self.local_factors.append(PoseGraphEdge(
            key_from=PoseKey(self.robot_id, msg.keyframe0_id),
            key_to=PoseKey(self.robot_id, msg.keyframe1_id),
            measurement=np.asarray(msg.transform),
            noise_sigmas=self.default_sigmas))

    def inter_robot_loop_closure_callback(self,
                                          msg: InterRobotLoopClosure) -> None:
        if not msg.success:
            return
        pair = (min(msg.robot0_id, msg.robot1_id),
                max(msg.robot0_id, msg.robot1_id))
        self.inter_robot_loop_closures[pair].append(PoseGraphEdge(
            key_from=PoseKey(msg.robot0_id, msg.robot0_keyframe_id),
            key_to=PoseKey(msg.robot1_id, msg.robot1_keyframe_id),
            measurement=np.asarray(msg.transform),
            noise_sigmas=self.default_sigmas))
        if msg.robot0_id == self.robot_id:
            self.connected_robots.add(msg.robot1_id)
        elif msg.robot1_id == self.robot_id:
            self.connected_robots.add(msg.robot0_id)

    # ------------------------------------------------------------------
    # Election + waiting (cpp:332-368, 515-542)
    # ------------------------------------------------------------------

    def current_neighbors_callback(self, msg: RobotIdsAndOrigin) -> None:
        self.current_neighbors = msg
        self.end_waiting()
        self.optimizer_state = (OptimizerState.POSEGRAPH_COLLECTION
                                if self.is_optimizer()
                                else OptimizerState.IDLE)

    def is_optimizer(self) -> bool:
        """Lowest (origin, id) among neighbors runs the optimization."""
        if not self.odometry_pose_estimates:
            return False
        for origin, rid in zip(self.current_neighbors.origins.ids,
                               self.current_neighbors.robots.ids):
            if self.origin_robot_id > origin:
                return False
            if self.origin_robot_id == origin and self.robot_id > rid:
                return False
        return True

    def start_waiting(self) -> None:
        if self.optimizer_state == OptimizerState.IDLE:
            self.optimizer_state = OptimizerState.WAITING_FOR_NEIGHBORS_INFO
        elif self.optimizer_state == OptimizerState.POSEGRAPH_COLLECTION:
            self.optimizer_state = \
                OptimizerState.WAITING_FOR_NEIGHBORS_POSEGRAPHS
        self.is_waiting = True
        self.start_waiting_time = self.ctx.clock.now()

    def end_waiting(self) -> None:
        self.is_waiting = False

    def check_waiting_timeout(self) -> None:
        if (self.ctx.clock.now() - self.start_waiting_time
                > self.max_waiting_time_sec):
            self.end_waiting()
            self.optimizer_state = OptimizerState.IDLE

    # ------------------------------------------------------------------
    # Pose-graph exchange (cpp:370-462)
    # ------------------------------------------------------------------

    def fill_pose_graph_msg(self, for_robots: Optional[List[int]] = None
                            ) -> PoseGraph:
        ids = (for_robots if for_robots is not None
               else list(self.current_neighbors.robots.ids) + [self.robot_id])
        msg = PoseGraph(robot_id=self.robot_id,
                        origin_robot_id=self.origin_robot_id)
        msg.values = [PoseGraphValue(key=PoseKey(*k), pose=v)
                      for k, v in self.odometry_pose_estimates.items()]
        msg.edges = list(self.local_factors)
        connected = set()
        for a in range(len(ids)):
            for b in range(a + 1, len(ids)):
                lo, hi = min(ids[a], ids[b]), max(ids[a], ids[b])
                factors = self.inter_robot_loop_closures.get((lo, hi), [])
                if factors and self.robot_id in (lo, hi):
                    connected.update((lo, hi))
                    if lo == self.robot_id:
                        msg.edges = msg.edges + factors
        msg.connected_robots = [i for i in sorted(connected)
                                if i != self.robot_id]
        if self.gps_data:
            msg.gps_values_idx = sorted(self.gps_data)
            msg.gps_values = [self.gps_data[i] for i in msg.gps_values_idx]
        if self.logger is not None:
            self.logger.fill_msg(msg)
        return msg

    def get_pose_graph_callback(self, msg: RobotIds) -> None:
        self.pose_graph_publisher.publish(self.fill_pose_graph_msg(msg.ids))
        self._tentative_local_pose_at_latest_optimization = \
            self.latest_local_pose

    def pose_graph_callback(self, msg: PoseGraph) -> None:
        if self.optimizer_state != \
                OptimizerState.WAITING_FOR_NEIGHBORS_POSEGRAPHS:
            return
        self.other_robots_graphs[msg.robot_id] = msg
        self.received_pose_graphs[msg.robot_id] = True
        self.received_connectivity[msg.robot_id] = list(msg.connected_robots)
        if self.logger is not None:
            self.logger.add_pose_graph_log_info(msg)
        if all(self.received_pose_graphs.get(i, False)
               for i in self.current_neighbors.robots.ids):
            self.end_waiting()
            self.optimizer_state = OptimizerState.START_OPTIMIZATION
            if self.logger is not None:
                self.logger.add_pose_graph_log_info(self.fill_pose_graph_msg())

    # ------------------------------------------------------------------
    # Aggregation (cpp:464-634)
    # ------------------------------------------------------------------

    def connected_robot_pose_graph(self) -> Dict[int, bool]:
        """BFS over received connectivity from the local robot."""
        adjacency = dict(self.received_connectivity)
        if self.connected_robots:
            adjacency[self.robot_id] = sorted(self.connected_robots)
        is_connected = {self.robot_id: True}
        for rid in self.current_neighbors.robots.ids:
            is_connected.setdefault(rid, False)
        visited = {self.robot_id}
        queue = [self.robot_id]
        while queue:
            cur = queue.pop(0)
            for rid in adjacency.get(cur, ()):
                is_connected[rid] = True
                if rid not in visited:
                    visited.add(rid)
                    queue.append(rid)
        return is_connected

    def _warm_start_values(self, raw):
        """Re-initialize variables from the previous optimized solution.

        TPU-native improvement over the reference (which re-optimizes from
        the aggregated odometry values every round, cpp:555-634): keys seen
        in the last solution reuse it; newer keys chain their odometry
        increment off that robot's last optimized pose. Cuts GNC outer
        iterations in steady state; disable with backend.enable_warm_start.
        """
        self._warmed_this_round = False
        warm = self._last_optimized_values
        if not warm or not self.params.get("backend.enable_warm_start", True):
            return raw
        covered = sum(1 for k in raw if k in warm
                      or k[0] in {wk[0] for wk in warm})
        if covered < len(raw) // 2:
            # a merge brought in mostly-unseen robots: the warm basin no
            # longer covers the graph, run the full cold initial solve
            return raw
        self._warmed_this_round = True
        last_warm_key = {}
        for k in warm:
            if k in raw and k[1] > last_warm_key.get(k[0], (None, -1))[1]:
                last_warm_key[k[0]] = k
        out = {}
        for k, pose in raw.items():
            if k in warm:
                out[k] = warm[k]
            elif k[0] in last_warm_key:
                j = last_warm_key[k[0]]
                out[k] = warm[j] @ np.linalg.inv(raw[j]) @ pose
            else:
                out[k] = pose
        return out

    def aggregate_pose_graphs(self) -> FactorGraph:
        is_connected = self.connected_robot_pose_graph()
        graph = FactorGraph()
        raw = dict(self.odometry_pose_estimates)
        self._tentative_local_pose_at_latest_optimization = \
            self.latest_local_pose
        for rid in self.current_neighbors.robots.ids:
            if is_connected.get(rid, False) and rid in self.other_robots_graphs:
                for v in self.other_robots_graphs[rid].values:
                    raw[v.key.as_tuple()] = v.pose
        for key, pose in self._warm_start_values(raw).items():
            graph.add_variable(key, pose)

        added: Set[Tuple[Tuple[int, int], Tuple[int, int]]] = set()

        def try_add(edge: PoseGraphEdge, robust: bool) -> None:
            kf, kt = edge.key_from.as_tuple(), edge.key_to.as_tuple()
            if not (is_connected.get(kf[0], False)
                    and is_connected.get(kt[0], False)):
                return
            if kf not in graph or kt not in graph or (kf, kt) in added:
                return
            added.add((kf, kt))
            graph.add_between(kf, kt, edge.measurement, edge.noise_sigmas,
                              robust=robust)

        for edge in self.local_factors:
            try_add(edge, robust=edge.key_from.keyframe_id + 1
                    != edge.key_to.keyframe_id)
        included = list(self.current_neighbors.robots.ids) + [self.robot_id]
        for a in range(len(included)):
            for b in range(a + 1, len(included)):
                lo, hi = (min(included[a], included[b]),
                          max(included[a], included[b]))
                for edge in self.inter_robot_loop_closures.get((lo, hi), []):
                    try_add(edge, robust=True)
        for rid in self.current_neighbors.robots.ids:
            if rid not in self.other_robots_graphs:
                continue
            for edge in self.other_robots_graphs[rid].edges:
                inter = edge.key_from.robot_id != edge.key_to.robot_id
                consecutive = (not inter and edge.key_from.keyframe_id + 1
                               == edge.key_to.keyframe_id)
                try_add(edge, robust=not consecutive)
        return graph

    # ------------------------------------------------------------------
    # Optimization (cpp:796-926)
    # ------------------------------------------------------------------

    @staticmethod
    def _edge_weight_key(e: PoseGraphEdge) -> Tuple:
        """Canonical (symmetric) edge identity for carrying TLS weights
        across optimization rounds."""
        a, b = e.key_from.as_tuple(), e.key_to.as_tuple()
        return (a, b) if a <= b else (b, a)

    def _optimize_distributed(self, graph: FactorGraph):
        """Solve the aggregated multi-robot graph with the robot-sharded
        block Gauss-Seidel mode (``backend.pgo_mode: distributed``): one
        robot's subgraph per block of a ``StackedMesh`` on this node's
        device (``pgo/distributed.py``). The JAX package returned None with
        fewer devices than robots and fell back to the centralized solve
        (``cslam_tpu/runtime/backend_node.py:536-538``); here one device
        holds every block, so that case does not arise. Counts its solves
        in ``distributed_solves``."""
        problem, slot = split_factor_graph(graph, self.robot_id)
        # steady-state rounds: the aggregate graph's variables carry the
        # previous solution (warm_start_values), so the hard-TLS warm mode
        # applies (the distributed analogue of gnc_reoptimize); a periodic
        # full solve guards against drift, like the centralized path
        full_every = self.params.get(
            "backend.full_gnc_every_n_optimizations", 10)
        warm = (getattr(self, "_warmed_this_round", False)
                and self.optimization_count > 0
                and (full_every <= 0
                     or self.optimization_count % full_every != 0))
        # previous round's separator classification, stored by REAL robot
        # ids (slots renumber when the connected set changes), translated
        # to this round's slot keys
        carried = None
        prev = getattr(self, "_last_sep_weights", None)
        if warm and prev:
            carried = {}
            for ((r0, k0), (r1, k1)), wv in prev.items():
                if r0 in slot and r1 in slot:
                    carried[((slot[r0], k0), (slot[r1], k1))] = wv
        values, dinfo = distributed_optimize(
            problem, StackedMesh(len(slot), self.device),
            sweeps=self.params.get("backend.distributed_max_sweeps", 30),
            lm_iters=self.params.get("backend.lm_max_iterations", 50),
            cg_iters=self.params.get("backend.cg_max_iterations", 150),
            mu_step=self.params.get("backend.gnc_mu_step",
                                    config.BackendConfig.gnc_mu_step),
            barc_sq=self.params.get("backend.gnc_barc_sq", 16.81),
            warm=warm, carried_weights=carried, return_info=True)
        self.distributed_solves += 1
        unslot = {i: r for r, i in slot.items()}
        self._last_sep_weights = {
            ((unslot[s0], k0), (unslot[s1], k1)): wv
            for ((s0, k0), (s1, k1)), wv in dinfo.sep_weight_by_key.items()}
        # back into the aggregate graph's padded pose layout
        n = _tier(max(len(graph), 1), minimum=max(16, self._np_floor))
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for key, idx in graph._index.items():
            poses[idx] = values[(slot[key[0]], key[1])]
        return poses

    def _gnc_call(self, arrays):
        """Single chokepoint for ``gnc_optimize`` (warmup and production
        share one call with the configured solver knobs)."""
        return gnc_optimize(
            arrays,
            max_outer=self.params.get(
                "backend.gnc_max_outer_iterations", 100),
            lm_iters=self.params.get("backend.lm_max_iterations", 50),
            cg_iters=self.params.get("backend.cg_max_iterations", 150),
            barc_sq=self.params.get("backend.gnc_barc_sq", 16.81),
            mu_step=self.params.get("backend.gnc_mu_step",
                                    config.BackendConfig.gnc_mu_step))

    def _reopt_call(self, arrays, weights):
        """Chokepoint for ``gnc_reoptimize`` (see :meth:`_gnc_call`)."""
        return gnc_reoptimize(
            arrays, torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                                    device=self.device),
            lm_iters=self.params.get("backend.lm_max_iterations", 50),
            cg_iters=self.params.get("backend.cg_max_iterations", 150),
            barc_sq=self.params.get("backend.gnc_barc_sq", 16.81))

    def _maybe_dump_graph(self, arrays) -> None:
        """Debug hook: CSLAM_TPU_DUMP_PGO=<dir> saves every aggregate graph
        this node solves as ``pgo_r{robot_id}_{seq:03d}.npz``, one key per
        PoseGraphArrays field in the JAX package's dtypes (no tensor, no
        pickle), so that a slow optimization seen in a live run replays
        alone in either package (``tools/pgo_replay.py``). Unset, it costs
        one environment lookup and no device read."""
        dump_dir = os.environ.get("CSLAM_TPU_DUMP_PGO", "")
        if not dump_dir:
            return
        os.makedirs(dump_dir, exist_ok=True)
        seq = getattr(self, "_dump_seq", 0)
        self._dump_seq = seq + 1
        np.savez(os.path.join(
            dump_dir, f"pgo_r{self.robot_id}_{seq:03d}.npz"),
            **arrays_to_numpy(arrays))

    def _optimize(self, graph: FactorGraph):
        with profiling.span("pgo.optimize"):
            return self._optimize_impl(graph)

    def _optimize_impl(self, graph: FactorGraph):
        if self.logger is not None:
            self.logger.start_timer()
        if self.params.get("backend.pgo_mode", "centralized") == "distributed":
            poses_d = self._optimize_distributed(graph)
            self._last_edge_weights = {}  # modes don't share warm state
            if self.logger is not None:
                self.logger.stop_timer()
                self.logger.log_optimized_global_pose_graph(
                    graph, poses_d, self.robot_id)
            return graph, poses_d
        arrays = graph.to_arrays(np_floor=self._np_floor,
                                 ne_floor=self._ne_floor, device=self.device)
        self._maybe_dump_graph(arrays)
        edge_keys = [self._edge_weight_key(e) for e in graph.edges_as_records()]
        full_every = self.params.get(
            "backend.full_gnc_every_n_optimizations", 10)
        warm_ok = (getattr(self, "_warmed_this_round", False)
                   and self._last_edge_weights
                   and (full_every <= 0
                        or self.optimization_count % full_every != 0))
        if warm_ok:
            # incremental round: previous TLS weights, new edges enter at 1
            w = np.ones(arrays.num_edges, np.float64)
            for slot, k in enumerate(edge_keys):
                w[slot] = self._last_edge_weights.get(k, 1.0)
            result = self._reopt_call(arrays, w)
        else:
            result = self._gnc_call(arrays)
        weights = result.weights.cpu().numpy()
        self._last_edge_weights = {k: float(weights[slot])
                                   for slot, k in enumerate(edge_keys)}
        poses = result.poses.cpu().numpy()
        if self.logger is not None:
            self.logger.stop_timer()
            self.logger.log_optimized_global_pose_graph(graph, poses,
                                                        self.robot_id)
        return graph, poses

    def start_optimization(self) -> None:
        graph = self.aggregate_pose_graphs()
        first_key = (self.robot_id, 0)
        if first_key not in graph:
            return
        anchor = self.current_pose_estimates.get(
            first_key, graph.get_pose(first_key))
        graph.add_prior(first_key, anchor, self.default_sigmas)
        if self.logger is not None:
            self.logger.log_initial_global_pose_graph(graph)
        self._aggregate = graph
        if self.synchronous:
            fut = Future()
            fut.set_result(self._optimize(graph))
            self._optimization_future = fut
        else:
            self._optimization_future = self._executor.submit(
                self._optimize, graph)
        self.optimizer_state = OptimizerState.OPTIMIZATION

    def check_result_and_finish_optimization(self) -> None:
        fut = self._optimization_future
        if fut is None or not fut.done():
            return
        graph, poses = fut.result()
        self._optimization_future = None
        self.optimization_count += 1
        self._last_optimized_values = {
            v.key.as_tuple(): v.pose for v in graph.values_from_arrays(poses)}
        self.share_optimized_estimates(graph, poses)
        # debug result for monitoring (reference cpp:873-880)
        self.debug_optimization_result_publisher.publish(OptimizationResult(
            success=True, origin_robot_id=self.origin_robot_id,
            estimates=graph.values_from_arrays(poses),
            factors=graph.edges_as_records()))
        self.optimizer_state = OptimizerState.IDLE

    def share_optimized_estimates(self, graph: FactorGraph,
                                  poses: np.ndarray) -> None:
        values = graph.values_from_arrays(poses)
        included = list(self.current_neighbors.robots.ids) + [self.robot_id]
        for rid in included:
            msg = OptimizationResult(
                success=True, origin_robot_id=self.origin_robot_id,
                estimates=[v for v in values if v.key.robot_id == rid])
            self.optimized_estimates_publishers[rid].publish(msg)

    def optimized_estimates_callback(self, msg: OptimizationResult) -> None:
        if not self.odometry_pose_estimates or not msg.estimates:
            return
        self.current_pose_estimates = {
            v.key.as_tuple(): v.pose for v in msg.estimates}
        self.origin_robot_id = msg.origin_robot_id
        first = self.current_pose_estimates.get((self.robot_id, 0), np.eye(4))
        self.update_transform_to_origin(first)
        if self.logger is not None:
            self.logger.write_logs()

    def update_transform_to_origin(self, first_pose: np.ndarray) -> None:
        self.origin_to_first_pose = first_pose
        self.reference_frames_publisher.publish(ReferenceFrames(
            robot_id=self.robot_id, origin_to_local=first_pose))
        self.local_pose_at_latest_optimization = \
            self._tentative_local_pose_at_latest_optimization
        last_key = max(self.current_pose_estimates)
        self.latest_optimized_pose = self.current_pose_estimates[last_key]

    def current_pose_estimate(self) -> np.ndarray:
        """Fused pose: latest optimized pose composed with odometry since
        (cpp:779-793)."""
        diff = (np.linalg.inv(self.local_pose_at_latest_optimization)
                @ self.latest_local_pose)
        return self.latest_optimized_pose @ diff

    # ------------------------------------------------------------------
    # Timers (cpp:544-553, 884-926, 683-694)
    # ------------------------------------------------------------------

    def optimization_callback(self) -> None:
        if (self.optimizer_state == OptimizerState.IDLE
                and self.odometry_pose_estimates):
            self.received_pose_graphs = {}
            self.other_robots_graphs = {}
            self.received_connectivity = {}
            self.get_current_neighbors_publisher.publish(object())
            self.start_waiting()

    def optimization_loop_callback(self) -> None:
        if not self.odometry_pose_estimates:
            return
        if self.optimizer_state == OptimizerState.POSEGRAPH_COLLECTION:
            if self.current_neighbors.robots.ids:
                ids = RobotIds(ids=list(self.current_neighbors.robots.ids)
                               + [self.robot_id])
                for rid in self.current_neighbors.robots.ids:
                    self.get_pose_graph_publishers[rid].publish(ids)
                self.start_waiting()
            else:
                self.optimizer_state = OptimizerState.START_OPTIMIZATION
        elif self.optimizer_state == OptimizerState.START_OPTIMIZATION:
            self.start_optimization()
        elif self.optimizer_state == OptimizerState.OPTIMIZATION:
            self.check_result_and_finish_optimization()
        elif self.is_waiting:
            self.check_waiting_timeout()
        self.optimizer_state_publisher.publish(
            OptimizerStateMsg(state=int(self.optimizer_state)))

    def broadcast_tf_callback(self) -> None:
        """Publish the reference-frame chain + fused current pose
        (reference cpp:755-794): origin map -> own map -> latest optimized
        pose -> current odometry-only pose."""
        diff = (np.linalg.inv(self.local_pose_at_latest_optimization)
                @ self.latest_local_pose)
        frames = {
            f"robot{self.origin_robot_id}_map->robot{self.robot_id}_map":
                self.origin_to_first_pose,
            f"robot{self.robot_id}_latest_optimized_pose":
                self.latest_optimized_pose,
            f"robot{self.robot_id}_current_pose":
                self.latest_optimized_pose @ diff,
        }
        self.tf_publisher.publish(frames)
        self.current_pose_publisher.publish(self.current_pose_estimate())

    def visualization_callback(self) -> None:
        """Publish the current estimates + factors for visualization
        (reference cpp:696-729)."""
        msg = PoseGraph(robot_id=self.robot_id,
                        origin_robot_id=self.origin_robot_id)
        msg.values = [PoseGraphValue(key=PoseKey(*k), pose=v)
                      for k, v in self.current_pose_estimates.items()]
        msg.edges = list(self.local_factors)
        for (lo, hi), factors in self.inter_robot_loop_closures.items():
            if lo == self.robot_id and factors:
                msg.edges = msg.edges + factors
        self.viz_pose_graph_publisher.publish(msg)

    def write_current_estimates_callback(self, msg) -> None:
        """Dump the current local graph + estimates as g2o on request
        (reference ``cslam/print_current_estimates`` -> writeG2o,
        cpp:322-330). The message payload is the output path."""
        from cslam_tpu_torch.evaluation import g2o as g2o_io
        path = msg if isinstance(msg, str) else getattr(msg, "data", None)
        if not path:
            return
        values = dict(self.current_pose_estimates)
        for k, v in self.odometry_pose_estimates.items():
            values.setdefault(k, v)
        g2o_io.write_g2o(path, values, list(self.local_factors))

    def heartbeat_timer_callback(self) -> None:
        if self.sim_rendezvous is not None and not self.sim_rendezvous.is_alive():
            return
        self.heartbeat_publisher.publish(
            Heartbeat(origin_robot_id=self.origin_robot_id))

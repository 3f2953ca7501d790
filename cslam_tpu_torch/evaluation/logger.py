"""Experiment logger: metrics CSVs, g2o dumps, PGO timers, comm accounting.

Parity with the reference's evaluation subsystem
(``src/back_end/utils/logger.cpp``): a per-experiment timestamped folder;
a KeyValue metric bus (``cslam/log_info`` topic, producers in the detection
front end and sensor handlers); PGO wall-clock timers (ll.59-69); initial and
optimized global pose graphs dumped as ``.g2o`` (ll.82-103); a metrics CSV
with match counts, communication bytes, sparsification and PGO times and
graph errors (ll.105-153); GPS and pose-timestamp CSVs (ll.155-204); and
``fill_msg`` aggregation of front-end counters into outgoing PoseGraph
messages (ll.325-334).

Counterpart of ``cslam_tpu/evaluation/logger.py``. The graph error is the
port's ``pgo.solver.cost`` on the logger's torch device (the back end's;
CUDA unless the caller passes another), read back as a Python float.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.types import KeyValue, PoseGraph

_METRIC_KEYS = (
    "nb_matches", "nb_failed_matches", "nb_vertices_transmitted",
    "nb_matches_selected", "detection_cumulative_communication",
    "sparsification_cumulative_computation_time",
    "local_descriptors_cumulative_communication",
)


class ExperimentLogger:
    """Per-robot experiment logging (attach to the back-end node)."""

    def __init__(self, ctx, log_folder: str, device=None):
        self.ctx = ctx
        self.device = resolve_device(device)
        self.robot_id = ctx.params["robot_id"]
        stamp = f"{ctx.clock.now():.0f}"
        self.folder = os.path.join(log_folder,
                                   f"experiment_{stamp}_r{self.robot_id}")
        os.makedirs(self.folder, exist_ok=True)
        self.metrics: Dict[str, float] = {k: 0.0 for k in _METRIC_KEYS}
        self.total_pgo_time = 0.0
        self._timer_start: Optional[float] = None
        self.optimization_count = 0
        self._pose_graphs_log_info: List[Dict[str, float]] = []
        self._initial_graph = None
        self._optimized = None
        self._pose_timestamps: List[Tuple[Tuple[int, int], float]] = []
        self._gps_data: Dict[Tuple[int, int], object] = {}
        self._spectral_matches: List[Tuple[float, int, int, int, int, float]] = []
        ctx.create_subscription("cslam/log_info", self.log_info_callback)
        ctx.create_subscription("cslam/log_matches", self.log_matches_callback)

    # -- KeyValue metric bus (reference logger.cpp:274-308) --

    def log_info_callback(self, msg: KeyValue) -> None:
        if msg.key in self.metrics:
            try:
                self.metrics[msg.key] = float(msg.value)
            except ValueError:
                pass

    def log_matches_callback(self, msg) -> None:
        """MAC-selected matches for spectral-analysis CSVs
        (reference logger.cpp:174-191)."""
        now = self.ctx.clock.now()
        for m in msg.matches:
            self._spectral_matches.append(
                (now, m.robot0_id, m.robot0_keyframe_id, m.robot1_id,
                 m.robot1_keyframe_id, m.weight))

    # -- PGO wall-clock timers (logger.cpp:59-69) --

    def start_timer(self) -> None:
        import time
        self._timer_start = time.monotonic()

    def stop_timer(self) -> None:
        import time
        if self._timer_start is not None:
            self.total_pgo_time += time.monotonic() - self._timer_start
            self._timer_start = None

    # -- pose-graph log aggregation (logger.cpp:325-334; consumed per
    #    optimization round) --

    def fill_msg(self, msg: PoseGraph) -> None:
        msg.log_info = dict(self.metrics)
        msg.log_info["total_pgo_time"] = self.total_pgo_time

    def add_pose_graph_log_info(self, msg: PoseGraph) -> None:
        if msg.log_info:
            self._pose_graphs_log_info.append(dict(msg.log_info))
        # GPS fixes ride along in PoseGraph messages (reference
        # logger.cpp:155-172 writes them to a per-robot CSV)
        for idx, gps in zip(msg.gps_values_idx, msg.gps_values):
            self._gps_data[(msg.robot_id, idx)] = gps

    def log_pose_timestamp(self, key, stamp: float) -> None:
        self._pose_timestamps.append((tuple(key), stamp))

    # -- graph dumps (logger.cpp:82-103) --

    def log_initial_global_pose_graph(self, graph) -> None:
        self._initial_graph = graph

    def log_optimized_global_pose_graph(self, graph, poses: np.ndarray,
                                        robot_id: int) -> None:
        self._optimized = (graph, np.asarray(poses))
        self.optimization_count += 1

    # -- error metric (logger.cpp:259-272): residual RMS of the optimized
    #    graph --

    def compute_error(self) -> float:
        if self._optimized is None:
            return float("nan")
        from cslam_tpu_torch.pgo import solver
        graph, poses = self._optimized
        arrays = graph.to_arrays(device=self.device)
        c = solver.cost(
            torch.as_tensor(poses, dtype=arrays.poses.dtype,
                            device=self.device), arrays,
            torch.ones(arrays.num_edges, device=self.device))
        return float(c)

    # -- artifact writes (logger.cpp:71-219) --

    def write_logs(self) -> None:
        from cslam_tpu_torch.evaluation import g2o as g2o_io
        n = self.optimization_count
        if self._initial_graph is not None:
            values = {tuple(v.key.as_tuple()): v.pose
                      for v in self._initial_graph.values_from_arrays(
                          self._initial_graph.to_arrays(
                              device=self.device).poses)}
            g2o_io.write_g2o(
                os.path.join(self.folder, f"initial_global_{n}.g2o"),
                values, self._initial_graph.edges_as_records())
        if self._optimized is not None:
            graph, poses = self._optimized
            values = {tuple(v.key.as_tuple()): v.pose
                      for v in graph.values_from_arrays(poses)}
            g2o_io.write_g2o(
                os.path.join(self.folder, f"optimized_global_{n}.g2o"),
                values, graph.edges_as_records())

        row = dict(self.metrics)
        row["total_pgo_time"] = self.total_pgo_time
        row["graph_error"] = self.compute_error()
        row["optimization_count"] = self.optimization_count
        path = os.path.join(self.folder, "metrics.csv")
        write_header = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(row))
            if write_header:
                writer.writeheader()
            writer.writerow(row)

        if self._spectral_matches:
            with open(os.path.join(self.folder, "spectral_matches.csv"), "w",
                      newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["stamp", "robot0_id", "robot0_keyframe_id",
                                 "robot1_id", "robot1_keyframe_id", "weight"])
                writer.writerows(self._spectral_matches)

        if self._gps_data:
            with open(os.path.join(self.folder, "gps.csv"), "w",
                      newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["robot_id", "keyframe_id", "gps"])
                for (rid, kf), gps in sorted(self._gps_data.items()):
                    writer.writerow([rid, kf, gps])

        if self._pose_timestamps:
            with open(os.path.join(self.folder, "pose_timestamps.csv"),
                      "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["robot_id", "keyframe_id", "stamp"])
                for (rid, kf), stamp in self._pose_timestamps:
                    writer.writerow([rid, kf, stamp])

"""Checkpoint / resume of per-robot runtime state.

The reference has no runtime checkpointing — a restarted robot loses its
in-memory banks and graphs and relies on gossip resend to recover
(SURVEY.md §5). Here the full per-robot state is explicitly snapshotable:
descriptor banks, candidate/fixed edge bookkeeping, gossip buffers and
windows, and the back end's pose graph. A restored robot continues exactly
where it left off (same keyframe counters, same candidate pool), instead of
re-downloading the swarm's history.

Format: one pickled dict of numpy arrays and plain Python objects.

Counterpart of ``cslam_tpu/utils/snapshot.py``. The state is pickled by
``utils.host_pickle``, which refuses a ``torch.Tensor``: the banks are
saved from their host mirrors (``DescriptorBank._host``,
``ScanContextBank._sc_host``) and the back end keeps its poses in numpy,
so a snapshot holds no device state. One written from CUDA nodes restores
into CPU nodes and the other way round; a restored bank starts with no
device copy and uploads its rows at its next search.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict

from cslam_tpu_torch.utils import host_pickle


def _bank_state(bank) -> Dict[str, Any]:
    from cslam_tpu_torch.matching.nns_bank import DescriptorBank
    from cslam_tpu_torch.matching.scancontext_bank import ScanContextBank
    if isinstance(bank, DescriptorBank):
        return {"kind": "nns", "n": bank.n, "dim": bank.dim,
                "data": None if bank._host is None else bank._host[:bank.n].copy(),
                "items": dict(bank.items)}
    if isinstance(bank, ScanContextBank):
        return {"kind": "sc", "n": bank.nb_items, "shape": bank.shape,
                "sc": bank._sc_host[:bank.nb_items].copy(),
                "items": dict(bank.items)}
    raise TypeError(f"unknown bank type {type(bank)}")


def _restore_bank(bank, state: Dict[str, Any]) -> None:
    if state["kind"] == "nns":
        if state["data"] is not None:
            bank.add_items(state["data"],
                           [state["items"][i] for i in range(state["n"])])
    else:
        for i in range(state["n"]):
            bank.add_item(state["sc"][i].reshape(-1), state["items"][i])


def snapshot_robot(detection, backend, path: str) -> None:
    """Serialize one robot's detection + back-end state."""
    # drain the async planes first: in-flight device results (deferred
    # embeds / searches) are not serializable, and dropping them would
    # silently un-embed keyframes after restore
    if hasattr(detection, "_drain_embeds"):
        detection._drain_embeds()
    if hasattr(detection, "_harvest_searches"):
        detection._harvest_searches()
    sel = detection.lcm.candidate_selector
    state = {
        "robot_id": detection.robot_id,
        # detection front end
        "local_bank": _bank_state(detection.lcm.local_nnsm),
        "other_banks": {rid: _bank_state(b)
                        for rid, b in detection.lcm.other_robots_nnsm.items()},
        "fixed_edges": list(sel.fixed_edges),
        "candidate_edges": dict(sel.candidate_edges),
        "already_considered": set(sel.already_considered_matches),
        "nb_poses": dict(sel.nb_poses),
        "initial_fixed_edge_exists": dict(sel.initial_fixed_edge_exists),
        "gd_buffer": dict(detection.global_descriptors_buffer),
        "match_buffer": dict(detection.inter_robot_matches_buffer),
        "nb_inter_robot_matches": detection.nb_inter_robot_matches,
        "stats": dict(detection.stats),
        "monitor_windows": {
            rid: {"last_keyframe_sent": m.last_keyframe_sent,
                  "last_match_sent": m.last_match_sent,
                  "last_keyframe_received": m.last_keyframe_received}
            for rid, m in
            detection.neighbor_manager.neighbors_monitors.items()},
        # back end
        "odometry_pose_estimates": dict(backend.odometry_pose_estimates),
        "last_optimized_values": dict(backend._last_optimized_values),
        "last_edge_weights": dict(backend._last_edge_weights),
        "current_pose_estimates": dict(backend.current_pose_estimates),
        "local_factors": list(backend.local_factors),
        "inter_robot_loop_closures": {
            k: list(v) for k, v in backend.inter_robot_loop_closures.items()},
        "connected_robots": set(backend.connected_robots),
        "latest_local_key": backend.latest_local_key,
        "latest_local_pose": backend.latest_local_pose.copy(),
        "origin_robot_id": backend.origin_robot_id,
        "origin_to_first_pose": backend.origin_to_first_pose.copy(),
        "optimization_count": backend.optimization_count,
    }
    data = host_pickle.dumps(state)
    with open(path, "wb") as f:
        f.write(data)


def restore_robot(detection, backend, path: str) -> None:
    """Restore state written by :func:`snapshot_robot` into fresh nodes."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert state["robot_id"] == detection.robot_id, "snapshot robot mismatch"

    _restore_bank(detection.lcm.local_nnsm, state["local_bank"])
    for rid, bstate in state["other_banks"].items():
        _restore_bank(detection.lcm.other_robots_nnsm[rid], bstate)
    sel = detection.lcm.candidate_selector
    sel.fixed_edges = list(state["fixed_edges"])
    sel.candidate_edges = dict(state["candidate_edges"])
    sel.already_considered_matches = set(state["already_considered"])
    sel.nb_poses.update(state["nb_poses"])
    sel.initial_fixed_edge_exists.update(state["initial_fixed_edge_exists"])
    detection.global_descriptors_buffer = dict(state["gd_buffer"])
    detection.inter_robot_matches_buffer = dict(state["match_buffer"])
    detection.nb_inter_robot_matches = state["nb_inter_robot_matches"]
    detection.stats.update(state["stats"])
    for rid, win in state["monitor_windows"].items():
        mon = detection.neighbor_manager.neighbors_monitors[rid]
        mon.last_keyframe_sent = win["last_keyframe_sent"]
        mon.last_match_sent = win["last_match_sent"]
        mon.last_keyframe_received = win["last_keyframe_received"]

    backend.odometry_pose_estimates = dict(state["odometry_pose_estimates"])
    backend._last_optimized_values = dict(
        state.get("last_optimized_values", {}))
    backend._last_edge_weights = dict(state.get("last_edge_weights", {}))
    backend.current_pose_estimates = dict(state["current_pose_estimates"])
    backend.local_factors = list(state["local_factors"])
    backend.inter_robot_loop_closures = {
        k: list(v) for k, v in state["inter_robot_loop_closures"].items()}
    backend.connected_robots = set(state["connected_robots"])
    backend.latest_local_key = state["latest_local_key"]
    backend.latest_local_pose = state["latest_local_pose"]
    backend.origin_robot_id = state["origin_robot_id"]
    backend.origin_to_first_pose = state["origin_to_first_pose"]
    backend.optimization_count = state["optimization_count"]

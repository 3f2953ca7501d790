"""Neighbor liveness monitoring and gossip-window bookkeeping.

Behavior parity with the reference ``cslam/neighbor_monitor.py`` and
``cslam/neighbors_manager.py``: heartbeat freshness windows, lowest-alive-ID
broker election, per-neighbor resend windows (``last_keyframe_sent`` /
``last_match_sent``) that guarantee no gossip is lost across connectivity
churn, garbage-collection thresholds, and receiver-side dedup ranges.

One deliberate fix: the reference's ``is_alive`` falls through to ``None``
when monitoring is disabled (``neighbor_monitor.py:53``, a known bug — the
documented intent is "disabled = always neighbors", config README). Here
disabled monitoring reports alive, per the documented intent.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from cslam_tpu_torch.types import Heartbeat, RobotIds, RobotIdsAndOrigin


class NeighborMonitor:
    """Tracks one neighbor's liveness from its heartbeat topic."""

    def __init__(self, ctx, rid: int, is_enabled: bool, init_delay_sec: float,
                 max_delay_sec: float):
        self.ctx = ctx
        self.robot_id = rid
        self.is_enabled = is_enabled
        self.origin_robot_id = rid
        self.init_delay_sec = init_delay_sec
        self.max_delay_sec = max_delay_sec
        self.first_heartbeat_received = False
        self.init_time = ctx.clock.now()
        self.latest_time_stamp = self.init_time
        self.last_keyframe_received = -1
        self.last_keyframe_sent = -1
        self.last_match_sent = -1
        ctx.create_subscription(f"/r{rid}/cslam/heartbeat",
                                self.heartbeat_callback)

    def heartbeat_callback(self, msg: Heartbeat) -> None:
        self.origin_robot_id = msg.origin_robot_id
        self.latest_time_stamp = self.ctx.clock.now()
        if not self.first_heartbeat_received:
            self.first_heartbeat_received = True
            self.init_time = self.ctx.clock.now()

    def is_alive(self) -> bool:
        if not self.is_enabled:
            return True
        now = self.ctx.clock.now()
        return (self.first_heartbeat_received
                and now - self.init_time > self.init_delay_sec
                and now - self.latest_time_stamp < self.max_delay_sec)


class NeighborManager:
    """Tracks which robots are in communication range and what they have
    already received."""

    def __init__(self, ctx, params: dict):
        self.ctx = ctx
        self.params = params
        self.robot_id = params["robot_id"]
        self.max_nb_robots = params["max_nb_robots"]
        self.neighbors_monitors: Dict[int, NeighborMonitor] = {}
        for rid in range(self.max_nb_robots):
            if rid != self.robot_id:
                self.neighbors_monitors[rid] = NeighborMonitor(
                    ctx, rid,
                    params["neighbor_management.enable_neighbor_monitoring"],
                    params["neighbor_management.init_delay_sec"],
                    params["neighbor_management.max_heartbeat_delay_sec"])

        ctx.create_subscription("cslam/get_current_neighbors",
                                self.get_current_neighbors_callback)
        self._neighbors_publisher = ctx.create_publisher(
            "cslam/current_neighbors")

    def check_neighbors_in_range(self) -> Tuple[Dict[int, bool], List[int]]:
        in_range = {}
        in_range_list = []
        for i in range(self.max_nb_robots):
            alive = (i == self.robot_id
                     or self.neighbors_monitors[i].is_alive())
            in_range[i] = alive
            if alive:
                in_range_list.append(i)
        return in_range, in_range_list

    def local_robot_is_broker(self) -> bool:
        """Lowest alive ID is the broker (reference neighbors_manager.py:48-64)."""
        for i, mon in self.neighbors_monitors.items():
            if mon.is_alive() and self.robot_id > i:
                return False
        return True

    # -- gossip resend windows (reference ll.66-106): send from the minimum
    #    last-sent over alive neighbors so nobody misses data --

    def _select_from(self, latest_local: int, attr: str) -> int:
        start = latest_local
        for mon in self.neighbors_monitors.values():
            if mon.is_alive():
                start = min(getattr(mon, attr), start)
        for mon in self.neighbors_monitors.values():
            if mon.is_alive():
                setattr(mon, attr, latest_local)
        return start + 1

    def select_from_which_kf_to_send(self, latest_local_id: int) -> int:
        return self._select_from(latest_local_id, "last_keyframe_sent")

    def select_from_which_match_to_send(self, latest_local_idx: int) -> int:
        return self._select_from(latest_local_idx, "last_match_sent")

    # -- garbage collection thresholds (reference ll.108-136): entries below
    #    min(last_sent) over ALL neighbors (alive or not) stay buffered --

    def useless_descriptors(self, last_kf_id: int) -> int:
        return min([m.last_keyframe_sent
                    for m in self.neighbors_monitors.values()] + [last_kf_id])

    def useless_matches(self, last_match_id: int) -> int:
        return min([m.last_match_sent
                    for m in self.neighbors_monitors.values()]
                   + [last_match_id])

    # -- receiver-side dedup (reference ll.138-169) --

    def update_received_kf_id(self, other_robot_id: int, kf_id: int) -> None:
        self.neighbors_monitors[other_robot_id].last_keyframe_received = kf_id

    def get_unknown_range(self, descriptors) -> List[int]:
        other = descriptors[0].robot_id
        mon = self.neighbors_monitors[other]
        unknown = [i for i, d in enumerate(descriptors)
                   if d.keyframe_id > mon.last_keyframe_received]
        last = max(d.keyframe_id for d in descriptors)
        mon.last_keyframe_received = max(mon.last_keyframe_received, last)
        return unknown

    # -- back-end query service (reference ll.171-185) --

    def get_current_neighbors_callback(self, _msg) -> None:
        _, in_range_list = self.check_neighbors_in_range()
        in_range_list.remove(self.robot_id)
        msg = RobotIdsAndOrigin()
        msg.robots.ids = in_range_list
        msg.origins.ids = [self.neighbors_monitors[i].origin_robot_id
                           for i in in_range_list]
        self._neighbors_publisher.publish(msg)

"""In-process typed message bus with ROS-like namespaced topics.

Transport equivalent of the reference's DDS pub/sub plane (layer L0 in
SURVEY.md): robot-addressed unicast (``/r{i}/cslam/...``), broadcast topics
(``/cslam/...``), and node-relative names (resolved against the owning
robot's namespace, like ROS does). Delivery is queued and drained by the
driver so multi-robot runs are deterministic and replayable; a network
transport can replace this class behind the same interface.

Fault injection: an optional ``link_filter(src_robot, topic, msg) -> bool``
lets tests drop traffic between out-of-range robots, generalizing the
reference's heartbeat-only gating (``SimulatedRendezVous``,
``decentralized_pgo.cpp:685-690``).

QoS: topics are reliable (every message delivered) unless a subscriber
declares a best-effort profile — then the topic's pending messages are
bounded to ``depth`` with drop-oldest, the semantics of the reference's
best-effort sensor intake (``rgbd_handler.cpp:58-61``,
``lidar_handler_node.py:23-27``): under overload the consumer sees the
freshest frames, and backlog never grows without bound.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from cslam_tpu_torch.runtime.clock import Timer


@dataclass(frozen=True)
class QoSProfile:
    """Subset of DDS QoS the reference actually uses: reliable (default)
    vs best-effort with a bounded history depth, plus transient-local
    durability (latched topics — the reference publishes ReferenceFrames
    with it, ``decentralized_pgo.cpp:194-196``, so robots that come into
    range LATE still receive the current reference frame)."""
    best_effort: bool = False
    depth: int = 10
    transient_local: bool = False


class Publisher:
    def __init__(self, bus: "MessageBus", topic: str, src_robot: int,
                 latch: bool = False):
        self.bus = bus
        self.topic = topic
        self.src_robot = src_robot
        self.latch = latch

    def publish(self, msg: Any) -> None:
        self.bus.publish(self.topic, msg, self.src_robot, latch=self.latch)


class _Subscription:
    """One subscriber on one topic. Best-effort subscribers own a bounded
    drop-oldest queue; reliable subscribers share the bus-wide queue —
    per-SUBSCRIPTION reliability, like DDS/ROS, so one best-effort
    consumer never makes a topic lossy for a reliable one."""

    __slots__ = ("callback", "queue")

    def __init__(self, callback: Callable[[Any], None],
                 qos: Optional[QoSProfile]):
        self.callback = callback
        self.queue: Optional[deque] = (
            deque(maxlen=max(int(qos.depth), 1))
            if qos is not None and qos.best_effort else None)


class MessageBus:
    """Topic-based queued pub/sub shared by all in-process robots."""

    def __init__(self):
        self._subs: Dict[str, List[_Subscription]] = {}
        self._queue: deque = deque()
        self._latched: Dict[str, Tuple[Any, int]] = {}
        self._latch_pending: List[Tuple[str, Any, int, _Subscription]] = []
        self.link_filter: Optional[Callable[[int, str, Any], bool]] = None
        self.messages_delivered = 0
        self.messages_dropped = 0

    def subscribe(self, topic: str, callback: Callable[[Any], None],
                  qos: Optional[QoSProfile] = None) -> None:
        sub = _Subscription(callback, qos)
        self._subs.setdefault(topic, []).append(sub)
        if (qos is not None and qos.transient_local
                and topic in self._latched):
            # transient-local durability: a late subscriber receives the
            # latched value at its next deliver() (same callback timing
            # as live traffic), targeted so existing subscribers don't
            # see it twice
            msg, src = self._latched[topic]
            if sub.queue is not None:
                sub.queue.append((msg, src))
            else:
                self._latch_pending.append((topic, msg, src, sub))

    def publish(self, topic: str, msg: Any, src_robot: int = -1,
                latch: bool = False) -> None:
        if latch:
            self._latched[topic] = (msg, src_robot)
        self._enqueue(topic, msg, src_robot)

    def _enqueue(self, topic: str, msg: Any, src_robot: int) -> None:
        subs = self._subs.get(topic, ())
        reliable = not subs or any(s.queue is None for s in subs)
        seen_best_effort = []
        for s in subs:
            if s.queue is not None:
                if len(s.queue) == s.queue.maxlen:
                    self.messages_dropped += 1  # drop-oldest (deque maxlen)
                s.queue.append((msg, src_robot))
                seen_best_effort.append(s)
        if reliable:
            # topics without subscribers keep the original queued behavior;
            # seen_best_effort records which bounded queues already took
            # the message so deliver() can route it to best-effort
            # subscribers added between publish and deliver without
            # double-delivering.
            self._queue.append((topic, msg, src_robot, seen_best_effort))

    def _flush_best_effort(self) -> int:
        flushed = 0
        for topic, subs in self._subs.items():
            for s in subs:
                if s.queue is None:
                    continue
                while s.queue:
                    msg, src = s.queue.popleft()
                    if self.link_filter is not None and not self.link_filter(
                            src, topic, msg):
                        continue
                    s.callback(msg)
                    flushed += 1
        return flushed

    def deliver(self, max_messages: int = 100000) -> int:
        """Drain the queue (including messages published by callbacks)."""
        delivered = 0
        if self._latch_pending:
            pending, self._latch_pending = self._latch_pending, []
            for topic, msg, src, sub in pending:
                if self.link_filter is not None and not self.link_filter(
                        src, topic, msg):
                    continue
                sub.callback(msg)
                delivered += 1
        while delivered < max_messages:
            if not self._queue:
                flushed = self._flush_best_effort()
                delivered += flushed
                if not self._queue and flushed == 0:
                    break
                continue
            topic, msg, src, seen = self._queue.popleft()
            if self.link_filter is not None and not self.link_filter(
                    src, topic, msg):
                continue
            for s in self._subs.get(topic, ()):
                if s.queue is None:  # reliable subscribers
                    s.callback(msg)
                elif s not in seen:
                    # best-effort subscriber added after publish: route
                    # through its bounded queue (flushed this same drain)
                    if len(s.queue) == s.queue.maxlen:
                        self.messages_dropped += 1
                    s.queue.append((msg, src))
            delivered += 1
        self.messages_delivered += delivered
        return delivered


class RobotContext:
    """Node handle for one robot: namespaced topics, timers, clock, params.

    Topic resolution matches ROS semantics used throughout the reference:
    names starting with '/' are absolute; others live under this robot's
    namespace ``/r{id}/``.
    """

    def __init__(self, bus: MessageBus, clock, robot_id: int, params: dict):
        self.bus = bus
        self.clock = clock
        self.robot_id = robot_id
        self.params = params
        self.timers: List[Timer] = []

    def resolve(self, topic: str) -> str:
        return topic if topic.startswith("/") else f"/r{self.robot_id}/{topic}"

    def create_publisher(self, topic: str, latch: bool = False) -> Publisher:
        return Publisher(self.bus, self.resolve(topic), self.robot_id,
                         latch=latch)

    def create_subscription(self, topic: str,
                            callback: Callable[[Any], None],
                            qos: Optional[QoSProfile] = None) -> None:
        self.bus.subscribe(self.resolve(topic), callback, qos=qos)

    def create_timer(self, period_sec: float,
                     callback: Callable[[], None]) -> Timer:
        timer = Timer(self.clock, period_sec, callback)
        self.timers.append(timer)
        return timer

    def poll_timers(self) -> int:
        return sum(t.poll() for t in self.timers)

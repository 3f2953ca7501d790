"""Clocks and timers for the runtime.

A ``VirtualClock`` makes multi-robot runs deterministic and fast (the
simulator advances time explicitly); ``WallClock`` is the real-time
equivalent for deployments. Reference nodes hang everything off ROS wall
timers (e.g. ``loop_closure_detection_node.py:99-101``,
``decentralized_pgo.cpp:76-82``) — ``Timer`` reproduces fixed-period firing
with catch-up semantics.
"""
from __future__ import annotations

import time
from typing import Callable


class VirtualClock:
    """Manually advanced simulation clock (seconds)."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt


class WallClock:
    def now(self) -> float:
        return time.time()


class Timer:
    """Fixed-period timer; ``poll`` fires the callback for every elapsed
    period boundary (at most ``max_catchup`` per poll)."""

    def __init__(self, clock, period_sec: float, callback: Callable[[], None],
                 max_catchup: int = 1):
        assert period_sec > 0
        self.clock = clock
        self.period = period_sec
        self.callback = callback
        self.max_catchup = max_catchup
        self._next = clock.now() + period_sec
        self.cancelled = False

    def poll(self) -> int:
        fired = 0
        while (not self.cancelled and self.clock.now() >= self._next
               and fired < self.max_catchup):
            self._next += self.period
            self.callback()
            fired += 1
        if self.clock.now() >= self._next:  # drop missed periods beyond cap
            k = int((self.clock.now() - self._next) / self.period) + 1
            self._next += k * self.period
        return fired

    def cancel(self) -> None:
        self.cancelled = True

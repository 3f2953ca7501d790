"""Simulated rendezvous schedules (communication fault injection).

Parity with reference ``src/back_end/utils/simulated_rendezvous.cpp``: a CSV
schedule per robot of ``robot_id,start,end[,start,end,...]`` windows
(seconds relative to process start); the robot is "alive" (emits heartbeats)
only inside a window. Used to emulate robots drifting out of range without a
real network.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


class SimulatedRendezVous:
    def __init__(self, clock, windows: Sequence[Tuple[float, float]],
                 start_time: float | None = None):
        self.clock = clock
        self.windows = list(windows)
        self.start_time = clock.now() if start_time is None else start_time

    @classmethod
    def from_schedule_file(cls, clock, path: str, robot_id: int
                           ) -> "SimulatedRendezVous":
        windows: List[Tuple[float, float]] = []
        with open(path) as f:
            for line in f:
                fields = [x.strip() for x in line.strip().split(",") if x.strip()]
                if not fields or int(fields[0]) != robot_id:
                    continue
                times = [float(x) for x in fields[1:]]
                windows = list(zip(times[::2], times[1::2]))
        return cls(clock, windows)

    def is_alive(self) -> bool:
        if not self.windows:
            return True
        t = self.clock.now() - self.start_time
        return any(start <= t <= end for start, end in self.windows)

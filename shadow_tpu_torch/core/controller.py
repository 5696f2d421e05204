"""The simulation time authority: round windows and runahead.

Parity: reference `src/main/core/controller.rs` (window =
`[min_next_event, min_next_event + runahead)` clipped to the end time,
`controller.rs:80-113`) and `src/main/core/runahead.rs` (static runahead =
min possible graph latency; dynamic = min latency actually used so far; both
floored by the config lower bound).
"""

from __future__ import annotations

import threading
from typing import Optional


class Runahead:
    def __init__(
        self,
        is_dynamic: bool,
        min_possible_latency_ns: int,
        min_runahead_config_ns: Optional[int],
    ):
        assert min_possible_latency_ns > 0
        self._is_dynamic = is_dynamic
        self._min_possible = min_possible_latency_ns
        self._min_config = min_runahead_config_ns or 0
        self._min_used: Optional[int] = None
        self._lock = threading.Lock()

    def get(self) -> int:
        used = self._min_used if self._min_used is not None else self._min_possible
        return max(used, self._min_config)

    def update_lowest_used_latency(self, latency_ns: int) -> None:
        assert latency_ns > 0
        if not self._is_dynamic:
            return
        if self._min_used is not None and latency_ns >= self._min_used:
            return
        with self._lock:
            if self._min_used is None or latency_ns < self._min_used:
                self._min_used = latency_ns


class Controller:
    """Owns the simulation end time; computes each next scheduling window."""

    def __init__(self, stop_time_ns: int, runahead: Runahead):
        self.stop_time = stop_time_ns
        self.runahead = runahead

    def first_window(self) -> Optional[tuple[int, int]]:
        return self.next_window(0)

    def next_window(self, min_next_event_time: Optional[int]) -> Optional[tuple[int, int]]:
        """Window starting at the global min next-event time
        (`controller.rs:87-113`); None when the simulation is over."""
        if min_next_event_time is None or min_next_event_time >= self.stop_time:
            return None
        start = min_next_event_time
        end = min(start + self.runahead.get(), self.stop_time)
        return (start, end)

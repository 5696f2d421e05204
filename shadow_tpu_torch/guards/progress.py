"""Virtual-time progress detection: the round-loop livelock guard.

The fault plane's watchdog (faults/watchdog.py) covers WALL-clock
hangs — a wedged native process that stops the round loop dead. This
detector covers the complementary failure: the round loop keeps
SPINNING — virtual time advances round after round — while nothing is
actually simulated. The signature case is a device plane (or any
next-event source) that keeps advertising a pending event which never
materializes into an executed host event or a delivered packet, while
managed processes sit blocked on input that will never arrive: a
zero-progress livelock that would otherwise burn wall time to the stop
time and report silently wrong (empty) results.

A round counts as STALLED when all of:

- virtual time advanced (the window start moved forward);
- zero host events executed (nothing was drained from any queue);
- zero packets moved on either plane (no sends, no deliveries).

`max_rounds` consecutive stalled rounds trip the detector, producing a
`StallDiagnosis` naming who is waiting on what: every host with alive
processes (and what its next queued event is, if any), plus the
device-plane in-flight population. Everything observed is virtual-time
/ counter state — wall clock never enters, so a run that does not trip
the detector is bitwise-unaffected by it (docs/determinism.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .report import GuardViolation


@dataclass
class HostWait:
    """One host's contribution to a stall diagnosis."""

    host: str
    alive_processes: list[str] = field(default_factory=list)
    next_event_ns: Optional[int] = None

    def describe(self) -> str:
        nxt = (f"next event at {self.next_event_ns}"
               if self.next_event_ns is not None else "no queued events")
        procs = ", ".join(self.alive_processes) or "none"
        return f"host {self.host}: blocked processes [{procs}], {nxt}"


@dataclass
class StallDiagnosis:
    """Who is waiting on what after N zero-progress rounds."""

    stalled_rounds: int
    first_stalled_ns: int
    window_start_ns: int
    waiting: list[HostWait] = field(default_factory=list)
    device_in_flight: int = 0

    def describe(self) -> str:
        hosts = "; ".join(w.describe() for w in self.waiting) or \
            "no host holds blocked processes"
        return (
            f"{self.stalled_rounds} consecutive rounds advanced virtual "
            f"time ({self.first_stalled_ns} -> {self.window_start_ns} ns) "
            f"without executing an event or moving a packet; "
            f"device in-flight: {self.device_in_flight}; {hosts}")

    def to_violation(self) -> GuardViolation:
        return GuardViolation(
            cls="progress", check="zero-progress-livelock",
            time_ns=self.window_start_ns,
            host=self.waiting[0].host if self.waiting else None,
            expected="events or packets within "
                     f"{self.stalled_rounds} rounds",
            actual="none", detail=self.describe(),
        )


class ProgressDetector:
    """Feed one `observe()` per round; returns a StallDiagnosis when
    the stall budget is exhausted (then re-arms, so a `warn` policy
    reports each full stall period once instead of every round)."""

    def __init__(self, max_rounds: int):
        if max_rounds <= 0:
            raise ValueError("guards.progress_rounds must be positive")
        self.max_rounds = int(max_rounds)
        self._streak = 0
        self._first_stalled_ns: Optional[int] = None
        self._last_start: Optional[int] = None
        self.trips = 0

    def observe(self, window_start_ns: int, *, events_delta: int,
                packets_delta: int,
                waiting: Optional[list[HostWait]] = None,
                device_in_flight: int = 0) -> Optional[StallDiagnosis]:
        advanced = (self._last_start is not None
                    and window_start_ns > self._last_start)
        self._last_start = window_start_ns
        if not advanced or events_delta > 0 or packets_delta > 0:
            self._streak = 0
            self._first_stalled_ns = None
            return None
        if self._streak == 0:
            self._first_stalled_ns = window_start_ns
        self._streak += 1
        if self._streak < self.max_rounds:
            return None
        diagnosis = StallDiagnosis(
            stalled_rounds=self._streak,
            first_stalled_ns=int(self._first_stalled_ns or 0),
            window_start_ns=int(window_start_ns),
            waiting=list(waiting or []),
            device_in_flight=int(device_in_flight),
        )
        self.trips += 1
        self._streak = 0
        self._first_stalled_ns = None
        return diagnosis

"""Simulated-CPU time accounting.

Parity: reference `src/main/host/cpu.rs:8-95` — native execution time spent
by managed code is charged to a simulated CPU at a configured frequency
ratio; when the accumulated unapplied delay exceeds a threshold, event
execution is pushed into the future, modelling an oversubscribed CPU.
Charged delays are rounded to the configured precision (nearest, up at the
midpoint — `cpu.rs:62-76`); the reported delay is the raw backlog.
"""

from __future__ import annotations

from typing import Optional


class Cpu:
    __slots__ = ("_sim_freq_khz", "_native_freq_khz", "threshold",
                 "_precision", "_now", "_time_cursor")

    def __init__(
        self,
        sim_frequency_khz: int,
        native_frequency_khz: int,
        threshold_ns: Optional[int],
        precision_ns: Optional[int],
    ):
        if precision_ns is not None and precision_ns < 0:
            raise ValueError("cpu_precision must be >= 0 (0 = no rounding)")
        self._sim_freq_khz = sim_frequency_khz
        self._native_freq_khz = native_frequency_khz
        self.threshold = threshold_ns  # None = model disabled (`cpu.rs:83`)
        self._precision = precision_ns
        self._now = 0
        # The simulated-CPU "busy until" cursor; delay = cursor - now.
        self._time_cursor = 0

    def update_time(self, now: int) -> None:
        self._now = now
        if self._time_cursor < now:
            self._time_cursor = now

    def add_delay(self, native_ns: int) -> None:
        """Charge native execution time, scaled by the frequency ratio and
        rounded to the precision (nearest, ties up — `cpu.rs:62-76`)."""
        scaled = native_ns * self._native_freq_khz // max(1, self._sim_freq_khz)
        if self._precision:
            rem = scaled % self._precision
            scaled -= rem
            if rem * 2 >= self._precision:
                scaled += self._precision
        self._time_cursor += scaled

    def delay(self) -> int:
        """Outstanding delay to apply; 0 when disabled or below threshold
        (`cpu.rs:81-95`)."""
        if self.threshold is None:
            return 0
        raw = self._time_cursor - self._now
        if raw <= self.threshold:
            return 0
        return raw

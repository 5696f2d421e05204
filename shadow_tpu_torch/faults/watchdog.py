"""The round watchdog: a hung round becomes a structured error.

A managed native process that wedges (an infinite loop that never traps
a syscall, a binary stuck before the shim handshake) leaves a scheduler
worker blocked in `recv_from_shim` forever — the one liveness hole the
`ChildPidWatcher` (which only detects *death*) cannot cover. The
watchdog closes it:

- the Manager arms the watchdog around every `scheduler.run_round`;
- if the round does not finish within the WALL-clock timeout
  (`faults.watchdog`), the watchdog thread collects per-host blame —
  which hosts were in the round, which managed processes are still
  alive, and which of their pids the pidwatcher is still watching —
  then SIGKILLs the blamed native pids. The kill makes the pidwatcher
  fire, which closes the IPC writers, which wakes the blocked
  `recv_from_shim` calls: the round completes instead of hanging;
- back on the driving thread, the Manager sees the strike and raises
  `WatchdogError` carrying the blame — a structured failure (CLI exit
  code 3, docs/robustness.md) with an emergency checkpoint behind it,
  not a simulator that sits silent forever.

Wall-clock here detects *failure*, never feeds simulation state: a run
that does not trip the watchdog is bitwise-unaffected by it.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("shadow_tpu_torch.faults")


@dataclass
class HostBlame:
    """Why the watchdog blames one host for a hung round."""

    host: str
    processes: list[str] = field(default_factory=list)  # proc names
    native_pids: list[int] = field(default_factory=list)
    watched_pids: list[int] = field(default_factory=list)  # per pidwatcher

    def describe(self) -> str:
        pids = ", ".join(
            f"{p}{'*' if p in self.watched_pids else ''}"
            for p in self.native_pids) or "none"
        return (f"host {self.host}: processes [{', '.join(self.processes)}]"
                f" native pids [{pids}] (* = still watched by the "
                f"pidwatcher, i.e. alive when the watchdog fired)")


class WatchdogError(RuntimeError):
    """A round exceeded the watchdog timeout. `.blame` names the hosts
    and managed processes that were still executing."""

    def __init__(self, round_start_ns: int, timeout_s: float,
                 blame: list[HostBlame], killed: list[int]):
        self.round_start_ns = round_start_ns
        self.timeout_s = timeout_s
        self.blame = blame
        self.killed = killed
        lines = "; ".join(b.describe() for b in blame) or "no live blame"
        super().__init__(
            f"round at simtime {round_start_ns} exceeded the {timeout_s:g}s "
            f"watchdog ({len(killed)} wedged native process(es) killed): "
            f"{lines}")


class RoundWatchdog:
    """One daemon timer armed per round.

    `collect_blame(round_start_ns)` is the Manager's callback: it runs
    ON THE WATCHDOG THREAD while workers are still blocked, so it must
    only read process-table state and send signals — never touch host
    event queues."""

    def __init__(self, timeout_s: float,
                 collect_blame: Callable[[int], list[HostBlame]]):
        if timeout_s <= 0:
            raise ValueError("watchdog timeout must be positive")
        self.timeout_s = float(timeout_s)
        self._collect_blame = collect_blame
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self.strike: Optional[WatchdogError] = None  # set by the timer

    def arm(self, round_start_ns: int) -> None:
        with self._lock:
            self._round_start = round_start_ns
            self._timer = threading.Timer(
                self.timeout_s, self._fire, args=(round_start_ns,))
            self._timer.daemon = True
            self._timer.start()

    def disarm(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def _fire(self, round_start_ns: int) -> None:
        # Timer.cancel() is a no-op once the callback has started, so a
        # round completing right AT the timeout could race the strike:
        # re-check armed state under the lock — if disarm() already ran
        # (the round finished), healthy processes must NOT be killed
        with self._lock:
            if self._timer is None or self._round_start != round_start_ns:
                return
            self._timer = None
        log.error(
            "watchdog: round at simtime %d still running after %gs — "
            "collecting blame and killing wedged managed processes",
            round_start_ns, self.timeout_s)
        try:
            blame = self._collect_blame(round_start_ns)
        except Exception:
            log.error("watchdog: blame collection failed", exc_info=True)
            blame = []
        killed = kill_blamed(blame)
        self.strike = WatchdogError(round_start_ns, self.timeout_s, blame,
                                    killed)

    class _Guard:
        def __init__(self, wd: "RoundWatchdog", round_start_ns: int):
            self._wd = wd
            self._start = round_start_ns

        def __enter__(self):
            self._wd.arm(self._start)
            return self._wd

        def __exit__(self, *exc):
            self._wd.disarm()
            return False

    def guard(self, round_start_ns: int) -> "RoundWatchdog._Guard":
        return RoundWatchdog._Guard(self, round_start_ns)


def kill_blamed(blame: list[HostBlame]) -> list[int]:
    """SIGKILL every blamed native pid. SIGKILL (not TERM): the process
    is wedged — the whole point is that it no longer services anything,
    and only an unmaskable kill guarantees the pidfd fires and the
    blocked IPC reads wake."""
    killed: list[int] = []
    for b in blame:
        for pid in b.native_pids:
            try:
                os.kill(pid, signal.SIGKILL)
                killed.append(pid)
            except (ProcessLookupError, PermissionError):
                continue  # already gone (raced its own exit) or not ours
    if killed:
        log.error("watchdog: SIGKILLed wedged native pids %s", killed)
    return killed

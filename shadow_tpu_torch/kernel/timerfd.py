"""timerfd + the underlying per-host Timer.

Parity: reference `src/main/host/timer.rs` (one-shot/interval timers
scheduling TaskRefs on the host, generation-guarded against stale fires)
and `descriptor/timerfd.rs` (a file whose read returns the expiration
count; READABLE while count > 0).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.event import TaskRef
from . import errors
from .status import FileState, StatefulFile


class Timer:
    """One-shot or periodic emulated-time timer on a host."""

    def __init__(self, host, on_expire: Callable[[], None]):
        self._host = host
        self._on_expire = on_expire
        self._gen = 0
        self.expire_at: Optional[int] = None  # absolute ns
        self.interval: int = 0  # 0 = one-shot

    def arm(self, expire_at_ns: int, interval_ns: int = 0) -> None:
        self._gen += 1
        self.expire_at = expire_at_ns
        self.interval = interval_ns
        self._schedule()

    def disarm(self) -> None:
        self._gen += 1
        self.expire_at = None

    def remaining(self) -> Optional[int]:
        if self.expire_at is None:
            return None
        return max(0, self.expire_at - self._host.now())

    def _schedule(self) -> None:
        gen = self._gen
        delay = max(0, self.expire_at - self._host.now())
        self._host.schedule_task_with_delay(
            TaskRef(lambda h, g=gen: self._fire(g), "timer"), delay
        )

    def _fire(self, gen: int) -> None:
        if gen != self._gen or self.expire_at is None:
            return
        if self.interval > 0:
            self.expire_at = self.expire_at + self.interval
            self._schedule()
        else:
            self.expire_at = None
        self._on_expire()


class TimerFd(StatefulFile):
    def __init__(self, host):
        super().__init__(FileState.ACTIVE)
        self._host = host
        self.expirations = 0
        self.nonblocking = False
        self._timer = Timer(host, self._on_expire)

    def settime(self, initial_ns: int, interval_ns: int = 0,
                absolute: bool = False) -> None:
        """Arm (initial > 0) or disarm (initial == 0)."""
        if initial_ns == 0:
            self._timer.disarm()
            return
        at = initial_ns if absolute else self._host.now() + initial_ns
        self.expirations = 0
        self._refresh()
        self._timer.arm(at, interval_ns)

    def gettime(self) -> tuple[Optional[int], int]:
        return self._timer.remaining(), self._timer.interval

    def read_expirations(self) -> int:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.expirations == 0:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.READABLE)
        n, self.expirations = self.expirations, 0
        self._refresh()
        return n

    def close(self) -> None:
        if self.is_closed():
            return
        self._timer.disarm()
        self.update_state(
            FileState.ACTIVE | FileState.READABLE | FileState.CLOSED, FileState.CLOSED
        )

    def _on_expire(self) -> None:
        if self.is_closed():
            return
        self.expirations += 1
        self._refresh()

    def _refresh(self) -> None:
        if self.is_closed():
            return
        self.update_state(
            FileState.READABLE,
            FileState.READABLE if self.expirations > 0 else FileState.NONE,
        )

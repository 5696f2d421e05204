"""eventfd: a 64-bit kernel counter usable as a wakeup channel.

Parity: reference `src/main/host/descriptor/eventfd.rs` — read returns the
counter (and zeroes it; or decrements by 1 in semaphore mode), write adds;
READABLE when counter > 0, WRITABLE while a write of 1 wouldn't overflow.
"""

from __future__ import annotations

from . import errors
from .status import FileState, StatefulFile

_MAX = (1 << 64) - 2


class EventFd(StatefulFile):
    def __init__(self, initval: int = 0, semaphore: bool = False):
        super().__init__(FileState.ACTIVE | FileState.WRITABLE)
        self.counter = initval
        self.semaphore = semaphore
        self.nonblocking = False
        # Smallest value a blocked writer is waiting to add (0 = none). The
        # poll-visible WRITABLE bit keeps Linux's "a write of 1 won't block"
        # meaning; blocked writers wait on EVENTFD_WRITE_SPACE, which turns
        # on once a read makes room for the smallest waiter. Tracking the
        # min means wakeups can be spurious (a larger waiter retries and
        # re-blocks) but never missed.
        self._pending_write = 0
        self._refresh()

    def read_value(self) -> int:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.counter == 0:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.READABLE)
        if self.semaphore:
            self.counter -= 1
            value = 1
        else:
            value, self.counter = self.counter, 0
        self._refresh()
        return value

    def write_value(self, value: int) -> None:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if value >= (1 << 64) - 1:
            raise errors.SyscallError(errors.EINVAL)
        if self.counter + value > _MAX:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            if self.state & FileState.EVENTFD_WRITE_SPACE:
                # The bit is on yet this write doesn't fit: whatever smaller
                # value it was advertising is stale (a cancelled writer) or
                # already consumed (every armed waiter fired when it turned
                # on). Re-seed from this writer so the bit turns OFF instead
                # of livelocking an immediate-wakeup retry loop.
                self._pending_write = value
            else:
                self._pending_write = (
                    value if self._pending_write == 0
                    else min(self._pending_write, value)
                )
            self._refresh()
            raise errors.Blocked(self, FileState.EVENTFD_WRITE_SPACE)
        self.counter += value
        self._pending_write = 0
        self._refresh()

    def close(self) -> None:
        if self.is_closed():
            return
        self.update_state(
            FileState.ACTIVE | FileState.READABLE | FileState.WRITABLE | FileState.CLOSED,
            FileState.CLOSED,
        )

    def _refresh(self) -> None:
        if self.is_closed():
            return
        values = FileState.NONE
        if self.counter > 0:
            values |= FileState.READABLE
        if self.counter + 1 <= _MAX:
            values |= FileState.WRITABLE
        if self.counter + max(1, self._pending_write) <= _MAX:
            values |= FileState.EVENTFD_WRITE_SPACE
        self.update_state(
            FileState.READABLE | FileState.WRITABLE | FileState.EVENTFD_WRITE_SPACE,
            values,
        )

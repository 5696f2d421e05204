"""epoll: scalable readiness notification over simulated files.

Parity: reference `src/main/host/descriptor/epoll/` — an interest list of
(file, events, data) entries; level-triggered by default with EPOLLET
edge-triggering and EPOLLONESHOT; the epoll instance is itself a
StatefulFile whose READABLE bit reflects a non-empty ready set, so epolls
nest and blocked `epoll_wait`s park on an ordinary condition.
"""

from __future__ import annotations

import enum
from typing import Optional

from . import errors
from .status import CallbackQueue, FileSignal, FileState, ListenerFilter, StatefulFile


class EpollEvents(enum.IntFlag):
    IN = 0x001  # readable
    OUT = 0x004  # writable
    ERR = 0x008
    HUP = 0x010
    ET = 1 << 31  # edge-triggered
    ONESHOT = 1 << 30


def _file_state_to_events(state: FileState) -> EpollEvents:
    ev = EpollEvents(0)
    if state & FileState.READABLE:
        ev |= EpollEvents.IN
    if state & FileState.WRITABLE:
        ev |= EpollEvents.OUT
    if state & FileState.CLOSED:
        ev |= EpollEvents.HUP
    return ev


_MONITOR = FileState.READABLE | FileState.WRITABLE | FileState.CLOSED


class _Entry:
    __slots__ = ("file", "events", "data", "listener", "armed")

    def __init__(self, file, events: EpollEvents, data):
        self.file = file
        self.events = events
        self.data = data
        self.listener: Optional[int] = None
        self.armed = True  # ONESHOT disarms after a report


class Epoll(StatefulFile):
    def __init__(self):
        super().__init__(FileState.ACTIVE)
        self._entries: dict[int, _Entry] = {}  # keyed by id(file)

    # -- interest list (epoll_ctl) --------------------------------------

    def add(self, file, events: EpollEvents, data=None) -> None:
        key = id(file)
        if key in self._entries:
            raise errors.SyscallError(errors.EEXIST)
        entry = _Entry(file, events, data if data is not None else file)
        entry.listener = file.add_listener(
            _MONITOR, ListenerFilter.ALWAYS, self._make_callback(entry),
            signals=FileSignal.READ_BUFFER_GREW,
        )
        self._entries[key] = entry
        self._refresh()

    def modify(self, file, events: EpollEvents, data=None) -> None:
        entry = self._entries.get(id(file))
        if entry is None:
            raise errors.SyscallError(errors.ENOENT)
        entry.events = events
        if data is not None:
            entry.data = data
        entry.armed = True
        self._refresh()

    def remove(self, file) -> None:
        entry = self._entries.pop(id(file), None)
        if entry is None:
            raise errors.SyscallError(errors.ENOENT)
        if entry.listener is not None:
            entry.file.remove_listener(entry.listener)
        self._refresh()

    # -- wait (epoll_wait) ----------------------------------------------

    def ready(self, max_events: int = 64) -> list[tuple]:
        """Collect up to max_events (data, events) pairs; non-blocking.
        Level-triggered entries re-report while the condition holds;
        edge-triggered entries only after a fresh transition (tracked via
        the armed flag)."""
        out = []
        for entry in list(self._entries.values()):
            if len(out) >= max_events:
                break
            if not entry.armed:
                continue
            hits = self._entry_ready(entry)
            if hits:
                out.append((entry.data, hits))
                if entry.events & EpollEvents.ONESHOT:
                    entry.armed = False
                elif entry.events & EpollEvents.ET:
                    entry.armed = False  # re-armed by the next transition
        self._refresh()
        return out

    def wait(self, max_events: int = 64):
        """Generator for the Syscalls facade: blocks until something is
        ready (level-triggered semantics drive the epoll's own READABLE)."""
        while True:
            got = self.ready(max_events)
            if got:
                return got
            yield errors.Blocked(self, FileState.READABLE)

    def close(self) -> None:
        if self.is_closed():
            return
        for entry in self._entries.values():
            if entry.listener is not None:
                entry.file.remove_listener(entry.listener)
        self._entries.clear()
        self.update_state(
            FileState.ACTIVE | FileState.READABLE | FileState.CLOSED, FileState.CLOSED
        )

    # -- internals -------------------------------------------------------

    def _entry_ready(self, entry: _Entry) -> EpollEvents:
        now = _file_state_to_events(entry.file.state)
        interest = entry.events | EpollEvents.ERR | EpollEvents.HUP
        return now & interest

    def _make_callback(self, entry: _Entry):
        def on_change(state: FileState, changed: FileState, cq: CallbackQueue):
            if entry.events & EpollEvents.ET:
                # Linux ET fires again on every new event: a fresh off->on
                # transition OR new activity while the bit stays on (the
                # signal path delivers the latter with changed == NONE,
                # e.g. more bytes arriving on an already-readable pipe)
                if (changed & state & _MONITOR) or changed == FileState.NONE:
                    entry.armed = True
            self._refresh()

        return on_change

    def _refresh(self) -> None:
        if self.is_closed():
            return
        any_ready = any(
            e.armed and self._entry_ready(e) for e in self._entries.values()
        )
        self.update_state(
            FileState.READABLE,
            FileState.READABLE if any_ready else FileState.NONE,
        )

"""File state bits, state-change listeners, and the deferred callback queue.

Parity: reference `FileState` bitflags
(`src/lib/shadow-shim-helper-rs/src/shim_shmem.rs` / `descriptor/mod.rs`),
`StateEventSource`/`StatusListener` (`src/main/host/status_listener.{c,rs}`,
`descriptor/listener.rs`), and `CallbackQueue`
(`src/main/utility/callback_queue.rs`): state transitions never invoke
listeners re-entrantly — notifications are queued and run after the state
change that caused them has fully settled.
"""

from __future__ import annotations

import enum
from collections import deque
from contextlib import contextmanager
from typing import Callable, Iterator, Optional


class FileState(enum.IntFlag):
    """Observable state bits of a file/socket (`descriptor/mod.rs` FileState)."""

    NONE = 0
    ACTIVE = 1 << 0  # file is open / usable
    READABLE = 1 << 1
    WRITABLE = 1 << 2
    CLOSED = 1 << 3
    # TCP-specific: a listener is able to accept (backlog non-empty) or a
    # connecting socket finished the handshake.
    SOCKET_ALLOWING_CONNECT = 1 << 4
    FUTEX_WAKEUP = 1 << 5
    CHILD_EVENTS = 1 << 6
    # eventfd-internal: room for the SMALLEST value a blocked writer is
    # waiting to add (distinct from WRITABLE, which keeps poll's "a write
    # of 1 won't block" meaning). Wakeups may be spurious for larger
    # waiters — they must retry and re-block — but are never missed.
    EVENTFD_WRITE_SPACE = 1 << 7
    # unix-dgram-internal: the RECEIVER's queue has room. A blocked dgram
    # sender parks on the destination socket's bit (its own WRITABLE is
    # static for dgram and would livelock the condition).
    DGRAM_SPACE = 1 << 8



# plain-int twin of FileState.CLOSED for the hottest predicates —
# IntFlag arithmetic re-enters the enum machinery per operation (see
# tcp/connection.py's flag twins); state words flow through
# StatusListener as plain ints and compare equal to FileState members
_CLOSED_I = int(FileState.CLOSED)

class FileSignal(enum.IntFlag):
    """Edge events that are not state-bit transitions (reference
    `FileSignals`): e.g. more bytes arriving while a file is already
    READABLE — invisible to state-change listeners, but exactly what
    edge-triggered epoll must see (`epoll(7)`)."""

    NONE = 0
    READ_BUFFER_GREW = 1 << 0


class ListenerFilter(enum.Enum):
    """When a listener fires, relative to the monitored bits' transition
    (`descriptor/listener.rs` StateListenerFilter)."""

    NEVER = 0
    OFF_TO_ON = 1
    ON_TO_OFF = 2
    ALWAYS = 3


class CallbackQueue:
    """FIFO of deferred callbacks (`utility/callback_queue.rs`).

    State-change handlers are pushed here and run once the mutation that
    triggered them has unwound, so a listener observing a state change can
    itself mutate files without re-entering their notification paths.
    """

    __slots__ = ("_queue",)

    def __init__(self):
        self._queue: deque[Callable[["CallbackQueue"], None]] = deque()

    def add(self, callback: Callable[["CallbackQueue"], None]) -> None:
        self._queue.append(callback)

    def run(self) -> None:
        while self._queue:
            self._queue.popleft()(self)

    def __len__(self) -> int:
        return len(self._queue)


@contextmanager
def queue_and_run() -> Iterator[CallbackQueue]:
    """Run a mutation with a fresh callback queue, flushing it afterwards —
    the standard entry point for any externally-triggered state change
    (`callback_queue.rs` queue_and_run)."""
    cq = CallbackQueue()
    try:
        yield cq
    finally:
        cq.run()


class StateEventSource:
    """A file's listener registry.

    Listeners are keyed by insertion-ordered integer handles so notification
    order is deterministic and independent of object identity.
    """

    __slots__ = ("_listeners", "_next_handle")

    def __init__(self):
        # handle -> (state mask, signal mask, filter, cb(state, changed, cq))
        self._listeners: dict[
            int,
            tuple[
                FileState,
                FileSignal,
                ListenerFilter,
                Callable[[FileState, FileState, CallbackQueue], None],
            ],
        ] = {}
        self._next_handle = 0

    def add_listener(
        self,
        monitoring: FileState,
        filter: ListenerFilter,
        callback: Callable[[FileState, FileState, CallbackQueue], None],
        signals: FileSignal = FileSignal.NONE,
    ) -> int:
        handle = self._next_handle
        self._next_handle += 1
        self._listeners[handle] = (monitoring, signals, filter, callback)
        return handle

    def remove_listener(self, handle: int) -> None:
        self._listeners.pop(handle, None)

    def has_listeners(self) -> bool:
        return bool(self._listeners)

    def notify(
        self,
        state: FileState,
        changed: FileState,
        cb_queue: CallbackQueue,
        signals: FileSignal = FileSignal.NONE,
    ) -> None:
        """Queue notifications for every listener whose monitored bits
        intersect `changed` in the direction its filter requires, or whose
        monitored signals intersect `signals`."""
        for monitoring, want_sig, filt, callback in list(self._listeners.values()):
            if signals & want_sig:
                cb_queue.add(
                    lambda cq, cb=callback, s=state, c=changed: cb(s, c, cq)
                )
                continue
            hit = monitoring & changed
            if not hit:
                continue
            if filt == ListenerFilter.NEVER:
                continue
            if filt == ListenerFilter.OFF_TO_ON and not (state & hit):
                continue
            if filt == ListenerFilter.ON_TO_OFF and (state & hit):
                continue
            cb_queue.add(lambda cq, cb=callback, s=state, c=changed: cb(s, c, cq))


class StatefulFile:
    """Base for anything with observable `FileState` — sockets, pipes,
    eventfds, timerfds, epoll instances.

    Subclasses mutate state exclusively through `update_state`, which
    computes the changed bits and queues listener notifications.
    """

    def __init__(self, initial: FileState = FileState.ACTIVE):
        self._state = initial
        self._event_source = StateEventSource()

    @property
    def state(self) -> FileState:
        return self._state

    def add_listener(
        self,
        monitoring: FileState,
        filter: ListenerFilter,
        callback: Callable[[FileState, FileState, CallbackQueue], None],
        signals: FileSignal = FileSignal.NONE,
    ) -> int:
        return self._event_source.add_listener(monitoring, filter, callback, signals)

    def remove_listener(self, handle: int) -> None:
        self._event_source.remove_listener(handle)

    def emit_signal(
        self, signals: FileSignal, cb_queue: Optional[CallbackQueue] = None
    ) -> None:
        """Fire signal-only listeners (no state bits changed) — e.g. the
        read buffer grew while already READABLE."""
        if not signals:
            return
        if cb_queue is None:
            with queue_and_run() as cq:
                self._event_source.notify(self._state, FileState.NONE, cq, signals)
        else:
            self._event_source.notify(self._state, FileState.NONE, cb_queue, signals)

    def update_state(
        self,
        mask: FileState,
        values: FileState,
        cb_queue: Optional[CallbackQueue] = None,
    ) -> None:
        """Set the bits selected by `mask` to `values`; notify listeners of
        any bits that actually changed. With no queue supplied, notifications
        run before this returns (a fresh queue is flushed)."""
        mask = int(mask)
        values = int(values)
        assert values & ~mask == 0, "values outside mask"
        state = int(self._state)
        new_state = (state & ~mask) | values
        changed = state ^ new_state
        if not changed:
            return
        self._state = new_state
        if cb_queue is None:
            with queue_and_run() as cq:
                self._event_source.notify(new_state, changed, cq)
        else:
            self._event_source.notify(new_state, changed, cb_queue)

    def is_closed(self) -> bool:
        return bool(int(self._state) & _CLOSED_I)

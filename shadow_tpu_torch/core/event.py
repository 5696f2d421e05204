"""Events, their deterministic total order, and the per-host event queue.

The ordering rules here are the heart of the determinism contract; they are
kept identical in spirit to the reference:

- Events sort by time first (`src/main/core/work/event.rs:102-110`).
- At equal times, ALL packet events sort before ALL local events — a packet
  arriving at time T must beat a timer that fires at T, regardless of which
  was enqueued first.
- Packet events tie-break by (src_host_id, src_host_event_id)
  (`event.rs:131-155`): the sending host's identity and its per-host
  monotone counter, both scheduling-independent.
- Local events tie-break by the receiving host's per-host event_id counter
  (`event.rs:163-184`).

The queue asserts monotonic pops (`event_queue.rs:36-39`): popping an event
earlier than one already popped is a simulation bug, never silently allowed.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, Optional

# EventData discriminants; packet < local so packets win time ties.
_KIND_PACKET = 0
_KIND_LOCAL = 1


@dataclass(frozen=True)
class PacketEventKey:
    src_host_id: int
    src_event_id: int


class TaskRef:
    """A closure executed on a host at a scheduled time.

    Parity: reference `src/main/core/work/task.rs`; `name` shows up in traces.
    """

    __slots__ = ("fn", "name")

    def __init__(self, fn: Callable[..., None], name: str = "task"):
        self.fn = fn
        self.name = name

    def execute(self, host) -> None:
        self.fn(host)

    def __repr__(self) -> str:
        return f"TaskRef({self.name})"


@dataclass(eq=False)
class Event:
    """A scheduled occurrence on one host.

    `key` is the scheduling-independent total-order tie-break:
      packet: (0, src_host_id, src_event_id)
      local:  (1, dst_event_id, 0)
    """

    time: int
    kind: int
    key: tuple[int, int]
    payload: Any  # Packet for kind=PACKET, TaskRef for kind=LOCAL

    def sort_key(self) -> tuple[int, int, int, int]:
        return (self.time, self.kind, self.key[0], self.key[1])

    def __lt__(self, other: "Event"):
        # Reached only when two events share an identical sort key inside the
        # heap — a violated uniqueness invariant (duplicate (src_host,
        # event_id) or event-id counter bug), never a legal state.
        raise AssertionError(
            f"duplicate event sort key {self.sort_key()}: {self!r} vs {other!r}"
        )

    @staticmethod
    def new_packet(time: int, packet, src_host_id: int, src_event_id: int) -> "Event":
        return Event(time, _KIND_PACKET, (src_host_id, src_event_id), packet)

    @staticmethod
    def new_local(time: int, task: TaskRef, event_id: int) -> "Event":
        return Event(time, _KIND_LOCAL, (event_id, 0), task)

    @property
    def is_packet(self) -> bool:
        return self.kind == _KIND_PACKET


class EventQueue:
    """Per-host min-heap of events with a monotonic-pop assertion.

    Parity: reference `src/main/core/work/event_queue.rs:10-48`
    (BinaryHeap<Reverse<PanickingOrd<Event>>> + assert on pop order).
    """

    __slots__ = ("_heap", "_last_popped")

    def __init__(self):
        self._heap: list[tuple[tuple[int, int, int, int], Event]] = []
        self._last_popped: Optional[tuple[int, int, int, int]] = None

    def push(self, event: Event) -> None:
        heapq.heappush(self._heap, (event.sort_key(), event))

    def next_time(self) -> Optional[int]:
        return self._heap[0][1].time if self._heap else None

    def peek_key(self) -> Optional[tuple[int, int, int, int]]:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[Event]:
        if not self._heap:
            return None
        key, event = heapq.heappop(self._heap)
        # Keys are unique by contract, so equality is as much a bug as going
        # backwards (it means a duplicate (src_host, event_id) slipped past the
        # push-time guard, e.g. the same Event object pushed twice).
        if self._last_popped is not None and key <= self._last_popped:
            raise AssertionError(
                f"non-monotonic or duplicate event pop: {key} after {self._last_popped}"
            )
        self._last_popped = key
        return event

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def purge(self) -> list["Event"]:
        """Drop every pending event (the fault plane's host-crash
        semantics: a crash loses the queue). The monotonic-pop floor is
        KEPT — post-reboot events must still sort after everything the
        host already executed."""
        out = [event for _key, event in self._heap]
        self._heap.clear()
        return out

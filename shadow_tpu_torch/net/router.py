"""Per-host inbound router with CoDel active queue management.

Parity: reference `src/main/network/router/` — CoDel per RFC 8289 with
Shadow's parameters: TARGET = 10ms (vs the RFC's 5ms), INTERVAL = 100ms,
unbounded limit (`codel_queue.rs:23-33`). The router holds packets inbound
from the simulated internet until the host pops them.

TPU note: the CoDel decision (standing delay vs TARGET, control-law drop
times) is pure arithmetic on enqueue timestamps, which makes it a natural
fit for ring-buffer timestamp arrays on device (`shadow_tpu/tpu/plane.py`).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

from ..core import simtime
from .packet import Packet, PacketDevice, PacketStatus, CONFIG_MTU

TARGET = 10 * simtime.MILLISECOND
INTERVAL = 100 * simtime.MILLISECOND

_STORE = 0
_DROP = 1


class CoDelQueue:
    """RFC 8289 CoDel ("controlled delay") AQM queue."""

    __slots__ = (
        "_elements",
        "_total_bytes",
        "_mode",
        "_interval_end",
        "_drop_next",
        "_current_drop_count",
        "_previous_drop_count",
        "dropped_count",
    )

    def __init__(self):
        self._elements: deque[tuple[Packet, int]] = deque()
        self._total_bytes = 0
        self._mode = _STORE
        self._interval_end: Optional[int] = None
        self._drop_next: Optional[int] = None
        self._current_drop_count = 0
        self._previous_drop_count = 0
        self.dropped_count = 0

    def __len__(self) -> int:
        return len(self._elements)

    def push(self, packet: Packet, now: int) -> None:
        packet.add_status(PacketStatus.ROUTER_ENQUEUED)
        self._total_bytes += packet.total_size()
        self._elements.append((packet, now))

    def pop(self, now: int) -> Optional[Packet]:
        """Next packet conforming to the standing-delay requirement; CoDel may
        drop packets during this operation."""
        item = self._codel_pop(now)
        if item is None:
            self._mode = _STORE  # empty queue is always a good state
            return None
        packet, ok_to_drop = item
        if not ok_to_drop:
            self._mode = _STORE
            packet.add_status(PacketStatus.ROUTER_DEQUEUED)
            return packet
        if self._mode == _STORE:
            out = self._drop_from_store_mode(now, packet)
        else:
            out = self._drop_from_drop_mode(now, packet)
        if out is not None:
            out.add_status(PacketStatus.ROUTER_DEQUEUED)
        return out

    # -- internals (names follow the RFC's dodequeue/control-law structure) --

    def _drop_from_store_mode(self, now: int, packet: Packet) -> Optional[Packet]:
        self._drop_packet(packet)
        nxt = self._codel_pop(now)
        self._mode = _DROP
        # Restart from the drop rate that last controlled the queue.
        delta = self._current_drop_count - self._previous_drop_count
        if self._was_dropping_recently(now) and delta > 1:
            self._current_drop_count = delta
        else:
            self._current_drop_count = 1
        self._drop_next = self._control_law(now, self._current_drop_count)
        self._previous_drop_count = self._current_drop_count
        return nxt[0] if nxt else None

    def _drop_from_drop_mode(self, now: int, packet: Packet) -> Optional[Packet]:
        item: Optional[tuple[Packet, bool]] = (packet, True)
        while item is not None and self._mode == _DROP and self._should_drop(now):
            self._drop_packet(item[0])
            self._current_drop_count += 1
            item = self._codel_pop(now)
            if item is not None and item[1]:
                self._drop_next = self._control_law(
                    self._drop_next, self._current_drop_count
                )
            else:
                self._mode = _STORE
        return item[0] if item else None

    def _codel_pop(self, now: int) -> Optional[tuple[Packet, bool]]:
        if not self._elements:
            self._interval_end = None
            return None
        packet, enqueue_ts = self._elements.popleft()
        self._total_bytes -= packet.total_size()
        standing_delay = now - enqueue_ts
        return packet, self._process_standing_delay(now, standing_delay)

    def _process_standing_delay(self, now: int, standing_delay: int) -> bool:
        if standing_delay < TARGET or self._total_bytes <= CONFIG_MTU:
            self._interval_end = None
            return False
        if self._interval_end is None:
            # just entered the bad state: wait one full interval before dropping
            self._interval_end = now + INTERVAL
            return False
        return now >= self._interval_end

    def _should_drop(self, now: int) -> bool:
        return self._drop_next is not None and now >= self._drop_next

    def _was_dropping_recently(self, now: int) -> bool:
        if self._drop_next is None:
            return False
        return max(0, now - self._drop_next) < INTERVAL * 16

    @staticmethod
    def _control_law(time: int, count: int) -> int:
        """`time + INTERVAL / sqrt(count)` — drop faster while above target."""
        return time + round(INTERVAL / math.sqrt(count) if count else INTERVAL)

    def _drop_packet(self, packet: Packet) -> None:
        self.dropped_count += 1
        packet.add_status(PacketStatus.ROUTER_DROPPED)

    def drain(self) -> list[Packet]:
        """Empty the queue without CoDel accounting (fault purge): the
        queue state machine resets to STORE as if freshly built."""
        out = [p for p, _ts in self._elements]
        self._elements.clear()
        self._total_bytes = 0
        self._mode = _STORE
        self._interval_end = None
        self._drop_next = None
        self._current_drop_count = 0
        self._previous_drop_count = 0
        return out


class Router(PacketDevice):
    """Per-host entry point for packets arriving from the simulated internet
    (`router/mod.rs:16-78`). Pushing routes outward via the host's
    send-packet hook; popping drains the inbound CoDel queue."""

    def __init__(self, address: str, send_packet_hook, clock):
        """`send_packet_hook(packet)` forwards to the simulated internet
        (Worker.send_packet); `clock()` returns current emulated time ns."""
        self._address = address
        self._send = send_packet_hook
        self._clock = clock
        self._inbound = CoDelQueue()

    def get_address(self) -> str:
        return self._address

    def route_incoming_packet(self, packet: Packet) -> None:
        self._inbound.push(packet, self._clock())

    def pop(self) -> Optional[Packet]:
        return self._inbound.pop(self._clock())

    def push(self, packet: Packet) -> None:
        self._send(packet)

    def inbound_len(self) -> int:
        return len(self._inbound)

    def purge_for_fault(self) -> int:
        """A host crash loses everything queued at its inbound router
        (faults/schedule.py host_crash). Returns the drop count; each
        purged packet gets FAULT_DROPPED so trackers bucket it apart
        from CoDel/wire drops."""
        n = 0
        for packet in self._inbound.drain():
            packet.add_status(PacketStatus.FAULT_DROPPED)
            n += 1
        return n

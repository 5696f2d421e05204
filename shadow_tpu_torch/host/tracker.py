"""Per-host traffic/heartbeat tracking.

Parity: reference `src/main/host/tracker.c` — per-host counters (packets
and bytes, in/out, by protocol) logged as heartbeat lines at
`host_heartbeat_interval`, feeding log-parsing tools. Counters hook the
packet status-trace stream, the same instrumentation point the reference's
`PacketCounter`/`ByteCounter` use.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field

from ..core.event import TaskRef
from ..net.packet import Packet, PacketStatus, Protocol

log = logging.getLogger("shadow_tpu_torch.tracker")


@dataclass
class Counters:
    packets_in: int = 0
    packets_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    packets_dropped: int = 0
    # injected fault-plane drops (FAULT_DROPPED), kept APART from
    # packets_dropped so an injected outage is never misread as wire
    # loss (docs/robustness.md drop taxonomy)
    packets_dropped_fault: int = 0
    retransmitted: int = 0
    by_protocol: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        # by_protocol sorted by key: its insertion order is first-packet
        # order, which varies across seeds — sorted serialization keeps
        # heartbeat log diffs between seeds stable
        return {
            "packets_in": self.packets_in,
            "packets_out": self.packets_out,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "packets_dropped": self.packets_dropped,
            "packets_dropped_fault": self.packets_dropped_fault,
            "retransmitted": self.retransmitted,
            "by_protocol": dict(sorted(self.by_protocol.items())),
        }


class Tracker:
    """Attach to a host; records its interface traffic and logs heartbeats."""

    def __init__(self, host, heartbeat_interval_ns: int | None):
        self.host = host
        self.counters = Counters()
        self._interval = heartbeat_interval_ns
        host.trackers = getattr(host, "trackers", [])
        host.trackers.append(self)

    def start(self) -> None:
        if self._interval:
            self.host.schedule_task_with_delay(
                TaskRef(self._heartbeat, "tracker-heartbeat"), self._interval
            )

    # statuses this tracker reacts to, as plain ints — everything else
    # early-outs before touching the packet (this handler runs per
    # status transition on the hottest path in the simulator; it was
    # computing total_size() and a Protocol(...).name round-trip on all
    # ~10 transitions of every packet before looking at the status)
    _SENT = int(PacketStatus.SND_INTERFACE_SENT)
    _RCVD = int(PacketStatus.RCV_INTERFACE_RECEIVED)
    _RETX = int(PacketStatus.SND_TCP_RETRANSMITTED)
    _FAULT = int(PacketStatus.FAULT_DROPPED)
    _DROPS = frozenset((
        int(PacketStatus.INET_DROPPED), int(PacketStatus.ROUTER_DROPPED),
        int(PacketStatus.RCV_SOCKET_DROPPED),
        int(PacketStatus.RCV_INTERFACE_DROPPED),
    ))
    WANTED = frozenset({_SENT, _RCVD, _RETX, _FAULT} | _DROPS)

    def on_packet_status(self, packet: Packet, status: PacketStatus) -> None:
        s = int(status)
        c = self.counters
        if s == self._SENT:
            c.packets_out += 1
            c.bytes_out += packet.total_size()
            proto = Protocol(packet.protocol).name
            c.by_protocol[proto] = c.by_protocol.get(proto, 0) + 1
        elif s == self._RCVD:
            c.packets_in += 1
            c.bytes_in += packet.total_size()
        elif s in self._DROPS:
            c.packets_dropped += 1
        elif s == self._FAULT:
            c.packets_dropped_fault += 1
        elif s == self._RETX:
            c.retransmitted += 1

    def _heartbeat(self, host) -> None:
        # JSON payload so parse_shadow.py can consume the line directly.
        # sort_keys + the sorted by_protocol above make the line a pure
        # function of the counter VALUES; the self-rescheduling task
        # fires for idle hosts too (zero-counter lines on a fixed
        # cadence), so heartbeat streams from different seeds diff
        # line-for-line
        log.info(
            "heartbeat host=%s time_ns=%d %s",
            self.host.name, self.host.now(),
            json.dumps(self.counters.as_dict(), sort_keys=True),
        )
        if self._interval:
            self.host.schedule_task_with_delay(
                TaskRef(self._heartbeat, "tracker-heartbeat"), self._interval
            )

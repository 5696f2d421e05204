"""Simulated packets.

Parity: reference `src/main/network/packet.rs` (PacketRc wrapper) +
`src/main/routing/packet.c` (payload, TCP/UDP headers, priority, and the
22-state delivery-status lifecycle used for tracing).

TPU note: this object form feeds the CPU syscall plane; the TPU network plane
carries the same information as SoA arrays (see `shadow_tpu/tpu/`), with
`Packet.as_record()` defining the array schema.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

CONFIG_MTU = 1500  # bytes (`src/main/core/definitions.h:124-129`)
CONFIG_HEADER_SIZE_TCPIPETH = 54  # eth(14) + ip(20) + tcp(20)
CONFIG_HEADER_SIZE_UDPIPETH = 42  # eth(14) + ip(20) + udp(8)


class Protocol(enum.IntEnum):
    LOCAL = 0
    TCP = 1
    UDP = 2


class PacketStatus(enum.IntEnum):
    """Delivery-status lifecycle flags (`network/packet.rs:16-39`)."""

    SND_CREATED = 0
    SND_TCP_ENQUEUE_THROTTLED = 1
    SND_TCP_ENQUEUE_RETRANSMIT = 2
    SND_TCP_DEQUEUE_RETRANSMIT = 3
    SND_TCP_RETRANSMITTED = 4
    SND_SOCKET_BUFFERED = 5
    SND_INTERFACE_SENT = 6
    INET_SENT = 7
    INET_DROPPED = 8
    ROUTER_ENQUEUED = 9
    ROUTER_DEQUEUED = 10
    ROUTER_DROPPED = 11
    RCV_INTERFACE_RECEIVED = 12
    RCV_INTERFACE_DROPPED = 13
    RCV_SOCKET_PROCESSED = 14
    RCV_SOCKET_DROPPED = 15
    RCV_TCP_ENQUEUE_UNORDERED = 16
    RCV_SOCKET_BUFFERED = 17
    RCV_SOCKET_DELIVERED = 18
    DESTROYED = 19
    RELAY_CACHED = 20
    RELAY_FORWARDED = 21
    # injected fault-plane drop (crashed host, downed interface, burst
    # corruption — faults/schedule.py): its own status so trackers can
    # keep the `fault` drop bucket apart from wire loss
    FAULT_DROPPED = 22


# Optional global hook for packet tracing (the tracker/pcap layers register
# here; kept module-level so Packet stays lean). A hook that only reacts
# to a few statuses should early-out itself (the Manager's tracker hook
# does) — the module filters nothing, so a replacement full-stream
# tracer sees every transition.
status_trace_hook: Optional[Callable[["Packet", PacketStatus], None]] = None


@dataclass
class TcpHeader:
    """TCP header fields carried by simulated packets (`routing/packet.c`)."""

    seq: int = 0
    ack: int = 0
    window: int = 0
    flags: int = 0  # TcpFlags bitfield (see shadow_tpu.tcp)
    window_scale: Optional[int] = None
    timestamp: int = 0
    timestamp_echo: int = 0
    sel_acks: tuple = ()  # selective-ack ranges ((start, end), ...)
    sack_permitted: bool = False  # RFC 2018 option on SYN


class Packet:
    """One simulated packet.

    Addresses are (ipv4_string, port) tuples. `priority` is the host-assigned
    monotone FIFO priority (`host.rs:679-720`); lower forwards first.
    """

    __slots__ = (
        "protocol",
        "src",
        "dst",
        "payload",
        "header",
        "priority",
        "statuses",
        "_total_size",
    )

    def __init__(
        self,
        protocol: Protocol,
        src: tuple[str, int],
        dst: tuple[str, int],
        payload: bytes = b"",
        header: Optional[TcpHeader] = None,
        priority: int = 0,
    ):
        self.protocol = protocol
        self.src = src
        self.dst = dst
        self.payload = payload
        self.header = header
        self.priority = priority
        self._total_size = len(payload) + self.header_size()
        self.statuses: list[PacketStatus] = []
        self.add_status(PacketStatus.SND_CREATED)

    # -- sizes --------------------------------------------------------------

    def payload_size(self) -> int:
        return len(self.payload)

    def header_size(self) -> int:
        if self.protocol == Protocol.TCP:
            return CONFIG_HEADER_SIZE_TCPIPETH
        if self.protocol == Protocol.UDP:
            return CONFIG_HEADER_SIZE_UDPIPETH
        return 0

    def total_size(self) -> int:
        """Header + payload bytes, the unit of rate limiting (payload is
        immutable after construction, so this is precomputed)."""
        return self._total_size

    def is_control(self) -> bool:
        """Zero-payload control packets are never dropped by path loss
        (`worker.rs:364-367`)."""
        return self.payload_size() == 0

    # -- tracing ------------------------------------------------------------

    def add_status(self, status: PacketStatus) -> None:
        self.statuses.append(status)
        if status_trace_hook is not None:
            status_trace_hook(self, status)

    def __repr__(self) -> str:
        return (
            f"Packet({self.protocol.name} {self.src[0]}:{self.src[1]}->"
            f"{self.dst[0]}:{self.dst[1]} len={self.payload_size()} prio={self.priority})"
        )

    def as_record(self) -> dict:
        """Flat record form — the schema mirrored by the TPU SoA arrays."""
        h = self.header or TcpHeader()
        return {
            "protocol": int(self.protocol),
            "src_ip": self.src[0],
            "src_port": self.src[1],
            "dst_ip": self.dst[0],
            "dst_port": self.dst[1],
            "payload_len": self.payload_size(),
            "priority": self.priority,
            "seq": h.seq,
            "ack": h.ack,
            "window": h.window,
            "flags": h.flags,
        }


class PacketDevice:
    """Anything that produces/consumes packets at an address
    (`src/main/network/mod.rs:15-19`): NICs, routers."""

    def get_address(self) -> str:
        raise NotImplementedError

    def pop(self) -> Optional[Packet]:
        raise NotImplementedError

    def push(self, packet: Packet) -> None:
        raise NotImplementedError

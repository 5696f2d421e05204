"""The simulated NIC: socket association, send-side queuing disciplines,
receive-side delivery.

Parity: reference `src/main/host/network/network_interface.c` (+ Rust wrapper
`interface.rs`, qdiscs in `network_queuing_disciplines.c`):
- sockets associate with the interface under a (protocol, local port, peer)
  key; receive-side delivery prefers an exact 4-tuple match and falls back to
  the wildcard-peer (listening) association;
- the send side multiplexes ready sockets through a queuing discipline:
  FIFO by per-packet host-assigned priority, or round-robin across sockets
  (`network_interface.c:205-303`, `QDiscMode` `configuration.rs:961`);
- a pcap hook observes both directions.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Callable, Optional, Protocol as TypingProtocol

from ..core.config import QDiscMode
from .packet import Packet, PacketDevice, PacketStatus, Protocol


class InterfaceSocket(TypingProtocol):
    """What the NIC needs from a socket."""

    def pull_out_packet(self) -> Optional[Packet]:
        """Pop this socket's next outgoing packet (None if none)."""

    def peek_next_priority(self) -> Optional[int]:
        """Priority of the next outgoing packet (None if none)."""

    def push_in_packet(self, packet: Packet) -> None:
        """Deliver an inbound packet to this socket."""


class AssociationKey:
    __slots__ = ("protocol", "local_port", "peer")

    def __init__(self, protocol: Protocol, local_port: int, peer: tuple[str, int]):
        self.protocol = protocol
        self.local_port = local_port
        self.peer = peer  # ("0.0.0.0", 0) = wildcard (listening)

    def _key(self):
        return (self.protocol, self.local_port, self.peer)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, AssociationKey) and self._key() == other._key()


WILDCARD_PEER = ("0.0.0.0", 0)


class NetworkInterface(PacketDevice):
    def __init__(
        self,
        address: str,
        qdisc: QDiscMode = QDiscMode.FIFO,
        pcap_hook: Optional[Callable[[Packet, bool], None]] = None,
    ):
        self._address = address
        self._qdisc = qdisc
        self._pcap_hook = pcap_hook  # (packet, inbound) -> None
        # administrative link state (the fault plane's iface_down/up
        # events, faults/schedule.py): down = outbound pop() yields
        # nothing, inbound push() drops with FAULT_DROPPED
        self.link_up = True
        self.fault_dropped = 0
        self._associations: dict[AssociationKey, InterfaceSocket] = {}
        # send-side: sockets with data, managed per qdisc
        self._ready_fifo: list[tuple[int, int, InterfaceSocket]] = []  # heap by priority
        self._ready_rr: deque[InterfaceSocket] = deque()
        self._ready_set: set[int] = set()  # id(socket) guards double-queueing
        self._fifo_counter = 0
        self.recv_bytes = 0
        self.send_bytes = 0

    # -- association (protocol, port, peer) ---------------------------------

    def associate(
        self,
        socket: InterfaceSocket,
        protocol: Protocol,
        local_port: int,
        peer: tuple[str, int] = WILDCARD_PEER,
    ) -> None:
        key = AssociationKey(protocol, local_port, peer)
        if key in self._associations:
            raise ValueError(
                f"association exists for {protocol.name} port {local_port} peer {peer}"
            )
        self._associations[key] = socket

    def disassociate(
        self,
        protocol: Protocol,
        local_port: int,
        peer: tuple[str, int] = WILDCARD_PEER,
    ) -> None:
        self._associations.pop(AssociationKey(protocol, local_port, peer), None)

    def is_associated(
        self, protocol: Protocol, local_port: int, peer: tuple[str, int] = WILDCARD_PEER
    ) -> bool:
        return AssociationKey(protocol, local_port, peer) in self._associations

    def socket_for(
        self, protocol: Protocol, local_port: int, peer: tuple[str, int]
    ) -> Optional[InterfaceSocket]:
        """Exact 4-tuple match first, then wildcard-peer (listening) match."""
        sock = self._associations.get(AssociationKey(protocol, local_port, peer))
        if sock is None:
            sock = self._associations.get(
                AssociationKey(protocol, local_port, WILDCARD_PEER)
            )
        return sock

    # -- send side ----------------------------------------------------------

    def add_data_source(self, socket: InterfaceSocket) -> None:
        """Socket announces it has packets to send; NIC queues it per qdisc."""
        if id(socket) in self._ready_set:
            return
        self._ready_set.add(id(socket))
        if self._qdisc == QDiscMode.FIFO:
            prio = socket.peek_next_priority()
            self._fifo_counter += 1
            heapq.heappush(
                self._ready_fifo,
                (prio if prio is not None else 0, self._fifo_counter, socket),
            )
        else:
            self._ready_rr.append(socket)

    def set_link_up(self, up: bool) -> None:
        """Administrative link flap (fault plane). Sockets keep queueing
        while the link is down; on restore the caller kicks the relays
        so the backlog forwards again."""
        self.link_up = bool(up)

    def has_data_to_send(self) -> bool:
        return self.link_up and bool(self._ready_fifo or self._ready_rr)

    def pop(self) -> Optional[Packet]:
        """Dequeue the next outgoing packet per the queuing discipline."""
        if not self.link_up:
            return None  # administratively down: nothing leaves
        while self._ready_fifo or self._ready_rr:
            if self._qdisc == QDiscMode.FIFO:
                _, _, socket = heapq.heappop(self._ready_fifo)
            else:
                socket = self._ready_rr.popleft()
            self._ready_set.discard(id(socket))
            packet = socket.pull_out_packet()
            if packet is None:
                continue  # socket had nothing after all; try next
            # requeue if the socket still has data (RR moves to tail; FIFO
            # reinserts keyed by its next packet's priority)
            if socket.peek_next_priority() is not None:
                self.add_data_source(socket)
            packet.add_status(PacketStatus.SND_INTERFACE_SENT)
            self.send_bytes += packet.total_size()
            if self._pcap_hook is not None:
                self._pcap_hook(packet, False)
            return packet
        return None

    # -- receive side -------------------------------------------------------

    def push(self, packet: Packet) -> None:
        if not self.link_up:
            # inbound during a link-down window: the NIC never sees it
            packet.add_status(PacketStatus.FAULT_DROPPED)
            self.fault_dropped += 1
            return
        self.recv_bytes += packet.total_size()
        packet.add_status(PacketStatus.RCV_INTERFACE_RECEIVED)
        if self._pcap_hook is not None:
            self._pcap_hook(packet, True)
        sock = self.socket_for(packet.protocol, packet.dst[1], packet.src)
        if sock is None:
            packet.add_status(PacketStatus.RCV_INTERFACE_DROPPED)
            return
        sock.push_in_packet(packet)

    def get_address(self) -> str:
        return self._address

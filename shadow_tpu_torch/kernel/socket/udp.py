"""The simulated UDP socket.

Parity: reference `src/main/host/descriptor/socket/inet/udp.rs` —
message-oriented soft-limited send/recv buffers; one packet per datagram (no
IP fragmentation; datagrams over 65507 bytes fail with EMSGSIZE,
`udp.rs:367-369`, `definitions.h:134`); implicit bind on first send chooses
loopback vs the default interface by destination (`udp.rs:381-387`);
received packets are dropped when the recv buffer is full (`udp.rs:140`);
connected sockets drop packets not from their peer (`udp.rs:736`);
READABLE/WRITABLE reflect buffer occupancy after every operation
(`udp.rs:984`).

The socket faces two planes: the NIC pulls outgoing packets via the
`InterfaceSocket` protocol (`pull_out_packet`/`peek_next_priority`/
`push_in_packet`), and applications call the bind/connect/send/recv API.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from ...net.packet import Packet, PacketStatus, Protocol
from .. import errors
from ..status import CallbackQueue, FileSignal, FileState, StatefulFile, queue_and_run

CONFIG_DATAGRAM_MAX_SIZE = 65507  # `definitions.h:134`

UNSPECIFIED = "0.0.0.0"
LOCALHOST = "127.0.0.1"


class _MessageBuffer:
    """Datagram buffer with a soft byte limit: a message may exceed the limit
    only when the buffer is empty (`udp.rs:1060-1100` MessageBuffer)."""

    __slots__ = ("soft_limit", "bytes", "queue")

    def __init__(self, soft_limit: int):
        self.soft_limit = soft_limit
        self.bytes = 0
        self.queue: deque = deque()

    def has_space(self) -> bool:
        return self.bytes < self.soft_limit

    def push(self, data, header, size: int) -> None:
        self.queue.append((data, header, size))
        self.bytes += size

    def pop(self):
        if not self.queue:
            return None
        item = self.queue.popleft()
        self.bytes -= item[2]
        return item

    def peek(self):
        return self.queue[0] if self.queue else None

    def __len__(self) -> int:
        return len(self.queue)


class UdpSocket(StatefulFile):
    def __init__(self, host, *, send_buf_size: Optional[int] = None,
                 recv_buf_size: Optional[int] = None):
        # A fresh UDP socket is writable immediately.
        super().__init__(FileState.ACTIVE | FileState.WRITABLE)
        self._host = host
        cfg = getattr(host, "config_experimental", None)
        send_default = getattr(cfg, "socket_send_buffer", 131072)
        recv_default = getattr(cfg, "socket_recv_buffer", 174760)
        # (data, header-tuple, size) entries
        self._send_buffer = _MessageBuffer(send_buf_size or send_default)
        self._recv_buffer = _MessageBuffer(recv_buf_size or recv_default)
        self.bound_addr: Optional[tuple[str, int]] = None
        self.peer_addr: Optional[tuple[str, int]] = None
        self.nonblocking = False
        self.drop_count = 0

    # ------------------------------------------------------------------
    # application API
    # ------------------------------------------------------------------

    def bind(self, addr: tuple[str, int]) -> tuple[str, int]:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.bound_addr is not None:
            raise errors.SyscallError(errors.EINVAL, "already bound")
        ip, port = addr
        if ip != UNSPECIFIED and self._host.netns.interface_for(ip) is None:
            raise errors.SyscallError(errors.EADDRNOTAVAIL, ip)
        if port == 0:
            port = self._host.netns.get_random_free_port(
                Protocol.UDP, self._host.rng, ip
            )
        elif not self._host.netns.is_port_free(Protocol.UDP, port, ip):
            raise errors.SyscallError(errors.EADDRINUSE, f"{ip}:{port}")
        self._host.netns.associate(self, Protocol.UDP, ip, port)
        self.bound_addr = (ip, port)
        return self.bound_addr

    def connect(self, addr: tuple[str, int]) -> None:
        """Set the default destination and filter inbound to that peer."""
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.bound_addr is None:
            self._implicit_bind(addr[0])
        self.peer_addr = addr

    def sendto(
        self, data: bytes, dst: Optional[tuple[str, int]] = None
    ) -> int:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if dst is None:
            if self.peer_addr is None:
                raise errors.SyscallError(errors.EDESTADDRREQ)
            dst = self.peer_addr
        if len(data) > CONFIG_DATAGRAM_MAX_SIZE:
            raise errors.SyscallError(errors.EMSGSIZE)

        if self.bound_addr is None:
            self._implicit_bind(dst[0])

        if not self._send_buffer.has_space():
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.WRITABLE)

        src = self._effective_src(dst)
        priority = self._host.get_next_packet_priority()
        self._send_buffer.push(bytes(data), (src, dst, priority), len(data))

        # Notify after state settles (`udp.rs:449-459` defers via cb_queue).
        with queue_and_run() as cq:
            self._refresh_readable_writable(cq)
            iface_ip = self.bound_addr[0]
            cq.add(
                lambda _cq: self._host.notify_socket_has_packets(
                    src[0] if iface_ip == UNSPECIFIED else iface_ip, self
                )
            )
        return len(data)

    def send(self, data: bytes) -> int:
        return self.sendto(data, None)

    def recvfrom(self, peek: bool = False) -> tuple[bytes, tuple[str, int]]:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        entry = self._recv_buffer.peek() if peek else self._recv_buffer.pop()
        if entry is None:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.READABLE)
        data, (src, _dst, _prio), _size = entry
        if not peek:
            self._refresh_readable_writable(None)
        return data, src

    def recv(self) -> bytes:
        return self.recvfrom()[0]

    def close(self) -> None:
        if self.is_closed():
            return
        if self.bound_addr is not None:
            self._host.netns.disassociate(Protocol.UDP, *self.bound_addr)
            self.bound_addr = None
        # Buffered outbound datagrams die with the socket: the port is
        # released, so emitting them later would source from a reusable port.
        self._send_buffer.queue.clear()
        self._send_buffer.bytes = 0
        self.update_state(
            FileState.ACTIVE | FileState.READABLE | FileState.WRITABLE | FileState.CLOSED,
            FileState.CLOSED,
        )

    def getsockname(self) -> Optional[tuple[str, int]]:
        return self.bound_addr

    def getpeername(self) -> Optional[tuple[str, int]]:
        return self.peer_addr

    # ------------------------------------------------------------------
    # InterfaceSocket protocol (NIC-facing)
    # ------------------------------------------------------------------

    def peek_next_priority(self) -> Optional[int]:
        if not self._send_buffer.queue:
            return None
        return self._send_buffer.queue[0][1][2]

    def pull_out_packet(self) -> Optional[Packet]:
        entry = self._send_buffer.pop()
        if entry is None:
            return None
        data, (src, dst, priority), _size = entry
        self._refresh_readable_writable(None)
        packet = Packet(Protocol.UDP, src, dst, payload=data, priority=priority)
        packet.add_status(PacketStatus.SND_SOCKET_BUFFERED)
        return packet

    def push_in_packet(self, packet: Packet) -> None:
        if self.is_closed():
            packet.add_status(PacketStatus.RCV_SOCKET_DROPPED)
            return
        # Connected sockets accept only their peer (`udp.rs:736`): port must
        # match; a peer IP of LOCALHOST also matches our own public address
        # form, so compare ports strictly and IPs loosely via local aliases.
        if self.peer_addr is not None and not self._from_peer(packet):
            packet.add_status(PacketStatus.RCV_SOCKET_DROPPED)
            self.drop_count += 1
            return
        if not self._recv_buffer.has_space():
            packet.add_status(PacketStatus.RCV_SOCKET_DROPPED)
            self.drop_count += 1
            return
        self._recv_buffer.push(
            packet.payload,
            (packet.src, packet.dst, packet.priority),
            packet.payload_size(),
        )
        packet.add_status(PacketStatus.RCV_SOCKET_BUFFERED)
        packet.add_status(PacketStatus.RCV_SOCKET_DELIVERED)
        self._refresh_readable_writable(None)
        self.emit_signal(FileSignal.READ_BUFFER_GREW)

    # ------------------------------------------------------------------

    def _from_peer(self, packet: Packet) -> bool:
        peer_ip, peer_port = self.peer_addr
        if packet.src[1] != peer_port:
            return False
        if packet.src[0] == peer_ip:
            return True
        # our loopback alias: peer "127.0.0.1" == packets sourced from our own
        # public IP when both ends sit on this host
        aliases = {LOCALHOST, self._host.netns.public_ip}
        return peer_ip in aliases and packet.src[0] in aliases

    def _implicit_bind(self, dst_ip: str) -> None:
        """Bind to an ephemeral port on loopback (loopback destination) or the
        default interface (anything else) (`udp.rs:381-400`)."""
        local_ip = LOCALHOST if dst_ip == LOCALHOST else self._host.netns.public_ip
        port = self._host.netns.get_random_free_port(
            Protocol.UDP, self._host.rng, local_ip
        )
        self._host.netns.associate(self, Protocol.UDP, local_ip, port)
        self.bound_addr = (local_ip, port)

    def _effective_src(self, dst: tuple[str, int]) -> tuple[str, int]:
        ip, port = self.bound_addr
        if ip == UNSPECIFIED:
            ip = LOCALHOST if dst[0] == LOCALHOST else self._host.netns.public_ip
        return (ip, port)

    def _refresh_readable_writable(self, cb_queue: Optional[CallbackQueue]) -> None:
        if self.is_closed():
            return  # close() cleared READABLE/WRITABLE permanently
        values = FileState.NONE
        if len(self._recv_buffer):
            values |= FileState.READABLE
        if self._send_buffer.has_space():
            values |= FileState.WRITABLE
        self.update_state(FileState.READABLE | FileState.WRITABLE, values, cb_queue)

"""The simulated TCP socket: glue between the pure `TcpConnection` state
machine and the host plane (NIC association, packet priorities, timers,
file-state notifications).

Parity: reference `src/main/host/descriptor/tcp.c` socket surface +
`descriptor/socket/inet/mod.rs` association rules:
- listeners hold a wildcard-peer association and spawn one child socket per
  SYN, associated by exact 4-tuple (the NIC's exact-match-first lookup
  routes established traffic to the child);
- the accept queue holds children whose handshake completed (backlog-capped
  at SYN time);
- connect() picks loopback vs the public interface by destination and draws
  a deterministic ephemeral port;
- outgoing segments are staged one at a time, stamped with the host's
  monotone packet priority so qdisc ordering matches the reference
  (`host.rs:679-720`).

The wrapper converts between wire `Packet`s (addressed) and protocol
`Segment`s (pure), so `shadow_tpu.tcp` never learns about IPs.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from ...core.event import TaskRef
from ...net.packet import Packet, PacketStatus, Protocol, TcpHeader
from ...tcp.connection import Segment, TcpConfig, TcpConnection, TcpError, TcpFlags, TcpState
from .. import errors
from ..status import FileSignal, FileState, StatefulFile

# int twins of the FileState combos _refresh_state recomputes per
# packet (IntFlag | / & re-enter the enum machinery per op)
_READABLE = int(FileState.READABLE)
_WRITABLE = int(FileState.WRITABLE)
_ALLOW_CONNECT = int(FileState.SOCKET_ALLOWING_CONNECT)
_RWC = _READABLE | _WRITABLE | _ALLOW_CONNECT

UNSPECIFIED = "0.0.0.0"
LOCALHOST = "127.0.0.1"
DEFAULT_BACKLOG = 128


def packet_to_segment(packet: Packet) -> Segment:
    h = packet.header or TcpHeader()
    return Segment(
        flags=h.flags,  # plain int bits on the hot path
        seq=h.seq,
        ack=h.ack,
        window=h.window,
        payload=packet.payload,
        window_scale=h.window_scale,
        timestamp=h.timestamp,
        timestamp_echo=h.timestamp_echo,
        sack_permitted=h.sack_permitted,
        sack=tuple(h.sel_acks),
    )


def segment_to_packet(
    seg: Segment, src: tuple[str, int], dst: tuple[str, int], priority: int
) -> Packet:
    header = TcpHeader(
        seq=seg.seq,
        ack=seg.ack,
        window=seg.window,
        flags=int(seg.flags),
        window_scale=seg.window_scale,
        timestamp=seg.timestamp,
        timestamp_echo=seg.timestamp_echo,
        sel_acks=tuple(seg.sack),
        sack_permitted=seg.sack_permitted,
    )
    return Packet(
        Protocol.TCP, src, dst, payload=seg.payload, header=header, priority=priority
    )


class _ConnDeps:
    """Dependencies implementation backed by the owning host."""

    __slots__ = ("sock",)

    def __init__(self, sock: "TcpSocket"):
        self.sock = sock

    def now(self) -> int:
        return self.sock._host.now()

    def set_timer(self, delay_ns, callback) -> None:
        self.sock._host.schedule_task_with_delay(
            TaskRef(lambda host: callback(), "tcp-timer"), delay_ns
        )

    def random_u32(self) -> int:
        return self.sock._host.rng.next_u64() >> 32

    def notify(self) -> None:
        self.sock._on_conn_event()


class TcpSocket(StatefulFile):
    # Linux sysctl ceilings the reference hardcodes (`definitions.h:32-37`)
    RMEM_MAX = 6291456
    WMEM_MAX = 4194304
    SND_UNIT = 2404  # per-segment send-mem estimate (`tcp.c` autotune)

    def __init__(self, host, config: Optional[TcpConfig] = None):
        super().__init__(FileState.ACTIVE)
        self._host = host
        exp = getattr(host, "config_experimental", None)
        if config is None:
            config = TcpConfig(
                send_buffer=getattr(exp, "socket_send_buffer", 131072),
                recv_buffer=getattr(exp, "socket_recv_buffer", 174760),
            )
        else:
            # never mutate a caller-supplied template (the listener
            # passes its _config to every accepted child)
            config = dataclasses.replace(config)
        self._config = config
        # dynamic buffer autotuning (`tcp.c:587-649`): receive buffers
        # track 2x the bytes the app drains per smoothed RTT; send
        # buffers track the congestion window. setsockopt SO_RCVBUF/
        # SO_SNDBUF disables the respective direction, like Linux.
        self.autotune_recv = bool(getattr(exp, "socket_recv_autotune", True))
        self.autotune_send = bool(getattr(exp, "socket_send_autotune", True))
        self._at_bytes_copied = 0
        self._at_space = 0
        self._at_last_adjust: Optional[int] = None
        if self.autotune_recv and config.wscale_buffer is None:
            # wscale must cover where autotune may take the buffer
            config.wscale_buffer = self.RMEM_MAX
        self.conn: Optional[TcpConnection] = None  # None while unconnected/listening
        self.bound_addr: Optional[tuple[str, int]] = None
        self.peer_addr: Optional[tuple[str, int]] = None
        self.nonblocking = False
        # listener state
        self._backlog: Optional[int] = None
        self._accept_queue: deque[TcpSocket] = deque()
        self._pending_children: dict[tuple[str, int], TcpSocket] = {}
        self._listener: Optional[TcpSocket] = None  # back-pointer on children
        # one staged outbound packet so the NIC can peek its priority
        self._staged: Optional[Packet] = None
        self._app_closed = False

    # ==================================================================
    # application API
    # ==================================================================

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
                Protocol.TCP, self._host.rng, ip
            )
        elif not self._host.netns.is_port_free(Protocol.TCP, port, ip):
            raise errors.SyscallError(errors.EADDRINUSE, f"{ip}:{port}")
        self._host.netns.associate(self, Protocol.TCP, ip, port)
        self.bound_addr = (ip, port)
        return self.bound_addr

    def listen(self, backlog: int = DEFAULT_BACKLOG) -> None:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.conn is not None:
            raise errors.SyscallError(errors.EISCONN)
        if self.bound_addr is None:
            # Linux allows listen() on unbound sockets (ephemeral on ANY)
            self.bind((UNSPECIFIED, 0))
        self._backlog = max(1, backlog)

    def accept(self) -> "TcpSocket":
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self._backlog is None:
            raise errors.SyscallError(errors.EINVAL, "not listening")
        if not self._accept_queue:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.READABLE)
        child = self._accept_queue.popleft()
        self._refresh_state()
        return child

    def connect(self, addr: tuple[str, int]) -> None:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self._backlog is not None:
            raise errors.SyscallError(errors.EOPNOTSUPP, "listening socket")
        if self.conn is not None:
            if self.conn.state == TcpState.SYN_SENT:
                raise errors.SyscallError(errors.EALREADY)
            raise errors.SyscallError(errors.EISCONN)
        dst_ip, _ = addr
        if self.bound_addr is None:
            local_ip = LOCALHOST if dst_ip == LOCALHOST else self._host.netns.public_ip
            port = self._host.netns.get_random_free_port(
                Protocol.TCP, self._host.rng, local_ip, peer=addr
            )
            self.bound_addr = (local_ip, port)
        else:
            # drop the wildcard-peer association from bind(); the exact
            # 4-tuple association below covers this connection
            local_ip, port = self.bound_addr
            self._host.netns.disassociate(Protocol.TCP, local_ip, port)
            if local_ip == UNSPECIFIED:
                local_ip = LOCALHOST if dst_ip == LOCALHOST else self._host.netns.public_ip
            self.bound_addr = (local_ip, port)
        self.peer_addr = addr
        # exact 4-tuple association: replies route straight to this socket
        self._host.netns.associate(self, Protocol.TCP, self.bound_addr[0],
                                   self.bound_addr[1], peer=addr)
        # per-connection config copy: autotune growth must not leak into
        # sibling sockets sharing the template
        self.conn = TcpConnection(_ConnDeps(self),
                                  dataclasses.replace(self._config))
        self.conn.open_active()
        self._pump_out()
        if self.nonblocking:
            raise errors.SyscallError(errors.EINPROGRESS)
        raise errors.Blocked(
            self, FileState.SOCKET_ALLOWING_CONNECT, restartable=False
        )

    def send(self, data: bytes) -> int:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.conn is None:
            raise errors.SyscallError(errors.ENOTCONN)
        if self.autotune_send:
            self._autotune_send()
        try:
            n = self.conn.write(data)
        except TcpError as e:
            raise errors.SyscallError(e.errno) from None
        if n == 0:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.WRITABLE)
        self._pump_out()
        self._refresh_state()
        return n

    def recv(self, max_bytes: int = 1 << 20, peek: bool = False) -> bytes:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        if self.conn is None:
            raise errors.SyscallError(errors.ENOTCONN)
        try:
            data = (self.conn.peek(max_bytes) if peek
                    else self.conn.read(max_bytes))
        except TcpError as e:
            raise errors.SyscallError(e.errno) from None
        if not data and not self.conn.at_eof():
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.READABLE)
        if not peek:
            if data and self.autotune_recv:
                self._autotune_recv(len(data))
            self._pump_out()  # reads can reopen the advertised window
            self._refresh_state()
        return data

    # -- buffer autotuning (`tcp.c:587-649`) ---------------------------

    def _autotune_recv(self, bytes_copied: int) -> None:
        """Input buffer tracks 2x the bytes the app drains per smoothed
        RTT: fast drains grow the window toward RMEM_MAX."""
        conn = self.conn
        self._at_bytes_copied += bytes_copied
        space = 2 * self._at_bytes_copied
        if space > self._at_space:
            self._at_space = space
            new = min(space, self.RMEM_MAX)
            if new > conn.config.recv_buffer:
                conn.config.recv_buffer = new
        now = self._host.now()
        if self._at_last_adjust is None:
            self._at_last_adjust = now
        elif conn.rtt.srtt_ms > 0 and \
                now - self._at_last_adjust > conn.rtt.srtt_ms * 1_000_000:
            self._at_last_adjust = now
            self._at_bytes_copied = 0

    def _autotune_send(self) -> None:
        """Output buffer tracks the congestion window (`tcp.c`'s
        2404-bytes-per-demanded-segment estimate)."""
        conn = self.conn
        demanded = max(conn.cong.cwnd, 1)
        new = min(self.SND_UNIT * 2 * demanded, self.WMEM_MAX)
        if new > conn.config.send_buffer:
            conn.config.send_buffer = new

    def set_buffer_size(self, direction: str, size: int) -> None:
        """SO_SNDBUF/SO_RCVBUF: Linux clamps the request to the sysctl
        ceiling as a u32 (so -1 means "the max"), doubles it, and pins it
        (disabling that direction's autotuning)."""
        cap = self.RMEM_MAX if direction == "recv" else self.WMEM_MAX
        size = max(4096, min(size & 0xFFFFFFFF, cap) * 2)
        target = self.conn.config if self.conn is not None else self._config
        if direction == "recv":
            self.autotune_recv = False
            self._config.recv_buffer = target.recv_buffer = size
        else:
            self.autotune_send = False
            self._config.send_buffer = target.send_buffer = size

    def close(self) -> None:
        if self._app_closed:
            return
        self._app_closed = True
        for child in list(self._accept_queue) + list(self._pending_children.values()):
            child.close()
        self._accept_queue.clear()
        if self.conn is not None and self.conn.state != TcpState.CLOSED:
            self.conn.close()
            self._pump_out()
        else:
            self._teardown()
        self.update_state(
            FileState.ACTIVE | FileState.READABLE | FileState.WRITABLE | FileState.CLOSED,
            FileState.CLOSED,
        )

    def getsockname(self):
        return self.bound_addr

    def getpeername(self):
        return self.peer_addr

    def is_connected(self) -> bool:
        return self.conn is not None and self.conn.is_established()

    # ==================================================================
    # InterfaceSocket protocol (NIC-facing)
    # ==================================================================

    def peek_next_priority(self) -> Optional[int]:
        return self._staged.priority if self._staged is not None else None

    def pull_out_packet(self) -> Optional[Packet]:
        packet = self._staged
        self._staged = None
        if packet is not None:
            packet.add_status(PacketStatus.SND_SOCKET_BUFFERED)
            self._stage_next()  # quiet restage; NIC requeues via peek
        return packet

    def push_in_packet(self, packet: Packet) -> None:
        if self._backlog is not None:
            self._listener_push(packet)
            return
        if self.conn is None:
            packet.add_status(PacketStatus.RCV_SOCKET_DROPPED)
            return
        packet.add_status(PacketStatus.RCV_SOCKET_PROCESSED)
        before = self.conn.readable_bytes()
        self.conn.on_segment(packet_to_segment(packet))
        if self.conn.readable_bytes() > before:
            self.emit_signal(FileSignal.READ_BUFFER_GREW)

    # ==================================================================
    # listener internals
    # ==================================================================

    def _listener_push(self, packet: Packet) -> None:
        seg = packet_to_segment(packet)
        key = packet.src
        if not seg.flags & TcpFlags.SYN or seg.flags & TcpFlags.ACK:
            packet.add_status(PacketStatus.RCV_SOCKET_DROPPED)
            return
        if key in self._pending_children:
            # duplicate SYN: the child's own association should normally win
            # the NIC lookup; re-deliver defensively
            self._pending_children[key].push_in_packet(packet)
            return
        if len(self._pending_children) + len(self._accept_queue) >= self._backlog:
            packet.add_status(PacketStatus.RCV_SOCKET_DROPPED)  # SYN drop
            return
        local = packet.dst
        child = TcpSocket(self._host, self._config)
        child.bound_addr = local
        child.peer_addr = key
        child._listener = self
        # Linux copies the buffer-lock flags to accepted sockets: an
        # explicit SO_*BUF pin on the listener binds its children too
        child.autotune_recv = self.autotune_recv
        child.autotune_send = self.autotune_send
        self._host.netns.associate(child, Protocol.TCP, local[0], local[1], peer=key)
        child.conn = TcpConnection(_ConnDeps(child),
                                   dataclasses.replace(self._config))
        child.conn.open_passive(seg)
        self._pending_children[key] = child
        child._pump_out()

    def _child_established(self, child: "TcpSocket") -> None:
        key = child.peer_addr
        if key in self._pending_children:
            del self._pending_children[key]
            self._accept_queue.append(child)
            self._refresh_state()

    def _child_died(self, child: "TcpSocket") -> None:
        self._pending_children.pop(child.peer_addr, None)
        try:
            self._accept_queue.remove(child)
        except ValueError:
            pass

    # ==================================================================
    # connection-event plumbing
    # ==================================================================

    def _on_conn_event(self) -> None:
        conn = self.conn
        if conn is None:
            return
        if (
            self._listener is not None
            and conn.state >= TcpState.ESTABLISHED
            and conn.state != TcpState.CLOSED
        ):
            listener, self._listener = self._listener, None
            listener._child_established(self)
        if conn.state == TcpState.CLOSED:
            if self._listener is not None:
                listener, self._listener = self._listener, None
                listener._child_died(self)
            self._teardown()
        self._pump_out()
        self._refresh_state()

    def _pump_out(self) -> None:
        """Stage one packet and wake the NIC if we went non-empty."""
        if self._staged is not None or self.conn is None:
            return
        if self._stage_next():
            iface_ip = self._staged.src[0]
            self._host.notify_socket_has_packets(iface_ip, self)

    def _stage_next(self) -> bool:
        if self.conn is None or self._staged is not None:
            return False
        seg = self.conn.next_segment()
        if seg is None:
            return False
        src = self._effective_src()
        self._staged = segment_to_packet(
            seg, src, self.peer_addr, self._host.get_next_packet_priority()
        )
        if getattr(self.conn, "last_segment_retransmit", False):
            self._staged.add_status(PacketStatus.SND_TCP_RETRANSMITTED)
        return True

    def _effective_src(self) -> tuple[str, int]:
        ip, port = self.bound_addr
        if ip == UNSPECIFIED:
            ip = (
                LOCALHOST
                if self.peer_addr and self.peer_addr[0] == LOCALHOST
                else self._host.netns.public_ip
            )
        return (ip, port)

    def _refresh_state(self) -> None:
        if self.is_closed():
            return
        values = 0
        if self._backlog is not None:
            if self._accept_queue:
                values |= _READABLE
            self.update_state(_READABLE, values)
            return
        conn = self.conn
        if conn is None:
            self.update_state(_RWC, 0)
            return
        if conn.readable_bytes() > 0 or conn.at_eof() or conn.error is not None:
            values |= _READABLE
        if conn.is_established() and conn.send_space() > 0 and not conn.fin_requested:
            values |= _WRITABLE
        if conn.is_established() or conn.error is not None:
            # error included: blocked connect()s must wake to see ECONNREFUSED
            values |= _ALLOW_CONNECT
        self.update_state(_RWC, values)

    def _teardown(self) -> None:
        """Connection fully dead: release the port association."""
        if self.bound_addr is not None and self.bound_addr[1] != 0:
            self._host.netns.disassociate(
                Protocol.TCP, self.bound_addr[0], self.bound_addr[1],
                peer=self.peer_addr if self.peer_addr else ("0.0.0.0", 0),
            )
        self._staged = None

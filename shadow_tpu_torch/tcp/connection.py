"""The TCP connection state machine.

Parity: reference `src/lib/tcp/src/lib.rs` (TcpState + Dependencies-driven
design, typestate FSM `states.rs:23-120`) and the legacy stack's congestion
machinery (`src/main/host/descriptor/tcp.c`): Reno (`tcp_cong_reno.c`),
RFC 6298 RTO (`tcp.c:1137-1170`), fast retransmit on the third duplicate
ack, TIME_WAIT expiry, window scaling (`src/lib/tcp/src/window_scaling.rs`),
RTT from timestamp options with Karn's rule (`tcp.c:2314-2316`).

Design notes (TPU-first, SURVEY.md §7 phase C):
- *Pull model*: the environment asks for the next segment
  (`next_segment()`); the connection never pushes. The NIC/relay layer paces
  transmission, so bandwidth and congestion limits compose correctly.
- *Unwrapped stream offsets* internally (plain ints), 32-bit wrapping only
  at the header boundary — the kernel-facing arithmetic stays branch-light
  and array-packable.
- All mutable state is scalars + two byte buffers; the planned JAX port
  carries the scalars as SoA arrays and fixed-capacity ring buffers.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from . import seq as seqmod
from .cong import RenoCongestion
from .rtt import RttEstimator

MSS = 1460  # CONFIG_TCP_MAX_SEGMENT_SIZE (`definitions.h:129`)
TIME_WAIT_NS = 60 * 1_000_000_000  # 2*MSL; Linux's 60s TIME_WAIT
MAX_WSCALE = 14  # RFC 7323 limit
SYN_RETRIES = 6  # Linux tcp_syn_retries default
DATA_RETRIES = 15  # Linux tcp_retries2 default


class TcpFlags(enum.IntFlag):
    NONE = 0
    FIN = 1
    SYN = 2
    RST = 4
    PSH = 8
    ACK = 16
    URG = 32


# plain-int twins for hot-path flag arithmetic: IntFlag's __and__/__or__
# re-enter the enum machinery on every test (measured ~25% of rung-3
# wall in enum internals); segments carry int flags at runtime and
# IntFlag's int interop keeps every external `==`/`&` comparison working
_FIN = int(TcpFlags.FIN)
_SYN = int(TcpFlags.SYN)
_RST = int(TcpFlags.RST)
_PSH = int(TcpFlags.PSH)
_ACK = int(TcpFlags.ACK)


class TcpState(enum.IntEnum):
    """FSM states (`src/lib/tcp/src/states.rs:23-120`, `tcp.c:38-52`)."""

    CLOSED = 0
    LISTEN = 1
    SYN_SENT = 2
    SYN_RCVD = 3
    ESTABLISHED = 4
    FIN_WAIT_1 = 5
    FIN_WAIT_2 = 6
    CLOSING = 7
    TIME_WAIT = 8
    CLOSE_WAIT = 9
    LAST_ACK = 10


class TcpError(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = err
        super().__init__(msg or str(err))


class Dependencies(Protocol):
    """Everything the state machine needs from its host environment
    (reference `lib/tcp/src/lib.rs` `Dependencies` trait)."""

    def now(self) -> int:
        """Emulated time, ns."""

    def set_timer(self, delay_ns: int, callback: Callable[[], None]) -> None:
        """Run `callback` after `delay_ns`; no cancellation (callbacks must
        self-validate, which the connection does with generation counters)."""

    def random_u32(self) -> int:
        """Deterministic per-host randomness for the ISS."""

    def notify(self) -> None:
        """State changed outside a caller's stack frame (timer fire, inbound
        segment): the wrapper should refresh file state and, if
        `has_outgoing()`, tell the NIC."""


@dataclass
class TcpConfig:
    mss: int = MSS
    send_buffer: int = 131072
    recv_buffer: int = 174760
    # wscale is fixed at SYN time; when buffers may grow later (socket
    # autotuning), this names the ceiling the scale should cover (None =
    # recv_buffer, the static-buffer behavior)
    wscale_buffer: Optional[int] = None
    window_scaling: bool = True
    nagle: bool = False  # reference disables Nagle's algorithm
    sack: bool = True  # RFC 2018 selective acknowledgment


SACK_SLOTS = 16  # sender scoreboard capacity (tcp_retransmit_tally.cc)
SACK_WIRE_BLOCKS = 3  # blocks carried per segment (RFC 2018 w/ timestamps)


@dataclass
class Segment:
    """One outbound segment, protocol-level only (no addresses — the socket
    wrapper owns addressing)."""

    flags: int  # TcpFlags bits (plain int on the hot path)
    seq: int  # 32-bit wire value
    ack: int
    window: int  # as advertised on the wire (already scaled down)
    payload: bytes = b""
    window_scale: Optional[int] = None  # SYN only
    timestamp: int = 0
    timestamp_echo: int = 0
    sack_permitted: bool = False  # SYN only (RFC 2018 option)
    sack: tuple = ()  # ((wire_start, wire_end), ...) end exclusive


class _Reassembly:
    """Out-of-order segment store keyed by unwrapped stream offset."""

    __slots__ = ("segments",)

    def __init__(self):
        self.segments: dict[int, bytes] = {}

    def insert(self, off: int, data: bytes) -> None:
        existing = self.segments.get(off)
        if existing is None or len(existing) < len(data):
            self.segments[off] = data

    def drain_from(self, off: int) -> tuple[int, list[bytes]]:
        """Pop every byte contiguous from `off`; returns (new_off, chunks)."""
        chunks = []
        while True:
            best = None
            for start, data in self.segments.items():
                if start <= off < start + len(data):
                    best = start
                    break
            if best is None:
                break
            data = self.segments.pop(best)
            skip = off - best
            chunks.append(data[skip:])
            off += len(data) - skip
        # drop fully-covered stale segments
        for start in [s for s, d in self.segments.items() if s + len(d) <= off]:
            del self.segments[start]
        return off, chunks

    def byte_count(self) -> int:
        return sum(len(d) for d in self.segments.values())


class _SackScoreboard:
    """Sender-side tally of peer-held (SACKed) ranges, unwrapped stream
    offsets (`tcp_retransmit_tally.cc`).

    A FIXED slot algorithm, deliberately branch-simple so the device
    kernel (`tpu/tcp.py`) mirrors it slot-for-slot: `insert` clips to the
    cumulative ack, skips contained duplicates, extends the FIRST
    overlapping-or-touching slot once (no cascade merging), else takes
    the first empty slot (all full = drop the block); `prune` clips every
    slot to the advancing ack; `next_unsacked` walks chained ranges to
    the first hole and reports the distance to the next range above."""

    __slots__ = ("s", "e")

    INF = 1 << 62

    def __init__(self):
        self.s = [0] * SACK_SLOTS
        self.e = [0] * SACK_SLOTS

    def insert(self, start: int, end: int, una: int) -> None:
        start = max(start, una)
        if start >= end:
            return
        for i in range(SACK_SLOTS):  # contained in an existing range?
            if self.e[i] > self.s[i] and self.s[i] <= start \
                    and end <= self.e[i]:
                return
        for i in range(SACK_SLOTS):  # extend the first overlap/touch
            if self.e[i] > self.s[i] and start <= self.e[i] \
                    and self.s[i] <= end:
                self.s[i] = min(self.s[i], start)
                self.e[i] = max(self.e[i], end)
                return
        for i in range(SACK_SLOTS):  # first empty slot
            if self.e[i] <= self.s[i]:
                self.s[i], self.e[i] = start, end
                return

    def prune(self, una: int) -> None:
        for i in range(SACK_SLOTS):
            if self.e[i] > self.s[i]:
                self.s[i] = max(self.s[i], una)
                if self.s[i] >= self.e[i]:
                    self.s[i] = self.e[i] = 0

    def next_unsacked(self, off: int) -> tuple[int, int]:
        """(off', cap): first unsacked offset >= off; bytes until the next
        range above (INF when none)."""
        for _ in range(SACK_SLOTS):
            moved = False
            for i in range(SACK_SLOTS):
                if self.e[i] > self.s[i] and self.s[i] <= off < self.e[i]:
                    off = self.e[i]
                    moved = True
            if not moved:
                break
        cap = self.INF
        for i in range(SACK_SLOTS):
            if self.e[i] > self.s[i] and self.s[i] > off:
                cap = min(cap, self.s[i] - off)
        return off, cap


class TcpConnection:
    def __init__(self, deps: Dependencies, config: Optional[TcpConfig] = None):
        self.deps = deps
        self.config = config or TcpConfig()
        self.state = TcpState.CLOSED
        self.error: Optional[int] = None

        # --- send side (unwrapped stream offsets; 0 = first payload byte) ---
        self.iss = 0  # initial send sequence number (wire value of our SYN)
        self.snd_una = 0  # lowest unacked stream offset
        self.snd_nxt = 0  # next offset to transmit
        self.snd_wnd = self.config.mss  # peer-advertised window, bytes
        self.snd_buf = bytearray()  # bytes [snd_una, stream_len)
        self.stream_len = 0  # total bytes accepted from the app
        self.fin_requested = False
        self.fin_sent = False
        self.fin_acked = False
        self._syn_outstanding = False  # our SYN/SYN-ACK is in flight
        self._syn_sends = 0  # builds of our SYN; >1 means handshake retransmit
        self.syn_acked = False
        self._retx_pending = False  # rebuild a segment at snd_una
        self._probe_pending = False  # zero-window probe: 1 byte past window
        self._recover = 0  # NewReno fast-recovery point (snd_nxt at entry)
        self._gbn_high = 0  # go-back-N: resends below this are retransmits
        self.snd_max = 0  # highest stream offset ever transmitted (+FIN slot)
        self._rst_pending = False

        # --- receive side -------------------------------------------------
        self.irs = 0  # peer's ISS
        self.rcv_nxt = 0  # next expected stream offset
        self._reassembly = _Reassembly()
        self._ordered: deque[bytes] = deque()  # in-order, app-readable chunks
        self._ordered_bytes = 0
        self._error_consumed = False  # reset reported to the app once
        self.fin_received = False
        self._fin_offset: Optional[int] = None
        self._ack_pending = False

        # --- options ------------------------------------------------------
        self.my_wscale = 0
        self.peer_wscale = 0
        self._wscale_ok = False  # both sides negotiated scaling
        if self.config.window_scaling:
            ws = 0
            cover = self.config.wscale_buffer or self.config.recv_buffer
            while (cover >> ws) > 0xFFFF and ws < MAX_WSCALE:
                ws += 1
            self.my_wscale = ws
        self._last_ts_recv = 0  # peer timestamp to echo

        # --- SACK (RFC 2018; `tcp_retransmit_tally.cc`) --------------------
        self._sack_ok = False  # negotiated on the handshake
        self._sacked = _SackScoreboard()
        self.retransmitted_bytes = 0

        # --- timers / control ---------------------------------------------
        self.rtt = RttEstimator()
        self.cong = RenoCongestion()
        self._rto_gen = 0
        self._rto_armed = False
        self._persist_gen = 0
        self._persist_armed = False
        self.retransmit_count = 0

    # ==================================================================
    # application-facing API
    # ==================================================================

    def open_active(self) -> None:
        assert self.state == TcpState.CLOSED
        self.iss = self.deps.random_u32() & 0xFFFFFFFF
        self.state = TcpState.SYN_SENT
        self._arm_rto()

    def open_passive(self, syn: Segment) -> None:
        """Become the server side of a connection from a received SYN
        (the listener socket calls this on a fresh connection)."""
        assert self.state == TcpState.CLOSED
        assert syn.flags & _SYN
        self.iss = self.deps.random_u32() & 0xFFFFFFFF
        self.irs = syn.seq
        self.rcv_nxt = 0  # offset 0 == wire seq irs+1
        if syn.window_scale is not None and self.config.window_scaling:
            self.peer_wscale = min(syn.window_scale, MAX_WSCALE)
            self._wscale_ok = True
        else:
            self.my_wscale = 0
        self._sack_ok = syn.sack_permitted and self.config.sack
        self.snd_wnd = syn.window  # unscaled on SYN
        self._last_ts_recv = syn.timestamp
        self.state = TcpState.SYN_RCVD
        self._arm_rto()

    def write(self, data: bytes) -> int:
        """Queue bytes for sending; returns how many were accepted (0 means
        the send buffer is full — caller blocks on WRITABLE)."""
        if self.error is not None:
            raise TcpError(self.error)
        if self.state in (TcpState.CLOSED, TcpState.LISTEN):
            raise TcpError(107, "ENOTCONN")
        if self.fin_requested:
            raise TcpError(32, "EPIPE")
        space = self.send_space()
        n = min(space, len(data))
        if n:
            self.snd_buf.extend(data[:n])
            self.stream_len += n
            # Zero-window deadlock guard: if the peer already closed its
            # window, only the persist timer can get this data moving.
            if self.snd_wnd == 0 and self.is_established():
                self._arm_persist()
        return n

    def _raise_pending_error(self) -> bool:
        """Shared by read/peek: surface a pending error once when the
        ordered queue is drained; afterwards reads see EOF, like Linux.
        Returns True when the caller should return b"" (post-consumption)."""
        if self.error is None or self._ordered:
            return False
        if self._error_consumed:
            return True
        self._error_consumed = True
        raise TcpError(self.error)

    def read(self, max_bytes: int) -> bytes:
        """Pop in-order received bytes; b"" at EOF. Raises when unreadable."""
        if self._raise_pending_error():
            return b""
        out = []
        need = max_bytes
        while need > 0 and self._ordered:
            chunk = self._ordered[0]
            if len(chunk) <= need:
                out.append(chunk)
                self._ordered.popleft()
                need -= len(chunk)
            else:
                out.append(chunk[:need])
                self._ordered[0] = chunk[need:]
                need = 0
        got = b"".join(out)
        self._ordered_bytes -= len(got)
        if got:
            # The window just opened; push an update if we'd gone quiet.
            self._ack_pending = True
            self.deps.notify()
        return got

    def peek(self, max_bytes: int) -> bytes:
        """Non-consuming read of in-order bytes (recv MSG_PEEK): no queue
        mutation, no window-update side effects. Pending errors are still
        consumed-once, like Linux sk_err under MSG_PEEK."""
        if self._raise_pending_error():
            return b""
        out = []
        need = max_bytes
        for chunk in self._ordered:
            if need <= 0:
                break
            take = chunk[:need]
            out.append(take)
            need -= len(take)
        return b"".join(out)

    def close(self) -> None:
        """Orderly close of the send direction (app close())."""
        if self.state in (TcpState.CLOSED, TcpState.LISTEN):
            self.state = TcpState.CLOSED
            return
        if self.state == TcpState.SYN_SENT:
            self._enter_closed(None)
            return
        if self.fin_requested:
            return
        self.fin_requested = True
        if self.state in (TcpState.ESTABLISHED, TcpState.SYN_RCVD):
            self.state = TcpState.FIN_WAIT_1
        elif self.state == TcpState.CLOSE_WAIT:
            self.state = TcpState.LAST_ACK
        self.deps.notify()

    def abort(self) -> None:
        """Hard reset (SO_LINGER 0 close / process death)."""
        if self.state in (TcpState.CLOSED, TcpState.LISTEN, TcpState.TIME_WAIT):
            self.state = TcpState.CLOSED
            return
        self._rst_pending = True
        self.deps.notify()

    # -- poll surface for the socket wrapper ---------------------------

    def readable_bytes(self) -> int:
        return self._ordered_bytes

    def at_eof(self) -> bool:
        if self._ordered_bytes:
            return False
        return self.fin_received or self._error_consumed

    def send_space(self) -> int:
        return max(0, self.config.send_buffer - (self.stream_len - self.snd_una))

    def is_established(self) -> bool:
        return self.state >= TcpState.ESTABLISHED and self.state != TcpState.CLOSED

    # ==================================================================
    # segment egress (pull model)
    # ==================================================================

    def has_outgoing(self) -> bool:
        return self._next_kind() is not None

    def next_segment(self) -> Optional[Segment]:
        kind = self._next_kind()
        if kind is None:
            return None
        builder = getattr(self, f"_build_{kind}")
        before_nxt = self.snd_nxt
        seg = builder()
        # visible to the socket wrapper so retransmissions can be stamped
        # with SND_TCP_RETRANSMITTED for the tracker (`tracker.c:24-41`);
        # covers handshake RTOs (kind 'syn' rebuilt after _on_rto_fire),
        # data retransmits, zero-window probes, and go-back-N resends of
        # previously-transmitted data after an RTO
        gbn_resend = kind in ("data", "fin") and before_nxt < self._gbn_high
        if gbn_resend:
            self.retransmit_count += 1
        if gbn_resend or kind == "retransmit":
            self.retransmitted_bytes += len(seg.payload)
        self.last_segment_retransmit = (
            kind in ("retransmit", "probe")
            or (kind == "syn" and self._syn_sends > 1)
            or gbn_resend
        )
        return seg

    def _next_kind(self) -> Optional[str]:
        if self._rst_pending:
            return "rst"
        if self.state in (TcpState.SYN_SENT, TcpState.SYN_RCVD) and not self._syn_outstanding:
            return "syn"
        if self.state == TcpState.SYN_SENT:
            return None  # nothing else goes out until the handshake answers
        if self._retx_pending and self.snd_nxt > self.snd_una:
            return "retransmit"
        if self._probe_pending and self.stream_len > self.snd_nxt:
            return "probe"
        if self._can_send_new_data():
            return "data"
        if self._should_send_fin():
            return "fin"
        if self._ack_pending and self.state not in (TcpState.CLOSED,):
            return "ack"
        return None

    def _can_send_new_data(self) -> bool:
        if self.state not in (
            TcpState.ESTABLISHED,
            TcpState.CLOSE_WAIT,
            TcpState.FIN_WAIT_1,  # data queued before close() drains first
            TcpState.CLOSING,  # ditto, after a simultaneous close
            TcpState.LAST_ACK,
        ):
            return False
        if self.snd_nxt >= self.stream_len:
            return False
        in_flight = self.snd_nxt - self.snd_una
        window = min(self.cong.cwnd * self.config.mss, self.snd_wnd)
        return in_flight < window

    def _should_send_fin(self) -> bool:
        return (
            self.fin_requested
            and not self.fin_sent
            and self.snd_nxt >= self.stream_len
            and self.state
            in (TcpState.FIN_WAIT_1, TcpState.LAST_ACK, TcpState.CLOSING)
        )

    # -- builders -------------------------------------------------------

    def _wire_seq(self, off: int) -> int:
        """Stream offset -> 32-bit wire sequence (offset 0 == iss+1)."""
        return seqmod.add(self.iss, 1 + off)

    def _wire_ack(self) -> int:
        off = self.rcv_nxt + (1 if self.fin_received else 0)
        return seqmod.add(self.irs, 1 + off)

    def _recv_space(self) -> int:
        used = self._ordered_bytes + self._reassembly.byte_count()
        return max(0, self.config.recv_buffer - used)

    def _advertised_window(self, for_syn: bool) -> int:
        space = self._recv_space()
        if for_syn or not self._wscale_ok:
            return min(space, 0xFFFF)
        return min(space >> self.my_wscale, 0xFFFF)

    def _now_ms(self) -> int:
        return self.deps.now() // 1_000_000

    def _stamp(self, seg: Segment) -> Segment:
        seg.timestamp = self._now_ms() & 0xFFFFFFFF
        seg.timestamp_echo = self._last_ts_recv
        return seg

    def _sack_blocks(self) -> tuple:
        """Receiver SACK blocks from the reassembly store: the ranges
        NEAREST the ack point first (lowest start), merged when touching.
        Deterministic (stable across schedulers) and maximally useful to
        the sender, whose retransmissions fill the lowest holes first —
        as they fill, the 3-block window slides up the held ranges."""
        if not self._sack_ok or not self._reassembly.segments:
            return ()
        ranges = sorted(
            (start, start + len(data))
            for start, data in self._reassembly.segments.items()
        )
        merged: list[list[int]] = []
        for s, e in ranges:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        base = seqmod.add(self.irs, 1)
        return tuple(
            (seqmod.add(base, s), seqmod.add(base, e))
            for s, e in merged[:SACK_WIRE_BLOCKS]
        )

    def _build_syn(self) -> Segment:
        self._syn_outstanding = True
        self._syn_sends += 1
        if self._syn_sends > 1:
            self.retransmit_count += 1
        if self.state == TcpState.SYN_SENT:
            flags, ack = _SYN, 0
        else:  # SYN_RCVD: SYN|ACK
            flags, ack = _SYN | _ACK, self._wire_ack()
        self._ack_pending = False
        return self._stamp(
            Segment(
                flags=flags,
                seq=self.iss,
                ack=ack,
                window=self._advertised_window(for_syn=True),
                window_scale=self.my_wscale if self.config.window_scaling else None,
                sack_permitted=self.config.sack,
            )
        )

    def _build_data(self) -> Segment:
        off = self.snd_nxt
        # never (re)send bytes the peer already SACKed: jump the send
        # cursor over held ranges, cap the chunk at the next held range
        off2, cap = self._sacked.next_unsacked(off)
        if off2 != off:
            self.snd_nxt = off2
            self.snd_max = max(self.snd_max, off2)
            off = off2
        in_flight = off - self.snd_una
        window = min(self.cong.cwnd * self.config.mss, self.snd_wnd)
        n = min(self.config.mss, self.stream_len - off, window - in_flight,
                cap)
        if n <= 0:
            # everything in reach is already held by the peer
            return self._build_ack()
        payload = bytes(self.snd_buf[off - self.snd_una : off - self.snd_una + n])
        self.snd_nxt = off + n
        self.snd_max = max(self.snd_max, self.snd_nxt)
        self._ack_pending = False
        if not self._rto_armed:
            self._arm_rto()
        flags = _ACK
        if self.snd_nxt >= self.stream_len:
            flags |= _PSH
        return self._stamp(
            Segment(
                flags=flags,
                seq=self._wire_seq(off),
                ack=self._wire_ack(),
                window=self._advertised_window(False),
                payload=payload,
                sack=self._sack_blocks(),
            )
        )

    def _build_retransmit(self) -> Segment:
        self._retx_pending = False
        self.retransmit_count += 1
        off = self.snd_una
        # only payload bytes live in the buffer; the FIN slot retransmits
        # as a FIN. SACK: the hole ends where the peer's held data starts.
        _, cap = self._sacked.next_unsacked(off)
        n = min(self.config.mss, self.stream_len - off, cap)
        if n <= 0:
            if self.fin_sent:
                return self._build_fin(retransmit=True)
            return self._build_ack()
        payload = bytes(self.snd_buf[:n])
        if not self._rto_armed:
            self._arm_rto()
        return self._stamp(
            Segment(
                flags=_ACK,
                seq=self._wire_seq(off),
                ack=self._wire_ack(),
                window=self._advertised_window(False),
                payload=payload,
                sack=self._sack_blocks(),
            )
        )

    def _build_probe(self) -> Segment:
        """Zero-window probe: one byte beyond the advertised window."""
        self._probe_pending = False
        off = self.snd_nxt
        payload = bytes(self.snd_buf[off - self.snd_una : off - self.snd_una + 1])
        self.snd_nxt = off + 1
        self.snd_max = max(self.snd_max, self.snd_nxt)
        if not self._rto_armed:
            self._arm_rto()
        return self._stamp(
            Segment(
                flags=_ACK,
                seq=self._wire_seq(off),
                ack=self._wire_ack(),
                window=self._advertised_window(False),
                payload=payload,
                sack=self._sack_blocks(),
            )
        )

    def _build_fin(self, retransmit: bool = False) -> Segment:
        if not retransmit:
            self.fin_sent = True
            self.snd_nxt = self.stream_len + 1  # FIN occupies one seq slot
            self.snd_max = max(self.snd_max, self.snd_nxt)
        self._ack_pending = False
        if not self._rto_armed:
            self._arm_rto()
        return self._stamp(
            Segment(
                flags=_FIN | _ACK,
                seq=self._wire_seq(self.stream_len),
                ack=self._wire_ack(),
                window=self._advertised_window(False),
                sack=self._sack_blocks(),
            )
        )

    def _build_ack(self) -> Segment:
        self._ack_pending = False
        return self._stamp(
            Segment(
                flags=_ACK,
                seq=self._wire_seq(min(self.snd_nxt, self.stream_len + (1 if self.fin_sent else 0))),
                ack=self._wire_ack(),
                window=self._advertised_window(False),
                sack=self._sack_blocks(),
            )
        )

    def _build_rst(self) -> Segment:
        self._rst_pending = False
        seg = Segment(
            flags=_RST | _ACK,
            seq=self._wire_seq(min(self.snd_nxt, self.stream_len)),
            ack=self._wire_ack(),
            window=0,
        )
        self._enter_closed(104)  # ECONNRESET locally too
        return seg

    # ==================================================================
    # segment ingress
    # ==================================================================

    def on_segment(self, seg: Segment) -> None:
        if self.state == TcpState.CLOSED:
            # RFC 793: a segment (other than RST) arriving at a closed
            # connection elicits a RESET — without it, a peer stuck in
            # CLOSING/LAST_ACK retransmits its FIN into a silent void
            # until retry exhaustion (reachable once the wire is lossy;
            # both twins fixed together round 5, tpu/tcp.py _ev_segment)
            if not seg.flags & _RST:
                self._rst_pending = True
                self.deps.notify()
            return
        if seg.timestamp:
            self._last_ts_recv = seg.timestamp

        if self.state == TcpState.SYN_SENT:
            self._on_segment_syn_sent(seg)
            self.deps.notify()
            return

        # --- RST (any synchronized state) ------------------------------
        if seg.flags & _RST:
            if self.state == TcpState.TIME_WAIT:
                self._enter_closed(None)
            else:
                self._enter_closed(104)  # ECONNRESET
            self.deps.notify()
            return

        # --- SYN handling outside handshake -----------------------------
        if seg.flags & _SYN:
            if self.state == TcpState.SYN_RCVD and seg.seq == self.irs:
                # duplicate of the original SYN: re-send SYN|ACK
                self._syn_outstanding = False
                self.deps.notify()
                return
            if self.state == TcpState.TIME_WAIT:
                return  # new-connection reuse unsupported; ignore
            if seqmod.lt(seg.seq, seqmod.add(self.irs, 1 + self.rcv_nxt)):
                # old duplicate SYN below the window — e.g. a
                # retransmitted SYN|ACK when our handshake-completing
                # ACK was lost. RFC 793 p.69 / RFC 5961: answer with an
                # ACK (which completes the peer's handshake), never RST.
                # Both twins fixed together round 5 (tpu/tcp.py
                # _ev_segment); a lossy wire made this reachable.
                self._ack_pending = True
                self.deps.notify()
                return
            self._rst_pending = True
            self.deps.notify()
            return

        if seg.flags & _ACK:
            self._process_ack(seg)

        if seg.payload:
            self._process_payload(seg)

        if seg.flags & _FIN:
            self._process_fin(seg)

        self.deps.notify()

    def _on_segment_syn_sent(self, seg: Segment) -> None:
        if seg.flags & _RST:
            if seg.flags & _ACK and seg.ack == seqmod.add(self.iss, 1):
                self._enter_closed(111)  # ECONNREFUSED
            return
        if seg.flags & _SYN and seg.flags & _ACK:
            if seg.ack != seqmod.add(self.iss, 1):
                self._rst_pending = True
                return
            self.irs = seg.seq
            self.rcv_nxt = 0
            self.syn_acked = True
            self._syn_outstanding = False
            if seg.window_scale is not None and self.config.window_scaling:
                self.peer_wscale = min(seg.window_scale, MAX_WSCALE)
                self._wscale_ok = True
            else:
                self.my_wscale = 0
            self._sack_ok = seg.sack_permitted and self.config.sack
            self.snd_wnd = seg.window  # unscaled on SYN
            self.state = TcpState.ESTABLISHED
            self._ack_pending = True
            self._disarm_rto()
            if seg.timestamp_echo and self.rtt.backoff_count == 0:
                self.rtt.update(self._now_ms() - seg.timestamp_echo)
        elif seg.flags & _SYN:
            # simultaneous open
            self.irs = seg.seq
            self.rcv_nxt = 0
            if seg.window_scale is not None and self.config.window_scaling:
                self.peer_wscale = min(seg.window_scale, MAX_WSCALE)
                self._wscale_ok = True
            self._sack_ok = seg.sack_permitted and self.config.sack
            self.snd_wnd = seg.window
            self.state = TcpState.SYN_RCVD
            self._syn_outstanding = False  # rebuild as SYN|ACK
            # that rebuild is a NEW segment (first SYN|ACK), not a
            # handshake retransmission — don't let it count as one
            self._syn_sends = 0

    def _process_ack(self, seg: Segment) -> None:
        ack_off = self._unwrap_ack(seg.ack)
        if ack_off is None:
            return

        # SYN_RCVD: the handshake-completing ACK
        if self.state == TcpState.SYN_RCVD and ack_off >= 0:
            self.syn_acked = True
            self.state = TcpState.ESTABLISHED
            self._disarm_rto()
            if seg.timestamp_echo and self.rtt.backoff_count == 0:
                self.rtt.update(self._now_ms() - seg.timestamp_echo)

        if self._sack_ok and seg.sack:
            base = self._wire_seq(0)  # wire value of stream offset 0
            limit = max(self.snd_nxt, self.snd_max)
            for ws, we in seg.sack[:SACK_WIRE_BLOCKS]:
                s_off = seqmod.sub(ws, base)
                e_off = seqmod.sub(we, base)
                if s_off < (1 << 31) and e_off < (1 << 31) \
                        and s_off < e_off and e_off <= limit:
                    self._sacked.insert(s_off, e_off, self.snd_una)

        sent_end = self.snd_nxt
        fin_off = self.stream_len + 1 if self.fin_sent else None
        new_window = seg.window << (self.peer_wscale if self._wscale_ok else 0)

        if ack_off > self.snd_una:
            acked_bytes = min(ack_off, self.stream_len) - self.snd_una
            del self.snd_buf[:acked_bytes]
            self.snd_una = min(ack_off, self.stream_len)
            if fin_off is not None and ack_off >= fin_off:
                self.fin_acked = True
                self.snd_una = self.stream_len
            if self.snd_nxt < self.snd_una:
                self.snd_nxt = self.snd_una
            self._sacked.prune(self.snd_una)
            if acked_bytes > 0:
                n_seg = (acked_bytes + self.config.mss - 1) // self.config.mss
                if self.cong.in_fast_recovery and ack_off < self._recover:
                    # NewReno (RFC 6582): a partial ack means the next hole
                    # is also lost — retransmit it NOW, stay in recovery
                    self.cong.on_partial_ack(n_seg)
                    self._retx_pending = True
                else:
                    self.cong.on_new_ack(n_seg)
                    self._retx_pending = False
            else:
                self._retx_pending = False
            if seg.timestamp_echo and self.rtt.backoff_count == 0:
                self.rtt.update(self._now_ms() - seg.timestamp_echo)
            self.rtt.reset_backoff()
            # RTO restarts while anything is in flight
            if self.snd_nxt > self.snd_una or (self.fin_sent and not self.fin_acked):
                self._arm_rto()
            else:
                self._disarm_rto()
            self._on_fin_acked_transitions()
        elif (
            ack_off == self.snd_una
            and not seg.payload
            and self.snd_nxt > self.snd_una
            and new_window == self.snd_wnd
            and new_window > 0  # probe-elicited acks aren't loss signals
        ):
            if self.cong.on_duplicate_ack():
                self._retx_pending = True  # fast retransmit
                self._recover = self.snd_nxt  # NewReno recovery point

        self.snd_wnd = new_window
        if self.snd_wnd == 0 and self.stream_len > self.snd_nxt:
            self._arm_persist()

    def _unwrap_ack(self, wire_ack: int) -> Optional[int]:
        """Wire ack -> stream offset; None for an ack of data never sent
        (RFC 793: such acks must be ignored, not applied).

        Offsets near snd_una disambiguate the wrap: old duplicate acks map
        below snd_una (harmless), valid ones into [snd_una, snd_nxt]."""
        base = self._wire_seq(self.snd_una)
        delta = seqmod.sub(wire_ack, base)
        if delta < (1 << 31):
            off = self.snd_una + delta
            # bound by the ever-sent high-water mark, not snd_nxt: after a
            # go-back-N rollback, in-flight acks legitimately cover data
            # above the rolled-back snd_nxt
            if off > max(self.snd_nxt, self.snd_max):
                return None  # acks bytes we never transmitted
            return off
        return self.snd_una - seqmod.sub(base, wire_ack)

    def _on_fin_acked_transitions(self) -> None:
        if not self.fin_acked:
            return
        if self.state == TcpState.FIN_WAIT_1:
            self.state = TcpState.FIN_WAIT_2
        elif self.state == TcpState.CLOSING:
            self._enter_time_wait()
        elif self.state == TcpState.LAST_ACK:
            self._enter_closed(None)

    def _process_payload(self, seg: Segment) -> None:
        if self.state in (TcpState.TIME_WAIT,):
            self._ack_pending = True
            return
        seg_off = self.rcv_nxt + seqmod.sub(seg.seq, self._wire_rcv_nxt())
        if seg_off > self.rcv_nxt + (1 << 31):
            seg_off = self.rcv_nxt - seqmod.sub(self._wire_rcv_nxt(), seg.seq)

        data = seg.payload
        # trim left of rcv_nxt
        if seg_off < self.rcv_nxt:
            skip = self.rcv_nxt - seg_off
            if skip >= len(data):
                self._ack_pending = True  # pure duplicate
                return
            data = data[skip:]
            seg_off = self.rcv_nxt
        # trim right of the receive window
        space_end = self.rcv_nxt + self._recv_space()
        if seg_off >= space_end:
            self._ack_pending = True
            return
        if seg_off + len(data) > space_end:
            data = data[: space_end - seg_off]
        if data:
            self._reassembly.insert(seg_off, data)
            new_nxt, chunks = self._reassembly.drain_from(self.rcv_nxt)
            self.rcv_nxt = new_nxt
            for c in chunks:
                self._ordered.append(c)
                self._ordered_bytes += len(c)
        self._ack_pending = True
        self._maybe_apply_pending_fin()

    def _wire_rcv_nxt(self) -> int:
        return seqmod.add(self.irs, 1 + self.rcv_nxt)

    def _process_fin(self, seg: Segment) -> None:
        fin_off = self.rcv_nxt + seqmod.sub(
            seqmod.add(seg.seq, len(seg.payload)), self._wire_rcv_nxt()
        )
        if fin_off > self.rcv_nxt + (1 << 31):  # stale retransmitted fin
            fin_off = self.rcv_nxt
        self._fin_offset = fin_off if self._fin_offset is None else self._fin_offset
        self._ack_pending = True
        self._maybe_apply_pending_fin()

    def _maybe_apply_pending_fin(self) -> None:
        if self.fin_received or self._fin_offset is None:
            return
        if self._fin_offset > self.rcv_nxt:
            return  # data before the FIN still missing
        self.fin_received = True
        if self.state == TcpState.ESTABLISHED:
            self.state = TcpState.CLOSE_WAIT
        elif self.state == TcpState.FIN_WAIT_1:
            if self.fin_acked:
                self._enter_time_wait()
            else:
                self.state = TcpState.CLOSING
        elif self.state == TcpState.FIN_WAIT_2:
            self._enter_time_wait()

    # ==================================================================
    # timers
    # ==================================================================

    def _arm_rto(self) -> None:
        self._rto_gen += 1
        self._rto_armed = True
        gen = self._rto_gen
        self.deps.set_timer(self.rtt.rto_ns, lambda: self._on_rto_fire(gen))

    def _disarm_rto(self) -> None:
        self._rto_gen += 1
        self._rto_armed = False

    def _on_rto_fire(self, gen: int) -> None:
        if gen != self._rto_gen or self.state == TcpState.CLOSED:
            return
        self._rto_armed = False
        in_flight = (
            self.snd_nxt > self.snd_una
            or (self.fin_sent and not self.fin_acked)
            or self.state in (TcpState.SYN_SENT, TcpState.SYN_RCVD)
        )
        if not in_flight:
            return
        # Retry limits (Linux tcp_syn_retries / tcp_retries2): give up and
        # surface ETIMEDOUT rather than retransmitting forever.
        limit = (
            SYN_RETRIES
            if self.state in (TcpState.SYN_SENT, TcpState.SYN_RCVD)
            else DATA_RETRIES
        )
        if self.rtt.backoff_count >= limit:
            self._enter_closed(110)  # ETIMEDOUT
            return
        self.rtt.backoff()
        self.cong.on_timeout()
        if self.state in (TcpState.SYN_SENT, TcpState.SYN_RCVD):
            self._syn_outstanding = False  # rebuild the SYN / SYN|ACK
        else:
            # Go-back-N (pre-SACK TCP timeout recovery): the receiver may
            # have discarded any or all of the in-flight tail, so resend
            # everything unacked through normal slow-start-paced
            # transmission instead of trickling one MSS per (backed-off)
            # RTO. Segments below the old snd_nxt are stamped as
            # retransmissions. A pure unacked FIN lands here too (its
            # sequence slot keeps snd_nxt above snd_una) and re-sends via
            # fin_sent=False once the data, if any, drains.
            self._gbn_high = max(self._gbn_high, self.snd_nxt)
            self.snd_nxt = self.snd_una
            self._retx_pending = False
            if self.fin_sent and not self.fin_acked:
                self.fin_sent = False
            if self.snd_wnd == 0 and self.stream_len > self.snd_nxt:
                self._arm_persist()  # window may never reopen via acks
        self._arm_rto()
        self.deps.notify()

    def _arm_persist(self) -> None:
        if self._persist_armed:
            return
        self._persist_gen += 1
        self._persist_armed = True
        gen = self._persist_gen
        self.deps.set_timer(self.rtt.rto_ns, lambda: self._on_persist_fire(gen))

    def _on_persist_fire(self, gen: int) -> None:
        if gen != self._persist_gen or self.state == TcpState.CLOSED:
            return
        self._persist_armed = False
        if self.snd_wnd == 0 and self.stream_len > self.snd_nxt:
            self._probe_pending = True
            self.rtt.backoff()
            self._arm_persist()
            self.deps.notify()

    def _enter_time_wait(self) -> None:
        self.state = TcpState.TIME_WAIT
        self._disarm_rto()
        gen = self._rto_gen
        self.deps.set_timer(
            TIME_WAIT_NS,
            lambda: self._enter_closed(None) if gen == self._rto_gen else None,
        )

    def _enter_closed(self, error: Optional[int]) -> None:
        notify = self.state != TcpState.CLOSED
        self.state = TcpState.CLOSED
        if error is not None:
            self.error = error
        self._disarm_rto()
        self._persist_gen += 1
        if notify:
            self.deps.notify()

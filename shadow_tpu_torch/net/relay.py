"""Rate-limited packet relays.

Parity: reference `src/main/network/relay/` — a `Relay` is the active
forwarder between `PacketDevice`s. It pulls packets from a source device and
pushes them to destination devices resolved through the host, enforcing an
optional byte-rate limit with a token bucket. State machine Idle → Pending →
Forwarding (`relay/mod.rs:67-77`); when out of tokens it caches the blocked
packet and schedules itself to resume exactly when enough tokens will exist.

Token bucket (`relay/token_bucket.rs`): refills `increment` tokens every
`interval` (1ms), lazily applying missed refills; capacity = increment + one
MTU of burst allowance so unfragmented packets can't strand tokens
(`relay/mod.rs:277-318`). Rate limits are bypassed during the bootstrap
period and for device-local (src == dst) deliveries (`relay/mod.rs:202,224`).
"""

from __future__ import annotations

from typing import Optional

from ..core import simtime
from .packet import CONFIG_MTU, Packet, PacketStatus

_IDLE = 0
_PENDING = 1
_FORWARDING = 2


class TokenBucket:
    """Discrete-interval token bucket; times are emulated-time ns ints."""

    __slots__ = ("capacity", "balance", "refill_increment", "refill_interval", "last_refill")

    def __init__(self, capacity: int, refill_increment: int, refill_interval: int):
        if capacity <= 0 or refill_increment <= 0 or refill_interval <= 0:
            raise ValueError("token bucket args must be positive")
        self.capacity = capacity
        self.balance = capacity
        self.refill_increment = refill_increment
        self.refill_interval = refill_interval
        self.last_refill = 0

    def conforming_remove(self, decrement: int, now: int) -> tuple[bool, int]:
        """Try to remove `decrement` tokens at time `now`. Returns
        (True, new_balance) on success or (False, wait_ns) where `wait_ns` is
        the duration until enough tokens will exist (aligned to refill
        boundaries)."""
        next_refill_span = self._lazy_refill(now)
        if decrement <= self.balance:
            self.balance -= decrement
            return True, self.balance
        required = decrement - self.balance
        num_refills = -(-required // self.refill_increment)  # ceil div
        if num_refills == 0:
            return False, 0
        wait = next_refill_span + (num_refills - 1) * self.refill_interval
        return False, wait

    def _lazy_refill(self, now: int) -> int:
        """Apply any refill events that have passed; return ns to the next."""
        span = now - self.last_refill
        if span >= self.refill_interval:
            num = span // self.refill_interval
            self.balance = min(
                self.balance + num * self.refill_increment, self.capacity
            )
            self.last_refill += num * self.refill_interval
            span = now - self.last_refill
        return self.refill_interval - span


def create_token_bucket(bytes_per_second: int) -> TokenBucket:
    """Shadow's relay bucket: 1ms refills of rate/1000 (min 1) bytes, with one
    MTU of extra capacity as burst allowance (`relay/mod.rs:277-296`)."""
    refill_interval = simtime.MILLISECOND
    refill_size = max(1, bytes_per_second // 1000)
    return TokenBucket(refill_size + CONFIG_MTU, refill_size, refill_interval)


class Relay:
    """Forwards packets from one source device until out of packets/tokens.

    The host supplies the environment:
      host.get_packet_device(ip) -> PacketDevice   (routing table)
      host.schedule_relay_task(callback, delay_ns) (self-scheduling)
      host.now() -> int                            (emulated time)
      host.is_bootstrapping() -> bool              (rate-limit bypass)
    """

    def __init__(self, host, src_dev_address: str, bytes_per_second: Optional[int]):
        self._host = host
        self._src_address = src_dev_address
        self._base_bytes_per_second = bytes_per_second
        self._rate_limiter = (
            create_token_bucket(bytes_per_second) if bytes_per_second is not None else None
        )
        self._state = _IDLE
        self._next_packet: Optional[Packet] = None

    def set_fault_divisor(self, div: int) -> None:
        """Fault-plane bandwidth degradation (host_degrade): rebuild the
        bucket at base_rate // div. Rebuilding starts the new bucket at
        full (degraded) capacity and re-anchors its refill phase at the
        event instant — documented modeling choice (docs/robustness.md):
        a degradation event resets the bucket."""
        if self._base_bytes_per_second is None:
            return
        rate = max(1, self._base_bytes_per_second // max(int(div), 1))
        bucket = create_token_bucket(rate)
        bucket.last_refill = self._host.now()
        self._rate_limiter = bucket

    def notify(self) -> None:
        """Source device became non-empty; start forwarding after the current
        stack unwinds (lets socket data accumulate for batched forwards)."""
        if self._state == _IDLE:
            self._forward_later(0)
        # Pending/Forwarding: a run is already scheduled or active.

    def _forward_later(self, delay_ns: int) -> None:
        assert self._state != _PENDING
        self._state = _PENDING
        self._host.schedule_relay_task(self._run_forward_task, delay_ns)

    def _run_forward_task(self) -> None:
        self._state = _IDLE
        blocking = self._forward_until_blocked()
        if blocking is not None:
            self._forward_later(blocking)

    def _forward_until_blocked(self) -> Optional[int]:
        host = self._host
        bootstrapping = host.is_bootstrapping()
        self._state = _FORWARDING
        src = host.get_packet_device(self._src_address)
        while True:
            packet = self._next_packet
            self._next_packet = None
            if packet is None:
                packet = src.pop()
            if packet is None:
                self._state = _IDLE
                return None
            # Local deliveries (loopback; inet device talking to itself) are
            # exempt from rate limits.
            is_local = src.get_address() == packet.dst[0]
            if not bootstrapping and not is_local and self._rate_limiter is not None:
                ok, result = self._rate_limiter.conforming_remove(
                    packet.total_size(), host.now()
                )
                if not ok:
                    packet.add_status(PacketStatus.RELAY_CACHED)
                    self._next_packet = packet
                    self._state = _IDLE
                    return result
            packet.add_status(PacketStatus.RELAY_FORWARDED)
            if is_local:
                src.push(packet)
            else:
                host.get_packet_device(packet.dst[0]).push(packet)

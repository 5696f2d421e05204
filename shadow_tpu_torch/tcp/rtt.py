"""RFC 6298 round-trip-time estimation and retransmission timeout.

Parity: reference `tcp.c:1128-1170` (`_tcp_updateRTTEstimate`,
`_tcp_setRetransmitTimeout`) and `definitions.h:46-48`: millisecond
granularity integer arithmetic, SRTT/RTTVAR with alpha=1/8 beta=1/4,
initial RTO 1s, exponential backoff on expiry, and Karn's rule (no
estimate updates from echoes while backed off, `tcp.c:2315-2316`).

DELIBERATE deviation from the reference's RTO = SRTT + 4*RTTVAR: the
deviation term is floored at RTO_MIN/4 like Linux's tcp_rtt_estimator
(net/ipv4/tcp_input.c, mdev floor), so RTO >= SRTT + RTO_MIN. See
`_rto_from_estimate` for why the unfloored formula spuriously times out
on deterministic constant-RTT paths. The clamp to [200ms, 120s] is
unchanged.

Integer milliseconds — not ns — deliberately: the estimator divides, and
keeping the reference's ms units makes the arithmetic exact and cheap for
the eventual int32 TPU port.
"""

from __future__ import annotations

RTO_INIT_MS = 1000  # CONFIG_TCP_RTO_INIT (NET_TCP_HZ = 1000 ms)
RTO_MIN_MS = 200  # CONFIG_TCP_RTO_MIN
RTO_MAX_MS = 120_000  # CONFIG_TCP_RTO_MAX


def _rto_from_estimate(srtt_ms: int, rttvar_ms: int) -> int:
    """RTO from the current estimate, with Linux's deviation floor
    (tcp_input.c tcp_rtt_estimator: mdev_max >= tcp_rto_min/4) so
    RTO >= srtt + RTO_MIN. Pure RFC 6298 lets rttvar decay to 0 under
    perfectly regular samples while the integer srtt EWMA settles a
    couple ms BELOW the true RTT (floor division) — rto < RTT,
    guaranteeing periodic spurious timeouts on any constant-RTT path
    with RTT > RTO_MIN. A deterministic simulator produces exactly such
    paths (the device flow engine hit this at RTT 234 ms: srtt settled
    at 232, rttvar at 0). The device twin (`tpu/tcp.py:_rtt_update`)
    mirrors this formula; change BOTH or the bitwise-parity contract
    breaks."""
    return srtt_ms + 4 * max(rttvar_ms, RTO_MIN_MS // 4)


class RttEstimator:
    __slots__ = ("srtt_ms", "rttvar_ms", "rto_ms", "backoff_count")

    def __init__(self):
        self.srtt_ms = 0  # 0 = no measurement yet
        self.rttvar_ms = 0
        self.rto_ms = RTO_INIT_MS
        self.backoff_count = 0

    def update(self, rtt_ms: int) -> None:
        """Fold one RTT sample in; recompute the RTO. Callers must not feed
        samples taken from retransmitted segments (Karn's rule) — gate on
        `backoff_count == 0` like the reference does."""
        rtt_ms = max(1, rtt_ms)
        if self.srtt_ms == 0:
            self.srtt_ms = rtt_ms
            self.rttvar_ms = rtt_ms // 2
        else:
            self.rttvar_ms = (3 * self.rttvar_ms) // 4 + abs(self.srtt_ms - rtt_ms) // 4
            self.srtt_ms = (7 * self.srtt_ms) // 8 + rtt_ms // 8
        self._set_rto(_rto_from_estimate(self.srtt_ms, self.rttvar_ms))
        self.backoff_count = 0

    def backoff(self) -> None:
        """RTO expiry: double the timeout (`tcp.c:1499`)."""
        self.backoff_count += 1
        self._set_rto(self.rto_ms * 2)

    def reset_backoff(self) -> None:
        """Forward progress after a timeout: restore the RTO from the
        estimator instead of keeping the exponentially-inflated value
        (otherwise every later loss doubles from the inflated base and
        recovery degenerates into minutes-long stalls)."""
        if self.backoff_count == 0:
            return
        self.backoff_count = 0
        if self.srtt_ms:
            self._set_rto(_rto_from_estimate(self.srtt_ms, self.rttvar_ms))
        else:
            self._set_rto(RTO_INIT_MS)

    def _set_rto(self, ms: int) -> None:
        self.rto_ms = min(max(ms, RTO_MIN_MS), RTO_MAX_MS)

    @property
    def rto_ns(self) -> int:
        return self.rto_ms * 1_000_000

"""Reno congestion control, counted in segments.

Parity: reference `src/main/host/descriptor/tcp_cong_reno.c` — the three
phases and their transitions:

- slow start: cwnd += n per n newly-acked segments; on reaching ssthresh,
  carry the leftover acks into congestion avoidance (`tcp_cong_reno.c:70-93`);
- congestion avoidance: cwnd += 1 per cwnd acked segments, via an
  accumulator (`:110-120`);
- three duplicate acks (from slow start or avoidance): ssthresh = cwnd/2+1,
  cwnd = ssthresh + 3, enter fast recovery (`:50-66`); every further dup ack
  inflates cwnd += 1 (`:97-99`); the next new ack deflates cwnd = ssthresh
  and re-enters avoidance (`:101-107`);
- RTO timeout: ssthresh = cwnd/2+1, restart slow start (`:152-163`) —
  the reference restarts at cwnd=10, its initial-window constant
  (`tcp.c:2856`).

The whole state is four small ints — trivially SoA-packable for the TPU
per-connection step kernel.
"""

from __future__ import annotations

INITIAL_WINDOW = 10  # segments (`tcp.c:2856`)
_SSTHRESH_INF = (1 << 31) - 1

_SLOW_START = 0
_AVOIDANCE = 1
_RECOVERY = 2


class RenoCongestion:
    __slots__ = ("cwnd", "ssthresh", "phase", "dup_acks", "_avoid_acked")

    def __init__(self, initial_window: int = INITIAL_WINDOW):
        self.cwnd = initial_window  # segments
        self.ssthresh = _SSTHRESH_INF
        self.phase = _SLOW_START
        self.dup_acks = 0
        self._avoid_acked = 0

    def on_new_ack(self, n_segments: int) -> None:
        """`n_segments` newly acknowledged (cumulative-ack advance / MSS)."""
        self.dup_acks = 0
        if self.phase == _RECOVERY:
            self.cwnd = self.ssthresh
            self._enter_avoidance(n_segments)
        elif self.phase == _SLOW_START:
            new_cwnd = self.cwnd + n_segments
            if new_cwnd >= self.ssthresh:
                leftover = new_cwnd - self.ssthresh
                self.cwnd = self.ssthresh
                self._enter_avoidance(leftover)
            else:
                self.cwnd = new_cwnd
        else:
            self._avoid_tick(n_segments)

    def on_duplicate_ack(self) -> bool:
        """Returns True exactly when fast retransmit should fire (3rd dup)."""
        if self.phase == _RECOVERY:
            self.cwnd += 1  # window inflation
            return False
        self.dup_acks += 1
        if self.dup_acks == 3:
            self.ssthresh = self.cwnd // 2 + 1
            self.cwnd = self.ssthresh + 3
            self.phase = _RECOVERY
            return True
        return False

    def on_partial_ack(self, n_segments: int) -> None:
        """NewReno partial ack during fast recovery (RFC 6582): deflate by
        the amount acked, add back one segment, stay in recovery."""
        self.cwnd = max(1, self.cwnd - n_segments + 1)

    def on_timeout(self) -> None:
        self.dup_acks = 0
        self.ssthresh = self.cwnd // 2 + 1
        self.cwnd = INITIAL_WINDOW
        self.phase = _SLOW_START

    @property
    def in_fast_recovery(self) -> bool:
        return self.phase == _RECOVERY

    def _enter_avoidance(self, carried_acks: int) -> None:
        self.phase = _AVOIDANCE
        self._avoid_acked = 0
        if carried_acks:
            self._avoid_tick(carried_acks)

    def _avoid_tick(self, n: int) -> None:
        self._avoid_acked += n
        while self._avoid_acked >= self.cwnd:
            self._avoid_acked -= self.cwnd
            self.cwnd += 1

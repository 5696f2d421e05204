"""Pure, dependency-injected TCP.

Parity: reference `src/lib/tcp/` (clean-room Rust TCP driven by a
`Dependencies` trait — clock and timers injected, nothing Shadow-specific)
*plus* the congestion machinery the Rust crate lacks, modeled on the legacy
stack: Reno congestion control (`src/main/host/descriptor/tcp_cong_reno.c`),
RFC 6298 retransmission timing (`tcp.c:1137-1170`), retransmit queue and
fast retransmit/recovery (`tcp.c`, `tcp_retransmit_tally.cc`).

Deliberately structured as a *pull-model state machine over plain integer
state* — the shape that transplants to a vmapped JAX step function in the
TPU plane (SURVEY.md §7 phase C): no callbacks into the environment except
the injected `Dependencies`, segments built on demand, all window/sequence
state as scalars.
"""

from .connection import (
    Dependencies,
    TcpConfig,
    TcpConnection,
    TcpError,
    TcpFlags,
    TcpState,
)
from .cong import RenoCongestion
from .rtt import RttEstimator

__all__ = [
    "Dependencies",
    "RenoCongestion",
    "RttEstimator",
    "TcpConfig",
    "TcpConnection",
    "TcpError",
    "TcpFlags",
    "TcpState",
]

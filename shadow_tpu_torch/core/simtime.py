"""Simulation and emulated time: the port's copy of
`shadow_tpu/core/simtime.py`.

Times are plain Python ints (nanoseconds); this module holds the
constants, conversions and the emulated-time epoch the configuration
parser and the unit parser read (the reference's `simulation_time.rs`,
u64 nanoseconds since the start, and `emulated_time.rs`, whose epoch is
2000-01-01 00:00:00 UTC).
"""

from __future__ import annotations

import datetime

# One unit of each duration, in nanoseconds.
NANOSECOND = 1
MICROSECOND = 1_000
MILLISECOND = 1_000_000
SECOND = 1_000_000_000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE

# EmulatedTime epoch: what sim-time zero looks like to managed applications.
# 2000-01-01T00:00:00Z expressed as ns since the UNIX epoch.
EMUTIME_SIMULATION_START_UNIX_NS = int(
    datetime.datetime(2000, 1, 1, tzinfo=datetime.timezone.utc).timestamp()
) * SECOND


# clockids whose reads are raw simulation time (zero at sim start) rather
# than emulated-epoch time: MONOTONIC(1), MONOTONIC_RAW(4),
# MONOTONIC_COARSE(6), BOOTTIME(7). Must match clockid_is_monotonic() in
# interpose/shim.cc (the in-shim fast path answers the same clocks).
MONOTONIC_CLOCK_IDS = frozenset((1, 4, 6, 7))


def emulated_from_sim(sim_ns: int) -> int:
    """Map simulation time -> emulated UNIX time (ns) seen by applications."""
    return EMUTIME_SIMULATION_START_UNIX_NS + sim_ns


def sim_from_emulated(emu_unix_ns: int) -> int:
    """Inverse of :func:`emulated_from_sim`."""
    return emu_unix_ns - EMUTIME_SIMULATION_START_UNIX_NS


def from_seconds(s: float) -> int:
    return round(s * SECOND)


def to_seconds(ns: int) -> float:
    return ns / SECOND


def fmt(ns: int) -> str:
    """Human-readable duration, used by the logger (e.g. '00:00:03.000000042')."""
    s, rem = divmod(ns, SECOND)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.{rem:09d}"

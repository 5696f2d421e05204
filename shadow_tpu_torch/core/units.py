"""Typed config units: durations, byte sizes and bit rates.

The port's copy of `shadow_tpu/core/units.py`: the same spellings ("1
Gbit", "10 ms", "16 MiB", "2 seconds") and the same rounding, so a
config compiles to the same integers in both packages (the reference's
`src/main/utility/units.rs`).
"""

from __future__ import annotations

import re

from . import simtime

_NUM = r"(?P<num>[0-9]+(?:\.[0-9]+)?)"
_RE = re.compile(_NUM + r"\s*(?P<unit>[A-Za-zμ]*)$")

_TIME_UNITS = {
    "": simtime.SECOND,  # bare numbers in time positions mean seconds
    "ns": simtime.NANOSECOND,
    "nanosecond": simtime.NANOSECOND,
    "nanoseconds": simtime.NANOSECOND,
    "us": simtime.MICROSECOND,
    "μs": simtime.MICROSECOND,
    "microsecond": simtime.MICROSECOND,
    "microseconds": simtime.MICROSECOND,
    "ms": simtime.MILLISECOND,
    "millisecond": simtime.MILLISECOND,
    "milliseconds": simtime.MILLISECOND,
    "s": simtime.SECOND,
    "sec": simtime.SECOND,
    "secs": simtime.SECOND,
    "second": simtime.SECOND,
    "seconds": simtime.SECOND,
    "m": simtime.MINUTE,
    "min": simtime.MINUTE,
    "mins": simtime.MINUTE,
    "minute": simtime.MINUTE,
    "minutes": simtime.MINUTE,
    "h": simtime.HOUR,
    "hr": simtime.HOUR,
    "hrs": simtime.HOUR,
    "hour": simtime.HOUR,
    "hours": simtime.HOUR,
}

_SI = {
    "": 1,
    "K": 10**3,
    "kilo": 10**3,
    "M": 10**6,
    "mega": 10**6,
    "G": 10**9,
    "giga": 10**9,
    "T": 10**12,
    "tera": 10**12,
}
_BIN = {
    "Ki": 2**10,
    "kibi": 2**10,
    "Mi": 2**20,
    "mebi": 2**20,
    "Gi": 2**30,
    "gibi": 2**30,
    "Ti": 2**40,
    "tebi": 2**40,
}


def _build_scaled(suffixes: tuple[str, ...]) -> dict[str, int]:
    out: dict[str, int] = {}
    for suffix in suffixes:
        for prefix, mult in list(_SI.items()) + list(_BIN.items()):
            out[prefix + suffix] = mult
            out[(prefix + suffix).lower()] = mult
    return out


_BYTE_UNITS = _build_scaled(("B", "byte", "bytes"))
_BYTE_UNITS[""] = 1
_BIT_UNITS = _build_scaled(("bit", "bits", "b"))
_BIT_UNITS[""] = 1  # bare numbers mean bits/sec, like bare bytes/durations


class UnitParseError(ValueError):
    pass


def _split(text: str | int | float) -> tuple[float, str]:
    if isinstance(text, (int, float)):
        return float(text), ""
    m = _RE.match(text.strip())
    if not m:
        raise UnitParseError(f"cannot parse unit value: {text!r}")
    return float(m.group("num")), m.group("unit")


def parse_duration_ns(text: str | int | float) -> int:
    """Parse a duration ('10 ms', '2s', 30) into integer nanoseconds."""
    num, unit = _split(text)
    try:
        scale = _TIME_UNITS[unit]
    except KeyError:
        raise UnitParseError(f"unknown time unit {unit!r} in {text!r}") from None
    return round(num * scale)


def parse_bytes(text: str | int | float) -> int:
    num, unit = _split(text)
    try:
        scale = _BYTE_UNITS[unit]
    except KeyError:
        raise UnitParseError(f"unknown byte unit {unit!r} in {text!r}") from None
    return round(num * scale)


def parse_bits_per_sec(text: str | int | float) -> int:
    """Parse a bandwidth ('1 Gbit', '10 Mbit', '100 Mbps') into bits/second."""
    num, unit = _split(text)
    # "Mbps"-style spellings: strip the per-second suffix, but only when a
    # unit remains — a bare "ps" (e.g. a picosecond duration misplaced in a
    # rate field) must stay an error, not parse as dimensionless bits/sec.
    if unit.endswith("ps") and len(unit) > 2:
        unit = unit[:-2]
    try:
        scale = _BIT_UNITS[unit]
    except KeyError:
        raise UnitParseError(f"unknown rate unit {unit!r} in {text!r}") from None
    return round(num * scale)

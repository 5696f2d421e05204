"""Typed durations, as the fault schedule reads them ("10 ms", "2s", 30).

The port's copy of the duration half of `shadow_tpu/core/units.py` and
the constants of `shadow_tpu/core/simtime.py` it needs: the same
spellings and the same rounding, so a `faults:` block compiles to the
same nanoseconds in both packages.
"""

from __future__ import annotations

import re

NANOSECOND = 1
MICROSECOND = 1_000
MILLISECOND = 1_000_000
SECOND = 1_000_000_000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE

_RE = re.compile(r"(?P<num>[0-9]+(?:\.[0-9]+)?)\s*(?P<unit>[A-Za-zμ]*)$")

_TIME_UNITS = {
    "": SECOND,  # a bare number in a time position means seconds
    **dict.fromkeys(("ns", "nanosecond", "nanoseconds"), NANOSECOND),
    **dict.fromkeys(("us", "μs", "microsecond", "microseconds"), MICROSECOND),
    **dict.fromkeys(("ms", "millisecond", "milliseconds"), MILLISECOND),
    **dict.fromkeys(("s", "sec", "secs", "second", "seconds"), SECOND),
    **dict.fromkeys(("m", "min", "mins", "minute", "minutes"), MINUTE),
    **dict.fromkeys(("h", "hr", "hrs", "hour", "hours"), HOUR),
}


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
        raise UnitParseError(
            f"unknown time unit {unit!r} in {text!r}") from None
    return round(num * scale)

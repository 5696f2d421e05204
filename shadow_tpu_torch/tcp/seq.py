"""32-bit wrapping sequence-number arithmetic.

Parity: reference `src/lib/tcp/src/seq.rs` (wrapping `Seq` type). All
comparisons are modular: `a` is "before" `b` when the wrapped distance from
`a` to `b` is less than half the space.
"""

MOD = 1 << 32
_HALF = 1 << 31


def add(a: int, n: int) -> int:
    return (a + n) % MOD


def sub(a: int, b: int) -> int:
    """Distance from b to a (a - b), wrapped to [0, 2^32)."""
    return (a - b) % MOD


def lt(a: int, b: int) -> bool:
    return a != b and sub(b, a) < _HALF


def le(a: int, b: int) -> bool:
    return a == b or lt(a, b)


def gt(a: int, b: int) -> bool:
    return lt(b, a)


def ge(a: int, b: int) -> bool:
    return le(b, a)


def clamp(x: int, lo: int, hi: int) -> int:
    """Clamp x into the wrapped interval [lo, hi]."""
    if lt(x, lo):
        return lo
    if gt(x, hi):
        return hi
    return x

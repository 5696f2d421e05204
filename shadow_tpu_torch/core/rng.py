"""The host-side deterministic RNG the fault schedule draws from.

The port's copy of `shadow_tpu/core/rng.py`: splitmix64 seeding,
xoshiro256++, the stable hostname hash and the per-host seeds, bit for
bit, so a seeded `random:` fault block expands to the same events and
the Manager shuffles and seeds its hosts as in both packages. Nothing on
the device uses these streams.
"""

from __future__ import annotations

import hashlib

_MASK = (1 << 64) - 1


def splitmix64(state: int) -> tuple[int, int]:
    """One splitmix64 step: returns (new_state, output)."""
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK


def hostname_hash(name: str) -> int:
    """Stable 64-bit hash of a hostname (blake2b-8, not Python's salted
    hash)."""
    return int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=8).digest(), "little")


class Xoshiro256pp:
    """xoshiro256++, seeded through splitmix64."""

    __slots__ = ("s",)

    def __init__(self, seed: int):
        state = seed & _MASK
        s = []
        for _ in range(4):
            state, out = splitmix64(state)
            s.append(out)
        self.s = s

    def next_u64(self) -> int:
        s = self.s
        result = (_rotl((s[0] + s[3]) & _MASK, 23) + s[0]) & _MASK
        t = (s[1] << 17) & _MASK
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return result

    def randrange(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) by the multiply-shift reduction."""
        span = hi - lo
        if span <= 0:
            raise ValueError("empty range")
        return lo + (self.next_u64() * span >> 64)

    def random(self) -> float:
        """Uniform float in [0, 1) with 53 bits of precision."""
        return (self.next_u64() >> 11) * (2.0**-53)

    def bernoulli(self, p: float) -> bool:
        return self.random() < p

    def shuffle(self, xs: list) -> None:
        for i in range(len(xs) - 1, 0, -1):
            j = self.randrange(0, i + 1)
            xs[i], xs[j] = xs[j], xs[i]


def host_seed_for(global_rng: Xoshiro256pp, hostname: str) -> int:
    """Per-host seed: a draw from the global stream XOR the hostname hash.

    Drawing in config-declared host order makes the seed independent of
    scheduling; XORing the name hash decorrelates hosts that would otherwise
    share a draw position across config edits.
    """
    return global_rng.next_u64() ^ hostname_hash(hostname)

"""The guard plane's device checks (`GuardState`), in PyTorch.

Counterpart of `shadow_tpu/guards/plane.py`: conservation laws and
ring invariants checked on the device every window over values the step
already computed, folded into per-host int32 violation bitmasks and the
window of each host's first violation. Nothing raises on the device and
nothing is read back: the runner pulls the small state once, after the
drive, and decodes it with `summarize`. Threading guards leaves the
simulation state bitwise unchanged.

The checks: egress conservation (occupancy at entry == sent + fault
purge + occupancy at exit), ingress conservation (entry + arrivals ==
overflow + AQM drops + deliveries + relay-cache moves + exit), ring
structure (front-packed validity, I32_MAX sentinels in invalid slots),
the packed-key budget (live priority and seq >= 0), RNG monotonicity (a
counter advance in [0, CE]), the virtual clock (shift and window >= 0,
a scalar flag) and, in `ingest`/`ingest_rows`/`flow_emit`, append
conservation. Equality is modular int32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

I32_MAX = 2**31 - 1

# violation bits; per host unless marked scalar
GUARD_EGRESS_FLOW = 1 << 0
GUARD_INGRESS_FLOW = 1 << 1
GUARD_RING_STRUCT = 1 << 2
GUARD_KEY_BUDGET = 1 << 3
GUARD_RNG_MONOTONE = 1 << 4
GUARD_CLOCK = 1 << 5  # scalar (the flags leaf)
GUARD_INGEST_FLOW = 1 << 6

GUARD_BIT_NAMES = {
    GUARD_EGRESS_FLOW: "egress-conservation",
    GUARD_INGRESS_FLOW: "ingress-conservation",
    GUARD_RING_STRUCT: "ring-structure",
    GUARD_KEY_BUDGET: "packed-key-budget",
    GUARD_RNG_MONOTONE: "rng-monotone",
    GUARD_CLOCK: "virtual-clock",
    GUARD_INGEST_FLOW: "ingest-conservation",
}

#: checks evaluated per guarded window (the `checks` leaf)
_CHECKS_PER_WINDOW = 6


class GuardState(NamedTuple):
    """The violation accumulator; field order is the JAX package's."""

    violations: torch.Tensor  # [N] int32 bitmask of GUARD_* bits
    first_window: torch.Tensor  # [N] int32 window of the first hit
    flags: torch.Tensor  # 0-d int32 bitmask of window-global checks
    windows: torch.Tensor  # 0-d int32 guarded windows so far
    checks: torch.Tensor  # 0-d int32 checks evaluated


def make_guards(n_hosts: int, *, device=None) -> GuardState:
    """A clean accumulator for `n_hosts` hosts."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return GuardState(
        violations=torch.zeros(n_hosts, **i32),
        first_window=torch.full((n_hosts,), I32_MAX, **i32),
        flags=torch.zeros((), **i32),
        windows=torch.zeros((), **i32),
        checks=torch.zeros((), **i32),
    )


def _record(guards: GuardState, bad_bits, scalar_bits: int,
            n_checks: int) -> GuardState:
    """Fold one window's bits in; `first_window` pins the current window
    index for hosts whose first bit lands now."""
    hit_now = (guards.violations == 0) & (bad_bits != 0)
    return GuardState(
        violations=guards.violations | bad_bits,
        first_window=torch.where(hit_now, guards.windows,
                                 guards.first_window),
        flags=guards.flags | scalar_bits,
        windows=guards.windows + 1,
        checks=guards.checks + n_checks,
    )


def _front_packed(valid) -> torch.Tensor:
    """Per row: True when an invalid slot precedes a valid one (the
    front-pack invariant is broken)."""
    return (~valid[:, :-1] & valid[:, 1:]).any(dim=1)


def _struct_bits(state) -> torch.Tensor:
    """Per-host ring-structure violations: front-packed validity and
    I32_MAX sentinels in invalid slots."""
    return (_front_packed(state.eg_valid)
            | _front_packed(state.in_valid)
            | (~state.in_valid & (state.in_deliver_rel != I32_MAX)).any(dim=1)
            | (~state.eg_valid & (state.eg_prio != I32_MAX)).any(dim=1))


def _key_bits(state) -> torch.Tensor:
    """Per-host packed-key budget violations: live priority and seq must
    be non-negative."""
    return (state.eg_valid
            & ((state.eg_prio < 0) | (state.eg_seq < 0))).any(dim=1)


def _bit(cond, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(torch.int32)


def check_window(guards: GuardState, *, state, eg_occ_in,
                 eg_left_this_window, in_occ_in, arrivals, overflowed,
                 delivered, qdisc_delta, cached_in, cached_out, new_state,
                 rng_delta, egress_cap: int, shift_ns: int,
                 window_ns: int) -> GuardState:
    """Section 9 of `window_step`: every window invariant over values the
    step computed. Structure and key budget are checked on both the
    entry and the exit state. `eg_left_this_window` is [N] sent +
    fault-purged, `arrivals` [N] routed packets by destination,
    `cached_in/out` relay-cached occupancy (zeros on the direct path),
    `rng_delta` [N] the counter advance; all int32, compared modulo
    2**32."""
    eg_occ_out = new_state.eg_valid.sum(dim=1, dtype=torch.int32)
    in_occ_out = new_state.in_valid.sum(dim=1, dtype=torch.int32)
    egress_bad = eg_occ_in - eg_left_this_window != eg_occ_out
    ingress_bad = (in_occ_in + arrivals - overflowed - delivered
                   - qdisc_delta + cached_in - cached_out) != in_occ_out
    struct_bad = _struct_bits(state) | _struct_bits(new_state)
    key_bad = _key_bits(state) | _key_bits(new_state)
    rng_bad = (rng_delta < 0) | (rng_delta > egress_cap)
    bad = (_bit(egress_bad, GUARD_EGRESS_FLOW)
           | _bit(ingress_bad, GUARD_INGRESS_FLOW)
           | _bit(struct_bad, GUARD_RING_STRUCT)
           | _bit(key_bad, GUARD_KEY_BUDGET)
           | _bit(rng_bad, GUARD_RNG_MONOTONE))
    clock_bad = shift_ns < 0 or window_ns < 0
    return _record(guards, bad, GUARD_CLOCK if clock_bad else 0,
                   _CHECKS_PER_WINDOW)


def check_ingest(guards: GuardState, *, occ_before, occ_after, incoming,
                 overflow) -> GuardState:
    """Append conservation: each row gains exactly incoming - overflow
    entries. Does not advance `windows` (an append rides between
    windows, so a hit pins the window about to run)."""
    bad = _bit(occ_after - occ_before != incoming - overflow,
               GUARD_INGEST_FLOW)
    hit_now = (guards.violations == 0) & (bad != 0)
    return guards._replace(
        violations=guards.violations | bad,
        first_window=torch.where(hit_now, guards.windows,
                                 guards.first_window),
        checks=guards.checks + 1,
    )


# -- host-side decode (after the drive) ---------------------------------------


def decode_bits(bits: int) -> list[str]:
    """Names of the guard classes set in a violation bitmask."""
    return [name for bit, name in sorted(GUARD_BIT_NAMES.items())
            if bits & bit]


def summarize(guards: GuardState) -> dict:
    """The JAX package's summary of a guard state: violating hosts,
    scalar flags, per-class host counts, the first 16 offenders, windows
    and checks counted, and `clean`. Reads the state to the host."""
    host = lambda t: t.detach().cpu().numpy()
    violations, first = host(guards.violations), host(guards.first_window)
    flags = int(host(guards.flags))
    bad_hosts = np.nonzero(violations)[0]
    by_class: dict[str, int] = {}
    for bit, name in sorted(GUARD_BIT_NAMES.items()):
        n = int(((violations & bit) != 0).sum()) + (1 if flags & bit else 0)
        if n:
            by_class[name] = n
    offenders = [{"host_index": int(h),
                  "bits": decode_bits(int(violations[h])),
                  "first_window": int(first[h])} for h in bad_hosts[:16]]
    return {
        "violating_hosts": int(bad_hosts.size),
        "scalar_flags": decode_bits(flags),
        "by_class": by_class,
        "first_offenders": offenders,
        "windows_checked": int(host(guards.windows)),
        "checks_evaluated": int(host(guards.checks)),
        "clean": bad_hosts.size == 0 and flags == 0,
    }

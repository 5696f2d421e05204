"""The destination router's per-host scalar state, as far as the FIFO
direct-delivery window step needs it.

`window_step` rebases this state on every window even without the
router AQM (the state carries the rebased clocks and the re-anchored
down-bandwidth bucket), so the port keeps the state, its constructor and
its rebase. The CoDel drain itself (`router_drain`) is not ported yet.

Counterpart: `shadow_tpu/tpu/codel.py:317-393`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .prims import floordiv, floormod

MILLISECOND = 1_000_000


class RouterDownState(NamedTuple):
    """Per-host scalar state of the integrated router+relay, axis 0 = host."""

    # CoDel scalars
    mode: torch.Tensor
    has_interval_end: torch.Tensor
    interval_end: torch.Tensor
    has_drop_next: torch.Tensor
    drop_next: torch.Tensor
    cur_count: torch.Tensor
    prev_count: torch.Tensor
    # down-bandwidth token bucket
    dn_balance: torch.Tensor  # int32 token bytes
    dn_last_refill: torch.Tensor  # int32 rel ns of the last refill boundary
    # relay-cached packet (popped from CoDel, waiting for tokens)
    has_cached: torch.Tensor  # bool
    cached_src: torch.Tensor
    cached_seq: torch.Tensor
    cached_sock: torch.Tensor
    cached_bytes: torch.Tensor
    resume: torch.Tensor  # int32 rel ns the relay resumes (iff has_cached)
    dropped: torch.Tensor  # int32 cumulative router drops


def make_router_state(n_hosts: int, dn_cap: torch.Tensor | None = None, *,
                      device: torch.device) -> RouterDownState:
    z = lambda: torch.zeros(n_hosts, dtype=torch.int32, device=device)
    f = lambda: torch.zeros(n_hosts, dtype=torch.bool, device=device)
    return RouterDownState(
        mode=z(), has_interval_end=f(), interval_end=z(),
        has_drop_next=f(), drop_next=z(), cur_count=z(), prev_count=z(),
        dn_balance=(dn_cap.to(device=device, dtype=torch.int32).clone()
                    if dn_cap is not None else z()),
        dn_last_refill=z(), has_cached=f(), cached_src=z(), cached_seq=z(),
        cached_sock=z(), cached_bytes=z(), resume=z(), dropped=z(),
    )


def rebase_router_state(st: RouterDownState, shift_ns: int, dn_rate,
                        dn_cap) -> RouterDownState:
    """Rebase stored times by the window shift and apply every refill
    boundary that has passed up to the new window start (elapsed clamped
    before multiplying), re-anchoring the bucket into (-1 ms, 0]."""
    lref = st.dn_last_refill - shift_ns
    span = torch.clamp(-lref, min=0)
    num = floordiv(span, MILLISECOND)
    headroom = torch.clamp(dn_cap - st.dn_balance, min=0)
    need = floordiv(headroom + dn_rate - 1, dn_rate)
    balance = dn_cap - torch.clamp(
        headroom - dn_rate * torch.minimum(num, need), min=0)
    lref = torch.clamp(lref, min=0) - floormod(span, MILLISECOND)
    return st._replace(
        interval_end=torch.where(st.has_interval_end,
                                 st.interval_end - shift_ns, st.interval_end),
        drop_next=torch.where(st.has_drop_next, st.drop_next - shift_ns,
                              st.drop_next),
        dn_balance=balance,
        dn_last_refill=lref,
        resume=torch.where(st.has_cached, st.resume - shift_ns, st.resume),
    )

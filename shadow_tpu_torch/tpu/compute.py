"""The device compute plane: per-host service occupancy (`compute_step`).

Counterpart of `shadow_tpu/tpu/compute.py`, bitwise. Each host is one
FIFO service station: a busy-until clock, a bounded queue and a
per-request service cost `svc_ns` from the traffic program's per-(host,
phase) table (`ComputeTables.service_ns`). A window's deliveries are
served in closed form, no per-request loop: with a constant cost s the
completions obey c_j = max(c_{j-1}, a_j) + s, and d_j = c_j - s*j turns
that into a running maximum (`torch.cummax`) over the delivered row,
which is already in FIFO (deliver_rel, src, seq) order. Arrivals the
queue cannot hold are refused from the tail of the window and counted.
Queueing delay and sojourn go into log2 histograms kept in
`ComputeState`.

`compute_step` reads the delivered dict and writes only its
`ComputeState`: the simulation state never sees the plane. The coupling
"a phase advances only when delivery and service are both done" is the
scenario runner's, through `gate_credits`.

Everything is int32 and wraps as the JAX plane's does; the spec compiler
bounds svc_ns * (ingress_cap + queue_cap + 1) inside the int32 budget.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..telemetry import histo
from .prims import I32_MAX, floordiv


class ComputeTables(NamedTuple):
    """The service-cost table (read-only on the device) and the static
    queue bound."""

    service_ns: torch.Tensor  # [N, P] int32
    queue_cap: int


class ComputeState(NamedTuple):
    """Per-host service-station state, axis 0 = host; field order is the
    JAX package's. `busy_rel` is relative to the current window start,
    counters are modular int32, histograms [N, HIST_BUCKETS]."""

    busy_rel: torch.Tensor  # backlog end
    svc_ns: torch.Tensor  # the current phase's service cost
    q_depth: torch.Tensor  # admitted, not complete, at window end
    served_win: torch.Tensor  # completions within the last window
    n_served: torch.Tensor
    n_queued: torch.Tensor  # arrivals that waited
    n_overflow: torch.Tensor  # arrivals refused (queue full)
    n_credit_raw: torch.Tensor  # raw credits offered to the gate
    n_granted: torch.Tensor  # credits the gate granted
    hist_wait_ns: torch.Tensor  # queueing delay
    hist_sojourn_ns: torch.Tensor  # wait + service


def make_compute_tables(service_ns, queue_cap: int, *,
                        device=None) -> ComputeTables:
    """Upload the [N, P] service table (a copy). `queue_cap` must be >=
    1: a queue of none would refuse every arrival that cannot start in
    its own window."""
    if queue_cap < 1:
        raise ValueError(
            f"compute queue_cap={queue_cap} must be >= 1 (a bounded "
            "FIFO needs at least one waiting slot)")
    device = resolve_device(device)
    return ComputeTables(
        service_ns=torch.tensor(np.asarray(service_ns, np.int32),
                                device=device),
        queue_cap=int(queue_cap))


def make_compute_state(ct: ComputeTables) -> ComputeState:
    """Zeroed state, `svc_ns` armed from phase 0's costs (hosts start in
    phase 0), on the tables' device."""
    n = ct.service_ns.shape[0]
    dev = ct.service_ns.device
    z = lambda: torch.zeros(n, dtype=torch.int32, device=dev)
    zb = lambda: torch.zeros((n, histo.HIST_BUCKETS), dtype=torch.int32,
                             device=dev)
    return ComputeState(
        busy_rel=z(), svc_ns=ct.service_ns[:, 0].clone(), q_depth=z(),
        served_win=z(), n_served=z(), n_queued=z(), n_overflow=z(),
        n_credit_raw=z(), n_granted=z(),
        hist_wait_ns=zb(), hist_sojourn_ns=zb())


def _ceil_div(x, y):
    """ceil(x / y) for x >= 0, 0 where y == 0 (a zero-cost host has no
    backlog)."""
    y1 = torch.clamp(y, min=1)
    return torch.where(y > 0, floordiv(x + y1 - 1, y1), 0)


def compute_step(ct: ComputeTables, cs: ComputeState, delivered,
                 shift_ns, window_ns) -> ComputeState:
    """Serve one window's deliveries through each host's FIFO: rebase
    the backlog clock by `shift_ns`; the carried backlog's requests that
    finish inside the window complete; this window's arrivals complete
    at c_j = s*(j+1) + max(busy, cummax_j(a_j - s*j)); if more than
    `queue_cap` admitted requests would be incomplete at window end, the
    window's last arrivals are refused; `served_win` counts this
    window's completions; queueing delay and sojourn of each admitted
    arrival go into the histograms."""
    mask = delivered["mask"]
    s = cs.svc_ns
    sN = s[:, None]
    cap = ct.queue_cap
    win = window_ns
    busy0 = torch.clamp(cs.busy_rel - shift_ns, min=0)

    # the carried backlog: q_depth requests finishing at busy0, busy0 -
    # s, ...; those past the window's end remain
    backlog = torch.clamp(busy0 - win, min=0)
    carried_rem = torch.minimum(cs.q_depth, _ceil_div(backlog, s))
    carried_done = cs.q_depth - carried_rem

    # the closed-form FIFO over this window's arrivals
    a = torch.where(mask, delivered["deliver_rel"], 0)
    k = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1  # service rank
    base = torch.where(mask, a - sN * k, -I32_MAX)
    d = torch.maximum(busy0[:, None], torch.cummax(base, dim=1).values)
    c = d + sN * (k + 1)  # completion (where mask)

    # the bounded queue refuses the tail it cannot hold
    n_arr = mask.sum(dim=1, dtype=torch.int32)
    incomplete = mask & (c > win)
    depth_all = carried_rem + incomplete.sum(dim=1, dtype=torch.int32)
    over = torch.clamp(depth_all - cap, min=0)
    kept = mask & (k < (n_arr - over)[:, None])
    done_now = (kept & (c <= win)).sum(dim=1, dtype=torch.int32)
    busy_end = torch.maximum(
        busy0, torch.where(kept, c, -I32_MAX).amax(dim=1))

    wait = torch.where(kept, c - sN - a, 0)
    sojourn = torch.where(kept, c - a, 0)
    return cs._replace(
        busy_rel=busy_end,
        q_depth=depth_all - over,
        served_win=carried_done + done_now,
        n_served=cs.n_served + carried_done + done_now,
        n_queued=cs.n_queued
        + (kept & (wait > 0)).sum(dim=1, dtype=torch.int32),
        n_overflow=cs.n_overflow + over,
        hist_wait_ns=histo.accum_rows(
            cs.hist_wait_ns, histo.bucket_index(wait), kept),
        hist_sojourn_ns=histo.accum_rows(
            cs.hist_sojourn_ns, histo.bucket_index(sojourn), kept))


def phase_service(ct: ComputeTables, cs: ComputeState,
                  phase) -> ComputeState:
    """Re-arm each host's per-request cost from its current phase's
    table entry (the runner calls it after `workload_step`)."""
    P = ct.service_ns.shape[1]
    idx = torch.clamp(phase, 0, P - 1).to(torch.int64)[:, None]
    return cs._replace(
        svc_ns=torch.gather(ct.service_ns, 1, idx)[:, 0])


def gate_credits(cs: ComputeState, raw_credits):
    """Meter phase credits through service: the k-th credit is granted
    once the k-th network credit and the k-th service completion have
    both happened, granted = min(cum_raw, cum_served), less what was
    granted before. Returns (cs', got)."""
    cum_raw = cs.n_credit_raw + raw_credits
    granted = torch.minimum(cum_raw, cs.n_served)
    return (cs._replace(n_credit_raw=cum_raw, n_granted=granted),
            granted - cs.n_granted)

"""On-device simulation counters of the network plane (`PlaneMetrics`).

Counterpart of `shadow_tpu/telemetry/metrics.py`: the same fields in the
same order, per-host leaves [N] int32 and per-window scalars 0-d int32,
all modular 2**32. `window_step`, `ingest` and `ingest_rows` accumulate
them with tensor adds over values the step has already computed, when a
metrics tuple is passed: nothing feeds back into the simulation state,
and nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device


class PlaneMetrics(NamedTuple):
    """Accumulating device counters; field order is the JAX package's."""

    # per-host traffic
    pkts_out: torch.Tensor  # packets that left the egress gate (sent)
    bytes_out: torch.Tensor  # wire bytes of those packets
    pkts_in: torch.Tensor  # packets delivered to this host
    bytes_in: torch.Tensor  # wire bytes delivered
    # per-host drops, by reason
    drop_ring_full: torch.Tensor  # egress/ingress ring-capacity overflow
    drop_qdisc: torch.Tensor  # router AQM (CoDel) drops
    drop_loss: torch.Tensor  # Bernoulli path-loss samples
    drop_fault: torch.Tensor  # injected fault-plane drops
    # per-host recovery activity (fed by callers; the plane has none)
    retransmits: torch.Tensor
    # per-host queue-depth high-water marks (maxima, not modular)
    max_eg_depth: torch.Tensor
    max_in_depth: torch.Tensor
    # per-window scalars
    windows: torch.Tensor  # window_step calls accumulated
    events: torch.Tensor  # send + deliver events processed
    sort_slots: torch.Tensor  # occupied egress+ingress slots entering
    # the window's sorts


def make_metrics(n_hosts: int, *, device=None) -> PlaneMetrics:
    """A zeroed metrics tuple for `n_hosts` hosts."""
    device = resolve_device(device)
    z = lambda: torch.zeros(n_hosts, dtype=torch.int32, device=device)
    s = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return PlaneMetrics(
        pkts_out=z(), bytes_out=z(), pkts_in=z(), bytes_in=z(),
        drop_ring_full=z(), drop_qdisc=z(), drop_loss=z(), drop_fault=z(),
        retransmits=z(), max_eg_depth=z(), max_in_depth=z(),
        windows=s(), events=s(), sort_slots=s(),
    )


def add_retransmits(metrics: PlaneMetrics,
                    per_host: torch.Tensor) -> PlaneMetrics:
    """Fold per-host retransmission counts into the metrics tuple."""
    return metrics._replace(
        retransmits=metrics.retransmits + per_host.to(torch.int32))


def metric_names() -> tuple[str, ...]:
    """Leaf names in field order."""
    return tuple(PlaneMetrics._fields)

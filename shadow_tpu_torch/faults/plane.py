"""The fault plane's device masks (`FaultArrays`), in PyTorch.

Counterpart of `shadow_tpu/faults/plane.py`. The compiled `faults:`
schedule (`faults/schedule.py`) folds into these masks, which
`tpu/plane.window_step(kernel="xla", faults=)` reads:

- a host with `host_alive` or `link_up` False transmits nothing (its
  queued egress drops, counted at the source) and accepts no new
  routing (packets toward it drop, counted at the destination); what is
  already in its ingress ring still delivers;
- `lat_mult[src_node, dst_node]` (int >= 1) multiplies path latency;
- `bw_div[host]` (>= 1) divides the egress token refill rate;
- `corrupt_p[host]` drops the host's outbound data packets with that
  probability, drawn from a counter stream of its own (host index + N),
  so the loss stream is untouched.

Neutral masks (`neutral_faults`) leave the step bitwise as
`faults=None` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device


class FaultArrays(NamedTuple):
    """The fault masks one window runs under."""

    host_alive: torch.Tensor  # [N] bool
    link_up: torch.Tensor  # [N] bool
    lat_mult: torch.Tensor  # [M, M] int32 >= 1
    bw_div: torch.Tensor  # [N] int32 >= 1
    corrupt_p: torch.Tensor  # [N] float32


def neutral_faults(n_hosts: int, n_nodes: int | None = None, *,
                   device=None) -> FaultArrays:
    """Every host alive and up, multiplier and divisor 1, no corruption."""
    device = resolve_device(device)
    m = n_nodes if n_nodes is not None else n_hosts
    return FaultArrays(
        host_alive=torch.ones(n_hosts, dtype=torch.bool, device=device),
        link_up=torch.ones(n_hosts, dtype=torch.bool, device=device),
        lat_mult=torch.ones(m, m, dtype=torch.int32, device=device),
        bw_div=torch.ones(n_hosts, dtype=torch.int32, device=device),
        corrupt_p=torch.zeros(n_hosts, dtype=torch.float32, device=device),
    )


def faults_from_numpy(host_alive, link_up, lat_mult, bw_div, corrupt_p, *,
                      device=None) -> FaultArrays:
    """Upload a schedule's numpy mask state. Each array is copied (never
    `torch.from_numpy`, which aliases): the schedule mutates its masks in
    place on its next `advance`, and that must not reach a window
    already given these."""
    device = resolve_device(device)
    up = lambda a, dt: torch.tensor(np.array(a, dtype=dt, copy=True),
                                    device=device)
    return FaultArrays(
        host_alive=up(host_alive, bool),
        link_up=up(link_up, bool),
        lat_mult=up(lat_mult, np.int32),
        bw_div=up(bw_div, np.int32),
        corrupt_p=up(corrupt_p, np.float32),
    )

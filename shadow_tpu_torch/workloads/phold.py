"""The PHOLD respawn generator (counterpart of
`shadow_tpu/workloads/phold.py`)."""

from __future__ import annotations

import torch

from ..tpu.prims import floormod, wrap_i32


def respawn_batch(delivered, spawn_seq, round_idx: int, n_hosts: int,
                  ingress_cap: int):
    """Each delivered packet spawns one new packet from the receiving
    host to a hashed destination; the respawned seq is the packet's rank
    among the row's due lanes, so the stream does not depend on the ring
    capacity. The int32 hash `src*40503 + seq*1566083941 + round*97`
    wraps like the JAX plane's (computed in int64, wrapped once) before
    the floor modulo. `n_hosts` is the fleet's host count, the modulus;
    the rows may be a host-axis mesh rank's (`delivered["src"]` then
    holds global hosts). Returns (valid_mask, dst, nbytes, seq, ctrl),
    all [rows, CI]."""
    mask = delivered["mask"]
    h = (delivered["src"].to(torch.int64) * 40503
         + delivered["seq"].to(torch.int64) * 1566083941 + round_idx * 97)
    dst = floormod(wrap_i32(h), n_hosts)
    rank = torch.where(
        mask, torch.cumsum(mask, dim=1, dtype=torch.int32) - 1, 0)
    seq = spawn_seq[:, None] + rank
    rows = mask.shape[0]
    nbytes = torch.full((rows, ingress_cap), 1400, dtype=torch.int32,
                        device=mask.device)
    ctrl = torch.zeros((rows, ingress_cap), dtype=torch.bool,
                       device=mask.device)
    return mask, dst, nbytes, seq, ctrl

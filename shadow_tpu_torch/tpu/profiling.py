"""The PHOLD bench world (counterpart of `shadow_tpu/tpu/profiling.py`
`build_world`)."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .plane import ingest, make_params, make_state, window_step
from .prims import floormod, wrap_i32

MS = 1_000_000
# the JAX bench's root key is jax.random.key(1)
RNG_SEED = 1


def build_world(n_hosts: int, *, n_nodes: int = 64, egress_cap: int = 16,
                ingress_cap: int = 32, seed: int = 0,
                warmup_windows: int = 3, down_bw_bps: int | None = None,
                seed_packets: int = 4, device=None) -> dict:
    """The bench.py PHOLD world: node-level path tables from `seed`,
    `seed_packets` packets of 1400 B per host to hashed destinations
    appended by the flat `ingest`, then `warmup_windows` full windows.

    `down_bw_bps` (bits/s, None: unlimited, as in the JAX bench) gives
    every host that downlink and starts its relay bucket full: the
    world of the router AQM (`window_step(router_aqm=True)`)."""
    device = resolve_device(device)
    N, M = n_hosts, n_nodes
    rng = np.random.default_rng(seed)
    lat = rng.integers(1 * MS, 50 * MS, size=(M, M), dtype=np.int32)
    lat = np.minimum(lat, lat.T)
    loss = np.full((M, M), 0.01, np.float32)
    host_node = (np.arange(N) % M).astype(np.int32)
    bw = np.full((N,), 10_000_000_000, np.int64)
    params = make_params(
        lat, loss, bw, host_node=host_node, device=device,
        down_bw_bps=None if down_bw_bps is None else np.full(N, down_bw_bps))
    state = make_state(N, egress_cap=egress_cap, ingress_cap=ingress_cap,
                       initial_tokens=params.tb_cap,
                       initial_dn_tokens=(None if down_bw_bps is None
                                          else params.dn_cap), device=device)
    k = seed_packets
    i64 = dict(dtype=torch.int64, device=device)
    src0 = torch.arange(N, **i64).repeat_interleave(k)
    dst0 = floormod(wrap_i32(src0 * 1566083941
                             + torch.arange(k, **i64).repeat(N) * 40503
                             + 1), N)
    b0 = src0.shape[0]
    ids = torch.arange(b0, dtype=torch.int32, device=device)
    state = ingest(state, src0.to(torch.int32), dst0,
                   torch.full((b0,), 1400, dtype=torch.int32, device=device),
                   ids, ids, torch.zeros(b0, dtype=torch.bool, device=device))
    window = 10 * MS
    shift = 0
    delivered = None
    for _ in range(warmup_windows):
        state, delivered, _next = window_step(
            state, params, RNG_SEED, shift, window, rr_enabled=False,
            kernel="pallas_fused")
        shift = window
    return {
        "state": state, "params": params, "rng_root": RNG_SEED,
        "shift": window, "window": window, "delivered": delivered,
        "egress_cap": egress_cap, "ingress_cap": ingress_cap,
    }

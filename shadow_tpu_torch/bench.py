"""PHOLD device-plane throughput: the port's twin of `bench.py`'s fixed-
capacity solo run.

Every round is `window_step` (FIFO) + the PHOLD respawn + `ingest_rows`,
driven in chains by `tpu/elastic.drive_chained_windows`. The metric is
`packet_events_per_sec`, counted as `bench.py` counts it: (delivered +
sent packets) over the wall seconds of a timed run, after one untimed
run that builds the kernels and warms the card up.
"""

from __future__ import annotations

import time

import torch

from . import resolve_device
from .tpu import pipeline
from .tpu.elastic import drive_chained_windows
from .tpu.plane import ingest_rows, window_step
from .tpu.profiling import build_world
from .workloads.phold import respawn_batch

# final-state digest (convert.state_digest) of the PHOLD world at
# GOLDEN_PHOLD's size after its rounds; tests pin it against the JAX
# package's window_step(kernel="pallas_fused") run of the same world
GOLDEN_PHOLD = dict(n_hosts=1024, n_nodes=64, egress_cap=16, ingress_cap=32,
                    rounds=16)
GOLDEN_PHOLD_DIGEST = (
    "3997ae828b6430c7919a8a864ba9c9c978dcfaa218c7d2f9145cbcf8fdbfed60")
SPAWN_SEQ0 = 10_000


def phold_chain_fn(world: dict, *, plain_kernels: bool = False):
    """The bench's chain body: windows r0..r1-1 of the PHOLD closed loop
    on `world`, with one host read (the chain's delivered count) at the
    end. extras = (spawn_seq [N] int32, delivered total int)."""
    params, seed, window = world["params"], world["rng_root"], world["window"]

    def chain_fn(state, extras, r0, r1):
        spawn_seq, total = extras
        N, CI = state.in_src.shape
        n_delivered = torch.zeros((), dtype=torch.int64,
                                  device=spawn_seq.device)
        for r in range(r0, r1):
            state, delivered, _next = window_step(
                state, params, seed, 0 if r == 0 else window, window,
                rr_enabled=False, plain_kernels=plain_kernels)
            mask, dst, nbytes, seq, ctrl = respawn_batch(
                delivered, spawn_seq, r, N, CI)
            state = ingest_rows(state, dst, nbytes, seq, seq, ctrl, mask)
            spawn_seq = spawn_seq + mask.sum(dim=1, dtype=torch.int32)
            n_delivered = n_delivered + mask.sum()
        return state, (spawn_seq, total + int(n_delivered))
    return chain_fn


def run_chain(world: dict, rounds: int, chain_len: int | None = None, *,
              plain_kernels: bool = False):
    """Drive `rounds` PHOLD windows on `world`; returns (final state,
    delivered total)."""
    state = world["state"]
    spawn_seq = torch.full((state.in_src.shape[0],), SPAWN_SEQ0,
                           dtype=torch.int32, device=state.in_src.device)
    state, (_spawn, total) = drive_chained_windows(
        state, (spawn_seq, 0), phold_chain_fn(world,
                                              plain_kernels=plain_kernels),
        n_rounds=rounds, chain_len=chain_len or rounds)
    return state, total


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_phold(n_hosts: int = 32768, n_nodes: int = 64, egress_cap: int = 16,
              ingress_cap: int = 32, rounds: int = 192,
              chain_len: int | None = None, *, device=None,
              warmup: bool = True, plain_kernels: bool = False) -> dict:
    """The PHOLD closed loop at the bench's size, seed 0 as in `bench.py`.
    With `warmup`, one untimed run builds and warms up before the timed
    one. Returns the final state, the delivered and sent totals, the timed
    run's wall seconds and packet_events_per_sec."""
    device = resolve_device(device)
    size = dict(n_nodes=n_nodes, egress_cap=egress_cap,
                ingress_cap=ingress_cap, seed=0, warmup_windows=0,
                device=device)
    if warmup:
        run_chain(build_world(n_hosts, **size), rounds, chain_len,
                  plain_kernels=plain_kernels)
    world = build_world(n_hosts, **size)
    _sync(device)
    t0 = time.perf_counter()
    state, delivered = run_chain(world, rounds, chain_len,
                                 plain_kernels=plain_kernels)
    _sync(device)
    wall = time.perf_counter() - t0
    sent = int(state.n_sent.sum())
    return {
        "state": state, "delivered": delivered, "sent": sent,
        "events": delivered + sent, "wall_s": wall,
        "packet_events_per_sec": (delivered + sent) / wall,
        "n_hosts": n_hosts, "rounds": rounds,
        "chain_len": chain_len or rounds, "device": str(device),
    }


def profile_windows(n_hosts: int = 32768, windows: int = 16, *,
                    n_nodes: int = 64, egress_cap: int = 16,
                    ingress_cap: int = 32, device=None, top: int = 15) -> dict:
    """Where a PHOLD window's time goes on the card: `windows` windows
    after as many warm-up windows, timed bare (wall per window), then
    again under torch.profiler (device kernels by name, kernel launches
    per window, and the device's busy share of the bare wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("profile_windows measures the card: device must "
                         "be CUDA")
    world = build_world(n_hosts, n_nodes=n_nodes, egress_cap=egress_cap,
                        ingress_cap=ingress_cap, warmup_windows=0,
                        device=device)
    chain = phold_chain_fn(world)
    spawn_seq = torch.full((n_hosts,), SPAWN_SEQ0, dtype=torch.int32,
                           device=device)
    state, extras = chain(world["state"], (spawn_seq, 0), 0, windows)
    _sync(device)
    t0 = time.perf_counter()
    state, extras = chain(state, extras, windows, 2 * windows)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / windows
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, extras = chain(state, extras, 2 * windows, 3 * windows)
        _sync(device)
    kernels: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernels.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    busy_ms = sum(sum(v) for v in kernels.values()) / 1e3 / windows
    by_time = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))
    return {
        "n_hosts": n_hosts, "windows": windows, "wall_ms_per_window": wall_ms,
        "device_busy_ms_per_window": busy_ms,
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "kernel_launches_per_window": sum(map(len, kernels.values()))
        / windows,
        "top_kernels": [
            {"name": name[:120], "count_per_window": len(v) / windows,
             "ms_per_window": sum(v) / 1e3 / windows,
             "us_per_launch": sum(v) / len(v)}
            for name, v in by_time[:top]],
        # the port's own CUDA kernels, wherever they rank
        "port_kernels": [
            {"name": name, "count_per_window": len(v) / windows,
             "us_per_launch": sum(v) / len(v)}
            for name, v in kernels.items()
            if any(k in name for k in pipeline.LAUNCHES)],
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="WINDOWS",
                    help="also profile this many windows on the card")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    res = run_phold()
    rec = {k: v for k, v in res.items() if k != "state"}
    if torch.cuda.is_available():
        rec["gpu"] = torch.cuda.get_device_name(0)
    if args.profile:
        rec["profile"] = profile_windows(windows=args.profile)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()

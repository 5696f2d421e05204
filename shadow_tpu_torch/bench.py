"""PHOLD device-plane throughput: the port's twin of `bench.py`'s solo run.

Every round is `window_step` (FIFO, kernel "pallas_fused" or "pallas",
a CUDA kernel pair, or "xla", the plain PyTorch step that is the JAX
bench's default) + the PHOLD respawn + `ingest_rows`, driven in chains by
`tpu/elastic.drive_chained_windows`, under the capacity policy "fixed",
"strict" or "elastic" as `bench.py`'s BENCH_CAPACITY. The metric is
`packet_events_per_sec`, counted as `bench.py` counts it: (delivered +
sent packets) over the wall seconds of a timed run, after one untimed
run that builds the kernels and warms the card up.

    python -m shadow_tpu_torch.bench [--kernel pallas_fused|pallas|xla]
        [--capacity fixed|strict|elastic] [--egress-cap CE]
        [--ingress-cap CI] [--max-doublings K] [--grow-every R]
        [--profile WINDOWS] [--telemetry DIR [--hist]
        [--harvest-every K]] [--trace PATH] [--memo] [--worlds W]
        [--faults] [--no-sections] [--out FILE]

`--telemetry DIR`, `--hist`, `--harvest-every K` and `--trace PATH` are
the JAX bench's BENCH_TELEMETRY, BENCH_HIST, BENCH_HARVEST_EVERY and
BENCH_TRACE modes; `--memo` its BENCH_MEMO rep (`run_memo`), `--worlds
W` its BENCH_WORLDS rep (`run_worlds`: W worlds of the bench world
through `elastic.drive_ensemble`, kernel "xla"; with `--trace PATH` its
ledger goes to `PATH.worlds.jsonl`); `--faults` its BENCH_FAULTS mode
(neutral `FaultArrays` through every window, kernel "xla" only: the
Pallas kernels do not fuse the fault plane, and the port never falls
back to another kernel). After the timed run one profiled rep of each of
`profiling.BENCH_SECTIONS` (reps=1) is recorded as `sections` (section
-> min ms, plus the driver's `windows_per_sync`) when the kernel is
"xla", as the JAX bench records it; `--no-sections` is its
BENCH_SECTIONS=0.

The JSON line carries the JAX record's keys `metric`
("packet_events_per_sec"), `value`, `unit`, `backend` (the device
fingerprint, `telemetry/tracer.backend_fingerprint`), `hosts`, `kernel`
(with `faults_threaded`), `driver`, `capacity`, `telemetry`, `worlds`,
`memo` and `sections`, so `tools/compare_runs.py --bench` diffs two of
them (and prints its mismatched-backend banner against a TPU record).
It leaves out `vs_baseline`, `compiled_events_per_sec`, `vs_compiled`
and `prior_round`: the first two need the CPU object plane and the C++
microbench, which the port does not have (it is the device side only),
and `prior_round` compares with the `BENCH_r*.json` records, which were
measured on a TPU. Beside them it keeps its own keys (the events, the
wall seconds, the device, `state_digest`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from . import resolve_device
from .core.capacity import CAPACITY_MODES
from .faults import runstate
from .faults.plane import neutral_faults
from .telemetry import export, histo
from .telemetry.harvest import TelemetryHarvester
from .telemetry.metrics import make_metrics
from .telemetry.tracer import RunTracer, backend_fingerprint
from .tpu import pipeline, profiling
from .tpu.elastic import (RingPolicy, chain_spans, drive_chained_windows,
                          drive_ensemble, stack_worlds, world_keys)
from .tpu.mesh import shard_state, shard_tree
from .tpu.plane import KERNELS, ingest_rows, unpack_planes, window_step
from .tpu.profiling import build_world
from .workloads.phold import respawn_batch

# final-state digest (convert.state_digest) of the PHOLD world at
# GOLDEN_PHOLD's size after its rounds; tests pin it against the JAX
# package's window_step run of the same world (its "pallas_fused",
# "pallas" and "xla" kernels agree bitwise)
GOLDEN_PHOLD = dict(n_hosts=1024, n_nodes=64, egress_cap=16, ingress_cap=32,
                    rounds=16)
GOLDEN_PHOLD_DIGEST = (
    "3997ae828b6430c7919a8a864ba9c9c978dcfaa218c7d2f9145cbcf8fdbfed60")
SPAWN_SEQ0 = 10_000
# torch.profiler range over each window's routing stage (profile_windows)
ROUTING_STAGE = "routing_stage"


def _phold_round(state, params, seed, r: int, window: int, spawn_seq, *,
                 kernel: str, plain_kernels: bool, metrics=None, hist=None,
                 faults=None, mesh=None):
    """Window r of the PHOLD closed loop: `window_step` under `seed` (an
    int seed or a key tensor) with `faults` (`FaultArrays`, or None), the
    respawn of what it delivered, and its append; under a host-axis
    `mesh` on the rank's rows. Returns (state', spawn_seq', the respawn
    mask [N, CI], the ingress ring's drops [N] in the routing stage, the
    egress ring's in the append, metrics', hist')."""
    N, CI = state.in_src.shape
    dropped = state.n_overflow_dropped
    out = window_step(
        state, params, seed, 0 if r == 0 else window, window,
        rr_enabled=False, kernel=kernel, plain_kernels=plain_kernels,
        faults=faults, metrics=metrics, hist=hist, mesh=mesh)
    (state, delivered, _next), metrics, _g, hist, _f = unpack_planes(
        out, metrics=metrics, hist=hist)
    in_drops = state.n_overflow_dropped - dropped
    dropped = state.n_overflow_dropped
    mask, dst, nbytes, seq, ctrl = respawn_batch(
        delivered, spawn_seq, r, N if mesh is None else N * mesh.size, CI)
    out = ingest_rows(state, dst, nbytes, seq, seq, ctrl, mask,
                      metrics=metrics, hist=hist, mesh=mesh)
    (state,), metrics, _g, hist, _f = unpack_planes(
        out, metrics=metrics, hist=hist, n_lead=1)
    eg_drops = state.n_overflow_dropped - dropped
    spawn_seq = spawn_seq + mask.sum(dim=1, dtype=torch.int32)
    return state, spawn_seq, mask, in_drops, eg_drops, metrics, hist


def phold_chain_fn(world: dict, *, kernel: str = "pallas_fused",
                   plain_kernels: bool = False, faults=None, mesh=None):
    """The bench's chain body: windows r0..r1-1 of the PHOLD closed loop,
    with one host read (the chain's delivered count) at the end. extras
    = (spawn_seq [N] int32, delivered total int[, metrics[, hist]]): a
    `PlaneMetrics` third element and a `PlaneHistograms` fourth ride
    `window_step` and `ingest_rows`, as the JAX bench's telemetry run
    threads them; `faults` (`FaultArrays`) rides every window. Returns
    the driver's 4-tuple; the overflows are each
    ring's drops over the chain, the egress ring's from the respawn
    append and the ingress ring's from the routing stage, as
    `bench.py`'s round body accumulates them. Under a host-axis `mesh`
    the state is the rank's rows and the delivered total the fleet's."""
    params, seed, window = world["params"], world["rng_root"], world["window"]

    def chain_fn(state, extras, r0, r1):
        spawn_seq, total, *planes = extras
        metrics = planes[0] if planes else None
        hist = planes[1] if len(planes) > 1 else None
        N = state.in_src.shape[0]
        zeros = lambda dt: torch.zeros(N, dtype=dt, device=spawn_seq.device)
        n_delivered = zeros(torch.int64).sum()
        eg_acc, in_acc = zeros(torch.int32), zeros(torch.int32)
        for r in range(r0, r1):
            (state, spawn_seq, mask, in_drops, eg_drops, metrics,
             hist) = _phold_round(state, params, seed, r, window, spawn_seq,
                                  kernel=kernel, plain_kernels=plain_kernels,
                                  metrics=metrics, hist=hist, faults=faults,
                                  mesh=mesh)
            in_acc = in_acc + in_drops
            eg_acc = eg_acc + eg_drops
            n_delivered = n_delivered + mask.sum()
        if mesh is not None:
            n_delivered = mesh.all_sum(n_delivered)
        extras = (spawn_seq, total + int(n_delivered),
                  *(metrics, hist)[:len(planes)])
        return state, extras, eg_acc, in_acc
    return chain_fn


def phold_keyed_chain_fn(world: dict, *, kernel: str = "xla"):
    """The PHOLD chain with its key in the carry, the JAX bench's worlds
    chain: extras = (key [2] int64, spawn_seq [N] int32, delivered total
    0-d int32), every window drawn under that key, and nothing read back
    to the host, so `elastic.drive_ensemble` vmaps it over worlds (each
    with its `world_keys` key) as `drive_chained_windows` drives it solo.
    Returns the driver's 4-tuple, the overflows as `phold_chain_fn`'s."""
    params, window = world["params"], world["window"]

    def chain_fn(state, extras, r0, r1):
        key, spawn_seq, total = extras
        eg_acc = torch.zeros_like(spawn_seq)
        in_acc = torch.zeros_like(spawn_seq)
        for r in range(r0, r1):
            state, spawn_seq, mask, in_drops, eg_drops, _m, _h = \
                _phold_round(state, params, key, r, window, spawn_seq,
                             kernel=kernel, plain_kernels=False)
            in_acc = in_acc + in_drops
            eg_acc = eg_acc + eg_drops
            total = total + mask.sum(dtype=torch.int32)
        return state, (key, spawn_seq, total), eg_acc, in_acc
    return chain_fn


def run_chain(world: dict, rounds: int, chain_len: int | None = None, *,
              kernel: str = "pallas_fused", plain_kernels: bool = False,
              policy: RingPolicy | None = None, metrics=None, hist=None,
              on_chain=None, tracer=None, checkpointer=None,
              resume_from: str | None = None, faults=None, mesh=None):
    """Drive `rounds` PHOLD windows on `world`, under `policy` when one
    is given, with `metrics` (a `PlaneMetrics`), `hist` (a
    `PlaneHistograms`, with metrics) and `faults` (a `FaultArrays`)
    threaded when given; returns (final
    state, delivered total[, metrics'[, hist']]). `on_chain`, `tracer` and
    `checkpointer` go to the driver; `resume_from` (a
    runstate checkpoint of this run) starts at its round, from its
    carry. Under a host-axis `mesh` the world and the planes are the
    rank's part (`tpu/mesh.shard_state`)."""
    if hist is not None and metrics is None:
        raise ValueError("hist rides the bench chain with metrics only")
    state = world["state"]
    spawn_seq = torch.full((state.in_src.shape[0],), SPAWN_SEQ0,
                           dtype=torch.int32, device=state.in_src.device)
    planes = ((metrics,) if metrics is not None else ()) + (
        (hist,) if hist is not None else ())
    extras = (spawn_seq, 0, *planes)
    start = 0
    if resume_from is not None:
        res = runstate.resume_carry(resume_from, (state, extras))
        state, extras = res["carry"]
        start = res["round"]
    state, (_spawn, total, *planes) = drive_chained_windows(
        state, extras,
        phold_chain_fn(world, kernel=kernel, plain_kernels=plain_kernels,
                       faults=faults, mesh=mesh),
        n_rounds=rounds, chain_len=chain_len or rounds, policy=policy,
        window_ns=world["window"], start_round=start, on_chain=on_chain,
        tracer=tracer, checkpointer=checkpointer, mesh=mesh)
    return (state, total, *planes)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_phold(n_hosts: int = 32768, n_nodes: int = 64, egress_cap: int = 16,
              ingress_cap: int = 32, rounds: int = 192,
              chain_len: int | None = None, *, kernel: str = "pallas_fused",
              capacity: str = "fixed", max_doublings: int = 4,
              grow_every: int = 16, device=None, warmup: bool = True,
              plain_kernels: bool = False, metrics: bool = False,
              telemetry: str | None = None, hist: bool = False,
              harvest_every: int = 32, trace: str | None = None,
              on_chain=None, faults: bool = False, mesh=None) -> dict:
    """The PHOLD closed loop at the bench's size, seed 0 as in `bench.py`.
    Under capacity "strict" or "elastic" the chains are `grow_every`
    windows long (the growth-decision unit) and a fresh `RingPolicy`
    starts from (egress_cap, ingress_cap) in each run. With `warmup`, one
    untimed run builds and warms up before the timed one. `metrics`
    threads a `PlaneMetrics` through the timed run's windows and appends
    (the tuple is `metrics` in the result).

    `telemetry=DIR` (the JAX bench's BENCH_TELEMETRY) threads the metrics
    and harvests them every `harvest_every` windows (the chain length)
    into `DIR/heartbeats.jsonl`, with a Perfetto trace `DIR/trace.json`
    after the run; `hist` adds the log2 histograms (on "xla" only: the
    JAX step refuses them on its Pallas kernels, and the port runs no
    other kernel than the one asked for). `trace=PATH` writes the timed
    run's ledger (`telemetry/tracer.RunTracer`). Both ride the timed run
    only, inside its wall time. `on_chain(r1, state, extras)` is called
    on the host after each chain of the timed run, after its harvest, as
    `drive_chained_windows` calls it. `faults` (the JAX bench's
    BENCH_FAULTS) threads neutral `FaultArrays` through every window of
    both runs: the fault plane's cost when nothing fails, its state
    unchanged ("xla" only; ValueError on the Pallas kernels, which the
    JAX step refuses too and from which the port does not fall back).

    `mesh` (a `tpu/mesh.Mesh`, one call on every rank) runs the world
    sharded along the host axis: each rank builds the world, keeps its
    rows (`shard_state`) and drives them with `window_step(mesh=)`, on
    the mesh's device; the state returned is the rank's part
    (`tpu/mesh.gather_state` gives the whole), the delivered and sent totals
    the fleet's. The telemetry harvester and the run ledger are refused
    under a mesh (their host reads would see one rank's rows).

    Returns the final state, the delivered and sent totals, the timed
    run's wall seconds and packet_events_per_sec, the kernel, capacity,
    driver and telemetry records of `bench.py`'s JSON, and `faults`."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel: expected one of {KERNELS}, got {kernel!r}")
    if capacity not in CAPACITY_MODES:
        raise ValueError(f"capacity: expected one of {CAPACITY_MODES}, "
                         f"got {capacity!r}")
    if hist and not telemetry:
        raise ValueError("hist threads the histograms of a telemetry run: "
                         "pass telemetry=DIR too")
    if hist and kernel != "xla":
        raise ValueError(
            f"hist: kernel={kernel!r} does not fuse the histogram plane "
            "(nor does the JAX step's); use kernel='xla'")
    if faults and kernel != "xla":
        raise ValueError(
            f"faults: kernel={kernel!r} does not fuse the fault plane (nor "
            "does the JAX step's), and the port runs no other kernel than "
            "the one asked for; use kernel='xla'")
    if telemetry and capacity != "fixed":
        raise ValueError("telemetry and capacity strict/elastic each own "
                         "the chain cadence; run them separately")
    if mesh is not None and (telemetry or trace):
        raise ValueError("telemetry and trace do not run under a host-axis "
                         "mesh: their host reads would see one rank's rows")
    device = resolve_device(device) if mesh is None else mesh.device
    size = dict(n_nodes=n_nodes, egress_cap=egress_cap,
                ingress_cap=ingress_cap, seed=0, warmup_windows=0,
                device=device)
    chain_len = chain_len or (harvest_every if telemetry else grow_every
                              if capacity != "fixed" else rounds)
    make_policy = lambda: (None if capacity == "fixed" else RingPolicy(
        mode=capacity, max_doublings=max_doublings, egress_cap=egress_cap,
        ingress_cap=ingress_cap, plane="bench"))
    with_metrics = metrics or bool(telemetry)
    fault_arrays = (neutral_faults(n_hosts, n_nodes, device=device)
                    if faults else None)
    shard = lambda tree: (tree if mesh is None or tree is None
                          else shard_tree(tree, mesh, n_hosts))
    run = lambda world, policy, **kw: run_chain(
        world, rounds, chain_len, kernel=kernel,
        plain_kernels=plain_kernels, policy=policy, faults=fault_arrays,
        metrics=shard(make_metrics(n_hosts, device=device))
        if with_metrics else None,
        hist=shard(histo.make_histograms(n_hosts, device=device)) if hist
        else None, mesh=mesh, **kw)

    def make_world():
        world = build_world(n_hosts, **size)
        if mesh is not None:
            world["state"], world["params"] = shard_state(
                world["state"], world["params"], mesh)
        return world

    if warmup:
        run(make_world(), make_policy())
    world, policy = make_world(), make_policy()
    harvester = tracer = None
    if telemetry:
        os.makedirs(telemetry, exist_ok=True)
        harvester = TelemetryHarvester(
            interval_ns=harvest_every * world["window"],
            sink=os.path.join(telemetry, "heartbeats.jsonl"),
            slot_capacity=n_hosts * (egress_cap + ingress_cap))
    if trace:
        tracer = RunTracer(
            "bench", backend=backend_fingerprint(device),
            meta={"hosts": n_hosts, "rounds": rounds,
                  "chain_len": chain_len, "kernel": kernel,
                  "capacity": capacity, "telemetry": bool(telemetry)})

    def after_chain(r1, state, extras):
        if harvester is not None:
            if tracer is not None:
                tracer.annotate("harvest", r=int(r1),
                                time_ns=int(r1) * world["window"])
            _spawn, _total, m, *h = extras
            harvester.tick(r1 * world["window"],
                           device=dict(m._asdict(), **h[0]._asdict()) if h
                           else m)
        return None if on_chain is None else on_chain(r1, state, extras)

    _sync(device)
    t0 = time.perf_counter()
    state, delivered, *planes = run(
        world, policy, tracer=tracer,
        on_chain=(after_chain if harvester is not None
                  or on_chain is not None else None))
    _sync(device)
    wall = time.perf_counter() - t0
    telemetry_info = None
    if harvester is not None:
        harvester.finalize()
        tr = export.write_perfetto_trace(
            harvester.heartbeats, os.path.join(telemetry, "trace.json"))
        telemetry_info = {"heartbeats": harvester.emitted,
                          "harvests": harvester.harvests,
                          "sink": harvester.sink_path, "trace": tr["path"],
                          "trace_events": tr["events"]}
        if hist:
            telemetry_info["latency"] = {
                name[len(histo.HIST_PREFIX):]: histo.fleet_percentiles(t)
                for name, t in planes[1]._asdict().items()}
    if tracer is not None:
        tracer.close(wall_s=round(wall, 6))
        tracer.write(trace)
    sent = state.n_sent.sum(dtype=torch.int64)
    sent = int(sent if mesh is None else mesh.all_sum(sent))
    capacity_info = None
    if policy is not None:
        capacity_info = policy.trajectory.as_dict()
        capacity_info["initial"] = {"egress_cap": egress_cap,
                                    "ingress_cap": ingress_cap}
        capacity_info["final"] = {"egress_cap": policy.egress_cap,
                                  "ingress_cap": policy.ingress_cap}
    n_chains = len(chain_spans(rounds, chain_len))
    return {
        "state": state, "metrics": planes[0] if planes else None,
        "hist": planes[1] if len(planes) > 1 else None,
        "delivered": delivered, "sent": sent,
        "events": delivered + sent, "wall_s": wall,
        "packet_events_per_sec": (delivered + sent) / wall,
        "n_hosts": n_hosts, "rounds": rounds, "chain_len": chain_len,
        "device": str(device),
        # no fallback: the kernel pair asked for is the one that ran
        "kernel": {"requested": kernel, "used": kernel},
        "faults": faults,
        "capacity": capacity_info,
        "driver": {"loop": "drive_chained_windows", "chain_len": chain_len,
                   "chains": n_chains,
                   "windows_per_sync": rounds / max(n_chains, 1)},
        "telemetry": telemetry_info,
        "trace": trace,
        "mesh": None if mesh is None else {
            "ranks": mesh.size, "rank": mesh.rank, "backend": mesh.backend,
            "hosts_local": mesh.host_range(n_hosts)[1]},
    }


def run_worlds(n_worlds: int, n_hosts: int = 32768, n_nodes: int = 64,
               egress_cap: int = 16, ingress_cap: int = 32,
               rounds: int = 192, chain_len: int | None = None, *,
               kernel: str = "xla", solo_rate: float | None = None,
               device=None,
               warmup: bool = True, trace: str | None = None,
               on_chain=None) -> dict:
    """The JAX bench's BENCH_WORLDS rep: the keyed PHOLD chain
    (`phold_keyed_chain_fn`) over `n_worlds` worlds through
    `elastic.drive_ensemble`, each world the bench world (seed 0) under
    its `world_keys` key (worlds 0..W-1 of the world's root key), one
    host read a chain for the whole ensemble, fixed capacity, in chains
    of `chain_len` (all `rounds` by default). With `warmup`, one untimed
    run first, then the timed run on a fresh world. `trace=PATH` writes
    the timed run's ledger (one `ensemble` span a chain) to
    `PATH.worlds.jsonl`; `on_chain` goes to the driver.

    Returns JAX's `worlds` record (n_worlds, driver, chain_len, events,
    min_world_events, events_per_sec_sum: the ensemble's delivered +
    sent packets over the timed wall seconds, and amortization_vs_solo:
    that over `solo_rate`, the events/s of one solo run, None without
    it), with the kernel, the wall seconds, each world's events and
    the device beside it; "states" and "extras" hold the batched end
    carry."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel: expected one of {KERNELS}, got {kernel!r}")
    if n_worlds < 1:
        raise ValueError(f"n_worlds must be >= 1, got {n_worlds}")
    device = resolve_device(device)
    chain_len = chain_len or rounds
    size = dict(n_nodes=n_nodes, egress_cap=egress_cap,
                ingress_cap=ingress_cap, seed=0, warmup_windows=0,
                device=device)
    chain = phold_keyed_chain_fn(build_world(n_hosts, **size),
                                 kernel=kernel)

    def run(world, tracer=None, hook=None):
        keys = world_keys(world["rng_root"], range(n_worlds), device=device)
        extras = (keys, torch.full((n_worlds, n_hosts), SPAWN_SEQ0,
                                   dtype=torch.int32, device=device),
                  torch.zeros(n_worlds, dtype=torch.int32, device=device))
        return drive_ensemble(stack_worlds(world["state"], n_worlds), extras,
                              chain, n_rounds=rounds, chain_len=chain_len,
                              tracer=tracer, on_chain=hook)

    if warmup:
        run(build_world(n_hosts, **size))
    world = build_world(n_hosts, **size)
    tracer = None
    if trace:
        tracer = RunTracer(
            "bench-worlds", backend=backend_fingerprint(device),
            meta={"worlds": n_worlds, "hosts": n_hosts, "rounds": rounds,
                  "chain_len": chain_len, "kernel": kernel})
    _sync(device)
    t0 = time.perf_counter()
    states, extras = run(world, tracer, on_chain)
    per_world = (extras[2].to(torch.int64)
                 + states.n_sent.sum(dim=1, dtype=torch.int64)).tolist()
    wall = time.perf_counter() - t0
    if tracer is not None:
        tracer.close(wall_s=round(wall, 6))
        tracer.write(trace + ".worlds.jsonl")
    events = sum(per_world)
    rate = events / wall
    return {
        "n_worlds": n_worlds, "driver": "drive_ensemble",
        "chain_len": chain_len, "events": events,
        "min_world_events": min(per_world),
        "events_per_sec_sum": rate,
        # the ensemble's summed rate over one solo run's: above 1, the
        # world axis buys throughput that W solo runs in turn would not
        "amortization_vs_solo": (rate / solo_rate if solo_rate else None),
        "kernel": kernel, "wall_s": wall, "world_events": per_world,
        "rounds": rounds, "n_hosts": n_hosts, "device": str(device),
        "states": states, "extras": extras,
    }


def run_memo(hosts: int = 16, windows: int = 4096, chain_len: int = 64, *,
             device=None) -> dict:
    """The JAX bench's BENCH_MEMO rep: a `hosts`-host ring allreduce
    driven for `windows` windows (the collective ends early and the
    drained tail dominates), cold and then memoized, through one chain
    body at the same span length, after a warm-up pass of one chain. The
    memo table is built inside the timed memoized run, so its keys and
    records are in its time. Returns both wall times, the windows/s and
    effective events/s of each (same event total), the memo stats and
    the canonical-digest parity bit."""
    from .tpu.elastic import canonical_state
    from .convert import digest_pytrees
    from .workloads import device as wdevice
    from .workloads import runner as wrunner
    from .workloads.compile import compile_program
    from .workloads.spec import parse_scenario

    device = resolve_device(device)
    spec = parse_scenario({
        "name": f"memo-bench-ring-{hosts}", "family": "ring_allreduce",
        "seed": 7, "hosts": hosts, "windows": windows,
        "patterns": [{"kind": "ring_allreduce", "first": 0,
                      "count": hosts, "bytes": 4096, "rounds": 1}],
    })
    prog = compile_program(spec)
    state0, params = wrunner.build_scenario_world(spec, device=device)
    wl = wdevice.to_device(prog, device)
    ws0 = wdevice.make_workload_state(prog, device)
    metrics0 = make_metrics(spec.n_hosts, device=device)
    state0, ws0, metrics0 = wdevice.prime(wl, ws0, state0, metrics=metrics0)
    window = spec.window_ns

    def chain_fn(state, extras, r0, r1):
        ws, metrics = extras[0], extras[1]
        for r in range(r0, r1):
            out = window_step(state, params, spec.seed, 0 if r == 0
                              else window, window, rr_enabled=False,
                              kernel="xla", metrics=metrics)
            (state, delivered, _nx), metrics, *_ = unpack_planes(
                out, metrics=metrics)
            state, ws, metrics = wdevice.workload_step(
                wl, ws, state, delivered, r, window, metrics=metrics)
        # the runner's extras layout, so its memo key_extra reads the
        # workload and flow planes where it looks for them
        return state, (ws, metrics, None, None, None, None, None), 0, 0

    def drive(memo_obj, rounds=spec.windows):
        out = drive_chained_windows(
            state0, (ws0, metrics0, None, None, None, None, None), chain_fn,
            n_rounds=rounds, chain_len=chain_len, window_ns=window,
            memo=memo_obj)
        _sync(device)
        return out

    def fresh_memo():
        return wrunner._build_memo(
            {"chain_len": chain_len}, spec=spec, prog=prog, schedule=None,
            adv=wdevice.MAX_ADVANCE, emit_cap=0, recv_wnd=0, guards=False,
            histograms=False, sample_every=None, trace_ring=0)[0]

    drive(None, chain_len)  # warm-up: one chain
    t0 = time.perf_counter()
    state_c, extras_c = drive(None)
    cold_s = time.perf_counter() - t0
    memo_obj = fresh_memo()
    t0 = time.perf_counter()
    state_m, extras_m = drive(memo_obj)
    memo_s = time.perf_counter() - t0
    events = int(extras_c[1].events)
    parity = (digest_pytrees(canonical_state(state_c), extras_c[0])
              == digest_pytrees(canonical_state(state_m), extras_m[0]))
    return {
        "scenario": spec.name, "hosts": hosts, "windows": windows,
        "chain_len": chain_len, "events": events, "device": str(device),
        "cold_s": cold_s, "memo_s": memo_s,
        "windows_per_s_cold": windows / cold_s,
        "windows_per_s_memo": windows / memo_s,
        "effective_evps_cold": events / cold_s,
        "effective_evps_memo": events / memo_s,
        "speedup": cold_s / memo_s,
        "digest_parity": parity,
        "memo": memo_obj.stats(),
    }


@contextlib.contextmanager
def _routing_stage_ranges(takes: list):
    """While it is open, each window's routing stage runs in a
    `record_function` range: from the return of the pipeline module's
    `_routing_rank` (the flat sort and bucket bounds) to the return of
    its placement wrapper (`place` or `scatter`), so the range holds what
    the stage builds for the placement kernel and the kernel. Each
    wrapper call's take [N] is kept in `takes`, unread. It wraps the
    module's functions and touches nothing else, so it measures any tree
    of this package alike."""
    rank = pipeline._routing_rank
    wrappers = {name: getattr(pipeline, name)
                for name in ("place", "scatter")}
    open_ranges = []

    def ranked(*args, **kw):
        out = rank(*args, **kw)
        rf = torch.profiler.record_function(ROUTING_STAGE)
        rf.__enter__()
        open_ranges.append(rf)
        return out

    def placing(fn):
        def run(*args, **kw):
            takes.append(args[2])
            try:
                return fn(*args, **kw)
            finally:
                open_ranges.pop().__exit__(None, None, None)
        return run

    pipeline._routing_rank = ranked
    for name, fn in wrappers.items():
        setattr(pipeline, name, placing(fn))
    try:
        yield
    finally:
        pipeline._routing_rank = rank
        for name, fn in wrappers.items():
            setattr(pipeline, name, fn)


def profile_windows(n_hosts: int = 32768, windows: int = 16, *,
                    n_nodes: int = 64, egress_cap: int = 16,
                    ingress_cap: int = 32, kernel: str = "pallas_fused",
                    device=None, top: int = 15) -> dict:
    """Where a PHOLD window's time goes on the card: `windows` windows
    after as many warm-up windows, timed bare (wall per window), then
    again under torch.profiler (device kernels by name, kernel launches
    per window, the device's busy share of the bare wall, and the routing
    stage's device time and launches a window, with the slots it placed,
    counted after the profiled windows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("profile_windows measures the card: device must "
                         "be CUDA")
    world = build_world(n_hosts, n_nodes=n_nodes, egress_cap=egress_cap,
                        ingress_cap=ingress_cap, warmup_windows=0,
                        device=device)
    chain = phold_chain_fn(world, kernel=kernel)
    spawn_seq = torch.full((n_hosts,), SPAWN_SEQ0, dtype=torch.int32,
                           device=device)
    state, extras, _eg, _in = chain(world["state"], (spawn_seq, 0), 0,
                                    windows)
    _sync(device)
    t0 = time.perf_counter()
    state, extras, _eg, _in = chain(state, extras, windows, 2 * windows)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / windows
    takes = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _routing_stage_ranges(takes):
        state, extras, _eg, _in = chain(state, extras, 2 * windows,
                                        3 * windows)
        _sync(device)
    events = prof.events()
    # device work: kernels and copies; the ranges' device-side spans are
    # not work
    on_card = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and ev.name != ROUTING_STAGE and not ev.is_user_annotation]
    kernels: dict[str, list[float]] = {}
    for ev in on_card:
        kernels.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    # the stage's device work: what the runtime calls made inside a range
    # launched (a call and its kernel share a correlation id), so kernels
    # launched from ctypes count as PyTorch's do
    stage = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.name == ROUTING_STAGE and ev.device_type == DeviceType.CPU]
    launched = {ev.id for ev in events
                if ev.device_type == DeviceType.CPU
                and ev.name.startswith("cu")
                and any(s <= ev.time_range.start and ev.time_range.end <= e
                        for s, e in stage)}
    stage_kernels: dict[str, list[float]] = {}
    for ev in on_card:
        if ev.id in launched:
            stage_kernels.setdefault(ev.name, []).append(
                ev.time_range.elapsed_us())
    busy_ms = sum(sum(v) for v in kernels.values()) / 1e3 / windows
    by_time = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))
    return {
        "n_hosts": n_hosts, "windows": windows, "kernel": kernel,
        "wall_ms_per_window": wall_ms,
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
        "routing_stage": {
            "ranges": len(stage),
            "host_ms_per_window": sum(e - s for s, e in stage) / 1e3
            / windows,
            "device_ms_per_window": sum(map(sum, stage_kernels.values()))
            / 1e3 / windows,
            "launches_per_window": sum(map(len, stage_kernels.values()))
            / windows,
            "kernels": {name: len(v) / windows
                        for name, v in stage_kernels.items()},
            "placed_slots_per_window": int(sum(
                t.sum(dtype=torch.int64) for t in takes)) / windows,
        },
    }


def bench_sections(kernel: str, n_hosts: int = 32768, n_nodes: int = 64,
                   egress_cap: int = 16, ingress_cap: int = 32, *,
                   device=None) -> dict:
    """One profiled rep of each of `profiling.BENCH_SECTIONS` at the
    bench shape (outside the timed run): section name -> min ms, as the
    JAX bench's `bench_sections`."""
    rep = profiling.profile_sections(
        n_hosts, reps=1, rr_enabled=False, kernel=kernel, n_nodes=n_nodes,
        egress_cap=egress_cap, ingress_cap=ingress_cap,
        sections=profiling.BENCH_SECTIONS, device=device)
    return {name: vals["min_ms"] for name, vals in rep["sections"].items()}


def bench_record(res: dict, sections: dict | None = None) -> dict:
    """The JSON record of a `run_phold` result: JAX's keys (`metric`,
    `value`, `unit`, `backend`, `hosts`, `sections`, with the driver's
    `windows_per_sync` beside the section times, as the JAX bench puts
    it there) beside the port's own, the final state's digest among
    them."""
    from .convert import state_digest

    if sections is not None:
        sections = dict(sections,
                        windows_per_sync=res["driver"]["windows_per_sync"])
    kernel = dict(res["kernel"], fell_back=False,
                  faults_threaded=res["faults"])
    rec = {"metric": "packet_events_per_sec",
           "value": round(res["packet_events_per_sec"], 1),
           "unit": "events/s",
           "backend": backend_fingerprint(res["device"]),
           "hosts": res["n_hosts"], "sections": sections,
           "worlds": None, "memo": None,
           "state_digest": state_digest(res["state"])}
    rec.update((k, v) for k, v in res.items()
               if k not in ("state", "metrics", "hist", "faults"))
    rec["kernel"] = kernel
    return rec


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=KERNELS, default="pallas_fused",
                    help="the window step's kernel pair, or xla (no "
                         "kernel)")
    ap.add_argument("--capacity", choices=CAPACITY_MODES, default="fixed",
                    help="the ring capacity policy")
    ap.add_argument("--egress-cap", type=int, default=16)
    ap.add_argument("--ingress-cap", type=int, default=32)
    ap.add_argument("--max-doublings", type=int, default=4,
                    help="growth budget per ring (elastic)")
    ap.add_argument("--grow-every", type=int, default=16,
                    help="windows a chain under strict/elastic")
    ap.add_argument("--profile", type=int, default=0, metavar="WINDOWS",
                    help="also profile this many windows on the card")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="thread the metrics and harvest heartbeats into "
                         "DIR/heartbeats.jsonl (+ DIR/trace.json)")
    ap.add_argument("--hist", action="store_true",
                    help="with --telemetry: thread the log2 histograms "
                         "too (kernel xla only)")
    ap.add_argument("--harvest-every", type=int, default=32, metavar="K",
                    help="windows between harvests (the chain length "
                         "under --telemetry; default 32)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the timed run's run ledger (JSONL) here")
    ap.add_argument("--memo", action="store_true",
                    help="also run the memo rep: a 16-host ring allreduce "
                         "over 4096 windows in chains of 64, cold and "
                         "memoized, with the digest parity bit")
    ap.add_argument("--worlds", type=int, default=0, metavar="W",
                    help="also run the ensemble rep: the keyed PHOLD chain "
                         "over W worlds through drive_ensemble, kernel xla "
                         "(the JSON's `worlds` record; its "
                         "amortization_vs_solo is against the solo run of "
                         "--kernel)")
    ap.add_argument("--faults", action="store_true",
                    help="thread neutral fault masks through every window "
                         "(kernel xla only)")
    ap.add_argument("--no-sections", action="store_true",
                    help="skip the per-section profile rep (the JAX "
                         "bench's BENCH_SECTIONS=0)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    try:
        res = run_phold(
            egress_cap=args.egress_cap, ingress_cap=args.ingress_cap,
            kernel=args.kernel, capacity=args.capacity,
            max_doublings=args.max_doublings, grow_every=args.grow_every,
            telemetry=args.telemetry, hist=args.hist,
            harvest_every=args.harvest_every, trace=args.trace,
            faults=args.faults)
    except ValueError as e:
        ap.error(str(e))
    # sections are recorded for the "xla" kernel only, as the JAX bench
    # records them for its default kernel
    sections = (bench_sections(
        "xla", res["n_hosts"], egress_cap=args.egress_cap,
        ingress_cap=args.ingress_cap, device=res["device"])
        if not args.no_sections and res["kernel"]["used"] == "xla"
        else None)
    rec = bench_record(res, sections)
    if args.worlds:
        worlds = run_worlds(args.worlds, egress_cap=args.egress_cap,
                            ingress_cap=args.ingress_cap,
                            solo_rate=res["packet_events_per_sec"],
                            trace=args.trace)
        rec["worlds"] = {k: v for k, v in worlds.items()
                         if k not in ("states", "extras")}
        rec["worlds"]["solo_kernel"] = args.kernel
    if args.memo:
        rec["memo"] = run_memo()
    if torch.cuda.is_available():
        rec["gpu"] = torch.cuda.get_device_name(0)
    if args.profile:
        # at the caps the run ended with (grown, under elastic)
        caps = (res["capacity"] or {}).get("final", {
            "egress_cap": args.egress_cap, "ingress_cap": args.ingress_cap})
        rec["profile"] = profile_windows(windows=args.profile,
                                         kernel=args.kernel, **caps)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()

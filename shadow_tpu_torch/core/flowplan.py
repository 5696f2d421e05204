"""Compile a YAML tgen workload into a device flow plan and run it.

Counterpart of `shadow_tpu/core/flowplan.py`. `compile_flow_plan`
inspects a parsed config (`core/config.load_config_str`), verifies the
workload is flow-engine-shaped (every process a built-in `tgen-server`
/ `tgen-client`, one transfer a client), resolves each client's server,
path latency and composed path loss through the routing tables
(`net/graph.py`), and emits the arrays `tpu/floweng.make_flow_world`
takes; a config that is not flow-engine-shaped raises `FlowPlanError`
naming the offending process. `run_flow_simulation` runs the plan on
the flow engine (kernel F on the card) in latency buckets and fills a
`SimStats` as the JAX `Manager.run` does under
`experimental.use_flow_engine`: `run_config(config)` is the port's
counterpart of `Manager(config).run()` there, which builds only the
graph and routing (`routing_from_config`, as `manager.py:110-123`).

A `flow-progress` checkpoint lands after every finished bucket (the
port's `faults/checkpoint`, the JAX package's format: either package
resumes the other's), and a resume recomputes only the buckets left.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time as _walltime
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import simtime
from .capacity import CapacityError, CapacityTrajectory

log = logging.getLogger("shadow.flowplan")

_WORKLOADS = Path(__file__).resolve().parent.parent / "workloads"
#: the benchmark ladder's rung 3 on the flow engine
#: (`tools/bench_ladder.py:92-123`, `rung3(use_flow_engine=True)`): 1000
#: hosts on a 40-node GML mesh, 20-200 ms latency, 0.1-1 % loss, 25 tgen
#: servers, 975 clients of 256 KiB
RUNG3_YAML = _WORKLOADS / "rung3_floweng.yaml"
#: `stats_record` of the JAX `Manager` run of RUNG3_YAML on the CPU
RUNG3_RECORD = _WORKLOADS / "rung3_floweng.record.json"


@dataclass
class SimStats:
    """End-of-run statistics: the fields and `as_dict` of the JAX
    package's `SimStats` (`shadow_tpu/core/manager.py:38-70`). A flow
    run also sets `flow_complete_us` and `flow_retransmits` on it, as
    the JAX one does."""

    rounds: int = 0
    events_executed: int = 0
    packets_sent: int = 0
    packets_dropped: int = 0
    packets_dropped_fault: int = 0
    sim_time_ns: int = 0
    wall_seconds: float = 0.0
    process_failures: list = field(default_factory=list)
    capacity_events: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "packets_sent": self.packets_sent,
            "packets_dropped": self.packets_dropped,
            "packets_dropped_fault": self.packets_dropped_fault,
            "sim_time_ns": self.sim_time_ns,
            "wall_seconds": self.wall_seconds,
            "process_failures": list(self.process_failures),
            "capacity_events": list(self.capacity_events),
        }


def stats_record(stats) -> dict:
    """What a flow-engine run's `SimStats` says, for comparison across
    packages and runs: `as_dict()` without `wall_seconds`, the event
    count, the retransmit total and a sha256 of the per-flow completion
    times (int64)."""
    d = stats.as_dict()
    d.pop("wall_seconds")
    complete = np.ascontiguousarray(np.asarray(stats.flow_complete_us,
                                               np.int64))
    return {"stats": d, "events_executed": int(stats.events_executed),
            "flow_retransmits": int(stats.flow_retransmits),
            "flow_complete_us_sha256":
                hashlib.sha256(complete.tobytes()).hexdigest()}


def routing_from_config(config):
    """The network graph's routing for a parsed config, built as the
    JAX `Manager.__init__` builds it (`manager.py:110-123`): the
    built-in switch, an inline GML or a GML file, over the hosts' nodes."""
    from ..net import graph as netgraph

    gsrc = config.network.graph
    if gsrc.type == "1_gbit_switch":
        text = netgraph.ONE_GBIT_SWITCH_GRAPH
    elif gsrc.inline is not None:
        text = gsrc.inline
    else:
        text = netgraph.load_graph_text(gsrc.file_path)
    graph = netgraph.NetworkGraph.parse(text)
    used_nodes = [h.network_node_id for h in config.hosts.values()]
    return netgraph.build_routing(graph, used_nodes,
                                  config.network.use_shortest_path)


def run_config(config, **kw) -> SimStats:
    """`Manager(config).run()` of a `use_flow_engine` config: routing,
    then `run_flow_simulation` (with its keywords) into a fresh
    `SimStats`."""
    return run_flow_simulation(config, routing_from_config(config),
                               SimStats(), **kw)

class FlowPlanError(ValueError):
    """The config is not a flow-engine-shaped workload."""


@dataclass
class FlowPlan:
    client: list  # [F] client host name
    server: list  # [F] server host name
    size: np.ndarray  # [F] bytes the server streams to the client
    start_us: np.ndarray  # [F] client connect time
    latency_us: np.ndarray  # [F] client->server path latency
    latency_back_us: np.ndarray  # [F] server->client (may differ on
    # directed graphs)
    loss: np.ndarray  # [F] client->server path loss probability
    loss_back: np.ndarray  # [F] server->client
    window_us: int
    stop_us: int
    seed: int


def compile_flow_plan(config, routing, node_index_of_host=None) -> FlowPlan:
    """Extract the flow plan from a parsed config. `routing` is the
    Manager's `RoutingInfo`; `node_index_of_host` maps a host name to
    its network node id (defaults to the config's network_node_id)."""
    if node_index_of_host is None:
        node_index_of_host = {
            name: h.network_node_id for name, h in config.hosts.items()
        }
    servers: dict[str, tuple[str, int]] = {}  # name -> (port, node)
    clients = []
    for name, host in config.hosts.items():
        for popt in host.processes:
            if popt.path == "tgen-server":
                port = popt.args[0] if popt.args else "8888"
                servers[name] = (port, node_index_of_host[name])
            elif popt.path == "tgen-client":
                args = list(popt.args) + ["server", "8888", "1048576", "1"][
                    len(popt.args):]
                server, port, size, count = args[:4]
                if int(count) != 1:
                    raise FlowPlanError(
                        f"host {name}: tgen-client count={count}; the "
                        f"flow engine runs single transfers per client "
                        f"(count=1)")
                clients.append((name, node_index_of_host[name], server,
                                port, int(size), popt.start_time))
            else:
                raise FlowPlanError(
                    f"host {name}: process '{popt.path}' is not a tgen "
                    f"app; experimental.use_flow_engine only accepts "
                    f"tgen-server/tgen-client workloads")
    if not clients:
        raise FlowPlanError("no tgen-client processes in the config")

    F = len(clients)
    size = np.zeros(F, np.int64)
    start_us = np.zeros(F, np.int64)
    latency_us = np.zeros(F, np.int64)
    latency_back_us = np.zeros(F, np.int64)
    loss = np.zeros(F, np.float64)
    loss_back = np.zeros(F, np.float64)
    names_c, names_s = [], []
    for f, (cname, cnode, server, port, sz, t0) in enumerate(clients):
        if server not in servers:
            raise FlowPlanError(
                f"host {cname}: tgen-client targets '{server}' but no "
                f"host runs a tgen-server")
        sport, snode = servers[server]
        if sport != port:
            raise FlowPlanError(
                f"host {cname}: port {port} != server port {sport}")
        fwd = routing.path(cnode, snode)  # client -> server
        back = routing.path(snode, cnode)  # server -> client (directed
        # graphs may be asymmetric; each lane carries its own direction)
        if fwd.latency_ns < simtime.MICROSECOND \
                or back.latency_ns < simtime.MICROSECOND:
            raise FlowPlanError(
                f"host {cname}: path to '{server}' has sub-microsecond "
                f"latency ({min(fwd.latency_ns, back.latency_ns)} ns); "
                f"the flow engine's PDES window cannot go below 1 us")
        size[f] = sz
        start_us[f] = t0 // simtime.MICROSECOND
        if start_us[f] >= 2**31:
            raise FlowPlanError(
                f"host {cname}: start_time {start_us[f]} us exceeds the "
                f"flow engine's int32 microsecond domain (~35.8 simulated "
                f"minutes); it would silently wrap on device")
        latency_us[f] = fwd.latency_ns // simtime.MICROSECOND
        latency_back_us[f] = back.latency_ns // simtime.MICROSECOND
        loss[f] = fwd.packet_loss
        loss_back[f] = back.packet_loss
        names_c.append(cname)
        names_s.append(server)

    stop_us = config.general.stop_time // simtime.MICROSECOND
    if stop_us >= 2**31:
        raise FlowPlanError(
            f"general.stop_time {stop_us} us exceeds the flow engine's "
            f"int32 microsecond domain (~35.8 simulated minutes); it "
            f"would silently wrap on device")
    # PDES lookahead: windows no wider than the narrowest flow's one-way
    # latency (pairs are independent — only a pair's own latency bounds
    # its window), clamped to keep per-window bursts inside the rings
    window_us = int(min(latency_us.min(), int(latency_back_us.min()),
                        25_000))
    return FlowPlan(
        client=names_c, server=names_s, size=size, start_us=start_us,
        latency_us=latency_us, latency_back_us=latency_back_us,
        loss=loss, loss_back=loss_back, window_us=window_us,
        stop_us=int(stop_us), seed=config.general.seed,
    )


# window-width ladder for latency buckets: flows whose one-way latency
# admits a wider window run in a separate world with that window — pairs
# never interact, so partitioning by latency is exact PDES decomposition
# (not an approximation), and it keeps fast-flow worlds from forcing
# narrow windows on slow flows. A flow may always run NARROWER windows
# than its latency admits, so the ladder is coarse (fewer, larger
# buckets amortize per-dispatch and probe overhead better than exact
# windows amortize step count). Padding each bucket to a power of two
# maximizes XLA compile-cache hits across configs.
_WINDOW_LADDER = (1_000, 2_000, 5_000, 20_000)
#: a bucket's ring slots on its first attempt (doubled on ring drops)
QUEUE_SLOTS0 = 256


def _bucket_window(lat_us: int) -> int:
    w = min(lat_us, _WINDOW_LADDER[-1])
    best = 0
    for step in _WINDOW_LADDER:
        if step <= w:
            best = step
    return best if best else int(w)  # sub-ladder latency: exact window


def _plan_fingerprint(plan: FlowPlan) -> str:
    """Digest of everything that determines a flow run's results: a
    resume against a DIFFERENT config/seed must refuse, not silently
    merge incompatible bucket results."""
    import hashlib

    h = hashlib.sha256()
    h.update(repr((plan.client, plan.server, plan.window_us, plan.stop_us,
                   plan.seed)).encode())
    for arr in (plan.size, plan.start_us, plan.latency_us,
                plan.latency_back_us, plan.loss, plan.loss_back):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def flow_buckets(plan: FlowPlan) -> dict[int, list[int]]:
    """The plan's latency buckets: {window_us: [flow index]}, each flow
    under the widest ladder window its lookahead admits."""
    buckets: dict[int, list[int]] = {}
    for f in range(len(plan.size)):
        lookahead = min(int(plan.latency_us[f]),
                        int(plan.latency_back_us[f]))
        buckets.setdefault(_bucket_window(lookahead), []).append(f)
    return buckets


def bucket_chunk(window_us: int) -> int:
    """Windows a launch in a bucket: ~1 simulated second a dispatch."""
    return max(1, 1_000_000 // window_us)


def _bucket_pad(n_flows: int) -> int:
    """Idle flows that pad a bucket to a power of two (at least 8)."""
    return max(8, 1 << (n_flows - 1).bit_length()) - n_flows


def bucket_world(plan: FlowPlan, window_us: int, idx, queue_slots: int,
                 device):
    """The bucket's world: its flows, then `_bucket_pad` idle flows that
    never start."""
    from ..tpu import floweng

    pad = _bucket_pad(len(idx))
    sel = np.asarray(idx)
    lat = np.concatenate([plan.latency_us[sel],
                          np.full(pad, window_us, np.int64)])
    lat_b = np.concatenate([plan.latency_back_us[sel],
                            np.full(pad, window_us, np.int64)])
    size = np.concatenate([plan.size[sel], np.zeros(pad, np.int64)])
    start = np.concatenate([plan.start_us[sel],
                            np.full(pad, np.iinfo(np.int32).max, np.int64)])
    loss = np.concatenate([plan.loss[sel], np.zeros(pad)])
    loss_b = np.concatenate([plan.loss_back[sel], np.zeros(pad)])
    return floweng.make_flow_world(
        lat, size, start_us=start, loss=loss, seed=plan.seed,
        server_writes=True, queue_slots=queue_slots, latency_back_us=lat_b,
        loss_back=loss_b, device=device)


def run_flow_simulation(config, routing, stats, *, checkpoint_dir=None,
                        resume_from=None, device=None):
    """Execute the config's tgen workload on the device flow engine and
    fill `stats` (a `SimStats`) the way the round loop would: segments
    as events/packets, wire drops as packet drops, incomplete transfers
    as process failures against the clients' expected exit 0.

    Checkpoint/resume (docs/robustness.md): latency buckets are
    independent worlds, so bucket completion is an EXACT resume unit.
    With `checkpoint_dir` set, a ``flow-progress`` checkpoint lands
    after every finished bucket; `resume_from` restores it (fingerprint
    -verified against this config+seed) and recomputes only the
    remaining buckets — the merged results are bitwise-identical to an
    uninterrupted run because per-bucket results are deterministic and
    disjoint.

    `device` is the flow engine's (the CUDA card by default)."""
    from .. import resolve_device
    from ..tpu import floweng

    dev = resolve_device(device)
    wall0 = _walltime.monotonic()
    plan = compile_flow_plan(config, routing)
    F = len(plan.size)
    buckets = flow_buckets(plan)

    complete_us = np.full(F, np.iinfo(np.int32).max, np.int64)
    bytes_read = np.zeros(F, np.int64)
    segments = wire_drops = queue_drops = retransmits = 0
    rounds = 0
    total_retries = 0
    ring_dirty = False  # a bucket's FINAL run still had ring drops
    # ring-capacity policy (core/capacity.py): the flow engine's
    # per-destination segment rings are this path's capacity dimension.
    # Engine ring drops were ALWAYS re-run with doubled queue_slots
    # (they are an engine artifact, not modeled wire loss), so fixed
    # and elastic behave identically here — the policy contributes the
    # unified trajectory record, the strict failure, and the
    # max_doublings bound.
    cap_opts = getattr(config, "capacity", None)
    max_doublings = cap_opts.max_doublings if cap_opts else 3
    cap_mode = cap_opts.mode if cap_opts else "fixed"
    trajectory = CapacityTrajectory(cap_mode)
    fingerprint = _plan_fingerprint(plan)
    done_buckets: set[int] = set()
    if resume_from:
        from ..faults.checkpoint import CheckpointError, load_checkpoint

        meta, arrays = load_checkpoint(resume_from)
        if meta.get("kind") != "flow":
            raise CheckpointError(
                f"{resume_from}: kind {meta.get('kind')!r} is not a "
                f"flow-engine checkpoint")
        if meta.get("plan_fingerprint") != fingerprint:
            raise CheckpointError(
                f"{resume_from}: checkpoint was written by a different "
                f"config/seed (plan fingerprint mismatch); refusing to "
                f"merge incompatible bucket results")
        complete_us = arrays["complete_us"].astype(np.int64)
        bytes_read = arrays["bytes_read"].astype(np.int64)
        c = meta["counters"]
        segments, wire_drops = c["segments"], c["wire_drops"]
        queue_drops, retransmits = c["queue_drops"], c["retransmits"]
        rounds, total_retries = c["rounds"], c["retries"]
        ring_dirty = bool(c["ring_dirty"])
        trajectory.events.extend(meta.get("capacity_events", []))
        done_buckets = set(meta["done_buckets"])
        log.info("flow engine: resumed from %s (%d/%d bucket(s) done)",
                 resume_from, len(done_buckets), len(buckets))

    def _bucket_checkpoint():
        if not checkpoint_dir:
            return
        from ..faults.checkpoint import write_checkpoint

        write_checkpoint(
            os.path.join(checkpoint_dir, "flow-progress"),
            meta={
                "kind": "flow",
                "plan_fingerprint": fingerprint,
                "done_buckets": sorted(done_buckets),
                "capacity_events": list(trajectory.events),
                "counters": {
                    "segments": int(segments),
                    "wire_drops": int(wire_drops),
                    "queue_drops": int(queue_drops),
                    "retransmits": int(retransmits),
                    "rounds": int(rounds),
                    "retries": int(total_retries),
                    "ring_dirty": bool(ring_dirty),
                },
            },
            arrays={"complete_us": complete_us, "bytes_read": bytes_read},
        )

    for window_us, idx in sorted(buckets.items(), reverse=True):
        if window_us in done_buckets:
            log.info("flow engine: bucket window %d us already complete "
                     "in the resumed checkpoint; skipping", window_us)
            continue
        Fb = len(idx)
        sel = np.asarray(idx)
        log.info("flow engine: bucket window %d us, %d flows (+%d pad)",
                 window_us, Fb, _bucket_pad(Fb))
        chunk = bucket_chunk(window_us)
        # ring-capacity drops are an ENGINE artifact (per-destination
        # segment rings overflowing), not modeled wire loss — the TCP
        # machines recover via retransmit, so results stay valid but
        # completion times are distorted. Same discipline as step-cap
        # saturation: re-run the bucket from scratch with doubled rings.
        queue_slots = QUEUE_SLOTS0
        for ring_attempt in range(max_doublings + 1):
            world = bucket_world(plan, window_us, idx, queue_slots, dev)
            world, sim_s, retries = floweng.run_to_completion(
                world, window_us, max_sim_s=plan.stop_us / 1e6,
                chunk_windows=chunk, probe_every=3)
            world = floweng.finalize_to(world, plan.stop_us)
            res = floweng.flow_results(world)
            if res["queue_drops"] == 0:
                break
            if cap_mode == "strict":
                # strict refuses the self-healing re-run too: the
                # caller claimed the provisioning was right
                raise CapacityError(
                    f"flow engine: {int(res['queue_drops'])} "
                    f"ring-capacity drop(s) in the {window_us} us "
                    f"bucket under capacity.mode=strict "
                    f"(queue_slots={queue_slots}); raise the rings or "
                    f"run capacity.mode=elastic", ring="flow-queue")
            if ring_attempt == max_doublings:
                ring_dirty = True
                ev = trajectory.record_drop(
                    time_ns=config.general.stop_time, ring="flow-queue",
                    cap=queue_slots, overflow=int(res["queue_drops"]),
                    plane="floweng", exhausted=True)
                ev["bucket_window_us"] = window_us
                log.warning(
                    "flow engine: ring drops persist after %d doublings "
                    "(queue_slots=%d); reconciled packets_dropped now "
                    "includes %d engine ring drops alongside wire drops",
                    max_doublings, queue_slots, res["queue_drops"])
                break
            # the ad-hoc doubled-queue_slots re-run, now ONE policy with
            # the device planes: a bucket re-run from scratch with
            # doubled rings IS the elastic snapshot/re-execute (the
            # snapshot is the bucket's deterministic start), so fixed
            # and elastic both take it; only the trajectory record and
            # bounds come from the policy
            ev = trajectory.record_growth(
                time_ns=config.general.stop_time, ring="flow-queue",
                from_cap=queue_slots, to_cap=queue_slots * 2,
                overflow=int(res["queue_drops"]), plane="floweng")
            ev["bucket_window_us"] = window_us
            queue_slots *= 2
            log.warning(
                "flow engine: %d ring-capacity drop(s) in the %d us "
                "bucket (engine ring overflow, distinct from modeled "
                "wire drops) — re-running with queue_slots=%d",
                res["queue_drops"], window_us, queue_slots)
            total_retries += 1
        complete_us[sel] = res["complete_us"][:Fb]
        bytes_read[sel] = res["bytes_read"][:Fb]
        segments += res["segments"]
        wire_drops += res["wire_drops"]
        queue_drops += res["queue_drops"]
        retransmits += res["retransmits"]
        rounds += int(round(sim_s * 1e6 / window_us))
        total_retries += retries
        done_buckets.add(window_us)
        _bucket_checkpoint()

    ok = bytes_read >= plan.size
    for f in np.nonzero(~ok)[0]:
        stats.process_failures.append((
            f"{plan.client[f]}/tgen-client",
            f"expected exited(0), got running (transfer "
            f"{int(bytes_read[f])}/{int(plan.size[f])}"
            f" bytes from {plan.server[f]})",
        ))
    if total_retries:
        log.warning("flow engine re-ran %d time(s) after window "
                    "saturation%s", total_retries,
                    " (ring drops persisted in a final run)" if ring_dirty
                    else " (final runs clean)")
    if ring_dirty and getattr(config, "strict", False):
        # top-level strict: a final run that still lost packets to
        # engine ring capacity is a refused silent divergence, not a
        # warning (same promotion as the transport's ingress drops)
        raise CapacityError(
            "flow engine: ring-capacity drops persisted after the "
            "growth budget (capacity.max_doublings="
            f"{max_doublings}) under strict: true; raise the rings or "
            "the budget", ring="flow-queue")
    stats.capacity_events = list(trajectory.events)
    stats.rounds = rounds
    stats.events_executed = segments
    stats.packets_sent = segments
    stats.packets_dropped = wire_drops + queue_drops
    stats.sim_time_ns = config.general.stop_time
    stats.wall_seconds = _walltime.monotonic() - wall0
    stats.flow_complete_us = complete_us
    stats.flow_retransmits = retransmits
    return stats

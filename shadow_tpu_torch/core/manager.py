"""The simulation driver: builds hosts from config, runs the round loop.

Parity: reference `src/main/core/manager.rs` — builds hosts (`build_host`,
`manager.rs:551`), shuffles them for thread assignment (`manager.rs:272`),
picks parallelism = min(cores, hosts) (`manager.rs:248-298`), runs the
boot → scheduling-loop → shutdown phases (`manager.rs:357-489`), and merges
worker stats. The Controller supplies each next window from the global min
next-event time (`controller.rs:80-113`).

The port's copy of `shadow_tpu/core/manager.py`. What differs: the
Manager takes `device` (None: the CUDA card), which the device transport
(`experimental.use_tpu_transport`: the port's `tpu/transport`) and the
flow engine (`experimental.use_flow_engine`: the port's `core/flowplan`,
kernel F) run on; a config that switches on neither touches no device.
`SimStats` is `core/flowplan`'s. The port has the built-in apps only: a
process whose path is a real executable (a managed native process, run
under the interposition shim in the JAX package) raises `ConfigError`
when the Manager is built.
"""

from __future__ import annotations

import heapq
import json
import logging
import os
import sys
import time as _walltime
from typing import Optional

from ..host.cpu import Cpu
from ..host.host import Host
from ..net import graph as netgraph
from ..net.dns import Dns
from . import resource_usage, simtime
from .config import ConfigOptions, FinalState
from .controller import Controller, Runahead
from .rng import Xoshiro256pp, host_seed_for
from .flowplan import SimStats
from .scheduler import make_scheduler
from . import worker as worker_mod
from .worker import WorkerShared

log = logging.getLogger("shadow_tpu_torch.manager")

#: what a real executable in `processes[].path` needs, and the port lacks
MANAGED_PROCESS_SLICE = (
    "managed native processes (process/managed.py, "
    "process/syscall_handler.py, process/strace.py, process/memory.py, "
    "the rest of kernel/ and the interposition shim of interpose/)")


def _tracker_dispatch(packet, status):
    """Route a packet status to the executing host's trackers."""
    host = worker_mod.current_host()
    if host is None:
        return
    for tracker in getattr(host, "trackers", ()):
        tracker.on_packet_status(packet, status)


def _raw_cpu_frequency_khz() -> int:
    """The machine's raw CPU frequency (`manager.rs:826-830`), with a
    /proc/cpuinfo fallback and a 1 GHz default when neither is readable."""
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/cpuinfo_max_freq") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    return int(float(line.split(":", 1)[1]) * 1000)
    except (OSError, ValueError, IndexError):
        pass
    return 1_000_000  # 1 GHz


class Manager:
    def __init__(self, config: ConfigOptions, data_dir: Optional[str] = None,
                 device=None):
        self.config = config
        # the device transport's and the flow engine's (None: the card)
        self.device = device
        self.data_dir = data_dir  # set by the CLI; enables pcap/stats files
        self._pcap_writers = []
        self.global_rng = Xoshiro256pp(config.general.seed)
        self.dns = Dns()
        self.hosts: list[Host] = []
        self.hosts_by_name: dict[str, Host] = {}

        # --- network graph + routing ---------------------------------------
        gsrc = config.network.graph
        if gsrc.type == "1_gbit_switch":
            text = netgraph.ONE_GBIT_SWITCH_GRAPH
        elif gsrc.inline is not None:
            text = gsrc.inline
        else:
            text = netgraph.load_graph_text(gsrc.file_path)
        self.graph = netgraph.NetworkGraph.parse(text)

        used_nodes = [h.network_node_id for h in config.hosts.values()]
        self.routing = netgraph.build_routing(
            self.graph, used_nodes, config.network.use_shortest_path
        )

        # --- flow-engine delegation ------------------------------------------
        # a tgen workload bound for the device flow engine needs only the
        # graph + routing built above: skip hosts, trackers, scheduler
        # worker threads, and transport entirely (they would be built,
        # pinned, and never used)
        self.stats = SimStats()
        self.trackers = {}
        # unified telemetry (docs/observability.md): instantiated at
        # run() start so a Manager built-but-never-run opens no sink.
        # Assigned before the flow-engine early return so every Manager
        # has the attribute (the CLI reads it after run()).
        self.harvester = None
        # fault-plane / checkpoint state shared by BOTH run paths (the
        # flow engine checkpoints per bucket; the round loop per
        # interval + on the crash path) — initialized before the
        # flow-engine early return so every Manager has the attributes
        self.fault_schedule = None
        self._watchdog = None
        self._last_window_start = 0
        self.resume_from = None  # set by the CLI's --resume
        # guard plane (docs/robustness.md): the ledger collects every
        # violation and dispatches the per-class policy; the reconciler
        # and progress detector attach below when their classes are
        # active. Initialized before the flow-engine early return so
        # every Manager has the attributes.
        self._guard_ledger = None
        self._guard_recon = None
        self._progress = None
        self._progress_packets = 0
        if config.guards.enabled:
            from ..guards.report import GuardLedger

            self._guard_ledger = GuardLedger(policies={
                "device": config.guards.device,
                "reconcile": config.guards.reconcile,
                "progress": config.guards.progress,
            })
        self._ckpt_dir = config.faults.checkpoint.directory or (
            os.path.join(self.data_dir, "checkpoints")
            if self.data_dir else None)
        self._next_ckpt_ns = None
        if config.faults.checkpoint.interval:
            if self._ckpt_dir is None:
                log.warning(
                    "faults.checkpoint.interval is set but there is no "
                    "data directory and no faults.checkpoint.directory; "
                    "periodic checkpoints are disabled for this run")
            else:
                self._next_ckpt_ns = config.faults.checkpoint.interval
        if config.experimental.plane_kernel != "xla":
            # the config validates `plane_kernel: pallas` but no
            # Manager-driven run consults it: the use_tpu_transport
            # device path has its own fused kernels, and the CPU object
            # plane / flow engine run no window_step at all — only the
            # general plane's drivers (bench.py via BENCH_PLANE_KERNEL,
            # tools/profile_plane.py --kernel, direct window_step
            # callers) honor the flag. A silent no-op here looked like a
            # broken feature (docs/performance.md caveat), so warn
            # loudly / refuse under `strict: true`.
            self._unsupported_combo(
                f"experimental.plane_kernel: "
                f"{config.experimental.plane_kernel!r} is not consulted "
                "by Manager-driven runs (use_tpu_transport has its own "
                "fused kernels; the CPU plane runs no window_step) — "
                "this run proceeds on its default kernels; the flag "
                "governs bench.py and tools/profile_plane.py only")
        if config.telemetry.flight_recorder.enabled:
            # the sampled hop recorder rides the device-plane WINDOW
            # drivers (bench.py, tools/chaos_smoke.py,
            # tools/run_scenarios.py), which own the fixed window
            # cadence its virtual timestamps decode against;
            # Manager-driven rounds have no such driver loop — a
            # silently-ignored opt-in would look like a broken feature
            # (docs/observability.md "Distributions and the flight
            # recorder")
            self._unsupported_combo(
                "telemetry.flight_recorder is not consulted by "
                "Manager-driven runs: sampled per-packet hop tracing "
                "rides the device-plane window drivers (bench.py, "
                "tools/chaos_smoke.py, tools/run_scenarios.py) — this "
                "run proceeds without hop tracing; telemetry.histograms "
                "remains available on the use_tpu_transport path")
        if config.flows.enabled:
            # the flow plane (RTO retransmit / congestion
            # backpressure) threads the device-plane window drivers —
            # tools/run_scenarios.py executes it for scenarios with
            # `transport: flows`; Manager-driven runs use the CPU
            # socket machinery (or use_tpu_transport), neither of
            # which consults this block — a silently-ignored opt-in
            # would look like a broken feature (docs/robustness.md
            # "Flow plane")
            self._unsupported_combo(
                "flows.enabled is not consulted by Manager-driven "
                "runs: the device flow plane rides the window drivers "
                "(tools/run_scenarios.py, scenarios with `transport: "
                "flows`) — this run proceeds on its normal socket "
                "transport")
        if config.workload.enabled or config.workload.scenario not in (
                None, "off"):
            # the workload plane's generators ride the device-plane
            # window drivers (tools/run_scenarios.py is the driver);
            # Manager-driven runs execute managed processes, not
            # scenario programs — a silently-ignored `workload:` block
            # would look like a broken feature (docs/workloads.md)
            self._unsupported_combo(
                "workload.enabled is not consulted by Manager-driven "
                "runs: scenario traffic programs run through the "
                "device-plane drivers (tools/run_scenarios.py) — this "
                "run proceeds without the declared workload")
        if config.experimental.use_flow_engine:
            # unsupported feature combinations: log-and-ignore by
            # default; `strict: true` promotes each to a ConfigError
            # (exit 2) so CI and wrappers never silently lose a
            # requested feature
            if config.faults.any_injection() or config.faults.watchdog:
                # the flow engine has no hosts, processes, or round loop
                # to inject against; a silently-ignored schedule would
                # look like a broken feature
                self._unsupported_combo(
                    "faults injection/watchdog are not supported with "
                    "experimental.use_flow_engine; only checkpoint/resume "
                    "applies to flow-engine runs")
            if config.telemetry.enabled:
                # the flow engine never runs the round loop the
                # harvester hooks; a silently-ignored opt-in would look
                # like a broken feature
                self._unsupported_combo(
                    "telemetry.enabled is not supported with "
                    "experimental.use_flow_engine; no heartbeats or "
                    "trace will be emitted for this run")
            if config.guards.enabled:
                # guards hook the round loop, the transport kernels,
                # and the harvest boundary — none of which exist here
                self._unsupported_combo(
                    "guards.enabled is not supported with "
                    "experimental.use_flow_engine; no invariants will "
                    "be checked for this run")
            return

        # --- IP assignment + host seeds (config-declared order) -------------
        ips = netgraph.IpAssignment()
        host_plans = []
        for name, opts in config.hosts.items():
            if opts.ip_addr is not None:
                ips.assign_manual(opts.ip_addr, opts.network_node_id)
                ip = opts.ip_addr
            else:
                ip = ips.assign_auto(opts.network_node_id)
            seed = host_seed_for(self.global_rng, name)
            host_plans.append((name, opts, ip, seed))

        # --- runahead from the routing table --------------------------------
        min_latency = self.routing.get_smallest_latency_ns()
        self.runahead = Runahead(
            config.experimental.use_dynamic_runahead,
            min_latency,
            config.experimental.runahead,
        )
        self.controller = Controller(config.general.stop_time, self.runahead)

        # --- hosts -----------------------------------------------------------
        ip_to_host: dict[str, Host] = {}
        ip_to_node: dict[str, int] = {}
        raw_freq_khz = _raw_cpu_frequency_khz()
        for host_id, (name, opts, ip, seed) in enumerate(host_plans, start=1):
            node = self.graph.node_by_id(opts.network_node_id)
            bw_down = opts.bandwidth_down or node.bandwidth_down
            bw_up = opts.bandwidth_up or node.bandwidth_up
            if bw_down is None or bw_up is None:
                raise netgraph.GraphError(
                    f"host {name!r}: no bandwidth on host or graph node "
                    f"{opts.network_node_id}"
                )
            host_opts = config.host_defaults.merged_with(opts.host_options).resolved()
            pcap_factory = self._make_pcap_factory(name, host_opts)
            # sim freq == native freq, like `manager.rs:565` passing the
            # machine's raw frequency as the host frequency; threshold None
            # keeps the model (and its wall-time nondeterminism) off
            cpu = Cpu(
                raw_freq_khz, raw_freq_khz,
                config.experimental.cpu_threshold,
                config.experimental.cpu_precision,
            )
            host = Host(
                cpu=cpu,
                host_id=host_id,
                name=name,
                ip=ip,
                node_id=opts.network_node_id,
                seed=seed,
                bandwidth_down_bps=bw_down,
                bandwidth_up_bps=bw_up,
                qdisc=config.experimental.interface_qdisc,
                experimental=config.experimental,
                pcap_factory=pcap_factory,
                model_unblocked_syscall_latency=(
                    config.general.model_unblocked_syscall_latency
                ),
            )
            if config.experimental.host_path_isolation:
                # per-host filesystem view (file-family syscalls): the
                # redirect root lives beside the host's output dir; a
                # shared per-run temp root stands in when no data dir
                # was given
                host.vfs_enabled = True
                # ABSOLUTE: the rewritten path is resolved by the GUEST
                # against ITS cwd, and the simulator's own makedirs
                # against ours — only an absolute root means the same dir
                host.vfs_host_dir = os.path.abspath(os.path.join(
                    self._vfs_data_root(), "hosts", name))
                host.vfs_root = os.path.join(host.vfs_host_dir, "root")
            self.hosts.append(host)
            self.hosts_by_name[name] = host
            ip_to_host[ip] = host
            ip_to_node[ip] = opts.network_node_id
            self.dns.register(name, ip)
            self._wire_processes(host, name, opts)

        # the simulation's /etc/hosts view, consumed by the addrinfo
        # preload so managed binaries resolve simulated hostnames
        # (`shim_api_addrinfo.c` + the reference's mounted hosts file)
        import tempfile

        if self.data_dir:
            os.makedirs(self.data_dir, exist_ok=True)
            # absolute: the path is handed to managed processes whose cwd
            # is their per-host data dir, not the simulator's
            hosts_path = os.path.abspath(
                os.path.join(self.data_dir, "etc-hosts"))
        else:
            fd, hosts_path = tempfile.mkstemp(prefix="shadow-hosts-")
            os.close(fd)
            self._hosts_file_temp = True  # unlinked at run() teardown
        with open(hosts_path, "w") as fh:
            fh.write(self.dns.hosts_file())
        self.hosts_file_path = hosts_path
        for host in self.hosts:
            host.hosts_file_path = hosts_path

        self.shared = WorkerShared(
            dns=self.dns,
            routing=self.routing,
            ip_to_host=ip_to_host,
            ip_to_node_id=ip_to_node,
            runahead=self.runahead,
            sim_end_time=config.general.stop_time,
            bootstrap_end_time=config.general.bootstrap_end_time,
        )
        self.transport = None
        if config.experimental.use_tpu_transport:
            from ..tpu.transport import DeviceTransport

            self.transport = DeviceTransport(
                self.hosts, self.routing, ip_to_node,
                egress_cap=config.experimental.tpu_egress_cap,
                ingress_cap=config.experimental.tpu_ingress_cap,
                mode=config.experimental.tpu_transport_mode,
                compact_cap=config.experimental.tpu_compact_cap,
                capacity_mode=config.capacity.mode,
                max_doublings=config.capacity.max_doublings,
                # top-level strict promotes fixed-mode ring drops to the
                # strict capacity failure: a strict caller never
                # silently loses packets to simulator capacity
                capacity_strict=(
                    config.capacity.mode == "strict"
                    or (config.strict
                        and config.capacity.mode == "fixed")),
                device=device,
            )
            self.shared.device_transport = self.transport
            # self-healing: transient device errors retry with backoff
            # before the crash path (faults/healing.py)
            self.transport.retry_attempts = config.faults.device_retries
            self.transport.retry_backoff_s = config.faults.retry_backoff / 1e9
            self.transport.retry_cap_s = config.faults.retry_cap / 1e9
            self.transport.retry_jitter = config.faults.retry_jitter
            # the retry sleep schedule is seeded like the fault plane
            # (faults.seed falls back to general.seed) so identical
            # configs retry on identical wall cadences
            self.transport.retry_seed = (
                config.faults.seed if config.faults.seed is not None
                else config.general.seed)
            # guard plane: thread the device invariant accumulator
            # through every transport dispatch, and pair the device
            # counters with the CPU ledger for reconciliation (mid-run
            # pairs are only meaningful in sync mode — the mirrored
            # device re-executes windows in lagged batches, so there
            # reconciliation runs on the settled teardown snapshot)
            if config.guards.active("device"):
                self.transport.enable_guards()
            if config.guards.active("reconcile"):
                from ..guards.reconcile import TransportReconciler

                self._guard_recon = TransportReconciler(
                    self.transport, [h.name for h in self.hosts],
                    mid_run=self.transport.mode == "sync")

        # --- fault plane (faults/schedule.py; docs/robustness.md) -----------
        # compiled HERE so a bad `faults:` block dies as a ConfigError
        # before anything runs; the schedule is shared with every worker
        # through the send-packet overlay
        if config.faults.any_injection():
            from ..faults.schedule import compile_schedule

            node_map = {
                opts.network_node_id: self.routing.node_index(
                    opts.network_node_id)
                for opts in config.hosts.values()
            }
            self.fault_schedule = compile_schedule(
                config.faults,
                host_names=[h.name for h in self.hosts],
                n_nodes=len(self.routing.latency_ns),
                seed=config.general.seed,
                stop_time_ns=config.general.stop_time,
                node_index=lambda nid: node_map[nid],
            )
            self.fault_schedule.set_node_map(node_map)
            self.shared.fault_plane = self.fault_schedule
            log.info("fault plane: %d scheduled event(s), fingerprint %s",
                     len(self.fault_schedule.events),
                     self.fault_schedule.fingerprint()[:12])

        # guard plane: the round-loop zero-progress detector (the
        # virtual-time complement of the wall-clock watchdog)
        if config.guards.active("progress"):
            from ..guards.progress import ProgressDetector

            self._progress = ProgressDetector(
                config.guards.progress_rounds)

        # parallelism = min(cores, hosts) unless configured
        par = config.general.parallelism
        if par <= 0:
            par = min(os.cpu_count() or 1, len(self.hosts))

        # random thread-assignment order (`manager.rs:272`); per-round host
        # iteration uses this fixed shuffled order
        self._host_order = list(self.hosts)
        self.global_rng.shuffle(self._host_order)

        # Active-host heap: only hosts with an event before the round end
        # are iterated each round. Hosts announce new events through the
        # dirty sink (one append per host per round, under their queue
        # lock); the Manager re-keys them at round barriers. At 1k+ hosts
        # the old iterate-everyone round loop spent more wall time polling
        # idle hosts than executing events.
        self._host_heap: list[tuple[int, int]] = []  # (next_t, host_id)
        self._dirty_hosts: list = []
        self._cross_hosts: list = []
        self._host_by_id = {h.host_id: h for h in self.hosts}
        for host in self.hosts:
            host._dirty_sink = self._dirty_hosts
            host._cross_sink = self._cross_hosts

        self.scheduler = make_scheduler(
            config.experimental.scheduler, self.shared, par,
            hosts=self._host_order,
            pin_cpus=config.experimental.use_cpu_pinning,
        )

        self.stats = SimStats()

        # manager heartbeat + resource watchdogs + status printer state
        # (`manager.rs:380-388,439-453`, `controller.rs:116-168`)
        self._heartbeat_interval = config.general.heartbeat_interval
        self._last_heartbeat = 0
        self._check_fd_usage = True
        self._check_mem_usage = True
        self._last_resource_check = 0.0
        self._progress_enabled = config.general.progress
        self._last_progress = 0.0
        self._wall_start = 0.0

        # Per-host trackers dispatch off the packet status-trace stream —
        # only when something consumes them (heartbeats or stats output),
        # so library runs with heartbeats disabled pay nothing per packet.
        from ..host.tracker import Tracker
        from ..net import packet as packet_mod

        hb = config.experimental.host_heartbeat_interval
        if hb or self.data_dir:
            self.trackers = {
                h.name: Tracker(h, hb) for h in self.hosts
            }
            # per-instance wrapper so run()'s cleanup can tell OUR hook from
            # one installed by a different Manager in the same process.
            # Early-out on statuses no tracker reacts to BEFORE the
            # current-host lookup: this hook fires on every status
            # transition of every packet (~10 per packet), and only ~3
            # of them move a counter
            # the hook fires on every status transition (~10 per
            # packet); early-out here on the ~3 statuses trackers react
            # to. The filter lives in OUR closure, not the packet
            # module, so a replacement full-stream tracer is unaffected
            wanted = frozenset(
                packet_mod.PacketStatus(s) for s in Tracker.WANTED)
            self._status_hook = lambda packet, status: (
                _tracker_dispatch(packet, status)
                if status in wanted else None)
            packet_mod.status_trace_hook = self._status_hook
        else:
            self.trackers = {}
            self._status_hook = None

    def _unsupported_combo(self, message: str) -> None:
        """Unsupported feature-combination handling (flow-engine combos,
        the plane_kernel no-op): warn by default, ConfigError under
        top-level `strict: true` (exit 2) — the feature the config asked
        for will NOT run, and strict callers want that to be fatal, not
        a log line."""
        if self.config.strict:
            from .config import ConfigError

            raise ConfigError(f"strict mode: {message}")
        log.warning(message)

    # -- telemetry ------------------------------------------------------

    def _telemetry_sink_path(self) -> Optional[str]:
        t = self.config.telemetry
        if t.sink == "off":
            return None  # log-summary-only mode
        if t.sink:
            return t.sink
        return (os.path.join(self.data_dir, "telemetry.jsonl")
                if self.data_dir else None)

    def _telemetry_trace_path(self) -> Optional[str]:
        t = self.config.telemetry
        if t.trace == "off":
            return None
        if t.trace:
            return t.trace
        return (os.path.join(self.data_dir, "trace.json")
                if self.data_dir else None)

    def _start_telemetry(self) -> None:
        if not self.config.telemetry.enabled:
            return
        from ..telemetry.harvest import TelemetryHarvester

        if self.config.telemetry.histograms:
            if self.transport is not None:
                # per-destination delivery-latency / in-flight-depth
                # log2 histograms ride the transport kernels as a
                # static presence switch and drain through the same
                # async harvest (docs/observability.md "Distributions
                # and the flight recorder")
                self.transport.enable_histograms()
            else:
                self._unsupported_combo(
                    "telemetry.histograms needs the device transport "
                    "(experimental.use_tpu_transport): the CPU object "
                    "plane has no device counter arrays to bucket — "
                    "this run emits no histograms")

        on_drain = None
        if self._guard_recon is not None:
            # cross-plane reconciliation rides the harvester's drain:
            # the device snapshot for a tick materializes one interval
            # later, and is compared against the CPU ledger copied at
            # the SAME tick (guards/reconcile.py) — zero added syncs
            def on_drain(time_ns, device_totals, cpu):
                self._guard_ledger.apply(
                    "reconcile",
                    self._guard_recon.on_drain(time_ns, device_totals,
                                               cpu))

        self.harvester = TelemetryHarvester(
            interval_ns=self.config.telemetry.interval,
            sink=self._telemetry_sink_path(),
            host_names=[h.name for h in self.hosts],
            per_host=self.config.telemetry.per_host,
            # heartbeats are retained in memory only for the trace
            # export; with the trace off they'd be dead weight on a
            # long run (per-host records every interval)
            retain=bool(self._telemetry_trace_path()),
            on_drain=on_drain,
        )

    def _telemetry_tick(self, now_ns: int) -> None:
        """One harvest: device transport counters (fresh undonated
        copies; the D2H pull is asynchronous and materializes a full
        interval later) merged with the CPU tracker counters under the
        host-id namespace."""
        device = (self.transport.telemetry_arrays()
                  if self.transport is not None else None)
        if device is not None:
            # [N, B] histogram leaves merge into the same device dict;
            # the harvester splits them off by rank (empty when
            # telemetry.histograms is off)
            device = {**device, **self.transport.histogram_arrays()}
        cpu = {
            t.host.host_id: t.counters.as_dict()
            for t in self.trackers.values()
        } or None
        drain = getattr(self.transport, "drain_capacity_events", None)
        if drain is not None:
            # capacity resize events ride the heartbeat stream (and the
            # trace as instants) — a run that grew its rings says so in
            # its own telemetry, not only in a log line
            for ev in drain():
                self.harvester.note_event(ev)
        self.harvester.tick(now_ns, device=device, cpu=cpu)
        if self._guard_recon is not None:
            # pair the device snapshot just started with a same-instant
            # CPU ledger copy; compared when the harvester drains it
            self._guard_recon.note_tick(now_ns)

    def _finish_telemetry(self) -> None:
        if self.harvester is None:
            return
        self._telemetry_tick(self.config.general.stop_time)
        self.harvester.finalize()
        trace_path = self._telemetry_trace_path()
        if trace_path:
            from ..telemetry import export

            info = export.write_perfetto_trace(
                self.harvester.heartbeats, trace_path)
            log.info("telemetry trace: %s (%d events, %d hosts)",
                     trace_path, info["events"], info["hosts_plotted"])

    # ------------------------------------------------------------------

    def _make_pcap_factory(self, host_name: str, host_opts):
        """Per-host, per-interface pcap capture when enabled and a data dir
        exists (`host.rs:279-282` PcapConfig; lo.pcap + eth0.pcap like the
        reference)."""
        if not self.data_dir or not host_opts.pcap_enabled:
            return None
        import os

        from ..utils.pcap import PcapWriter

        host_dir = os.path.join(self.data_dir, "hosts", host_name)
        os.makedirs(host_dir, exist_ok=True)
        snaplen = host_opts.pcap_capture_size
        if snaplen is None:
            snaplen = 65535

        def factory(iface_name: str):
            writer = PcapWriter(
                open(os.path.join(host_dir, f"{iface_name}.pcap"), "wb"), snaplen
            )
            self._pcap_writers.append(writer)

            def hook(packet, inbound, _writer=writer):
                host = worker_mod.current_host()
                _writer.record(packet, host.now() if host else 0)

            return hook

        return factory

    def _vfs_data_root(self) -> str:
        if self.data_dir:
            return self.data_dir
        root = getattr(self, "_tmp_data_root", None)
        if root is None:
            import tempfile

            root = self._tmp_data_root = tempfile.mkdtemp(
                prefix="shadow-tpu-vfs-")
        return root

    def _wire_processes(self, host: Host, host_name: str, opts) -> None:
        """Schedule spawn (and optional shutdown-signal) tasks for each
        configured process (`manager.rs:551` build_host + `host.rs:406-454`
        add_application)."""
        from .. import apps as app_registry
        from ..process.process import SimProcess
        from .event import TaskRef

        self._spawned = getattr(self, "_spawned", [])
        # per-host spawn registry: the fault plane's reboot-respawn and
        # the watchdog's blame collector both need (cell, spawn) by host
        self._respawn_by_host = getattr(self, "_respawn_by_host", {})
        for i, popt in enumerate(opts.processes):
            # app-registry coroutines first; real executables run as managed
            # native processes under the interposition shim
            app = None
            try:
                app = app_registry.resolve(popt.path)
            except ValueError:
                import shutil as _shutil

                if not (os.path.isfile(popt.path) and os.access(popt.path, os.X_OK)) \
                        and _shutil.which(popt.path) is None:
                    raise
                from .config import ConfigError

                raise ConfigError(
                    f"host {host_name!r}: process {popt.path!r} is a real "
                    f"executable; the port runs the built-in apps only "
                    f"(shadow_tpu_torch.apps), and {MANAGED_PROCESS_SLICE} "
                    f"are a later slice of the port") from None
            proc_name = f"{host_name}.{popt.path.rsplit('/', 1)[-1]}.{i}"
            cell: dict = {}

            def spawn(h, app=app, popt=popt, proc_name=proc_name, cell=cell):
                proc = SimProcess(h, proc_name, app, tuple(popt.args))
                cell["proc"] = proc
                proc.spawn()
                if cell.get("pending_kill") is not None and proc.is_alive:
                    # shutdown_time <= start_time: deliver the signal at
                    # the spawn instant rather than dropping it
                    proc.stop(cell["pending_kill"])

            host.add_application(popt.start_time, spawn)
            if popt.shutdown_time is not None:

                def shutdown(h, popt=popt, cell=cell):
                    proc = cell.get("proc")
                    if proc is not None:
                        proc.stop(popt.shutdown_signal)
                    else:
                        # spawn hasn't run yet (same-timestamp ordering or
                        # shutdown before start): record the pending kill
                        cell["pending_kill"] = popt.shutdown_signal

                host.schedule_task_at(
                    TaskRef(shutdown, "process-shutdown"), popt.shutdown_time
                )
            self._spawned.append((proc_name, popt, cell))
            self._respawn_by_host.setdefault(host_name, []).append(
                (proc_name, popt, cell, spawn))

    def _check_final_states(self) -> list:
        """Compare each process against expected_final_state
        (`worker.rs:589-604` plugin-error accounting)."""
        from ..process.process import ProcessState

        failures = []
        for proc_name, popt, cell in getattr(self, "_spawned", []):
            proc = cell.get("proc")
            exp = popt.expected_final_state
            if proc is None:
                failures.append((proc_name, "never spawned"))
                continue
            if not self._final_state_ok(proc, exp):
                failures.append(
                    (
                        proc_name,
                        f"expected {exp.kind.value}({exp.value}), got "
                        f"{proc.state.value}(exit={proc.exit_status} "
                        f"sig={proc.kill_signal})",
                    )
                )
        return failures

    def _rekey_hosts(self, hosts) -> None:
        """Recompute next-event times and re-enter the heap. Called only
        at round barriers (hosts quiescent). Stale heap entries are
        dropped lazily at pop time by comparing against
        host._cached_next."""
        heap = self._host_heap
        for host in hosts:
            host._dirty = False
            t = host.next_event_time()
            if t != host._cached_next:
                host._cached_next = t
                if t is not None:
                    heapq.heappush(heap, (t, host.host_id))

    def _rekey_dirty(self) -> None:
        """Round-barrier pass: every host that gained an event since the
        last barrier re-enters the heap (the sink list object is shared
        with the hosts, so it is drained in place)."""
        if self._dirty_hosts:
            dirty = self._dirty_hosts[:]
            self._dirty_hosts.clear()
            self._rekey_hosts(dirty)

    def _min_host_event(self):
        """Earliest pending event time across all hosts (None = all idle);
        lazily discards stale heap entries."""
        self._rekey_dirty()
        heap = self._host_heap
        by_id = self._host_by_id
        while heap:
            t, hid = heap[0]
            if by_id[hid]._cached_next == t:
                return t
            heapq.heappop(heap)
        return None

    def _pop_active(self, end_ns: int) -> list:
        """Hosts with an event before `end_ns`, in deterministic
        (next_t, host_id) order; they leave the heap (re-keyed after the
        round runs)."""
        self._rekey_dirty()
        heap = self._host_heap
        by_id = self._host_by_id
        active = []
        while heap and heap[0][0] < end_ns:
            t, hid = heapq.heappop(heap)
            host = by_id[hid]
            if host._cached_next == t:
                host._cached_next = None
                active.append(host)
        return active

    # -- heartbeat / watchdogs / progress (`manager.rs:675-793`) --------

    def _log_heartbeat(self, now_ns: int) -> None:
        """The tornettools-contract rusage line + a meminfo JSON line.
        Format is contractually stable (`manager.rs:692-717`)."""
        ru = resource_usage.rusage_self()
        log.info(
            "Process resource usage at simtime %d reported by getrusage(): "
            "ru_maxrss=%.03f GiB, ru_utime=%.03f minutes, "
            "ru_stime=%.03f minutes, ru_nvcsw=%d, ru_nivcsw=%d",
            now_ns,
            ru.ru_maxrss / 1048576.0,  # KiB -> GiB
            ru.ru_utime / 60.0,
            ru.ru_stime / 60.0,
            ru.ru_nvcsw,
            ru.ru_nivcsw,
        )
        try:
            mem = resource_usage.meminfo()
        except OSError as e:
            log.warning("unable to read /proc/meminfo: %s", e)
            return
        log.info(
            "System memory usage in bytes at simtime %d ns reported by "
            "/proc/meminfo: %s",
            now_ns,
            json.dumps(mem),
        )

    def _check_resource_usage(self) -> None:
        """Warn-once watchdogs: fd usage >90%%, free memory <500 MiB
        (`manager.rs:719-751`)."""
        if self._check_fd_usage:
            try:
                usage, limit = resource_usage.fd_usage()
                if usage > limit * 90 // 100:
                    log.warning(
                        "Using more than 90%% (%d/%d) of available file "
                        "descriptors", usage, limit)
                    self._check_fd_usage = False
            except OSError as e:
                log.warning("Unable to check fd usage: %s", e)
                self._check_fd_usage = False
        if self._check_mem_usage:
            try:
                remaining = resource_usage.memory_remaining()
                if remaining < 500 * 1024 * 1024:
                    log.warning("Only %d MiB of memory available",
                                remaining // 1024 // 1024)
                    self._check_mem_usage = False
            except OSError as e:
                log.warning("Unable to check memory usage: %s", e)
                self._check_mem_usage = False

    @staticmethod
    def _final_state_ok(proc, exp) -> bool:
        """The expected_final_state predicate, shared by the end-of-run
        check and the live progress counter (`worker.rs:589-604`)."""
        from ..process.process import ProcessState

        if exp.kind == FinalState.RUNNING:
            return proc.state == ProcessState.RUNNING
        if exp.kind == FinalState.EXITED:
            return (proc.state == ProcessState.EXITED
                    and proc.exit_status == exp.value)
        return (proc.state == ProcessState.KILLED
                and proc.kill_signal == exp.value)

    def _live_failures(self) -> int:
        """Processes already finished in a state that contradicts their
        expected_final_state (the status bar's failed counter)."""
        from ..process.process import ProcessState

        n = 0
        for _name, popt, cell in getattr(self, "_spawned", []):
            proc = cell.get("proc")
            if proc is None or proc.state == ProcessState.RUNNING:
                continue  # still running = not failed yet
            if not self._final_state_ok(proc, popt.expected_final_state):
                n += 1
        return n

    def _print_progress(self, now_ns: int) -> None:
        """`controller.rs:123-142` status line, at most once per wall
        second, to stderr (the non-TTY "printer" flavor)."""
        stop = max(1, self.config.general.stop_time)
        frac = min(100, round(100 * now_ns / stop))
        # shadowlint: disable=SL101 -- progress line realtime display; never feeds sim state
        wall = _walltime.monotonic() - self._wall_start
        print(
            f"{frac}% — simulated: {simtime.fmt(now_ns)}/"
            f"{simtime.fmt(stop)}, realtime: {wall:.1f}s, "
            f"processes failed: {self._live_failures()}",
            file=sys.stderr, flush=True,
        )

    # -- fault plane + self-healing (docs/robustness.md) ----------------

    def _fault_horizon(self, min_next):
        """Fold the next fault instant into the window computation so a
        round boundary lands EXACTLY on each scheduled fault — the
        SIGKILL/respawn happens at the configured virtual instant, not
        at whatever boundary drifts past it."""
        if self.fault_schedule is None:
            return min_next
        nxt = self.fault_schedule.peek_next_ns()
        if nxt is None or nxt >= self.controller.stop_time:
            return min_next
        return nxt if min_next is None else min(min_next, nxt)

    def _clamp_window_to_fault(self, start: int, end: int) -> int:
        """A fault instant STRICTLY INSIDE a window would otherwise fire
        a full runahead late (the start-side fold above only helps when
        the fault is the earliest event): shrink the round end to the
        fault instant so the next boundary lands on it. Shorter windows
        are always legal under conservative PDES."""
        if self.fault_schedule is None:
            return end
        nxt = self.fault_schedule.peek_next_ns()
        if nxt is not None and start < nxt < end:
            return nxt
        return end

    def _apply_faults(self, now_ns: int) -> None:
        """Fire every fault event due at this round boundary, mirroring
        the schedule's mask state onto the CPU objects (the device masks
        are read off the same schedule by device-plane drivers)."""
        if self.fault_schedule is None:
            return
        from .event import TaskRef

        link_changed = False
        for ev in self.fault_schedule.advance(now_ns):
            log.warning("fault plane: firing %s", ev.describe())
            if ev.kind in ("link_degrade", "link_restore"):
                link_changed = True  # table rebuilt ONCE after the loop
                continue
            host = self.hosts_by_name[ev.host]
            if ev.kind == "host_crash":
                purged = host.fault_crash()
                killed = 0
                for _pn, _popt, cell, _spawn in \
                        self._respawn_by_host.get(ev.host, ()):
                    proc = cell.get("proc")
                    if proc is not None and proc.is_alive:
                        proc.stop(9)  # SIGKILL at the virtual instant
                        killed += 1
                log.warning(
                    "fault plane: host %s crashed at %d (%d event(s) "
                    "purged, %d process(es) SIGKILLed)",
                    ev.host, now_ns, purged, killed)
            elif ev.kind == "host_reboot":
                host.fault_reboot()
                respawned = 0
                if self.config.faults.respawn_on_reboot:
                    for pn, popt, cell, spawn in \
                            self._respawn_by_host.get(ev.host, ()):
                        t = max(now_ns, popt.start_time)
                        host.schedule_task_at(
                            TaskRef(spawn, "process-respawn"), t)
                        respawned += 1
                # crashed hosts lost their heartbeat tasks with the
                # queue; restart the cadence at the reboot instant
                for tracker in self.trackers.values():
                    if tracker.host is host:
                        tracker.start()
                log.warning(
                    "fault plane: host %s rebooted at %d (%d process "
                    "respawn(s) scheduled)", ev.host, now_ns, respawned)
            elif ev.kind in ("iface_down", "iface_up"):
                host.fault_set_iface(ev.kind == "iface_up")
            elif ev.kind in ("host_degrade", "host_restore"):
                div = ev.bandwidth_div if ev.kind == "host_degrade" else 1
                host.relay_inet_out.set_fault_divisor(div)
            # corrupt_burst/_corrupt_end live entirely in the schedule
            # masks the send filter reads
        if link_changed and self.transport is not None:
            # keep on-device deliver arithmetic bit-identical to the CPU
            # overlay. One rebuild per boundary, not per event — the
            # schedule's lat_mult already reflects every event fired
            # above, and apply_fault_latency flushes the mirrored batch
            # and recompiles all four kernels (expensive)
            self.transport.apply_fault_latency(self.fault_schedule.lat_mult)

    def _collect_watchdog_blame(self, round_start_ns: int):
        """Runs ON THE WATCHDOG THREAD while workers may still be
        blocked: read-only over the process table + pidwatcher, builds
        the per-host blame the WatchdogError carries."""
        from ..faults.watchdog import HostBlame
        from ..process.pidwatcher import get_watcher

        watched = set(get_watcher().watched_pids())
        blame = []
        for host_name in sorted(self._respawn_by_host):
            procs, pids, wpids = [], [], []
            for proc_name, _popt, cell, _spawn in \
                    self._respawn_by_host[host_name]:
                proc = cell.get("proc")
                if proc is None or not getattr(proc, "is_alive", False):
                    continue
                procs.append(proc_name)
                native = getattr(proc, "proc", None)
                pid = getattr(native, "pid", None)
                if pid:
                    pids.append(pid)
                    if pid in watched:
                        wpids.append(pid)
            if procs:
                blame.append(HostBlame(host_name, procs, pids, wpids))
        return blame

    # -- guard plane (docs/robustness.md "Guard plane") ------------------

    def _collect_host_waits(self):
        """Who is waiting on what: every host holding alive processes,
        with its next queued event (None = blocked purely on input).
        Read-only over the process table, like the watchdog blame."""
        from ..guards.progress import HostWait
        from ..process.process import ProcessState

        waits = []
        for host_name in sorted(getattr(self, "_respawn_by_host", {})):
            procs = []
            for proc_name, _popt, cell, _spawn in \
                    self._respawn_by_host[host_name]:
                proc = cell.get("proc")
                if proc is None:
                    continue
                alive = getattr(proc, "is_alive", None)
                if alive is None:
                    alive = proc.state == ProcessState.RUNNING
                if alive:
                    procs.append(proc_name)
            if procs:
                host = self.hosts_by_name[host_name]
                waits.append(HostWait(host_name, procs,
                                      host.next_event_time()))
        return waits

    def _observe_progress(self, window_start: int, active,
                          events_before: int) -> None:
        """One round's progress sample: host events executed + packets
        moved. Everything observed is virtual-time/counter state — a
        run that never stalls is bitwise-unaffected."""
        events_after = sum(h.n_events_executed for h in active)
        packets_now = int(self.routing.packet_counters.sum())
        diagnosis = self._progress.observe(
            window_start,
            events_delta=events_after - events_before,
            packets_delta=packets_now - self._progress_packets,
        )
        self._progress_packets = packets_now
        if diagnosis is not None:
            diagnosis.waiting = self._collect_host_waits()
            diagnosis.device_in_flight = (
                self.transport.in_flight if self.transport else 0)
            self._guard_ledger.apply("progress",
                                     [diagnosis.to_violation()])

    def _final_guard_checks(self) -> None:
        """Teardown self-verification on settled counters: the device
        guard accumulator (transport kernels) and the full cross-plane
        reconciliation including SimStats fleet totals. Blocking pulls
        are fine here — the run is over."""
        if self._guard_ledger is None:
            return
        from ..guards.report import GuardViolation

        if self.transport is not None:
            report = self.transport.guard_report()
            if report is not None and not report["clean"]:
                self._guard_ledger.apply("device", [GuardViolation(
                    cls="device", check=",".join(report["classes"]),
                    time_ns=self.config.general.stop_time,
                    expected="clean device guard accumulator",
                    actual=report["classes"],
                    detail=f"first violation at guarded dispatch "
                           f"{report['first_window']} of "
                           f"{report['windows']}")])
        if self._guard_recon is not None:
            self._guard_ledger.apply(
                "reconcile",
                self._guard_recon.final(
                    self.config.general.stop_time,
                    packets_sent=self.stats.packets_sent))

    def _write_guard_report(self) -> None:
        if self._guard_ledger is None or not self.data_dir:
            return
        from ..guards.report import write_report

        extra = {"clean": not self._guard_ledger.violations}
        if self.transport is not None:
            try:
                extra["device_guard"] = self.transport.guard_report()
            except Exception as e:  # teardown path: report, don't mask
                log.warning("guards: device report unavailable: %s", e)
        if self._progress is not None:
            extra["progress_trips"] = self._progress.trips
        write_report(self.data_dir, self._guard_ledger, extra=extra)

    def _run_round_guarded(self, start: int, active, end: int):
        """scheduler.run_round under the round watchdog: a wedged
        managed process becomes a WatchdogError with host blame instead
        of a simulator that hangs forever."""
        if self._watchdog is None:
            return self.scheduler.run_round(active, end)
        with self._watchdog.guard(start):
            sched_min = self.scheduler.run_round(active, end)
        if self._watchdog.strike is not None:
            raise self._watchdog.strike
        return sched_min

    def _checkpoint_due(self, window_start: int) -> None:
        interval = self.config.faults.checkpoint.interval
        if (self._next_ckpt_ns is None or self._ckpt_dir is None
                or window_start < self._next_ckpt_ns):
            return
        from ..faults.checkpoint import write_manager_checkpoint

        write_manager_checkpoint(
            self, self._ckpt_dir, window_start, reason="periodic",
            keep=self.config.faults.checkpoint.keep)
        while self._next_ckpt_ns <= window_start:
            self._next_ckpt_ns += interval

    def _emergency_checkpoint(self) -> None:
        """Crash/watchdog path: preserve the forensic state of exactly
        the run that needs explaining. Never raises."""
        if self._ckpt_dir is None:
            return
        from ..faults.checkpoint import write_manager_checkpoint

        write_manager_checkpoint(
            self, self._ckpt_dir, self._last_window_start,
            reason="emergency")

    def _round_upkeep(self, window_start: int) -> None:
        """Per-round heartbeat/watchdog/progress pass (`manager.rs:439-453`)."""
        if (self._heartbeat_interval
                and window_start >= self._last_heartbeat
                + self._heartbeat_interval):
            self._last_heartbeat = window_start
            self._log_heartbeat(window_start)
        # shadowlint: disable=SL101 -- heartbeat/watchdog pacing; never feeds sim state
        wall = _walltime.monotonic()
        if wall - self._last_resource_check >= 30.0:
            self._last_resource_check = wall
            self._check_resource_usage()
        if self._progress_enabled and wall - self._last_progress >= 1.0:
            self._last_progress = wall
            self._print_progress(window_start)
        if self.harvester is not None and self.harvester.due(window_start):
            self._telemetry_tick(window_start)
        self._checkpoint_due(window_start)

    def run(self) -> SimStats:
        if self.config.experimental.use_flow_engine:
            # tgen-shaped workload on the device flow engine: the round
            # loop never runs; flowplan reconciles completions into the
            # same SimStats surface (failures, packets, sim time).
            # Checkpoints are bucket-granular (flowplan.py): --resume
            # skips completed buckets, results bitwise-identical.
            from . import flowplan

            return flowplan.run_flow_simulation(
                self.config, self.routing, self.stats,
                checkpoint_dir=self._ckpt_dir
                if self.config.faults.checkpoint.interval is not None
                or self.resume_from else None,
                resume_from=self.resume_from, device=self.device)
        wall_start = _walltime.monotonic()  # shadowlint: disable=SL101 -- perf stat
        self._wall_start = wall_start
        self._last_resource_check = wall_start
        if self.resume_from:
            # round-loop runs cannot restore mid-run state (host event
            # queues hold live closures, managed processes hold kernel
            # state — docs/robustness.md); only the flow engine and the
            # device-plane drivers resume. Fail loudly, don't pretend.
            from .config import ConfigError

            raise ConfigError(
                "--resume is supported for flow-engine runs "
                "(experimental.use_flow_engine) and device-plane "
                "checkpoints (tools/chaos_smoke.py); round-loop Manager "
                "checkpoints are diagnostic snapshots — see "
                "docs/robustness.md")
        if self.config.faults.watchdog:
            from ..faults.watchdog import RoundWatchdog

            self._watchdog = RoundWatchdog(
                self.config.faults.watchdog / 1e9,
                self._collect_watchdog_blame)
        try:
            # round 0: boot all hosts (schedules application-start tasks)
            for host in self._host_order:
                host.boot()
            for tracker in self.trackers.values():
                tracker.start()
            self._start_telemetry()

            # the scheduling loop (`manager.rs:392-478`)
            min_next = self._min_host_event()
            window = self.controller.next_window(
                self._fault_horizon(min_next))
            while window is not None:
                start, end = window
                self._last_window_start = start
                self._apply_faults(start)
                end = self._clamp_window_to_fault(start, end)
                self._round_upkeep(start)
                if self.transport is not None:
                    # release device-held packets due in this window into
                    # host event queues before anyone executes; the device
                    # chains straight through delivery-free windows up to
                    # the earliest CPU-side event (host queues are
                    # quiescent here, so that horizon is exact). The
                    # fault horizon clamps the chain too: the device must
                    # not run past an instant whose crash/link event the
                    # CPU hasn't applied yet.
                    host_min = self._min_host_event()
                    self.transport.release(
                        start, end, horizon_ns=self._fault_horizon(host_min),
                        runahead_ns=self.runahead.get(),
                        stop_ns=self.controller.stop_time,
                    )
                # only hosts with an event in this window run; everyone
                # else keeps their heap entry untouched
                active = self._pop_active(end)
                events_before = (
                    sum(h.n_events_executed for h in active)
                    if self._progress is not None else 0)
                # sched_min matters in sync device mode: a packet captured
                # this round lives on NEITHER a host queue nor the device
                # yet (ingest happens at finish_round below) — only the
                # sending worker's next_event_time knows its deliver time
                # (`manager.rs:430-436`)
                sched_min = self._run_round_guarded(start, active, end)
                if self.transport is not None:
                    # barrier: ship this round's captured egress to device
                    self.transport.finish_round(start, end)
                # round boundary: absorb watcher-thread posts (managed
                # process deaths) into the now-quiescent host queues.
                # pop() one at a time: a copy-then-clear would race the
                # watcher thread's append between the two ops and lose
                # the host's drain forever (its sink guard only re-arms
                # once _cross_pending empties)
                while self._cross_hosts:
                    self._cross_hosts.pop().drain_cross_thread_tasks()
                # ran hosts left the heap at _pop_active; dirty hosts
                # (event pushes during the round) re-key alongside them
                self._rekey_hosts(active)
                self.stats.rounds += 1
                if self._progress is not None:
                    self._observe_progress(start, active, events_before)
                min_next = self._min_host_event()
                for t in (sched_min,
                          None if self.transport is None
                          else self.transport.next_pending_abs):
                    if t is not None:
                        min_next = t if min_next is None else min(min_next, t)
                window = self.controller.next_window(
                    self._fault_horizon(min_next))

            if self.transport is not None:
                # mirrored mode: drain the lagged device-verification
                # pipeline before declaring the run done
                self.transport.finalize()
                if self.transport.divergence_count:
                    # a diverged mirror is a FAILED run (nonzero CLI
                    # exit), not a log line — the device re-execution is
                    # a correctness gate (VERDICT r4 #6)
                    self.stats.process_failures.append((
                        "device-transport",
                        f"mirrored device transport diverged from the "
                        f"CPU ledger in "
                        f"{self.transport.divergence_count} window(s) "
                        f"of {self.transport.verified_windows} verified",
                    ))

            # absorb any managed-process death the watcher reported too
            # late for a round-boundary drain
            for host in self.hosts:
                for proc in host.processes:
                    reap = getattr(proc, "reap_if_native_dead", None)
                    if reap is not None:
                        reap()

            # final telemetry harvest (after transport finalize so the
            # device counters are settled) + trace export
            self._finish_telemetry()

            # expected-final-state check happens before teardown kills
            # everyone (extend: a transport-divergence failure may
            # already be recorded above)
            self.stats.process_failures.extend(self._check_final_states())

            # teardown (`manager.rs:480-489`)
            for host in self._host_order:
                host.shutdown()
            self.scheduler.join()

            self.stats.sim_time_ns = self.config.general.stop_time
            self.stats.events_executed = sum(
                h.n_events_executed for h in self._host_order)
            self.stats.packets_sent = int(self.routing.packet_counters.sum())
            self.stats.packets_dropped = self.shared.packet_drop_count
            self.stats.packets_dropped_fault = (
                self.shared.fault_drop_count
                + sum(h.fault_packets_dropped for h in self.hosts))
            # the full capacity trajectory (growths + drops, incl.
            # anything finalize() just accounted) lands in the final
            # stats — sim-stats.json carries it verbatim. getattr:
            # tests stand in phantom transports without the policy.
            cap = getattr(self.transport, "capacity", None)
            if cap is not None:
                self.stats.capacity_events = list(cap.events)
            # shadowlint: disable=SL101 -- wall-clock perf stat only
            self.stats.wall_seconds = _walltime.monotonic() - wall_start
            for writer in self._pcap_writers:
                writer.close()

            # guard plane teardown pass: device guard accumulator +
            # full cross-plane reconciliation against the settled
            # SimStats totals. Runs LAST so an abort policy reports on
            # a finished, fully-accounted run (the raise still takes
            # the crash path below: emergency checkpoint + telemetry
            # finalize = the postmortem bundle).
            self._final_guard_checks()
            return self.stats
        except BaseException as e:
            # crash / watchdog path: drop the emergency checkpoint FIRST
            # — it documents exactly the run that is about to die — then
            # let the error propagate through the telemetry-preserving
            # finally below. A plain `abort` guard policy opts out of
            # the checkpoint; `abort+checkpoint` keeps it.
            from ..guards.report import GuardError

            if not isinstance(e, GuardError) or e.want_checkpoint:
                self._emergency_checkpoint()
            raise
        finally:
            # crash path: preserve whatever telemetry is buffered — the
            # run that died is exactly the one the heartbeats should
            # explain. Idempotent after the normal _finish_telemetry.
            if self.harvester is not None:
                try:
                    self.harvester.finalize()
                except Exception as e:  # never mask the primary error
                    log.warning("telemetry flush failed at teardown: %s", e)
            # every guarded run leaves guards-report.json behind — the
            # violation report for aborts, a clean: true record
            # otherwise. write_report never raises.
            self._write_guard_report()
            # a data-dir-less run's per-host filesystem trees live in a
            # private temp root: the caller never asked for persistence
            tmp_root = getattr(self, "_tmp_data_root", None)
            if tmp_root is not None:
                import shutil

                shutil.rmtree(tmp_root, ignore_errors=True)
                self._tmp_data_root = None
            # drop the process-wide status hook so later Manager instances
            # in the same process don't pay per-packet dispatch to a stale
            # tracker set (only if it is still ours — a newer Manager may
            # have installed its own)
            from ..net import packet as packet_mod

            if (
                self._status_hook is not None
                and packet_mod.status_trace_hook is self._status_hook
            ):
                packet_mod.status_trace_hook = None

    @property
    def guard_violations(self) -> list:
        """Every violation the guard plane recorded this run (empty
        when guards are off or the run was clean)."""
        return (list(self._guard_ledger.violations)
                if self._guard_ledger is not None else [])

    def host_stats(self) -> dict:
        """Per-host tracker counters for sim-stats.json, plus perf-timer
        readings when experimental.use_perf_timers is on."""
        out = {name: t.counters.as_dict() for name, t in self.trackers.items()}
        if self.config.experimental.use_perf_timers:
            for host in self.hosts:
                # every handler ever created on the host registers itself
                # (incl. fork children already reaped) — see
                # SyscallHandler.__init__'s perf_handlers registry
                # closed handlers folded their durations into the host
                # aggregate; live ones still hold their own dicts
                agg: dict[int, int] = dict(
                    getattr(host, "perf_syscall_ns", {}))
                for handler in getattr(host, "perf_handlers", []):
                    for nr, ns in handler.syscall_ns.items():
                        agg[nr] = agg.get(nr, 0) + ns
                entry = out.setdefault(host.name, {})
                entry["perf"] = {
                    "execution_ns": host.execution_ns,
                    "syscall_ns": {str(nr): ns
                                   for nr, ns in sorted(agg.items())},
                }
        return out


def run_simulation(config: ConfigOptions) -> SimStats:
    return Manager(config).run()

"""The simulated machine.

Parity: reference `src/main/host/host.rs` — a Host owns its event queue, RNG
(seeded from config, `host.rs:233`), a router plus three relays (inet-out
rate-limited by up-bandwidth, inet-in by down-bandwidth, loopback unlimited,
`host.rs:295-311`), a network namespace, monotone counters that feed the
deterministic event/packet ordering (`host.rs:159-168,679-720`), an optional
CPU model, and its applications. `Host::execute` (`host.rs:810-865`) is the
inner hot loop: pop events below the round end; packet events enter the
router's CoDel queue and wake the inet-in relay; local events run their task.
"""

from __future__ import annotations

import threading
from time import perf_counter_ns as _perf_ns
from typing import Callable, Optional

from ..core.config import QDiscMode
from ..core.event import Event, EventQueue, TaskRef
from ..core.rng import Xoshiro256pp
from ..net.namespace import NetworkNamespace
from ..net.packet import Packet, PacketStatus
from ..net.relay import Relay
from ..net.router import Router
from .cpu import Cpu


class Host:
    def __init__(
        self,
        *,
        host_id: int,
        name: str,
        ip: str,
        node_id: int,
        seed: int,
        bandwidth_down_bps: int,
        bandwidth_up_bps: int,
        qdisc: QDiscMode = QDiscMode.FIFO,
        cpu: Optional[Cpu] = None,
        pcap_factory=None,
        experimental=None,
        model_unblocked_syscall_latency: bool = False,
    ):
        self.host_id = host_id
        self.name = name
        self.ip = ip
        self.node_id = node_id
        self.rng = Xoshiro256pp(seed)
        self.cpu = cpu
        # ExperimentalOptions (socket buffer sizes/autotuning, TCP selection);
        # sockets read their defaults from here.
        self.config_experimental = experimental
        # `general.model_unblocked_syscall_latency` (`configuration.rs`):
        # gates the in-shim latency accumulator for managed processes
        self.model_unblocked_syscall_latency = model_unblocked_syscall_latency

        self.event_queue = EventQueue()
        self._queue_lock = threading.Lock()  # cross-thread packet pushes
        self._cross_lock = threading.Lock()  # cross-thread task posts
        self._cross_pending: list[TaskRef] = []
        # Active-host tracking (the Manager's round heap): any event push
        # appends this host once per round to the dirty sink so the
        # Manager re-keys it at the barrier; hosts with no events before
        # the round end are never iterated at all (at 1k+ hosts the
        # idle-poll loop used to dominate the round cost).
        self._dirty = False
        self._dirty_sink: Optional[list] = None
        self._cross_sink: Optional[list] = None
        self._cached_next: Optional[int] = None  # Manager heap key

        # Deterministic ordering counters (`host.rs:159-168`).
        self._local_event_id = 0
        self._packet_event_id = 0
        self._packet_priority = 0
        self.n_events_executed = 0  # summed into SimStats at teardown
        # perf timers (`host.rs:142-143,722-730`): wall ns spent in
        # execute(), accumulated only when the experimental knob is on
        self._perf_enabled = bool(experimental is not None and getattr(
            experimental, "use_perf_timers", False))
        self.execution_ns = 0
        # virtual PID allocation base (process.FIRST_PID; not imported to
        # keep host free of process-plane dependencies)
        self._next_pid = 1000

        # Clock: maintained by execute(); relays and sockets read it.
        self._now = 0
        # The worker currently executing this host (set by the scheduler).
        self._worker = None
        # Fault plane (faults/schedule.py): True between a host_crash
        # and its host_reboot. A down host executes nothing, accepts no
        # packet events, and its crash purged the queue.
        self.fault_down = False
        self.fault_packets_dropped = 0

        self.netns = NetworkNamespace(ip, qdisc, pcap_factory)
        # The router's address is the unspecified address (`host.rs:298`):
        # get_packet_device maps any non-local address to it, and relays'
        # "local delivery" checks (src address == packet dst) never match it.
        self.router = Router("0.0.0.0", self._send_packet_out, self.now)
        # bits/sec -> bytes/sec for the relay rate limiters
        self.relay_inet_out = Relay(self, ip, bandwidth_up_bps // 8)
        self.relay_inet_in = Relay(self, "0.0.0.0", bandwidth_down_bps // 8)
        self.relay_loopback = Relay(self, "127.0.0.1", None)
        self._in_notify_socket_has_packets = False

        # Applications: (start_time, callable(host)) pairs added before boot.
        self._applications: list[tuple[int, Callable]] = []
        self.processes: list = []  # populated by the process plane

    # -- relay/host environment protocol ------------------------------------

    def now(self) -> int:
        return self._now

    def is_bootstrapping(self) -> bool:
        return self._worker.is_bootstrapping() if self._worker else False

    def get_packet_device(self, ip: str):
        """The host's routing table (`host.rs:965-973`): local interfaces for
        local addresses, the router for everything else."""
        iface = self.netns.interface_for(ip)
        return iface if iface is not None else self.router

    def schedule_relay_task(self, callback: Callable[[], None], delay_ns: int) -> None:
        self.schedule_task_with_delay(TaskRef(lambda host: callback(), "relay"), delay_ns)

    def _send_packet_out(self, packet: Packet) -> None:
        """Router egress → the simulated internet via the worker."""
        self._worker.send_packet(self, packet)

    # -- counters -----------------------------------------------------------

    def next_packet_event_id(self) -> int:
        self._packet_event_id += 1
        return self._packet_event_id

    def next_pid(self) -> int:
        pid = self._next_pid
        self._next_pid += 1
        return pid

    def dns_lookup(self, name: str):
        """Simulated DNS (the worker holds the global registry)."""
        if self._worker is None:
            return None
        return self._worker.shared.dns.name_to_ip(name)

    def get_next_packet_priority(self) -> int:
        self._packet_priority += 1
        return self._packet_priority

    # -- scheduling ---------------------------------------------------------

    def _mark_dirty(self) -> None:
        """Caller holds _queue_lock (or the host is quiescent)."""
        if not self._dirty and self._dirty_sink is not None:
            self._dirty = True
            self._dirty_sink.append(self)

    def schedule_task_at(self, task: TaskRef, time_ns: int) -> None:
        assert time_ns >= self._now, "cannot schedule into the past"
        self._local_event_id += 1
        with self._queue_lock:
            self.event_queue.push(Event.new_local(time_ns, task, self._local_event_id))
            self._mark_dirty()

    def schedule_task_with_delay(self, task: TaskRef, delay_ns: int) -> None:
        self.schedule_task_at(task, self._now + delay_ns)

    def push_packet_event(
        self, packet: Packet, time_ns: int, src_host_id: int, src_event_id: int
    ) -> None:
        """Called from ANY worker thread (`worker.rs:629-639`)."""
        if self.fault_down:
            # crashed destination: the packet event is lost, bucketed as
            # a fault drop (never wire loss). Guards the device-transport
            # release path too — the send-side filter in Worker.send_packet
            # can't see a crash that happened after capture. The counter
            # update takes the queue lock: this runs on ANY worker thread.
            packet.add_status(PacketStatus.FAULT_DROPPED)
            with self._queue_lock:
                self.fault_packets_dropped += 1
            return
        with self._queue_lock:
            self.event_queue.push(
                Event.new_packet(time_ns, packet, src_host_id, src_event_id)
            )
            self._mark_dirty()

    def post_cross_thread_task(self, task: TaskRef) -> None:
        """Queue a task from a non-worker thread (the ChildPidWatcher
        reporting a managed-process death). Posted tasks cannot go straight
        into the event queue — the poster can't observe a coherent host
        clock, and a stale-timestamped event would break the monotonic-pop
        invariant — so the Manager drains them at the next round boundary
        (`drain_cross_thread_tasks`), when the host is quiescent."""
        with self._cross_lock:
            if not self._cross_pending and self._cross_sink is not None:
                self._cross_sink.append(self)
            self._cross_pending.append(task)

    def drain_cross_thread_tasks(self) -> Optional[int]:
        """Round-boundary drain (called by the Manager between rounds, no
        worker running this host): schedules every posted task at the host
        clock and returns that time, or None if nothing was pending."""
        with self._cross_lock:
            pending, self._cross_pending = self._cross_pending, []
        if not pending:
            return None
        for task in pending:
            self.schedule_task_at(task, self._now)
        return self._now

    def next_event_time(self) -> Optional[int]:
        with self._queue_lock:
            return self.event_queue.next_time()

    # -- fault plane (faults/schedule.py; docs/robustness.md) ---------------

    def fault_crash(self) -> int:
        """Host crash at the current round boundary: the event queue and
        inbound router are purged (a crash loses everything), the NIC
        goes down, and no new packet events are accepted until
        `fault_reboot`. Process SIGKILLs are the Manager's job (it owns
        the process table). Returns the number of purged events."""
        self.fault_down = True
        with self._queue_lock:
            purged = self.event_queue.purge()
        for event in purged:
            if event.is_packet:
                event.payload.add_status(PacketStatus.FAULT_DROPPED)
                self.fault_packets_dropped += 1
        purged_router = self.router.purge_for_fault()
        self.fault_packets_dropped += purged_router
        self._cached_next = None  # Manager heap entries go stale lazily
        # the simulated kernel's networking state dies with the host:
        # port associations clear so respawned processes re-bind cleanly
        self.netns.purge_for_fault()
        for iface in (self.netns.internet, self.netns.localhost):
            iface.set_link_up(False)
        return len(purged) + purged_router

    def fault_reboot(self) -> None:
        """Restore connectivity after a crash. Respawning the host's
        configured processes is the Manager's job."""
        self.fault_down = False
        for iface in (self.netns.internet, self.netns.localhost):
            iface.set_link_up(True)

    def fault_set_iface(self, up: bool) -> None:
        """Administrative NIC flap (iface_down/iface_up): the internet
        interface only — loopback stays up, like pulling a cable."""
        self.netns.internet.set_link_up(up)
        if up:
            # kick the relays: backlog queued behind the downed link
            # resumes forwarding at the restore instant
            self.relay_inet_out.notify()
            self.relay_inet_in.notify()

    # -- applications -------------------------------------------------------

    def add_application(self, start_time_ns: int, app: Callable) -> None:
        """Register a callable(host) to run at `start_time_ns` (the process
        plane schedules spawns through this, `host.rs:406-454`)."""
        self._applications.append((start_time_ns, app))

    def boot(self) -> None:
        for start_time, app in self._applications:
            self.schedule_task_at(TaskRef(app, "process-start"), start_time)

    def shutdown(self) -> None:
        for proc in self.processes:
            stop = getattr(proc, "stop", None)
            if stop is not None:
                stop()

    # -- the inner hot loop (`host.rs:810-865`) ------------------------------

    def execute(self, until_ns: int) -> None:
        if self._perf_enabled:
            t0 = _perf_ns()  # shadowlint: disable=SL101 -- opt-in host-exec profiling stat
            try:
                self._execute(until_ns)
            finally:
                # shadowlint: disable=SL101 -- opt-in host-exec profiling stat
                self.execution_ns += _perf_ns() - t0
        else:
            self._execute(until_ns)

    def _execute(self, until_ns: int) -> None:
        while True:
            with self._queue_lock:
                nxt = self.event_queue.next_time()
                if nxt is None or nxt >= until_ns:
                    return
                event = self.event_queue.pop()

            self._now = event.time
            if self._worker is not None:
                self._worker.current_time = event.time

            # CPU oversubscription can push the event into the future
            # (`host.rs:821-849`).
            if self.cpu is not None and self.cpu.threshold is not None:
                self.cpu.update_time(event.time)
                delay = self.cpu.delay()
                if delay > 0:
                    new_time = event.time + delay
                    if event.is_packet:
                        with self._queue_lock:
                            self.event_queue.push(
                                Event.new_packet(
                                    new_time, event.payload, event.key[0], event.key[1]
                                )
                            )
                    else:
                        self._local_event_id += 1
                        with self._queue_lock:
                            self.event_queue.push(
                                Event.new_local(
                                    new_time, event.payload, self._local_event_id
                                )
                            )
                    continue

            # counted here, after the deferral check, so a CPU-deferred
            # event is not tallied twice
            self.n_events_executed += 1
            if event.is_packet:
                self.router.route_incoming_packet(event.payload)
                self.notify_router_has_packets()
            else:
                event.payload.execute(self)

    # -- notifications ------------------------------------------------------

    def notify_router_has_packets(self) -> None:
        self.relay_inet_in.notify()

    def notify_socket_has_packets(self, ip: str, socket) -> None:
        """A socket has data to send on the interface with address `ip`
        (`host.rs:988-1002`). Not reentrant (recursion guard mirrors
        `host.rs:989-991`)."""
        if self._in_notify_socket_has_packets:
            raise AssertionError("recursive notify_socket_has_packets")
        self._in_notify_socket_has_packets = True
        try:
            iface = self.netns.interface_for(ip)
            if iface is None:
                return
            iface.add_data_source(socket)
            if iface is self.netns.localhost:
                self.relay_loopback.notify()
            else:
                self.relay_inet_out.notify()
        finally:
            self._in_notify_socket_has_packets = False

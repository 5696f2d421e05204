"""Per-thread simulation context and the cross-host packet send path.

Parity: reference `src/main/core/worker.rs` — `Worker` holds the active host,
the clock (current time + round end), and a per-thread min next-event-time;
`WorkerShared` holds global read-mostly state (routing tables, DNS, host
registry, runahead, end times). `Worker.send_packet` (`worker.rs:326-410`) is
the ONLY cross-host communication point: it resolves the destination host,
applies Bernoulli path loss (never for zero-payload control packets,
`worker.rs:364-367`; never while bootstrapping), samples path latency, clamps
the delivery time to at least the round end (what makes round-batched
execution legal), and pushes a packet event into the destination host's
queue.

TPU note: in the TPU network plane this entire function becomes a batched
kernel: dense [N,N] latency/loss lookups + counter-based Bernoulli + a
bucketed all-to-all by destination shard (see `shadow_tpu/tpu/`).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..net.packet import Packet, PacketStatus

# Thread-local "which host is executing on this scheduler thread" — the
# dispatch point for per-host instrumentation (tracker counters, strace),
# mirroring the reference's thread-local Worker (`worker.rs:57`).
_active = threading.local()


def current_host():
    return getattr(_active, "host", None)


def current_cpu():
    """The CPU this scheduler thread is pinned to (None = unpinned)."""
    return getattr(_active, "cpu", None)


def set_current_cpu(cpu) -> None:
    _active.cpu = cpu


class WorkerShared:
    """Global state shared by all workers; read-mostly after setup."""

    def __init__(
        self,
        *,
        dns,
        routing,
        ip_to_host,  # dict: ip str -> Host
        ip_to_node_id,  # dict: ip str -> graph node id
        runahead,
        sim_end_time: int,
        bootstrap_end_time: int = 0,
    ):
        self.dns = dns
        self.routing = routing
        self.ip_to_host = ip_to_host
        self.ip_to_node_id = ip_to_node_id
        self.runahead = runahead
        self.sim_end_time = sim_end_time
        self.bootstrap_end_time = bootstrap_end_time
        self.packet_drop_count = 0
        # injected fault-plane drops, kept APART from packet_drop_count
        # so SimStats never conflates a scheduled outage with wire loss
        # (docs/robustness.md drop taxonomy)
        self.fault_drop_count = 0
        # set by the Manager when experimental.use_tpu_transport is on:
        # cross-host delivery runs through the device plane
        self.device_transport = None
        # set by the Manager when a `faults:` schedule is configured: the
        # compiled FaultSchedule whose overlay send_packet consults
        # (crashed endpoints, link latency multipliers, corruption
        # bursts). None = the fault branch below never runs.
        self.fault_plane = None
        # guards the (non-atomic) numpy counter updates and the drop count
        self._count_lock = threading.Lock()

    def latency_and_reliability(self, src_ip: str, dst_ip: str) -> tuple[int, float]:
        src_node = self.ip_to_node_id[src_ip]
        dst_node = self.ip_to_node_id[dst_ip]
        props = self.routing.path(src_node, dst_node)
        return props.latency_ns, 1.0 - props.packet_loss

    def count_packet(self, src_ip: str, dst_ip: str) -> None:
        with self._count_lock:
            self.routing.increment_packet_count(
                self.ip_to_node_id[src_ip], self.ip_to_node_id[dst_ip]
            )

    def count_drop(self) -> None:
        with self._count_lock:
            self.packet_drop_count += 1

    def count_fault_drop(self) -> None:
        with self._count_lock:
            self.fault_drop_count += 1


class Worker:
    """Per-thread context. One exists per scheduler thread (or one total under
    the serial scheduler)."""

    def __init__(self, shared: WorkerShared, worker_id: int = 0):
        self.shared = shared
        self.worker_id = worker_id
        self.active_host = None
        self.current_time: int = 0
        self.round_end_time: int = 0
        # Min delivery time of packets sent this round — the destination may
        # already have executed and reported its next-event time, so the
        # sender's worker accounts for the new event (`manager.rs:430-436`).
        self.next_event_time: Optional[int] = None
        self.syscall_counts: dict[str, int] = {}

    # -- round lifecycle ----------------------------------------------------

    def start_round(self, round_end_time: int) -> None:
        self.round_end_time = round_end_time
        self.next_event_time = None

    def set_active_host(self, host) -> None:
        self.active_host = host
        _active.host = host
        if host is not None:
            host._worker = self

    def update_next_event_time(self, t: int) -> None:
        if self.next_event_time is None or t < self.next_event_time:
            self.next_event_time = t

    def is_bootstrapping(self) -> bool:
        return self.current_time < self.shared.bootstrap_end_time

    # -- the cross-host send path (`worker.rs:326-410`) ---------------------

    def send_packet(self, src_host, packet: Packet) -> None:
        now = self.current_time
        if now >= self.shared.sim_end_time:
            return  # simulation is over, don't bother

        dst_ip = packet.dst[0]
        dst_host = self.shared.ip_to_host.get(dst_ip)
        if dst_host is None:
            # Unroutable destination: model as a silent drop.
            packet.add_status(PacketStatus.INET_DROPPED)
            self.shared.count_drop()
            return

        latency, reliability = self.shared.latency_and_reliability(
            packet.src[0], dst_ip
        )

        # Fault plane (faults/schedule.py): crashed endpoints drop the
        # packet (FAULT_DROPPED, never the loss counter), degraded links
        # multiply latency, and an active corruption burst may draw an
        # extra Bernoulli from the SOURCE host's stream. The filter runs
        # BEFORE the loss draw so a corruption-free schedule consumes
        # exactly the same RNG stream as a faultless run.
        fp = self.shared.fault_plane
        if fp is not None:
            drop, latency = fp.filter_send(
                src_host, dst_host, packet,
                self.shared.ip_to_node_id[packet.src[0]],
                self.shared.ip_to_node_id[dst_ip], latency)
            if drop:
                packet.add_status(PacketStatus.FAULT_DROPPED)
                self.shared.count_fault_drop()
                return

        # Bernoulli path loss from the *source host's* RNG stream — part of
        # the determinism contract. Control packets (payload 0) are never
        # dropped so congestion control can always see loss signals.
        chance = src_host.rng.random()
        if (
            not self.is_bootstrapping()
            and chance >= reliability
            and packet.payload_size() > 0
        ):
            packet.add_status(PacketStatus.INET_DROPPED)
            self.shared.count_drop()
            return

        self.shared.runahead.update_lowest_used_latency(latency)
        self.shared.count_packet(packet.src[0], dst_ip)
        packet.add_status(PacketStatus.INET_SENT)

        # Delay the packet until at least the next round: the destination may
        # have already executed this round.
        deliver_time = max(now + latency, self.round_end_time)
        self.update_next_event_time(deliver_time)

        src_event_id = src_host.next_packet_event_id()
        transport = self.shared.device_transport
        if transport is not None:
            # device mode: the plane computes the deliver time and routes
            # the packet; everything above (RNG draw, counters, statuses,
            # event-id allocation) already happened identically, so event
            # keys — and therefore event order — match the CPU path
            transport.capture(src_host, dst_host, packet, now, src_event_id,
                              self.round_end_time, deliver_time)
            if not transport.mirrored:
                return
            # mirrored mode: the CPU push below is authoritative (bitwise
            # CPU-transport behavior); the device runs the same window
            # asynchronously and is verified against it a few rounds later
        dst_host.push_packet_event(
            packet, deliver_time, src_host.host_id, src_event_id
        )

"""Per-host network namespace: localhost + internet interfaces, port
association, ephemeral port allocation.

Parity: reference `src/main/host/network/namespace.rs` — each host owns a
loopback interface (127.0.0.1) and an internet interface (its public IP);
ephemeral ports are drawn uniformly from [10000, 65535] with the host RNG,
falling back to a linear search when the space is crowded
(`namespace.rs:19-26,210-232`). The RNG draw makes port assignment part of
the determinism contract.
"""

from __future__ import annotations

from typing import Optional

from ..core.config import QDiscMode
from ..core.rng import Xoshiro256pp
from .interface import NetworkInterface, WILDCARD_PEER, InterfaceSocket
from .packet import Protocol

EPHEMERAL_PORT_MIN = 10000
EPHEMERAL_PORT_MAX = 65535  # inclusive


class NoPortsError(RuntimeError):
    pass


class NetworkNamespace:
    def __init__(
        self,
        public_ip: str,
        qdisc: QDiscMode = QDiscMode.FIFO,
        pcap_factory=None,
    ):
        """`pcap_factory(iface_name)` returns a per-interface capture hook
        (or None) — captures are per-interface files (lo.pcap/eth0.pcap)
        like the reference's."""
        self.public_ip = public_ip
        lo_hook = pcap_factory("lo") if pcap_factory else None
        eth_hook = pcap_factory("eth0") if pcap_factory else None
        self.localhost = NetworkInterface("127.0.0.1", qdisc, lo_hook)
        self.internet = NetworkInterface(public_ip, qdisc, eth_hook)

    def purge_for_fault(self) -> int:
        """Host crash (faults/schedule.py): the simulated kernel's
        networking state is gone — every association, every queued
        ready-socket. Respawned processes re-bind their ports on a
        clean namespace, exactly like a power cycle. Returns the number
        of associations dropped."""
        n = 0
        for iface in (self.localhost, self.internet):
            n += len(iface._associations)
            iface._associations.clear()
            iface._ready_fifo.clear()
            iface._ready_rr.clear()
            iface._ready_set.clear()
        return n

    def interface_for(self, ip: str) -> Optional[NetworkInterface]:
        if ip == "127.0.0.1":
            return self.localhost
        if ip == self.public_ip:
            return self.internet
        return None

    def interfaces_for_bind(self, bind_ip: str) -> list[NetworkInterface]:
        """0.0.0.0 binds to every interface."""
        if bind_ip == "0.0.0.0":
            return [self.localhost, self.internet]
        iface = self.interface_for(bind_ip)
        return [iface] if iface else []

    def is_port_free(
        self, protocol: Protocol, port: int, bind_ip: str = "0.0.0.0",
        peer: tuple[str, int] = WILDCARD_PEER,
    ) -> bool:
        # A port is taken if any interface the bind covers has an association.
        ifaces = (
            [self.localhost, self.internet]
            if bind_ip == "0.0.0.0"
            else self.interfaces_for_bind(bind_ip)
        )
        return all(not i.is_associated(protocol, port, peer) for i in ifaces)

    def get_random_free_port(
        self,
        protocol: Protocol,
        rng: Xoshiro256pp,
        bind_ip: str = "0.0.0.0",
        peer: tuple[str, int] = WILDCARD_PEER,
    ) -> int:
        """Random draw first (RNG-consuming, determinism-relevant), linear
        scan fallback (`namespace.rs:210-232`)."""
        span = EPHEMERAL_PORT_MAX - EPHEMERAL_PORT_MIN + 1
        for _ in range(10):
            port = rng.randrange(EPHEMERAL_PORT_MIN, EPHEMERAL_PORT_MAX + 1)
            if self.is_port_free(protocol, port, bind_ip, peer):
                return port
        start = rng.randrange(EPHEMERAL_PORT_MIN, EPHEMERAL_PORT_MAX + 1)
        for off in range(span):
            port = EPHEMERAL_PORT_MIN + (start - EPHEMERAL_PORT_MIN + off) % span
            if self.is_port_free(protocol, port, bind_ip, peer):
                return port
        raise NoPortsError(f"no free {protocol.name} ephemeral ports")

    def associate(
        self,
        socket: InterfaceSocket,
        protocol: Protocol,
        bind_ip: str,
        port: int,
        peer: tuple[str, int] = WILDCARD_PEER,
    ) -> None:
        for iface in self.interfaces_for_bind(bind_ip):
            iface.associate(socket, protocol, port, peer)

    def disassociate(
        self,
        protocol: Protocol,
        bind_ip: str,
        port: int,
        peer: tuple[str, int] = WILDCARD_PEER,
    ) -> None:
        for iface in self.interfaces_for_bind(bind_ip):
            iface.disassociate(protocol, port, peer)

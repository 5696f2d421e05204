"""Global name ↔ IP registry for the simulated internet.

Parity: reference `src/main/routing/dns.c` (C GHashTables + mutex;
`dns_resolveNameToAddress` / `dns_resolveIPToAddress`, `dns.c:180-268`) and
its `/etc/hosts`-style file generation mounted into managed processes.
"""

from __future__ import annotations

from typing import Optional


class DnsError(ValueError):
    pass


class Dns:
    def __init__(self):
        self._name_to_ip: dict[str, str] = {}
        self._ip_to_name: dict[str, str] = {}

    def register(self, name: str, ip: str) -> None:
        if name in self._name_to_ip:
            raise DnsError(f"hostname {name!r} already registered")
        if ip in self._ip_to_name:
            raise DnsError(f"address {ip} already registered")
        self._name_to_ip[name] = ip
        self._ip_to_name[ip] = name

    def deregister(self, name: str) -> None:
        ip = self._name_to_ip.pop(name, None)
        if ip is not None:
            self._ip_to_name.pop(ip, None)

    def name_to_ip(self, name: str) -> Optional[str]:
        if name == "localhost":
            return "127.0.0.1"
        return self._name_to_ip.get(name)

    def ip_to_name(self, ip: str) -> Optional[str]:
        return self._ip_to_name.get(ip)

    def hosts_file(self) -> str:
        """An /etc/hosts view of the simulation, for managed processes."""
        lines = ["127.0.0.1 localhost"]
        for name, ip in sorted(self._name_to_ip.items(), key=lambda kv: kv[0]):
            lines.append(f"{ip} {name}")
        return "\n".join(lines) + "\n"

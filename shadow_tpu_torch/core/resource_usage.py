"""Process/system resource probes for manager heartbeats and watchdogs.

Parity: reference `src/main/core/resource_usage.rs` (meminfo parsing) and
`manager.rs:675-793` (getrusage heartbeat, fd/memory watchdogs).
"""

from __future__ import annotations

import os
import resource


def rusage_self():
    """getrusage(RUSAGE_SELF) — maxrss in KiB, times in seconds."""
    return resource.getrusage(resource.RUSAGE_SELF)


def meminfo(path: str = "/proc/meminfo") -> dict[str, int]:
    """Parse /proc/meminfo into {field: bytes} (`resource_usage.rs`).

    Values are reported by the kernel in KiB despite the 'kB' suffix.
    """
    out: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            if ":" not in line:
                continue
            key, rest = line.split(":", 1)
            parts = rest.split()
            if not parts:
                continue
            try:
                value = int(parts[0])
            except ValueError:
                continue
            if len(parts) > 1 and parts[1] == "kB":
                value *= 1024
            out[key.strip()] = value
    return out


def fd_usage() -> tuple[int, int]:
    """(open fds, soft limit) — `manager.rs:756-775`."""
    count = len(os.listdir("/proc/self/fd"))
    soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    return count, soft


def memory_remaining() -> int:
    """Available system memory in bytes (`manager.rs:777-793`)."""
    info = meminfo()
    return info.get("MemAvailable", 0)

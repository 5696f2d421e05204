"""The process plane: emulated processes driven by the host event loop.

Parity: reference `src/main/host/process.rs` / `thread.rs` /
`syscall/syscall_condition.c`. Applications here are Python coroutines
against the simulated-kernel API (the analogue of Shadow's managed native
processes; the native interposition plane arrives with the C++ runtime).
"""

from .condition import SysCallCondition
from .process import ProcessState, SimProcess, Syscalls

__all__ = ["SysCallCondition", "SimProcess", "ProcessState", "Syscalls"]

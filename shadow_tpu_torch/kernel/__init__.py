"""The simulated kernel: file state/listener plane, descriptors, sockets,
timers, and (via the process plane) blocking-call conditions.

Parity: reference `src/main/host/descriptor/` + `src/main/host/syscall/` —
the layer between applications and the host's network/timer machinery.
"""

"""Syscall-level error vocabulary for the simulated kernel.

Parity: reference `SyscallError` (`src/main/host/syscall/types.rs`) — a
syscall either fails with an errno, or *blocks* on a file reaching a state
(plus optional timeout), carrying whether SA_RESTART semantics apply.
Python's stdlib `errno` provides the numeric values.
"""

from __future__ import annotations

import errno as _errno
from typing import Optional

# Re-export the names handlers use, so call sites read like the reference.
EAGAIN = _errno.EAGAIN
EWOULDBLOCK = _errno.EWOULDBLOCK
EBADF = _errno.EBADF
EINVAL = _errno.EINVAL
EINTR = _errno.EINTR
ENOSYS = _errno.ENOSYS
EMSGSIZE = _errno.EMSGSIZE
EDESTADDRREQ = _errno.EDESTADDRREQ
EADDRINUSE = _errno.EADDRINUSE
EADDRNOTAVAIL = _errno.EADDRNOTAVAIL
ECONNREFUSED = _errno.ECONNREFUSED
ECONNRESET = _errno.ECONNRESET
EISCONN = _errno.EISCONN
ENOTCONN = _errno.ENOTCONN
EALREADY = _errno.EALREADY
EINPROGRESS = _errno.EINPROGRESS
EPIPE = _errno.EPIPE
ETIMEDOUT = _errno.ETIMEDOUT
EOPNOTSUPP = _errno.EOPNOTSUPP
ENOBUFS = _errno.ENOBUFS
EPROTONOSUPPORT = _errno.EPROTONOSUPPORT
EAFNOSUPPORT = _errno.EAFNOSUPPORT
ENFILE = _errno.ENFILE
EMFILE = _errno.EMFILE
EFAULT = _errno.EFAULT
ENOTDIR = _errno.ENOTDIR
ENAMETOOLONG = _errno.ENAMETOOLONG
ESPIPE = _errno.ESPIPE
ENODEV = _errno.ENODEV
EACCES = _errno.EACCES
ECHILD = _errno.ECHILD
ESRCH = _errno.ESRCH
EPERM = _errno.EPERM
ENOENT = _errno.ENOENT
EEXIST = _errno.EEXIST
ERANGE = _errno.ERANGE
ENOTSOCK = _errno.ENOTSOCK


class SyscallError(Exception):
    """A simulated syscall failed with `err` (a positive errno value)."""

    def __init__(self, err: int, msg: str = ""):
        self.errno = err
        super().__init__(msg or _errno.errorcode.get(err, str(err)))


class Blocked(Exception):
    """A simulated syscall must block.

    Carries the file + state bits to wait for (and optionally a timeout in
    emulated ns). The process plane converts this into a condition that
    parks the calling thread (`SysCallCondition`, reference
    `syscall_condition.c`). `restartable` is the SA_RESTART eligibility bit.
    """

    def __init__(
        self,
        file,
        state_mask,
        *,
        timeout_ns: Optional[int] = None,
        restartable: bool = True,
        forever: bool = False,
    ):
        self.file = file
        self.state_mask = state_mask
        self.timeout_ns = timeout_ns
        self.restartable = restartable
        # opt-in signal-only park (pause/sigsuspend): no file and no
        # timeout trigger; only signal delivery (or teardown) unparks
        self.forever = forever
        super().__init__(f"blocked on {state_mask!r}")

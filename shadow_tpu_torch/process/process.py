"""Emulated processes: Python coroutines scheduled on the host event loop.

Parity: reference `src/main/host/process.rs` — virtual PIDs from 1000,
process lifecycle (spawn → running → zombie/exited), exit status, signal
stop, `expected_final_state` checking (`configuration.rs:614`) — with the
execution model adapted: where Shadow resumes a *native* thread over IPC
until its next syscall (`managed_thread.rs:185-322`), this plane resumes a
*generator* until it yields its next blocking point. The blocking contract
is identical: a syscall either completes, fails with errno, or parks the
process on a `SysCallCondition` (file-state × timeout), and a fired
condition schedules the resume task (`syscall_condition.c`).

Applications are generator functions `app(api, *args)` written against the
`Syscalls` facade, e.g.::

    def client(api):
        s = api.tcp_socket()
        yield from api.connect(s, ("server", 80))
        yield from api.send_all(s, b"GET /")
        data = yield from api.recv(s)
        api.close(s)

`yield from` marks every potential block point; everything else is plain
Python running to completion inside one host event (the discrete-event
abstraction: emulated time does not advance during a burst of user code).
"""

from __future__ import annotations

import enum
import ipaddress
import logging
from typing import Callable, Generator, Optional

from ..kernel import errors
from ..kernel.socket.tcp import TcpSocket
from ..kernel.socket.udp import UdpSocket
from ..kernel.status import FileState
from .condition import SysCallCondition

log = logging.getLogger("shadow_tpu_torch.process")


class ProcessState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    EXITED = "exited"
    KILLED = "killed"


class SimProcess:
    """One emulated process = one driver around an application generator."""

    def __init__(self, host, name: str, app: Callable, args: tuple = (),
                 pid: Optional[int] = None):
        self.host = host
        self.name = name
        self.pid = pid if pid is not None else host.next_pid()
        self.pgid = 1  # init's group/session (`process.rs:1092-1094`)
        self.sid = 1
        self.state = ProcessState.PENDING
        self.exit_status: Optional[int] = None
        self.kill_signal: Optional[int] = None
        self._app = app
        self._args = args
        self._gen: Optional[Generator] = None
        self._condition: Optional[SysCallCondition] = None
        self.api = Syscalls(self)
        host.processes.append(self)

    # -- lifecycle -----------------------------------------------------

    def spawn(self) -> None:
        """Start running (called from the start-time task)."""
        assert self.state == ProcessState.PENDING
        self.state = ProcessState.RUNNING
        self._gen = self._app(self.api, *self._args)
        if self._gen is None or not hasattr(self._gen, "send"):
            # plain function: ran to completion synchronously
            self._finish(0)
            return
        self._advance(None)

    def stop(self, signal: int = 15) -> None:
        """Deliver a terminating signal (SIGTERM default, like the
        config's shutdown_signal)."""
        if self.state != ProcessState.RUNNING:
            return
        self.state = ProcessState.KILLED
        self.kill_signal = signal
        if self._condition is not None:
            cond, self._condition = self._condition, None
            cond.cancel()
        gen, self._gen = self._gen, None
        if gen is not None:
            gen.close()

    @property
    def is_alive(self) -> bool:
        return self.state in (ProcessState.PENDING, ProcessState.RUNNING)

    def _finish(self, status: int) -> None:
        self.state = ProcessState.EXITED
        self.exit_status = status
        self._gen = None
        self._condition = None

    # -- the resume loop -----------------------------------------------

    def _advance(self, wake_reason: Optional[str]) -> None:
        """Resume the generator until its next block point.

        Mirrors `Thread::resume` returning Blocked(condition) vs exited:
        the generator yields `errors.Blocked` values; StopIteration is
        process exit."""
        if self.state != ProcessState.RUNNING:
            return
        self._condition = None
        try:
            blocked = self._gen.send(wake_reason)
        except StopIteration as stop:
            self._finish(stop.value if isinstance(stop.value, int) else 0)
            return
        except errors.Blocked:
            # A blocking op was *raised* instead of yielded — an app bug the
            # generator contract can't express; surface it loudly.
            log.warning(
                "process %r raised Blocked instead of yielding it; blocking "
                "ops must be driven with `yield from api....`",
                self.name, exc_info=True,
            )
            self._finish(1)
            return
        except Exception:
            # Any uncaught app error (errno, assertion, bug) is an abnormal
            # exit of THIS process, never a simulator crash — the analogue
            # of a plugin error, which the reference logs (`worker.rs:589-604`).
            log.warning(
                "process %r exited abnormally with an uncaught exception",
                self.name, exc_info=True,
            )
            self._finish(1)
            return
        if not isinstance(blocked, errors.Blocked):
            raise TypeError(
                f"process {self.name!r} yielded {blocked!r}; apps must yield "
                "errors.Blocked (use the Syscalls api helpers)"
            )
        timeout_at = None
        if blocked.timeout_ns is not None:
            timeout_at = self.host.now() + blocked.timeout_ns
        self._condition = SysCallCondition(
            self.host,
            file=blocked.file,
            state_mask=blocked.state_mask,
            timeout_at_ns=timeout_at,
            wakeup=self._advance,
        )
        self._condition.arm()


class Syscalls:
    """The simulated-syscall facade handed to applications.

    Non-blocking operations return plain values; potentially-blocking ones
    are generators used with `yield from`. Retry loops mirror the
    reference's restart semantics (`SyscallError::new_blocked` + resume
    re-dispatching the syscall)."""

    def __init__(self, process: SimProcess):
        self.process = process
        self.host = process.host

    # -- non-blocking --------------------------------------------------

    def tcp_socket(self) -> TcpSocket:
        return TcpSocket(self.host)

    def udp_socket(self) -> UdpSocket:
        return UdpSocket(self.host)

    def pipe(self):
        from ..kernel.pipe import make_pipe

        return make_pipe()

    def eventfd(self, initval: int = 0, semaphore: bool = False):
        from ..kernel.eventfd import EventFd

        return EventFd(initval, semaphore)

    def timerfd(self):
        from ..kernel.timerfd import TimerFd

        return TimerFd(self.host)

    def epoll(self):
        from ..kernel.epoll import Epoll

        return Epoll()

    def epoll_wait(self, ep, max_events: int = 64):
        """Blocking epoll_wait (generator)."""
        return ep.wait(max_events)

    def close(self, f) -> None:
        f.close()

    def now(self) -> int:
        return self.host.now()

    def gethostbyname(self, name: str) -> str:
        ip = self.host.dns_lookup(name)
        if ip is None:
            raise errors.SyscallError(errors.ENOENT, f"unknown host {name}")
        return ip

    def getpid(self) -> int:
        return self.process.pid

    # -- blocking ------------------------------------------------------

    def sleep(self, duration_ns: int):
        yield errors.Blocked(None, FileState.NONE, timeout_ns=duration_ns)

    def _resolve(self, name_or_ip: str) -> str:
        """Hostname or IPv4 literal -> IPv4 literal, via simulated DNS."""
        try:
            return str(ipaddress.IPv4Address(name_or_ip))
        except ValueError:
            return self.gethostbyname(name_or_ip)

    def connect(self, sock: TcpSocket, addr: tuple[str, int]):
        """Blocking TCP connect; resolves hostnames through simulated DNS."""
        ip = self._resolve(addr[0])
        try:
            sock.connect((ip, addr[1]))
        except errors.Blocked as b:
            yield b
        except errors.SyscallError as e:
            if e.errno != errors.EINPROGRESS:
                raise
            yield errors.Blocked(sock, FileState.SOCKET_ALLOWING_CONNECT)
        if sock.conn is not None and sock.conn.error is not None:
            raise errors.SyscallError(sock.conn.error)

    def accept(self, listener: TcpSocket):
        while True:
            try:
                return listener.accept()
            except errors.Blocked as b:
                yield b
            except errors.SyscallError as e:
                if e.errno != errors.EWOULDBLOCK:
                    raise
                yield errors.Blocked(listener, FileState.READABLE)

    def recv(self, sock, max_bytes: int = 65536):
        while True:
            try:
                return sock.recv(max_bytes)
            except errors.Blocked as b:
                yield b
            except errors.SyscallError as e:
                if e.errno != errors.EWOULDBLOCK:
                    raise
                yield errors.Blocked(sock, FileState.READABLE)

    def recvfrom(self, sock: UdpSocket):
        while True:
            try:
                return sock.recvfrom()
            except errors.Blocked as b:
                yield b
            except errors.SyscallError as e:
                if e.errno != errors.EWOULDBLOCK:
                    raise
                yield errors.Blocked(sock, FileState.READABLE)

    def send(self, sock, data: bytes):
        while True:
            try:
                return sock.send(data)
            except errors.Blocked as b:
                yield b
            except errors.SyscallError as e:
                if e.errno != errors.EWOULDBLOCK:
                    raise
                yield errors.Blocked(sock, FileState.WRITABLE)

    def send_all(self, sock, data: bytes):
        sent = 0
        while sent < len(data):
            sent += yield from self.send(sock, data[sent:])
        return sent

    def sendto(self, sock: UdpSocket, data: bytes, addr: tuple[str, int]):
        ip = self._resolve(addr[0])
        while True:
            try:
                return sock.sendto(data, (ip, addr[1]))
            except errors.Blocked as b:
                yield b
            except errors.SyscallError as e:
                if e.errno != errors.EWOULDBLOCK:
                    raise
                yield errors.Blocked(sock, FileState.WRITABLE)

    def recv_exact(self, sock, n: int):
        chunks, got = [], 0
        while got < n:
            data = yield from self.recv(sock, n - got)
            if not data:
                break  # EOF
            chunks.append(data)
            got += len(data)
        return b"".join(chunks)

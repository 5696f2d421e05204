"""Pipes: unidirectional byte stream between two file endpoints.

Parity: reference `src/main/host/descriptor/pipe.rs` — a shared ring buffer
(default capacity 64 KiB, Linux's pipe size) with distinct reader/writer
files; EOF when all writers close, EPIPE when all readers close.
"""

from __future__ import annotations

from collections import deque

from . import errors
from .status import FileSignal, FileState, StatefulFile

PIPE_CAPACITY = 65536


class _PipeShared:
    __slots__ = ("buf", "nbytes", "reader", "writer")

    def __init__(self):
        self.buf: deque[bytes] = deque()
        self.nbytes = 0
        self.reader: "PipeReader" = None
        self.writer: "PipeWriter" = None


def make_pipe() -> tuple["PipeReader", "PipeWriter"]:
    shared = _PipeShared()
    shared.reader = PipeReader(shared)
    shared.writer = PipeWriter(shared)
    return shared.reader, shared.writer


class PipeReader(StatefulFile):
    def __init__(self, shared: _PipeShared):
        super().__init__(FileState.ACTIVE)
        self._shared = shared
        self.nonblocking = False

    def recv(self, max_bytes: int = 65536) -> bytes:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        sh = self._shared
        if sh.nbytes == 0:
            if sh.writer is None or sh.writer.is_closed():
                return b""  # EOF
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.READABLE)
        out = []
        need = max_bytes
        while need > 0 and sh.buf:
            chunk = sh.buf[0]
            if len(chunk) <= need:
                out.append(sh.buf.popleft())
                need -= len(chunk)
            else:
                out.append(chunk[:need])
                sh.buf[0] = chunk[need:]
                need = 0
        got = b"".join(out)
        sh.nbytes -= len(got)
        self._refresh()
        if sh.writer is not None:
            sh.writer._refresh()
        return got

    def close(self) -> None:
        if self.is_closed():
            return
        self.update_state(
            FileState.ACTIVE | FileState.READABLE | FileState.CLOSED, FileState.CLOSED
        )
        if self._shared.writer is not None:
            self._shared.writer._refresh()

    def _refresh(self) -> None:
        if self.is_closed():
            return
        eof = self._shared.writer is None or self._shared.writer.is_closed()
        readable = self._shared.nbytes > 0 or eof
        self.update_state(
            FileState.READABLE, FileState.READABLE if readable else FileState.NONE
        )


class PipeWriter(StatefulFile):
    def __init__(self, shared: _PipeShared):
        super().__init__(FileState.ACTIVE | FileState.WRITABLE)
        self._shared = shared
        self.nonblocking = False

    def send(self, data: bytes) -> int:
        if self.is_closed():
            raise errors.SyscallError(errors.EBADF)
        sh = self._shared
        if sh.reader is None or sh.reader.is_closed():
            raise errors.SyscallError(errors.EPIPE)
        space = PIPE_CAPACITY - sh.nbytes
        if space == 0:
            if self.nonblocking:
                raise errors.SyscallError(errors.EWOULDBLOCK)
            raise errors.Blocked(self, FileState.WRITABLE)
        n = min(space, len(data))
        sh.buf.append(bytes(data[:n]))
        sh.nbytes += n
        self._refresh()
        sh.reader._refresh()
        sh.reader.emit_signal(FileSignal.READ_BUFFER_GREW)
        return n

    def close(self) -> None:
        if self.is_closed():
            return
        self.update_state(
            FileState.ACTIVE | FileState.WRITABLE | FileState.CLOSED, FileState.CLOSED
        )
        if self._shared.reader is not None:
            self._shared.reader._refresh()  # EOF becomes readable

    def _refresh(self) -> None:
        if self.is_closed():
            return
        writable = self._shared.nbytes < PIPE_CAPACITY
        self.update_state(
            FileState.WRITABLE, FileState.WRITABLE if writable else FileState.NONE
        )

"""ChildPidWatcher: detect managed-process death and unblock the simulator.

Parity: reference `src/main/utility/childpid_watcher.rs` — a dedicated
thread epoll-waits on one pidfd per watched child; when a pidfd becomes
readable (the process died), registered callbacks run, whose job is to
close the IPC channel writer so a simulator thread blocked in
`recv_from_shim` wakes with WriterIsClosed instead of hanging forever
(`managed_thread.rs:444-447`). This is the only liveness mechanism that
covers SIGKILL and crashes, where the shim's destructor (which normally
announces PROCESS_DEATH) never runs.
"""

from __future__ import annotations

import logging
import os
import select
import threading
from typing import Callable, Optional

log = logging.getLogger("shadow_tpu_torch.process")

# os.pidfd_open exists on Linux 5.3+ / Python 3.9+; fall back to a
# waitpid-polling thread per child if unavailable.
_HAVE_PIDFD = hasattr(os, "pidfd_open")


class ChildPidWatcher:
    """One epoll thread watching every managed child's pidfd."""

    def __init__(self):
        self._lock = threading.Lock()
        self._callbacks: dict[int, tuple[int, Callable[[], None]]] = {}  # pid -> (pidfd, cb)
        self._epoll: Optional[select.epoll] = None
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_w, False)
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._epoll = select.epoll()
            self._epoll.register(self._wake_r, select.EPOLLIN)
            self._shutdown = False
            self._thread = threading.Thread(
                target=self._run, name="child-pid-watcher", daemon=True
            )
            self._thread.start()

    def watch(self, pid: int, callback: Callable[[], None]) -> None:
        """Invoke `callback` (on the watcher thread) when `pid` dies.

        The callback must be safe to call while another thread is blocked
        on the resource it releases (it closes an IPC channel writer)."""
        if not _HAVE_PIDFD:
            t = threading.Thread(
                target=self._poll_fallback, args=(pid, callback), daemon=True
            )
            t.start()
            return
        with self._lock:
            self._ensure_thread()
            try:
                pidfd = os.pidfd_open(pid)
            except ProcessLookupError:
                # already dead: fire immediately (off-thread, like the
                # reference's register-after-death path)
                threading.Thread(target=callback, daemon=True).start()
                return
            self._callbacks[pid] = (pidfd, callback)
            self._epoll.register(pidfd, select.EPOLLIN)
        self._wake()

    def watched_pids(self) -> list[int]:
        """Pids with a live death-watch — i.e. children the watcher has
        NOT yet seen die. The round watchdog's blame collector reads
        this to mark which of a hung host's processes were still alive
        when the watchdog fired (faults/watchdog.py)."""
        with self._lock:
            return sorted(self._callbacks)

    def unwatch(self, pid: int) -> None:
        with self._lock:
            entry = self._callbacks.pop(pid, None)
            if entry is None:
                return
            pidfd, _ = entry
            try:
                self._epoll.unregister(pidfd)
            except (OSError, ValueError):
                pass
            os.close(pidfd)
        self._wake()

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except BlockingIOError:
            pass

    def _run(self) -> None:
        while True:
            try:
                events = self._epoll.poll()
            except (OSError, ValueError):
                return
            fired: list[Callable[[], None]] = []
            with self._lock:
                if self._shutdown:
                    return
                for fd, _mask in events:
                    if fd == self._wake_r:
                        try:
                            os.read(self._wake_r, 4096)
                        except OSError:
                            pass
                        continue
                    for pid, (pidfd, cb) in list(self._callbacks.items()):
                        if pidfd == fd:
                            fired.append(cb)
                            del self._callbacks[pid]
                            try:
                                self._epoll.unregister(pidfd)
                            except (OSError, ValueError):
                                pass
                            os.close(pidfd)
            for cb in fired:
                try:
                    cb()
                except Exception:
                    # a failing death-callback must not kill the watcher
                    # thread (other children still need their wakeups),
                    # but it may leave a worker blocked forever — say so
                    log.error(
                        "child-death callback raised; a simulator thread "
                        "may stay blocked on this child's IPC channel",
                        exc_info=True)

    def _poll_fallback(self, pid: int, callback: Callable[[], None]) -> None:
        """No pidfd support: block in waitid(WNOWAIT) — it returns as soon
        as the child exits but leaves the zombie for subprocess.Popen's own
        waitpid to reap. (A kill(pid, 0) poll would NOT work: it succeeds
        on zombies, and the reaping wait() only runs after this callback
        unblocks the worker thread — a circular wait.)"""
        try:
            os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT)
        except (ChildProcessError, OSError):
            pass  # already reaped or not our child: treat as dead
        callback()


_watcher: Optional[ChildPidWatcher] = None
_watcher_lock = threading.Lock()


def get_watcher() -> ChildPidWatcher:
    """The process-wide watcher (the reference keeps one in WorkerShared)."""
    global _watcher
    with _watcher_lock:
        if _watcher is None:
            _watcher = ChildPidWatcher()
        return _watcher

"""Blocked-syscall conditions.

Parity: reference `src/main/host/syscall/syscall_condition.c` — the object
representing "this thread is parked until X": a trigger composed of a file
reaching monitored state bits, and/or a timeout. When any leg fires, the
condition schedules a host task that resumes the blocked process, and
disarms its other legs (fire-once semantics). The reference also triggers
on signals; signal delivery here routes through `SimProcess.signal`, which
cancels the condition directly.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.event import TaskRef
from ..kernel.status import FileState, ListenerFilter


class SysCallCondition:
    """Fire-once waiter on (file-state, timeout).

    `wakeup(reason)` is called exactly once from a host task context;
    `reason` is "file", "timeout", or "cancel" (signal/kill).
    """

    def __init__(
        self,
        host,
        *,
        file=None,
        state_mask: FileState = FileState.NONE,
        timeout_at_ns: Optional[int] = None,
        wakeup: Callable[[str], None],
        allow_forever: bool = False,
    ):
        self._host = host
        self._file = file
        self._state_mask = state_mask
        self._timeout_at = timeout_at_ns
        self._wakeup = wakeup
        self._allow_forever = allow_forever
        self._fired = False
        self._listener_handle: Optional[int] = None

    def arm(self) -> None:
        if self._file is not None and self._state_mask:
            # already satisfied? fire on the next task (never synchronously,
            # matching the reference's task-deferred wakeups)
            if self._file.state & self._state_mask:
                self._schedule("file")
                return
            self._listener_handle = self._file.add_listener(
                self._state_mask, ListenerFilter.OFF_TO_ON, self._on_file_event
            )
        if self._timeout_at is not None:
            # The host event queue has no unschedule; when another leg wins,
            # this task fires as a no-op against the _fired guard (same
            # shape as expired reference conditions).
            delay = max(0, self._timeout_at - self._host.now())
            self._host.schedule_task_with_delay(
                TaskRef(lambda h: self._fire("timeout"), "condition-timeout"),
                delay,
            )
        if not (self._file is not None and self._state_mask) \
                and self._timeout_at is None and not self._allow_forever:
            raise ValueError("condition with no trigger would park forever")

    def cancel(self) -> None:
        """Signal/kill: wake the blocked thread with EINTR semantics."""
        self._fire("cancel")

    def _on_file_event(self, state, changed, cb_queue) -> None:
        # resume via a host task, never from inside a notification flush
        cb_queue.add(lambda _cq: self._schedule("file"))

    def _schedule(self, reason: str) -> None:
        self._host.schedule_task_with_delay(
            TaskRef(lambda h: self._fire(reason), "condition-wakeup"), 0
        )

    def _fire(self, reason: str) -> None:
        if self._fired:
            return
        self._fired = True
        if self._listener_handle is not None and self._file is not None:
            self._file.remove_listener(self._listener_handle)
            self._listener_handle = None
        self._wakeup(reason)

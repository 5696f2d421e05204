"""Simulation-aware logging.

Parity: reference `src/main/core/logger/shadow_logger.rs` — every record is
tagged with the *emulated* time and the executing host, so logs from
parallel runs are comparable and the determinism harness can diff them.

Like the reference (`shadow_logger.rs:17-60`, async buffered flush with
a flusher thread), records are handed to a background flusher by
default: the worker thread pays only a queue put (sim context is
captured producer-side, where the thread-local host is visible), and
the blocking stderr write happens on the flusher. The deterministic
content contract is unchanged — the async path formats exactly the
records the sync path would, and `close()` drains the queue before the
CLI exits. Per-thread record order is preserved; cross-thread
interleaving was never deterministic in either mode (the reference's
isn't either — the determinism harness strips/sorts accordingly).
"""

from __future__ import annotations

import logging
import logging.handlers
import queue as _queue

from . import simtime
from .worker import current_host


class SimContextFilter(logging.Filter):
    """Injects sim_time / host_name fields into every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        host = current_host()
        record.host_name = host.name if host is not None else "-"
        record.sim_time = host.now() if host is not None else 0
        record.sim_time_str = simtime.fmt(record.sim_time)
        return True


DETERMINISTIC_FORMAT = (
    "%(sim_time_str)s [%(levelname)s] [%(host_name)s] %(name)s: %(message)s"
)
WALL_FORMAT = (
    "%(asctime)s %(sim_time_str)s [%(levelname)s] [%(host_name)s] "
    "%(name)s: %(message)s"
)


class AsyncShadowHandler(logging.handlers.QueueHandler):
    """Buffered background flush (`shadow_logger.rs:17-60`): the
    producer thread captures the sim context (filters run producer-side
    — the thread-local active host is only visible there) and enqueues;
    a daemon listener thread runs the real stream handler. `close()`
    stops the listener, which drains every queued record first."""

    def __init__(self, target: logging.Handler):
        super().__init__(_queue.SimpleQueue())
        self.addFilter(SimContextFilter())
        self._listener = logging.handlers.QueueListener(self.queue, target)
        self._target = target
        self._listener.start()

    def close(self) -> None:
        if self._listener is not None:
            self._listener.stop()  # joins the thread after a full drain
            self._listener = None
            self._target.close()
        super().close()

    def flush(self) -> None:
        # stop/start cycles the listener through a full queue drain
        if self._listener is not None:
            self._listener.stop()
            self._target.flush()
            self._listener.start()


def init_logging(level: int = logging.INFO, deterministic: bool = True,
                 stream=None, buffered: bool = True) -> logging.Handler:
    """Install a handler on the shadow_tpu_torch logger tree; returns it so the
    CLI can flush/remove. Deterministic mode omits wall-clock timestamps
    (the diffable format the determinism harness compares). `buffered`
    (default) flushes from a background thread like the reference's
    ShadowLogger; pass False for strictly synchronous emission (e.g.
    debugging a crash where the tail of the log matters)."""
    logger = logging.getLogger("shadow_tpu_torch")
    target = logging.StreamHandler(stream)
    target.setFormatter(
        logging.Formatter(DETERMINISTIC_FORMAT if deterministic else WALL_FORMAT)
    )
    if buffered:
        handler: logging.Handler = AsyncShadowHandler(target)
    else:
        handler = target
        handler.addFilter(SimContextFilter())
    logger.addHandler(handler)
    logger.setLevel(level)
    return handler

"""Host-parallel schedulers.

Parity: reference `src/lib/scheduler/` — hosts are the unit of parallelism;
within one round every host runs independently and a barrier separates
rounds. Three schedulers, as in the reference (`configuration.rs:533`):

- `ThreadPerCoreScheduler` (default): N persistent worker threads, hosts
  dealt round-robin into per-thread queues each round, **work stealing**
  when a thread drains its own queue (it cycles over the other threads'
  queues starting from its own index, `thread_per_core.rs:193-212`).
  Threads are created once and parked between rounds (the reference's
  UnboundedThreadPool), and pinned to CPUs when the platform allows
  (`affinity.c`; `use_cpu_pinning` defaults on).
- `ThreadPerHostScheduler`: one persistent OS thread per host, host pinned
  to its thread for the simulation's lifetime (`thread_per_host.rs`).
- `SerialScheduler`: single-thread degenerate case.

Determinism holds for all three because per-round host execution is
independent and all cross-host effects carry scheduling-independent
ordering keys — `tools/compare_runs.py --matrix` proves it per config.
The Python planes are GIL-bound; the scalable data path is the TPU plane
(`shadow_tpu.tpu`), and these schedulers exist for semantic parity and for
overlapping managed-process I/O waits, which do release the GIL.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Sequence

from .worker import Worker, WorkerShared
from .worker import set_current_cpu as worker_mod_set_cpu


def _pin_to_cpu(index: int) -> Optional[int]:
    """Best-effort CPU pinning (`affinity_getGoodWorkerAffinity`): worker i
    gets core i mod n_cores. Returns the chosen cpu (None = unsupported)
    and records it thread-locally so managed native threads can be
    migrated to follow their worker (`managed_thread.rs:533-544`)."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        cpu = cpus[index % len(cpus)]
        os.sched_setaffinity(0, {cpu})
    except (AttributeError, OSError):
        return None
    worker_mod_set_cpu(cpu)
    return cpu


class SerialScheduler:
    parallelism = 1

    def __init__(self, shared: WorkerShared):
        self.worker = Worker(shared, 0)

    def run_round(self, hosts, round_end: int) -> Optional[int]:
        """Execute all hosts up to `round_end`; return the min next-event
        time across hosts and in-flight packet deliveries."""
        w = self.worker
        w.start_round(round_end)
        min_next: Optional[int] = None
        for host in hosts:
            w.set_active_host(host)
            host.execute(round_end)
            t = host.next_event_time()
            if t is not None and (min_next is None or t < min_next):
                min_next = t
            w.set_active_host(None)
        if w.next_event_time is not None and (
            min_next is None or w.next_event_time < min_next
        ):
            min_next = w.next_event_time
        return min_next

    def join(self) -> None:
        pass


class _RoundPool:
    """Persistent worker threads executing one callback per round.

    The reference keeps one pool for the whole simulation and parks workers
    between rounds (`pools/unbounded.rs`); respawning threads per round (the
    round-1 design) cost a spawn/join per thread per window.
    """

    def __init__(self, n: int, pin_cpus: bool):
        self._n = n
        self._round_fn: Optional[Callable[[int], None]] = None
        self._gen = 0
        self._done = 0
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._start_cv = threading.Condition(self._lock)
        self._done_cv = threading.Condition(self._lock)
        self._stop = False
        self._threads = [
            threading.Thread(
                target=self._loop, args=(i, pin_cpus), daemon=True,
                name=f"shadow-worker-{i}",
            )
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def _loop(self, index: int, pin_cpus: bool) -> None:
        if pin_cpus:
            _pin_to_cpu(index)
        seen = 0
        while True:
            with self._start_cv:
                while self._gen == seen and not self._stop:
                    self._start_cv.wait()
                if self._stop:
                    return
                seen = self._gen
                fn = self._round_fn
            # the thread must survive a failing round: swallow the error
            # into the barrier result so the pool stays whole and run()
            # re-raises on the driving thread
            err: Optional[BaseException] = None
            try:
                fn(index)
            except BaseException as e:  # noqa: BLE001 — transported, not dropped
                err = e
            with self._done_cv:
                if err is not None:
                    self._errors.append(err)
                self._done += 1
                if self._done == self._n:
                    self._done_cv.notify_all()

    def run(self, fn: Callable[[int], None]) -> None:
        """Run `fn(worker_index)` on every thread; blocks until all done
        (the round barrier). Re-raises the first worker exception here."""
        with self._start_cv:
            self._round_fn = fn
            self._done = 0
            self._errors = []
            self._gen += 1
            self._start_cv.notify_all()
        with self._done_cv:
            while self._done < self._n:
                self._done_cv.wait()
            errors = self._errors
        if errors:
            raise errors[0]

    def shutdown(self) -> None:
        with self._start_cv:
            self._stop = True
            self._start_cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)


class ThreadPerCoreScheduler:
    """Persistent pinned workers + per-thread host queues + work stealing."""

    def __init__(self, shared: WorkerShared, parallelism: int,
                 pin_cpus: bool = True):
        self.parallelism = max(1, parallelism)
        self._workers = [Worker(shared, i) for i in range(self.parallelism)]
        self._pool = _RoundPool(self.parallelism, pin_cpus)
        self._results: List[Optional[int]] = [None] * self.parallelism
        # per-thread double-buffered host queues (`thread_per_core.rs:87-94`);
        # rebuilt per round from the host list, guarded by the round barrier
        self._queues: List[List] = [[] for _ in range(self.parallelism)]
        self._cursors: List[int] = [0] * self.parallelism
        self._qlocks = [threading.Lock() for _ in range(self.parallelism)]
        self._round_end = 0

    def _worker_round(self, index: int) -> None:
        worker = self._workers[index]
        worker.start_round(self._round_end)
        min_next: Optional[int] = None
        n = self.parallelism
        # drain own queue, then steal others' cycling from own index
        # (`thread_per_core.rs:193-212`)
        for qi in range(n):
            q = (index + qi) % n
            queue = self._queues[q]
            lock = self._qlocks[q]
            while True:
                with lock:
                    i = self._cursors[q]
                    if i >= len(queue):
                        break
                    self._cursors[q] = i + 1
                host = queue[i]
                worker.set_active_host(host)
                host.execute(self._round_end)
                t = host.next_event_time()
                if t is not None and (min_next is None or t < min_next):
                    min_next = t
                worker.set_active_host(None)
        if worker.next_event_time is not None and (
            min_next is None or worker.next_event_time < min_next
        ):
            min_next = worker.next_event_time
        self._results[index] = min_next

    def run_round(self, hosts, round_end: int) -> Optional[int]:
        n = self.parallelism
        for q in self._queues:
            q.clear()
        # round-robin deal mirrors the reference's host assignment
        # (`thread_per_core.rs:70-85`); hosts were already shuffled once by
        # the manager for load balance (`manager.rs:272`)
        for i, host in enumerate(hosts):
            self._queues[i % n].append(host)
        self._cursors = [0] * n
        self._results = [None] * n
        self._round_end = round_end
        self._pool.run(self._worker_round)
        live = [r for r in self._results if r is not None]
        return min(live) if live else None

    def join(self) -> None:
        self._pool.shutdown()


class ThreadPerHostScheduler:
    """One persistent thread per host; the host never migrates
    (`thread_per_host.rs` — host pinned in TLS for its lifetime). The
    number of hosts *running* at once is bounded by `parallelism` via a
    semaphore — the reference analogue is the logical-processor layer that
    multiplexes per-host threads onto worker CPUs (`pools/bounded.rs`)."""

    def __init__(self, shared: WorkerShared, hosts: Sequence,
                 parallelism: int, pin_cpus: bool = True):
        self.parallelism = max(1, parallelism)
        self._hosts = list(hosts)
        self._known = set(map(id, self._hosts))  # hosts pinned for life
        n = len(self._hosts)
        self._workers = [Worker(shared, i) for i in range(n)]
        self._pool = _RoundPool(n, pin_cpus)
        self._run_slots = threading.Semaphore(self.parallelism)
        self._results: List[Optional[int]] = [None] * n
        self._round_end = 0

    def _worker_round(self, index: int) -> None:
        worker = self._workers[index]
        host = self._hosts[index]
        if id(host) not in self._active:
            # not in this round's active set: the host has no event
            # before the round end, nothing to do (its thread still
            # exists — hosts are pinned for the simulation's lifetime)
            self._results[index] = None
            return
        min_next: Optional[int] = None
        with self._run_slots:
            worker.start_round(self._round_end)
            worker.set_active_host(host)
            host.execute(self._round_end)
            t = host.next_event_time()
            if t is not None:
                min_next = t
            worker.set_active_host(None)
        if worker.next_event_time is not None and (
            min_next is None or worker.next_event_time < min_next
        ):
            min_next = worker.next_event_time
        self._results[index] = min_next

    def run_round(self, hosts, round_end: int) -> Optional[int]:
        known = self._known
        if any(id(h) not in known for h in hosts):
            raise ValueError(
                "thread-per-host hosts are pinned at construction; "
                "run_round was given an unknown host"
            )
        self._active = set(map(id, hosts))
        self._results = [None] * len(self._hosts)
        self._round_end = round_end
        self._pool.run(self._worker_round)
        live = [r for r in self._results if r is not None]
        return min(live) if live else None

    def join(self) -> None:
        self._pool.shutdown()


def make_scheduler(kind: str, shared: WorkerShared, parallelism: int,
                   hosts: Optional[Sequence] = None, pin_cpus: bool = True):
    if kind == "thread-per-host":
        if not hosts:
            raise ValueError(
                "thread-per-host scheduler requires a non-empty host list")
        return ThreadPerHostScheduler(shared, hosts, parallelism, pin_cpus)
    if kind == "serial" or parallelism <= 1:
        return SerialScheduler(shared)
    if kind == "thread-per-core":
        return ThreadPerCoreScheduler(shared, parallelism, pin_cpus)
    raise ValueError(f"unknown scheduler {kind!r}")

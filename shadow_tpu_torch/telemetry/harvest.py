"""Telemetry harvest: device counters -> JSONL heartbeats.

Counterpart of `shadow_tpu/telemetry/harvest.py`. The cycle is
double-buffered, so the drive never waits for telemetry: `tick(now_ns,
...)` first drains the previous tick's snapshot, whose copy has had a
whole harvest interval to land, then starts copying the current counter
tensors to the host (on the card, `non_blocking` copies and an event
that the next drain waits on; a CPU tensor is cloned; a numpy array is
held). Heartbeats therefore trail the run by one interval; `finalize()`
drains the last snapshot.

Counters arrive as modular-2^32 int32; `unwrap_u32` turns them into
monotone int64 totals. High-water marks (`max_*`) and CPU-side counters
pass through. Output is JSONL with sorted keys and virtual-time stamps,
no wall clock: one ``sim`` line per harvest and one ``host`` line per
host (off with per_host=False), byte for byte the JAX harvester's for the
same counters.
"""

from __future__ import annotations

import json
import logging
from typing import Mapping, Optional

import numpy as np
import torch

log = logging.getLogger("shadow_tpu_torch.telemetry")

#: PlaneMetrics fields that are high-water marks, not modular counters:
#: they aggregate across hosts with max, never sum (export.py shares it)
MAX_FIELDS = frozenset({"max_eg_depth", "max_in_depth"})

_U32 = np.uint64(1 << 32)


def unwrap_u32(prev_raw, cur_raw):
    """Delta of a modular-2^32 counter between two raw snapshots, as
    int64 (exact while the true delta is below 2^32)."""
    p = np.asarray(prev_raw).astype(np.int64) & 0xFFFFFFFF
    c = np.asarray(cur_raw).astype(np.int64) & 0xFFFFFFFF
    return (c - p) % np.int64(_U32)


def counter_delta(prev_raw, cur_raw):
    """Modular uint32 delta between two int32 counter snapshots: the
    record half of the memo's delta replay (`tpu/memo.py`).
    `int(counter_delta(p, c)) == unwrap_u32(p, c)` elementwise."""
    p = np.asarray(prev_raw)
    c = np.asarray(cur_raw)
    if p.dtype != np.int32 or c.dtype != np.int32:
        raise TypeError(
            f"counter_delta wants int32 modular counters, got "
            f"{p.dtype}/{c.dtype}")
    # signed -> unsigned astype wraps mod 2^32, so the subtraction is
    # exact through the 2^31 sign flip and the 2^32 wrap
    return c.astype(np.uint32) - p.astype(np.uint32)


def apply_counter_delta(base_raw, delta_u32):
    """Wrap-add a `counter_delta` onto a live int32 counter: the replay
    half. int32 addition on the device is two's-complement modular, so
    this equals the device having run the span itself."""
    b = np.asarray(base_raw)
    d = np.asarray(delta_u32)
    if b.dtype != np.int32 or d.dtype != np.uint32:
        raise TypeError(
            f"apply_counter_delta wants int32 base + uint32 delta, got "
            f"{b.dtype}/{d.dtype}")
    return (b.astype(np.uint32) + d).astype(np.int32)


def _leaves(device) -> dict:
    """A device-counter source as {name: tensor or array}: a
    PlaneMetrics-style NamedTuple, a mapping, or None."""
    if device is None:
        return {}
    if hasattr(device, "_asdict"):
        return dict(device._asdict())
    return dict(device)


def _start_copy(arr):
    """Start moving one leaf to the host: a non-blocking copy on the card,
    a clone on the CPU (the tensor may be reused), numpy as it is."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type == "cuda":
            return arr.detach().to("cpu", non_blocking=True)
        return arr.detach().clone()
    return arr


def _as_numpy(arr) -> np.ndarray:
    return arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


class TelemetryHarvester:
    """Snapshots device counters every `interval_ns` of virtual time,
    merges them with CPU-side per-host counters under one host-id
    namespace, and emits JSONL heartbeats.

    `sink` is a path (opened and closed here) or a file object
    (borrowed). `host_names[i]` names host_id i+1. `slot_capacity` is the
    per-window sort-slot capacity (N*(CE+CI)) that turns the accumulated
    `sort_slots` into an occupancy ratio. `on_drain(time_ns,
    device_totals, cpu)` runs at the end of every drain."""

    def __init__(self, *, interval_ns: int, sink=None,
                 host_names: Optional[list[str]] = None,
                 slot_capacity: Optional[int] = None,
                 per_host: bool = True, retain: bool = True,
                 on_drain=None):
        if interval_ns <= 0:
            raise ValueError("telemetry interval must be positive")
        self._on_drain = on_drain
        self.interval_ns = int(interval_ns)
        self._next_due = int(interval_ns)
        self._per_host = per_host
        self._retain = retain
        self._slot_capacity = slot_capacity
        self._host_names = host_names
        self._pending = None  # (time_ns, {name: host copy}, cpu, event)
        self._events: list[dict] = []  # annotations for the next sim line
        self._prev_raw: dict[str, np.ndarray] = {}
        self._totals: dict[str, np.ndarray] = {}
        self.heartbeats: list[dict] = []
        self.emitted = 0  # JSONL lines written
        self.harvests = 0  # drained snapshots
        self._own_sink = isinstance(sink, str)
        self.sink_path = sink if self._own_sink else None
        self._sink = open(sink, "w") if self._own_sink else sink

    def due(self, now_ns: int) -> bool:
        return now_ns >= self._next_due

    def note_event(self, record: dict) -> None:
        """Queue a run-lifecycle event (a phase completion, a ring
        growth, ...) for the next sim line's ``annotations``."""
        self._events.append(dict(record))

    def tick(self, now_ns: int, device=None,
             cpu: Optional[Mapping[int, dict]] = None) -> None:
        """One harvest: drain the previous snapshot, then start copying
        the current counters. `device` is a PlaneMetrics or a {name: [N]
        tensor} mapping; `cpu` maps host_id -> plain counter dict."""
        self.drain()
        src = _leaves(device)
        leaves = {name: _start_copy(arr) for name, arr in src.items()}
        done = None
        if any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in src.values()):
            done = torch.cuda.Event()
            done.record()
        cpu_copy = (
            {int(hid): dict(counters) for hid, counters in cpu.items()}
            if cpu else None
        )
        self._pending = (int(now_ns), leaves, cpu_copy, done)
        while self._next_due <= now_ns:
            self._next_due += self.interval_ns

    def drain(self) -> None:
        """Materialize and emit the pending snapshot, if any."""
        if self._pending is None:
            return
        time_ns, leaves, cpu, done = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()
        device_now: dict[str, np.ndarray] = {}
        for name, arr in leaves.items():
            raw = _as_numpy(arr)
            if name in MAX_FIELDS:
                device_now[name] = raw.astype(np.int64)
                continue
            prev = self._prev_raw.get(name)
            delta = unwrap_u32(0 if prev is None else prev, raw)
            total = self._totals.get(name)
            self._totals[name] = delta if total is None else total + delta
            self._prev_raw[name] = raw
            device_now[name] = self._totals[name]
        self.harvests += 1
        self._emit(time_ns, device_now, cpu)
        if self._on_drain is not None:
            self._on_drain(time_ns, device_now, cpu)

    def finalize(self) -> None:
        """Drain the pending snapshot and flush (and close, when it opened
        it) the sink. Idempotent."""
        self.drain()
        if self._sink is not None:
            self._sink.flush()
            if self._own_sink:
                self._sink.close()
                self._sink = None

    def _write(self, record: dict) -> None:
        if self._sink is not None:
            self._sink.write(json.dumps(record, sort_keys=True) + "\n")
        if self._retain:
            self.heartbeats.append(record)
        self.emitted += 1

    def _host_name(self, idx: int) -> str:
        if self._host_names and idx < len(self._host_names):
            return self._host_names[idx]
        return f"host{idx + 1}"

    def _emit(self, time_ns: int, device: dict[str, np.ndarray],
              cpu: Optional[dict[int, dict]]) -> None:
        per_host = {k: v for k, v in device.items() if np.ndim(v) == 1}
        scalars = {k: int(v) for k, v in device.items() if np.ndim(v) == 0}
        # [N, B] leaves are per-host log2 histograms: the sim line gets the
        # fleet-summed buckets, each host line its own row
        hists = {k: v for k, v in device.items() if np.ndim(v) == 2}
        sim: dict = {"type": "sim", "time_ns": time_ns}
        if hists:
            sim["hist"] = {
                k: [int(x) for x in v.sum(axis=0)]
                for k, v in sorted(hists.items())}
        if self._events:
            sim["annotations"], self._events = self._events, []
        sim.update(scalars)
        if "sort_slots" in scalars and self._slot_capacity and \
                scalars.get("windows"):
            sim["sort_occupancy"] = round(
                scalars["sort_slots"]
                / (scalars["windows"] * self._slot_capacity), 6)
        if per_host:
            # high-water marks aggregate with max, counters with sum
            sim["device_totals"] = {
                k: int(v.max() if k in MAX_FIELDS else v.sum())
                for k, v in sorted(per_host.items())}
        if cpu:
            agg: dict[str, int] = {}
            for counters in cpu.values():
                for k, v in counters.items():
                    if isinstance(v, (int, np.integer)):
                        agg[k] = agg.get(k, 0) + int(v)
            sim["cpu_totals"] = agg
        self._write(sim)
        log.info("telemetry time_ns=%d %s", time_ns,
                 json.dumps(sim, sort_keys=True))
        if not self._per_host:
            return
        n = max((v.shape[0] for v in per_host.values()), default=0)
        n = max(n, max((v.shape[0] for v in hists.values()), default=0))
        ids = set(range(1, n + 1)) | set(cpu.keys() if cpu else ())
        # Python ints, row by row, in one conversion per leaf
        host_cols = sorted((k, v.tolist()) for k, v in per_host.items())
        hist_rows = sorted((k, v.tolist()) for k, v in hists.items())
        for hid in sorted(ids):
            i = hid - 1
            rec: dict = {"type": "host", "time_ns": time_ns,
                         "host_id": hid, "host": self._host_name(i)}
            if per_host and i < n:
                rec["device"] = {k: col[i] for k, col in host_cols
                                 if i < len(col)}
            if hists and i < n:
                rec["hist"] = {k: rows[i] for k, rows in hist_rows
                               if i < len(rows)}
            if cpu and hid in cpu:
                rec["cpu"] = cpu[hid]
            self._write(rec)

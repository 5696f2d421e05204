"""The run ledger and the two-clock Chrome-trace export.

Counterpart of `shadow_tpu/telemetry/tracer.py`. `RunTracer` is the
driver loop's flight log: one JSONL record per chain span, written at
the chain boundary where the driver already regains the host. Every
field is a host wall clock (`time.monotonic`), a Python int the driver
computed from the span bounds, or a dict a boundary hook already holds
(memo stats, capacity events, harvest annotations): the tracer reads no
tensor and adds no device synchronise, so a traced run is digest-equal
to an untraced one. Wall-clock fields (`WALL_FIELDS`) are excluded from
every compare.

Record kinds: ``meta`` (first line: ``schema``, ``label``, the
``backend`` fingerprint, caller metadata); ``span`` (``r0``/``r1``/
``windows``, ``mode`` execute | replay | ffwd | ensemble, the wall split
``wall_ms``/``dispatch_ms``/``memo_ms``/``hook_ms``, capacity
``growth`` events, ``span_salt``); annotations (``harvest``,
``checkpoint``, ``kill``, ``resume``, ``tamper``, ...); ``memo`` (the
folded `ChainMemo.report()`); ``end`` (last line). The schema string is
the JAX package's, so either package reads the other's ledgers.

`write_chrome_trace` lays the ledger out as the "driver (wall time)"
row of a Chrome trace and, given heartbeats, the virtual-time
simulation rows of `export.build_sim_events` beside it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

#: the ledger schema version: bump on ANY change to the span-record
#: field set (tests/test_tracer.py pins both).
RUNLEDGER_SCHEMA = "runledger-v1"

#: fields always present on a ``span`` record, in emission order —
#: the drift-pin surface.
SPAN_FIELDS = ("kind", "seq", "r0", "r1", "windows", "mode",
               "wall_t0_ms", "wall_ms", "dispatch_ms", "memo_ms",
               "hook_ms")

#: wall-clock fields — excluded from EVERY compare (trace-parity,
#: compare_runs ratios gate on aggregates, never on these raw values
#: matching across runs).
WALL_FIELDS = frozenset({"wall_t0_ms", "wall_ms", "dispatch_ms",
                         "memo_ms", "hook_ms"})

#: span execution modes the driver reports.
SPAN_MODES = ("execute", "replay", "ffwd", "ensemble")

#: the driver row's pid in the merged Chrome trace — far above any
#: heartbeat host_id row (those are host index + 1).
DRIVER_PID = 1_000_000


def backend_fingerprint(device=None) -> dict:
    """The identity wall times are comparable within: the torch device a
    run used (None: the CUDA card when there is one, else the CPU), its
    name and capability, the device count, and the PyTorch and CUDA
    versions. A CPU run says "cpu"."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type == "cuda":
        cap = torch.cuda.get_device_capability(dev)
        out.update(device_kind=torch.cuda.get_device_name(dev),
                   capability=f"{cap[0]}.{cap[1]}",
                   device_count=torch.cuda.device_count())
    else:
        out["device_kind"] = dev.type
    return out


class RunTracer:
    """Accumulates the run ledger in host memory; `write` dumps JSONL.

    The driver calls `clock()`/`span()` at chain boundaries; boundary
    hooks call `annotate()`; the owner calls `memo_close()`/`close()`/
    `write()` once after the drive loop returns. Nothing here may read
    a device value — pass host scalars/dicts only.

    ``sink`` switches the ledger to STREAMING mode: every record is
    appended (and flushed + fsynced) to the file the instant it is
    recorded, so a SIGKILL preserves everything up to the last chain
    boundary — the crash-survivable ledger a checkpointed run needs.
    ``resume=True`` (requires ``sink``) APPENDS to an existing ledger
    instead of truncating it, and suppresses the duplicate head meta
    record (`read_ledger`'s first-line contract): the resumed run's
    records continue the killed run's stream, and the caller marks the
    seam with an ``annotate("resume", checkpoint=...)`` record that
    `stitch_ledger` / trace_report use to rebase the second segment's
    wall clocks (docs/observability.md "Ledger stitching")."""

    def __init__(self, label: str = "run", *, backend: dict | None = None,
                 meta: dict | None = None, sink: str | None = None,
                 resume: bool = False):
        if resume and sink is None:
            raise ValueError("RunTracer(resume=True) requires a sink "
                             "path — only a streamed ledger can be "
                             "appended across a resume")
        self.label = label
        self._origin = time.monotonic()
        self._seq = 0
        self._sink = None
        self.sink_path = sink
        self.resumed = bool(resume)
        head = {"schema": RUNLEDGER_SCHEMA, "kind": "meta",
                "label": label,
                "backend": dict(backend) if backend is not None
                else backend_fingerprint()}
        if meta:
            head.update({k: v for k, v in meta.items()
                         if k not in ("schema", "kind")})
        self.records: list[dict] = [head]
        if sink is not None:
            self._sink = open(sink, "a" if resume else "w")
            if not resume:
                self._emit(head)

    def _emit(self, rec: dict) -> None:
        if self._sink is None:
            return
        self._sink.write(json.dumps(rec, sort_keys=True) + "\n")
        self._sink.flush()
        os.fsync(self._sink.fileno())

    # -- driver hooks ----------------------------------------------------

    def clock(self) -> float:
        """Host monotonic seconds — the only clock the ledger knows."""
        return time.monotonic()

    def span(self, r0: int, r1: int, *, mode: str, t0: float,
             dispatch_ms: float = 0.0, memo_ms: float = 0.0,
             hook_ms: float = 0.0, growth=None, span_salt=None,
             **extra) -> dict:
        """One committed chain span. `t0` is the `clock()` value taken
        at span start; total wall closes here. `growth` is the list of
        capacity-trajectory events this span committed; `span_salt` is
        the memo/fault-span fingerprint hex when the driver has one."""
        now = time.monotonic()
        rec = {"kind": "span", "seq": self._seq, "r0": int(r0),
               "r1": int(r1), "windows": int(r1) - int(r0),
               "mode": mode,
               "wall_t0_ms": (t0 - self._origin) * 1e3,
               "wall_ms": (now - t0) * 1e3,
               "dispatch_ms": dispatch_ms, "memo_ms": memo_ms,
               "hook_ms": hook_ms}
        if growth:
            rec["growth"] = [dict(ev) for ev in growth]
        if span_salt is not None:
            rec["span_salt"] = span_salt
        rec.update(extra)
        self._seq += 1
        self.records.append(rec)
        self._emit(rec)
        return rec

    def annotate(self, kind: str, **fields) -> dict:
        """A boundary-hook event (harvest tick, guard deltas,
        checkpoint/tamper/kill, resume seam, fault-span fingerprint)
        at its wall instant. `fields` must be host values."""
        rec = {"kind": kind,
               "wall_t0_ms": (time.monotonic() - self._origin) * 1e3}
        rec.update(fields)
        self.records.append(rec)
        self._emit(rec)
        return rec

    # -- finalization ----------------------------------------------------

    def memo_close(self, memo) -> dict:
        """Fold the `ChainMemo.report()` into the ledger — ONE
        artifact; `--memo-report` stays a filtered view of this record
        (trace_report.py --memo-view, pinned by test)."""
        rec = {"kind": "memo", "report": memo.report()}
        self.records.append(rec)
        self._emit(rec)
        return rec

    def close(self, **fields) -> dict:
        """Terminal record: total wall + span/sync accounting (spans
        counted from THIS process — a resumed ledger's earlier
        segments live only in the sink file). Closes the sink."""
        spans = [r for r in self.records if r.get("kind") == "span"]
        rec = {"kind": "end",
               "wall_ms": (time.monotonic() - self._origin) * 1e3,
               "spans": len(spans),
               "windows": sum(r["windows"] for r in spans)}
        rec.update(fields)
        self.records.append(rec)
        self._emit(rec)
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        return rec

    def write(self, path: str) -> dict:
        """Dump the ledger as JSONL (meta first, end last when
        `close()` ran). In streaming-sink mode the file is already on
        disk record-by-record: writing to the sink path is a no-op
        (returns its summary); writing elsewhere copies the in-memory
        records (which on a resumed tracer are THIS segment only)."""
        if self.sink_path is not None and (
                os.path.abspath(path) == os.path.abspath(self.sink_path)):
            return {"path": path, "records": len(self.records),
                    "streamed": True}
        with open(path, "w") as fh:
            for rec in self.records:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return {"path": path, "records": len(self.records)}


# --------------------------------------------------------------------------
# ledger readers (trace_report.py / compare_runs.py share these)
# --------------------------------------------------------------------------


def read_ledger(lines: Iterable[str]) -> list[dict]:
    """Parse a run-ledger JSONL stream, enforcing the schema stamp on
    the meta line — a ledger from a different schema version refuses to
    parse rather than mis-attributing fields."""
    records = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        records.append(json.loads(line))
    if not records or records[0].get("kind") != "meta":
        raise ValueError("run ledger must start with a meta record")
    schema = records[0].get("schema")
    if schema != RUNLEDGER_SCHEMA:
        raise ValueError(
            f"run-ledger schema mismatch: file says {schema!r}, this "
            f"tree reads {RUNLEDGER_SCHEMA!r} — regenerate the ledger "
            "or use the matching tools/trace_report.py")
    return records


def load_ledger(path: str) -> list[dict]:
    with open(path) as fh:
        return read_ledger(fh)


def stitch_ledger(records: list[dict]) -> tuple[list[dict], int]:
    """Rebase a resumed ledger's wall clocks onto one monotone
    timeline.

    A killed-and-resumed run's ledger is one stream with a ``resume``
    annotation at every seam (the resumed tracer appends; no duplicate
    head meta). Each segment's wall clocks restart at its own process
    origin, so raw ``wall_t0_ms`` values overlap; this shifts every
    post-seam record forward by the maximum wall extent seen so far —
    purely presentational (WALL_FIELDS are excluded from every
    compare), but it is what makes the Chrome export render segments
    side by side instead of stacked. Returns ``(rebased_records,
    n_resumes)``; untouched pass-through when no seam exists."""
    out: list[dict] = []
    offset = 0.0
    seg_max = 0.0
    resumes = 0
    for rec in records:
        if rec.get("kind") == "resume":
            resumes += 1
            offset = seg_max
        if "wall_t0_ms" in rec:
            rec = dict(rec)
            rec["wall_t0_ms"] += offset
            seg_max = max(seg_max,
                          rec["wall_t0_ms"] + rec.get("wall_ms", 0.0))
        out.append(rec)
    return out, resumes


def phase_totals(records: list[dict]) -> dict:
    """Aggregate wall attribution — the per-phase table compare_runs
    --trace and trace_report print: totals plus a per-mode breakdown.
    All values are wall-clock (WALL_FIELDS discipline: meaningful only
    within one backend fingerprint)."""
    spans = [r for r in records if r.get("kind") == "span"]
    out = {
        "spans": len(spans),
        "windows": sum(r["windows"] for r in spans),
        "wall_ms": sum(r["wall_ms"] for r in spans),
        "dispatch_ms": sum(r["dispatch_ms"] for r in spans),
        "memo_ms": sum(r["memo_ms"] for r in spans),
        "hook_ms": sum(r["hook_ms"] for r in spans),
        "growth_events": sum(len(r.get("growth", ())) for r in spans),
        "resumes": sum(1 for r in records if r.get("kind") == "resume"),
    }
    for mode in SPAN_MODES:
        picked = [r for r in spans if r["mode"] == mode]
        out[f"{mode}_spans"] = len(picked)
        out[f"{mode}_ms"] = sum(r["wall_ms"] for r in picked)
    end = next((r for r in records if r.get("kind") == "end"), None)
    if end is not None:
        out["run_wall_ms"] = end["wall_ms"]
    return out


def memo_view(records: list[dict]) -> Optional[dict]:
    """The memo filtered view: the folded `ChainMemo.report()` — what
    `run_scenarios --memo-report` publishes per scenario. None when the
    run was not memoized."""
    rec = next((r for r in records if r.get("kind") == "memo"), None)
    return rec["report"] if rec is not None else None


# --------------------------------------------------------------------------
# the two-clock Chrome-trace export
# --------------------------------------------------------------------------


def write_chrome_trace(records: list[dict], path: str, *,
                       heartbeats: Optional[list[dict]] = None,
                       max_hosts: int = 256, hops=None,
                       max_flows: int = 512) -> dict:
    """Merge the run ledger's wall-time driver spans with the
    virtual-time simulation rows into one Chrome trace-event JSON.

    Driver row (pid `DRIVER_PID`): each span is an X slice whose
    children nest the wall split — `dispatch` at the span start,
    `memo` directly after, `hook` closing the span — so Perfetto's
    slice nesting IS the attribution. Annotations render as instants.
    `ts`/`dur` on this row are wall µs since run start.

    Simulation rows (when `heartbeats` given): exactly the rows
    telemetry/export.py `write_perfetto_trace` draws — harvest slices,
    percentile counters, per-host traffic, flight-recorder flows — on
    the VIRTUAL axis (1 trace µs = 1 simulated µs). The two tracks
    share a timeline but not a clock; `otherData.clocks` names each."""
    # a resumed ledger's segments get their wall clocks rebased onto
    # one monotone axis first (no-op for single-segment ledgers)
    records, _resumes = stitch_ledger(records)
    meta = records[0] if records and records[0].get("kind") == "meta" \
        else {"label": "run"}
    events: list[dict] = [
        {"ph": "M", "pid": DRIVER_PID, "tid": 0, "name": "process_name",
         "args": {"name": "driver (wall time)"}},
        {"ph": "M", "pid": DRIVER_PID, "tid": 0, "name": "thread_name",
         "args": {"name": meta.get("label", "run")}},
    ]
    for rec in records:
        kind = rec.get("kind")
        if kind == "span":
            ts = rec["wall_t0_ms"] * 1e3  # ledger ms -> trace us
            dur = max(rec["wall_ms"], 1e-3) * 1e3
            args = {k: rec[k] for k in
                    ("r0", "r1", "windows", "mode", "span_salt")
                    if k in rec}
            if rec.get("growth"):
                args["growth"] = rec["growth"]
            events.append({
                "ph": "X", "pid": DRIVER_PID, "tid": 0,
                "name": f"{rec['mode']} [{rec['r0']},{rec['r1']})",
                "ts": ts, "dur": dur, "args": args})
            # nested children: measured sub-intervals in their real
            # order (dispatch, then memo bookkeeping, hook last)
            offset = 0.0
            for name, ms in (("dispatch", rec["dispatch_ms"]),
                             ("memo", rec["memo_ms"])):
                if ms > 0:
                    events.append({
                        "ph": "X", "pid": DRIVER_PID, "tid": 0,
                        "name": name, "ts": ts + offset * 1e3,
                        "dur": min(ms, rec["wall_ms"]) * 1e3,
                        "args": {}})
                    offset += ms
            if rec["hook_ms"] > 0:
                events.append({
                    "ph": "X", "pid": DRIVER_PID, "tid": 0,
                    "name": "hook",
                    "ts": ts + max(rec["wall_ms"] - rec["hook_ms"],
                                   offset) * 1e3,
                    "dur": rec["hook_ms"] * 1e3, "args": {}})
        elif kind not in ("meta", "end"):
            events.append({
                "ph": "i", "pid": DRIVER_PID, "tid": 0, "s": "p",
                "name": kind, "ts": rec.get("wall_t0_ms", 0.0) * 1e3,
                "args": {k: v for k, v in rec.items()
                         if k not in ("kind", "wall_t0_ms")}})

    sim_summary = {"hosts_plotted": 0, "hosts_dropped_by_cap": 0,
                   "flows_plotted": 0, "flows_dropped_by_cap": 0}
    if heartbeats:
        from .export import build_sim_events

        sim_events, sim_summary = build_sim_events(
            heartbeats, max_hosts=max_hosts, hops=hops,
            max_flows=max_flows)
        events.extend(sim_events)

    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": RUNLEDGER_SCHEMA,
            "clocks": {
                "driver (wall time)":
                    "wall us since run start (host monotonic)",
                "simulation (virtual time)":
                    "virtual simulated time (1 trace us = 1 sim us)",
            },
            **sim_summary,
        },
    }
    with open(path, "w") as fh:
        json.dump(trace, fh, sort_keys=True)
    return {"path": path, "events": len(events), **sim_summary}

"""Telemetry exporters: Perfetto/Chrome trace + plot-pipeline stats.

Counterpart of `shadow_tpu/telemetry/export.py`, line for line: it reads
heartbeat JSONL and writes files, with no tensor in sight.
`write_perfetto_trace` lays a run's heartbeat stream out on the
virtual-time axis in the Chrome trace-event JSON format (loadable in
Perfetto / chrome://tracing): one process row per host carrying counter
tracks (traffic rates and drop totals, per-interval deltas of the
cumulative heartbeat counters) plus a simulation row whose slices mark
the harvest intervals. `ts` is virtual nanoseconds divided by 1000: a
trace "us" is a simulated us, so two seeds' traces align for diffing.

`to_plot_stats` converts the same heartbeats into the
`stats.shadow.json` shape `tools/parse_shadow.py` produces, so
`tools/plot_shadow.py` plots telemetry runs unchanged.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

from . import histo
from .flightrec import hop_flows
from .harvest import MAX_FIELDS

#: keys plotted as per-host counter tracks (cumulative in heartbeats;
#: traffic is emitted as per-interval rates, drops as running totals)
_RATE_KEYS = ("bytes_out", "bytes_in", "pkts_out", "pkts_in")
_TOTAL_KEYS = ("drop_ring_full", "drop_qdisc", "drop_loss",
               "retransmits", "packets_dropped", "retransmitted")


def read_heartbeats(lines: Iterable[str]) -> list[dict]:
    """Parse heartbeat JSONL. Lines may carry a log prefix (the
    shadowlog-formatted `telemetry time_ns=...` form): everything
    before the first '{' is ignored; non-JSON lines are skipped."""
    out = []
    for line in lines:
        brace = line.find("{")
        if brace < 0:
            continue
        try:
            rec = json.loads(line[brace:])
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("type") in ("sim", "host"):
            out.append(rec)
    return out


def _host_series(heartbeats: list[dict]) -> dict[str, list[dict]]:
    """Per-host heartbeat lines, keyed by host name, in time order."""
    series: dict[str, list[dict]] = {}
    for rec in heartbeats:
        if rec.get("type") == "host":
            series.setdefault(rec["host"], []).append(rec)
    for recs in series.values():
        recs.sort(key=lambda r: r["time_ns"])
    return series


def _merged_counters(rec: dict) -> dict[str, int]:
    """One flat counter dict per host line: device counters first, CPU
    tracker counters layered on top (distinct names, so no clobbering
    beyond the intentional shared namespace)."""
    out: dict[str, int] = {}
    out.update(rec.get("device") or {})
    for k, v in (rec.get("cpu") or {}).items():
        if isinstance(v, (int, float)):
            out[k] = v
    return out


def build_sim_events(heartbeats: list[dict], *, max_hosts: int = 256,
                     hops: Optional[list[dict]] = None,
                     max_flows: int = 512) -> tuple[list[dict], dict]:
    """The virtual-time trace-event rows of `write_perfetto_trace`,
    as (events, caps-summary) — shared with the two-clock merged
    exporter (telemetry/tracer.py `write_chrome_trace`), which lays
    these beside the wall-time driver row."""
    events: list[dict] = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": "simulation (virtual time)"}},
    ]
    # simulation row: one slice per harvest interval
    sims = sorted((r for r in heartbeats if r.get("type") == "sim"),
                  key=lambda r: r["time_ns"])
    prev_t = 0
    prev_hist: dict[str, list] = {}
    for rec in sims:
        t = rec["time_ns"]
        args = {k: rec[k] for k in ("windows", "events", "sort_occupancy")
                if k in rec}
        events.append({
            "ph": "X", "pid": 0, "tid": 0,
            "name": "harvest", "ts": prev_t / 1e3,
            "dur": max(t - prev_t, 1) / 1e3, "args": args,
        })
        for hname, counts in sorted((rec.get("hist") or {}).items()):
            # interval percentiles from the cumulative bucket deltas:
            # counter tracks on the VIRTUAL-time axis, so an incast's
            # p99 blowup lands at its simulated instant
            prev = prev_hist.get(hname, [0] * len(counts))
            delta = [c - p for c, p in zip(counts, prev)]
            prev_hist[hname] = counts
            if sum(delta) <= 0:
                continue
            events.append({
                "ph": "C", "pid": 0,
                "name": hname.removeprefix(histo.HIST_PREFIX),
                "ts": t / 1e3, "args": histo.percentiles(delta),
            })
        for totals_key in ("device_totals", "cpu_totals"):
            if totals_key in rec:
                events.append({
                    "ph": "C", "pid": 0, "name": totals_key,
                    "ts": t / 1e3,
                    "args": {k: v for k, v in rec[totals_key].items()},
                })
        for ev in rec.get("annotations", ()):
            # run-lifecycle annotations (capacity-ring growth, ...) as
            # global trace instants at their own virtual instant
            events.append({
                "ph": "i", "pid": 0, "tid": 0, "s": "g",
                "name": ev.get("kind", "event"),
                "ts": ev.get("time_ns", t) / 1e3,
                "args": dict(ev),
            })
        prev_t = t

    series = _host_series(heartbeats)
    by_bytes = sorted(
        series.items(),
        key=lambda kv: (-sum(_merged_counters(r).get("bytes_out", 0)
                             + _merged_counters(r).get("bytes_in", 0)
                             for r in kv[1][-1:]), kv[0]),
    )
    plotted, dropped = by_bytes[:max_hosts], by_bytes[max_hosts:]
    for name, recs in sorted(plotted):
        pid = recs[0]["host_id"]
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})
        prev: dict[str, int] = {}
        prev_t = 0
        for rec in recs:
            t = rec["time_ns"]
            c = _merged_counters(rec)
            dt_s = max(t - prev_t, 1) / 1e9
            rates = {k: round((c[k] - prev.get(k, 0)) / dt_s, 3)
                     for k in _RATE_KEYS if k in c}
            if rates:
                events.append({"ph": "C", "pid": pid, "name": "traffic/s",
                               "ts": t / 1e3, "args": rates})
            totals = {k: c[k] for k in _TOTAL_KEYS if k in c}
            if totals:
                events.append({"ph": "C", "pid": pid, "name": "drops",
                               "ts": t / 1e3, "args": totals})
            prev, prev_t = c, t

    flows_written = flows_dropped = 0
    if hops:
        flows_written, flows_dropped = _flow_events(
            events, hops, max_flows)

    return events, {"hosts_plotted": len(plotted),
                    "hosts_dropped_by_cap": len(dropped),
                    "flows_plotted": flows_written,
                    "flows_dropped_by_cap": flows_dropped}


def write_perfetto_trace(heartbeats: list[dict], path: str, *,
                         max_hosts: int = 256,
                         hops: Optional[list[dict]] = None,
                         max_flows: int = 512) -> dict:
    """Write a Chrome trace-event JSON file; returns a small summary
    dict (events written, hosts plotted/dropped). Hosts are capped at
    `max_hosts` counter rows (top talkers by total bytes) so a 4096-host
    run stays loadable; the cap is recorded in the trace's otherData —
    never silent.

    When the sim heartbeats carry `hist` bucket vectors
    (telemetry/histo.py), the simulation row gains per-interval
    percentile COUNTER tracks on the virtual-time axis (p50/p90/p99/
    p999 of each histogram's interval delta). When `hops` (flight-
    recorder hop records, telemetry/flightrec.py) are given, sampled
    packets become FLOW events: a send slice on the source host row
    bound by an `s` arrow to a deliver slice on the destination row —
    one packet's life, linked across hosts. Flows are capped at
    `max_flows` (recorded in otherData, never silent)."""
    events, caps = build_sim_events(heartbeats, max_hosts=max_hosts,
                                    hops=hops, max_flows=max_flows)
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "virtual simulated time (1 trace us = 1 sim us)",
            **caps,
        },
    }
    with open(path, "w") as fh:
        json.dump(trace, fh, sort_keys=True)
    return {"events": len(events), "path": path, **caps}


def _flow_events(events: list[dict], hops: list[dict],
                 max_flows: int) -> tuple[int, int]:
    """Append flight-recorder packet flows to a trace-event list: for
    each sampled packet with a `routed` hop, a send slice on the
    source host's row, an `s` flow arrow, and (when the packet's
    terminal hop was recorded) a terminal slice on the destination row
    closing the arrow (`f`, bp="e"). An AQM drop is a terminal hop
    too, named `drop_aqm` — the trace says where and why the packet
    died. Loss/fault-dropped packets never entered the wire, so they
    have no flow; their hops still appear in the hops JSONL. Host rows
    use pid = host index + 1 (the heartbeat host_id), matching the
    counter-track rows. Returns (flows written, flows dropped by the
    cap)."""
    # only flows with a `routed` hop are plottable (e.g. an ingest-only
    # group has no wire span); the cap counts PLOTTABLE flows cut, so
    # flows_dropped_by_cap is the same number regardless of where the
    # unplottable groups fall in iteration order
    plottable = []
    for (src, seq), group in sorted(hop_flows(hops).items()):
        routed = next((h for h in group if h["kind"] == "routed"), None)
        if routed is not None:
            plottable.append(((src, seq), group, routed))
    written = 0
    for (src, seq), group, routed in plottable[:max_flows]:
        fid = f"pkt-{src}-{seq}"
        terminal = next(
            (h for h in group
             if h["kind"] in ("delivered", "drop_aqm")), None)
        end_t = terminal["t_ns"] if terminal else routed["t_ns"]
        events.append({
            "ph": "X", "pid": src + 1, "tid": 1,
            "name": f"send #{seq} -> host{routed['dst'] + 1}",
            "ts": routed["t_ns"] / 1e3,
            "dur": max(end_t - routed["t_ns"], 1) / 1e3,
            "args": dict(routed),
        })
        events.append({"ph": "s", "pid": src + 1, "tid": 1,
                       "id": fid, "name": "packet",
                       "ts": routed["t_ns"] / 1e3})
        if terminal is not None:
            events.append({
                "ph": "X", "pid": terminal["dst"] + 1, "tid": 1,
                "name": f"{terminal['kind']} #{seq} "
                        f"from host{src + 1}",
                "ts": terminal["t_ns"] / 1e3, "dur": 1.0,
                "args": dict(terminal),
            })
            events.append({"ph": "f", "bp": "e",
                           "pid": terminal["dst"] + 1, "tid": 1,
                           "id": fid, "name": "packet",
                           "ts": terminal["t_ns"] / 1e3})
        written += 1
    return written, len(plottable) - written


def to_plot_stats(heartbeats: list[dict]) -> dict:
    """The `stats.shadow.json` shape `tools/plot_shadow.py` consumes:
    cumulative per-host counters sampled at heartbeat times. Drop
    reasons fold into the `packets_dropped` total when the CPU tracker
    didn't already provide one."""
    nodes: dict[str, dict] = {}
    for name, recs in sorted(_host_series(heartbeats).items()):
        entry = nodes.setdefault(name, {"time_ns": [], "counters": []})
        for rec in recs:
            c = _merged_counters(rec)
            if "packets_dropped" not in c:
                c["packets_dropped"] = (
                    c.get("drop_ring_full", 0) + c.get("drop_qdisc", 0)
                    + c.get("drop_loss", 0))
            entry["time_ns"].append(rec["time_ns"])
            entry["counters"].append(c)
    return {"nodes": nodes, "rusage": [], "meminfo": []}


def summarize(heartbeats: list[dict], *, top: int = 10) -> dict:
    """Run-level summary for the report CLI: final totals, drop
    breakdown, window stats, top talkers."""
    sims = sorted((r for r in heartbeats if r.get("type") == "sim"),
                  key=lambda r: r["time_ns"])
    series = _host_series(heartbeats)
    finals = {name: _merged_counters(recs[-1])
              for name, recs in series.items()}
    total = {}
    for c in finals.values():
        for k, v in c.items():
            if not isinstance(v, (int, float)):
                continue
            if k in MAX_FIELDS:  # high-water marks: fleet max, not sum
                total[k] = max(total.get(k, 0), v)
            else:
                total[k] = total.get(k, 0) + v
    talkers = sorted(
        finals.items(),
        key=lambda kv: (-(kv[1].get("bytes_out", 0)
                          + kv[1].get("bytes_in", 0)), kv[0]))[:top]
    out = {
        "heartbeats": len(heartbeats),
        "harvests": len(sims),
        "hosts": len(series),
        "last_time_ns": sims[-1]["time_ns"] if sims else 0,
        "totals": total,
        "top_talkers": [
            {"host": name,
             "bytes_out": c.get("bytes_out", 0),
             "bytes_in": c.get("bytes_in", 0)}
            for name, c in talkers],
    }
    if sims:
        last = sims[-1]
        for k in ("windows", "events", "sort_occupancy"):
            if k in last:
                out[k] = last[k]
        if last.get("hist"):
            # run-level SLO percentiles from the final cumulative
            # fleet histograms (telemetry/histo.py bucket scheme)
            out["percentiles"] = {
                name.removeprefix(histo.HIST_PREFIX):
                    histo.percentiles(counts)
                for name, counts in sorted(last["hist"].items())}
    return out


def host_percentiles(heartbeats: list[dict]) -> dict[str, dict]:
    """Per-host percentile tables from each host's FINAL cumulative
    histogram line: {host_name: {hist_name: {p50: ..., ...}}} — the
    report CLI's per-host latency table."""
    out: dict[str, dict] = {}
    for name, recs in sorted(_host_series(heartbeats).items()):
        hist = next((r["hist"] for r in reversed(recs)
                     if r.get("hist")), None)
        if not hist:
            continue
        out[name] = {
            hname.removeprefix(histo.HIST_PREFIX):
                histo.percentiles(counts)
            for hname, counts in sorted(hist.items())}
    return out

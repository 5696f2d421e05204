"""Turn a telemetry heartbeat JSONL stream into a summary, a Perfetto
trace, and plot-pipeline stats.

The port of `tools/telemetry_report.py`, on the port's own
`telemetry/export.py`, `histo.py` and `flightrec.read_hops`: the same
flags, and the same stdout, JSON, trace and `stats.shadow.json` bytes
for the same input files. It reads and writes host files only and
touches no device.

    python -m shadow_tpu_torch.tools.telemetry_report run/telemetry.jsonl
        [--json] [--trace trace.json] [--hops run/hops.jsonl]
        [--stats-dir out/] [--top K]
    python -m shadow_tpu_torch.tools.telemetry_report w0.jsonl w1.jsonl \
        --ensemble          # the percentile of percentiles over worlds
    python -m shadow_tpu_torch.tools.telemetry_report --slo slo.json
        # a run_scenarios --slo-report file as target-vs-measured tables

Input is a run's heartbeat JSONL (or a raw log: lines are matched on
their embedded JSON; '-' reads stdin). `--ensemble` takes one stream per
world and reduces each world's final cumulative histograms to its own
p50/p90/p99/p999 first, then reports each quantile's min/median/max
across worlds (`histo.ensemble_percentiles`). `--slo` exits 1 on a
missed SLO target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..telemetry import export, histo
from ..telemetry.flightrec import read_hops


def _delta_table(label: str, s0: dict, s1: dict, width: int = 24,
                 unit: str = "ms"):
    """The per-key before/after/ratio table of `tools/compare_runs.py`
    (its `_delta_table`, copied)."""
    names = sorted(set(s0) | set(s1),
                   key=lambda n: -float(s0.get(n, s1.get(n, 0)) or 0))
    print(f"{label:<{width}} {'before ' + unit:>12} "
          f"{'after ' + unit:>12} {'ratio':>7}")
    for name in names:
        a, b = s0.get(name), s1.get(name)
        ratio = (f"{a / b:.2f}x" if a and b else "-")
        fmt = lambda x: f"{x:.2f}" if x is not None else "-"
        print(f"{name:<{width}} {fmt(a):>12} {fmt(b):>12} {ratio:>7}")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _print_table(summary: dict) -> None:
    print(f"heartbeats: {summary['heartbeats']}  "
          f"harvests: {summary['harvests']}  hosts: {summary['hosts']}  "
          f"last virtual time: {summary['last_time_ns'] / 1e9:.3f} s")
    for k in ("windows", "events", "sort_occupancy"):
        if k in summary:
            print(f"  {k}: {summary[k]}")
    totals = summary["totals"]
    if totals:
        print("totals:")
        for k in sorted(totals):
            v = totals[k]
            shown = _fmt_bytes(v) if k.startswith("bytes") else v
            print(f"  {k:>18}: {shown}")
        # drop taxonomy (docs/robustness.md): the `fault` bucket holds
        # INJECTED losses (crashes, corruption bursts) so an operator
        # never misreads a scheduled outage as wire loss
        drops = {k[len("drop_"):]: v for k, v in totals.items()
                 if k.startswith("drop_")}
        if any(drops.values()):
            total_drops = sum(drops.values())
            parts = ", ".join(f"{k}={v}" for k, v in sorted(drops.items()))
            print(f"drop breakdown ({total_drops} total): {parts}")
            if drops.get("fault"):
                print(f"  note: {drops['fault']} drop(s) are INJECTED "
                      "faults (faults: schedule), not wire loss")
    if summary["top_talkers"]:
        print("top talkers (bytes out / in):")
        for t in summary["top_talkers"]:
            print(f"  {t['host']:>16}  {_fmt_bytes(t['bytes_out']):>12}  "
                  f"{_fmt_bytes(t['bytes_in']):>12}")
    pct = summary.get("percentiles")
    if pct:
        print("distributions (log2-bucket upper bounds, "
              "docs/observability.md):")
        for name, ps in sorted(pct.items()):
            unit = " ns" if name.endswith("_ns") else ""
            cols = "  ".join(f"{k}={v}{unit}"
                             for k, v in sorted(ps.items(),
                                                key=lambda kv: len(kv[0])))
            print(f"  {name:>16}: {cols}")


def _print_host_percentiles(per_host: dict, top: int) -> None:
    if not per_host:
        return
    print(f"per-host delivery latency (first {top} hosts, "
          "p50/p99/p999 ns):")
    shown = 0
    for host, hists in per_host.items():
        ps = hists.get("delivery_ns")
        if not ps:
            continue
        print(f"  {host:>16}  p50={ps['p50']:>12}  p99={ps['p99']:>12}  "
              f"p999={ps['p999']:>12}")
        shown += 1
        if shown >= top:
            remaining = len(per_host) - shown
            if remaining > 0:
                print(f"  ... and {remaining} more host(s) (--top)")
            break


def _final_hist(heartbeats: list[dict]) -> dict | None:
    """One world's final cumulative fleet histograms — the same line
    `summarize` reduces to run-level percentiles."""
    sims = sorted((r for r in heartbeats if r.get("type") == "sim"),
                  key=lambda r: r["time_ns"])
    return next((r["hist"] for r in reversed(sims) if r.get("hist")),
                None)


def ensemble_report(paths: list[str]) -> dict:
    """The percentile-of-percentiles report over one heartbeat stream
    per world: per-world histogram percentiles first, then min/median/
    max across worlds per quantile (histo.ensemble_percentiles)."""
    hists = []
    for path in paths:
        with open(path) as fh:
            heartbeats = export.read_heartbeats(fh)
        hist = _final_hist(heartbeats)
        if hist is None:
            raise SystemExit(
                f"telemetry_report: {path} carries no histogram "
                "heartbeats — ensemble mode needs runs with "
                "telemetry.histograms enabled")
        hists.append(hist)
    names = sorted(set().union(*(h.keys() for h in hists)))
    report = {}
    for name in names:
        worlds = [h[name] for h in hists if name in h]
        report[name.removeprefix(histo.HIST_PREFIX)] = \
            histo.ensemble_percentiles(worlds)
    return {"worlds": len(paths), "files": list(paths),
            "percentile_of_percentiles": report}


def _print_ensemble(rep: dict) -> None:
    print(f"ensemble percentile of percentiles "
          f"({rep['worlds']} worlds):")
    for name, qs in sorted(rep["percentile_of_percentiles"].items()):
        unit = " ns" if name.endswith("_ns") else ""
        print(f"  {name}:")
        for q, bars in sorted(qs.items(), key=lambda kv: len(kv[0])):
            print(f"    {q:>5}: min={bars['min']}{unit}  "
                  f"median={bars['median']}{unit}  "
                  f"max={bars['max']}{unit}  "
                  f"(n={bars['worlds']})")


def slo_table(path: str) -> int:
    """Print a run_scenarios --slo-report file as per-quantile
    target-vs-measured tables, reusing compare_runs' shared
    `_delta_table` (before = the scenario's declared SLO target, after
    = the measured percentile; the ratio column is the headroom), plus
    the compute-plane served/queued/overflow totals."""
    with open(path) as fh:
        rec = json.load(fh)
    scenarios = dict(rec.get("scenarios") or {})
    if not scenarios:
        print("telemetry_report: no compute-plane scenarios in "
              f"{path}", file=sys.stderr)
        return 1
    for q in ("p99", "p999"):
        targets = {}
        measured = {}
        for name, v in scenarios.items():
            t = (v.get("slo", {}).get("targets") or {}).get(q)
            if t is not None:
                targets[name] = t["target_ns"] / 1e6
                measured[name] = t["measured_ns"] / 1e6
            elif q in v.get("slo", {}).get("sojourn_ns", {}):
                measured[name] = v["slo"]["sojourn_ns"][q] / 1e6
        if targets or measured:
            print(f"sojourn {q} — SLO target (before) vs measured "
                  "(after); ratio = headroom:")
            _delta_table("scenario", targets, measured, width=32)
            print()
    totals = {m: {n: (v.get("compute") or {}).get(m)
                  for n, v in scenarios.items()
                  if (v.get("compute") or {}).get(m) is not None}
              for m in ("served", "queued", "overflow")}
    for m, t in totals.items():
        if t:
            _delta_table(f"scenario ({m})", t, t, width=32,
                         unit="count")
            print()
    missed = [(n, q) for n, v in sorted(scenarios.items())
              for q, t in (v.get("slo", {}).get("targets") or {}).items()
              if not t.get("met", True)]
    for n, q in missed:
        print(f"SLO MISS: {n} {q}")
    return 1 if missed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jsonl", metavar="PATH", nargs="*",
                    help="heartbeat JSONL (or a shadow log; '-' = "
                         "stdin); with --ensemble, one stream per "
                         "world")
    ap.add_argument("--ensemble", action="store_true",
                    help="percentile-of-percentiles across one "
                         "heartbeat stream per world: per-world "
                         "histogram percentiles, then min/median/max "
                         "error bars across worlds")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of a table")
    ap.add_argument("--trace", metavar="OUT",
                    help="also write a Perfetto/Chrome trace.json")
    ap.add_argument("--hops", metavar="PATH",
                    help="flight-recorder hops JSONL; feeds --trace "
                         "packet flow spans and the hop summary")
    ap.add_argument("--trace-max-hosts", type=int, default=256,
                    help="counter-track cap for the trace (default 256)")
    ap.add_argument("--trace-max-flows", type=int, default=512,
                    help="packet-flow cap for the trace (default 512)")
    ap.add_argument("--stats-dir", metavar="DIR",
                    help="also write DIR/stats.shadow.json for "
                         "tools/plot_shadow.py")
    ap.add_argument("--top", type=int, default=10,
                    help="top talkers to list (default 10)")
    ap.add_argument("--slo", metavar="REPORT", default=None,
                    help="print a run_scenarios --slo-report file as "
                         "per-quantile target-vs-measured tables "
                         "(compare_runs' shared delta-table shape); "
                         "exit 1 on any missed SLO target")
    args = ap.parse_args(argv)

    if args.slo is not None:
        if args.jsonl or args.ensemble:
            print("telemetry_report: --slo takes the report path only "
                  "(no heartbeat streams)", file=sys.stderr)
            return 2
        return slo_table(args.slo)
    if not args.jsonl:
        ap.error("heartbeat PATH required (or --slo REPORT)")

    if args.ensemble:
        if len(args.jsonl) < 2:
            print("telemetry_report: --ensemble needs at least two "
                  "per-world heartbeat streams", file=sys.stderr)
            return 2
        rep = ensemble_report(args.jsonl)
        if args.json:
            print(json.dumps(rep, indent=2, sort_keys=True))
        else:
            _print_ensemble(rep)
        return 0
    if len(args.jsonl) != 1:
        print("telemetry_report: multiple heartbeat streams need "
              "--ensemble", file=sys.stderr)
        return 2

    if args.jsonl[0] == "-":
        heartbeats = export.read_heartbeats(sys.stdin)
    else:
        with open(args.jsonl[0]) as fh:
            heartbeats = export.read_heartbeats(fh)
    if not heartbeats:
        print("telemetry_report: no heartbeat records found",
              file=sys.stderr)
        return 1

    summary = export.summarize(heartbeats, top=args.top)
    hops = None
    if args.hops:
        with open(args.hops) as fh:
            hops = read_hops(fh)
        summary["hops"] = len(hops)
    if args.trace:
        summary["trace"] = export.write_perfetto_trace(
            heartbeats, args.trace, max_hosts=args.trace_max_hosts,
            hops=hops, max_flows=args.trace_max_flows)
    if args.stats_dir:
        os.makedirs(args.stats_dir, exist_ok=True)
        stats_path = os.path.join(args.stats_dir, "stats.shadow.json")
        with open(stats_path, "w") as fh:
            json.dump(export.to_plot_stats(heartbeats), fh, indent=2)
        summary["stats"] = stats_path

    per_host = export.host_percentiles(heartbeats)
    if args.json:
        if per_host:
            summary["per_host_percentiles"] = per_host
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        _print_table(summary)
        _print_host_percentiles(per_host, args.top)
        if hops is not None:
            print(f"flight recorder: {len(hops)} sampled hop(s)")
        if args.trace:
            print(f"wrote {args.trace} "
                  f"({summary['trace']['events']} events, "
                  f"{summary['trace']['flows_plotted']} flow span(s))")
        if args.stats_dir:
            print(f"wrote {summary['stats']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

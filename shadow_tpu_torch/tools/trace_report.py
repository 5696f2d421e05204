"""Run-ledger report: summarize a run-ledger JSONL, export the two-clock
Chrome trace, or print the memo view.

The port of `tools/trace_report.py`, on the port's own
`telemetry/tracer.py` and `telemetry/export.py`: the same flags, and the
same stdout, JSON and Chrome-trace bytes for the same ledger. The ledger
is the driver loop's span-by-span log (`telemetry/tracer.RunTracer`,
written by `run_scenarios --trace`, `chaos_smoke --trace` or `bench
--trace`). It reads and writes host files only and touches no device.

    python -m shadow_tpu_torch.tools.trace_report run.ledger.jsonl
        # per-mode span table (execute / replay / ffwd / ensemble), the
        # dispatch / memo / hook split, capacity events
    python -m shadow_tpu_torch.tools.trace_report run.ledger.jsonl --json
    python -m shadow_tpu_torch.tools.trace_report run.ledger.jsonl \
        --memo-view         # the folded memo report (exit 2: none)
    python -m shadow_tpu_torch.tools.trace_report run.ledger.jsonl \
        --chrome out.json [--heartbeats hb.jsonl] [--hops hops.jsonl]

Wall times compare only within one backend fingerprint (the ledger's
meta record carries it).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..telemetry import export, tracer


def _read_jsonl(path: str) -> list[dict]:
    """Best-effort JSONL (the hops artifact): non-JSON lines skipped."""
    out = []
    with open(path) as fh:
        for line in fh:
            brace = line.find("{")
            if brace < 0:
                continue
            try:
                out.append(json.loads(line[brace:]))
            except json.JSONDecodeError:
                continue
    return out


def summarize(records: list[dict]) -> dict:
    """The report object: meta + phase totals + annotation census +
    the memo view when the run was memoized."""
    meta = records[0]
    spans = [r for r in records if r.get("kind") == "span"]
    notes: dict[str, int] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind not in ("meta", "span", "memo", "end"):
            notes[kind] = notes.get(kind, 0) + 1
    growth = [ev for r in spans for ev in r.get("growth", ())]
    # a resumed run's ledger is ONE file appended across invocations:
    # each `resume` record is a seam (the checkpoint id + restart
    # round), and wall times are stitched per segment for display
    resumes = [{"checkpoint": r.get("checkpoint"), "r": r.get("r")}
               for r in records if r.get("kind") == "resume"]
    out = {
        "schema": meta.get("schema"),
        "label": meta.get("label"),
        "backend": meta.get("backend"),
        "phases": tracer.phase_totals(records),
        "annotations": notes,
        "growth": growth,
    }
    if resumes:
        out["resumes"] = resumes
    memo = tracer.memo_view(records)
    if memo is not None:
        out["memo"] = memo
    return out


def print_summary(rep: dict) -> None:
    be = rep.get("backend") or {}
    print(f"run ledger: {rep['label']}  [{rep['schema']}]  "
          f"backend={be.get('platform')}/{be.get('device_kind')}")
    ph = rep["phases"]
    print(f"  spans={ph['spans']}  windows={ph['windows']}  "
          f"wall={ph['wall_ms']:.1f} ms"
          + (f"  run_wall={ph['run_wall_ms']:.1f} ms"
             if "run_wall_ms" in ph else ""))
    print(f"  {'phase':<12} {'wall_ms':>12}")
    for name in ("dispatch_ms", "memo_ms", "hook_ms"):
        print(f"  {name.removesuffix('_ms'):<12} {ph[name]:>12.2f}")
    print(f"  {'mode':<12} {'spans':>8} {'wall_ms':>12}")
    for mode in tracer.SPAN_MODES:
        if ph[f"{mode}_spans"]:
            print(f"  {mode:<12} {ph[f'{mode}_spans']:>8} "
                  f"{ph[f'{mode}_ms']:>12.2f}")
    if ph["growth_events"]:
        print(f"  capacity events: {ph['growth_events']}")
        for ev in rep["growth"]:
            print(f"    {json.dumps(ev, sort_keys=True)}")
    if rep.get("resumes"):
        print(f"  resumes: {len(rep['resumes'])} (ledger stitched "
              f"across invocations)")
        for seam in rep["resumes"]:
            print(f"    resumed at r={seam['r']} from "
                  f"{seam['checkpoint']}")
    for kind in sorted(rep["annotations"]):
        print(f"  annotations[{kind}]: {rep['annotations'][kind]}")
    if "memo" in rep:
        stats = {k: v for k, v in rep["memo"].items()
                 if k != "entry_sizes"}
        print(f"  memo: {json.dumps(stats, sort_keys=True)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="shadowscope run-ledger report / Chrome-trace "
                    "export")
    ap.add_argument("ledger", help="run-ledger JSONL path")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    ap.add_argument("--memo-view", action="store_true",
                    help="print the folded memo report (the "
                         "--memo-report view) and exit")
    ap.add_argument("--chrome", metavar="OUT",
                    help="write the merged wall/virtual Chrome trace")
    ap.add_argument("--heartbeats", metavar="JSONL",
                    help="heartbeat stream to merge as the "
                         "virtual-time simulation rows")
    ap.add_argument("--hops", metavar="JSONL",
                    help="flight-recorder hops to merge as flow events")
    ap.add_argument("--trace-max-hosts", type=int, default=256)
    ap.add_argument("--trace-max-flows", type=int, default=512)
    args = ap.parse_args(argv)

    records = tracer.load_ledger(args.ledger)

    if args.memo_view:
        memo = tracer.memo_view(records)
        if memo is None:
            print("trace_report: ledger has no memo record (run was "
                  "not memoized)", file=sys.stderr)
            return 2
        print(json.dumps(memo, indent=2, sort_keys=True))
        return 0

    if args.chrome:
        heartbeats = None
        if args.heartbeats:
            with open(args.heartbeats) as fh:
                heartbeats = export.read_heartbeats(fh)
        hops = _read_jsonl(args.hops) if args.hops else None
        info = tracer.write_chrome_trace(
            records, args.chrome, heartbeats=heartbeats, hops=hops,
            max_hosts=args.trace_max_hosts,
            max_flows=args.trace_max_flows)
        print(json.dumps(info, sort_keys=True))
        return 0

    rep = summarize(records)
    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    else:
        print_summary(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run the scenario corpus through the port and check it against the
golden digests: the corpus mode of `tools/run_scenarios.py`.

    python -m shadow_tpu_torch.workloads.run_scenarios [paths ...]
        [--config SIM_YAML] [--check] [-o out.json] [--slo-report slo.json]
        [--faults] [--guards] [--sample-every K] [--trace-ring R]
        [--telemetry DIR] [--memo] [--memo-report PATH]
        [--memo-cache DIR] [--trace DIR] [--trace-report PATH]
        [--checkpoint-dir DIR] [--checkpoint-every K] [--resume]
        [--kill-at R] [--shard N] [--update-golden --golden PATH]
        [--device cuda|cpu]

With no paths it runs every `scenarios/*.yaml` of the checkout. `--check`
compares each record's fingerprint, program digest and canonical digest
with `scenarios/GOLDEN.json` (or `--golden PATH`) and exits 1 on a
mismatch; with no paths a golden entry that did not run is a mismatch
too. `--update-golden` writes this run's golden entries to `--golden
PATH` in the JAX tool's format; it refuses (exit 2) to write
`scenarios/GOLDEN.json`, the reference's record, which the port never
rewrites. `--config SIM_YAML`
runs the scenario a simulation config's `workload:` block names instead
of paths (the path taken against the config's directory, `workload.seed`
overriding the scenario's seed), with the config's `flows:` knobs
(`emit_cap`, `recv_wnd`; `enabled` only warns when the scenario does not
run the flow transport) and its `memo:` block; a config the JAX parser
refuses (`core/config.ConfigError`, the same text), a block that names
no scenario, and `--config` with paths exit 2. `--slo-report` writes
the compute and SLO sections of the scenarios that have a `compute:`
block, stamped with the device the run used. `--faults` threads the
runner's default fault schedule, `--guards` the guard plane (each line
then says guards=clean or guards=DIRTY, and a dirty run exits 1), and
`--sample-every K` the flight recorder with a ring of `--trace-ring`
slots. A fault or guard run is another world than the golden corpus's,
so `--check` and `--update-golden` refuse them (exit 2).

The run infrastructure, with the JAX tool's meanings and file names:

- `--telemetry DIR`: heartbeat JSONL per scenario in `DIR/<name>.jsonl`
  (and the recorder's hops in `DIR/<name>.hops.jsonl`);
- `--memo`: memoized chain spans; the digests do not move, so `--check`
  still passes; `--memo-report PATH` writes each scenario's memo report
  with the device fingerprint; `--memo-cache DIR` loads
  `DIR/<name>.memo.npz` before a scenario and saves it after;
- `--trace DIR`: the run ledger `DIR/<name>.ledger.jsonl` and the
  two-clock Chrome trace `DIR/<name>.trace.json`; `--trace-report PATH`
  writes each scenario's wall-time phase totals with the fingerprint;
- `--checkpoint-dir DIR` (every `--checkpoint-every` windows, default
  16): full-run checkpoints; `--kill-at R` exits 137 once the round-R
  checkpoint is on disk (R a multiple of the cadence); `--resume`
  continues each scenario from its newest checkpoint. The output file of
  a killed and resumed run is byte-identical to the uninterrupted run's;
  where it restarted is written to the `<out>.provenance.json` sidecar
  (with `-o`) and the ledger.

`--shard N` runs each scenario host-axis sharded over N ranks
(`runner.run_scenario(mesh_devices=N)`, `tpu/mesh.py`; ranks 1..N-1
spawned, rank 0 this process); the digests do not move, so `--check`
passes as unsharded. The ranks talk over NCCL when each has a card of
its own, and over gloo on the CPU or when several share one card. As in
the JAX tool, `--shard` refuses flow and compute entries,
`--memo` and `--checkpoint-dir` (the runner's ValueError, exit 2).

The device defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CORPUS_DIR = Path(__file__).resolve().parents[2] / "scenarios"
GOLDEN = CORPUS_DIR / "GOLDEN.json"


def _refusal(args, memo: bool) -> str | None:
    """The flag combinations the JAX tool refuses (exit 2), as a line;
    `memo` is whether the run memoizes (`--memo` or the config's
    `memo.enabled`)."""
    if (args.faults or args.guards) and (args.check or args.update_golden):
        return ("--faults/--guards runs cannot be checked against or "
                "written as the golden corpus")
    if args.update_golden and \
            Path(args.golden).resolve() == GOLDEN.resolve():
        return (f"--update-golden will not rewrite {GOLDEN}, the "
                f"reference's record: pass --golden PATH")
    if args.memo_report and not memo:
        return "--memo-report needs --memo (or a config with memo.enabled)"
    if args.memo_cache and not memo:
        return "--memo-cache needs --memo (or a config with memo.enabled)"
    if args.trace_report and not args.trace:
        return "--trace-report needs --trace"
    if args.resume and not args.checkpoint_dir:
        return "--resume needs --checkpoint-dir"
    if args.checkpoint_every < 1:
        return "--checkpoint-every must be >= 1"
    if args.kill_at is not None:
        if not args.checkpoint_dir:
            return ("--kill-at needs --checkpoint-dir (the kill fires "
                    "after a durable checkpoint)")
        if args.kill_at % args.checkpoint_every != 0 \
                or args.kill_at < args.checkpoint_every:
            return (f"--kill-at {args.kill_at} is not a checkpoint "
                    f"instant (must be a positive multiple of "
                    f"--checkpoint-every {args.checkpoint_every})")
    return None


def _from_config(path: str):
    """The run a simulation config's blocks describe: (scenario path,
    seed override, flow emit cap, receive window, flows enabled, the
    `memo:` block), or the line to exit 2 with."""
    from ..core.config import ConfigError, load_config_file

    try:
        cfg = load_config_file(path)
    except ConfigError as e:
        return f"{path}: {e}"
    if cfg.workload.scenario in (None, "off"):
        return (f"{path}: the `workload:` block names no scenario "
                f"(workload.scenario is {cfg.workload.scenario!r})")
    scenario = cfg.workload.scenario
    if not os.path.isabs(scenario):
        scenario = os.path.join(os.path.dirname(os.path.abspath(path)),
                                scenario)
    return (scenario, cfg.workload.seed, cfg.flows.emit_cap,
            cfg.flows.recv_wnd, cfg.flows.enabled, cfg.memo)


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, sort_keys=True, indent=1)
        fh.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="*",
                    help="scenario YAMLs (default: scenarios/*.yaml)")
    ap.add_argument("--config", default=None, metavar="SIM_YAML",
                    help="run the scenario a simulation config's "
                         "`workload:` block names (with its seed override, "
                         "`flows:` knobs and `memo:` block) instead of "
                         "listing scenario files")
    ap.add_argument("--check", action="store_true",
                    help="compare with the golden digests (exit 1 on a "
                         "mismatch)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the records here as JSON")
    ap.add_argument("--slo-report", default=None, metavar="PATH",
                    help="write the compute and SLO sections of the "
                         "scenarios with a compute: block, with the "
                         "device fingerprint, as JSON")
    ap.add_argument("--faults", action="store_true",
                    help="thread the default fault schedule per scenario")
    ap.add_argument("--guards", action="store_true",
                    help="thread the guard plane; exit 1 when any "
                         "scenario reports a violation")
    ap.add_argument("--sample-every", type=int, default=None, metavar="K",
                    help="thread the flight recorder: tag ~1/K packets "
                         "and record their hops (seeded from the "
                         "scenario seed)")
    ap.add_argument("--trace-ring", type=int, default=4096,
                    help="flight-recorder ring capacity (default 4096; "
                         "overwritten events are counted)")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write heartbeat JSONL per scenario into DIR "
                         "(<name>.jsonl, and <name>.hops.jsonl with "
                         "--sample-every)")
    ap.add_argument("--memo", action="store_true",
                    help="memoize steady-state chain spans; the digests "
                         "do not move, so --check still passes")
    ap.add_argument("--memo-report", default=None, metavar="PATH",
                    help="write each scenario's memo report with the "
                         "device fingerprint as JSON")
    ap.add_argument("--memo-cache", default=None, metavar="DIR",
                    help="load DIR/<name>.memo.npz before each scenario "
                         "and save it after (needs --memo)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write the run ledger DIR/<name>.ledger.jsonl "
                         "and the Chrome trace DIR/<name>.trace.json")
    ap.add_argument("--trace-report", default=None, metavar="PATH",
                    help="write each scenario's wall-time phase totals "
                         "with the device fingerprint (needs --trace)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write full-run checkpoints into DIR")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    metavar="K",
                    help="checkpoint cadence in windows (default 16); the "
                         "killed run and its --resume must agree")
    ap.add_argument("--resume", action="store_true",
                    help="resume each scenario from its newest checkpoint "
                         "in --checkpoint-dir (a cold start when none)")
    ap.add_argument("--kill-at", type=int, default=None, metavar="R",
                    help="exit 137 once the round-R checkpoint is on disk "
                         "(R a multiple of --checkpoint-every)")
    ap.add_argument("--update-golden", action="store_true",
                    help="write this run's golden entries to --golden "
                         "(never scenarios/GOLDEN.json)")
    ap.add_argument("--golden", default=str(GOLDEN))
    ap.add_argument("--shard", type=int, default=None, metavar="N",
                    help="host-axis shard over N ranks (digest parity)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    seed_override = emit_cap = recv_wnd = memo_cfg = None
    flows_enabled = False
    if args.config is not None:
        if args.scenarios:
            ap.error("--config and positional scenarios are mutually "
                     "exclusive")
        run = _from_config(args.config)
        if isinstance(run, str):
            print(f"run_scenarios: {run}", file=sys.stderr)
            return 2
        (scenario, seed_override, emit_cap, recv_wnd, flows_enabled,
         memo_cfg) = run
    memo = args.memo or (memo_cfg is not None and memo_cfg.enabled)
    refused = _refusal(args, memo)
    if refused:
        print(f"run_scenarios: {refused}", file=sys.stderr)
        return 2
    memo_arg = None
    if memo:
        from ..core.config import MemoOptions

        memo_arg = memo_cfg if memo_cfg is not None else MemoOptions(
            enabled=True)
        if not memo_arg.enabled:  # the --memo flag turns the block on
            memo_arg = MemoOptions(enabled=True,
                                   max_bytes=memo_arg.max_bytes,
                                   min_repeat=memo_arg.min_repeat,
                                   chain_len=memo_arg.chain_len)

    from ..telemetry import export
    from ..telemetry import tracer as tracermod
    from ..telemetry.harvest import TelemetryHarvester
    from . import runner
    from .spec import load_scenario_file

    paths = ([scenario] if args.config is not None else args.scenarios
             or sorted(str(p) for p in CORPUS_DIR.glob("*.yaml")))
    backend = tracermod.backend_fingerprint(args.device)
    for d in (args.telemetry, args.trace, args.memo_cache):
        if d:
            os.makedirs(d, exist_ok=True)
    records = []
    memo_reports = {}
    trace_summaries = {}
    provenance_all = {}
    guards_dirty = False
    for path in paths:
        spec = load_scenario_file(path, seed=seed_override)
        if args.shard is not None:
            try:
                runner.check_mesh_run(spec, args.shard, memo=memo_arg,
                                      checkpoint_dir=args.checkpoint_dir)
            except ValueError as e:  # the JAX runner's refusals
                print(f"run_scenarios: {spec.name}: {e}", file=sys.stderr)
                return 2
        if flows_enabled and spec.transport != "flows":
            print(f"run_scenarios: flows.enabled is set but scenario "
                  f"{spec.name!r} declares transport: {spec.transport}; "
                  f"the flow plane runs only for `transport: flows` "
                  f"scenarios, so this run stays on the direct transport",
                  file=sys.stderr)
        harvester = hops_sink = None
        if args.telemetry:
            harvester = TelemetryHarvester(
                interval_ns=spec.window_ns,
                sink=os.path.join(args.telemetry, f"{spec.name}.jsonl"))
            if args.sample_every:
                hops_sink = os.path.join(args.telemetry,
                                         f"{spec.name}.hops.jsonl")
        tracer = ledger_path = None
        if args.trace:
            ledger_path = os.path.join(args.trace,
                                       f"{spec.name}.ledger.jsonl")
            # under checkpointing the ledger streams (each record flushed
            # and fsynced), so a kill keeps it; a resume appends to it
            tracer = tracermod.RunTracer(
                spec.name, backend=backend,
                meta={"family": spec.family, "hosts": spec.n_hosts,
                      "windows": spec.windows, "memo": memo,
                      "faults": bool(args.faults)},
                sink=ledger_path if args.checkpoint_dir else None,
                resume=bool(args.resume and args.checkpoint_dir
                            and os.path.isfile(ledger_path)))
        timings = {}
        prov = {}
        rec = runner.run_scenario(
            spec, device=args.device, timings=timings,
            use_default_faults=args.faults, guards=args.guards,
            telemetry=harvester, sample_every=args.sample_every,
            trace_ring=args.trace_ring, hops_sink=hops_sink,
            flow_emit_cap=emit_cap, flow_recv_wnd=recv_wnd,
            memo=memo_arg, tracer=tracer,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            kill_at=args.kill_at,
            memo_cache=(os.path.join(args.memo_cache,
                                     f"{spec.name}.memo.npz")
                        if args.memo_cache else None),
            provenance=prov, mesh_devices=args.shard)
        if args.checkpoint_dir:
            provenance_all[spec.name] = prov
        if harvester is not None:
            harvester.finalize()
        if tracer is not None:
            tracer.close()
            tracer.write(ledger_path)
            heartbeats = None
            if args.telemetry:
                with open(harvester.sink_path) as fh:
                    heartbeats = export.read_heartbeats(fh)
            # a resumed tracer holds only its own segment; the streamed
            # file holds the whole ledger
            ledger = (tracermod.load_ledger(ledger_path)
                      if tracer.sink_path is not None else tracer.records)
            tracermod.write_chrome_trace(
                ledger, os.path.join(args.trace, f"{spec.name}.trace.json"),
                heartbeats=heartbeats)
            trace_summaries[spec.name] = tracermod.phase_totals(ledger)
        records.append(rec)
        status = ("done" if rec["all_done"]
                  else f"{rec['completed_hosts']}/{rec['participants']}")
        g = rec.get("guards")
        gtxt = ""
        if g is not None:
            gtxt = " guards=clean" if g["clean"] else " guards=DIRTY"
            guards_dirty |= not g["clean"]
        ftxt = (f" fault_drops={rec['drops']['fault']}"
                if rec["faults_active"] else "")
        htxt = (f" hops={rec['flight_recorder']['recorded_hops']}"
                if "flight_recorder" in rec else "")
        mtxt = ""
        if "memo" in rec:
            memo_reports[spec.name] = rec["memo"]
            mtxt = (f" memo={rec['memo']['hits']}h/"
                    f"{rec['memo']['misses']}m/"
                    f"{rec['memo']['fast_forwarded_windows']}ffwd")
        ran = spec.windows - prov.get("start_round", 0)
        stxt = f" x {args.shard} ranks" if args.shard else ""
        print(f"{spec.name:<24} [{rec['family']}] {status:>8}  "
              f"events={rec['events']:<8} "
              f"digest={rec['canonical_digest'][:12]}{gtxt}{ftxt}{htxt}"
              f"{mtxt}  {ran / timings['drive_s']:.1f} windows/s on "
              f"{args.device}{stxt}", file=sys.stderr)
    if args.out:
        _write_json(args.out, {"records": records})
        if provenance_all:
            # where a run restarted rides a sidecar, never the record
            # file, which equals the uninterrupted run's byte for byte
            _write_json(args.out + ".provenance.json", {
                "schema": "runprov-v1",
                "checkpoint_dir": args.checkpoint_dir,
                "checkpoint_every": args.checkpoint_every,
                "scenarios": provenance_all})
    if args.slo_report:
        slo = {rec["name"]: {"compute": rec["compute"], "slo": rec["slo"]}
               for rec in records if "slo" in rec}
        _write_json(args.slo_report, {
            "backend": backend, "scenarios": slo})
        print(f"run_scenarios: slo report -> {args.slo_report} "
              f"({len(slo)} scenario(s) with a compute plane)",
              file=sys.stderr)
    if args.memo_report:
        _write_json(args.memo_report, {"backend": backend,
                                       "scenarios": memo_reports})
    if args.trace_report:
        _write_json(args.trace_report, {
            "backend": backend, "schema": tracermod.RUNLEDGER_SCHEMA,
            "scenarios": trace_summaries})
    if args.update_golden:
        _write_json(args.golden, {rec["name"]: runner.golden_entry(rec)
                                  for rec in records})
        print(f"run_scenarios: golden corpus written: {args.golden}",
              file=sys.stderr)
    if args.check:
        golden = runner.load_golden(args.golden)
        if args.scenarios:
            ran = {rec["name"] for rec in records}
            golden = {k: v for k, v in golden.items() if k in ran}
        problems = runner.check_against_golden(records, golden)
        for line in problems:
            print(f"run_scenarios: {line}", file=sys.stderr)
        if problems:
            return 1
        print(f"run_scenarios: {len(records)} scenario(s) match the golden "
              "digests", file=sys.stderr)
    if guards_dirty:
        print("run_scenarios: guard violations reported", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

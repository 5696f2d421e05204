"""Run the scenario corpus through the port and check it against the
golden digests: the corpus mode of `tools/run_scenarios.py`.

    python -m shadow_tpu_torch.workloads.run_scenarios [paths ...]
        [--check] [-o out.json] [--slo-report slo.json]
        [--faults] [--guards] [--sample-every K] [--trace-ring R]
        [--device cuda|cpu]

With no paths it runs every `scenarios/*.yaml` of the checkout. `--check`
compares each record's fingerprint, program digest and canonical digest
with `scenarios/GOLDEN.json` and exits 1 on a mismatch; with no paths a
golden entry that did not run is a mismatch too. `--slo-report` writes
the compute and SLO sections of the scenarios that have a `compute:`
block, stamped with the device the run used. `--faults` threads the
runner's default fault schedule, `--guards` the guard plane (each line
then says guards=clean or guards=DIRTY, and a dirty run exits 1), and
`--sample-every K` the flight recorder with a ring of `--trace-ring`
slots. A fault or guard run is another world than the golden corpus's,
so `--check` refuses them (exit 2). The device defaults to the CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

CORPUS_DIR = Path(__file__).resolve().parents[2] / "scenarios"
GOLDEN = CORPUS_DIR / "GOLDEN.json"


def device_fingerprint(device: str) -> dict:
    """The identity a run's numbers are comparable within: the device's
    platform and kind, and the PyTorch and CUDA versions."""
    dev = torch.device(device)
    gpu = dev.type == "cuda"
    return {"platform": "gpu" if gpu else dev.type,
            "device_kind": (torch.cuda.get_device_name(dev) if gpu
                            else dev.type),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="*",
                    help="scenario YAMLs (default: scenarios/*.yaml)")
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
    ap.add_argument("--golden", default=str(GOLDEN))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if (args.faults or args.guards) and args.check:
        print("run_scenarios: --faults/--guards runs cannot be checked "
              "against the golden corpus", file=sys.stderr)
        return 2

    from . import runner
    from .spec import load_scenario_file

    paths = args.scenarios or sorted(str(p) for p in CORPUS_DIR.glob("*.yaml"))
    records = []
    guards_dirty = False
    for path in paths:
        spec = load_scenario_file(path)
        timings = {}
        rec = runner.run_scenario(
            spec, device=args.device, timings=timings,
            use_default_faults=args.faults, guards=args.guards,
            sample_every=args.sample_every, trace_ring=args.trace_ring)
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
        print(f"{spec.name:<24} [{rec['family']}] {status:>8}  "
              f"events={rec['events']:<8} "
              f"digest={rec['canonical_digest'][:12]}{gtxt}{ftxt}{htxt}  "
              f"{spec.windows / timings['drive_s']:.1f} windows/s on "
              f"{args.device}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"records": records}, fh, sort_keys=True, indent=1)
            fh.write("\n")
    if args.slo_report:
        slo = {rec["name"]: {"compute": rec["compute"], "slo": rec["slo"]}
               for rec in records if "slo" in rec}
        with open(args.slo_report, "w") as fh:
            json.dump({"backend": device_fingerprint(args.device),
                       "scenarios": slo}, fh, sort_keys=True, indent=1)
            fh.write("\n")
        print(f"run_scenarios: slo report -> {args.slo_report} "
              f"({len(slo)} scenario(s) with a compute plane)",
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

"""Kernels A and C at the widths past 16384 on the card, one tree's
package beside another's, in turns.

Each `--tree NAME=DIR` (a checkout of the repository, its own
`shadow_tpu_torch` package) runs in a child process of its own, which
builds that tree's kernels and then serves the turns this process hands
it, one at a time, so no two trees share the card at once:

- at each `--ces` width, kernels A and C through `chip_smoke.time_egress`
  (the `chip_smoke.py` beside this script: one launch a call of the build the
  tree's launcher picks, bitwise against its plain version on
  `chip_smoke.WIDE_SLOTS` slots of random columns and on the int32 edge
  rows, then timed cold, clean and warm beside its byte bound and the
  plain version's time);
- with `--phold`, 22 (d)'s `PHOLD_CLUSTER` world through "pallas_fused"
  and "pallas" (`chip_smoke.phold_width_run`: the state equal to the
  "xla" run's, each launch of A's and C's build its µs on the card in the
  window by torch.profiler's kernel events, beside its byte bound).

The turns run through the trees forward, then backward, `--turns` times
(2: A B B A). Every row is
printed as a JSON line with its tree, turn and the card's name and power
limit, and all of them are written to `--json`.

Usage: python3 egress_probe.py --tree NAME=DIR ... [--ces CE ...]
           [--phold] [--turns N] [--json OUT]
(on the card, from the repository's root; it refuses without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the child: its tree's package first on the path, the chip_smoke.py
# beside this script by path; one JSON command a line in, one JSON row out
CHILD = r"""
import importlib.util, json, sys
tree, chip_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", chip_path)
chip = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip)
import torch
from shadow_tpu_torch import _build, bench, convert
from shadow_tpu_torch.tpu import pipeline
_build.build(["egress_rank", "egress_gate", "route_place", "route_scatter"])
ident = chip.gpu_identity()
print(json.dumps({"ready": ident}), flush=True)
for line in sys.stdin:
    cmd = json.loads(line)
    if cmd["op"] == "width":
        row = chip.time_egress(torch, pipeline, cmd["which"], cmd["ce"],
                               chip.WIDE_SLOTS[cmd["which"]] // cmd["ce"],
                               ident)
    else:
        size = chip.PHOLD_CLUSTER
        want = chip.phold_width_digest(bench, convert, size)
        row = {kernel: chip.phold_width_run(torch, bench, convert, pipeline,
                                            size, kernel, want, ident)
               for kernel in ("pallas_fused", "pallas")}
    torch.cuda.empty_cache()
    print(json.dumps({"row": row}, default=str), flush=True)
"""


class Child:
    """A tree's child process: its kernels built, serving turns."""

    def __init__(self, name: str, tree: Path):
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(tree), str(ROOT /
                                                          "chip_smoke.py")],
            cwd=tree, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})

    def read(self) -> dict:
        """The child's next JSON line (its own prints pass through)."""
        for line in self.proc.stdout:
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    pass
            print(f"[{self.name}] {line.rstrip()}", flush=True)
        raise RuntimeError(f"tree {self.name}: the child ended "
                           f"(exit {self.proc.wait()})")

    def ask(self, cmd: dict) -> dict:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self.read()["row"]

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--ces", type=int, nargs="*", default=[32768, 65536])
    ap.add_argument("--phold", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: egress_probe times kernels on "
                           "the card")
    trees = {}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    if not trees:
        ap.error("name at least one --tree")
    children = {name: Child(name, path) for name, path in trees.items()}
    try:
        ident = None
        for child in children.values():
            ident = child.read()["ready"]
        print(f"gpu: {ident}", flush=True)
        order = list(children)
        turns = [order if t % 2 == 0 else order[::-1]
                 for t in range(args.turns)]
        jobs = [dict(op="width", which=w, ce=ce)
                for ce in args.ces for w in ("A", "C")]
        if args.phold:
            jobs.append(dict(op="phold"))
        rows = []
        for job in jobs:
            for turn, names in enumerate(turns):
                for name in names:
                    row = dict(tree=name, turn=turn, gpu=ident, **job,
                               result=children[name].ask(job))
                    rows.append(row)
                    print(json.dumps(row, default=str), flush=True)
    finally:
        for child in children.values():
            child.close()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel F (`csrc/flow_window.cu`) on the card, beside other builds of
itself.

Builds each `--source` as it is (all at once) and prints ptxas'
registers, stack frame and spills of each build. Then times every build
in turns (forward, then backward) at three chunks: bench_flows' first
25-window chunk (975 flows, Q=128), phase 20 (a)'s 60-window chunk of
64 flows (Q=16) and rung 3's 20 ms bucket at its first chunk with work
(2048 lanes, Q=256): warm, cold and cold clean, CUDA events around
`floweng.flow_window_`'s launch path (`time_launch`, which
`chip_smoke.py` phase 20 uses too). Every build is held bitwise to the
first one at each chunk (every world leaf and `steps_per_window`).

`--bench-queue-slots Q ...` adds bench_flows' first chunk with rings
of each Q slots. `--in-run` times bench_flows' whole run with each build (CUDA events
around each launch, in turns). `--events` counts each pair's events on
the plain version (`run_windows_plain(counts=)`) at the bench and
rung-3 chunks: the pair's scheduled events, pulls and app phases, the
serial work its threads must run; the longest pair sets the launch's
time.

Usage: python -m shadow_tpu_torch.tools.kernel_f_probe
           [--source NAME=PATH ...] [--bench-queue-slots Q ...]
           [--in-run] [--events] [--reps N] [--json OUT]
(on the card; the first source is the reference, by default the
package's own `csrc/flow_window.cu`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
BENCH_CHUNK = 25  # bench_flows' windows a launch
A_WINDOWS, A_WINDOW_US = 60, 2000  # phase 20 (a)'s chunk
SPIN_CYCLES = 2_000_000  # ~1 ms of spin before each timed launch


def build_all(sources: dict[str, tuple[str, Path]], out_dir: Path):
    """nvcc every (text, include dir) at once, with ptxas' report.
    Returns {name: (library path, ptxas lines of the kernel)}."""
    from .. import _build

    procs = {}
    for name, (text, inc) in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(inc), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if re.search(r"registers|stack frame|spill", ln)])
    return out


def load(lib: Path):
    from .. import _build

    fn_name, argtypes = _build.SIGNATURES["flow_window"]
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def launch(fn, world, n_windows, window_us, cap=512):
    """`floweng.flow_window_` (its defaults but the step cap) through
    the C entry point `fn` of any build. Returns steps_per_window."""
    from ..tpu import floweng

    return floweng._flow_window(world, n_windows, window_us,
                                max_events_per_window=cap, entry=fn)


def leaves(world):
    return list(world.plane) + list(world[1:])


def time_launch(torch, launch_, world, reps=20) -> dict:
    """Warm, cold and clean device ms of `launch_(w)`, one launch of
    kernel F in place on `w`, a copy of `world`: CUDA events around the
    call. Before each launch the copy is restored (F writes in place);
    cold then writes a 128 MiB buffer, which evicts the world from L2
    and leaves it full of dirty lines, clean reads that buffer too; warm
    launches on the restored world, in L2. A spin queued before the
    first event keeps the card busy while the host runs the wrapper's
    checks and enqueues its work, so no host time shows; the wrapper's
    own small device ops (the step and saturation counts' zeroing and
    sums, the clock) are inside the events."""
    from ..tpu import floweng

    work = floweng.clone_world(world)
    pairs = list(zip(leaves(work), leaves(world)))
    dev = world.conn_t.device
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    out = {}
    for mode in ("warm", "cold", "clean"):
        marks = []
        for _ in range(reps):
            for d, s_ in pairs:
                d.copy_(s_)
            if mode != "warm":
                flush.fill_(0)
            if mode == "clean":
                flush.sum()
            torch.cuda._sleep(SPIN_CYCLES)
            e0, e1 = ev(), ev()
            e0.record()
            launch_(work)
            e1.record()
            marks.append((e0, e1))
        torch.cuda.synchronize()
        out[mode] = sum(a.elapsed_time(b) for a, b in marks) / reps
    return out


def world_a(floweng, device, n_flows=64, queue_slots=16):
    """`chip_smoke.py` phase 20 (a)'s world: one-way latencies of 2-40 ms
    each way, 2 %/1 % loss, staggered starts, odd flows fetching (their
    passive side writes)."""
    rng = np.random.default_rng(5)
    lat = rng.integers(2, 40, n_flows) * 1000
    lat_back = rng.integers(2, 40, n_flows) * 1000
    size = rng.integers(20, 200, n_flows) * 1000
    start = rng.integers(0, 30, n_flows) * 1000
    w = floweng.make_flow_world(lat, size, start_us=start,
                                queue_slots=queue_slots, seed=3, loss=0.02,
                                loss_back=0.01, latency_back_us=lat_back,
                                device=device)
    total = w.total.clone()
    total[2::4], total[3::4] = w.total[3::4], w.total[2::4]
    return w._replace(total=total)


def rung3_bucket(device) -> dict:
    """Rung 3's largest latency bucket: its world on the first attempt's
    rings (`world`), window us, windows a chunk, its flows and the first
    chunk with work (`busy`)."""
    from ..core import flowplan
    from ..core.config import load_config_str

    cfg = load_config_str(flowplan.RUNG3_YAML.read_text())
    plan = flowplan.compile_flow_plan(cfg, flowplan.routing_from_config(cfg))
    wus, idx = max(flowplan.flow_buckets(plan).items(),
                   key=lambda kv: len(kv[1]))
    chunk = flowplan.bucket_chunk(wus)
    return dict(world=flowplan.bucket_world(plan, wus, idx,
                                            flowplan.QUEUE_SLOTS0, device),
                window_us=wus, chunk=chunk, flows=len(idx),
                busy=int(plan.start_us[idx].min()) // (chunk * wus))


def shapes(fn, device, bench_qs=()) -> dict:
    """{label: (world at the chunk's start, windows, window us)}. Rung
    3's world is advanced to its first chunk with work by `fn`; each Q of
    `bench_qs` adds bench_flows' first chunk with rings of Q slots
    ("bench_q<Q>")."""
    from ..tpu import floweng
    from . import bench_flows

    lats, sizes, qs, wus = bench_flows.default_world_args()
    out = {"bench": (floweng.make_flow_world(lats, sizes, queue_slots=qs,
                                             device=device),
                     BENCH_CHUNK, wus),
           "a": (world_a(floweng, device), A_WINDOWS, A_WINDOW_US)}
    r = rung3_bucket(device)
    w = floweng.clone_world(r["world"])
    for _ in range(r["busy"]):
        launch(fn, w, r["chunk"], r["window_us"])
    out["rung3"] = (w, r["chunk"], r["window_us"])
    for q in bench_qs:
        out[f"bench_q{q}"] = (floweng.make_flow_world(
            lats, sizes, queue_slots=q, device=device), BENCH_CHUNK, wus)
    return out


def pair_events(floweng, world, n_windows, window_us, **opts):
    """`run_windows_plain` from `world`, counting each pair's events
    (`counts=`): its lanes' scheduled events, pulls and app phases (one
    a lane a fused step in which the pair has work). Returns the plain
    version's (world, steps) and the counts as numpy [F] arrays."""
    cnt = {}
    w, steps = floweng.run_windows_plain(world, n_windows, window_us,
                                         counts=cnt, **opts)
    lane = {k: v.cpu().numpy() for k, v in cnt.items()}
    lane_events = lane["sched"] + lane["pulls"] + lane["steps"]
    pair = lane_events.reshape(-1, 2)
    return w, steps, dict(pair_events=pair.sum(1), lane_events=pair,
                          sched=lane["sched"].reshape(-1, 2).sum(1),
                          pulls=lane["pulls"].reshape(-1, 2).sum(1),
                          steps=lane["steps"][0::2])


def longest_pair(ev: dict) -> dict:
    """The pair with the most events: its index, events (scheduled,
    pulls, app phases), its busier lane's events and its fused steps."""
    p = int(np.argmax(ev["pair_events"]))
    return dict(pair=p, events=int(ev["pair_events"][p]),
                sched=int(ev["sched"][p]), pulls=int(ev["pulls"][p]),
                app=2 * int(ev["steps"][p]),
                busier_lane=int(ev["lane_events"][p].max()),
                mean_pair_events=float(ev["pair_events"].mean()))


def bench_in_run(torch, fn, world, wus) -> list[float]:
    """bench_flows' run to completion with `fn`, device ms a launch (a
    spin queued before each launch's first event keeps the card busy
    while the host enqueues it, as `chip_smoke` phase 20 (b) times)."""
    from ..tpu import floweng

    marks = []

    def chunk(w, cap):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        w2 = floweng.clone_world(w)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        st = launch(fn, w2, BENCH_CHUNK, wus, cap)
        e1.record()
        marks.append((e0, e1))
        return w2, st

    floweng.run_to_completion(world, wus, max_sim_s=40.0,
                              chunk_windows=BENCH_CHUNK, probe_every=2,
                              run_fn=chunk)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in marks]


def same(torch, a, sa, b, sb) -> bool:
    return torch.equal(sa, sb) and all(
        torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def main(argv=None):
    import torch

    from ..tpu import floweng

    here = Path(__file__).resolve().parent.parent / "csrc"
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of a flow_window.cu (repeatable)")
    ap.add_argument("--in-run", action="store_true")
    ap.add_argument("--events", action="store_true")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--bench-queue-slots", type=int, nargs="*", default=[],
                    help="also bench_flows' first chunk with rings of "
                         "each of these slot counts")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_f_probe: needs a CUDA card")
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"gpu: {ident}", flush=True)
    srcs = {}
    for s in args.source or [f"current={here / 'flow_window.cu'}"]:
        name, path = s.split("=", 1)
        path = Path(path).resolve()
        srcs[name] = (path.read_text(), path.parent)
    rec = {"gpu": ident, "builds": {}, "chunks": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(srcs, Path(tmp))
        fns = {k: load(lib) for k, (lib, _) in built.items()}
        for k, (_, ptxas) in built.items():
            rec["builds"][k] = ptxas
            print(f"ptxas {k}: {' | '.join(ptxas)}", flush=True)
        names = list(fns)
        dev = torch.device("cuda")
        chunks = shapes(fns[names[0]], dev, args.bench_queue_slots)
        for label, (w0, n_win, win) in chunks.items():
            outs = {}
            for k in names:
                w = floweng.clone_world(w0)
                outs[k] = (w, launch(fns[k], w, n_win, win))
            torch.cuda.synchronize()
            ref = outs[names[0]]
            bad = [k for k in names if not same(torch, *outs[k], *ref)]
            if bad:
                raise SystemExit(f"kernel_f_probe: {bad} differ from "
                                 f"{names[0]} at {label}")
            times = {k: [] for k in names}
            for rep in range(args.reps):
                for k in (names if rep % 2 == 0 else names[::-1]):
                    times[k].append(time_launch(
                        torch, lambda w, f=fns[k]: launch(f, w, n_win, win),
                        w0))
            rec["chunks"][label] = dict(
                lanes=int(w0.conn_t.shape[0]), Q=int(w0.q_time.shape[1]),
                windows=n_win, window_us=win,
                steps=int(ref[1].sum()), times=times)
            for k in names:
                t = times[k]
                print(f"{label} ({w0.conn_t.shape[0]} lanes, Q="
                      f"{w0.q_time.shape[1]}, {n_win} x {win} us) {k}: cold "
                      f"{[round(x['cold'], 5) for x in t]} clean "
                      f"{[round(x['clean'], 5) for x in t]} warm "
                      f"{[round(x['warm'], 5) for x in t]} ms; bitwise "
                      f"{names[0]}", flush=True)
        if args.in_run:
            w0, _, wus = chunks["bench"]
            runs = {k: [] for k in names}
            for rep in range(args.reps):
                for k in (names if rep % 2 == 0 else names[::-1]):
                    runs[k].append(bench_in_run(torch, fns[k], w0, wus))
            rec["in_run"] = runs
            for k in names:
                print(f"bench_flows in run {k}: " + "; ".join(
                    f"{len(r)} launches, sum {sum(r):.5f} ms "
                    f"({[round(x, 5) for x in r]})" for r in runs[k]),
                    flush=True)
    if args.events:
        rec["events"] = {}
        for label in ("bench", "rung3"):
            w0, n_win, win = chunks[label]
            t0 = time.perf_counter()
            top = longest_pair(pair_events(floweng, w0, n_win, win)[2])
            top["plain_s"] = time.perf_counter() - t0
            rec["events"][label] = top
            print(f"{label} events on the plain version: {top}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()

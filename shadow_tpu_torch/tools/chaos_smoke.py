"""Chaos smoke: a fault-injected PHOLD world that survives a kill.

The port of `tools/chaos_smoke.py`, run as

    python -m shadow_tpu_torch.tools.chaos_smoke --hosts 256 --windows 48 \
        --checkpoint-dir chaos/ --checkpoint-every 8        # full run
    python -m shadow_tpu_torch.tools.chaos_smoke ... --kill-at 20
    python -m shadow_tpu_torch.tools.chaos_smoke ... \
        --resume chaos/ckpt-000000000016                   # continues

It runs the PHOLD bench world (`tpu/profiling.build_world`) with an
active fault schedule (a host crash and reboot, a degraded link, a
corruption burst, an interface flap, a degraded host) threaded through
`window_step(kernel="xla", faults=)` window by window, in chains through
`tpu/elastic.drive_chained_windows`, checkpointing the plane every few
windows (`faults/checkpoint.save_plane_checkpoint`); `--kill-at W` exits
137 after window W, and `--resume DIR` restores a checkpoint and goes on.
Each invocation prints one JSON line (the final state digest, the drop
totals, the checkpoints written); a resumed run's digest equals the
uninterrupted run's.

`--kernel pallas` is refused (exit 2): the Pallas kernels fuse no fault
plane, and where the JAX tool demotes the run to the XLA path
(`KernelFallback`), the port runs no other kernel than the one asked for.

`--guards warn|abort` threads the guard plane (abort: a violation exits
5); `--tamper-at W` puts a phantom valid slot into one ingress ring
after window W, which the guards must catch. `--capacity elastic|strict`
(with `--egress-cap/--ingress-cap/--max-doublings`) runs the capacity
policy (strict: the first overflow exits 6). `--telemetry DIR` threads
the histograms and writes `heartbeats.jsonl` and `trace.json` every
`--harvest-every` windows; `--sample-every K` adds the flight recorder
(`hops.jsonl`, a ring of `--trace-ring` slots, grown on overwrite under
elastic). `--memo` threads the memo (the fault plane's safety smoke: the
keys fold the absolute round and the schedule's span fingerprint, so a
run never hits its own cache, and its digest must equal the plain
run's); its cache rides the checkpoints. `--trace PATH` writes the run
ledger. `--device cpu` runs on the CPU (default: the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

EXIT_GUARD = 5
EXIT_CAPACITY = 6
N_NODES = 64
SEED = 1234


def default_schedule(n_hosts: int, n_windows: int, window_ns: int):
    """The JAX tool's chaos scenario, scaled to the run: host h1 crashed
    for the middle quarter, a link degraded x4, the last host's egress
    corrupted at 30 %, h2's interface flapped, h0's bandwidth divided by
    8, compiled through the `faults:` path."""
    from ..core.config import FaultsOptions
    from ..faults.schedule import compile_schedule

    w = lambda k: f"{max(1, k) * window_ns}ns"
    q = max(2, n_windows // 4)
    events = [
        {"at": w(q), "kind": "host_crash", "host": "h1"},
        {"at": w(2 * q), "kind": "host_reboot", "host": "h1"},
        {"at": w(q // 2), "kind": "link_degrade", "src_node": 0,
         "dst_node": 1, "latency_mult": 4, "duration": w(2 * q)},
        {"at": w(q), "kind": "corrupt_burst", "host": f"h{n_hosts - 1}",
         "p": 0.3, "duration": w(q)},
        {"at": w(2 * q), "kind": "iface_down", "host": "h2"},
        {"at": w(2 * q + q // 2), "kind": "iface_up", "host": "h2"},
        {"at": w(q), "kind": "host_degrade", "host": "h0",
         "bandwidth_div": 8, "duration": w(q)},
    ]
    return compile_schedule(
        FaultsOptions(events=events),
        host_names=[f"h{i}" for i in range(n_hosts)],
        n_nodes=N_NODES, seed=SEED,
        stop_time_ns=(n_windows + 1) * window_ns)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=256)
    ap.add_argument("--windows", type=int, default=48)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--kill-at", type=int, default=None,
                    help="exit 137 (no clean-up) after this window")
    ap.add_argument("--resume", default=None,
                    help="checkpoint directory to restore and continue")
    ap.add_argument("--kernel", choices=["xla", "pallas"], default="xla")
    ap.add_argument("--no-faults", action="store_true",
                    help="neutral masks only")
    ap.add_argument("--guards", choices=["off", "warn", "abort"],
                    default="off",
                    help="thread the guard plane (abort: violations "
                         "exit 5)")
    ap.add_argument("--tamper-at", type=int, default=None,
                    help="corrupt the state after this window (a phantom "
                         "ring slot): the guards must catch it")
    ap.add_argument("--capacity", choices=["fixed", "strict", "elastic"],
                    default="fixed",
                    help="ring capacity policy: elastic grows and re-runs "
                         "overflowing chains; strict exits 6")
    ap.add_argument("--egress-cap", type=int, default=16)
    ap.add_argument("--ingress-cap", type=int, default=32)
    ap.add_argument("--max-doublings", type=int, default=4)
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write heartbeats.jsonl + trace.json (and "
                         "hops.jsonl with --sample-every) into DIR; "
                         "threads the histograms")
    ap.add_argument("--harvest-every", type=int, default=8,
                    help="windows between harvests (default 8)")
    ap.add_argument("--sample-every", type=int, default=None, metavar="K",
                    help="thread the flight recorder (needs --telemetry)")
    ap.add_argument("--trace-ring", type=int, default=2048,
                    help="flight-recorder ring capacity (default 2048)")
    ap.add_argument("--chain-len", type=int, default=8,
                    help="windows a chain (harvest, checkpoint, tamper and "
                         "kill instants cut chains too); runs compared "
                         "under --capacity elastic must agree (default 8)")
    ap.add_argument("--memo", action="store_true",
                    help="thread the memo; the digest must equal the "
                         "plain run's")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run ledger (JSONL) to PATH")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.kernel == "pallas":
        ap.exit(2, "chaos_smoke: --kernel pallas is refused: the Pallas "
                   "kernels fuse no fault plane, and the port never runs "
                   "another kernel in their place; use --kernel xla\n")
    if args.sample_every is not None and not args.telemetry:
        ap.error("--sample-every requires --telemetry DIR")
    if args.memo and args.capacity != "fixed":
        ap.error("--memo requires --capacity fixed: a memo hit skips the "
                 "chain whose overflow the capacity policy reads")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from .. import resolve_device
    from ..convert import (carry_to_host, digest_pytrees,
                           flightrec_from_numpy, flightrec_to_numpy)
    from ..faults.checkpoint import (load_plane_checkpoint,
                                     save_plane_checkpoint)
    from ..faults.plane import neutral_faults
    from ..guards.plane import GuardState, make_guards, summarize
    from ..telemetry import flightrec as frmod
    from ..telemetry.metrics import make_metrics
    from ..tpu import elastic, profiling
    from ..tpu.elastic import CapacityError
    from ..tpu.plane import ingest_rows, unpack_planes, window_step
    from ..tpu.prims import key_data
    from ..workloads.phold import respawn_batch

    device = resolve_device(args.device)
    N, R = args.hosts, args.windows
    tracer = None
    if args.trace:
        from ..telemetry.tracer import RunTracer, backend_fingerprint

        tracer = RunTracer(
            "chaos_smoke", backend=backend_fingerprint(device),
            meta={"hosts": N, "windows": R, "kernel": args.kernel,
                  "capacity": args.capacity, "chain_len": args.chain_len,
                  "faults": not args.no_faults, "memo": bool(args.memo)})
    world = profiling.build_world(N, warmup_windows=0,
                                  egress_cap=args.egress_cap,
                                  ingress_cap=args.ingress_cap,
                                  device=device)
    params, seed = world["params"], world["rng_root"]
    window_ns = int(world["window"])
    schedule = None if args.no_faults else default_schedule(N, R, window_ns)
    use_guards = args.guards != "off"
    policy = None
    if args.capacity != "fixed":
        policy = elastic.RingPolicy(
            mode=args.capacity, max_doublings=args.max_doublings,
            egress_cap=args.egress_cap, ingress_cap=args.ingress_cap,
            plane="chaos_smoke")

    def chain_fn(state, extras, r0, r1, faults_list):
        metrics, guards, hist, fr, spawn_seq = extras
        zeros = torch.zeros(N, dtype=torch.int32, device=device)
        eg_acc, in_acc = zeros, zeros
        for r, faults in zip(range(r0, r1), faults_list):
            ci = state.in_src.shape[1]
            dropped = state.n_overflow_dropped
            out = window_step(state, params, seed, 0 if r == 0
                              else window_ns, window_ns, rr_enabled=False,
                              kernel=args.kernel, faults=faults,
                              metrics=metrics, guards=guards, hist=hist,
                              flightrec=fr)
            (state, delivered, _next), metrics, guards, hist, fr = \
                unpack_planes(out, metrics=metrics, guards=guards,
                              hist=hist, flightrec=fr)
            # ingress-ring overflow: the routing stage's ring-full drops
            in_acc = in_acc + (state.n_overflow_dropped - dropped)
            dropped = state.n_overflow_dropped
            mask, dst, nbytes, seq, ctrl = respawn_batch(
                delivered, spawn_seq, r, N, ci)
            # dead and flapped hosts spawn nothing
            mask = mask & (faults.host_alive & faults.link_up)[:, None]
            out = ingest_rows(state, dst, nbytes, seq, seq, ctrl, mask,
                              metrics=metrics, guards=guards, hist=hist,
                              flightrec=fr)
            (state,), metrics, guards, hist, fr = unpack_planes(
                out, metrics=metrics, guards=guards, hist=hist,
                flightrec=fr, n_lead=1)
            # egress-ring overflow: the respawn append's ring-full drops
            eg_acc = eg_acc + (state.n_overflow_dropped - dropped)
            spawn_seq = spawn_seq + mask.sum(dim=1, dtype=torch.int32)
        return state, (metrics, guards, hist, fr, spawn_seq), eg_acc, in_acc

    start_w = 0
    state = world["state"]
    metrics = make_metrics(N, device=device)
    guards = make_guards(N, device=device) if use_guards else None
    hist = fr = harvester = recorder = None
    if args.telemetry:
        from ..telemetry.harvest import TelemetryHarvester
        from ..telemetry.histo import make_histograms

        os.makedirs(args.telemetry, exist_ok=True)
        hist = make_histograms(N, device=device)
        harvester = TelemetryHarvester(
            interval_ns=args.harvest_every * window_ns,
            sink=os.path.join(args.telemetry, "heartbeats.jsonl"))
        if args.sample_every:
            fr = frmod.make_flightrec(SEED, sample_every=args.sample_every,
                                      ring=args.trace_ring, device=device)
            recorder = frmod.FlightRecorder(
                window_ns=window_ns,
                sink=os.path.join(args.telemetry, "hops.jsonl"))
    spawn_seq = torch.full((N,), 10_000, dtype=torch.int32, device=device)
    memo_obj = memo_salt_fn = None
    if args.memo:
        from ..tpu.memo import ChainMemo

        # the static salt: what the chain closes over and the carry does
        # not show; the default key_extra folds the absolute round, since
        # respawn traffic is round-indexed
        memo_obj = ChainMemo(salt="|".join([
            "chaos-memo-v1", f"hosts={N}", f"kernel={args.kernel}",
            f"egcap={args.egress_cap}", f"incap={args.ingress_cap}",
            f"faults={int(schedule is not None)}",
        ]).encode())
        memo_salt_fn = lambda r0, r1: b"neutral"
    if schedule is not None and (memo_obj is not None or tracer is not None):
        def memo_salt_fn(r0, r1):
            # keep the schedule's position current across memo hits
            # (a no-op after a miss: per_round already moved it)
            schedule.advance(r0 * window_ns)
            return schedule.span_fingerprint(r0 * window_ns,
                                             r1 * window_ns).encode()
    if args.resume:
        restored = load_plane_checkpoint(
            args.resume, state_template=state,
            faults_template=neutral_faults(N, N_NODES, device=device),
            metrics_template=metrics, device=device)
        extra = restored["extra"]
        state = restored["state"]
        metrics = restored["metrics"]
        up = lambda a: torch.from_numpy(np.array(a)).to(device)
        spawn_seq = up(extra["spawn_seq"])
        if use_guards and "guards.violations" in extra:
            guards = GuardState(**{f: up(extra[f"guards.{f}"])
                                   for f in GuardState._fields})
        if hist is not None and "hist.hist_qdepth" in extra:
            hist = type(hist)(**{f: up(extra[f"hist.{f}"])
                                 for f in hist._fields})
        if fr is not None and "flightrec.cursor" in extra:
            fr = flightrec_from_numpy(
                {f: extra[f"flightrec.{f}"] for f in fr._fields}, device)
            recorder.seed_cursor(int(fr.cursor))
        start_w = int(restored["meta"]["window_index"])
        if policy is not None and "capacity" in restored["meta"]:
            policy.restore_meta(restored["meta"]["capacity"])
        got = digest_pytrees(state, spawn_seq)
        want = restored["meta"].get("state_digest")
        if want and got != want:
            raise SystemExit(
                f"chaos_smoke: restored state digest {got[:12]} != "
                f"checkpointed {want[:12]}: the restore is not faithful")
        if schedule is not None:
            schedule.advance(start_w * window_ns)
        if memo_obj is not None and "memo" in restored["meta"]:
            n = memo_obj.absorb(restored["meta"]["memo"], extra,
                                prefix="memo.", source=args.resume,
                                restore=True)
            print(f"chaos_smoke: absorbed {n} memoized span(s)",
                  file=sys.stderr)
        print(f"chaos_smoke: resumed at window {start_w} from "
              f"{args.resume}", file=sys.stderr)

    checkpoints = []
    neutral = neutral_faults(N, N_NODES, device=device)

    def per_round(r0, r1):
        # one FaultArrays a window, built on the host before the span
        if schedule is None:
            return [neutral] * (r1 - r0)
        out = []
        for r in range(r0, r1):
            schedule.advance((r + 1) * window_ns)
            out.append(schedule.device_arrays(device))
        return out

    def on_chain(r1, state, extras):
        metrics, guards, hist, fr, spawn_seq = extras
        replaced = False
        if args.tamper_at is not None and r1 == args.tamper_at:
            print(f"chaos_smoke: tampering with the device state at "
                  f"window {r1}", file=sys.stderr)
            iv = state.in_valid.clone()
            iv[1, iv.shape[1] - 1] = True
            state = state._replace(in_valid=iv)
            replaced = True
            if tracer is not None:
                tracer.annotate("tamper", r=int(r1))
        if harvester is not None and r1 % args.harvest_every == 0:
            if tracer is not None:
                tracer.annotate("harvest", r=int(r1),
                                time_ns=int(r1) * window_ns)
            harvester.tick(r1 * window_ns,
                           device={**metrics._asdict(), **hist._asdict()})
            if recorder is not None:
                recorder.tick(fr)
                if args.capacity == "elastic" and recorder.want_growth():
                    # an overwriting drain doubles the trace ring, bounded
                    # like every ring by --max-doublings
                    cur = fr.ev_kind.shape[0]
                    cap_max = args.trace_ring << args.max_doublings
                    if cur < cap_max:
                        fr = frmod.grow_ring(fr, min(cur * 2, cap_max))
                        recorder.note_grown()
                        replaced = True
                        print(f"chaos_smoke: trace ring grown to "
                              f"{fr.ev_kind.shape[0]}", file=sys.stderr)
        if args.checkpoint_dir and args.checkpoint_every \
                and r1 % args.checkpoint_every == 0 and r1 < R:
            path = os.path.join(args.checkpoint_dir, f"ckpt-{r1:012d}")
            extra = {"spawn_seq": spawn_seq}
            if use_guards:
                extra.update({f"guards.{f}": getattr(guards, f)
                              for f in GuardState._fields})
            if hist is not None:
                extra.update({f"hist.{f}": getattr(hist, f)
                              for f in hist._fields})
            if fr is not None:
                extra.update({f"flightrec.{f}": v
                              for f, v in flightrec_to_numpy(fr).items()})
            meta = {"window_index": r1, "hosts": N,
                    "state_digest": digest_pytrees(state, spawn_seq)}
            if hist is not None:
                meta["telemetry"] = {
                    "histograms": True,
                    "flight_recorder": (frmod.flightrec_meta(fr)
                                        if fr is not None else None)}
            if policy is not None:
                meta["capacity"] = policy.to_meta()
            if memo_obj is not None:
                memo_meta, memo_arrays = memo_obj.spill(prefix="memo.")
                meta["memo"] = memo_meta
                extra.update(memo_arrays)
            if schedule is not None:
                # the masks at the cut, from the schedule (a memo hit
                # skips per_round; after a miss this advance is a no-op)
                schedule.advance(r1 * window_ns)
                faults_now = schedule.device_arrays(device)
            else:
                faults_now = neutral
            save_plane_checkpoint(
                path, state=state, clock_ns=r1 * window_ns,
                rng_key_data=np.asarray(key_data(seed), np.uint32),
                faults=faults_now, metrics=metrics, extra_arrays=extra,
                meta=meta)
            checkpoints.append(path)
            if tracer is not None:
                tracer.annotate("checkpoint", r=int(r1), path=path)
        if args.kill_at is not None and r1 >= args.kill_at:
            if tracer is not None:
                tracer.annotate("kill", r=int(r1))
            print(f"chaos_smoke: simulating a crash at window {r1}",
                  file=sys.stderr)
            sys.stderr.flush()
            os._exit(137)  # abrupt: no clean-up, like a SIGKILL
        if replaced:
            return state, (metrics, guards, hist, fr, spawn_seq)
        return None

    boundaries = set()
    if harvester is not None:
        boundaries.update(range(args.harvest_every, R, args.harvest_every))
    if args.checkpoint_dir and args.checkpoint_every:
        boundaries.update(range(args.checkpoint_every, R,
                                args.checkpoint_every))
    if args.tamper_at is not None:
        boundaries.add(args.tamper_at)
    if args.kill_at is not None:
        boundaries.add(args.kill_at)
    try:
        state, extras = elastic.drive_chained_windows(
            state, (metrics, guards, hist, fr, spawn_seq), chain_fn,
            n_rounds=R, chain_len=args.chain_len, start_round=start_w,
            boundaries=boundaries, per_round=per_round, policy=policy,
            window_ns=window_ns, host_names=[f"h{i}" for i in range(N)],
            on_chain=on_chain, memo=memo_obj, memo_span_salt=memo_salt_fn,
            tracer=tracer)
    except CapacityError as e:
        print(f"chaos_smoke: capacity abort: {e}", file=sys.stderr)
        span = getattr(e, "chain_span", None)
        if tracer is not None:
            tracer.annotate("capacity-abort", error=str(e),
                            chain_span=list(span) if span else None)
            tracer.close()
            tracer.write(args.trace)
        print(json.dumps({
            "capacity_error": str(e), "mode": policy.mode,
            "window": span[0] if span else None,
            "chain_span": list(span) if span else None,
            "egress_cap": policy.egress_cap,
            "ingress_cap": policy.ingress_cap}))
        return EXIT_CAPACITY
    metrics, guards, hist, fr, spawn_seq = extras

    telemetry_out = None
    if harvester is not None:
        from ..telemetry import export
        from ..telemetry.histo import HIST_PREFIX, percentiles

        if R % args.harvest_every != 0:
            # the cadence did not harvest the final instant
            harvester.tick(R * window_ns,
                           device={**metrics._asdict(), **hist._asdict()})
            if recorder is not None:
                recorder.tick(fr)
        harvester.finalize()
        if recorder is not None:
            recorder.tick(fr)
            recorder.finalize()
        trace_info = export.write_perfetto_trace(
            harvester.heartbeats, os.path.join(args.telemetry, "trace.json"),
            hops=recorder.hops if recorder is not None else None)
        h = carry_to_host(hist)
        telemetry_out = {
            "dir": args.telemetry,
            "heartbeats": harvester.emitted,
            "trace": trace_info,
            "latency": {
                name[len(HIST_PREFIX):]: percentiles(
                    np.asarray(arr, np.int64).sum(axis=0))
                for name, arr in h._asdict().items()},
        }
        if recorder is not None:
            telemetry_out["flight_recorder"] = recorder.summary()
            telemetry_out["trace_ring"] = int(fr.ev_kind.shape[0])
    m = carry_to_host(metrics)._asdict()
    out = {
        "hosts": N,
        "windows": R,
        "resumed_from": args.resume,
        "kernel": args.kernel,
        "fell_back": False,
        "faults_active": schedule is not None,
        "state_digest": digest_pytrees(state, spawn_seq),
        # elastic-vs-pre-provisioned parity is on the canonical state:
        # dead lanes hold each run's own compaction garbage
        "canonical_digest": digest_pytrees(elastic.canonical_state(state),
                                           spawn_seq),
        "egress_cap": int(state.eg_dst.shape[1]),
        "ingress_cap": int(state.in_src.shape[1]),
        "drops": {
            "ring_full": int(m["drop_ring_full"].sum()),
            "qdisc": int(m["drop_qdisc"].sum()),
            "loss": int(m["drop_loss"].sum()),
            "fault": int(m["drop_fault"].sum()),
        },
        "events": int(m["events"]),
        "checkpoints": checkpoints,
    }
    if telemetry_out is not None:
        out["telemetry"] = telemetry_out
    if memo_obj is not None:
        out["memo"] = memo_obj.stats()
    if policy is not None:
        out["capacity"] = {
            "mode": policy.mode,
            "initial": {"egress_cap": args.egress_cap,
                        "ingress_cap": args.ingress_cap},
            "final": {"egress_cap": policy.egress_cap,
                      "ingress_cap": policy.ingress_cap},
            "growth_events": len(policy.trajectory.growth_events()),
            "events": list(policy.trajectory.events),
            # no compile cache: the port re-traces nothing
            "step_recompiles": None,
        }
    if use_guards:
        out["guards"] = summarize(guards)
    if tracer is not None:
        if memo_obj is not None:
            tracer.memo_close(memo_obj)
        if use_guards:
            tracer.annotate("guards", summary=out["guards"])
        tracer.close()
        tracer.write(args.trace)
        out["trace"] = args.trace
    if use_guards and not out["guards"]["clean"]:
        print("chaos_smoke: guard violations: "
              + json.dumps(out["guards"]["by_class"]), file=sys.stderr)
        if args.guards == "abort":
            print(json.dumps(out))
            return EXIT_GUARD
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The scenario-corpus runner.

Counterpart of `shadow_tpu/workloads/runner.py`: the deterministic
scenario world, the window loop of `window_step(kernel="xla")` with the
metrics and histogram planes threaded, `unpack_planes` and
`workload_step`, driven in chains by `tpu/elastic.drive_chained_windows`,
and the JAX runner's JSON record, field for field. A scenario with
`transport: flows` runs the flow plane (`tpu/flows.py`) in split form
around the generator each window: `flow_recv` credits acked in-order
segments, `workload_step` enqueues the next sends onto their flows,
`flow_emit` puts the cwnd-gated window, retransmits and delayed acks on
the wire. A `compute:` block threads the compute plane
(`tpu/compute.py`) through the step, meters the phase credits through
service completion (`gate_credits`) and re-arms each host's service cost
from its phase (`phase_service`). The record's `canonical_digest`
hashes the bytes the JAX runner's `digest_pytrees` hashes, flow and
compute state included, so it is the golden corpus's comparison key
here too (`scenarios/GOLDEN.json`).

The robustness planes compose as in the JAX runner: a fault schedule
(`fault_events`, or `default_fault_schedule` with
`use_default_faults=True`) advances on the host before each window and
keeps one `FaultArrays` on the device, refreshed only in a window where
an event fired; `guards=True` threads the guard plane and adds its
`summarize` to the record; `sample_every=K` threads the flight recorder,
drained every `telemetry_every` windows as the JAX runner drains it.

The run infrastructure rides the driver as in the JAX runner: the
telemetry harvester (`telemetry=`, heartbeats with `workload_phase`
annotations), the chain memo (`memo=`, `memo_cache=`, with the JAX
runner's salt and key policy), the run ledger (`tracer=`) and full-run
checkpoints (`checkpoint_dir=`, `checkpoint_every=`, `resume=`,
`kill_at=`, `provenance=`); a checkpoint either runner writes, the other
resumes.

`mesh_devices=N` runs the scenario host-axis sharded over N ranks
(`tpu/mesh.py`), as the JAX runner's `mesh_devices` does: inside a
process group of N ranks (under `torchrun`) each rank runs its shard;
otherwise the call spawns ranks 1..N-1 and is rank 0 itself. Every
rank builds the world, keeps its hosts' rows and steps them with
`window_step(mesh=)`; the record, from the gathered state, is the
unsharded run's (its canonical digest does not move). Flows, compute,
checkpoints and the memo are refused under a mesh, as in JAX.

The device is read back after the drive, and between chains by the
flight recorder's drains, the harvests, the memo's snapshots and the
checkpoints. The record carries no wall-clock time.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..convert import digest_pytrees
from ..core.config import FaultsOptions
from ..faults import runstate
from ..faults.checkpoint import CheckpointError
from ..faults.schedule import compile_schedule
from ..guards.plane import make_guards, summarize
from ..telemetry import flightrec as frmod
from ..telemetry import histo
from ..telemetry.metrics import make_metrics
from ..tpu import compute as computemod
from ..tpu import elastic
from ..tpu import flows as flowsmod
from ..tpu import memo as memomod
from ..tpu import mesh as meshmod
from ..tpu.plane import make_params, make_state, unpack_planes, window_step
from . import device as wdevice
from .compile import TrafficProgram, compile_program, program_digest
from .spec import ScenarioSpec, scenario_fingerprint

MS = 1_000_000


def build_scenario_world(spec: ScenarioSpec, *, device=None):
    """The scenario's net-plane world, the JAX runner's byte for byte:
    a host-pair latency table drawn from the scenario seed, the spec's
    uniform `loss_p`, 10 Gbit/s hosts, full token buckets. The N x N
    tables are drawn with numpy and copied to the device once. Returns
    (state, params)."""
    device = resolve_device(device)
    N = spec.n_hosts
    rng = np.random.default_rng([spec.seed, 0x57A7])
    lat = rng.integers(1 * MS, 5 * MS, size=(N, N), dtype=np.int32)
    lat = np.minimum(lat, lat.T)
    loss = np.full((N, N), spec.loss_p, np.float32)
    bw = np.full((N,), 10_000_000_000, np.int64)
    params = make_params(lat, loss, bw, device=device)
    state = make_state(N, egress_cap=spec.egress_cap,
                       ingress_cap=spec.ingress_cap,
                       initial_tokens=params.tb_cap, device=device)
    return state, params


def default_fault_schedule(spec: ScenarioSpec):
    """The JAX runner's small chaos schedule scaled to the scenario: the
    last host crashed for the middle quarter, a link between nodes 0 and
    1 degraded x4, the next-to-last host's egress corrupted at 30 %,
    compiled through the real `faults:` path."""
    w = lambda k: f"{max(1, k) * spec.window_ns}ns"
    q = max(2, spec.windows // 4)
    last = spec.n_hosts - 1
    events = [
        {"at": w(q), "kind": "host_crash", "host": f"h{last}"},
        {"at": w(2 * q), "kind": "host_reboot", "host": f"h{last}"},
        {"at": w(q // 2), "kind": "link_degrade", "src_node": 0,
         "dst_node": min(1, spec.n_hosts - 1), "latency_mult": 4,
         "duration": w(2 * q)},
        {"at": w(q), "kind": "corrupt_burst",
         "host": f"h{max(0, last - 1)}", "p": 0.3, "duration": w(q)},
    ]
    return compile_schedule(
        FaultsOptions(events=events),
        host_names=[f"h{i}" for i in range(spec.n_hosts)],
        n_nodes=spec.n_hosts, seed=spec.seed,
        stop_time_ns=(spec.windows + 1) * spec.window_ns)


def run_scenario(spec: ScenarioSpec, *, guards: bool = False,
                 fault_events=None, use_default_faults: bool = False,
                 telemetry=None, telemetry_every: int = 16,
                 histograms: bool = True,
                 sample_every: Optional[int] = None, trace_ring: int = 4096,
                 hops_sink=None, max_advance: Optional[int] = None,
                 flow_emit_cap: Optional[int] = None,
                 flow_recv_wnd: Optional[int] = None,
                 memo=None, tracer=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 16, resume: bool = False,
                 kill_at: Optional[int] = None,
                 memo_cache: Optional[str] = None,
                 provenance: Optional[dict] = None,
                 chain_len: Optional[int] = None, on_chain=None,
                 device=None, timings: Optional[dict] = None,
                 mesh_devices: Optional[int] = None, mesh=None) -> dict:
    """Execute one scenario for its full window budget and return the
    JAX runner's record (no wall-clock in it).

    `guards` threads the guard plane and records its summary as
    `guards`. `fault_events` (a `faults.schedule.FaultSchedule`) or
    `use_default_faults` (`default_fault_schedule`) threads the fault
    plane: window r runs under the masks the schedule holds after
    `advance((r + 1) * window_ns)`, as the JAX runner's per-round stack.
    `histograms` (default on) threads the log2 latency and depth
    histograms and records their fleet percentiles as `latency`.
    `sample_every=K` threads the flight recorder (keyed by the scenario
    seed, a ring of `trace_ring` slots), drained every `telemetry_every`
    windows and at the end into `hops_sink` (a path or a file object);
    its summary is the record's `flight_recorder`. `flow_emit_cap` and
    `flow_recv_wnd` set the flow plane's per-window emission cap and
    receive window (None: `flows.EMIT_CAP`, `flows.RECV_WND`; read only
    under `transport: flows`); `max_advance` the phases a host may leave
    a window (None: `device.MAX_ADVANCE`).

    `telemetry` (a `telemetry/harvest.TelemetryHarvester`) is ticked
    every `telemetry_every` windows with the metrics and histogram
    tensors, its heartbeats annotated with the phases completed since
    the last tick (`workload_phase`). `memo` (True, or a dict or object
    with `max_bytes`, `min_repeat`, `chain_len`) memoizes chain spans
    (`tpu/memo.py`) under the JAX runner's salt and key policy; the
    record gains the memo report as `memo`, and its digests do not move.
    `memo_cache` (a path) loads the memo's entries before the run when
    the file exists and saves them after. `tracer` (a
    `telemetry/tracer.RunTracer`) records the run ledger: a span a
    chain, `harvest` annotations, the memo report.

    `checkpoint_dir` and `checkpoint_every` write the whole carry, the
    fault schedule's position and the memo every K windows
    (`faults/runstate.py`); `kill_at=R` exits with code 137 once the
    round-R checkpoint is on disk; `resume=True` starts from the newest
    checkpoint of this scenario (a cold start when there is none). The
    record of a resumed run is byte-identical to the uninterrupted
    run's; `provenance` (a dict) receives `resumed_from`, `start_round`
    and `checkpoints_written`, and the tracer a `resume` annotation. A
    resumed harvester starts afresh, as in JAX: its file holds the
    heartbeats after the checkpoint, and announces every phase once
    (the killed run's last snapshot, which would have carried some,
    was never drained).

    The drive runs `chain_len` windows a chain (None: `telemetry_every`
    under the harvester or the recorder, the memo's chain length under
    the memo, else all of them in one; the harvest cadence cuts the
    chains too) and calls `on_chain(r1)` on the host after the chain
    that ends before window r1 (a profiler starts and stops there). A
    dict passed as `timings` receives the host seconds of the set-up
    (`setup_s`: world, program, upload, prime, resume) and of the drive
    (`drive_s`, ended by a device synchronise), outside the record.

    `mesh_devices=N` shards the run over N ranks (the module's
    docstring; NCCL when each rank has a card of its own, gloo on the
    CPU or with several ranks on one card). The harvester, the tracer,
    the hops sink, `on_chain` and `timings` are rank 0's. `mesh` is the
    rank's `tpu/mesh.Mesh` when the caller has made it."""
    if telemetry_every < 1:
        raise ValueError(
            f"telemetry_every must be >= 1, got {telemetry_every}")
    if mesh is not None and mesh_devices is None:
        mesh_devices = mesh.size
    if mesh_devices is not None:
        check_mesh_run(spec, mesh_devices, memo=memo,
                       checkpoint_dir=checkpoint_dir)
        if mesh is None:
            shared = dict(
                guards=guards, fault_events=fault_events,
                use_default_faults=use_default_faults,
                telemetry=_RankHarvest() if telemetry is not None else None,
                telemetry_every=telemetry_every, histograms=histograms,
                sample_every=sample_every, trace_ring=trace_ring,
                max_advance=max_advance, chain_len=chain_len,
                device=device, mesh_devices=mesh_devices)
            rank0 = dict(telemetry=telemetry, hops_sink=hops_sink,
                         tracer=tracer, on_chain=on_chain, timings=timings)
            if not meshmod.dist.is_initialized():
                return meshmod.run_ranks(
                    _scenario_rank, mesh_devices, spec, shared,
                    device=device, local=rank0)
            mesh = meshmod.make_mesh(mesh_devices, device=device)
        if mesh.rank != 0:
            # the harvests gather on every rank (a collective) and rank 0
            # keeps them; the rest is rank 0's alone
            if telemetry is not None:
                telemetry = _RankHarvest()
            hops_sink = tracer = on_chain = timings = None
    device = resolve_device(device) if mesh is None else mesh.device
    t0 = time.perf_counter()
    prog = compile_program(spec)
    state, params = build_scenario_world(spec, device=device)
    wl = wdevice.to_device(prog, device)
    ws = wdevice.make_workload_state(prog, device)
    N = spec.n_hosts
    adv = max_advance if max_advance is not None else wdevice.MAX_ADVANCE
    use_flows = spec.transport == "flows"
    ftab = flowst = None
    emit_cap = recv_wnd = 0
    if use_flows:
        emit_cap = (flow_emit_cap if flow_emit_cap is not None
                    else flowsmod.EMIT_CAP)
        recv_wnd = (flow_recv_wnd if flow_recv_wnd is not None
                    else flowsmod.RECV_WND)
        if emit_cap < 1 or recv_wnd < 1 or emit_cap > recv_wnd:
            raise ValueError(
                f"flow knobs out of range: emit_cap={emit_cap} must be "
                f">= 1 and <= recv_wnd={recv_wnd}")
        ftab = flowsmod.make_flow_tables(prog.flow_src, prog.flow_dst,
                                         prog.flow_bytes, prog.lane_flow,
                                         device=device)
        flowst = flowsmod.make_flow_state(prog.flow_src.shape[0],
                                          recv_wnd=recv_wnd, device=device)
    use_compute = spec.compute is not None
    ctab = cstate = None
    if use_compute:
        ctab = computemod.make_compute_tables(
            prog.compute_service_ns, spec.compute.queue_cap, device=device)
        cstate = computemod.make_compute_state(ctab)
    metrics = make_metrics(N, device=device)
    gstate = make_guards(N, device=device) if guards else None
    hstate = histo.make_histograms(N, device=device) if histograms else None
    if mesh is not None:
        # every host-major leaf keeps the rank's rows, as the JAX runner's
        # `_shard_host_axis`; the recorder's ring and the fault masks stay
        # whole on every rank, as there
        state, params = meshmod.shard_state(state, params, mesh)
        wl, ws, metrics, gstate, hstate = meshmod.shard_tree(
            (wl, ws, metrics, gstate, hstate), mesh, N)
    fstate = recorder = None
    if sample_every is not None:
        fstate = frmod.make_flightrec(spec.seed, sample_every=sample_every,
                                      ring=trace_ring, device=device)
        recorder = frmod.FlightRecorder(window_ns=spec.window_ns,
                                        sink=hops_sink)
    schedule = fault_events
    if schedule is None and use_default_faults:
        schedule = default_fault_schedule(spec)
    if use_flows:
        # prime enqueues the phase-0 sends; one flow_emit puts the first
        # cwnd-gated window on the wire before window 0 (the guard plane
        # starts with window 0, as in the JAX runner)
        state, ws, flowst, metrics = wdevice.prime(
            wl, ws, state, metrics=metrics, flows=(ftab, flowst))
        state, flowst, metrics = flowsmod.flow_emit(
            ftab, flowst, state, emit_cap=emit_cap, metrics=metrics)
    else:
        state, ws, metrics = wdevice.prime(wl, ws, state, metrics=metrics)
    window = spec.window_ns
    faults = None
    synced = 0  # schedule events the device masks `faults` hold

    def chain_fn(state, extras, r0, r1):
        nonlocal faults, synced
        ws, metrics, gstate, hstate, fstate, flowst, cstate = extras
        for r in range(r0, r1):
            if schedule is not None:
                # window r runs under the masks after (r + 1) * window.
                # The device copy is refreshed where events fire, and
                # rebuilt when the schedule moved outside this loop (a
                # memo replay's span salt, a resume) since it was last
                # synced
                fired = schedule.advance((r + 1) * window)
                if faults is None or \
                        len(schedule.fired) - len(fired) != synced:
                    faults = schedule.device_arrays(device)
                elif fired:
                    faults = schedule.refresh_device_arrays(faults, fired)
                synced = len(schedule.fired)
            shift = 0 if r == 0 else window
            out = window_step(state, params, spec.seed, shift, window,
                              rr_enabled=False, kernel="xla", faults=faults,
                              metrics=metrics, guards=gstate, hist=hstate,
                              flightrec=fstate, mesh=mesh,
                              compute=(ctab, cstate) if use_compute
                              else None)
            ((state, delivered, _next), metrics, gstate, hstate, fstate,
             cstate) = unpack_planes(out, metrics=metrics, guards=gstate,
                                     hist=hstate, flightrec=fstate,
                                     compute=cstate)
            if use_flows:
                # credit acked in-order arrivals, advance the phases,
                # enqueue their sends, then emit the window's segments
                flowst, credits = flowsmod.flow_recv(ftab, flowst,
                                                     delivered, window)
                if use_compute:
                    cstate, credits = computemod.gate_credits(cstate,
                                                              credits)
                state, ws, flowst, metrics, *g = wdevice.workload_step(
                    wl, ws, state, delivered, r, window, max_advance=adv,
                    metrics=metrics, guards=gstate,
                    flows=(ftab, flowst, credits))
                state, flowst, metrics, *rest = flowsmod.flow_emit(
                    ftab, flowst, state, emit_cap=emit_cap,
                    metrics=metrics, guards=gstate, flightrec=fstate)
                if gstate is not None:
                    gstate = rest.pop(0)
                if fstate is not None:
                    fstate = rest.pop(0)
            else:
                credits = None
                if use_compute:
                    cstate, credits = computemod.gate_credits(
                        cstate, delivered["mask"].sum(dim=1,
                                                      dtype=torch.int32))
                state, ws, metrics, *g = wdevice.workload_step(
                    wl, ws, state, delivered, r, window, max_advance=adv,
                    metrics=metrics, guards=gstate, credits=credits)
                if gstate is not None:
                    gstate = g[0]
            if use_compute:
                cstate = computemod.phase_service(ctab, cstate, ws.phase)
        return state, (ws, metrics, gstate, hstate, fstate, flowst,
                       cstate), 0, 0

    annotated = 0  # phases the harvester has announced

    def after_chain(r1, state, extras):
        nonlocal annotated
        ws, metrics, _g, hstate, fstate, _fl, _c = extras
        if mesh is not None and telemetry is not None \
                and r1 % telemetry_every == 0:
            # a collective: every rank with a harvester (all, or none)
            ws, metrics, hstate = meshmod.gather_state((ws, metrics, hstate),
                                                       mesh)
        if r1 % telemetry_every == 0:
            if telemetry is not None:
                annotated = _annotate_phases(telemetry, spec, prog, ws,
                                             annotated)
                telemetry.tick(r1 * window,
                               device=_device_counters(metrics, hstate))
            if recorder is not None:
                recorder.tick(fstate)
            if tracer is not None:
                tracer.annotate("harvest", r=int(r1),
                                time_ns=int(r1) * window)
        if on_chain is not None:
            on_chain(r1)

    memo_obj, memo_salt_fn, memo_chain = _build_memo(
        memo, spec=spec, prog=prog, schedule=schedule, adv=adv,
        emit_cap=emit_cap, recv_wnd=recv_wnd, guards=guards,
        histograms=histograms, sample_every=sample_every,
        trace_ring=trace_ring)
    if tracer is not None and memo_salt_fn is None and schedule is not None:
        # no memo, but the ledger still takes each span's fault
        # fingerprint (advancing to r0 is a no-op mid-run)
        def memo_salt_fn(r0, r1):
            schedule.advance(r0 * window)
            return schedule.span_fingerprint(r0 * window,
                                             r1 * window).encode()
    if memo_cache is not None:
        if memo_obj is None:
            raise ValueError("memo_cache requires memo: there is no "
                             "cache to persist on a non-memoized run")
        if os.path.isfile(memo_cache):
            memo_obj.load(memo_cache)

    checkpointer = None
    start_round = 0
    resumed_from = None
    if checkpoint_dir is not None:
        checkpointer = runstate.RunCheckpointer(
            checkpoint_dir, every=checkpoint_every, label=spec.name,
            window_ns=window, schedule=schedule, memo=memo_obj,
            kill_after=kill_at,
            extra_meta={"fingerprint": scenario_fingerprint(spec),
                        "program_digest": program_digest(prog)})
        ckpt_path = (runstate.latest_checkpoint(checkpoint_dir,
                                                label=spec.name)
                     if resume else None)
        if ckpt_path is not None:
            # refuse world drift before touching the carry
            want_fp = runstate.load_runstate(ckpt_path)[0].get(
                "fingerprint")
            if want_fp != scenario_fingerprint(spec):
                raise CheckpointError(
                    f"{ckpt_path}: scenario fingerprint mismatch "
                    f"(checkpoint {str(want_fp)[:12]}..., this run "
                    f"{scenario_fingerprint(spec)[:12]}...) — the "
                    f"checkpoint belongs to a different world")
            template = (state, (ws, metrics, gstate, hstate, fstate,
                                flowst, cstate))
            res = runstate.resume_carry(ckpt_path, template,
                                        schedule=schedule, memo=memo_obj)
            state, (ws, metrics, gstate, hstate, fstate, flowst,
                    cstate) = res["carry"]
            start_round = res["round"]
            resumed_from = os.path.basename(ckpt_path).removesuffix(
                ".runstate.npz")
            if tracer is not None:
                tracer.annotate("resume", checkpoint=resumed_from,
                                r=start_round)

    need_cadence = telemetry is not None or recorder is not None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    state, extras = elastic.drive_chained_windows(
        state, (ws, metrics, gstate, hstate, fstate, flowst, cstate),
        chain_fn, n_rounds=spec.windows,
        chain_len=chain_len or (telemetry_every if need_cadence
                                else memo_chain if memo_obj is not None
                                else spec.windows),
        start_round=start_round,
        boundaries=(range(telemetry_every, spec.windows, telemetry_every)
                    if need_cadence else ()),
        window_ns=window,
        on_chain=(after_chain if need_cadence or on_chain is not None
                  else None),
        memo=memo_obj, memo_span_salt=memo_salt_fn, tracer=tracer,
        checkpointer=checkpointer, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.update(setup_s=t1 - t0, drive_s=time.perf_counter() - t1)
    ws, metrics, gstate, hstate, fstate, flowst, cstate = extras
    if mesh is not None:
        state, ws, metrics, gstate, hstate = meshmod.gather_state(
            (state, ws, metrics, gstate, hstate), mesh)
    if memo_cache is not None:
        memo_obj.save(memo_cache)
    if provenance is not None:
        provenance.update({
            "resumed_from": resumed_from,
            "start_round": int(start_round),
            "checkpoints_written": (checkpointer.saved
                                    if checkpointer is not None else 0),
        })
    record = _record(spec, prog, state, ws, metrics, hstate, flowst, cstate,
                     faults_active=schedule is not None)
    if use_flows:
        record["flows"] = {**flowsmod.flow_totals(ftab, flowst),
                           "emit_cap": emit_cap, "recv_wnd": recv_wnd}
    if use_compute:
        record.update(_serving_record(spec, cstate))
    if memo_obj is not None:
        record["memo"] = memo_obj.report()
        if tracer is not None:
            tracer.memo_close(memo_obj)
    if gstate is not None:
        record["guards"] = summarize(gstate)
    if recorder is not None:
        # the last snapshot: one tick queues it, finalize decodes it
        recorder.tick(fstate)
        recorder.finalize()
        record["flight_recorder"] = {**recorder.summary(),
                                     **frmod.flightrec_meta(fstate)}
    if telemetry is not None:
        # trailing annotations ride the pending snapshot; tick again only
        # when the cadence did not harvest this very instant
        _annotate_phases(telemetry, spec, prog, ws, annotated)
        if spec.windows % telemetry_every != 0:
            telemetry.tick(spec.windows * window,
                           device=_device_counters(metrics, hstate))
    return record


def check_mesh_run(spec: ScenarioSpec, n_ranks: int, *, memo,
                   checkpoint_dir) -> None:
    """The JAX runner's refusals under `mesh_devices` (ValueError naming
    the mesh), before any rank starts: the flow transport, the compute
    plane, checkpoints and the memo; and a world that does not shard
    evenly."""
    if spec.transport == "flows":
        raise ValueError(
            "transport: flows does not run under a host-axis mesh "
            "(mesh_devices): the flow axis is flow-major, not host-major, "
            "and its credit scatter-adds need a cross-shard reduction")
    if spec.compute is not None:
        raise ValueError(
            "the compute plane does not run under a host-axis mesh "
            "(mesh_devices): its service tables are not host-sharded")
    if checkpoint_dir is not None:
        raise ValueError(
            "checkpointing does not run under a host-axis mesh "
            "(mesh_devices): the carry's host copy holds one rank's rows")
    if _memo_knob(memo) is not None:
        raise ValueError(
            "memo does not run under a host-axis mesh (mesh_devices): its "
            "host mirror of the carry would hold one rank's rows")
    if n_ranks < 1 or spec.n_hosts % n_ranks:
        raise ValueError(
            f"mesh_devices={n_ranks}: {spec.n_hosts} hosts do not shard "
            "evenly over the mesh")


def _scenario_rank(mesh, spec: ScenarioSpec, shared: dict, **rank0):
    """One rank of a spawned `run_scenario(mesh_devices=)`: rank 0 (the
    caller's process) runs with the caller's harvester, tracer, hops
    sink, hook and timings."""
    return run_scenario(spec, mesh=mesh, **{**shared, **rank0})


class _RankHarvest:
    """A harvester for a mesh rank other than 0: it takes part in the
    harvests' gathers, and rank 0's harvester keeps what they read."""

    def tick(self, *_args, **_kw):
        pass

    def note_event(self, *_args, **_kw):
        pass


def _memo_knob(memo):
    """The `memo` argument's knob reader (`knob(name, default)`), or None
    when it turns the memo off (None, False, or `enabled` false)."""
    if memo is None or memo is False:
        return None
    knob = (memo.get if isinstance(memo, dict)
            else lambda k, d: getattr(memo, k, d))
    if memo is not True and not knob("enabled", True):
        return None
    return knob


def _build_memo(memo, *, spec, prog, schedule, adv, emit_cap, recv_wnd,
                guards, histograms, sample_every, trace_ring):
    """The `memo` argument (None, a bool, or a dict or object of
    `enabled`, `max_bytes`, `min_repeat`, `chain_len`) as the driver's
    (ChainMemo, span_salt_fn, chain_len), with the JAX runner's salt and
    key policy, so the keys are its keys.

    The static salt folds what the chain closes over and the carry does
    not show: the scenario fingerprint, the program digest and every
    dynamics knob. `key_extra` folds the absolute start round while any
    workload host is live (`done_win` stamps absolute rounds), and the
    flow plane's raw virtual clock while anything could read it (a timer
    armed, an RTT probe out, unacked bytes, a pending ack, receiver
    bitmap content, or any packet still in a ring). Under faults the
    span salt is the schedule's span fingerprint."""
    knob = _memo_knob(memo)
    if knob is None:
        return None, None, None
    salt = "|".join([
        "memo-v1", scenario_fingerprint(spec), program_digest(prog),
        f"adv={adv}", f"emit={emit_cap}", f"wnd={recv_wnd}",
        f"guards={int(guards)}", f"hist={int(histograms)}",
        f"se={sample_every}", f"ring={trace_ring}",
    ]).encode()
    n_phases_host = np.asarray(prog.n_phases)

    def key_extra(carry, r0):
        mstate, mextras = carry
        mws, mflow = mextras[0], mextras[5]
        parts = []
        if bool((np.asarray(mws.phase) < n_phases_host).any()):
            parts.append(b"r0:%d" % r0)
        if mflow is not None:
            live = bool(
                np.asarray(mflow.rto_armed).any()
                or (np.asarray(mflow.rtt_seq) >= 0).any()
                or (np.asarray(mflow.snd_una)
                    != np.asarray(mflow.stream_len)).any()
                or np.asarray(mflow.ack_pending).any()
                or np.asarray(mflow.rcv_bits).any()
                or np.asarray(mstate.eg_valid).any()
                or np.asarray(mstate.in_valid).any())
            parts.append(b"clk:" + (
                np.ascontiguousarray(mflow.clock_ms).tobytes()
                if live else b"idle"))
        return b"|".join(parts)

    memo_obj = memomod.ChainMemo(
        max_bytes=int(knob("max_bytes", 64 << 20)),
        min_repeat=int(knob("min_repeat", 1)),
        salt=salt, key_extra=key_extra)
    salt_fn = None
    if schedule is not None:
        def salt_fn(r0, r1):
            # keep the schedule's position current across hits (a hit
            # skips chain_fn, which advances it); a no-op after a miss
            schedule.advance(r0 * spec.window_ns)
            return schedule.span_fingerprint(
                r0 * spec.window_ns, r1 * spec.window_ns).encode()
    # 4-window spans by default, as in JAX: the drained tail of every
    # corpus entry then yields equal-length recurring spans
    return memo_obj, salt_fn, int(knob("chain_len", 4))


def _device_counters(metrics, hstate):
    """The harvester's device dict: the metrics and histogram tensors."""
    if hstate is None:
        return metrics
    return {**metrics._asdict(), **hstate._asdict()}


def _annotate_phases(harvester, spec: ScenarioSpec, prog: TrafficProgram,
                     ws, already: int) -> int:
    """Queue a heartbeat annotation for each phase completed fleet-wide
    since the last harvest (one read of `done_win` a harvest): phases
    complete in order for each host, so the completed prefix grows and
    `already` counts its announced part. Returns the new count."""
    done_win = ws.done_win.detach().cpu().numpy().astype(np.int64)
    never = 2**31 - 1
    count = already
    for p in range(already, prog.max_phases):
        members = prog.n_phases > p
        if not members.any():
            break
        wins = done_win[members, p]
        if (wins >= never).any():
            break
        harvester.note_event({
            "kind": "workload_phase",
            "scenario": spec.name,
            "family": spec.family,
            "phase": p,
            "time_ns": int((wins.max() + 1) * spec.window_ns),
        })
        count = p + 1
    return count


def _record(spec: ScenarioSpec, prog: TrafficProgram, state, ws, metrics,
            hstate, flowst=None, cstate=None, *,
            faults_active: bool = False) -> dict:
    """The JAX runner's record but its `flows`, `compute`, `slo`,
    `guards` and `flight_recorder` sections: the read of the device
    after the drive. Flow and compute state fold into the canonical
    digest, so a retransmit schedule that diverges fails the golden gate
    even when the net-plane state converges."""
    host = lambda t: t.detach().cpu().numpy()
    phase = host(ws.phase)
    m = {f: host(getattr(metrics, f)) for f in metrics._fields}
    done = phase >= prog.n_phases
    record = {
        "name": spec.name,
        "family": spec.family,
        "fingerprint": scenario_fingerprint(spec),
        "program_digest": program_digest(prog),
        "hosts": spec.n_hosts,
        "windows": spec.windows,
        "window_ns": spec.window_ns,
        "phases": prog.max_phases,
        "faults_active": faults_active,
        "transport": spec.transport,
        "canonical_digest": digest_pytrees(
            elastic.canonical_state(state), ws,
            *(t for t in (flowst, cstate) if t is not None)),
        "all_done": bool(done.all()),
        "completed_hosts": int(done[prog.n_phases > 0].sum()),
        "participants": int((prog.n_phases > 0).sum()),
        "sent": int(host(state.n_sent).sum()),
        "delivered": int(host(state.n_delivered).sum()),
        "events": int(m["events"]),
        "drops": {
            "ring_full": int(m["drop_ring_full"].sum()),
            "qdisc": int(m["drop_qdisc"].sum()),
            "loss": int(m["drop_loss"].sum()),
            "fault": int(m["drop_fault"].sum()),
        },
        "retransmits": int(m["retransmits"].astype(np.int64).sum()),
        **_phase_completion(spec, prog, wdevice.completion_windows(ws)),
    }
    if hstate is not None:
        # per-scenario SLO percentiles of the fleet-summed histograms
        record["latency"] = {
            name[len(histo.HIST_PREFIX):] if name.startswith(
                histo.HIST_PREFIX) else name:
            histo.fleet_percentiles(getattr(hstate, name))
            for name in hstate._fields}
    return record


def _serving_record(spec: ScenarioSpec, cstate) -> dict:
    """The serving sections: compute-plane totals, and the SLO block of
    request wait and sojourn percentiles from the fleet-summed compute
    histograms, judged against the scenario's `serve:` targets."""
    i64sum = lambda t: int(t.detach().cpu().numpy().astype(np.int64).sum())
    slo = {"wait_ns": histo.fleet_percentiles(cstate.hist_wait_ns),
           "sojourn_ns": histo.fleet_percentiles(cstate.hist_sojourn_ns)}
    if spec.serve is not None:
        soj = slo["sojourn_ns"]
        slo["targets"] = {
            q: {"target_ns": target, "measured_ns": soj[q],
                "met": bool(soj[q] <= target)}
            for q, target in (("p99", spec.serve.p99_ns),
                              ("p999", spec.serve.p999_ns))
            if target is not None}
    return {
        "compute": {"op": spec.compute.op,
                    "queue_cap": spec.compute.queue_cap,
                    "served": i64sum(cstate.n_served),
                    "queued": i64sum(cstate.n_queued),
                    "overflow": i64sum(cstate.n_overflow)},
        "slo": slo,
    }


def _phase_completion(spec: ScenarioSpec, prog: TrafficProgram,
                      done_win: np.ndarray) -> dict:
    """Completion report from the [N, P] done-window table, in
    window-quantized virtual ns: per phase, the last participant's exit
    (None while any has not left it); per host, its terminal phase's
    exit, as min/p50/max over the hosts that finished."""
    never = 2**31 - 1
    phase_ns: list[Optional[int]] = []
    for p in range(prog.max_phases):
        members = prog.n_phases > p
        if not members.any():
            phase_ns.append(None)
            continue
        wins = done_win[members, p]
        phase_ns.append(None if (wins >= never).any()
                        else int((wins.max() + 1) * spec.window_ns))
    hosts_done = []
    for h in range(prog.n_hosts):
        np_h = int(prog.n_phases[h])
        if np_h == 0:
            continue
        w = done_win[h, np_h - 1]
        if w < never:
            hosts_done.append(int((w + 1) * spec.window_ns))
    hosts_done.sort()
    spread = ({"min_ns": hosts_done[0],
               "p50_ns": hosts_done[len(hosts_done) // 2],
               "max_ns": hosts_done[-1]} if hosts_done else None)
    return {"phase_completion_ns": phase_ns, "host_completion": spread}


def load_golden(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def golden_entry(record: dict) -> dict:
    """The per-scenario golden tuple: the scenario (fingerprint), the
    compiler (program digest) and the run (canonical digest)."""
    return {"fingerprint": record["fingerprint"],
            "program_digest": record["program_digest"],
            "canonical_digest": record["canonical_digest"]}


def check_against_golden(records: list[dict], golden: dict) -> list[str]:
    """Mismatch lines of a corpus run against the golden file (empty =
    clean); a golden entry that did not run is a mismatch too."""
    problems = []
    seen = set()
    for rec in records:
        name = rec["name"]
        seen.add(name)
        want = golden.get(name)
        if want is None:
            problems.append(f"{name}: not in the golden corpus")
            continue
        got = golden_entry(rec)
        for key in ("fingerprint", "program_digest", "canonical_digest"):
            if got[key] != want.get(key):
                problems.append(f"{name}: {key} mismatch\n"
                                f"  golden: {want.get(key)}\n"
                                f"  run:    {got[key]}")
    for name in sorted(set(golden) - seen):
        problems.append(f"{name}: in the golden corpus but not run")
    return problems

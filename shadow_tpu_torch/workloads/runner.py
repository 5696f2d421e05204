"""The scenario-corpus runner.

Counterpart of `shadow_tpu/workloads/runner.py`: the deterministic
scenario world, the window loop of `window_step(kernel="xla")` with the
metrics and histogram planes threaded, `unpack_planes` and
`workload_step`, driven as one chain of `spec.windows` windows by
`tpu/elastic.drive_chained_windows`, and the JSON record of the JAX
runner, field for field. A scenario with `transport: flows` runs the
flow plane (`tpu/flows.py`) in split form around the generator each
window: `flow_recv` credits acked in-order segments, `workload_step`
enqueues the next sends onto their flows, `flow_emit` puts the
cwnd-gated window, retransmits and delayed acks on the wire. A
`compute:` block threads the compute plane (`tpu/compute.py`) through
the step, meters the phase credits through service completion
(`gate_credits`) and re-arms each host's service cost from its phase
(`phase_service`). The record's `canonical_digest` hashes the bytes the
JAX runner's `digest_pytrees` hashes, flow and compute state included,
so it is the golden corpus's comparison key here too
(`scenarios/GOLDEN.json`).

The device is read back once, after the drive. The record carries no
wall-clock time.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..convert import digest_pytrees
from ..telemetry import histo
from ..telemetry.metrics import make_metrics
from ..tpu import compute as computemod
from ..tpu import elastic
from ..tpu import flows as flowsmod
from ..tpu.plane import make_params, make_state, unpack_planes, window_step
from . import device as wdevice
from .compile import TrafficProgram, compile_program, program_digest
from .spec import ScenarioSpec, scenario_fingerprint

MS = 1_000_000

# keywords of the JAX runner that the port does not run yet, with the
# ROADMAP.md queue A item that brings each (max_advance stays at its
# default, the only value the JAX runner's callers pass)
_NOT_PORTED = {
    "max_advance": "run infrastructure",
    "guards": "faults, guards and the flight recorder",
    "fault_events": "faults, guards and the flight recorder",
    "use_default_faults": "faults, guards and the flight recorder",
    "sample_every": "faults, guards and the flight recorder",
    "trace_ring": "faults, guards and the flight recorder",
    "hops_sink": "faults, guards and the flight recorder",
    "mesh_devices": "multi-GPU",
    "telemetry": "run infrastructure",
    "telemetry_every": "run infrastructure",
    "memo": "run infrastructure",
    "memo_cache": "run infrastructure",
    "tracer": "run infrastructure",
    "checkpoint_dir": "run infrastructure",
    "checkpoint_every": "run infrastructure",
    "resume": "run infrastructure",
    "kill_at": "run infrastructure",
    "provenance": "run infrastructure",
}


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


def run_scenario(spec: ScenarioSpec, *, histograms: bool = True,
                 flow_emit_cap: Optional[int] = None,
                 flow_recv_wnd: Optional[int] = None,
                 chain_len: Optional[int] = None, on_chain=None,
                 device=None, timings: Optional[dict] = None,
                 **unported) -> dict:
    """Execute one scenario for its full window budget and return the
    JAX runner's record (no wall-clock in it).

    `histograms` (default on) threads the log2 latency and depth
    histograms and records their fleet percentiles as `latency`.
    `flow_emit_cap` and `flow_recv_wnd` set the flow plane's per-window
    emission cap and receive window (None: `flows.EMIT_CAP`,
    `flows.RECV_WND`; read only under `transport: flows`). The drive
    runs `chain_len` windows a chain (None: all of them in one), and
    calls `on_chain(r1)` on the host after the chain that ends before
    window r1 (a profiler starts and stops there). A dict
    passed as `timings` receives the host seconds of the set-up
    (`setup_s`: world, program, upload, prime) and of the drive
    (`drive_s`, ended by a device synchronise), outside the record.
    The JAX runner's other keywords raise NotImplementedError naming the
    ROADMAP.md item that brings them."""
    for key, value in unported.items():
        if key not in _NOT_PORTED:
            raise TypeError(f"run_scenario: unexpected argument {key!r}")
        if value is not None and value is not False:
            raise NotImplementedError(
                f"run_scenario: {key}= is not ported yet (ROADMAP.md "
                f"queue A: {_NOT_PORTED[key]})")
    device = resolve_device(device)
    t0 = time.perf_counter()
    prog = compile_program(spec)
    state, params = build_scenario_world(spec, device=device)
    wl = wdevice.to_device(prog, device)
    ws = wdevice.make_workload_state(prog, device)
    N = spec.n_hosts
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
    hstate = histo.make_histograms(N, device=device) if histograms else None
    if use_flows:
        # prime enqueues the phase-0 sends; one flow_emit puts the first
        # cwnd-gated window on the wire before window 0
        state, ws, flowst, metrics = wdevice.prime(
            wl, ws, state, metrics=metrics, flows=(ftab, flowst))
        state, flowst, metrics = flowsmod.flow_emit(
            ftab, flowst, state, emit_cap=emit_cap, metrics=metrics)
    else:
        state, ws, metrics = wdevice.prime(wl, ws, state, metrics=metrics)
    window = spec.window_ns

    def chain_fn(state, extras, r0, r1):
        ws, metrics, hstate, flowst, cstate = extras
        for r in range(r0, r1):
            shift = 0 if r == 0 else window
            out = window_step(state, params, spec.seed, shift, window,
                              rr_enabled=False, kernel="xla",
                              metrics=metrics, hist=hstate,
                              compute=(ctab, cstate) if use_compute
                              else None)
            (state, delivered, _next), metrics, _g, hstate, _fr, cstate = \
                unpack_planes(out, metrics=metrics, hist=hstate,
                              compute=cstate)
            if use_flows:
                # credit acked in-order arrivals, advance the phases,
                # enqueue their sends, then emit the window's segments
                flowst, credits = flowsmod.flow_recv(ftab, flowst,
                                                     delivered, window)
                if use_compute:
                    cstate, credits = computemod.gate_credits(cstate,
                                                              credits)
                state, ws, flowst, metrics = wdevice.workload_step(
                    wl, ws, state, delivered, r, window, metrics=metrics,
                    flows=(ftab, flowst, credits))
                state, flowst, metrics = flowsmod.flow_emit(
                    ftab, flowst, state, emit_cap=emit_cap,
                    metrics=metrics)
            else:
                credits = None
                if use_compute:
                    cstate, credits = computemod.gate_credits(
                        cstate, delivered["mask"].sum(dim=1,
                                                      dtype=torch.int32))
                state, ws, metrics = wdevice.workload_step(
                    wl, ws, state, delivered, r, window, metrics=metrics,
                    credits=credits)
            if use_compute:
                cstate = computemod.phase_service(ctab, cstate, ws.phase)
        return state, (ws, metrics, hstate, flowst, cstate), 0, 0

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    state, extras = elastic.drive_chained_windows(
        state, (ws, metrics, hstate, flowst, cstate), chain_fn,
        n_rounds=spec.windows, chain_len=chain_len or spec.windows,
        window_ns=window,
        on_chain=None if on_chain is None else lambda r1, *_: on_chain(r1))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.update(setup_s=t1 - t0, drive_s=time.perf_counter() - t1)
    ws, metrics, hstate, flowst, cstate = extras
    record = _record(spec, prog, state, ws, metrics, hstate, flowst, cstate)
    if use_flows:
        record["flows"] = {**flowsmod.flow_totals(ftab, flowst),
                           "emit_cap": emit_cap, "recv_wnd": recv_wnd}
    if use_compute:
        record.update(_serving_record(spec, cstate))
    return record


def _record(spec: ScenarioSpec, prog: TrafficProgram, state, ws, metrics,
            hstate, flowst=None, cstate=None) -> dict:
    """The JAX runner's record for a world without faults, but its
    `flows`, `compute` and `slo` sections: the one read of the device,
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
        "faults_active": False,
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

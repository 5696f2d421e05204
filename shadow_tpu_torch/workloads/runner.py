"""The scenario-corpus runner on the direct transport.

Counterpart of `shadow_tpu/workloads/runner.py` for scenarios whose
sends go straight onto the wire (`transport: direct`, no `compute:`
block): the deterministic scenario world, the window loop of
`window_step(kernel="xla")` with the metrics and histogram planes
threaded, `unpack_planes` and `workload_step`, driven as one chain of
`spec.windows` windows by `tpu/elastic.drive_chained_windows`, and the
JSON record of the JAX runner, field for field. The record's
`canonical_digest` hashes the bytes the JAX runner's `digest_pytrees`
hashes, so it is the golden corpus's comparison key here too
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
from ..tpu import elastic
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
    "flow_emit_cap": "the flow and compute planes",
    "flow_recv_wnd": "the flow and compute planes",
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


def runnable(spec: ScenarioSpec) -> Optional[str]:
    """None when the port runs `spec`, else why not (the ROADMAP.md
    item that brings it)."""
    if spec.transport != "direct" or spec.compute is not None:
        return (f"transport: {spec.transport}"
                + (", compute:" if spec.compute is not None else "")
                + " needs the flow and compute planes, not ported yet "
                "(ROADMAP.md queue A: the flow and compute planes)")
    return None


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
                 device=None, timings: Optional[dict] = None,
                 **unported) -> dict:
    """Execute one direct-transport scenario for its full window budget
    and return the JAX runner's record (no wall-clock in it).

    `histograms` (default on) threads the log2 latency and depth
    histograms and records their fleet percentiles as `latency`. A dict
    passed as `timings` receives the host seconds of the set-up
    (`setup_s`: world, program, upload, prime) and of the drive
    (`drive_s`, ended by a device synchronise), outside the record.
    The JAX runner's other keywords raise NotImplementedError naming the
    ROADMAP.md item that brings them; so do flow-transport and compute
    scenarios."""
    for key, value in unported.items():
        if key not in _NOT_PORTED:
            raise TypeError(f"run_scenario: unexpected argument {key!r}")
        if value is not None and value is not False:
            raise NotImplementedError(
                f"run_scenario: {key}= is not ported yet (ROADMAP.md "
                f"queue A: {_NOT_PORTED[key]})")
    why = runnable(spec)
    if why is not None:
        raise NotImplementedError(f"scenario {spec.name!r}: {why}")
    device = resolve_device(device)
    t0 = time.perf_counter()
    prog = compile_program(spec)
    state, params = build_scenario_world(spec, device=device)
    wl = wdevice.to_device(prog, device)
    ws = wdevice.make_workload_state(prog, device)
    N = spec.n_hosts
    metrics = make_metrics(N, device=device)
    hstate = histo.make_histograms(N, device=device) if histograms else None
    state, ws, metrics = wdevice.prime(wl, ws, state, metrics=metrics)
    window = spec.window_ns

    def chain_fn(state, extras, r0, r1):
        ws, metrics, hstate = extras
        for r in range(r0, r1):
            shift = 0 if r == 0 else window
            out = window_step(state, params, spec.seed, shift, window,
                              rr_enabled=False, kernel="xla",
                              metrics=metrics, hist=hstate)
            (state, delivered, _next), metrics, _g, hstate, _fr = \
                unpack_planes(out, metrics=metrics, hist=hstate)
            state, ws, metrics = wdevice.workload_step(
                wl, ws, state, delivered, r, window, metrics=metrics)
        return state, (ws, metrics, hstate), 0, 0

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    state, (ws, metrics, hstate) = elastic.drive_chained_windows(
        state, (ws, metrics, hstate), chain_fn, n_rounds=spec.windows,
        chain_len=spec.windows, window_ns=window)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.update(setup_s=t1 - t0, drive_s=time.perf_counter() - t1)
    return _record(spec, prog, state, ws, metrics, hstate)


def _record(spec: ScenarioSpec, prog: TrafficProgram, state, ws, metrics,
            hstate) -> dict:
    """The JAX runner's record for a direct-transport world without
    faults: the one read of the device, after the drive."""
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
        "canonical_digest": digest_pytrees(elastic.canonical_state(state),
                                           ws),
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

"""The batched on-device traffic generator: `workload_step`.

Counterpart of `shadow_tpu/workloads/device.py` on the direct transport.
A compiled traffic program (`compile.TrafficProgram`) is uploaded once
as `WorkloadArrays`; per window, `workload_step` takes the window's
`delivered` dict, advances each host's phase pointer and emits the next
phases' sends through `plane.ingest_rows`, with no read back to the
host. Phase semantics are the JAX package's:

- deliveries received this window credit the host's current phase;
- a host advances when its phase's dependency count is met and its hold
  time has run out, at most `max_advance` phases a window;
- holds count down by `window_ns` a window;
- entering a phase emits its send table, each lane offset by its
  `send_delay` within the window;
- the window in which a host leaves each phase lands in `done_win`
  (I32_MAX = not yet).

Under the flow transport (`flows=`) the emissions are enqueued onto
their flows (`tpu/flows.enqueue`) instead of appended as packets, and a
phase is credited with acked in-order segments. `metrics=` and
`guards=` ride the emission's `ingest_rows` as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..tpu import flows as flows_mod
from ..tpu.plane import ingest_rows
from ..tpu.prims import I32_MAX
from .compile import TrafficProgram

#: default phase-advance budget per window (the JAX package's)
MAX_ADVANCE = 4


class WorkloadArrays(NamedTuple):
    """The uploaded traffic program (read-only on the device)."""

    dep: torch.Tensor  # [N, P] int32
    hold_ns: torch.Tensor  # [N, P] int32
    send_peer: torch.Tensor  # [N, P, K] int32 (-1 = unused lane)
    send_bytes: torch.Tensor  # [N, P, K] int32
    send_delay: torch.Tensor  # [N, P, K] int32
    n_phases: torch.Tensor  # [N] int32


class WorkloadState(NamedTuple):
    """Per-host generator state, axis 0 = host; field order is the JAX
    package's."""

    phase: torch.Tensor  # [N] int32 current phase (== n_phases: done)
    recv_acc: torch.Tensor  # [N] int32 deliveries credited to it
    hold_left: torch.Tensor  # [N] int32 ns left in the phase's hold
    seq: torch.Tensor  # [N] int32 next send seq (per-source monotone)
    done_win: torch.Tensor  # [N, P] int32 window the phase was left


def to_device(prog: TrafficProgram, device=None) -> WorkloadArrays:
    """Upload the program tables (copies, so a later edit of the numpy
    program never reaches the device state)."""
    device = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return WorkloadArrays(
        dep=t(prog.dep), hold_ns=t(prog.hold_ns), send_peer=t(prog.send_peer),
        send_bytes=t(prog.send_bytes), send_delay=t(prog.send_delay),
        n_phases=t(prog.n_phases))


def make_workload_state(prog: TrafficProgram, device=None) -> WorkloadState:
    """Initial state: every participant in phase 0 (its sends go out
    through `prime`), holds armed from phase 0's table."""
    device = resolve_device(device)
    N, P = prog.dep.shape
    z = lambda: torch.zeros(N, dtype=torch.int32, device=device)
    return WorkloadState(
        phase=z(), recv_acc=z(),
        hold_left=torch.tensor(np.asarray(prog.hold_ns[:, 0], np.int32),
                               device=device),
        seq=z(),
        done_win=torch.full((N, P), I32_MAX, dtype=torch.int32,
                            device=device))


def _phase_sends(wl: WorkloadArrays, phase, entered):
    """[N, K] send lanes of each host's `phase`, masked by `entered`:
    (valid, peer, bytes, delay)."""
    idx = torch.clamp(phase, 0, wl.dep.shape[1] - 1).to(torch.int64)
    rows = torch.arange(idx.shape[0], device=idx.device)
    peer = wl.send_peer[rows, idx]
    valid = entered[:, None] & (peer >= 0)
    return valid, peer, wl.send_bytes[rows, idx], wl.send_delay[rows, idx]


def _emit(state, ws: WorkloadState, valid, peer, nbytes, delay, *,
          metrics=None, guards=None):
    """Append the emission batch to the egress rings, seqs assigned in
    lane order (the rank among the row's valid lanes); the seq is the
    priority too. Returns (state', (metrics', guards' as threaded),
    ws')."""
    rank = torch.where(
        valid, torch.cumsum(valid, dim=1, dtype=torch.int32) - 1, 0)
    seq_vals = ws.seq[:, None] + rank
    out = ingest_rows(state, peer, nbytes, seq_vals, seq_vals,
                      torch.zeros_like(valid), valid, send_rel=delay,
                      metrics=metrics, guards=guards)
    state, extras = (out[0], out[1:]) if type(out) is tuple else (out, ())
    ws = ws._replace(seq=ws.seq + valid.sum(dim=1, dtype=torch.int32))
    return state, extras, ws


def _planes(metrics, guards) -> tuple:
    return tuple(p for p in (metrics, guards) if p is not None)


def _lane_flows(ft, phase, entered):
    """[N, K] flow ids of each host's `phase` send lanes (-1 where the
    host did not enter it), gathered as `_phase_sends` gathers the send
    tables."""
    idx = torch.clamp(phase, 0, ft.lane_flow.shape[1] - 1).to(torch.int64)
    rows = torch.arange(idx.shape[0], device=idx.device)
    return torch.where(entered[:, None], ft.lane_flow[rows, idx], -1)


def prime(wl: WorkloadArrays, ws: WorkloadState, state, *, metrics=None,
          guards=None, flows=None):
    """Emit every participant's phase-0 sends (once, before the first
    window). Returns (state', ws'[, metrics'][, guards']). With
    `flows=(ft, fs)` the sends are enqueued onto their flows instead, for
    the caller's following `flow_emit`; the return is then (state, ws,
    fs'[, metrics][, guards]) with the state and the planes untouched."""
    entered = wl.n_phases > 0
    phase0 = torch.zeros_like(ws.phase)
    valid, peer, nbytes, delay = _phase_sends(wl, phase0, entered)
    if flows is not None:
        ft, fs = flows
        fs = flows_mod.enqueue(ft, fs, _lane_flows(ft, phase0, entered),
                               valid)
        return (state, ws, fs, *_planes(metrics, guards))
    state, extras, ws = _emit(state, ws, valid, peer, nbytes, delay,
                              metrics=metrics, guards=guards)
    return (state, ws, *extras)


def workload_step(wl: WorkloadArrays, ws: WorkloadState, state, delivered,
                  round_idx: int, window_ns: int, *,
                  max_advance: int = MAX_ADVANCE, metrics=None, guards=None,
                  flows=None, credits=None):
    """Advance the generator by one window and emit the next sends.

    `delivered` is `window_step`'s dict for this window; each delivery
    credits the receiving host's current phase, unless `credits` ([N]
    int32) gives the per-host credits instead. `round_idx` is the
    driver's window counter (stamps `done_win`); `window_ns` counts the
    holds down. Returns (state', ws'[, metrics'][, guards']).

    `flows=(ft, fs, credits)` runs the generator on the flow transport:
    the phases are credited with `credits` (`flows.flow_recv`'s acked
    in-order segments) and the sends are enqueued onto their flows for
    the caller's following `flow_emit`; the return is then (state, ws',
    fs'[, metrics][, guards]) with the state and the planes untouched."""
    if flows is not None:
        ft, fs, credits = flows
    N, P = wl.dep.shape
    got = (delivered["mask"].sum(dim=1, dtype=torch.int32)
           if credits is None else credits)
    recv_acc = ws.recv_acc + got
    hold_left = torch.clamp(ws.hold_left - window_ns, min=0)
    phase, done_win = ws.phase, ws.done_win
    rows = torch.arange(N, device=phase.device)
    col = torch.arange(P, dtype=torch.int32, device=phase.device)[None, :]
    lanes = []
    for _ in range(max_advance):
        cur = torch.clamp(phase, 0, P - 1)
        dep_cur = wl.dep[rows, cur.to(torch.int64)]
        live = phase < wl.n_phases
        adv = live & (recv_acc >= dep_cur) & (hold_left == 0)
        recv_acc = torch.where(adv, recv_acc - dep_cur, recv_acc)
        # the window a phase was left: a min against a one-hot stamp
        done_win = torch.where(adv[:, None] & (col == cur[:, None]),
                               done_win.clamp(max=round_idx), done_win)
        phase = torch.where(adv, phase + 1, phase)
        entered = adv & (phase < wl.n_phases)
        new = torch.clamp(phase, 0, P - 1).to(torch.int64)
        hold_left = torch.where(entered, wl.hold_ns[rows, new], hold_left)
        lanes.append(_phase_sends(wl, phase, entered))
        if flows is not None:
            lanes[-1] += (_lane_flows(ft, phase, entered),)
    valid, peer, nbytes, delay, *lf = (torch.cat(cols, dim=1)
                                       for cols in zip(*lanes))
    ws = ws._replace(phase=phase, recv_acc=recv_acc, hold_left=hold_left,
                     done_win=done_win)
    if flows is not None:
        fs = flows_mod.enqueue(ft, fs, lf[0], valid)
        return (state, ws, fs, *_planes(metrics, guards))
    state, extras, ws = _emit(state, ws, valid, peer, nbytes, delay,
                              metrics=metrics, guards=guards)
    return (state, ws, *extras)


def all_done(wl: WorkloadArrays, ws: WorkloadState) -> torch.Tensor:
    """0-d bool: every participant reached its terminal phase."""
    return (ws.phase >= wl.n_phases).all()


def completion_windows(ws: WorkloadState) -> np.ndarray:
    """[N, P] int64 window indices at which each phase was left
    (I32_MAX where never), on the host, for the runner's reports."""
    return ws.done_win.detach().cpu().numpy().astype(np.int64)

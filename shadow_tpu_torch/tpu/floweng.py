"""The device flow engine: tgen-shaped bulk TCP transfers with both
endpoints' TCP machines, the wire, the timers and the app on the card.

Counterpart of `shadow_tpu/tpu/floweng.py`. A world holds F flows as 2F
connections (even = active opener, odd = passive accepter; peer(i) =
i ^ 1). Windows no wider than the narrowest flow's one-way latency
advance every connection through its own events (conservative PDES:
nothing a connection emits reaches its peer inside the window), and
emitted segments wait in per-destination FIFO rings with their arrival
times. One fused step runs up to `sched_batch` scheduled events a
connection (arrivals, timers, opens; `tcp.tcp_sched_step`), the app
phase (greedy read, buffer-refill write, close) and up to `pull_cap`
egress pulls (`tcp.tcp_pull_step`, GSO macro-segments with the wire's
loss drawn per MSS unit from a counter hash). Pure ACKs of in-order data
are held up to `ack_every` segments or the window barrier, where a pull
pass with `ack_every=1` flushes them. Time is int32 microseconds.

`run_windows` is the entry point. On CUDA tensors it launches kernel F
(`csrc/flow_window.cu`): one thread a flow pair advances both lanes
through a whole chunk of windows in one launch, in the order of JAX's
global loops. That is exact because pairs never interact and a fused
step, the app phase and the barrier flush leave a pair with no work
unchanged (`tests/test_torch_floweng.py` holds the pair-independence
test that shows it), so a pair may stop where it has none; the window's
step count is the largest over pairs. On CPU tensors it runs
`run_windows_plain`, the JAX loop structure in PyTorch with its loop
predicates read back to the host, which also runs on CUDA tensors when
called by name.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import tcp as dtcp
from .prims import I32_MAX, floordiv, u32, wrap_i32

MS_US = 1000  # microseconds per millisecond
_U32 = 0xFFFFFFFF

# kernel launches since the last reset (kernel F)
LAUNCHES = {"flow_window": 0}


def reset_launches():
    LAUNCHES["flow_window"] = 0


class FlowWorld(NamedTuple):
    """2F connections, axis 0 = connection (`FlowWorld` of
    `shadow_tpu/tpu/floweng.py:93`, field for field). `loss_u32` is held
    as int64 in [0, 2**32); `clock_us` and `n_saturated` are 0-d."""

    plane: dtcp.TcpPlane  # [C]
    q_time: torch.Tensor  # [C, Q] int32 arrival us
    q_fields: torch.Tensor  # [C, Q, 16] int32 EV_SEG fields
    q_head: torch.Tensor  # [C]
    q_count: torch.Tensor  # [C]
    q_dropped: torch.Tensor  # [C] ring-overflow drops
    opened: torch.Tensor  # [C] bool
    close_sent: torch.Tensor  # [C] bool
    written: torch.Tensor  # [C]
    read_bytes: torch.Tensor  # [C]
    total: torch.Tensor  # [C] bytes this side must write (reader: 0)
    t_start: torch.Tensor  # [C] us, the active opener's start
    latency_us: torch.Tensor  # [C] one-way latency toward the peer
    loss_u32: torch.Tensor  # [C] Bernoulli threshold toward the peer
    lane_id: torch.Tensor  # [C] global lane index (keys the loss hash)
    iss: torch.Tensor  # [C] int32 initial send sequence (u32 bits)
    conn_t: torch.Tensor  # [C] us, local clock
    complete_us: torch.Tensor  # [C] reader: time the payload was read
    n_segments: torch.Tensor  # [C] wire units emitted
    seg_units: torch.Tensor  # [C] MSS-equivalent segments emitted
    wire_drops: torch.Tensor  # [C]
    unacked: torch.Tensor  # [C] in-order data segments not yet acked
    clock_us: torch.Tensor  # [] window start
    n_saturated: torch.Tensor  # [] windows that hit the step cap


def make_flow_world(latency_us, size_bytes, start_us=None,
                    queue_slots: int = 192, seed: int = 1, loss=0.0,
                    server_writes: bool = False, latency_back_us=None,
                    loss_back=None, device=None) -> FlowWorld:
    """F flows; flow f is the connection pair (2f, 2f+1), `2f` opening
    at start_us[f]. With server_writes=False `2f` writes size_bytes[f]
    and `2f+1` drains; with True the other way round (tgen's fetch).
    `loss` is the per-flow one-way segment loss probability;
    latency_back_us / loss_back give the passive->active direction its
    own path (they default to the forward values). The ISS splitmix and
    the loss thresholds are computed in numpy, as in JAX."""
    dev = resolve_device(device)
    F = len(latency_us)
    C = F * 2
    if start_us is None:
        start_us = np.zeros(F, np.int64)
    if latency_back_us is None:
        latency_back_us = latency_us
    lat = np.empty(C, np.int64)
    lat[0::2] = np.asarray(latency_us, np.int64)
    lat[1::2] = np.asarray(latency_back_us, np.int64)
    total = np.zeros(C, np.int64)
    total[(1 if server_writes else 0)::2] = np.asarray(size_bytes, np.int64)
    t_start = np.full(C, I32_MAX, np.int64)
    t_start[0::2] = np.asarray(start_us, np.int64)
    if loss_back is None:
        loss_back = loss
    loss_pair = np.empty(C, np.float64)
    loss_pair[0::2] = np.broadcast_to(np.asarray(loss, np.float64), (F,))
    loss_pair[1::2] = np.broadcast_to(np.asarray(loss_back, np.float64),
                                      (F,))
    loss_u32 = np.clip(loss_pair * 2.0**32, 0, 2**32 - 1).astype(np.uint32)
    # deterministic per-connection ISS (splitmix32 of the index)
    idx = np.arange(C, dtype=np.uint32)
    with np.errstate(over="ignore"):  # uint32 wraps on purpose
        z = (idx + np.uint32(seed) * np.uint32(0x9E3779B9))
        z = (z ^ (z >> 16)) * np.uint32(0x85EBCA6B)
        z = (z ^ (z >> 13)) * np.uint32(0xC2B2AE35)
    iss = (z ^ (z >> 16)).astype(np.int32)
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                    device=dev)
    zc = lambda: torch.zeros(C, dtype=torch.int32, device=dev)
    return FlowWorld(
        # GSO macro-segment wires produce few disjoint ranges: 32 slots
        plane=dtcp.make_tcp_plane(C, reass_slots=32, device=dev),
        q_time=torch.full((C, queue_slots), I32_MAX, dtype=torch.int32,
                          device=dev),
        q_fields=torch.zeros((C, queue_slots, dtcp.N_FIELDS),
                             dtype=torch.int32, device=dev),
        q_head=zc(), q_count=zc(), q_dropped=zc(),
        opened=torch.zeros(C, dtype=torch.bool, device=dev),
        close_sent=torch.zeros(C, dtype=torch.bool, device=dev),
        written=zc(), read_bytes=zc(), total=i32(total),
        t_start=i32(t_start), latency_us=i32(lat),
        loss_u32=torch.as_tensor(loss_u32.astype(np.int64), device=dev),
        lane_id=torch.arange(C, dtype=torch.int32, device=dev),
        iss=i32(iss), conn_t=zc(),
        complete_us=torch.full((C,), I32_MAX, dtype=torch.int32,
                               device=dev),
        n_segments=zc(), seg_units=zc(), wire_drops=zc(), unacked=zc(),
        clock_us=torch.zeros((), dtype=torch.int32, device=dev),
        n_saturated=torch.zeros((), dtype=torch.int32, device=dev))


def _peer(w):
    return torch.arange(w.conn_t.shape[0], device=w.conn_t.device) ^ 1


def _seg_to_fields(out):
    """PULL output [C, 18] -> EV_SEG fields [C, 16] (drop `has` and the
    retransmit flag)."""
    return torch.cat([out[:, 1:9], out[:, 10:]], dim=1)


def _sched_times(w: FlowWorld):
    """Each connection's earliest scheduled event time [C]: head-of-ring
    arrival, armed timer deadlines, the active opener's start."""
    p = w.plane
    Q = w.q_time.shape[1]
    q_slot = torch.remainder(w.q_head, Q).to(torch.int64)
    arr_t = torch.where(w.q_count > 0,
                        torch.gather(w.q_time, 1, q_slot[:, None])[:, 0],
                        I32_MAX)
    rto_t = torch.where(p.rto_armed, p.rto_deadline_ms * MS_US, I32_MAX)
    tw_t = torch.where(p.state == dtcp.TIME_WAIT, p.rto_deadline_ms * MS_US,
                       I32_MAX)
    ps_t = torch.where(p.persist_armed, p.persist_deadline_ms * MS_US,
                       I32_MAX)
    open_t = torch.where(w.opened, I32_MAX, w.t_start)
    sched_t = torch.minimum(torch.minimum(arr_t, rto_t),
                            torch.minimum(torch.minimum(tw_t, ps_t), open_t))
    return sched_t, arr_t, rto_t, tw_t, ps_t


def _ack_delayed(w: FlowWorld, kind, ack_every: int):
    """The connections that may hold a pure ACK: in-order
    established-state data acks below the coalescing threshold."""
    p = w.plane
    return ((kind == dtcp.K_ACK) & (p.state == dtcp.ESTABLISHED)
            & ~p.fin_received & (p.reass_bytes == 0) & (p.error == 0)
            & (w.unacked >= 1) & (w.unacked < ack_every))


def _pull_wanted(w: FlowWorld, ack_every: int):
    kind = dtcp._next_kind(w.plane)
    return (kind != dtcp.K_NONE) & w.opened & ~_ack_delayed(w, kind,
                                                             ack_every)


def _any_work(w: FlowWorld, window_end, ack_every: int):
    """Does any connection have a scheduled event before the barrier,
    or unsuppressed egress? (a 0-d bool tensor)"""
    sched_t, *_ = _sched_times(w)
    return ((sched_t < window_end) | _pull_wanted(w, ack_every)).any()


def _sched_event(w: FlowWorld, window_end):
    """Process ONE scheduled event a connection (arrival / timer / open),
    each at its own local time. Returns (w', any_active)."""
    p = w.plane
    C = w.conn_t.shape[0]
    Q = w.q_time.shape[1]
    sched_t, arr_t, rto_t, tw_t, ps_t = _sched_times(w)
    active = sched_t < window_end
    t = torch.where(active, torch.maximum(sched_t, w.conn_t), w.conn_t)
    now_ms = floordiv(t, MS_US)

    # priority at equal times: arrival > rto > time-wait > persist > open
    is_arr = active & (sched_t == arr_t)
    is_rto = active & ~is_arr & (sched_t == rto_t)
    is_tw = active & ~is_arr & ~is_rto & (sched_t == tw_t)
    is_ps = active & ~is_arr & ~is_rto & ~is_tw & (sched_t == ps_t)
    is_open = active & ~is_arr & ~is_rto & ~is_tw & ~is_ps

    q_slot = torch.remainder(w.q_head, Q).to(torch.int64)
    arr_f = w.q_fields[torch.arange(C, device=q_slot.device), q_slot]
    # a SYN arriving at an unopened passive side becomes OPEN_PASSIVE
    syn_arrival = is_arr & ~w.opened & ((arr_f[:, 0] & dtcp.SYN) != 0)
    seg_arrival = is_arr & w.opened
    # (a non-SYN arrival at an unopened side is popped and dropped)

    zero_f = torch.zeros_like(arr_f)
    passive_f = torch.cat([torch.stack([
        w.iss, arr_f[:, 1], arr_f[:, 3], arr_f[:, 5], arr_f[:, 6],
        arr_f[:, 7], arr_f[:, 8]], dim=1), zero_f[:, 7:]], dim=1)
    open_f = torch.cat([w.iss[:, None], zero_f[:, 1:]], dim=1)
    gen_f = torch.cat([torch.where(is_ps, p.persist_gen, p.rto_gen)[:, None],
                       zero_f[:, 1:]], dim=1)

    kind = torch.full_like(w.conn_t, dtcp.EV_NONE)
    kind = torch.where(seg_arrival, dtcp.EV_SEG, kind)
    kind = torch.where(syn_arrival, dtcp.EV_OPEN_PASSIVE, kind)
    kind = torch.where(is_rto, dtcp.EV_TIMER_RTO, kind)
    kind = torch.where(is_tw, dtcp.EV_TIMER_TW, kind)
    kind = torch.where(is_ps, dtcp.EV_TIMER_PERSIST, kind)
    kind = torch.where(is_open, dtcp.EV_OPEN_ACTIVE, kind)
    fields = torch.where(seg_arrival[:, None], arr_f, zero_f)
    fields = torch.where(syn_arrival[:, None], passive_f, fields)
    fields = torch.where((is_rto | is_tw | is_ps)[:, None], gen_f, fields)
    fields = torch.where(is_open[:, None], open_f, fields)

    plane = dtcp.tcp_sched_step(p, kind, fields, now_ms)

    opened = w.opened | (kind == dtcp.EV_OPEN_ACTIVE) \
        | (kind == dtcp.EV_OPEN_PASSIVE)
    return w._replace(
        plane=plane, q_head=torch.where(is_arr, w.q_head + 1, w.q_head),
        q_count=torch.where(is_arr, w.q_count - 1, w.q_count),
        opened=opened,
        unacked=w.unacked + (seg_arrival & (arr_f[:, 4] > 0)),
        conn_t=t), active.any()


def _app_phase(w: FlowWorld) -> FlowWorld:
    """The app model at the current local clocks: greedy read,
    buffer-refill write, EOF/done close, as [C] updates."""
    p = w.plane
    now_ms = floordiv(w.conn_t, MS_US)
    healthy = p.error == 0
    state_ok = (p.state == dtcp.ESTABLISHED) | (p.state == dtcp.CLOSE_WAIT)

    # greedy read
    got = torch.where(w.opened, p.ordered_bytes, 0)
    drain = got > 0
    p = p._replace(ordered_bytes=torch.where(drain, 0, p.ordered_bytes),
                   ack_pending=p.ack_pending | drain)
    read_bytes = w.read_bytes + got
    peer_total = w.total[_peer(w)]
    complete_us = torch.where(
        (w.complete_us == I32_MAX) & (read_bytes >= peer_total)
        & (peer_total > 0) & drain, w.conn_t, w.complete_us)

    # buffer-refill write
    n = torch.minimum(dtcp._send_space(p), w.total - w.written)
    do_write = state_ok & healthy & w.opened & (n > 0)
    n = torch.where(do_write, n, 0)
    p = p._replace(stream_len=p.stream_len + n)
    written = w.written + n
    need_persist = (do_write & (p.snd_wnd == 0)
                    & (p.state >= dtcp.ESTABLISHED) & ~p.persist_armed)
    armed = p._replace(persist_gen=p.persist_gen + 1,
                       persist_armed=torch.ones_like(p.persist_armed),
                       persist_deadline_ms=now_ms + p.rto_ms)
    p = dtcp.sel_batched(need_persist, armed, p)

    # close: the writer once everything is accepted; the reader at EOF
    writer_done = written >= w.total
    at_eof = p.fin_received & (p.ordered_bytes == 0) & (p.reass_bytes == 0)
    do_close = (~w.close_sent & w.opened & healthy
                & torch.where(w.total > 0,
                              writer_done & (p.state == dtcp.ESTABLISHED),
                              at_eof & state_ok))
    nxt = torch.where(p.state == dtcp.ESTABLISHED, dtcp.FIN_WAIT_1,
                      torch.where(p.state == dtcp.CLOSE_WAIT, dtcp.LAST_ACK,
                                  p.state))
    p = p._replace(state=torch.where(do_close, nxt, p.state),
                   fin_requested=p.fin_requested | do_close)
    return w._replace(plane=p, read_bytes=read_bytes, written=written,
                      complete_us=complete_us,
                      close_sent=w.close_sent | do_close)


def _wire_draw(idx, counter):
    """Counter-based uniform u32 (as int64): a splitmix-style hash of
    (connection, emission ordinal)."""
    z = (u32(idx) * 0x9E3779B9 + u32(counter) * 0x85EBCA6B
         + 0x6A09E667) & _U32
    z = ((z ^ (z >> 16)) * 0x21F0AAAD) & _U32
    z = ((z ^ (z >> 15)) * 0x735A2D97) & _U32
    return z ^ (z >> 15)


def _pull_once(w: FlowWorld, ack_every: int, gso_segs: int) -> FlowWorld:
    """One iteration of the egress pull loop over every connection."""
    C = w.conn_t.shape[0]
    Q = w.q_time.shape[1]
    MSS = dtcp.MSS
    peer = _peer(w)
    kk = torch.arange(gso_segs, dtype=torch.int32, device=peer.device)
    do = _pull_wanted(w, ack_every)
    p2, out = dtcp.tcp_pull_step(w.plane, floordiv(w.conn_t, MS_US),
                                 gso_segs)
    plane = dtcp.sel_batched(do, p2, w.plane)
    emitted = do & (out[:, 0] != 0)
    paylen = out[:, 5]
    units = torch.clamp(floordiv(paylen + MSS - 1, MSS), min=1)
    draws = _wire_draw(w.lane_id[:, None],
                       w.n_segments[:, None] * gso_segs + kk[None, :])
    unit_lost = ((w.loss_u32 > 0)[:, None] & (draws < w.loss_u32[:, None])
                 & (kk[None, :] < units[:, None]))
    any_lost = unit_lost.any(1)
    f0 = dtcp._first_true(unit_lost).to(torch.int32)
    after0 = unit_lost & (kk[None, :] > f0[:, None])
    f1 = torch.where(after0.any(1), dtcp._first_true(after0).to(torch.int32),
                     units)
    # the surviving runs of the burst ship as (up to) two wire segments:
    # A = units [0, f0), B = units (f0, f1)
    lenA_units = torch.where(any_lost, f0, units)
    lenA = torch.minimum(lenA_units * MSS, paylen)
    startB = (f0 + 1) * MSS
    lenB = torch.where(any_lost, torch.clamp(
        torch.minimum(f1 * MSS, paylen) - startB, min=0), 0)
    lenB_units = floordiv(lenB + MSS - 1, MSS)
    pure = paylen == 0  # ack/SYN/FIN carrier: one all-or-nothing unit
    hasA = emitted & torch.where(pure, ~any_lost, lenA > 0)
    hasB = emitted & (lenB > 0)
    delivered = torch.where(pure, hasA.to(torch.int32),
                            lenA_units + lenB_units)
    seg_f = _seg_to_fields(out)
    segA = seg_f.clone()
    segA[:, 4] = torch.minimum(seg_f[:, 4], lenA)
    segB = seg_f.clone()
    segB[:, 1] = wrap_i32(u32(seg_f[:, 1]) + u32(startB))
    segB[:, 4] = lenB
    p_count = w.q_count[peer]
    p_head = w.q_head[peer]
    roomA = p_count < Q
    slotA = torch.remainder(p_head + p_count, Q)
    occA = (hasA & roomA).to(torch.int32)
    roomB = p_count + occA < Q
    slotB = torch.remainder(p_head + p_count + occA, Q)
    # the one writer into lane d's ring is its peer: gather from it
    arrive = w.conn_t + w.latency_us
    slots = torch.arange(Q, device=peer.device)[None, :]
    inA = (hasA & roomA)[peer]
    inB = (hasB & roomB)[peer]
    atA = inA[:, None] & (slots == slotA[peer][:, None])
    atB = inB[:, None] & (slots == slotB[peer][:, None])
    q_time = torch.where(atA, arrive[peer][:, None], w.q_time)
    q_time = torch.where(atB, arrive[peer][:, None], q_time)
    q_fields = torch.where(atA[:, :, None], segA[peer][:, None, :],
                           w.q_fields)
    q_fields = torch.where(atB[:, :, None], segB[peer][:, None, :],
                           q_fields)
    return w._replace(
        plane=plane, q_time=q_time, q_fields=q_fields,
        q_count=w.q_count + inA + inB,
        q_dropped=w.q_dropped + (hasA & ~roomA) + (hasB & ~roomB),
        wire_drops=w.wire_drops + torch.where(emitted, units - delivered, 0),
        n_segments=w.n_segments + emitted,
        seg_units=w.seg_units + torch.where(emitted, units, 0),
        # every emitted segment carries the current cumulative ack
        unacked=torch.where(emitted, 0, w.unacked))


def _pull_phase(w: FlowWorld, ack_every: int, pull_cap: int,
                gso_segs: int = 1) -> FlowWorld:
    """Drain egress until no connection wants to pull, at most pull_cap
    times (the loop predicate read back to the host)."""
    i, pending = 0, True
    while pending and i < pull_cap:
        w = _pull_once(w, ack_every, gso_segs)
        i += 1
        pending = bool(_pull_wanted(w, ack_every).any())
    return w


def _fused_step(w: FlowWorld, window_end, ack_every: int, sched_batch: int,
                pull_cap: int, gso_segs: int) -> FlowWorld:
    """One fused step: up to sched_batch scheduled events a
    connection (stopping when none is left), the app phase, then the
    egress pull loop."""
    i, alive = 0, True
    while alive and i < sched_batch:
        w, any_active = _sched_event(w, window_end)
        sched_t, *_ = _sched_times(w)
        i += 1
        alive = bool(any_active & (sched_t < window_end).any())
    return _pull_phase(_app_phase(w), ack_every, pull_cap, gso_segs)


def run_windows_plain(world: FlowWorld, n_windows: int, window_us: int,
                      max_events_per_window: int = 512, ack_every: int = 2,
                      sched_batch: int = 8, pull_cap: int = 8,
                      gso_segs: int = 16):
    """Kernel F's function in plain PyTorch: JAX's `run_windows` loop
    structure, its loop predicates read back to the host. Returns
    (world', steps_per_window [n_windows] int32)."""
    w = world
    steps = []
    for _ in range(n_windows):
        end = w.clock_us + window_us
        n = 0
        while n < max_events_per_window and bool(_any_work(w, end,
                                                           ack_every)):
            w = _fused_step(w, end, ack_every, sched_batch, pull_cap,
                            gso_segs)
            n += 1
        saturated = n >= max_events_per_window and bool(
            _any_work(w, end, ack_every))
        # flush delayed acks at the barrier (nothing to flush when the
        # window ran no steps)
        if n > 0:
            w = _pull_phase(w, ack_every=1, pull_cap=pull_cap,
                            gso_segs=gso_segs)
        w = w._replace(clock_us=end, conn_t=torch.maximum(w.conn_t, end),
                       n_saturated=w.n_saturated + int(saturated))
        steps.append(n)
    return w, torch.tensor(steps, dtype=torch.int32,
                           device=w.conn_t.device)


# ---------------------------------------------------------------------------
# kernel F
# ---------------------------------------------------------------------------

#: the order of the pointers the launcher takes: every TcpPlane field,
#: then every FlowWorld field but plane, clock_us and n_saturated
F_PLANE_FIELDS = dtcp.TcpPlane._fields
F_WORLD_FIELDS = tuple(f for f in FlowWorld._fields
                       if f not in ("plane", "clock_us", "n_saturated"))


def _leaf_dtype(owner: str, field: str):
    if owner == "plane":
        if field in dtcp.U32_FIELDS:
            return torch.int64
        return torch.bool if field in dtcp._BOOL_FIELDS else torch.int32
    if field == "loss_u32":
        return torch.int64
    return torch.bool if field in ("opened", "close_sent") else torch.int32


def flow_window_(world: FlowWorld, n_windows: int, window_us: int,
                 max_events_per_window: int = 512, ack_every: int = 2,
                 sched_batch: int = 8, pull_cap: int = 8,
                 gso_segs: int = 16) -> torch.Tensor:
    """Kernel F: advance `world` (CUDA tensors) `n_windows` windows IN
    PLACE with one launch, one thread a flow pair. Returns
    steps_per_window [n_windows] int32. No host read."""
    from .pipeline import _check

    p = world.plane
    C, Q = world.q_time.shape
    RS = p.reass_off.shape[1]
    dev = world.conn_t.device
    if C % 2:
        raise ValueError(f"flow world: {C} lanes is not whole pairs")
    for f in F_PLANE_FIELDS:
        shape = {"reass_off": (C, RS), "reass_len": (C, RS),
                 "sacked_s": (C, dtcp.SACK_SLOTS),
                 "sacked_e": (C, dtcp.SACK_SLOTS)}.get(f, (C,))
        _check(f"plane.{f}", getattr(p, f), _leaf_dtype("plane", f), shape,
               dev)
    for f in F_WORLD_FIELDS:
        shape = {"q_time": (C, Q), "q_fields": (C, Q, dtcp.N_FIELDS)}.get(
            f, (C,))
        _check(f, getattr(world, f), _leaf_dtype("world", f), shape, dev)
    for f in ("clock_us", "n_saturated"):
        _check(f, getattr(world, f), torch.int32, (), dev)
    steps = torch.zeros(n_windows, dtype=torch.int32, device=dev)
    sat = torch.zeros(n_windows, dtype=torch.int32, device=dev)
    if n_windows and C:
        _launch_f(dev, (C // 2, Q, RS, n_windows, int(window_us),
                        int(max_events_per_window), int(ack_every),
                        int(sched_batch), int(pull_cap), int(gso_segs)),
                  _pointers(world, steps, sat))
    world.clock_us.add_(n_windows * int(window_us))
    world.n_saturated.add_(sat.sum().to(torch.int32))
    return steps


def _pointers(world: FlowWorld, steps, sat) -> list[torch.Tensor]:
    """The tensors kernel F takes, in its pointer array's order."""
    return [*(getattr(world.plane, f) for f in F_PLANE_FIELDS),
            *(getattr(world, f) for f in F_WORLD_FIELDS),
            world.clock_us, steps, sat]


def _launch_f(dev, ints, tensors):
    """Launch kernel F on the current stream of `dev`; raise on a
    refused launch."""
    import ctypes

    from .._build import load_kernel

    fn = load_kernel("flow_window").flow_window_launch
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ints, ptrs, len(tensors), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flow_window_kernel: CUDA error {err} at launch")
    LAUNCHES["flow_window"] += 1


def clone_world(world: FlowWorld) -> FlowWorld:
    return FlowWorld(dtcp.TcpPlane(*(t.clone() for t in world.plane)),
                     *(t.clone() for t in world[1:]))


def run_windows(world: FlowWorld, n_windows: int, window_us: int,
                max_events_per_window: int = 512, ack_every: int = 2,
                sched_batch: int = 8, pull_cap: int = 8,
                gso_segs: int = 16):
    """Advance `n_windows` windows of `window_us` each. `window_us` must
    be <= the minimum one-way flow latency. Check `n_saturated` on the
    result (nonzero: the step cap truncated a window; see
    `run_to_completion`). On CUDA tensors one launch of kernel F on a
    copy of the world; on CPU tensors `run_windows_plain`. Returns
    (world', steps_per_window [n_windows] int32)."""
    opts = dict(max_events_per_window=max_events_per_window,
                ack_every=ack_every, sched_batch=sched_batch,
                pull_cap=pull_cap, gso_segs=gso_segs)
    if world.conn_t.device.type == "cpu":
        return run_windows_plain(world, n_windows, window_us, **opts)
    w = clone_world(world)
    return w, flow_window_(w, n_windows, window_us, **opts)


def flow_results(world: FlowWorld) -> dict:
    """The per-flow outcome on the host (only the small per-flow
    columns, never the rings)."""
    complete = world.complete_us.cpu().numpy()
    read = world.read_bytes.cpu().numpy()
    total = world.total.cpu().numpy()
    C = len(complete)
    even, odd = np.arange(0, C, 2), np.arange(1, C, 2)
    # the reader of flow f is the lane whose PEER carries the payload
    reader = np.where(total[even] > 0, odd, even)
    writer = reader ^ 1
    return {
        "complete_us": complete[reader],
        "bytes_read": read[reader],
        "bytes_expected": total[writer],
        "segments": int(world.seg_units.sum()),
        "retransmits": int(world.plane.retransmit_count.sum()),
        "queue_drops": int(world.q_dropped.sum()),
        "wire_drops": int(world.wire_drops.sum()),
        "saturated_windows": int(world.n_saturated),
        "states": world.plane.state.cpu().numpy(),
    }


def _status_flags(world: FlowWorld) -> torch.Tensor:
    """(all_complete, quiescent) as one bool [2] tensor. Quiescent =
    nothing in flight and nothing armed but TIME_WAIT expiries."""
    complete = (world.read_bytes >= world.total[_peer(world)]).all()
    p = world.plane
    settled = (p.state == dtcp.CLOSED) | (p.state == dtcp.TIME_WAIT)
    quiescent = ((world.q_count == 0).all() & (~p.rto_armed).all()
                 & (~p.persist_armed).all() & settled.all()
                 & (~p.ack_pending | (p.state == dtcp.CLOSED)).all())
    return torch.stack([complete, quiescent])


def all_complete(world: FlowWorld) -> bool:
    """Cheap completion probe: one tiny read back."""
    return bool(_status_flags(world)[0])


def finalize_to(world: FlowWorld, stop_us: int) -> FlowWorld:
    """Fast-forward a quiescent world to the stop time: TIME_WAIT lanes
    whose 2MSL deadline falls before it close, clocks jump to it."""
    p = world.plane
    expire = (p.state == dtcp.TIME_WAIT) & (p.rto_deadline_ms * MS_US
                                            <= stop_us)
    stop = torch.full_like(world.clock_us, stop_us)
    return world._replace(
        plane=p._replace(state=torch.where(expire, dtcp.CLOSED, p.state)),
        clock_us=stop, conn_t=torch.maximum(world.conn_t, stop))


def run_to_completion(world: FlowWorld, window_us: int,
                      max_sim_s: float = 40.0, chunk_windows: int = 50,
                      probe_every: int = 2, run_fn=None,
                      max_events_per_window: int = 512, **step_opts):
    """Run chunks of windows until every flow is complete and the world
    quiescent; if any window saturated its step cap, rerun the whole
    run from the initial world with the cap doubled (at most six
    times). The host reads the status every `probe_every` chunks and
    the saturation count at the end, nothing else. `run_fn(world,
    cap)`, when given, replaces `run_windows` for a chunk. Returns
    (world, sim_seconds, retries)."""
    cap = max_events_per_window
    n_chunks = int(max_sim_s * 1e6 / (window_us * chunk_windows)) + 1
    for retry in range(6):
        w = world
        windows = 0
        for i in range(n_chunks):
            if run_fn is None:
                w, _steps = run_windows(w, chunk_windows, window_us,
                                        max_events_per_window=cap,
                                        **step_opts)
            else:
                w, _steps = run_fn(w, cap)
            windows += chunk_windows
            if (i + 1) % probe_every == 0:
                complete, quiescent = _status_flags(w).tolist()
                if complete and quiescent:
                    break
        if int(w.n_saturated) == 0:
            return w, windows * window_us / 1e6, retry
        cap *= 2
    raise RuntimeError(
        f"flow engine still saturating after 6 cap doublings (cap={cap})")


# ---------------------------------------------------------------------------
# pairs never interact, so a world splits on whole pairs
# ---------------------------------------------------------------------------

def split_flow_world(world: FlowWorld, n_shards: int) -> FlowWorld:
    """[C]-leaved world -> [n_shards, C/n_shards]-leaved world, split on
    whole pairs; the 0-d clock replicates and the saturation count rides
    on shard 0 only."""
    C = world.conn_t.shape[0]
    if C % (2 * n_shards):
        raise ValueError(f"{C} lanes not divisible into {n_shards} "
                         f"pair-aligned shards")

    def split(x):
        if x.dim() == 0:
            return x.expand(n_shards).clone()
        return x.reshape((n_shards, C // n_shards) + tuple(x.shape[1:]))

    plane = dtcp.TcpPlane(*(split(x) for x in world.plane))
    out = FlowWorld(plane, *(split(x) for x in world[1:]))
    sat0 = torch.zeros_like(out.n_saturated)
    sat0[0] = world.n_saturated
    return out._replace(n_saturated=sat0)


def merge_flow_world(sharded: FlowWorld) -> FlowWorld:
    """Inverse of split_flow_world; scalar leaves take shard 0 except
    n_saturated, which sums."""

    def merge(x):
        if x.dim() == 1:
            return x[0].clone()
        return x.reshape((-1,) + tuple(x.shape[2:]))

    plane = dtcp.TcpPlane(*(merge(x) for x in sharded.plane))
    out = FlowWorld(plane, *(merge(x) for x in sharded[1:]))
    return out._replace(n_saturated=sharded.n_saturated.sum().to(
        torch.int32))

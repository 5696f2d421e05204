"""The device flow plane: RTO retransmit and congestion backpressure.

Counterpart of `shadow_tpu/tpu/flows.py`, bitwise. A flow is a directed
(src host -> dst host) stream of fixed-size segments, one workload
message a segment. Per flow the plane keeps Reno congestion state, the
RFC 6298 estimator in integer ms, an RTO timer with go-back-N recovery,
and a `recv_wnd`-segment receive bitmap; all of it is a `FlowState` of
[F] tensors (the bitmap [F, recv_wnd]), stepped for every flow at once
by the helpers of `tpu/tcp.py`.

Flow packets ride the plane's payload columns: `sock` is the flow tag
(`(flow + 1) * 2 + kind`, kind 0 data and 1 ack; socks 0 and 1 are never
a tag) and `seq` the segment index (data) or the cumulative ack. A
window's half `flow_recv` reads the delivered dict: in-order arrivals
advance `rcv_nxt` and become the receiver's phase credits, acks advance
the sender. The other half, `flow_emit`, fires expired RTOs and appends
up to `emit_cap` cwnd-gated data segments and one delayed ack a flow
through `plane.ingest`. Time is the window cadence: `clock_ms` advances
by the window each `flow_recv`, with the sub-ms remainder carried.

The JAX package gates both halves on an idle test (`lax.cond`) whose
branches it proves bitwise equal; the port always takes the active
branch, which avoids reading the test back to the host every window.
`flow_emit` takes the guard plane (append conservation) and the flight
recorder (RTO-fired and retransmit hops) as the JAX one does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..guards import plane as guards_plane
from ..telemetry import flightrec as flightrec_mod
from ..telemetry.metrics import add_retransmits
from . import tcp as tcp_mod
from .plane import ingest as plane_ingest
from .prims import I32_MAX, floordiv, floormod, scatter_add_i32, take

#: wire size of an ack segment
ACK_BYTES = 64
#: data segments a flow emits a window at most (cwnd beyond it carries
#: to the next window)
EMIT_CAP = 8
#: receive window in segments: arrivals past it are discarded, and the
#: sender clamps its window to min(cwnd, recv_wnd)
RECV_WND = 64
#: sock values below this are never a flow tag
SOCK_RESERVED = 2


class FlowTables(NamedTuple):
    """Static per-flow tables, axis 0 = flow. `lane_flow` is the [N, P,
    K] flow id of each workload send lane (-1 = none), or None."""

    src: torch.Tensor  # [F] int32 sending host (-1 = inactive slot)
    dst: torch.Tensor  # [F] int32 receiving host
    pkt_bytes: torch.Tensor  # [F] int32 wire bytes per data segment
    lane_flow: torch.Tensor | None = None  # [N, P, K] int32


class FlowState(NamedTuple):
    """Per-flow state, axis 0 = flow; every leaf [F] int32 unless noted.
    Field order and names are the JAX package's (the `tcp` helpers
    `_replace` them)."""

    # sender: segment-index stream offsets
    snd_una: torch.Tensor
    snd_nxt: torch.Tensor
    snd_max: torch.Tensor
    stream_len: torch.Tensor
    # receiver
    rcv_nxt: torch.Tensor
    rcv_bits: torch.Tensor  # [F, recv_wnd] bool, bit 0 == rcv_nxt
    ack_pending: torch.Tensor  # bool
    # Reno
    cwnd: torch.Tensor
    ssthresh: torch.Tensor
    phase: torch.Tensor
    dup_acks: torch.Tensor
    avoid_acked: torch.Tensor
    # RFC 6298 estimator
    srtt_ms: torch.Tensor
    rttvar_ms: torch.Tensor
    rto_ms: torch.Tensor
    backoff_count: torch.Tensor
    # RTO timer
    rto_gen: torch.Tensor
    rto_armed: torch.Tensor  # bool
    rto_deadline_ms: torch.Tensor  # absolute virtual ms
    # one-segment RTT probe
    rtt_seq: torch.Tensor  # -1 = none
    rtt_sent_ms: torch.Tensor
    # cumulative counters (int32, modular)
    retransmit_count: torch.Tensor
    retransmitted_bytes: torch.Tensor
    rto_fired: torch.Tensor
    # virtual clock at the end of the last window, and its sub-ms carry
    clock_ms: torch.Tensor
    clock_rem_ns: torch.Tensor


def make_flow_tables(src, dst, pkt_bytes, lane_flow=None, *,
                     device=None) -> FlowTables:
    """Upload the flow tables (copies: a later edit of the numpy program
    never reaches the device)."""
    device = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return FlowTables(src=t(src), dst=t(dst), pkt_bytes=t(pkt_bytes),
                      lane_flow=t(lane_flow) if lane_flow is not None
                      else None)


def make_flow_state(n_flows: int, recv_wnd: int = RECV_WND, *,
                    device=None) -> FlowState:
    """Fresh state: empty streams, the initial cwnd and RTO."""
    device = resolve_device(device)
    full = lambda v: torch.full((n_flows,), v, dtype=torch.int32,
                                device=device)
    z = lambda: full(0)
    f = lambda: torch.zeros(n_flows, dtype=torch.bool, device=device)
    return FlowState(
        snd_una=z(), snd_nxt=z(), snd_max=z(), stream_len=z(),
        rcv_nxt=z(),
        rcv_bits=torch.zeros((n_flows, recv_wnd), dtype=torch.bool,
                             device=device),
        ack_pending=f(),
        cwnd=full(tcp_mod.INITIAL_CWND),
        ssthresh=full(tcp_mod.SSTHRESH_INF),
        phase=z(), dup_acks=z(), avoid_acked=z(),
        srtt_ms=z(), rttvar_ms=z(), rto_ms=full(tcp_mod.RTO_INIT_MS),
        backoff_count=z(),
        rto_gen=z(), rto_armed=f(), rto_deadline_ms=z(),
        rtt_seq=full(-1), rtt_sent_ms=z(),
        retransmit_count=z(), retransmitted_bytes=z(), rto_fired=z(),
        clock_ms=z(), clock_rem_ns=z(),
    )


def data_tag(flow_idx):
    """The `sock` tag of flow `flow_idx`'s data segments."""
    return (flow_idx + 1) * 2


def ack_tag(flow_idx):
    """The `sock` tag of flow `flow_idx`'s cumulative acks."""
    return (flow_idx + 1) * 2 + 1


def _scatter_max(n: int, fill: int, idx, values) -> torch.Tensor:
    """[n] int32 maxima of `values` at `idx` over a `fill` start, index
    n dropped (the JAX `.at[].max(mode="drop")`)."""
    out = torch.full((n + 1,), fill, dtype=torch.int32, device=idx.device)
    out = out.scatter_reduce(0, idx.reshape(-1).to(torch.int64),
                             values.reshape(-1).to(torch.int32), "amax",
                             include_self=True)
    return out[:n]


def enqueue(ft: FlowTables, fs: FlowState, flow_ids, valid) -> FlowState:
    """Extend each flow's stream by one segment per valid lane whose
    flow id is >= 0 (any shape)."""
    F = ft.src.shape[0]
    ids = torch.where(valid & (flow_ids >= 0), flow_ids, F)
    return fs._replace(stream_len=fs.stream_len + scatter_add_i32(
        F, ids, torch.ones_like(ids)))


# -- per-flow handlers, batched over flows ----------------------------------


def _ack_one(s: FlowState, ack_val) -> FlowState:
    """One cumulative ack a flow (-1 = none): Reno advance, the
    Karn-gated RTT sample from the probe, backoff reset, RTO re-armed
    while data is in flight, else disarmed."""
    now_ms = s.clock_ms
    has = ack_val > s.snd_una
    n_seg = torch.clamp(ack_val - s.snd_una, min=0)
    a = tcp_mod._cong_new_ack(s, n_seg)
    a = a._replace(snd_una=torch.minimum(ack_val, a.stream_len))
    a = a._replace(snd_nxt=torch.maximum(a.snd_nxt, a.snd_una))
    take_rtt = (a.rtt_seq >= 0) & (ack_val > a.rtt_seq)
    sampled = tcp_mod._rtt_update(a, now_ms - a.rtt_sent_ms)
    a = tcp_mod.sel_batched(take_rtt & (a.backoff_count == 0), sampled, a)
    a = a._replace(rtt_seq=torch.where(take_rtt, -1, a.rtt_seq))
    a = tcp_mod._rtt_reset_backoff(a)
    in_flight = a.snd_nxt > a.snd_una
    a = tcp_mod.sel_batched(in_flight, tcp_mod._arm_rto(a, now_ms),
                     tcp_mod._disarm_rto(a))
    return tcp_mod.sel_batched(has, a, s)


def _rto_one(s: FlowState) -> FlowState:
    """An expired RTO: backoff, Reno timeout, go-back-N rewind, the probe
    abandoned, the timer re-armed (callers select with `fired`)."""
    b = tcp_mod._rtt_backoff(s)
    b = tcp_mod._cong_timeout(b)
    b = b._replace(snd_nxt=b.snd_una, rtt_seq=torch.full_like(b.rtt_seq, -1),
                   rto_fired=b.rto_fired + 1)
    return tcp_mod._arm_rto(b, s.clock_ms)


# -- the window halves -------------------------------------------------------


def flow_recv(ft: FlowTables, fs: FlowState, delivered, window_ns):
    """Consume one window's `delivered` dict: advance the flow clock by
    the window, fold data arrivals into the receive bitmaps and advance
    `rcv_nxt` through the leading run, arm delayed acks, and fold the
    cumulative acks into the senders. Returns (fs', credits): `credits`
    [N] int32 is each receiving host's count of new in-order segments.
    Reads `delivered` only."""
    F = ft.src.shape[0]
    W = fs.rcv_bits.shape[1]
    N, _CI = delivered["mask"].shape
    dev = ft.src.device
    total_ns = fs.clock_rem_ns + window_ns
    fs = fs._replace(clock_ms=fs.clock_ms + floordiv(total_ns, 1_000_000),
                     clock_rem_ns=floormod(total_ns, 1_000_000))

    mask, sock = delivered["mask"], delivered["sock"]
    seq, psrc = delivered["seq"], delivered["src"]
    rows = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    f_id = (sock >> 1) - 1
    kind_ack = (sock & 1) == 1
    tagged = mask & (sock >= SOCK_RESERVED) & (f_id < F)
    f_safe = torch.clamp(f_id, 0, F - 1)
    fi = f_safe.to(torch.int64)
    # a tag counts only when the packet's (row, src) are the flow's ends
    is_data = (tagged & ~kind_ack & (ft.dst[fi] == rows)
               & (ft.src[fi] == psrc))
    is_ackp = (tagged & kind_ack & (ft.src[fi] == rows)
               & (ft.dst[fi] == psrc))

    # receiver: arrivals inside the window set their bit (duplicates
    # set it again); rcv_nxt advances through the leading run of set
    # bits, and the bitmap shifts so bit 0 tracks it
    off = seq - fs.rcv_nxt[fi]
    in_wnd = is_data & (off >= 0) & (off < W)
    flat_idx = torch.where(in_wnd, f_safe * W + off, F * W)
    present = _scatter_max(F * W, 0, flat_idx,
                           torch.ones_like(flat_idx)).reshape(F, W)
    bits = fs.rcv_bits | (present != 0)
    adv = bits.to(torch.int32).cummin(dim=1).values.sum(dim=1,
                                                        dtype=torch.int32)
    shift_idx = torch.arange(W, dtype=torch.int32, device=dev)[None, :] \
        + adv[:, None]
    bits_shifted = take(bits, torch.clamp(shift_idx, 0, W - 1).to(
        torch.int64)) & (shift_idx < W)
    # any data arrival (in order, duplicate or past the window) re-arms
    # the delayed ack
    any_data = scatter_add_i32(F, torch.where(is_data, f_safe, F),
                            torch.ones_like(f_safe)) > 0
    fs = fs._replace(rcv_nxt=fs.rcv_nxt + adv, rcv_bits=bits_shifted,
                     ack_pending=fs.ack_pending | any_data)
    credits = scatter_add_i32(N, torch.where(ft.src >= 0, ft.dst, N), adv)

    # sender: the cumulative ack is the largest delivered ack value
    ack_val = _scatter_max(F, -1, torch.where(is_ackp, f_safe, F),
                           torch.where(is_ackp, seq, -1))
    return _ack_one(fs, ack_val), credits


def flow_emit(ft: FlowTables, fs: FlowState, state, *,
              emit_cap: int = EMIT_CAP, metrics=None, guards=None,
              flightrec=None):
    """Fire expired RTO deadlines (go-back-N with backoff), then append
    this window's sends, up to `emit_cap` cwnd-gated data segments and
    one delayed cumulative ack a flow, through one `plane.ingest` (data
    lanes flow-major, then the acks; `seq` is both seq and priority).
    `metrics` takes the append's ring-full drops and the sending hosts'
    retransmitted segments; `guards` checks the append's conservation;
    `flightrec` records an `rto_fired` hop (seq = the snd_una the timer
    guarded) and a `retransmit` hop a sampled segment, with the packet's
    own (src, seq) identity. Returns (state', fs'[, metrics'][,
    guards'][, flightrec'])."""
    F = ft.src.shape[0]
    W = fs.rcv_bits.shape[1]
    N = state.eg_dst.shape[0]
    dev = ft.src.device
    active = ft.src >= 0
    now_ms = fs.clock_ms

    una_before = fs.snd_una
    fired = (fs.rto_armed & active & (fs.snd_nxt > fs.snd_una)
             & (now_ms >= fs.rto_deadline_ms))
    fs = tcp_mod.sel_batched(fired, _rto_one(fs), fs)

    wnd = torch.clamp(fs.cwnd, max=W)
    limit = torch.minimum(fs.stream_len, fs.snd_una + wnd)
    n_emit = torch.where(active,
                         torch.clamp(limit - fs.snd_nxt, 0, emit_cap), 0)
    lane = torch.arange(emit_cap, dtype=torch.int32, device=dev)[None, :]
    emit_seq = fs.snd_nxt[:, None] + lane
    data_valid = lane < n_emit[:, None]
    retx_lane = data_valid & (emit_seq < fs.snd_max[:, None])
    retx_n = retx_lane.sum(dim=1, dtype=torch.int32)
    retx_b = torch.where(retx_lane, ft.pkt_bytes[:, None], 0).sum(
        dim=1, dtype=torch.int32)
    new_nxt = fs.snd_nxt + n_emit
    # the RTT probe times the batch's first never-sent segment (Karn:
    # not while backed off, never a retransmission)
    probe = ((fs.rtt_seq < 0) & (n_emit > 0) & (fs.backoff_count == 0)
             & (fs.snd_nxt >= fs.snd_max))
    arm = (n_emit > 0) & ~fs.rto_armed
    ack_valid = fs.ack_pending & active
    fs = fs._replace(
        snd_nxt=new_nxt,
        snd_max=torch.maximum(fs.snd_max, new_nxt),
        rtt_seq=torch.where(probe, fs.snd_nxt, fs.rtt_seq),
        rtt_sent_ms=torch.where(probe, now_ms, fs.rtt_sent_ms),
        retransmit_count=fs.retransmit_count + retx_n,
        retransmitted_bytes=fs.retransmitted_bytes + retx_b,
        rto_gen=fs.rto_gen + arm.to(torch.int32),
        rto_armed=fs.rto_armed | arm,
        rto_deadline_ms=torch.where(arm, now_ms + fs.rto_ms,
                                    fs.rto_deadline_ms),
        ack_pending=fs.ack_pending & ~ack_valid,
    )

    flow_idx = torch.arange(F, dtype=torch.int32, device=dev)
    rep = lambda a: torch.repeat_interleave(a, emit_cap)
    cat = lambda a, b: torch.cat([a, b])
    src_b = cat(rep(ft.src), ft.dst)
    valid_b = cat(data_valid.reshape(-1), ack_valid)
    seq_b = cat(emit_seq.reshape(-1), fs.rcv_nxt)
    if guards is not None:
        pre_occ = state.eg_valid.sum(dim=1, dtype=torch.int32)
    pre_ovf = state.n_overflow_dropped
    # an append with no valid lane is the identity, so the JAX idle gate
    # is not taken
    state = plane_ingest(
        state, src_b, cat(rep(ft.dst), ft.src),
        cat(rep(ft.pkt_bytes), torch.full_like(ft.src, ACK_BYTES)),
        seq_b, seq_b, torch.zeros_like(valid_b), valid=valid_b,
        sock=cat(rep(data_tag(flow_idx)), ack_tag(flow_idx)))
    ovf_delta = state.n_overflow_dropped - pre_ovf
    out = (state, fs)
    if metrics is not None:
        per_host = scatter_add_i32(N, torch.where(active, ft.src, N), retx_n)
        out += (add_retransmits(metrics._replace(
            drop_ring_full=metrics.drop_ring_full + ovf_delta), per_host),)
    if guards is not None:
        incoming = scatter_add_i32(
            N, torch.where(valid_b, torch.clamp(src_b, 0, N - 1), N),
            torch.ones_like(src_b))
        out += (guards_plane.check_ingest(
            guards, occ_before=pre_occ,
            occ_after=state.eg_valid.sum(dim=1, dtype=torch.int32),
            incoming=incoming, overflow=ovf_delta),)
    if flightrec is not None:
        src_d = rep(ft.src)
        samp = flightrec_mod.sample_mask(
            flightrec, cat(ft.src, src_d), cat(una_before,
                                               emit_seq.reshape(-1)))
        n_all = F + F * emit_cap
        kind = torch.full((n_all,), flightrec_mod.HOP_RETRANSMIT,
                          dtype=torch.int32, device=dev)
        kind[:F] = flightrec_mod.HOP_RTO_FIRED
        out += (flightrec_mod.record_events(
            flightrec, kind, cat(ft.src, src_d),
            cat(una_before, emit_seq.reshape(-1)), cat(ft.dst, rep(ft.dst)),
            torch.zeros(n_all, dtype=torch.int32, device=dev),
            cat(fired, retx_lane.reshape(-1)) & samp),)
    return out


def flow_step(ft: FlowTables, fs: FlowState, state, delivered, window_ns,
              *, emit_cap: int = EMIT_CAP, metrics=None, guards=None,
              flightrec=None):
    """`flow_recv` then `flow_emit`, the form `window_step(flows=)`
    runs. Returns (state', fs', credits[, metrics'][, guards'][,
    flightrec'])."""
    fs, credits = flow_recv(ft, fs, delivered, window_ns)
    out = flow_emit(ft, fs, state, emit_cap=emit_cap, metrics=metrics,
                    guards=guards, flightrec=flightrec)
    return (out[0], out[1], credits, *out[2:])


def next_deadline_rel_ns(ft: FlowTables, fs: FlowState) -> torch.Tensor:
    """The earliest pending RTO deadline in ns after the flow clock, as a
    0-d int32 tensor: 0 when already due, I32_MAX when no armed timer
    guards outstanding data; a far deadline is clamped to the int32
    budget."""
    active = (ft.src >= 0) & fs.rto_armed & (fs.snd_nxt > fs.snd_una)
    rel_ms = torch.clamp(fs.rto_deadline_ms - fs.clock_ms, 0,
                         (I32_MAX // 2) // 1_000_000)
    rel = torch.where(active, rel_ms * 1_000_000 - fs.clock_rem_ns,
                      I32_MAX)
    return torch.clamp(rel.amin(), min=0).to(torch.int32)


# -- host-side reports --------------------------------------------------------


def retransmits_by_host(ft: FlowTables, fs: FlowState,
                        n_hosts: int) -> torch.Tensor:
    """[N] cumulative retransmitted segments by sending host."""
    return scatter_add_i32(n_hosts, torch.where(ft.src >= 0, ft.src, n_hosts),
                        fs.retransmit_count)


def flow_totals(ft: FlowTables, fs: FlowState) -> dict:
    """Fleet totals for a run record (reads the tensors to the host)."""
    active = ft.src.detach().cpu().numpy() >= 0
    g = lambda t: int(t.detach().cpu().numpy()[active].astype(np.int64)
                      .sum())
    return {
        "flows": int(active.sum()),
        "segments_enqueued": g(fs.stream_len),
        "segments_acked": g(fs.snd_una),
        "retransmits": g(fs.retransmit_count),
        "retransmitted_bytes": g(fs.retransmitted_bytes),
        "rto_fired": g(fs.rto_fired),
    }

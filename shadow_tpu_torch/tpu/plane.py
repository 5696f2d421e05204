"""Batched network-plane state, the per-window step and the window
chain, in PyTorch.

The port of `shadow_tpu/tpu/plane.py`: the params/state SoA, the flat
and row-shaped egress appends, `window_step` (packed sort keys) with
three kernels, and `chain_windows`. The fused pair A and B
(`kernel="pallas_fused"`) and the split pair C and D (`kernel="pallas"`)
run the CUDA kernels of `tpu/pipeline.py`, FIFO only; `kernel="xla"`,
the default as in the JAX package, runs every stage in PyTorch with no
kernel of the port (the split pair's plain versions) and adds the
round-robin qdisc (`rr_enabled=True`). The router AQM
(`router_aqm=True`: CoDel and the down-bandwidth relay on the
destination side) follows the routing stage of all three kernels and
runs kernel E (`codel.router_drain`) on CUDA tensors. The metrics plane
rides all three kernels; the fault, guard, histogram and
flight-recorder planes and the flow and compute planes ride the XLA
path only, as in the JAX package. `unpack_planes` splits what they
append.

Every result is bitwise the JAX plane's `window_step` with the same
kernel: int32 state, int32 arithmetic that wraps where the JAX plane's
does, and the float32 loss and corruption draws computed from the same
threefry bits. Sorts that the JAX plane runs outside its Pallas kernels
stay `torch.sort` (stable) on composite int64 keys that give the same
permutation. Nothing in `window_step` reads a tensor back to the host;
`chain_windows` reads one small tensor a chained window.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..faults.plane import FaultArrays
from ..guards import plane as guards_plane
from ..guards.plane import GuardState
from ..telemetry import flightrec as flightrec_mod
from ..telemetry import histo
from ..telemetry.flightrec import FlightRecArrays
from ..telemetry.histo import PlaneHistograms
from ..telemetry.metrics import PlaneMetrics
from . import codel
from . import compute as compute_mod
from .prims import (_SIGN32, I32_MAX, NO_CLAMP, _pack_rank_key,
                    _pack_time_key, _pkt_uniform, _row_perm_sort, floordiv,
                    floormod, scatter_add_i32, take, u32, wrap_i32)

# per-host socket-slot space of the round-robin qdisc's counters
RR_SOCK_SLOTS = 16


class NetPlaneParams(NamedTuple):
    """Static per-simulation data (node-level [M, M] path tables and a
    [N] host -> node map)."""

    latency_ns: torch.Tensor  # [M, M] int32
    loss: torch.Tensor  # [M, M] float32
    host_node: torch.Tensor  # [N] int32
    tb_rate: torch.Tensor  # [N] int32 egress bytes per millisecond
    tb_cap: torch.Tensor  # [N] int32 bucket capacity
    qdisc_rr: torch.Tensor  # [N] bool
    dn_rate: torch.Tensor  # [N] int32 ingress bytes per millisecond
    dn_cap: torch.Tensor  # [N] int32


class NetPlaneState(NamedTuple):
    """Mutable SoA state, axis 0 = host; field order is the JAX plane's."""

    # egress queues [N, CE]
    eg_dst: torch.Tensor
    eg_bytes: torch.Tensor
    eg_prio: torch.Tensor
    eg_seq: torch.Tensor
    eg_ctrl: torch.Tensor  # bool
    eg_tsend: torch.Tensor
    eg_clamp: torch.Tensor
    eg_sock: torch.Tensor
    eg_valid: torch.Tensor  # bool
    # ingress queues [N, CI]
    in_src: torch.Tensor
    in_bytes: torch.Tensor
    in_seq: torch.Tensor
    in_sock: torch.Tensor
    in_deliver_rel: torch.Tensor
    in_valid: torch.Tensor  # bool
    # per host [N]
    tb_balance: torch.Tensor
    tb_rem_ns: torch.Tensor
    rng_counter: torch.Tensor
    rr_sent: torch.Tensor  # [N, RR_SOCK_SLOTS]
    router: codel.RouterDownState
    n_sent: torch.Tensor
    n_loss_dropped: torch.Tensor
    n_overflow_dropped: torch.Tensor
    n_delivered: torch.Tensor
    n_fault_dropped: torch.Tensor


def make_params(latency_ns, loss, up_bw_bps, mtu: int = 1500,
                qdisc_rr=None, down_bw_bps=None, host_node=None, *,
                device=None) -> NetPlaneParams:
    """Params from node-level [M, M] latency/loss tables and per-host
    up-bandwidths in bits/s; `host_node` None means host-pair tables."""
    device = resolve_device(device)
    lat = np.asarray(latency_ns)
    if lat.size and (lat.min() < 0 or lat.max() > (2**31 - 1) // 2):
        raise ValueError(
            f"latency_ns out of the device budget [0, I32_MAX//2 ns]: "
            f"min={lat.min()}, max={lat.max()}")
    # per-ms rate capped at 2^30 - mtu so the refill arithmetic stays
    # inside int32
    rate = np.minimum(
        np.maximum(1, (np.asarray(up_bw_bps) // 8) // 1000), 2**30 - mtu
    ).astype(np.int32)
    if host_node is None:
        host_node = np.arange(lat.shape[0], dtype=np.int32)
    n = np.asarray(host_node).shape[0]
    rate = np.broadcast_to(rate, (n,))
    if down_bw_bps is None:
        dn_rate = np.full(n, 2**30 - mtu, np.int32)
    else:
        dn_rate = np.broadcast_to(np.minimum(
            np.maximum(1, (np.asarray(down_bw_bps) // 8) // 1000),
            2**30 - mtu).astype(np.int32), (n,))
    t = lambda a, dt: torch.as_tensor(np.array(a, dt), device=device)
    return NetPlaneParams(
        latency_ns=t(lat, np.int32),
        loss=t(loss, np.float32),
        host_node=t(host_node, np.int32),
        tb_rate=t(rate, np.int32),
        tb_cap=t(rate + mtu, np.int32),
        qdisc_rr=(t(qdisc_rr, bool) if qdisc_rr is not None
                  else torch.zeros(n, dtype=torch.bool, device=device)),
        dn_rate=t(dn_rate, np.int32),
        dn_cap=t(dn_rate + mtu, np.int32),
    )


def make_state(n_hosts: int, egress_cap: int = 32, ingress_cap: int = 64,
               initial_tokens=None, initial_dn_tokens=None,
               params: NetPlaneParams | None = None, *,
               device=None) -> NetPlaneState:
    """Empty rings with the canonical dead-lane fills (-1 dst/src,
    I32_MAX priority and deliver, NO_CLAMP). `params` starts the
    down-bandwidth bucket full, like the JAX plane."""
    device = resolve_device(device)
    if initial_dn_tokens is None and params is not None:
        initial_dn_tokens = params.dn_cap
    N, CE, CI = n_hosts, egress_cap, ingress_cap
    i32 = dict(dtype=torch.int32, device=device)
    z = lambda *shape: torch.zeros(shape, **i32)
    full = lambda shape, v: torch.full(shape, v, **i32)
    as_i32 = lambda a: torch.as_tensor(a).to(**i32).clone()
    return NetPlaneState(
        eg_dst=full((N, CE), -1),
        eg_bytes=z(N, CE),
        eg_prio=full((N, CE), I32_MAX),
        eg_seq=z(N, CE),
        eg_ctrl=torch.zeros(N, CE, dtype=torch.bool, device=device),
        eg_tsend=z(N, CE),
        eg_clamp=full((N, CE), NO_CLAMP),
        eg_sock=z(N, CE),
        eg_valid=torch.zeros(N, CE, dtype=torch.bool, device=device),
        in_src=full((N, CI), -1),
        in_bytes=z(N, CI),
        in_seq=z(N, CI),
        in_sock=z(N, CI),
        in_deliver_rel=full((N, CI), I32_MAX),
        in_valid=torch.zeros(N, CI, dtype=torch.bool, device=device),
        tb_balance=(as_i32(initial_tokens) if initial_tokens is not None
                    else z(N)),
        tb_rem_ns=z(N),
        rng_counter=z(N),
        rr_sent=z(N, RR_SOCK_SLOTS),
        router=codel.make_router_state(
            N, (as_i32(initial_dn_tokens) if initial_dn_tokens is not None
                else None), device=device),
        n_sent=z(N),
        n_loss_dropped=z(N),
        n_overflow_dropped=z(N),
        n_delivered=z(N),
        n_fault_dropped=z(N),
    )


def _arange(n: int, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def ingest(state: NetPlaneState, src, dst, nbytes, prio, seq, ctrl,
           valid=None, send_rel=None, clamp_rel=None, sock=None, *,
           metrics: PlaneMetrics | None = None,
           guards: GuardState | None = None):
    """Append a flat batch of packets ([B] tensors, src = emitting host)
    to the egress rings after each row's valid entries, in (src, seq,
    batch position) order; what overflows a row is counted and dropped.
    The JAX plane's packed bucketed append: one stable sort on the
    composite key (src << 32 | seq ^ SIGN), binary-searched row bounds,
    and one stacked gather of the payload columns. With `metrics` the
    overflow also lands in `drop_ring_full`; `guards` checks that each
    row gained its incoming packets less the overflow. Returns the bare
    state without them, else (state'[, metrics'][, guards'])."""
    N, CE = state.eg_dst.shape
    if valid is not None:
        src = torch.where(valid, src, N)
    if send_rel is None:
        send_rel = torch.zeros_like(seq)
    if clamp_rel is None:
        clamp_rel = torch.full_like(seq, NO_CLAMP)
    if sock is None:
        sock = torch.zeros_like(seq)

    n_valid = state.eg_valid.sum(dim=1, dtype=torch.int32)
    B = src.shape[0]
    src_b = torch.where((src >= 0) & (src < N), src, N).to(torch.int64)
    o_key, o_pos = torch.sort((src_b << 32) | (u32(seq) ^ _SIGN32),
                              stable=True)
    bounds = torch.searchsorted(o_key >> 32, _arange(N + 1, src_b,
                                                     torch.int64))
    offsets = bounds[:-1].to(torch.int32)
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    take_n = torch.minimum(counts, CE - n_valid)
    overflow = torch.clamp(counts + n_valid - CE, min=0)
    i32 = lambda a: a.to(torch.int32)
    flat = lambda a: i32(a).reshape(-1)
    streams = torch.stack([
        dst[o_pos], nbytes[o_pos], prio[o_pos], seq[o_pos],
        i32(ctrl[o_pos]), send_rel[o_pos], clamp_rel[o_pos], sock[o_pos],
        torch.ones(B, dtype=torch.int32, device=src.device)])
    bases = torch.stack([
        flat(state.eg_dst), flat(state.eg_bytes), flat(state.eg_prio),
        flat(state.eg_seq), flat(state.eg_ctrl), flat(state.eg_tsend),
        flat(state.eg_clamp), flat(state.eg_sock), flat(state.eg_valid)])
    combined = torch.cat([bases, streams], dim=1)
    ce_col = _arange(CE, src)[None, :]
    nv = n_valid[:, None]
    append = (ce_col >= nv) & (ce_col < nv + take_n[:, None])
    stream_idx = torch.clamp(offsets[:, None] + ce_col - nv, 0, B - 1)
    rows = _arange(N, src)[:, None]
    gidx = torch.where(append, N * CE + stream_idx, rows * CE + ce_col)
    (eg_dst, eg_bytes, eg_prio, eg_seq, eg_ctrl_i, eg_tsend, eg_clamp,
     eg_sock, eg_valid_i) = combined[:, gidx.to(torch.int64)]
    new_state = state._replace(
        eg_dst=eg_dst, eg_bytes=eg_bytes, eg_prio=eg_prio, eg_seq=eg_seq,
        eg_ctrl=eg_ctrl_i != 0, eg_tsend=eg_tsend, eg_clamp=eg_clamp,
        eg_sock=eg_sock, eg_valid=eg_valid_i != 0,
        n_overflow_dropped=state.n_overflow_dropped + overflow,
    )
    out = (new_state,)
    if metrics is not None:
        out += (metrics._replace(
            drop_ring_full=metrics.drop_ring_full + overflow),)
    if guards is not None:
        out += (guards_plane.check_ingest(
            guards, occ_before=n_valid,
            occ_after=new_state.eg_valid.sum(dim=1, dtype=torch.int32),
            incoming=counts, overflow=overflow),)
    return out if len(out) > 1 else new_state


def ingest_rows(state: NetPlaneState, dst, nbytes, prio, seq, ctrl, valid,
                send_rel=None, clamp_rel=None, sock=None, *,
                metrics: PlaneMetrics | None = None,
                guards: GuardState | None = None,
                hist: PlaneHistograms | None = None,
                flightrec: FlightRecArrays | None = None):
    """Append per-host batches ([N, K] tensors, row = emitting host)
    after each row's existing entries, in column order: the packed
    single-key merge (validity | column rank). The JAX plane's idle gate
    is not taken; the merge of an entry-free batch is the identity
    (SL505), and skipping the gate avoids a host read.

    `metrics` adds the overflow to `drop_ring_full`; `guards` checks
    append conservation; `hist` samples the post-append egress occupancy
    into `hist_qdepth`; `flightrec` records an `ingest` hop for each
    sampled packet the rings accepted (the first free-slots valid
    entries of a row), stamped with the coming window. None touches the
    state. Returns the bare state without them, else (state'[,
    metrics'][, guards'][, hist'][, flightrec']) in the JAX plane's
    order."""
    N, CE = state.eg_dst.shape
    if send_rel is None:
        send_rel = torch.zeros_like(seq)
    if clamp_rel is None:
        clamp_rel = torch.full_like(seq, NO_CLAMP)
    if sock is None:
        sock = torch.zeros_like(seq)
    cat = lambda a, b: torch.cat([a, b], dim=1)
    valid_all = cat(state.eg_valid, valid)
    W = valid_all.shape[1]
    rank = _arange(W, valid, torch.int64).expand(N, W)
    key = torch.sort(_pack_rank_key(valid_all, rank, W), dim=1).values
    perm = (key & 0x7FFFFFFF)[:, :CE]
    tk = lambda a, b: take(cat(a, b), perm)
    overflow = torch.clamp(valid_all.sum(dim=1, dtype=torch.int32) - CE,
                           min=0)
    new_state = state._replace(
        eg_dst=tk(state.eg_dst, dst), eg_bytes=tk(state.eg_bytes, nbytes),
        eg_prio=tk(state.eg_prio, prio), eg_seq=tk(state.eg_seq, seq),
        eg_ctrl=tk(state.eg_ctrl, ctrl),
        eg_tsend=tk(state.eg_tsend, send_rel),
        eg_clamp=tk(state.eg_clamp, clamp_rel),
        eg_sock=tk(state.eg_sock, sock),
        eg_valid=tk(state.eg_valid, valid),
        n_overflow_dropped=state.n_overflow_dropped + overflow,
    )
    if guards is not None or flightrec is not None:
        occ_before = state.eg_valid.sum(dim=1, dtype=torch.int32)
    out = (new_state,)
    if metrics is not None:
        out += (metrics._replace(
            drop_ring_full=metrics.drop_ring_full + overflow),)
    if guards is not None:
        out += (guards_plane.check_ingest(
            guards, occ_before=occ_before,
            occ_after=new_state.eg_valid.sum(dim=1, dtype=torch.int32),
            incoming=valid.sum(dim=1, dtype=torch.int32),
            overflow=overflow),)
    if hist is not None:
        out += (hist._replace(hist_qdepth=histo.accum_depth(
            hist.hist_qdepth,
            new_state.eg_valid.sum(dim=1, dtype=torch.int32))),)
    if flightrec is not None:
        rows = _arange(N, valid)[:, None].expand(valid.shape)
        valid_i = valid.to(torch.int32)
        new_rank = torch.cumsum(valid_i, dim=1, dtype=torch.int32) - valid_i
        accepted = valid & (new_rank < (CE - occ_before)[:, None])
        samp = flightrec_mod.sample_mask(flightrec, rows, seq)
        out += (flightrec_mod.record_events(
            flightrec,
            torch.full((valid.numel(),), flightrec_mod.HOP_INGEST,
                       dtype=torch.int32, device=valid.device),
            rows.reshape(-1), seq.reshape(-1), dst.reshape(-1),
            send_rel.reshape(-1), (accepted & samp).reshape(-1)),)
    return out if len(out) > 1 else new_state


_UNSET = object()


def unpack_planes(out, *, metrics=None, guards=None, hist=None,
                  flightrec=None, flows=_UNSET, compute=_UNSET,
                  n_lead=3):
    """Split a `window_step` (n_lead=3) or `ingest_rows` (n_lead=1)
    output into its lead values and the presence planes' outputs, in the
    order both append them: metrics, guards, hist, flightrec[, flows][,
    compute]. Pass the presence values the call received: each non-None
    plane comes back as its output, each None stays None. Passing
    `flows` or `compute` (even None) adds its slot to the return."""
    if type(out) is not tuple:
        # a bare state (ingest_rows with no planes) is itself a
        # NamedTuple, so the test is on the exact type
        out = (out,)
    lead, rest = out[:n_lead], list(out[n_lead:])
    want = [metrics, guards, hist, flightrec]
    if flows is not _UNSET:
        want.append(flows)
    if compute is not _UNSET:
        want.append(compute)
    planes = tuple(rest.pop(0) if p is not None else None for p in want)
    if rest:
        raise TypeError(
            f"unpack_planes: {len(rest)} unclaimed kernel output(s): the "
            "presence arguments do not match the kernel call's")
    return (lead, *planes)


def compact_delivered(delivered: dict, cap: int):
    """A [N, CI] delivered dict as fixed-[cap] columns (count, dst, src,
    seq, sock, deliver_rel) for a cheap read to the host: a stable sort
    on the inverted mask front-packs the due slots in row-major order,
    dst recovered from the flat index (-1 on dead slots). A count above
    `cap` means the tail was cut."""
    mask = delivered["mask"]
    N, CI = mask.shape
    flat = mask.reshape(-1)
    n = flat.sum(dtype=torch.int32)
    idx = torch.sort((~flat).to(torch.uint8), stable=True).indices[:cap]
    pick = lambda a: a.reshape(-1)[idx]
    dst = torch.where(pick(mask), floordiv(idx, CI).to(torch.int32), -1)
    return (n, dst, pick(delivered["src"]), pick(delivered["seq"]),
            pick(delivered["sock"]), pick(delivered["deliver_rel"]))


# ---------------------------------------------------------------------------
# window_step sections (the JAX plane's section helpers, FIFO packed path)
# ---------------------------------------------------------------------------


def _refill_tokens(state: NetPlaneState, params: NetPlaneParams, shift_ns,
                   *, faults: FaultArrays | None = None):
    """Section 1b: lazy 1 ms token refill with the sub-ms remainder
    carried; elapsed is clamped to the headroom before multiplying.
    `faults` divides each host's rate by `bw_div` (the MTU burst part of
    the capacity stays). Returns (balance, tb_rem_ns)."""
    rate, cap = params.tb_rate, params.tb_cap
    if faults is not None:
        rate = torch.clamp(floordiv(rate, torch.clamp(faults.bw_div, min=1)),
                           min=1)
        cap = rate + (params.tb_cap - params.tb_rate)
    rem_total = state.tb_rem_ns + floormod(shift_ns, 1_000_000)
    elapsed_ms = floordiv(shift_ns, 1_000_000) + floordiv(rem_total,
                                                          1_000_000)
    tb_rem_ns = floormod(rem_total, 1_000_000)
    headroom = torch.clamp(cap - state.tb_balance, min=0)
    need_ms = floordiv(headroom + rate - 1, rate)
    elapsed_eff = torch.minimum(elapsed_ms, need_ms)
    balance = cap - torch.clamp(headroom - rate * elapsed_eff, min=0)
    return balance, tb_rem_ns


def _rebase_refill(state: NetPlaneState, params: NetPlaneParams, shift_ns,
                   *, faults: FaultArrays | None = None):
    """Section 1: the queued ingress's deliver times rebased to this
    window (I32_MAX on invalid lanes) and the token refill
    (`_refill_tokens`). Returns (in_deliver, balance, tb_rem_ns)."""
    in_deliver = torch.where(state.in_valid,
                             state.in_deliver_rel - shift_ns, I32_MAX)
    balance, tb_rem_ns = _refill_tokens(state, params, shift_ns,
                                        faults=faults)
    return in_deliver, balance, tb_rem_ns


def _rebase_egress(valid, tsend, clamp, shift_ns):
    """Section 1 for the egress rings: the send times and clamps of
    queued packets rebased to this window (tsend 0 on invalid lanes, a
    NO_CLAMP or invalid lane's clamp kept). Kernels A and C rebase
    inside. Returns (tsend_rb, clamp_rb)."""
    tsend_rb = torch.where(valid, tsend - shift_ns, 0)
    clamp_rb = torch.where(valid & (clamp != NO_CLAMP), clamp - shift_ns,
                           clamp)
    return tsend_rb, clamp_rb


def _egress_sort(valid, qkey1, nbytes, tsend_rb, clamp_rb, tiebreak=None):
    """The qdisc sort over rebased columns: each row by (validity |
    qkey1[, tiebreak], column), one packed key. Returns (perm [N, CE]
    int32, bytes_s, tsend_s, clamp_s int32, valid_s bool), the carried
    columns in that order."""
    key = torch.where(valid, 0, _SIGN32) | u32(qkey1)
    if tiebreak is None:
        key_s, perm = torch.sort(key, dim=1, stable=True)
    else:
        perm = _row_perm_sort(key, tiebreak)
        key_s = take(key, perm)
    # validity comes back from the key's top bit, as in the TPU kernel
    valid_s = (key_s & _SIGN32) == 0
    return (perm.to(torch.int32), take(nbytes, perm), take(tsend_rb, perm),
            take(clamp_rb, perm), valid_s)


def _take_egress(state: NetPlaneState, perm):
    """The egress columns an order leaves to its caller (prio, sock,
    dst, seq, ctrl), gathered through `perm` [N, CE]."""
    perm = perm.to(torch.int64)
    return tuple(take(a, perm) for a in (state.eg_prio, state.eg_sock,
                                         state.eg_dst, state.eg_seq,
                                         state.eg_ctrl))


def _egress_order(state: NetPlaneState, qkey1, qkey2, eg_tsend_rb,
                  eg_clamp_rb):
    """Section 2b: the XLA path's qdisc sort (kernel C's plain ordering,
    the round-robin tiebreak `qkey2` included) and the gathers of the
    other columns through its permutation. Returns the 9 sorted columns
    (prio, sock, dst, bytes, seq, ctrl, tsend, clamp, valid), as the JAX
    function. The JAX plane skips the sort of an already ordered FIFO
    row; the stable sort of an ordered key is the identity (SL505), so
    the port always sorts."""
    perm, eg_bytes, eg_tsend, eg_clamp, eg_valid = _egress_sort(
        state.eg_valid, qkey1, state.eg_bytes, eg_tsend_rb, eg_clamp_rb,
        qkey2)
    eg_prio, eg_sock, eg_dst, eg_seq, eg_ctrl = _take_egress(state, perm)
    return (eg_prio, eg_sock, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend,
            eg_clamp, eg_valid)


def _gate_spent(valid_s, bytes_s, balance):
    """The prefix-sum token gate over ordered rows, kernel C's gating
    half. Returns (sendable bool [N, CE], spent [N] int32)."""
    cum = wrap_i32(torch.cumsum(torch.where(valid_s, bytes_s, 0), dim=1,
                                dtype=torch.int64))
    sendable = valid_s & (cum <= balance[:, None])
    spent = wrap_i32(torch.where(sendable, bytes_s, 0).sum(
        dim=1, dtype=torch.int64))
    return sendable, spent


def _token_gate(eg_valid, eg_bytes, balance):
    """Section 2c: the prefix-sum token-bucket gate over the sorted
    egress. Returns (sendable, balance_after), as the JAX function."""
    sendable, spent = _gate_spent(eg_valid, eg_bytes, balance)
    return sendable, balance - spent


def _qdisc_keys(state: NetPlaneState, params: NetPlaneParams, *,
                rr_enabled: bool):
    """Section 2a: per-slot qdisc sort keys. FIFO = packet priority (no
    tiebreak); round-robin hosts (`params.qdisc_rr`) key each slot by its
    socket slot's virtual-finish counter plus its rank among the
    socket's earlier-seq packets (the [N, CE, CE] pairwise compare),
    with the socket id as the tiebreak. Returns (qkey1, qkey2 or None,
    rr_aux = (rr_base, vtime) or None)."""
    if not rr_enabled:
        return state.eg_prio, None, None
    S = RR_SOCK_SLOTS
    valid = state.eg_valid
    sock_slot = torch.where(valid, floormod(state.eg_sock, S), S - 1)
    slots = _arange(S, sock_slot)
    # active sockets re-join at the current virtual time; rows with
    # nothing queued reset to 0
    active = ((sock_slot[:, :, None] == slots) & valid[:, :, None]).any(dim=1)
    vtime = torch.where(active, state.rr_sent, I32_MAX).amin(dim=1)
    vtime = torch.where(active.any(dim=1), vtime, 0)
    rr_base = torch.maximum(state.rr_sent, vtime[:, None])
    same_sock = sock_slot[:, :, None] == sock_slot[:, None, :]
    both_valid = valid[:, :, None] & valid[:, None, :]
    earlier = state.eg_seq[:, None, :] < state.eg_seq[:, :, None]
    rr_rank = (same_sock & both_valid & earlier).sum(dim=2, dtype=torch.int32)
    rr_key = take(rr_base, sock_slot.to(torch.int64)) + rr_rank
    rr_mode = params.qdisc_rr[:, None]
    qkey1 = torch.where(rr_mode, rr_key, state.eg_prio)
    qkey2 = torch.where(rr_mode, state.eg_sock, 0)
    return qkey1, qkey2, (rr_base, vtime)


def _rr_advance(eg_sock, eg_valid, sendable, rr_aux):
    """Section 2d: advance the RR virtual-finish counters by the packets
    the gate let through, rebased to the floor so they stay bounded."""
    S = RR_SOCK_SLOTS
    rr_base, vtime = rr_aux
    sent_slot = torch.where(eg_valid, floormod(eg_sock, S), S - 1)
    sent_per_sock = ((sent_slot[:, :, None] == _arange(S, sent_slot))
                     & sendable[:, :, None]).sum(dim=1, dtype=torch.int32)
    return rr_base - vtime[:, None] + sent_per_sock


def _loss_latency(state: NetPlaneState, params: NetPlaneParams, seed,
                  eg_dst, eg_ctrl, eg_tsend, eg_clamp, sendable, window_ns,
                  *, no_loss: bool, faults: FaultArrays | None = None):
    """Section 3: the counter-based Bernoulli loss draw and the
    node-table latency lookup. Returns (sent, lost, corrupt or None,
    rng_counter', deliver_rel).

    With `faults`: the corruption draw, the same counter stream at host
    index host + N (drawn under `no_loss` too, and in one threefry call
    with the loss draw otherwise), drops data packets that were not
    lost with the host's `corrupt_p`; and `lat_mult` > 1 multiplies the
    latency, clamped first so the product stays in the int32 budget."""
    N, CE = eg_dst.shape
    col = _arange(CE, eg_dst)
    node_src = params.host_node.to(torch.int64)[:, None].expand(N, CE)
    node_dst = params.host_node[
        torch.clamp(eg_dst, 0, N - 1).to(torch.int64)].to(torch.int64)
    host = _arange(N, eg_dst, torch.int64)[:, None].expand(N, CE)
    # the JAX counter is int32 and wraps; the draw reads its bits
    counter = state.rng_counter.to(torch.int64)[:, None] + col
    draws = (([] if no_loss else [host])
             + ([host + N] if faults is not None else []))
    if len(draws) == 1:
        u = [_pkt_uniform(seed, draws[0], counter)]
    elif draws:  # the loss and corruption draws in one call
        u = list(_pkt_uniform(seed, torch.stack(draws), counter))
    if no_loss:
        lost = torch.zeros_like(sendable)
        sent = sendable
    else:
        p_loss = params.loss[node_src, node_dst]
        lost = sendable & (u[0] < p_loss) & ~eg_ctrl
        sent = sendable & ~lost
    corrupt = None
    if faults is not None:
        corrupt = (sendable & ~lost & ~eg_ctrl
                   & (u[-1] < faults.corrupt_p[:, None]))
        sent = sent & ~corrupt
    rng_counter = state.rng_counter + sendable.sum(dim=1, dtype=torch.int32)
    latency = params.latency_ns[node_src, node_dst]
    if faults is not None:
        mult = torch.clamp(faults.lat_mult[node_src, node_dst], min=1)
        cap = floordiv(torch.full_like(mult, I32_MAX // 2), mult)
        latency = torch.where(mult > 1, torch.minimum(latency, cap) * mult,
                              latency)
    clamp_eff = torch.where(eg_clamp == NO_CLAMP, window_ns, eg_clamp)
    deliver_rel = torch.maximum(eg_tsend + latency, clamp_eff)
    return sent, lost, corrupt, rng_counter, deliver_rel


def _compact_ingress(state: NetPlaneState, in_deliver):
    """Section 4: surviving ingress front-packed by (validity, deliver)
    through one packed key. The JAX plane skips the sort when rows are
    already ordered; the stable sort of an ordered key is the identity
    (SL505), so the port always sorts. Returns (deliver_c, src_c, seq_c,
    sock_c, bytes_c, valid_c, n_valid_in)."""
    key_deliver = torch.where(state.in_valid, in_deliver, I32_MAX)
    perm = _row_perm_sort(_pack_time_key(state.in_valid, key_deliver))
    in_valid_c = take(state.in_valid, perm)
    return (take(key_deliver, perm), take(state.in_src, perm),
            take(state.in_seq, perm), take(state.in_sock, perm),
            take(state.in_bytes, perm), in_valid_c,
            in_valid_c.sum(dim=1, dtype=torch.int32))


def _seq_row_order(eg_seq):
    """Each row's stable (seq, column) order, as int32 column indices:
    one stable row sort of the sign-biased seq. The JAX plane builds it
    from an [N, CE, CE] pairwise (seq, column) rank and a scatter that
    inverts it; (seq, column) pairs are distinct, so the two give the
    same permutation."""
    return torch.sort(u32(eg_seq) ^ _SIGN32, dim=1,
                      stable=True).indices.to(torch.int32)


def _routing_order(sent, eg_dst, eg_seq, deliver_rel, row_perm=None):
    """Bucketed routing, phase A: `row_perm` (each row's seq order;
    kernel A's output, or `_seq_row_order` when None) permutes the
    source rows so the flat slot index encodes the (src, seq)
    tiebreak; one flat stable sort on (bucket << 32 | sign-biased
    deliver) over the permuted slots follows. (dst, deliver, slot) is a
    total order, so this is the JAX plane's permutation. Unsent slots go
    to bucket N, which is never placed. Returns (row_perm [N, CE] int32,
    o_pos [B] int64, offsets, counts [N] int32)."""
    N, CE = eg_dst.shape
    if row_perm is None:
        row_perm = _seq_row_order(eg_seq)
    perm = row_perm.to(torch.int64)
    sent_p, dst_p = take(sent, perm), take(eg_dst, perm)
    flat_dst = torch.where(sent_p & (dst_p >= 0) & (dst_p < N), dst_p,
                           N).reshape(-1).to(torch.int64)
    deliver_key = u32(take(deliver_rel, perm)).reshape(-1) ^ _SIGN32
    o_key, o_pos = torch.sort((flat_dst << 32) | deliver_key, stable=True)
    bounds = torch.searchsorted(o_key >> 32,
                                _arange(N + 1, o_key, torch.int64))
    offsets = bounds[:-1].to(torch.int32)
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return row_perm, o_pos, offsets, counts


def _routing_rank(sent, eg_dst, eg_seq, deliver_rel, n_valid_in,
                  ingress_cap: int, row_perm=None):
    """Section 5a: each destination row takes the first `take` items of
    its bucket. Returns (row_perm, o_pos, offsets, take [N],
    overflow [N])."""
    row_perm, o_pos, offsets, counts = _routing_order(
        sent, eg_dst, eg_seq, deliver_rel, row_perm)
    take_n = torch.minimum(counts, ingress_cap - n_valid_in)
    overflow = torch.clamp(counts + n_valid_in - ingress_cap, min=0)
    return row_perm, o_pos, offsets, take_n, overflow


def _routing_place(row_perm, o_pos, offsets, take_n, n_valid_in, eg_seq,
                   eg_bytes, eg_sock, deliver_rel, in_deliver_c, in_src_c,
                   in_seq_c, in_sock_c, in_bytes_c, in_valid_c):
    """Section 5b: land each destination row's bucket segment of the
    arrival order in its free slots, with the JAX function's arguments:
    the XLA placement, which is kernel D's plain version
    (`pipeline.scatter(plain=True)`, what `route_scatter(plain=True)`
    runs after `_routing_rank`). Returns the merged (src, seq, sock,
    bytes, deliver, valid); unlike the JAX function, these are the
    compacted ingress tensors given, updated in place."""
    from . import pipeline  # pipeline imports this module

    return pipeline.scatter(
        n_valid_in, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock,
        eg_bytes, deliver_rel, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
        in_deliver_c, in_valid_c, plain=True)


def _route_scatter(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                   in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                   in_valid_c, n_valid_in, *, kernel: str = "xla",
                   plain: bool = False):
    """Section 5 off the fused pair: `_routing_rank` and the placement,
    through kernel D on `kernel="pallas"` (CUDA tensors, unless
    `plain`) and through its plain version, the JAX XLA path's
    placement, on every other kernel, as the JAX function dispatches.
    Returns the merged ingress columns + overflow [N], the compacted
    ingress tensors updated in place (`pipeline.route_scatter`)."""
    from . import pipeline  # pipeline imports this module

    return pipeline.route_scatter(
        sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel, in_deliver_c,
        in_src_c, in_seq_c, in_sock_c, in_bytes_c, in_valid_c, n_valid_in,
        plain=plain or kernel != "pallas")


def _release_due(in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
                 in_valid_m, window_ns):
    """Section 5b: split the merged ingress into this window's due
    deliveries (row tail, in (deliver, src, seq) order) and the
    front-packed survivors. The JAX plane's wrapped key
    `biased(deliver) - biased(window)` orders not-due before due, each
    ascending; it is masked back into [0, 2**32) after the subtraction.
    (wkey, src, seq, column) is a total order, realised here as two
    stable passes: by seq, then by (wkey << 32 | biased src). Returns
    (delivered, due, deliver', src', seq', sock', bytes', valid')."""
    in_deliver_key = torch.where(in_valid_m, in_deliver_m, I32_MAX)
    due = in_valid_m & (in_deliver_key < window_ns)
    w_bias = (window_ns & 0xFFFFFFFF) ^ _SIGN32
    wkey = ((u32(in_deliver_key) ^ _SIGN32) - w_bias) & 0xFFFFFFFF
    hi = (wkey - _SIGN32) << 32  # signed high word keeps unsigned order
    perm = _row_perm_sort(hi | (u32(in_src_m) ^ _SIGN32), in_seq_m)
    d_t = take(in_deliver_key, perm)  # == the key unwrapped (bijective)
    d_src, d_seq = take(in_src_m, perm), take(in_seq_m, perm)
    d_sock, d_bytes = take(in_sock_m, perm), take(in_bytes_m, perm)
    d_due, d_valid = take(due, perm), take(in_valid_m, perm)
    delivered = {
        "mask": d_due, "src": d_src, "seq": d_seq, "sock": d_sock,
        "bytes": d_bytes, "deliver_rel": d_t,
    }
    in_valid_new = d_valid & ~d_due
    in_deliver_new = torch.where(in_valid_new, d_t, I32_MAX)
    return (delivered, due, in_deliver_new, d_src, d_seq, d_sock, d_bytes,
            in_valid_new)


def _key_valid_time(valid, t):
    """(invalid, int32 time) as one int64 sort key: exact for every time,
    I32_MAX included (the JAX AQM sorts carry the two as separate keys)."""
    return ((~valid).to(torch.int64) << 32) | (u32(t) ^ _SIGN32)


def _key_src_seq(src, seq):
    """(src, seq), both signed int32, as one order-exact int64 key."""
    return (src.to(torch.int64) << 32) | (u32(seq) ^ _SIGN32)


def _router_order(in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
                  in_valid_m):
    """The merged ingress rows in the order they reach the router:
    (arrival, src, seq), invalid lanes last with arrival I32_MAX (the
    JAX four-key stable row sort, as two stable passes: by (src, seq),
    then by (invalid, arrival)). Returns (arr_s, src_s, seq_s, sock_s,
    bytes_s, valid_s)."""
    arr_key = torch.where(in_valid_m, in_deliver_m, I32_MAX)
    perm = _row_perm_sort(_key_valid_time(in_valid_m, arr_key),
                          _key_src_seq(in_src_m, in_seq_m))
    return tuple(take(a, perm) for a in (arr_key, in_src_m, in_seq_m,
                                         in_sock_m, in_bytes_m, in_valid_m))


def _router_release(in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
                    in_valid_m, window_ns, params: NetPlaneParams,
                    rt: codel.RouterDownState, *, plain: bool):
    """Section 5b under the router AQM: the inbound pipeline (router
    CoDel, down-bandwidth relay, delivery) in place of the due release.
    Stored times are arrivals at the destination router. The rows go to
    the router in (arrival, src, seq) order (`_router_order`);
    `codel.router_drain` (kernel E on CUDA tensors unless
    `plain`) drains them; a row entry left cached moves its identity into
    the router scalars. The delivered dict is [N, CI + 1]: the forwarded
    rows plus the previous window's cached packet in the extra column,
    in (deliver, src, seq) order; the untouched FIFO suffix is
    front-packed. Returns (delivered, due, deliver', src', seq', sock',
    bytes', valid', router state', (src_s, seq_s, arr_s, aqm_dropped))
    with the last the flight recorder's AQM-drop candidates."""
    CI = in_src_m.shape[1]
    arr_s, src_s, seq_s, sock_s, bytes_s, valid_s = _router_order(
        in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m, in_valid_m)
    rt2, rstatus, r_dt, co_mask, co_t, c_idx = codel.router_drain(
        arr_s, bytes_s, window_ns, params.dn_rate, params.dn_cap, rt,
        plain=plain)
    # a row entry cached at window end leaves the queue: its identity
    # moves into the router scalars until the relay resumes
    new_cached = c_idx >= 0
    ci = torch.clamp(c_idx, 0, CI - 1).to(torch.int64)[:, None]
    cached = lambda a, old: torch.where(new_cached, take(a, ci)[:, 0], old)
    rt2 = rt2._replace(cached_src=cached(src_s, rt.cached_src),
                       cached_seq=cached(seq_s, rt.cached_seq),
                       cached_sock=cached(sock_s, rt.cached_sock))
    # delivered: forwarded row entries + (maybe) the prior window's
    # relay-cached packet, in (deliver, src, seq) order
    fwd_rows = rstatus == codel.STATUS_DELIVERED
    col = lambda a, b: torch.cat([a, b[:, None]], dim=1)
    d_mask0 = col(fwd_rows, co_mask)
    d_src0, d_seq0 = col(src_s, rt.cached_src), col(seq_s, rt.cached_seq)
    d_t0 = col(torch.where(fwd_rows, r_dt, I32_MAX),
               torch.where(co_mask, co_t, I32_MAX))
    dperm = _row_perm_sort(_key_valid_time(d_mask0, d_t0),
                           _key_src_seq(d_src0, d_seq0))
    d_due = take(d_mask0, dperm)
    delivered = {
        "mask": d_due, "src": take(d_src0, dperm),
        "seq": take(d_seq0, dperm),
        "sock": take(col(sock_s, rt.cached_sock), dperm),
        "bytes": take(col(bytes_s, rt.cached_bytes), dperm),
        "deliver_rel": take(d_t0, dperm),
    }
    # the surviving queue: the untouched FIFO suffix, re-front-packed
    keep = valid_s & (rstatus == codel.STATUS_QUEUED)
    kperm = _row_perm_sort(_pack_time_key(keep, arr_s))
    aqm_dropped = valid_s & (rstatus == codel.STATUS_DROPPED)
    return (delivered, d_due, take(torch.where(keep, arr_s, I32_MAX), kperm),
            take(src_s, kperm), take(seq_s, kperm), take(sock_s, kperm),
            take(bytes_s, kperm), take(keep, kperm), rt2,
            (src_s, seq_s, arr_s, aqm_dropped))


def _compact_egress(eg_prio, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend,
                    eg_clamp, eg_sock, eg_valid_left):
    """Section 6: leftover egress front-packed by (validity, priority)."""
    eg_prio_left = torch.where(eg_valid_left, eg_prio, I32_MAX)
    perm = _row_perm_sort(_pack_time_key(eg_valid_left, eg_prio_left))
    return tuple(take(a, perm) for a in (
        eg_prio_left, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend,
        eg_clamp, eg_sock, eg_valid_left))


def _row_sum_i32(x: torch.Tensor) -> torch.Tensor:
    """Row sums modulo 2**32, as the JAX plane's int32 reductions wrap
    (accumulated in int64, wrapped once)."""
    return wrap_i32(x.sum(dim=1, dtype=torch.int64))


def _accumulate_metrics(metrics: PlaneMetrics, state: NetPlaneState,
                        sent, lost, due, overflowed, delivered, in_valid_m,
                        eg_bytes, fault_drops=None,
                        router_drops=None) -> PlaneMetrics:
    """Section 8: the telemetry counters, over values the step already
    computed; nothing feeds back into the state. `fault_drops` ([N],
    None without faults) is the fault plane's per-host drops and
    `router_drops` ([N], None without the router AQM, where the JAX
    step adds a zero delta) the router's CoDel drops."""
    sent_n = sent.sum(dim=1, dtype=torch.int32)
    due_n = due.sum(dim=1, dtype=torch.int32)
    occupancy = lambda v: v.sum(dim=1, dtype=torch.int32)
    return PlaneMetrics(
        pkts_out=metrics.pkts_out + sent_n,
        bytes_out=metrics.bytes_out
        + _row_sum_i32(torch.where(sent, eg_bytes, 0)),
        pkts_in=metrics.pkts_in + due_n,
        bytes_in=metrics.bytes_in
        + _row_sum_i32(torch.where(delivered["mask"], delivered["bytes"], 0)),
        drop_ring_full=metrics.drop_ring_full + overflowed,
        drop_qdisc=(metrics.drop_qdisc if router_drops is None
                    else metrics.drop_qdisc + router_drops),
        drop_loss=metrics.drop_loss + lost.sum(dim=1, dtype=torch.int32),
        drop_fault=(metrics.drop_fault if fault_drops is None
                    else metrics.drop_fault + fault_drops),
        retransmits=metrics.retransmits,
        # high-water marks at the peak points: egress entering the window,
        # ingress after the arrivals merged and before the due release
        max_eg_depth=torch.maximum(metrics.max_eg_depth,
                                   occupancy(state.eg_valid)),
        max_in_depth=torch.maximum(metrics.max_in_depth,
                                   occupancy(in_valid_m)),
        windows=metrics.windows + 1,
        events=wrap_i32(metrics.events.to(torch.int64)
                        + sent_n.sum(dtype=torch.int64)
                        + due_n.sum(dtype=torch.int64)),
        sort_slots=wrap_i32(metrics.sort_slots.to(torch.int64)
                            + state.eg_valid.sum(dtype=torch.int64)
                            + state.in_valid.sum(dtype=torch.int64)),
    )


def _accumulate_hist(hist: PlaneHistograms, state: NetPlaneState, sent,
                     eg_dst, eg_tsend, deliver_rel,
                     in_valid_m) -> PlaneHistograms:
    """Section 10: the latency and depth histograms, over values the step
    already computed: deliver - send per sent packet at its destination,
    the egress sojourn (-tsend: a packet carried over k windows has a
    negative rebased send time) at its source, and one depth sample a
    host (egress entering the window + ingress after the merge)."""
    return PlaneHistograms(
        hist_delivery_ns=histo.accum_scatter(
            hist.hist_delivery_ns, eg_dst,
            histo.bucket_index(deliver_rel - eg_tsend), sent),
        hist_sojourn_ns=histo.accum_rows(
            hist.hist_sojourn_ns, histo.bucket_index(-eg_tsend), sent),
        hist_qdepth=histo.accum_depth(
            hist.hist_qdepth,
            state.eg_valid.sum(dim=1, dtype=torch.int32)
            + in_valid_m.sum(dim=1, dtype=torch.int32)),
    )


_PRESENCE_PLANES = ("faults", "metrics", "guards", "hist", "flightrec",
                    "flows", "compute")
KERNELS = ("pallas_fused", "pallas", "xla")


def _check_step_options(kernel: str, rr_enabled: bool, packed_sort: bool,
                        planes: dict):
    """The JAX step's refusals (ValueError, as there: the Pallas kernels
    are FIFO-only, packed-sort-only and fuse no presence plane but
    metrics) and the port's own (`packed_sort=False` on any kernel). The
    router AQM runs on every kernel, as in the JAX step."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown plane kernel {kernel!r}: expected one of "
                         f"{KERNELS}")
    unknown = sorted(set(planes) - set(_PRESENCE_PLANES))
    if unknown:
        raise TypeError(f"window_step: unexpected arguments {unknown}")
    fused = kernel != "xla"
    if fused and rr_enabled:
        raise ValueError(
            f"plane_kernel={kernel!r} fuses the FIFO qdisc only; pass "
            "rr_enabled=False (all-FIFO configs) or use kernel='xla'")
    if not packed_sort:
        raise ValueError(
            f"plane_kernel={kernel!r}: the port implements the packed/"
            "bucketed ordering only; packed_sort=False is a JAX-side "
            "parity reference (ROADMAP.md)")
    refused = [k for k in _PRESENCE_PLANES
               if k != "metrics" and planes.get(k) is not None]
    if fused and refused:
        raise ValueError(
            f"plane_kernel={kernel!r} does not fuse the presence planes "
            f"{refused}; the JAX plane runs them on kernel='xla' only")


def window_step(state: NetPlaneState, params: NetPlaneParams, rng_seed,
                shift_ns: int, window_ns: int, *, rr_enabled: bool = True,
                router_aqm: bool = False, no_loss: bool = False,
                packed_sort: bool = True, kernel: str = "xla",
                plain_kernels: bool = False,
                faults: FaultArrays | None = None,
                metrics: PlaneMetrics | None = None,
                guards: GuardState | None = None,
                hist: PlaneHistograms | None = None,
                flightrec: FlightRecArrays | None = None, **planes):
    """Advance one scheduling round [t, t + window_ns): the JAX
    `window_step` with the same kernel, bitwise.

    `kernel="pallas_fused"` runs kernels A and B (`pipeline.
    egress_rank_stage`, `route_place`); `kernel="pallas"` the split pair,
    kernels C and D (`egress_order_gate`, `route_scatter`), with the
    other egress columns gathered through C's permutation and the routing
    row order computed in PyTorch. `kernel="xla"` (the default, as in the
    JAX package) runs the split path's stages through the plain versions
    of C and D, which compute the JAX XLA path's egress sort and gate and
    its routing placement, launching no kernel; it alone takes the
    round-robin qdisc (`rr_enabled=True`, per host by `params.qdisc_rr`)
    and every presence plane but metrics. The JAX package makes the three
    bitwise identical. `rng_seed` is the int seed of the JAX run's
    `jax.random.key(seed)`, or a key tensor (int64 [2], the words of
    `jax.random.key_data`: `prims.key_tensor`, `elastic.world_key`),
    read on the device so that a per-world key rides a batched carry;
    `shift_ns` is this window's start minus the
    previous one's. `plain_kernels=True` runs the plain PyTorch versions
    of the kernels even on CUDA tensors (the reference a card run is
    held against); otherwise CUDA tensors go through the CUDA kernels.

    `router_aqm=True` (every kernel) switches the destination side from
    the due release to the inbound pipeline (`host.rs:810-865`): a
    stored time is then the packet's arrival at the destination router,
    the router's CoDel may drop it (`state.router.dropped`), and the
    down-bandwidth relay delivers it when its tokens allow
    (`_router_release`; the drain is kernel E on CUDA tensors).

    The presence planes (each None by default, leaving the step as it
    is): `faults` (`faults.plane.FaultArrays`) purges a down host's
    egress before the token gate, divides its refill rate, corrupts its
    data packets and multiplies path latency, and drops what is routed
    toward a down host; its drops count in `n_fault_dropped` and
    `metrics.drop_fault`. `metrics` (`telemetry.metrics.PlaneMetrics`),
    `guards` (`guards.plane.GuardState`), `hist`
    (`telemetry.histo.PlaneHistograms`) and `flightrec`
    (`telemetry.flightrec.FlightRecArrays`) read values the step computes
    anyway and leave the state bitwise unchanged.
    `flows=(FlowTables, FlowState)` runs the flow plane's `flow_step`
    after them (its retransmits and acks append to the egress rings) and
    `compute=(ComputeTables, ComputeState)` the compute plane's
    `compute_step` on the same delivered dict (`tpu/flows.py`,
    `tpu/compute.py`).

    Returns (state', delivered, next_event_rel[, metrics'][, guards'][,
    hist'][, flightrec'][, flow_state'][, compute_state']):
    `delivered` is a dict of [N, CI] tensors ([N, CI + 1] under the
    router AQM) masked by delivered["mask"], and next_event_rel a 0-d
    int32 tensor (I32_MAX when idle). No tensor is read back to the
    host.
    """
    _check_step_options(kernel, rr_enabled, packed_sort,
                        dict(planes, faults=faults, metrics=metrics,
                             guards=guards, hist=hist, flightrec=flightrec))
    from . import pipeline

    N, CE = state.eg_dst.shape

    # --- 1. rebase clocks + refill token buckets ------------------------
    in_deliver, balance, tb_rem_ns = _rebase_refill(state, params, shift_ns,
                                                    faults=faults)
    rt = codel.rebase_router_state(state.router, shift_ns, params.dn_rate,
                                   params.dn_cap)

    # --- 2. egress: qdisc order and token gate (kernel A or C) ----------
    rr_sent = state.rr_sent
    if kernel == "pallas_fused":
        egress_rank = (pipeline.egress_rank_plain if plain_kernels
                       else pipeline.egress_rank_stage)
        (eg_prio, eg_sock, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend,
         eg_clamp, eg_valid, sendable, spent, row_perm) = egress_rank(
            state.eg_valid, state.eg_prio, state.eg_bytes, state.eg_tsend,
            state.eg_clamp, state.eg_dst, state.eg_seq, state.eg_sock,
            state.eg_ctrl, balance, shift_ns)
        balance = balance - spent
    else:
        qkey1, qkey2, rr_aux = _qdisc_keys(state, params,
                                           rr_enabled=rr_enabled)
        if kernel == "xla" or plain_kernels:
            eg_tsend_rb, eg_clamp_rb = _rebase_egress(
                state.eg_valid, state.eg_tsend, state.eg_clamp, shift_ns)
            (eg_prio, eg_sock, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend,
             eg_clamp, eg_valid) = _egress_order(state, qkey1, qkey2,
                                                 eg_tsend_rb, eg_clamp_rb)
            if faults is not None:
                # 2f. a down host transmits nothing: its queued egress
                # drops here, before the gate, once a slot
                up_src = (faults.host_alive & faults.link_up)[:, None]
                fault_purged = eg_valid & ~up_src
                eg_valid = eg_valid & up_src
            sendable, balance = _token_gate(eg_valid, eg_bytes, balance)
        else:
            (perm, eg_bytes, eg_tsend, eg_clamp, eg_valid, sendable,
             spent) = pipeline.egress_order_gate(
                state.eg_valid, qkey1, state.eg_bytes, state.eg_tsend,
                state.eg_clamp, balance, shift_ns)
            eg_prio, eg_sock, eg_dst, eg_seq, eg_ctrl = _take_egress(state,
                                                                     perm)
            balance = balance - spent
        if rr_enabled:
            rr_sent = _rr_advance(eg_sock, eg_valid, sendable, rr_aux)

    # --- 3. loss sampling + latency lookup -------------------------------
    sent, lost, corrupt, rng_counter, deliver_rel = _loss_latency(
        state, params, rng_seed, eg_dst, eg_ctrl, eg_tsend, eg_clamp,
        sendable, window_ns, no_loss=no_loss, faults=faults)
    if faults is not None:
        # 3f. routing toward a down destination drops (what is already in
        # its ingress ring stays); purge and corruption count at the
        # source, a blocked route at the destination
        in_range = (eg_dst >= 0) & (eg_dst < N)
        dst_c = torch.clamp(eg_dst, 0, N - 1).to(torch.int64)
        dst_ok = (faults.host_alive & faults.link_up)[dst_c] & in_range
        blocked_dst = sent & ~dst_ok & in_range
        sent = sent & dst_ok
        fault_drops = (fault_purged.sum(dim=1, dtype=torch.int32)
                       + corrupt.sum(dim=1, dtype=torch.int32)
                       + scatter_add_i32(N, dst_c, blocked_dst))
    eg_valid_left = eg_valid & ~sendable

    # --- 4 + 5. compact surviving ingress, route (kernel B or D) --------
    (in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c, in_valid_c,
     n_valid_in) = _compact_ingress(state, in_deliver)
    routed = (sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
              in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
              in_valid_c, n_valid_in)
    if kernel == "pallas_fused":
        merged = pipeline.route_place(*routed, row_perm, plain=plain_kernels)
    else:
        merged = _route_scatter(*routed, kernel=kernel, plain=plain_kernels)
    (in_src_m, in_seq_m, in_sock_m, in_bytes_m, in_deliver_m, in_valid_m,
     overflowed) = merged

    # --- 5b. release what this window hands the hosts --------------------
    if router_aqm:
        (delivered, due, in_deliver_new, in_src_new, in_seq_new,
         in_sock_new, in_bytes_new, in_valid_new, rt_out,
         aqm_hops) = _router_release(
            in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
            in_valid_m, window_ns, params, rt, plain=plain_kernels)
    else:
        (delivered, due, in_deliver_new, in_src_new, in_seq_new,
         in_sock_new, in_bytes_new, in_valid_new) = _release_due(
            in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
            in_valid_m, window_ns)
        rt_out, aqm_hops = rt, None

    # --- 6. compact leftover egress --------------------------------------
    (eg_prio_c, eg_dst_c, eg_bytes_c, eg_seq_c, eg_ctrl_c, eg_tsend_c,
     eg_clamp_c, eg_sock_c, eg_valid_c) = _compact_egress(
        eg_prio, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend, eg_clamp,
        eg_sock, eg_valid_left)

    # --- 7. stats + next-event reduction ---------------------------------
    per_host_in_next = torch.where(in_valid_new, in_deliver_new,
                                   I32_MAX).amin(dim=1)
    if router_aqm:
        # a relay-cached packet blocks its whole row until the resume fires
        per_host_in_next = torch.where(rt_out.has_cached, rt_out.resume,
                                       per_host_in_next)
    idle = torch.full((), I32_MAX, dtype=torch.int32,
                      device=eg_valid_c.device)
    next_event = torch.minimum(
        per_host_in_next.amin(),
        torch.where(eg_valid_c.any(), idle.new_full((), window_ns), idle))

    new_state = state._replace(
        eg_dst=eg_dst_c, eg_bytes=eg_bytes_c, eg_prio=eg_prio_c,
        eg_seq=eg_seq_c, eg_ctrl=eg_ctrl_c, eg_tsend=eg_tsend_c,
        eg_clamp=eg_clamp_c, eg_sock=eg_sock_c, eg_valid=eg_valid_c,
        in_src=in_src_new, in_bytes=in_bytes_new, in_seq=in_seq_new,
        in_sock=in_sock_new, in_deliver_rel=in_deliver_new,
        in_valid=in_valid_new,
        tb_balance=balance, tb_rem_ns=tb_rem_ns, rng_counter=rng_counter,
        rr_sent=rr_sent, router=rt_out,
        n_sent=state.n_sent + sent.sum(dim=1, dtype=torch.int32),
        n_loss_dropped=state.n_loss_dropped
        + lost.sum(dim=1, dtype=torch.int32),
        n_overflow_dropped=state.n_overflow_dropped + overflowed,
        n_delivered=state.n_delivered + due.sum(dim=1, dtype=torch.int32),
        n_fault_dropped=(state.n_fault_dropped if faults is None
                         else state.n_fault_dropped + fault_drops),
    )
    router_drops = (rt_out.dropped - state.router.dropped if router_aqm
                    else None)
    if metrics is not None:
        # --- 8. telemetry counters ---------------------------------------
        metrics = _accumulate_metrics(
            metrics, state, sent, lost, due, overflowed, delivered,
            in_valid_m, eg_bytes, fault_drops if faults is not None else None,
            router_drops)
    if guards is not None:
        # --- 9. guard plane ("xla" only): reads, never writes the state
        eg_left = sendable.sum(dim=1, dtype=torch.int32)
        if faults is not None:
            eg_left = eg_left + fault_purged.sum(dim=1, dtype=torch.int32)
        if router_aqm:
            qdisc_delta = router_drops
            cached_in = state.router.has_cached.to(torch.int32)
            cached_out = rt_out.has_cached.to(torch.int32)
        else:
            qdisc_delta = cached_in = cached_out = torch.zeros(
                N, dtype=torch.int32, device=eg_dst.device)
        guards = guards_plane.check_window(
            guards, state=state,
            eg_occ_in=state.eg_valid.sum(dim=1, dtype=torch.int32),
            eg_left_this_window=eg_left,
            in_occ_in=state.in_valid.sum(dim=1, dtype=torch.int32),
            arrivals=scatter_add_i32(N, torch.clamp(eg_dst, 0, N - 1),
                                      sent),
            overflowed=overflowed,
            delivered=due.sum(dim=1, dtype=torch.int32),
            qdisc_delta=qdisc_delta, cached_in=cached_in,
            cached_out=cached_out,
            new_state=new_state, rng_delta=rng_counter - state.rng_counter,
            egress_cap=CE, shift_ns=shift_ns, window_ns=window_ns)
    if hist is not None:
        # --- 10. latency/depth histograms ("xla" only) -------------------
        hist = _accumulate_hist(hist, state, sent, eg_dst, eg_tsend,
                                deliver_rel, in_valid_m)
    if flightrec is not None:
        # --- 11. flight recorder ("xla" only)
        flightrec = _record_hops(flightrec, eg_dst, eg_seq, eg_tsend, sent,
                                 lost, delivered,
                                 None if faults is None
                                 else fault_purged | corrupt | blocked_dst,
                                 aqm_hops)
    flows, compute = planes.get("flows"), planes.get("compute")
    if flows is not None:
        # --- 12. the flow plane ("xla" only): acks and credits read the
        # released dict, then retransmits and delayed acks append through
        # `ingest` after every observability section; next_event was
        # reduced before the append, as in the JAX step
        from . import flows as flows_mod  # flows imports this module

        new_state, fs_out, _credits, *rest = flows_mod.flow_step(
            *flows, new_state, delivered, window_ns, metrics=metrics,
            guards=guards, flightrec=flightrec)
        if metrics is not None:
            metrics = rest.pop(0)
        if guards is not None:
            guards = rest.pop(0)
        if flightrec is not None:
            flightrec = rest.pop(0)
    if compute is not None:
        # --- 13. the compute plane ("xla" only): reads the released
        # dict, writes only its own state
        cs_out = compute_mod.compute_step(*compute, delivered, shift_ns,
                                          window_ns)
    out = (new_state, delivered, next_event)
    out += tuple(p for p in (metrics, guards, hist, flightrec)
                 if p is not None)
    if flows is not None:
        out += (fs_out,)
    if compute is not None:
        out += (cs_out,)
    return out


def chain_windows(state: NetPlaneState, params: NetPlaneParams,
                  rng_seed, shift0: int, window0_ns: int,
                  runahead_ns: int, horizon_rel: int, stop_rel: int,
                  max_windows: int = 64, *, rr_enabled: bool = True,
                  router_aqm: bool = False, no_loss: bool = False,
                  kernel: str = "xla",
                  faults: FaultArrays | None = None,
                  metrics: PlaneMetrics | None = None,
                  guards: GuardState | None = None,
                  hist: PlaneHistograms | None = None,
                  flightrec: FlightRecArrays | None = None,
                  workload=None, flows=None, compute=None, round0: int = 0):
    """Advance consecutive windows until one delivers: the JAX
    `chain_windows`, bitwise, with the same boundaries.

    The first window ([shift0-rebased start, +window0_ns)) runs
    unconditionally. Afterwards, while a window delivered nothing and
    its next event stays below both `horizon_rel` (the earliest
    host-side event) and `stop_rel` (the simulation's end), the next
    window opens at that event with length min(runahead_ns, stop_rel -
    start), at most `max_windows` windows in all. `horizon_rel` and
    `stop_rel` are relative to the first window's start and at most
    I32_MAX // 2, as in JAX. The shifts, lengths, bounds and `round0` are
    Python ints, as `window_step` takes them.

    The JAX chain is one `lax.while_loop` on the device. A PyTorch loop
    cannot branch on the device, and the port's `window_step` takes its
    shift and length as Python ints, so this reads the host once per
    chained window, and only then: after a window that could be
    followed, one small tensor holding the continue flag and the next
    event, read with a single `.tolist()`. A fixed trip count of masked
    windows would cost `max_windows` full steps a chain instead.

    Every presence plane threads through the windows as in
    `window_step` (same arguments, `kernel` included). `workload=(wl,
    ws)` runs the traffic generator's `workload_step` after each window
    (its emission re-arms the next event); `flows=(ft, fs)` threads the flow plane, whose emission and
    pending RTO deadline re-arm it too; the two exclude each other, as
    in JAX. `compute=(ct, cs)` threads the compute plane (it emits
    nothing). `round0` is the caller's window counter for the
    generator's `done_win` stamps.

    Returns (state, delivered, off, next_rel, n_windows[, metrics'][,
    guards'][, hist'][, flightrec'][, ws'][, fs'][, cs']), `off`,
    `next_rel` and `n_windows` 0-d int32 tensors: `off` is the last
    window's start relative to the first's, and `delivered` and
    `next_rel` are relative to the last window's start."""
    if workload is not None and flows is not None:
        raise ValueError(
            "chain_windows composes workload= or flows=, not both: a "
            "workload riding a flow transport must interleave the phase "
            "credits between flow_recv and flow_emit, which is the "
            "scenario runner's split-form loop (workloads/runner.py)")
    wl, ws = workload if workload is not None else (None, None)
    ft, fs = flows if flows is not None else (None, None)
    ctab, cs = compute if compute is not None else (None, None)

    def step(st, planes, shift, window_ns, ridx):
        m, g, h, fr, ws, fs, cs = planes
        out = window_step(
            st, params, rng_seed, shift, window_ns, rr_enabled=rr_enabled,
            router_aqm=router_aqm, no_loss=no_loss, kernel=kernel,
            faults=faults, metrics=m, guards=g,
            hist=h, flightrec=fr,
            flows=(ft, fs) if fs is not None else None,
            compute=(ctab, cs) if cs is not None else None)
        (st, delivered, next_ev), m, g, h, fr, fs, cs = unpack_planes(
            out, metrics=m, guards=g, hist=h, flightrec=fr, flows=fs,
            compute=cs)
        idle = torch.full((), I32_MAX, dtype=torch.int32,
                          device=next_ev.device)
        if fs is not None:
            from . import flows as flows_mod  # flows imports this module

            # the flow emission may have re-armed an empty egress ring,
            # and a pending RTO deadline (relative to this window's end)
            # wakes the chain even with nothing in flight
            next_ev = torch.minimum(next_ev, torch.where(
                st.eg_valid.any(), idle.new_full((), window_ns), idle))
            rto_rel = flows_mod.next_deadline_rel_ns(ft, fs)
            wake = torch.where(
                rto_rel > I32_MAX // 2, idle,
                window_ns + torch.clamp(rto_rel, max=I32_MAX // 2))
            next_ev = torch.minimum(next_ev, wake)
        if ws is not None:
            from ..workloads import device as wdevice

            st, ws, *rest = wdevice.workload_step(
                wl, ws, st, delivered, ridx, window_ns, metrics=m, guards=g)
            if m is not None:
                m = rest.pop(0)
            if g is not None:
                g = rest.pop(0)
            # the emission may have re-armed an empty egress ring
            next_ev = torch.minimum(next_ev, torch.where(
                st.eg_valid.any(), idle.new_full((), window_ns), idle))
        return st, delivered, next_ev, (m, g, h, fr, ws, fs, cs)

    hs = min(horizon_rel, stop_rel)
    planes = (metrics, guards, hist, flightrec, ws, fs, cs)
    state, delivered, next_ev, planes = step(state, planes, shift0,
                                             window0_ns, round0)
    off, n = 0, 1
    while n < max_windows:
        # the one host read of a chained window: continue?, next event
        go, nxt = torch.stack([
            (~delivered["mask"].any() & (next_ev < hs - off)).to(
                torch.int32), next_ev]).tolist()
        if not go:
            break
        off += nxt
        window = min(runahead_ns, stop_rel - off)
        state, delivered, next_ev, planes = step(state, planes, nxt, window,
                                                 round0 + n)
        n += 1
    m, g, h, fr, ws, fs, cs = planes
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,
                                 device=next_ev.device)
    out = (state, delivered, i32(off), next_ev, i32(n))
    out += tuple(p for p in (m, g, h, fr) if p is not None)
    if workload is not None:
        out += (ws,)
    if flows is not None:
        out += (fs,)
    if compute is not None:
        out += (cs,)
    return out


def _record_hops(fr: FlightRecArrays, eg_dst, eg_seq, eg_tsend, sent, lost,
                 delivered, fault_dropped=None, aqm=None) -> FlightRecArrays:
    """Section 11: the sampled packets' hops of this window, candidates
    in the JAX layout order (routed, loss drops, fault drops when the
    fault plane runs, delivered, AQM drops under the router AQM), then
    the window counter. One sampling call covers every candidate slot.
    `aqm` is (src, seq, arrival, dropped) of the router's sorted rows:
    an AQM drop is stamped with its destination row and arrival."""
    N, CE = eg_dst.shape
    dev = eg_dst.device
    flat = lambda a: a.reshape(-1)
    rows = lambda shape: flat(_arange(N, eg_dst)[:, None].expand(shape))
    full = lambda n, h: torch.full((n,), h, dtype=torch.int32, device=dev)
    eg_hops = [(flightrec_mod.HOP_ROUTED, sent),
               (flightrec_mod.HOP_DROP_LOSS, lost)]
    if fault_dropped is not None:
        eg_hops.append((flightrec_mod.HOP_DROP_FAULT, fault_dropped))
    k = len(eg_hops)
    # (kind, src, seq, dst, t, mask, sampled by (src, seq)) per class
    d_src, d_seq = flat(delivered["src"]), flat(delivered["seq"])
    classes = [(flightrec_mod.HOP_DELIVERED, d_src, d_seq,
                rows(delivered["mask"].shape),
                flat(delivered["deliver_rel"]), flat(delivered["mask"]))]
    if aqm is not None:
        a_src, a_seq, a_t, a_mask = aqm
        classes.append((flightrec_mod.HOP_DROP_AQM, flat(a_src), flat(a_seq),
                        rows(a_src.shape), flat(a_t), flat(a_mask)))
    samp = flightrec_mod.sample_mask(
        fr, torch.cat([rows((N, CE))] + [c[1] for c in classes]),
        torch.cat([flat(eg_seq)] + [c[2] for c in classes]))
    samp_eg, samp = samp[:N * CE], samp[N * CE:]
    samp_c = torch.split(samp, [c[1].shape[0] for c in classes])
    fr = flightrec_mod.record_events(
        fr,
        torch.cat([full(N * CE, h) for h, _m in eg_hops]
                  + [full(c[1].shape[0], c[0]) for c in classes]),
        torch.cat([rows((N, CE))] * k + [c[1] for c in classes]),
        torch.cat([flat(eg_seq)] * k + [c[2] for c in classes]),
        torch.cat([flat(eg_dst)] * k + [c[3] for c in classes]),
        torch.cat([flat(eg_tsend)] * k + [c[4] for c in classes]),
        torch.cat([flat(m) & samp_eg for _h, m in eg_hops]
                  + [c[5] & sc for c, sc in zip(classes, samp_c)]))
    return flightrec_mod.advance_window(fr)

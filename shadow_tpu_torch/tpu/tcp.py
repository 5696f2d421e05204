"""The TCP connection state machine, batched over connections.

Counterpart of `shadow_tpu/tpu/tcp.py`: every scalar of the CPU machine
(`shadow_tpu/tcp/connection.py`) is a [C] tensor, and one step advances
C connections by one event each. The JAX package writes the machine on
one connection's scalars and `vmap`s it; here every function takes a
NamedTuple of [C] tensors ([C, S] for the reassembly and SACK slots)
and `_replace`s fields with per-connection `torch.where` selects: the
JAX scalar `_sel` under `vmap` is `sel_batched` here.

The uint32 wire values (`iss`, `irs`, `last_ts_recv`) are held as int64
tensors masked to 32 bits; `prims.u32` makes one from int32 bits and
`prims.wrap_i32` turns it back. Floor division follows jnp (`floordiv`).
JAX's data-dependent `while_loop`s become closed forms (the coverage
fixpoint of `_reass_drain` and `_sb_next`, `_avoid_tick`), so nothing
here reads a tensor back to decide whether to loop again. `lax.sort(..., num_keys=1, is_stable=True)` is a stable
`torch.sort` plus a gather, `associative_scan(max)` is `cummax`.

The flow plane (`flows.py`) reuses the Reno, RTT and RTO helpers and
their constants; the flow engine (`floweng.py`) steps the whole machine.
Kernel F (`csrc/tcp_fsm.cuh`) is the same machine written for one
connection of a CUDA thread: edit the two together.

The one loop of the Reno helpers, `_avoid_tick` (congestion avoidance's
"one more segment of window per window's worth of acks"), is solved in
closed form: the trip count k is the largest k >= 0 with
k*cwnd + k*(k-1)/2 <= acked, found by a float64 square root and
corrected to the exact integer by int64 comparisons.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .prims import I32_MAX, floordiv, u32, wrap_i32

#: Reno's initial window in segments (`shadow_tpu/tcp/cong.py:24`)
INITIAL_CWND = 10
#: "no slow-start threshold yet" (`shadow_tpu/tcp/cong.py:25`)
SSTHRESH_INF = 2**31 - 1
#: RFC 6298 timer bounds in ms (`shadow_tpu/tcp/rtt.py:23-25`)
RTO_INIT_MS = 1000
RTO_MIN_MS = 200
RTO_MAX_MS = 120000

# congestion phases
PH_SLOW_START, PH_AVOIDANCE, PH_RECOVERY = 0, 1, 2


def sel_batched(pred: torch.Tensor, a, b):
    """Per-field select of two NamedTuples of tensors: pred ? a : b,
    with the [F] predicate broadcast over each field's trailing axes. A
    field both sides share (the same tensor) is taken as it is, which
    saves a launch for every field a transition leaves alone."""
    def w(x, y):
        if x is y:
            return x
        return torch.where(pred.reshape(pred.shape + (1,) * (x.dim() - 1)),
                           x, y)
    return type(a)(*(w(x, y) for x, y in zip(a, b)))


def _set_rto(s, ms):
    return s._replace(rto_ms=torch.clamp(ms, RTO_MIN_MS, RTO_MAX_MS))


def _rto_from_estimate(srtt_ms, rttvar_ms):
    """srtt + 4 * max(rttvar, RTO_MIN / 4) (the Linux mdev floor)."""
    return srtt_ms + 4 * torch.clamp(rttvar_ms, min=RTO_MIN_MS // 4)


def _rtt_update(s, rtt_ms):
    """One RTT sample (callers gate on backoff_count == 0)."""
    rtt_ms = torch.clamp(rtt_ms, min=1)
    first = s.srtt_ms == 0
    rttvar = torch.where(
        first, floordiv(rtt_ms, 2),
        floordiv(3 * s.rttvar_ms, 4)
        + floordiv(torch.abs(s.srtt_ms - rtt_ms), 4))
    srtt = torch.where(first, rtt_ms,
                       floordiv(7 * s.srtt_ms, 8) + floordiv(rtt_ms, 8))
    s = s._replace(srtt_ms=srtt, rttvar_ms=rttvar,
                   backoff_count=torch.zeros_like(s.backoff_count))
    return _set_rto(s, _rto_from_estimate(srtt, rttvar))


def _rtt_backoff(s):
    s = s._replace(backoff_count=s.backoff_count + 1)
    return _set_rto(s, s.rto_ms * 2)


def _rtt_reset_backoff(s):
    had = s.backoff_count > 0
    s2 = s._replace(backoff_count=torch.zeros_like(s.backoff_count))
    s2 = _set_rto(s2, torch.where(
        s.srtt_ms > 0, _rto_from_estimate(s.srtt_ms, s.rttvar_ms),
        RTO_INIT_MS))
    return sel_batched(had, s2, s)


# -- Reno ------------------------------------------------------------------


def _avoid_tick(cwnd, acked, n):
    """`acked += n; while acked >= cwnd: acked -= cwnd; cwnd += 1`, per
    flow, for cwnd >= 1 and acked + n >= 0. After k trips acked has lost
    k*cwnd + k*(k-1)/2, so k is the largest integer with that sum <=
    acked: the positive root of k^2 + (2*cwnd - 1)*k - 2*acked, written
    as 4*acked / ((2*cwnd - 1) + sqrt(...)) so nothing cancels, then
    moved by one either way until the int64 test holds. Returns (cwnd',
    acked') as int32."""
    c = cwnd.to(torch.int64)
    a = acked.to(torch.int64) + n.to(torch.int64)
    b = torch.clamp(2 * c - 1, min=1).to(torch.float64)
    af = a.to(torch.float64)
    root = 4 * af / (b + torch.sqrt(b * b + 8 * af))
    k = torch.clamp(torch.floor(root), min=0).to(torch.int64)
    spent = lambda k: k * c + k * (k - 1) // 2
    k = torch.where(spent(k) > a, k - 1, k)
    k = torch.where(spent(k + 1) <= a, k + 1, k)
    return (c + k).to(torch.int32), (a - spent(k)).to(torch.int32)


def _cong_new_ack(s, n):
    """Reno on `n` newly acked segments: recovery deflates to ssthresh
    and enters avoidance carrying n; slow start grows by n, entering
    avoidance with the excess once it reaches ssthresh; avoidance ticks."""
    zero = torch.zeros_like(s.dup_acks)
    avoid = torch.full_like(s.phase, PH_AVOIDANCE)
    s0 = s._replace(dup_acks=zero)
    cw_r, aa_r = _avoid_tick(s0.ssthresh, zero, n)
    rec = s0._replace(cwnd=cw_r, phase=avoid, avoid_acked=aa_r)
    new_cwnd = s0.cwnd + n
    reach = new_cwnd >= s0.ssthresh
    cw_s, aa_s = _avoid_tick(s0.ssthresh, zero,
                             torch.clamp(new_cwnd - s0.ssthresh, min=0))
    ss_reach = s0._replace(cwnd=cw_s, phase=avoid, avoid_acked=aa_s)
    ss_stay = s0._replace(cwnd=new_cwnd)
    ss = sel_batched(reach, ss_reach, ss_stay)
    cw_a, aa_a = _avoid_tick(s0.cwnd, s0.avoid_acked, n)
    av = s0._replace(cwnd=cw_a, avoid_acked=aa_a)
    return sel_batched(s.phase == PH_RECOVERY, rec,
                       sel_batched(s.phase == PH_SLOW_START, ss, av))


def _cong_timeout(s):
    return s._replace(dup_acks=torch.zeros_like(s.dup_acks),
                      ssthresh=floordiv(s.cwnd, 2) + 1,
                      cwnd=torch.full_like(s.cwnd, INITIAL_CWND),
                      phase=torch.full_like(s.phase, PH_SLOW_START))


# -- timers ----------------------------------------------------------------


def _arm_rto(s, now_ms):
    return s._replace(rto_gen=s.rto_gen + 1,
                      rto_armed=torch.ones_like(s.rto_armed),
                      rto_deadline_ms=now_ms + s.rto_ms)


def _disarm_rto(s):
    return s._replace(rto_gen=s.rto_gen + 1,
                      rto_armed=torch.zeros_like(s.rto_armed))


def _arm_persist(s, now_ms):
    armed = s._replace(persist_gen=s.persist_gen + 1,
                       persist_armed=torch.ones_like(s.persist_armed),
                       persist_deadline_ms=now_ms + s.rto_ms)
    return sel_batched(s.persist_armed, s, armed)


def _cong_dup_ack(s):
    """Returns (state', fast_retransmit_now)."""
    in_rec = s.phase == PH_RECOVERY
    inflated = s._replace(cwnd=s.cwnd + 1)
    bumped = s._replace(dup_acks=s.dup_acks + 1)
    third = bumped.dup_acks == 3
    ssthresh = floordiv(s.cwnd, 2) + 1
    entered = bumped._replace(ssthresh=ssthresh, cwnd=ssthresh + 3,
                              phase=torch.full_like(s.phase, PH_RECOVERY))
    out = sel_batched(in_rec, inflated, sel_batched(third, entered, bumped))
    return out, ~in_rec & third


def _cong_partial_ack(s, n):
    return s._replace(cwnd=torch.clamp(s.cwnd - n + 1, min=1))


# ---------------------------------------------------------------------------
# the rest of the connection machine (`shadow_tpu/tpu/tcp.py:43-1272`)
# ---------------------------------------------------------------------------

#: the CPU machine's constants (`shadow_tpu/tcp/connection.py:32-36`)
MSS = 1460
TIME_WAIT_NS = 60 * 1_000_000_000
MAX_WSCALE = 14
SYN_RETRIES = 6
DATA_RETRIES = 15
TIME_WAIT_MS = TIME_WAIT_NS // 1_000_000
#: `TcpConfig`'s buffers and SACK default
#: (`shadow_tpu/tcp/connection.py:103-113`)
SEND_BUFFER = 131072
RECV_BUFFER = 174760
SACK_DEFAULT = True

REASS_SLOTS = 128  # >= recv_buffer/MSS: as many ranges as the window admits
SACK_SLOTS = 16  # sender scoreboard capacity (mirrors _SackScoreboard)
SACK_WIRE_BLOCKS = 3
SB_INF = 1 << 30  # scoreboard hole-cap sentinel (> any chunk)

# TcpFlags (bit-identical to the CPU enum)
FIN, SYN, RST, PSH, ACK, URG = 1, 2, 4, 8, 16, 32

# TcpState (bit-identical)
(CLOSED, LISTEN, SYN_SENT, SYN_RCVD, ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2,
 CLOSING, TIME_WAIT, CLOSE_WAIT, LAST_ACK) = range(11)

# event kinds
(EV_NONE, EV_OPEN_ACTIVE, EV_OPEN_PASSIVE, EV_WRITE, EV_READ, EV_CLOSE,
 EV_ABORT, EV_SEG, EV_PULL, EV_TIMER_RTO, EV_TIMER_PERSIST,
 EV_TIMER_TW) = range(12)

N_FIELDS = 16  # per-event int32 args (8 base + SACK)
N_OUT = 18  # PULL output fields

# segment kinds a PULL emits
K_NONE, K_RST, K_SYN, K_RETX, K_PROBE, K_DATA, K_FIN, K_ACK = range(8)

_U32 = 0xFFFFFFFF
_BOOL_FIELDS = ("error_consumed", "fin_requested", "fin_sent", "fin_acked",
                "syn_outstanding", "syn_acked", "retx_pending",
                "probe_pending", "rst_pending", "fin_received",
                "has_fin_offset", "ack_pending", "wscale_ok", "rto_armed",
                "persist_armed", "last_retx", "sack_on", "sack_ok")
#: the uint32 leaves, held as int64 masked to 32 bits
U32_FIELDS = ("iss", "irs", "last_ts_recv")


class TcpPlane(NamedTuple):
    """Per-connection scalars, axis 0 = connection (`TcpPlane` of
    `shadow_tpu/tpu/tcp.py:73`, field for field). Bools are bool, the
    uint32 wire values int64 in [0, 2**32), the rest int32."""

    state: torch.Tensor
    error: torch.Tensor
    error_consumed: torch.Tensor
    iss: torch.Tensor
    snd_una: torch.Tensor
    snd_nxt: torch.Tensor
    snd_wnd: torch.Tensor
    stream_len: torch.Tensor
    snd_max: torch.Tensor
    fin_requested: torch.Tensor
    fin_sent: torch.Tensor
    fin_acked: torch.Tensor
    syn_outstanding: torch.Tensor
    syn_sends: torch.Tensor
    syn_acked: torch.Tensor
    retx_pending: torch.Tensor
    probe_pending: torch.Tensor
    recover: torch.Tensor
    gbn_high: torch.Tensor
    rst_pending: torch.Tensor
    irs: torch.Tensor
    rcv_nxt: torch.Tensor
    ordered_bytes: torch.Tensor
    reass_bytes: torch.Tensor
    fin_received: torch.Tensor
    has_fin_offset: torch.Tensor
    fin_offset: torch.Tensor
    ack_pending: torch.Tensor
    my_wscale: torch.Tensor
    peer_wscale: torch.Tensor
    wscale_ok: torch.Tensor
    last_ts_recv: torch.Tensor
    srtt_ms: torch.Tensor
    rttvar_ms: torch.Tensor
    rto_ms: torch.Tensor
    backoff_count: torch.Tensor
    cwnd: torch.Tensor
    ssthresh: torch.Tensor
    phase: torch.Tensor
    dup_acks: torch.Tensor
    avoid_acked: torch.Tensor
    rto_gen: torch.Tensor
    rto_armed: torch.Tensor
    rto_deadline_ms: torch.Tensor
    persist_gen: torch.Tensor
    persist_armed: torch.Tensor
    persist_deadline_ms: torch.Tensor
    retransmit_count: torch.Tensor
    retransmitted_bytes: torch.Tensor
    last_retx: torch.Tensor
    sack_on: torch.Tensor
    sack_ok: torch.Tensor
    sacked_s: torch.Tensor  # [C, SACK_SLOTS]
    sacked_e: torch.Tensor
    reass_off: torch.Tensor  # [C, reass_slots] (len 0 = free slot)
    reass_len: torch.Tensor


def make_tcp_plane(n_conns: int, sack: bool = SACK_DEFAULT,
                   reass_slots: int = REASS_SLOTS, device=None) -> TcpPlane:
    """C fresh connections (`make_tcp_plane` of `shadow_tpu/tpu/tcp.py`).
    `reass_slots` sizes the out-of-order range store; the flow engine
    passes a small one (its GSO wires produce few disjoint ranges)."""
    from .. import resolve_device

    dev = resolve_device(device)
    i32 = lambda v=0: torch.full((n_conns,), v, dtype=torch.int32,
                                 device=dev)
    flag = lambda v=False: torch.full((n_conns,), v, dtype=torch.bool,
                                      device=dev)
    u = lambda: torch.zeros((n_conns,), dtype=torch.int64, device=dev)
    slots = lambda n: torch.zeros((n_conns, n), dtype=torch.int32,
                                  device=dev)
    ws = 0  # my_wscale from recv_buffer, as TcpConnection.__init__
    while (RECV_BUFFER >> ws) > 0xFFFF and ws < MAX_WSCALE:
        ws += 1
    return TcpPlane(
        state=i32(), error=i32(), error_consumed=flag(),
        iss=u(), snd_una=i32(), snd_nxt=i32(), snd_wnd=i32(MSS),
        stream_len=i32(), snd_max=i32(), fin_requested=flag(),
        fin_sent=flag(), fin_acked=flag(), syn_outstanding=flag(),
        syn_sends=i32(), syn_acked=flag(), retx_pending=flag(),
        probe_pending=flag(), recover=i32(), gbn_high=i32(),
        rst_pending=flag(), irs=u(), rcv_nxt=i32(), ordered_bytes=i32(),
        reass_bytes=i32(), fin_received=flag(), has_fin_offset=flag(),
        fin_offset=i32(), ack_pending=flag(), my_wscale=i32(ws),
        peer_wscale=i32(), wscale_ok=flag(), last_ts_recv=u(),
        srtt_ms=i32(), rttvar_ms=i32(), rto_ms=i32(RTO_INIT_MS),
        backoff_count=i32(), cwnd=i32(INITIAL_CWND),
        ssthresh=i32(SSTHRESH_INF), phase=i32(), dup_acks=i32(),
        avoid_acked=i32(), rto_gen=i32(), rto_armed=flag(),
        rto_deadline_ms=i32(), persist_gen=i32(), persist_armed=flag(),
        persist_deadline_ms=i32(), retransmit_count=i32(),
        retransmitted_bytes=i32(), last_retx=flag(), sack_on=flag(sack),
        sack_ok=flag(), sacked_s=slots(SACK_SLOTS),
        sacked_e=slots(SACK_SLOTS), reass_off=slots(reass_slots),
        reass_len=slots(reass_slots))


def retransmits_by_host(plane: TcpPlane, conn_host: torch.Tensor,
                        n_hosts: int) -> torch.Tensor:
    """Per-host retransmission totals [N] int32 from the per-connection
    counters [C] (`conn_host` maps each connection to its sending
    host); a host index outside [0, n_hosts) is dropped, as JAX's
    segment_sum drops it."""
    idx = conn_host.to(torch.int64)
    keep = (idx >= 0) & (idx < n_hosts)
    out = torch.zeros(n_hosts + 1, dtype=torch.int64,
                      device=plane.retransmit_count.device)
    out.index_add_(0, torch.where(keep, idx, n_hosts),
                   plane.retransmit_count.to(torch.int64))
    return out[:n_hosts].to(torch.int32)


# -- helpers over [C] ------------------------------------------------------

_sel = sel_batched
_W = torch.where


def _full(ref, v):
    return torch.full_like(ref, v)


def _col(x):
    return x[:, None]


def _first_true(mask):
    """jnp.argmax of a bool row: the first True, 0 when there is none."""
    return torch.argmax(mask.to(torch.int32), dim=1)


def _at(idx, width, device):
    """[C, width] one-hot of the [C] column indices."""
    return torch.arange(width, device=device)[None, :] == idx[:, None]


def _wire_seq(s, off):
    return (s.iss + (1 + off).to(torch.int64)) & _U32


def _wire_ack(s):
    off = s.rcv_nxt + s.fin_received.to(torch.int32)
    return (s.irs + (1 + off).to(torch.int64)) & _U32


def _wire_rcv_nxt(s):
    return (s.irs + (1 + s.rcv_nxt).to(torch.int64)) & _U32


def _recv_space(s):
    return torch.clamp(RECV_BUFFER - (s.ordered_bytes + s.reass_bytes),
                       min=0)


def _advertised_window(s, for_syn: bool):
    shift = (torch.zeros_like(s.my_wscale) if for_syn
             else _W(s.wscale_ok, s.my_wscale, 0))
    return torch.clamp(torch.bitwise_right_shift(_recv_space(s), shift),
                       max=0xFFFF)


def _send_space(s):
    return torch.clamp(SEND_BUFFER - (s.stream_len - s.snd_una), min=0)


# -- reassembly (coverage math over fixed (off, len) slots) ----------------

def _reass_insert(s, off, length):
    """_Reassembly.insert with extend-on-touch coalescing: a range that
    overlaps or touches live slots is unioned into the first of them and
    the others are cleared; otherwise it takes the first free slot, and
    is dropped when there is none (the peer retransmits)."""
    ro, rl = s.reass_off, s.reass_len
    S = ro.shape[1]
    end = off + length
    live = rl > 0
    touch = live & (ro <= _col(end)) & (_col(off) <= ro + rl)
    has_touch = touch.any(1)
    at_t = _at(_first_true(touch), S, ro.device)
    new_off = torch.minimum(_W(touch, ro, _col(off)).amin(1), off)
    new_end = torch.maximum(_W(touch, ro + rl, _col(end)).amax(1), end)
    ext_off = _W(at_t, _col(new_off), ro)
    ext_len = _W(at_t, _col(new_end - new_off), rl)
    ext_len = _W(touch & ~at_t, 0, ext_len)
    free = rl == 0
    do_ins = ~has_touch & free.any(1)
    at_f = _at(_first_true(free), S, ro.device) & _col(do_ins)
    ins_off = _W(at_f, _col(off), ro)
    ins_len = _W(at_f, _col(length), rl)
    off_out = _W(_col(has_touch), ext_off, ins_off)
    len_out = _W(_col(has_touch), ext_len, ins_len)
    bytes_out = _W(len_out > 0, len_out, 0).sum(1).to(torch.int32)
    return s._replace(reass_off=off_out, reass_len=len_out,
                      reass_bytes=bytes_out)


def _cover_fixpoint(starts, ends, live, off):
    """The fixpoint of JAX's convergent loop `off = max(off, max end of
    the live ranges covering off)`, in closed form. Each pass raises off
    to G(off), the largest end of the live ranges starting at or below
    it, so with the ranges sorted by start and M_i the running maximum
    of their ends, the loop stops at the first i >= j0 (j0 = the last
    range starting at or below off) whose successor starts above
    max(off, M_i); it ends at max(off, M_i), or at off when no range
    starts at or below off."""
    st, order = torch.sort(_W(live, starts, I32_MAX), dim=1, stable=True)
    en = _W(live, ends, torch.iinfo(torch.int32).min)
    m = torch.cummax(torch.gather(en, 1, order), dim=1).values
    reach = torch.maximum(m, _col(off))
    nxt = torch.cat([st[:, 1:], torch.full_like(st[:, :1], I32_MAX)], 1)
    upto = (st <= _col(off)).sum(1)  # j0 + 1
    idx = torch.arange(st.shape[1], device=st.device)[None, :]
    stop = (nxt > reach) & (idx >= _col(upto - 1))
    i_star = _first_true(stop)
    got = torch.gather(reach, 1, i_star[:, None])[:, 0]
    return _W(upto > 0, got, off)


def _reass_drain(s):
    """_Reassembly.drain_from(rcv_nxt): advance through contiguous
    coverage and drop consumed slots. Returns (state', advanced). JAX's
    convergent while_loop is `_cover_fixpoint`."""
    ro, rl = s.reass_off, s.reass_len
    live = rl > 0
    ends = ro + rl
    off0 = s.rcv_nxt
    off = _cover_fixpoint(ro, ends, live, off0)
    keep = live & (ends > _col(off))
    new_len = _W(keep, rl, 0)
    adv = off - off0
    return s._replace(
        rcv_nxt=off, reass_len=new_len,
        reass_bytes=new_len.sum(1).to(torch.int32),
        ordered_bytes=s.ordered_bytes + adv), adv


# -- SACK scoreboard (slot-for-slot mirror of _SackScoreboard) -------------

def _sb_insert(ss, se, start, end, una):
    start = torch.maximum(start, una)
    S = ss.shape[1]
    valid = start < end
    live = se > ss
    contained = (live & (ss <= _col(start)) & (_col(end) <= se)).any(1)
    overlap = live & (_col(start) <= se) & (ss <= _col(end))
    has_ov = overlap.any(1)
    at_o = _at(_first_true(overlap), S, ss.device)
    ext_s = _W(at_o, torch.minimum(ss, _col(start)), ss)
    ext_e = _W(at_o, torch.maximum(se, _col(end)), se)
    empty = ~live
    at_e = _at(_first_true(empty), S, ss.device)
    ins_s = _W(at_e, _col(start), ss)
    ins_e = _W(at_e, _col(end), se)
    do_ext = _col(valid & ~contained & has_ov)
    do_ins = _col(valid & ~contained & ~has_ov & empty.any(1))
    return (_W(do_ext, ext_s, _W(do_ins, ins_s, ss)),
            _W(do_ext, ext_e, _W(do_ins, ins_e, se)))


def _sb_prune(ss, se, una):
    live = se > ss
    s2 = _W(live, torch.maximum(ss, _col(una)), ss)
    dead = live & (s2 >= se)
    return _W(dead, 0, s2), _W(dead, 0, se)


def _sb_next(ss, se, off):
    """(off', cap): first unSACKed offset >= off (`_cover_fixpoint`), and
    the bytes to the next range above (SB_INF when none)."""
    live = se > ss
    off = _cover_fixpoint(ss, se, live, off)
    above = live & (ss > _col(off))
    cap = _W(above, ss - _col(off), SB_INF).amin(1)
    return off, cap


def _recv_sack_blocks(s):
    """Receiver SACK blocks (mirror of _sack_blocks): reassembly ranges
    sorted ascending (stable), touching ranges merged, the lowest three
    reported. Returns (nsack [C], wire starts [C, 3], wire ends [C, 3])
    as int32 wire bits."""
    live = s.reass_len > 0
    starts = _W(live, s.reass_off, I32_MAX)
    ends = _W(live, s.reass_off + s.reass_len, 0)
    starts, order = torch.sort(starts, dim=1, stable=True)
    ends = torch.gather(ends, 1, order)
    valid = starts < I32_MAX
    incl_max = torch.cummax(ends, dim=1).values
    prev_max = torch.cat([torch.full_like(incl_max[:, :1], -1),
                          incl_max[:, :-1]], dim=1)
    is_new = valid & (starts > prev_max)
    block = torch.cumsum(is_new.to(torch.int32), dim=1) - 1
    cnt = is_new.sum(1).to(torch.int32)
    idx3 = torch.arange(SACK_WIRE_BLOCKS, device=starts.device)
    in_blk = valid[:, None, :] & (block[:, None, :] == idx3[None, :, None])
    m_s = _W(in_blk, starts[:, None, :], I32_MAX).amin(2)
    m_s = _W(idx3[None, :] < _col(cnt), m_s, 0)
    m_e = _W(in_blk, ends[:, None, :], 0).amax(2)
    n = torch.clamp(cnt, max=SACK_WIRE_BLOCKS)
    base = _col(s.irs + 1)
    sel = idx3[None, :] < _col(n)
    ws = _W(sel, wrap_i32(base + u32(m_s)), 0)
    we = _W(sel, wrap_i32(base + u32(m_e)), 0)
    has = s.sack_ok & (cnt > 0)
    return _W(has, n, 0), _W(_col(has), ws, 0), _W(_col(has), we, 0)


# ---------------------------------------------------------------------------
# event handlers (mirror TcpConnection method for method)
# ---------------------------------------------------------------------------

def _enter_closed(s, errno: int):
    """errno 0 = none."""
    s2 = _disarm_rto(s._replace(state=_full(s.state, CLOSED)))
    error = s.error if errno == 0 else _W(s.error == 0, errno, s.error)
    return s2._replace(error=error, persist_gen=s2.persist_gen + 1)


def _enter_time_wait(s, now_ms):
    s2 = _disarm_rto(s._replace(state=_full(s.state, TIME_WAIT)))
    # the TIME_WAIT timer rides the rto generation (connection.py:867-874)
    return s2._replace(rto_deadline_ms=now_ms + TIME_WAIT_MS)


def _ev_open_active(s, f, now_ms):
    s = s._replace(iss=u32(f[:, 0]), state=_full(s.state, SYN_SENT))
    return _arm_rto(s, now_ms)


def _ev_open_passive(s, f, now_ms):
    # f: iss, syn_seq, syn_window, wscale(-1 none), ts, ts_echo, sack_perm
    has_ws = f[:, 3] >= 0
    s = s._replace(
        iss=u32(f[:, 0]), irs=u32(f[:, 1]),
        rcv_nxt=torch.zeros_like(s.rcv_nxt),
        peer_wscale=_W(has_ws, torch.clamp(f[:, 3], max=MAX_WSCALE),
                       s.peer_wscale),
        wscale_ok=has_ws,
        my_wscale=_W(has_ws, s.my_wscale, 0),
        snd_wnd=f[:, 2],
        last_ts_recv=_W(f[:, 4] != 0, u32(f[:, 4]), s.last_ts_recv),
        sack_ok=(f[:, 6] != 0) & s.sack_on,
        state=_full(s.state, SYN_RCVD))
    return _arm_rto(s, now_ms)


def _ev_write(s, f, now_ms):
    """Returns (state', accepted-or-negative-errno)."""
    err = s.error != 0
    notconn = (s.state == CLOSED) | (s.state == LISTEN)
    pipe = s.fin_requested
    n = torch.minimum(_send_space(s), f[:, 0])
    accepted = s._replace(stream_len=s.stream_len + n)
    accepted = _sel((n > 0) & (s.snd_wnd == 0) & (s.state >= ESTABLISHED),
                    _arm_persist(accepted, now_ms), accepted)
    ret = _W(err, -s.error, _W(notconn, -107, _W(pipe, -32, n)))
    return _sel(err | notconn | pipe, s, accepted), ret


def _ev_read(s, f):
    """Returns (state', got-or-negative-errno)."""
    err_path = (s.error != 0) & (s.ordered_bytes == 0)
    raise_now = err_path & ~s.error_consumed
    got = torch.minimum(f[:, 0], s.ordered_bytes)
    drained = s._replace(ordered_bytes=s.ordered_bytes - got,
                         ack_pending=s.ack_pending | (got > 0))
    out = _sel(err_path,
               s._replace(error_consumed=torch.ones_like(s.error_consumed)),
               drained)
    ret = _W(raise_now, -s.error, _W(err_path, 0, got))
    return out, ret


def _ev_close(s):
    st = s.state
    trivially = (st == CLOSED) | (st == LISTEN)
    nxt = _W((st == ESTABLISHED) | (st == SYN_RCVD), FIN_WAIT_1,
             _W(st == CLOSE_WAIT, LAST_ACK, st))
    closed = s._replace(state=_full(st, CLOSED))
    requested = s._replace(fin_requested=torch.ones_like(s.fin_requested),
                           state=nxt)
    return _sel(trivially, closed,
                _sel(st == SYN_SENT, _enter_closed(s, 0),
                     _sel(s.fin_requested, s, requested)))


def _ev_abort(s):
    st = s.state
    trivially = (st == CLOSED) | (st == LISTEN) | (st == TIME_WAIT)
    return _sel(trivially, s._replace(state=_full(st, CLOSED)),
                s._replace(rst_pending=torch.ones_like(s.rst_pending)))


# -- segment ingress -------------------------------------------------------

def _unwrap_ack(s, wire_ack_u):
    """(ignore, adv, is_eq): ignore = an ack of bytes never sent; adv =
    forward stream bytes acked (0 when backward or equal); is_eq = the
    ack sits exactly at snd_una."""
    delta = (wire_ack_u - _wire_seq(s, s.snd_una)) & _U32
    is_fwd = delta < (1 << 31)
    limit = u32(torch.maximum(s.snd_nxt, s.snd_max) - s.snd_una)
    fwd_valid = is_fwd & (delta <= limit)
    adv = _W(fwd_valid, wrap_i32(delta), 0)
    return is_fwd & ~fwd_valid, adv, fwd_valid & (delta == 0)


def _process_ack(s, f, now_ms):
    wire_ack = u32(f[:, 2])
    paylen, wnd = f[:, 4], f[:, 3]
    ts_echo = f[:, 7]
    ignore, adv, is_eq = _unwrap_ack(s, wire_ack)
    ack_off = s.snd_una + adv

    # SYN_RCVD completing ACK: any FORWARD-valid ack (connection.py:644)
    complete = (s.state == SYN_RCVD) & (is_eq | (adv > 0))
    s_hs = s._replace(syn_acked=torch.ones_like(s.syn_acked),
                      state=_full(s.state, ESTABLISHED))
    s_hs = _disarm_rto(s_hs)
    s_hs = _sel((ts_echo != 0) & (s_hs.backoff_count == 0),
                _rtt_update(s_hs, now_ms - ts_echo), s_hs)
    s = _sel(complete, s_hs, s)

    # SACK blocks -> scoreboard, clipped at the PRE-advance snd_una
    base0 = _wire_seq(s, torch.zeros_like(s.snd_una))
    limit = torch.maximum(s.snd_nxt, s.snd_max)
    ss, se = s.sacked_s, s.sacked_e
    nsack = f[:, 9]
    for k in range(SACK_WIRE_BLOCKS):
        s_off = wrap_i32(u32(f[:, 10 + 2 * k]) - base0)
        e_off = wrap_i32(u32(f[:, 11 + 2 * k]) - base0)
        bval = (s.sack_ok & ~ignore & (k < nsack) & (s_off >= 0)
                & (e_off >= 0) & (s_off < e_off) & (e_off <= limit))
        ns, ne = _sb_insert(ss, se, s_off, e_off, s.snd_una)
        ss = _W(_col(bval), ns, ss)
        se = _W(_col(bval), ne, se)
    s = s._replace(sacked_s=ss, sacked_e=se)

    fin_off = s.stream_len + 1
    new_window = torch.bitwise_left_shift(
        wnd, _W(s.wscale_ok, s.peer_wscale, 0))

    # --- new data acked -------------------------------------------------
    newly = adv > 0
    acked_bytes = torch.minimum(ack_off, s.stream_len) - s.snd_una
    a = s._replace(snd_una=torch.minimum(ack_off, s.stream_len))
    ack_covers_fin = s.fin_sent & (ack_off >= fin_off)
    a = a._replace(fin_acked=a.fin_acked | ack_covers_fin,
                   snd_una=_W(ack_covers_fin, a.stream_len, a.snd_una))
    a = a._replace(snd_nxt=torch.maximum(a.snd_nxt, a.snd_una))
    pr_s, pr_e = _sb_prune(a.sacked_s, a.sacked_e, a.snd_una)
    a = a._replace(sacked_s=pr_s, sacked_e=pr_e)
    n_seg = floordiv(acked_bytes + MSS - 1, MSS)
    partial = (a.phase == PH_RECOVERY) & (ack_off < a.recover)
    a_partial = _cong_partial_ack(a, n_seg)._replace(
        retx_pending=torch.ones_like(a.retx_pending))
    a_full = _cong_new_ack(a, n_seg)._replace(
        retx_pending=torch.zeros_like(a.retx_pending))
    a = _sel(acked_bytes > 0, _sel(partial, a_partial, a_full),
             a._replace(retx_pending=torch.zeros_like(a.retx_pending)))
    a = _sel((ts_echo != 0) & (a.backoff_count == 0),
             _rtt_update(a, now_ms - ts_echo), a)
    a = _rtt_reset_backoff(a)
    in_flight = (a.snd_nxt > a.snd_una) | (a.fin_sent & ~a.fin_acked)
    a = _sel(in_flight, _arm_rto(a, now_ms), _disarm_rto(a))
    # FIN-acked transitions
    a = _sel(a.fin_acked & (a.state == FIN_WAIT_1),
             a._replace(state=_full(a.state, FIN_WAIT_2)),
             _sel(a.fin_acked & (a.state == CLOSING),
                  _enter_time_wait(a, now_ms),
                  _sel(a.fin_acked & (a.state == LAST_ACK),
                       _enter_closed(a, 0), a)))

    # --- duplicate ack --------------------------------------------------
    dup = (is_eq & (paylen == 0) & (s.snd_nxt > s.snd_una)
           & (new_window == s.snd_wnd) & (new_window > 0))
    d, fast = _cong_dup_ack(s)
    d = _sel(fast, d._replace(retx_pending=torch.ones_like(d.retx_pending),
                              recover=d.snd_nxt), d)

    out = _sel(newly, a, _sel(dup, d, s))
    out = out._replace(snd_wnd=new_window)
    out = _sel((out.snd_wnd == 0) & (out.stream_len > out.snd_nxt),
               _arm_persist(out, now_ms), out)
    return _sel(ignore, s, out)


def _process_payload(s, f, now_ms):
    seq_u, paylen = u32(f[:, 1]), f[:, 4]
    tw = s.state == TIME_WAIT
    base = _wire_rcv_nxt(s)
    delta = (seq_u - base) & _U32
    is_fwd = delta < (1 << 31)
    back = wrap_i32(base - seq_u)  # valid when ~is_fwd
    delta_i = wrap_i32(delta)

    # backward: trim left by `back`; forward: starts `delta` into the space
    pure_dup = ~is_fwd & (back >= paylen)
    space = _recv_space(s)
    beyond = is_fwd & (delta_i >= space)
    eff_off = _W(is_fwd, s.rcv_nxt + delta_i, s.rcv_nxt)
    raw_len = _W(is_fwd, paylen, paylen - back)
    # right-trim to the receive window in both cases
    eff_len = torch.minimum(raw_len, space - (eff_off - s.rcv_nxt))
    ok = ~tw & ~pure_dup & ~beyond & (eff_len > 0)

    ins, _adv = _reass_drain(_reass_insert(s, eff_off, eff_len))
    out = _sel(ok, ins, s)
    out = out._replace(ack_pending=torch.ones_like(out.ack_pending))
    return _sel(tw | pure_dup | beyond, out, _maybe_apply_fin_t(out, now_ms))


def _maybe_apply_fin_t(s, now_ms):
    """_maybe_apply_pending_fin (the clock only feeds TIME_WAIT's
    deadline)."""
    applies = ~s.fin_received & s.has_fin_offset & (s.fin_offset
                                                    <= s.rcv_nxt)
    a = s._replace(fin_received=torch.ones_like(s.fin_received))
    est = a.state == ESTABLISHED
    fw1 = a.state == FIN_WAIT_1
    fw2 = a.state == FIN_WAIT_2
    a = _sel(est, a._replace(state=_full(a.state, CLOSE_WAIT)),
             _sel(fw1 & a.fin_acked, _enter_time_wait(a, now_ms),
                  _sel(fw1, a._replace(state=_full(a.state, CLOSING)),
                       _sel(fw2, _enter_time_wait(a, now_ms), a))))
    return _sel(applies, a, s)


def _process_fin(s, f, now_ms):
    seq_u, paylen = u32(f[:, 1]), f[:, 4]
    end = (seq_u + u32(paylen)) & _U32
    delta = (end - _wire_rcv_nxt(s)) & _U32
    is_fwd = delta < (1 << 31)
    # clamp bogus-huge forward offsets below int32 overflow; they can
    # never apply (fin_offset > rcv_nxt forever), matching the CPU
    dd = torch.clamp(delta & 0x7FFFFFFF, max=1 << 30).to(torch.int32)
    fin_off = _W(is_fwd, s.rcv_nxt + dd, s.rcv_nxt)
    s = s._replace(
        fin_offset=_W(s.has_fin_offset, s.fin_offset, fin_off),
        has_fin_offset=torch.ones_like(s.has_fin_offset),
        ack_pending=torch.ones_like(s.ack_pending))
    return _maybe_apply_fin_t(s, now_ms)


def _on_segment_syn_sent(s, f, now_ms):
    flags = f[:, 0]
    is_rst = (flags & RST) != 0
    is_syn = (flags & SYN) != 0
    is_ack = (flags & ACK) != 0
    ack_u = u32(f[:, 2])
    expect = (s.iss + 1) & _U32
    r = _sel(is_rst & is_ack & (ack_u == expect), _enter_closed(s, 111), s)

    has_ws = f[:, 5] >= 0
    peer_ws = _W(has_ws, torch.clamp(f[:, 5], max=MAX_WSCALE),
                 s.peer_wscale)
    sack_ok = (f[:, 8] != 0) & s.sack_on
    zero = torch.zeros_like(s.rcv_nxt)
    # SYN|ACK
    sa = s._replace(
        irs=u32(f[:, 1]), rcv_nxt=zero,
        syn_acked=torch.ones_like(s.syn_acked),
        syn_outstanding=torch.zeros_like(s.syn_outstanding),
        peer_wscale=peer_ws, wscale_ok=has_ws,
        my_wscale=_W(has_ws, s.my_wscale, 0), sack_ok=sack_ok,
        snd_wnd=f[:, 3], state=_full(s.state, ESTABLISHED),
        ack_pending=torch.ones_like(s.ack_pending))
    sa = _disarm_rto(sa)
    sa = _sel((f[:, 7] != 0) & (sa.backoff_count == 0),
              _rtt_update(sa, now_ms - f[:, 7]), sa)
    sa = _sel(ack_u != expect,
              s._replace(rst_pending=torch.ones_like(s.rst_pending)), sa)
    # simultaneous open (SYN, no ACK)
    so = s._replace(
        irs=u32(f[:, 1]), rcv_nxt=zero, peer_wscale=peer_ws,
        wscale_ok=has_ws, sack_ok=sack_ok, snd_wnd=f[:, 3],
        state=_full(s.state, SYN_RCVD),
        syn_outstanding=torch.zeros_like(s.syn_outstanding),
        syn_sends=torch.zeros_like(s.syn_sends))
    return _sel(is_rst, r, _sel(is_syn & is_ack, sa, _sel(is_syn, so, s)))


def _ev_segment(s, f, now_ms):
    closed = s.state == CLOSED
    # record the peer timestamp to echo (f[6] = ts)
    s1 = s._replace(last_ts_recv=_W(f[:, 6] != 0, u32(f[:, 6]),
                                    s.last_ts_recv))
    syn_sent = s1.state == SYN_SENT
    ss = _on_segment_syn_sent(s1, f, now_ms)

    flags = f[:, 0]
    # RST in any synchronized state
    is_rst = (flags & RST) != 0
    tw = s1.state == TIME_WAIT
    r = _sel(tw, _enter_closed(s1, 0), _enter_closed(s1, 104))

    # SYN outside the handshake
    is_syn = (flags & SYN) != 0
    dup_syn = (s1.state == SYN_RCVD) & (u32(f[:, 1]) == s1.irs)
    syn_dup = s1._replace(syn_outstanding=torch.zeros_like(
        s1.syn_outstanding))
    # an old duplicate SYN below the window is answered with an ACK,
    # never a RST (RFC 793 p.69 / RFC 5961)
    syn_delta = (_wire_rcv_nxt(s1) - u32(f[:, 1])) & _U32
    syn_is_old = (syn_delta != 0) & (syn_delta < (1 << 31))
    syn_old = s1._replace(ack_pending=torch.ones_like(s1.ack_pending))
    syn_other = _sel(tw, s1, _sel(syn_is_old, syn_old, s1._replace(
        rst_pending=torch.ones_like(s1.rst_pending))))
    sy = _sel(dup_syn, syn_dup, syn_other)

    # normal path
    n = s1
    n = _sel((flags & ACK) != 0, _process_ack(n, f, now_ms), n)
    n = _sel(f[:, 4] > 0, _process_payload(n, f, now_ms), n)
    n = _sel((flags & FIN) != 0, _process_fin(n, f, now_ms), n)

    out = _sel(syn_sent, ss, _sel(is_rst, r, _sel(is_syn, sy, n)))
    # RFC 793: a non-RST segment at a CLOSED connection elicits a RESET;
    # the CPU twin returns before recording the timestamp, hence `s`
    closed_rst = s._replace(rst_pending=s.rst_pending | ~is_rst)
    return _sel(closed, closed_rst, out)


# -- timers ----------------------------------------------------------------

def _ev_timer_rto(s, f, now_ms):
    stale = (f[:, 0] != s.rto_gen) | (s.state == CLOSED)
    a = s._replace(rto_armed=torch.zeros_like(s.rto_armed))
    handshake = (a.state == SYN_SENT) | (a.state == SYN_RCVD)
    in_flight = ((a.snd_nxt > a.snd_una) | (a.fin_sent & ~a.fin_acked)
                 | handshake)
    limit = _W(handshake, SYN_RETRIES, DATA_RETRIES)
    give_up = a.backoff_count >= limit
    gu = _enter_closed(a, 110)

    b = _cong_timeout(_rtt_backoff(a))
    hs = b._replace(syn_outstanding=torch.zeros_like(b.syn_outstanding))
    gbn = b._replace(
        gbn_high=torch.maximum(b.gbn_high, b.snd_nxt), snd_nxt=b.snd_una,
        retx_pending=torch.zeros_like(b.retx_pending),
        fin_sent=b.fin_sent & b.fin_acked)
    gbn = _sel((gbn.snd_wnd == 0) & (gbn.stream_len > gbn.snd_nxt),
               _arm_persist(gbn, now_ms), gbn)
    b = _arm_rto(_sel(handshake, hs, gbn), now_ms)
    fired = _sel(give_up, gu, b)
    return _sel(stale, s, _sel(in_flight, fired, a))


def _ev_timer_tw(s, f, now_ms):
    return _sel(f[:, 0] == s.rto_gen, _enter_closed(s, 0), s)


def _ev_timer_persist(s, f, now_ms):
    stale = (f[:, 0] != s.persist_gen) | (s.state == CLOSED)
    a = s._replace(persist_armed=torch.zeros_like(s.persist_armed))
    due = (a.snd_wnd == 0) & (a.stream_len > a.snd_nxt)
    b = _rtt_backoff(a._replace(
        probe_pending=torch.ones_like(a.probe_pending)))
    b = b._replace(persist_gen=b.persist_gen + 1,
                   persist_armed=torch.ones_like(b.persist_armed),
                   persist_deadline_ms=now_ms + b.rto_ms)
    return _sel(stale, s, _sel(due, b, a))


# -- egress (PULL = next_segment) ------------------------------------------

def _next_kind(s):
    st = s.state
    hs = (st == SYN_SENT) | (st == SYN_RCVD)
    can_data = (
        ((st == ESTABLISHED) | (st == CLOSE_WAIT) | (st == FIN_WAIT_1)
         | (st == CLOSING) | (st == LAST_ACK))
        & (s.snd_nxt < s.stream_len)
        & (s.snd_nxt - s.snd_una < torch.minimum(s.cwnd * MSS, s.snd_wnd)))
    should_fin = (s.fin_requested & ~s.fin_sent
                  & (s.snd_nxt >= s.stream_len)
                  & ((st == FIN_WAIT_1) | (st == LAST_ACK)
                     | (st == CLOSING)))
    k = torch.full_like(st, K_NONE)
    k = _W(s.ack_pending & (st != CLOSED), K_ACK, k)
    k = _W(should_fin, K_FIN, k)
    k = _W(can_data, K_DATA, k)
    k = _W(s.probe_pending & (s.stream_len > s.snd_nxt), K_PROBE, k)
    k = _W(s.retx_pending & (s.snd_nxt > s.snd_una), K_RETX, k)
    k = _W(st == SYN_SENT, K_NONE, k)
    k = _W(hs & ~s.syn_outstanding, K_SYN, k)
    return _W(s.rst_pending, K_RST, k)


def _ev_pull(s, now_ms, gso_segs: int = 1):
    """next_segment(): returns (state', out [C, 18]): out = (has, flags,
    seq (u32 bits), ack, window, paylen, wscale (-1), ts, ts_echo,
    retransmit, sack_permitted, nsack, s1, e1, s2, e2, s3, e3).

    gso_segs > 1 emits one TSO/GSO-style macro-segment of up to
    gso_segs*MSS contiguous payload per pull (the flow engine's wire);
    retransmissions stay single-MSS."""
    kind = _next_kind(s)
    before_nxt = s.snd_nxt
    zero = torch.zeros_like(s.state)
    one = torch.ones_like(s.state)
    minus1 = torch.full_like(s.state, -1)
    i32 = lambda b: b.to(torch.int32)
    ts = (now_ms & 0x7FFFFFFF, wrap_i32(s.last_ts_recv))
    wack = wrap_i32(_wire_ack(s))
    awnd = _advertised_window(s, False)
    fin_seq = lambda st: torch.minimum(st.snd_nxt, st.stream_len
                                       + i32(st.fin_sent))

    nb_blk, ws_blk, we_blk = _recv_sack_blocks(s)
    sack_tail = (zero, nb_blk, ws_blk[:, 0], we_blk[:, 0], ws_blk[:, 1],
                 we_blk[:, 1], ws_blk[:, 2], we_blk[:, 2])
    no_sack_tail = (zero,) * 8

    def armed(st):
        return _sel(st.rto_armed, st, _arm_rto(st, now_ms))

    # --- syn ---
    syn_state = s._replace(syn_outstanding=torch.ones_like(
        s.syn_outstanding), syn_sends=s.syn_sends + 1)
    syn_retx = syn_state.syn_sends > 1
    syn_state = syn_state._replace(
        retransmit_count=syn_state.retransmit_count + i32(syn_retx),
        ack_pending=torch.zeros_like(s.ack_pending))
    syn_is_sent = s.state == SYN_SENT
    syn_out = (one, _W(syn_is_sent, SYN, SYN | ACK), wrap_i32(s.iss),
               _W(syn_is_sent, 0, wack), _advertised_window(s, True), zero,
               s.my_wscale, *ts, i32(syn_retx), i32(s.sack_on),
               *((zero,) * 7))

    # --- data ---
    off0 = s.snd_nxt
    # never (re)send SACKed bytes: jump over held ranges, cap at the next
    off, d_cap = _sb_next(s.sacked_s, s.sacked_e, off0)
    in_flight = off - s.snd_una
    window = torch.minimum(s.cwnd * MSS, s.snd_wnd)
    n_data = torch.minimum(torch.minimum(
        torch.clamp(s.stream_len - off, max=MSS * gso_segs),
        window - in_flight), d_cap)
    d_has = n_data > 0
    n_eff = torch.clamp(n_data, min=0)
    d_state = s._replace(
        snd_nxt=_W(d_has, off + n_eff, torch.maximum(off, off0)),
        snd_max=torch.maximum(s.snd_max, _W(d_has, off + n_eff, off)),
        ack_pending=torch.zeros_like(s.ack_pending))
    d_state = _sel(d_state.rto_armed | ~d_has, d_state,
                   _arm_rto(d_state, now_ms))
    d_flags = _W(d_state.snd_nxt >= s.stream_len, ACK | PSH, ACK)
    data_gbn = before_nxt < s.gbn_high
    d_state = d_state._replace(
        retransmit_count=d_state.retransmit_count + i32(data_gbn),
        retransmitted_bytes=d_state.retransmitted_bytes
        + _W(data_gbn & d_has, n_eff, 0))
    # n <= 0 (everything in reach already held): _build_data falls back to
    # _build_ack, with the jumped snd_nxt already applied
    d_ack_seq = torch.minimum(d_state.snd_nxt, s.stream_len
                              + i32(s.fin_sent))
    d_out = (one, _W(d_has, d_flags, ACK),
             _W(d_has, wrap_i32(_wire_seq(s, off)),
                wrap_i32(_wire_seq(s, d_ack_seq))),
             wack, awnd, _W(d_has, n_data, 0), minus1, *ts, i32(data_gbn),
             *sack_tail)

    # --- retransmit (n>0 data at snd_una; else FIN-retx or bare ack) ---
    r_state0 = s._replace(retx_pending=torch.zeros_like(s.retx_pending),
                          retransmit_count=s.retransmit_count + 1)
    _, r_cap = _sb_next(s.sacked_s, s.sacked_e, s.snd_una)
    r_n = torch.minimum(torch.clamp(s.stream_len - s.snd_una, max=MSS),
                        r_cap)
    r_has_data = r_n > 0
    r_data = armed(r_state0._replace(
        retransmitted_bytes=r_state0.retransmitted_bytes + r_n))
    r_data_out = (one, _full(zero, ACK), wrap_i32(_wire_seq(s, s.snd_una)),
                  wack, awnd, r_n, minus1, *ts, one, *sack_tail)
    no_ack = torch.zeros_like(s.ack_pending)
    rf_state = armed(r_state0._replace(ack_pending=no_ack))
    rf_out = (one, _full(zero, FIN | ACK),
              wrap_i32(_wire_seq(s, s.stream_len)), wack, awnd, zero,
              minus1, *ts, one, *sack_tail)
    ra_state = r_state0._replace(ack_pending=no_ack)
    ra_out = (one, _full(zero, ACK), wrap_i32(_wire_seq(s, fin_seq(s))),
              wack, awnd, zero, minus1, *ts, one, *sack_tail)

    # --- probe (1 byte past the window) ---
    p_state = armed(s._replace(
        probe_pending=torch.zeros_like(s.probe_pending),
        snd_nxt=s.snd_nxt + 1,
        snd_max=torch.maximum(s.snd_max, s.snd_nxt + 1)))
    p_out = (one, _full(zero, ACK), wrap_i32(_wire_seq(s, s.snd_nxt)), wack,
             awnd, one, minus1, *ts, one, *sack_tail)

    # --- fin ---
    f_state = armed(s._replace(
        fin_sent=torch.ones_like(s.fin_sent), snd_nxt=s.stream_len + 1,
        snd_max=torch.maximum(s.snd_max, s.stream_len + 1),
        ack_pending=no_ack))
    fin_gbn = before_nxt < s.gbn_high
    f_state = f_state._replace(
        retransmit_count=f_state.retransmit_count + i32(fin_gbn))
    f_out = (one, _full(zero, FIN | ACK),
             wrap_i32(_wire_seq(s, s.stream_len)), wack, awnd, zero, minus1,
             *ts, i32(fin_gbn), *sack_tail)

    # --- ack ---
    a_state = s._replace(ack_pending=no_ack)
    a_out = (one, _full(zero, ACK), wrap_i32(_wire_seq(s, fin_seq(s))),
             wack, awnd, zero, minus1, *ts, zero, *sack_tail)

    # --- rst (the CPU machine stamps every segment but a RST) ---
    rst_out = (one, _full(zero, RST | ACK),
               wrap_i32(_wire_seq(s, torch.minimum(s.snd_nxt,
                                                   s.stream_len))),
               wack, zero, zero, minus1, zero, zero, zero, *no_sack_tail)
    rst_state = _enter_closed(s._replace(
        rst_pending=torch.zeros_like(s.rst_pending)), 104)

    none_out = (zero,) * N_OUT

    # merge: the retransmit kind has three sub-shapes
    retx_state = _sel(r_has_data, r_data, _sel(s.fin_sent, rf_state,
                                               ra_state))
    retx_out = tuple(_W(r_has_data, x, _W(s.fin_sent, y, z))
                     for x, y, z in zip(r_data_out, rf_out, ra_out))

    out_state, out_seg = s, none_out
    for k, st, sg in ((K_ACK, a_state, a_out), (K_FIN, f_state, f_out),
                      (K_DATA, d_state, d_out), (K_PROBE, p_state, p_out),
                      (K_RETX, retx_state, retx_out),
                      (K_SYN, syn_state, syn_out),
                      (K_RST, rst_state, rst_out)):
        m = kind == k
        out_state = _sel(m, st, out_state)
        out_seg = tuple(_W(m, x, y) for x, y in zip(sg, out_seg))
    out_state = out_state._replace(
        last_retx=(out_seg[9] > 0) & (kind != K_NONE))
    return out_state, torch.stack(out_seg, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# the event steps
# ---------------------------------------------------------------------------

def tcp_event_step(plane: TcpPlane, kind: torch.Tensor, fields: torch.Tensor,
                   now_ms: torch.Tensor):
    """Step C connections, one event each: kind [C] int32 EV_*, fields
    [C, 16] int32, now_ms [C] int32. Returns (plane', out [C, 18], ret
    [C]): `out` the PULL segment metadata, `ret` the WRITE/READ return."""
    s, f = plane, fields
    s_wr, wr_ret = _ev_write(s, f, now_ms)
    s_rd, rd_ret = _ev_read(s, f)
    s_pl, pull_out = _ev_pull(s, now_ms)
    out_state = s
    for k, st in ((EV_OPEN_ACTIVE, _ev_open_active(s, f, now_ms)),
                  (EV_OPEN_PASSIVE, _ev_open_passive(s, f, now_ms)),
                  (EV_WRITE, s_wr), (EV_READ, s_rd), (EV_CLOSE, _ev_close(s)),
                  (EV_ABORT, _ev_abort(s)),
                  (EV_SEG, _ev_segment(s, f, now_ms)), (EV_PULL, s_pl),
                  (EV_TIMER_RTO, _ev_timer_rto(s, f, now_ms)),
                  (EV_TIMER_PERSIST, _ev_timer_persist(s, f, now_ms)),
                  (EV_TIMER_TW, _ev_timer_tw(s, f, now_ms))):
        out_state = _sel(kind == k, st, out_state)
    out = _W(_col(kind == EV_PULL), pull_out, 0)
    ret = _W(kind == EV_WRITE, wr_ret, _W(kind == EV_READ, rd_ret, 0))
    return out_state, out, ret.to(torch.int32)


def tcp_sched_step(plane: TcpPlane, kind: torch.Tensor, fields: torch.Tensor,
                   now_ms: torch.Tensor) -> TcpPlane:
    """One SCHEDULED event a connection: the kinds the flow engine's
    fused step dispatches (segment arrivals, timers and opens)."""
    s, f = plane, fields
    out = s
    for k, st in ((EV_OPEN_ACTIVE, _ev_open_active(s, f, now_ms)),
                  (EV_OPEN_PASSIVE, _ev_open_passive(s, f, now_ms)),
                  (EV_SEG, _ev_segment(s, f, now_ms)),
                  (EV_TIMER_RTO, _ev_timer_rto(s, f, now_ms)),
                  (EV_TIMER_PERSIST, _ev_timer_persist(s, f, now_ms)),
                  (EV_TIMER_TW, _ev_timer_tw(s, f, now_ms))):
        out = _sel(kind == k, st, out)
    return out


def tcp_pull_step(plane: TcpPlane, now_ms: torch.Tensor, gso_segs: int = 1):
    """A PULL (= next_segment) of every connection: (plane', out [C, 18])."""
    return _ev_pull(plane, now_ms, gso_segs)


def tcp_replay(plane: TcpPlane, kinds: torch.Tensor, fields: torch.Tensor,
               now_ms: torch.Tensor):
    """Replay [C, T] event streams (fields [C, T, 16]), one step an
    event. Returns (plane', outs [T, C, 18], rets [T, C])."""
    outs, rets = [], []
    for t in range(kinds.shape[1]):
        plane, out, ret = tcp_event_step(plane, kinds[:, t], fields[:, t],
                                         now_ms[:, t])
        outs.append(out)
        rets.append(ret)
    C = kinds.shape[0]
    if not outs:
        return plane, fields.new_zeros((0, C, N_OUT)), \
            fields.new_zeros((0, C))
    return plane, torch.stack(outs), torch.stack(rets)

"""The TCP helpers the flow plane reuses, batched over flows.

Counterpart of the pieces of `shadow_tpu/tpu/tcp.py` that
`shadow_tpu/tpu/flows.py` calls: the Reno congestion transitions, the
RFC 6298 RTT estimator in integer milliseconds and the RTO timer, plus
their constants. The JAX package writes them on one connection's scalars
and `vmap`s them; here every helper takes a NamedTuple of [F] tensors
(the flow plane's `FlowState`) and `_replace`s fields with per-flow
`torch.where` selects: the JAX scalar `_sel` under `vmap` is
`sel_batched` here. Only the fields the helpers name are touched, so
any NamedTuple carrying them works.

The one loop, `_avoid_tick` (congestion avoidance's "one more segment of
window per window's worth of acks"), is a data-dependent
`lax.while_loop` in JAX. It is solved here in closed form: the trip
count k is the largest k >= 0 with k*cwnd + k*(k-1)/2 <= acked, found
by a float64 square root and corrected to the exact integer by int64
comparisons, so no window reads a tensor back to decide whether to loop
again.
"""

from __future__ import annotations

import torch

from .prims import floordiv

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

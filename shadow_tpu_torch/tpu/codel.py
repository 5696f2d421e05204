"""The destination router: CoDel AQM plus the down-bandwidth relay.

Counterpart of `shadow_tpu/tpu/codel.py`, bitwise:

- the CoDel constants, `CTRL_TABLE` (the control law `INTERVAL /
  sqrt(count)` as an int32 table, rounded half-to-even from float64 as
  the CPU plane's `round()` does; nothing takes a square root at run
  time), `CodelState` and its rebase;
- `_codel_pop_step`, one micro-step of the CoDel pop state machine over
  [N] tensors, and `codel_drain`, the trace replay that the tests hold
  against the CPU plane's `CoDelQueue` (plain PyTorch, a fixed
  `K + P` micro-steps; no entry point runs it at width);
- the integrated router (`host.rs:810-865`: CoDel, then the
  down-bandwidth relay, then delivery): `RouterDownState`, its
  constructor and rebase, `router_drain_plain` (plain PyTorch, the
  fixed `4*K + 16` micro-steps of the JAX `fori_loop`) and
  `router_drain`, which runs kernel E (`csrc/router_drain.cu`) on CUDA
  tensors and the plain version on CPU tensors.

The JAX drain is one `lax.fori_loop` vmapped over hosts: serial per
host, independent across hosts. As eager PyTorch on the card it is
~130 launches a micro-step, ~19000 a window at CI=32; kernel E runs it
in one launch, a host a lane, a block a warp and a tile of 32 hosts
whose rows it stages in shared memory by asynchronous copy (see its
source note; `e_geometry` reads the launch's tile and grid).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .ops import row_op
from .prims import I32_MAX, floordiv, floormod, wrap_i32

MILLISECOND = 1_000_000
CONFIG_MTU = 1500

TARGET = 10 * MILLISECOND
INTERVAL = 100 * MILLISECOND

_MODE_STORE = 0
_MODE_DROP = 1

# control_law(t, c) = t + CTRL_TABLE[clip(c, 1, _MAX_COUNT)]; entry 0 is
# never queried (kept for safe indexing)
_MAX_COUNT = 4096
CTRL_TABLE = torch.tensor(
    [round(float(INTERVAL))]
    + [round(float(INTERVAL) / math.sqrt(float(c)))
       for c in range(1, _MAX_COUNT + 1)], dtype=torch.int32)

# entry status codes
STATUS_QUEUED = 0  # not consumed this window (still in the queue)
STATUS_DELIVERED = 1
STATUS_DROPPED = 2
STATUS_TAKEN = 3  # consumed from the queue, cached in the relay

# phases of the linearised pop state machine
_PH_START = 0  # at the top of pop(now)
_PH_AFTER_STORE_DROP = 1  # store-mode drop done; pop-and-return next
_PH_DROP_LOOP = 2  # inside the drop-mode loop; front entry just dropped
_PH_IDLE = 3  # router only: no pop chain active

_tables: dict[torch.device, torch.Tensor] = {}


def ctrl_table(device) -> torch.Tensor:
    """`CTRL_TABLE` on `device` (one copy a device)."""
    device = torch.device(device)
    t = _tables.get(device)
    if t is None:
        t = _tables[device] = CTRL_TABLE.to(device)
    return t


class CodelState(NamedTuple):
    """Per-host scalar CoDel state of the trace replay, axis 0 = host."""

    mode: torch.Tensor  # int32: 0 store / 1 drop
    has_interval_end: torch.Tensor  # bool
    interval_end: torch.Tensor  # int32 rel ns (valid iff flag)
    has_drop_next: torch.Tensor  # bool
    drop_next: torch.Tensor  # int32 rel ns (valid iff flag)
    cur_count: torch.Tensor
    prev_count: torch.Tensor
    entry_idx: torch.Tensor  # entries consumed from the trace
    consumed_bytes: torch.Tensor
    dropped: torch.Tensor  # total drops


def make_codel_state(n_hosts: int, *, device) -> CodelState:
    z = lambda: torch.zeros(n_hosts, dtype=torch.int32, device=device)
    f = lambda: torch.zeros(n_hosts, dtype=torch.bool, device=device)
    return CodelState(
        mode=z(), has_interval_end=f(), interval_end=z(),
        has_drop_next=f(), drop_next=z(), cur_count=z(), prev_count=z(),
        entry_idx=z(), consumed_bytes=z(), dropped=z())


def rebase_codel_state(state: CodelState, shift_ns: int) -> CodelState:
    """Rebase the stored times when the window start moves."""
    return state._replace(
        interval_end=torch.where(state.has_interval_end,
                                 state.interval_end - shift_ns,
                                 state.interval_end),
        drop_next=torch.where(state.has_drop_next,
                              state.drop_next - shift_ns, state.drop_next))


def _codel_pop_step(phase, mode, has_ie, ie, has_dn, dn, cur, prev, now,
                    empty, e_arr, total_after, table):
    """One micro-step of the CoDel pop state machine over [N] tensors:
    the CPU `CoDelQueue.pop` nested drop loops, one queue entry or empty
    pop at a time. Returns (scalars', outcome) with scalars' = (mode,
    has_ie, ie, has_dn, dn, cur, prev, phase_mid) and outcome = (consume,
    rec_status, pop_done, any_empty, deliver); the caller resolves the
    phase of a completed pop."""
    ctrl = lambda t, c: t + table[torch.clamp(c, 1, _MAX_COUNT).long()]
    # _codel_pop(now): the standing-delay check on the front entry
    below = (now - e_arr < TARGET) | (total_after <= CONFIG_MTU)
    entered_bad = ~below & ~has_ie
    ok = ~below & has_ie & (now >= ie)
    n_ie = torch.where(entered_bad, now + INTERVAL, ie)
    n_has_ie = ~below

    is_start = phase == _PH_START
    is_after_sd = phase == _PH_AFTER_STORE_DROP
    is_drop_loop = phase == _PH_DROP_LOOP
    full = ~empty
    c_empty = is_start & empty
    c_deliver = is_start & full & ~ok
    c_store_drop = is_start & full & ok & (mode == _MODE_STORE)
    should = has_dn & (now >= dn)
    c_drop = is_start & full & ok & (mode == _MODE_DROP)
    c_drop_again = c_drop & should
    c_drop_deliver = c_drop & ~should
    a_empty = is_after_sd & empty
    a_deliver = is_after_sd & full  # delivered whatever its ok flag
    d_empty = is_drop_loop & empty
    d_nonempty = is_drop_loop & full
    dn_upd = torch.where(d_nonempty & ok, ctrl(dn, cur), dn)
    mode_upd = torch.where(d_nonempty & ~ok, _MODE_STORE, mode)
    d_drop = d_nonempty & ok & has_dn & (now >= dn_upd)
    d_deliver = d_nonempty & ~d_drop

    any_empty = c_empty | a_empty | d_empty
    n_mode = torch.where(c_empty | c_deliver, _MODE_STORE, mode)
    n_has_ie = n_has_ie & ~any_empty
    deliver = c_deliver | a_deliver | c_drop_deliver | d_deliver
    n_mode = torch.where(d_deliver, mode_upd, n_mode)
    n_dn = torch.where(d_deliver, dn_upd, dn)

    # store-mode drop: drop the entry, count bookkeeping, enter phase 1
    recently = has_dn & (torch.clamp(now - dn, min=0) < INTERVAL * 16)
    delta = cur - prev
    new_cur = torch.where(recently & (delta > 1), delta, 1)
    n_cur = torch.where(c_store_drop, new_cur, cur)
    n_prev = torch.where(c_store_drop, new_cur, prev)
    n_dn = torch.where(c_store_drop, ctrl(now, new_cur), n_dn)
    n_has_dn = has_dn | c_store_drop
    n_mode = torch.where(c_store_drop, _MODE_DROP, n_mode)
    n_phase = torch.where(c_store_drop, _PH_AFTER_STORE_DROP, phase)
    # drop-mode drop from phase 0: count++, enter the loop; a continued
    # drop inside the loop: count++, take the updated drop_next
    n_cur = torch.where(c_drop_again | d_drop, cur + 1, n_cur)
    n_phase = torch.where(c_drop_again, _PH_DROP_LOOP, n_phase)
    n_dn = torch.where(d_drop, dn_upd, n_dn)

    dropped = c_store_drop | c_drop_again | d_drop
    consume = deliver | dropped
    rec_status = (deliver.to(torch.int32) * STATUS_DELIVERED
                  + dropped.to(torch.int32) * STATUS_DROPPED)
    pop_done = any_empty | deliver
    scalars = (n_mode, n_has_ie, n_ie, n_has_dn, n_dn, n_cur, n_prev,
               n_phase)
    return scalars, (consume, rec_status, pop_done, any_empty, deliver)


def _col(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[row, idx[row]] for an [N, K] tensor and [N] column indices."""
    return torch.gather(a, 1, idx.long()[:, None])[:, 0]


def _put(a: torch.Tensor, idx, cond, value) -> torch.Tensor:
    """`a` with a[row, idx[row]] = value where cond (the JAX `.at[e].set(
    where(cond, value, a[e]))` on one column a row), as a new tensor: out
    of place, so a drain under `torch.func.vmap` writes no tensor that
    is shared by the worlds."""
    idx = idx.long()[:, None]
    old = torch.gather(a, 1, idx)[:, 0]
    return a.scatter(1, idx, torch.where(cond, value, old)[:, None])


def _pushed_bytes(arrival, size):
    """Per-row int32 (wrapping) prefix sums of the real entries' sizes."""
    return wrap_i32(torch.cumsum(torch.where(arrival < I32_MAX, size, 0),
                                 dim=1, dtype=torch.int64))


def _queue_view(arrival, size, pushed_bytes, eidx, cbytes, now):
    """The queue as a pop at `now` sees it: (empty, front index e, its
    size, its arrival, total bytes after removing it)."""
    K = arrival.shape[1]
    n_pushed = torch.searchsorted(arrival, now[:, None].contiguous(),
                                  right=True)[:, 0].to(torch.int32)
    empty = eidx >= n_pushed
    e = torch.clamp(eidx, max=K - 1)
    e_size = _col(size, e)
    pushed = torch.where(
        n_pushed > 0,
        _col(pushed_bytes, torch.clamp(n_pushed - 1, 0, K - 1)), 0)
    return empty, e, e_size, _col(arrival, e), pushed - cbytes - e_size


def codel_drain(arrival: torch.Tensor, size: torch.Tensor,
                pops: torch.Tensor, state: CodelState):
    """Replay pop invocations against per-host entry traces.

    arrival/size: [N, K] int32, arrival ascending with I32_MAX padding;
    pops: [N, P] pop times ascending with I32_MAX padding (a padded pop is
    ignored). Returns (state', status [N, K], deliver_t [N, K]): status
    STATUS_QUEUED / _DELIVERED / _DROPPED, deliver_t the pop time of a
    delivered entry (I32_MAX otherwise). Plain PyTorch, `K + P`
    micro-steps (every one consumes an entry or completes a pop)."""
    N, K = arrival.shape
    P = pops.shape[1]
    dev = arrival.device
    table = ctrl_table(dev)
    n_pops = (pops < I32_MAX).sum(dim=1, dtype=torch.int32)
    pushed_bytes = _pushed_bytes(arrival, size)
    st = state
    mode, has_ie, ie = st.mode, st.has_interval_end, st.interval_end
    has_dn, dn = st.has_drop_next, st.drop_next
    cur, prev = st.cur_count, st.prev_count
    eidx, cbytes, dropped = st.entry_idx, st.consumed_bytes, st.dropped
    pidx = torch.zeros(N, dtype=torch.int32, device=dev)
    phase = torch.full((N,), _PH_START, dtype=torch.int32, device=dev)
    status = torch.zeros((N, K), dtype=torch.int32, device=dev)
    deliver_t = torch.full((N, K), I32_MAX, dtype=torch.int32, device=dev)
    for _ in range(K + P):
        active = pidx < n_pops
        now = torch.where(active, _col(pops, torch.clamp(pidx, max=P - 1)),
                          0)
        empty, e, e_size, e_arr, total_after = _queue_view(
            arrival, size, pushed_bytes, eidx, cbytes, now)
        scalars, (consume, rec_status, pop_done, _e, _d) = _codel_pop_step(
            phase, mode, has_ie, ie, has_dn, dn, cur, prev, now, empty,
            e_arr, total_after, table)
        n_mode, n_has_ie, n_ie, n_has_dn, n_dn, n_cur, n_prev, n_phase = \
            scalars
        # trace replay: a completed pop restarts at the next pop time
        n_phase = torch.where(pop_done, _PH_START, n_phase)
        consume = consume & active
        pop_done = pop_done & active
        status = _put(status, e, consume, rec_status)
        deliver_t = _put(deliver_t, e,
                         consume & (rec_status == STATUS_DELIVERED), now)
        sel = lambda new, old: torch.where(active, new, old)
        mode, has_ie, ie = sel(n_mode, mode), sel(n_has_ie, has_ie), \
            sel(n_ie, ie)
        has_dn, dn = sel(n_has_dn, has_dn), sel(n_dn, dn)
        cur, prev = sel(n_cur, cur), sel(n_prev, prev)
        eidx = torch.where(consume, eidx + 1, eidx)
        cbytes = torch.where(consume, cbytes + e_size, cbytes)
        dropped = torch.where(consume & (rec_status == STATUS_DROPPED),
                              dropped + 1, dropped)
        pidx = torch.where(pop_done, pidx + 1, pidx)
        phase = sel(n_phase, phase)
    st_out = CodelState(
        mode=mode, has_interval_end=has_ie, interval_end=ie,
        has_drop_next=has_dn, drop_next=dn, cur_count=cur, prev_count=prev,
        entry_idx=eidx, consumed_bytes=cbytes, dropped=dropped)
    return st_out, status, deliver_t


# -- the integrated router: CoDel + down-bandwidth relay --------------------
#
# Pop times are derived, not given: every arrival starts a pop chain at
# its arrival time (the CPU plane's route_incoming_packet -> relay.notify
# -> delay-0 task), the chain pops until the queue empties or the
# down-bandwidth token bucket runs dry, and a packet the bucket cannot
# afford is cached in the relay (already consumed from the CoDel queue)
# with a resume at the refill boundary that affords it.


class RouterDownState(NamedTuple):
    """Per-host scalar state of the integrated router+relay, axis 0 = host."""

    # CoDel scalars (as CodelState)
    mode: torch.Tensor
    has_interval_end: torch.Tensor
    interval_end: torch.Tensor
    has_drop_next: torch.Tensor
    drop_next: torch.Tensor
    cur_count: torch.Tensor
    prev_count: torch.Tensor
    # down-bandwidth token bucket
    dn_balance: torch.Tensor  # int32 token bytes
    dn_last_refill: torch.Tensor  # int32 rel ns of the last refill boundary
    # relay-cached packet (popped from CoDel, waiting for tokens)
    has_cached: torch.Tensor  # bool
    cached_src: torch.Tensor
    cached_seq: torch.Tensor
    cached_sock: torch.Tensor
    cached_bytes: torch.Tensor
    resume: torch.Tensor  # int32 rel ns the relay resumes (iff has_cached)
    dropped: torch.Tensor  # int32 cumulative router drops


# the fields the drain rewrites, in kernel E's argument order (the
# cached identity src/seq/sock passes through: the caller owns it)
DRAIN_FIELDS = ("mode", "has_interval_end", "interval_end", "has_drop_next",
                "drop_next", "cur_count", "prev_count", "dn_balance",
                "dn_last_refill", "has_cached", "cached_bytes", "resume",
                "dropped")


def make_router_state(n_hosts: int, dn_cap: torch.Tensor | None = None, *,
                      device: torch.device) -> RouterDownState:
    z = lambda: torch.zeros(n_hosts, dtype=torch.int32, device=device)
    f = lambda: torch.zeros(n_hosts, dtype=torch.bool, device=device)
    return RouterDownState(
        mode=z(), has_interval_end=f(), interval_end=z(),
        has_drop_next=f(), drop_next=z(), cur_count=z(), prev_count=z(),
        dn_balance=(dn_cap.to(device=device, dtype=torch.int32).clone()
                    if dn_cap is not None else z()),
        dn_last_refill=z(), has_cached=f(), cached_src=z(), cached_seq=z(),
        cached_sock=z(), cached_bytes=z(), resume=z(), dropped=z(),
    )


def rebase_router_state(st: RouterDownState, shift_ns: int, dn_rate,
                        dn_cap) -> RouterDownState:
    """Rebase stored times by the window shift and apply every refill
    boundary that has passed up to the new window start (elapsed clamped
    before multiplying), re-anchoring the bucket into (-1 ms, 0]."""
    lref = st.dn_last_refill - shift_ns
    span = torch.clamp(-lref, min=0)
    num = floordiv(span, MILLISECOND)
    headroom = torch.clamp(dn_cap - st.dn_balance, min=0)
    need = floordiv(headroom + dn_rate - 1, dn_rate)
    balance = dn_cap - torch.clamp(
        headroom - dn_rate * torch.minimum(num, need), min=0)
    lref = torch.clamp(lref, min=0) - floormod(span, MILLISECOND)
    return st._replace(
        interval_end=torch.where(st.has_interval_end,
                                 st.interval_end - shift_ns, st.interval_end),
        drop_next=torch.where(st.has_drop_next, st.drop_next - shift_ns,
                              st.drop_next),
        dn_balance=balance,
        dn_last_refill=lref,
        resume=torch.where(st.has_cached, st.resume - shift_ns, st.resume),
    )


def _router_drain_loop(arrival, size, window_ns: int, dn_rate, dn_cap,
                       st: RouterDownState, *, until=None):
    """`router_drain_plain`'s loop; also returns the micro-steps each host
    ran before it halted ([N] int32: the steps kernel E runs). `until`,
    given, is a host-side caller's stop: called with `halted` [N] bool
    after each micro-step, it ends the loop when it returns True. A
    halted host changes nothing, so stopping once every host has halted
    (`until=lambda h: bool(h.all())`, a read of the device a micro-step,
    which only host-side references take: the card's checks of wide
    rows, the CPU's witnesses) equals JAX's fixed `4*K + 16`
    micro-steps; the window step's path passes none and reads nothing."""
    N, K = arrival.shape
    dev = arrival.device
    table = ctrl_table(dev)
    pushed_bytes = _pushed_bytes(arrival, size)
    n_valid = (arrival < I32_MAX).sum(dim=1, dtype=torch.int32)

    def refill(bal, lref, now):
        """Lazy 1 ms refill, elapsed clamped before multiplying."""
        span = torch.clamp(now - lref, min=0)
        num = floordiv(span, MILLISECOND)
        headroom = torch.clamp(dn_cap - bal, min=0)
        need = floordiv(headroom + dn_rate - 1, dn_rate)
        bal2 = dn_cap - torch.clamp(
            headroom - dn_rate * torch.minimum(num, need), min=0)
        return bal2, torch.maximum(now, lref) - floormod(span, MILLISECOND)

    def wait_until(now, required, lref_now):
        """The refill boundary that affords `required` more bytes,
        saturating just below I32_MAX when the sum wraps (a saturated
        resume fires early, fails the re-check and re-blocks)."""
        n_refills = floordiv(required + dn_rate - 1, dn_rate)
        w = (MILLISECOND - (now - lref_now)
             + (n_refills - 1) * MILLISECOND)
        r = now + w
        return torch.where(r < now, I32_MAX - MILLISECOND, r)

    i32 = lambda v: torch.full((N,), v, dtype=torch.int32, device=dev)
    mode, has_ie, ie = st.mode, st.has_interval_end, st.interval_end
    has_dn, dn = st.has_drop_next, st.drop_next
    cur, prev = st.cur_count, st.prev_count
    bal, lref = st.dn_balance, st.dn_last_refill
    has_c, c_size, resume = st.has_cached, st.cached_bytes, st.resume
    dropped = st.dropped
    c_idx, eidx, cbytes, T = i32(-1), i32(0), i32(0), i32(0)
    phase = i32(_PH_IDLE)
    halted = torch.zeros(N, dtype=torch.bool, device=dev)
    co_mask = torch.zeros(N, dtype=torch.bool, device=dev)
    co_t, steps = i32(0), i32(0)
    status = torch.zeros((N, K), dtype=torch.int32, device=dev)
    deliver_t = torch.full((N, K), I32_MAX, dtype=torch.int32, device=dev)
    for _ in range(4 * K + 16):
        if until is not None and until(halted):
            break
        steps = steps + (~halted).to(torch.int32)
        # event selection while no pop chain is active
        idle = (phase == _PH_IDLE) & ~halted
        resume_ok = idle & has_c & (resume < window_ns)
        head_arr = _col(arrival, torch.clamp(eidx, max=K - 1))
        head_ok = idle & ~has_c & (eidx < n_valid) & (head_arr < window_ns)
        halted = halted | (idle & ~resume_ok & ~head_ok)

        # the cached packet's resume: refill, conformance re-check
        r_bal, r_lref = refill(bal, lref, resume)
        r_conform = c_size <= r_bal
        r_fwd = resume_ok & r_conform
        r_again = resume_ok & ~r_conform
        bal = torch.where(r_fwd, r_bal - c_size,
                          torch.where(r_again, r_bal, bal))
        lref = torch.where(resume_ok, r_lref, lref)
        row_cached = c_idx >= 0
        ci = torch.clamp(c_idx, 0, K - 1)
        status = _put(status, ci, r_fwd & row_cached,
                      torch.full_like(ci, STATUS_DELIVERED))
        deliver_t = _put(deliver_t, ci, r_fwd & row_cached, resume)
        co_mask = co_mask | (r_fwd & ~row_cached)
        co_t = torch.where(r_fwd & ~row_cached, resume, co_t)
        has_c = has_c & ~r_fwd
        c_idx = torch.where(r_fwd, -1, c_idx)
        T = torch.where(r_fwd, resume, T)
        resume = torch.where(r_again, wait_until(resume, c_size - r_bal,
                                                 r_lref), resume)
        phase = torch.where(r_fwd, _PH_START, phase)
        # an idle chain starts at the head entry's arrival
        T = torch.where(head_ok, head_arr, T)
        phase = torch.where(head_ok, _PH_START, phase)

        # one CoDel pop micro-step at chain time T
        in_chain = (phase != _PH_IDLE) & ~halted & ~resume_ok & ~head_ok
        now = T
        empty, e, e_size, e_arr, total_after = _queue_view(
            arrival, size, pushed_bytes, eidx, cbytes, now)
        scalars, (consume, rec_status, _pd, any_empty, deliver) = \
            _codel_pop_step(phase, mode, has_ie, ie, has_dn, dn, cur, prev,
                            now, empty, e_arr, total_after, table)
        n_mode, n_has_ie, n_ie, n_has_dn, n_dn, n_cur, n_prev, n_phase = \
            scalars
        # the relay's token gate: a candidate the bucket cannot afford is
        # taken into the relay cache instead of delivered
        g_bal, g_lref = refill(bal, lref, now)
        conform = e_size <= g_bal
        fwd = deliver & conform
        blocked = deliver & ~conform
        rec_status = torch.where(blocked, STATUS_TAKEN, rec_status)
        upd = in_chain & deliver
        bal = torch.where(upd, torch.where(conform, g_bal - e_size, g_bal),
                          bal)
        lref = torch.where(upd, g_lref, lref)
        take = in_chain & blocked
        has_c = has_c | take
        c_size = torch.where(take, e_size, c_size)
        c_idx = torch.where(take, e, c_idx)
        resume = torch.where(take, wait_until(now, e_size - g_bal, g_lref),
                             resume)
        # an empty queue or a token block idles the relay; a forwarded pop
        # restarts the chain at the same instant
        n_phase = torch.where(any_empty | blocked, _PH_IDLE, n_phase)
        n_phase = torch.where(fwd, _PH_START, n_phase)

        gc = in_chain & consume
        status = _put(status, e, gc, rec_status)
        deliver_t = _put(deliver_t, e, gc & (rec_status == STATUS_DELIVERED),
                         now)
        sel = lambda new, old: torch.where(in_chain, new, old)
        mode, has_ie, ie = sel(n_mode, mode), sel(n_has_ie, has_ie), \
            sel(n_ie, ie)
        has_dn, dn = sel(n_has_dn, has_dn), sel(n_dn, dn)
        cur, prev = sel(n_cur, cur), sel(n_prev, prev)
        dropped = torch.where(gc & (rec_status == STATUS_DROPPED),
                              dropped + 1, dropped)
        eidx = torch.where(gc, eidx + 1, eidx)
        cbytes = torch.where(gc, cbytes + e_size, cbytes)
        phase = sel(n_phase, phase)
    st_out = st._replace(
        mode=mode, has_interval_end=has_ie, interval_end=ie,
        has_drop_next=has_dn, drop_next=dn, cur_count=cur, prev_count=prev,
        dn_balance=bal, dn_last_refill=lref, has_cached=has_c,
        cached_bytes=c_size, resume=resume, dropped=dropped)
    return st_out, status, deliver_t, co_mask, co_t, c_idx, steps


def router_drain_plain(arrival: torch.Tensor, size: torch.Tensor,
                       window_ns: int, dn_rate: torch.Tensor,
                       dn_cap: torch.Tensor, state: RouterDownState, *,
                       until=None):
    """Kernel E's function in plain PyTorch: the JAX `router_drain`'s
    fixed `4*K + 16` micro-steps over [N] vectors (`until` stops early,
    as in `_router_drain_loop`).

    arrival/size: [N, K] int32, arrival ascending per row with I32_MAX
    padding. Returns (state', status [N, K], deliver_t [N, K], co_mask
    [N], co_t [N], cached_idx [N]): cached_idx >= 0 names the row entry
    left cached at window end (the caller moves its identity into the
    state); co_mask says the previous window's cached packet (identity
    in the pre-drain state) was delivered at co_t. The state's cached
    src/seq/sock pass through unchanged."""
    return _router_drain_loop(arrival, size, window_ns, dn_rate, dn_cap,
                              state, until=until)[:6]


def _router_drain_impl(arrival, size, dn_rate, dn_cap, *args):
    """The `router_drain` op: `router_drain_plain` on CPU tensors, kernel
    E on CUDA tensors. The arguments after dn_cap are the state's
    DRAIN_FIELDS, then window_ns and the build wanted (the launcher's
    code: 0 by K); returns the drained fields in that order, then status,
    deliver_t, co_mask, co_t and cached_idx."""
    *fields, window_ns, want = args
    if arrival.device.type == "cpu":
        st = RouterDownState(**dict(zip(DRAIN_FIELDS, fields)),
                             cached_src=None, cached_seq=None,
                             cached_sock=None)
        st_out, *rest = router_drain_plain(arrival, size, window_ns, dn_rate,
                                           dn_cap, st)
        return (*(getattr(st_out, f) for f in DRAIN_FIELDS), *rest)
    from . import pipeline

    N, K = arrival.shape
    dev = arrival.device
    outs = [torch.empty_like(t) for t in fields]
    status = torch.empty((N, K), dtype=torch.int32, device=dev)
    deliver_t = torch.empty((N, K), dtype=torch.int32, device=dev)
    co_mask = torch.empty(N, dtype=torch.bool, device=dev)
    co_t = torch.empty(N, dtype=torch.int32, device=dev)
    cached_idx = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        pipeline._launch("router_drain", N, K, int(window_ns), int(want),
                         arrival, size, dn_rate, dn_cap, ctrl_table(dev),
                         *fields, *outs, status, deliver_t, co_mask, co_t,
                         cached_idx)
        pipeline.E_BUILD_LAUNCHES[_e_geometry(N, K, int(want))[3]] += 1
    return (*outs, status, deliver_t, co_mask, co_t, cached_idx)


_router_drain_op = row_op(
    "router_drain", _router_drain_impl,
    "(Tensor arrival, Tensor size, Tensor dn_rate, Tensor dn_cap, "
    + ", ".join(f"Tensor {f}" for f in DRAIN_FIELDS)
    + ", int window_ns, int want) -> ("
    + ", ".join(["Tensor"] * (len(DRAIN_FIELDS) + 5)) + ")")


#: kernel E's two builds (`csrc/router_drain.cu`): "staged" copies a
#: tile's rows into shared memory (rows up to 29055 entries), "device"
#: reads them where they lie; the launcher's codes for them (0 picks by
#: the rows' width)
E_BUILDS = {"staged": 1, "device": 2}


@functools.lru_cache(maxsize=64)
def _e_geometry(n: int, k: int, want: int) -> tuple:
    """The launcher's geometry of kernel E over `n` rows of `k` entries
    with the build code `want`: (hosts a tile, blocks, shared bytes a
    block, the build it runs); RuntimeError where it takes no launch."""
    import ctypes

    from .._build import load_kernel

    out = (ctypes.c_int * 4)()
    fn = load_kernel("router_drain").router_drain_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    err = fn(n, k, want, out)
    if err:
        raise RuntimeError(f"router_drain_kernel: CUDA error {err} at "
                           f"geometry (K={k}, build code {want})")
    names = {v: b for b, v in E_BUILDS.items()}
    return out[0], out[1], out[2], names[out[3]]


def e_geometry(n: int, k: int, build: str | None = None) -> dict:
    """Kernel E's launch over `n` rows of `k` entries, as its launcher
    works it out: hosts a tile (a block of one warp), blocks, shared
    bytes a block and the build ("staged" or "device", picked by `k`
    unless `build` forces one). A `k` the build does not take raises
    RuntimeError, as its launch does."""
    g = _e_geometry(n, k, E_BUILDS[build] if build else 0)
    return dict(zip(("hosts_a_tile", "blocks", "smem_bytes", "build"), g))


def router_drain(arrival: torch.Tensor, size: torch.Tensor, window_ns: int,
                 dn_rate: torch.Tensor, dn_cap: torch.Tensor,
                 state: RouterDownState, *, plain: bool = False,
                 _build: str | None = None):
    """Kernel E (`csrc/router_drain.cu`) on CUDA tensors, its plain
    version (`router_drain_plain`, the same function) on CPU tensors or
    with `plain=True`. Every output is a fresh tensor; the input state is
    not written. The launcher picks the kernel's build by the rows'
    width (staged up to 29055 entries, rows read from device memory
    beyond; `e_geometry`); `_build` forces one ("staged" or "device",
    the tests' handle; a staged launch past 29055 raises RuntimeError).
    Both go through the op `shadow_tpu_torch::router_drain` (unless
    `plain`), whose vmap rule drains every world of an ensemble in one
    launch, a host a lane."""
    if plain:
        return router_drain_plain(arrival, size, window_ns, dn_rate, dn_cap,
                                  state)
    dev = arrival.device
    if dev.type != "cpu":
        from . import pipeline

        N, K = arrival.shape
        if not -2**31 <= int(window_ns) < 2**31:
            raise ValueError(
                f"router_drain: window_ns {window_ns} is not int32")
        pipeline._check("arrival", arrival, torch.int32, (N, K), dev)
        pipeline._check("size", size, torch.int32, (N, K), dev)
        for name, t in (("dn_rate", dn_rate), ("dn_cap", dn_cap)):
            pipeline._check(name, t, torch.int32, (N,), dev)
        for f in DRAIN_FIELDS:
            dt = torch.bool if f.startswith("has_") else torch.int32
            pipeline._check(f"state.{f}", getattr(state, f), dt, (N,), dev)
    out = _router_drain_op(arrival, size, dn_rate, dn_cap,
                           *(getattr(state, f) for f in DRAIN_FIELDS),
                           int(window_ns), E_BUILDS[_build] if _build else 0)
    n = len(DRAIN_FIELDS)
    return (state._replace(**dict(zip(DRAIN_FIELDS, out[:n]))), *out[n:])

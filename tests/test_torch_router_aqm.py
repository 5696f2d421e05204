"""The port's router AQM (CoDel + down-bandwidth relay) against the JAX
package's, bitwise:

- `codel.router_drain_plain` against JAX `router_drain` on random rows
  and mid-run router states (caches, both CoDel modes, resumes that
  wrap int32), and a scalar model of kernel E's thread loop (it stops at
  `halted`, walks the queue with a pointer and branches where the JAX
  machine selects) against the plain version, so the kernel's
  restructuring is checked before the card;
- `window_step(router_aqm=True)` on the six single-link traces of
  `tests/test_tpu_router_aqm.py` and a multi-host case, state and
  delivered dict every window;
- PHOLD windows with the AQM on "pallas_fused" against JAX's
  (interpret mode), on "pallas" and "xla" against JAX's XLA step, with
  the round-robin qdisc on "xla", and with metrics, guards, histograms,
  the flight recorder and neutral faults on "xla"."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (MS, assert_states_equal, assert_tuples_equal,  # noqa: E402
                          all_halted, drain_inputs, jax_params_to_numpy,
                          long_chain_drain_inputs,
                          jax_state_to_numpy, phold_both, rr_world)

from shadow_tpu.net.packet import CONFIG_HEADER_SIZE_UDPIPETH  # noqa: E402
from shadow_tpu.tpu import codel as jcodel  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.tpu import codel as tcodel  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
I32_MAX = 2**31 - 1
U32 = 1 << 32


# -- the drain -----------------------------------------------------------------


def jax_drain(arrival, size, window_ns, rate, cap, state):
    out = jax.jit(jcodel.router_drain, static_argnums=2)(
        arrival, size, window_ns, rate, cap,
        jcodel.RouterDownState(**{f: jnp.asarray(v)
                                  for f, v in state.items()}))
    st, *rest = out
    return ({f: np.asarray(getattr(st, f)) for f in st._fields},
            *(np.asarray(a) for a in rest))


def port_drain(arrival, size, window_ns, rate, cap, state):
    t = torch.from_numpy
    st, *rest = tcodel.router_drain_plain(
        t(arrival), t(size), window_ns, t(rate), t(cap),
        convert.router_from_numpy(state, "cpu"))
    return (convert.tuple_to_numpy(st), *(a.numpy() for a in rest))


def assert_drains_equal(a, b, ctx=None):
    (sa, *ra), (sb, *rb) = a, b
    assert sa.keys() == sb.keys()
    for f in sa:
        assert sa[f].dtype == sb[f].dtype and np.array_equal(sa[f], sb[f]), \
            (ctx, f)
    for i, (x, y) in enumerate(zip(ra, rb)):
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, i)


# -- a scalar model of kernel E's thread loop ------------------------------


def _i32(v):
    v &= U32 - 1
    return v - U32 if v >= 1 << 31 else v


def _floordiv(a, b):
    return a // b  # Python floors, like jnp and the kernel's floordiv


class Row:
    """A host's row in the modelled shared memory: words base, base + 1..."""

    def __init__(self, mem, base):
        self.mem, self.base = mem, base

    def __getitem__(self, c):
        return self.mem[self.base + c]

    def __setitem__(self, c, v):
        self.mem[self.base + c] = v


def host_model(A, S, ST, DT, k, window_ns, r, c, g, table):
    """One lane's `drain_host`, line for line, on Python ints wrapped to
    int32: it stops at `halted`, walks the queue count as a pointer
    carrying the pushed bytes, and starts a chain while `A[eidx]` (a
    sorted row's valid entries are its prefix) arrives in the window.
    Returns (state, co_mask, co_t, cached_idx, micro-steps)."""

    def refill(bal, lref, now):
        span = max(_i32(now - lref), 0)
        num = span // MS
        headroom = max(_i32(c - bal), 0)
        need = _floordiv(_i32(headroom + r - 1), r)
        bal2 = _i32(c - max(_i32(headroom - _i32(r * min(num, need))), 0))
        return bal2, _i32(max(now, lref) - span % MS)

    def wait_until(now, required, lref):
        n_refills = _floordiv(_i32(required + r - 1), r)
        w = _i32(_i32(MS - _i32(now - lref)) + _i32((n_refills - 1) * MS))
        res = _i32(now + w)
        return I32_MAX - MS if res < now else res

    mode, ie, dn = g["mode"], g["interval_end"], g["drop_next"]
    has_ie, has_dn, has_c = (g["has_interval_end"], g["has_drop_next"],
                             g["has_cached"])
    cur, prev = g["cur_count"], g["prev_count"]
    bal, lref = g["dn_balance"], g["dn_last_refill"]
    c_size, resume, dropped = g["cached_bytes"], g["resume"], g["dropped"]
    c_idx, eidx, cbytes, T, phase = -1, 0, 0, 0, 3
    cm, ct = False, 0
    n_pushed, pushed = 0, 0
    it = 0
    while it < 4 * k + 16:
        it += 1
        if phase == 3:
            if has_c and resume < window_ns:
                r_bal, r_lref = refill(bal, lref, resume)
                lref = r_lref
                if c_size <= r_bal:
                    bal = _i32(r_bal - c_size)
                    if c_idx >= 0:
                        ST[c_idx] = 1
                        DT[c_idx] = resume
                    else:
                        cm, ct = True, resume
                    has_c, c_idx, T, phase = False, -1, resume, 0
                else:
                    bal = r_bal
                    resume = wait_until(resume, _i32(c_size - r_bal),
                                        r_lref)
                continue
            if not has_c and eidx < k and A[eidx] < window_ns:
                T, phase = A[eidx], 0
                continue
            break
        now = T
        while n_pushed < k and A[n_pushed] <= now:
            if A[n_pushed] < I32_MAX:
                pushed = _i32(pushed + S[n_pushed])
            n_pushed += 1
        while n_pushed > 0 and A[n_pushed - 1] > now:
            n_pushed -= 1
            if A[n_pushed] < I32_MAX:
                pushed = _i32(pushed - S[n_pushed])
        empty = eidx >= n_pushed
        e = min(eidx, k - 1)
        e_size = S[e]
        total_after = _i32(_i32(pushed - cbytes) - e_size)
        below = _i32(now - A[e]) < 10 * MS or total_after <= 1500
        ok = not below and has_ie and now >= ie
        if not below and not has_ie:
            ie = _i32(now + 100 * MS)
        any_empty = deliver_now = drop = False
        n_phase = phase
        if phase == 0:
            if empty:
                any_empty, mode = True, 0
            elif not ok:
                deliver_now, mode = True, 0
            elif mode == 0:
                recently = has_dn and max(_i32(now - dn), 0) < 1_600_000_000
                delta = _i32(cur - prev)
                new_cur = delta if (recently and delta > 1) else 1
                cur = prev = new_cur
                dn = _i32(now + table[min(max(new_cur, 1), 4096)])
                has_dn, mode, n_phase, drop = True, 1, 1, True
            elif mode == 1:
                if has_dn and now >= dn:
                    cur, n_phase, drop = _i32(cur + 1), 2, True
                else:
                    deliver_now = True
        elif phase == 1:
            if empty:
                any_empty = True
            else:
                deliver_now = True
        else:
            if empty:
                any_empty = True
            else:
                dn_upd = (_i32(dn + table[min(max(cur, 1), 4096)])
                          if ok else dn)
                dn = dn_upd
                if ok and has_dn and now >= dn_upd:
                    cur, drop = _i32(cur + 1), True
                else:
                    deliver_now = True
                    if not ok:
                        mode = 0
        has_ie = not below and not any_empty
        rec = 2 if drop else 0
        if deliver_now:
            g_bal, g_lref = refill(bal, lref, now)
            lref = g_lref
            if e_size <= g_bal:
                bal, rec, n_phase = _i32(g_bal - e_size), 1, 0
            else:
                bal, rec, has_c, c_size, c_idx = g_bal, 3, True, e_size, e
                resume = wait_until(now, _i32(e_size - g_bal), g_lref)
                n_phase = 3
        elif any_empty:
            n_phase = 3
        phase = n_phase
        if drop or deliver_now:
            ST[e] = rec
            if rec == 1:
                DT[e] = now
            if drop:
                dropped = _i32(dropped + 1)
            eidx += 1
            cbytes = _i32(cbytes + e_size)
    out = dict(mode=mode, has_interval_end=has_ie, interval_end=ie,
               has_drop_next=has_dn, drop_next=dn, cur_count=cur,
               prev_count=prev, dn_balance=bal, dn_last_refill=lref,
               has_cached=has_c, cached_bytes=c_size, resume=resume,
               dropped=dropped)
    return out, cm, ct, c_idx, it


MAX_SMEM = 232448  # the shared bytes a block may use
MAX_STAGED_K = 29055  # the widest row the staged build takes


def e_geometry_model(k, build=None):
    """`choose_geometry`: (build, hosts a tile, words of a row as the
    machines read it, words of one staged array), the build picked by K
    (staged up to MAX_STAGED_K, device beyond) unless `build` forces one;
    None for a K the build does not take."""
    build = build or ("staged" if k <= MAX_STAGED_K else "device")
    if k < 1 or (build == "staged" and k > MAX_STAGED_K):
        return None
    if build == "device":
        return build, 32, k, 0
    stride = k | 1
    tile = 32
    while 2 * 4 * tile * stride > MAX_SMEM:
        tile //= 2
    return build, tile, stride, tile * stride


def stage_slab_model(smem, dst, mem, src, cnt, k, stride):
    """`stage_slab` for the 32 lanes: `mem` is device memory by word
    address, `dst` a word of the modelled shared memory; slab word i
    lands at row i // k, column i % k of rows `stride` words apart."""
    pad = stride - k
    for lane in range(32):
        col, pos = lane % k, lane + pad * (lane // k)
        for i in range(lane, cnt, 32):
            smem[dst + pos] = mem[src + i]
            col += 32 % k
            pos += 32 + pad * (32 // k)
            if col >= k:
                col -= k
                pos += pad


def kernel_model(arrival, size, window_ns, rate, cap, state, *,
                 phases=(0, 0, 0, 0), build=None):
    """Kernel E (`csrc/router_drain.cu`) as its warps run it: the
    geometry of `choose_geometry`, a warp a tile; in the staged build the
    tile's slabs of arrival and size staged word by word into the warp's
    shared buffers at the kernel's stride (the device build reads its
    rows in device memory); its status and deliver_t slabs filled with
    kQueued and I32_MAX; a lane's `host_model` on its rows, writing the
    entries it consumes to device memory. Device memory is
    word-addressed; `phases` puts arrival, size, status and deliver_t at
    those words mod 4 (a row view's storage offset). Shared and output
    words start as garbage, so a word read or left unwritten shows."""
    n, k = arrival.shape
    geo = e_geometry_model(k, build)
    assert geo is not None, f"K={k} does not fit"
    build, tile, stride, words = geo
    table = [int(x) for x in tcodel.CTRL_TABLE]
    span = (n * k + 7) & ~3  # an array's words and room to offset it
    bases = [i * span + p + 4 for i, p in enumerate(phases)]
    mem = [-54321] * (4 * span + 4)
    for b, a in zip(bases[:2], (arrival, size)):
        mem[b:b + n * k] = [int(v) for v in a.reshape(-1)]
    out = {f: np.array(v, copy=True) for f, v in state.items()}
    co_mask = np.zeros(n, bool)
    co_t = np.zeros(n, np.int32)
    c_idx_out = np.full(n, -1, np.int32)
    steps = np.zeros(n, np.int32)
    a0, s0 = 0, words
    for first in range(0, n, tile):
        smem = [-12345] * (2 * words)
        rows = min(tile, n - first)
        cnt = rows * k
        slab = [b + first * k for b in bases]
        if build == "staged":
            for which, dst in ((0, a0), (1, s0)):
                stage_slab_model(smem, dst, mem, slab[which], cnt, k, stride)
            rows_a = lambda lane: (Row(smem, a0 + lane * stride),
                                   Row(smem, s0 + lane * stride))
        else:
            rows_a = lambda lane: (Row(mem, slab[0] + lane * k),
                                   Row(mem, slab[1] + lane * k))
        mem[slab[2]:slab[2] + cnt] = [0] * cnt
        mem[slab[3]:slab[3] + cnt] = [I32_MAX] * cnt
        for lane in range(rows):
            h = first + lane
            g = {f: (bool(v[h]) if v.dtype == bool else int(v[h]))
                 for f, v in state.items()}
            st, cm, ct, ci, it = host_model(
                *rows_a(lane),
                Row(mem, slab[2] + lane * k), Row(mem, slab[3] + lane * k),
                k, window_ns, int(rate[h]), int(cap[h]), g, table)
            for f, v in st.items():
                out[f][h] = v
            co_mask[h], co_t[h], c_idx_out[h], steps[h] = cm, ct, ci, it
    status, deliver = (np.array(mem[b:b + n * k], np.int32).reshape(n, k)
                       for b in bases[2:])
    return (out, status, deliver, co_mask, co_t, c_idx_out), steps


@pytest.mark.parametrize("k,seed,window_ns", [
    (8, 1, 10 * MS), (16, 2, 10 * MS), (16, 3, 2**30), (32, 4, 10 * MS)])
def test_router_drain_plain_matches_jax(k, seed, window_ns):
    args = drain_inputs(48, k, seed, window_ns=window_ns)
    arrival, size, rate, cap, state = args
    ref = jax_drain(arrival, size, window_ns, rate, cap, state)
    got = port_drain(arrival, size, window_ns, rate, cap, state)
    assert_drains_equal(ref, got, (k, seed))
    # the inputs reach the machine's corners
    st, status = got[0], got[1]
    assert (status == tcodel.STATUS_DELIVERED).any()
    assert got[3].any(), "no carried-over cache delivered: dead test"
    assert st["has_cached"].any() and (got[5] >= 0).any()


@pytest.mark.parametrize("k,seed,window_ns", [
    (8, 5, 10 * MS), (16, 6, 2**30), (32, 7, 10 * MS), (33, 8, 10 * MS)])
def test_kernel_model_matches_plain(k, seed, window_ns):
    """The kernel's loop (stopping at `halted`, pointer-walked queue,
    branches) equals the fixed trip count of selects, and the steps it
    runs are the plain version's count."""
    arrival, size, rate, cap, state = drain_inputs(40, k, seed,
                                                   window_ns=window_ns)
    got, steps = kernel_model(arrival, size, window_ns, rate, cap, state)
    t = torch.from_numpy
    ref = tcodel._router_drain_loop(
        t(arrival), t(size), window_ns, t(rate), t(cap),
        convert.router_from_numpy(state, "cpu"))
    st_ref = {f: v for f, v in convert.tuple_to_numpy(ref[0]).items()
              if f in tcodel.DRAIN_FIELDS}
    st_got = {f: got[0][f] for f in tcodel.DRAIN_FIELDS}
    assert_drains_equal((st_ref, *(a.numpy() for a in ref[1:6])),
                        (st_got, *got[1:]), (k, seed))
    assert np.array_equal(steps, ref[6].numpy())
    assert (steps < 4 * k + 16).all(), "a host ran out of micro-steps"


def model_against_plain(args, window_ns, **kw):
    """`kernel_model` against the plain loop, every output bitwise;
    returns the micro-steps each host ran."""
    arrival, size, rate, cap, state = args
    got, steps = kernel_model(arrival, size, window_ns, rate, cap, state,
                              **kw)
    t = torch.from_numpy
    ref = tcodel._router_drain_loop(
        t(arrival), t(size), window_ns, t(rate), t(cap),
        convert.router_from_numpy(state, "cpu"))
    st_ref = {f: v for f, v in convert.tuple_to_numpy(ref[0]).items()
              if f in tcodel.DRAIN_FIELDS}
    st_got = {f: got[0][f] for f in tcodel.DRAIN_FIELDS}
    assert_drains_equal((st_ref, *(a.numpy() for a in ref[1:6])),
                        (st_got, *got[1:]), kw)
    assert np.array_equal(steps, ref[6].numpy())
    return steps


@pytest.mark.parametrize("n,k,phases", [
    (1, 32, (0, 0, 0, 0)), (31, 32, (1, 2, 3, 0)), (32, 32, (0, 0, 0, 0)),
    (33, 32, (3, 1, 0, 2)), (70, 32, (2, 2, 1, 1)), (40, 1, (3, 1, 2, 0)),
    (40, 2, (1, 0, 3, 1)), (40, 7, (1, 1, 1, 1)), (70, 33, (2, 3, 0, 1)),
    (40, 33, (0, 0, 0, 0)), (9, 300, (1, 0, 0, 3)),
    (20, 1024, (0, 1, 2, 3))])
def test_kernel_model_tiles_and_alignment(n, k, phases):
    """The kernel's tiles, staging and fills, modelled word by word: host
    counts about one tile, odd and even K, slabs at every word phase mod
    16 bytes (a row view's storage offset), tiles of 16 hosts at K=1024;
    every output bitwise the plain loop's."""
    args = drain_inputs(n, k, seed=1000 + n + k)
    model_against_plain(args, 10 * MS, phases=phases)


@pytest.mark.parametrize("n,k", [(65, 32), (40, 33)])
def test_kernel_model_long_chains_beside_halting_hosts(n, k):
    """A host a tile whose tiny bucket caches and resumes every packet
    runs more than K micro-steps, beside a host that halts at once."""
    args = long_chain_drain_inputs(n, k, seed=77)
    steps = model_against_plain(args, 2**30, phases=(1, 3, 2, 1))
    assert (steps[::32] > k).all(), steps[::32]
    assert (steps[1::32] == 1).all()


@pytest.mark.parametrize("k,phases", [(29054, (1, 2, 3, 1)),
                                      (29055, (1, 2, 3, 1)),
                                      (29055, (0, 0, 0, 0))])
def test_kernel_model_stages_the_widest_rows(k, phases):
    """The widest rows the staged build takes (one host a tile): rows of
    padding, one with an entry after the window, halt at once and leave
    the state as it was, every entry queued."""
    _a, _s, rate, cap, state = drain_inputs(3, 8, seed=1)
    state["has_cached"][:] = False
    arrival = np.full((3, k), I32_MAX, np.int32)
    arrival[1, 0] = 11 * MS
    size = np.full((3, k), 1500, np.int32)
    (out, status, deliver, co_mask, co_t, c_idx), steps = kernel_model(
        arrival, size, 10 * MS, rate, cap, state, phases=phases)
    for f in tcodel.DRAIN_FIELDS:
        assert np.array_equal(out[f], state[f]), f
    assert (status == 0).all() and (deliver == I32_MAX).all()
    assert not co_mask.any() and (co_t == 0).all() and (c_idx == -1).all()
    assert (steps == 1).all()


def test_e_geometry_model_edges():
    """`choose_geometry`'s tiles: 32 hosts up to K = 907, smaller tiles
    for wider rows, two hosts at K = 14527, one at the widest staged row
    (K = 29055: 232440 B), odd strides (K for an odd K, K + 1 for an even
    one); wider rows in the device build (32 hosts a tile, rows K words
    apart where they lie, no shared memory), which any K may force."""
    s = "staged"
    assert e_geometry_model(32) == (s, 32, 33, 1056)
    assert e_geometry_model(33) == (s, 32, 33, 1056)
    assert e_geometry_model(907) == (s, 32, 907, 29024)
    assert e_geometry_model(908) == (s, 16, 909, 14544)
    assert e_geometry_model(909) == (s, 16, 909, 14544)
    assert e_geometry_model(1024)[1] == 16
    assert e_geometry_model(14526) == (s, 2, 14527, 29054)
    assert e_geometry_model(14527) == (s, 2, 14527, 29054)
    assert e_geometry_model(14528) == (s, 1, 14529, 14529)
    assert e_geometry_model(29054) == (s, 1, 29055, 29055)
    assert e_geometry_model(29055) == (s, 1, 29055, 29055)
    assert 2 * 4 * 29055 <= MAX_SMEM < 2 * 4 * 29057
    for k in (29056, 32768, 65536):
        assert e_geometry_model(k) == ("device", 32, k, 0)
    assert e_geometry_model(7, "device") == ("device", 32, 7, 0)
    assert e_geometry_model(29056, "staged") is None
    assert e_geometry_model(0) is None
    src = (REPO / "shadow_tpu_torch/csrc/router_drain.cu").read_text()
    assert f"kMaxStagedK = {MAX_STAGED_K};" in src


@pytest.mark.parametrize("n,k,phases", [
    (40, 1, (3, 1, 2, 0)), (40, 7, (1, 1, 1, 1)), (70, 33, (2, 3, 0, 1)),
    (9, 300, (1, 0, 0, 3)), (3, 2047, (0, 1, 2, 3))])
def test_kernel_model_device_build_matches_plain(n, k, phases):
    """The device build forced at K the staged build takes: its machines
    read their rows where they lie, at every word phase; every output
    bitwise the plain loop's, and the staged build's."""
    args = drain_inputs(n, k, seed=2000 + n + k)
    steps = model_against_plain(args, 10 * MS, phases=phases,
                                build="device")
    assert np.array_equal(steps, model_against_plain(args, 10 * MS,
                                                     phases=phases))


@pytest.mark.parametrize("k,seed,window_ns,long_chains", [
    (8, 11, 10 * MS, False), (16, 12, 2**30, False), (33, 13, 2**30, True),
    (64, 14, 10 * MS, True)])
def test_router_drain_plain_stops_once_every_host_halted(k, seed, window_ns,
                                                        long_chains):
    """The plain version's stop once every host has halted (`until`)
    equals JAX's fixed 4K + 16 micro-steps bitwise (the fixed-trip loop
    and JAX's `router_drain`), and stops well before them."""
    make = long_chain_drain_inputs if long_chains else drain_inputs
    args = (make(70, k, seed) if long_chains
            else make(70, k, seed, window_ns=window_ns))
    arrival, size, rate, cap, state = args
    t = torch.from_numpy
    targs = (t(arrival), t(size), window_ns, t(rate), t(cap),
             convert.router_from_numpy(state, "cpu"))
    stopped = tcodel._router_drain_loop(*targs, until=all_halted)
    fixed = tcodel._router_drain_loop(*targs)
    for a, b in zip(convert.tuple_to_numpy(stopped[0]).values(),
                    convert.tuple_to_numpy(fixed[0]).values()):
        assert np.array_equal(a, b)
    for a, b in zip(stopped[1:], fixed[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(stopped[6].max()) < 4 * k + 16
    ref = jax_drain(arrival, size, window_ns, rate, cap, state)
    st, *rest = tcodel.router_drain_plain(*targs, until=all_halted)
    got = (convert.tuple_to_numpy(st), *(a.numpy() for a in rest))
    assert_drains_equal(ref, got, (k, seed))


def test_router_drain_on_cpu_runs_the_plain_version():
    """CPU tensors run the plain version whatever `plain` says; no output
    aliases the input state."""
    arrival, size, rate, cap, state = drain_inputs(8, 8, 9)
    t = torch.from_numpy
    st = convert.router_from_numpy(state, "cpu")
    before = dict(pipeline.LAUNCHES)
    out = tcodel.router_drain(t(arrival), t(size), 10 * MS, t(rate), t(cap),
                              st)
    assert pipeline.LAUNCHES == before
    for f in tcodel.DRAIN_FIELDS:
        assert getattr(out[0], f).data_ptr() != getattr(st, f).data_ptr()
    ref = port_drain(arrival, size, 10 * MS, rate, cap, state)
    assert_drains_equal(ref, (convert.tuple_to_numpy(out[0]),
                              *(a.numpy() for a in out[1:])))


# -- window_step(router_aqm=True) on the single-link traces -------------------

# one egress width for every trace (the widest burst is 80 packets) and
# two ingress widths, so JAX compiles the step twice
TRACE_EGRESS = 96


@pytest.fixture(scope="module")
def jax_trace_step():
    return jax.jit(lambda *a: jplane.window_step(*a, rr_enabled=False,
                                                 router_aqm=True))


def run_trace(jstep, arrivals, down_bw_bps, window_ns, n_windows,
              ingress_cap):
    """`tests/test_tpu_router_aqm.py`'s `_device_run` through both
    packages: 2 hosts, every packet 0 -> 1 with zero latency, each
    ingested in the window its time falls in; state, delivered dict and
    next event compared every window. Returns the port's final state and
    its deliveries."""
    n = 2
    params = jplane.make_params(
        np.zeros((n, n), np.int32), np.zeros((n, n), np.float32),
        np.full(n, 8e12), down_bw_bps=np.full(n, down_bw_bps))
    jst = jplane.make_state(
        n, egress_cap=TRACE_EGRESS, ingress_cap=ingress_cap,
        initial_tokens=np.full(n, 2**30, np.int32),
        initial_dn_tokens=np.asarray(params.dn_cap))
    tst = convert.state_from_numpy(jax_state_to_numpy(jst), "cpu")
    tparams = convert.params_from_numpy(jax_params_to_numpy(params), "cpu")
    by_window: dict[int, list] = {}
    for t, _src, seq, payload in arrivals:
        by_window.setdefault(t // window_ns, []).append(
            (t, seq, payload + CONFIG_HEADER_SIZE_UDPIPETH))
    key = jax.random.PRNGKey(0)
    delivered = []
    for w in range(n_windows):
        prev_start = (w - 1) * window_ns if w > 0 else 0
        batch = by_window.get(w, [])
        if batch:
            b = len(batch)
            cols = (np.zeros(b, np.int32), np.ones(b, np.int32),
                    np.asarray([x[2] for x in batch], np.int32),
                    np.asarray([x[1] for x in batch], np.int32),
                    np.asarray([x[1] for x in batch], np.int32),
                    np.zeros(b, bool))
            send = np.asarray([x[0] - prev_start for x in batch], np.int32)
            clamp = np.zeros(b, np.int32)
            jst = jplane.ingest(jst, *map(jnp.asarray, cols),
                                send_rel=jnp.asarray(send),
                                clamp_rel=jnp.asarray(clamp))
            tst = tplane.ingest(tst, *map(torch.from_numpy, cols),
                                send_rel=torch.from_numpy(send),
                                clamp_rel=torch.from_numpy(clamp))
        shift = 0 if w == 0 else window_ns
        jst, jd, jn = jstep(jst, params, key, jnp.int32(shift),
                            jnp.int32(window_ns))
        tst, td, tn = tplane.window_step(tst, tparams, 0, shift, window_ns,
                                         rr_enabled=False, router_aqm=True)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        assert jd.keys() == td.keys()
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
        assert int(jn) == int(tn), w
        mask, seq, t = (td[k].numpy() for k in ("mask", "seq", "deliver_rel"))
        for i, j in zip(*np.nonzero(mask)):
            delivered.append((w * window_ns + int(t[i, j]), int(seq[i, j])))
    return tst, delivered


# the six traces of tests/test_tpu_router_aqm.py: (arrivals, down_bw_bps,
# window_ns, n_windows, ingress_cap). The ingress ring holds every packet
# a window leaves queued, as the JAX test's 128 slots do; the burst
# trace drains in 24 windows (the JAX test runs 40)
TRACES = {
    "passthrough": ([(i * 2_000_000, 7, i, 600) for i in range(20)],
                    100_000_000, 10_000_000, 6, 16),
    "queueing_drops": ([(i * 100_000, 3, i, 600) for i in range(80)],
                       1_000_000, 20_000_000, 24, 96),
    "cached_across_boundary": (
        [(0, 1, 0, 1400), (100_000, 1, 1, 1400), (200_000, 1, 2, 1400),
         (9_900_000, 1, 3, 1400), (25_000_000, 1, 4, 200)],
        2_000_000, 10_000_000, 8, 16),
    "idle_gaps": ([(b * 150_000_000 + i * 50_000, 9, b * 10 + i, 400)
                   for b in range(4) for i in range(10)],
                  5_000_000, 25_000_000, 30, 16),
    "long_idle_then_burst": (
        [(0, 1, 0, 1400), (5_000_000, 1, 1, 1400),
         (2_500_000_000, 1, 2, 1400), (2_501_000_000, 1, 3, 1400),
         (2_502_000_000, 1, 4, 1400)], 1_000_000, 100_000_000, 30, 16),
    "resume_overflow": ([(0, 1, 0, 1400), (890_000_000, 1, 1, 1400),
                         (900_000_000, 1, 2, 1400)], 8_000, 1_000_000_000,
                        6, 16),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_window_step_aqm_traces_match_jax(jax_trace_step, name):
    st, delivered = run_trace(jax_trace_step, *TRACES[name])
    arrivals = TRACES[name][0]
    assert int(st.n_overflow_dropped.sum()) == 0
    dropped = int(st.router.dropped[1])
    assert len(delivered) + dropped == len(arrivals), name
    if name == "queueing_drops":
        assert dropped > 0, "CoDel never dropped: dead test"
    if name == "passthrough":
        assert dropped == 0


def test_window_step_aqm_multi_host_matches_jax():
    """Two destinations with different down rates (one instant, one
    paced and dropping) keep independent router state, window by
    window."""
    n = 3
    params = jplane.make_params(
        np.zeros((n, n), np.int32), np.zeros((n, n), np.float32),
        np.full(n, 8e12),
        down_bw_bps=np.asarray([8e12, 1_000_000, 100_000_000]))
    jst = jplane.make_state(n, egress_cap=64, ingress_cap=32,
                            initial_tokens=np.full(n, 2**30, np.int32),
                            initial_dn_tokens=np.asarray(params.dn_cap))
    b = 40
    cols = (np.zeros(b, np.int32), np.asarray([1, 2] * 20, np.int32),
            np.full(b, 628, np.int32), np.arange(b, dtype=np.int32),
            np.arange(b, dtype=np.int32), np.zeros(b, bool))
    send = np.repeat(np.arange(20) * 100_000, 2).astype(np.int32)
    clamp = np.zeros(b, np.int32)
    tst = convert.state_from_numpy(jax_state_to_numpy(jst), "cpu")
    tparams = convert.params_from_numpy(jax_params_to_numpy(params), "cpu")
    jst = jplane.ingest(jst, *map(jnp.asarray, cols),
                        send_rel=jnp.asarray(send),
                        clamp_rel=jnp.asarray(clamp))
    tst = tplane.ingest(tst, *map(torch.from_numpy, cols),
                        send_rel=torch.from_numpy(send),
                        clamp_rel=torch.from_numpy(clamp))
    jstep = jax.jit(lambda *a: jplane.window_step(*a, rr_enabled=False,
                                                  router_aqm=True))
    key = jax.random.PRNGKey(0)
    window = 50_000_000
    for w in range(10):
        shift = 0 if w == 0 else window
        jst, jd, jn = jstep(jst, params, key, jnp.int32(shift),
                            jnp.int32(window))
        tst, td, tn = tplane.window_step(tst, tparams, 0, shift, window,
                                         rr_enabled=False, router_aqm=True)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
        assert int(jn) == int(tn)
    drops = tst.router.dropped.tolist()
    assert drops[0] == 0 and drops[2] == 0
    assert int(tst.n_delivered[1]) + drops[1] == 20
    assert int(tst.n_delivered[2]) == 20


# -- PHOLD windows with the AQM on every kernel --------------------------------

AQM_WINDOWS = 6
PLANE_WINDOWS = 14  # CoDel drops after 100 ms of standing delay


def burst_world(n, ce, ci, seed):
    """Every host's egress ring filled with 1400 B packets to random
    destinations over 10 Gbit/s uplinks, 1 Mbit/s downlinks (125 B/ms)
    and 10 % loss: ~ce packets queue at each router, ~11 ms of tokens
    each, so the standing delay outlasts CoDel's 100 ms interval."""
    from shadow_tpu.tpu import ingest, make_params, make_state

    rng = np.random.default_rng(seed)
    lat = rng.integers(1 * MS, 20 * MS, size=(n, n)).astype(np.int32)
    params = make_params(lat, np.full((n, n), 0.1, np.float32),
                         np.full((n,), 10**10, np.int64),
                         down_bw_bps=np.full((n,), 1_000_000))
    state = make_state(n, egress_cap=ce, ingress_cap=ci, params=params,
                       initial_tokens=np.asarray(params.tb_cap))
    b = n * ce
    batch = dict(src=np.repeat(np.arange(n, dtype=np.int32), ce),
                 dst=rng.integers(0, n, b).astype(np.int32),
                 nbytes=np.full(b, 1400, np.int32),
                 prio=np.arange(b, dtype=np.int32),
                 seq=np.arange(b, dtype=np.int32),
                 ctrl=np.zeros(b, bool),
                 sock=rng.integers(0, 40, b).astype(np.int32))
    tst = convert.state_from_numpy(jax_state_to_numpy(state), "cpu")
    jst = jplane.ingest(state, **{k: jnp.asarray(v) for k, v in batch.items()})
    tst = tplane.ingest(tst, **{k: torch.from_numpy(v)
                                for k, v in batch.items()})
    tparams = convert.params_from_numpy(jax_params_to_numpy(params), "cpu")
    return (params, jst), (tparams, tst)


@pytest.mark.parametrize("kernel,jax_kernel", [
    ("pallas_fused", "pallas_fused"), ("pallas", "xla"), ("xla", "xla")])
def test_phold_aqm_matches_jax_on_every_kernel(kernel, jax_kernel):
    before = dict(pipeline.LAUNCHES)
    # rr_world's 400 kbit/s downlinks (50 B/ms) cache and drop early
    world = rr_world(16, 8, 16, rr_mix=False, seed=11)
    final, _m, _h = phold_both(world, AQM_WINDOWS, kernel=kernel,
                               jax_kernel=jax_kernel, router_aqm=True)
    assert pipeline.LAUNCHES == before  # CPU tensors: plain versions
    assert int(final.n_delivered.sum()) > 0
    assert bool(final.router.has_cached.any()), "nothing cached: dead test"


def test_phold_aqm_rr_matches_jax():
    world = rr_world(16, 8, 16, rr_mix=True, seed=12)
    final, _m, _h = phold_both(world, AQM_WINDOWS, rr_enabled=True,
                               router_aqm=True)
    assert int(final.rr_sent.abs().sum()) > 0


def test_aqm_with_every_plane_matches_jax():
    """metrics, guards, histograms, the flight recorder (every packet
    sampled) and neutral faults on "xla" with the AQM, against JAX:
    each plane bitwise every window, `drop_qdisc` equal to the router's
    drops, a clean guard run, and AQM-drop hops in the recorder."""
    from shadow_tpu.faults.plane import neutral_faults as jneutral
    from shadow_tpu.guards import make_guards as jguards
    from shadow_tpu.telemetry import make_flightrec as jflightrec
    from shadow_tpu.telemetry import make_histograms as jhist
    from shadow_tpu.telemetry import make_metrics as jmetrics
    from shadow_tpu_torch.faults.plane import neutral_faults
    from shadow_tpu_torch.guards.plane import make_guards, summarize
    from shadow_tpu_torch.telemetry import flightrec as tfr
    from shadow_tpu_torch.telemetry import histo, metrics as tmetrics

    n = 16
    (params, jst), (tparams, tst) = burst_world(n, 16, 32, seed=13)
    key = jax.random.key(3)
    jp = dict(faults=jneutral(n), metrics=jmetrics(n), guards=jguards(n),
              hist=jhist(n), flightrec=jflightrec(5, sample_every=1))
    tp = dict(faults=neutral_faults(n, device="cpu"),
              metrics=tmetrics.make_metrics(n, device="cpu"),
              guards=make_guards(n, device="cpu"),
              hist=histo.make_histograms(n, device="cpu"),
              flightrec=tfr.make_flightrec(5, sample_every=1, device="cpu"))

    @jax.jit
    def jstep(st, sh, m, g, h, fr):
        out = jplane.window_step(st, params, key, sh, jnp.int32(10 * MS),
                                 rr_enabled=False, router_aqm=True,
                                 faults=jp["faults"], metrics=m, guards=g,
                                 hist=h, flightrec=fr)
        return out

    names = ("metrics", "guards", "hist", "flightrec")
    for w in range(PLANE_WINDOWS):
        shift = 0 if w == 0 else 10 * MS
        jout = jstep(jst, jnp.int32(shift), *(jp[k] for k in names))
        tout = tplane.window_step(tst, tparams, 3, shift, 10 * MS,
                                  rr_enabled=False, router_aqm=True, **tp)
        jst, tst = jout[0], tout[0]
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        for k in jout[1]:
            assert np.array_equal(np.asarray(jout[1][k]),
                                  tout[1][k].numpy()), (w, k)
        for i, k in enumerate(names):
            jp[k], tp[k] = jout[3 + i], tout[3 + i]
        for k in ("metrics", "guards", "hist"):
            assert_tuples_equal(jp[k], tp[k], (w, k))
        jfr = convert.flightrec_to_numpy(tp["flightrec"])
        for f, v in jp["flightrec"]._asdict().items():
            assert np.array_equal(np.asarray(v), jfr[f]), (w, f)
    dropped = tst.router.dropped.to(torch.int64).sum()
    assert int(dropped) > 0, "CoDel never dropped: dead test"
    assert int(tp["metrics"].drop_qdisc.to(torch.int64).sum()) == int(dropped)
    assert summarize(tp["guards"])["clean"]
    assert bool((tp["flightrec"].ev_kind == tfr.HOP_DROP_AQM).any())

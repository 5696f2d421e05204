"""The port's flow plane against the JAX package's, bitwise: the TCP
helpers it reuses (the closed-form `_avoid_tick` on a lattice of loop
boundaries), `enqueue`, `flow_recv`, `flow_emit` and `flow_step` on random
delivered dicts (tagged, untagged, endpoint-mismatched, duplicate and
out-of-window arrivals, idle windows, expired RTOs), `window_step` with
the flow and compute planes threaded, and 12 windows of the scenario
runner's split flow loop on serve_burst_lossy, step by step."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, assert_tuples_equal,  # noqa: E402
                          jax_state_to_numpy)

from shadow_tpu.telemetry import make_histograms, make_metrics  # noqa: E402
from shadow_tpu.tcp import cong as jcong  # noqa: E402
from shadow_tpu.tcp import rtt as jrtt  # noqa: E402
from shadow_tpu.tpu import compute as jcompute  # noqa: E402
from shadow_tpu.tpu import flows as jflows  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu.tpu import tcp as jtcp  # noqa: E402
from shadow_tpu.workloads import compile as jcompile  # noqa: E402
from shadow_tpu.workloads import device as jdevice  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.telemetry import histo as thisto  # noqa: E402
from shadow_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from shadow_tpu_torch.tpu import compute as tcompute  # noqa: E402
from shadow_tpu_torch.tpu import flows as tflows  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.tpu import tcp as ttcp  # noqa: E402
from shadow_tpu_torch.workloads import compile as tcompile  # noqa: E402
from shadow_tpu_torch.workloads import device as tdevice  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

CORPUS = Path(__file__).resolve().parent.parent / "scenarios"
MS = 1_000_000
WINDOW = 5 * MS
INF = 2**31 - 1
W = 16  # receive window of the random flow states


def test_constants_match_jax():
    assert (ttcp.INITIAL_CWND, ttcp.SSTHRESH_INF) == (
        jcong.INITIAL_WINDOW, jcong._SSTHRESH_INF)
    assert (ttcp.RTO_INIT_MS, ttcp.RTO_MIN_MS, ttcp.RTO_MAX_MS) == (
        jrtt.RTO_INIT_MS, jrtt.RTO_MIN_MS, jrtt.RTO_MAX_MS)
    assert (ttcp.PH_SLOW_START, ttcp.PH_AVOIDANCE, ttcp.PH_RECOVERY) == (
        jtcp.PH_SLOW_START, jtcp.PH_AVOIDANCE, jtcp.PH_RECOVERY)
    assert (tflows.ACK_BYTES, tflows.EMIT_CAP, tflows.RECV_WND,
            tflows.SOCK_RESERVED) == (jflows.ACK_BYTES, jflows.EMIT_CAP,
                                      jflows.RECV_WND, jflows.SOCK_RESERVED)


def _avoid_lattice(cwnds):
    """(cwnd, acked, n) with acked + n at k trips' worth of acks (the
    loop's exit boundaries) and one either side, for n = 0, 1 and the
    default receive window. Near 2**30 the float64 square root is no
    longer exact, which is what the integer correction is for."""
    cw, ac, nn = [], [], []
    for c in cwnds:
        ks = [0, 1, 2] if c >= 2**29 else [0, 1, 2, 3, 7, 64]
        if c == 1:
            ks += [60000]
        for k in ks:
            t = k * c + k * (k - 1) // 2
            for total in (t - 1, t, t + 1):
                if total >= INF:
                    continue  # the JAX loop's own cwnd wraps there
                for n in (0, 1, tflows.RECV_WND):
                    if total - n >= 0:
                        cw.append(c)
                        ac.append(total - n)
                        nn.append(n)
    return [np.asarray(a, np.int32) for a in (cw, ac, nn)]


@pytest.mark.parametrize("cwnds", [(1, 2, 3), (10, 63, 64, 1000),
                                   (2**20, 2**29 + 7, 2**30, 2**30 + 12345,
                                    INF)],
                         ids=["small", "typical", "huge"])
def test_avoid_tick_lattice_matches_jax(cwnds):
    cw, ac, nn = _avoid_lattice(cwnds)
    want = jax.vmap(jtcp._avoid_tick)(jnp.asarray(cw), jnp.asarray(ac),
                                      jnp.asarray(nn))
    got = ttcp._avoid_tick(*(torch.from_numpy(a) for a in (cw, ac, nn)))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy())


def random_flow_state(rng, f, *, w=W, rto_due=False) -> dict:
    """A consistent random FlowState as numpy: the stream offsets
    ordered, bit 0 of the receive bitmap clear, some flows backed off,
    in recovery or with SSTHRESH_INF, some RTOs due when `rto_due`."""
    i = lambda lo, hi, dt=np.int32: rng.integers(lo, hi, f).astype(dt)
    una = i(0, 40)
    nxt = una + i(0, 20)
    smax = nxt + i(0, 6)
    cwnd = i(1, 80)
    clock = i(0, 3000)
    bits = rng.random((f, w)) < 0.3
    bits[:, 0] = False
    srtt = np.where(rng.random(f) < 0.3, 0, i(1, 3000)).astype(np.int32)
    armed = rng.random(f) < 0.7
    deadline = clock + (i(-50, 5) if rto_due else i(1, 800))
    return {
        "snd_una": una, "snd_nxt": nxt, "snd_max": smax,
        "stream_len": smax + i(0, 30), "rcv_nxt": i(0, 40),
        "rcv_bits": bits, "ack_pending": rng.random(f) < 0.4,
        "cwnd": cwnd,
        "ssthresh": np.where(rng.random(f) < 0.3, INF,
                             i(1, 100)).astype(np.int32),
        "phase": i(0, 3), "dup_acks": i(0, 4),
        "avoid_acked": (rng.integers(0, 1 << 20, f) % cwnd).astype(np.int32),
        "srtt_ms": srtt, "rttvar_ms": i(0, 2000),
        "rto_ms": i(200, 120001), "backoff_count": i(0, 4),
        "rto_gen": i(0, 100), "rto_armed": armed,
        "rto_deadline_ms": deadline.astype(np.int32),
        "rtt_seq": np.where(rng.random(f) < 0.5, -1,
                            una + i(0, 20)).astype(np.int32),
        "rtt_sent_ms": np.maximum(clock - i(0, 2000), 0).astype(np.int32),
        "retransmit_count": i(0, 100), "retransmitted_bytes": i(0, 99999),
        "rto_fired": i(0, 10), "clock_ms": clock,
        "clock_rem_ns": i(0, 1_000_000),
    }


def both_states(d):
    return (jflows.FlowState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.tuple_from_numpy(tflows.FlowState, d, "cpu"))


HELPERS = {
    "cong_new_ack": (lambda m, s, n, now: m._cong_new_ack(s, n)),
    "cong_timeout": (lambda m, s, n, now: m._cong_timeout(s)),
    "rtt_update": (lambda m, s, n, now: m._rtt_update(s, now - s.rtt_sent_ms)),
    "rtt_backoff": (lambda m, s, n, now: m._rtt_backoff(s)),
    "rtt_reset_backoff": (lambda m, s, n, now: m._rtt_reset_backoff(s)),
    "arm_rto": (lambda m, s, n, now: m._arm_rto(s, now)),
    "disarm_rto": (lambda m, s, n, now: m._disarm_rto(s)),
    "set_rto": (lambda m, s, n, now: m._set_rto(s, n * 977 - 3000)),
}


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_tcp_helper_matches_jax(helper):
    """Each helper, batched, against JAX's scalar helper under vmap on
    random flow states (n from 0 to past the receive window, now up to
    far past every send time)."""
    rng = np.random.default_rng(len(helper))
    d = random_flow_state(rng, 257)
    n = rng.integers(0, 2 * tflows.RECV_WND, 257).astype(np.int32)
    now = (d["clock_ms"] + rng.integers(0, 5000, 257)).astype(np.int32)
    fn = HELPERS[helper]
    js, ts = both_states(d)
    want = jax.vmap(lambda s, a, b: fn(jtcp, s, a, b))(
        js, jnp.asarray(n), jnp.asarray(now))
    got = fn(ttcp, ts, torch.from_numpy(n), torch.from_numpy(now))
    assert_tuples_equal(want, got, helper)


def test_sel_and_rto_from_estimate_match_jax():
    rng = np.random.default_rng(1)
    a, b = random_flow_state(rng, 64), random_flow_state(rng, 64)
    pred = rng.random(64) < 0.5
    (ja, ta), (jb, tb) = both_states(a), both_states(b)
    assert_tuples_equal(
        jtcp.sel_batched(jnp.asarray(pred), ja, jb),
        ttcp.sel_batched(torch.from_numpy(pred), ta, tb))
    assert np.array_equal(
        np.asarray(jtcp._rto_from_estimate(ja.srtt_ms, ja.rttvar_ms)),
        ttcp._rto_from_estimate(ta.srtt_ms, ta.rttvar_ms).numpy())


# -- the flow plane's halves -------------------------------------------------


def flow_world(rng, n=8, f=12, *, inactive=0):
    """Flow tables between random host pairs (the last `inactive` slots
    inactive), as numpy."""
    src = rng.integers(0, n, f).astype(np.int32)
    dst = ((src + rng.integers(1, n, f)) % n).astype(np.int32)
    src[f - inactive:] = -1
    dst[f - inactive:] = -1
    return src, dst, rng.integers(64, 1500, f).astype(np.int32)


def both_tables(src, dst, nbytes):
    return (jflows.make_flow_tables(src, dst, nbytes),
            tflows.make_flow_tables(src, dst, nbytes, device="cpu"))


def random_delivered(rng, n, ci, src, dst, fs, *, fill=0.6):
    """A delivered dict (row-major by receiving host) mixing every kind
    of arrival the flow plane distinguishes: in-window data, duplicates
    below rcv_nxt, data past the window, cumulative acks, untagged and
    reserved socks, tags whose endpoints do not match, tags past the
    flow table, and masked-out slots carrying tags."""
    f = src.shape[0]
    d = {k: np.zeros((n, ci), np.int32)
         for k in ("src", "seq", "sock", "bytes", "deliver_rel")}
    d["mask"] = np.zeros((n, ci), bool)
    used = np.zeros(n, int)
    for _ in range(int(fill * n * ci)):
        fl = int(rng.integers(0, f))
        kind = rng.integers(0, 8)
        row, psrc = int(dst[fl]), int(src[fl])
        sock, seq = int(tflows.data_tag(fl)), int(fs["rcv_nxt"][fl])
        if kind == 0:
            seq += int(rng.integers(0, 6))
        elif kind == 1:
            seq -= int(rng.integers(1, 4))  # duplicate
        elif kind == 2:
            seq += W + int(rng.integers(0, 3))  # past the window
        elif kind == 3:  # a cumulative ack, at the sender
            row, psrc = psrc, row
            sock = int(tflows.ack_tag(fl))
            seq = int(fs["snd_una"][fl]) + int(rng.integers(-2, 12))
        elif kind == 4:
            sock = int(rng.integers(0, 2))  # untagged or reserved
        elif kind == 5:
            psrc = (psrc + 1) % n  # wrong source
        elif kind == 6:
            sock = int(tflows.data_tag(f + int(rng.integers(0, 3))))
        if row < 0:
            row, psrc = int(rng.integers(0, n)), int(rng.integers(0, n))
        c = used[row]
        if c >= ci:
            continue
        used[row] += 1
        d["mask"][row, c] = kind != 7 or rng.random() < 0.5
        d["src"][row, c], d["seq"][row, c], d["sock"][row, c] = \
            psrc, seq, sock
        d["bytes"][row, c] = int(rng.integers(64, 1500))
        d["deliver_rel"][row, c] = int(rng.integers(0, WINDOW))
    return d


def mini_world(n=8, ce=16, ci=16):
    params = jplane.make_params(np.full((n, n), MS, np.int64),
                                np.zeros((n, n), np.float32),
                                np.full(n, 10**9, np.int64))
    state = jplane.make_state(n, egress_cap=ce, ingress_cap=ci,
                              params=params)
    return (state, convert.state_from_numpy(jax_state_to_numpy(state),
                                            "cpu"))


def delivered_both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


@pytest.mark.parametrize("seed", range(4))
def test_flow_recv_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src, dst, nbytes = flow_world(rng, inactive=2)
    d = random_flow_state(rng, 12)
    jft, tft = both_tables(src, dst, nbytes)
    js, ts = both_states(d)
    jd, td = delivered_both(random_delivered(rng, 8, 16, src, dst, d))
    jfs, jcred = jflows.flow_recv(jft, js, jd, jnp.int32(WINDOW))
    tfs, tcred = tflows.flow_recv(tft, ts, td, WINDOW)
    assert_tuples_equal(jfs, tfs, seed)
    assert np.array_equal(np.asarray(jcred), tcred.numpy())
    assert tcred.dtype == torch.int32
    assert int(tcred.sum()) > 0 and (tfs.snd_una != ts.snd_una).any()


def test_flow_recv_idle_and_foreign_windows_match_jax():
    """A window with no delivery, one of foreign traffic only, and an
    all-inactive flow table: JAX takes its idle branch, the port its one
    branch; the flow state moves only its clock and no credit is
    given."""
    rng = np.random.default_rng(9)
    src, dst, nbytes = flow_world(rng)
    d = random_flow_state(rng, 12)
    cases = []
    empty = random_delivered(rng, 8, 16, src, dst, d, fill=0)
    cases.append((src, dst, empty))
    foreign = random_delivered(rng, 8, 16, src, dst, d)
    foreign["sock"] = np.where(foreign["sock"] > 1, 1, foreign["sock"])
    cases.append((src, dst, foreign))
    tagged = random_delivered(rng, 8, 16, src, dst, d)
    cases.append((np.full(12, -1, np.int32), np.full(12, -1, np.int32),
                  tagged))
    for i, (s, t, dd) in enumerate(cases):
        jft, tft = both_tables(s, t, nbytes)
        js, ts = both_states(d)
        jd, td = delivered_both(dd)
        jfs, jcred = jflows.flow_recv(jft, js, jd, jnp.int32(WINDOW))
        tfs, tcred = tflows.flow_recv(tft, ts, td, WINDOW)
        assert_tuples_equal(jfs, tfs, i)
        assert int(tcred.abs().sum()) == 0 and not np.asarray(jcred).any()
        moved = [f for f in tflows.FlowState._fields
                 if not torch.equal(getattr(tfs, f), getattr(ts, f))]
        assert set(moved) <= {"clock_ms", "clock_rem_ns"}, (i, moved)


@pytest.mark.parametrize("emit_cap", [1, 8])
@pytest.mark.parametrize("metrics", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_flow_emit_matches_jax(emit_cap, metrics, ties):
    """Expired RTOs fire (go-back-N with backoff), the cwnd-gated lanes
    and delayed acks append through `ingest`, a full egress ring
    overflows into the metrics. With `ties` every flow's next segment
    and every ack carry the same seq, so a host's data lanes and acks
    tie on (src, seq) and only the append's order separates them."""
    rng = np.random.default_rng(emit_cap)
    src, dst, nbytes = flow_world(rng, inactive=1)
    d = random_flow_state(rng, 12, rto_due=True)
    if ties:
        d["snd_una"][:], d["snd_nxt"][:], d["rcv_nxt"][:] = 3, 5, 5
        d["snd_max"] = np.maximum(d["snd_max"], 5).astype(np.int32)
        d["stream_len"] = (d["snd_max"] + 20).astype(np.int32)
        d["ack_pending"][:] = True
    jft, tft = both_tables(src, dst, nbytes)
    js, ts = both_states(d)
    jst, tst = mini_world(ce=4)
    jm = make_metrics(8) if metrics else None
    tm = tmetrics.make_metrics(8, device="cpu") if metrics else None
    for r in range(3):
        jout = jflows.flow_emit(jft, js, jst, emit_cap=emit_cap, metrics=jm)
        tout = tflows.flow_emit(tft, ts, tst, emit_cap=emit_cap, metrics=tm)
        assert len(jout) == len(tout) == 2 + metrics
        (jst, js), (tst, ts) = jout[:2], tout[:2]
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), r)
        assert_tuples_equal(js, ts, r)
        if metrics:
            jm, tm = jout[2], tout[2]
            assert_tuples_equal(jm, tm, r)
    assert int(ts.rto_fired.sum()) > int(d["rto_fired"].sum())
    assert int(tst.n_overflow_dropped.sum()) > 0
    if metrics:
        assert int(tm.retransmits.sum()) > 0
    assert torch.equal(tflows.retransmits_by_host(tft, ts, 8),
                       torch.from_numpy(np.array(
                           jflows.retransmits_by_host(jft, js, 8))))
    assert tflows.flow_totals(tft, ts) == jflows.flow_totals(jft, js)
    assert int(tflows.next_deadline_rel_ns(tft, ts)) == int(
        jflows.next_deadline_rel_ns(jft, js))


def test_flow_emit_idle_and_inactive_match_jax():
    """Nothing to send (JAX's idle gate) and an all-inactive table
    leave the state and the metrics unchanged and equal to JAX's."""
    rng = np.random.default_rng(4)
    src, dst, nbytes = flow_world(rng)
    idle = random_flow_state(rng, 12)
    idle["ack_pending"][:] = False
    idle["rto_armed"][:] = False
    idle["stream_len"] = idle["snd_nxt"].copy()
    # pending acks and segments, but on inactive slots only
    busy = dict(idle, ack_pending=rng.random(12) < 0.5,
                stream_len=idle["stream_len"] + 5)
    off = np.full(12, -1, np.int32)
    for s, t, dd in ((src, dst, idle), (off, off, busy)):
        jft, tft = both_tables(s, t, nbytes)
        js, ts = both_states(dd)
        jst, tst = mini_world()
        jst2, js2, jm = jflows.flow_emit(jft, js, jst, metrics=make_metrics(8))
        tst2, ts2, tm = tflows.flow_emit(
            tft, ts, tst, metrics=tmetrics.make_metrics(8, device="cpu"))
        assert_states_equal(jax_state_to_numpy(jst2),
                            convert.state_to_numpy(tst2))
        assert convert.state_digest(tst2) == convert.state_digest(tst)
        assert_tuples_equal(js2, ts2)
        assert_tuples_equal(jm, tm)
        assert not any(bool(getattr(tm, f).any()) for f in tm._fields)


def test_flow_emit_refuses_guards_and_flightrec():
    """The guard and flight-recorder hooks, once refused, now run as
    JAX's: append conservation under ring overflow, and the RTO-fired
    and retransmit hops (every segment sampled, a ring of 48 slots
    overwritten), with the metrics, over three emissions."""
    from shadow_tpu.guards import plane as jgplane
    from shadow_tpu.telemetry import flightrec as jfr
    from shadow_tpu_torch.guards import plane as tgplane

    rng = np.random.default_rng(7)
    src, dst, nbytes = flow_world(rng, inactive=1)
    jft, tft = both_tables(src, dst, nbytes)
    js, ts = both_states(random_flow_state(rng, 12, rto_due=True))
    jst, tst = mini_world(ce=4)
    jm, tm = make_metrics(8), tmetrics.make_metrics(8, device="cpu")
    jg, tg = jgplane.make_guards(8), tgplane.make_guards(8, device="cpu")
    jf = jfr.make_flightrec(3, sample_every=1, ring=48)
    tf = convert.flightrec_from_numpy(
        {k: np.asarray(v) for k, v in jf._asdict().items()}, "cpu")
    for r in range(3):
        jst, js, jm, jg, jf = jflows.flow_emit(
            jft, js, jst, emit_cap=4, metrics=jm, guards=jg, flightrec=jf)
        tst, ts, tm, tg, tf = tflows.flow_emit(
            tft, ts, tst, emit_cap=4, metrics=tm, guards=tg, flightrec=tf)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), r)
        for ref, got in ((js, ts), (jm, tm), (jg, tg)):
            assert_tuples_equal(ref, got, r)
        tfd = convert.flightrec_to_numpy(tf)
        for k, v in jf._asdict().items():
            assert tfd[k].dtype == np.asarray(v).dtype, (r, k)
            assert np.array_equal(tfd[k], np.asarray(v)), (r, k)
    assert int(tst.n_overflow_dropped.sum()) > 0
    assert int(tf.cursor) > 48 and int(tg.checks) == 3
    kinds = set(tf.ev_kind.tolist())
    assert {6, 7} <= kinds  # rto_fired and retransmit hops


@pytest.mark.parametrize("seed", range(3))
def test_enqueue_and_flow_step_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    src, dst, nbytes = flow_world(rng, inactive=seed)
    d = random_flow_state(rng, 12, rto_due=seed == 2)
    jft, tft = both_tables(src, dst, nbytes)
    js, ts = both_states(d)
    ids = rng.integers(-2, 12, (8, 3, 5)).astype(np.int32)
    valid = rng.random((8, 3, 5)) < 0.6
    js = jflows.enqueue(jft, js, jnp.asarray(ids), jnp.asarray(valid))
    ts = tflows.enqueue(tft, ts, torch.from_numpy(ids),
                        torch.from_numpy(valid))
    assert_tuples_equal(js, ts)
    jst, tst = mini_world()
    jd, td = delivered_both(random_delivered(rng, 8, 16, src, dst, d))
    jm, tm = make_metrics(8), tmetrics.make_metrics(8, device="cpu")
    jst, js, jcred, jm = jflows.flow_step(jft, js, jst, jd,
                                          jnp.int32(WINDOW), metrics=jm)
    tst, ts, tcred, tm = tflows.flow_step(tft, ts, tst, td, WINDOW,
                                          metrics=tm)
    assert_states_equal(jax_state_to_numpy(jst), convert.state_to_numpy(tst))
    assert_tuples_equal(js, ts)
    assert_tuples_equal(jm, tm)
    assert np.array_equal(np.asarray(jcred), tcred.numpy())


def test_flow_state_carries_through_numpy():
    rng = np.random.default_rng(2)
    d = random_flow_state(rng, 12)
    js, ts = both_states(d)
    back = convert.tuple_from_numpy(tflows.FlowState,
                                    convert.tuple_to_numpy(ts), "cpu")
    assert_tuples_equal(js, back)
    jft = jflows.make_flow_tables(*flow_world(rng), np.zeros((8, 2, 3)))
    tft = convert.tuple_from_numpy(tflows.FlowTables, jft._asdict(), "cpu")
    assert_tuples_equal(jft, tft)
    assert convert.digest_pytrees(ts, tft) == jrunner.digest_pytrees(js, jft)
    bare = jflows.make_flow_tables(*flow_world(rng))
    tbare = convert.tuple_from_numpy(tflows.FlowTables, bare._asdict(), "cpu")
    assert tbare.lane_flow is None
    assert convert.tuple_to_numpy(tbare)["lane_flow"] is None
    assert convert.digest_pytrees(tbare) == jrunner.digest_pytrees(bare)


# -- the planes in the window step and the runner's loop ----------------------


def serve_world(name="serve_burst_lossy"):
    """The JAX and port worlds, programs and flow and compute tables of
    one corpus entry."""
    path = str(CORPUS / f"{name}.yaml")
    jsp, tsp = jspec.load_scenario_file(path), tspec.load_scenario_file(path)
    jprog, tprog = jcompile.compile_program(jsp), tcompile.compile_program(tsp)
    jst, params = jrunner.build_scenario_world(jsp)
    tst, tparams = trunner.build_scenario_world(tsp, device="cpu")
    jft = jflows.make_flow_tables(jprog.flow_src, jprog.flow_dst,
                                  jprog.flow_bytes, jprog.lane_flow)
    tft = tflows.make_flow_tables(tprog.flow_src, tprog.flow_dst,
                                  tprog.flow_bytes, tprog.lane_flow,
                                  device="cpu")
    jct = jcompute.make_compute_tables(jprog.compute_service_ns,
                                       jsp.compute.queue_cap)
    tct = tcompute.make_compute_tables(tprog.compute_service_ns,
                                       tsp.compute.queue_cap, device="cpu")
    return (jsp, jprog, jst, params, jft, jct), (tprog, tst, tparams, tft,
                                                 tct)


def test_window_step_with_flows_and_compute_matches_jax():
    """`window_step(kernel="xla", flows=, compute=)`: the flow plane's
    whole step and the compute plane inside the step, 10 windows of the
    serving entry's world primed onto its flows, every output compared
    after each window; the Pallas kernels refuse both planes."""
    (jsp, jprog, jst, params, jft, jct), (tprog, tst, tparams, tft, tct) = \
        serve_world()
    n, f = jsp.n_hosts, jprog.flow_src.shape[0]
    jfs, tfs = jflows.make_flow_state(f), tflows.make_flow_state(
        f, device="cpu")
    ids = np.asarray(jprog.lane_flow).reshape(n, -1)  # every send lane
    valid = ids >= 0
    jfs = jflows.enqueue(jft, jfs, jnp.asarray(ids), jnp.asarray(valid))
    tfs = tflows.enqueue(tft, tfs, torch.from_numpy(ids),
                         torch.from_numpy(valid))
    jcs, tcs = jcompute.make_compute_state(jct), tcompute.make_compute_state(
        tct)
    jm, tm = make_metrics(n), tmetrics.make_metrics(n, device="cpu")
    key = jax.random.key(jsp.seed)

    @jax.jit
    def jround(st, m, fs, cs, sh):
        out = jplane.window_step(st, params, key, sh, jnp.int32(WINDOW),
                                 rr_enabled=False, metrics=m,
                                 flows=(jft, fs), compute=(jct, cs))
        return jplane.unpack_planes(out, metrics=m, flows=fs, compute=cs)

    for r in range(10):
        sh = 0 if r == 0 else WINDOW
        (jst, jd, jn), jm, _g, _h, _fr, jfs, jcs = jround(
            jst, jm, jfs, jcs, jnp.int32(sh))
        out = tplane.window_step(tst, tparams, jsp.seed, sh, WINDOW,
                                 rr_enabled=False, kernel="xla", metrics=tm,
                                 flows=(tft, tfs), compute=(tct, tcs))
        (tst, td, tn), tm, _g, _h, _fr, tfs, tcs = tplane.unpack_planes(
            out, metrics=tm, flows=tfs, compute=tcs)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), r)
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (r, k)
        assert int(jn) == int(tn)
        assert_tuples_equal(jm, tm, r)
        assert_tuples_equal(jfs, tfs, r)
        assert_tuples_equal(jcs, tcs, r)
    assert int(tfs.snd_una.sum()) > 0 and int(tcs.n_served.sum()) > 0
    for kernel in ("pallas_fused", "pallas"):
        for planes in ({"flows": (tft, tfs)}, {"compute": (tct, tcs)}):
            with pytest.raises(ValueError, match="presence planes"):
                tplane.window_step(tst, tparams, 0, 0, WINDOW,
                                   rr_enabled=False, kernel=kernel, **planes)


def test_runner_flow_loop_matches_jax_step_by_step():
    """12 windows of serve_burst_lossy as the scenario runner drives
    them: the step with the compute plane, `flow_recv`, `gate_credits`,
    `workload_step(flows=)`, `flow_emit`, `phase_service`, every output
    compared after each window. Before window 6 the port's flow and
    compute state are rebuilt from the JAX run's arrays through
    `convert`, and the run continues from them."""
    (jsp, jprog, jst, params, jft, jct), (tprog, tst, tparams, tft, tct) = \
        serve_world()
    n = jsp.n_hosts
    wl, ws = jdevice.to_device(jprog), jdevice.make_workload_state(jprog)
    twl = tdevice.to_device(tprog, "cpu")
    tws = tdevice.make_workload_state(tprog, "cpu")
    jfs = jflows.make_flow_state(jprog.flow_src.shape[0])
    tfs = tflows.make_flow_state(tprog.flow_src.shape[0], device="cpu")
    jcs, tcs = jcompute.make_compute_state(jct), tcompute.make_compute_state(
        tct)
    jm, tm = make_metrics(n), tmetrics.make_metrics(n, device="cpu")
    jh, th = make_histograms(n), thisto.make_histograms(n, device="cpu")
    jst, ws, jfs, jm = jdevice.prime(wl, ws, jst, metrics=jm,
                                     flows=(jft, jfs))
    jst, jfs, jm = jflows.flow_emit(jft, jfs, jst, metrics=jm)
    tst, tws, tfs, tm = tdevice.prime(twl, tws, tst, metrics=tm,
                                      flows=(tft, tfs))
    tst, tfs, tm = tflows.flow_emit(tft, tfs, tst, metrics=tm)
    assert_tuples_equal(jfs, tfs)
    key, win = jax.random.key(jsp.seed), jnp.int32(WINDOW)

    @jax.jit
    def jround(st, ws, m, h, fs, cs, r):
        out = jplane.window_step(st, params, key, jnp.where(r == 0, 0, win),
                                 win, rr_enabled=False, metrics=m, hist=h,
                                 compute=(jct, cs))
        (st, d, _n), m, _g, h, _f, cs = jplane.unpack_planes(
            out, metrics=m, hist=h, compute=cs)
        fs, credits = jflows.flow_recv(jft, fs, d, win)
        cs, credits = jcompute.gate_credits(cs, credits)
        st, ws, fs, m = jdevice.workload_step(wl, ws, st, d, r, win,
                                              metrics=m,
                                              flows=(jft, fs, credits))
        st, fs, m = jflows.flow_emit(jft, fs, st, metrics=m)
        cs = jcompute.phase_service(jct, cs, ws.phase)
        return st, ws, m, h, fs, cs, credits

    for r in range(12):
        if r == 6:
            tfs = convert.tuple_from_numpy(tflows.FlowState,
                                           jfs._asdict(), "cpu")
            tcs = convert.tuple_from_numpy(tcompute.ComputeState,
                                           jcs._asdict(), "cpu")
        jst, ws, jm, jh, jfs, jcs, jcred = jround(jst, ws, jm, jh, jfs, jcs,
                                                  jnp.int32(r))
        out = tplane.window_step(tst, tparams, jsp.seed, 0 if r == 0
                                 else WINDOW, WINDOW, rr_enabled=False,
                                 kernel="xla", metrics=tm, hist=th,
                                 compute=(tct, tcs))
        (tst, td, _n), tm, _g, th, _f, tcs = tplane.unpack_planes(
            out, metrics=tm, hist=th, compute=tcs)
        tfs, tcred = tflows.flow_recv(tft, tfs, td, WINDOW)
        tcs, tcred = tcompute.gate_credits(tcs, tcred)
        tst, tws, tfs, tm = tdevice.workload_step(
            twl, tws, tst, td, r, WINDOW, metrics=tm,
            flows=(tft, tfs, tcred))
        tst, tfs, tm = tflows.flow_emit(tft, tfs, tst, metrics=tm)
        tcs = tcompute.phase_service(tct, tcs, tws.phase)
        assert convert.state_digest(tst) == convert.state_digest(
            jax_state_to_numpy(jst)), r
        for ref, got in ((ws, tws), (jm, tm), (jh, th), (jfs, tfs),
                         (jcs, tcs)):
            assert_tuples_equal(ref, got, r)
        assert np.array_equal(np.asarray(jcred), tcred.numpy()), r
    assert int(tfs.snd_una.sum()) > 0 and int(tcs.n_served.sum()) > 0
    assert int(tws.phase.sum()) > 0

"""The port's device transport (`shadow_tpu_torch/tpu/transport.py`)
against the JAX package's, bitwise (every comparison below is exact: the
same dtype, shape and bits).

Each device function is held against the JAX closure of a JAX
`DeviceTransport` on the same numpy inputs, through the dispatch
wrappers both classes share (`_k_ingest`, `_k_step`, `_k_chain`,
`_k_batch_verify`), with the guard and histogram planes off and on. The
inputs hold overflowing destinations, pad rows, deliver times at the
edges of int32 (a negative shift wraps some), a live slot at the idle
sentinel, and a 64-window chain. A scripted call sequence with stub
hosts then drives both classes in sync and mirrored mode, an elastic
growth and the strict capacity error included, and compares what each
call leaves behind."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shadow_tpu.core.capacity import CapacityError as JCapacityError  # noqa: E402
from shadow_tpu.tpu import transport as jtr  # noqa: E402
from shadow_tpu_torch.core.capacity import CapacityError  # noqa: E402
from shadow_tpu_torch.tools import transport_replay as replay  # noqa: E402
from shadow_tpu_torch.tpu import transport as ttr  # noqa: E402

I32_MAX = 2**31 - 1
N, CI, M = 37, 16, 5
B = 64
PLANES = [(False, False), (True, False), (False, True), (True, True)]
PLANE_IDS = ["bare", "guards", "hist", "guards+hist"]


def world(seed=0, n=N, m=M):
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000, 900_000, (m, m)).astype(np.int32)
    host_node = rng.integers(0, m, n)
    return lat, host_node


def transports(lat, host_node, *, mode="sync", **kw):
    """(JAX transport, port transport on the CPU) over stub hosts."""
    hj, hp = [], []
    mk = lambda pushes: [replay._Host(i + 1, int(nd), pushes)
                         for i, nd in enumerate(host_node)]
    routing = replay._Routing(lat)
    jt = jtr.DeviceTransport(mk(hj), routing, None, mode=mode, **kw)
    pt = ttr.DeviceTransport(mk(hp), routing, None, mode=mode,
                             device="cpu", **kw)
    return jt, pt, hj, hp


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    """Two (nested) outputs equal leaf for leaf: dtype, shape, bits."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        fields = getattr(a, "_fields", range(len(a)))
        for f, x, y in zip(fields, a, b):
            assert_same(x, y, f"{what}.{f}")
        return
    x, y = np_of(a), np_of(b)
    if y.dtype == np.int64 and x.dtype == np.uint32:
        y = y.astype(np.uint32)  # the port holds u32 values as int64
    assert x.dtype == y.dtype and x.shape == y.shape, (what, x.dtype,
                                                       y.dtype, x.shape)
    assert np.array_equal(x, y), what


def random_state(seed, n=N, ci=CI, *, conserved=True):
    """A TransportState as numpy arrays: half the slots live, deliver
    times spread over a few ms with some at the edges of int32, idle
    slots at the sentinel or stale, and one live slot at the sentinel
    when `conserved` is False (which also breaks the conservation law)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, ci)) < 0.5
    valid[1] = True  # a full destination: every row there overflows
    valid[2] = False
    deliver = rng.integers(-50_000, 3_000_000, (n, ci))
    edge = rng.random((n, ci)) < 0.05
    deliver[edge] = rng.choice([I32_MAX - 3, I32_MAX - 1, -2**31,
                                -2**31 + 7], edge.sum())
    deliver[~valid & (rng.random((n, ci)) < 0.5)] = I32_MAX
    i32 = lambda a: np.asarray(a, np.int32)
    occ = int(valid.sum())
    n_rel = rng.integers(0, 50, n)
    n_ovf = rng.integers(0, 3, n)
    n_out = np.zeros(n, np.int64)
    n_out[0] = occ + n_rel.sum() + n_ovf.sum()
    if not conserved:
        n_out[0] += 1
        deliver[3, np.nonzero(valid[3])[0][:1]] = I32_MAX
    return dict(in_src=i32(rng.integers(0, n, (n, ci))),
                in_seq=i32(rng.integers(0, 2**31 - 1, (n, ci))),
                in_tag=i32(rng.integers(0, 2**31 - 1, (n, ci))),
                in_deliver=i32(deliver), in_valid=valid,
                n_overflow=i32(n_ovf), n_out=i32(n_out),
                n_released=i32(n_rel))


def batch(seed, n=N, b=B, real=45):
    """One ingest batch of `b` rows, `real` of them live: a hot
    destination (row 0) past its free slots, rows for the full row 1,
    valid rows with an out-of-range destination, and pads with an
    out-of-range source; send and clamp times relative to the base, a
    few near the top of int32 so send + latency wraps."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, b)
    dst = rng.integers(0, n, b)
    h = b // 5
    dst[:h] = 0
    dst[h:h + 3] = 1
    dst[h + 3:h + 5] = n + rng.integers(0, 3, 2)
    send = rng.integers(-20_000, 1_000_000, b)
    send[h + 5:h + 7] = I32_MAX - 500
    clamp = send + rng.integers(-300_000, 300_000, b)
    seq = rng.integers(0, 2**31 - 1, b)
    tag = rng.integers(0, 2**31 - 1, b)
    valid = np.arange(b) < real
    src[~valid] = n
    i32 = lambda a: np.asarray(a, np.int32)
    return [i32(src), i32(dst), i32(seq), i32(tag), i32(send), i32(clamp),
            valid]


def random_guard(seed):
    rng = np.random.default_rng(seed)
    return dict(violations=np.int32(0), first_window=np.int32(I32_MAX),
                windows=np.int32(rng.integers(0, 40)))


def random_hist(seed, n=N):
    rng = np.random.default_rng(seed)
    return dict(hist_delivery_ns=rng.integers(0, 9, (n, 32)).astype(np.int32),
                hist_qdepth=rng.integers(0, 9, (n, 32)).astype(np.int32))


def both(arrays: dict, jcls, tcls):
    """The same numpy leaves as a JAX and a port NamedTuple."""
    j = jcls(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t = tcls(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    return j, t


def planes(seed, guards, hist):
    g = both(random_guard(seed), jtr.TransportGuard, ttr.TransportGuard) \
        if guards else (None, None)
    h = both(random_hist(seed), jtr.TransportHist, ttr.TransportHist) \
        if hist else (None, None)
    return g, h


@pytest.fixture(scope="module")
def pair():
    lat, host_node = world()
    jt, pt, _, _ = transports(lat, host_node, ingress_cap=CI,
                              compact_cap=64)
    return jt, pt


@pytest.mark.parametrize("guards,hist", PLANES, ids=PLANE_IDS)
@pytest.mark.parametrize("conserved", [True, False])
def test_ingest_matches_jax(pair, guards, hist, conserved):
    jt, pt = pair
    (jg, tg), (jh, th) = planes(1, guards, hist)
    js, ts = both(random_state(2, conserved=conserved), jtr.TransportState,
                  ttr.TransportState)
    cols = batch(3)
    got_j = jt._k_ingest(js, jg, jh, *(jnp.asarray(c) for c in cols))
    got_t = pt._k_ingest(ts, tg, th, *(torch.from_numpy(c) for c in cols))
    assert_same(got_j, got_t, "ingest")
    # the batch overflowed row 0 and row 1, and a pad source dropped
    st = got_t[0]
    assert int(st.n_overflow[1]) > int(ts.n_overflow[1])


@pytest.mark.parametrize("guards,hist", PLANES, ids=PLANE_IDS)
@pytest.mark.parametrize("shift,window", [(0, 1_000_000),
                                          (700_000, 250_000),
                                          (-10_000_000, 40_000)],
                         ids=["zero", "forward", "negative"])
def test_step_matches_jax(pair, guards, hist, shift, window):
    jt, pt = pair
    (jg, tg), (jh, th) = planes(4, guards, hist)
    js, ts = both(random_state(5), jtr.TransportState, ttr.TransportState)
    got_j = jt._k_step(js, jg, jh, jnp.int32(shift), jnp.int32(window))
    got_t = pt._k_step(ts, tg, th, shift, window)
    assert_same(got_j, got_t, "step_compact")
    assert int(got_t[3][0]) > 0  # something was released


def chain_state(seed, spread):
    """A state whose live slots deliver at distinct times `spread` ns
    apart, so delivery-free windows can be chained."""
    st = random_state(seed)
    rng = np.random.default_rng(seed)
    live = st["in_valid"]
    st["in_deliver"] = np.where(
        live, 2_000_000 + spread * rng.permutation(live.size).reshape(
            live.shape), I32_MAX).astype(np.int32)
    return st


@pytest.mark.parametrize("guards,hist", PLANES, ids=PLANE_IDS)
@pytest.mark.parametrize("case", ["short", "64-windows", "horizon"])
def test_chain_matches_jax(pair, guards, hist, case):
    """A chain that stops at its first delivering window, one that runs
    all 64 windows (a zero runahead opens empty windows at each next
    event), and one cut by the horizon."""
    jt, pt = pair
    (jg, tg), (jh, th) = planes(6, guards, hist)
    js, ts = both(chain_state(7, 10_000), jtr.TransportState,
                  ttr.TransportState)
    shift0, window0, runahead, horizon, stop = {
        "short": (0, 1_000_000, 1_000_000, 10**9, 10**9),
        "64-windows": (0, 1_000_000, 0, 10**9, 10**9),
        "horizon": (0, 1_000_000, 1_000_000, 1_500_000, 10**9),
    }[case]
    args = (shift0, window0, runahead, horizon, stop)
    got_j = jt._k_chain(js, jg, jh, *(jnp.int32(a) for a in args))
    got_t = pt._k_chain(ts, tg, th, *args)
    assert_same(got_j, got_t, "chain")
    if guards:
        # windows run: the quiet first one and the delivering second; all
        # 64; the first only, its next event past the horizon
        ran = int(got_t[1].windows) - int(random_guard(6)["windows"])
        assert ran == {"short": 2, "64-windows": 64, "horizon": 1}[case]


def verify_inputs(pt, seed, k=32, b=16, poison=(3, 11, 17)):
    """`batch_verify` inputs: K windows of a run, each a step then an
    ingest, and the true fingerprints of each window (from the port's own
    step and fingerprint), poisoned at the windows in `poison`."""
    rng = np.random.default_rng(seed)
    shifts = rng.integers(0, 400_000, k).astype(np.int32)
    shifts[5] = 0
    widths = rng.integers(0, 500_000, k).astype(np.int32)
    widths[6] = 0
    ing = {name: [] for name in ("src", "dst", "seq", "tag", "send",
                                 "clamp", "valid")}
    for i in range(k):
        cols = batch(seed * 100 + i, b=b, real=int(rng.integers(0, b)))
        cols[4] = np.abs(cols[4]) % 600_000
        cols[5] = np.abs(cols[5]) % 600_000
        for name, c in zip(ing, cols):
            ing[name].append(c)
    ing = {name: np.stack(v) for name, v in ing.items()}
    st = ttr.TransportState(**{k: torch.from_numpy(np.array(v)) for k, v in
                               chain_state(seed, 3_000).items()})
    fps = np.zeros((3, k), np.int64)
    for i in range(k):
        st, due, deliver, _ = ttr.step(st, int(shifts[i]), int(widths[i]))
        fp1, fp2, cnt = ttr.fingerprint(st, due, deliver)
        fps[:, i] = fp1.item(), fp2.item(), cnt.item()
        st, _ = ttr.ingest(st, None, *(torch.from_numpy(ing[c][i]) for c in
                                       ing), latency=pt._latency,
                           host_node=pt._host_node)
    for i in poison:
        fps[i % 3, i] += 1
    fps[:2] &= 0xFFFFFFFF
    return shifts, widths, ing, fps


@pytest.mark.parametrize("guards,hist", PLANES, ids=PLANE_IDS)
def test_batch_verify_matches_jax(pair, guards, hist):
    jt, pt = pair
    (jg, tg), (jh, th) = planes(8, guards, hist)
    st = chain_state(9, 3_000)
    js, ts = both(st, jtr.TransportState, ttr.TransportState)
    shifts, widths, ing, fps = verify_inputs(pt, 9)
    got_j = jt._k_batch_verify(
        js, jg, jh, jnp.asarray(shifts), jnp.asarray(widths),
        {k: jnp.asarray(v) for k, v in ing.items()},
        jnp.asarray(fps[0].astype(np.uint32)),
        jnp.asarray(fps[1].astype(np.uint32)),
        jnp.asarray(fps[2].astype(np.int32)), jnp.int32(2))
    got_t = pt._k_batch_verify(
        ts, tg, th, shifts, widths,
        {k: torch.from_numpy(v) for k, v in ing.items()},
        torch.from_numpy(fps[0]), torch.from_numpy(fps[1]),
        torch.from_numpy(fps[2].astype(np.int32)),
        torch.tensor(2, dtype=torch.int32))
    assert_same(got_j, got_t, "batch_verify")
    # exactly the poisoned windows diverged: the port's fingerprint is JAX's
    assert int(got_t[3]) == 2 + 3


def test_fingerprint_np_edges_and_device_twin():
    """`_fingerprint_np` equals JAX's on the edges of int32 and uint32,
    and the port's device `fingerprint` equals it."""
    tags = np.array([0, 1, 2, 2**31 - 1, 2**31, 2**32 - 1, 12345, 7, 7],
                    np.int64)
    deliver = np.array([0, -1, -2**31, 2**31 - 1, 1, 0, -12345, 7, 7],
                       np.int64)
    assert ttr._fingerprint_np(tags, deliver) == jtr._fingerprint_np(
        tags, deliver)
    assert ttr._fingerprint_np(tags[:0], deliver[:0]) == (0, 0)
    n = len(tags)
    st = ttr.make_transport_state(1, n, "cpu")._replace(
        in_tag=torch.from_numpy(tags.astype(np.uint32).view(np.int32)))
    d = torch.from_numpy(deliver.astype(np.int32)[None])
    due = torch.ones((1, n), dtype=torch.bool)
    due[0, 1] = False
    fp1, fp2, cnt = ttr.fingerprint(st, due, d)
    keep = np.arange(n) != 1
    assert (fp1.item(), fp2.item()) == jtr._fingerprint_np(tags[keep],
                                                          deliver[keep])
    assert cnt.item() == n - 1


# -- the classes through one scripted call sequence ---------------------------


def script(seed, lat, host_node, *, rounds=40, per_round=10, hot=0.0,
           lat_change_at=None):
    """A Manager-like call sequence: each round a release, captures at
    times inside the window (deliver = max(now + path latency, round
    end)), a finish; windows of 1 ms with idle gaps, a latency change
    (and the captures after it use the degraded table), then finalize."""
    rng = np.random.default_rng(seed)
    n = len(host_node)
    W = 1_000_000
    t, stop = 5 * W, 5 * W + rounds * 3 * W
    seqs = np.zeros(n, np.int64)
    mult = np.ones_like(lat)
    ops = []
    for r in range(rounds):
        if r == lat_change_at:
            mult = np.where(rng.random(lat.shape) < 0.5, 3, 1).astype(
                np.int32)
            ops.append(("latency", mult))
        start, end = t, t + W
        ops.append(("release", start, end,
                    start + int(rng.integers(0, 4 * W)), W, stop))
        for _ in range(int(rng.integers(0, per_round + 1))):
            s = int(rng.integers(0, n))
            d = 0 if rng.random() < hot else int(rng.integers(0, n))
            now = start + int(rng.integers(0, W))
            lat_sd = int(lat[host_node[s], host_node[d]]) * int(
                mult[host_node[s], host_node[d]])
            ops.append(("capture", s, d, now, int(seqs[s]), end,
                        max(now + lat_sd, end)))
            seqs[s] += 1
        ops.append(("finish", start, end))
        t = end + W * int(rng.integers(0, 3))
    ops.append(("finalize",))
    return ops


def observe(t, pushes) -> dict:
    """What a call leaves behind, as plain data."""
    obs = {"pushes": list(pushes), "next": t.next_pending_abs,
           "in_flight": t.in_flight, "div": t.divergence_count,
           "verified": (t.verified_windows, t.verified_packets),
           "telemetry": {k: np_of(v).tolist()
                         for k, v in t.telemetry_arrays().items()},
           "hist": {k: np_of(v).tolist()
                    for k, v in t.histogram_arrays().items()},
           "guard": t.guard_report(),
           "ledger": {k: v.tolist() for k, v in t.cpu_ledger().items()},
           "capacity": t.drain_capacity_events(),
           "summary": t.capacity_summary()}
    pushes.clear()
    return obs


def drive(t, hosts_pushes, ops, *, guards, hist):
    """Run `ops` through `t`; the observations after each op, and the
    exception type and op index if one raised."""
    if guards:
        t.enable_guards()
    if hist:
        t.enable_histograms()
    out = []
    hosts = t.hosts
    for i, op in enumerate(ops):
        try:
            if op[0] == "release":
                t.release(*op[1:])
            elif op[0] == "capture":
                _, s, d, now, seq, end, deliver = op
                p = replay._Packet()
                t.capture(hosts[s], hosts[d], p, now, seq, end, deliver)
                p.tag = t._pending[-1][3]
                continue
            elif op[0] == "finish":
                t.finish_round(*op[1:])
            elif op[0] == "latency":
                t.apply_fault_latency(op[1])
            else:
                t.finalize()
        except (CapacityError, JCapacityError) as e:
            out.append(("raised", i, e.ring, e.blame))
            return out
        out.append(observe(t, hosts_pushes))
    return out


@pytest.mark.parametrize("mode", ["sync", "mirrored"])
@pytest.mark.parametrize("case", ["fixed", "elastic", "strict",
                                  "guards+hist"])
def test_scripted_calls_match_jax(mode, case):
    lat, host_node = world(11, n=23, m=4)
    kw = {"ingress_cap": 16, "compact_cap": 256}
    hot, per_round = 0.0, 10
    if case == "elastic":
        kw.update(ingress_cap=2, capacity_mode="elastic", max_doublings=8)
        hot, per_round = 0.6, 14
    elif case == "strict":
        kw.update(ingress_cap=2, capacity_mode="strict")
        hot, per_round = 0.6, 14
    on = case == "guards+hist"
    ops = script(12, lat, host_node, hot=hot, per_round=per_round,
                 lat_change_at=25)
    jt, pt, hj, hp = transports(lat, host_node, mode=mode, **kw)
    got_j = drive(jt, hj, ops, guards=on, hist=on)
    got_t = drive(pt, hp, ops, guards=on, hist=on)
    assert len(got_j) == len(got_t)
    for k, (a, b) in enumerate(zip(got_j, got_t)):
        assert a == b, f"observation {k} differs"
    last = got_t[-1]
    if case == "strict":
        assert last[0] == "raised" and last[2] == "transport-ingress"
        return
    assert last["div"] == 0
    if case == "elastic":
        assert last["summary"]["ingress_cap"] > 2
        assert any(e["kind"] == "capacity-growth"
                   for o in got_t for e in o["capacity"])
    if mode == "sync":
        assert sum(len(o["pushes"]) for o in got_t) > 100
    else:
        assert last["verified"][1] > 100 and last["in_flight"] == 0


def test_device_transport_refuses_without_a_card_and_retries_in_place(
        monkeypatch):
    """No card and no device: the transport raises, it does not fall
    back. A transient error in a dispatch is retried on the same inputs
    and the result equals an undisturbed dispatch."""
    lat, host_node = world(13, n=4, m=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.DeviceTransport([replay._Host(i + 1, int(nd), [])
                                 for i, nd in enumerate(host_node)],
                                replay._Routing(lat), None, mode="sync")
    _, pt, _, _ = transports(lat, host_node, ingress_cap=8)
    from shadow_tpu_torch.faults import healing

    monkeypatch.setattr(healing._walltime, "sleep", lambda s: None)
    pt.retry_attempts = 2
    st = ttr.TransportState(**{k: torch.from_numpy(np.array(v)) for k, v in
                               random_state(14, n=4, ci=8).items()})
    want = pt._k_step(st, None, None, 0, 1_000_000)
    real, calls = ttr.step_compact, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE: link reset")
        return real(*a, **k)

    monkeypatch.setattr(ttr, "step_compact", flaky)
    got = pt._k_step(st, None, None, 0, 1_000_000)
    assert len(calls) == 2
    assert_same(want, got, "retried step")


def test_capture_from_many_threads_loses_nothing():
    """Worker threads capture at once (more threads than cores, a short
    switch interval): every capture gets its own pool tag, one pending
    row and one ledger count, so nothing a lost update would drop."""
    import sys
    import threading

    lat, host_node = world(15, n=8, m=2)
    for mode in ("sync", "mirrored"):
        _, pt, _, _ = transports(lat, host_node, mode=mode)
        hosts = pt.hosts
        n_threads, per = 24, 400
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)

        def worker(k):
            for i in range(per):
                pt.capture(hosts[k % 8], hosts[(k + i) % 8], object(),
                           1000 + i, i, 5000, 9000 + i)

        try:
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        total = n_threads * per
        tags = [row[3] for row in pt._pending]
        assert len(tags) == total and len(set(tags)) == total
        assert pt.in_flight == total == len(pt._pool)
        assert int(pt.cpu_ledger()["captured"].sum()) == total
        if mode == "mirrored":
            assert len(pt._expect_heap) == total


def test_telemetry_with_a_tcp_source_matches_jax():
    """`attach_tcp_source`: each harvest folds the per-connection
    retransmit counters into the per-host `retransmits` field, a
    connection with an out-of-range host dropped, as JAX's does."""
    from shadow_tpu.tpu import tcp as jtcp
    from shadow_tpu_torch.tpu import tcp as ttcp

    lat, host_node = world(16, n=6, m=2)
    jt, pt, _, _ = transports(lat, host_node)
    rng = np.random.default_rng(16)
    counts = rng.integers(0, 50, 12).astype(np.int32)
    conn_host = np.array([0, 1, 1, 5, -1, 6, 2, 2, 3, 0, 4, 9], np.int32)
    jplane = jtcp.make_tcp_plane(12)._replace(
        retransmit_count=jnp.asarray(counts))
    tplane = ttcp.make_tcp_plane(12, device="cpu")._replace(
        retransmit_count=torch.from_numpy(counts))
    jt.attach_tcp_source(lambda: jplane, conn_host)
    pt.attach_tcp_source(lambda: tplane, conn_host)
    got_j, got_t = jt.telemetry_arrays(), pt.telemetry_arrays()
    assert got_j.keys() == got_t.keys()
    for k in got_j:
        assert_same(got_j[k], got_t[k], k)
    assert int(got_t["retransmits"].sum()) == int(
        counts[(conn_host >= 0) & (conn_host < 6)].sum())

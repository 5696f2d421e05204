"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
feed the JAX plane and the port the same numpy data and compare outputs
exactly."""

from __future__ import annotations

import numpy as np


def jax_state_to_numpy(st) -> dict:
    """A JAX `NetPlaneState` as the numpy dict `shadow_tpu_torch.convert`
    reads (router as a nested dict)."""
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "router"}
    d["router"] = {k: np.asarray(v) for k, v in st.router._asdict().items()}
    return d


def jax_params_to_numpy(params) -> dict:
    return {k: np.asarray(v) for k, v in params._asdict().items()}


def placement_inputs(n, ce, ci, seed, *, hot=1 / 8, n_src=None):
    """Kernel B's and D's arguments as numpy arrays, in `pipeline.place`'s
    order: bucket segments that tile the n_src*ce arrival slots, rows
    whose arrivals overflow the ring, a random arrival order `o_pos` and
    row orders `row_perm`, random payload and ingress columns (invalid
    slots with and without deliver = I32_MAX). Row 0's segment starts
    before the first arrival and row n-1's runs past the last, so both
    read arrivals j outside [0, n_src*ce). The source columns have
    `n_src` rows (n when None), the rings n."""
    m = n if n_src is None else n_src
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    nv = rng.integers(0, ci + 1, n)
    counts = rng.poisson(ce * 0.8, n)
    hot_rows = rng.random(n) < hot
    counts[hot_rows] += rng.integers(ci, 2 * ci, hot_rows.sum())
    counts = np.minimum(counts, np.maximum(
        0, m * ce - (np.cumsum(counts) - counts)))  # fit the m*ce slots
    offsets = np.cumsum(counts) - counts
    take = np.minimum(counts, ci - nv)
    nv[0], take[0], offsets[0] = 0, ci, -(ci // 2)
    nv[-1], take[-1], offsets[-1] = 1, ci - 1, m * ce - ci // 2
    words = lambda *shape: i32(rng.integers(-2**31, 2**31, shape))
    deliver = words(n, ci)
    deliver[rng.random((n, ci)) < 0.25] = 2**31 - 1
    return (i32(nv), i32(offsets), i32(take),
            rng.permutation(m * ce).astype(np.int64),
            i32(np.argsort(rng.random((m, ce)), axis=1)),
            words(m, ce), words(m, ce), words(m, ce), words(m, ce),
            words(n, ci), words(n, ci), words(n, ci), words(n, ci), deliver,
            rng.random((n, ci)) < 0.5)


I32_MIN, I32_MAX = -(2**31), 2**31 - 1
MS = 1_000_000
NO_CLAMP = -(2**30)
EDGE_SHIFTS = (10_000_000, -10_000_000)


def gate_edge_columns(n, ce, seed):
    """Kernel C's arguments (valid, prio, nbytes, tsend, clamp, balance)
    as numpy arrays, at the edges of int32. Rows cycle through six kinds:
    mixed, all invalid, all valid, all-equal priority (a pure column
    tiebreak), all valid with non-negative priorities and bytes in
    [2^30, 2^31) (the prefix sum passes 2^31 and wraps), and arbitrary
    int32 bytes. Priorities are mostly extremes
    (INT32_MIN, -1, INT32_MAX and their neighbours: a negative one sets
    the key's validity bit); tsend and clamp sit near -2^31 and 2^31 - 1,
    so either sign of `EDGE_SHIFTS` wraps some of them, with NO_CLAMP
    and clamps that land on NO_CLAMP after the shift; balances include
    negative ones and both extremes."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    kind = np.arange(n) % 6
    valid = rng.random((n, ce)) < 0.6
    valid[kind == 1] = False
    valid[(kind == 2) | (kind == 4)] = True
    extremes = np.array([I32_MIN, I32_MIN + 1, -2, -1, 0, 1, 2, 7,
                         I32_MAX - 1, I32_MAX])
    prio = rng.choice(extremes, (n, ce))
    prio[kind == 3] = rng.choice(extremes, (int((kind == 3).sum()), 1))
    prio[kind == 4] = np.abs(prio[kind == 4] + 1) % 2**31
    nbytes = rng.integers(0, 1500, (n, ce))
    nbytes[kind == 4] = rng.integers(2**30, 2**31, (int((kind == 4).sum()),
                                                    ce))
    nbytes[kind == 5] = rng.integers(I32_MIN, 2**31,
                                     (int((kind == 5).sum()), ce))
    near = lambda: np.where(rng.random((n, ce)) < 0.5,
                            rng.integers(I32_MIN, I32_MIN + 3 * 10**7, (n, ce)),
                            rng.integers(I32_MAX - 3 * 10**7, 2**31, (n, ce)))
    tsend = near()
    pick = rng.random((n, ce))
    clamp = np.where(pick < 0.3, NO_CLAMP, near())
    for k, s in enumerate(EDGE_SHIFTS):
        clamp[(pick >= 0.3 + 0.05 * k) & (pick < 0.35 + 0.05 * k)] = \
            NO_CLAMP + s
    balance = rng.integers(I32_MIN, 2**31, n)
    balance[::4] = rng.integers(-3000, 0, len(balance[::4]))
    balance[1::4] = rng.integers(0, ce * 1500, len(balance[1::4]))
    balance[2::8] = I32_MAX
    balance[3::8] = I32_MIN
    return dict(valid=valid, prio=i32(prio), nbytes=i32(nbytes),
                tsend=i32(tsend), clamp=i32(clamp), balance=i32(balance))


def all_halted(halted) -> bool:
    """Kernel E's plain loop's stop once every host has halted
    (`codel._router_drain_loop(until=)`): one read of the device a
    micro-step."""
    return bool(halted.all())


def drain_inputs(n, k, seed, *, window_ns=10 * MS):
    """Kernel E's arguments as numpy (arrival, size, dn_rate, dn_cap, the
    router state as a dict): ascending arrivals (some before the window
    start, some after its end, I32_MAX padding), 1-1500 B sizes, rates
    from 1 B/ms to 2^20, a mid-run state with caches whose resumes fall
    inside and beyond the window, both CoDel modes."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    n_real = rng.integers(0, k + 1, n)
    arrival = np.sort(rng.integers(-3 * MS, window_ns + 3 * MS, (n, k)),
                      axis=1)
    arrival[np.arange(k)[None, :] >= n_real[:, None]] = I32_MAX
    size = rng.integers(1, 1501, (n, k))
    size[arrival == I32_MAX] = rng.integers(0, 1501, int(
        (arrival == I32_MAX).sum()))
    rate = np.where(rng.random(n) < 0.2, rng.integers(1, 8, n),
                    rng.integers(100, 1 << 20, n))
    cap = rate + 1500
    has_c = rng.random(n) < 0.4
    state = dict(
        mode=i32(rng.integers(0, 2, n)),
        has_interval_end=rng.random(n) < 0.5,
        interval_end=i32(rng.integers(-150 * MS, 150 * MS, n)),
        has_drop_next=rng.random(n) < 0.5,
        drop_next=i32(rng.integers(-150 * MS, 150 * MS, n)),
        cur_count=i32(rng.integers(0, 8, n)),
        prev_count=i32(rng.integers(0, 8, n)),
        dn_balance=i32(rng.integers(-2000, cap + 1)),
        dn_last_refill=i32(rng.integers(-MS + 1, 1, n)),
        has_cached=has_c,
        cached_src=i32(rng.integers(0, n, n)),
        cached_seq=i32(rng.integers(0, 1000, n)),
        cached_sock=i32(rng.integers(0, 40, n)),
        cached_bytes=i32(np.where(has_c, rng.integers(1, 1501, n), 0)),
        resume=i32(rng.integers(-MS, window_ns + 5 * MS, n)),
        dropped=i32(rng.integers(0, 50, n)))
    return i32(arrival), i32(size), i32(rate), i32(cap), state


def long_chain_drain_inputs(n, k, seed, *, every=32):
    """`drain_inputs` over a window of 2**30 ns where host 0 of every
    `every` holds K full packets that arrive 1 µs apart behind a bucket
    of 100 B/ms (each packet is cached, waits ~15 ms and resumes, so the
    host runs more than K micro-steps) and host 1 of every `every` holds
    no packet and no cache (it halts on its first micro-step)."""
    arrival, size, rate, cap, state = drain_inputs(n, k, seed,
                                                   window_ns=2**30)
    long, idle = np.arange(0, n, every), np.arange(1, n, every)
    arrival[long] = np.arange(k, dtype=np.int32) * 1000
    size[long] = 1500
    rate[long], cap[long] = 100, 1600
    arrival[idle] = I32_MAX
    for f, v in (("mode", 0), ("has_interval_end", False),
                 ("has_drop_next", False), ("has_cached", False),
                 ("cached_bytes", 0), ("dn_balance", 0),
                 ("dn_last_refill", 0)):
        state[f][np.concatenate([long, idle])] = v
    return arrival, size, rate, cap, state


def wide_drain_inputs(n, k, seed, *, queued=300):
    """`long_chain_drain_inputs` of `queued` entries a row, each row
    padded with I32_MAX out to K entries: a router with deep buffers
    holding a few hundred packets, hosts with long chains among them."""
    arrival, size, rate, cap, state = long_chain_drain_inputs(
        n, min(k, queued), seed)
    wide = np.full((n, k), I32_MAX, np.int32)
    wide_size = np.full((n, k), 1500, np.int32)
    wide[:, :arrival.shape[1]] = arrival
    wide_size[:, :arrival.shape[1]] = size
    return wide, wide_size, rate, cap, state


def assert_states_equal(a: dict, b: dict, ctx=None):
    """Every leaf bitwise equal, dtype and shape included."""
    assert a.keys() == b.keys(), ctx
    for k in a:
        if k == "router":
            assert_states_equal(a[k], b[k], (ctx, "router"))
            continue
        assert a[k].dtype == b[k].dtype, (ctx, k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), (ctx, k)



def rr_world(n, ce, ci, *, rr_mix=True, loss=0.3, seed=7):
    """The sort-diet test's busy world at any size: starved token buckets
    (leftover egress every window), real loss, a round-robin/FIFO qdisc
    mix, duplicate priorities and socket ids past the RR slot space.
    Returns ((jax params, jax state), (port params, port state)) after
    the same flat ingest on both sides."""
    import jax.numpy as jnp
    import torch

    from shadow_tpu.tpu import ingest, make_params, make_state
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.tpu import plane as tplane

    rng = np.random.default_rng(seed)
    lat = rng.integers(1 * MS, 20 * MS, size=(n, n)).astype(np.int32)
    qrr = (np.arange(n) % 2 == 0) if rr_mix else np.zeros(n, bool)
    params = make_params(lat, np.full((n, n), loss, np.float32),
                         np.full((n,), 2_400_000, np.int64),
                         qdisc_rr=qrr, down_bw_bps=np.full((n,), 400_000))
    state = make_state(n, egress_cap=ce, ingress_cap=ci, params=params,
                       initial_tokens=np.asarray(params.tb_cap))
    b = 6 * n
    batch = dict(
        src=rng.integers(0, n, b).astype(np.int32),
        dst=rng.integers(0, n, b).astype(np.int32),
        nbytes=rng.integers(100, 1500, b).astype(np.int32),
        prio=rng.integers(0, 6, b).astype(np.int32),
        seq=np.arange(b, dtype=np.int32),
        ctrl=rng.integers(0, 3, b) == 0,
        sock=rng.integers(0, 40, b).astype(np.int32),
    )
    tst = convert.state_from_numpy(jax_state_to_numpy(state), "cpu")
    jst = ingest(state, **{k: jnp.asarray(v) for k, v in batch.items()})
    tst = tplane.ingest(tst, **{k: torch.from_numpy(v)
                                for k, v in batch.items()})
    tparams = convert.params_from_numpy(jax_params_to_numpy(params), "cpu")
    return (params, jst), (tparams, tst)


def assert_tuples_equal(ref, got, ctx=None):
    """A JAX NamedTuple of arrays against the port's of tensors: same
    fields, every leaf's dtype, shape and values."""
    assert ref._fields == got._fields, ctx
    for f in ref._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, (ctx, f)
        assert np.array_equal(r, g), (ctx, f)


def phold_both(world, windows, *, kernel="xla", jax_kernel="xla",
               rr_enabled=False, no_loss=False, metrics=False, hist=False,
               router_aqm=False, seed=3, packed_sort=True):
    """`windows` PHOLD windows (window_step + respawn + ingest_rows) of
    the JAX plane and the port on one world, with the metrics and
    histogram planes threaded through both calls when asked (as the JAX
    bench threads them), compared leaf by leaf after every window: the
    state, every delivered column, the next-event scalar and each plane.
    The respawn batch is as wide as the delivered dict (CI + 1 columns
    under `router_aqm`); `packed_sort` goes to both sides' step and
    append. Returns the final (port state, metrics, hist)."""
    import jax
    import jax.numpy as jnp
    import torch

    from shadow_tpu.telemetry import make_histograms, make_metrics
    from shadow_tpu.tpu.plane import ingest_rows, unpack_planes, window_step
    from shadow_tpu.workloads.phold import respawn_batch
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.telemetry import histo as thisto
    from shadow_tpu_torch.telemetry import metrics as tmetrics
    from shadow_tpu_torch.tpu import plane as tplane
    from shadow_tpu_torch.workloads.phold import respawn_batch as trespawn

    (params, jst), (tparams, tst) = world
    n = jst.in_src.shape[0]
    key = jax.random.key(seed)
    jm = make_metrics(n) if metrics else None
    jh = make_histograms(n) if hist else None
    tm = tmetrics.make_metrics(n, device="cpu") if metrics else None
    th = thisto.make_histograms(n, device="cpu") if hist else None

    @jax.jit
    def jround(st, sh, spawn, r, m, h):
        out = window_step(st, params, key, sh, jnp.int32(10 * MS),
                          rr_enabled=rr_enabled, no_loss=no_loss,
                          router_aqm=router_aqm, kernel=jax_kernel,
                          packed_sort=packed_sort, metrics=m, hist=h)
        (st, d, nx), m, _g, h, _f = unpack_planes(out, metrics=m, hist=h)
        mask, dst, nb, seq, ctrl = respawn_batch(d, spawn, r, n,
                                                 d["mask"].shape[1])
        out = ingest_rows(st, dst, nb, seq, seq, ctrl, valid=mask,
                          packed_sort=packed_sort, metrics=m, hist=h)
        (st,), m, _g, h, _f = unpack_planes(out, metrics=m, hist=h,
                                            n_lead=1)
        return st, d, nx, spawn + mask.sum(axis=1, dtype=jnp.int32), m, h

    spawn = jnp.full((n,), 10_000, jnp.int32)
    tspawn = torch.full((n,), 10_000, dtype=torch.int32)
    for r in range(windows):
        shift = 0 if r == 0 else 10 * MS
        jst, jd, jn, spawn, jm, jh = jround(jst, jnp.int32(shift), spawn,
                                            jnp.int32(r), jm, jh)
        out = tplane.window_step(tst, tparams, seed, shift, 10 * MS,
                                 rr_enabled=rr_enabled, no_loss=no_loss,
                                 router_aqm=router_aqm, kernel=kernel,
                                 packed_sort=packed_sort, metrics=tm,
                                 hist=th)
        (tst, td, tn), tm, _g, th, _f = tplane.unpack_planes(
            out, metrics=tm, hist=th)
        mask, dst, nb, seq, ctrl = trespawn(td, tspawn, r, n,
                                            td["mask"].shape[1])
        out = tplane.ingest_rows(tst, dst, nb, seq, seq, ctrl, mask,
                                 packed_sort=packed_sort, metrics=tm,
                                 hist=th)
        (tst,), tm, _g, th, _f = tplane.unpack_planes(
            out, metrics=tm, hist=th, n_lead=1)
        tspawn = tspawn + mask.sum(dim=1, dtype=torch.int32)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), r)
        assert jd.keys() == td.keys()
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (r, k)
        assert int(jn) == int(tn), r
        if metrics:
            assert_tuples_equal(jm, tm, r)
        if hist:
            assert_tuples_equal(jh, th, r)
    return tst, tm, th


def egress_inputs(n, ce, seed):
    """Kernels A's and C's egress columns (valid, prio, nbytes, tsend,
    clamp, dst, seq, sock, ctrl [n, ce]) and balance [n], as numpy:
    duplicate priorities and seqs, NO_CLAMP and real clamps."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    return (rng.random((n, ce)) < 0.7, i32(rng.integers(0, 4, (n, ce))),
            i32(rng.integers(60, 1500, (n, ce))),
            i32(rng.integers(-20 * MS, 10 * MS, (n, ce))),
            i32(np.where(rng.random((n, ce)) < 0.5, NO_CLAMP,
                         rng.integers(-5 * MS, 20 * MS, (n, ce)))),
            i32(rng.integers(-1, n, (n, ce))),
            i32(rng.integers(0, 4 * ce, (n, ce))),
            i32(rng.integers(0, 64, (n, ce))),
            rng.random((n, ce)) < 0.2,
            i32(rng.integers(0, ce * 1500, n)))


BATCHED_KERNELS = ("egress_rank", "egress_gate", "route_place",
                   "route_scatter", "router_drain")


def batched_kernel_case(name, n, seeds, device, *, ce=8, ci=16, k=16):
    """Kernel `name` (one of BATCHED_KERNELS) over len(seeds) distinct
    worlds, one seed a world: (wrapper, plain version, arguments with a
    leading world axis, vmap in_dims, mutated argument indices). The
    wrapper and the plain version take the same arguments, so
    `torch.func.vmap` of each over the worlds compares the batched
    launch (one op call, the worlds folded into rows) with the plain
    version world by world. Placement arguments are written in place:
    clone them for each call."""
    import torch

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.tpu import codel, pipeline

    stack = lambda per_world: [torch.from_numpy(np.stack(a)).to(device)
                               for a in zip(*per_world)]
    shift = 10 * MS
    if name in ("egress_rank", "egress_gate"):
        worlds = [egress_inputs(n, ce, s) for s in seeds]
        if name == "egress_gate":
            worlds = [w[:5] + w[9:] for w in worlds]
            fns = (pipeline.egress_order_gate, pipeline.egress_gate_plain)
        else:
            fns = (pipeline.egress_rank_stage, pipeline.egress_rank_plain)
        args = (*stack(worlds), shift)
        return (*fns, args, (0,) * (len(args) - 1) + (None,), ())
    if name in ("route_place", "route_scatter"):
        args = stack([placement_inputs(n, ce, ci, s) for s in seeds])
        wrapper = pipeline.place if name == "route_place" else \
            pipeline.scatter
        return (wrapper, pipeline.place_plain, tuple(args),
                (0,) * len(args), tuple(range(9, 15)))
    if name != "router_drain":
        raise ValueError(f"unknown kernel {name!r}")
    worlds = [drain_inputs(n, k, s) for s in seeds]
    arrival, size, rate, cap = stack([w[:4] for w in worlds])
    states = [convert.router_from_numpy(w[4], device) for w in worlds]
    state = codel.RouterDownState(*(torch.stack(f) for f in zip(*states)))
    kernel = lambda a, s, r, c, st: codel.router_drain(a, s, shift, r, c, st)
    plain = lambda a, s, r, c, st: codel.router_drain_plain(a, s, shift, r,
                                                            c, st)
    return (kernel, plain, (arrival, size, rate, cap, state), (0,) * 5, ())


def flat_outputs(out):
    """A kernel's outputs as a flat tuple of tensors (kernel E's router
    state spread into its fields)."""
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat.extend(o if isinstance(o, tuple) else (o,))
    return tuple(flat)

"""The port's flight recorder against the JAX package's, bitwise: the
sampling mask over wide (src, seq) values, the ring append with more
candidates than slots and with a cursor that wraps past 2**31, ring
growth, the host drain's hops and counts, and `flightrec=` on
`window_step` (with faults and guards) and `ingest_rows`."""

from __future__ import annotations

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, jax_state_to_numpy,  # noqa: E402
                          rr_world)

from shadow_tpu.faults import plane as jfplane  # noqa: E402
from shadow_tpu.guards import plane as jgplane  # noqa: E402
from shadow_tpu.telemetry import flightrec as jfr  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.faults import plane as tfplane  # noqa: E402
from shadow_tpu_torch.guards import plane as tgplane  # noqa: E402
from shadow_tpu_torch.telemetry import flightrec as tfr  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

MS = 1_000_000
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def both(seed=3, *, sample_every=64, ring=4096, cursor=None):
    """The JAX recorder and the port's twin converted from it."""
    jf = jfr.make_flightrec(seed, sample_every=sample_every, ring=ring)
    if cursor is not None:
        jf = jf._replace(cursor=jnp.int32(cursor))
    return jf, to_port(jf)


def to_port(jf):
    return convert.flightrec_from_numpy(
        {k: np.asarray(v) for k, v in jf._asdict().items()}, "cpu")


def assert_rings_equal(jf, tf, ctx=None):
    got = convert.flightrec_to_numpy(tf)
    for k, v in jf._asdict().items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, (ctx, k)
        assert np.array_equal(got[k], v), (ctx, k)


@pytest.mark.parametrize("sample_every", [1, 3, 64, 1_000_003, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 11, -5])
def test_sample_mask_matches_jax(sample_every, seed):
    rng = np.random.default_rng(abs(seed) + sample_every % 97)
    src = rng.integers(I32_MIN, I32_MAX, (40, 24), dtype=np.int64).astype(
        np.int32)
    seq = rng.integers(I32_MIN, I32_MAX, (40, 24), dtype=np.int64).astype(
        np.int32)
    src[0, :4] = [I32_MIN, I32_MAX, -1, 0]
    seq[0, :4] = [0, -1, I32_MAX, I32_MIN]
    jf, tf = both(seed, sample_every=sample_every)
    want = np.asarray(jfr.sample_mask(jf, jnp.asarray(src), jnp.asarray(seq)))
    got = tfr.sample_mask(tf, torch.from_numpy(src), torch.from_numpy(seq))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    if sample_every == 1:
        assert want.all()
    elif sample_every == 64:
        assert 0 < want.sum() < want.size


def _candidates(rng, b):
    cols = [rng.integers(-50, 5000, b).astype(np.int32) for _ in range(5)]
    return cols, rng.random(b) < 0.6


@pytest.mark.parametrize("cursor", [None, 5, I32_MAX - 9, I32_MIN + 3, -1])
def test_record_events_matches_jax_with_overflow(cursor):
    """Windows of 0 to 60 candidates into an 8-slot ring (most windows
    hold more than the ring), the cursor starting at 0, mid-ring, just
    under 2**31 (it wraps) and negative; every leaf after each."""
    rng = np.random.default_rng(7)
    jf, tf = both(ring=8, cursor=cursor)
    for w, b in enumerate((40, 3, 60, 1, 17, 33)):
        cols, mask = _candidates(rng, b)
        if w == 1:
            mask[:] = False
        jf = jfr.advance_window(jfr.record_events(
            jf, *map(jnp.asarray, cols), jnp.asarray(mask)))
        tf = tfr.advance_window(tfr.record_events(
            tf, *map(torch.from_numpy, cols), torch.from_numpy(mask)))
        assert_rings_equal(jf, tf, w)
    assert int(tf.win) == 6


@pytest.mark.parametrize("cursor", [None, 3, I32_MAX - 4, I32_MIN + 2])
@pytest.mark.parametrize("new_ring", [9, 16, 37])
def test_grow_ring_matches_jax(cursor, new_ring):
    rng = np.random.default_rng(2)
    jf, tf = both(ring=8, cursor=cursor)
    for b in (5, 11):
        cols, mask = _candidates(rng, b)
        jf = jfr.record_events(jf, *map(jnp.asarray, cols),
                               jnp.asarray(mask))
        tf = tfr.record_events(tf, *map(torch.from_numpy, cols),
                               torch.from_numpy(mask))
    assert_rings_equal(jfr.grow_ring(jf, new_ring),
                       tfr.grow_ring(tf, new_ring))
    with pytest.raises(ValueError, match="only grow"):
        tfr.grow_ring(tf, 8)


@pytest.mark.parametrize("cursor", [None, I32_MAX - 20])
def test_flight_recorder_drain_matches_jax(cursor):
    """The same ring states drained by both recorders, ticks between
    bursts of events of which some overflow the ring: equal hops, JSONL
    sinks, `recorded_hops` and `overwritten`."""
    rng = np.random.default_rng(5)
    jf, tf = both(ring=16, cursor=cursor)
    jsink, tsink = io.StringIO(), io.StringIO()
    jrec = jfr.FlightRecorder(window_ns=5 * MS, sink=jsink)
    trec = tfr.FlightRecorder(window_ns=5 * MS, sink=tsink)
    if cursor is not None:
        jrec.seed_cursor(cursor)
        trec.seed_cursor(cursor)
    for burst in ((10,), (30, 2), (), (5, 5, 5), (50,)):
        for b in burst:
            cols, mask = _candidates(rng, b)
            jf = jfr.advance_window(jfr.record_events(
                jf, *map(jnp.asarray, cols), jnp.asarray(mask)))
            tf = tfr.advance_window(tfr.record_events(
                tf, *map(torch.from_numpy, cols), torch.from_numpy(mask)))
        jrec.tick(jf)
        trec.tick(tf)
    jrec.tick(jf)
    trec.tick(tf)
    jrec.finalize()
    trec.finalize()
    assert trec.hops == jrec.hops and trec.summary() == jrec.summary()
    assert tsink.getvalue() == jsink.getvalue()
    assert trec.overwritten > 0 and trec.recorded > 16
    assert tfr.read_hops(tsink.getvalue().splitlines()) == trec.hops
    assert tfr.hop_flows(trec.hops) == jfr.hop_flows(jrec.hops)
    assert tfr.flightrec_meta(tf) == jfr.flightrec_meta(jf)


def test_flight_recorder_retain_false_only_streams():
    """`retain=False`, as in JAX: every decoded hop still goes to the
    sink and counts in `recorded`, but none is kept in `hops`."""
    rng = np.random.default_rng(8)
    jf, tf = both(ring=16)
    sinks = {k: io.StringIO() for k in ("jax", "keep", "stream")}
    jrec = jfr.FlightRecorder(window_ns=5 * MS, sink=sinks["jax"],
                              retain=False)
    keep = tfr.FlightRecorder(window_ns=5 * MS, sink=sinks["keep"])
    stream = tfr.FlightRecorder(window_ns=5 * MS, sink=sinks["stream"],
                                retain=False)
    for b in (10, 30, 5):
        cols, mask = _candidates(rng, b)
        jf = jfr.advance_window(jfr.record_events(
            jf, *map(jnp.asarray, cols), jnp.asarray(mask)))
        tf = tfr.advance_window(tfr.record_events(
            tf, *map(torch.from_numpy, cols), torch.from_numpy(mask)))
        for rec in (jrec, keep, stream):
            rec.tick(tf if rec is not jrec else jf)
    for rec in (jrec, keep, stream):
        rec.finalize()
    assert keep.recorded > 0 and len(keep.hops) == keep.recorded
    assert stream.hops == [] and jrec.hops == []
    assert stream.recorded == keep.recorded == jrec.recorded
    assert stream.summary() == jrec.summary()
    assert sinks["stream"].getvalue() == sinks["keep"].getvalue() \
        == sinks["jax"].getvalue()
    assert tfr.read_hops(sinks["stream"].getvalue().splitlines()) == \
        keep.hops


def test_step_and_ingest_rows_flightrec_match_jax():
    """`window_step(kernel="xla")` with faults, guards and the recorder
    (every other packet sampled) and `ingest_rows` with the recorder
    and guards: the ring and the state after each call, and the
    guards' summary."""
    n = 8
    (params, jst), (tparams, tst) = rr_world(n, 8, 8, seed=12)
    masks = dict(host_alive=np.ones(n, bool), link_up=np.ones(n, bool),
                 lat_mult=np.ones((n, n), np.int32),
                 bw_div=np.ones(n, np.int32),
                 corrupt_p=np.full(n, 0.3, np.float32))
    masks["host_alive"][2] = False
    jfa = jfplane.faults_from_numpy(**masks)
    tfa = tfplane.faults_from_numpy(**masks, device="cpu")
    jf, tf = both(4, sample_every=2, ring=64)
    jg, tg = jgplane.make_guards(n), tgplane.make_guards(n, device="cpu")
    key = jax.random.key(4)
    rng = np.random.default_rng(1)
    step = jax.jit(lambda st, sh, g, f: jplane.window_step(
        st, params, key, sh, jnp.int32(10 * MS), faults=jfa, guards=g,
        flightrec=f))
    for w in range(4):
        shift = 0 if w == 0 else 10 * MS
        jst, _d, _n, jg, jf = step(jst, jnp.int32(shift), jg, jf)
        tst, _td, _tn, tg, tf = tplane.window_step(
            tst, tparams, 4, shift, 10 * MS, faults=tfa, guards=tg,
            flightrec=tf)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        assert_rings_equal(jf, tf, w)
        rows = dict(dst=rng.integers(0, n, (n, 5)).astype(np.int32),
                    nbytes=rng.integers(60, 1500, (n, 5)).astype(np.int32),
                    prio=rng.integers(0, 4, (n, 5)).astype(np.int32),
                    seq=rng.integers(0, 10**6, (n, 5)).astype(np.int32),
                    ctrl=rng.random((n, 5)) < 0.2,
                    valid=rng.random((n, 5)) < 0.7,
                    send_rel=rng.integers(0, MS, (n, 5)).astype(np.int32))
        jst, jg, jf = jplane.ingest_rows(
            jst, **{k: jnp.asarray(v) for k, v in rows.items()}, guards=jg,
            flightrec=jf)
        tst, tg, tf = tplane.ingest_rows(
            tst, **{k: torch.from_numpy(v) for k, v in rows.items()},
            guards=tg, flightrec=tf)
        assert_rings_equal(jf, tf, ("ingest", w))
    assert tgplane.summarize(tg) == jgplane.summarize(jg)
    kinds = set(tf.ev_kind.tolist())
    assert {0, 1, 2, 4} <= kinds  # ingest, routed, delivered, drop_fault


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_pallas_paths_refuse_flightrec(kernel):
    (_p, _j), (tparams, tst) = rr_world(8, 8, 8, rr_mix=False)
    with pytest.raises(ValueError, match="flightrec"):
        tplane.window_step(tst, tparams, 0, 0, MS, rr_enabled=False,
                           kernel=kernel,
                           flightrec=tfr.make_flightrec(0, device="cpu"))

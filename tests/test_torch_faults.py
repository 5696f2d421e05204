"""The port's fault plane against the JAX package's, bitwise (no
tolerance: the plane is int32 plus float32 draws from the same threefry
bits): the fault branches of `window_step(kernel="xla", faults=)` one
fault class at a time, neutral masks against `faults=None`, the compiled
schedule step by step with its validation messages, the copy made on
upload, and the Pallas kernels' refusal. Also the XLA default kernel:
a call with only the positional arguments runs as JAX's does."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, assert_tuples_equal,  # noqa: E402
                          jax_state_to_numpy, rr_world)

from shadow_tpu.core.config import ConfigError as JConfigError  # noqa: E402
from shadow_tpu.core.config import FaultsOptions as JFaultsOptions  # noqa: E402
from shadow_tpu.faults import plane as jfplane  # noqa: E402
from shadow_tpu.faults import schedule as jsched  # noqa: E402
from shadow_tpu.telemetry import make_metrics  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.core.config import ConfigError, FaultsOptions  # noqa: E402
from shadow_tpu_torch.faults import plane as tfplane  # noqa: E402
from shadow_tpu_torch.faults import schedule as tsched  # noqa: E402
from shadow_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

MS = 1_000_000
N = 8
SEED = 5
CORPUS = Path(__file__).resolve().parent.parent / "scenarios"


def fault_masks(kind: str) -> dict:
    """One fault class on the 8-host world, as numpy masks."""
    m = dict(host_alive=np.ones(N, bool), link_up=np.ones(N, bool),
             lat_mult=np.ones((N, N), np.int32), bw_div=np.ones(N, np.int32),
             corrupt_p=np.zeros(N, np.float32))
    if kind == "crash":
        m["host_alive"][[2, 5]] = False
    elif kind == "link_down":
        m["link_up"][3] = False
    elif kind == "lat_mult":
        m["lat_mult"][0, :] = 3
        m["lat_mult"][:, 4] = 7
        m["lat_mult"][1, 1] = 0  # clamped up to 1, as in JAX
    elif kind == "bw_div":
        m["bw_div"][:] = [1, 2, 3, 5, 1, 8, 0, 4]  # 0 clamps to 1
    elif kind in ("corrupt", "corrupt_no_loss"):
        m["corrupt_p"][:] = [0.5, 0.0, 0.9, 0.25, 1.0, 0.0, 0.6, 0.1]
    return m


def step_both(masks, *, windows=3, rr_enabled=True, no_loss=False,
              port_masks="same"):
    """`windows` XLA windows of the rr world on both sides, the fault
    masks threaded (None: faults=None) with metrics; compares the state,
    the delivered dict, the next event and the metrics after each.
    `port_masks` gives the port other masks (the neutral-vs-None
    check). Returns the port's final state and metrics."""
    (params, jst), (tparams, tst) = rr_world(N, 8, 8, rr_mix=rr_enabled,
                                             seed=11)
    key = jax.random.key(SEED)
    jfa = None if masks is None else jfplane.faults_from_numpy(**masks)
    pm = masks if port_masks == "same" else port_masks
    tfa = None if pm is None else tfplane.faults_from_numpy(**pm,
                                                             device="cpu")
    jm, tm = make_metrics(N), tmetrics.make_metrics(N, device="cpu")

    @jax.jit
    def jstep(st, sh, m, fa):
        return jplane.window_step(st, params, key, sh, jnp.int32(10 * MS),
                                  rr_enabled=rr_enabled, no_loss=no_loss,
                                  faults=fa, metrics=m)

    for w in range(windows):
        shift = 0 if w == 0 else 10 * MS
        jst, jd, jn, jm = jstep(jst, jnp.int32(shift), jm, jfa)
        tst, td, tn, tm = tplane.window_step(
            tst, tparams, SEED, shift, 10 * MS, rr_enabled=rr_enabled,
            no_loss=no_loss, faults=tfa, metrics=tm)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
        assert int(jn) == int(tn), w
        assert_tuples_equal(jm, tm, w)
    return tst, tm


def test_positional_call_runs_the_xla_default_as_jax():
    """`window_step(state, params, seed, shift, window)` with every
    default: kernel "xla" and the round-robin qdisc, as in JAX."""
    (params, jst), (tparams, tst) = rr_world(N, 8, 8)
    key = jax.random.key(SEED)
    for w in range(3):
        shift = 0 if w == 0 else 10 * MS
        jst, jd, jn = jplane.window_step(jst, params, key, jnp.int32(shift),
                                         jnp.int32(10 * MS))
        tst, td, tn = tplane.window_step(tst, tparams, SEED, shift, 10 * MS)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
        assert int(jn) == int(tn)
    assert int(tst.n_sent.sum()) > 0


@pytest.mark.parametrize("rr_enabled", [True, False])
@pytest.mark.parametrize("no_loss", [False, True])
def test_neutral_faults_equal_no_faults(rr_enabled, no_loss):
    """Neutral masks leave the step as faults=None does (the port against
    JAX's unfaulted step), and so match JAX's neutral run too."""
    neutral = fault_masks("none")
    kw = dict(rr_enabled=rr_enabled, no_loss=no_loss)
    st_none, m_none = step_both(None, port_masks=neutral, **kw)
    st_neutral, m_neutral = step_both(neutral, **kw)
    assert convert.state_digest(st_none) == convert.state_digest(st_neutral)
    assert int(st_neutral.n_fault_dropped.sum()) == 0
    assert_tuples_equal(m_none, m_neutral)


@pytest.mark.parametrize("kind", ["crash", "link_down", "lat_mult", "bw_div",
                                  "corrupt", "corrupt_no_loss"])
def test_each_fault_class_matches_jax(kind):
    masks = fault_masks(kind)
    no_loss = kind == "corrupt_no_loss"
    st, m = step_both(masks, no_loss=no_loss)
    plain, _ = step_both(None, no_loss=no_loss)
    assert convert.state_digest(st) != convert.state_digest(plain), \
        "the fault class changed nothing: the check is dead"
    drops = int(st.n_fault_dropped.sum())
    assert drops == int(m.drop_fault.sum())
    if kind in ("crash", "link_down", "corrupt", "corrupt_no_loss"):
        assert drops > 0
    else:
        assert drops == 0


def _compile(sched_mod, opts_cls, opts_kw: dict, n_hosts=16, seed=3):
    return sched_mod.compile_schedule(
        opts_cls(**opts_kw), host_names=[f"h{i}" for i in range(n_hosts)],
        n_nodes=n_hosts, seed=seed, stop_time_ns=10_000 * MS)


def _schedules(opts_kw: dict, **kw):
    return (_compile(jsched, JFaultsOptions, opts_kw, **kw),
            _compile(tsched, FaultsOptions, opts_kw, **kw))


def _same_refusal(opts_kw: dict):
    with pytest.raises(JConfigError) as je:
        _compile(jsched, JFaultsOptions, opts_kw)
    with pytest.raises(ConfigError) as te:
        _compile(tsched, FaultsOptions, opts_kw)
    assert str(te.value) == str(je.value)


def _event_tuple(e):
    return (e.time_ns, e.kind, e.host, e.src_node, e.dst_node,
            e.latency_mult, e.bandwidth_div, e.corrupt_p, e.symmetric, e.seq)


def _compare_steps(js, ts, windows, window_ns):
    assert js.fingerprint() == ts.fingerprint()
    assert [_event_tuple(e) for e in js.events] == \
        [_event_tuple(e) for e in ts.events]
    refreshed = None
    for r in range(windows):
        t = (r + 1) * window_ns
        assert js.span_fingerprint(r * window_ns, t) == \
            ts.span_fingerprint(r * window_ns, t), r
        jf, tf = js.advance(t), ts.advance(t)
        assert [_event_tuple(e) for e in jf] == \
            [_event_tuple(e) for e in tf], r
        ja = js.device_arrays()
        ta = ts.device_arrays("cpu")
        refreshed = (ts.device_arrays("cpu") if refreshed is None
                     else ts.refresh_device_arrays(refreshed, tf))
        for f in ja._fields:
            want = np.asarray(getattr(ja, f))
            for got in (getattr(ta, f), getattr(refreshed, f)):
                assert got.numpy().dtype == want.dtype, (r, f)
                assert np.array_equal(got.numpy(), want), (r, f)
    assert js.remaining == ts.remaining
    assert js.peek_next_ns() == ts.peek_next_ns()


def test_default_schedule_matches_jax_step_by_step():
    """`default_fault_schedule` of a corpus entry: the compiled events,
    every window's fired events, masks and span digests, and the
    in-place refresh the runner uses, against JAX's per-round stack."""
    path = str(CORPUS / "serve_burst_lossy.yaml")
    jsp, tsp = jspec.load_scenario_file(path), tspec.load_scenario_file(path)
    js = jrunner.default_fault_schedule(jsp)
    ts = trunner.default_fault_schedule(tsp)
    assert len(ts.events) == 6
    _compare_steps(js, ts, tsp.windows, tsp.window_ns)


def test_random_schedule_matches_jax_step_by_step():
    """A seeded `random:` block (crashes and flaps from xoshiro256++),
    explicit events of every kind, an asymmetric link and a
    `faults.seed` override."""
    opts = dict(seed=99, random={
        "host_crashes": {"count": 3, "window": ["10ms", "200ms"],
                         "downtime": "30ms"},
        "iface_flaps": {"count": 2, "window": ["5ms", "100ms"],
                        "downtime": "50 ms"}},
        events=[
            {"at": "20ms", "kind": "host_degrade", "host": "h4",
             "bandwidth_div": 3, "until": "90ms"},
            {"at": "15ms", "kind": "link_degrade", "src_node": 2,
             "dst_node": 7, "latency_mult": 5, "symmetric": False,
             "duration": "40ms"},
            {"at": 0.03, "kind": "corrupt_burst", "host": "h1", "p": 0.4,
             "duration": "25ms"},
            {"at": "60ms", "kind": "iface_down", "host": "h9"},
        ])
    js, ts = _schedules(opts)
    assert len(ts.events) == 17
    _compare_steps(js, ts, 30, 10 * MS)
    for seed in (0, 1, 2**40 + 7):
        a, b = _schedules(dict(opts, seed=None), seed=seed)
        assert a.fingerprint() == b.fingerprint()


@pytest.mark.parametrize("bad", [
    [{"at": "1s", "kind": "meteor", "host": "h0"}],
    [{"kind": "host_crash", "host": "h0"}],
    [{"at": "1s", "kind": "host_crash", "host": "nope"}],
    [{"at": "1s", "kind": "corrupt_burst", "host": "h0", "p": 1.5,
      "duration": "1s"}],
    [{"at": "1s", "kind": "corrupt_burst", "host": "h0", "p": 0.5}],
    [{"at": "1s", "kind": "link_degrade", "src_node": 0, "dst_node": 1,
      "latency_mult": 0}],
    [{"at": "1s", "kind": "host_crash", "host": "h0", "bogus": 1}],
    [{"at": "0s", "kind": "host_crash", "host": "h0"}],
    [{"at": "1 fortnight", "kind": "host_crash", "host": "h0"}],
    [{"at": "1s", "kind": "host_crash", "host": "h0", "duration": "1s",
      "until": "3s"}],
    [{"at": "2s", "kind": "host_crash", "host": "h0", "until": "1s"}],
    [{"at": "1s", "kind": "host_reboot", "host": "h0", "duration": "1s"}],
], ids=["kind", "at", "host", "probability", "corrupt-duration",
        "latency-mult", "unknown-field", "at-zero", "unit", "both-ends",
        "until-before", "no-recovery"])
def test_schedule_validation_errors_match_jax(bad):
    _same_refusal(dict(events=bad))


def test_random_block_validation_matches_jax():
    for spec in ({"meteors": {}},
                 {"host_crashes": {"count": 0, "window": ["1s", "2s"],
                                   "downtime": "1s"}},
                 {"host_crashes": {"count": 1, "window": ["2s", "1s"],
                                   "downtime": "1s"}},
                 {"iface_flaps": {"count": 1, "window": ["1s", "2s"]}}):
        _same_refusal(dict(random=spec))


def test_faults_from_numpy_does_not_alias():
    """The schedule mutates its masks in place on `advance`; an uploaded
    `FaultArrays` keeps the values it was given."""
    _js, ts = _schedules(dict(events=[
        {"at": "1s", "kind": "host_crash", "host": "h2"},
        {"at": "2s", "kind": "host_reboot", "host": "h2"},
        {"at": "1s", "kind": "link_degrade", "src_node": 0, "dst_node": 1,
         "latency_mult": 4, "until": "2s"}]))
    ts.advance(1_000 * MS)
    arrays = ts.device_arrays("cpu")
    before = convert.tuple_to_numpy(arrays)
    ts.advance(2_000 * MS)  # mutates the schedule's masks in place
    after = convert.tuple_to_numpy(arrays)
    for f in before:
        assert np.array_equal(before[f], after[f]), f
    assert not before["host_alive"][2] and before["lat_mult"][0, 1] == 4
    assert ts.host_alive[2] and ts.lat_mult[0, 1] == 1


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_pallas_paths_refuse_faults(kernel):
    (_p, _j), (tparams, tst) = rr_world(N, 8, 8, rr_mix=False)
    fa = tfplane.neutral_faults(N, device="cpu")
    with pytest.raises(ValueError, match="faults"):
        tplane.window_step(tst, tparams, 0, 0, MS, rr_enabled=False,
                           kernel=kernel, faults=fa)
    jst = jplane.make_state(N, 8, 8)
    jparams = jplane.make_params(np.full((N, N), MS, np.int32),
                                 np.zeros((N, N), np.float32),
                                 np.full(N, 10**9))
    with pytest.raises(ValueError, match="fault plane"):
        jplane.window_step(jst, jparams, jax.random.key(0), 0, MS,
                           rr_enabled=False, kernel=kernel,
                           faults=jfplane.neutral_faults(N))


def test_rng_and_units_copies_match_jax():
    """The port's copies of the host RNG and the duration parser that the
    schedule's `random:` expansion and `_dur` read."""
    from shadow_tpu.core import rng as jrng
    from shadow_tpu.core import units as junits
    from shadow_tpu_torch.core import rng as trng
    from shadow_tpu_torch.core import units as tunits

    for seed in (0, 1, 2**63 + 5, -3):
        a, b = jrng.Xoshiro256pp(seed), trng.Xoshiro256pp(seed)
        assert [a.randrange(3, 10**9) for _ in range(50)] == \
            [b.randrange(3, 10**9) for _ in range(50)]
        assert a.next_u64() == b.next_u64()
        assert jrng.splitmix64(seed & (2**64 - 1)) == \
            trng.splitmix64(seed & (2**64 - 1))
    assert trng.hostname_hash("h16379") == jrng.hostname_hash("h16379")
    for text in ("10 ms", "2s", 30, 1.5, "7us", "3 min", "0.25h", "4ns"):
        assert tunits.parse_duration_ns(text) == \
            junits.parse_duration_ns(text)
    for bad in ("1 fortnight", "ms", "-3s"):
        with pytest.raises(ValueError):
            tunits.parse_duration_ns(bad)

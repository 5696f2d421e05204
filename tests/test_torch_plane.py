"""The port's plane against the JAX plane, bitwise: the flat `ingest`,
`ingest_rows`, and chained `window_step`s on the sort-diet test's busy
world, compared with `window_step(kernel="pallas_fused")` (interpret
mode) leaf by leaf, garbage lanes included, plus every delivered column
and the next-event scalar. Also pins the step's refusals of what is not
ported yet."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, jax_params_to_numpy,  # noqa: E402
                          jax_state_to_numpy)

from shadow_tpu.tpu import ingest, ingest_rows, make_params, make_state  # noqa: E402
from shadow_tpu.tpu.plane import window_step  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

MS = 1_000_000
N = 8
RNG_SEED = 3


def busy_world(*, ingress_cap=8, loss=0.3, seed=7):
    """`tests/test_plane_sortdiet.py`'s busy_world(rr_mix=False):
    starved token buckets, real loss, duplicate priorities, colliding
    socket slots. Returns (jax params, jax state before the ingest, the
    ingest batch as numpy)."""
    rng = np.random.default_rng(seed)
    lat = rng.integers(1 * MS, 20 * MS, size=(N, N)).astype(np.int32)
    params = make_params(lat, np.full((N, N), loss, np.float32),
                         np.full((N,), 80_000, np.int64),
                         qdisc_rr=np.zeros(N, bool),
                         down_bw_bps=np.full((N,), 400_000))
    state = make_state(N, egress_cap=8, ingress_cap=ingress_cap,
                       params=params,
                       initial_tokens=np.asarray(params.tb_cap))
    b = 48
    batch = dict(
        src=rng.integers(0, N, b).astype(np.int32),
        dst=rng.integers(0, N, b).astype(np.int32),
        nbytes=rng.integers(100, 1500, b).astype(np.int32),
        prio=rng.integers(0, 6, b).astype(np.int32),
        seq=np.arange(b, dtype=np.int32),
        ctrl=rng.integers(0, 3, b) == 0,
        sock=rng.integers(0, 40, b).astype(np.int32),
    )
    return params, state, batch


def both_worlds(**kw):
    params, state, batch = busy_world(**kw)
    jst = ingest(state, **{k: jnp.asarray(v) for k, v in batch.items()})
    tst = convert.state_from_numpy(jax_state_to_numpy(state), "cpu")
    tst = tplane.ingest(tst, **{k: torch.from_numpy(v)
                                for k, v in batch.items()})
    tparams = convert.params_from_numpy(jax_params_to_numpy(params), "cpu")
    return (params, jst), (tparams, tst)


def test_ingest_matches_jax():
    (_p, jst), (_tp, tst) = both_worlds()
    assert_states_equal(jax_state_to_numpy(jst),
                        convert.state_to_numpy(tst))


def test_ingest_with_dead_slots_and_overflow():
    """A valid mask routes dead slots nowhere; a hot source overflows."""
    params, state, batch = busy_world()
    rng = np.random.default_rng(9)
    batch["src"][:20] = 3  # 20 packets for one 8-slot row
    valid = rng.random(batch["src"].shape[0]) < 0.8
    jst = ingest(state, **{k: jnp.asarray(v) for k, v in batch.items()},
                 valid=jnp.asarray(valid))
    tst = tplane.ingest(
        convert.state_from_numpy(jax_state_to_numpy(state), "cpu"),
        **{k: torch.from_numpy(v) for k, v in batch.items()},
        valid=torch.from_numpy(valid))
    ref = jax_state_to_numpy(jst)
    assert ref["n_overflow_dropped"].sum() > 0
    assert_states_equal(ref, convert.state_to_numpy(tst))


def test_ingest_rows_matches_jax():
    """New entries, a full batch that overflows, and an all-invalid
    batch (the JAX idle gate's skip branch)."""
    (_p, jst), (_tp, tst) = both_worlds()
    rng = np.random.default_rng(5)
    K = 12
    cols = dict(
        dst=rng.integers(0, N, (N, K)).astype(np.int32),
        nbytes=rng.integers(100, 900, (N, K)).astype(np.int32),
        prio=rng.integers(0, 30, (N, K)).astype(np.int32),
        seq=rng.integers(100, 200, (N, K)).astype(np.int32),
        ctrl=rng.random((N, K)) < 0.3,
    )
    for valid in (rng.random((N, K)) < 0.4, np.ones((N, K), bool),
                  np.zeros((N, K), bool)):
        ref = ingest_rows(jst, **{k: jnp.asarray(v) for k, v in cols.items()},
                          valid=jnp.asarray(valid))
        got = tplane.ingest_rows(
            tst, **{k: torch.from_numpy(v) for k, v in cols.items()},
            valid=torch.from_numpy(valid))
        assert_states_equal(jax_state_to_numpy(ref),
                            convert.state_to_numpy(got))


@pytest.mark.parametrize("gate_idle", [True, False])
def test_ingest_rows_gate_idle_keyword_matches_jax(gate_idle):
    """`gate_idle=` is JAX's switch for its idle gate, which leaves the
    result unchanged: the port takes either value and gives its default
    result, equal to JAX's with the same value, for a batch with entries
    and an all-invalid one (the gate's skip branch)."""
    (_p, jst), (_tp, tst) = both_worlds()
    rng = np.random.default_rng(6)
    K = 6
    cols = dict(
        dst=rng.integers(0, N, (N, K)).astype(np.int32),
        nbytes=rng.integers(100, 900, (N, K)).astype(np.int32),
        prio=rng.integers(0, 30, (N, K)).astype(np.int32),
        seq=rng.integers(100, 200, (N, K)).astype(np.int32),
        ctrl=rng.random((N, K)) < 0.3,
    )
    for valid in (rng.random((N, K)) < 0.5, np.zeros((N, K), bool)):
        tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
        ref = ingest_rows(jst, **{k: jnp.asarray(v) for k, v in cols.items()},
                          valid=jnp.asarray(valid), gate_idle=gate_idle)
        got = tplane.ingest_rows(tst, **tcols, valid=torch.from_numpy(valid),
                                 gate_idle=gate_idle)
        default = tplane.ingest_rows(tst, **tcols,
                                     valid=torch.from_numpy(valid))
        assert_states_equal(jax_state_to_numpy(ref),
                            convert.state_to_numpy(got))
        assert_states_equal(convert.state_to_numpy(default),
                            convert.state_to_numpy(got))


def test_ingest_packed_sort_false_matches_jax():
    """Both appends take JAX's `packed_sort=` keyword: False runs JAX's
    pre-diet reference (the flat append's 9-array two-key sort and
    grouped scatters, dead slots to src N; the row merge's validity
    sort), equal to JAX's with the same flag, metrics and guards
    included, and to the packed append; True is the default."""
    from shadow_tpu.guards.plane import make_guards as jguards
    from shadow_tpu.telemetry import make_metrics as jmetrics
    from shadow_tpu_torch.guards.plane import make_guards
    from shadow_tpu_torch.telemetry.metrics import make_metrics
    from torch_parity import assert_tuples_equal

    params, state, batch = busy_world()
    batch["valid"] = np.arange(len(batch["seq"])) % 5 != 3
    tst = convert.state_from_numpy(jax_state_to_numpy(state), "cpu")
    flat = {k: torch.from_numpy(v) for k, v in batch.items()}
    jflat = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = np.random.default_rng(4)
    K = 4
    rows = {k: rng.integers(0, 1000, (N, K)).astype(np.int32)
            for k in ("dst", "nbytes", "prio", "seq")}
    rows["ctrl"] = rng.random((N, K)) < 0.3
    rows["valid"] = rng.random((N, K)) < 0.6
    trows = {k: torch.from_numpy(v) for k, v in rows.items()}
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    planes = dict(metrics=jmetrics(N), guards=jguards(N))
    tplanes = dict(metrics=make_metrics(N, device="cpu"),
                   guards=make_guards(N, device="cpu"))
    for jfn, tfn, jargs, targs in (
            (ingest, tplane.ingest, jflat, flat),
            (ingest_rows, tplane.ingest_rows, jrows, trows)):
        for st in (state, ingest(state, **jflat)):  # rings that overflow
            t = convert.state_from_numpy(jax_state_to_numpy(st), "cpu")
            jst, jm, jg = jfn(st, **jargs, packed_sort=False, **planes)
            got = tfn(t, **targs, packed_sort=False, **tplanes)
            assert_states_equal(jax_state_to_numpy(jst),
                                convert.state_to_numpy(got[0]))
            assert_tuples_equal(jm, got[1])
            assert_tuples_equal(jg, got[2])
            assert_states_equal(
                convert.state_to_numpy(got[0]),
                convert.state_to_numpy(tfn(t, **targs, **tplanes)[0]))
    assert_states_equal(
        convert.state_to_numpy(tplane.ingest(tst, **flat, packed_sort=True)),
        convert.state_to_numpy(tplane.ingest(tst, **flat)))
    assert_states_equal(
        convert.state_to_numpy(tplane.ingest_rows(tst, **trows,
                                                  packed_sort=True)),
        convert.state_to_numpy(tplane.ingest_rows(tst, **trows)))


def run_both(windows, **kw):
    (params, jst), (tparams, tst) = both_worlds(**kw.pop("world", {}))
    key = jax.random.key(RNG_SEED)
    step = jax.jit(lambda s, sh: window_step(
        s, params, key, sh, jnp.int32(10 * MS), rr_enabled=False,
        kernel="pallas_fused", **kw))
    shift = 0
    for w in range(windows):
        jst, jd, jn = step(jst, jnp.int32(shift))
        tst, td, tn = tplane.window_step(tst, tparams, RNG_SEED, shift,
                                         10 * MS, rr_enabled=False,
                                         kernel="pallas_fused", **kw)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        assert jd.keys() == td.keys()
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
            assert np.asarray(jd[k]).dtype == td[k].numpy().dtype, (w, k)
        assert tn.dtype == torch.int32 and tn.dim() == 0
        assert int(jn) == int(tn), w
        shift = 10 * MS
    return jax_state_to_numpy(jst)


@pytest.mark.parametrize("no_loss", [False, True])
def test_window_steps_match_pallas_fused(no_loss):
    final = run_both(4, no_loss=no_loss)
    assert final["n_sent"].sum() > 0 and final["n_delivered"].sum() > 0
    if not no_loss:
        assert final["n_loss_dropped"].sum() > 0, "no loss drawn: dead test"


def test_window_steps_with_ingress_overflow():
    """A 4-slot ingress ring overflows: the placement's take/overflow
    arithmetic and the per-host overflow counter."""
    final = run_both(3, world=dict(ingress_cap=4, loss=0.0, seed=11))
    assert final["n_overflow_dropped"].sum() > 0, "no overflow: dead test"


def test_window_step_refuses_what_is_not_ported():
    """What the JAX plane refuses for its Pallas kernels raises
    ValueError, as there (packed_sort=False among it; "xla" runs it).
    The metrics plane and the router AQM ride every kernel; the fault,
    guard, histogram, flight-recorder, flow and compute planes ride
    "xla"."""
    (_p, _j), (tparams, tst) = both_worlds()
    step = lambda **kw: tplane.window_step(tst, tparams, 0, 0, MS, **kw)
    for kernel in ("pallas_fused", "pallas"):
        with pytest.raises(ValueError, match="FIFO"):
            step(kernel=kernel)  # rr_enabled defaults to True, as in JAX
        with pytest.raises(ValueError, match="packed"):
            step(rr_enabled=False, packed_sort=False, kernel=kernel)
        for plane_name in ("faults", "guards", "hist", "flightrec", "flows",
                           "compute"):
            with pytest.raises(ValueError, match=plane_name):
                step(rr_enabled=False, kernel=kernel,
                     **{plane_name: object()})
        # the router AQM runs on every kernel, as in the JAX step; its
        # delivered dict has the relay's carried-over column
        out = step(rr_enabled=False, router_aqm=True, kernel=kernel)
        assert out[1]["mask"].shape == (N, tst.in_src.shape[1] + 1)
    # JAX's pre-diet sorts run on "xla" (tests/test_torch_xla_step.py)
    assert len(step(packed_sort=False, kernel="xla")) == 3
    # the fault, guard and flight-recorder planes are ported: "xla"
    # takes them (tests/test_torch_faults.py, _guards.py, _flightrec.py)
    from shadow_tpu_torch.faults.plane import neutral_faults
    from shadow_tpu_torch.guards.plane import make_guards
    from shadow_tpu_torch.telemetry.flightrec import make_flightrec
    n = tst.eg_dst.shape[0]
    out = step(kernel="xla", faults=neutral_faults(n, device="cpu"),
               guards=make_guards(n, device="cpu"),
               flightrec=make_flightrec(0, device="cpu"))
    assert len(out) == 5
    out = step(kernel="xla", router_aqm=True)
    assert out[1]["mask"].shape == (N, tst.in_src.shape[1] + 1)
    with pytest.raises(ValueError, match="unknown plane kernel"):
        step(rr_enabled=False, kernel="mosaic")
    with pytest.raises(TypeError, match="unexpected"):
        step(rr_enabled=False, tracer=object())

"""The port's capacity policy and elastic driver against the JAX
package's, bitwise.

`core/capacity.RingPolicy` and `tpu/elastic` (`grow_state`,
`canonical_state`, `chain_spans`, `run_elastic_window`,
`drive_chained_windows`) against `shadow_tpu.core.capacity` and
`shadow_tpu.tpu.elastic`; then the PHOLD bench body under the fixed,
strict and elastic policies from tiny rings (CE=4, CI=8) at N=64, the
port through its split (`kernel="pallas"`) and fused kernel pairs, the
JAX reference through `window_step(kernel="xla")` (the JAX package makes
its three kernels bitwise identical) driven by the JAX
`drive_chained_windows(policy=...)`.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from test_torch_plane import RNG_SEED, both_worlds  # noqa: E402
from torch_parity import assert_states_equal, jax_state_to_numpy  # noqa: E402

from shadow_tpu.core import capacity as jcapacity  # noqa: E402
from shadow_tpu.tpu import elastic as jelastic  # noqa: E402
from shadow_tpu.tpu import ingest_rows, profiling, window_step  # noqa: E402
from shadow_tpu.workloads.phold import respawn_batch  # noqa: E402
from shadow_tpu_torch import bench, convert  # noqa: E402
from shadow_tpu_torch.core import capacity  # noqa: E402
from shadow_tpu_torch.tpu import elastic  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.tpu import profiling as tprofiling  # noqa: E402

MS = 1_000_000
N_HOSTS, ROUNDS, GROW_EVERY = 64, 48, 16
SMALL = dict(egress_cap=4, ingress_cap=8)


@pytest.mark.parametrize("n_rounds,chain_len,start_round,boundaries", [
    (8, 3, 0, ()), (192, 16, 0, ()), (50, 16, 20, ()), (50, 16, 50, ()),
    (40, 7, 3, (5, 14, 39, 40, 99)), (10, 1, 0, (4,))])
def test_chain_spans_match_jax(n_rounds, chain_len, start_round,
                               boundaries):
    kw = dict(start_round=start_round, boundaries=boundaries)
    assert elastic.chain_spans(n_rounds, chain_len, **kw) == \
        jelastic.chain_spans(n_rounds, chain_len, **kw)
    for mod in (elastic, jelastic):
        with pytest.raises(ValueError, match="chain_len"):
            mod.chain_spans(4, 0)


def test_ring_policy_trajectory_matches_jax():
    """Growth, a growth budget running out per dimension, once-per-run
    drop notes, and the checkpoint meta round trip."""
    steps = [(5, 0), (0, 3), (7, 9), (2, 0), (0, 1), (4, 4), (0, 0)]
    pols = [mod.RingPolicy(mode="elastic", max_doublings=2, egress_cap=4,
                           ingress_cap=8, plane="bench")
            for mod in (capacity, jcapacity)]
    for i, (eg, inn) in enumerate(steps):
        got = [p.plan_growth(eg_overflow=eg, in_overflow=inn,
                             time_ns=i * 10 * MS) for p in pols]
        assert got[0] == got[1], i
    for p in pols:
        p.note_drop(ring="egress", overflow=3, time_ns=7)
        p.note_drop(ring="ingress", overflow=1, time_ns=8)
    port, ref = pols
    assert port.trajectory.as_dict() == ref.trajectory.as_dict()
    assert port.to_meta() == ref.to_meta()
    assert any(e["kind"] == "capacity-exhausted"
               for e in port.trajectory.events), "budget never ran out"
    again = [mod.RingPolicy(mode="elastic", max_doublings=2)
             for mod in (capacity, jcapacity)]
    for p, src in zip(again, pols):
        p.restore_meta(src.to_meta())
    assert again[0].to_meta() == again[1].to_meta() == ref.to_meta()
    assert capacity.next_pow2(9) == jcapacity.next_pow2(9) == 16
    assert capacity.CAPACITY_MODES == jcapacity.CAPACITY_MODES
    for mod in (capacity, jcapacity):
        with pytest.raises(ValueError, match="expected one of"):
            mod.RingPolicy(mode="loose")


def test_grow_and_canonical_state_match_jax():
    """A world with garbage lanes (two windows after a busy ingest),
    grown from (8, 8) to (16, 32) by both packages, and each canonical
    state."""
    (params, jst), (tparams, tst) = both_worlds()
    key = jax.random.key(RNG_SEED)
    for w in range(2):
        shift = 0 if w == 0 else 10 * MS
        jst, _d, _n = window_step(jst, params, key, jnp.int32(shift),
                                  jnp.int32(10 * MS), rr_enabled=False,
                                  kernel="xla")
        tst, _d, _n = tplane.window_step(tst, tparams, RNG_SEED, shift,
                                         10 * MS, rr_enabled=False,
                                         kernel="pallas")
    ref = jax_state_to_numpy(jst)
    assert_states_equal(ref, convert.state_to_numpy(tst))
    assert (~ref["eg_valid"]).any() and ref["eg_valid"].any()
    for caps in ((8, 8), (16, 8), (16, 32)):
        jg = jelastic.grow_state(jst, *caps)
        tg = elastic.grow_state(tst, *caps)
        assert elastic.ring_dims(tg) == jelastic.ring_dims(jg) == caps
        assert_states_equal(jax_state_to_numpy(jg),
                            convert.state_to_numpy(tg), caps)
        assert_states_equal(
            jax_state_to_numpy(jelastic.canonical_state(jg)),
            convert.state_to_numpy(elastic.canonical_state(tg)), caps)
    assert elastic.grow_state(tst, 8, 8) is tst
    with pytest.raises(ValueError, match="cannot shrink"):
        elastic.grow_state(tst, 4, 8)


def jax_bench_driver():
    """`bench.py`'s round body (its overflow accumulators included) as a
    jitted round plus a chain loop for the JAX `drive_chained_windows`.
    The world's params are shared by every run, so each ring shape
    compiles once."""
    world = profiling.build_world(N_HOSTS, n_nodes=64, seed=0,
                                  warmup_windows=0, **SMALL)
    params, key, window = world["params"], world["rng_root"], world["window"]

    @jax.jit
    def round_fn(state, spawn_seq, eg_acc, in_acc, round_idx):
        state0 = state
        shift = jnp.where(round_idx == 0, jnp.int32(0), window)
        state, delivered, _ = window_step(state, params, key, shift, window,
                                          rr_enabled=False, kernel="xla")
        in_acc = in_acc + (state.n_overflow_dropped
                           - state0.n_overflow_dropped)
        state1 = state
        mask, dst, nbytes, seq, ctrl = respawn_batch(
            delivered, spawn_seq, round_idx, N_HOSTS, state.in_src.shape[1])
        state = ingest_rows(state, dst, nbytes, seq, seq, ctrl, valid=mask)
        eg_acc = eg_acc + (state.n_overflow_dropped
                           - state1.n_overflow_dropped)
        return (state, spawn_seq + mask.sum(axis=1, dtype=jnp.int32),
                eg_acc, in_acc, mask.sum(dtype=jnp.int32))

    def chain_fn(state, extras, rids, _pr):
        spawn_seq, total = extras
        eg = inn = jnp.zeros((N_HOSTS,), jnp.int32)
        for r in np.asarray(rids):
            state, spawn_seq, eg, inn, nd = round_fn(state, spawn_seq, eg,
                                                     inn, jnp.int32(r))
            total += int(nd)
        return state, (spawn_seq, total), eg, inn

    def run(mode):
        policy = jcapacity.RingPolicy(mode=mode, max_doublings=4,
                                      plane="bench", **SMALL)
        spawn = jnp.full((N_HOSTS,), bench.SPAWN_SEQ0, jnp.int32)
        state, (_s, total) = jelastic.drive_chained_windows(
            world["state"], (spawn, 0), chain_fn, n_rounds=ROUNDS,
            chain_len=GROW_EVERY, policy=policy, window_ns=int(window))
        return state, total, policy
    return run


@pytest.fixture(scope="module")
def jax_runs():
    run = jax_bench_driver()
    out = {}
    for mode in ("elastic", "fixed"):
        state, total, policy = run(mode)
        out[mode] = (state, total, policy.trajectory.as_dict())
    with pytest.raises(jcapacity.CapacityError) as err:
        run("strict")
    out["strict"] = err.value
    return out


def port_run(mode, kernel):
    return bench.run_phold(N_HOSTS, rounds=ROUNDS, warmup=False,
                           device="cpu", kernel=kernel, capacity=mode,
                           grow_every=GROW_EVERY, **SMALL)


@pytest.mark.parametrize("kernel", ["pallas", "pallas_fused"])
def test_elastic_phold_matches_jax(jax_runs, kernel):
    """Growth happens, the trajectory is the JAX one, and the run ends in
    the JAX elastic run's canonical state and delivered total; it also
    ends canonically equal to a fixed run pre-provisioned at the final
    caps."""
    ref_state, ref_total, ref_traj = jax_runs["elastic"]
    res = port_run("elastic", kernel)
    cap = res["capacity"]
    assert cap["events"] == ref_traj["events"]
    assert any(e["kind"] == "capacity-growth" for e in cap["events"]), \
        "no ring grew: dead test"
    assert cap["initial"] == SMALL
    assert (cap["final"]["egress_cap"], cap["final"]["ingress_cap"]) == \
        jelastic.ring_dims(ref_state)
    assert res["delivered"] == ref_total > 0
    canon = convert.state_to_numpy(elastic.canonical_state(res["state"]))
    assert_states_equal(jax_state_to_numpy(
        jelastic.canonical_state(ref_state)), canon)
    pre = bench.run_phold(N_HOSTS, rounds=ROUNDS, warmup=False, device="cpu",
                          kernel=kernel, **cap["final"])
    assert pre["delivered"] == res["delivered"]
    assert convert.state_digest(elastic.canonical_state(pre["state"])) == \
        convert.state_digest(canon)
    assert res["driver"]["chains"] == ROUNDS // GROW_EVERY


def test_fixed_policy_drops_match_jax(jax_runs):
    """Under a fixed policy the tiny rings drop: the state is the JAX
    one, garbage lanes included, and each ring's first drop is noted
    once."""
    ref_state, ref_total, ref_traj = jax_runs["fixed"]
    res = port_run("fixed", "pallas")
    assert res["capacity"] is None  # the bench runs "fixed" policy-free
    policy = capacity.RingPolicy(mode="fixed", max_doublings=4,
                                 plane="bench", **SMALL)
    world = tprofiling.build_world(N_HOSTS, n_nodes=64, seed=0,
                                   warmup_windows=0, device="cpu", **SMALL)
    state, total = bench.run_chain(world, ROUNDS, GROW_EVERY,
                                   kernel="pallas", policy=policy)
    assert policy.trajectory.as_dict() == ref_traj
    assert [e["kind"] for e in ref_traj["events"]] == ["capacity-drop"] * 2
    assert total == ref_total == res["delivered"]
    assert_states_equal(jax_state_to_numpy(ref_state),
                        convert.state_to_numpy(state))


def test_strict_blame_matches_jax(jax_runs):
    ref = jax_runs["strict"]
    with pytest.raises(capacity.CapacityError) as err:
        port_run("strict", "pallas")
    got = err.value
    assert got.chain_span == ref.chain_span == (0, GROW_EVERY)
    assert got.ring == ref.ring and got.blame == ref.blame
    assert str(got) == str(ref)
    assert got.blame, "strict raised without blame"


def test_strict_blame_names_hosts():
    """`host_names` turns blamed rows into names."""
    policy = capacity.RingPolicy(mode="strict", **SMALL)
    attempt = lambda st: (st, torch.tensor([0, 2, 0]),
                          torch.tensor([0, 0, 1]))
    with pytest.raises(capacity.CapacityError, match="ingress") as err:
        elastic.run_elastic_window(None, attempt, policy, time_ns=5,
                                   host_names=["a", "b", "c"])
    assert err.value.blame == ["b", "c"]
    assert err.value.ring == "egress+ingress"


def test_driver_on_chain_hook_and_boundaries():
    """`on_chain` runs after every committed chain and may replace the
    carry; boundaries cut extra chains, as in the JAX driver."""
    seen = []

    def chain_fn(state, extras, r0, r1):
        return state + (r1 - r0), extras + [(r0, r1)], 0, 0

    def on_chain(r1, state, extras):
        seen.append((r1, state))
        return (state * 10, extras) if r1 == 5 else None

    state, extras = elastic.drive_chained_windows(
        0, [], chain_fn, n_rounds=12, chain_len=4, boundaries=(5,),
        on_chain=on_chain)
    assert extras == jelastic.chain_spans(12, 4, boundaries=(5,)) == [
        (0, 4), (4, 5), (5, 8), (8, 12)]
    assert seen == [(4, 4), (5, 5), (8, 53), (12, 57)]
    assert state == 57

"""The port's ensembles against the JAX package's, bitwise.

`prims.fold_in` / `elastic.world_keys` against `jax.random.fold_in`;
`window_step` under a key tensor against the JAX step under that key;
`elastic.drive_ensemble` (`torch.func.vmap` of the chain) against JAX's
`drive_ensemble` (`jax.vmap`) world by world on every kernel, with the
router AQM too, and each world against its solo run; each kernel's vmap
rule (one call of the op for W worlds folded into its rows) against the
plain version world by world; `histo.ensemble_percentiles`; the
`ensemble` spans of the run ledger; a batched checkpoint, array for
array JAX's and resumable across the packages; and the bench's worlds
record. The JAX side of each comparison runs once for the module."""

from __future__ import annotations

import ast
import functools
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from torch_parity import (BATCHED_KERNELS, assert_states_equal,  # noqa: E402
                          batched_kernel_case, flat_outputs,
                          jax_params_to_numpy, jax_state_to_numpy, rr_world)

from shadow_tpu.faults import runstate as jrunstate  # noqa: E402
from shadow_tpu.telemetry import RunTracer as JRunTracer  # noqa: E402
from shadow_tpu.telemetry import histo as jhisto  # noqa: E402
from shadow_tpu.tpu import elastic as jelastic  # noqa: E402
from shadow_tpu.tpu import (ingest_rows, profiling, unpack_planes,  # noqa: E402
                            window_step)
from shadow_tpu.workloads.phold import respawn_batch  # noqa: E402
from shadow_tpu_torch import bench, convert  # noqa: E402
from shadow_tpu_torch.faults import runstate as trunstate  # noqa: E402
from shadow_tpu_torch.telemetry import histo as thisto  # noqa: E402
from shadow_tpu_torch.telemetry.tracer import RunTracer  # noqa: E402
from shadow_tpu_torch.tpu import codel, pipeline, prims  # noqa: E402
from shadow_tpu_torch.tpu import elastic as telastic  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.workloads.phold import \
    respawn_batch as trespawn  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# tests/test_ensemble.py's world and schedule
N, M, ROUNDS, CHAIN_LEN, EVERY, W = 32, 8, 12, 4, 4, 2
SPAWN_BASE = 10_000
MS = 1_000_000
# where the keyed chain's key rides the carry (state, (key, spawn, total))
KEY_PATHS = ("carry.1.0",)


# -- the JAX side ---------------------------------------------------------


def jax_chain_fn(params, window, kernel, *, n=N, router_aqm=False):
    """tests/test_ensemble.py's per-world PHOLD chain over `n` hosts, on
    `kernel`, the respawn as wide as the delivered dict (CI + 1 under the
    AQM)."""
    def chain_fn(state, extras, rids, _pr):
        key, spawn_seq, total = extras

        def round_fn(carry, round_idx):
            state, spawn_seq = carry
            shift = jnp.where(round_idx == 0, jnp.int32(0), window)
            out = window_step(state, params, key, shift, window,
                              rr_enabled=False, kernel=kernel,
                              router_aqm=router_aqm)
            (state, delivered, _nx), _m, _g, _h, _fr = unpack_planes(out)
            mask, new_dst, nbytes, seq_vals, ctrl = respawn_batch(
                delivered, spawn_seq, round_idx, n,
                delivered["mask"].shape[1])
            out = ingest_rows(state, new_dst, nbytes, seq_vals, seq_vals,
                              ctrl, valid=mask)
            (state,), _m, _g, _h, _fr = unpack_planes(out, n_lead=1)
            spawn_seq = spawn_seq + mask.sum(axis=1, dtype=jnp.int32)
            return (state, spawn_seq), mask.sum(dtype=jnp.int32)

        (state, spawn_seq), nd = jax.lax.scan(round_fn, (state, spawn_seq),
                                              rids)
        zeros = jnp.zeros((n,), jnp.int32)
        return state, (key, spawn_seq, total + nd.sum()), zeros, zeros
    return chain_fn


@functools.lru_cache(maxsize=None)
def jax_world():
    return profiling.build_world(N, n_nodes=M, egress_cap=8, ingress_cap=16,
                                 seed=3, warmup_windows=1)


def jax_extras(keys):
    return (keys, jnp.full((W, N), SPAWN_BASE, jnp.int32),
            jnp.zeros((W,), jnp.int32))


def jax_stacked(state):
    return jax.tree.map(lambda x: jnp.stack([x] * W), state)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's W=2 ensembles, once: "xla" with its tracer and a checkpoint
    every 4 rounds, "pallas_fused" (Pallas in interpret mode), and the
    AQM world on "xla"."""
    w = jax_world()
    keys = jelastic.world_keys(w["rng_root"], jnp.arange(W, dtype=jnp.int32))
    out = {"keys": keys}
    ck_dir = tmp_path_factory.mktemp("jax_ens")
    tracer = JRunTracer("ens")
    ck = jrunstate.RunCheckpointer(str(ck_dir), every=EVERY, label="ens")
    for kernel in ("xla", "pallas_fused"):
        extra = dict(tracer=tracer, checkpointer=ck) if kernel == "xla" \
            else {}
        out[kernel] = jelastic.drive_ensemble(
            jax_stacked(w["state"]), jax_extras(keys),
            jax_chain_fn(w["params"], w["window"], kernel),
            n_rounds=ROUNDS, chain_len=CHAIN_LEN, **extra)
    out["spans"] = [r for r in tracer.records if r["kind"] == "span"]
    out["ckpt"] = jrunstate.latest_checkpoint(str(ck_dir), label="ens")
    (params, jst), (tparams, tst) = rr_world(16, 8, 16, rr_mix=False,
                                             seed=11)
    aqm_keys = jelastic.world_keys(jax.random.key(5),
                                   jnp.arange(W, dtype=jnp.int32))
    aqm = jelastic.drive_ensemble(
        jax_stacked(jst), (aqm_keys, jnp.full((W, 16), SPAWN_BASE, jnp.int32),
                           jnp.zeros((W,), jnp.int32)),
        jax_chain_fn(params, 10 * MS, "xla", n=16, router_aqm=True),
        n_rounds=8, chain_len=CHAIN_LEN)
    out["aqm"] = (aqm, (tparams, tst))
    return out


# -- the port's side ---------------------------------------------------------


def port_world():
    w = jax_world()
    return {"state": convert.state_from_numpy(jax_state_to_numpy(w["state"]),
                                              "cpu"),
            "params": convert.params_from_numpy(
                jax_params_to_numpy(w["params"]), "cpu"),
            "window": int(w["window"]), "rng_root": 1}


def port_extras(keys):
    return (keys, torch.full((W, N), SPAWN_BASE, dtype=torch.int32),
            torch.zeros(W, dtype=torch.int32))


def port_ensemble(kernel, **kw):
    world = port_world()
    keys = telastic.world_keys(1, range(W), device="cpu")
    chain = bench.phold_keyed_chain_fn(world, kernel=kernel)
    states, extras = telastic.drive_ensemble(
        telastic.stack_worlds(world["state"], W), port_extras(keys), chain,
        n_rounds=ROUNDS, chain_len=CHAIN_LEN, **kw)
    return world, keys, chain, states, extras


def assert_worlds_equal(jout, tout, ctx):
    """Each world of JAX's batched (states, extras) against the port's:
    the state leaf by leaf, the key words, spawn counters and totals."""
    (jst, jex), (tst, tex) = jout, tout
    for b in range(W):
        assert_states_equal(
            jax_state_to_numpy(jax.tree.map(lambda x: x[b], jst)),
            convert.state_to_numpy(telastic.world_slice(tst, b)), (ctx, b))
    assert np.array_equal(np.asarray(jax.random.key_data(jex[0])),
                          tex[0].numpy()), ctx
    for i in (1, 2):
        a, t = np.asarray(jex[i]), tex[i].numpy()
        assert a.dtype == t.dtype and np.array_equal(a, t), (ctx, i)


# -- keys ---------------------------------------------------------------------


ANCHOR = [[507451445, 1853169794], [1948878966, 4237131848]]
EDGE_SEEDS = (0, 1, -1, 2**31 - 1, -2**31)


def test_world_keys_match_jax_fold_in():
    got = telastic.world_keys(1, [0, 1], device="cpu")
    assert got.dtype == torch.int64 and got.tolist() == ANCHOR
    root = jax.random.key(1)
    edge = jnp.asarray(EDGE_SEEDS, jnp.int32)
    want = np.asarray(jax.random.key_data(jelastic.world_keys(root, edge)))
    assert np.array_equal(
        telastic.world_keys(1, torch.tensor(EDGE_SEEDS, dtype=torch.int32),
                            device="cpu").numpy(), want)
    for s, words in zip(EDGE_SEEDS, want):
        assert telastic.world_key(1, s).tolist() == words.tolist(), s
        # a key tensor root, and a key folded again, as JAX chains them
        kt = prims.key_tensor(1)
        twice = jax.random.key_data(jax.random.fold_in(
            jax.random.fold_in(root, jnp.int32(s)), jnp.int32(7)))
        assert prims.fold_in(prims.fold_in(kt, s), 7).tolist() == \
            np.asarray(twice).tolist(), s
    assert prims.key_tensor(1).tolist() == np.asarray(
        jax.random.key_data(root)).tolist()
    with pytest.raises(ValueError):
        prims.fold_in(1, 2**32)


@settings(max_examples=40, deadline=None)
@given(root=st.integers(-2**31, 2**31 - 1), seed=st.integers(-2**31,
                                                             2**31 - 1))
def test_fold_in_matches_jax_for_any_int32(root, seed):
    want = jax.random.key_data(jax.random.fold_in(jax.random.key(root),
                                                  jnp.int32(seed)))
    got = prims.fold_in(prims.key_tensor(root), torch.tensor(
        seed, dtype=torch.int32))
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("kernel,jax_kernel", [
    ("xla", "xla"), ("pallas_fused", "pallas_fused"), ("pallas", "xla")])
def test_window_step_under_a_key_tensor_matches_jax(kernel, jax_kernel):
    """Two windows under a world key, against JAX's step under the same
    key ("pallas" against the XLA step: JAX's split kernel needs
    `pl.load`); and the int-seed path equals the key_tensor(seed) path."""
    w = jax_world()
    tw = port_world()
    jkey = jax.random.fold_in(w["rng_root"], jnp.int32(5))
    tkey = telastic.world_key(1, 5)
    jst, tst = w["state"], tw["state"]
    step = jax.jit(lambda s, sh: window_step(s, w["params"], jkey, sh,
                                             w["window"], rr_enabled=False,
                                             kernel=jax_kernel))
    for r in range(2):
        shift = 0 if r == 0 else tw["window"]
        jst, jd, _ = step(jst, jnp.int32(shift))
        tst, td, _ = tplane.window_step(tst, tw["params"], tkey, shift,
                                        tw["window"], rr_enabled=False,
                                        kernel=kernel)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), (kernel, r))
    assert int(tst.n_loss_dropped.sum()) > 0  # the key drew losses
    by_int = tplane.window_step(tw["state"], tw["params"], 1, 0,
                                tw["window"], rr_enabled=False,
                                kernel=kernel)[0]
    by_key = tplane.window_step(tw["state"], tw["params"],
                                prims.key_tensor(1), 0, tw["window"],
                                rr_enabled=False, kernel=kernel)[0]
    assert convert.state_digest(by_int) == convert.state_digest(by_key)


# -- the ensemble driver ---------------------------------------------------


@pytest.mark.parametrize("kernel,jax_kernel", [
    ("xla", "xla"), ("pallas_fused", "pallas_fused"), ("pallas", "xla")])
def test_drive_ensemble_matches_jax_and_each_solo_run(jax_runs, kernel,
                                                      jax_kernel):
    before = dict(pipeline.LAUNCHES)
    world, keys, chain, states, extras = port_ensemble(kernel)
    assert pipeline.LAUNCHES == before  # CPU tensors: plain versions
    assert keys.tolist() == np.asarray(
        jax.random.key_data(jax_runs["keys"])).tolist()
    assert_worlds_equal(jax_runs[jax_kernel], (states, extras), kernel)
    totals = extras[2].tolist()
    assert all(t > 0 for t in totals), totals  # every world is live
    digests = set()
    for b in range(W):
        solo = telastic.drive_chained_windows(
            world["state"], (keys[b], torch.full((N,), SPAWN_BASE,
                                                 dtype=torch.int32),
                             torch.zeros((), dtype=torch.int32)),
            chain, n_rounds=ROUNDS, chain_len=CHAIN_LEN)
        mine = telastic.world_slice((states, extras), b)
        assert convert.state_digest(solo[0]) == convert.state_digest(
            mine[0]), (kernel, b)
        assert [int(x.sum()) for x in solo[1][1:]] == \
            [int(x.sum()) for x in mine[1][1:]], (kernel, b)
        digests.add(convert.state_digest(mine[0]))
    assert len(digests) == W  # the world keys separate the worlds


def aqm_chain_fn(params, window, kernel):
    """The port's twin of `jax_chain_fn(router_aqm=True)`."""
    def chain_fn(state, extras, r0, r1):
        key, spawn_seq, total = extras
        n = state.in_src.shape[0]
        for r in range(r0, r1):
            out = tplane.window_step(state, params, key,
                                     0 if r == 0 else window, window,
                                     rr_enabled=False, router_aqm=True,
                                     kernel=kernel)
            state, delivered, _nx = out
            mask, dst, nbytes, seq, ctrl = trespawn(
                delivered, spawn_seq, r, n, delivered["mask"].shape[1])
            (state,), *_ = tplane.unpack_planes(tplane.ingest_rows(
                state, dst, nbytes, seq, seq, ctrl, mask), n_lead=1)
            spawn_seq = spawn_seq + mask.sum(dim=1, dtype=torch.int32)
            total = total + mask.sum(dtype=torch.int32)
        zeros = torch.zeros_like(spawn_seq)
        return state, (key, spawn_seq, total), zeros, zeros
    return chain_fn


@pytest.mark.parametrize("kernel", ["xla", "pallas_fused", "pallas"])
def test_router_aqm_ensemble_matches_jax(jax_runs, kernel):
    """The router AQM world (400 kbit/s downlinks: the relay caches and
    CoDel drops) under drive_ensemble, against JAX's on "xla"; kernel E
    and the placement kernels through their vmap rules."""
    jout, (tparams, tst) = jax_runs["aqm"]
    keys = telastic.world_keys(prims.key_tensor(5), range(W))
    states, extras = telastic.drive_ensemble(
        telastic.stack_worlds(tst, W),
        (keys, torch.full((W, 16), SPAWN_BASE, dtype=torch.int32),
         torch.zeros(W, dtype=torch.int32)),
        aqm_chain_fn(tparams, 10 * MS, kernel), n_rounds=8,
        chain_len=CHAIN_LEN)
    (jst, jex) = jout
    for b in range(W):
        assert_states_equal(
            jax_state_to_numpy(jax.tree.map(lambda x: x[b], jst)),
            convert.state_to_numpy(telastic.world_slice(states, b)),
            (kernel, b))
    assert np.array_equal(np.asarray(jex[2]), extras[2].numpy())
    assert int(states.router.dropped.sum()) > 0 or bool(
        states.router.has_cached.any()), "the AQM did nothing: dead test"


# -- each kernel's vmap rule -----------------------------------------------


# the plain version each kernel's op runs on CPU tensors, and the module
# it is looked up in at call time
OP_PLAIN = {"egress_rank": (pipeline, "egress_rank_plain"),
            "egress_gate": (pipeline, "egress_gate_plain"),
            "route_place": (pipeline, "place_plain"),
            "route_scatter": (pipeline, "place_plain"),
            "router_drain": (codel, "router_drain_plain")}


@pytest.mark.parametrize("name", BATCHED_KERNELS)
def test_kernel_vmap_rule_folds_the_worlds_into_one_call(monkeypatch, name):
    """Each kernel's op under `torch.func.vmap` over 3 distinct worlds
    (seeds 1-3; for B and D with rows that overflow and rows that read
    outside the arrivals): the op runs once, on the worlds folded into
    3 * N rows (B and D told N rows a world), and each world's outputs
    equal its own plain run; B and D write the rings in place."""
    n, W3 = 16, 3
    wrapper, plain, args, in_dims, mutated = batched_kernel_case(
        name, n, (1, 2, 3), "cpu")
    clone = lambda: tuple(a.clone() if i in mutated else a
                          for i, a in enumerate(args))
    per_world = [flat_outputs(plain(*(
        telastic.world_slice(a, w) if d == 0 else a
        for a, d in zip(clone(), in_dims)))) for w in range(W3)]
    module, plain_name = OP_PLAIN[name]
    real, calls = getattr(module, plain_name), []

    def spy(*a, **kw):
        calls.append((a[0].shape[0], kw.get("world_rows")))
        return real(*a, **kw)

    monkeypatch.setattr(module, plain_name, spy)
    before = dict(pipeline.LAUNCHES)
    mine = clone()
    got = flat_outputs(torch.func.vmap(wrapper, in_dims=in_dims)(*mine))
    assert calls == [(W3 * n, n if mutated else None)]
    assert pipeline.LAUNCHES == before  # CPU tensors: no launch
    assert len(got) == len(per_world[0])
    for i, g in enumerate(got):
        want = torch.stack([p[i] for p in per_world])
        assert g.dtype == want.dtype and torch.equal(g, want), (name, i)
    for i in mutated:
        assert torch.equal(mine[i], got[i - 9])  # written in place
    assert any(not torch.equal(g[0], g[1]) for g in got)  # distinct worlds


def test_router_drain_vmap_rule_takes_shared_rates():
    """Kernel E with the rates and caps shared by the worlds (in_dim
    None), as an ensemble's params are: repeated for each world."""
    wrapper, plain, (arrival, size, rate, cap, state), _d, _m = \
        batched_kernel_case("router_drain", 12, (7, 8, 9), "cpu")
    got = flat_outputs(torch.func.vmap(wrapper, in_dims=(0, 0, None, None,
                                                         0))(
        arrival, size, rate[0], cap[0], state))
    for w in range(3):
        want = flat_outputs(plain(arrival[w], size[w], rate[0], cap[0],
                                  telastic.world_slice(state, w)))
        for g, r in zip(got, want):
            assert torch.equal(g[w], r), w


# -- percentiles, spans, checkpoints, the bench ----------------------------


def test_ensemble_percentiles_match_jax():
    rng = np.random.default_rng(3)
    counts = [rng.integers(0, 50, 32) for _ in range(5)]
    counts.append(np.zeros(32, np.int64))  # an empty world counts as 0
    for ws in (counts[:1], counts[:2], counts):
        assert thisto.ensemble_percentiles(ws) == \
            jhisto.ensemble_percentiles(ws)
    as_tensor = torch.from_numpy(np.stack(counts))
    assert thisto.ensemble_percentiles(as_tensor) == \
        jhisto.ensemble_percentiles(counts)
    with pytest.raises(ValueError):
        thisto.ensemble_percentiles([])
    with pytest.raises(ValueError):
        jhisto.ensemble_percentiles([])


def test_one_ensemble_span_a_chain_with_jax_fields(jax_runs):
    tracer = RunTracer("ens", backend={"platform": "cpu"})
    port_ensemble("xla", tracer=tracer)
    spans = [r for r in tracer.records if r["kind"] == "span"]
    want = jax_runs["spans"]
    assert [(s["r0"], s["r1"], s["mode"]) for s in spans] == \
        [(s["r0"], s["r1"], s["mode"]) for s in want] == \
        [(0, 4, "ensemble"), (4, 8, "ensemble"), (8, 12, "ensemble")]
    assert [sorted(s) for s in spans] == [sorted(s) for s in want]


def test_ensemble_checkpoint_resumes_and_crosses_packages(jax_runs,
                                                          tmp_path):
    """Checkpointed every 4 rounds, "killed" after round 8 and resumed
    from the round-8 file: the uninterrupted end. The file equals JAX's
    array for array (the key leaf's uint32 words at its path too) and
    resumes in JAX, and JAX's resumes here."""
    full_states, full_extras = port_ensemble("xla")[3:]
    ck = trunstate.RunCheckpointer(str(tmp_path), every=EVERY, label="ens",
                                   key_paths=KEY_PATHS)
    world, keys, chain, states, extras = port_ensemble("xla",
                                                       checkpointer=ck)
    assert ck.saved == 2  # r4 and r8; r12 is the end
    uninterrupted = convert.digest_pytrees(full_states, full_extras[1],
                                           full_extras[2])
    assert convert.digest_pytrees(states, extras[1], extras[2]) == \
        uninterrupted
    path = trunstate.latest_checkpoint(str(tmp_path), label="ens")
    template = (telastic.stack_worlds(world["state"], W), port_extras(keys))

    def resume_port(p):
        res = trunstate.resume_carry(p, template, key_paths=KEY_PATHS)
        assert res["round"] == 8
        st, ex = telastic.drive_ensemble(
            *res["carry"], chain, n_rounds=ROUNDS, chain_len=CHAIN_LEN,
            start_round=res["round"])
        return convert.digest_pytrees(st, ex[1], ex[2])

    assert resume_port(path) == uninterrupted
    assert resume_port(jax_runs["ckpt"]) == uninterrupted

    mine = np.load(path)
    theirs = np.load(jax_runs["ckpt"])
    carry = sorted(k for k in theirs.files if k.startswith("carry."))
    assert carry == sorted(k for k in mine.files if k.startswith("carry."))
    for k in carry:
        assert mine[k].dtype == theirs[k].dtype, k
        assert mine[k].shape == theirs[k].shape and np.array_equal(
            mine[k], theirs[k]), k
    assert mine[KEY_PATHS[0]].dtype == np.uint32
    assert mine[KEY_PATHS[0]].shape == (W, 2)

    w = jax_world()
    jres = jrunstate.resume_carry(path, (jax_stacked(w["state"]),
                                         jax_extras(jax_runs["keys"])))
    jst, jex = jelastic.drive_ensemble(
        *jres["carry"], jax_chain_fn(w["params"], w["window"], "xla"),
        n_rounds=ROUNDS, chain_len=CHAIN_LEN, start_round=jres["round"])
    assert_worlds_equal((jst, jex), (full_states, full_extras), "resumed")


def _jax_worlds_keys() -> set:
    """The keys of the record `bench.py`'s `bench_tpu_worlds` returns."""
    tree = ast.parse((REPO / "bench.py").read_text(encoding="utf-8"))
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "bench_tpu_worlds")
    ret = next(n for n in fn.body if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def test_bench_worlds_prints_jax_worlds_record(monkeypatch, capsys):
    """`bench --worlds 2` at a small width on the CPU: the JSON line's
    `worlds` record carries JAX's keys, with W worlds' events."""
    small = dict(n_nodes=8, egress_cap=8, ingress_cap=16, rounds=8,
                 device="cpu")
    run_phold, run_worlds = bench.run_phold, bench.run_worlds
    monkeypatch.setattr(bench, "run_phold", lambda **kw: run_phold(
        64, **{**kw, **small}))
    monkeypatch.setattr(bench, "run_worlds", lambda w, **kw: run_worlds(
        w, 64, chain_len=4, **{**kw, **small}))
    bench.main(["--kernel", "xla", "--worlds", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    worlds = rec["worlds"]
    assert _jax_worlds_keys() == {
        "n_worlds", "driver", "chain_len", "events", "min_world_events",
        "events_per_sec_sum", "amortization_vs_solo"}
    assert _jax_worlds_keys() <= set(worlds)
    assert worlds["n_worlds"] == 2 and worlds["driver"] == "drive_ensemble"
    assert worlds["kernel"] == "xla" and worlds["chain_len"] == 4
    assert len(worlds["world_events"]) == 2
    assert worlds["events"] == sum(worlds["world_events"])
    assert worlds["min_world_events"] == min(worlds["world_events"]) > 0
    assert worlds["amortization_vs_solo"] > 0

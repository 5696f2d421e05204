"""The split kernel pair of the port, kernels C and D, against the JAX
package, bitwise.

On the CPU the wrappers `egress_order_gate` (kernel C) and `scatter`
(kernel D, inside the routing stage `route_scatter`) run their plain
PyTorch versions. Kernel C is held against `shadow_tpu.tpu.pallas_egress`
in Pallas interpret mode. Kernel D's Pallas reference does not run on
this JAX (it calls `pl.load`), so the routing stage is held against the
XLA `plane._route_scatter(packed_sort=True)`, and the port's
`window_step(kernel="pallas")` against the JAX `window_step(kernel=
"xla")`: the JAX package makes its "pallas" and "xla" paths bitwise
identical, garbage lanes included (tests/test_plane_sortdiet.py). Also
the split path's golden PHOLD digest, the step's and wrappers' refusals,
and the build's header hashing.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from test_torch_plane import RNG_SEED, both_worlds  # noqa: E402
from torch_parity import (EDGE_SHIFTS, NO_CLAMP,  # noqa: E402
                          assert_states_equal, gate_edge_columns,
                          jax_state_to_numpy)

from shadow_tpu.tpu import pallas_egress  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu_torch import _build, bench, convert  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

NO_CLAMP = -(2**30)
MS = 1_000_000


def gate_columns(n, ce, seed):
    """Random egress rows: duplicate priorities, invalid lanes with
    garbage payloads, NO_CLAMP and real clamps, starved buckets."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(
        valid=rng.random((n, ce)) < 0.7,
        prio=i32(rng.integers(0, 6, (n, ce))),
        nbytes=i32(rng.integers(60, 1500, (n, ce))),
        tsend=i32(rng.integers(-20 * MS, 10 * MS, (n, ce))),
        clamp=i32(np.where(rng.random((n, ce)) < 0.5, NO_CLAMP,
                           rng.integers(-5 * MS, 20 * MS, (n, ce)))),
        balance=i32(rng.integers(0, ce * 900, n)),
    )


def assert_outputs_equal(ref, got):
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        assert r.dtype == g.numpy().dtype, (i, r.dtype, g.dtype)
        assert np.array_equal(r, g.numpy()), i


@pytest.mark.parametrize("ce", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("shift", [0, 10 * MS])
def test_egress_order_gate_matches_pallas(ce, shift):
    before = dict(pipeline.LAUNCHES)
    cols = gate_columns(24, ce, seed=ce)
    ref = pallas_egress.egress_order_gate(
        *(jnp.asarray(v) for v in cols.values()), jnp.int32(shift))
    got = pipeline.egress_order_gate(
        *(torch.from_numpy(v) for v in cols.values()), shift)
    assert_outputs_equal(ref, got)
    assert np.asarray(ref[5]).any() and not np.asarray(ref[5]).all(), \
        "the token gate neither sent nor held anything: dead case"
    # the CPU path runs the plain version: no kernel launch is counted
    assert pipeline.LAUNCHES == before


@pytest.mark.parametrize("ce", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("n", [24, 37])
@pytest.mark.parametrize("shift", EDGE_SHIFTS)
def test_egress_gate_plain_matches_pallas_on_edge_values(n, ce, shift):
    """Kernel C's plain version against the Pallas kernel at the edges of
    int32 (`torch_parity.gate_edge_columns`): the wrapping rebase and
    prefix sum, NO_CLAMP, negative priorities on the validity bit, all-
    valid, all-invalid and all-tied rows, negative balances."""
    cols = gate_edge_columns(n, ce, seed=1000 * n + ce)
    ref = pallas_egress.egress_order_gate(
        *(jnp.asarray(v) for v in cols.values()), jnp.int32(shift))
    got = pipeline.egress_gate_plain(
        *(torch.from_numpy(v) for v in cols.values()), shift)
    assert_outputs_equal(ref, got)
    valid, prio = cols["valid"], cols["prio"]
    # the cases the generator aims at are there
    assert (valid & (prio < 0)).any(), "no valid slot with a negative prio"
    ts, cl = cols["tsend"].astype(np.int64), cols["clamp"].astype(np.int64)
    wraps = lambda x: ((x - shift < -2**31) | (x - shift >= 2**31))
    assert (valid & wraps(ts)).any() and \
        (valid & (cl != NO_CLAMP) & wraps(cl)).any(), "no rebase wraps"
    cum = np.cumsum(np.where(np.asarray(ref[4]), np.asarray(ref[1]), 0),
                    axis=1, dtype=np.int64)
    assert (cum >= 2**31).any(), "no prefix sum passes 2^31"
    sendable = np.asarray(ref[5])
    assert sendable.any() and not sendable.all(), "dead token gate"


def routing_inputs(n, ce, ci, seed):
    """A routed window: random egress rows with duplicate seqs (the
    (seq, column) tiebreak), a sent subset with in-range and
    out-of-range destinations, and compacted ingress rows (front-packed,
    garbage behind)."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    dst = i32(rng.integers(0, n, (n, ce)))
    dst[0, :2] = [-1, n]
    sent = rng.random((n, ce)) < 0.8
    n_valid_in = i32(rng.integers(0, ci + 1, n))
    in_valid = np.arange(ci)[None, :] < n_valid_in[:, None]
    in_deliver = i32(np.where(in_valid, np.sort(rng.integers(
        -MS, 40 * MS, (n, ci)), axis=1), 2**31 - 1))
    garbage = lambda: i32(rng.integers(-9, 500, (n, ci)))
    return (sent, dst, i32(rng.integers(0, 2 * ce, (n, ce))),
            i32(rng.integers(60, 1500, (n, ce))),
            i32(rng.integers(0, 40, (n, ce))),
            i32(rng.integers(-MS, 30 * MS, (n, ce))), in_deliver, garbage(),
            garbage(), garbage(), garbage(), in_valid, n_valid_in)


@pytest.mark.parametrize("ce,ci", [(8, 4), (16, 32), (32, 32)])
def test_route_scatter_matches_xla_route_scatter(ce, ci):
    """(8, 4) is the overflow case: a 4-slot ring overflows."""
    args = routing_inputs(16, ce, ci, seed=ce + ci)
    ref = jplane._route_scatter(*(jnp.asarray(a) for a in args),
                                packed_sort=True)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    before = dict(pipeline.LAUNCHES)
    assert_outputs_equal(ref, pipeline.route_scatter(*targs))
    assert_outputs_equal(ref, pipeline.route_scatter(*targs, plain=True))
    assert pipeline.LAUNCHES == before
    if ci == 4:
        assert int(np.asarray(ref[-1]).sum()) > 0, "no overflow: dead case"


def run_split_vs_xla(windows, **kw):
    """The port's kernel="pallas" step against the JAX XLA step, leaf by
    leaf, every delivered column and the next-event scalar."""
    (params, jst), (tparams, tst) = both_worlds(**kw.pop("world", {}))
    key = jax.random.key(RNG_SEED)
    step = jax.jit(lambda s, sh: jplane.window_step(
        s, params, key, sh, jnp.int32(10 * MS), rr_enabled=False,
        kernel="xla", **kw))
    shift = 0
    for w in range(windows):
        jst, jd, jn = step(jst, jnp.int32(shift))
        tst, td, tn = tplane.window_step(tst, tparams, RNG_SEED, shift,
                                         10 * MS, rr_enabled=False,
                                         kernel="pallas", **kw)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        assert jd.keys() == td.keys()
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
        assert int(jn) == int(tn), w
        shift = 10 * MS
    return jax_state_to_numpy(jst)


@pytest.mark.parametrize("no_loss", [False, True])
def test_split_window_steps_match_xla(no_loss):
    final = run_split_vs_xla(4, no_loss=no_loss)
    assert final["n_sent"].sum() > 0 and final["n_delivered"].sum() > 0
    if not no_loss:
        assert final["n_loss_dropped"].sum() > 0, "no loss drawn: dead test"


def test_split_window_steps_with_ingress_overflow():
    final = run_split_vs_xla(3, world=dict(ingress_cap=4, loss=0.0,
                                           seed=11))
    assert final["n_overflow_dropped"].sum() > 0, "no overflow: dead test"


def test_split_golden_phold_digest():
    """The three JAX kernels agree bitwise, so the split path ends in the
    fused path's golden state."""
    g = dict(bench.GOLDEN_PHOLD)
    res = bench.run_phold(g.pop("n_hosts"), rounds=g.pop("rounds"),
                          warmup=False, device="cpu", kernel="pallas", **g)
    assert convert.state_digest(res["state"]) == bench.GOLDEN_PHOLD_DIGEST
    assert res["kernel"] == {"requested": "pallas", "used": "pallas"}


def test_split_path_refusals():
    (_p, _j), (tparams, tst) = both_worlds()
    step = lambda st, **kw: tplane.window_step(st, tparams, 0, 0, MS, **kw)
    # the router AQM is no refusal: it runs after the split pair too
    out = step(tst, rr_enabled=False, kernel="pallas", router_aqm=True)
    assert out[1]["mask"].shape[1] == tst.in_src.shape[1] + 1
    with pytest.raises(ValueError, match="unknown plane kernel"):
        step(tst, rr_enabled=False, kernel="mosaic")
    with pytest.raises(ValueError, match="FIFO"):
        step(tst, rr_enabled=True, kernel="pallas")
    narrow = tst._replace(**{f: getattr(tst, f)[:, :6].contiguous()
                             for f in tst._fields if f.startswith("eg_")})
    with pytest.raises(ValueError, match="power-of-two"):
        step(narrow, rr_enabled=False, kernel="pallas")
    with pytest.raises(ValueError, match="kernel"):
        bench.run_phold(8, rounds=1, device="cpu", kernel="mosaic")
    with pytest.raises(ValueError, match="capacity"):
        bench.run_phold(8, rounds=1, device="cpu", capacity="loose")

    cols = {k: torch.from_numpy(v) for k, v in
            gate_columns(4, 8, seed=0).items()}
    wide = dict(cols, prio=cols["prio"].to(torch.int64))
    with pytest.raises(TypeError, match="prio"):
        pipeline.egress_order_gate(*wide.values(), 0)
    meta = {k: v.to("meta") for k, v in cols.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.egress_order_gate(*meta.values(), 0)
    args = [torch.from_numpy(np.array(a)) for a in routing_inputs(8, 8, 8, 1)]
    args[7] = args[7].repeat(1, 2)[:, ::2]  # a strided base column
    with pytest.raises(ValueError, match="contiguous"):
        pipeline.route_scatter(*args)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """Editing a header that a kernel source includes names a new
    library, so a stale build is never loaded; a header it does not
    include changes nothing."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources("egress_gate")] == [
        "egress_gate.cu", "row_bitonic.cuh"]
    before = {n: _build._library_path(n) for n in _build.SIGNATURES}
    header = tmp_path / "row_bitonic.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.SIGNATURES}
    for name in ("egress_rank", "egress_gate"):
        assert after[name] != before[name], name
    for name in ("route_place", "route_scatter"):
        assert after[name] == before[name], name
    # kernels B and D share csrc/ring_place.cuh
    assert [p.name for p in _build._sources("route_scatter")] == [
        "route_scatter.cu", "ring_place.cuh"]
    header = tmp_path / "ring_place.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    again = {n: _build._library_path(n) for n in _build.SIGNATURES}
    for name in ("route_place", "route_scatter"):
        assert again[name] != after[name], name
    for name in ("egress_rank", "egress_gate"):
        assert again[name] == after[name], name


@pytest.mark.parametrize("ce", [1, 2048])
def test_egress_kernels_take_every_width_jax_takes(ce):
    """Kernels A and C at a row of one slot and at one wider than 1024
    (the kernels' wide build on the card), both widths JAX's Pallas
    kernels take: the port's wrappers (the plain versions on the CPU)
    against JAX's `egress_rank_stage` and `egress_order_gate` in
    interpret mode, on random rows and on the int32 edge rows, every
    output bitwise; no launch and no build counted."""
    from test_torch_pipeline import egress_columns

    from shadow_tpu.tpu import pallas_pipeline

    before = [dict(d) for d in (pipeline.LAUNCHES, pipeline.A_BUILD_LAUNCHES,
                                pipeline.C_BUILD_LAUNCHES)]
    cols = egress_columns(8, ce, seed=ce)
    shift = 10 * MS
    ref = pallas_pipeline.egress_rank_stage(
        *(jnp.asarray(v) for v in cols.values()), jnp.int32(shift))
    got = pipeline.egress_rank_stage(
        *(torch.from_numpy(v) for v in cols.values()), shift)
    assert_outputs_equal(ref, got)
    edge = gate_edge_columns(12, ce, seed=ce + 1)
    for case in (gate_columns(8, ce, seed=ce), edge):
        ref = pallas_egress.egress_order_gate(
            *(jnp.asarray(v) for v in case.values()), jnp.int32(shift))
        got = pipeline.egress_order_gate(
            *(torch.from_numpy(v) for v in case.values()), shift)
        assert_outputs_equal(ref, got)
    sendable = np.asarray(ref[5])
    assert sendable.any() and not sendable.all(), "dead token gate"
    assert [dict(d) for d in (pipeline.LAUNCHES, pipeline.A_BUILD_LAUNCHES,
                              pipeline.C_BUILD_LAUNCHES)] == before


def test_egress_checks_take_powers_of_two_only():
    """`_egress_checks` and the routing stage take what JAX takes: any
    power of two, one slot included, and refuse the rest."""
    for ce in (1, 2, 2048, 1 << 16):
        valid = torch.zeros((2, ce), dtype=torch.bool)
        cols = dict(valid=valid, prio=torch.zeros((2, ce), dtype=torch.int32))
        assert pipeline._egress_checks(valid, cols, torch.zeros(
            2, dtype=torch.int32))[1] == ce
    for bad in (0, 3, 6, 1536):
        with pytest.raises(ValueError, match="power-of-two"):
            pipeline._require_pow2(bad, "egress capacity")
    assert not hasattr(pipeline, "MAX_EGRESS_CAP")

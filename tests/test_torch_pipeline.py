"""Kernels A and B of the port against the Pallas pipeline, bitwise.

On the CPU the wrappers `egress_rank_stage` and `route_place` run their
plain PyTorch versions; the reference is
`shadow_tpu.tpu.pallas_pipeline` in Pallas interpret mode. Every output
is compared (12 of kernel A, 7 of the route-place stage), garbage lanes
included, across egress widths, with and without ingress overflow. Also
pins kernel B's plain version against the padded-stream placement the
routing stage used to materialise, its in-place contract (and that the
window step writes nothing a chain starts from), and the wrappers'
refusals.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import placement_inputs  # noqa: E402

from shadow_tpu.tpu import pallas_pipeline  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.tpu.profiling import RNG_SEED, build_world  # noqa: E402

NO_CLAMP = -(2**30)
I32_MAX = 2**31 - 1
MS = 1_000_000


def egress_columns(n, ce, seed):
    """Random egress rows: duplicate priorities and seqs, invalid lanes
    with garbage payloads, NO_CLAMP and real clamps, starved buckets."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(
        valid=rng.random((n, ce)) < 0.7,
        prio=i32(rng.integers(0, 6, (n, ce))),
        nbytes=i32(rng.integers(60, 1500, (n, ce))),
        tsend=i32(rng.integers(-20 * MS, 10 * MS, (n, ce))),
        clamp=i32(np.where(rng.random((n, ce)) < 0.5, NO_CLAMP,
                           rng.integers(-5 * MS, 20 * MS, (n, ce)))),
        dst=i32(rng.integers(-1, n, (n, ce))),
        seq=i32(rng.integers(0, 3 * ce, (n, ce))),
        sock=i32(rng.integers(0, 40, (n, ce))),
        ctrl=rng.random((n, ce)) < 0.2,
        balance=i32(rng.integers(0, ce * 900, n)),
    )


def run_egress(cols, shift):
    ref = pallas_pipeline.egress_rank_stage(
        *(jnp.asarray(v) for v in cols.values()), jnp.int32(shift))
    got = pipeline.egress_rank_stage(
        *(torch.from_numpy(v) for v in cols.values()), shift)
    return ref, got


def assert_outputs_equal(ref, got):
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        assert r.dtype == g.numpy().dtype, (i, r.dtype, g.dtype)
        assert np.array_equal(r, g.numpy()), i


@pytest.mark.parametrize("ce", [8, 16, 32])
def test_egress_rank_stage_matches_pallas(ce):
    before = dict(pipeline.LAUNCHES)
    cols = egress_columns(24, ce, seed=ce)
    for shift in (0, 10 * MS):
        ref, got = run_egress(cols, shift)
        assert_outputs_equal(ref, got)
    # the CPU path runs the plain version: no kernel launch is counted
    assert pipeline.LAUNCHES == before


def route_inputs(n, ce, ci, seed, garbage_deliver=False):
    """A routed window: kernel A's outputs for random egress rows, a
    random sent subset with in-range and out-of-range destinations, and
    compacted ingress rows (front-packed, garbage behind). The deliver
    column of an invalid slot is I32_MAX, as the compaction leaves it,
    or with `garbage_deliver` random, so the stage's select binds."""
    rng = np.random.default_rng(seed)
    cols = egress_columns(n, ce, seed)
    cols["dst"] = np.asarray(rng.integers(0, n, (n, ce)), np.int32)
    cols["dst"][0, :2] = [-1, n]
    (_p, sock, dst, nbytes, seq, _c, _t, _cl, valid, _s, _sp,
     row_perm) = pallas_pipeline.egress_rank_stage(
        *(jnp.asarray(v) for v in cols.values()), jnp.int32(0))
    sent = np.asarray(valid) & (rng.random((n, ce)) < 0.8)
    deliver = np.asarray(rng.integers(-MS, 30 * MS, (n, ce)), np.int32)
    n_valid_in = np.asarray(rng.integers(0, ci + 1, n), np.int32)
    lane = np.arange(ci)[None, :]
    in_valid = lane < n_valid_in[:, None]
    in_deliver = np.where(in_valid, np.sort(rng.integers(
        -MS, 40 * MS, (n, ci)), axis=1), 2**31 - 1).astype(np.int32)
    garbage = lambda: np.asarray(rng.integers(-9, 500, (n, ci)), np.int32)
    if garbage_deliver:
        in_deliver = np.where(in_valid, in_deliver, garbage())
    return (sent, np.asarray(dst), np.asarray(seq), np.asarray(nbytes),
            np.asarray(sock), deliver, in_deliver, garbage(), garbage(),
            garbage(), garbage(), in_valid, n_valid_in, np.asarray(row_perm))


@pytest.mark.parametrize("ce,ci", [(8, 16), (16, 32), (32, 32), (8, 4)])
def test_route_place_matches_pallas(ce, ci):
    """(8, 4) is the overflow case: a 4-slot ring overflows."""
    args = route_inputs(16, ce, ci, seed=ce + ci)
    ref = pallas_pipeline.route_place(*(jnp.asarray(a) for a in args))
    got = pipeline.route_place(*(torch.from_numpy(np.array(a)) for a in args))
    assert_outputs_equal(ref, got)
    if ci == 4:
        assert int(np.asarray(ref[-1]).sum()) > 0, "no overflow: dead case"


@pytest.mark.parametrize("ce,ci", [(8, 16), (16, 32), (8, 4)])
def test_route_place_matches_pallas_on_garbage_deliver(ce, ci):
    """Invalid ingress slots carry a random deliver: the select that
    sets it to I32_MAX (in the JAX stage, in the port's placement) binds
    on every unplaced one of them."""
    args = route_inputs(16, ce, ci, seed=3 * ce + ci, garbage_deliver=True)
    in_deliver, in_valid = args[6], args[11]
    assert (~in_valid & (in_deliver != I32_MAX)).sum() > ci, \
        "no invalid slot carries a deliver to rewrite: dead case"
    ref = pallas_pipeline.route_place(*(jnp.asarray(a) for a in args))
    got = pipeline.route_place(*(torch.from_numpy(np.array(a)) for a in args))
    assert_outputs_equal(ref, got)
    placed_or_valid = got[5].numpy()  # the merged ingress valid column
    assert (got[4].numpy()[~placed_or_valid] == I32_MAX).all()


def padded_stream_placement(args):
    """The placement as the routing stage computed it around the TPU
    kernel (`pallas_pipeline.route_place` and `_place_kernel`): five
    arrival-sorted streams gathered through the composed permutation and
    padded by CI on both sides, read at clip(lo + c + CI, 0, B2 - 1), and
    the base deliver of an invalid slot replaced by I32_MAX."""
    (nv, offsets, take, o_pos, row_perm, seq, sock, nbytes, deliver,
     b_src, b_seq, b_sock, b_bytes, b_del, b_valid) = args
    n, ci = b_src.shape
    ce = row_perm.shape[1]
    src_row = o_pos // ce
    g = src_row * ce + row_perm.reshape(-1)[o_pos]
    pad = lambda a: np.pad(a, (ci, ci))
    streams = [pad(src_row.astype(np.int32))] + [
        pad(a.reshape(-1)[g]) for a in (seq, sock, nbytes, deliver)]
    ccol = np.arange(ci)[None, :]
    mask = (ccol >= nv[:, None]) & (ccol < (nv + take)[:, None])
    idx = np.clip((offsets - nv)[:, None] + ccol + ci, 0, n * ce + 2 * ci - 1)
    bases = (b_src, b_seq, b_sock, b_bytes, np.where(b_valid, b_del, I32_MAX))
    return [np.where(mask, s[idx], b) for s, b in zip(streams, bases)] + [
        mask | b_valid]


@pytest.mark.parametrize("n,ce,ci", [(32, 8, 4), (40, 16, 32), (24, 4, 64)])
def test_place_plain_matches_padded_stream_placement(n, ce, ci):
    args = placement_inputs(n, ce, ci, seed=n + ce + ci)
    nv, offsets, take = args[:3]
    ccol = np.arange(ci)[None, :]
    j = (offsets - nv)[:, None] + ccol
    placed = (ccol >= nv[:, None]) & (ccol < (nv + take)[:, None])
    assert (placed & (j < 0)).any() and (placed & (j >= n * ce)).any(), \
        "no placed slot reads outside the arrivals: dead edge case"
    assert (nv + take == ci).any(), "no row filled to the brim: dead case"
    ref = padded_stream_placement(args)
    got = pipeline.place_plain(*(torch.from_numpy(a.copy()) for a in args))
    assert_outputs_equal(ref, got)
    # the edge: every column of a placed slot reading outside is 0
    for col in got[:5]:
        assert not col.numpy()[placed & ((j < 0) | (j >= n * ce))].any()


def test_placement_updates_the_ingress_in_place():
    """The returned tensors are the ingress tensors given; slots that are
    not placed keep their bytes (deliver becomes I32_MAX where invalid);
    nothing else is written; a second call on the result changes
    nothing; aliased ingress tensors are refused."""
    args = [torch.from_numpy(a) for a in placement_inputs(48, 8, 16, seed=7)]
    before = [a.clone() for a in args]
    out = pipeline.place(*args)
    assert [o.data_ptr() for o in out] == [a.data_ptr() for a in args[9:]]
    for a, b in zip(args[:9], before[:9]):
        assert torch.equal(a, b)
    nv, take = before[0][:, None], before[2][:, None]
    ccol = torch.arange(16)
    kept = ~((ccol >= nv) & (ccol < nv + take))
    b_valid = before[14]
    for i in (9, 10, 11, 12):  # src, seq, sock, bytes
        assert torch.equal(out[i - 9][kept], before[i][kept])
    assert torch.equal(out[4][kept & b_valid], before[13][kept & b_valid])
    assert (out[4][kept & ~b_valid] == I32_MAX).all()
    assert torch.equal(out[5][kept], b_valid[kept])
    assert out[5][~kept].all()
    snapshot = [o.clone() for o in out]
    pipeline.place(*args)
    for a, b in zip(out, snapshot):
        assert torch.equal(a, b)
    aliased = list(args)
    aliased[10] = aliased[9]
    with pytest.raises(ValueError, match="distinct"):
        pipeline.place(*aliased)


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_window_step_writes_nothing_a_chain_starts_from(kernel):
    """The routing stage updates the window's compacted ingress in place;
    those are fresh tensors, so the state a window starts from is not
    written, and a window re-run from it (as the elastic driver re-runs a
    discarded chain) ends in the same state."""
    world = build_world(64, n_nodes=8, egress_cap=8, ingress_cap=8,
                        warmup_windows=2, device="cpu")
    st, params = world["state"], world["params"]
    state_ptrs = {t.data_ptr() for t in (*st, *st.router)
                  if isinstance(t, torch.Tensor)}
    compacted = tplane._compact_ingress(st, st.in_deliver_rel)
    assert not {t.data_ptr() for t in compacted} & state_ptrs
    digest = convert.state_digest(st)
    step = lambda: tplane.window_step(st, params, RNG_SEED, 10 * MS,
                                      10 * MS, rr_enabled=False,
                                      kernel=kernel)
    first, _d, _n = step()
    assert convert.state_digest(st) == digest
    again, _d, _n = step()
    assert convert.state_digest(again) == convert.state_digest(first)
    assert int(first.n_sent.sum()) > 0 and int(first.in_valid.sum()) > 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    cols = egress_columns(4, 8, seed=0)
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    bad_width = {k: (v[:, :6].contiguous() if v.dim() == 2 else v)
                 for k, v in tcols.items()}
    with pytest.raises(ValueError, match="power-of-two"):
        pipeline.egress_rank_stage(*bad_width.values(), 0)
    wrong_dtype = dict(tcols, prio=tcols["prio"].to(torch.int64))
    with pytest.raises(TypeError, match="prio"):
        pipeline.egress_rank_stage(*wrong_dtype.values(), 0)
    strided = dict(tcols, seq=torch.from_numpy(
        np.asarray(np.tile(cols["seq"], 2)))[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        pipeline.egress_rank_stage(*strided.values(), 0)
    # a device that is neither the CPU nor CUDA is refused, not run plain
    meta = {k: v.to("meta") for k, v in tcols.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.egress_rank_stage(*meta.values(), 0)

    args = [torch.from_numpy(np.array(a))
            for a in route_inputs(8, 8, 8, seed=1)]
    narrow = list(args)
    for i in range(6, 12):
        narrow[i] = args[i][:, :6].contiguous()
    with pytest.raises(ValueError, match="power-of-two"):
        pipeline.route_place(*narrow)

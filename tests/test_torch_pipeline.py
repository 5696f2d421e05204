"""Kernels A and B of the port against the Pallas pipeline, bitwise.

On the CPU the wrappers `egress_rank_stage` and `route_place` run their
plain PyTorch versions; the reference is
`shadow_tpu.tpu.pallas_pipeline` in Pallas interpret mode. Every output
is compared (12 of kernel A, 7 of the route-place stage), garbage lanes
included, across egress widths, with and without ingress overflow. Also
pins the wrappers' refusals.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shadow_tpu.tpu import pallas_pipeline  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402

NO_CLAMP = -(2**30)
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


def route_inputs(n, ce, ci, seed):
    """A routed window: kernel A's outputs for random egress rows, a
    random sent subset with in-range and out-of-range destinations, and
    compacted ingress rows (front-packed, garbage behind)."""
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

"""The metrics and histogram planes of the port against the JAX
package's, bitwise, and what rides with them: `ingest`/`ingest_rows`
with the planes, `unpack_planes`, `compact_delivered` and the histogram
bucket index.

Metrics go through all three kernels of the port. The JAX reference of
the port's "pallas_fused" is JAX's "pallas_fused" in interpret mode; of
"pallas" and "xla", JAX's "xla" (JAX's "pallas" needs `pl.load`, absent
from this JAX, ROADMAP.md queue C; the JAX package makes its kernels
bitwise identical). Histograms ride "xla" only, as in JAX. Both planes
leave the simulation state bitwise unchanged."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (MS, assert_tuples_equal,  # noqa: E402
                          jax_state_to_numpy, phold_both, rr_world)

from shadow_tpu.telemetry import histo as jhisto  # noqa: E402
from shadow_tpu.telemetry import make_histograms, make_metrics  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.telemetry import histo, metrics  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

WINDOWS = 6
JAX_KERNEL = {"pallas_fused": "pallas_fused", "pallas": "xla", "xla": "xla"}


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas", "xla"])
def test_metrics_match_jax_and_leave_state_unchanged(kernel):
    world = rr_world(16, 8, 4, rr_mix=False, seed=5)
    on, m, _h = phold_both(world, WINDOWS, kernel=kernel,
                           jax_kernel=JAX_KERNEL[kernel], metrics=True)
    off, _m, _h = phold_both(rr_world(16, 8, 4, rr_mix=False, seed=5),
                             WINDOWS, kernel=kernel,
                             jax_kernel=JAX_KERNEL[kernel])
    assert convert.state_digest(on) == convert.state_digest(off)
    assert int(m.windows) == WINDOWS and int(m.events) > 0
    assert int(m.drop_loss.sum()) > 0 and int(m.drop_ring_full.sum()) > 0
    assert int(m.bytes_in.sum()) > 0 and int(m.max_in_depth.max()) > 0


@pytest.mark.parametrize("rr_enabled", [False, True])
def test_histograms_match_jax_and_leave_state_unchanged(rr_enabled):
    world = rr_world(16, 8, 16, rr_mix=rr_enabled, seed=9)
    on, m, h = phold_both(world, WINDOWS, rr_enabled=rr_enabled,
                          metrics=True, hist=True)
    off, _m, _h = phold_both(rr_world(16, 8, 16, rr_mix=rr_enabled, seed=9),
                             WINDOWS, rr_enabled=rr_enabled)
    assert convert.state_digest(on) == convert.state_digest(off)
    for name in histo.hist_names():
        assert int(getattr(h, name).sum()) > 0, name
    # the sojourn histogram saw carried-over packets, not only fresh ones
    assert int(h.hist_sojourn_ns[:, 1:].sum()) > 0
    assert histo.fleet_percentiles(h.hist_delivery_ns) == \
        jhisto.fleet_percentiles(h.hist_delivery_ns.numpy())


def test_ingest_and_ingest_rows_with_planes():
    (_p, jst), (_tp, tst) = rr_world(8, 8, 8, seed=2)
    rng = np.random.default_rng(4)
    n, k = 8, 12
    cols = dict(dst=rng.integers(0, n, (n, k)).astype(np.int32),
                nbytes=rng.integers(100, 900, (n, k)).astype(np.int32),
                prio=rng.integers(0, 30, (n, k)).astype(np.int32),
                seq=rng.integers(100, 200, (n, k)).astype(np.int32),
                ctrl=rng.random((n, k)) < 0.3,
                valid=rng.random((n, k)) < 0.6)
    jm, jh = make_metrics(n), make_histograms(n)
    tm = metrics.make_metrics(n, device="cpu")
    th = histo.make_histograms(n, device="cpu")
    for planes in (dict(metrics=True), dict(hist=True),
                   dict(metrics=True, hist=True)):
        jkw = {p: {"metrics": jm, "hist": jh}[p] for p in planes}
        tkw = {p: {"metrics": tm, "hist": th}[p] for p in planes}
        ref = jplane.ingest_rows(
            jst, **{c: jnp.asarray(v) for c, v in cols.items()}, **jkw)
        got = tplane.ingest_rows(
            tst, **{c: torch.from_numpy(v) for c, v in cols.items()}, **tkw)
        assert len(ref) == len(got) == 1 + len(planes)
        (rs,), rm, _g, rh, _f = jplane.unpack_planes(ref, n_lead=1, **jkw)
        (gs,), gm, _g, gh, _f = tplane.unpack_planes(got, n_lead=1, **tkw)
        assert convert.state_digest(jax_state_to_numpy(rs)) == \
            convert.state_digest(gs)
        if "metrics" in planes:
            assert_tuples_equal(rm, gm)
            assert int(gm.drop_ring_full.sum()) > 0, "no overflow: dead case"
        if "hist" in planes:
            assert_tuples_equal(rh, gh)
    # the flat ingest with metrics
    b = 40
    flat = dict(src=np.repeat(np.arange(4, dtype=np.int32), 10),
                dst=rng.integers(0, n, b).astype(np.int32),
                nbytes=np.full(b, 500, np.int32),
                prio=np.zeros(b, np.int32), seq=np.arange(b, dtype=np.int32),
                ctrl=np.zeros(b, bool))
    jst2, jm2 = jplane.ingest(jst, **{c: jnp.asarray(v)
                                      for c, v in flat.items()}, metrics=jm)
    tst2, tm2 = tplane.ingest(tst, **{c: torch.from_numpy(v)
                                      for c, v in flat.items()}, metrics=tm)
    assert_tuples_equal(jm2, tm2)
    assert int(tm2.drop_ring_full.sum()) > 0
    assert convert.state_digest(jax_state_to_numpy(jst2)) == \
        convert.state_digest(tst2)


def test_unpack_planes_and_compact_delivered():
    (params, jst), (tparams, tst) = rr_world(8, 8, 8, rr_mix=False, seed=3)
    m = metrics.make_metrics(8, device="cpu")
    out = tplane.window_step(tst, tparams, 3, 0, 10 * MS, rr_enabled=False,
                             kernel="xla", metrics=m)
    (st, d, nx), m2, g, h, fr = tplane.unpack_planes(out, metrics=m)
    assert st is out[0] and m2 is out[3] and g is h is fr is None
    lead, *rest = tplane.unpack_planes(out, metrics=m, flows=None)
    assert len(rest) == 5 and rest[-1] is None
    with pytest.raises(TypeError, match="unclaimed"):
        tplane.unpack_planes(out)
    bare = tplane.ingest_rows(st, *(torch.zeros((8, 2), dtype=torch.int32)
                                    for _ in range(4)),
                              torch.zeros((8, 2), dtype=torch.bool),
                              torch.zeros((8, 2), dtype=torch.bool))
    assert tplane.unpack_planes(bare, n_lead=1)[0] == (bare,)

    # the second window delivers (the first clamps to its end)
    d = tplane.window_step(st, tparams, 3, 10 * MS, 10 * MS,
                           rr_enabled=False, kernel="xla")[1]
    key = jax.random.key(3)
    jout = jplane.window_step(jst, params, key, jnp.int32(0),
                              jnp.int32(10 * MS), rr_enabled=False)
    jout = jplane.window_step(jout[0], params, key, jnp.int32(10 * MS),
                              jnp.int32(10 * MS), rr_enabled=False)
    for cap in (1, 5, 64, 200):
        ref = jplane.compact_delivered(jout[1], cap)
        got = tplane.compact_delivered(d, cap)
        for r, g_ in zip(ref, got):
            r = np.asarray(r)
            assert r.dtype == g_.numpy().dtype and np.array_equal(
                r, g_.numpy()), cap
    assert int(got[0]) > 0, "nothing delivered: dead case"


def test_bucket_index_boundaries():
    edges = [0, -1, -(2**31), 2**31 - 1, 1, 2, 3]
    for k in range(1, 31):
        edges += [2**k - 1, 2**k, 2**k + 1]
    vals = np.array([v for v in edges if -(2**31) <= v < 2**31], np.int32)
    ref = np.asarray(jhisto.bucket_index(jnp.asarray(vals)))
    got = histo.bucket_index(torch.from_numpy(vals))
    assert np.array_equal(ref, got.numpy())
    want = [max(int(v), 1).bit_length() - 1 for v in vals]
    assert got.tolist() == want
    assert histo.percentiles(np.eye(32, dtype=np.int64)[5] * 7) == \
        jhisto.percentiles(np.eye(32, dtype=np.int64)[5] * 7)
    assert histo.bucket_edges(0) == (0, 2) and histo.bucket_edges(4) == (16, 32)

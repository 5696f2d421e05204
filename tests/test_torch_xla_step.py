"""The port's `window_step(kernel="xla")` against the JAX package's, bitwise:
the XLA egress stage (qdisc keys, the packed sort, the token gate, the
round-robin advance) and routing stage, over 8 PHOLD windows of a busy
world with a round-robin/FIFO qdisc mix, starved token buckets and loss.
Also the three kernels of the port on one world, and the step's
refusals."""

from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_parity import MS, phold_both, rr_world  # noqa: E402

from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.telemetry import histo  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

WINDOWS = 8


@pytest.mark.parametrize("ce,ci", [(8, 16), (16, 32)])
@pytest.mark.parametrize("no_loss", [False, True])
@pytest.mark.parametrize("rr_enabled", [False, True])
def test_xla_step_matches_jax(rr_enabled, no_loss, ce, ci):
    before = dict(pipeline.LAUNCHES)
    world = rr_world(16, ce, ci, rr_mix=rr_enabled, seed=ce + ci)
    final, _m, _h = phold_both(world, WINDOWS, rr_enabled=rr_enabled,
                               no_loss=no_loss)
    assert pipeline.LAUNCHES == before
    assert int(final.n_sent.sum()) > 0 and int(final.n_delivered.sum()) > 0
    assert bool(final.eg_valid.any()), "no egress backlog: dead test"
    if not no_loss:
        assert int(final.n_loss_dropped.sum()) > 0, "no loss: dead test"
    if rr_enabled:
        assert int(final.rr_sent.abs().sum()) > 0, "RR never ran: dead test"


@pytest.mark.parametrize("rr_enabled,router_aqm,metrics", [
    (True, False, True), (False, False, False), (True, True, False),
    (False, True, True)])
def test_xla_step_packed_sort_false_matches_jax(rr_enabled, router_aqm,
                                                metrics):
    """`window_step(packed_sort=False)` and `ingest_rows(packed_sort=
    False)` (JAX's pre-diet variadic sorts: the qdisc, ingress and egress
    compactions, the flat routing sort and scatters, the due release or
    the AQM keep sort) against JAX's with the same flag, window by
    window, with a round-robin/FIFO mix, the router AQM and the metrics
    plane in turn."""
    world = rr_world(16, 8, 16, rr_mix=rr_enabled, seed=29)
    final, _m, _h = phold_both(world, 6, rr_enabled=rr_enabled,
                               router_aqm=router_aqm, metrics=metrics,
                               packed_sort=False)
    assert int(final.n_sent.sum()) > 0 and int(final.n_delivered.sum()) > 0
    assert bool(final.eg_valid.any()), "no egress backlog: dead test"


def test_legacy_routing_drops_out_of_range_dst_as_jax():
    """A queued packet whose dst lies outside the hosts: JAX's legacy
    routing scatters it through an out-of-bounds index (dst >= N drops;
    a negative flat index counts from the end, as numpy's), where the
    packed path's not-placeable bucket would drop it uncounted. The
    port's `packed_sort=False` step follows the legacy path: equal to
    JAX's, state and delivered columns, over two windows."""
    import jax.numpy as jnp
    import numpy as np
    from torch_parity import assert_states_equal, jax_state_to_numpy

    from shadow_tpu.tpu.plane import window_step

    (params, jst), (tparams, tst) = rr_world(16, 8, 16, rr_mix=False,
                                             loss=0.0, seed=31)
    dst = np.asarray(jst.eg_dst).copy()
    dst[:4, :] = np.array([16, 40, -1, -3], np.int32)[:, None]
    jst = jst._replace(eg_dst=jnp.asarray(dst))
    tst = tst._replace(eg_dst=torch.from_numpy(dst))
    packed = tplane.window_step(tst, tparams, 3, 0, 10 * MS,
                                rr_enabled=False)[0]
    key = jax.random.key(3)
    for w in range(2):
        shift = 0 if w == 0 else 10 * MS
        jst, jd, jn = window_step(jst, params, key, jnp.int32(shift),
                                  jnp.int32(10 * MS), rr_enabled=False,
                                  packed_sort=False)
        tst, td, tn = tplane.window_step(tst, tparams, 3, shift, 10 * MS,
                                         rr_enabled=False, packed_sort=False)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        for k in jd:
            assert np.array_equal(np.asarray(jd[k]), td[k].numpy()), (w, k)
        assert int(jn) == int(tn)
        if w == 0:  # the legacy path placed what the packed one drops
            assert convert.state_digest(tst) != convert.state_digest(packed)


def test_three_kernels_agree():
    """On one FIFO world the port's "xla", "pallas_fused" and "pallas"
    steps end in the same state, delivered columns and next event."""
    ends = []
    for kernel in tplane.KERNELS:
        (_p, _j), (tparams, tst) = rr_world(16, 8, 8, rr_mix=False)
        shift = 0
        for _ in range(4):
            tst, td, tn = tplane.window_step(tst, tparams, 3, shift,
                                             10 * MS, rr_enabled=False,
                                             kernel=kernel)
            shift = 10 * MS
        ends.append((convert.state_digest(tst),
                     {k: v.clone() for k, v in td.items()}, int(tn)))
    digest, delivered, nxt = ends[0]
    assert int(delivered["mask"].sum()) > 0
    for d, dl, n in ends[1:]:
        assert d == digest and n == nxt
        assert all(torch.equal(dl[k], delivered[k]) for k in delivered)


def test_xla_step_refusals():
    (_p, _j), (tparams, tst) = rr_world(8, 8, 8)
    step = lambda **kw: tplane.window_step(tst, tparams, 0, 0, MS, **kw)
    # the router AQM is ported: "xla" runs it (tests/test_torch_router_aqm.py)
    out = step(kernel="xla", router_aqm=True)
    assert out[1]["mask"].shape == (8, tst.in_src.shape[1] + 1)
    # JAX's pre-diet sorts run on "xla" (the Pallas kernels refuse them,
    # tests/test_torch_plane.py), the same step as the packed sorts
    legacy = step(kernel="xla", packed_sort=False)
    packed = step(kernel="xla")
    assert convert.state_digest(legacy[0]) == convert.state_digest(packed[0])
    assert all(torch.equal(legacy[1][k], packed[1][k]) for k in packed[1])
    assert int(legacy[2]) == int(packed[2])
    hist = histo.make_histograms(8, device="cpu")
    for kernel in ("pallas_fused", "pallas"):
        with pytest.raises(ValueError, match="hist"):
            step(kernel=kernel, rr_enabled=False, hist=hist)

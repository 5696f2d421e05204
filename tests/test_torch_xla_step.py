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
    with pytest.raises(ValueError, match="packed"):
        step(kernel="xla", packed_sort=False)
    hist = histo.make_histograms(8, device="cpu")
    for kernel in ("pallas_fused", "pallas"):
        with pytest.raises(ValueError, match="hist"):
            step(kernel=kernel, rr_enabled=False, hist=hist)

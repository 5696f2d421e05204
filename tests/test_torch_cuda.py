"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: skipped where no CUDA card is present; run them on
one with `python -m pytest tests/test_torch_cuda.py -m cuda -q`.
`chip_smoke.py` holds the kernels to the same standard at the bench
shapes."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shadow_tpu_torch import bench, convert  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402

pytestmark = pytest.mark.cuda
MS = 1_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def egress_args(n, ce, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=np.int32: torch.from_numpy(np.asarray(a, dt)).to(device)
    return (t(rng.random((n, ce)) < 0.7, bool),
            t(rng.integers(0, 6, (n, ce))), t(rng.integers(60, 1500, (n, ce))),
            t(rng.integers(-20 * MS, 10 * MS, (n, ce))),
            t(np.where(rng.random((n, ce)) < 0.5, -(2**30),
                       rng.integers(0, 20 * MS, (n, ce)))),
            t(rng.integers(-1, n, (n, ce))), t(rng.integers(0, 3 * ce, (n, ce))),
            t(rng.integers(0, 40, (n, ce))), t(rng.random((n, ce)) < 0.2, bool),
            t(rng.integers(0, ce * 900, n)), 10 * MS)


@pytest.mark.parametrize("ce", [2, 4, 8, 16, 32, 64, 128, 1024])
def test_egress_rank_kernel_matches_plain(cuda, ce):
    args = egress_args(300, ce, cuda, seed=ce)
    before = pipeline.LAUNCHES["egress_rank"]
    got = pipeline.egress_rank_stage(*args)
    ref = pipeline.egress_rank_plain(*args)
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["egress_rank"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("ce", [2, 4, 8, 16, 32, 64, 128, 1024])
def test_egress_gate_kernel_matches_plain(cuda, ce):
    valid, prio, nbytes, tsend, clamp, _d, _s, _k, _c, balance, shift = \
        egress_args(300, ce, cuda, seed=ce)
    args = (valid, prio, nbytes, tsend, clamp, balance, shift)
    before = pipeline.LAUNCHES["egress_gate"]
    got = pipeline.egress_order_gate(*args)
    ref = pipeline.egress_gate_plain(*args)
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["egress_gate"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def placement_args(n, ce, ci, device, seed=0):
    """Kernel B's and D's inputs as the routing stage makes them: bucket
    segments that tile the N*CE arrival slots, rows whose arrivals
    overflow the ring, random streams and bases."""
    rng = np.random.default_rng(seed)
    nv = rng.integers(0, ci + 1, n)
    counts = rng.poisson(ce * 0.8, n)
    hot = rng.random(n) < 1 / 8
    counts[hot] += rng.integers(ci, 2 * ci, hot.sum())
    counts = np.minimum(counts, np.maximum(
        0, n * ce - (np.cumsum(counts) - counts)))
    offsets = np.cumsum(counts) - counts
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    b2 = n * ce + 2 * ci
    return (t(nv), t(offsets - nv), t(np.minimum(counts, ci - nv)),
            *(t(rng.integers(-2**31, 2**31 - 1, b2)) for _ in range(5)),
            *(t(rng.integers(-2**31, 2**31 - 1, (n, ci))) for _ in range(5)),
            torch.from_numpy(rng.random((n, ci)) < 0.5).to(device))


@pytest.mark.parametrize("ce,ci", [(8, 4), (16, 32), (64, 64)])
def test_route_scatter_kernel_matches_plain(cuda, ce, ci):
    args = placement_args(300, ce, ci, cuda, seed=ce + ci)
    before = pipeline.LAUNCHES["route_scatter"]
    got = pipeline.scatter(*args)
    ref = pipeline.scatter_plain(*args)
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["route_scatter"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_phold_golden_digest_on_the_card(cuda, kernel):
    g = dict(bench.GOLDEN_PHOLD)
    res = bench.run_phold(g.pop("n_hosts"), rounds=g.pop("rounds"),
                          warmup=False, device=cuda, kernel=kernel, **g)
    assert convert.state_digest(res["state"]) == bench.GOLDEN_PHOLD_DIGEST

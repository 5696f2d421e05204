"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: skipped where no CUDA card is present; run them on
one with `python -m pytest tests/test_torch_cuda.py -m cuda -q`.
`chip_smoke.py` holds the kernels to the same standard at the bench
shapes."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (EDGE_SHIFTS, gate_edge_columns,  # noqa: E402
                          placement_inputs)

from shadow_tpu_torch import bench, convert  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.workloads import runner, spec  # noqa: E402

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


@pytest.mark.parametrize("ce", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("n", [1, 37, 300, 4099])
def test_egress_gate_kernel_matches_plain_on_edge_values(cuda, n, ce):
    """Kernel C at the edges of int32 (`gate_edge_columns`: wrapping
    rebase and prefix sum, NO_CLAMP, negative priorities, all-valid,
    all-invalid and all-tied rows, negative balances), with both shifts,
    at row counts that leave a block tile ragged."""
    cols = gate_edge_columns(n, ce, seed=n + ce)
    for shift in EDGE_SHIFTS:
        args = (*(torch.from_numpy(v).to(cuda) for v in cols.values()),
                shift)
        got = pipeline.egress_order_gate(*args)
        ref = pipeline.egress_gate_plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r), (shift, n, ce)


def test_egress_gate_kernel_refuses_misaligned_columns(cuda):
    """Kernel C moves 16-byte vectors: a column that does not start on 16
    bytes is refused, not read."""
    valid, prio, nbytes, tsend, clamp, _d, _s, _k, _c, balance, shift = \
        egress_args(8, 16, cuda)
    shifted = torch.empty(8 * 16 + 1, dtype=torch.int32, device=cuda)
    shifted[1:] = prio.reshape(-1)
    before = pipeline.LAUNCHES["egress_gate"]
    with pytest.raises(ValueError, match="16 bytes"):
        pipeline.egress_order_gate(valid, shifted[1:].view(8, 16), nbytes,
                                   tsend, clamp, balance, shift)
    assert pipeline.LAUNCHES["egress_gate"] == before


@pytest.mark.parametrize("ce,ci", [(8, 4), (16, 32), (64, 64)])
@pytest.mark.parametrize("name,kernel,plain", [
    ("route_place", pipeline.place, pipeline.place_plain),
    ("route_scatter", pipeline.scatter, pipeline.scatter_plain)],
    ids=["B", "D"])
def test_route_scatter_kernel_matches_plain(cuda, ce, ci, name, kernel,
                                            plain):
    """Kernels B and D against their plain version, each on its own clone
    of the inputs (both update the ingress tensors in place)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in placement_inputs(300, ce, ci, seed=ce + ci)]
    mine = [a.clone() for a in args]
    before = pipeline.LAUNCHES[name]
    got = kernel(*mine)
    ref = plain(*[a.clone() for a in args])
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES[name] == before + 1
    assert [g.data_ptr() for g in got] == [a.data_ptr() for a in mine[9:]]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_phold_golden_digest_on_the_card(cuda, kernel):
    g = dict(bench.GOLDEN_PHOLD)
    res = bench.run_phold(g.pop("n_hosts"), rounds=g.pop("rounds"),
                          warmup=False, device=cuda, kernel=kernel, **g)
    assert convert.state_digest(res["state"]) == bench.GOLDEN_PHOLD_DIGEST


def test_corpus_entry_on_the_card_matches_golden(cuda):
    """One direct-transport corpus entry through the port's runner on the
    card: the golden digests, the record of the CPU run, and no kernel
    launch (the XLA path runs none)."""
    corpus = Path(__file__).resolve().parent.parent / "scenarios"
    golden = json.loads((corpus / "GOLDEN.json").read_text())
    sp = spec.load_scenario_file(str(corpus / "incast.yaml"))
    before = dict(pipeline.LAUNCHES)
    rec = runner.run_scenario(sp, device=cuda)
    assert pipeline.LAUNCHES == before
    assert runner.golden_entry(rec) == golden[sp.name]
    assert rec == runner.run_scenario(sp, device="cpu")

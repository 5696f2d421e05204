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

from torch_parity import (BATCHED_KERNELS, EDGE_SHIFTS,  # noqa: E402
                          batched_kernel_case, drain_inputs, flat_outputs,
                          gate_edge_columns, placement_inputs)

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


@pytest.mark.parametrize("n,n_src", [(300, 1200), (1024, 4096), (512, 128)])
@pytest.mark.parametrize("name,kernel,plain", [
    ("route_place", pipeline.place, pipeline.place_plain),
    ("route_scatter", pipeline.scatter, pipeline.scatter_plain)],
    ids=["B", "D"])
def test_placement_kernel_with_a_source_axis_matches_plain(cuda, n, n_src,
                                                           name, kernel,
                                                           plain):
    """Kernels B and D with n_src source rows and n ring rows (a mesh
    rank's launch after the routing exchange) against their plain
    version, bitwise, one launch each."""
    args = [torch.from_numpy(a).to(cuda)
            for a in placement_inputs(n, 16, 32, seed=n_src, n_src=n_src)]
    mine = [a.clone() for a in args]
    before = pipeline.LAUNCHES[name]
    got = kernel(*mine)
    ref = plain(*[a.clone() for a in args])
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES[name] == before + 1
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


@pytest.mark.parametrize("n,k", [(n, k) for k in (8, 32, 64)
                                 for n in (1, 37, 4099)]
                         + [(37, 300), (4099, 300), (37, 1024)])
def test_router_drain_kernel_matches_plain(cuda, n, k):
    """Kernel E against `router_drain_plain` on the card, on random rows
    and mid-run router states (`drain_inputs`), at a block-aligned and
    ragged host counts, rows that fill 32, 16 and 4 hosts' shared memory
    a block, in a short window and one so long that resumes wrap int32;
    every output a fresh tensor."""
    from shadow_tpu_torch.tpu import codel

    for window_ns in (10 * MS, 2**30):
        arrival, size, rate, cap, state = drain_inputs(
            n, k, seed=n + k, window_ns=window_ns)
        t = lambda a: torch.from_numpy(a).to(cuda)
        st = convert.router_from_numpy(state, cuda)
        args = (t(arrival), t(size), window_ns, t(rate), t(cap), st)
        before = pipeline.LAUNCHES["router_drain"]
        got = codel.router_drain(*args)
        ref = codel.router_drain_plain(*args)
        torch.cuda.synchronize()
        assert pipeline.LAUNCHES["router_drain"] == before + 1
        for f in codel.RouterDownState._fields:
            g, r = getattr(got[0], f), getattr(ref[0], f)
            assert g.dtype == r.dtype and torch.equal(g, r), (window_ns, f)
            if f in codel.DRAIN_FIELDS:
                assert g.data_ptr() != getattr(st, f).data_ptr()
        for g, r in zip(got[1:], ref[1:]):
            assert g.dtype == r.dtype and torch.equal(g, r), window_ns


def test_router_drain_kernel_refuses_rows_it_cannot_stage(cuda):
    from shadow_tpu_torch.tpu import codel

    _a, _s, rate, cap, state = drain_inputs(4, 8, seed=0)
    # a block stages four rows of K + 1 words a host in its 227 KB of
    # shared memory: K = 14527 at most, and the launcher refuses wider
    wide = np.full((4, 14528), 2**31 - 1, np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    with pytest.raises(RuntimeError, match="router_drain_kernel: CUDA error"):
        codel.router_drain(t(wide), t(wide), 10 * MS, t(rate), t(cap),
                           convert.router_from_numpy(state, cuda))


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas", "xla"])
def test_aqm_window_step_on_the_card(cuda, kernel):
    """`window_step(router_aqm=True)` through each kernel on the card
    equals the plain versions' run on the card and the CPU run, window by
    window, and launches kernel E once a window."""
    from shadow_tpu_torch.tpu import profiling

    runs = {}
    for name, device, plain in (("card", cuda, False),
                                ("plain", cuda, True), ("cpu", "cpu", False)):
        w = profiling.build_world(300, n_nodes=16, egress_cap=16,
                                  ingress_cap=32, warmup_windows=0,
                                  down_bw_bps=1_000_000, seed_packets=16,
                                  device=device)
        st, shift, digests = w["state"], 0, []
        before = dict(pipeline.LAUNCHES)
        for _ in range(12):
            st, d, nxt = aqm_step(st, w, shift, kernel, plain)
            shift = w["window"]
            digests.append((convert.state_digest(st),
                            int(d["mask"].sum()), int(nxt)))
        runs[name] = digests
        launched = pipeline.LAUNCHES["router_drain"] - before["router_drain"]
        assert launched == (12 if name == "card" else 0), name
    assert runs["card"] == runs["plain"] == runs["cpu"]
    assert sum(n for _d, n, _x in runs["card"]) > 0


def aqm_step(st, w, shift, kernel, plain):
    from shadow_tpu_torch.tpu import plane

    return plane.window_step(st, w["params"], w["rng_root"], shift,
                             w["window"], rr_enabled=False, router_aqm=True,
                             kernel=kernel, plain_kernels=plain)


@pytest.mark.parametrize("kernel,pair,hist", [
    ("pallas_fused", ("egress_rank", "route_place"), False),
    ("pallas", ("egress_gate", "route_scatter"), False),
    ("xla", (), True)])
def test_phold_telemetry_and_ledger_on_the_card(cuda, tmp_path, kernel,
                                                pair, hist):
    """`chip_smoke.py` phase 16 (a) at 4096 hosts: the harvester every 8
    windows (and the histograms on "xla") with the run ledger leave the
    state of the bare run, and every window launches the pair."""
    size = dict(n_nodes=64, egress_cap=16, ingress_cap=32, rounds=32,
                warmup=False, kernel=kernel)
    off = bench.run_phold(4096, chain_len=8, **size)
    pipeline.reset_launches()
    on = bench.run_phold(4096, telemetry=str(tmp_path), hist=hist,
                         harvest_every=8, trace=str(tmp_path / "l.jsonl"),
                         **size)
    assert convert.state_digest(on["state"]) == \
        convert.state_digest(off["state"])
    assert all(n == (32 if k in pair else 0)
               for k, n in pipeline.LAUNCHES.items())
    assert on["telemetry"]["harvests"] == 4
    assert on["telemetry"]["heartbeats"] == 4 * 4097
    ledger = [json.loads(x) for x in open(tmp_path / "l.jsonl")]
    assert sum(r["kind"] == "span" for r in ledger) == 4


def test_phold_checkpoint_resume_on_the_card(cuda, tmp_path):
    """Phase 16 (b) at 4096 hosts, in one process: the fused run
    checkpointed every 8 windows, resumed from its round-16 checkpoint,
    ends as the uninterrupted run."""
    from shadow_tpu_torch.faults import runstate
    from shadow_tpu_torch.tpu.profiling import build_world

    world = lambda: build_world(4096, seed=0, warmup_windows=0)
    ck = runstate.RunCheckpointer(str(tmp_path), every=8, label="phold",
                                  keep=4)
    state, total = bench.run_chain(world(), 32, 8, checkpointer=ck)
    assert ck.saved == 3
    path = str(tmp_path / "phold-r00000016.runstate.npz")
    pipeline.reset_launches()
    again, total2 = bench.run_chain(world(), 32, 8, resume_from=path)
    assert convert.state_digest(again) == convert.state_digest(state)
    assert total2 == total
    assert pipeline.LAUNCHES["egress_rank"] == 16


@pytest.mark.parametrize("name", BATCHED_KERNELS)
def test_batched_launch_matches_the_vmapped_plain_version(cuda, name):
    """Each kernel under `torch.func.vmap` over 3 distinct worlds is one
    launch (the worlds folded into its rows), equal to its plain version
    vmapped over the same worlds, each on its own clone of the inputs."""
    wrapper, plain, args, in_dims, mutated = batched_kernel_case(
        name, 300, (1, 2, 3), cuda)
    clone = lambda: tuple(a.clone() if i in mutated else a
                          for i, a in enumerate(args))
    before = pipeline.LAUNCHES[name]
    got = flat_outputs(torch.func.vmap(wrapper, in_dims=in_dims)(*clone()))
    ref = flat_outputs(torch.func.vmap(plain, in_dims=in_dims)(*clone()))
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES[name] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("kernel,pair", [
    ("pallas_fused", ("egress_rank", "route_place")),
    ("pallas", ("egress_gate", "route_scatter"))])
def test_ensemble_launches_each_kernel_once_a_window(cuda, kernel, pair):
    """`bench.run_worlds` with 3 worlds of 2048 hosts for 8 windows: 8
    launches of each kernel of the pair, not 24, and each world's state
    equal to its solo run under its world key."""
    from shadow_tpu_torch.tpu import elastic
    from shadow_tpu_torch.tpu.profiling import build_world

    size = dict(n_nodes=16, egress_cap=16, ingress_cap=32)
    pipeline.reset_launches()
    rec = bench.run_worlds(3, 2048, rounds=8, chain_len=4, kernel=kernel,
                           warmup=False, **size)
    assert {k: pipeline.LAUNCHES[k] for k in pair} == dict.fromkeys(pair, 8)
    world = build_world(2048, seed=0, warmup_windows=0, **size)
    chain = bench.phold_keyed_chain_fn(world, kernel=kernel)
    keys = elastic.world_keys(world["rng_root"], range(3))
    for w in range(3):
        solo, _ex = elastic.drive_chained_windows(
            world["state"], (keys[w], torch.full((2048,), bench.SPAWN_SEQ0,
                                                 dtype=torch.int32,
                                                 device=cuda),
                             torch.zeros((), dtype=torch.int32, device=cuda)),
            chain, n_rounds=8, chain_len=4)
        assert convert.state_digest(solo) == convert.state_digest(
            elastic.world_slice(rec["states"], w)), w


def flow_world(floweng, n_flows, device, queue_slots=16):
    rng = np.random.default_rng(n_flows)
    lat = rng.integers(2, 40, n_flows) * 1000
    size = rng.integers(20, 200, n_flows) * 1000
    w = floweng.make_flow_world(
        lat, size, start_us=rng.integers(0, 30, n_flows) * 1000,
        queue_slots=queue_slots, seed=3, loss=0.02, loss_back=0.01,
        latency_back_us=rng.integers(2, 40, n_flows) * 1000, device=device)
    total = w.total.cpu().numpy()
    total[2::4], total[3::4] = total[3::4].copy(), total[2::4].copy()
    return w._replace(total=torch.from_numpy(total).to(device))


@pytest.mark.parametrize("opts", [{}, dict(gso_segs=1,
                                           max_events_per_window=2)],
                         ids=["default", "gso1-cap2"])
def test_flow_window_kernel_matches_plain(cuda, opts):
    """Kernel F bitwise against `run_windows_plain` on the card, every
    FlowWorld leaf and steps_per_window, one launch a call."""
    from shadow_tpu_torch.tpu import floweng

    w0 = flow_world(floweng, 48, cuda)
    before = floweng.LAUNCHES["flow_window"]
    got, steps = floweng.run_windows(w0, 40, 2000, **opts)
    ref, ref_steps = floweng.run_windows_plain(w0, 40, 2000, **opts)
    torch.cuda.synchronize()
    assert floweng.LAUNCHES["flow_window"] == before + 1
    assert torch.equal(steps, ref_steps)
    assert_flow_worlds_equal(got, ref)


def assert_flow_worlds_equal(got, ref):
    a = convert.flow_world_to_numpy(got)
    b = convert.flow_world_to_numpy(ref)
    for k in b:
        if k == "plane":
            for g in b[k]:
                assert np.array_equal(a[k][g], b[k][g]), g
        else:
            assert np.array_equal(a[k], b[k]), k


def test_flow_window_kernel_matches_plain_at_bench_flows_shape(cuda):
    """Kernel F bitwise against `run_windows_plain` on bench_flows' first
    chunk: 975 flows (8 blocks of 128 threads), Q=128, 25 windows."""
    from shadow_tpu_torch.tools import bench_flows
    from shadow_tpu_torch.tpu import floweng

    lats, sizes, queue_slots, window_us = bench_flows.default_world_args()
    w0 = floweng.make_flow_world(lats, sizes, queue_slots=queue_slots,
                                 device=cuda)
    got, steps = floweng.run_windows(w0, 25, window_us)
    ref, ref_steps = floweng.run_windows_plain(w0, 25, window_us)
    torch.cuda.synchronize()
    assert torch.equal(steps, ref_steps) and int(steps.sum()) > 0
    assert_flow_worlds_equal(got, ref)

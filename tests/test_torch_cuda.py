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
                          all_halted, batched_kernel_case, drain_inputs, flat_outputs,
                          gate_edge_columns, long_chain_drain_inputs,
                          placement_inputs, wide_drain_inputs)

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


@pytest.mark.parametrize("ce", [1, 2, 4, 8, 16, 32, 64, 128, 1024, 2048,
                                4096, 16384])
def test_egress_rank_kernel_matches_plain(cuda, ce):
    args = egress_args(300, ce, cuda, seed=ce)
    before = pipeline.LAUNCHES["egress_rank"]
    got = pipeline.egress_rank_stage(*args)
    ref = pipeline.egress_rank_plain(*args)
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["egress_rank"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("ce", [1, 2, 4, 8, 16, 32, 64, 128, 1024, 2048,
                                4096, 16384])
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


@pytest.mark.parametrize("ce", [1, 2048, 4096, 16384])
@pytest.mark.parametrize("n", [1, 37])
def test_egress_kernels_match_plain_on_edge_values_at_new_widths(cuda, n,
                                                                  ce):
    """Kernels A and C at a one-slot row and in their wide build, on the
    int32 edge columns (prefix sums past 2^31 across rows of 2^11-2^14
    slots), with both shifts; each launch counted under the build its
    launcher picks by the width."""
    cols = gate_edge_columns(n, ce, seed=3 * n + ce)
    rng = np.random.default_rng(ce)
    extra = [torch.from_numpy(np.asarray(a, dt)).to(cuda) for a, dt in (
        (rng.integers(-1, n, (n, ce)), np.int32),
        (rng.integers(-2**31, 2**31, (n, ce)), np.int32),
        (rng.integers(0, 40, (n, ce)), np.int32),
        (rng.random((n, ce)) < 0.2, bool))]
    for shift in EDGE_SHIFTS:
        c = [torch.from_numpy(v).to(cuda) for v in cols.values()]
        for stage, plain, args, name, builds in (
                (pipeline.egress_order_gate, pipeline.egress_gate_plain,
                 (*c, shift), "egress_gate", pipeline.C_BUILD_LAUNCHES),
                (pipeline.egress_rank_stage, pipeline.egress_rank_plain,
                 (*c[:5], *extra, c[5], shift), "egress_rank",
                 pipeline.A_BUILD_LAUNCHES)):
            build = pipeline.egress_build(name, ce)
            assert build == ("wide" if ce > 1024 else
                             "warp" if name == "egress_rank" else "tile")
            before = builds[build]
            got = stage(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            assert builds[build] == before + 1
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and torch.equal(g, r), (
                    name, shift, n, ce)


def test_route_place_kernel_takes_one_slot_rings(cuda):
    """Kernel B with ingress rings of one slot (CI = 1), which JAX's
    `_place_kernel` takes: B against its plain version on clones of the
    same inputs (both update the rings in place)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in placement_inputs(2048, 16, 1, seed=9)]
    clone = lambda: [a.clone() for a in args]
    before = pipeline.LAUNCHES["route_place"]
    got = pipeline.place(*clone())
    ref = pipeline.place_plain(*clone())
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["route_place"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


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


def drain_on_card(cuda, inputs, window_ns, view=False, build=None):
    """Kernel E and `router_drain_plain` on the same card tensors, one
    launch, every output bitwise and fresh; with `view`, each input is a
    view one element into a longer tensor (`[1:]` of its flat storage), so
    the rows start a word past a 16-byte boundary whatever K is; `build`
    forces kernel E's build (else K picks it). The plain loop stops once
    every host has halted. Returns its micro-steps a host and the
    outputs of the launch."""
    from shadow_tpu_torch.tpu import codel

    arrival, size, rate, cap, state = inputs

    def t(a):
        if not view:
            return torch.from_numpy(a).to(cuda)
        flat = a.reshape(-1)
        big = torch.from_numpy(np.concatenate([flat[:1], flat])).to(cuda)
        return big[1:].view(a.shape)

    st = codel.RouterDownState(**{
        f: t(np.asarray(v)) for f, v in convert.router_from_numpy(
            state, "cpu")._asdict().items()})
    args = (t(arrival), t(size), window_ns, t(rate), t(cap), st)
    if view:
        assert args[0].data_ptr() % 16 == 4 and args[1].data_ptr() % 16 == 4
    before = pipeline.LAUNCHES["router_drain"]
    built = dict(pipeline.E_BUILD_LAUNCHES)
    got = codel.router_drain(*args, _build=build)
    ref = codel._router_drain_loop(*args, until=all_halted)
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["router_drain"] == before + 1
    ran = codel.e_geometry(*arrival.shape, build)["build"]
    assert ran == (build or ("staged" if arrival.shape[1] <= 29055
                             else "device"))
    assert pipeline.E_BUILD_LAUNCHES[ran] == built[ran] + 1
    for f in codel.RouterDownState._fields:
        g, r = getattr(got[0], f), getattr(ref[0], f)
        assert g.dtype == r.dtype and torch.equal(g, r), (window_ns, f)
        if f in codel.DRAIN_FIELDS:
            assert g.data_ptr() != getattr(st, f).data_ptr()
    for g, r in zip(got[1:], ref[1:6]):
        assert g.dtype == r.dtype and torch.equal(g, r), window_ns
    return ref[6], got


@pytest.mark.parametrize("n,k", [(n, k) for k in (8, 32, 64)
                                 for n in (1, 37, 4099)]
                         + [(37, 300), (4099, 300), (37, 1024)]
                         + [(31, 32), (32, 32), (33, 32), (37, 1), (37, 7),
                            (4099, 7), (37, 33), (4099, 33), (9, 2047)])
def test_router_drain_kernel_matches_plain(cuda, n, k):
    """Kernel E against `router_drain_plain` on the card, on random rows
    and mid-run router states (`drain_inputs`), at host counts of one, a
    tile less one, a tile, a tile plus one and ragged ones, odd widths
    whose slabs lie off 16 bytes (1, 7, 33, 2047), rows wide enough to
    need more than 48 KB of shared memory (300) or to shrink the tile
    (1024: 16 hosts; 2047: 8), in a short window and one so long that
    resumes wrap int32; every output a fresh tensor."""
    for window_ns in (10 * MS, 2**30):
        drain_on_card(cuda, drain_inputs(n, k, seed=n + k,
                                         window_ns=window_ns), window_ns)


@pytest.mark.parametrize("n,k", [(37, 1), (37, 7), (70, 32), (70, 33),
                                 (33, 64)])
def test_router_drain_kernel_on_unaligned_row_views(cuda, n, k):
    """Inputs that are views one element into longer tensors: rows that
    start a word past a 16-byte boundary, at odd and even K."""
    drain_on_card(cuda, drain_inputs(n, k, seed=3 * n + k), 10 * MS,
                  view=True)


@pytest.mark.parametrize("n,k", [(65, 32), (97, 33)])
def test_router_drain_kernel_long_chains_beside_halting_hosts(cuda, n, k):
    """A host a tile whose tiny bucket caches and resumes each packet, so
    that it runs more than K micro-steps, beside hosts that halt at once:
    one lane's long chain holds only its own tile."""
    steps, _ = drain_on_card(cuda, long_chain_drain_inputs(n, k, seed=5),
                             2**30)
    assert (steps[::32] > k).all() and (steps[1::32] == 1).all()


@pytest.mark.parametrize("n,k", [(37, 1), (37, 7), (4099, 33), (9, 2047),
                                 (40, 29055)])
def test_router_drain_device_build_matches_staged_and_plain(cuda, n, k):
    """Kernel E's device build forced at K its staged build takes (the
    widest, 29055, with a few hundred packets a row) equals the plain
    version and the staged build, bitwise, in a short window and a long
    one."""
    from shadow_tpu_torch.tpu import codel

    for window_ns in (10 * MS, 2**30):
        inputs = (wide_drain_inputs(n, k, seed=k) if k > 2047 else
                  drain_inputs(n, k, seed=7 * n + k, window_ns=window_ns))
        _, dev = drain_on_card(cuda, inputs, window_ns, build="device")
        arrival, size, rate, cap, state = inputs
        t = lambda a: torch.from_numpy(a).to(cuda)
        staged = codel.router_drain(
            t(arrival), t(size), window_ns, t(rate), t(cap),
            convert.router_from_numpy(state, cuda), _build="staged")
        for a, b in zip(dev[1:], staged[1:]):
            assert torch.equal(a, b)
        for f in dev[0]._fields:
            assert torch.equal(getattr(dev[0], f), getattr(staged[0], f))


@pytest.mark.parametrize("k", [14528, 29055, 29056, 32768, 65536])
def test_router_drain_kernel_takes_wide_rows_with_real_packets(cuda, k):
    """Rows as wide as a router with deep buffers (the staged build up to
    K = 29055, the device build beyond), a few hundred packets queued in
    each, long chains among them: bitwise the plain version, which stops
    once every host has halted."""
    steps, got = drain_on_card(cuda, wide_drain_inputs(40, k, seed=k), 2**30)
    assert (steps[::32] > 100).all() and (steps[1::32] == 1).all()
    assert int(steps.max()) > 300
    assert (got[1] != 0).any(), "no packet left the queue: a dead test"


@pytest.mark.parametrize("k", [29054, 29055])
def test_router_drain_kernel_stages_the_widest_rows(cuda, k):
    """The widest rows the staged build takes (one host a tile at K =
    29054 and 29055): rows of padding, with one entry that arrives after
    the window, halt at once, so the drain leaves the state as it was
    and every entry queued."""
    from shadow_tpu_torch.tpu import codel

    _a, _s, rate, cap, state = drain_inputs(3, 8, seed=1)
    state["has_cached"][:] = False
    arrival = np.full((3, k), 2**31 - 1, np.int32)
    arrival[1, 0] = 11 * MS
    size = np.full((3, k), 1500, np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    st = convert.router_from_numpy(state, cuda)
    got = codel.router_drain(t(arrival), t(size), 10 * MS, t(rate), t(cap),
                             st)
    torch.cuda.synchronize()
    for f in codel.RouterDownState._fields:
        assert torch.equal(getattr(got[0], f), getattr(st, f)), f
    assert (got[1] == codel.STATUS_QUEUED).all()
    assert (got[2] == 2**31 - 1).all()
    assert not got[3].any() and (got[4] == 0).all()
    assert (got[5] == -1).all()


def test_batched_router_drain_with_ragged_rows(cuda):
    """Kernel E under `torch.func.vmap` over 3 worlds of 37 hosts (111
    rows: no whole tile at the world boundaries) at K=33: one launch,
    equal to the plain version vmapped over the worlds."""
    wrapper, plain, args, in_dims, _m = batched_kernel_case(
        "router_drain", 37, (4, 5, 6), cuda, k=33)
    before = pipeline.LAUNCHES["router_drain"]
    got = flat_outputs(torch.func.vmap(wrapper, in_dims=in_dims)(*args))
    ref = flat_outputs(torch.func.vmap(plain, in_dims=in_dims)(*args))
    torch.cuda.synchronize()
    assert pipeline.LAUNCHES["router_drain"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_router_drain_kernel_refuses_rows_it_cannot_stage(cuda):
    """The staged build forced past the widest row it stages refuses at
    its launcher; unforced, the launch runs the device build."""
    from shadow_tpu_torch.tpu import codel

    _a, _s, rate, cap, state = drain_inputs(4, 8, seed=0)
    # a block stages two rows of K + 1 words a host in its 227 KB of
    # shared memory: K = 29055 at most in the staged build
    wide = np.full((4, 29056), 2**31 - 1, np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    args = (t(wide), t(wide), 10 * MS, t(rate), t(cap),
            convert.router_from_numpy(state, cuda))
    with pytest.raises(RuntimeError,
                       match="router_drain_kernel: CUDA error"):
        codel.router_drain(*args, _build="staged")
    assert codel.e_geometry(4, 29056)["build"] == "device"
    assert codel.e_geometry(4, 29055)["build"] == "staged"
    with pytest.raises(RuntimeError, match="geometry"):
        codel.e_geometry(4, 29056, "staged")
    before = pipeline.E_BUILD_LAUNCHES["device"]
    out = codel.router_drain(*args)
    torch.cuda.synchronize()
    assert pipeline.E_BUILD_LAUNCHES["device"] == before + 1
    assert (out[1] == codel.STATUS_QUEUED).all()


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
    chunk: 975 flows (122 blocks of 8 pairs), Q=128, 25 windows."""
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


@pytest.mark.parametrize("queue_slots", [16, 256, 1024])
@pytest.mark.parametrize("n_flows", [1, 33, 975])
def test_flow_window_kernel_matches_plain_on_wrapping_rings(
        cuda, n_flows, queue_slots):
    """Kernel F on rings whose heads start at the last slot, so they wrap
    at once: bitwise `run_windows_plain`, one launch."""
    from shadow_tpu_torch.tpu import floweng

    w0 = flow_world(floweng, n_flows, cuda, queue_slots=queue_slots)
    w0 = w0._replace(q_head=torch.full_like(w0.q_head, queue_slots - 1))
    opts = dict(sched_batch=2, pull_cap=8, gso_segs=1,
                max_events_per_window=3)
    w = floweng.clone_world(w0)
    before = floweng.LAUNCHES["flow_window"]
    steps = floweng.flow_window_(w, 40, 2000, **opts)
    ref, ref_steps = floweng.run_windows_plain(w0, 40, 2000, **opts)
    torch.cuda.synchronize()
    assert floweng.LAUNCHES["flow_window"] == before + 1
    assert int(ref.q_head.max()) >= queue_slots  # a pop past the last slot
    assert torch.equal(steps, ref_steps)
    assert_flow_worlds_equal(w, ref)


@pytest.mark.parametrize("queue_slots", [28958, 30001, 32768])
def test_flow_window_kernel_takes_rings_past_28957_slots(cuda, queue_slots):
    """Rings larger than an earlier kernel F could stage in shared memory
    (by the mask at 32768, by division at 28958 and 30001): 33 flows
    whose rings wrap at once, bitwise `run_windows_plain`."""
    from shadow_tpu_torch.tpu import floweng

    w0 = flow_world(floweng, 33, cuda, queue_slots=queue_slots)
    w0 = w0._replace(q_head=torch.full_like(w0.q_head, queue_slots - 2))
    before = floweng.LAUNCHES["flow_window"]
    got, steps = floweng.run_windows(w0, 40, 2000)
    ref, ref_steps = floweng.run_windows_plain(w0, 40, 2000)
    torch.cuda.synchronize()
    assert floweng.LAUNCHES["flow_window"] == before + 1
    assert int(ref.q_head.max()) > queue_slots
    assert torch.equal(steps, ref_steps)
    assert_flow_worlds_equal(got, ref)


@pytest.mark.parametrize("queue_slots", [16, 128, 256, 1024])
@pytest.mark.parametrize("n_flows", [1, 33, 975])
def test_flow_window_kernel_matches_plain_at_pair_counts_and_rings(
        cuda, n_flows, queue_slots):
    """Kernel F bitwise against `run_windows_plain` where the pairs do not
    fill a block (one pair, 33 blocks of one, 122 blocks of 8) and at
    rings of 16 to 1024 slots."""
    from shadow_tpu_torch.tpu import floweng

    w0 = flow_world(floweng, n_flows, cuda, queue_slots=queue_slots)
    geo = floweng.f_geometry(w0)
    assert geo["blocks"] * geo["pairs_a_block"] >= n_flows
    assert geo["blocks"] == -(-n_flows // geo["pairs_a_block"])
    got, steps = floweng.run_windows(w0, 30, 2000)
    ref, ref_steps = floweng.run_windows_plain(w0, 30, 2000)
    torch.cuda.synchronize()
    assert torch.equal(steps, ref_steps) and int(steps.sum()) > 0
    assert_flow_worlds_equal(got, ref)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_flow_engine_equals_one_launch_on_the_card(cuda, n_shards):
    """`run_windows_sharded` on one card: one launch of kernel F a shard,
    each on its own stream, merged bitwise equal to the single launch of
    the whole world, each shard's steps equal to F on that shard alone,
    and the input world unchanged."""
    from shadow_tpu_torch.tools import multichip
    from shadow_tpu_torch.tpu import floweng

    n_flows = 12 * n_shards
    w0 = multichip.flow_world(n_flows, cuda)
    keep = floweng.clone_world(w0)
    ref, _ = floweng.run_windows(w0, 400, multichip.FLOW_WINDOW_US)
    before = floweng.LAUNCHES["flow_window"]
    got, steps = floweng.run_windows_sharded(
        w0, 400, multichip.FLOW_WINDOW_US, n_shards=n_shards)
    torch.cuda.synchronize()
    assert floweng.LAUNCHES["flow_window"] == before + n_shards
    assert steps.shape == (n_shards, 400) and int(steps.sum()) > 0
    assert_flow_worlds_equal(got, ref)
    assert_flow_worlds_equal(w0, keep)
    split = floweng.split_flow_world(w0, n_shards)
    for s in range(n_shards):
        alone = floweng.clone_world(floweng._shard(split, s))
        st = floweng.flow_window_(alone, 400, multichip.FLOW_WINDOW_US)
        assert torch.equal(st, steps[s]), s

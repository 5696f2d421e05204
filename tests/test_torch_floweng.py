"""The port's device flow engine (`shadow_tpu_torch/tpu/floweng.py`)
against the JAX package's, bitwise: `make_flow_world` leaf for leaf,
`run_windows_plain` against JAX's `run_windows` on a heterogeneous lossy
world (asymmetric latencies, both transfer directions, staggered starts,
16-slot rings that overflow), with and without a step cap small enough
to saturate windows; `flow_results`, `finalize_to`, `run_to_completion`'s
cap doubling and the split/merge round trip.

The pair-independence test is what kernel F rests on: the plain run of
the whole world equals the merge of every pair run alone, apart from
`steps_per_window`, which is the largest pair's. The host build of
kernel F's source (`csrc/flow_window.cu` through a C++ compiler, one
pair after another over the staged layout the card uses, lane a then
lane b within each phase) is held to the plain version here too, and so
is a build that runs lane b first: the card runs the two lanes at once,
which is exact only if neither order matters."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shadow_tpu.tpu import floweng as jfe  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.tpu import floweng as tfe  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N_FLOWS = 8
N_WINDOWS = 60
WINDOW_US = 2000  # the narrowest one-way latency
CAPS = (512, 2)  # the default step cap, and one that saturates windows
# one MSS a pull: bursts of single segments overflow the 16-slot rings
# and need more than one fused step a window
GSO = 1


def world_args(n_flows=N_FLOWS, seed=5):
    rng = np.random.default_rng(seed)
    lat = rng.integers(2, 40, n_flows) * 1000
    lat_back = rng.integers(2, 40, n_flows) * 1000
    size = rng.integers(20, 200, n_flows) * 1000
    start = rng.integers(0, 30, n_flows) * 1000
    return (lat, size), dict(start_us=start, queue_slots=16, seed=3,
                             loss=0.02, loss_back=0.01,
                             latency_back_us=lat_back)


def mixed(world, total):
    """Odd flows fetch: their passive side writes."""
    t = np.array(total)
    t[2::4], t[3::4] = t[3::4].copy(), t[2::4].copy()
    return world._replace(total=(jnp.asarray(t) if isinstance(
        world.total, jax.Array) else torch.from_numpy(t)))


def jax_world(n_flows=N_FLOWS):
    args, kw = world_args(n_flows)
    w = jfe.make_flow_world(*args, **kw)
    return mixed(w, np.asarray(w.total))


def port_world(n_flows=N_FLOWS):
    args, kw = world_args(n_flows)
    w = tfe.make_flow_world(*args, device="cpu", **kw)
    return mixed(w, w.total.numpy())


def as_numpy(world):
    if isinstance(world, tfe.FlowWorld):
        return convert.flow_world_to_numpy(world)
    w = jax.tree.map(np.asarray, world)
    d = w._asdict()
    d["plane"] = w.plane._asdict()
    return d


def assert_worlds_equal(a, b, skip=()):
    da, db = as_numpy(a), as_numpy(b)
    for f, x in da.items():
        if f in skip:
            continue
        if f == "plane":
            for g, xg in x.items():
                yg = db["plane"][g]
                assert xg.dtype == yg.dtype and xg.shape == yg.shape, g
                assert np.array_equal(xg, yg), ("plane", g)
            continue
        y = db[f]
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's run_windows on the world, once a cap."""
    w0 = jax_world()
    out = {}
    for cap in CAPS:
        run = jax.jit(lambda w, cap=cap: jfe.run_windows(
            w, N_WINDOWS, WINDOW_US, max_events_per_window=cap,
            gso_segs=GSO))
        out[cap] = run(w0)
    return w0, out


@pytest.fixture(scope="module")
def plain_runs():
    w0 = port_world()
    return w0, {cap: tfe.run_windows_plain(w0, N_WINDOWS, WINDOW_US,
                                           max_events_per_window=cap,
                                           gso_segs=GSO)
                for cap in CAPS}


@pytest.mark.parametrize("server_writes", [False, True])
@pytest.mark.parametrize("asym", [False, True])
def test_make_flow_world_matches_jax(server_writes, asym):
    args, kw = world_args(8, seed=int(server_writes) + 2 * int(asym))
    if not asym:
        kw = {k: v for k, v in kw.items()
              if k not in ("latency_back_us", "loss_back")}
    kw["server_writes"] = server_writes
    assert_worlds_equal(jfe.make_flow_world(*args, **kw),
                        tfe.make_flow_world(*args, device="cpu", **kw))


def test_flow_world_numpy_round_trip():
    w = port_world(4)
    d = convert.flow_world_to_numpy(w)
    assert d["loss_u32"].dtype == np.uint32
    assert d["plane"]["iss"].dtype == np.uint32 and d["iss"].dtype == np.int32
    assert_worlds_equal(w, convert.flow_world_from_numpy(d, "cpu"))
    assert_worlds_equal(jax_world(4), convert.flow_world_from_numpy(
        jax.tree.map(np.asarray, jax_world(4)), "cpu"))


@pytest.mark.parametrize("cap", CAPS)
def test_run_windows_plain_matches_jax(jax_runs, plain_runs, cap):
    j0, jout = jax_runs
    t0, tout = plain_runs
    assert_worlds_equal(j0, t0)
    (jw, jsteps), (tw, tsteps) = jout[cap], tout[cap]
    assert tsteps.dtype == torch.int32
    assert np.array_equal(np.asarray(jsteps), tsteps.numpy())
    assert_worlds_equal(jw, tw)


def test_the_world_exercises_the_engine(plain_runs):
    """Wire losses, ring-overflow drops, both directions of transfer
    and (under the small cap) saturated windows all occur."""
    _w0, out = plain_runs
    res = tfe.flow_results(out[512][0])
    assert res["wire_drops"] > 0 and res["queue_drops"] > 0
    # both directions deliver: even flows upload, odd flows fetch
    assert (res["bytes_read"][0::2] > 0).any()
    assert (res["bytes_read"][1::2] > 0).any()
    total = out[512][0].total.numpy()
    assert (total[0::4] > 0).all() and (total[3::4] > 0).all()
    assert int(out[512][0].n_saturated) == 0
    assert int(out[2][0].n_saturated) > 0


def test_run_windows_on_cpu_tensors_is_the_plain_version(plain_runs):
    w0, out = plain_runs
    before = tfe.LAUNCHES["flow_window"]
    w, steps = tfe.run_windows(w0, N_WINDOWS, WINDOW_US,
                               max_events_per_window=2, gso_segs=GSO)
    assert tfe.LAUNCHES["flow_window"] == before
    assert torch.equal(steps, out[2][1])
    assert_worlds_equal(w, out[2][0])


def pair_world(world, p):
    """Pair p alone, as a world of one flow (its lanes keep their
    global lane ids, so its loss draws are the whole world's)."""
    lanes = slice(2 * p, 2 * p + 2)
    cut = lambda x: x if x.dim() == 0 else x[lanes].clone()
    return tfe.FlowWorld(tfe.dtcp.TcpPlane(*map(cut, world.plane)),
                         *map(cut, world[1:]))


def concat_worlds(worlds):
    cat = lambda *xs: xs[0] if xs[0].dim() == 0 else torch.cat(xs)
    plane = tfe.dtcp.TcpPlane(*(cat(*xs) for xs in zip(
        *(w.plane for w in worlds))))
    return tfe.FlowWorld(plane, *(cat(*xs) for xs in zip(
        *(w[1:] for w in worlds))))


def test_pair_independence(plain_runs):
    """Each pair run alone, merged, equals the whole world's run, and
    the whole world's step count a window is the largest pair's: a
    fused step, the app phase and the barrier flush leave a pair with
    no work unchanged. Under the saturating cap, as it has the most
    windows with pairs idle beside busy ones; the saturated windows are
    those in which some pair saturated, so their count lies between the
    largest pair's and the pairs' sum. (The host build of kernel F runs
    pair by pair too, and equals the plain run under both caps.)"""
    w0, out = plain_runs
    whole, steps = out[2]
    runs = [tfe.run_windows_plain(pair_world(w0, p), N_WINDOWS, WINDOW_US,
                                  max_events_per_window=2, gso_segs=GSO)
            for p in range(N_FLOWS)]
    merged = concat_worlds([w for w, _ in runs])
    assert_worlds_equal(whole, merged, skip=("n_saturated",))
    pair_steps = torch.stack([s for _, s in runs])
    assert torch.equal(steps, pair_steps.amax(0))
    assert (pair_steps.amin(0) < pair_steps.amax(0)).any()
    sats = [int(w.n_saturated) for w, _ in runs]
    assert 0 < max(sats) <= int(whole.n_saturated) <= sum(sats)


def build_host_lib(tmp_path_factory, *defines):
    """Kernel F's source built for the host by a C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("needs a C++ compiler for the host build of kernel F")
    lib = tmp_path_factory.mktemp("fw") / "libflow_window_host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", *defines,
                    "-shared", "-fPIC", "-o", str(lib),
                    str(REPO / "shadow_tpu_torch/csrc/flow_window.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.flow_window_host.argtypes = [ctypes.c_int] * 10 + [
        ctypes.c_void_p, ctypes.c_int]
    lib.flow_window_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


@pytest.fixture(scope="module")
def host_kernel(host_lib):
    return host_lib.flow_window_host


@pytest.fixture(scope="module")
def host_kernel_reversed(tmp_path_factory):
    """The host build that runs lane b before lane a in every phase."""
    return build_host_lib(tmp_path_factory,
                          "-DFW_HOST_LANES_REVERSED").flow_window_host


def host_windows(fn, world, n_windows, window_us, cap, **opts):
    """Kernel F's thread loop, built for the host, on CPU tensors, with
    the wrapper's bookkeeping after it."""
    kw = dict(ack_every=2, sched_batch=8, pull_cap=8, gso_segs=16) | opts
    w = tfe.clone_world(world)
    C, Q = w.q_time.shape
    steps = torch.zeros(n_windows, dtype=torch.int32)
    sat = torch.zeros(n_windows, dtype=torch.int32)
    ts = tfe._pointers(w, steps, sat)
    ptrs = (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    assert fn(C // 2, Q, w.plane.reass_off.shape[1], n_windows, window_us,
              cap, kw["ack_every"], kw["sched_batch"], kw["pull_cap"],
              kw["gso_segs"], ptrs, len(ts)) == 0
    w.clock_us.add_(n_windows * window_us)
    w.n_saturated.add_(sat.sum().to(torch.int32))
    return w, steps


@pytest.mark.parametrize("cap", CAPS)
def test_kernel_f_host_build_matches_plain(host_kernel, plain_runs, cap):
    w0, out = plain_runs
    w, steps = host_windows(host_kernel, w0, N_WINDOWS, WINDOW_US, cap,
                            gso_segs=GSO)
    assert torch.equal(steps, out[cap][1])
    assert_worlds_equal(w, out[cap][0])


def test_kernel_f_host_build_matches_plain_on_tight_rings(host_kernel):
    """One-event batches, one pull a step and 4-slot rings: saturation
    and ring drops in nearly every window, GSO of four units."""
    w0 = port_world(6)
    w0 = w0._replace(q_time=w0.q_time[:, :4].contiguous(),
                     q_fields=w0.q_fields[:, :4].contiguous())
    opts = dict(sched_batch=1, pull_cap=1, gso_segs=4)
    want = tfe.run_windows_plain(w0, 50, WINDOW_US, max_events_per_window=3,
                                 **opts)
    got = host_windows(host_kernel, w0, 50, WINDOW_US, 3, **opts)
    assert int(want[0].n_saturated) > 0
    assert tfe.flow_results(want[0])["queue_drops"] > 0
    assert torch.equal(got[1], want[1])
    assert_worlds_equal(got[0], want[0])


@pytest.mark.parametrize("cap", CAPS)
def test_kernel_f_host_build_lanes_reversed_matches_plain(
        host_kernel_reversed, plain_runs, cap):
    """Lane b before lane a in every phase gives the same world: the
    phases the card runs on two threads at once touch disjoint state."""
    w0, out = plain_runs
    w, steps = host_windows(host_kernel_reversed, w0, N_WINDOWS, WINDOW_US,
                            cap, gso_segs=GSO)
    assert torch.equal(steps, out[cap][1])
    assert_worlds_equal(w, out[cap][0])


def test_kernel_f_host_build_lanes_reversed_matches_plain_on_tight_rings(
        host_kernel, host_kernel_reversed):
    """As the tight-ring test, lanes in both orders: each pull pushes
    into a ring its peer pops, on rings that fill."""
    w0 = port_world(6)
    w0 = w0._replace(q_time=w0.q_time[:, :4].contiguous(),
                     q_fields=w0.q_fields[:, :4].contiguous())
    opts = dict(sched_batch=1, pull_cap=1, gso_segs=4)
    want = tfe.run_windows_plain(w0, 50, WINDOW_US, max_events_per_window=3,
                                 **opts)
    assert tfe.flow_results(want[0])["queue_drops"] > 0
    for fn in (host_kernel, host_kernel_reversed):
        got = host_windows(fn, w0, 50, WINDOW_US, 3, **opts)
        assert torch.equal(got[1], want[1])
        assert_worlds_equal(got[0], want[0])


@pytest.mark.parametrize("queue_slots", [3, 6])
def test_kernel_f_host_build_matches_plain_on_rings_not_a_power_of_two(
        host_kernel, host_kernel_reversed, queue_slots):
    """A ring of Q slots where Q is no power of two takes its slot by
    division, not by the mask: both lane orders equal the plain run."""
    w0 = port_world(6)
    w0 = w0._replace(
        q_time=w0.q_time[:, :queue_slots].contiguous(),
        q_fields=w0.q_fields[:, :queue_slots].contiguous())
    opts = dict(sched_batch=2, pull_cap=2, gso_segs=4)
    want = tfe.run_windows_plain(w0, 50, WINDOW_US, max_events_per_window=3,
                                 **opts)
    assert tfe.flow_results(want[0])["queue_drops"] > 0
    assert int(want[0].q_head.max()) > queue_slots  # the rings wrapped
    for fn in (host_kernel, host_kernel_reversed):
        got = host_windows(fn, w0, 50, WINDOW_US, 3, **opts)
        assert torch.equal(got[1], want[1])
        assert_worlds_equal(got[0], want[0])


def ring_world(n_flows, queue_slots, head, jax_side=False):
    """The test world's first `n_flows` flows with rings of `queue_slots`
    slots whose heads start at `head` (every ring empty), so the first
    pushes wrap past the last slot; JAX's world when `jax_side`."""
    args, kw = world_args(n_flows)
    kw = dict(kw, queue_slots=queue_slots)
    if jax_side:
        w = jfe.make_flow_world(*args, **kw)
        w = mixed(w, np.asarray(w.total))
        return w._replace(q_head=jnp.full_like(w.q_head, head))
    w = tfe.make_flow_world(*args, device="cpu", **kw)
    w = mixed(w, w.total.numpy())
    return w._replace(q_head=torch.full_like(w.q_head, head))


@pytest.mark.parametrize("queue_slots", [16, 256, 1024])
def test_kernel_f_host_build_matches_plain_on_wrapping_rings(
        host_kernel, host_kernel_reversed, queue_slots):
    """Rings that wrap at once, and fill at Q=16, equal the plain run in
    both lane orders (the ring's times and fields read and written in
    the world's [C, Q] tensors)."""
    w0 = ring_world(6, queue_slots, queue_slots - 3)
    opts = dict(sched_batch=2, pull_cap=8, gso_segs=1)
    want = tfe.run_windows_plain(w0, 50, WINDOW_US, max_events_per_window=3,
                                 **opts)
    assert int(want[0].q_head.max()) > queue_slots  # the rings wrapped
    if queue_slots == 16:
        assert tfe.flow_results(want[0])["queue_drops"] > 0
    for fn in (host_kernel, host_kernel_reversed):
        got = host_windows(fn, w0, 50, WINDOW_US, 3, **opts)
        assert torch.equal(got[1], want[1])
        assert_worlds_equal(got[0], want[0])


@pytest.mark.parametrize("queue_slots", [28958, 30001, 32768])
def test_kernel_f_host_build_takes_rings_past_28957_slots(host_kernel,
                                                          queue_slots):
    """Rings larger than an earlier kernel F could stage in shared memory
    (28957 slots at RS=32): two flows whose rings wrap at once (by the
    mask at 32768, by division at 28958 and 30001) equal the plain run,
    and both equal JAX's `run_windows` on the same world."""
    w0 = ring_world(2, queue_slots, queue_slots - 2)
    j0 = ring_world(2, queue_slots, queue_slots - 2, jax_side=True)
    assert_worlds_equal(j0, w0)
    opts = dict(sched_batch=2, pull_cap=2, gso_segs=4)
    jw, jsteps = jax.jit(lambda w: jfe.run_windows(
        w, 50, WINDOW_US, max_events_per_window=3, **opts))(j0)
    want = tfe.run_windows_plain(w0, 50, WINDOW_US, max_events_per_window=3,
                                 **opts)
    assert int(want[0].q_head.max()) > queue_slots
    assert np.array_equal(np.asarray(jsteps), want[1].numpy())
    assert_worlds_equal(jw, want[0])
    got = host_windows(host_kernel, w0, 50, WINDOW_US, 3, **opts)
    assert torch.equal(got[1], want[1])
    assert_worlds_equal(got[0], want[0])


def test_kernel_f_staging_and_geometry(host_lib):
    """The wrapper's staged bytes are the source's (a pair's slots, ring
    heads and counts: 792 B at RS=32, whatever Q), and the launch spreads
    pairs over the SMs: bench_flows' 975 pairs in 122 blocks of 8 on 132
    SMs at any Q, the flow plan's largest rings included."""
    for rs in (1, 32, 33):
        assert host_lib.flow_window_pair_bytes(rs) == tfe.f_pair_bytes(rs)
    assert tfe.f_pair_bytes(32) == 792
    out = (ctypes.c_int * 3)()
    for n, q, want in ((1, 128, [1, 1, 792]), (33, 16, [1, 33, 792]),
                       (975, 128, [8, 122, 6336]),
                       (1024, 256, [8, 128, 6336]),
                       (975, 1024, [8, 122, 6336]),
                       (975, 28958, [8, 122, 6336]),
                       (975, 30001, [8, 122, 6336]),
                       (975, 256 << 8, [8, 122, 6336])):
        assert host_lib.flow_window_geometry(n, q, 32, 132, out) == 0
        assert list(out) == want, (n, q)
        assert want[2] == want[0] * tfe.f_pair_bytes(32)
    assert host_lib.flow_window_geometry(5, 0, 32, 132, out) == 1
    assert host_lib.flow_window_geometry(5, 16, 32, 0, out) == 1


def test_flow_window_refuses_a_ring_it_cannot_stage(monkeypatch, host_kernel):
    """Kernel F keeps its rings in device memory, so no Q is too large to
    stage: one past the 28957 slots an earlier layout staged in shared
    memory passes `flow_window_`'s checks and launches, and the host
    build runs it. What F does refuse is a world of unpaired lanes
    (ValueError before any launch) and, in its host build, an empty
    ring."""
    launched = []
    monkeypatch.setattr(tfe, "_launch_f", lambda *a: launched.append(a))
    for q in (28958, 40000):
        w = tfe.make_flow_world([5000], [10_000], queue_slots=q,
                                device="cpu")
        steps = torch.zeros(2, dtype=torch.int32)
        ts = tfe._pointers(w, steps, torch.zeros(2, dtype=torch.int32))
        ptrs = (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
        assert host_kernel(1, q, 32, 2, 2000, 512, 2, 8, 8, 16, ptrs,
                           len(ts)) == 0
        assert host_kernel(1, 0, 32, 2, 2000, 512, 2, 8, 8, 16, ptrs,
                           len(ts)) == 1
        before = len(launched)
        tfe.flow_window_(w, 2, 2000)
        assert len(launched) == before + 1
        assert launched[-1][1][:3] == (1, q, 32)
    odd = tfe.FlowWorld(tfe.dtcp.TcpPlane(*(t[:1] for t in w.plane)),
                        *(t if t.dim() == 0 else t[:1] for t in w[1:]))
    with pytest.raises(ValueError, match="not whole pairs"):
        tfe.flow_window_(odd, 2, 2000)
    assert len(launched) == 2


def test_flow_window_refuses_a_slot_count_it_was_not_built_for(monkeypatch):
    """Kernel F is compiled for `make_flow_world`'s 32 reassembly slots a
    lane: a world with another count raises ValueError before any
    launch."""
    launched = []
    monkeypatch.setattr(tfe, "_launch_f", lambda *a: launched.append(a))
    w = tfe.make_flow_world([5000], [10_000], device="cpu")
    assert w.plane.reass_off.shape[1] == tfe.F_RS
    p = w.plane
    w16 = w._replace(plane=p._replace(
        reass_off=p.reass_off[:, :16].contiguous(),
        reass_len=p.reass_len[:, :16].contiguous()))
    with pytest.raises(ValueError, match="32 reassembly slots"):
        tfe.flow_window_(w16, 2, 2000)
    assert launched == []
    tfe.flow_window_(w, 2, 2000)
    assert len(launched) == 1


def test_run_to_completion_doubles_the_cap_until_no_window_saturates():
    w0 = port_world(4)
    w0 = w0._replace(total=torch.clamp(w0.total, max=15_000))
    w, sim_s, retries = tfe.run_to_completion(
        w0, WINDOW_US, max_sim_s=2.0, chunk_windows=40, probe_every=2,
        max_events_per_window=1, gso_segs=GSO)
    assert retries >= 1 and int(w.n_saturated) == 0
    assert tfe.all_complete(w)
    # the accepted attempt is a fresh run at the final cap
    ref, windows = w0, 0
    while windows < round(sim_s * 1e6 / WINDOW_US):
        ref, _ = tfe.run_windows_plain(ref, 40, WINDOW_US,
                                       max_events_per_window=2 ** retries,
                                       gso_segs=GSO)
        windows += 40
    assert_worlds_equal(w, ref)
    # and JAX's host-side readers agree on it
    jw = convert.flow_world_to_numpy(w)
    jw = jfe.FlowWorld(plane=jfe.dtcp.TcpPlane(**{
        k: jnp.asarray(v) for k, v in jw.pop("plane").items()}),
        **{k: jnp.asarray(v) for k, v in jw.items()})
    got, want = tfe.flow_results(w), jfe.flow_results(jw)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert bool(tfe.all_complete(w)) == jfe.all_complete(jw)
    assert np.array_equal(tfe._status_flags(w).numpy(),
                          np.asarray(jfe._status_flags(jw)))
    stop = int(w.clock_us) + 70_000_000
    assert_worlds_equal(jfe.finalize_to(jw, stop), tfe.finalize_to(w, stop))


def test_split_merge_round_trip_matches_jax(plain_runs):
    w = plain_runs[1][2][0]
    sharded = tfe.split_flow_world(w, 4)
    assert sharded.q_fields.shape == (4, N_FLOWS // 2, 16, 16)
    assert sharded.n_saturated.tolist() == [int(w.n_saturated), 0, 0, 0]
    assert_worlds_equal(tfe.merge_flow_world(sharded), w)
    jw = convert.flow_world_to_numpy(w)
    jw = jfe.FlowWorld(plane=jfe.dtcp.TcpPlane(**{
        k: jnp.asarray(v) for k, v in jw.pop("plane").items()}),
        **{k: jnp.asarray(v) for k, v in jw.items()})
    assert_worlds_equal(jfe.split_flow_world(jw, 4), sharded)
    with pytest.raises(ValueError, match="pair-aligned"):
        tfe.split_flow_world(w, 3)


def test_run_to_completion_reads_the_host_only_where_jax_does():
    """One status read every `probe_every` chunks and the saturation
    count at the end of an attempt (JAX's two `device_get`s); the chunk
    runner here reads nothing, as kernel F's launch does not."""
    import chip_smoke

    w0 = port_world(2)
    calls = []

    def run_fn(w, cap):
        calls.append(cap)
        return w, torch.zeros(10, dtype=torch.int32)

    (w, sim_s, retries), reads = chip_smoke.count_host_reads(
        torch, tfe.run_to_completion, w0, WINDOW_US, max_sim_s=0.1,
        chunk_windows=10, probe_every=2, run_fn=run_fn)
    n_chunks = int(0.1 * 1e6 / (WINDOW_US * 10)) + 1
    assert retries == 0 and len(calls) == n_chunks
    assert reads == n_chunks // 2 + 1


def test_kernel_f_wrapper_reads_nothing_back():
    """`flow_window_`, the launch and `run_windows` call no host read
    (the shape and dtype checks read metadata only)."""
    import ast
    import inspect
    import textwrap

    reads = {"item", "cpu", "tolist", "numpy", "nonzero", "synchronize",
             "bool", "int", "float"}
    for fn in (tfe.flow_window_, tfe._launch_f, tfe._pointers,
               tfe.run_windows):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        called = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                called.add(f.attr if isinstance(f, ast.Attribute)
                           else getattr(f, "id", ""))
        if fn is tfe.flow_window_:
            # int() of the Python option arguments only
            ints = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "int"]
            assert all(isinstance(n.args[0], ast.Name) for n in ints)
            called.discard("int")
        assert not called & reads, (fn.__name__, called & reads)

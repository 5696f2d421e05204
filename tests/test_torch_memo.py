"""The port's chain memo against the JAX package's, bitwise: the memo key
of the same converted carry (every presence plane, the flight recorder's
uint32 leaves included), the memo report and canonical digest of
memoized runs (the ring-allreduce memo scenario, faulted entries whose
fault events fire after memo hits), `--memo --check` on the corpus,
hits served from a persisted cache (`memo_cache`), the cache's save,
load, spill and absorb, and the driver's refusal of a memo with unsalted
per-round inputs."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shadow_tpu.guards.plane import GuardState as JGuardState  # noqa: E402
from shadow_tpu.telemetry.flightrec import (  # noqa: E402
    FlightRecArrays as JFlightRecArrays)
from shadow_tpu.telemetry.histo import (  # noqa: E402
    PlaneHistograms as JPlaneHistograms)
from shadow_tpu.telemetry.metrics import PlaneMetrics as JPlaneMetrics  # noqa: E402
from shadow_tpu.tpu import memo as jmemo  # noqa: E402
from shadow_tpu.tpu.codel import RouterDownState as JRouter  # noqa: E402
from shadow_tpu.tpu.flows import FlowState as JFlowState  # noqa: E402
from shadow_tpu.tpu.plane import NetPlaneState as JNetPlaneState  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu.workloads.device import WorkloadState as JWorkloadState  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.faults.checkpoint import CheckpointError  # noqa: E402
from shadow_tpu_torch.guards.plane import make_guards  # noqa: E402
from shadow_tpu_torch.telemetry import flightrec, histo  # noqa: E402
from shadow_tpu_torch.telemetry.metrics import make_metrics  # noqa: E402
from shadow_tpu_torch.tpu import elastic  # noqa: E402
from shadow_tpu_torch.tpu import flows as tflows  # noqa: E402
from shadow_tpu_torch.tpu import memo as tmemo  # noqa: E402
from shadow_tpu_torch.workloads import compile as tcompile  # noqa: E402
from shadow_tpu_torch.workloads import device as tdevice  # noqa: E402
from shadow_tpu_torch.workloads import run_scenarios  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

CORPUS = Path(__file__).resolve().parent.parent / "scenarios"
JAX_CLASSES = {c.__name__: c for c in (
    JNetPlaneState, JRouter, JWorkloadState, JPlaneMetrics, JGuardState,
    JPlaneHistograms, JFlightRecArrays, JFlowState)}


def _random_carry(seed):
    """A port carry with every plane on but compute, its leaves drawn at
    random in their dtypes (the flight recorder's key as uint32 words)."""
    rng = np.random.default_rng(seed)
    spec = tspec.load_scenario_file(str(CORPUS / "rpc_fanout_lossy.yaml"))
    prog = tcompile.compile_program(spec)
    state, _ = trunner.build_scenario_world(spec, device="cpu")
    n = spec.n_hosts
    carry = (state, (tdevice.make_workload_state(prog, "cpu"),
                     make_metrics(n, device="cpu"),
                     make_guards(n, device="cpu"),
                     histo.make_histograms(n, device="cpu"),
                     flightrec.make_flightrec(5, device="cpu", ring=64),
                     tflows.make_flow_state(prog.flow_src.shape[0],
                                            device="cpu"),
                     None))

    def draw(owner, field, t):
        if (owner, field) in convert.HOST_DTYPES:
            return torch.from_numpy(rng.integers(0, 2**32, t.shape))
        if t.dtype == torch.bool:
            return torch.from_numpy(rng.random(t.shape) < 0.5)
        if t.dtype.is_floating_point:
            return torch.from_numpy(rng.random(t.shape).astype(np.float32))
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, t.shape).astype(np.int32)).to(t.dtype)

    return convert.map_carry(draw, carry)


def _as_jax_host(host):
    """A port host carry rebuilt in the JAX package's classes as jnp
    arrays, then pulled back as JAX does."""
    def rec(node):
        if node is None:
            return None
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return JAX_CLASSES[type(node).__name__](*map(rec, node))
        if isinstance(node, tuple):
            return tuple(map(rec, node))
        return jnp.asarray(node)
    return jax.device_get(rec(host))


@pytest.mark.parametrize("seed", [0, 1])
def test_key_equals_jax_key_for_the_same_carry(seed):
    carry = _random_carry(seed)
    salt, span = b"scenario|knobs", b"fault-span"
    tm = tmemo.ChainMemo(salt=salt)
    host = tm.snapshot(*carry)
    assert host[1][4].key.dtype == np.uint32
    jm = jmemo.ChainMemo(salt=salt)
    jhost = _as_jax_host(host)
    for r0, r1 in ((0, 4), (8, 12)):
        tkey, twalk = tm.key(host, r0, r1, span_salt=span)
        jkey, jwalk = jm.key(jhost, r0, r1, span_salt=span)
        assert tkey == jkey
        assert [(o, f, a.dtype, a.shape) for o, f, a in twalk] == \
            [(o, f, a.dtype, a.shape) for o, f, a in jwalk]
    # the host carry goes back to the port's tensors, dtypes included
    back = tm.to_device(host)
    assert back[1][4].key.dtype == torch.int64
    assert convert.digest_pytrees(*back[1][:6]) == \
        convert.digest_pytrees(*carry[1][:6])


@pytest.mark.parametrize("entry,kw", [
    ("ring_allreduce", {}),
    ("rpc_fanout_lossy", dict(use_default_faults=True)),
    ("mixed", dict(use_default_faults=True, guards=True)),
])
def test_memoized_record_equals_jax_and_the_plain_run(entry, kw):
    """The memo report (hits, misses, fast-forwarded windows, entries)
    and the canonical digest equal JAX's, and the digest the unmemoized
    run's: under faults the device masks are rebuilt after a hit
    advanced the schedule outside the chain."""
    path = str(CORPUS / f"{entry}.yaml")
    got = trunner.run_scenario(tspec.load_scenario_file(path), memo=True,
                               device="cpu", **kw)
    want = jrunner.run_scenario(jspec.load_scenario_file(path), memo=True,
                                **kw)
    assert got == want
    assert got["memo"]["hits"] > 0 and got["memo"]["entries"] > 0
    plain = trunner.run_scenario(tspec.load_scenario_file(path),
                                 device="cpu", **kw)
    assert got["canonical_digest"] == plain["canonical_digest"]


def test_memo_check_on_the_corpus(capsys):
    paths = [str(CORPUS / f"{e}.yaml") for e in (
        "incast_lossy", "mixed", "ring_allreduce", "serve_diurnal")]
    assert run_scenarios.main(paths + ["--device", "cpu", "--memo",
                                       "--check"]) == 0
    err = capsys.readouterr().err
    assert "match the golden digests" in err and "memo=" in err


def test_persisted_cache_serves_hits_on_the_second_invocation(tmp_path):
    path = str(CORPUS / "ring_allreduce.yaml")
    cache = str(tmp_path / "ring.memo.npz")
    tspc = tspec.load_scenario_file(path)
    first = trunner.run_scenario(tspc, memo=True, memo_cache=cache,
                                 device="cpu")
    second = trunner.run_scenario(tspc, memo=True, memo_cache=cache,
                                  device="cpu")
    jcache = str(tmp_path / "ring.jax.memo.npz")
    jspc = jspec.load_scenario_file(path)
    jrunner.run_scenario(jspc, memo=True, memo_cache=jcache)
    jsecond = jrunner.run_scenario(jspc, memo=True, memo_cache=jcache)
    assert second == jsecond
    assert second["memo"]["persisted_hits"] > 0
    assert second["memo"]["loaded_entries"] == first["memo"]["entries"]
    assert second["canonical_digest"] == first["canonical_digest"]
    # the port reads the JAX package's cache file, and the other way
    assert trunner.run_scenario(tspc, memo=True, memo_cache=jcache,
                                device="cpu")["memo"] == jrunner.run_scenario(
        jspc, memo=True, memo_cache=cache)["memo"]
    with pytest.raises(ValueError, match="memo_cache requires memo"):
        trunner.run_scenario(tspc, memo_cache=cache, device="cpu")


def test_save_load_spill_absorb(tmp_path):
    carry = _random_carry(3)
    m = tmemo.ChainMemo(salt=b"world")
    host = m.snapshot(*carry)
    key, walk = m.key(host, 0, 4)
    assert m.lookup(key) is None
    assert m.record(key, walk, host, span_len=4)
    assert m.lookup(key) is not None
    path = str(tmp_path / "c.npz")
    m.save(path)
    other = tmemo.ChainMemo(salt=b"world")
    assert other.load(path) == 1
    entry = other.lookup(key)
    assert other.stats()["persisted_hits"] == 1
    replayed = other.replay(entry, host)
    # bytes and dtypes, as the digests read them (a replayed 0-d keyed
    # leaf comes back with shape (1,), as in the JAX memo)
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for (_o, _f, a), (_p, _g, b) in zip(
                   tmemo.walk_carry(replayed), tmemo.walk_carry(host)))
    meta, arrays = m.spill(prefix="memo.")
    exact = tmemo.ChainMemo(salt=b"world")
    exact.absorb(meta, arrays, prefix="memo.", restore=True)
    assert exact.report() == m.report()
    with pytest.raises(CheckpointError, match="salt"):
        tmemo.ChainMemo(salt=b"elsewhere").load(path)
    del arrays[next(iter(arrays))]
    with pytest.raises(CheckpointError, match="missing serialized leaf"):
        tmemo.ChainMemo(salt=b"world").absorb(meta, arrays, prefix="memo.")


def test_memo_with_unsalted_per_round_is_refused():
    state, _ = trunner.build_scenario_world(
        tspec.load_scenario_file(str(CORPUS / "incast.yaml")), device="cpu")
    with pytest.raises(ValueError, match="memo_span_salt"):
        elastic.drive_chained_windows(
            state, (), lambda *a: None, n_rounds=4, chain_len=2,
            per_round=lambda r0, r1: [None] * (r1 - r0),
            memo=tmemo.ChainMemo())


def masks_checked(monkeypatch, schedule):
    """Wrap the runner's `window_step` so each call's fault masks are
    held against the schedule's host masks at that moment (the masks
    window r must run under); returns the list of mismatching calls."""
    bad = []
    step = trunner.window_step

    def checked(*args, faults=None, **kw):
        got = [t.numpy() for t in (faults.host_alive, faults.link_up,
                                   faults.lat_mult, faults.bw_div,
                                   faults.corrupt_p)]
        want = [schedule.host_alive, schedule.link_up, schedule.lat_mult,
                schedule.bw_div, schedule.corrupt_p]
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            bad.append(len(schedule.fired))
        return step(*args, faults=faults, **kw)

    monkeypatch.setattr(trunner, "window_step", checked)
    return bad


def test_fault_masks_are_rebuilt_after_a_memo_replay(monkeypatch,
                                                    tmp_path):
    """A hit moves the schedule in its span salt, outside the chain: a
    second run from a persisted cache replays spans in which fault
    events fire, and the windows it then runs must run under the masks
    of those events, not the cached ones."""
    spec = tspec.load_scenario_file(str(CORPUS / "mixed.yaml"))
    kw = dict(memo=True, memo_cache=str(tmp_path / "c.npz"),
              sample_every=8, device="cpu")
    first = trunner.run_scenario(spec, use_default_faults=True, **kw)
    schedule = trunner.default_fault_schedule(spec)
    bad = masks_checked(monkeypatch, schedule)
    second = trunner.run_scenario(spec, fault_events=schedule, **kw)
    assert second["memo"]["persisted_hits"] > 0 and not bad
    first.pop("memo")
    second.pop("memo")
    assert second == first

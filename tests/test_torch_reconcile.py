"""The port's copies of the transport's satellite modules against the JAX
package's, exactly (equal values, equal floats, equal exceptions):
`guards/reconcile.py` (per-host and fleet reconciliation, the
`TransportReconciler` hook), the retry trio of `faults/healing.py`
(with the pinned backoff floats of the JAX tests), `FaultSchedule.
filter_send`, and the Manager snapshots of `faults/checkpoint.py`
taken of a JAX Manager run over the port's transport."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import test_tpu_transport as ref  # noqa: E402
from shadow_tpu.core.config import load_config_str  # noqa: E402
from shadow_tpu.core.manager import Manager  # noqa: E402
from shadow_tpu.core.rng import Xoshiro256pp  # noqa: E402
from shadow_tpu.faults import checkpoint as jckpt  # noqa: E402
from shadow_tpu.faults import healing as jheal  # noqa: E402
from shadow_tpu.faults import schedule as jsched  # noqa: E402
from shadow_tpu.guards import reconcile as jrec  # noqa: E402
from shadow_tpu.tpu import transport as jtr  # noqa: E402
from shadow_tpu_torch.faults import checkpoint as tckpt  # noqa: E402
from shadow_tpu_torch.faults import healing as theal  # noqa: E402
from shadow_tpu_torch.faults import schedule as tsched  # noqa: E402
from shadow_tpu_torch.guards import reconcile as trec  # noqa: E402
from shadow_tpu_torch.tpu import transport as ttr  # noqa: E402

NAMES = [f"h{i}" for i in range(40)]


def as_dicts(violations):
    return [dataclasses.asdict(v) for v in violations]


def counters(seed, n=40, flips=0):
    rng = np.random.default_rng(seed)
    led = {"captured": rng.integers(0, 1000, n),
           "released": rng.integers(0, 1000, n)}
    dev = {"pkts_out": led["captured"].astype(np.int32).copy(),
           "pkts_in": led["released"].astype(np.int32).copy(),
           "drop_ring_full": np.zeros(n, np.int32)}
    for i in rng.choice(n, flips, replace=False):
        dev["pkts_out" if i % 2 else "pkts_in"][i] += 3
    return dev, led


@pytest.mark.parametrize("flips,cap", [(0, 32), (5, 32), (30, 8)])
def test_reconcile_per_host_and_fleet_match_jax(flips, cap):
    dev, led = counters(flips, flips=flips)
    for names in (NAMES, None, NAMES[:10]):
        got = trec.reconcile_per_host(7, dev, led, trec.TRANSPORT_PAIRS,
                                      names, max_violations=cap)
        want = jrec.reconcile_per_host(7, dev, led, jrec.TRANSPORT_PAIRS,
                                       names, max_violations=cap)
        assert as_dicts(got) == as_dicts(want)
        assert len(got) == min(flips, cap) + (flips > cap)
    checks = [("a", 1, 1, "same"), ("b", 2, 3, "off"), ("c", 0, -1, "neg")]
    assert as_dicts(trec.reconcile_fleet(9, checks)) == as_dicts(
        jrec.reconcile_fleet(9, checks))
    assert trec.TRANSPORT_PAIRS == jrec.TRANSPORT_PAIRS


class StubTransport:
    """The reconciler's view of a transport, over given counters."""

    def __init__(self, dev, led, in_flight, wrap):
        self._dev, self._led, self._in_flight = dev, led, in_flight
        self._wrap = wrap

    def telemetry_arrays(self):
        return {k: self._wrap(v) for k, v in self._dev.items()}

    def cpu_ledger(self):
        return {k: v.copy() for k, v in self._led.items()}

    def device_in_flight(self):
        return self._in_flight


@pytest.mark.parametrize("mid_run", [True, False])
@pytest.mark.parametrize("flips,in_flight", [(0, 0), (3, 2)])
def test_transport_reconciler_matches_jax(mid_run, flips, in_flight):
    dev, led = counters(11, flips=flips)
    dev["drop_ring_full"][0] = 4
    # conserved on the ledger: captured = released + dropped + in flight
    fix = int(led["released"].sum()) + 4 + in_flight - int(
        led["captured"].sum())
    led["captured"][1] += fix
    dev["pkts_out"][1] += fix
    mk = lambda rec, wrap: rec.TransportReconciler(
        StubTransport(dev, led, in_flight, wrap), NAMES, mid_run=mid_run)
    tr, jr = mk(trec, torch.from_numpy), mk(jrec, jnp.asarray)
    for r in (tr, jr):
        r.note_tick(100)
    totals = {k: v.astype(np.int64) for k, v in dev.items()}
    assert as_dicts(tr.on_drain(100, totals, None)) == as_dicts(
        jr.on_drain(100, totals, None))
    assert tr.on_drain(5, totals, None) == []
    sent = int(led["captured"].sum()) + flips
    got = tr.final(200, packets_sent=sent)
    assert as_dicts(got) == as_dicts(jr.final(200, packets_sent=sent))
    assert bool(got) == bool(flips)


# -- the retry trio ----------------------------------------------------------


ERRORS = [RuntimeError("UNAVAILABLE: link reset"), ValueError(
    "RESOURCE_EXHAUSTED looks transient but is not"), TypeError("x"),
    KeyError("DEADLINE_EXCEEDED"), AssertionError("ABORTED"),
    OSError("Broken pipe"), RuntimeError("CUDA error: illegal address"),
    RuntimeError("temporarily unavailable"), Exception("ABORTED")]


def test_transient_classifier_matches_jax():
    for e in ERRORS:
        assert theal.is_transient_device_error(e) == \
            jheal.is_transient_device_error(e), e


def test_backoff_schedule_pinned_and_equal_to_jax():
    got = theal.backoff_schedule(4, base_s=0.05, cap_s=2.0, jitter=0.5,
                                 seed=0, what="device dispatch")
    # the frozen first draw of the JAX tests (tests/test_faults.py)
    assert round(got[0], 12) == round(0.045871920679567496, 12)
    for kw in ({}, {"seed": 7}, {"what": "device transport chain"},
               {"base_s": 0.01, "cap_s": 0.04, "jitter": 0.25}):
        assert theal.backoff_schedule(9, **kw) == \
            jheal.backoff_schedule(9, **kw)
    assert theal.backoff_schedule(8, base_s=0.05, cap_s=0.4,
                                  jitter=0.0) == (
        0.05, 0.1, 0.2, 0.4, 0.4, 0.4, 0.4, 0.4)
    assert theal.backoff_schedule(0) == ()
    with pytest.raises(ValueError, match="attempts"):
        theal.backoff_schedule(-1)
    with pytest.raises(ValueError, match="jitter"):
        theal.backoff_schedule(2, jitter=1.5)


def test_retry_transient_sleeps_the_schedule_and_reraises(monkeypatch):
    slept = {"port": [], "jax": []}

    def flaky_fn():
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise RuntimeError("UNAVAILABLE: link reset")
            return len(calls)

        return flaky

    kw = dict(attempts=3, backoff_s=0.05, cap_s=2.0, jitter=0.5, seed=7,
              what="device transport step")
    # both modules sleep through the one `time` module: patch it in turn
    monkeypatch.setattr(theal._walltime, "sleep", slept["port"].append)
    assert theal.retry_transient(flaky_fn(), **kw) == 4
    monkeypatch.setattr(jheal._walltime, "sleep", slept["jax"].append)
    assert jheal.retry_transient(flaky_fn(), **kw) == 4
    assert slept["port"] == slept["jax"] == list(
        theal.backoff_schedule(3, base_s=0.05, seed=7,
                               what="device transport step"))
    for mod in (theal, jheal):
        calls = []

        def buggy():
            calls.append(1)
            raise ValueError("RESOURCE_EXHAUSTED looks transient")

        with pytest.raises(ValueError):
            mod.retry_transient(buggy, attempts=3)
        assert len(calls) == 1
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            mod.retry_transient(flaky_fn(), attempts=2)


# -- the send filter -----------------------------------------------------------


class Host:
    def __init__(self, name, seed, down=False):
        self.name = name
        self.rng = Xoshiro256pp(seed)
        self.fault_down = down


class Packet:
    def __init__(self, size):
        self._size = size

    def payload_size(self):
        return self._size


def test_filter_send_matches_jax():
    """Both schedules in one mask state (a latency multiplier on some
    node pairs, corruption bursts on some hosts, a raw node-id map), each
    over its own copy of the hosts: the same (drop, latency') for a
    seeded run of sends, and the same host RNG streams after."""
    rng = np.random.default_rng(3)
    names = [f"h{i}" for i in range(6)]
    scheds = [mod.FaultSchedule([], names, 4) for mod in (jsched, tsched)]
    lat_mult = rng.integers(1, 4, (4, 4)).astype(np.int32)
    corrupt = np.array([0, 0.5, 0, 0.9, 0.2, 0], np.float32)
    for s in scheds:
        s.lat_mult[:] = lat_mult
        s.corrupt_p[:] = corrupt
    hosts = [[Host(n, 100 + i, down=(i == 5)) for i, n in enumerate(names)]
             for _ in scheds]
    for step in range(400):
        if step == 200:
            for s in scheds:  # raw graph ids 10..13 -> dense 0..3
                s._node_map = {10 + k: k for k in range(4)}
        a, b = rng.integers(0, 6, 2)
        na, nb = (int(x) + (10 if step >= 200 else 0)
                  for x in rng.integers(-1, 5, 2))
        size = int(rng.integers(0, 2)) * 100
        lat = int(rng.integers(1, 10**6))
        got = [s.filter_send(h[a], h[b], Packet(size), na, nb, lat)
               for s, h in zip(scheds, hosts)]
        assert got[0] == got[1], step
    for hj, ht in zip(*hosts):
        assert hj.rng.s == ht.rng.s


# -- manager snapshots -----------------------------------------------------------


class PortTransport(ttr.DeviceTransport):
    def __init__(self, *args, **kw):
        super().__init__(*args, device="cpu", **kw)


def snapshot_manager(port: bool, guards: bool):
    cfg = ref.PHOLD.format(device="true").replace(
        "use_tpu_transport: true",
        "use_tpu_transport: true, tpu_transport_mode: sync")
    if guards:
        cfg += "guards: {enabled: true}\n"
    orig = jtr.DeviceTransport
    if port:
        jtr.DeviceTransport = PortTransport
    try:
        mgr = Manager(load_config_str(cfg))
        mgr.run()
    finally:
        jtr.DeviceTransport = orig
    return mgr


@pytest.fixture(scope="module")
def managers():
    return {port: snapshot_manager(port, guards=port)
            for port in (False, True)}


def _strip(meta):
    meta = dict(meta)
    meta["stats"] = {k: v for k, v in meta["stats"].items()
                     if k != "wall_seconds"}
    meta.pop("guards", None)
    return meta


def test_manager_snapshot_matches_jax(managers, tmp_path):
    """The port's `manager_snapshot` of the Manager on the port's
    transport equals JAX's of the Manager on the JAX transport (the wall
    time and the guard ledger aside: the port run has guards on), and
    JAX's snapshot of the same port-transport Manager reads its tensors
    alike; `write_manager_checkpoint` writes what JAX's loader reads."""
    jm, pm = managers[False], managers[True]
    assert isinstance(pm.transport, PortTransport)
    want = jckpt.manager_snapshot(jm, 123, reason="periodic")
    got = tckpt.manager_snapshot(pm, 123, reason="periodic")
    assert _strip(got["meta"]) == _strip(want["meta"])
    assert got["meta"]["guards"]["total"] == 0
    assert got["arrays"].keys() == want["arrays"].keys()
    for k, v in want["arrays"].items():
        assert v.dtype == got["arrays"][k].dtype
        assert np.array_equal(v, got["arrays"][k]), k
    same = jckpt.manager_snapshot(pm, 123, reason="periodic")
    assert same["meta"] == got["meta"]
    for k, v in same["arrays"].items():
        assert np.array_equal(v, got["arrays"][k]), k
    path = tckpt.write_manager_checkpoint(pm, str(tmp_path), 123,
                                          reason="periodic")
    meta, arrays = jckpt.load_checkpoint(path)
    assert meta["kind"] == "manager" and meta["clock_ns"] == 123
    for k, v in got["arrays"].items():
        assert np.array_equal(arrays[k], v), k
    assert tckpt.write_manager_checkpoint(
        object(), str(tmp_path), 1, reason="emergency") is None

"""The port's device transport end to end: the JAX package's Manager,
with `shadow_tpu_torch.tpu.transport.DeviceTransport` (on the CPU) in
place of its own, against the same Manager on the JAX transport and on
the CPU transport, bitwise.

The Manager imports `DeviceTransport` when it is built, so each run here
sets the JAX module's name to the port's class for the run's length.
Each host's packet-status trace (every status transition with its
simulated time, in the order that host saw them) must equal both
references' and the stats must equal the JAX transport run's; mirrored
runs verify every window with no divergence, as many windows and packets
as the JAX transport verifies. The traces are compared per host: the
global trace interleaves the worker threads, so its order is not a
property of either transport.

Also here: the port's twins of the JAX transport tests (a poisoned CPU
ledger is caught, sparse window gaps survive, a runahead that shrinks
mid-run, a guarded run that stays clean, elastic growth), and the
committed call logs replayed through `tools/transport_replay.py`."""

from __future__ import annotations

import collections
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_elastic as ref_elastic  # noqa: E402
import test_guards as ref_guards  # noqa: E402
import test_tpu_transport as ref  # noqa: E402
from shadow_tpu.core.config import load_config_str  # noqa: E402
from shadow_tpu.core.manager import Manager  # noqa: E402
from shadow_tpu.guards import reconcile as jreconcile  # noqa: E402
from shadow_tpu.tpu import transport as jtr  # noqa: E402
from shadow_tpu_torch.guards import reconcile as treconcile  # noqa: E402
from shadow_tpu_torch.tools import transport_replay as replay  # noqa: E402
from shadow_tpu_torch.tpu import transport as ttr  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORKLOADS = REPO / "shadow_tpu_torch" / "workloads"
PHOLD_LOG = WORKLOADS / "phold_transport.log.npz"
RUNG3_LOG = WORKLOADS / "rung3_transport.log.npz"
#: rung-3 releases replayed in tier-1 (the card replays all of them)
RUNG3_ROUNDS = 300

CONFIGS = {"basic-file-transfer": ref.BASIC, "phold": ref.PHOLD,
           "lossy": ref.LOSSY}
MODES = ("sync", "mirrored")


class PortTransport(ttr.DeviceTransport):
    """The port's transport as the Manager builds it, on the CPU."""

    def __init__(self, *args, **kw):
        super().__init__(*args, device="cpu", **kw)


class port_transport:
    """Within the block the Manager builds the port's transport."""

    def __enter__(self):
        self._orig = jtr.DeviceTransport
        jtr.DeviceTransport = PortTransport

    def __exit__(self, *exc):
        jtr.DeviceTransport = self._orig


def per_host(trace) -> dict:
    """A packet-status trace split by host, each host's order kept."""
    out = collections.defaultdict(list)
    for row in trace:
        out[row[0]].append(row[1:])
    return dict(out)


def stats_of(s) -> dict:
    d = s.as_dict()
    d.pop("wall_seconds", None)
    return d


def run(cfg: str, mode, *, port: bool):
    """(stats, per-host traces, the run's transport or None)."""
    if port:
        with port_transport():
            stats, trace, mgr = ref._run_traced(cfg, mode=mode)
        assert isinstance(mgr.transport, PortTransport)
    else:
        stats, trace, mgr = ref._run_traced(cfg, mode=mode)
    return stats, per_host(trace), mgr.transport


@pytest.fixture(scope="module")
def references():
    """Each config's CPU-transport run and JAX-transport runs, once."""
    cache = {}

    def get(name, mode=None):
        key = (name, mode)
        if key not in cache:
            cfg = CONFIGS[name]
            cache[key] = (run(cfg.format(device="false"), None, port=False)
                          if mode is None else
                          run(cfg.format(device="true"), mode, port=False))
        return cache[key]

    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_manager_on_the_port_transport_matches_jax_and_cpu(
        references, name, mode):
    s_cpu, t_cpu, _ = references(name)
    s_jax, t_jax, tr_jax = references(name, mode)
    s_dev, t_dev, tr = run(CONFIGS[name].format(device="true"), mode,
                           port=True)
    assert t_dev == t_jax
    assert t_dev == t_cpu
    assert sum(len(v) for v in t_dev.values()) > 1000
    assert stats_of(s_dev) == stats_of(s_jax)
    assert (s_dev.packets_sent, s_dev.packets_dropped) == (
        s_cpu.packets_sent, s_cpu.packets_dropped)
    assert tr.mode == mode and tr.in_flight == tr_jax.in_flight
    assert tr.dispatches > 0
    if mode == "mirrored":
        assert tr.divergence_count == 0
        assert tr.in_flight == 0
        assert (tr.verified_windows, tr.verified_packets) == (
            tr_jax.verified_windows, tr_jax.verified_packets)
        assert tr.verified_packets > 0


def test_mirrored_detects_divergence():
    """Twin of the JAX test: one expected deliver time poisoned by 1 ns
    moves the divergence counter, and the run fails."""
    cfg = load_config_str(ref.PHOLD.format(device="true").replace(
        "use_tpu_transport: true",
        "use_tpu_transport: true, tpu_transport_mode: mirrored"))
    with port_transport():
        mgr = Manager(cfg)
    t = mgr.transport
    assert isinstance(t, PortTransport)
    orig = t._pop_expected
    poisoned = {"done": False}

    def poison(end_ns):
        expected = orig(end_ns)
        if not poisoned["done"] and expected:
            deliver, tag, dst = expected[0]
            expected[0] = (deliver + 1, tag, dst)
            poisoned["done"] = True
        return expected

    t._pop_expected = poison
    stats = mgr.run()
    assert poisoned["done"]
    assert t.divergence_count >= 1
    assert any(name == "device-transport" and "diverged" in why
               for name, why in stats.process_failures)


SPARSE = """
general: {stop_time: 60s, seed: 9}
network: {graph: {type: 1_gbit_switch}}
experimental: {use_tpu_transport: true, tpu_transport_mode: mirrored}
hosts:
  server:
    network_node_id: 0
    processes:
    - {path: udp-echo-server, args: ["9000"], start_time: 1s,
       expected_final_state: running}
  early:
    network_node_id: 0
    processes:
    - {path: udp-client, args: ["server", "9000", "100", "3"], start_time: 2s}
  late:
    network_node_id: 0
    processes:
    - {path: udp-client, args: ["server", "9000", "100", "3"], start_time: 55s}
"""


def test_mirrored_survives_sparse_window_gaps():
    """Twin of the JAX test: ~50 idle simulated seconds between
    exchanges keep every device shift inside int32."""
    with port_transport():
        mgr = Manager(load_config_str(SPARSE))
    stats = mgr.run()
    assert stats.process_failures == []
    assert mgr.transport.divergence_count == 0
    assert mgr.transport.verified_windows > 0


@pytest.mark.parametrize("mode", MODES)
def test_dynamic_runahead_transport_parity(mode):
    """Twin of the JAX test: the runahead shrinks tenfold mid-run and the
    port's transport stays equal to the CPU transport, per host."""
    s_cpu, t_cpu, _ = run(ref.DYNAMIC_RUNAHEAD.format(device="false"),
                          None, port=False)
    s_dev, t_dev, tr = run(ref.DYNAMIC_RUNAHEAD.format(device="true"),
                           mode, port=True)
    assert t_dev == t_cpu
    assert (s_cpu.packets_sent, s_cpu.packets_dropped) == (
        s_dev.packets_sent, s_dev.packets_dropped)
    if mode == "mirrored":
        assert tr.divergence_count == 0


@pytest.mark.parametrize("mode", MODES)
def test_guarded_transport_run_is_clean(mode, tmp_path, monkeypatch):
    """Twin of the JAX guard test, with the port's reconciler in the
    Manager: no violation from the device guard, the harvest-boundary
    and teardown reconciliations or the progress detector, and the CPU
    ledger equal to the device counters."""
    monkeypatch.setattr(jreconcile, "TransportReconciler",
                        treconcile.TransportReconciler)
    with port_transport():
        mgr = ref_guards._guarded_manager(tmp_path, mode=mode)
    assert isinstance(mgr._guard_recon, treconcile.TransportReconciler)
    stats = mgr.run()
    assert stats.process_failures == []
    assert mgr.guard_violations == []
    report = mgr.transport.guard_report()
    assert report is not None and report["clean"], report
    assert report["windows"] > 0
    ledger = mgr.transport.cpu_ledger()
    device = {k: v.numpy().astype(np.int64)
              for k, v in mgr.transport.telemetry_arrays().items()}
    assert np.array_equal(device["pkts_out"], ledger["captured"])
    assert np.array_equal(device["pkts_in"], ledger["released"])
    assert ledger["captured"].sum() == stats.packets_sent
    import json

    rep = json.load(open(tmp_path / "guards-report.json"))
    assert rep["clean"] and rep["total"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_transport_elastic_growth_trace_parity(mode, monkeypatch):
    """Twin of the JAX elastic test: started at two slots a destination,
    the port's elastic transport grows its rings and gives the packet
    trace of a pre-provisioned JAX transport run, with growth events and
    no divergence."""
    t_big, s_big, _ = ref_elastic._run_transport(mode, 256)
    with port_transport():
        t_el, s_el, mgr = ref_elastic._run_transport(
            mode, 2, "capacity: {mode: elastic, max_doublings: 8}")
    assert isinstance(mgr.transport, PortTransport)
    assert s_big.process_failures == [] and s_el.process_failures == []
    assert per_host(t_big) == per_host(t_el) and len(t_big) > 100
    growths = [e for e in s_el.capacity_events
               if e["kind"] == "capacity-growth"]
    assert growths and growths[0]["ring"] == "transport-ingress"
    assert mgr.transport._ingress_cap > 2
    assert mgr.transport.divergence_count == 0


# -- the committed call logs ---------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_phold_log_replays_equal_to_its_record(mode):
    """The small log (the PHOLD config, 3 hosts, 20 s) through the
    replay tool: every round's pushes and next event in sync mode, the
    verified windows and packets in mirrored mode."""
    log = replay.load_log(str(PHOLD_LOG))
    out = replay.replay(log, mode, device="cpu")
    assert out["rounds"] == log["meta"]["rounds"] > 500
    assert out["captures"] == log["meta"]["captures"] > 1000
    assert out["divergence_count"] == 0 and out["in_flight"] == 0
    if mode == "mirrored":
        assert out["verified_packets"] == log["meta"]["captures"]


def test_phold_log_replay_cli_names_the_first_round_that_differs(
        tmp_path, capsys):
    """The CLI exits 0 on the record and 1, naming the round, on a log
    whose record was altered at one round."""
    assert replay.main([str(PHOLD_LOG), "--mode", "sync", "--device",
                        "cpu"]) == 0
    assert '"rounds": ' in capsys.readouterr().out
    log = replay.load_log(str(PHOLD_LOG))
    k = int(np.nonzero(log["rel_pushes"])[0][7])
    log["rel_digest"][k] ^= 1
    bad = tmp_path / "bad.npz"
    import json

    np.savez_compressed(bad, meta=np.array(json.dumps(log.pop("meta"))),
                        **log)
    assert replay.main([str(bad), "--mode", "sync", "--device",
                        "cpu"]) == 1
    assert f"round {k}:" in capsys.readouterr().err


@pytest.fixture
def one_thread():
    """One torch thread: the replay's ops are small, and several test
    workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_rung3_log_first_rounds_replay_equal_to_the_record(one_thread):
    """The rung-3 log (1000 hosts, 40 nodes) through its first
    RUNG3_ROUNDS releases in sync mode, each against its record, and the
    JAX transport's own mirrored replay of the whole log in its meta."""
    log = replay.load_log(str(RUNG3_LOG))
    meta = log["meta"]
    assert (meta["rounds"], meta["captures"]) == (6873, 216442)
    assert meta["mirrored"] == {"in_flight": 0, "divergence_count": 0,
                                "verified_windows": 5985,
                                "verified_packets": 216442}
    assert len(log["host_node"]) == 1000
    out = replay.replay(log, "sync", rounds=RUNG3_ROUNDS, device="cpu")
    assert out["rounds"] == RUNG3_ROUNDS
    assert int(log["rel_pushes"][:RUNG3_ROUNDS].sum()) > 1000

"""The bench record's baselines in `shadow_tpu_torch/bench.py` against
JAX's `bench.py`: the object-plane PHOLD the CPU baseline counts (its
events against the same app over the JAX package's Manager), the
compiled microbench built into the port's `_build_out/`, JAX's
`prior_round` regression guard (a ratio against a record with the
port's own fingerprint, skipped against every committed `BENCH_r*.json`),
and the record's four keys through `bench.main` at a small size.
"""

from __future__ import annotations

import functools
import json
import shutil
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shadow_tpu.core.config import load_config_str as jload  # noqa: E402
from shadow_tpu.core.manager import Manager as JManager  # noqa: E402
from shadow_tpu.net.packet import Packet as JPacket  # noqa: E402
from shadow_tpu.net.packet import Protocol as JProtocol  # noqa: E402

from shadow_tpu_torch import bench  # noqa: E402
from shadow_tpu_torch.telemetry.tracer import backend_fingerprint  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COMMITTED = sorted(p.name for p in REPO.glob("BENCH_r*.json"))
# the baseline world's simulated time in the event-count test (the bench
# runs 2 s: ~25 s of wall a package here)
STOP = "250ms"


def jax_events(n_hosts: int = 64, stop_time: str = STOP) -> int:
    """The events JAX's `bench_cpu_baseline` app counts (`bench.py`'s
    App, over the JAX package's Manager) on its world."""
    hosts_yaml = "\n".join(
        f"  peer{i}:\n    network_node_id: 0" for i in range(n_hosts))
    mgr = JManager(jload(
        f"general:\n  stop_time: {stop_time}\n  seed: 1\n"
        f"network:\n  graph:\n    type: 1_gbit_switch\nhosts:\n{hosts_yaml}"))
    peer_ips = [h.ip for h in mgr.hosts]
    events = [0]

    class App:
        PORT = 9000

        def __init__(self, host):
            self.host = host
            self.outq = []
            host.netns.associate(self, JProtocol.UDP, "0.0.0.0", self.PORT)

        def pull_out_packet(self):
            return self.outq.pop(0) if self.outq else None

        def peek_next_priority(self):
            return self.outq[0].priority if self.outq else None

        def push_in_packet(self, packet):
            events[0] += 1
            self.send_one()

        def send_one(self):
            events[0] += 1
            dst = peer_ips[self.host.rng.randrange(0, len(peer_ips))]
            self.outq.append(JPacket(
                JProtocol.UDP, (self.host.ip, self.PORT), (dst, self.PORT),
                b"x" * 1400, priority=self.host.get_next_packet_priority()))
            self.host.notify_socket_has_packets(self.host.ip, self)

        def start(self, host):
            for _ in range(4):
                self.send_one()

    for host in mgr.hosts:
        host.add_application(bench.MS, App(host).start)
    mgr.run()
    return events[0]


def test_cpu_baseline_counts_jax_events():
    events, wall = bench.cpu_baseline_run(stop_time=STOP)
    assert events > 64 * 4 and wall > 0
    assert events == jax_events()


def write_record(root: Path, rnd: int, rec: dict, wrapped: bool = False):
    body = {"n": rnd, "parsed": rec} if wrapped else rec
    (root / f"BENCH_r{rnd:02d}.json").write_text(json.dumps(body))


def test_regression_guard_compares_a_record_of_this_backend(tmp_path,
                                                             capsys):
    fp = backend_fingerprint("cpu")
    write_record(tmp_path, 7, {"value": 100.0, "hosts": 64, "backend": fp})
    # older, other size, or unreadable: never the one compared
    write_record(tmp_path, 6, {"value": 1.0, "hosts": 64, "backend": fp})
    write_record(tmp_path, 9, {"value": 1.0, "hosts": 128, "backend": fp})
    (tmp_path / "BENCH_r10.json").write_text("{")
    guard = functools.partial(bench._regression_guard, fingerprint=fp,
                              hosts=64, root=tmp_path)
    assert guard(90.0) == {"vs_round": 7, "ratio": 0.9, "regressed": False}
    assert guard(70.0) == {"vs_round": 7, "ratio": 0.7, "regressed": True}
    write_record(tmp_path, 8, {"value": 50.0, "hosts": 64, "backend": fp},
                 wrapped=True)
    assert guard(60.0) == {"vs_round": 8, "ratio": 1.2, "regressed": False}
    assert bench._regression_guard(1.0, fp, hosts=32, root=tmp_path) is None
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("name", COMMITTED)
@pytest.mark.parametrize("platform", ("cpu", "gpu"))
def test_regression_guard_skips_each_committed_record(tmp_path, capsys,
                                                      name, platform):
    """Each committed record alone: skipped, with a warning, for the
    port's CPU fingerprint and for a card's; one that carries no `hosts`
    or no record at all (r01, r02) is of no shape, so None, as in JAX."""
    fp = backend_fingerprint("cpu")
    if platform == "gpu":
        fp = dict(fp, platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    shutil.copy(REPO / name, tmp_path / name)
    rec = json.loads((REPO / name).read_text())
    rec = rec.get("parsed", rec)
    got = bench._regression_guard(1e6, fp, hosts=32768, root=tmp_path)
    if not rec or rec.get("hosts") != 32768:
        assert got is None
        return
    assert got == {"vs_round": int(name[7:9]),
                   "skipped_mismatched_backend": True,
                   "prior_backend": rec.get("backend"), "regressed": False}
    assert "SKIPPED" in capsys.readouterr().err


def test_regression_guard_over_the_repository_skips():
    got = bench._regression_guard(1e6, backend_fingerprint("cpu"),
                                  hosts=32768)
    assert got["skipped_mismatched_backend"] and got["vs_round"] == 6


def test_compiled_baseline_builds_into_the_ports_build_dir():
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    jax_exe = REPO / "tools" / ".phold_compiled"
    before = jax_exe.stat().st_mtime if jax_exe.exists() else None
    src = bench.PHOLD_COMPILED.read_bytes()
    rate = bench.bench_compiled_baseline()
    assert rate > 0
    assert (bench.BUILD_DIR / "phold_compiled").exists()
    assert bench.BUILD_DIR == REPO / "shadow_tpu_torch" / "_build_out"
    after = jax_exe.stat().st_mtime if jax_exe.exists() else None
    assert after == before
    assert bench.PHOLD_COMPILED.read_bytes() == src


def test_missing_gpp_gives_null_vs_compiled(monkeypatch):
    monkeypatch.setattr(shutil, "which",
                        lambda name: None if name == "g++" else "/bin/x")
    assert bench.bench_compiled_baseline() == 0.0
    monkeypatch.setattr(bench, "bench_cpu_baseline", lambda: 100.0)
    rec = bench.baseline_record(200.0, backend_fingerprint("cpu"), 64)
    assert rec["vs_compiled"] is None
    assert rec["compiled_events_per_sec"] == 0.0
    assert rec["vs_baseline"] == 2.0
    assert rec["prior_round"] is None


def test_bench_main_record_has_the_four_keys(monkeypatch, tmp_path,
                                             capsys):
    """`bench.main` at 64 hosts and 4 rounds on the CPU (its PHOLD run
    and the CPU baseline's simulated time cut): JAX's four keys, rounded
    as JAX rounds them, and the baseline text naming the ladder twin."""
    monkeypatch.setattr(bench, "run_phold", functools.partial(
        bench.run_phold, 64, n_nodes=8, rounds=4, device="cpu",
        warmup=False))
    rates = {}

    def cpu_rate():
        events, wall = bench.cpu_baseline_run(stop_time="50ms")
        rates["cpu"] = events / wall
        return rates["cpu"]

    monkeypatch.setattr(bench, "bench_cpu_baseline", cpu_rate)
    out = tmp_path / "rec.json"
    bench.main(["--kernel", "xla", "--no-sections", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    for key in ("vs_baseline", "vs_compiled", "compiled_events_per_sec",
                "prior_round"):
        assert key in rec, key
    assert rec["vs_baseline"] > 0
    assert rec["vs_baseline"] == round(
        rec["packet_events_per_sec"] / rates["cpu"], 2)
    if rec["compiled_events_per_sec"]:
        # rounded from the unrounded compiled rate
        assert abs(rec["vs_compiled"] - rec["packet_events_per_sec"]
                   / rec["compiled_events_per_sec"]) <= 1e-3
    else:
        assert rec["vs_compiled"] is None
    assert rec["prior_round"] is None  # no record of 64 hosts
    assert "shadow_tpu_torch.tools.bench_ladder" in rec["baseline"]

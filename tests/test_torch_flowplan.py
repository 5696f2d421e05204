"""The port's flow plan (`shadow_tpu_torch/core/flowplan.py`) and its
network graph (`shadow_tpu_torch/net/`) against the JAX package's:
`compile_flow_plan` on the YAMLs of `tests/test_flowplan.py` and the
committed rung-3 deployment (plans, fingerprints, every refusal and its
message), `run_flow_simulation` against the JAX `Manager(cfg).run()`
(`SimStats.as_dict()` without `wall_seconds`, the per-flow completion
times), each package resuming the other's `flow-progress` checkpoint,
and the committed rung-3 YAML and its JAX record."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from test_flowplan import GML, tgen_cfg  # noqa: E402

from shadow_tpu.core import flowplan as jfp  # noqa: E402
from shadow_tpu.core.config import load_config_str as j_load  # noqa: E402
from shadow_tpu.core.manager import Manager, SimStats  # noqa: E402
from shadow_tpu_torch.core import flowplan as tfp  # noqa: E402
from shadow_tpu_torch.core.config import load_config_str as t_load  # noqa: E402
from shadow_tpu_torch.net import graph as tgraph  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

ASYM_GML = """\
      graph [
        directed 1
        node [ id 0 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
        node [ id 1 host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]
        edge [ source 0 target 0 latency "5 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "5 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "30 ms" packet_loss 0.001 ]
        edge [ source 1 target 0 latency "90 ms" packet_loss 0.01 ]
      ]
"""


def asym_cfg() -> str:
    return ("general: {stop_time: 30s, seed: 1}\n"
            "experimental: {use_flow_engine: true}\n"
            "network:\n  graph:\n    type: gml\n    inline: |\n" + ASYM_GML +
            "hosts:\n"
            "  server:\n    network_node_id: 0\n    processes:\n"
            "    - {path: tgen-server, args: ['8888'], start_time: 1s,\n"
            "       expected_final_state: running}\n"
            "  client0:\n    network_node_id: 1\n    processes:\n"
            "    - {path: tgen-client, args: ['server', '8888', '40000', "
            "'1'], start_time: 2s}\n")


def two_bucket_cfg() -> str:
    """Clients on the server's node (5 ms, its own bucket) and across
    the 40 ms edge."""
    return tgen_cfg(n_clients=2, size=30_000).replace(
        "  client0:\n    network_node_id: 1", "  client0:\n    network_node_id: 0")


def plans(text: str):
    jc, tc = j_load(text), t_load(text)
    return (jfp.compile_flow_plan(jc, Manager(jc).routing),
            tfp.compile_flow_plan(tc, tfp.routing_from_config(tc)))


def assert_plans_equal(jp, tp):
    for f in ("client", "server", "window_us", "stop_us", "seed"):
        assert getattr(jp, f) == getattr(tp, f), f
    for f in ("size", "start_us", "latency_us", "latency_back_us", "loss",
              "loss_back"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert jfp._plan_fingerprint(jp) == tfp._plan_fingerprint(tp)


@pytest.mark.parametrize("text", [
    tgen_cfg(), tgen_cfg(n_clients=5, size=123_456), asym_cfg(),
    two_bucket_cfg(),
    tgen_cfg().replace("type: gml\n    inline: |\n" + GML,
                       "type: 1_gbit_switch\n").replace(
        "network_node_id: 1", "network_node_id: 0")],
    ids=["tgen", "tgen5", "asymmetric-directed", "two-buckets", "switch"])
def test_compile_flow_plan_matches_jax(text):
    assert_plans_equal(*plans(text))


def test_rung3_plan_matches_jax():
    jp, tp = plans(tfp.RUNG3_YAML.read_text())
    assert_plans_equal(jp, tp)
    assert len(tp.size) == 975
    assert sorted({tfp._bucket_window(min(a, b)) for a, b in zip(
        tp.latency_us, tp.latency_back_us)}) == [5_000, 20_000]


def test_routing_from_config_is_the_manager_s():
    for text in (tgen_cfg(), asym_cfg(), tfp.RUNG3_YAML.read_text()):
        jr = Manager(j_load(text)).routing
        tr = tfp.routing_from_config(t_load(text))
        assert jr.used_ids == tr.used_ids
        assert np.array_equal(jr.latency_ns, tr.latency_ns)
        assert jr.packet_loss.dtype == tr.packet_loss.dtype
        assert np.array_equal(jr.packet_loss, tr.packet_loss)


BAD = {
    "non-tgen": (
        "general: {stop_time: 10s, seed: 1}\n"
        "experimental: {use_flow_engine: true}\n"
        "network:\n  graph: {type: 1_gbit_switch}\n"
        "hosts:\n  h:\n    network_node_id: 0\n    processes:\n"
        "    - {path: http-server, args: ['80'], start_time: 1s}\n"),
    "stop-past-int32": tgen_cfg(n_clients=1, stop="2150s"),
    "start-past-int32": tgen_cfg(n_clients=1).replace(
        "start_time: 2s", "start_time: 2148s"),
    "count": tgen_cfg(n_clients=1).replace("'50000', '1'", "'50000', '2'"),
    "no-server": tgen_cfg(n_clients=1).replace("['server', '8888'",
                                               "['nobody', '8888'"),
    "port": tgen_cfg(n_clients=1).replace("['server', '8888'",
                                          "['server', '9999'"),
    "no-clients": tgen_cfg(n_clients=0),
    "sub-microsecond": tgen_cfg(n_clients=1).replace('"5 ms"', '"500 ns"')
    .replace("network_node_id: 1", "network_node_id: 0"),
}


@pytest.mark.parametrize("name", list(BAD))
def test_refusals_match_jax(name):
    text = BAD[name]
    jc, tc = j_load(text), t_load(text)
    with pytest.raises(jfp.FlowPlanError) as j_err:
        jfp.compile_flow_plan(jc, Manager(jc).routing)
    with pytest.raises(tfp.FlowPlanError) as t_err:
        tfp.compile_flow_plan(tc, tfp.routing_from_config(tc))
    assert str(t_err.value) == str(j_err.value)
    assert isinstance(t_err.value, ValueError)


def test_bucket_window_and_sim_stats_match_jax():
    for lat in (1, 999, 1000, 1999, 2000, 4999, 5000, 19_999, 20_000,
                25_000, 200_000):
        assert tfp._bucket_window(lat) == jfp._bucket_window(lat)
    assert tfp._WINDOW_LADDER == jfp._WINDOW_LADDER
    assert tfp.SimStats().as_dict() == SimStats().as_dict()


def test_graph_refusals_match_jax():
    from shadow_tpu.net import graph as jgraph

    for text, used in (("graph [ node [ id 0 ] node [ id 0 ] ]", [0]),
                       ("graph [ node [ id 0 ] node [ id 1 ] edge [ source 0"
                        " target 1 latency \"1 ms\" ] ]", [0, 1])):
        with pytest.raises(jgraph.GraphError) as j_err:
            jgraph.build_routing(jgraph.NetworkGraph.parse(text), used, True)
        with pytest.raises(tgraph.GraphError) as t_err:
            tgraph.build_routing(tgraph.NetworkGraph.parse(text), used, True)
        assert str(t_err.value) == str(j_err.value)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's Manager run of the test config, and its checkpoint."""
    ck = tmp_path_factory.mktemp("jax_ck")
    cfg = j_load(tgen_cfg(n_clients=2, size=30_000))
    mgr = Manager(cfg)
    stats = Manager(cfg).run()
    jfp.run_flow_simulation(cfg, mgr.routing, SimStats(),
                            checkpoint_dir=str(ck))
    return tfp.stats_record(stats), ck / "flow-progress"


def test_run_flow_simulation_matches_the_jax_manager(jax_run, tmp_path):
    want, _ck = jax_run
    cfg = t_load(tgen_cfg(n_clients=2, size=30_000))
    got = tfp.run_config(cfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert tfp.stats_record(got) == want
    assert got.process_failures == [] and got.packets_sent > 0
    # the JAX package resumes the port's finished checkpoint
    jc = j_load(tgen_cfg(n_clients=2, size=30_000))
    resumed = jfp.run_flow_simulation(
        jc, Manager(jc).routing, SimStats(),
        resume_from=str(tmp_path / "flow-progress"))
    assert tfp.stats_record(resumed) == want


def test_the_port_resumes_the_jax_checkpoint(jax_run):
    want, ck = jax_run
    cfg = t_load(tgen_cfg(n_clients=2, size=30_000))
    got = tfp.run_config(cfg, resume_from=str(ck), device="cpu")
    assert tfp.stats_record(got) == want


def test_kill_after_a_bucket_and_resume(tmp_path):
    """A run killed where its second bucket starts (after the first
    bucket's checkpoint) resumes to the uninterrupted run's result; a
    checkpoint of another plan is refused."""
    import chip_smoke
    from shadow_tpu_torch.tpu import floweng

    text = two_bucket_cfg()
    whole = tfp.run_config(t_load(text), device="cpu")
    assert chip_smoke.flow_run_killed(floweng, tfp, t_load(text),
                                      str(tmp_path), "cpu")
    from shadow_tpu_torch.faults.checkpoint import (CheckpointError,
                                                    load_checkpoint)

    meta, _arrays = load_checkpoint(str(tmp_path / "flow-progress"))
    assert meta["kind"] == "flow" and len(meta["done_buckets"]) == 1
    resumed = tfp.run_config(t_load(text), device="cpu",
                             resume_from=str(tmp_path / "flow-progress"))
    assert tfp.stats_record(resumed) == tfp.stats_record(whole)
    with pytest.raises(CheckpointError, match="fingerprint"):
        tfp.run_config(t_load(tgen_cfg(n_clients=1)), device="cpu",
                       resume_from=str(tmp_path / "flow-progress"))


def rung3_text() -> str:
    """The rung-3 YAML as `tools/bench_ladder.rung3(use_flow_engine=
    True)` generates it, with `run_rung` replaced so nothing runs."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import bench_ladder
    finally:
        sys.path.remove(str(REPO / "tools"))
    captured = {}
    real = bench_ladder.run_rung
    bench_ladder.run_rung = lambda name, cfg, data_dir=None: \
        captured.update(name=name, cfg=cfg)
    try:
        bench_ladder.rung3(use_flow_engine=True)
    finally:
        bench_ladder.run_rung = real
    assert captured["name"] == "rung3_tgen_atlas_1k_floweng"
    return captured["cfg"]


def test_committed_rung3_yaml_is_what_the_ladder_generates():
    assert tfp.RUNG3_YAML.read_text() == rung3_text()


@pytest.mark.slow  # the JAX Manager's rung-3 run (~60 s on the CPU)
def test_committed_rung3_record_is_what_the_jax_manager_computes():
    record = json.loads(tfp.RUNG3_RECORD.read_text())
    record.pop("source")
    stats = Manager(j_load(tfp.RUNG3_YAML.read_text())).run()
    assert tfp.stats_record(stats) == record


def jax_bench_results(n_flows, size):
    """`tools/bench_flows.py`'s run, through the JAX package, of the
    world `bench_flows.default_world_args` draws."""
    from shadow_tpu.tpu import floweng as jfe
    from shadow_tpu_torch.tools import bench_flows

    lats, sizes, queue_slots, window_us = bench_flows.default_world_args(
        n_flows, size)
    world = jfe.make_flow_world(lats, sizes, queue_slots=queue_slots)
    world, sim_s, retries = jfe.run_to_completion(
        world, window_us, max_sim_s=40.0, chunk_windows=25, probe_every=2)
    return jfe.flow_results(world), sim_s, retries


def test_bench_flows_matches_the_jax_tool_at_small_width():
    from shadow_tpu_torch.tools import bench_flows

    res, sim_s, retries = jax_bench_results(6, 40_000)
    out = bench_flows.run(6, 40_000, device="cpu")
    assert out["digest"] == bench_flows.results_digest(res)
    assert out["flows_complete"] == 6 and out["sim_seconds"] == sim_s
    assert out["saturation_retries"] == retries
    assert out["segments"] == res["segments"]
    assert out["device"].startswith("cpu:") and out["launches"] == 0


@pytest.mark.slow  # the JAX package's 975-flow run (~25 s on the CPU)
def test_golden_flow_digest_is_what_the_jax_package_computes():
    from shadow_tpu_torch.tools import bench_flows

    res, sim_s, retries = jax_bench_results(975, 262_144)
    assert bench_flows.results_digest(res) == bench_flows.GOLDEN_FLOW_DIGEST
    summary = bench_flows.GOLDEN_FLOW_SUMMARY
    assert (sim_s, retries) == (summary["sim_seconds"],
                                summary["saturation_retries"])
    assert int((res["bytes_read"] == res["bytes_expected"]).sum()) == \
        summary["flows_complete"]
    for k in ("segments", "retransmits", "queue_drops", "wire_drops"):
        assert res[k] == summary[k], k


@pytest.mark.parametrize("doublings", [6, 7, 9])
def test_ring_budget_past_what_kernel_f_stages_reaches_the_first_bucket(
        monkeypatch, doublings):
    """On the card, a config whose rings may double past the 28957 slots
    an earlier kernel F could stage in a block's shared memory (256 << 7
    = 32768) runs as JAX's does: its first bucket starts. So do 6
    doublings (16384 slots), and the CPU's plain version takes any
    budget."""
    import shadow_tpu_torch

    class Reached(Exception):
        pass

    def first_bucket(*a, **k):
        raise Reached

    monkeypatch.setattr(tfp, "bucket_world", first_bucket)
    cfg = lambda: t_load(f"capacity: {{max_doublings: {doublings}}}\n"
                         + tgen_cfg(n_clients=2, size=30_000))
    assert cfg().capacity.max_doublings == doublings
    with pytest.raises(Reached):
        tfp.run_config(cfg(), device="cpu")
    monkeypatch.setattr(shadow_tpu_torch, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(Reached):
        tfp.run_config(cfg())


def test_rings_grown_past_28957_slots_match_the_jax_record(jax_run):
    """Ring drops added to each bucket run below 32768 slots make
    `run_flow_simulation` grow the rings 256 -> 32768
    (`chip_smoke.flow_run_grown`, which phase 20 (e) runs on the card):
    each size a fresh world and a re-run of the bucket, the last past the
    28957 slots an earlier kernel F staged. The record is the JAX
    Manager's with those growths in `capacity_events`, and the last run
    was at 32768 slots."""
    import chip_smoke
    from shadow_tpu_torch.tpu import floweng

    want, _ck = jax_run
    cfg = t_load("capacity: {max_doublings: 7}\n"
                 + tgen_cfg(n_clients=2, size=30_000))
    stats, runs = chip_smoke.flow_run_grown(floweng, tfp, cfg, "cpu")
    assert [q for q, _n in runs] == [256 << k for k in range(8)]
    got = tfp.stats_record(stats)
    grown = chip_smoke.flow_grown_events(tfp, cfg)
    assert len(grown) == 7 and grown[-1]["to"] == 32768
    assert got["stats"]["capacity_events"] == \
        want["stats"]["capacity_events"] + grown
    rest = lambda rec: dict(rec, stats=dict(rec["stats"],
                                            capacity_events=None))
    assert rest(got) == rest(want)

"""The port's configuration parser and `run_scenarios --config` against
the JAX package.

`shadow_tpu_torch.core.config` is the port's own copy of the JAX parser:
the same files give the same processed dict (`to_processed_dict`), and
the same bad blocks raise the same error, class name and text. The
port's `run_scenarios --config` (on the CPU) gives the JAX tool's
records for the same simulation configs (the scenario path taken
against the config's directory, the seed override, the `flows:` knobs,
the `memo:` block) and exits 2 where it does.
"""

from __future__ import annotations

import json
import os
import runpy
from pathlib import Path

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shadow_tpu.core import config as jconfig  # noqa: E402
from shadow_tpu_torch.core import config as tconfig  # noqa: E402
from shadow_tpu_torch.faults import schedule as tschedule  # noqa: E402
from shadow_tpu_torch.workloads import run_scenarios as trun  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HOSTS = "hosts:\n  h0: {network_node_id: 0}\n"
GENERAL = "general: {stop_time: 1s}\n"
SCENARIO = ("scenario:\n  name: cfg-driven\n  hosts: 8\n  windows: 16\n"
            "  seed: 1\n"
            "  patterns:\n    - {kind: onoff, count: 8, rounds: 2}\n")
FLOW_SCENARIO = ("scenario:\n  name: cfg-flows\n  family: incast\n"
                 "  seed: 5\n  hosts: 6\n  windows: 48\n"
                 "  transport: flows\n  loss_p: 0.05\n"
                 "  patterns:\n    - {kind: incast, first: 0, count: 5, "
                 "bytes: 3000, rounds: 2}\n")
# the simulation configs of tests/test_workloads.py's --config test,
# with the flows and memo blocks besides
CONFIGS = {
    "workload-seed": GENERAL + "workload: {scenario: scen.yaml, seed: 9}\n"
    + HOSTS,
    "workload-on": GENERAL + "workload: on\n" + HOSTS,
    "flows-knobs": GENERAL + "workload: {scenario: flows.yaml}\n"
    "flows: {enabled: true, emit_cap: 2, recv_wnd: 16}\n" + HOSTS,
    "flows-on-direct": GENERAL + "workload: {scenario: scen.yaml}\n"
    "flows: on\n" + HOSTS,
    "memo-block": GENERAL + "workload: {scenario: scen.yaml, seed: 3}\n"
    "memo: {enabled: true, chain_len: 4, min_repeat: 2}\n" + HOSTS,
}
BAD_BLOCKS = [
    "workload: {scenario: s.yaml, seed: -1}\n",
    "workload: {scenario: s.yaml, bogus: 1}\n",
    "workload: [s.yaml]\n",
    "workload: {scenario: 7}\n",
    "workload: {scenario: s.yaml, seed: nine}\n",
    "flows: {emit_cap: 0}\n",
    "flows: {recv_wnd: 0}\n",
    "flows: {emit_cap: 64, recv_wnd: 32}\n",
    "flows: {enabled: maybe}\n",
    "flows: {window: 4}\n",
    "flows: 3\n",
    "memo: {max_bytes: 0}\n",
    "memo: {min_repeat: 0}\n",
    "memo: {chain_len: 0}\n",
    "memo: {enabled: 1}\n",
    "memo: {size: 4}\n",
]
BAD_GENERAL = [
    "general: {stop_time: 0}\n" + HOSTS,
    "general: {}\n" + HOSTS,
    "general: {stop_time: 1s, seed: abc}\n" + HOSTS,
    "general: {stop_time: 1s, bogus: 1}\n" + HOSTS,
    "general: {stop_time: 10 parsecs}\n" + HOSTS,
    "general: {stop_time: 1s}\n",
    "general: [1s]\n" + HOSTS,
    "generals: {stop_time: 1s}\n" + HOSTS,
    "- general\n",
]


def processed(module, path):
    return module.to_processed_dict(module.load_config_file(str(path)))


@pytest.mark.parametrize("path", sorted((REPO / "examples").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_examples_give_jax_processed_dict(path):
    assert processed(tconfig, path) == processed(jconfig, path)


@pytest.fixture
def config_dir(tmp_path):
    (tmp_path / "scen.yaml").write_text(SCENARIO)
    (tmp_path / "flows.yaml").write_text(FLOW_SCENARIO)
    for name, text in CONFIGS.items():
        (tmp_path / f"{name}.yaml").write_text(text)
    return tmp_path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sim_configs_give_jax_processed_dict(config_dir, name):
    path = config_dir / f"{name}.yaml"
    assert processed(tconfig, path) == processed(jconfig, path)


def raised(module, text):
    try:
        module.load_config_str(text)
    except Exception as e:  # noqa: BLE001 -- JAX's refusals, whatever type
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("text", [GENERAL + b + HOSTS for b in BAD_BLOCKS]
                         + BAD_GENERAL)
def test_bad_blocks_raise_jax_error(text):
    ref = raised(jconfig, text)
    assert ref is not None, text
    assert raised(tconfig, text) == ref


def test_full_faults_block_still_compiles(config_dir):
    """The schedule reads `seed`, `events` and `random` of the now full
    `FaultsOptions`: a parsed `faults:` block compiles to the JAX
    schedule's fingerprint."""
    from shadow_tpu.faults import schedule as jschedule

    text = (GENERAL + "faults:\n  seed: 4\n  watchdog: 30s\n"
            "  events:\n    - {at: 100 ms, kind: host_crash, host: h0,"
            " duration: 50 ms}\n"
            "  random: {iface_flaps: {count: 2, window: [10 ms, 900 ms],"
            " downtime: 5 ms}}\n" + HOSTS)
    tf, jf = (m.load_config_str(text).faults for m in (tconfig, jconfig))
    assert tf.watchdog == jf.watchdog == 30 * 10**9
    kw = dict(host_names=["h0", "h1", "h2"], n_nodes=1, seed=1,
              stop_time_ns=10**9)
    t = tschedule.compile_schedule(tf, **kw)
    j = jschedule.compile_schedule(jf, **kw)
    assert len(t.events) == len(j.events) == 6
    assert t.fingerprint() == j.fingerprint()


def run_both(argv, out_dir: Path):
    """(rc, records) of the JAX tool and of the port's, same arguments."""
    jax_main = runpy.run_path(str(REPO / "tools" / "run_scenarios.py"),
                              run_name="run_scenarios")["main"]
    results = []
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", trun.main, ["--device", "cpu"])):
        out = out_dir / f"{tag}.json"
        try:
            rc = main([*argv, "-o", str(out), *extra])
        except SystemExit as e:
            rc = e.code
        recs = (json.loads(out.read_text())["records"] if out.exists()
                else None)
        results.append((rc, recs))
    return results


@pytest.mark.parametrize("name", ["workload-seed", "flows-knobs",
                                  "flows-on-direct", "memo-block"])
def test_run_scenarios_config_gives_jax_record(config_dir, name):
    (jrc, jrec), (trc, trec) = run_both(
        ["--config", str(config_dir / f"{name}.yaml")], config_dir)
    assert jrc == trc == 0
    assert trec == jrec
    rec = trec[0]
    assert rec["fingerprint"] and rec["canonical_digest"]
    if name == "memo-block":
        assert rec["memo"]["hits"] + rec["memo"]["misses"] > 0


def test_run_scenarios_config_exits_2_where_jax_does(config_dir):
    bad = config_dir / "bad.yaml"
    bad.write_text(GENERAL + "flows: {emit_cap: 0}\n"
                   "workload: {scenario: scen.yaml}\n" + HOSTS)
    cases = [
        ["--config", str(config_dir / "workload-on.yaml")],
        ["--config", str(bad)],
        ["--config", str(config_dir / "workload-seed.yaml"),
         str(config_dir / "scen.yaml")],
        ["--config", str(config_dir / "workload-seed.yaml"),
         "--memo-report", str(config_dir / "m.json")],
    ]
    for argv in cases:
        (jrc, _j), (trc, _t) = run_both(argv, config_dir)
        assert jrc == trc == 2, argv


def test_run_scenarios_config_paths_are_relative_to_the_config(config_dir,
                                                               monkeypatch):
    monkeypatch.chdir(REPO)
    rel = os.path.relpath(config_dir / "workload-seed.yaml")
    assert trun.main(["--config", rel, "--device", "cpu", "-o",
                      str(config_dir / "rel.json")]) == 0
    assert trun.main(["--config", str(config_dir / "workload-seed.yaml"),
                      "--device", "cpu", "-o",
                      str(config_dir / "abs.json")]) == 0
    rel_rec, abs_rec = (json.loads((config_dir / f"{n}.json").read_text())
                        for n in ("rel", "abs"))
    assert rel_rec == abs_rec
    assert abs_rec["records"][0]["name"] == "cfg-driven"

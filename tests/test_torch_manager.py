"""The port's own entry point, `python -m shadow_tpu_torch CONFIG
--device cpu` (`cli.main` -> `core/manager.Manager` -> hosts, the
simulated TCP/UDP stack and the built-in apps), against the JAX
package's `python -m shadow_tpu CONFIG`, on the CPU routing.

Each config runs through both CLIs in this process, each into its own
data directory (`cli_parity.run_cli`): the exit codes, every output file
(`sim-stats.json` less its `wall_seconds`, `processed-config.yaml`,
`etc-hosts`, each host's files) and each host's packet-status trace must
be equal. The configs: the three of `examples/` and the CPU-routing
twins of `tests/test_tpu_transport.py`'s BASIC, PHOLD and LOSSY; a small
tgen workload on the flow engine (the port's kernel F through its plain
version); a process that misses its expected final state. Also: a real
executable is refused, naming the slice that would run it, and the
port's Manager driving the port's transport (no JAX in the loop)
reproduces the committed PHOLD call log release for release.
"""

from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_tpu_transport as ref  # noqa: E402
from cli_parity import EXAMPLES, both, run_cli, same_outputs  # noqa: E402
from test_flowplan import tgen_cfg  # noqa: E402

from shadow_tpu_torch.core import manager as tmanager  # noqa: E402
from shadow_tpu_torch.core.config import (ConfigError,  # noqa: E402
                                          load_config_str)
from shadow_tpu_torch.tools import transport_replay as replay  # noqa: E402
from shadow_tpu_torch.tpu import transport as ttr  # noqa: E402

REPO = EXAMPLES.parent
PHOLD_LOG = REPO / "shadow_tpu_torch" / "workloads" / "phold_transport.log.npz"

CONFIGS = {
    **{name: (EXAMPLES / f"{name}.yaml").read_text()
       for name in ("phold", "basic-file-transfer", "fault-injection")},
    "BASIC": ref.BASIC.format(device="false"),
    "PHOLD": ref.PHOLD.format(device="false"),
    "LOSSY": ref.LOSSY.format(device="false"),
}

FAILING = """
general: {stop_time: 2s, seed: 1}
network: {graph: {type: 1_gbit_switch}}
hosts:
  a:
    network_node_id: 0
    processes:
    - {path: udp-echo-server, args: ["1"], start_time: 1s,
       expected_final_state: {exited: 0}}
  b:
    network_node_id: 0
    processes:
    - {path: udp-client, args: ["a", "1", "100", "3"], start_time: 1s,
       expected_final_state: running}
"""


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_matches_jax_on_the_cpu_routing(tmp_path, name):
    rc, out, trace = both(tmp_path, CONFIGS[name])
    assert rc == 0 and "etc-hosts" in out
    stats = out["sim-stats.json"]
    assert stats["process_failures"] == []
    assert stats["packets_sent"] > 0 and stats["rounds"] > 0
    assert sum(len(v) for v in trace.values()) > 20
    assert len(trace) == len(stats["hosts"])


def test_cli_flow_engine_matches_jax(tmp_path):
    """`experimental.use_flow_engine` at a small width: the port's flow
    engine (kernel F's plain version on the CPU) through its CLI."""
    managers = []
    rc_j, data_j, _ = run_cli("jax", tmp_path, tgen_cfg(n_clients=3))
    rc_t, data_t, trace = run_cli("port", tmp_path, tgen_cfg(n_clients=3),
                                  managers=managers)
    assert rc_t == rc_j == 0
    out = same_outputs(data_t, data_j)
    assert out["sim-stats.json"]["packets_sent"] > 0
    assert trace == {}  # no host ran: the flow engine has none
    (mgr,) = managers
    assert mgr.device == "cpu" and len(mgr.stats.flow_complete_us) == 3


def test_missed_final_state_matches_jax(tmp_path):
    """A process that misses its expected final state: the same exit
    code (1) and `process_failures` in both packages."""
    rc, out, _ = both(tmp_path, FAILING)
    assert rc == 1
    failures = out["sim-stats.json"]["process_failures"]
    assert [f[0] for f in failures] == ["a.udp-echo-server.0",
                                        "b.udp-client.0"]


def test_real_executable_is_refused_naming_the_slice(tmp_path):
    """A real executable in `processes[].path` is a managed native
    process, which the port does not run yet: the Manager raises
    ConfigError naming that slice when it is built (nothing runs), and
    the CLI exits with the config error's code."""
    text = FAILING.replace("udp-echo-server", "/bin/true")
    with pytest.raises(ConfigError, match="managed native processes") as e:
        tmanager.Manager(load_config_str(text))
    assert "process/managed.py" in str(e.value)
    rc, data, trace = run_cli("port", tmp_path, text)
    assert rc == 2 and trace == {}
    assert not (data / "sim-stats.json").exists()
    # a path that is neither an app nor an executable stays a ValueError
    with pytest.raises(ValueError, match="no-such-app"):
        tmanager.Manager(load_config_str(
            FAILING.replace("udp-echo-server", "no-such-app")))


def test_port_manager_reproduces_the_phold_call_log():
    """The port's Manager drives the port's transport (sync, on the CPU;
    nothing of JAX runs) through the PHOLD config the committed call log
    was recorded from: every release equal to the log's (window, push
    count, the push rows as a set less their pool tags against the
    log's own sync replay, next event), the same captures and stats."""
    log = replay.load_log(str(PHOLD_LOG))
    untagged = replay.replay(log, "sync", device="cpu")["untagged_digests"]
    sink = []
    orig = ttr.DeviceTransport
    ttr.DeviceTransport = replay.recording_class(sink)
    try:
        text = ref.PHOLD.format(device="true").replace(
            "use_tpu_transport: true",
            "use_tpu_transport: true, tpu_transport_mode: sync")
        stats = tmanager.Manager(load_config_str(text), device="cpu").run()
    finally:
        ttr.DeviceTransport = orig
    (t,) = sink
    assert replay.compare_releases(t.log, log, untagged=untagged) == \
        len(log["rel"]) == len(t.log.rel)
    assert len(t.log.caps) == log["meta"]["captures"]
    assert {"rounds": stats.rounds, "packets_sent": stats.packets_sent,
            "packets_dropped": stats.packets_dropped,
            "process_failures": len(stats.process_failures)} == \
        log["meta"]["stats"]
    assert t.log.meta["final"]["in_flight"] == 0

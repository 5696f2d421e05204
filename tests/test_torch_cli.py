"""The port's CLI with the device transport, `python -m shadow_tpu_torch
CONFIG --device cpu` with `experimental.use_tpu_transport` (the port's
`tpu/transport.DeviceTransport` on the CPU), against the JAX package's
CLI on its own transport, in sync and mirrored mode.

Each run goes through both CLIs in this process (`cli_parity.run_cli`):
the exit codes, every output file but `sim-stats.json`'s
`wall_seconds`, and each host's packet-status trace must be equal; a
mirrored run verifies every window with no divergence, as many windows
and packets as the JAX transport. Also: by default the port's CLI runs
the transport on the card and, with no card, fails rather than run on
the CPU, while a config that switches on neither the transport nor the
flow engine touches no device at all.
"""

from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_tpu_transport as ref  # noqa: E402
from cli_parity import both, run_cli  # noqa: E402

from shadow_tpu_torch import cli as tcli  # noqa: E402

CONFIGS = {"BASIC": ref.BASIC, "PHOLD": ref.PHOLD, "LOSSY": ref.LOSSY}
MODES = ("sync", "mirrored")


def transport_config(name: str, mode: str) -> str:
    return CONFIGS[name].format(device="true").replace(
        "use_tpu_transport: true",
        f"use_tpu_transport: true, tpu_transport_mode: {mode}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_transport_matches_jax(tmp_path, name, mode):
    managers = []
    rc, out, trace = both(tmp_path, transport_config(name, mode),
                          managers=managers)
    assert rc == 0
    stats = out["sim-stats.json"]
    assert stats["process_failures"] == [] and stats["packets_sent"] > 0
    assert sum(len(v) for v in trace.values()) > 1000
    (mgr,) = managers
    tr = mgr.transport
    assert tr.device.type == "cpu" and tr.mode == mode
    assert tr.dispatches > 0 and tr.in_flight == 0
    if mode == "mirrored":
        assert tr.divergence_count == 0
        assert tr.verified_packets == stats["packets_sent"]


def test_transport_runs_on_the_card_by_default(tmp_path):
    """Without `--device` the transport is built on the CUDA card; with
    no card the run fails (the crash exit code) and does not fall back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    rc, data, trace = run_cli("port", tmp_path, transport_config(
        "PHOLD", "sync"), default_device=True)
    assert rc == tcli.EXIT_CRASH and trace == {}
    assert not (data / "sim-stats.json").exists()


def test_cpu_routing_touches_no_device(tmp_path):
    """A config that switches on neither the transport nor the flow
    engine runs under the default device and initialises no CUDA."""
    rc, data, trace = run_cli("port", tmp_path, CONFIGS["PHOLD"].format(
        device="false"), default_device=True)
    assert tcli.build_parser().parse_args(["c.yaml"]).device == "cuda"
    assert rc == 0 and (data / "sim-stats.json").exists() and trace
    assert not torch.cuda.is_initialized()

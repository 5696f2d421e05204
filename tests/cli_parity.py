"""Running the JAX package's CLI and the port's in one test process, for
`test_torch_manager.py` and `test_torch_cli.py`.

`run_cli` runs one package's `cli.main` on a config in a directory of
its own (the data directory `data`, relative, so both packages write the
same `processed-config.yaml`), with every packet-status transition
recorded (host, simulated time, status, src, dst, payload size) beside
the Manager's own trackers. Each package keeps its own
`net/packet.status_trace_hook`; the one set here is removed after the
run. `same_outputs` holds two data directories to each other: every
file byte for byte but `sim-stats.json`, whose `wall_seconds` is left
out. The traces are compared per host: with several worker threads the
global trace is their interleaving."""

from __future__ import annotations

import collections
import json
import logging
import os
from pathlib import Path

from shadow_tpu import cli as jcli
from shadow_tpu.core import worker as jworker
from shadow_tpu.net import packet as jpacket
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch.core import worker as tworker
from shadow_tpu_torch.net import packet as tpacket

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"

# cli module, packet module, worker module, logger tree, extra arguments
PACKAGES = {
    "jax": (jcli, jpacket, jworker, "shadow_tpu", ()),
    "port": (tcli, tpacket, tworker, "shadow_tpu_torch",
             ("--device", "cpu")),
}


def per_host(trace) -> dict:
    """A packet-status trace split by host, each host's order kept."""
    out = collections.defaultdict(list)
    for row in trace:
        out[row[0]].append(row[1:])
    return dict(out)


def run_cli(pkg: str, tmp: Path, cfg_text: str, *extra, managers=None,
            default_device=False):
    """`pkg`'s CLI ("jax" or "port", the port with `--device cpu`, or
    with no `--device` at all under `default_device`) on `cfg_text` in
    `tmp/pkg`. Returns (exit code, data directory, the per-host
    packet-status trace). Each Manager the CLI builds is appended to
    `managers`."""
    cli, packet_mod, worker_mod, logger_name, pkg_args = PACKAGES[pkg]
    if default_device:
        pkg_args = ()
    work = tmp / pkg
    work.mkdir()
    (work / "config.yaml").write_text(cfg_text)
    trace = []
    base = cli.Manager

    class Traced(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if managers is not None:
                managers.append(self)
            inner = packet_mod.status_trace_hook

            def hook(packet, status):
                host = worker_mod.current_host()
                trace.append((host.name if host else None,
                              host.now() if host else -1, int(status),
                              packet.src, packet.dst,
                              packet.payload_size()))
                if inner is not None:
                    inner(packet, status)

            packet_mod.status_trace_hook = hook

    logger = logging.getLogger(logger_name)
    handlers = list(logger.handlers)
    old_hook = packet_mod.status_trace_hook
    cwd = Path.cwd()
    cli.Manager = Traced
    try:
        os.chdir(work)
        rc = cli.main(["config.yaml", "-d", "data", "--log-level", "error",
                       *pkg_args, *extra])
    finally:
        os.chdir(cwd)
        cli.Manager = base
        packet_mod.status_trace_hook = old_hook
        for h in list(logger.handlers):
            if h not in handlers:
                logger.removeHandler(h)
                h.close()
    return rc, work / "data", per_host(trace)


def outputs(data: Path) -> dict:
    """A data directory file by file: sim-stats.json parsed less its
    wall_seconds, every other file's bytes."""
    out = {}
    for f in sorted(data.rglob("*")):
        if f.is_file():
            rel = f.relative_to(data).as_posix()
            if rel == "sim-stats.json":
                d = json.loads(f.read_text())
                d.pop("wall_seconds")
                out[rel] = d
            else:
                out[rel] = f.read_bytes()
    return out


def same_outputs(a: Path, b: Path) -> dict:
    """Hold two data directories to each other; returns the first's."""
    oa, ob = outputs(a), outputs(b)
    assert sorted(oa) == sorted(ob)
    for rel in oa:
        assert oa[rel] == ob[rel], rel
    for rel in ("sim-stats.json", "processed-config.yaml"):
        assert rel in oa, rel
    return oa


def both(tmp: Path, cfg_text: str, *extra, managers=None):
    """Both CLIs on `cfg_text`: their exit codes and outputs equal, and
    their per-host traces. Returns (exit code, outputs, trace); the
    port's Managers are appended to `managers`."""
    rc_j, data_j, trace_j = run_cli("jax", tmp, cfg_text, *extra)
    rc_t, data_t, trace_t = run_cli("port", tmp, cfg_text, *extra,
                                    managers=managers)
    assert rc_t == rc_j
    out = same_outputs(data_t, data_j)
    assert trace_t == trace_j
    return rc_t, out, trace_t

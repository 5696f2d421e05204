"""The benchmark ladder's end-to-end runs, rungs 1-4, through the port's
Manager: the twin of `tools/bench_ladder.py`.

Rung 1: real binaries (`python3 -m http.server` and two `curl` clients)
        over a 1 Gbit switch.
Rung 2: tgen traffic mesh, 100 hosts on one vertex (`1_gbit_switch`).
Rung 3: 1000-host tgen over an Atlas-style GML with latency and loss
        (`3f`: the same YAML on the device flow engine).
Rung 4: the Tor-shaped workload, 99 real onion-relay processes
        (`workloads/rung4.py`), its heartbeats checked by
        `tools/parse_shadow.py`.
interpose: 100 real compiled processes (the TCP pair of
        `tests/test_managed_network.py`) under the port's shim.

Each rung prints the JAX tool's JSON line (`rung`, `sim_seconds`,
`wall_seconds`, `sim_per_wall`, `events_per_sec`, `events`, `packets`,
`failures`) with the run's `transport`, `device` and `backend`
fingerprint beside it. The configs are the JAX tool's, byte for byte,
at its shapes: each rung's text comes from a builder (`rung1_text`,
`rung2_text`, `rung3_text`, `interpose_text`, and `workloads/rung4.py`'s
`rung4_text`) and runs through `run_rung`.

    python -m shadow_tpu_torch.tools.bench_ladder [1|2|3|3f|4|interpose|all]
        [--device cuda|cpu] [--transport cpu|auto|sync|mirrored]

`--transport cpu` (with the JAX tool's YAML) routes every packet on the
CPU object plane, as the JAX tool does; `auto`, `sync` and `mirrored`
add the JAX config keys `experimental.use_tpu_transport: true` and
`tpu_transport_mode`, so the cross-host packets cross the device
transport on `--device`. Rung 3f runs the flow engine on `--device`
and ignores `--transport` (the flow engine has no round loop). The
device defaults to the CUDA card, and the tool raises where there is
none unless `--device cpu` is asked for.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import resolve_device
from ..core.config import load_config_str
from ..core.manager import Manager
from ..telemetry.tracer import backend_fingerprint
from ..workloads import rung4 as rung4_mod
from ..workloads.rung4 import make_gml

REPO = Path(__file__).resolve().parents[2]
# read, never imported: the JAX package's test module and the log parser
MANAGED_TESTS = REPO / "tests" / "test_managed_network.py"
PARSE_SHADOW = REPO / "tools" / "parse_shadow.py"
TRANSPORTS = ("cpu", "auto", "sync", "mirrored")
RUNGS = ("1", "2", "3", "3f", "4", "interpose")
# the port's logger tree (the tracker heartbeats) and the Manager's own
LOGGERS = ("shadow_tpu_torch", "shadow")


def with_transport(text: str, transport: str) -> str:
    """`text` as it is for the CPU routing ("cpu"); else with the device
    transport's JAX keys appended as one `experimental:` line."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} is not one of "
                         f"{TRANSPORTS}")
    if transport == "cpu":
        return text
    if re.search(r"(?m)^experimental:", text):
        raise ValueError("the config has an experimental: block already")
    return (text.rstrip("\n") + "\nexperimental: {use_tpu_transport: true, "
            f"tpu_transport_mode: {transport}}}\n")


def run_rung(name: str, cfg_text: str, data_dir: str | None = None, *,
             device=None, transport: str = "cpu") -> dict:
    """`cfg_text` through the port's Manager on `device` (None: the card),
    writing `data_dir` when given; prints and returns the rung's JSON
    line. `transport` only labels the line: the config says how packets
    are routed."""
    dev = resolve_device(device)
    mgr = Manager(load_config_str(cfg_text), data_dir=data_dir, device=dev)
    t0 = time.monotonic()
    stats = mgr.run()
    wall = time.monotonic() - t0
    out = {
        "rung": name,
        "sim_seconds": stats.sim_time_ns / 1e9,
        "wall_seconds": round(wall, 3),
        "sim_per_wall": round(stats.sim_time_ns / 1e9 / wall, 3),
        "events_per_sec": round(stats.events_executed / wall, 1),
        "events": stats.events_executed,
        "packets": stats.packets_sent,
        "failures": len(stats.process_failures),
        "transport": transport,
        "device": str(dev),
        "backend": backend_fingerprint(dev),
    }
    print(json.dumps(out), flush=True)
    return out


# -- rung 1 ------------------------------------------------------------------

def write_served_file(tmp, size: int) -> Path:
    """Rung 1's served file, `tmp/data.bin`: `size` bytes of 0..255."""
    path = Path(tmp) / "data.bin"
    path.write_bytes(bytes(range(256)) * (size // 256))
    return path


def rung1_text(tmp, py: str, curl: str) -> str:
    """Rung 1's config: `py -m http.server` serving `tmp` to two `curl`
    clients, each writing `tmp/out{i}.bin` in its host's view."""
    clients = "\n".join(
        f"""  client{i}:
    network_node_id: 0
    processes:
    - {{path: {curl}, args: ["-s", "-o", "{tmp}/out{i}.bin",
        "http://server:8000/data.bin"], start_time: {3 + i}s,
       expected_final_state: {{exited: 0}}}}"""
        for i in range(2))
    return f"""
general: {{stop_time: 120s, seed: 1}}
network:
  graph: {{type: 1_gbit_switch}}
hosts:
  server:
    network_node_id: 0
    processes:
    - {{path: {py}, args: ["-m", "http.server", "8000",
        "--bind", "0.0.0.0", "--directory", "{tmp}"], start_time: 1s,
       expected_final_state: running}}
{clients}
"""


def rung1(size: int = 10 * 1024 * 1024, *, tmp=None, data_dir=None,
          device=None, transport: str = "cpu") -> dict:
    """Rung 1 with real binaries: `python3 -m http.server` serving a 10
    MiB file to two real `curl` clients over a 1 Gbit switch (the
    reference's getting-started example). `tmp` holds the served file
    (a new directory with it written when None); the data directory is
    `tmp/data` unless given. Each client's file is checked by size.
    Skips, saying so, where `python3` or `curl` is missing."""
    py, curl = shutil.which("python3"), shutil.which("curl")
    if py is None or curl is None:
        print(json.dumps({"rung": "rung1_real_binaries",
                          "skipped": "python3/curl missing"}), flush=True)
        return {}
    if tmp is None:
        tmp = tempfile.mkdtemp(prefix="rung1-")
        write_served_file(tmp, size)
    data_dir = str(data_dir or f"{tmp}/data")
    out = run_rung("rung1_real_binaries",
                   with_transport(rung1_text(tmp, py, curl), transport),
                   data_dir, device=device, transport=transport)
    for i in range(2):
        # an absolute -o path lands in the client's own view of the
        # file system under its host directory
        got = Path(f"{data_dir}/hosts/client{i}/root{tmp}/out{i}.bin")
        n = got.stat().st_size if got.exists() else None
        if n != size:
            raise RuntimeError(f"rung 1: client{i} fetched {n} bytes, not "
                               f"{size}")
    return out


# -- rungs 2 and 3 -----------------------------------------------------------

def rung2_text(n_hosts: int = 100, size: int = 1_048_576) -> str:
    """Rung 2's config: one tgen server and `n_hosts - 1` clients, each
    pulling `size` bytes, on one vertex, for 60 s."""
    hosts = ["  server:\n    network_node_id: 0\n    processes:\n"
             "    - {path: tgen-server, args: ['8888'], start_time: 1s,\n"
             "       expected_final_state: running}"]
    for i in range(n_hosts - 1):
        hosts.append(
            f"  client{i}:\n    network_node_id: 0\n    processes:\n"
            f"    - {{path: tgen-client, args: ['server', '8888', "
            f"'{size}', '1'], start_time: 2s}}"
        )
    return ("general: {stop_time: 60s, seed: 1}\n"
            "network:\n  graph:\n    type: 1_gbit_switch\n"
            "hosts:\n" + "\n".join(hosts))


def rung2(n_hosts: int = 100, size: int = 1_048_576, *, data_dir=None,
          device=None, transport: str = "cpu") -> dict:
    """The 100-host tgen mesh: one server, 99 clients of 1 MiB."""
    return run_rung(f"rung2_tgen_mesh_{n_hosts}",
                    with_transport(rung2_text(n_hosts, size), transport),
                    data_dir, device=device, transport=transport)


def rung3_text(n_hosts: int = 1000, n_nodes: int = 40, size: int = 262_144,
               use_flow_engine: bool = False) -> str:
    """Rung 3's config: `n_hosts` over a full mesh of `n_nodes` GML nodes
    with 20-200 ms latencies and 0.1-1 % loss; 25 tgen servers and the
    rest clients of `size` bytes, starting over 2-11 s; 120 s. With
    `use_flow_engine` the same YAML asks for the device flow engine."""
    gml = make_gml(n_nodes, 20, 200, 0.001, 0.01, seed=7)
    n_servers = 25
    hosts = []
    for s in range(n_servers):
        hosts.append(
            f"  server{s}:\n    network_node_id: {s % n_nodes}\n"
            f"    processes:\n"
            f"    - {{path: tgen-server, args: ['8888'], start_time: 1s,\n"
            f"       expected_final_state: running}}"
        )
    for i in range(n_hosts - n_servers):
        server = f"server{i % n_servers}"
        hosts.append(
            f"  client{i}:\n    network_node_id: {i % n_nodes}\n"
            f"    processes:\n"
            f"    - {{path: tgen-client, args: ['{server}', '8888', "
            f"'{size}', '1'], start_time: {2 + (i % 10)}s}}"
        )
    flag = ("experimental: {use_flow_engine: true}\n"
            if use_flow_engine else "")
    return ("general: {stop_time: 120s, seed: 1}\n" + flag +
            "network:\n  graph:\n    type: gml\n    inline: |\n" + gml +
            "\nhosts:\n" + "\n".join(hosts))


def rung3(n_hosts: int = 1000, n_nodes: int = 40, size: int = 262_144,
          use_flow_engine: bool = False, *, data_dir=None, device=None,
          transport: str = "cpu") -> dict:
    """Rung 3 (the flow engine's `3f` under `use_flow_engine`, which
    runs as it is whatever `transport` says)."""
    text = rung3_text(n_hosts, n_nodes, size, use_flow_engine)
    if use_flow_engine:
        transport = "flow engine"
    else:
        text = with_transport(text, transport)
    name = "rung3_tgen_atlas_1k" + ("_floweng" if use_flow_engine else "")
    return run_rung(name, text, data_dir, device=device,
                    transport=transport)


# -- rung 4 ------------------------------------------------------------------

def rung4(n_relays: int = 66, n_clients: int = 33, n_nodes: int = 10,
          size: int = 32_768, *, device=None,
          transport: str = "cpu") -> dict:
    """Rung 4, the Tor-shaped workload (`workloads/rung4.py`): 99 real
    compiled onion processes, each client pushing `size` bytes through a
    3-hop circuit over a lossy GML. The run's log (the port's loggers)
    goes through `tools/parse_shadow.py`, and every relay and client
    must appear in its heartbeat hosts."""
    import logging

    tmp = tempfile.mkdtemp(prefix="rung4-onion-")
    rung4_mod.compile_onion(tmp)
    text = rung4_mod.rung4_text(tmp, n_relays, n_clients, n_nodes, size)
    log_path = f"{tmp}/shadow.log"
    handler = logging.FileHandler(log_path)
    handler.setFormatter(logging.Formatter("%(message)s"))
    # the simulator's loggers only, never the root: a caller's console
    # handler is not flooded
    targets = [logging.getLogger(name) for name in LOGGERS]
    saved = [(t, t.level) for t in targets]
    for t in targets:
        t.addHandler(handler)
        t.setLevel(logging.INFO)
    try:
        out = run_rung(f"rung4_onion_{n_relays + n_clients}_procs",
                       with_transport(text, transport),
                       data_dir=f"{tmp}/data", device=device,
                       transport=transport)
    finally:
        for t, lvl in saved:
            t.removeHandler(handler)
            t.setLevel(lvl)
        handler.close()
    parsed = subprocess.run(
        [sys.executable, str(PARSE_SHADOW), log_path, "-p", tmp],
        check=True, capture_output=True, text=True).stdout
    with open(f"{tmp}/stats.shadow.json") as fh:
        stats = json.load(fh)
    n_hb_hosts = len(stats.get("nodes", {}))
    if n_hb_hosts < n_relays + n_clients:
        raise RuntimeError(f"rung 4: heartbeat contract broken: "
                           f"{n_hb_hosts} hosts in parse_shadow's output, "
                           f"{n_relays + n_clients} expected")
    out["heartbeat_hosts"] = n_hb_hosts
    print(json.dumps({"rung": out["rung"], "heartbeat_hosts": n_hb_hosts,
                      "parse_shadow": parsed.strip()}), flush=True)
    return out


# -- the interposition rung --------------------------------------------------

def tcp_pair_sources() -> dict[str, str]:
    """The C sources of the TCP transfer pair, `SERVER_C` and `CLIENT_C`
    of tests/test_managed_network.py, read from its text."""
    src = MANAGED_TESTS.read_text()
    return {name: re.search(rf'{var} = r"""(.*?)"""', src, re.S).group(1)
            for name, var in (("server", "SERVER_C"),
                              ("client", "CLIENT_C"))}


def compile_tcp_pair(out_dir) -> None:
    """`server` and `client` of the TCP pair, built with `gcc -O1` in
    `out_dir` beside their sources."""
    for name, code in tcp_pair_sources().items():
        (Path(out_dir) / f"{name}.c").write_text(code)
        subprocess.run(["gcc", "-O1", "-o", f"{out_dir}/{name}",
                        f"{out_dir}/{name}.c"], check=True,
                       capture_output=True, text=True)


def interpose_text(tmp, n_pairs: int = 50, size: int = 262_144) -> str:
    """The interposition rung's config: `n_pairs` servers and clients of
    the TCP pair in `tmp`, each client fetching `size` bytes, 30 s."""
    hosts = []
    for i in range(n_pairs):
        hosts.append(
            f"  srv{i}:\n    network_node_id: 0\n    ip_addr: 10.9.{i // 250}.{i % 250 + 1}\n"
            f"    processes:\n"
            f"    - {{path: {tmp}/server, args: ['9000', '{size}'],\n"
            f"       start_time: 1s, expected_final_state: {{exited: 0}}}}"
        )
        hosts.append(
            f"  cli{i}:\n    network_node_id: 0\n    ip_addr: 10.9.{i // 250 + 100}.{i % 250 + 1}\n"
            f"    processes:\n"
            f"    - {{path: {tmp}/client, args: ['10.9.{i // 250}.{i % 250 + 1}', "
            f"'9000', '{size}'],\n"
            f"       start_time: 2s, expected_final_state: {{exited: 0}}}}"
        )
    return ("general: {stop_time: 30s, seed: 1}\n"
            "network:\n  graph:\n    type: 1_gbit_switch\n"
            "hosts:\n" + "\n".join(hosts))


def rung_interpose(n_pairs: int = 50, size: int = 262_144, *, tmp=None,
                   data_dir=None, device=None,
                   transport: str = "cpu") -> dict:
    """2 x `n_pairs` real compiled processes, each under the shim with
    its own IPC channel and death watcher; adds the simulator process's
    peak RSS (`peak_rss_mib`). `tmp` holds the built pair (built into a
    new directory when None)."""
    import resource

    if tmp is None:
        tmp = tempfile.mkdtemp(prefix="interpose-bench-")
        compile_tcp_pair(tmp)
    out = run_rung(f"rung_interpose_{2 * n_pairs}_procs",
                   with_transport(interpose_text(tmp, n_pairs, size),
                                  transport),
                   data_dir, device=device, transport=transport)
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out["peak_rss_mib"] = round(peak_kb / 1024, 1)
    print(json.dumps({"rung": out["rung"],
                      "peak_rss_mib": out["peak_rss_mib"]}), flush=True)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rung", nargs="?", default="all",
                    choices=(*RUNGS, "all"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the transport and the flow engine "
                         "(default: the CUDA card)")
    ap.add_argument("--transport", choices=TRANSPORTS, default="auto",
                    help="cpu: the CPU routing (the JAX tool's YAML); "
                         "auto, sync, mirrored: the device transport in "
                         "that mode")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    kw = dict(device=device, transport=args.transport)
    run = {"1": lambda: rung1(**kw), "2": lambda: rung2(**kw),
           "3": lambda: rung3(**kw),
           "3f": lambda: rung3(use_flow_engine=True, **kw),
           "4": lambda: rung4(**kw),
           "interpose": lambda: rung_interpose(**kw)}
    for name in RUNGS:
        if args.rung in (name, "all"):
            run[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Record a device-transport call log from a run of the JAX package's
Manager, for `shadow_tpu_torch.tools.transport_replay`.

`record(cfg_text)` runs the Manager on the CPU with a subclass of the
JAX `DeviceTransport` that writes every `capture`, `release`,
`finish_round`, `apply_fault_latency` and `finalize` into a `LogWriter`,
with the pushes and `next_pending_abs` each release produced. Captures
come from the worker threads: the recorder serialises them under one
lock, so the log's order is the order in which the transport saw them.
`add_mirrored_record` then replays the log through the JAX transport in
mirrored mode and stores its verified windows and packets in the log's
meta, the end state a mirrored replay is held to.

Usage (from the repository root, on the CPU):
    JAX_PLATFORMS=cpu python tests/transport_recorder.py CONFIG.yaml OUT.npz
    JAX_PLATFORMS=cpu python tests/transport_recorder.py phold OUT.npz

CONFIG's `experimental:` line is replaced by
`{use_tpu_transport: true, tpu_transport_mode: sync}`; `phold` records
the PHOLD config of `tests/test_tpu_transport.py`.
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import numpy as np

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent)]

from shadow_tpu.core.config import load_config_str  # noqa: E402
from shadow_tpu.core.manager import Manager  # noqa: E402
from shadow_tpu.tpu import transport as jax_transport  # noqa: E402
from shadow_tpu_torch.tools import transport_replay as tr  # noqa: E402

TRANSPORT_LINE = ("experimental: {use_tpu_transport: true, "
                  "tpu_transport_mode: sync}")


def transport_config(cfg_text: str) -> str:
    """`cfg_text` with its experimental line set to the sync transport."""
    out, n = re.subn(r"(?m)^experimental:.*$", TRANSPORT_LINE, cfg_text)
    if n != 1:
        raise ValueError("the config needs exactly one experimental: line")
    return out


def recording_class(sink: list):
    """A JAX `DeviceTransport` subclass that records into a `LogWriter`,
    appended to `sink` at construction (the port's recorder over the JAX
    transport class)."""
    return tr.recording_class(sink, base=jax_transport.DeviceTransport)


def record(cfg_text: str):
    """Run the Manager on `cfg_text` (a transport config) with the
    recording transport. Returns (stats, LogWriter)."""
    sink: list = []
    orig = jax_transport.DeviceTransport
    jax_transport.DeviceTransport = recording_class(sink)
    try:
        stats = Manager(load_config_str(cfg_text)).run()
    finally:
        jax_transport.DeviceTransport = orig
    (t,) = sink
    t.log.meta["stats"] = {
        "rounds": stats.rounds, "packets_sent": stats.packets_sent,
        "packets_dropped": stats.packets_dropped,
        "process_failures": len(stats.process_failures)}
    return stats, t.log


def jax_transport_factory(hosts, routing, mode, **kw):
    """The JAX package's `DeviceTransport`, for `transport_replay.replay`."""
    return jax_transport.DeviceTransport(hosts, routing, None, mode=mode,
                                         **kw)


def add_mirrored_record(log_path: str) -> dict:
    """Replay the log at `log_path` through the JAX transport in mirrored
    mode and store what it verified in the log's meta (rewriting the
    npz). Returns that record."""
    log = tr.load_log(log_path)
    out = tr.replay(log, "mirrored", make_transport=jax_transport_factory,
                    check_end=False)
    rec = {k: out[k] for k in ("in_flight", "divergence_count",
                               "verified_windows", "verified_packets")}
    log["meta"]["mirrored"] = rec
    arrays = {k: v for k, v in log.items() if k != "meta"}
    np.savez_compressed(log_path, meta=np.array(json.dumps(
        log["meta"], sort_keys=True)), **arrays)
    return rec


def main(argv=None) -> int:
    cfg_arg, out_path = (argv or sys.argv[1:])[:2]
    if cfg_arg == "phold":
        # the PHOLD config of tests/test_tpu_transport.py (3 hosts, 20 s)
        from test_tpu_transport import PHOLD

        name, text = "test_tpu_transport.PHOLD", PHOLD.format(device="true")
    else:
        name, text = Path(cfg_arg).name, Path(cfg_arg).read_text()
    t0 = time.perf_counter()
    _stats, log = record(transport_config(text))
    log.meta["source"] = (f"shadow_tpu Manager run of {name} with "
                          f"{TRANSPORT_LINE} on the CPU")
    log.save(out_path)
    t1 = time.perf_counter()
    rec = add_mirrored_record(out_path)
    print(json.dumps({"record_s": round(t1 - t0, 1),
                      "mirrored_s": round(time.perf_counter() - t1, 1),
                      "meta": log.meta, "mirrored": rec}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

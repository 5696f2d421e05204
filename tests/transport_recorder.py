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
import threading
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
    """A `DeviceTransport` subclass that records into a `LogWriter`,
    appended to `sink` at construction."""
    base = jax_transport.DeviceTransport

    class Recording(base):
        def __init__(self, hosts, routing, ip_to_node_id, **kw):
            super().__init__(hosts, routing, ip_to_node_id, **kw)
            self._rec_lock = threading.Lock()
            self._rec_tags: dict[int, int] = {}
            self._rec_pushes: list = []
            self.log = tr.LogWriter(
                self._base_latency_np, np.asarray(self._host_node),
                {"ingress_cap": self._ingress_cap,
                 "compact_cap": self._compact_cap,
                 "capacity_mode": self._capacity_mode,
                 "max_doublings": self._max_doublings,
                 "capacity_strict": self._capacity_strict,
                 "recorded_mode": self.mode})
            for h in self.hosts:
                h.push_packet_event = self._recording_push(h)
            sink.append(self)

        def _recording_push(self, host):
            orig = host.push_packet_event

            def push(packet, deliver_abs, src_id, seq):
                self._rec_pushes.append((
                    host.host_id - 1, deliver_abs, src_id, seq,
                    self._rec_tags.pop(id(packet), -1)))
                return orig(packet, deliver_abs, src_id, seq)

            return push

        def enable_guards(self):
            self.log.meta["guards"] = True
            super().enable_guards()

        def enable_histograms(self):
            self.log.meta["histograms"] = True
            super().enable_histograms()

        def capture(self, src_host, dst_host, packet, now_ns, seq,
                    round_end_ns, deliver_ns):
            with self._rec_lock:
                super().capture(src_host, dst_host, packet, now_ns, seq,
                                round_end_ns, deliver_ns)
                if not self.mirrored:
                    self._rec_tags[id(packet)] = self._pending[-1][3]
                self.log.capture(src_host.host_id - 1,
                                 dst_host.host_id - 1, seq, now_ns,
                                 round_end_ns, deliver_ns)

        def release(self, start_ns, end_ns, horizon_ns=None,
                    runahead_ns=None, stop_ns=None):
            self.log.release(start_ns, end_ns, horizon_ns, runahead_ns,
                             stop_ns)
            self._rec_pushes = []
            super().release(start_ns, end_ns, horizon_ns, runahead_ns,
                            stop_ns)
            self.log.release_result(self._rec_pushes, self.next_pending_abs)

        def finish_round(self, start_ns, end_ns):
            self.log.finish(start_ns, end_ns)
            super().finish_round(start_ns, end_ns)

        def apply_fault_latency(self, lat_mult):
            self.log.latency_change(lat_mult)
            super().apply_fault_latency(lat_mult)

        def finalize(self):
            super().finalize()
            self.log.meta["retry"] = {
                k: getattr(self, k) for k in (
                    "retry_attempts", "retry_backoff_s", "retry_cap_s",
                    "retry_jitter", "retry_seed")}
            self.log.finalize({
                "in_flight": self.in_flight,
                "divergence_count": self.divergence_count,
                "verified_windows": self.verified_windows,
                "verified_packets": self.verified_packets})

    return Recording


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

"""Device flow-engine benchmark: the rung-3 workload shape on the card.

Twin of `tools/bench_flows.py` for the port (`tpu/floweng.py`, kernel F):
975 flows (the rung-3 client count), 256 KiB each, one-way latencies
20-200 ms drawn from seed 7, 20 ms windows in chunks of 25, run to
completion with `run_to_completion`. It prints one JSON line with the
JAX tool's keys, a `device` fingerprint and `launches` (kernel F's
launches: chunks run times attempts), and `digest`, the sha256 of the
run's `flow_results` (`results_digest`), which a run of the same world
through the JAX package on the CPU gives as `GOLDEN_FLOW_DIGEST`.

Usage: python -m shadow_tpu_torch.tools.bench_flows [n_flows] [size_bytes]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np

MS = 1000  # us per ms
#: `results_digest` of the default world's `flow_results` (975 flows of
#: 262144 bytes), as the JAX package's `run_to_completion` gives it on
#: the CPU
GOLDEN_FLOW_DIGEST = \
    "e2a090f45bed2841ce08ad4e8619b78172e23f95d110820126a2e9caf66457f1"
#: the default world's outcome beside the digest: every flow complete in
#: 3.0 simulated seconds (150 windows), no saturation retry
GOLDEN_FLOW_SUMMARY = {"flows_complete": 975, "segments": 184275,
                       "retransmits": 0, "queue_drops": 0, "wire_drops": 0,
                       "sim_seconds": 3.0, "saturation_retries": 0}

_RESULT_ARRAYS = ("complete_us", "bytes_read", "bytes_expected", "states")
_RESULT_COUNTS = ("segments", "retransmits", "queue_drops", "wire_drops",
                  "saturated_windows")


def results_digest(res: dict) -> str:
    """sha256 over a `flow_results` dict: each per-flow array's dtype,
    shape and bytes, then each counter, in a fixed order. Either
    package's `flow_results` digests alike."""
    h = hashlib.sha256()
    for k in _RESULT_ARRAYS:
        a = np.ascontiguousarray(np.asarray(res[k]))
        h.update(f"{k}:{a.dtype.str}:{a.shape};".encode())
        h.update(a.tobytes())
    for k in _RESULT_COUNTS:
        h.update(f"{k}={int(res[k])};".encode())
    return h.hexdigest()


def default_world_args(n_flows: int = 975, size: int = 262_144):
    """(latency_us, size_bytes, queue_slots, window_us) of the benchmark
    world, as `tools/bench_flows.py` draws it."""
    rng = np.random.default_rng(7)
    lats = rng.integers(20, 200, n_flows) * MS
    return lats, np.full(n_flows, size), 128, 20 * MS


def run(n_flows: int = 975, size: int = 262_144, device=None) -> dict:
    import torch

    from .. import resolve_device
    from ..tpu import floweng

    dev = resolve_device(device)
    lats, sizes, queue_slots, window_us = default_world_args(n_flows, size)
    world = floweng.make_flow_world(lats, sizes, queue_slots=queue_slots,
                                    device=dev)
    floweng.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    world, sim_s, retries = floweng.run_to_completion(
        world, window_us, max_sim_s=40.0, chunk_windows=25, probe_every=2)
    res = floweng.flow_results(world)
    wall = time.monotonic() - t0
    done = int((res["bytes_read"] == res["bytes_expected"]).sum())
    if dev.type == "cuda":
        fingerprint = f"gpu:{torch.cuda.get_device_name(dev)}"
    else:
        fingerprint = f"cpu:torch-{torch.__version__}"
    return {
        "bench": "device_flow_engine",
        "flows": n_flows,
        "bytes_per_flow": size,
        "flows_complete": done,
        "sim_seconds": sim_s,
        "wall_seconds": round(wall, 2),
        "segments": res["segments"],
        "segments_per_sec": round(res["segments"] / wall, 1),
        "retransmits": res["retransmits"],
        "queue_drops": res["queue_drops"],
        "saturation_retries": retries,
        "device": fingerprint,
        "launches": floweng.LAUNCHES["flow_window"],
        "digest": results_digest(res),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_flows", nargs="?", type=int, default=975)
    ap.add_argument("size_bytes", nargs="?", type=int, default=262_144)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.n_flows, args.size_bytes, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""The port's telemetry harvest against the JAX package's, bitwise: the
modular counter helpers (`unwrap_u32`, `counter_delta`,
`apply_counter_delta`) on random int32 values across the 2^31 and 2^32
wraps, and the heartbeat JSONL of the scenario runner, byte for byte,
for a direct, a lossy-flows and a serving entry with the histograms."""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shadow_tpu.telemetry import harvest as jharvest  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch.telemetry import harvest as tharvest  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

CORPUS = Path(__file__).resolve().parent.parent / "scenarios"


def _wrapping_pairs(seed):
    """(prev, cur) int32 snapshots whose modular deltas cross the 2^31
    sign flip and the 2^32 wrap, with zero and large deltas."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(-2**31, 2**31, 4096, dtype=np.int64)
    prev[:64] = 2**31 - 1 - rng.integers(0, 50, 64)  # just under 2^31
    prev[64:128] = -1 - rng.integers(0, 50, 64)  # just under 2^32 (u32)
    delta = rng.integers(0, 2**32, 4096, dtype=np.int64)
    delta[:128] = rng.integers(1, 200, 128)
    delta[128:160] = 0
    cur = ((prev + delta + 2**31) % 2**32) - 2**31
    return prev.astype(np.int32), cur.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_helpers_match_jax_across_the_wrap(seed):
    prev, cur = _wrapping_pairs(seed)
    got = tharvest.unwrap_u32(prev, cur)
    assert got.dtype == np.int64
    assert np.array_equal(got, jharvest.unwrap_u32(prev, cur))
    d = tharvest.counter_delta(prev, cur)
    jd = jharvest.counter_delta(prev, cur)
    assert d.dtype == jd.dtype == np.uint32 and np.array_equal(d, jd)
    assert np.array_equal(d.astype(np.int64), got)
    back = tharvest.apply_counter_delta(prev, d)
    assert back.dtype == np.int32 and np.array_equal(back, cur)
    assert np.array_equal(back, jharvest.apply_counter_delta(prev, jd))
    # scalars, as the metrics' per-window counters are
    assert tharvest.unwrap_u32(prev[0], cur[0]) == \
        jharvest.unwrap_u32(prev[0], cur[0])


def test_counter_helpers_refuse_other_dtypes():
    with pytest.raises(TypeError, match="int32"):
        tharvest.counter_delta(np.zeros(2, np.int64), np.zeros(2, np.int32))
    with pytest.raises(TypeError, match="uint32"):
        tharvest.apply_counter_delta(np.zeros(2, np.int32),
                                     np.zeros(2, np.int32))


def test_harvester_drains_one_tick_late_and_unwraps_tensors():
    """Tensors are copied at the tick, so a later write to the source is
    not seen; totals unwrap through the int32 wrap; annotations ride the
    next sim line; `finalize` drains the last snapshot."""
    buf = io.StringIO()
    hv = tharvest.TelemetryHarvester(interval_ns=10, sink=buf,
                                     host_names=["a", "b"])
    c = torch.tensor([2**31 - 2, 5], dtype=torch.int32)
    hv.note_event({"kind": "x", "time_ns": 5})
    hv.tick(10, device={"pkts_out": c, "max_eg_depth": c.clone()})
    c[0] = -2**31 + 3  # a wrap by 5, after the snapshot was taken
    assert hv.harvests == 0 and hv.emitted == 0
    hv.tick(20, device={"pkts_out": c, "max_eg_depth": c.clone()})
    hv.finalize()
    sims = [r for r in hv.heartbeats if r["type"] == "sim"]
    assert [s["time_ns"] for s in sims] == [10, 20]
    assert sims[0]["annotations"] == [{"kind": "x", "time_ns": 5}]
    assert sims[0]["device_totals"]["pkts_out"] == 2**31 - 2 + 5
    assert sims[1]["device_totals"]["pkts_out"] == 2**31 + 3 + 5
    hosts = [r for r in hv.heartbeats if r["type"] == "host"]
    assert [h["host"] for h in hosts] == ["a", "b", "a", "b"]
    assert hv.emitted == 6 and len(buf.getvalue().splitlines()) == 6


@pytest.mark.parametrize("entry", ["incast", "rpc_fanout_lossy",
                                   "serve_burst_lossy"])
def test_runner_heartbeats_equal_jax_byte_for_byte(entry):
    path = str(CORPUS / f"{entry}.yaml")
    out = {}
    for name, mod, spec, kw in (
            ("jax", jharvest, jspec.load_scenario_file(path), {}),
            ("torch", tharvest, tspec.load_scenario_file(path),
             dict(device="cpu"))):
        buf = io.StringIO()
        hv = mod.TelemetryHarvester(interval_ns=spec.window_ns, sink=buf)
        run = (jrunner if name == "jax" else trunner).run_scenario
        rec = run(spec, telemetry=hv, telemetry_every=8, histograms=True,
                  **kw)
        hv.finalize()
        out[name] = (buf.getvalue(), rec)
    text, rec = out["torch"]
    assert text == out["jax"][0]
    assert rec == out["jax"][1]
    assert '"hist"' in text and '"workload_phase"' in text

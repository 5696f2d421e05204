"""The port's run ledger against the JAX package's: the span `(r0, r1,
mode)` sequences, annotation kinds and span salts of the same runs
(plain, memoized, faulted, killed-free), the readers `stitch_ledger`,
`phase_totals` and `memo_view` and the Chrome-trace export on ledgers
either package wrote, and the backend fingerprint naming torch."""

from __future__ import annotations

import io
import json
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shadow_tpu.telemetry import harvest as jharvest  # noqa: E402
from shadow_tpu.telemetry import tracer as jtracer  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch.telemetry import harvest as tharvest  # noqa: E402
from shadow_tpu_torch.telemetry import tracer as ttracer  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

CORPUS = Path(__file__).resolve().parent.parent / "scenarios"
BACKEND = {"platform": "cpu", "device_kind": "cpu"}

CASES = {
    "plain": ("incast", {}),
    "telemetry": ("ring_allreduce", dict(telemetry=True)),
    "memo": ("ring_allreduce", dict(memo=True)),
    "faulted": ("incast", dict(use_default_faults=True, guards=True)),
    "faulted-memo": ("rpc_fanout_lossy", dict(use_default_faults=True,
                                              memo=True)),
}


def _ledgers(entry, kw):
    """The ledger records of the same run through each package."""
    path = str(CORPUS / f"{entry}.yaml")
    out = {}
    for name, tmod, hmod, smod, rmod, extra in (
            ("jax", jtracer, jharvest, jspec, jrunner, {}),
            ("torch", ttracer, tharvest, tspec, trunner,
             dict(device="cpu"))):
        spec = smod.load_scenario_file(path)
        tr = tmod.RunTracer(spec.name, backend=BACKEND)
        run_kw = dict(kw)
        if run_kw.pop("telemetry", False):
            run_kw["telemetry"] = hmod.TelemetryHarvester(
                interval_ns=spec.window_ns, sink=io.StringIO())
        rec = rmod.run_scenario(spec, tracer=tr, **run_kw, **extra)
        tr.close()
        out[name] = (tr.records, rec)
    return out


def _shape(records):
    """A ledger without its wall clocks."""
    return [{k: v for k, v in r.items() if k not in jtracer.WALL_FIELDS}
            for r in records]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_spans_and_annotations_equal_jax(case):
    entry, kw = CASES[case]
    out = _ledgers(entry, kw)
    (jrec, jres), (trec, tres) = out["jax"], out["torch"]
    assert tres == jres
    assert _shape(trec) == _shape(jrec)
    spans = [(r["r0"], r["r1"], r["mode"]) for r in trec
             if r["kind"] == "span"]
    assert spans and spans[-1][1] == tres["windows"]
    kinds = {r["kind"] for r in trec}
    if "memo" in kw:
        assert "memo" in kinds and {"execute"} < {m for *_, m in spans}
    if "telemetry" in kw:
        assert "harvest" in kinds
    if "use_default_faults" in kw:
        assert all("span_salt" in r for r in trec if r["kind"] == "span")


def test_readers_and_chrome_trace_equal_jax_on_either_ledger(tmp_path):
    out = _ledgers("ring_allreduce", dict(memo=True, telemetry=True,
                                          telemetry_every=4))
    for name, (records, _rec) in out.items():
        # a stitched ledger: a resume seam in the middle
        seam = len(records) // 2
        records = (records[:seam]
                   + [{"kind": "resume", "checkpoint": "x", "r": 16,
                       "wall_t0_ms": 0.5}]
                   + [dict(r, wall_t0_ms=r["wall_t0_ms"] / 3)
                      if "wall_t0_ms" in r else r
                      for r in records[seam:]])
        assert ttracer.stitch_ledger(records) == \
            jtracer.stitch_ledger(records), name
        assert ttracer.phase_totals(records) == \
            jtracer.phase_totals(records), name
        assert ttracer.memo_view(records) == jtracer.memo_view(records)
        assert ttracer.memo_view(records)["hits"] > 0
        lines = [json.dumps(r, sort_keys=True) for r in records]
        assert ttracer.read_ledger(lines) == jtracer.read_ledger(lines)
        tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
        assert ttracer.write_chrome_trace(records, str(tpath)) == {
            **jtracer.write_chrome_trace(records, str(jpath)),
            "path": str(tpath)}
        assert tpath.read_bytes() == jpath.read_bytes()


def test_streamed_ledger_survives_and_resumes(tmp_path):
    sink = tmp_path / "run.ledger.jsonl"
    tr = ttracer.RunTracer("run", backend=BACKEND, sink=str(sink))
    t0 = tr.clock()
    tr.span(0, 4, mode="execute", t0=t0)
    # no close(): a killed run's ledger is on disk record by record
    assert [r["kind"] for r in ttracer.load_ledger(str(sink))] == [
        "meta", "span"]
    tr2 = ttracer.RunTracer("run", backend=BACKEND, sink=str(sink),
                            resume=True)
    tr2.annotate("resume", checkpoint="run-r00000004", r=4)
    tr2.span(4, 8, mode="ffwd", t0=tr2.clock())
    tr2.close()
    recs = jtracer.load_ledger(str(sink))
    assert [r["kind"] for r in recs] == ["meta", "span", "resume", "span",
                                         "end"]
    assert jtracer.phase_totals(recs)["resumes"] == 1
    assert tr2.write(str(sink))["streamed"]
    with pytest.raises(ValueError, match="sink"):
        ttracer.RunTracer("run", backend=BACKEND, resume=True)
    with pytest.raises(ValueError, match="schema"):
        ttracer.read_ledger(['{"kind": "meta", "schema": "runledger-v0"}'])


def test_backend_fingerprint_names_torch():
    fp = ttracer.backend_fingerprint("cpu")
    assert fp["platform"] == "cpu" and fp["device_kind"] == "cpu"
    assert fp["torch"] == torch.__version__
    assert "tpu" not in json.dumps(fp).lower()
    tr = ttracer.RunTracer("x", backend=fp)
    assert tr.records[0]["backend"] == fp
    assert tr.records[0]["schema"] == jtracer.RUNLEDGER_SCHEMA
    if not torch.cuda.is_available():
        assert ttracer.backend_fingerprint()["platform"] == "cpu"

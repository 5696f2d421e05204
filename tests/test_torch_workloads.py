"""The port's workload stack against the JAX package's, bitwise: the
scenario spec and compiler (fingerprints and program digests of the
whole corpus), `workload_step`, and the scenario runner's records for
every corpus entry, the flow-transport and serving entries' `flows`,
`compute` and `slo` sections included, which must also carry the golden
digests of `scenarios/GOLDEN.json`; the fault, guard and flight-recorder
runs of a direct, a flow and a serving entry, hops included. Also what
the port refuses yet, and the corpus command's `--check`,
`--slo-report`, `--faults`, `--guards` and `--sample-every`."""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import assert_tuples_equal, jax_state_to_numpy  # noqa: E402

from shadow_tpu.telemetry import make_metrics  # noqa: E402
from shadow_tpu.tpu.plane import unpack_planes, window_step  # noqa: E402
from shadow_tpu.workloads import compile as jcompile  # noqa: E402
from shadow_tpu.workloads import device as jdevice  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.workloads import compile as tcompile  # noqa: E402
from shadow_tpu_torch.workloads import device as tdevice  # noqa: E402
from shadow_tpu_torch.workloads import run_scenarios  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

CORPUS = Path(__file__).resolve().parent.parent / "scenarios"
GOLDEN = json.loads((CORPUS / "GOLDEN.json").read_text())
ENTRIES = sorted(p.stem for p in CORPUS.glob("*.yaml"))


def test_corpus_has_ten_entries():
    assert len(ENTRIES) == 10 and set(GOLDEN) == {
        tspec.load_scenario_file(str(CORPUS / f"{e}.yaml")).name
        for e in ENTRIES}


@pytest.mark.parametrize("entry", ENTRIES)
def test_spec_and_program_match_jax(entry):
    path = str(CORPUS / f"{entry}.yaml")
    jsp, tsp = jspec.load_scenario_file(path), tspec.load_scenario_file(path)
    assert tsp.as_dict() == jsp.as_dict()
    assert tspec.scenario_fingerprint(tsp) == jspec.scenario_fingerprint(jsp)
    jprog, tprog = jcompile.compile_program(jsp), tcompile.compile_program(tsp)
    assert tcompile.program_digest(tprog) == jcompile.program_digest(jprog)
    assert tcompile.program_digest(tprog) == \
        GOLDEN[tsp.name]["program_digest"]


@pytest.mark.parametrize("raw", [
    {"name": "lossy", "hosts": 4, "loss_p": 0.1,
     "patterns": [{"kind": "onoff"}]},
    {"name": "overlap", "hosts": 4,
     "patterns": [{"kind": "incast", "count": 3},
                  {"kind": "onoff", "first": 2}]},
    {"name": "wide", "hosts": 4, "egress_cap": 2,
     "patterns": [{"kind": "onoff", "burst": 8}]},
], ids=["loss-needs-flows", "overlapping-hosts", "burst-past-egress"])
def test_spec_refusals_match_jax(raw):
    """The copied validation raises where the JAX package's does, with
    the same message, at parse or at compile time."""
    def refusal(spec_mod, compile_mod):
        with pytest.raises(spec_mod.ScenarioError) as e:
            compile_mod.compile_program(spec_mod.parse_scenario(raw))
        return str(e.value)
    assert refusal(tspec, tcompile) == refusal(jspec, jcompile)


def test_workload_step_matches_jax():
    """12 windows of the mixed entry (incast, on/off and rpc hosts) step
    by step: window_step("xla") with metrics, then workload_step, with
    the state, the workload state and the metrics compared after each;
    then one step with an explicit credit vector."""
    spec = jspec.load_scenario_file(str(CORPUS / "mixed.yaml"))
    prog = jcompile.compile_program(spec)
    jst, params = jrunner.build_scenario_world(spec)
    wl, ws = jdevice.to_device(prog), jdevice.make_workload_state(prog)
    jst, ws, jm = jdevice.prime(wl, ws, jst, metrics=make_metrics(32))
    tsp = tspec.load_scenario_file(str(CORPUS / "mixed.yaml"))
    tprog = tcompile.compile_program(tsp)
    tst, tparams = trunner.build_scenario_world(tsp, device="cpu")
    twl = tdevice.to_device(tprog, "cpu")
    tws = tdevice.make_workload_state(tprog, "cpu")
    tst, tws, tm = tdevice.prime(twl, tws, tst,
                                 metrics=tmetrics.make_metrics(32,
                                                               device="cpu"))
    key, win = jax.random.key(spec.seed), spec.window_ns

    @jax.jit
    def jround(st, ws, m, r, credits):
        out = window_step(st, params, key, jnp.where(r == 0, 0, win),
                          jnp.int32(win), rr_enabled=False, metrics=m)
        (st, d, _n), m, *_ = unpack_planes(out, metrics=m)
        return jdevice.workload_step(wl, ws, st, d, r, jnp.int32(win),
                                     metrics=m, credits=credits)

    for r in range(13):
        credits = np.full(32, 2, np.int32) if r == 12 else None
        jst, ws, jm = jround(jst, ws, jm, jnp.int32(r),
                             None if credits is None else jnp.asarray(credits))
        out = tplane.window_step(tst, tparams, spec.seed, 0 if r == 0 else win,
                                 win, rr_enabled=False, kernel="xla",
                                 metrics=tm)
        (tst, td, _n), tm, *_ = tplane.unpack_planes(out, metrics=tm)
        tst, tws, tm = tdevice.workload_step(
            twl, tws, tst, td, r, win, metrics=tm,
            credits=None if credits is None else torch.from_numpy(credits))
        assert convert.state_digest(tst) == \
            convert.state_digest(jax_state_to_numpy(jst)), r
        assert_tuples_equal(ws, tws, r)
        assert_tuples_equal(jm, tm, r)
    assert int(tws.phase.sum()) > 0 and int(tm.events) > 0
    assert np.array_equal(tdevice.completion_windows(tws),
                          jdevice.completion_windows(ws))
    assert bool(tdevice.all_done(twl, tws)) == bool(jdevice.all_done(wl, ws))
    back = convert.tuple_from_numpy(tdevice.WorkloadState,
                                    convert.tuple_to_numpy(tws), "cpu")
    assert_tuples_equal(ws, back)


@pytest.mark.parametrize("entry", ENTRIES)
def test_run_scenario_matches_jax_and_golden(entry):
    path = str(CORPUS / f"{entry}.yaml")
    before = dict(pipeline.LAUNCHES)
    got = trunner.run_scenario(tspec.load_scenario_file(path), device="cpu")
    assert pipeline.LAUNCHES == before
    ref = jrunner.run_scenario(jspec.load_scenario_file(path))
    assert got == ref
    assert trunner.golden_entry(got) == GOLDEN[got["name"]]
    assert got["all_done"] and got["events"] > 0


def test_direct_transport_compute_matches_jax():
    """The compute plane on the direct transport (no corpus entry has
    it): raw delivery counts metered through service completion."""
    raw = {"name": "incast-served", "hosts": 12, "windows": 40,
           "compute": {"op": "attn_decode", "queue_cap": 2},
           "patterns": [{"kind": "incast", "count": 12, "rounds": 3}]}
    got = trunner.run_scenario(tspec.parse_scenario(raw), device="cpu")
    assert got == jrunner.run_scenario(jspec.parse_scenario(raw))
    assert got["transport"] == "direct" and got["compute"]["served"] > 0


def test_flow_knobs_match_jax():
    """`flow_emit_cap` and `flow_recv_wnd` change the run as in JAX, and
    out-of-range values are refused as there."""
    path = str(CORPUS / "serve_diurnal.yaml")
    tsp, jsp = tspec.load_scenario_file(path), jspec.load_scenario_file(path)
    got = trunner.run_scenario(tsp, device="cpu", flow_emit_cap=2,
                               flow_recv_wnd=4)
    assert got == jrunner.run_scenario(jsp, flow_emit_cap=2,
                                       flow_recv_wnd=4)
    assert got["flows"]["emit_cap"] == 2 and got["flows"]["recv_wnd"] == 4
    assert got["canonical_digest"] != GOLDEN[got["name"]]["canonical_digest"]
    for cap, wnd in ((0, 4), (5, 4), (1, 0)):
        with pytest.raises(ValueError, match="flow knobs") as e:
            trunner.run_scenario(tsp, device="cpu", flow_emit_cap=cap,
                                 flow_recv_wnd=wnd)
        with pytest.raises(ValueError, match="flow knobs") as je:
            jrunner.run_scenario(jsp, flow_emit_cap=cap, flow_recv_wnd=wnd)
        assert str(e.value) in str(je.value)


def test_unported_runner_options_are_refused(tmp_path):
    """No keyword of the JAX runner is refused any more: `mesh_devices`
    runs the record of the plain run sharded over 2 ranks; the
    run-infrastructure keywords run, their records equal the plain
    run's (the memo's adds its report), and so does any
    `telemetry_every` >= 1. A zero cadence and a keyword the JAX runner
    does not have raise."""
    spec = tspec.load_scenario_file(str(CORPUS / "incast.yaml"))
    short = dataclasses.replace(spec, windows=3)
    base = trunner.run_scenario(short, device="cpu")
    for kw in (dict(trace_ring=4096), dict(telemetry_every=16),
               dict(checkpoint_every=16), dict(telemetry_every=1),
               dict(memo=False, resume=False, memo_cache=None, tracer=None,
                    checkpoint_dir=None, kill_at=None, provenance=None,
                    telemetry=None, mesh_devices=None)):
        assert trunner.run_scenario(short, device="cpu", **kw) == base, kw
    for kw in (dict(memo=True), dict(checkpoint_every=8),
               dict(checkpoint_dir=str(tmp_path / "ckpt")),
               dict(checkpoint_dir=str(tmp_path / "ckpt"), resume=True),
               dict(resume=True)):
        rec = trunner.run_scenario(short, device="cpu", **kw)
        assert ("memo" in rec) == ("memo" in kw), kw
        rec.pop("memo", None)
        assert rec == base, kw
    assert trunner.run_scenario(short, device="cpu", mesh_devices=2) == base
    with pytest.raises(ValueError, match="telemetry_every"):
        trunner.run_scenario(spec, device="cpu", telemetry_every=0)
    with pytest.raises(TypeError, match="unexpected"):
        trunner.run_scenario(spec, device="cpu", colour="blue")


FAULTED = ["incast", "incast_lossy", "serve_burst_lossy"]


@pytest.mark.parametrize("entry", FAULTED)
def test_faulted_guarded_recorded_run_matches_jax(entry):
    """`use_default_faults`, `guards` and `sample_every` on a direct, a
    flow and a serving entry: the record equals the JAX runner's field
    for field (`faults_active`, `drops.fault`, `guards`,
    `flight_recorder` included) and the sampled hops are the same
    JSONL."""
    path = str(CORPUS / f"{entry}.yaml")
    kw = dict(use_default_faults=True, guards=True, sample_every=16)
    jsink, tsink = io.StringIO(), io.StringIO()
    got = trunner.run_scenario(tspec.load_scenario_file(path), device="cpu",
                               hops_sink=tsink, **kw)
    ref = jrunner.run_scenario(jspec.load_scenario_file(path),
                               hops_sink=jsink, **kw)
    assert got == ref
    assert tsink.getvalue() == jsink.getvalue()
    assert got["faults_active"] and got["guards"]["clean"]
    assert got["flight_recorder"]["recorded_hops"] == len(
        tsink.getvalue().splitlines()) > 0
    if entry == "serve_burst_lossy":
        assert got["drops"]["fault"] > 0
        assert got["canonical_digest"] != \
            GOLDEN[got["name"]]["canonical_digest"]


def test_run_scenarios_faults_guards_and_check(capsys):
    incast = str(CORPUS / "incast.yaml")
    assert run_scenarios.main([incast, "--faults", "--guards",
                               "--sample-every", "16", "--device",
                               "cpu"]) == 0
    err = capsys.readouterr().err
    assert "guards=clean" in err and "hops=" in err
    assert run_scenarios.main([incast, "--check", "--faults", "--device",
                               "cpu"]) == 2
    assert run_scenarios.main([incast, "--check", "--guards", "--device",
                               "cpu"]) == 2
    assert "cannot be checked" in capsys.readouterr().err


def test_run_scenarios_check(tmp_path, capsys):
    incast = str(CORPUS / "incast.yaml")
    out = tmp_path / "out.json"
    assert run_scenarios.main([incast, "--check", "--device", "cpu",
                               "-o", str(out)]) == 0
    assert json.loads(out.read_text())["records"][0]["name"] == \
        "incast-16to1"
    tampered = dict(GOLDEN)
    tampered["incast-16to1"] = dict(GOLDEN["incast-16to1"],
                                    canonical_digest="0" * 64)
    bad = tmp_path / "golden.json"
    bad.write_text(json.dumps(tampered))
    assert run_scenarios.main([incast, "--check", "--device", "cpu",
                               "--golden", str(bad)]) == 1
    assert "canonical_digest mismatch" in capsys.readouterr().err


def test_run_scenarios_check_whole_corpus(tmp_path, capsys):
    """The corpus command with no paths runs all ten entries, matches
    every golden digest, and writes the SLO report of the two serving
    entries, stamped with the port's device, not a JAX backend."""
    slo = tmp_path / "slo.json"
    assert run_scenarios.main(["--check", "--device", "cpu",
                               "--slo-report", str(slo)]) == 0
    assert "10 scenario(s) match the golden digests" in \
        capsys.readouterr().err
    report = json.loads(slo.read_text())
    assert report["backend"]["platform"] == "cpu"
    assert report["backend"]["torch"] == torch.__version__
    assert sorted(report["scenarios"]) == ["serve-burst-lossy-10",
                                           "serve-diurnal-12"]
    for entry in report["scenarios"].values():
        assert entry["compute"]["overflow"] == 0
        assert all(t["met"] for t in entry["slo"]["targets"].values())

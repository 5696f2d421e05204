"""The port's full-run checkpoints against the JAX package's: the
refusals (truncation, bit flip, schema drift, a missing leaf, a presence
mismatch, a schedule-fingerprint mismatch) as `CheckpointError`s naming
the field; the runner's checkpoint at round 16 equal to the JAX
runner's, array for array (names, dtypes, bytes) and meta for meta;
a JAX checkpoint resumed by the port and a port checkpoint resumed by
JAX, each ending at the uninterrupted digest; and `run_scenarios
--kill-at` in a subprocess (exit 137) then `--resume`, whose output file
equals the uninterrupted run's byte for byte, faulted and memoized."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shadow_tpu.faults import runstate as jrunstate  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch.faults import runstate as trunstate  # noqa: E402
from shadow_tpu_torch.faults.checkpoint import (  # noqa: E402
    CheckpointError, load_npz_checkpoint, write_npz_checkpoint)
from shadow_tpu_torch.telemetry import flightrec  # noqa: E402
from shadow_tpu_torch.telemetry.metrics import make_metrics  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "scenarios"
# the planes the interchange tests thread: the flight recorder's uint32
# leaves, guards, histograms and the fault schedule's position
ALL_PLANES = dict(use_default_faults=True, guards=True, sample_every=16)


def _toy_carry():
    m = make_metrics(3, device="cpu")
    fr = flightrec.make_flightrec(9, ring=8, device="cpu")
    state = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    return (state, (m, None, fr, 7))


def _save_toy(tmp_path, **kw):
    ck = trunstate.RunCheckpointer(str(tmp_path), every=2, window_ns=100,
                                   **kw)
    return ck.save(2, _toy_carry())["path"]


def _repack(path, mutate):
    """Re-pack the npz with `mutate(arrays)` applied: the zip stays
    well-formed, so only the checksums can catch it."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    mutate(arrays)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def _flip(name):
    def mutate(arrays):
        a = arrays[name].copy()
        a.view(np.uint8).flat[0] ^= 1
        arrays[name] = a
    return mutate


def _truncate(path):
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])


REFUSALS = {
    "truncation": (lambda p: _truncate(p), "truncated or corrupt"),
    "bit flip": (lambda p: _repack(p, _flip("carry.1.0.pkts_out")),
                 "checksum mismatch on array 'carry.1.0.pkts_out'"),
    "missing array": (lambda p: _repack(
        p, lambda a: a.pop("carry.1.2.cursor")),
        "missing array 'carry.1.2.cursor'"),
    "uncovered array": (lambda p: _repack(
        p, lambda a: a.update(extra=np.zeros(1))), "'extra' is not covered"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_corrupt_checkpoints_are_refused_by_name(tmp_path, case):
    path = _save_toy(tmp_path)
    damage, match = REFUSALS[case]
    damage(path)
    with pytest.raises(CheckpointError, match=match):
        trunstate.load_runstate(path)


def test_schema_drift_and_other_kinds_are_refused(tmp_path):
    path = str(tmp_path / "x.runstate.npz")
    write_npz_checkpoint(path, schema="runstate-v0", meta={"kind": "runstate"},
                         arrays={})
    with pytest.raises(CheckpointError, match="schema 'runstate-v0'"):
        trunstate.load_runstate(path)
    write_npz_checkpoint(path, schema=trunstate.RUNSTATE_SCHEMA,
                         meta={"kind": "other"}, arrays={})
    with pytest.raises(CheckpointError, match="kind"):
        trunstate.load_runstate(path)


def test_missing_leaf_presence_and_dtype_mismatches_are_refused(tmp_path):
    path = _save_toy(tmp_path)
    meta, arrays = trunstate.load_runstate(path)
    nones = meta["none_paths"]
    assert nones == ["carry.1.1"]
    state, (m, _none, fr, n) = _toy_carry()
    with pytest.raises(CheckpointError, match="'carry.0.b'"):
        trunstate.restore_carry(({"a": state["a"], "b": state["a"]},
                                 (m, None, fr, n)), arrays,
                                none_paths=nones)
    with pytest.raises(CheckpointError, match="'carry.1.1.pkts_out'"):
        trunstate.restore_carry((state, (m, m, fr, n)), arrays,
                                none_paths=nones)
    with pytest.raises(CheckpointError, match="presence mismatch at "
                                              "'carry.1.0'"):
        trunstate.restore_carry((state, (None, None, fr, n)), arrays,
                                none_paths=nones)
    wide = {"a": state["a"].to(torch.int64)}
    with pytest.raises(CheckpointError, match="'carry.0.a' is int32"):
        trunstate.restore_carry((wide, (m, None, fr, n)), arrays,
                                none_paths=nones)
    back = trunstate.restore_carry(_toy_carry(), arrays, none_paths=nones)
    assert back[1][2].key.dtype == torch.int64 and back[1][3] == 7
    assert arrays["carry.1.2.key"].dtype == np.uint32


def test_schedule_fingerprint_mismatch_is_refused(tmp_path):
    spec = tspec.load_scenario_file(str(CORPUS / "incast.yaml"))
    sched = trunner.default_fault_schedule(spec)
    path = _save_toy(tmp_path, schedule=sched)
    other = trunner.default_fault_schedule(
        tspec.load_scenario_file(str(CORPUS / "mixed.yaml")))
    with pytest.raises(CheckpointError, match="fingerprint mismatch"):
        trunstate.resume_carry(path, _toy_carry(), schedule=other)
    res = trunstate.resume_carry(path, _toy_carry(), schedule=sched)
    assert res["round"] == 2 and sched.fired == [
        e for e in sched.events if e.time_ns <= 200]


def test_checkpointer_cadence_prune_and_latest(tmp_path):
    ck = trunstate.RunCheckpointer(str(tmp_path), every=4, label="x",
                                   keep=2)
    assert ck.cut_rounds(13) == (4, 8, 12)
    assert ck.due(8, 13) and not ck.due(6, 13) and not ck.due(12, 12)
    for r in (4, 8, 12):
        ck.save(r, _toy_carry())
    names = sorted(os.listdir(tmp_path))
    assert names == ["x-r00000008.runstate.npz", "x-r00000012.runstate.npz"]
    assert trunstate.latest_checkpoint(str(tmp_path), "x").endswith(
        "x-r00000012.runstate.npz")
    assert len(ck.save_ms) == 3
    with pytest.raises(ValueError):
        trunstate.RunCheckpointer(str(tmp_path), every=0)


def _checkpoint_at_16(tmp_path, entry, windows=None, **kw):
    """Each package's runner checkpointing every 16 windows (the newest
    two kept), with its uninterrupted record; `windows` cuts the run.
    Returns {package: (dir, record)}."""
    path = str(CORPUS / f"{entry}.yaml")
    out = {}
    for name, smod, rmod, extra in (
            ("jax", jspec, jrunner, {}),
            ("torch", tspec, trunner, dict(device="cpu"))):
        d = tmp_path / name
        spec = smod.load_scenario_file(path)
        if windows is not None:
            spec = dataclasses.replace(spec, windows=windows)
        rec = rmod.run_scenario(spec, checkpoint_dir=str(d),
                                checkpoint_every=16, **kw, **extra)
        out[name] = (d, rec)
    return out


def test_checkpoint_at_round_16_equals_jax_array_for_array(tmp_path):
    out = _checkpoint_at_16(tmp_path, "rpc_fanout_lossy", windows=24,
                            memo=True, **ALL_PLANES)
    name = "rpc-fanout-lossy-8-r00000016.runstate.npz"
    want = load_npz_checkpoint(str(out["jax"][0] / name),
                               schema=jrunstate.RUNSTATE_SCHEMA)
    got = load_npz_checkpoint(str(out["torch"][0] / name),
                              schema=trunstate.RUNSTATE_SCHEMA)
    assert got[0] == want[0]  # the meta: sha256 map, schedule, memo
    assert sorted(got[1]) == sorted(want[1])
    for k, a in want[1].items():
        b = got[1][k]
        assert (b.dtype, b.shape, b.tobytes()) == (a.dtype, a.shape,
                                                   a.tobytes()), k
    assert got[1]["carry.1.4.key"].dtype == np.uint32
    assert out["torch"][1] == out["jax"][1]


@pytest.mark.parametrize("entry,kw", [
    ("serve_burst_lossy", ALL_PLANES),
    ("ring_allreduce", dict(memo=True)),
])
def test_checkpoints_resume_across_packages(tmp_path, entry, kw):
    """A JAX checkpoint resumed by the port and a port checkpoint resumed
    by JAX end at the uninterrupted record."""
    out = _checkpoint_at_16(tmp_path, entry, windows=40, **kw)
    path = str(CORPUS / f"{entry}.yaml")
    want = out["jax"][1]
    for src, smod, rmod, extra in (
            ("jax", tspec, trunner, dict(device="cpu")),
            ("torch", jspec, jrunner, {})):
        d = tmp_path / f"{src}-copy"
        shutil.copytree(out[src][0], d)
        prov = {}
        spec = dataclasses.replace(smod.load_scenario_file(path), windows=40)
        rec = rmod.run_scenario(spec, checkpoint_dir=str(d),
                                checkpoint_every=16, resume=True,
                                provenance=prov, **kw, **extra)
        assert prov["start_round"] == 32, src
        assert rec == want, src


def _heartbeats(path, after_window):
    """A heartbeat file's lines after `after_window` (10 ms windows)
    without their annotations, and the file's set of annotations."""
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    notes = sorted(json.dumps(a, sort_keys=True) for r in recs
                   for a in r.get("annotations", ()))
    lines = [{k: v for k, v in r.items() if k != "annotations"}
             for r in recs if r["time_ns"] > after_window * 10_000_000]
    return lines, notes


def _run_scenarios(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch.workloads.run_scenarios",
         "--device", "cpu", *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600)


@pytest.mark.parametrize("flags", [["--faults", "--guards"],
                                   ["--memo", "--check"]])
def test_killed_and_resumed_output_is_byte_identical(tmp_path, flags):
    paths = [str(CORPUS / f"{e}.yaml") for e in ("rpc_fanout_lossy",
                                                 "mixed")]
    full = _run_scenarios([*paths, *flags, "-o", "full.json", "--telemetry",
                           "tel_full"], tmp_path)
    assert full.returncode == 0, full.stderr
    common = [*paths, *flags, "-o", "kr.json", "--checkpoint-dir", "ck",
              "--telemetry", "tel", "--trace", "tr"]
    killed = _run_scenarios([*common, "--kill-at", "32"], tmp_path)
    assert killed.returncode == 137, killed.stderr
    assert not (tmp_path / "kr.json").exists()
    resumed = _run_scenarios([*common, "--resume"], tmp_path)
    assert resumed.returncode == 0, resumed.stderr
    assert (tmp_path / "kr.json").read_bytes() == \
        (tmp_path / "full.json").read_bytes()
    # the heartbeats after the kill equal, and so does the set of phase
    # annotations (the killed run's undrained snapshot would have carried
    # some; the resumed file's first line carries them instead)
    for name in ("rpc-fanout-lossy-8", "mixed-32"):
        full_hb, res_hb = (_heartbeats(tmp_path / d / f"{name}.jsonl", 32)
                           for d in ("tel_full", "tel"))
        assert full_hb[0] and full_hb == res_hb, name
    prov = (tmp_path / "kr.json.provenance.json").read_text()
    assert "rpc-fanout-lossy-8-r00000032" in prov
    ledger = (tmp_path / "tr" / "rpc-fanout-lossy-8.ledger.jsonl").read_text()
    assert '"kind": "kill"' in ledger and '"kind": "resume"' in ledger
    bad = _run_scenarios([*paths, "--checkpoint-dir", "ck",
                          "--kill-at", "20"], tmp_path)
    assert bad.returncode == 2 and "checkpoint instant" in bad.stderr

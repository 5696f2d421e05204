"""The port's chaos smoke (`python -m shadow_tpu_torch.tools.chaos_smoke`)
against `tools/chaos_smoke.py` at a small size: the same JSON line
(digests, drops, guards, memo stats, latency percentiles; heartbeat and
hop files byte-equal), a killed and resumed run ending at the
uninterrupted digest with and without the memo, `--kernel pallas`
refused, and a `--tamper-at` corruption caught by the guards."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from shadow_tpu_torch.tools import chaos_smoke  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--hosts", "64", "--windows", "24"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_smoke", REPO / "tools" / "chaos_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(mod, argv):
    """(exit code, the JSON line) of a tool's main run in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _port(argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch.tools.chaos_smoke",
         "--device", "cpu", *argv], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600)


@pytest.mark.parametrize("extra", [
    ["--guards", "warn"],
    ["--memo", "--telemetry", "{dir}", "--sample-every", "4",
     "--trace-ring", "256"],
])
def test_json_line_equals_the_jax_tool(tmp_path, extra):
    argv = lambda tag: SMALL + [a.format(dir=tmp_path / tag) for a in extra]
    jrc, want = _main(_jax_tool(), argv("jax"))
    rc, got = _main(chaos_smoke, argv("torch") + ["--device", "cpu"])
    assert rc == jrc == 0
    if "telemetry" in want:
        for name in ("heartbeats.jsonl", "hops.jsonl"):
            assert (tmp_path / "torch" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes()
        for rec in (want, got):
            tel = rec["telemetry"]
            del tel["dir"], tel["trace"]["path"], \
                tel["flight_recorder"]["sink"]
    assert got == want
    assert got["drops"]["fault"] > 0


@pytest.mark.parametrize("memo", [False, True])
def test_killed_and_resumed_run_ends_at_the_uninterrupted_digest(tmp_path,
                                                                 memo):
    flags = SMALL + ["--checkpoint-every", "8", "--guards", "warn"] + (
        ["--memo"] if memo else [])
    full = _port(flags, tmp_path)
    assert full.returncode == 0, full.stderr
    killed = _port(flags + ["--checkpoint-dir", "ck", "--kill-at", "12"],
                   tmp_path)
    assert killed.returncode == 137, killed.stderr
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt-000000000008"]
    resumed = _port(flags + ["--checkpoint-dir", "ck", "--resume",
                             "ck/ckpt-000000000008"], tmp_path)
    assert resumed.returncode == 0, resumed.stderr
    want, got = (json.loads(p.stdout.splitlines()[-1])
                 for p in (full, resumed))
    assert got["state_digest"] == want["state_digest"]
    assert got["guards"] == want["guards"] and got["guards"]["clean"]
    assert got.get("memo") == want.get("memo")


def test_pallas_kernel_is_refused():
    with pytest.raises(SystemExit) as exc:
        chaos_smoke.parse_args(SMALL + ["--kernel", "pallas"])
    assert exc.value.code == 2


def test_tamper_is_caught_by_the_guards():
    rc, out = _main(chaos_smoke, SMALL + ["--device", "cpu", "--guards",
                                          "warn", "--tamper-at", "8"])
    assert rc == 0 and not out["guards"]["clean"]
    rc, out = _main(chaos_smoke, SMALL + ["--device", "cpu", "--guards",
                                          "abort", "--tamper-at", "8"])
    assert rc == chaos_smoke.EXIT_GUARD and not out["guards"]["clean"]
    _rc, jout = _main(_jax_tool(), SMALL + ["--guards", "warn",
                                            "--tamper-at", "8"])
    assert jout["guards"] == _main(chaos_smoke, SMALL + [
        "--device", "cpu", "--guards", "warn", "--tamper-at", "8"])[1][
            "guards"]

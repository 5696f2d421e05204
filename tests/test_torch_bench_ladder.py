"""The port's benchmark ladder, `shadow_tpu_torch/tools/bench_ladder.py`,
against the JAX tool `tools/bench_ladder.py`.

At full shape nothing runs: each JAX rung's `run_rung` is replaced by a
capture of the config text, its temporary directory is the test's, and
the twin's text builder must give the same bytes (rungs 1, 2, 3, 3f and
interpose; rung 4's is `test_torch_managed.py`'s). At cut shapes each
rung's YAML runs through both CLIs (`cli_parity.both`: exit codes, data
directories and per-host packet traces equal), and through the twin's
own runner, whose JSON line and data directory must agree with the
port's CLI: rung 2 at 8 hosts of 64 KiB (10 s), the interposition rung
at 2 pairs, rung 1 with a 256 KiB file (skipped without `curl`), and
rung 4 at 6 relays and 3 clients, its heartbeat contract checked through
`tools/parse_shadow.py`.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from cli_parity import both  # noqa: E402

from shadow_tpu_torch.tools import bench_ladder as twin  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CC = shutil.which("gcc")
JSON_KEYS = ("rung", "sim_seconds", "wall_seconds", "sim_per_wall",
             "events_per_sec", "events", "packets", "failures")


@pytest.fixture(scope="module")
def jax_ladder():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import bench_ladder
    finally:
        sys.path.remove(str(REPO / "tools"))
    return bench_ladder


class Captured(Exception):
    pass


def jax_text(jax_ladder, monkeypatch, tmp_path, call) -> str:
    """The config text JAX's rung `call` would run, its temporary
    directory `tmp_path`, python3 and curl at fixed paths."""
    got = {}

    def capture(name, cfg_text, data_dir=None):
        got["text"] = cfg_text
        raise Captured

    monkeypatch.setattr(jax_ladder, "run_rung", capture)
    monkeypatch.setattr("tempfile.mkdtemp", lambda prefix="": str(tmp_path))
    monkeypatch.setattr("shutil.which", lambda name: f"/usr/bin/{name}")
    # the interposition rung reads its C sources relative to the repo
    monkeypatch.chdir(REPO)
    with pytest.raises(Captured):
        call(jax_ladder)
    return got["text"]


FULL_SHAPE = {
    "1": (lambda j: j.rung1(),
          lambda tmp: twin.rung1_text(tmp, "/usr/bin/python3",
                                      "/usr/bin/curl")),
    "2": (lambda j: j.rung2(), lambda tmp: twin.rung2_text()),
    "3": (lambda j: j.rung3(), lambda tmp: twin.rung3_text()),
    "3f": (lambda j: j.rung3(use_flow_engine=True),
           lambda tmp: twin.rung3_text(use_flow_engine=True)),
    "interpose": (lambda j: j.rung_interpose(),
                  lambda tmp: twin.interpose_text(tmp)),
}


@pytest.mark.parametrize("rung", sorted(FULL_SHAPE))
def test_full_shape_text_is_jax_ladders(jax_ladder, monkeypatch, tmp_path,
                                        rung):
    if rung == "interpose" and CC is None:
        pytest.skip("no gcc: the JAX rung compiles its pair first")
    call, builder = FULL_SHAPE[rung]
    want = jax_text(jax_ladder, monkeypatch, tmp_path, call)
    assert builder(str(tmp_path)) == want


def test_transport_adds_jax_keys_and_3f_ignores_it():
    text = twin.rung2_text(4, 1024)
    assert twin.with_transport(text, "cpu") == text
    for mode in ("auto", "sync", "mirrored"):
        got = twin.with_transport(text, mode)
        assert got.startswith(text)
        assert yaml.safe_load(got)["experimental"] == {
            "use_tpu_transport": True, "tpu_transport_mode": mode}
    with pytest.raises(ValueError):
        twin.with_transport(text, "nccl")
    with pytest.raises(ValueError):
        twin.with_transport(twin.rung3_text(use_flow_engine=True), "sync")


def fresh(tmp: Path, name: str) -> Path:
    (tmp / name).mkdir()
    return tmp / name


def data_files(data: Path) -> dict:
    return {f.relative_to(data).as_posix(): f.read_bytes()
            for f in sorted(data.rglob("*")) if f.is_file()}


def check_runner(line: dict, data: Path, cli_out: dict, transport: str):
    """The twin runner's JSON line and Manager data directory against
    the port CLI's outputs on the same config."""
    stats = cli_out["sim-stats.json"]
    assert all(k in line for k in JSON_KEYS)
    assert line["packets"] == stats["packets_sent"]
    assert line["failures"] == len(stats["process_failures"]) == 0
    assert line["sim_seconds"] * 1e9 == stats["sim_time_ns"]
    assert line["transport"] == transport and line["device"] == "cpu"
    assert line["backend"]["platform"] == "cpu"
    files = data_files(data)
    assert "etc-hosts" in files
    for rel, body in files.items():
        assert cli_out[rel] == body, rel


@pytest.mark.parametrize("transport", ("cpu", "sync"))
def test_rung2_cut_matches_jax(tmp_path, transport):
    """Rung 2 at 8 hosts of 64 KiB: both CLIs to 10 s, equal; the twin's
    runner (the whole 60 s: every transfer ends by 10 s) gives the CLI's
    packets, on the CPU routing and through the device transport."""
    text = twin.rung2_text(8, 65_536)
    rc, out, trace = both(fresh(tmp_path, "cli"), text, "--stop-time", "10s")
    assert rc == 0 and trace
    assert out["sim-stats.json"]["process_failures"] == []
    rc, full, _ = both(fresh(tmp_path, "full"), twin.with_transport(text,
                                                                transport))
    assert rc == 0
    assert full["sim-stats.json"]["packets_sent"] == \
        out["sim-stats.json"]["packets_sent"]
    line = twin.rung2(8, 65_536, data_dir=str(tmp_path / "run"),
                      device="cpu", transport=transport)
    check_runner(line, tmp_path / "run", full, transport)
    assert line["rung"] == "rung2_tgen_mesh_8"


@pytest.mark.skipif(CC is None, reason="no gcc to build the TCP pair")
def test_interpose_cut_matches_jax(tmp_path):
    """The interposition rung at 2 pairs (4 compiled processes): both
    CLIs equal, the twin's runner the CLI's, `peak_rss_mib` reported."""
    bins = tmp_path / "bin"
    bins.mkdir()
    twin.compile_tcp_pair(bins)
    text = twin.interpose_text(bins, n_pairs=2)
    rc, out, trace = both(fresh(tmp_path, "cli"), text)
    assert rc == 0 and trace
    line = twin.rung_interpose(2, tmp=bins, data_dir=str(tmp_path / "run"),
                               device="cpu", transport="cpu")
    check_runner(line, tmp_path / "run", out, "cpu")
    assert line["rung"] == "rung_interpose_4_procs"
    assert line["peak_rss_mib"] > 0


def test_rung1_cut_matches_jax(tmp_path):
    """Rung 1 with a 256 KiB file: `python3 -m http.server` and two
    `curl` clients through both CLIs, equal, each client's file the
    served one; the twin's runner checks the sizes itself."""
    py, curl = shutil.which("python3"), shutil.which("curl")
    if py is None or curl is None:
        pytest.skip("rung 1 needs python3 and curl: missing here")
    size = 256 * 1024
    served = twin.write_served_file(tmp_path, size)
    rc, out, trace = both(fresh(tmp_path, "cli"),
                          twin.rung1_text(tmp_path, py, curl))
    assert rc == 0 and trace
    for i in range(2):
        assert out[f"hosts/client{i}/root{tmp_path}/out{i}.bin"] == \
            served.read_bytes()
    line = twin.rung1(size, tmp=tmp_path, data_dir=tmp_path / "run",
                      device="cpu", transport="cpu")
    check_runner(line, tmp_path / "run", out, "cpu")


def test_rung1_skips_by_name_without_curl(monkeypatch, capsys):
    monkeypatch.setattr(twin.shutil, "which",
                        lambda name: None if name == "curl" else name)
    assert twin.rung1(device="cpu") == {}
    assert json.loads(capsys.readouterr().out) == {
        "rung": "rung1_real_binaries", "skipped": "python3/curl missing"}


@pytest.mark.skipif(CC is None, reason="no gcc to build the onion programs")
def test_rung4_runner_keeps_the_heartbeat_contract(capsys):
    """Rung 4 at 6 relays, 3 clients, 3 nodes through the twin's runner:
    every process succeeds and parse_shadow.py finds a heartbeat host
    for each of the 9."""
    line = twin.rung4(6, 3, 3, device="cpu", transport="cpu")
    assert line["failures"] == 0 and line["packets"] > 0
    assert line["heartbeat_hosts"] >= 9
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed[-1]["rung"] == "rung4_onion_9_procs"
    assert printed[-1]["heartbeat_hosts"] == line["heartbeat_hosts"]


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["2", "--transport", "cpu"])

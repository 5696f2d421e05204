"""The port's report tools against the JAX package's, byte for byte.

A small port run (`run_scenarios --device cpu` on three corpus entries,
one of them serving, with heartbeats, the flight recorder's hops, the
run ledger, the memo and the SLO report) writes the inputs. On each,
`shadow_tpu_torch.tools.telemetry_report` and `trace_report` must print
what `tools/telemetry_report.py` and `tools/trace_report.py` print (the
table, `--json`, `--ensemble`, `--slo`, `--memo-view`, the refusals) and
write the same Perfetto/Chrome trace and `stats.shadow.json` bytes. Each
tool runs in its own directory with the same relative output paths, so
the printed paths agree too.
"""

from __future__ import annotations

import os
import runpy
from pathlib import Path

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shadow_tpu_torch.tools import telemetry_report as ttel  # noqa: E402
from shadow_tpu_torch.tools import trace_report as ttrace  # noqa: E402
from shadow_tpu_torch.workloads import run_scenarios as trun  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ENTRIES = ("serve_burst_lossy", "incast", "rpc_fanout")
SERVE = "serve-burst-lossy-10"


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("reports")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert trun.main([
            *(str(REPO / "scenarios" / f"{e}.yaml") for e in ENTRIES),
            "--device", "cpu", "--telemetry", "tel", "--sample-every", "4",
            "--trace", "tr", "--memo", "--slo-report", "slo.json",
            "-o", "out.json"]) == 0
        # a ledger of a run without the memo
        assert trun.main([str(REPO / "scenarios" / "rpc_fanout.yaml"),
                          "--device", "cpu", "--trace", "tr-plain"]) == 0
    finally:
        os.chdir(cwd)
    (d / "empty.jsonl").write_text("not a heartbeat\n")
    return d


def run_tool(main, argv, cwd: Path, capsys):
    """(exit code, stdout, stderr) of `main(argv)` run in `cwd`."""
    old = os.getcwd()
    cwd.mkdir(exist_ok=True)
    os.chdir(cwd)
    try:
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
        out = capsys.readouterr()
    finally:
        os.chdir(old)
    return rc, out.out, out.err


def assert_same(jax_tool: str, port_main, argv, run_dir, capsys,
                files=()):
    jax_main = runpy.run_path(str(REPO / "tools" / jax_tool),
                              run_name=jax_tool)["main"]
    argv = [a.replace("@", str(run_dir) + "/") for a in argv]
    ref = run_tool(jax_main, argv, run_dir / "jax-out", capsys)
    got = run_tool(port_main, argv, run_dir / "port-out", capsys)
    assert got == ref
    for name in files:
        a = (run_dir / "jax-out" / name).read_bytes()
        b = (run_dir / "port-out" / name).read_bytes()
        assert a and a == b, name
    return ref


HB = f"@tel/{SERVE}.jsonl"
HOPS = f"@tel/{SERVE}.hops.jsonl"
TELEMETRY_CASES = {
    "table": ([HB], ()),
    "json": ([HB, "--json"], ()),
    "top": ([HB, "--top", "3"], ()),
    "trace-hops-stats": ([HB, "--trace", "trace.json", "--hops", HOPS,
                          "--stats-dir", "st"],
                         ("trace.json", "st/stats.shadow.json")),
    "trace-hops-stats-json": ([HB, "--json", "--trace", "t2.json", "--hops",
                               HOPS, "--trace-max-hosts", "4",
                               "--trace-max-flows", "8", "--stats-dir",
                               "s2"], ("t2.json", "s2/stats.shadow.json")),
    "direct-entry": (["@tel/incast-16to1.jsonl", "--trace", "t3.json"],
                     ("t3.json",)),
    "ensemble": ([*(f"@tel/{n}.jsonl" for n in (
        SERVE, "incast-16to1", "rpc-fanout-8")), "--ensemble"], ()),
    "ensemble-json": ([f"@tel/{SERVE}.jsonl", "@tel/incast-16to1.jsonl",
                       "--ensemble", "--json"], ()),
    "slo": (["--slo", "@slo.json"], ()),
    "refuse-one-world-ensemble": ([HB, "--ensemble"], ()),
    "refuse-streams-without-ensemble": ([HB, "@tel/incast-16to1.jsonl"],
                                        ()),
    "refuse-slo-with-streams": ([HB, "--slo", "@slo.json"], ()),
    "no-heartbeats": (["@empty.jsonl"], ()),
}


@pytest.mark.parametrize("case", sorted(TELEMETRY_CASES))
def test_telemetry_report_is_jax_byte_for_byte(run_dir, capsys, case):
    argv, files = TELEMETRY_CASES[case]
    rc, out, _err = assert_same("telemetry_report.py", ttel.main, argv,
                                run_dir, capsys, files)
    if case.startswith("refuse"):
        assert rc == 2
    elif case == "no-heartbeats":
        assert rc == 1
    else:
        assert rc == 0 and out


LEDGER = f"@tr/{SERVE}.ledger.jsonl"
TRACE_CASES = {
    "table": ([LEDGER], ()),
    "json": ([LEDGER, "--json"], ()),
    "memo-view": ([LEDGER, "--memo-view"], ()),
    "memo-view-without-memo": (["@tr-plain/rpc-fanout-8.ledger.jsonl",
                                "--memo-view"], ()),
    "plain-table": (["@tr-plain/rpc-fanout-8.ledger.jsonl"], ()),
    "chrome": ([LEDGER, "--chrome", "c.json", "--heartbeats", HB, "--hops",
                HOPS], ("c.json",)),
    "chrome-capped": ([LEDGER, "--chrome", "c2.json", "--heartbeats", HB,
                       "--trace-max-hosts", "2", "--trace-max-flows", "3"],
                      ("c2.json",)),
    "chrome-ledger-only": (["@tr/incast-16to1.ledger.jsonl", "--chrome",
                            "c3.json"], ("c3.json",)),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_report_is_jax_byte_for_byte(run_dir, capsys, case):
    argv, files = TRACE_CASES[case]
    rc, out, _err = assert_same("trace_report.py", ttrace.main, argv,
                                run_dir, capsys, files)
    assert rc == (2 if case == "memo-view-without-memo" else 0)
    if rc == 0:
        assert out

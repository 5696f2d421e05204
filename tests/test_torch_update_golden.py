"""`python -m shadow_tpu_torch.workloads.run_scenarios --update-golden
--golden PATH` on the CPU: the file it writes equals
`scenarios/GOLDEN.json` byte for byte (the reference's ten entries, in
the JAX tool's format), and it refuses, with exit 2, to write
`scenarios/GOLDEN.json` itself or to record a faulted or guarded run;
the reference's file is untouched either way.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from shadow_tpu_torch.workloads import run_scenarios  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "scenarios" / "GOLDEN.json"


@pytest.fixture
def one_thread():
    """The corpus's ops are small: one torch thread runs it faster than
    many, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_update_golden_writes_the_references_entries(tmp_path, one_thread):
    before = GOLDEN.read_bytes()
    out = tmp_path / "golden.json"
    assert run_scenarios.main(["--device", "cpu", "--update-golden",
                               "--golden", str(out), "--check"]) == 0
    assert out.read_bytes() == before
    assert len(json.loads(out.read_text())) == 10
    assert GOLDEN.read_bytes() == before


@pytest.mark.parametrize("argv", (
    [],
    ["--golden", str(GOLDEN)],
    ["--golden", str(REPO / "scenarios" / ".." / "scenarios" /
                     "GOLDEN.json")],
), ids=("default", "named", "through-dotdot"))
def test_update_golden_refuses_the_references_file(capsys, argv):
    before = GOLDEN.read_bytes()
    rc = run_scenarios.main(["--device", "cpu", "--update-golden", *argv,
                             str(REPO / "scenarios" / "incast.yaml")])
    assert rc == 2
    assert str(GOLDEN) in capsys.readouterr().err
    assert GOLDEN.read_bytes() == before


@pytest.mark.parametrize("flag", ("--faults", "--guards"))
def test_update_golden_refuses_faulted_runs(tmp_path, capsys, flag):
    out = tmp_path / "golden.json"
    rc = run_scenarios.main(["--device", "cpu", "--update-golden",
                             "--golden", str(out), flag,
                             str(REPO / "scenarios" / "incast.yaml")])
    assert rc == 2 and not out.exists()
    assert "--faults/--guards" in capsys.readouterr().err

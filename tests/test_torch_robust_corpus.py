"""The faulted corpus: the rest of the ten entries (the three of
`test_torch_workloads.py` aside) under the runner's default fault
schedule, with the guard plane and the flight recorder at the sampling
`chip_smoke.py` phase 14 uses, each record equal to the JAX runner's
field for field and its hops the same JSONL. Pins what phase 14 checks
on the card against its CPU twin: every entry guards-clean, and fault
drops exactly in `chip_smoke.FAULT_DROP_ENTRIES`."""

from __future__ import annotations

import io
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu.workloads import spec as jspec  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CORPUS = REPO / "scenarios"
# incast, incast_lossy and serve_burst_lossy run in test_torch_workloads.py
ENTRIES = [e for e in sorted(p.stem for p in CORPUS.glob("*.yaml"))
           if e not in ("incast", "incast_lossy", "serve_burst_lossy")]


@pytest.mark.parametrize("entry", ENTRIES)
def test_faulted_corpus_entry_matches_jax(entry):
    path = str(CORPUS / f"{entry}.yaml")
    jsink, tsink = io.StringIO(), io.StringIO()
    got = trunner.run_scenario(tspec.load_scenario_file(path), device="cpu",
                               hops_sink=tsink, **chip_smoke.ROBUST)
    ref = jrunner.run_scenario(jspec.load_scenario_file(path),
                               hops_sink=jsink, **chip_smoke.ROBUST)
    assert got == ref
    assert tsink.getvalue() == jsink.getvalue()
    assert got["guards"]["clean"]
    assert (got["drops"]["fault"] > 0) == (
        got["name"] in chip_smoke.FAULT_DROP_ENTRIES)

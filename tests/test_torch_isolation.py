"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, imports without nvcc or triton, refuses to fall back to the CPU
when no card is present unless asked, and carries state through numpy
without change."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from shadow_tpu_torch import bench, convert, resolve_device  # noqa: E402
from shadow_tpu_torch.faults import plane as fplane  # noqa: E402
from shadow_tpu_torch.guards import plane as gplane  # noqa: E402
from shadow_tpu_torch.telemetry import flightrec, histo, metrics  # noqa: E402
from shadow_tpu_torch.tpu import (compute, elastic, flows, plane,  # noqa: E402
                                  profiling)
from shadow_tpu_torch.tools import profile_plane  # noqa: E402
from shadow_tpu_torch.workloads import runner, spec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "shadow_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def test_port_imports_no_jax_and_nothing_of_shadow_tpu():
    assert len(PORT_FILES) > 10
    scanned = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for sub in ("faults", "guards", "core"):
        assert any(f.startswith(f"shadow_tpu_torch/{sub}/") for f in scanned)
    # nor the repository's scripts under tools/ (the port has its twins)
    scripts = {p.stem for p in (REPO / "tools").glob("*.py")} | {"tools"}
    for path in PORT_FILES:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "shadow_tpu"), (path, mod)
            assert top not in scripts, (path, mod)


# functions and classes of the scanned files that run on the host after
# a run or between chains, by design (reports and percentiles read the
# final tensors; the flight recorder's drain reads its snapshots)
HOST_SIDE = {"completion_windows", "percentile", "percentiles",
             "fleet_percentiles", "ensemble_percentiles", "bucket_edges",
             "flow_totals",
             "summarize", "decode_bits", "flightrec_meta", "ring_capacity",
             "read_hops", "hop_flows", "unwrap_u32", "FlightRecorder"}


# loops that read the host between windows by design, their window
# body and the reads each makes outside it: `plane.chain_windows` reads
# one small tensor with one `.tolist()` after each chained window (the
# JAX chain's while_loop condition), and nothing else; its arguments are
# Python ints, so its outer body calls no int() or float() either
BETWEEN_WINDOWS = {"chain_windows": ("step", {"tolist": 1})}
HOST_READS = {"item", "cpu", "tolist", "numpy", "nonzero", "synchronize",
              "bool"}
LOOP_READS = HOST_READS | {"int", "float"}


def _nested(tree, name: str):
    found = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
             and n.name == name]
    assert len(found) == 1, f"the window body {name} moved"
    return found


def _window_code(path: Path):
    """The parts of a module that a window runs: the whole module but its
    host-side report functions; of the scenario runner, only the chain
    body (`chain_fn`), since the runner reads the device once, after the
    drive, as the JAX runner does."""
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    if path.name == "runner.py":
        return _nested(tree, "chain_fn")
    return [n for n in tree.body
            if not (isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and n.name in HOST_SIDE)]


def _host_reads(node, names=HOST_READS) -> list[tuple[int, str]]:
    reads = []
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else "")
            if name in names:
                reads.append((n.lineno, name))
    return reads


def test_device_path_reads_nothing_back_to_the_host():
    """The host-sync fence (docs/performance.md, SL603) for the step and
    everything it calls, the presence planes (faults, guards and the
    flight recorder's device half too) and the workload generator
    included, and the scenario runner's window loop: no tensor is read
    back inside a window. A loop in BETWEEN_WINDOWS makes exactly its
    listed reads, all outside its window body."""
    port = REPO / "shadow_tpu_torch"
    step_files = [port / "tpu" / f for f in (
        "plane.py", "pipeline.py", "prims.py", "codel.py", "tcp.py",
        "flows.py", "compute.py")]
    step_files += [port / "telemetry" / f for f in ("metrics.py", "histo.py",
                                                    "flightrec.py")]
    step_files += [port / "faults" / "plane.py", port / "guards" / "plane.py"]
    step_files += [port / "workloads" / f for f in (
        "phold.py", "device.py", "runner.py")]
    loops = 0
    for path in step_files:
        for part in _window_code(path):
            reads = _host_reads(part)
            name = getattr(part, "name", None)
            if not isinstance(part, ast.FunctionDef) or \
                    name not in BETWEEN_WINDOWS:
                assert not reads, (path.name, reads)
                continue
            loops += 1
            reads = _host_reads(part, LOOP_READS)
            body, allowed = BETWEEN_WINDOWS[name]
            assert not _host_reads(_nested(part, body)[0]), (path.name, name)
            got = {}
            for _line, read in reads:
                got[read] = got.get(read, 0) + 1
            assert got == allowed, (path.name, name, reads)
    assert loops == len(BETWEEN_WINDOWS)


# the ensemble's chain code, which `torch.func.vmap` runs for W worlds at
# once: the driver's loop (`elastic.drive_ensemble`, one host sync a chain
# is the caller's `on_chain`) and the bench's keyed PHOLD chain with its
# round body; a batched tensor cannot be read back, and an int() there
# would also read the host once a window
ENSEMBLE_CHAIN_CODE = {"tpu/elastic.py": ("drive_ensemble",),
                       "bench.py": ("phold_keyed_chain_fn", "_phold_round")}


def test_ensemble_chain_reads_nothing_back_to_the_host():
    port = REPO / "shadow_tpu_torch"
    for rel, names in ENSEMBLE_CHAIN_CODE.items():
        tree = ast.parse((port / rel).read_text(encoding="utf-8"), rel)
        for name in names:
            (fn,) = _nested(tree, name)
            assert not _host_reads(fn, LOOP_READS), (rel, name)
    # the fence sees what it is meant to catch
    probe = ast.parse("def chain_fn(s):\n    return int(s.sum()) + s.item()")
    assert [r for _l, r in _host_reads(probe, LOOP_READS)] == ["int", "item"]


def test_copied_workload_modules_stand_alone():
    """The port's copies of the JAX package's JAX-free workload modules
    (spec, compile, serve) import nothing of it, and the op-timing table
    they read is the port's own file, byte-equal to the JAX package's."""
    wl = REPO / "shadow_tpu_torch" / "workloads"
    for name in ("spec.py", "compile.py", "serve.py"):
        for mod in imported_modules(wl / name):
            assert mod.split(".")[0] not in ("jax", "shadow_tpu"), (name, mod)
        text = (wl / name).read_text(encoding="utf-8")
        assert "from shadow_tpu." not in text and "import shadow_tpu" \
            not in text.replace("import shadow_tpu_torch", ""), name
    from shadow_tpu_torch.workloads import serve
    assert Path(serve.OP_TIMINGS_PATH).resolve().parent == wl
    assert (wl / "op_timings.json").read_bytes() == (
        REPO / "shadow_tpu" / "workloads" / "op_timings.json").read_bytes()


def test_package_imports_without_nvcc_or_triton():
    """A fresh interpreter with no CUDA toolkit on its path imports every
    module of the port; nothing builds and triton is never loaded."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES if p.parent != REPO)
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, shutil, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert shutil.which('nvcc') is None\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "from shadow_tpu_torch import _build\n"
        "assert not _build._loaded\n")
    env = {"PATH": os.path.dirname(sys.executable), "PYTHONPATH": str(REPO),
           "HOME": os.environ.get("HOME", "/tmp")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda_and_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    lat = np.full((2, 2), 1000, np.int32)
    calls = [
        lambda: resolve_device(None),
        lambda: plane.make_params(lat, np.zeros((2, 2), np.float32),
                                  np.full(2, 10**9)),
        lambda: plane.make_state(2, 4, 4),
        lambda: profiling.build_world(4, n_nodes=2, egress_cap=4,
                                      ingress_cap=4),
        lambda: bench.run_phold(4, n_nodes=2, egress_cap=4, ingress_cap=4,
                                rounds=1),
        lambda: bench.run_worlds(2, 4, n_nodes=2, egress_cap=4,
                                 ingress_cap=4, rounds=1),
        lambda: elastic.world_keys(1, [0, 1]),
        lambda: metrics.make_metrics(4),
        lambda: histo.make_histograms(4),
        lambda: fplane.neutral_faults(4),
        lambda: gplane.make_guards(4),
        lambda: flightrec.make_flightrec(0),
        lambda: runner.default_fault_schedule(spec.load_scenario_file(
            str(REPO / "scenarios" / "incast.yaml"))).device_arrays(),
        lambda: flows.make_flow_tables([0], [1], [64]),
        lambda: flows.make_flow_state(4),
        lambda: compute.make_compute_tables(np.zeros((4, 2)), 8),
        lambda: runner.run_scenario(spec.load_scenario_file(
            str(REPO / "scenarios" / "incast.yaml"))),
        lambda: profiling.profile_sections(4, reps=1, n_nodes=2,
                                           egress_cap=4, ingress_cap=4),
        lambda: profile_plane.main(["--hosts", "4", "--reps", "1",
                                    "--nodes", "2", "--egress-cap", "4",
                                    "--ingress-cap", "4"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_convert_round_trip_is_identity():
    rng = np.random.default_rng(0)
    st = plane.make_state(6, 4, 8, device="cpu")
    d = {}
    for f, v in convert.state_to_numpy(st).items():
        if f == "router":
            continue
        d[f] = (rng.random(v.shape) < 0.5 if v.dtype == bool
                else rng.integers(-2**31, 2**31 - 1, v.shape).astype(v.dtype))
    d["router"] = {
        f: (rng.random(v.shape) < 0.5 if v.dtype == bool
            else rng.integers(-9, 9, v.shape).astype(v.dtype))
        for f, v in convert.state_to_numpy(st)["router"].items()}
    back = convert.state_to_numpy(convert.state_from_numpy(d, "cpu"))
    assert back.keys() == d.keys()
    for f in d:
        pairs = (d[f].items() if f == "router" else [(f, d[f])])
        for g, a in pairs:
            b = back[f][g] if f == "router" else back[f]
            assert a.dtype == b.dtype and np.array_equal(a, b), (f, g)
    assert convert.state_digest(d) == convert.state_digest(
        convert.state_from_numpy(d, "cpu"))

    params = plane.make_params(np.full((3, 3), 5, np.int32),
                               np.full((3, 3), 0.25, np.float32),
                               np.full(3, 8_000_000), device="cpu")
    pd = {f: getattr(params, f).numpy() for f in params._fields}
    again = convert.params_from_numpy(pd, "cpu")
    for f in params._fields:
        assert torch.equal(getattr(again, f), getattr(params, f)), f

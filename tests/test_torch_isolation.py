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
                                  profiling, transport)
from shadow_tpu_torch.tools import profile_plane, transport_replay  # noqa: E402
from shadow_tpu_torch.workloads import runner, spec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TRANSPORT_LOG = (REPO / "shadow_tpu_torch" / "workloads"
                 / "phold_transport.log.npz")
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


# SL603 of the JAX package's cost model, over the port's driver modules:
# the files that own a loop driving windows, chains or runs, and the
# tracer and its report, which must not smuggle a per-span read in
DRIVER_MODULES = (
    "shadow_tpu_torch/bench.py",
    "shadow_tpu_torch/tools/chaos_smoke.py",
    "shadow_tpu_torch/tools/trace_report.py",
    "shadow_tpu_torch/workloads/runner.py",
    "shadow_tpu_torch/tpu/elastic.py",
    "shadow_tpu_torch/telemetry/tracer.py",
)
#: (path, enclosing function) -> why that function may read in a loop
HOST_SYNC_ALLOWED = {
    ("shadow_tpu_torch/tpu/elastic.py", "run_elastic_window"): (
        "the elastic capacity policy's decision point: one per-ring "
        "overflow readback per CHAIN attempt is the driver contract "
        "(docs/robustness.md 'Elastic capacity') — chain_len amortizes "
        "the sync, and the growth decision cannot be made without "
        "materializing the overflow counters"),
}
# a tensor method that reads it back, a call that waits for the card, and
# the calls that read a tensor they are given
SYNC_METHODS = HOST_READS - {"synchronize", "bool"}
SYNC_CALLS = {"torch.cuda.synchronize"}
MATERIALIZERS = {"bool", "int", "float", "numpy.asarray", "numpy.array"}
# calls whose result is on the host: the carry's one-synchronise pull
# (the port's `jax.device_get`) and the host-side report functions
HOST_RESULTS = {"carry_to_host"} | HOST_SIDE
# parameter annotations that name host values: scalars, numpy arrays,
# and the workload spec and its compiled program (modules without torch)
HOST_TYPES = {"int", "float", "bool", "str", "np.ndarray", "ScenarioSpec",
              "TrafficProgram"}


def _dotted(imports: dict, node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(imports.get(node.id, node.id))
    return ".".join(reversed(parts))


class SyncFence(ast.NodeVisitor):
    """JAX's `_SyncFence` for PyTorch: every read of `LOOP_READS` in a
    `for` or `while` body (a while's test included) or a comprehension,
    per enclosing function, unless its operand is provably on the host:
    every name it touches holds a host value (a read's or a host call's
    result, a loop target over a host iterable or a `range`, a parameter
    annotated with a `HOST_TYPES` type), or it is a literal."""

    def __init__(self):
        self.imports: dict[str, str] = {}
        self.hosts: list[set] = [set()]
        self.depth = 0
        self.fns: list[str] = []
        self.found: list[tuple[int, str, str]] = []

    def visit_Import(self, node):
        for a in node.names:
            self.imports[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])

    def visit_ImportFrom(self, node):
        for a in node.names:
            self.imports[a.asname or a.name] = \
                f"{node.module or ''}.{a.name}".lstrip(".")

    def _is_host(self, node) -> bool:
        if self._pulls(node):
            return True
        called = {id(n.func) for n in ast.walk(node)
                  if isinstance(n, ast.Call)}
        names = [n.id for n in ast.walk(node)
                 if isinstance(n, ast.Name) and id(n) not in called]
        return all(any(n in s for s in self.hosts) for n in names)

    def _pulls(self, node) -> bool:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            leaf = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if leaf in HOST_RESULTS or (
                    isinstance(f, ast.Attribute) and leaf in SYNC_METHODS):
                return True
            if _dotted(self.imports, f) in MATERIALIZERS - {"bool", "int",
                                                            "float"}:
                return True
        return False

    def _mark(self, target, host: bool):
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                if host:
                    self.hosts[-1].add(n.id)
                else:
                    for s in self.hosts:
                        s.discard(n.id)

    def _fn(self, node):
        self.fns.append(node.name)
        self.hosts.append(set())
        a = node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if arg.annotation is not None and \
                    ast.unparse(arg.annotation) in HOST_TYPES:
                self.hosts[-1].add(arg.arg)
        # a def inside a loop runs later, not once an iteration
        outer, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = outer
        self.hosts.pop()
        self.fns.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _fn

    def visit_Assign(self, node):
        host = self._is_host(node.value)
        for t in node.targets:
            self._mark(t, host)
        self.generic_visit(node)

    def _target(self, target, it):
        ranged = (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                  and it.func.id == "range")
        if ranged or self._is_host(it):
            self._mark(target, True)

    def _loop(self, node):
        if isinstance(node, ast.While):
            self.depth += 1
            self.visit(node.test)
        else:  # the iterable runs once
            self.visit(node.iter)
            self._target(node.target, node.iter)
            self.depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.depth -= 1

    visit_For = visit_AsyncFor = visit_While = _loop

    def _comp(self, node):
        gens = node.generators
        self.visit(gens[0].iter)
        self._target(gens[0].target, gens[0].iter)
        self.depth += 1
        for i, gen in enumerate(gens):
            if i:
                self.visit(gen.iter)
                self._target(gen.target, gen.iter)
            for cond in gen.ifs:
                self.visit(cond)
        for part in ((node.key, node.value) if isinstance(node, ast.DictComp)
                     else (node.elt,)):
            self.visit(part)
        self.depth -= 1

    visit_ListComp = visit_SetComp = visit_DictComp = _comp
    visit_GeneratorExp = _comp

    def visit_Call(self, node):
        f = node.func
        path = _dotted(self.imports, f)
        what = None
        if path in SYNC_CALLS:
            what = path
        elif isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS \
                and not (isinstance(f.value, ast.Name)
                         and f.value.id in self.imports) \
                and not self._is_host(f.value):
            what = f".{f.attr}()"
        elif path in MATERIALIZERS and node.args \
                and not self._is_host(node.args[0]):
            what = f"{path}(...)"
        if what and self.depth:
            self.found.append((node.lineno, self.fns[-1] if self.fns
                               else "<module>", what))
        self.generic_visit(node)


def host_syncs(source: str) -> list[tuple[int, str, str]]:
    """(line, enclosing function, read) of each read the fence flags."""
    fence = SyncFence()
    fence.visit(ast.parse(source))
    return fence.found


@pytest.mark.parametrize("rel", DRIVER_MODULES)
def test_driver_modules_read_nothing_back_inside_a_loop(rel):
    """SL603 (`analysis/costmodel.py`, `check_host_sync`) over the port's
    driver modules: no loop or comprehension reads a tensor back, but in
    a function of HOST_SYNC_ALLOWED. A listed module that is missing
    fails, as JAX's fence reports it."""
    path = REPO / rel
    assert path.is_file(), f"driver module missing: {rel}"
    bad = [(line, fn, what) for line, fn, what in
           host_syncs(path.read_text(encoding="utf-8"))
           if (rel, fn) not in HOST_SYNC_ALLOWED]
    assert not bad, (rel, bad)


def test_host_sync_registry_holds_only_reads_that_happen():
    """Every allowed function exists and reads in a loop (its entry is
    not stale), and the workload types the fence takes as host values
    come from modules that do not import torch."""
    for (rel, fn), why in HOST_SYNC_ALLOWED.items():
        assert rel in DRIVER_MODULES and why
        found = host_syncs((REPO / rel).read_text(encoding="utf-8"))
        assert any(f == fn for _l, f, _w in found), (rel, fn)
    for mod in ("spec.py", "compile.py"):
        path = REPO / "shadow_tpu_torch" / "workloads" / mod
        assert "torch" not in {m.split(".")[0] for m in
                               imported_modules(path)}, mod


def test_host_sync_fence_probe():
    """The fence catches each read kind in a loop, in a while's test and
    in a comprehension, and passes host operands and reads outside
    loops."""
    probe = (
        "import numpy as np\n"
        "import torch\n"
        "def drive(w, n: int, a: np.ndarray):\n"
        "    w.item()\n"
        "    for i in range(n):\n"
        "        w.item(); w.cpu(); w.tolist(); w.numpy(); w.nonzero()\n"
        "        torch.cuda.synchronize()\n"
        "        bool(w); int(w); float(w)\n"
        "        np.asarray(w); np.array(w)\n"
        "        int(i); int(n); float(a.sum()); int(3); np.asarray(a)\n"
        "        h = w.cpu()\n"
        "        int(h.sum()); h.tolist()\n"
        "    while bool(w.any()):\n"
        "        pass\n"
        "    xs = [w[j].item() for j in range(n)]\n"
        "    ys = {k: int(v) for k, v in w.items()}\n"
        "    return sum(int(r) for r in a)\n")
    got = [(line, what) for line, fn, what in host_syncs(probe)]
    assert {fn for _l, fn, _w in host_syncs(probe)} == {"drive"}
    assert got == [
        (6, ".item()"), (6, ".cpu()"), (6, ".tolist()"), (6, ".numpy()"),
        (6, ".nonzero()"), (7, "torch.cuda.synchronize"), (8, "bool(...)"),
        (8, "int(...)"), (8, "float(...)"), (9, "numpy.asarray(...)"),
        (9, "numpy.array(...)"), (11, ".cpu()"), (13, "bool(...)"),
        (15, ".item()"), (16, "int(...)")]


@pytest.mark.parametrize("read, pulled", [
    # bench.profile_windows' placed slots: one read a window's take
    ("sum(int(t.sum()) for t in takes)", "int(sum(t.sum() for t in takes))"),
    # chaos_smoke's metrics: one read a field (JAX pulls the tree once)
    ("{f: getattr(m, f).cpu().numpy() for f in m._fields}",
     "carry_to_host(m)._asdict()"),
    # and its histograms' percentiles
    ("{k: p(t.cpu().numpy().sum(0)) for k, t in h._asdict().items()}",
     "{k: p(np.asarray(a).sum(0)) for k, a in "
     "carry_to_host(h)._asdict().items()}"),
])
def test_repaired_driver_reads_stay_out_of_loops(read, pulled):
    """The reads the fence found in the port's driver modules, which the
    JAX tools make once outside a loop: the old spelling is flagged, the
    repaired one (one pull, then host values) is not."""
    wrap = "import numpy as np\ndef f(takes, m, h, p):\n    return {}\n"
    assert host_syncs(wrap.format(read))
    assert not host_syncs(wrap.format(pulled))


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
        lambda: transport.DeviceTransport(
            [transport_replay._Host(1, 0, [])],
            transport_replay._Routing(lat[:1, :1]), None, mode="sync"),
        lambda: transport.make_transport_guard(),
        lambda: transport.make_transport_hist(4),
        lambda: transport_replay.main([str(TRANSPORT_LOG), "--mode",
                                       "mirrored", "--rounds", "4"]),
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


def test_mesh_modules_import_no_jax_and_nothing_of_shadow_tpu():
    """The mesh and its dry run stand alone too (they are in PORT_FILES;
    named here so that a move cannot drop them from the scan)."""
    for rel in ("tpu/mesh.py", "tools/multichip.py"):
        path = REPO / "shadow_tpu_torch" / rel
        assert path in PORT_FILES
        for mod in imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "shadow_tpu"), (
                rel, mod)


def test_transport_modules_import_no_jax_and_nothing_of_shadow_tpu():
    """The device transport, its satellites and the replay tool stand
    alone too (named here so that a move cannot drop them from the
    scan)."""
    for rel in ("tpu/transport.py", "guards/reconcile.py",
                "faults/healing.py", "faults/schedule.py",
                "faults/checkpoint.py", "tpu/elastic.py",
                "tools/transport_replay.py"):
        path = REPO / "shadow_tpu_torch" / rel
        assert path in PORT_FILES
        for mod in imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "shadow_tpu"), (
                rel, mod)


# the transport's device functions: none reads the host but `chain`, which
# reads one small tensor once a chained window (the JAX while_loop's
# condition); `batch_verify`, the mirrored replay, reads nothing
TRANSPORT_FUNCTIONS = {"guard_update": {}, "hist_step": {}, "ingest": {},
                       "step": {}, "fingerprint": {}, "_compact": {},
                       "step_compact": {}, "batch_verify": {},
                       "ingest_guarded": {}, "_add_at": {}, "_put": {},
                       "_mul32": {}, "_sum32": {}, "_stable_argsort": {},
                       "chain": {"tolist": 1}}


def test_transport_device_functions_read_nothing_back_to_the_host():
    path = REPO / "shadow_tpu_torch" / "tpu" / "transport.py"
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for name, allowed in TRANSPORT_FUNCTIONS.items():
        (fn,) = _nested(tree, name)
        got = {}
        for _line, read in _host_reads(fn, LOOP_READS):
            got[read] = got.get(read, 0) + 1
        assert got == allowed, (name, got)


# the tensor methods that read a tensor back to the host
HOST_READ_METHODS = ("tolist", "item", "cpu", "numpy", "__bool__", "__int__",
                     "__float__", "__index__")


def test_sharded_chain_reads_the_host_once_a_chained_window(monkeypatch):
    """`chain_windows(mesh=)` on rank 0 of a 2-rank gloo mesh makes one
    host read a chained window, its `.tolist()`, and no other (the
    collectives that decide the chain are not host reads of its own):
    the multichip stress at 256 hosts, 16 windows, all walked."""
    from shadow_tpu_torch.tools import multichip
    from shadow_tpu_torch.tpu import mesh

    reads, active = {}, [False]
    for name in HOST_READ_METHODS:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            if active[0]:
                reads[_name] = reads.get(_name, 0) + 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    chain = multichip.chain_windows

    def counted_chain(*a, **k):
        active[0] = True
        try:
            return chain(*a, **k)
        finally:
            active[0] = False

    monkeypatch.setattr(multichip, "chain_windows", counted_chain)
    got = mesh.run_ranks(multichip.check_stress, 2, 256, 16, "pallas_fused",
                         False, device="cpu")
    assert got["chain"][2] == 16
    assert reads == {"tolist": 15}


def _count_host_reads(monkeypatch):
    reads, active = {}, [False]
    for name in HOST_READ_METHODS:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            if active[0]:
                reads[_name] = reads.get(_name, 0) + 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads, active


def test_mirrored_replay_reads_nothing_back_and_chain_once_a_window(
        monkeypatch):
    """At run time: `batch_verify` over 32 windows (each a step, the
    fingerprint against the ledger's and an ingest) makes no host read;
    a 64-window `chain` makes 63, one `.tolist()` after each window it
    could follow."""
    n, ci, k, b = 8, 16, 32, 8
    lat = torch.full((2, 2), 1000, dtype=torch.int32)
    node = torch.arange(n) % 2
    st = transport.make_transport_state(n, ci, "cpu")
    st = st._replace(in_valid=torch.arange(n * ci).reshape(n, ci) % 3 == 0,
                     in_deliver=torch.arange(n * ci, dtype=torch.int32
                                             ).reshape(n, ci) * 1000)
    zeros = torch.zeros((k, b), dtype=torch.int32)
    ing = {c: zeros for c in ("src", "dst", "seq", "tag", "send", "clamp")}
    ing["valid"] = torch.ones((k, b), dtype=torch.bool)
    ing["dst"] = torch.arange(k * b, dtype=torch.int32).reshape(k, b) % n
    g = transport.make_transport_guard("cpu")
    h = transport.make_transport_hist(n, "cpu")
    exp = torch.zeros(k, dtype=torch.int64)
    reads, active = _count_host_reads(monkeypatch)
    active[0] = True
    out = transport.batch_verify(st, g, h, [1000] * k, [500] * k, ing, exp,
                                 exp, exp.to(torch.int32),
                                 torch.zeros((), dtype=torch.int32),
                                 latency=lat, host_node=node)
    active[0] = False
    assert reads == {}
    assert int(out[1].windows) == k and int(out[3]) > 0
    active[0] = True
    out = transport.chain(st, g, None, 0, 0, 0, 10**6, 10**6, cap=64)
    active[0] = False
    assert reads == {"tolist": 63}
    assert int(out[1].windows) == 64

"""The port's section profiler and bench record against the JAX package,
bitwise.

The JAX side is JAX's own `profile_sections` at N=64, run eagerly
(`jax.jit` made the identity for the call, so its 24 sections are not
compiled one by one), with its `_time_call` replaced by a capture of
each section's output: the reference is the JAX profiler's code, not a
copy of it. On "pallas_fused" JAX's Pallas pipeline runs in interpret
mode; the sections that do not read the kernel are JAX's "xla" ones
there. JAX's `pallas_route` needs `pl.load`, absent from this JAX, so
the port's `pallas` sections are held against JAX's XLA path, which the
JAX package makes bitwise equal to it (tests/test_plane_sortdiet.py).
Every comparison is exact: the leaves in JAX's pytree order, integers
by value (the port's `o_pos` is int64 where JAX's is int32, and the
flight recorder's uint32 leaves are int64), everything else by dtype
and bytes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from shadow_tpu.tpu import profiling as jprof  # noqa: E402
from shadow_tpu_torch import bench  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402
from shadow_tpu_torch.tpu import profiling as tprof  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N, CE, CI = 64, 16, 32
KERNELS = ("xla", "pallas_fused", "pallas")
# the sections whose JAX code reads the profiled kernel
KERNEL_SECTIONS = ("fused_stage", "window_step", "window_chain8",
                   "window_step_telemetry", "window_step_elastic",
                   "window_step_workload")


def leaves(tree) -> list:
    """A port section's output as JAX's `tree_leaves` orders it: tuples
    (NamedTuples too) in order, dicts by sorted key, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def as_numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_leaves_equal(ref: list, got: list, ctx):
    assert len(ref) == len(got), (ctx, len(ref), len(got))
    for i, (r, g) in enumerate(zip(ref, got)):
        r, g = as_numpy(r), as_numpy(g)
        assert r.shape == g.shape, (ctx, i, r.shape, g.shape)
        if r.dtype.kind in "iu" and g.dtype.kind in "iu":
            assert np.array_equal(r.astype(np.int64), g.astype(np.int64)), \
                (ctx, i)
        else:
            assert r.dtype == g.dtype, (ctx, i, r.dtype, g.dtype)
            assert r.tobytes() == g.tobytes(), (ctx, i)


def run_jax_sections(runs):
    """{name: ({section: leaves}, record)} of JAX's profiler for each
    (name, kernel, sections, packed_sort) in `runs`."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda f, **kw: f)
        for name, kernel, wanted, packed_sort in runs:
            got = []

            def capture(fn, args, reps):
                got.append(jax.tree_util.tree_leaves(fn(*args)))
                return {}
            mp.setattr(jprof, "_time_call", capture)
            rec = jprof.profile_sections(N, reps=1, kernel=kernel,
                                         sections=wanted, egress_cap=CE,
                                         ingress_cap=CI,
                                         packed_sort=packed_sort)
            out[name] = dict(zip(wanted, got)), rec
    return out


@pytest.fixture(scope="module")
def jax_sections():
    """{kernel: ({section: leaves}, record)} from JAX's profiler."""
    return run_jax_sections(
        (("xla", "xla", jprof.DEFAULT_SECTIONS, True),
         ("pallas_fused", "pallas_fused", KERNEL_SECTIONS, True)))


@pytest.fixture(scope="module")
def jax_legacy_sections():
    """({section: leaves}, record) of JAX's profiler on "xla" with
    packed_sort=False."""
    return run_jax_sections(
        (("legacy", "xla", jprof.DEFAULT_SECTIONS, False),))["legacy"]


@pytest.fixture(scope="module")
def world():
    return tprof.build_world(N, egress_cap=CE, ingress_cap=CI, device="cpu")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("section", jprof.DEFAULT_SECTIONS)
def test_section_matches_jax(jax_sections, world, section, kernel):
    ref_kernel = ("pallas_fused" if kernel == "pallas_fused"
                  and section in KERNEL_SECTIONS else "xla")
    ref = jax_sections[ref_kernel][0][section]
    assert ref, section
    fn, args = tprof.section_calls(world, kernel=kernel,
                                   wanted=(section,))[section]
    state_before = [t.clone() for t in leaves(world["state"])]
    got = leaves(fn(*tprof.fresh_args(section, args)))
    assert_leaves_equal(ref, got, (section, kernel))
    # a section reads the world and writes none of it
    assert_leaves_equal(state_before, leaves(world["state"]),
                        ("world", section))


def test_in_place_sections_are_fed_fresh_rings():
    """`routing_scatter` and `routing_place` write the compacted ingress
    in place: their declared arguments are those rings, a call places
    arrivals into them, and calls on `fresh_args` leave the section's
    own arguments as they were and give the same outputs. (The profiled
    world has drained its egress after its warm-up windows, so this one
    has none: its seed packets are routed.)"""
    seeded = tprof.build_world(N, egress_cap=CE, ingress_cap=CI,
                               warmup_windows=0, device="cpu")
    calls = tprof.section_calls(seeded, wanted=tuple(tprof.MUTATED_ARGS))
    for name, (fn, args) in calls.items():
        ring_positions = [i for i, a in enumerate(args)
                          if a.shape == (N, CI)]
        assert list(tprof.MUTATED_ARGS[name]) == ring_positions, name
        snapshot = [a.clone() for a in args]
        first = fn(*tprof.fresh_args(name, args))
        # the valid ring (the last one) gained arrivals
        assert not torch.equal(first[5], args[ring_positions[-1]]), name
        second = fn(*tprof.fresh_args(name, args))
        assert_leaves_equal(leaves(first), leaves(second), name)
        assert_leaves_equal(snapshot, list(args), name)


def test_record_keys_and_section_tuples_are_jax(jax_sections):
    assert tprof.DEFAULT_SECTIONS == jprof.DEFAULT_SECTIONS
    assert tprof.BENCH_SECTIONS == jprof.BENCH_SECTIONS
    rec = tprof.profile_sections(N, reps=1, egress_cap=CE, ingress_cap=CI,
                                 device="cpu")
    jrec = jax_sections["xla"][1]
    assert list(rec) == list(jrec)
    assert list(rec["sections"]) == list(jprof.DEFAULT_SECTIONS)
    jtimed = jprof._time_call(jax.jit(lambda x: x + 1), (jnp.int32(0),), 1)
    for entry in rec["sections"].values():
        assert list(entry) == list(jtimed)
        assert entry["reps"] == 1 and 0 < entry["min_ms"] <= \
            entry["median_ms"]
    for key in ("hosts", "egress_cap", "ingress_cap", "nodes", "backend",
                "rr_enabled", "packed_sort", "kernel"):
        assert rec[key] == jrec[key], key


def test_legacy_sort_is_refused():
    """The Pallas kernels refuse packed_sort=False, as JAX's do."""
    for kernel in ("pallas_fused", "pallas"):
        with pytest.raises(ValueError, match="packed_sort=False"):
            tprof.profile_sections(N, reps=1, packed_sort=False,
                                   kernel=kernel, device="cpu")


@pytest.mark.parametrize("section", jprof.DEFAULT_SECTIONS)
def test_legacy_sort_section_matches_jax(jax_legacy_sections, world,
                                         section):
    """Each section with packed_sort=False (JAX's pre-diet variadic
    sorts; routing_rank and routing_place the legacy rank and scatters)
    equals JAX's profiler's with the same flag, and reads the world
    without writing it; the record says packed_sort false."""
    ref = jax_legacy_sections[0][section]
    assert ref, section
    fn, args = tprof.section_calls(world, wanted=(section,),
                                   packed_sort=False)[section]
    state_before = [t.clone() for t in leaves(world["state"])]
    got = leaves(fn(*tprof.fresh_args(section, args)))
    assert_leaves_equal(ref, got, (section, "legacy"))
    assert_leaves_equal(state_before, leaves(world["state"]),
                        ("world", section))
    if section == "routing_place":
        rec = tprof.profile_sections(N, reps=1, egress_cap=CE,
                                     ingress_cap=CI, packed_sort=False,
                                     sections=(section,), device="cpu")
        assert rec["packed_sort"] is jax_legacy_sections[1]["packed_sort"]


def test_unknown_sections_are_refused(world):
    with pytest.raises(ValueError, match="unknown sections"):
        tprof.section_calls(world, wanted=("window_step", "no_such"))


def test_window_step_runs_the_section_helpers(world, monkeypatch):
    """The step composes the helpers the profiler times, so a section
    cannot drift from the step: each runs once a window on its kernel."""
    calls = []
    for name in ("_rebase_refill", "_rebase_egress", "_egress_order",
                 "_token_gate", "_compact_ingress", "_route_scatter",
                 "_release_due", "_compact_egress"):
        fn = getattr(tplane, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tplane, name, spy)
    expect = {
        "xla": ["_rebase_refill", "_rebase_egress", "_egress_order",
                "_token_gate", "_compact_ingress", "_route_scatter",
                "_release_due", "_compact_egress"],
        "pallas": ["_rebase_refill", "_compact_ingress", "_route_scatter",
                   "_release_due", "_compact_egress"],
        "pallas_fused": ["_rebase_refill", "_compact_ingress",
                         "_release_due", "_compact_egress"],
    }
    for kernel, names in expect.items():
        calls.clear()
        tplane.window_step(world["state"], world["params"], 1,
                           world["shift"], world["window"],
                           rr_enabled=False, kernel=kernel)
        assert calls == names, kernel


def write_record(path: Path, faults: bool) -> dict:
    res = bench.run_phold(N, rounds=8, kernel="xla", device="cpu",
                          warmup=False, faults=faults)
    rec = bench.bench_record(res, bench.bench_sections("xla", N,
                                                       device="cpu"))
    path.write_text(json.dumps(rec) + "\n")
    return rec


def test_bench_faults_record_and_compare_runs(tmp_path):
    plain = write_record(tmp_path / "plain.json", faults=False)
    faulted = write_record(tmp_path / "faults.json", faults=True)
    # neutral masks leave the state as it was
    assert faulted["state_digest"] == plain["state_digest"]
    assert faulted["kernel"]["faults_threaded"] is True
    assert plain["kernel"] == {"requested": "xla", "used": "xla",
                               "fell_back": False, "faults_threaded": False}
    for rec in (plain, faulted):
        assert rec["metric"] == "packet_events_per_sec"
        assert rec["unit"] == "events/s" and rec["value"] > 0
        assert rec["hosts"] == N and rec["backend"]["platform"] == "cpu"
        assert list(rec["sections"]) == [*jprof.BENCH_SECTIONS,
                                         "windows_per_sync"]
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "compare_runs.py"), "--bench",
         str(tmp_path / "plain.json"), str(tmp_path / "faults.json")],
        capture_output=True, text=True, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "WARNING" not in proc.stdout
    assert "windows/sync: 8.0 -> 8.0" in proc.stdout
    table = proc.stdout.split("section", 1)[1]
    for name in jprof.BENCH_SECTIONS:
        assert name in table, name


def test_bench_refuses_faults_off_xla():
    for kernel in ("pallas_fused", "pallas"):
        with pytest.raises(ValueError, match="fault plane"):
            bench.run_phold(N, rounds=1, kernel=kernel, device="cpu",
                            warmup=False, faults=True)

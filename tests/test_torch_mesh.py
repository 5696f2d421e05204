"""The port's host-axis mesh (`shadow_tpu_torch/tpu/mesh.py`) against
the JAX package on the CPU: gloo process groups of 2-8 ranks, rank 0 in
the test process and the others spawned (`mesh.run_ranks`).

- the sharded `window_step` on 2, 4 and 8 ranks over the world of
  `tests/test_tpu_plane.py::test_sharded_step_matches_single_device`
  (16 hosts, loss 0.3, 4 windows), through the plain versions of all
  three kernels, equal bitwise to JAX's single-device run (which that
  test holds equal to JAX's 8-way sharded one);
- `tools.multichip`'s stress at 4096 hosts on 4 ranks (the JAX dry
  run's shape, reduced only in N) against JAX's one-device
  `chain_windows` on the same inputs, with overflow drops;
- `run_scenario(ring_allreduce, mesh_devices=8)` and `run_scenarios
  --shard 2 --check`: the canonical digest of JAX's
  `run_scenario(spec, mesh_devices=8)` and `scenarios/GOLDEN.json`;
- the runner's four refusals under a mesh, and NCCL with more ranks
  than cards.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, jax_params_to_numpy,  # noqa: E402
                          jax_state_to_numpy)

from shadow_tpu.tpu import ingest, make_params, make_state  # noqa: E402
from shadow_tpu.tpu.plane import chain_windows, window_step  # noqa: E402
from shadow_tpu_torch.tools import multichip  # noqa: E402
from shadow_tpu_torch.tpu import mesh as tmesh  # noqa: E402
from shadow_tpu_torch.workloads import run_scenarios as trs  # noqa: E402
from shadow_tpu_torch.workloads import runner as trunner  # noqa: E402
from shadow_tpu_torch.workloads import spec as tspec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "scenarios", "ring_allreduce.yaml")
GOLDEN = os.path.join(REPO, "scenarios", "GOLDEN.json")
MS = 1_000_000
N, WINDOWS, SEED = 16, 4, 3
# the port's (kernel, rr_enabled) runs and the JAX run each is held to:
# the Pallas kernels are FIFO-only, and JAX makes the three bitwise equal
VARIANTS = (("xla", True), ("xla", False), ("pallas", False),
            ("pallas_fused", False))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def step_world():
    """`test_sharded_step_matches_single_device`'s world and batch as
    numpy, and JAX's single-device run of it for rr on and off."""
    lat = np.full((N, N), 2 * MS, np.int32)
    params = make_params(lat, np.full((N, N), 0.3, np.float32),
                         np.full((N,), 8_000_000_000, np.int64))
    state = make_state(N, initial_tokens=np.asarray(params.tb_cap))
    batch = dict(
        src=np.repeat(np.arange(N, dtype=np.int32), 2),
        dst=np.tile(np.array([3, 11], np.int32), N),
        nbytes=np.full((2 * N,), 800, np.int32),
        prio=np.arange(2 * N, dtype=np.int32),
        seq=np.arange(2 * N, dtype=np.int32),
        ctrl=np.zeros(2 * N, bool))
    ref = {}
    for rr in (True, False):
        st = ingest(state, *(jnp.asarray(batch[k]) for k in (
            "src", "dst", "nbytes", "prio", "seq", "ctrl")))
        step = jax.jit(lambda s, p, k, sh, w, rr=rr: window_step(
            s, p, k, sh, w, rr_enabled=rr))
        delivered, nexts = [], []
        for w in range(WINDOWS):
            st, d, nxt = step(st, params, jax.random.key(SEED),
                              jnp.int32(0 if w == 0 else MS), jnp.int32(MS))
            delivered.append(_np(d))
            nexts.append(int(nxt))
        ref[rr] = (jax_state_to_numpy(st), delivered, nexts)
    return (jax_params_to_numpy(params), jax_state_to_numpy(state), batch,
            ref)


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_sharded_step_matches_jax_single_device(step_world, ranks):
    """Every kernel's sharded step on `ranks` ranks: the gathered state,
    each window's delivered dict and next event equal JAX's
    single-device run, bitwise; packets were lost and delivered."""
    params_np, state_np, batch, ref = step_world
    got = tmesh.run_ranks(multichip.sharded_windows, ranks, params_np,
                          state_np, batch, SEED, WINDOWS, VARIANTS,
                          device="cpu")
    for (kernel, rr), (st, delivered, nexts) in got.items():
        jst, jdel, jnext = ref[rr]
        assert_states_equal(jst, st, (ranks, kernel, rr))
        assert [int(x) for x in nexts] == jnext, (ranks, kernel, rr)
        for w, (jd, d) in enumerate(zip(jdel, delivered)):
            assert multichip.diff(jd, d) == [], (ranks, kernel, rr, w)
    jst = ref[False][0]
    assert jst["n_loss_dropped"].sum() > 0 and jst["n_delivered"].sum() > 0


def test_multichip_stress_matches_jax_one_device():
    """The stress at 4096 hosts on 4 ranks: state, delivered dict and the
    chain's (off, next, n_windows) equal JAX's one-device
    `chain_windows` of the same world, with overflow drops."""
    n = 4096
    got = tmesh.run_ranks(multichip.check_stress, 4, n,
                          multichip.STRESS_WINDOWS, "xla", False,
                          device="cpu")
    params = make_params(
        np.full((64, 64), 70 * MS, np.int32),
        np.full((64, 64), 0.01, np.float32), np.full(n, 80_000),
        host_node=np.arange(n) % 64)
    state = make_state(n, egress_cap=8,
                       ingress_cap=multichip.STRESS_INGRESS_CAP)
    b = multichip.stress_batch(n, "cpu")
    state = ingest(state, *(jnp.asarray(b[k].numpy()) for k in (
        "src", "dst", "nbytes", "prio", "seq", "ctrl")))
    st, d, off, nxt, n_win = jax.jit(lambda s, p: chain_windows(
        s, p, jax.random.key(multichip.STRESS_SEED), jnp.int32(0),
        jnp.int32(MS), jnp.int32(MS), jnp.int32(2**30), jnp.int32(2**30),
        max_windows=multichip.STRESS_WINDOWS, rr_enabled=False))(state,
                                                                 params)
    assert got["chain"] == [int(off), int(nxt), int(n_win)]
    assert got["chain"][2] == multichip.STRESS_WINDOWS
    assert_states_equal(jax_state_to_numpy(st), got["state"])
    assert multichip.diff(_np(d), got["delivered"]) == []
    assert got["overflow_drops"] > 0


def test_ring_corpus_entry_sharded_over_8_ranks_matches_jax():
    """`run_scenario(spec, mesh_devices=8)`: the canonical digest of the
    JAX runner's 8-device run and of the golden corpus, every host
    done."""
    from shadow_tpu.workloads import runner as jrunner
    from shadow_tpu.workloads.spec import load_scenario_file

    rec = trunner.run_scenario(tspec.load_scenario_file(RING), device="cpu",
                               mesh_devices=8)
    jrec = jrunner.run_scenario(load_scenario_file(RING), mesh_devices=8)
    with open(GOLDEN) as fh:
        golden = json.load(fh)[rec["name"]]
    assert rec["canonical_digest"] == jrec["canonical_digest"]
    assert rec["canonical_digest"] == golden["canonical_digest"]
    assert rec["all_done"] and rec["events"] == jrec["events"]


def test_run_scenarios_shard_2_checks_against_the_golden_corpus(capsys):
    assert trs.main([RING, "--shard", "2", "--check", "--device",
                     "cpu"]) == 0
    assert "x 2 ranks" in capsys.readouterr().err


def _refusal_spec(**kw):
    return tspec.parse_scenario({
        "name": "mesh-refusal", "family": "ring_allreduce", "seed": 3,
        "hosts": 8, "windows": 8,
        "patterns": [{"kind": "ring_allreduce", "first": 0, "count": 8,
                      "bytes": 256, "rounds": 1}], **kw})


@pytest.mark.parametrize("case", ["flows", "compute", "checkpoint_dir",
                                  "memo"])
def test_runner_refuses_under_a_mesh(case, tmp_path):
    """Flows, compute, checkpoints and the memo raise ValueError naming
    the mesh before any rank starts, as the JAX runner's do
    (`tests/test_memo.py::test_runner_refuses_memo_with_mesh`)."""
    spec, kw = _refusal_spec(), {}
    if case == "flows":
        spec = tspec.load_scenario_file(
            os.path.join(REPO, "scenarios", "incast_lossy.yaml"))
    elif case == "compute":
        # a serving entry on the direct transport, so the compute plane is
        # what the runner refuses
        spec = dataclasses.replace(tspec.load_scenario_file(
            os.path.join(REPO, "scenarios", "serve_diurnal.yaml")),
            transport="direct")
    elif case == "checkpoint_dir":
        kw = dict(checkpoint_dir=str(tmp_path / "ckpt"))
    else:
        kw = dict(memo=True)
    assert (spec.transport == "flows") == (case == "flows")
    assert (spec.compute is not None) == (case == "compute")
    with pytest.raises(ValueError, match="mesh"):
        trunner.run_scenario(spec, device="cpu", mesh_devices=2, **kw)


def test_make_mesh_refuses_more_nccl_ranks_than_cards():
    with pytest.raises(ValueError, match='backend="gloo"'):
        tmesh.make_mesh(torch.cuda.device_count() + 1, backend="nccl")
    with pytest.raises(ValueError, match='backend="gloo"'):
        tmesh.run_ranks(multichip.check_two_rounds,
                        torch.cuda.device_count() + 1, backend="nccl",
                        device="cpu")


class PairMesh:
    """Rank 0 of a 2-rank mesh in this process, whose other rank holds
    its own rows plus one (negated where boolean)."""

    def gather_leaf(self, t):
        return torch.cat([t, ~t if t.dtype == torch.bool else t + 1])


def test_carry_to_host_gathers_the_host_major_leaves():
    """`convert.carry_to_host(carry, mesh=)`: every host-major leaf in
    rank order, the 0-d leaves and the flight recorder's ring (whole on
    every rank) as they are, in the JAX dtypes."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.telemetry import flightrec
    from shadow_tpu_torch.telemetry.metrics import make_metrics
    from shadow_tpu_torch.tpu.plane import make_state as tmake_state

    state = tmake_state(4, egress_cap=8, ingress_cap=16, device="cpu")
    metrics = make_metrics(4, device="cpu")
    fr = flightrec.make_flightrec(5, ring=32, device="cpu")
    spawn = torch.arange(4, dtype=torch.int32)
    host = convert.carry_to_host((state, (spawn, 9, metrics, fr)),
                                 mesh=PairMesh())
    hstate, (hspawn, total, hmetrics, hfr) = host
    assert hspawn.tolist() == [0, 1, 2, 3, 1, 2, 3, 4]
    assert hstate.eg_dst.shape == (8, 8)
    assert hstate.router.dropped.shape == (8,)
    assert hstate.eg_valid.dtype == bool and hstate.eg_valid[4:].all()
    assert hmetrics.windows.shape == () and hmetrics.pkts_out.shape == (8,)
    assert int(total) == 9
    assert hfr.ev_kind.shape == (32,) and hfr.key.dtype == np.uint32

"""The port's PHOLD closed loop against the JAX bench loop, bitwise.

`shadow_tpu_torch.tpu.profiling.build_world` + `bench.run_chain`
(window_step through the plain versions of kernels A and B, respawn,
ingest_rows, driven by the chained driver with uneven spans) must end in
the state and delivered total of `bench.py`'s fixed-mode loop run with
`window_step(kernel="pallas_fused")` (Pallas interpret mode on the CPU).
Also pins `bench.GOLDEN_PHOLD_DIGEST`, which `chip_smoke.py` checks the
card's run against.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import assert_states_equal, jax_state_to_numpy  # noqa: E402

from shadow_tpu.tpu import ingest_rows, profiling, window_step  # noqa: E402
from shadow_tpu.workloads.phold import respawn_batch  # noqa: E402
from shadow_tpu_torch import bench, convert  # noqa: E402
from shadow_tpu_torch.tpu import elastic  # noqa: E402
from shadow_tpu_torch.tpu import profiling as tprofiling  # noqa: E402


def jax_phold(n_hosts, rounds, *, n_nodes=64, egress_cap=16,
              ingress_cap=32):
    """bench.py's fixed-mode round body, one jitted window per round."""
    world = profiling.build_world(n_hosts, n_nodes=n_nodes,
                                  egress_cap=egress_cap,
                                  ingress_cap=ingress_cap, seed=0,
                                  warmup_windows=0)
    params, key, window = world["params"], world["rng_root"], world["window"]
    N = n_hosts

    @jax.jit
    def round_fn(state, spawn_seq, round_idx):
        shift = jnp.where(round_idx == 0, jnp.int32(0), window)
        state, delivered, _ = window_step(state, params, key, shift, window,
                                          rr_enabled=False,
                                          kernel="pallas_fused")
        mask, dst, nbytes, seq, ctrl = respawn_batch(
            delivered, spawn_seq, round_idx, N, state.in_src.shape[1])
        state = ingest_rows(state, dst, nbytes, seq, seq, ctrl, valid=mask)
        return (state, spawn_seq + mask.sum(axis=1, dtype=jnp.int32),
                mask.sum(dtype=jnp.int32))

    state = world["state"]
    spawn_seq = jnp.full((N,), 10_000, jnp.int32)
    total = 0
    for r in range(rounds):
        state, spawn_seq, nd = round_fn(state, spawn_seq, jnp.int32(r))
        total += int(nd)
    return jax_state_to_numpy(state), total


def test_build_world_matches_jax():
    """The seeded world with its flat ingest and 2 warm-up windows."""
    ref = profiling.build_world(64, n_nodes=8, egress_cap=8,
                                ingress_cap=16, seed=3, warmup_windows=2)
    got = tprofiling.build_world(64, n_nodes=8, egress_cap=8,
                                 ingress_cap=16, seed=3, warmup_windows=2,
                                 device="cpu")
    assert_states_equal(jax_state_to_numpy(ref["state"]),
                        convert.state_to_numpy(got["state"]))
    for k in ref["delivered"]:
        assert np.array_equal(np.asarray(ref["delivered"][k]),
                              got["delivered"][k].numpy()), k


def test_phold_chain_matches_jax_bench_loop():
    """8 rounds at N=64 through chains of 3 (spans 3, 3, 2)."""
    assert elastic.chain_spans(8, 3) == [(0, 3), (3, 6), (6, 8)]
    ref_state, ref_total = jax_phold(64, 8)
    world = tprofiling.build_world(64, n_nodes=64, egress_cap=16,
                                   ingress_cap=32, seed=0, warmup_windows=0,
                                   device="cpu")
    state, total = bench.run_chain(world, 8, chain_len=3)
    assert total == ref_total > 0
    assert_states_equal(ref_state, convert.state_to_numpy(state))


def test_golden_phold_digest_matches_jax():
    """The constant `chip_smoke.py` holds the card's run to is the JAX
    pallas_fused run's final state, and the port's CPU run gives it."""
    g = bench.GOLDEN_PHOLD
    size = dict(n_nodes=g["n_nodes"], egress_cap=g["egress_cap"],
                ingress_cap=g["ingress_cap"])
    ref_state, _ = jax_phold(g["n_hosts"], g["rounds"], **size)
    assert convert.state_digest(ref_state) == bench.GOLDEN_PHOLD_DIGEST
    res = bench.run_phold(g["n_hosts"], rounds=g["rounds"], warmup=False,
                          device="cpu", **size)
    assert convert.state_digest(res["state"]) == bench.GOLDEN_PHOLD_DIGEST
    assert res["events"] == res["delivered"] + res["sent"] > 0


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_routing_stage_range_spans_the_placement(kernel):
    """`bench.profile_windows`' routing-stage range opens after the flat
    routing sort and closes after the placement: one range a window,
    holding the placement's ops but not the sort, with each window's take
    kept for the placed-slot count; the pipeline's functions are put back
    afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.tpu import pipeline

    world = tprofiling.build_world(32, n_nodes=8, egress_cap=8,
                                   ingress_cap=8, warmup_windows=1,
                                   device="cpu")
    chain = bench.phold_chain_fn(world, kernel=kernel)
    spawn = torch.full((32,), bench.SPAWN_SEQ0, dtype=torch.int32)
    before = (pipeline._routing_rank, pipeline.place, pipeline.scatter)
    takes = []
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            bench._routing_stage_ranges(takes):
        chain(world["state"], (spawn, 0), 1, 4)
    assert (pipeline._routing_rank, pipeline.place, pipeline.scatter) \
        == before
    stage = [ev for ev in prof.events() if ev.name == bench.ROUTING_STAGE]
    assert len(stage) == len(takes) == 3
    def subtree(ev):
        yield ev
        for child in ev.cpu_children:
            yield from subtree(child)

    ops = {op.name for ev in stage for op in subtree(ev)}
    assert "aten::copy_" in ops and "aten::sort" not in ops, ops
    assert all(t.shape == (32,) for t in takes)
    assert sum(int(t.sum()) for t in takes) > 0

"""The port's sharded flow engine (`floweng.run_windows_sharded`) against
JAX's, bitwise: JAX pmaps `run_windows` over its CPU devices, the port
runs each pair-aligned shard from one controller. On the world of
`tests/test_torch_floweng.py` (8 flows, 60 windows of 2 ms, 16-slot
rings, the default step cap), at 2 and 4 shards, every leaf of the
merged world and every shard's steps equal JAX's; the merged world also
equals the port's own unsharded run, and the input world is left as it
was. Also the flow-engine half of `tools.multichip` at a small size."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from test_torch_floweng import (GSO, N_WINDOWS, WINDOW_US,  # noqa: E402
                                as_numpy, assert_worlds_equal, jax_world,
                                port_world)

from shadow_tpu.tpu import floweng as jfe  # noqa: E402
from shadow_tpu_torch.tools import multichip  # noqa: E402
from shadow_tpu_torch.tpu import floweng as tfe  # noqa: E402

SHARDS = (2, 4)
OPTS = dict(max_events_per_window=512, gso_segs=GSO)


@pytest.fixture(scope="module")
def single():
    """The port's unsharded run of the world."""
    return tfe.run_windows(port_world(), N_WINDOWS, WINDOW_US, **OPTS)


@pytest.fixture(scope="module")
def sharded():
    """{n_shards: (input world, its numpy before the run, merged world,
    steps)} of the port's sharded runs."""
    out = {}
    for n in SHARDS:
        w0 = port_world()
        before = as_numpy(w0)
        out[n] = (w0, before, *tfe.run_windows_sharded(
            w0, N_WINDOWS, WINDOW_US, n_shards=n, **OPTS))
    return out


@pytest.mark.parametrize("n_shards", SHARDS)
def test_run_windows_sharded_matches_jax(n_shards, sharded):
    jw, jsteps = jfe.run_windows_sharded(jax_world(), N_WINDOWS, WINDOW_US,
                                         n_shards=n_shards, **OPTS)
    _w0, _before, tw, tsteps = sharded[n_shards]
    assert_worlds_equal(jw, tw)
    assert tsteps.dtype == torch.int32
    assert tsteps.shape == (n_shards, N_WINDOWS)
    assert np.array_equal(np.asarray(jsteps), tsteps.numpy())
    assert tsteps.sum() > 0 and int(tw.seg_units.sum()) > 0


@pytest.mark.parametrize("n_shards", SHARDS)
def test_run_windows_sharded_equals_one_run_and_keeps_its_input(
        n_shards, sharded, single):
    """Pairs never interact: the merge is the unsharded world, leaf for
    leaf, and a window's step count over the whole world is its largest
    shard's."""
    w0, before, tw, tsteps = sharded[n_shards]
    ref, ref_steps = single
    assert_worlds_equal(ref, tw)
    assert torch.equal(tsteps.max(dim=0).values, ref_steps)
    after = as_numpy(w0)
    for f, x in before.items():
        for g, y in (x.items() if f == "plane" else [(f, x)]):
            z = after["plane"][g] if f == "plane" else after[f]
            assert y.dtype == z.dtype and np.array_equal(y, z), (f, g)
    assert int(ref.n_saturated) == 0


def test_run_windows_sharded_refuses_a_split_inside_a_pair():
    w = port_world(6)  # 12 lanes: 4 shards would cut pairs
    with pytest.raises(ValueError, match="pair-aligned"):
        tfe.run_windows_sharded(w, 1, WINDOW_US, n_shards=4)
    with pytest.raises(ValueError, match="at least 1"):
        tfe.run_windows_sharded(w, 1, WINDOW_US, n_shards=0)


def test_run_windows_sharded_defaults_to_one_shard_on_the_cpu():
    """A CPU world has one shard by default; the clock and a saturation
    count it already carries come through the split and the merge as in
    the unsharded run (the count rides on shard 0 only)."""
    w = port_world(2)._replace(
        clock_us=torch.tensor(4000, dtype=torch.int32),
        n_saturated=torch.tensor(3, dtype=torch.int32))
    w = w._replace(conn_t=torch.full_like(w.conn_t, 4000))
    got, steps = tfe.run_windows_sharded(w, 5, WINDOW_US, **OPTS)
    ref, ref_steps = tfe.run_windows(w, 5, WINDOW_US, **OPTS)
    assert steps.shape == (1, 5)
    assert torch.equal(steps[0], ref_steps)
    assert_worlds_equal(ref, got)
    assert int(got.n_saturated) == 3 and int(got.clock_us) == 4000 + 5 * \
        WINDOW_US
    # two shards: the prior count is not counted twice
    got2, _ = tfe.run_windows_sharded(w, 5, WINDOW_US, n_shards=2, **OPTS)
    assert_worlds_equal(ref, got2)


def test_multichip_flow_engine_check_passes_small():
    rep = multichip.check_flow_engine(2, "cpu", n_flows_per_shard=2,
                                      n_windows=40)
    assert rep["diff"] == [] and rep["flows"] == 4
    assert rep["steps_shape"] == [2, 40]
    assert rep["segments"] > 0 and rep["complete"] > 0

"""The port's CoDel trace replay against the JAX package's, bitwise:
`codel.codel_drain` over the three traffic regimes of
`tests/test_tpu_codel.py` (from the empty state and from a random one),
`rebase_codel_state`, and the control-law table."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from test_tpu_codel import cpu_replay, make_trace  # noqa: E402

from shadow_tpu.tpu import codel as jcodel  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.tpu import codel as tcodel  # noqa: E402

I32_MAX = 2**31 - 1
MS = 1_000_000
# one padded shape for every regime, so JAX compiles the replay once
K, P = 64, 64


def traces_as_arrays(traces):
    n = len(traces)
    arrival = np.full((n, K), I32_MAX, np.int32)
    size = np.zeros((n, K), np.int32)
    pops = np.full((n, P), I32_MAX, np.int32)
    for h, (pushes, pop_t) in enumerate(traces):
        assert len(pushes) <= K and len(pop_t) <= P
        for i, (t, s) in enumerate(pushes):
            arrival[h, i], size[h, i] = t, s
        pops[h, :len(pop_t)] = pop_t
    return arrival, size, pops


def random_codel_state(n, seed):
    """A mid-run CodelState: both modes, set and unset deadlines, counts,
    consumed entries and bytes left from an earlier replay."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(
        mode=i32(rng.integers(0, 2, n)),
        has_interval_end=rng.random(n) < 0.5,
        interval_end=i32(rng.integers(-50 * MS, 150 * MS, n)),
        has_drop_next=rng.random(n) < 0.5,
        drop_next=i32(rng.integers(-50 * MS, 150 * MS, n)),
        cur_count=i32(rng.integers(0, 6, n)),
        prev_count=i32(rng.integers(0, 6, n)),
        entry_idx=np.zeros(n, np.int32),
        consumed_bytes=np.zeros(n, np.int32),
        dropped=i32(rng.integers(0, 9, n)))


def replay_both(arrival, size, pops, state: dict):
    jstate = jcodel.CodelState(**{k: jax.numpy.asarray(v)
                                  for k, v in state.items()})
    jst, jstatus, jdt = jax.jit(jcodel.codel_drain)(arrival, size, pops,
                                                    jstate)
    tst, tstatus, tdt = tcodel.codel_drain(
        torch.from_numpy(arrival), torch.from_numpy(size),
        torch.from_numpy(pops), convert.codel_from_numpy(state, "cpu"))
    assert np.array_equal(np.asarray(jstatus), tstatus.numpy())
    assert np.array_equal(np.asarray(jdt), tdt.numpy())
    for f in jcodel.CodelState._fields:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return tst, tstatus, tdt


@pytest.mark.parametrize("start", ["empty", "mid_run"])
@pytest.mark.parametrize("regime", ["light", "burst", "mixed"])
def test_codel_drain_matches_jax(regime, start):
    rng = np.random.default_rng(zlib.crc32(regime.encode()))
    traces = [make_trace(rng, regime) for _ in range(8)]
    arrival, size, pops = traces_as_arrays(traces)
    n = len(traces)
    if start == "empty":
        state = {k: np.asarray(v) for k, v in
                 jcodel.make_codel_state(n)._asdict().items()}
    else:
        state = random_codel_state(n, seed=len(regime))
    tst, tstatus, tdt = replay_both(arrival, size, pops, state)
    if start == "empty":
        # and the port reproduces the CPU plane's CoDelQueue directly
        for h, (pushes, pop_t) in enumerate(traces):
            status, deliver, dropped = cpu_replay(pushes, pop_t)
            assert tstatus[h, :len(pushes)].tolist() == status
            for i, t in enumerate(deliver):
                if t is not None:
                    assert int(tdt[h, i]) == t
            assert int(tst.dropped[h]) == dropped
    if regime == "burst":
        assert int(tst.dropped.sum()) > int(state["dropped"].sum()), \
            "no CoDel drop: dead test"


def test_rebase_codel_state_matches_jax():
    state = random_codel_state(16, seed=3)
    for shift in (0, 10 * MS, -7 * MS, 2**31 - 1):
        j = jcodel.rebase_codel_state(
            jcodel.CodelState(**{k: jax.numpy.asarray(v)
                                 for k, v in state.items()}), shift)
        t = tcodel.rebase_codel_state(
            convert.codel_from_numpy(state, "cpu"), shift)
        for f in jcodel.CodelState._fields:
            assert np.array_equal(np.asarray(getattr(j, f)),
                                  getattr(t, f).numpy()), (shift, f)


def test_ctrl_table_matches_jax():
    assert tcodel.CTRL_TABLE.dtype == torch.int32
    assert np.array_equal(np.asarray(jcodel.CTRL_TABLE),
                          tcodel.CTRL_TABLE.numpy())
    assert (tcodel.TARGET, tcodel.INTERVAL) == (int(jcodel.TARGET),
                                                int(jcodel.INTERVAL))

"""The port's compute plane against the JAX package's, bitwise:
`compute_step` on random delivered rows (a queue that overflows, a host
that costs nothing, a shifted backlog clock, a backlog carried from the
last window), `gate_credits`, `phase_service`, the tables' refusal and
the state carried through numpy."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import assert_tuples_equal  # noqa: E402

from shadow_tpu.telemetry import histo as jhisto  # noqa: E402
from shadow_tpu.tpu import compute as jcompute  # noqa: E402
from shadow_tpu.workloads import runner as jrunner  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.telemetry import histo as thisto  # noqa: E402
from shadow_tpu_torch.tpu import compute as tcompute  # noqa: E402

MS = 1_000_000
WINDOW = 5 * MS
N, P, CI = 6, 3, 16


def tables(rng, queue_cap):
    """[N, P] service costs: host 0 costs nothing in every phase, host 1
    so much that its queue overflows, the rest in between."""
    svc = rng.integers(0, 400_000, (N, P)).astype(np.int32)
    svc[0] = 0
    svc[1] = 3 * MS
    return (jcompute.make_compute_tables(svc, queue_cap),
            tcompute.make_compute_tables(svc, queue_cap, device="cpu"))


def delivered(rng, fill):
    """Front-packed delivered rows in ascending deliver_rel, as
    `window_step` releases them."""
    n_arr = rng.integers(0, CI + 1, N)
    n_arr[1] = CI  # the overflowing host gets a full row
    mask = np.arange(CI)[None, :] < (n_arr * fill).astype(int)[:, None]
    t = np.sort(rng.integers(0, WINDOW, (N, CI)), axis=1).astype(np.int32)
    d = {"mask": mask, "deliver_rel": np.where(mask, t, 2**31 - 1)
         .astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


def random_state(rng, ct):
    """A ComputeState with a backlog in flight and counters set."""
    d = convert.tuple_to_numpy(tcompute.make_compute_state(ct[1]))
    i = lambda lo, hi, shape=N: rng.integers(lo, hi, shape).astype(np.int32)
    d.update(busy_rel=i(0, 3 * WINDOW), q_depth=i(0, 6), n_served=i(0, 50),
             n_credit_raw=i(0, 60), n_granted=i(0, 40),
             hist_wait_ns=i(0, 9, (N, jhisto.HIST_BUCKETS)))
    d["busy_rel"][0] = 0
    d["q_depth"][0] = 0
    return (jcompute.ComputeState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.tuple_from_numpy(tcompute.ComputeState, d, "cpu"))


def test_histogram_layout_matches_jax():
    assert thisto.HIST_BUCKETS == jhisto.HIST_BUCKETS


@pytest.mark.parametrize("queue_cap", [1, 4, 128])
@pytest.mark.parametrize("shift", [0, WINDOW, 3 * WINDOW // 2])
def test_compute_step_matches_jax(queue_cap, shift):
    """Five windows of arrivals through each host's FIFO, from a random
    backlog, then `phase_service` and `gate_credits` each window."""
    rng = np.random.default_rng(queue_cap + shift)
    jct, tct = tables(rng, queue_cap)
    jcs, tcs = random_state(rng, (jct, tct))
    for w in range(5):
        jd, td = delivered(rng, fill=1.0 if w % 2 == 0 else 0.5)
        jcs = jcompute.compute_step(jct, jcs, jd, jnp.int32(shift),
                                    jnp.int32(WINDOW))
        tcs = tcompute.compute_step(tct, tcs, td, shift, WINDOW)
        assert_tuples_equal(jcs, tcs, w)
        raw = rng.integers(0, 6, N).astype(np.int32)
        jcs, jgot = jcompute.gate_credits(jcs, jnp.asarray(raw))
        tcs, tgot = tcompute.gate_credits(tcs, torch.from_numpy(raw))
        assert np.array_equal(np.asarray(jgot), tgot.numpy())
        phase = rng.integers(-1, P + 2, N).astype(np.int32)
        jcs = jcompute.phase_service(jct, jcs, jnp.asarray(phase))
        tcs = tcompute.phase_service(tct, tcs, torch.from_numpy(phase))
        assert_tuples_equal(jcs, tcs, w)
    if queue_cap < 128:
        assert int(tcs.n_overflow[1]) > 0
    assert int(tcs.n_served.sum()) > 0 and int(tcs.hist_sojourn_ns.sum()) > 0


def test_zero_cost_host_passes_credits_through():
    """A host whose phases cost nothing serves each arrival in its own
    window, so the gate grants its raw credits unchanged."""
    rng = np.random.default_rng(5)
    jct, tct = tables(rng, 8)
    tcs = tcompute.make_compute_state(tct)
    for _ in range(3):
        _jd, td = delivered(rng, fill=1.0)
        tcs = tcompute.compute_step(tct, tcs, td, WINDOW, WINDOW)
        raw = td["mask"].sum(dim=1, dtype=torch.int32)
        tcs, got = tcompute.gate_credits(tcs, raw)
        assert int(got[0]) == int(raw[0])
        assert int(tcs.q_depth[0]) == 0 and int(tcs.n_queued[0]) == 0
        assert int(tcs.served_win[0]) == int(raw[0])


def test_compute_tables_and_state_match_jax():
    rng = np.random.default_rng(0)
    svc = rng.integers(0, 10**6, (N, P))
    for cap in (0, -3):
        with pytest.raises(ValueError, match="queue_cap"):
            tcompute.make_compute_tables(svc, cap, device="cpu")
    jct, tct = tables(rng, 3)
    assert_tuples_equal(jcompute.make_compute_state(jct),
                        tcompute.make_compute_state(tct))
    back = convert.tuple_from_numpy(tcompute.ComputeTables,
                                    jct._asdict(), "cpu")
    assert back.queue_cap == 3 and isinstance(back.queue_cap, int)
    assert torch.equal(back.service_ns, tct.service_ns)
    assert convert.tuple_to_numpy(back)["queue_cap"] == 3
    jcs, tcs = random_state(rng, (jct, tct))
    again = convert.tuple_from_numpy(tcompute.ComputeState,
                                     convert.tuple_to_numpy(tcs), "cpu")
    assert_tuples_equal(jcs, again)
    # the digest hashes the int leaf as the JAX runner's does
    assert convert.digest_pytrees(tct, tcs) == jrunner.digest_pytrees(jct,
                                                                      jcs)

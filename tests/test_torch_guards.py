"""The port's guard plane against the JAX package's, bitwise: the
`GuardState` and its `summarize` after faulted windows, after `ingest`
and `ingest_rows`, and under the JAX tests' tampers (a phantom ring
slot, a negative live key, a negative shift); threading guards leaves
the state as it is; the Pallas kernels refuse the plane."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch_parity import (assert_states_equal, assert_tuples_equal,  # noqa: E402
                          jax_state_to_numpy, rr_world)

from shadow_tpu.faults import plane as jfplane  # noqa: E402
from shadow_tpu.guards import plane as jgplane  # noqa: E402
from shadow_tpu.tpu import plane as jplane  # noqa: E402
from shadow_tpu_torch import convert  # noqa: E402
from shadow_tpu_torch.faults import plane as tfplane  # noqa: E402
from shadow_tpu_torch.guards import plane as tgplane  # noqa: E402
from shadow_tpu_torch.guards import report as treport  # noqa: E402
from shadow_tpu_torch.tpu import plane as tplane  # noqa: E402

MS = 1_000_000
N, CE, CI = 8, 8, 8
SEED = 9


def _masks():
    m = dict(host_alive=np.ones(N, bool), link_up=np.ones(N, bool),
             lat_mult=np.ones((N, N), np.int32), bw_div=np.ones(N, np.int32),
             corrupt_p=np.zeros(N, np.float32))
    m["host_alive"][1] = False
    m["link_up"][6] = False
    m["lat_mult"][2, 3] = 4
    m["bw_div"][0] = 3
    m["corrupt_p"][4] = 0.5
    return m


def guarded_windows(windows=4, faulted=True, tamper=None, shift0=0):
    """`windows` XLA windows of the rr world with the guard plane (and
    faults) on both sides, the port's guard state compared with JAX's
    after each. `tamper(state)` edits JAX's entry state of window 0,
    which the port then starts from. Returns (jax guards, port guards,
    port state)."""
    (params, jst), (tparams, tst) = rr_world(N, CE, CI, seed=4)
    if tamper is not None:
        jst = tamper(jst)
        tst = convert.state_from_numpy(jax_state_to_numpy(jst), "cpu")
    key = jax.random.key(SEED)
    jfa = jfplane.faults_from_numpy(**_masks()) if faulted else None
    tfa = (tfplane.faults_from_numpy(**_masks(), device="cpu") if faulted
           else None)
    jg, tg = jgplane.make_guards(N), tgplane.make_guards(N, device="cpu")
    step = jax.jit(lambda st, sh, g: jplane.window_step(
        st, params, key, sh, jnp.int32(10 * MS), faults=jfa, guards=g))
    for w in range(windows):
        shift = shift0 if w == 0 else 10 * MS
        jst, _jd, _jn, jg = step(jst, jnp.int32(shift), jg)
        tst, _td, _tn, tg = tplane.window_step(
            tst, tparams, SEED, shift, 10 * MS, faults=tfa, guards=tg)
        assert_states_equal(jax_state_to_numpy(jst),
                            convert.state_to_numpy(tst), w)
        assert_tuples_equal(jg, tg, w)
    return jg, tg, tst


def test_guarded_faulted_windows_match_jax_and_stay_clean():
    jg, tg, tst = guarded_windows(6)
    assert tgplane.summarize(tg) == jgplane.summarize(jg)
    assert tgplane.summarize(tg)["clean"]
    assert int(tg.windows) == 6 and int(tg.checks) == 36
    assert int(tst.n_fault_dropped.sum()) > 0
    # guards read, never write: the same run without them ends alike
    (_p, _j), (tparams, bare) = rr_world(N, CE, CI, seed=4)
    tfa = tfplane.faults_from_numpy(**_masks(), device="cpu")
    for w in range(6):
        bare, _d, _n = tplane.window_step(bare, tparams, SEED,
                                          0 if w == 0 else 10 * MS, 10 * MS,
                                          faults=tfa)
    assert convert.state_digest(bare) == convert.state_digest(tst)


def test_phantom_ring_slot_matches_jax():
    """A phantom valid slot at the back of one ingress ring: the same
    ring-structure bit and first window as in JAX."""
    def tamper(st):
        return st._replace(in_valid=st.in_valid.at[3, CI - 1].set(True))
    jg, tg, _ = guarded_windows(2, faulted=False, tamper=tamper)
    summ = tgplane.summarize(tg)
    assert summ == jgplane.summarize(jg)
    assert summ["by_class"]["ring-structure"] >= 1
    assert summ["first_offenders"][0]["host_index"] == 3
    assert summ["first_offenders"][0]["first_window"] == 0


def test_negative_key_and_clock_match_jax():
    """A negative seq in a live egress slot (outside the packed keys'
    domain) and a negative first shift."""
    def tamper(st):
        return st._replace(eg_valid=st.eg_valid.at[5, 0].set(True),
                           eg_seq=st.eg_seq.at[5, 0].set(-7))
    jg, tg, _ = guarded_windows(2, faulted=False, tamper=tamper,
                                shift0=-MS)
    summ = tgplane.summarize(tg)
    assert summ == jgplane.summarize(jg)
    assert "packed-key-budget" in summ["by_class"]
    assert summ["scalar_flags"] == ["virtual-clock"]
    assert not summ["clean"]


def test_ingest_and_ingest_rows_guards_match_jax():
    """Append conservation through both appends, with overflow, and the
    guard state's window index untouched by them."""
    (params, jst), (tparams, tst) = rr_world(N, CE, CI, seed=2)
    rng = np.random.default_rng(3)
    jg, tg = jgplane.make_guards(N), tgplane.make_guards(N, device="cpu")
    b = 5 * N
    flat = dict(src=rng.integers(-1, N + 1, b).astype(np.int32),
                dst=rng.integers(0, N, b).astype(np.int32),
                nbytes=rng.integers(60, 1500, b).astype(np.int32),
                prio=rng.integers(0, 4, b).astype(np.int32),
                seq=np.arange(b, dtype=np.int32) + 100,
                ctrl=rng.random(b) < 0.2, valid=rng.random(b) < 0.8)
    jst, jg = jplane.ingest(jst, **{k: jnp.asarray(v)
                                    for k, v in flat.items()}, guards=jg)
    tst, tg = tplane.ingest(tst, **{k: torch.from_numpy(v)
                                    for k, v in flat.items()}, guards=tg)
    assert_tuples_equal(jg, tg)
    rows = dict(dst=rng.integers(0, N, (N, 6)).astype(np.int32),
                nbytes=rng.integers(60, 1500, (N, 6)).astype(np.int32),
                prio=rng.integers(0, 4, (N, 6)).astype(np.int32),
                seq=rng.integers(0, 1000, (N, 6)).astype(np.int32),
                ctrl=rng.random((N, 6)) < 0.2,
                valid=rng.random((N, 6)) < 0.7)
    jst, jg = jplane.ingest_rows(jst, **{k: jnp.asarray(v)
                                         for k, v in rows.items()}, guards=jg)
    tst, tg = tplane.ingest_rows(tst, **{k: torch.from_numpy(v)
                                         for k, v in rows.items()}, guards=tg)
    assert_tuples_equal(jg, tg)
    assert_states_equal(jax_state_to_numpy(jst), convert.state_to_numpy(tst))
    assert int(tst.n_overflow_dropped.sum()) > 0
    assert int(tg.checks) == 2 and int(tg.windows) == 0
    assert tgplane.summarize(tg) == jgplane.summarize(jg)


def test_guard_state_converts_and_decodes():
    g = tgplane.make_guards(4, device="cpu")._replace(
        violations=torch.tensor([0, 5, 0, 64], dtype=torch.int32),
        first_window=torch.tensor([2**31 - 1, 3, 2**31 - 1, 0],
                                  dtype=torch.int32),
        flags=torch.tensor(32, dtype=torch.int32))
    d = convert.tuple_to_numpy(g)
    back = convert.tuple_from_numpy(tgplane.GuardState, d, "cpu")
    assert tgplane.summarize(back) == jgplane.summarize(
        jgplane.GuardState(**{k: jnp.asarray(v) for k, v in d.items()}))
    assert tgplane.decode_bits(5) == jgplane.decode_bits(5) == [
        "egress-conservation", "ring-structure"]


def test_guard_report_writes_the_ledger(tmp_path):
    ledger = treport.GuardLedger(policies={"device": "abort"})
    v = treport.GuardViolation("device", "ring-structure", 10, host="h3",
                               expected=0, actual=1)
    ledger.apply("progress", [v])
    with pytest.raises(treport.GuardError, match="ring-structure"):
        ledger.apply("device", [v])
    path = treport.write_report(str(tmp_path), ledger, {"run": "x"})
    assert '"total": 2' in open(path).read()


@pytest.mark.parametrize("kernel", ["pallas_fused", "pallas"])
def test_pallas_paths_refuse_guards(kernel):
    (_p, _j), (tparams, tst) = rr_world(N, CE, CI, rr_mix=False)
    with pytest.raises(ValueError, match="guards"):
        tplane.window_step(tst, tparams, 0, 0, MS, rr_enabled=False,
                           kernel=kernel,
                           guards=tgplane.make_guards(N, device="cpu"))

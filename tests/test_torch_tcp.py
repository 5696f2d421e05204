"""The port's TCP connection machine (`shadow_tpu_torch/tpu/tcp.py`)
against the JAX package's, bitwise: `tcp_replay` over the CPU pair
traces of `tests/test_tpu_tcp.py` (clean, lossy with scripted drops,
abort, bidirectional), each with SACK on and off, and over random event
streams; every `TcpPlane` leaf, every PULL output and every WRITE/READ
return. Also the two reassembly edge cases and the closed forms that
replace JAX's convergent loops (`_reass_drain`, `_sb_next`)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from test_tpu_tcp import MS, transfer_scenario  # noqa: E402

from shadow_tpu.tpu import tcp as jtcp  # noqa: E402
from shadow_tpu_torch.tpu import tcp as ttcp  # noqa: E402

# name -> transfer_scenario arguments (small enough to record quickly)
SCENARIOS = {
    "clean": dict(latency_ns=1 * MS, seed=1, size=60_000, chunk=8192),
    "lossy": dict(latency_ns=2 * MS, seed=3, size=120_000, chunk=16384,
                  drop_at=(5, 6, 40, 41, 42)),
    "abort": dict(latency_ns=1 * MS, seed=9, size=200_000, chunk=4096,
                  abort_at_ns=8 * MS),
    "bidirectional": dict(latency_ns=1 * MS, seed=5, size=40_000,
                          chunk=8192, b_writes=30_000),
}
SACK = (True, False)


def plane_to_numpy(plane) -> dict:
    """A plane of either package as numpy, uint32 leaves as int64."""
    out = {}
    for f in plane._fields:
        a = np.asarray(getattr(plane, f))
        out[f] = a.astype(np.int64) if a.dtype == np.uint32 else a
    return out


def torch_plane(d: dict):
    return ttcp.TcpPlane(**{f: torch.from_numpy(np.array(d[f]))
                            for f in ttcp.TcpPlane._fields})


def assert_planes_equal(a: dict, b: dict, rows=slice(None)):
    for f in ttcp.TcpPlane._fields:
        x, y = a[f][rows], b[f][rows]
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), (f, x, y)


def both_replays(plane_np: dict, kinds, fields, now_ms):
    """(JAX's (plane, outs, rets), the port's) from one start plane."""
    jp = jtcp.TcpPlane(**{
        f: jnp.asarray(v.astype(np.uint32) if f in ttcp.U32_FIELDS else v)
        for f, v in plane_np.items()})
    j_plane, j_outs, j_rets = jax.jit(jtcp.tcp_replay)(
        jp, jnp.asarray(kinds), jnp.asarray(fields), jnp.asarray(now_ms))
    t_plane, t_outs, t_rets = ttcp.tcp_replay(
        torch_plane(plane_np), torch.from_numpy(kinds),
        torch.from_numpy(fields), torch.from_numpy(now_ms))
    return ((plane_to_numpy(j_plane), np.asarray(j_outs), np.asarray(j_rets)),
            (plane_to_numpy(t_plane), t_outs.numpy(), t_rets.numpy()))


@pytest.fixture(scope="module")
def pair_traces():
    """Every scenario's two connections, twice (SACK on, then off), in
    one batch padded with EV_NONE, so JAX compiles the replay once."""
    recorded = []
    for args in SCENARIOS.values():
        recorded += list(transfer_scenario(**args))
    conns = recorded * len(SACK)
    C = len(conns)
    T = max(len(rc.rec.events) for rc in conns)
    kinds = np.zeros((C, T), np.int32)
    fields = np.zeros((C, T, ttcp.N_FIELDS), np.int32)
    now_ms = np.zeros((C, T), np.int32)
    for i, rc in enumerate(conns):
        for j, (t, kind, f, _exp) in enumerate(rc.rec.events):
            kinds[i, j], fields[i, j], now_ms[i, j] = kind, f, t // MS
    plane = plane_to_numpy(ttcp.make_tcp_plane(C, device="cpu"))
    plane["sack_on"][len(recorded):] = False
    return both_replays(plane, kinds, fields, now_ms), len(recorded)


@pytest.mark.parametrize("sack", SACK)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pair_trace_replay_matches_jax(pair_traces, name, sack):
    (jax_out, port_out), n_rec = pair_traces
    i = 2 * list(SCENARIOS).index(name) + (0 if sack else n_rec)
    rows = slice(i, i + 2)
    assert_planes_equal(jax_out[0], port_out[0], rows)
    assert np.array_equal(jax_out[1][:, rows], port_out[1][:, rows])
    assert np.array_equal(jax_out[2][:, rows], port_out[2][:, rows])
    assert port_out[1].dtype == np.int32 and port_out[2].dtype == np.int32


def test_the_traces_reach_the_machine_s_paths(pair_traces):
    """The recorded traces exercise what they are meant to: segments
    pulled and retransmitted, SACK negotiated only where it is on, an
    error from the abort, every lane's PULLs emitting."""
    (_jax_out, (plane, outs, _rets)), n_rec = pair_traces
    assert (outs[:, :, 0] == 1).any(axis=0).all()
    assert plane["retransmit_count"][:n_rec].sum() > 0
    assert plane["sack_ok"][:n_rec].any() and not plane["sack_ok"][n_rec:].any()
    assert (plane["error"] != 0).any()


def random_streams(C, T, seed):
    """Random events on fresh connections: opens first, then every kind
    with fields near the connection's own sequence space."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(1, 12, (C, T)).astype(np.int32)
    kinds[:, 0] = np.where(np.arange(C) % 2, ttcp.EV_OPEN_PASSIVE,
                           ttcp.EV_OPEN_ACTIVE)
    base = rng.integers(-2**31, 2**31 - 1, C)
    fields = np.zeros((C, T, ttcp.N_FIELDS), np.int64)
    fields[:, :, 0] = np.where(rng.random((C, T)) < 0.5,
                               rng.integers(0, 64, (C, T)),
                               rng.integers(0, 8, (C, T)))
    fields[:, :, 1] = base[:, None] + rng.integers(-3000, 200_000, (C, T))
    fields[:, :, 2] = base[:, None] + rng.integers(-3000, 200_000, (C, T))
    fields[:, :, 3] = rng.integers(0, 70_000, (C, T))
    fields[:, :, 4] = np.where(rng.random((C, T)) < 0.5,
                               rng.integers(0, 3000, (C, T)), 0)
    fields[:, :, 5] = rng.integers(-1, 15, (C, T))
    fields[:, :, 6] = rng.integers(0, 5000, (C, T))
    fields[:, :, 7] = rng.integers(0, 5000, (C, T))
    fields[:, :, 8] = rng.integers(0, 2, (C, T))
    fields[:, :, 9] = rng.integers(0, 4, (C, T))
    fields[:, :, 10:] = base[:, None, None] + rng.integers(
        0, 200_000, (C, T, 6))
    fields = ((fields + 2**31) % 2**32 - 2**31).astype(np.int32)
    now_ms = np.sort(rng.integers(0, 10_000, (C, T)), axis=1).astype(
        np.int32)
    return kinds, fields, now_ms


@pytest.mark.parametrize("seed", [0, 1])
def test_random_event_streams_match_jax(seed):
    kinds, fields, now_ms = random_streams(16, 48, seed)
    plane = plane_to_numpy(ttcp.make_tcp_plane(16, reass_slots=8,
                                               device="cpu"))
    plane["sack_on"][::3] = False
    (jp, jo, jr), (tp, to, tr) = both_replays(plane, kinds, fields, now_ms)
    assert_planes_equal(jp, tp)
    assert np.array_equal(jo, to) and np.array_equal(jr, tr)


def one_conn(reass_slots=4):
    return ttcp.make_tcp_plane(1, reass_slots=reass_slots, device="cpu")


def insert(s, off, length):
    return ttcp._reass_insert(s, torch.tensor([off], dtype=torch.int32),
                              torch.tensor([length], dtype=torch.int32))


def test_reass_insert_bridging_segment_no_double_count():
    """A segment bridging two ranges merges them into one slot with the
    exact coverage bytes (`test_tpu_tcp.py:519`)."""
    s = insert(insert(one_conn(), 100, 10), 120, 10)
    assert int(s.reass_bytes) == 20
    s = insert(s, 108, 14)
    assert int(s.reass_bytes) == 30
    live = s.reass_len[0] > 0
    assert int(live.sum()) == 1
    slot = int(torch.argmax(live.to(torch.int32)))
    assert int(s.reass_off[0, slot]) == 100
    assert int(s.reass_len[0, slot]) == 30


def test_reass_insert_bridge_covering_second_range_entirely():
    """A bridging segment that covers the later range frees its slot
    (`test_tpu_tcp.py:539`)."""
    s = insert(insert(insert(one_conn(), 100, 10), 120, 10), 105, 30)
    assert int(s.reass_bytes) == 35
    assert int((s.reass_len[0] > 0).sum()) == 1


def random_slots(rng, C, S):
    off = rng.integers(0, 80, (C, S)).astype(np.int32)
    length = np.where(rng.random((C, S)) < 0.3, 0,
                      rng.integers(1, 20, (C, S))).astype(np.int32)
    at = rng.integers(0, 90, C).astype(np.int32)
    return off, length, at


def test_reass_drain_and_sb_next_closed_forms_match_jax():
    """The coverage fixpoint in closed form against JAX's convergent
    while_loops, on overlapping, touching and chained slot sets."""
    rng = np.random.default_rng(11)
    C, S = 256, 8
    off, length, at = random_slots(rng, C, S)
    plane = plane_to_numpy(ttcp.make_tcp_plane(C, reass_slots=S,
                                               device="cpu"))
    plane.update(reass_off=off, reass_len=length, rcv_nxt=at)
    jp = jtcp.TcpPlane(**{
        f: jnp.asarray(v.astype(np.uint32) if f in ttcp.U32_FIELDS else v)
        for f, v in plane.items()})
    j_s, j_adv = jax.jit(jax.vmap(jtcp._reass_drain))(jp)
    t_s, t_adv = ttcp._reass_drain(torch_plane(plane))
    assert_planes_equal(plane_to_numpy(j_s), plane_to_numpy(t_s))
    assert np.array_equal(np.asarray(j_adv), t_adv.numpy())

    ss, ln, at = random_slots(rng, C, ttcp.SACK_SLOTS)
    se = (ss + ln - np.where(rng.random(ss.shape) < 0.1, 25, 0)).astype(
        np.int32)
    j_off, j_cap = jax.jit(jax.vmap(jtcp._sb_next))(ss, se, at)
    t_off, t_cap = ttcp._sb_next(*map(torch.from_numpy, (ss, se, at)))
    assert np.array_equal(np.asarray(j_off), t_off.numpy())
    assert np.array_equal(np.asarray(j_cap), t_cap.numpy())


def test_retransmits_by_host_sums_the_sending_hosts():
    plane = ttcp.make_tcp_plane(6, device="cpu")
    plane = plane._replace(retransmit_count=torch.tensor(
        [1, 2, 3, 4, 5, 6], dtype=torch.int32))
    host = torch.tensor([0, 1, 1, 2, 0, 5], dtype=torch.int32)
    got = ttcp.retransmits_by_host(plane, host, 3)
    want = jtcp.retransmits_by_host(
        jtcp.make_tcp_plane(6)._replace(
            retransmit_count=jnp.arange(1, 7, dtype=jnp.int32)),
        jnp.asarray(host.numpy()), 3)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist() == [6, 5, 4]

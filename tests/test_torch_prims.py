"""The port's bitwise primitives against the JAX plane's.

`shadow_tpu_torch.tpu.prims` carries uint32 words as int64 and wraps
int32 explicitly; every helper must give exactly the JAX values: the
threefry-2x32 loss draw (counters near I32_MAX included), the packed
sort keys and the stable row sort, floor division/modulo at negative
values, and the int32 wrap of the PHOLD respawn hash.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.extend import random as jex_random  # noqa: E402

from shadow_tpu.tpu import plane  # noqa: E402
from shadow_tpu.workloads.phold import respawn_batch  # noqa: E402
from shadow_tpu_torch.tpu import prims  # noqa: E402
from shadow_tpu_torch.workloads import phold as tphold  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 3, 12345, -7, I32_MAX])
def test_key_data_matches_jax(seed):
    kd = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert tuple(int(x) for x in kd) == prims.key_data(seed)


def test_threefry_matches_jax_primitive():
    rng = np.random.default_rng(0)
    key = tuple(int(x) for x in rng.integers(0, 2**32, 2, dtype=np.uint64))
    words = rng.integers(0, 2**32, 2 * 999, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jex_random.threefry_2x32(
        jnp.asarray(key, jnp.uint32), jnp.asarray(words)))
    a, b = prims.threefry_2x32(key, t(words[:999].astype(np.int64)),
                               t(words[999:].astype(np.int64)))
    got = np.concatenate([a.numpy(), b.numpy()]).astype(np.uint32)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed", [1, 3, -7])
def test_pkt_uniform_matches_jax_bitwise(seed):
    rng = np.random.default_rng(seed & 0xFF)
    shape = (37, 16)
    host = rng.integers(0, 40000, shape).astype(np.int32)
    counter = rng.integers(0, 1000, shape).astype(np.int32)
    # counters at and around the int32 edge, as the window step's
    # rng_counter + column produces when it wraps
    counter[0, :] = I32_MAX - np.arange(16, dtype=np.int32)
    counter[1, :] = (np.int64(I32_MAX) + np.arange(16) + 1 - 2**32)
    counter[2, :] = I32_MIN + np.arange(16, dtype=np.int32)
    ref = np.asarray(plane._pkt_uniform(jax.random.key(seed),
                                        jnp.asarray(host),
                                        jnp.asarray(counter)))
    got = prims._pkt_uniform(seed, t(host), t(counter))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    # the window step's int64 counter (rng_counter + col, not wrapped)
    # reads the same bits as the wrapped int32 counter
    wide = t(np.int64(I32_MAX) + np.arange(16))[None, :].expand(37, 16)
    wrapped = prims.wrap_i32(wide)
    h = t(host)
    assert torch.equal(prims._pkt_uniform(seed, h, wide),
                       prims._pkt_uniform(seed, h, wrapped))


def test_packed_keys_match_jax():
    rng = np.random.default_rng(1)
    shape = (9, 32)
    valid = rng.random(shape) < 0.6
    key = rng.integers(0, 50, shape).astype(np.int32)
    key[0, :4] = I32_MAX
    tm = rng.integers(I32_MIN, I32_MAX, shape, dtype=np.int64).astype(np.int32)
    rank = np.broadcast_to(np.arange(32, dtype=np.int32), shape)
    j, p = jnp.asarray, prims
    pairs = [
        (plane._pack_valid_key(j(valid), j(key)),
         p._pack_valid_key(t(valid), t(key))),
        (plane._pack_time_key(j(valid), j(tm)),
         p._pack_time_key(t(valid), t(tm))),
        (plane._pack_rank_key(j(valid), j(rank), 32),
         p._pack_rank_key(t(valid), t(rank), 32)),
    ]
    for ref, got in pairs:
        assert got.dtype == torch.int64
        assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())
    with pytest.raises(ValueError, match="bit-budget overflow"):
        p._pack_rank_key(t(valid), t(rank), 2**32)


def test_row_perm_sort_matches_jax():
    """Stable row sort with duplicate keys, alone and with an extra
    tiebreak key."""
    rng = np.random.default_rng(2)
    shape = (11, 16)
    valid = rng.random(shape) < 0.7
    prio = rng.integers(0, 4, shape).astype(np.int32)  # many ties
    extra = rng.integers(-3, 3, shape).astype(np.int32)
    packed_j = plane._pack_time_key(jnp.asarray(valid), jnp.asarray(prio))
    packed_t = prims._pack_time_key(t(valid), t(prio))
    ref = np.asarray(plane._row_perm_sort(packed_j))
    assert np.array_equal(prims._row_perm_sort(packed_t).numpy(), ref)
    ref2 = np.asarray(plane._row_perm_sort(packed_j, jnp.asarray(extra)))
    got2 = prims._row_perm_sort(packed_t, t(extra))
    assert np.array_equal(got2.numpy(), ref2)


def test_floor_division_and_modulo_at_negative_values():
    x = np.array([-2_000_001, -1_000_000, -999_999, -1, 0, 1, 999_999,
                  1_000_000, 2_500_000, I32_MIN, I32_MAX], np.int32)
    for d in (1_000_000, 7, 1400):
        ref_div = np.asarray(jnp.asarray(x) // d)
        ref_mod = np.asarray(jnp.asarray(x) % d)
        assert np.array_equal(prims.floordiv(t(x), d).numpy(), ref_div)
        assert np.array_equal(prims.floormod(t(x), d).numpy(), ref_mod)
        for v in (-2_500_000, -1, 0, 3_000_001):
            assert prims.floordiv(v, d) == int(jnp.int32(v) // d)
            assert prims.floormod(v, d) == int(jnp.int32(v) % d)


def test_wrap_i32_is_twos_complement():
    x = np.array([0, I32_MAX, I32_MAX + 1, -1, I32_MIN, I32_MIN - 1,
                  2**40 + 5, -(2**40) - 5, 3 * 2**31], np.int64)
    assert np.array_equal(prims.wrap_i32(t(x)).numpy(), x.astype(np.int32))
    assert prims.wrap_i32(t(x)).dtype == torch.int32


def test_respawn_hash_wraps_like_jax():
    """src*40503 + seq*1566083941 + round*97 overflows int32 for most
    inputs; the destination, seq rank and masks must match JAX."""
    rng = np.random.default_rng(4)
    n, ci = 50, 16
    delivered = {
        "mask": rng.random((n, ci)) < 0.4,
        "src": rng.integers(0, n, (n, ci)).astype(np.int32),
        "seq": rng.integers(0, I32_MAX, (n, ci)).astype(np.int32),
    }
    spawn = rng.integers(10_000, 20_000, n).astype(np.int32)
    for round_idx in (0, 5, 191, 22_000_000):
        ref = respawn_batch({k: jnp.asarray(v) for k, v in delivered.items()},
                            jnp.asarray(spawn), jnp.int32(round_idx), n, ci)
        got = tphold.respawn_batch({k: t(v) for k, v in delivered.items()},
                                   t(spawn), round_idx, n, ci)
        for r, g in zip(ref, got):
            assert np.array_equal(np.asarray(r), g.numpy()), round_idx
            assert np.asarray(r).dtype == g.numpy().dtype

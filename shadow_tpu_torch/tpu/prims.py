"""Bitwise primitives the device plane relies on, in PyTorch.

The JAX plane sorts packed uint32 keys and wraps int32 arithmetic.
PyTorch's uint32 coverage is thin (no sort, few kernels on CUDA), so a
32-bit word is carried here as an int64 tensor holding its unsigned
value in [0, 2**32), and goes back to int32 through `wrap_i32`, whose
two's-complement wrap is explicit rather than left to a cast. Floor
division and modulo follow Python/jnp (round toward minus infinity):
`floordiv` and `floormod`, never `fmod`.

A JAX key is carried either as the int seed of `jax.random.key(seed)`
or as a key tensor, int64 [2] holding the two uint32 words of
`jax.random.key_data` (`key_tensor`); `fold_in` derives one key from
another as `jax.random.fold_in` does, and the threefry draws take
either form, so a per-world key can ride a batched carry on the device.

Counterparts: `shadow_tpu/tpu/plane.py:245-349` (`_pack_*_key`,
`_row_perm_sort`, `_pkt_uniform`), `jax.random.fold_in`.
"""

from __future__ import annotations

import torch

I32_MAX = 2**31 - 1
# eg_clamp sentinel: "clamp to the end of whatever window processes it"
NO_CLAMP = -(2**30)
_SIGN32 = 0x80000000
_U32_MAX = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an int32 (or int64) tensor, as int64."""
    return x.to(torch.int64) & _U32_MAX


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32, two's complement, without relying on
    the cast's behaviour out of range."""
    return (((x + _SIGN32) & _U32_MAX) - _SIGN32).to(torch.int32)


def floordiv(x, d):
    """jnp `//` on int tensors or Python ints (floor, not truncation)."""
    if isinstance(x, torch.Tensor):
        return torch.div(x, d, rounding_mode="floor")
    return x // d


def floormod(x, d):
    """jnp `%` on int tensors or Python ints (sign of the divisor)."""
    if isinstance(x, torch.Tensor):
        return torch.remainder(x, d)
    return x % d


def take(a: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """`jnp.take_along_axis(a, perm, axis=1)`."""
    return torch.gather(a, 1, perm)


def scatter_add_i32(n: int, idx, values) -> torch.Tensor:
    """[n] int32 sums of `values` at `idx`, index n dropped (the JAX
    `.at[].add(mode="drop")` with the drop slot at n). Integer adds, so
    the order of the atomics does not matter."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.reshape(-1).to(torch.int64),
                   values.reshape(-1).to(torch.int32))
    return out[:n]


def _assert_bit_budget(*fields):
    """The named (bits, what) fields must fit one 32-bit packed key."""
    total = sum(bits for bits, _ in fields)
    if total > 32:
        raise ValueError(
            "packed sort key bit-budget overflow: "
            + " + ".join(f"{what}={bits}b" for bits, what in fields)
            + f" = {total} bits > 32")


def _pack_valid_key(valid, key, *, what="qdisc key"):
    """(invalid-last, key) as one uint32 key: validity in bit 31, the
    int32 key's bit pattern OR-ed below (order-exact for keys >= 0)."""
    _assert_bit_budget((1, "validity"), (31, what))
    return torch.where(valid, 0, _SIGN32) | u32(key)


def _pack_time_key(valid, t):
    """(invalid-last, full-range int32 time) as one uint32 key: the time
    sign-biased into unsigned order, invalid slots all-ones."""
    return torch.where(valid, u32(t) ^ _SIGN32, _U32_MAX)


def _pack_rank_key(valid, rank, width: int):
    """(invalid-last, column rank) as one uint32 key; `width` is the
    column count the rank field must hold."""
    rank_bits = max(int(width - 1).bit_length(), 1)
    _assert_bit_budget((1, "validity"), (rank_bits, f"rank[{width}]"))
    return torch.where(valid, 0, _SIGN32) | u32(rank)


def _row_perm_sort(packed, *extra_keys):
    """Stable row sort by (packed [, extra keys...]); returns the int64
    permutation [N, C] for `take`. Each later key is a tiebreak, and the
    stable passes (least significant key first) break the remaining ties
    by column, exactly like the stable variadic sort."""
    keys = (packed, *extra_keys)
    perm = None
    for key in reversed(keys):
        k = key if perm is None else take(key, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else take(perm, idx)
    return perm


# --- threefry-2x32 (the JAX default PRNG's block cipher) -------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_data(seed: int) -> tuple[int, int]:
    """`jax.random.key_data(jax.random.key(seed))` for a 32-bit seed:
    (seed >> 32, seed & 0xFFFFFFFF) with the int32 seed's logical shift
    giving 0."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must fit int32, got {seed}")
    return 0, seed & _U32_MAX


def key_tensor(seed: int, device=None) -> torch.Tensor:
    """The key of `jax.random.key(seed)` as a tensor: int64 [2] holding
    its two uint32 words, `jax.random.key_data`'s layout. A window step
    takes it where it takes the int seed, and draws the same bits."""
    return torch.tensor(key_data(seed), dtype=torch.int64, device=device)


def key_words(key):
    """The two uint32 words of a key: a Python int seed (`key_data`) or a
    key tensor whose last axis holds the words (under `torch.func.vmap`,
    each world's [2]). Tensor words come back as int64 tensors of the
    key's leading shape, so a batched key rides the step unread."""
    if isinstance(key, torch.Tensor):
        if key.shape[-1:] != (2,):
            raise ValueError(f"a key tensor holds 2 words on its last axis, "
                             f"got shape {tuple(key.shape)}")
        words = key.to(torch.int64) & _U32_MAX
        return words[..., 0], words[..., 1]
    return key_data(key)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _U32_MAX


def threefry_2x32(key, x0: torch.Tensor,
                  x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the word pairs (x0, x1), each an
    int64 tensor of uint32 values; returns the two output words. `key` is
    the pair of key words, Python ints or int64 tensors that broadcast
    against the blocks (`key_words`)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & _U32_MAX
    b = (x1 + ks[1]) & _U32_MAX
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _U32_MAX
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _U32_MAX
        b = (b + ks[(i + 2) % 3] + i + 1) & _U32_MAX
    return a, b


def fold_in(key, data) -> torch.Tensor:
    """`jax.random.key_data(jax.random.fold_in(key, data))`, bitwise: the
    threefry-2x32 block (0, data) under `key` (an int seed or a key
    tensor, see `key_words`), its two output words the new key. `data`
    is an int or an int tensor of any shape, taken as its uint32 bits
    (JAX's int32 arrays go so; JAX refuses a negative Python int, this
    takes its int32 bits too). Returns int64 [..., 2]."""
    if isinstance(data, torch.Tensor):
        x1 = u32(data)
        dev = data.device
    else:
        if not -(2**31) <= data < 2**32:
            raise ValueError(f"fold_in data must fit 32 bits, got {data}")
        dev = key.device if isinstance(key, torch.Tensor) else None
        x1 = torch.tensor(data & _U32_MAX, dtype=torch.int64, device=dev)
    k0, k1 = key_words(key)
    a, b = threefry_2x32((k0, k1), torch.zeros_like(x1), x1)
    return torch.stack([a, b], dim=-1)


def _pkt_uniform(seed, host: torch.Tensor,
                 counter: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform [0, 1) per (host, counter) slot, bitwise the
    JAX plane's draw under `jax.random.key(seed)`, or under the key
    `seed` when it is a key tensor (`key_words`): JAX hashes
    concat(host, counter) by splitting the count array into halves, so
    slot i's block is (host[i], counter[i]) and its first output word is
    the slot's bits. 24 high bits -> float32."""
    bits, _ = threefry_2x32(key_words(seed), u32(host), u32(counter))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))

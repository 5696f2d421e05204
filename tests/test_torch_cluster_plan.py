"""A numpy model of kernels A's and C's cluster build
(`shadow_tpu_torch/csrc/row_bitonic.cuh`: `cluster_sort`, `wide_sort`,
`wide_merge`, `cross_stage`, `sorted_columns`, `cluster_gate`), held
against a stable `np.argsort` and a wrapping cumulative sum.

The kernel cuts a row of CE slots into blocks of S slots, one block of a
thread-block cluster each, and runs the row's bitonic network as the
model below does: the merges of size up to S within each block, then
each wider merge's strides that span blocks (a cluster barrier a stage,
the lower block of a pair taking the first half of the local slots and
the upper the second) before its strides within a block; every pair's
direction comes from the row index of its lower slot (block rank x S +
local index). The sorted slots' validity is the count of valid keys
(they sort first), and the token gate's prefix in each block starts from
the uint32 sum of the lower-ranked blocks' totals. The model runs at the
build's geometries (2 blocks of 16384 slots, 8 of 8192; and 4 of 16384,
the other one timed at 65536) and at stand-in widths of 4 and 2 slots a
block (2, 4 and 8 blocks a cluster).
The card holds the kernels themselves to their plain versions
(`tests/test_torch_cuda.py`, `chip_smoke.py` 3 (d)/4 (d)).
"""

from __future__ import annotations

import numpy as np
import pytest

SIGN = np.uint64(1 << 31)
LOW32 = np.uint64(0xFFFFFFFF)


def schedule(ce: int, s: int) -> list[tuple[int, int, str]]:
    """The network's stages over a row of `ce` slots in blocks of `s`, in
    the kernel's order: (log2 merge size, log2 stride, "block" for a
    stride within a block or "cluster" for one that spans blocks)."""
    log_ce, log_s = ce.bit_length() - 1, s.bit_length() - 1
    return [(ls, lt, "cluster" if lt >= log_s else "block")
            for ls in range(1, log_ce + 1) for lt in range(ls - 1, -1, -1)]


def exchange(x, y, asc):
    swap = (x > y) == asc
    return np.where(swap, y, x), np.where(swap, x, y)


def cluster_sort(words: np.ndarray, s: int, row_index: bool = True):
    """The kernel's network over one row's uint64 (key << 32 | column)
    words, block by block as a cluster runs it; `row_index=False` takes
    each direction from the slot's index in its block instead (the
    mistake the row index avoids). Returns the sorted row."""
    blocks = [b.copy() for b in np.split(words, len(words) // s)]
    local = np.arange(s)
    for ls, lt, where in schedule(len(words), s):
        size, stride = 1 << ls, 1 << lt
        if where == "block":
            a = local[(local & stride) == 0]
            for rank, blk in enumerate(blocks):
                off = rank * s if row_index else 0
                blk[a], blk[a | stride] = exchange(
                    blk[a], blk[a | stride], ((off | a) & size) == 0)
        else:
            apart = stride // s
            for rank in range(len(blocks)):
                lo, hi = rank & ~apart, (rank & ~apart) | apart
                half = local[:s // 2] + (s // 2 if rank & apart else 0)
                asc = ((lo * s if row_index else 0) & size) == 0
                blocks[lo][half], blocks[hi][half] = exchange(
                    blocks[lo][half], blocks[hi][half], asc)
    return np.concatenate(blocks)


def sorted_columns(sorted_words: np.ndarray, s: int):
    """Each block's 16-bit source columns and its count of valid slots
    (keys with the top bit clear), as `sorted_columns` keeps them."""
    cols = (sorted_words & LOW32).astype(np.uint32)
    assert (cols < 1 << 16).all()
    valid = ((sorted_words >> np.uint64(32)) & SIGN) == 0
    return (cols & 0xFFFF).astype(np.uint16), [
        int(v.sum()) for v in np.split(valid, len(valid) // s)]


def cluster_gate(n_valid: list[int], nbytes_s: np.ndarray, bal: int,
                 s: int):
    """The kernel's token gate over a sorted row: each block's first
    n_valid[r] slots valid, its inclusive prefix started from the uint32
    sum of the lower ranks' totals. Returns (sendable, spent)."""
    blocks = np.split(nbytes_s.astype(np.uint32), len(nbytes_s) // s)
    valid = [np.arange(s) < n for n in n_valid]
    totals = np.array([b[v].sum(dtype=np.uint32)
                       for b, v in zip(blocks, valid)], np.uint32)
    sendable, sent = [], []
    for rank, (b, v) in enumerate(zip(blocks, valid)):
        first = totals[:rank].sum(dtype=np.uint32)
        cum = np.cumsum(np.concatenate([[first], np.where(v, b, 0)]),
                        dtype=np.uint32)[1:]
        ok = v & (cum.view(np.int32) <= bal)
        sendable.append(ok)
        sent.append(b[ok].sum(dtype=np.uint32))
    spent = np.array(sent, np.uint32).sum(dtype=np.uint32)
    return np.concatenate(sendable), int(spent.view(np.int32))


def row_inputs(ce: int, seed: int):
    """One row's FIFO keys (validity in bit 31, priorities with many ties
    and some negative: those read as invalid) and int32 bytes up to
    2^31 - 1, so the prefix wraps."""
    rng = np.random.default_rng(seed)
    valid = rng.random(ce) < 0.7
    prio = rng.choice(np.array([-7, -1, 0, 1, 2, 3, 2**31 - 1],
                               np.int32), ce)
    key = np.where(valid, 0, 1 << 31).astype(np.uint32) | prio.view(np.uint32)
    nbytes = rng.integers(0, 2**31, ce).astype(np.int32)
    if seed % 2:
        nbytes = rng.integers(60, 1500, ce).astype(np.int32)
    bal = int(rng.integers(-2**31, 2**31))
    return key, nbytes, bal


GEOMETRIES = [(4, 2), (4, 4), (4, 8), (2, 2), (2, 4), (2, 8),
              (16384, 2), (8192, 8), (16384, 4)]


@pytest.mark.parametrize("s,blocks", GEOMETRIES)
def test_cluster_schedule_crosses_blocks_where_strides_span_them(s, blocks):
    """The stages that span blocks are the first log2(C) of each merge
    past a block's span: log2(C)(log2(C) + 1) / 2 a network (1 for 2
    blocks, 3 for 4, 6 for 8), each pairing blocks stride / S ranks
    apart; every other stage stays within a block; the network is the
    full bitonic one."""
    ce = s * blocks
    stages = schedule(ce, s)
    lg, lc = ce.bit_length() - 1, blocks.bit_length() - 1
    assert len(stages) == lg * (lg + 1) // 2
    cross = [(ls, lt) for ls, lt, where in stages if where == "cluster"]
    assert len(cross) == lc * (lc + 1) // 2 == {2: 1, 4: 3, 8: 6}[blocks]
    for ls, lt in cross:
        assert ls > s.bit_length() - 1 and (1 << lt) >= s
        assert 1 <= (1 << lt) // s < blocks


@pytest.mark.parametrize("s,blocks", GEOMETRIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_network_is_the_stable_sort(s, blocks, seed):
    """The model's network over (key, column) words equals a stable
    argsort of the keys, ties broken by column; the columns fit the 16
    bits the cluster build keeps (up to 65535), and each block's count
    of valid keys marks its valid sorted slots."""
    ce = s * blocks
    key, _, _ = row_inputs(ce, seed)
    words = (key.astype(np.uint64) << np.uint64(32)) | np.arange(
        ce, dtype=np.uint64)
    got = cluster_sort(words, s)
    want = np.argsort(key, kind="stable")
    np.testing.assert_array_equal((got & LOW32).astype(np.int64), want)
    cols, n_valid = sorted_columns(got, s)
    np.testing.assert_array_equal(cols.astype(np.int64), want)
    valid_s = (key[want] >> 31) == 0
    assert valid_s[:int(valid_s.sum())].all()
    np.testing.assert_array_equal(
        np.concatenate([np.arange(s) < n for n in n_valid]), valid_s)


@pytest.mark.parametrize("s,blocks", [g for g in GEOMETRIES if g[0] < 8192])
def test_cluster_directions_come_from_the_row_index(s, blocks):
    """Taking each direction from the slot's index in its block (its
    rank dropped) does not sort the row: the row index is what makes the
    blocks' sorted runs merge."""
    ce = s * blocks
    unsorted = 0
    for seed in range(6):
        key, _, _ = row_inputs(ce, seed)
        words = (key.astype(np.uint64) << np.uint64(32)) | np.arange(
            ce, dtype=np.uint64)
        got = cluster_sort(words, s, row_index=False)
        unsorted += not (np.diff(got.astype(np.float64)) >= 0).all()
    assert unsorted


@pytest.mark.parametrize("s,blocks", GEOMETRIES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_gate_prefix_crosses_blocks_as_a_wrapping_cumsum(s, blocks,
                                                                 seed):
    """The gate's blocks, each prefix started from the lower ranks' uint32
    totals, give the row's wrapping inclusive cumulative sum of valid
    bytes: sendable = valid and int32(cum) <= balance, and the uint32
    sum of the sendable bytes as spent."""
    ce = s * blocks
    key, nbytes, bal = row_inputs(ce, seed)
    words = (key.astype(np.uint64) << np.uint64(32)) | np.arange(
        ce, dtype=np.uint64)
    order = (cluster_sort(words, s) & LOW32).astype(np.int64)
    _, n_valid = sorted_columns(cluster_sort(words, s), s)
    nbytes_s = nbytes[order]
    valid_s = (key[order] >> 31) == 0
    got_send, got_spent = cluster_gate(n_valid, nbytes_s, bal, s)
    cum = np.cumsum(np.where(valid_s, nbytes_s.astype(np.uint64), 0)) \
        % (1 << 32)
    want_send = valid_s & (cum.astype(np.uint32).view(np.int32) <= bal)
    want_spent = int(np.uint32(nbytes_s[want_send].astype(np.uint64).sum()
                               % (1 << 32)).view(np.int32))
    np.testing.assert_array_equal(got_send, want_send)
    assert got_spent == want_spent

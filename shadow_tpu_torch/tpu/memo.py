"""Steady-state memoization and fast-forward for the chained driver.

Counterpart of `shadow_tpu/tpu/memo.py`: the chain span is the memo
unit of `elastic.drive_chained_windows`.

- At every chain boundary the whole carry (net-plane state and every
  extras plane) is copied to the host in the JAX package's dtypes
  (`convert.carry_to_host`, one synchronise) and digested into a key,
  with the span's length and alignment, the caller's static salt
  (program digest, world fingerprint, knobs) and the per-span salt (the
  fault schedule's span fingerprint). The same carry gives the JAX
  memo's key, byte for byte.
- A hit replays the recorded post-span carry instead of running it:
  keyed leaves are substituted byte for byte; the declared modular
  counters (`COUNTER_LEAVES`) get the recorded uint32 delta wrap-added
  (`telemetry/harvest.counter_delta`/`apply_counter_delta`).
- A miss runs the span and records (post snapshot, counter deltas),
  within an LRU byte budget.

Every leaf not declared a counter is keyed, so a new plane leaf lands in
the key (fewer hits, never a stale replay). Spans that stamp keyed
leaves from excluded inputs (a guard's first violation window, a flight
recorder append) are never recorded (`STABILITY_FIELDS`). The default
`key_extra` folds the absolute start round into every key; a caller
that can prove round-translation invariance overrides it.

Between consecutive hits the driver touches no tensor: replay is numpy
on the host, uploaded only when a miss must run or an `on_chain` hook
needs the tensors. The cache outlives a run: `save`/`load` write it as
one atomic self-verifying ``.npz`` (`faults/checkpoint`), and
`spill`/`absorb` embed it in a full-run checkpoint
(`faults/runstate.py`); `absorb` refuses a cache minted under another
salt.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import carry_to_device, carry_to_host
from ..faults import checkpoint as ckpt
from ..faults.checkpoint import CheckpointError
from ..telemetry.harvest import apply_counter_delta, counter_delta

__all__ = [
    "COUNTER_LEAVES", "MEMO_SCHEMA", "STABILITY_FIELDS", "ChainMemo",
    "walk_carry",
]

#: schema stamp for persisted caches (`write_npz_checkpoint` refuses a
#: mismatch before any entry is trusted)
MEMO_SCHEMA = "chainmemo-v1"

#: instance counters `spill` serializes and `absorb(restore=True)`
#: reproduces verbatim — the memoized kill/resume parity surface
_COUNTER_ATTRS = (
    "lookups", "hits", "misses", "records", "evictions",
    "unstable_skips", "oversize_skips", "fast_forwarded_windows",
    "peak_bytes", "loaded_entries", "persisted_hits",
)

#: (NamedTuple class name) -> field names excluded from the memo key
#: and replayed as modular uint32 deltas. Declaration rules:
#: observability accumulators that are presence-invisible to the
#: simulation (metrics, histograms, guard
#: tallies, flight-recorder cursors) plus counters the step only ever
#: wrap-adds (net-plane totals) and the flow plane's virtual clock
#: (translation-covariant; folded raw into the key by the caller's
#: `key_extra` whenever any flow could read it). EVERYTHING else is
#: keyed byte-for-byte — the safe default a new plane leaf gets.
COUNTER_LEAVES: dict[str, frozenset[str]] = {
    "NetPlaneState": frozenset({
        "n_sent", "n_loss_dropped", "n_overflow_dropped",
        "n_delivered", "n_fault_dropped",
    }),
    # all of PlaneMetrics EXCEPT the high-water marks: maxima are not
    # delta-applicable (harvest.MAX_FIELDS aggregates them with max),
    # and in steady state they are constant — so they stay keyed and
    # replay by substitution
    "PlaneMetrics": frozenset({
        "pkts_out", "bytes_out", "pkts_in", "bytes_in",
        "drop_ring_full", "drop_qdisc", "drop_loss", "drop_fault",
        "retransmits", "windows", "events", "sort_slots",
    }),
    "PlaneHistograms": frozenset({
        "hist_delivery_ns", "hist_sojourn_ns", "hist_qdepth",
    }),
    # violations/first_window/flags stay KEYED (latches, constant in
    # steady state) and double as the record-stability witness below
    "GuardState": frozenset({"windows", "checks"}),
    # the ring contents (ev_*) stay keyed; an event append moves the
    # cursor, which refuses the record (STABILITY_FIELDS)
    "FlightRecArrays": frozenset({"cursor", "win"}),
    "FlowState": frozenset({
        "retransmit_count", "retransmitted_bytes", "rto_fired",
        "clock_ms",
    }),
}

#: (NamedTuple class name) -> fields that must be byte-identical
#: between a span's pre and post snapshots for the span to be
#: RECORDED. These are keyed leaves whose in-span writes embed values
#: of excluded leaves (GuardState.first_window stamps .windows; the
#: flight recorder's ev_win stamps .win at the .cursor position) — a
#: span that moved them is not translation-stable and must never be
#: replayed elsewhere.
STABILITY_FIELDS: dict[str, frozenset[str]] = {
    "GuardState": frozenset({"violations", "first_window", "flags"}),
    "FlightRecArrays": frozenset({"cursor"}),
}

_I32_MAX = np.int32(2**31 - 1)
_NO_CLAMP = np.int32(-(2**30))  # tpu.plane.NO_CLAMP


def _canonical_netplane_np(state):
    """Host-side mirror of `elastic.canonical_state`: normalize dead
    ring lanes to the `make_state` defaults so two carries differing
    only in compaction garbage digest equal (byte-equal to
    `elastic.canonical_state` on the device)."""
    ev = np.asarray(state.eg_valid)
    iv = np.asarray(state.in_valid)
    w = lambda mask, arr, fill: np.where(
        mask, arr, np.asarray(fill, dtype=np.asarray(arr).dtype))
    return state._replace(
        eg_dst=w(ev, state.eg_dst, -1),
        eg_bytes=w(ev, state.eg_bytes, 0),
        eg_prio=w(ev, state.eg_prio, _I32_MAX),
        eg_seq=w(ev, state.eg_seq, 0),
        eg_ctrl=np.asarray(state.eg_ctrl) & ev,
        eg_tsend=w(ev, state.eg_tsend, 0),
        eg_clamp=w(ev, state.eg_clamp, _NO_CLAMP),
        eg_sock=w(ev, state.eg_sock, 0),
        in_src=w(iv, state.in_src, -1),
        in_bytes=w(iv, state.in_bytes, 0),
        in_seq=w(iv, state.in_seq, 0),
        in_sock=w(iv, state.in_sock, 0),
        in_deliver_rel=w(iv, state.in_deliver_rel, _I32_MAX),
    )


#: class name -> host-side canonicalizer applied before DIGESTING (the
#: recorded post snapshots stay raw — replay substitutes real bytes)
_CANONICALIZERS: dict[str, Callable] = {
    "NetPlaneState": _canonical_netplane_np,
}


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _tensor_leaves(carry):
    """The tensors of a carry, in traversal order."""
    if isinstance(carry, torch.Tensor):
        yield carry
    elif isinstance(carry, (tuple, list)):
        for v in carry:
            yield from _tensor_leaves(v)
    elif isinstance(carry, dict):
        for k in sorted(carry):
            yield from _tensor_leaves(carry[k])


def walk_carry(carry, *, canonical: bool = False):
    """Flatten a chain carry into ``[(owner, field, np.ndarray)]`` in
    deterministic traversal order. `owner` is the immediate NamedTuple
    class name ("" for anonymous tuple positions — always keyed).
    With ``canonical=True``, registered canonicalizers rewrite their
    node before its leaves are emitted (digest view only). None
    subtrees (disabled presence planes) vanish, exactly as they do in
    the JAX package's tree flattening."""
    out: list[tuple[str, str, np.ndarray]] = []

    def rec(node, owner: str, name: str):
        if node is None:
            return
        if _is_namedtuple(node):
            cls = type(node).__name__
            if canonical and cls in _CANONICALIZERS:
                node = _CANONICALIZERS[cls](node)
            for fname, val in zip(node._fields, node):
                rec(val, cls, fname)
            return
        if isinstance(node, (tuple, list)):
            for i, val in enumerate(node):
                rec(val, owner, f"{name}[{i}]")
            return
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], owner, f"{name}.{k}")
            return
        out.append((owner, name, np.asarray(node)))

    rec(carry, "", "")
    return out


def classify(owner: str, field: str) -> str:
    """'counter' for declared modular leaves, 'keyed' for everything
    else (the safe default a new plane leaf gets)."""
    if field in COUNTER_LEAVES.get(owner, ()):  # pragma: no branch
        return "counter"
    return "keyed"


class _Entry:
    __slots__ = ("post_keyed", "deltas", "nbytes", "span_len", "hits",
                 "persisted")

    def __init__(self, post_keyed, deltas, nbytes, span_len,
                 persisted=False):
        self.post_keyed = post_keyed
        self.deltas = deltas
        self.nbytes = nbytes
        self.span_len = span_len
        self.hits = 0
        self.persisted = persisted


class ChainMemo:
    """Chain-boundary memo table for `drive_chained_windows`.

    ``salt`` folds the caller's static world identity into every key
    (scenario fingerprint, program digest, knob settings — everything
    the chain closure captures that the carry does not show).
    ``key_extra(carry_host, r0)`` returns extra key bytes computed
    from the live carry: the default folds the absolute start round
    (safe — no cross-span hits); callers with a proven
    round-translation-invariance predicate override it.
    ``min_repeat`` is how many times a key must MISS before its span
    is recorded (1 = record on first sight). ``max_bytes`` bounds the
    recorded bytes, LRU-evicted."""

    def __init__(self, *, max_bytes: int = 64 << 20,
                 min_repeat: int = 1, salt: bytes = b"",
                 key_extra: Optional[Callable] = None):
        if max_bytes < 1:
            raise ValueError("memo max_bytes must be >= 1")
        if min_repeat < 1:
            raise ValueError("memo min_repeat must be >= 1")
        self.max_bytes = int(max_bytes)
        self.min_repeat = int(min_repeat)
        self.salt = bytes(salt)
        self.key_extra = (key_extra if key_extra is not None
                          else (lambda carry, r0: b"r0:%d" % r0))
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._seen: OrderedDict[str, int] = OrderedDict()
        self.bytes_cached = 0
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.records = 0
        self.evictions = 0
        self.unstable_skips = 0
        self.oversize_skips = 0
        self.fast_forwarded_windows = 0
        self.peak_bytes = 0
        self.loaded_entries = 0
        self.persisted_hits = 0
        self.device = torch.device("cpu")

    # -- snapshot / key ---------------------------------------------------

    def snapshot(self, state, extras):
        """Pull the full carry to the host in the JAX package's dtypes,
        with one synchronise per chain boundary
        (`convert.carry_to_host`). Remembers the device the carry lives
        on, for `to_device`."""
        for leaf in _tensor_leaves((state, extras)):
            self.device = leaf.device
            break
        return carry_to_host((state, extras))

    def key(self, carry_host, r0: int, r1: int,
            span_salt: bytes = b""):
        """Digest the canonicalized carry + span shape + salts.
        Returns ``(hexdigest, raw_walk)`` — the raw (uncanonicalized)
        walk is what `record`/`replay` consume, so the pre-walk rides
        along for free."""
        h = hashlib.sha256()
        h.update(self.salt)
        h.update(b"|span:%d" % (r1 - r0))
        h.update(b"|first:%d" % int(r0 == 0))
        h.update(b"|" + bytes(span_salt))
        h.update(b"|" + bytes(self.key_extra(carry_host, r0)))
        for owner, field, leaf in walk_carry(carry_host,
                                             canonical=True):
            h.update(b"|%s.%s:%s:%s:" % (
                owner.encode(), field.encode(),
                str(leaf.dtype).encode(), repr(leaf.shape).encode()))
            if classify(owner, field) == "keyed":
                h.update(np.ascontiguousarray(leaf).tobytes())
        return h.hexdigest(), walk_carry(carry_host)

    # -- lookup / record / replay ----------------------------------------

    def lookup(self, key: str):
        self.lookups += 1
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            self._seen[key] = self._seen.get(key, 0) + 1
            self._seen.move_to_end(key)
            while len(self._seen) > 65536:
                self._seen.popitem(last=False)
            return None
        self.hits += 1
        entry.hits += 1
        if entry.persisted:
            self.persisted_hits += 1
        self.fast_forwarded_windows += entry.span_len
        self._entries.move_to_end(key)
        return entry

    def record(self, key: str, pre_walk, post_carry_host, *,
               span_len: int) -> bool:
        """Store the span's replay data unless (a) the key hasn't
        missed `min_repeat` times yet, (b) the span moved a stability
        witness (never replayable), or (c) the entry alone exceeds
        the byte budget."""
        if key in self._entries or self._seen.get(key, 0) < self.min_repeat:
            return False
        post_walk = walk_carry(post_carry_host)
        if len(post_walk) != len(pre_walk):
            # an elastic growth changed the carry's shape mid-span;
            # keys include shapes, so the entry is still sound — but
            # delta alignment needs matched walks, so pair by name
            pre_by = {(o, f): a for o, f, a in pre_walk}
        else:
            pre_by = None
        for owner, field, post in post_walk:
            if field in STABILITY_FIELDS.get(owner, ()):
                pre = (pre_by[(owner, field)] if pre_by is not None
                       else pre_walk[[i for i, (o, f, _a) in
                                      enumerate(post_walk)
                                      if (o, f) == (owner, field)][0]][2])
                if not np.array_equal(pre, post):
                    self.unstable_skips += 1
                    return False
        post_keyed = []
        deltas = []
        nbytes = 0
        for i, (owner, field, post) in enumerate(post_walk):
            if classify(owner, field) == "counter":
                if pre_by is not None:
                    pre = pre_by[(owner, field)]
                else:
                    pre = pre_walk[i][2]
                d = counter_delta(pre, post)
                post_keyed.append(None)
                deltas.append(d)
                nbytes += d.nbytes
            else:
                arr = np.ascontiguousarray(post)
                post_keyed.append(arr)
                deltas.append(None)
                nbytes += arr.nbytes
        if nbytes > self.max_bytes:
            self.oversize_skips += 1
            return False
        while self.bytes_cached + nbytes > self.max_bytes and self._entries:
            _k, old = self._entries.popitem(last=False)
            self.bytes_cached -= old.nbytes
            self.evictions += 1
        self._entries[key] = _Entry(post_keyed, deltas, nbytes, span_len)
        self.bytes_cached += nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes_cached)
        self.records += 1
        self._seen.pop(key, None)
        return True

    def replay(self, entry: _Entry, pre_carry_host):
        """Rebuild the post-chain carry on host: keyed leaves from the
        recorded snapshot, counter leaves wrap-added (bitwise-equal to
        re-execution — the golden-corpus parity gate's contract)."""
        it = iter(range(len(entry.post_keyed)))

        def rec(node):
            if node is None:
                return None
            if _is_namedtuple(node):
                return type(node)(*(rec(v) for v in node))
            if isinstance(node, tuple):
                return tuple(rec(v) for v in node)
            if isinstance(node, list):
                return [rec(v) for v in node]
            if isinstance(node, dict):
                return {k: rec(node[k]) for k in sorted(node)}
            i = next(it)
            post = entry.post_keyed[i]
            if post is not None:
                return post
            return apply_counter_delta(node, entry.deltas[i])

        return rec(pre_carry_host)

    def to_device(self, carry_host):
        """Upload a host carry back to tensors on the device `snapshot`
        saw (lazy: only when a miss must execute or an on_chain hook
        needs device values)."""
        return carry_to_device(carry_host, self.device)

    # -- persistence ------------------------------------------------------

    def _salt_sha(self) -> str:
        return hashlib.sha256(self.salt).hexdigest()

    def spill(self, prefix: str = "") -> tuple[dict, dict]:
        """Serialize the cache: ``(meta_fragment, arrays)``.

        Each entry's leaves become arrays named
        ``{prefix}e{j}.post.{i}`` (keyed snapshot) or
        ``{prefix}e{j}.delta.{i}`` (modular counter delta); the meta
        fragment records insertion order, keys, span lengths, and a
        sha256 of the salt (the world identity the keys were minted
        under). Used standalone by `save` and embedded by
        `faults/runstate.py` full-run checkpoints."""
        arrays: dict[str, np.ndarray] = {}
        entries_meta = []
        for j, (key, e) in enumerate(self._entries.items()):
            leaves = []
            for i, post in enumerate(e.post_keyed):
                if post is not None:
                    arrays[f"{prefix}e{j}.post.{i}"] = post
                    leaves.append("post")
                else:
                    arrays[f"{prefix}e{j}.delta.{i}"] = e.deltas[i]
                    leaves.append("delta")
            entries_meta.append({"key": key, "span_len": int(e.span_len),
                                 "hits": int(e.hits), "leaves": leaves,
                                 "persisted": bool(e.persisted)})
        meta = {
            "salt_sha256": self._salt_sha(),
            "entries": entries_meta,
            "max_bytes": int(self.max_bytes),
            "min_repeat": int(self.min_repeat),
            # the full counter census + pre-record miss counts: what
            # `absorb(restore=True)` needs to reproduce this instance
            # EXACTLY (the memoized kill/resume byte-parity contract —
            # a resumed run's memo report matches the uninterrupted
            # twin's, entry hits and all)
            "counters": {f: int(getattr(self, f))
                         for f in _COUNTER_ATTRS},
            "seen": {k: int(v) for k, v in self._seen.items()},
        }
        return meta, arrays

    def absorb(self, meta: dict, arrays: dict, prefix: str = "",
               source: str = "<memo>", restore: bool = False) -> int:
        """Inverse of `spill`. Two modes:

        - cross-run import (default): re-admit entries flagged
          ``persisted`` with hit counts restarting at 0 — a later hit
          counts toward `persisted_hits`.
        - ``restore=True`` (full-run checkpoint resume): reproduce the
          spilled instance EXACTLY — per-entry hits and persisted
          flags, every counter, and the pre-record miss census — so a
          resumed run's memo report is byte-identical to the
          uninterrupted twin's.

        Refuses — as `CheckpointError` — a cache minted under a
        different salt (different world/knobs: its keys could never
        soundly hit) or one missing a serialized leaf. The caller must
        also keep its ``key_extra`` policy consistent across runs;
        that closure is not serializable, so it is a documented
        contract, not a check. Returns the number of entries admitted
        (LRU budget applies)."""
        want_salt = meta.get("salt_sha256")
        if want_salt != self._salt_sha():
            raise CheckpointError(
                f"{source}: memo cache salt_sha256 {str(want_salt)[:12]}... "
                f"does not match this run's salt {self._salt_sha()[:12]}... "
                f"— the cache was recorded for a different world/knob "
                f"configuration; refusing to replay it")
        loaded = 0
        for j, em in enumerate(meta.get("entries", ())):
            key = em["key"]
            if key in self._entries:
                continue
            post_keyed, deltas, nbytes = [], [], 0
            for i, kind in enumerate(em["leaves"]):
                name = f"{prefix}e{j}.{kind}.{i}"
                if name not in arrays:
                    raise CheckpointError(
                        f"{source}: memo entry {j} is missing serialized "
                        f"leaf {name!r}")
                arr = np.asarray(arrays[name])
                if kind == "post":
                    post_keyed.append(arr)
                    deltas.append(None)
                else:
                    post_keyed.append(None)
                    deltas.append(arr)
                nbytes += arr.nbytes
            if nbytes > self.max_bytes:
                self.oversize_skips += 1
                continue
            while (self.bytes_cached + nbytes > self.max_bytes
                   and self._entries):
                _k, old = self._entries.popitem(last=False)
                self.bytes_cached -= old.nbytes
                self.evictions += 1
            entry = _Entry(post_keyed, deltas, nbytes,
                           int(em["span_len"]),
                           persisted=(bool(em.get("persisted"))
                                      if restore else True))
            if restore:
                entry.hits = int(em.get("hits", 0))
            self._entries[key] = entry
            self.bytes_cached += nbytes
            loaded += 1
        if restore:
            for f in _COUNTER_ATTRS:
                if f in meta.get("counters", {}):
                    setattr(self, f, int(meta["counters"][f]))
            self._seen = OrderedDict(
                (k, int(v)) for k, v in meta.get("seen", {}).items())
        else:
            self.peak_bytes = max(self.peak_bytes, self.bytes_cached)
            self.loaded_entries += loaded
        return loaded

    def save(self, path: str) -> dict:
        """Persist the cache to one atomic self-verifying ``.npz``
        (cross-run cache persistence). Returns the written
        meta."""
        meta, arrays = self.spill()
        meta["kind"] = "chainmemo"
        return ckpt.write_npz_checkpoint(path, schema=MEMO_SCHEMA,
                                         meta=meta, arrays=arrays)

    def load(self, path: str) -> int:
        """Load a `save`d cache file; returns entries admitted."""
        meta, arrays = ckpt.load_npz_checkpoint(path, schema=MEMO_SCHEMA)
        return self.absorb(meta, arrays, source=path)

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "records": self.records,
            "evictions": self.evictions,
            "unstable_skips": self.unstable_skips,
            "oversize_skips": self.oversize_skips,
            "fast_forwarded_windows": self.fast_forwarded_windows,
            "loaded_entries": self.loaded_entries,
            "persisted_hits": self.persisted_hits,
            "entries": len(self._entries),
            "bytes_cached": self.bytes_cached,
            "peak_bytes": self.peak_bytes,
            "max_bytes": self.max_bytes,
            "min_repeat": self.min_repeat,
        }

    def report(self) -> dict:
        """The `--memo-report` artifact body: stats plus per-entry
        sizes (keys truncated — they are content digests, not
        secrets, but full hex is noise)."""
        return {
            **self.stats(),
            "entry_sizes": [
                {"key": k[:16], "bytes": e.nbytes,
                 "span_len": e.span_len, "hits": e.hits}
                for k, e in self._entries.items()],
        }

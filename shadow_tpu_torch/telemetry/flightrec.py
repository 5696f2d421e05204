"""The flight recorder: sampled per-packet hop tracing, in PyTorch.

Counterpart of `shadow_tpu/telemetry/flightrec.py`. A seeded mask tags
about 1/K packets by (src, seq); every tagged packet's hops (appended
to an egress ring, routed, delivered, dropped with the reason, and the
flow plane's RTO expiry and retransmission) land as fixed-shape events
in a device trace ring of R slots. The ring keeps the last R events
under a modular write cursor; the host half (`FlightRecorder`) drains it
at chain boundaries with copies that do not block the drive, and counts
what the ring overwrote between two drains instead of dropping it
silently. Recording never touches the simulation state or its RNG.

The device half is bitwise the JAX package's: the mask is one
threefry-2x32 block per (src, seq) under the recorder's key, and an
append is a gather per ring slot (a binary search of the candidates'
inclusive cumsum), the newest event winning a slot.
"""

from __future__ import annotations

import json
import logging
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..tpu.prims import floormod, key_data, threefry_2x32, u32, wrap_i32
from .harvest import unwrap_u32

log = logging.getLogger("shadow_tpu_torch.telemetry")

# hop kinds (ev_kind values); drop reasons are kinds of their own
HOP_INGEST = 0  # appended to its source's egress ring
HOP_ROUTED = 1  # cleared the egress gate and entered the wire
HOP_DELIVERED = 2  # released to the destination host
HOP_DROP_LOSS = 3  # Bernoulli path-loss sample
HOP_DROP_FAULT = 4  # injected fault (purge, corruption, blocked route)
HOP_DROP_AQM = 5  # router CoDel verdict at the destination
HOP_RTO_FIRED = 6  # flow-plane RTO expiry (seq = the guarded snd_una)
HOP_RETRANSMIT = 7  # flow-plane re-emission of an already-sent seq

HOP_NAMES = {
    HOP_INGEST: "ingest",
    HOP_ROUTED: "routed",
    HOP_DELIVERED: "delivered",
    HOP_DROP_LOSS: "drop_loss",
    HOP_DROP_FAULT: "drop_fault",
    HOP_DROP_AQM: "drop_aqm",
    HOP_RTO_FIRED: "rto_fired",
    HOP_RETRANSMIT: "retransmit",
}

_U32 = 1 << 32


class FlightRecArrays(NamedTuple):
    """The device trace ring; field order is the JAX package's. The
    uint32 leaves (`key`, `sample_every`) are int64 tensors holding the
    unsigned values."""

    key: torch.Tensor  # [2] int64 (uint32 words): the sampling key
    sample_every: torch.Tensor  # 0-d int64 (uint32): tag ~1/K packets
    ev_kind: torch.Tensor  # [R] int32 HOP_* code
    ev_src: torch.Tensor  # [R] int32 source host
    ev_seq: torch.Tensor  # [R] int32 per-source packet id
    ev_dst: torch.Tensor  # [R] int32 destination host
    ev_t: torch.Tensor  # [R] int32 ns after the event's window start
    ev_win: torch.Tensor  # [R] int32 window counter at the event
    cursor: torch.Tensor  # 0-d int32 modular write cursor
    win: torch.Tensor  # 0-d int32 windows recorded so far


def make_flightrec(seed: int, *, sample_every: int = 64, ring: int = 4096,
                   device=None) -> FlightRecArrays:
    """A fresh recorder keyed by `seed`, tagging ~1/`sample_every`
    packets into a ring of `ring` slots."""
    if sample_every < 1:
        raise ValueError("flight_recorder.sample_every must be >= 1")
    if ring < 1:
        raise ValueError("flight_recorder.ring must be >= 1")
    device = resolve_device(device)
    i64 = dict(dtype=torch.int64, device=device)
    z = lambda: torch.zeros(ring, dtype=torch.int32, device=device)
    return FlightRecArrays(
        key=torch.tensor(key_data(seed), **i64),
        sample_every=torch.tensor(sample_every % _U32, **i64),
        ev_kind=z(), ev_src=z(), ev_seq=z(), ev_dst=z(), ev_t=z(),
        ev_win=z(),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        win=torch.zeros((), dtype=torch.int32, device=device),
    )


def ring_capacity(fr: FlightRecArrays) -> int:
    return int(fr.ev_kind.shape[0])


# -- device half ----------------------------------------------------------------


def sample_mask(fr: FlightRecArrays, src, seq) -> torch.Tensor:
    """True for packets whose (src, seq) block hashes to 0 mod K under
    the recorder's key: the first output word of threefry-2x32 on the
    block (src, seq), as JAX's even-length split of concat(src, seq)
    gives it. Independent of batch shape and ring size."""
    bits, _ = threefry_2x32((fr.key[0], fr.key[1]), u32(src), u32(seq))
    return torch.remainder(bits, fr.sample_every) == 0


def record_events(fr: FlightRecArrays, kind, src, seq, dst, t,
                  mask) -> FlightRecArrays:
    """Append this window's masked candidates ([B] int32 columns, a bool
    mask, in layout order) to the ring: event of rank r goes to slot
    (cursor + r) mod R, and each slot gathers the newest rank that lands
    on it (the last R events survive a window that has more)."""
    R = fr.ev_kind.shape[0]
    B = mask.shape[0]
    csum = torch.cumsum(mask, dim=0, dtype=torch.int32)  # inclusive
    count = csum[-1]
    slots = torch.arange(R, dtype=torch.int64, device=mask.device)
    # the int32 difference wraps as the JAX cursor arithmetic does
    r0 = floormod(wrap_i32(slots - fr.cursor.to(torch.int64)), R)
    r = count - 1 - floormod(count - 1 - r0, R)
    written = (r >= 0) & (r >= count - R)
    src_idx = torch.clamp(torch.searchsorted(csum, r + 1), 0, B - 1)
    pick = lambda col, old: torch.where(written, col.reshape(-1)[src_idx],
                                        old)
    return fr._replace(
        ev_kind=pick(kind, fr.ev_kind),
        ev_src=pick(src, fr.ev_src),
        ev_seq=pick(seq, fr.ev_seq),
        ev_dst=pick(dst, fr.ev_dst),
        ev_t=pick(t, fr.ev_t),
        ev_win=torch.where(written, fr.win, fr.ev_win),
        cursor=wrap_i32(fr.cursor.to(torch.int64) + count),
    )


def advance_window(fr: FlightRecArrays) -> FlightRecArrays:
    """Bump the window counter, once a window after its events."""
    return fr._replace(win=fr.win + 1)


def grow_ring(fr: FlightRecArrays, new_ring: int) -> FlightRecArrays:
    """Repack the ring into `new_ring` (> R) slots, each live entry at
    its cursor-consistent position (absolute position mod `new_ring`),
    as if the run had started at the larger capacity."""
    R = fr.ev_kind.shape[0]
    if new_ring <= R:
        raise ValueError(
            f"flight-recorder ring can only grow ({R} -> {new_ring})")
    cur = fr.cursor.to(torch.int64)
    idx = torch.arange(R, dtype=torch.int64, device=fr.cursor.device)
    # the int32 arithmetic of the JAX package, wrapped at each step
    last = wrap_i32(cur - 1).to(torch.int64)
    abs_pos = wrap_i32(last - floormod(wrap_i32(last - idx), R))
    live = (abs_pos >= 0) & (abs_pos >= wrap_i32(cur - R))
    pos = torch.where(live, floormod(abs_pos, new_ring), new_ring)
    old = torch.stack([fr.ev_kind, fr.ev_src, fr.ev_seq, fr.ev_dst,
                       fr.ev_t, fr.ev_win])
    ring = torch.zeros(6, new_ring + 1, dtype=torch.int32,
                       device=old.device)
    ring[:, pos.to(torch.int64)] = old  # dead entries land on the pad
    ring = ring[:, :new_ring]
    return fr._replace(ev_kind=ring[0], ev_src=ring[1], ev_seq=ring[2],
                       ev_dst=ring[3], ev_t=ring[4], ev_win=ring[5])


# -- host half: the drain -------------------------------------------------------

#: ring columns the drain copies (the cursor rides along)
_COLS = ("ev_kind", "ev_src", "ev_seq", "ev_dst", "ev_t", "ev_win")


class FlightRecorder:
    """The host drain of the trace ring. `tick(fr)` decodes the previous
    snapshot, then starts copying the current ring and cursor to the
    host: on the card into pinned buffers with `non_blocking` copies and
    an event, which the next tick waits on; nothing blocks the drive in
    between. Decoded hops accumulate in `hops` (unless `retain` is
    False: a long run's hops then only stream) and stream to `sink` (a
    path or a file object) as JSONL with sorted keys. `overwritten`
    counts events the ring lost between two drains."""

    def __init__(self, *, window_ns: int, sink=None, retain: bool = True):
        self.window_ns = int(window_ns)
        self.hops: list[dict] = []
        self.recorded = 0  # hops decoded across all drains
        self.overwritten = 0  # events lost to ring overwrite
        self._retain = retain
        self._pending = None  # (columns, cursor, event or None)
        self._pinned: dict[str, torch.Tensor] = {}
        self._prev_cursor_raw = 0
        self._cursor_total = 0
        self._grown_at = 0  # `overwritten` at the last `grow_ring`
        self._own_sink = isinstance(sink, str)
        self.sink_path = sink if self._own_sink else None
        self._sink = open(sink, "w") if self._own_sink else sink

    def _host_copy(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t.detach().clone()
        buf = self._pinned.get(name)
        if buf is None or buf.shape != t.shape:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[name] = buf
        return buf.copy_(t, non_blocking=True)

    def tick(self, fr: FlightRecArrays) -> None:
        """Drain the previous snapshot, then start copying the current
        ring columns and cursor."""
        self.drain()
        cols = {c: self._host_copy(c, getattr(fr, c)) for c in _COLS}
        cursor = self._host_copy("cursor", fr.cursor)
        done = None
        if fr.cursor.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._pending = (cols, cursor, done)

    def seed_cursor(self, cursor_raw: int) -> None:
        """Start the drain at an existing ring cursor (a ring that was
        drained up to there before)."""
        self._prev_cursor_raw = int(cursor_raw) & 0xFFFFFFFF
        self._cursor_total = int(cursor_raw)

    def drain(self) -> None:
        """Decode the pending snapshot, if any."""
        if self._pending is None:
            return
        cols, cursor, done = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()
        cols = {c: t.numpy() for c, t in cols.items()}
        cur_raw = int(cursor.numpy())
        delta = int(unwrap_u32(self._prev_cursor_raw, cur_raw))
        self._prev_cursor_raw = cur_raw
        if delta == 0:
            return
        R = cols["ev_kind"].shape[0]
        lost = max(0, delta - R)
        if lost:
            self.overwritten += lost
            log.error("flight-recorder trace ring overflowed: %d hop "
                      "event(s) overwritten before the drain (ring=%d)",
                      lost, R)
        start = self._cursor_total + lost
        end = self._cursor_total + delta
        self._cursor_total = end
        for p in range(start, end):
            j = p % R
            kind = int(cols["ev_kind"][j])
            win = int(cols["ev_win"][j])
            self._write({
                "kind": HOP_NAMES.get(kind, str(kind)),
                "src": int(cols["ev_src"][j]),
                "seq": int(cols["ev_seq"][j]),
                "dst": int(cols["ev_dst"][j]),
                "win": win,
                "t_ns": win * self.window_ns + int(cols["ev_t"][j]),
            })

    def want_growth(self) -> bool:
        """True when a drain counted overwritten events since the last
        growth: an elastic driver's cue to `grow_ring`."""
        return self.overwritten > self._grown_at

    def note_grown(self) -> None:
        self._grown_at = self.overwritten

    def finalize(self) -> None:
        """Drain the pending snapshot and flush (and close, when it opened
        it) the sink. Idempotent."""
        self.drain()
        if self._sink is not None:
            self._sink.flush()
            if self._own_sink:
                self._sink.close()
                self._sink = None

    def _write(self, rec: dict) -> None:
        if self._sink is not None:
            self._sink.write(json.dumps(rec, sort_keys=True) + "\n")
        if self._retain:
            self.hops.append(rec)
        self.recorded += 1

    def summary(self) -> dict:
        """The drain's summary for run records."""
        return {"recorded_hops": self.recorded,
                "overwritten": self.overwritten,
                "sink": self.sink_path}


def read_hops(lines) -> list[dict]:
    """Parse a hops JSONL stream back into hop dicts."""
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "kind" in rec:
            out.append(rec)
    return out


def hop_flows(hops: list[dict]) -> dict[tuple[int, int], list[dict]]:
    """Hops grouped by packet identity (src, seq), each group in hop
    order."""
    flows: dict[tuple[int, int], list[dict]] = {}
    for h in hops:
        flows.setdefault((h["src"], h["seq"]), []).append(h)
    for group in flows.values():
        group.sort(key=lambda h: (h["t_ns"], h["kind"]))
    return flows


def flightrec_meta(fr: FlightRecArrays) -> dict:
    """The recorder's static parameters for run records."""
    return {"sample_every": int(fr.sample_every.detach().cpu()),
            "ring": ring_capacity(fr)}

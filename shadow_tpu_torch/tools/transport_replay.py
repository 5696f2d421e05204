"""Replay a recorded device-transport call log through the port's
`tpu/transport.DeviceTransport`.

A call log is what a live simulation asked of its device transport, in
order: each round's `release`, the round's `capture`s, its
`finish_round`, every `apply_fault_latency`, and the closing
`finalize`, with what the recording transport answered: each release's
pushes into the host event queues (their count and a digest of the
ordered `(dst, deliver_abs, src_id, seq, tag)` rows) and its
`next_pending_abs`, and at the end the transport's in-flight count,
divergence count and verified windows and packets. A log is written
with `LogWriter` beside a run of the JAX package's Manager on the CPU,
and kept as a compressed npz: int16 host indices, capture times relative
to their round's start, and one digest a round in place of the push
rows.

The replay drives a fresh transport with stub hosts (each records its
`push_packet_event`s) through the same calls and holds every round to
the record. In sync mode it compares each release's pushes and
`next_pending_abs`; in mirrored mode the pushes happen at capture in a
live run, so it compares the end: no tag in flight, no divergence, and
the verified windows and packets of the recording package's own
mirrored replay of the log (`meta["mirrored"]`). It raises `Mismatch`
naming the first round that differs.

Usage: python -m shadow_tpu_torch.tools.transport_replay LOG
       --mode sync|mirrored|auto [--rounds N] [--device cpu]

It prints one JSON line (wall seconds, rounds, captures, dispatches, the
mode, and for `auto` the D2H probe) and exits 1 on the first round that
differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Optional

import numpy as np

LOG_VERSION = 1
#: op kinds of a log's op stream; a CAPTURES op stands for a run of
#: `op_n` consecutive captures
OP_RELEASE, OP_CAPTURES, OP_FINISH, OP_LATENCY, OP_FINALIZE = range(5)
#: an absent time (None) in an int64 column
NONE = -1

_I32 = np.iinfo(np.int32)


def push_digest(rows) -> int:
    """The first 8 bytes (little endian) of the sha256 of ordered push
    rows `(dst, deliver_abs, src_id, seq, tag)` as int64."""
    a = np.asarray(rows, np.int64).reshape(-1, 5)
    return int.from_bytes(hashlib.sha256(a.tobytes()).digest()[:8], "little")


def _opt(v: Optional[int]) -> int:
    return NONE if v is None else int(v)


def _unopt(v) -> Optional[int]:
    return None if int(v) == NONE else int(v)


def _rel32(v: int, what: str) -> int:
    if not _I32.min <= v <= _I32.max:
        raise ValueError(f"{what} {v} does not fit the log's int32 column")
    return v


class LogWriter:
    """Accumulates a call log; `save` writes the npz. The header is the
    transport's construction: `latency` ([M, M] node latency ns),
    `host_node` ([N] node index of each host index) and the keywords of
    `DeviceTransport` in `meta`."""

    def __init__(self, latency, host_node, meta: dict):
        self.latency = np.asarray(latency, np.int32)
        self.host_node = np.asarray(host_node, np.int64)
        self.meta = dict(meta)
        self.kinds: list[int] = []
        self.counts: list[int] = []
        self.rel: list[tuple] = []  # start, end, horizon, runahead, stop
        self.rel_out: list[tuple] = []  # n pushes, digest, next_pending
        self.fin: list[tuple] = []
        self.lat_mult: list[np.ndarray] = []
        self.caps: list[tuple] = []  # src, dst, seq, now, clamp, lat
        self._base = 0

    def _op(self, kind: int, n: int = 0) -> None:
        self.kinds.append(kind)
        self.counts.append(n)

    def release(self, start, end, horizon, runahead, stop) -> None:
        self._op(OP_RELEASE)
        self.rel.append((start, end, _opt(horizon), _opt(runahead),
                         _opt(stop)))
        self._base = start

    def release_result(self, rows, next_pending) -> None:
        self.rel_out.append((len(rows), push_digest(rows),
                             _opt(next_pending)))

    def capture(self, src, dst, seq, now, round_end, deliver) -> None:
        if self.kinds and self.kinds[-1] == OP_CAPTURES:
            self.counts[-1] += 1
        else:
            self._op(OP_CAPTURES, 1)
        b = self._base
        self.caps.append((src, dst, _rel32(seq, "seq"),
                          _rel32(now - b, "capture time"),
                          _rel32(round_end - b, "round end"),
                          _rel32(deliver - now, "latency")))

    def finish(self, start, end) -> None:
        self._op(OP_FINISH)
        self.fin.append((start, end))
        self._base = start

    def latency_change(self, lat_mult) -> None:
        self._op(OP_LATENCY)
        self.lat_mult.append(np.asarray(lat_mult, np.int32))

    def finalize(self, result: dict) -> None:
        self._op(OP_FINALIZE)
        self.meta["final"] = dict(result)

    def save(self, path: str) -> None:
        n = self.latency.shape[0]
        cap = np.asarray(self.caps, np.int64).reshape(-1, 6)
        hidx = np.int16 if len(self.host_node) < 2**15 else np.int32
        meta = {**self.meta, "version": LOG_VERSION,
                "rounds": len(self.rel), "captures": len(self.caps)}
        np.savez_compressed(
            path, meta=np.array(json.dumps(meta, sort_keys=True)),
            latency=self.latency, host_node=self.host_node.astype(hidx),
            op_kind=np.asarray(self.kinds, np.uint8),
            op_n=np.asarray(self.counts, np.int32),
            rel=np.asarray(self.rel, np.int64).reshape(-1, 5),
            rel_pushes=np.asarray([r[0] for r in self.rel_out], np.int32),
            rel_digest=np.asarray([r[1] for r in self.rel_out], np.uint64),
            rel_next=np.asarray([r[2] for r in self.rel_out], np.int64),
            fin=np.asarray(self.fin, np.int64).reshape(-1, 2),
            lat_mult=np.asarray(self.lat_mult, np.int32).reshape(-1, n, n),
            cap_src=cap[:, 0].astype(hidx), cap_dst=cap[:, 1].astype(hidx),
            cap_seq=cap[:, 2].astype(np.int32),
            cap_now=cap[:, 3].astype(np.int32),
            cap_clamp=cap[:, 4].astype(np.int32),
            cap_lat=cap[:, 5].astype(np.int32))


def load_log(path: str) -> dict:
    """A log as a dict of numpy arrays, `meta` decoded."""
    with np.load(path) as z:
        log = {k: z[k] for k in z.files}
    log["meta"] = json.loads(str(log["meta"]))
    if log["meta"].get("version") != LOG_VERSION:
        raise ValueError(f"{path}: log version {log['meta'].get('version')}"
                         f", this replay reads {LOG_VERSION}")
    return log


class Mismatch(AssertionError):
    """The replay left the record at `round` (0-based release index)."""

    def __init__(self, round_idx: int, what: str):
        super().__init__(f"round {round_idx}: {what}")
        self.round = round_idx


class _Routing:
    """What `DeviceTransport` reads of the Manager's routing."""

    def __init__(self, latency_ns):
        self.latency_ns = latency_ns

    @staticmethod
    def node_index(node_id):
        return int(node_id)


class _Packet:
    __slots__ = ("tag",)


class _Host:
    """A stub host: its id, node and a shared list of pushes."""

    def __init__(self, host_id: int, node_id: int, pushes: list):
        self.host_id = host_id
        self.node_id = node_id
        self.name = f"host{host_id}"
        self._pushes = pushes

    def push_packet_event(self, packet, deliver_abs, src_id, seq):
        self._pushes.append((self.host_id - 1, deliver_abs, src_id, seq,
                             packet.tag))


def port_transport(hosts, routing, mode, device=None, **kw):
    """The port's `DeviceTransport` (the replay's default)."""
    from ..tpu.transport import DeviceTransport

    return DeviceTransport(hosts, routing, None, mode=mode, device=device,
                           **kw)


def transport_kwargs(meta: dict) -> dict:
    return {k: meta[k] for k in ("ingress_cap", "compact_cap",
                                 "capacity_mode", "max_doublings",
                                 "capacity_strict")}


def replay(log: dict, mode: str, *, make_transport=port_transport,
           rounds: Optional[int] = None, device=None,
           check_end: bool = True) -> dict:
    """Drive a transport made by `make_transport(hosts, routing, mode,
    **kw)` (plus `device=` for the port's) through `log`. With `rounds`,
    stop after that many releases and skip the end checks;
    `check_end=False` skips them too (a recorder making the mirrored
    record). Returns the summary dict; raises `Mismatch` at the first
    difference."""
    meta = log["meta"]
    pushes: list = []
    hosts = [_Host(i + 1, int(node), pushes)
             for i, node in enumerate(log["host_node"])]
    kw = transport_kwargs(meta)
    if make_transport is port_transport:
        kw["device"] = device
    t = make_transport(hosts, _Routing(log["latency"]), mode, **kw)
    for k, v in meta.get("retry", {}).items():
        setattr(t, k, v)
    if meta.get("guards"):
        t.enable_guards()
    if meta.get("histograms"):
        t.enable_histograms()
    sync = not t.mirrored
    caps = [log[f"cap_{c}"].tolist()
            for c in ("src", "dst", "seq", "now", "clamp", "lat")]
    ci = ri = fi = li = 0
    base = 0
    wall0 = time.perf_counter()
    for kind, n in zip(log["op_kind"].tolist(), log["op_n"].tolist()):
        if kind == OP_RELEASE:
            if rounds is not None and ri >= rounds:
                break
            start, end, horizon, runahead, stop = log["rel"][ri].tolist()
            pushes.clear()
            t.release(start, end, _unopt(horizon), _unopt(runahead),
                      _unopt(stop))
            base = start
            if sync:
                want_n = int(log["rel_pushes"][ri])
                if len(pushes) != want_n:
                    raise Mismatch(ri, f"{len(pushes)} pushes, the record "
                                   f"has {want_n}")
                if push_digest(pushes) != int(log["rel_digest"][ri]):
                    raise Mismatch(ri, "the push rows differ from the "
                                   "record's digest")
                want = _unopt(log["rel_next"][ri])
                if t.next_pending_abs != want:
                    raise Mismatch(ri, f"next_pending_abs "
                                   f"{t.next_pending_abs}, the record has "
                                   f"{want}")
            ri += 1
        elif kind == OP_CAPTURES:
            for src, dst, seq, now, clamp, lat in zip(
                    *(c[ci:ci + n] for c in caps)):
                p = _Packet()
                t.capture(hosts[src], hosts[dst], p, base + now, seq,
                          base + clamp, base + now + lat)
                p.tag = t._pending[-1][3]
            ci += n
        elif kind == OP_FINISH:
            start, end = log["fin"][fi].tolist()
            t.finish_round(start, end)
            base = start
            fi += 1
        elif kind == OP_LATENCY:
            t.apply_fault_latency(log["lat_mult"][li])
            li += 1
        elif kind == OP_FINALIZE:
            t.finalize()
            if check_end:
                _check_end(t, meta, ri)
    wall = time.perf_counter() - wall0
    return {"mode": t.mode, "rounds": ri, "captures": ci,
            "dispatches": getattr(t, "dispatches", None),
            "wall_s": wall, "in_flight": t.in_flight,
            "divergence_count": t.divergence_count,
            "verified_windows": t.verified_windows,
            "verified_packets": t.verified_packets,
            "d2h_probe_ms": getattr(t, "d2h_probe_ms", None),
            "transport": t}


def _check_end(t, meta: dict, ri: int) -> None:
    if t.mirrored:
        want = meta["mirrored"]
        got = {"in_flight": t.in_flight, "divergence_count":
               t.divergence_count, "verified_windows": t.verified_windows,
               "verified_packets": t.verified_packets}
        want = {k: want[k] for k in got}
    else:
        want = {k: meta["final"][k] for k in ("in_flight",
                                               "divergence_count")}
        got = {"in_flight": t.in_flight,
               "divergence_count": t.divergence_count}
    if got != want:
        raise Mismatch(ri, f"at finalize {got}, the record has {want}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a device-transport call log through the "
                    "port's DeviceTransport")
    ap.add_argument("log")
    ap.add_argument("--mode", choices=("sync", "mirrored", "auto"),
                    default="sync")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop after this many releases (no end checks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    log = load_log(args.log)
    try:
        out = replay(log, args.mode, rounds=args.rounds, device=args.device)
    except Mismatch as e:
        print(f"transport_replay: MISMATCH at {e}", file=sys.stderr)
        return 1
    out.pop("transport")
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The `faults:` block compiled into a deterministic schedule.

The port's copy of `shadow_tpu/faults/schedule.py`, the CPU plane's
send filter `filter_send` included (a caller that runs hosts on the CPU,
such as the JAX package's Manager over the port's device transport,
calls it on every cross-host send).
Explicit events and seeded `random:` generators compile into one
virtual-time event list, a pure function of (config, seed); `advance`
folds the events due by a time into the numpy mask state, and
`device_arrays` uploads it as the `FaultArrays` that
`tpu/plane.window_step(faults=)` reads.

Event kinds (`duration`/`until` add the paired recovery event):
``host_crash``/``host_reboot``, ``iface_down``/``iface_up``,
``link_degrade``/``link_restore`` (``src_node``, ``dst_node``,
``latency_mult``, ``symmetric``), ``host_degrade``/``host_restore``
(``bandwidth_div``) and ``corrupt_burst`` (``p``, with a duration).
Generators: ``host_crashes`` and ``iface_flaps``, each ``{count,
window: [start, end], downtime}``, drawn from a xoshiro256++ stream
seeded by the run's seed (or ``faults.seed``) XOR a domain constant.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..core import units
from ..core.config import ConfigError
from ..core.rng import Xoshiro256pp

#: domain separator for the fault-schedule RNG stream (never shared with
#: the global/host streams, which hash hostnames instead)
_FAULT_SEED_SALT = 0xFA17_0000_0000_0001

HOST_KINDS = frozenset({
    "host_crash", "host_reboot", "iface_down", "iface_up",
    "host_degrade", "host_restore", "corrupt_burst",
})
LINK_KINDS = frozenset({"link_degrade", "link_restore"})
ALL_KINDS = HOST_KINDS | LINK_KINDS

#: kind -> the auto-generated recovery kind for `duration`/`until`
_RECOVERY = {
    "host_crash": "host_reboot",
    "iface_down": "iface_up",
    "link_degrade": "link_restore",
    "host_degrade": "host_restore",
    "corrupt_burst": "_corrupt_end",
}


@dataclass(frozen=True)
class FaultEvent:
    """One compiled fault instant. `seq` is the stable tiebreak for
    same-instant events (config order, then generator order)."""

    time_ns: int
    kind: str
    host: Optional[str] = None
    src_node: Optional[int] = None
    dst_node: Optional[int] = None
    latency_mult: int = 1
    bandwidth_div: int = 1
    corrupt_p: float = 0.0
    symmetric: bool = True
    seq: int = 0

    def describe(self) -> str:
        tgt = (self.host if self.host is not None
               else f"link {self.src_node}->{self.dst_node}")
        return f"t={self.time_ns}ns {self.kind} {tgt}"


def _dur(raw: Any, where: str) -> int:
    try:
        return units.parse_duration_ns(raw)
    except (ValueError, TypeError) as e:
        raise ConfigError(f"{where}: {e}") from None


def _parse_event(raw: dict, i: int, host_names: set[str]) -> list[FaultEvent]:
    where = f"faults.events[{i}]"
    if not isinstance(raw, dict):
        raise ConfigError(f"{where}: expected a mapping, got {raw!r}")
    raw = dict(raw)
    kind = raw.pop("kind", None)
    if kind not in ALL_KINDS:
        raise ConfigError(
            f"{where}: unknown kind {kind!r} (expected one of "
            f"{', '.join(sorted(ALL_KINDS))})")
    at = raw.pop("at", None)
    if at is None:
        raise ConfigError(f"{where}: missing required field 'at'")
    t = _dur(at, f"{where}.at")
    duration = raw.pop("duration", None)
    until = raw.pop("until", None)
    if duration is not None and until is not None:
        raise ConfigError(f"{where}: give 'duration' or 'until', not both")
    end = None
    if duration is not None:
        end = t + _dur(duration, f"{where}.duration")
    elif until is not None:
        end = _dur(until, f"{where}.until")
        if end <= t:
            raise ConfigError(f"{where}: until must be after at")

    kw: dict = {"time_ns": t, "kind": kind}
    if kind in HOST_KINDS:
        host = raw.pop("host", None)
        if host not in host_names:
            raise ConfigError(
                f"{where}: host {host!r} is not a configured host")
        kw["host"] = str(host)
    else:
        for f in ("src_node", "dst_node"):
            v = raw.pop(f, None)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ConfigError(
                    f"{where}: {f} must be a non-negative node index")
            kw[f] = v
        kw["symmetric"] = bool(raw.pop("symmetric", True))
    if kind == "link_degrade":
        m = raw.pop("latency_mult", None)
        if not isinstance(m, int) or isinstance(m, bool) or m < 1:
            raise ConfigError(
                f"{where}: latency_mult must be an integer >= 1")
        kw["latency_mult"] = m
    if kind == "host_degrade":
        d = raw.pop("bandwidth_div", None)
        if not isinstance(d, int) or isinstance(d, bool) or d < 1:
            raise ConfigError(
                f"{where}: bandwidth_div must be an integer >= 1")
        kw["bandwidth_div"] = d
    if kind == "corrupt_burst":
        p = raw.pop("p", None)
        if not isinstance(p, (int, float)) or isinstance(p, bool) \
                or not (0.0 <= float(p) <= 1.0):
            raise ConfigError(f"{where}: p must be a probability in [0, 1]")
        kw["corrupt_p"] = float(p)
        if end is None:
            raise ConfigError(
                f"{where}: corrupt_burst requires duration (or until)")
    if raw:
        raise ConfigError(
            f"{where}: unknown field(s) {sorted(raw)} for kind {kind!r}")

    out = [FaultEvent(**kw)]
    if end is not None:
        rk = _RECOVERY.get(kind)
        if rk is None:
            raise ConfigError(
                f"{where}: duration/until is not meaningful for {kind!r}")
        rkw = dict(kw)
        rkw.update(time_ns=end, kind=rk, latency_mult=1, bandwidth_div=1,
                   corrupt_p=0.0)
        out.append(FaultEvent(**rkw))
    return out


def _expand_random(spec: dict, host_names: list[str],
                   rng: Xoshiro256pp) -> list[FaultEvent]:
    """Seeded generators -> concrete events. Draw order is fixed
    (generator key order is pinned below, not dict order) so the
    expansion is a pure function of the seed."""
    out: list[FaultEvent] = []
    known = {"host_crashes": ("host_crash", "host_reboot"),
             "iface_flaps": ("iface_down", "iface_up")}
    unknown = set(spec) - set(known)
    if unknown:
        raise ConfigError(
            f"faults.random: unknown generator(s) {sorted(unknown)} "
            f"(expected {sorted(known)})")
    for gen_name in ("host_crashes", "iface_flaps"):  # FIXED draw order
        g = spec.get(gen_name)
        if g is None:
            continue
        if not isinstance(g, dict):
            raise ConfigError(f"faults.random.{gen_name}: expected a mapping")
        g = dict(g)
        count = g.pop("count", None)
        window = g.pop("window", None)
        downtime = g.pop("downtime", None)
        if g:
            raise ConfigError(
                f"faults.random.{gen_name}: unknown field(s) {sorted(g)}")
        if not isinstance(count, int) or isinstance(count, bool) or count < 1:
            raise ConfigError(
                f"faults.random.{gen_name}.count must be an integer >= 1")
        if (not isinstance(window, (list, tuple)) or len(window) != 2):
            raise ConfigError(
                f"faults.random.{gen_name}.window must be [start, end]")
        w0 = _dur(window[0], f"faults.random.{gen_name}.window[0]")
        w1 = _dur(window[1], f"faults.random.{gen_name}.window[1]")
        if w1 <= w0:
            raise ConfigError(
                f"faults.random.{gen_name}.window end must be after start")
        if downtime is None:
            raise ConfigError(
                f"faults.random.{gen_name}: missing required 'downtime'")
        down_ns = _dur(downtime, f"faults.random.{gen_name}.downtime")
        down_kind, up_kind = known[gen_name]
        for _ in range(count):
            host = host_names[rng.randrange(0, len(host_names))]
            t = w0 + rng.randrange(0, w1 - w0)
            out.append(FaultEvent(time_ns=t, kind=down_kind, host=host))
            out.append(FaultEvent(time_ns=t + down_ns, kind=up_kind,
                                  host=host))
    return out


class FaultSchedule:
    """The compiled, sorted schedule plus the live mask state it folds
    into as `advance()` consumes events.

    Mask state (numpy; the `faults/plane.FaultArrays` mirror):
    `host_alive [N]`, `link_up [N]`, `bw_div [N]`, `corrupt_p [N]`,
    `lat_mult [M, M]`. Host index = position in `host_names`. Link
    events address node indices in [0, M): callers whose graph node IDs
    are not dense indices pass `node_index` to `compile_schedule`.
    """

    def __init__(self, events: list[FaultEvent], host_names: list[str],
                 n_nodes: int):
        self.events = sorted(events, key=lambda e: (e.time_ns, e.seq))
        self.host_names = list(host_names)
        self.host_index = {n: i for i, n in enumerate(self.host_names)}
        n, m = len(self.host_names), max(int(n_nodes), 1)
        self.n_hosts, self.n_nodes = n, m
        self.host_alive = np.ones(n, bool)
        self.link_up = np.ones(n, bool)
        self.bw_div = np.ones(n, np.int32)
        self.corrupt_p = np.zeros(n, np.float32)
        self.lat_mult = np.ones((m, m), np.int32)
        self._cursor = 0
        self.fired: list[FaultEvent] = []
        # raw graph-node id -> dense node index, for callers that hold
        # raw ids while the mask matrix lives in dense index space
        self._node_map: Optional[dict] = None

    def set_node_map(self, node_map: dict) -> None:
        self._node_map = dict(node_map)

    # -- compile-time views ----------------------------------------------

    @property
    def remaining(self) -> int:
        return len(self.events) - self._cursor

    def peek_next_ns(self) -> Optional[int]:
        if self._cursor >= len(self.events):
            return None
        return self.events[self._cursor].time_ns

    def fingerprint(self) -> str:
        """Stable digest of the compiled event list (determinism tests:
        same seed -> same schedule, byte for byte)."""
        import hashlib

        h = hashlib.sha256()
        for e in self.events:
            h.update(repr((e.time_ns, e.kind, e.host, e.src_node,
                           e.dst_node, e.latency_mult, e.bandwidth_div,
                           e.corrupt_p, e.symmetric)).encode())
        return h.hexdigest()

    def span_fingerprint(self, t0_ns: int, t1_ns: int) -> str:
        """Digest of everything the fault plane contributes to the
        span (t0, t1]: the CURRENT mask state (the masks the span's
        first window runs under — callers must have `advance`d the
        schedule to t0 first) plus every still-pending event firing
        inside the span, with times RELATIVE to t0 so a periodic fault
        pattern fingerprints equal across its repeats. Two spans with
        equal digests run under the same masks and events."""
        import hashlib

        h = hashlib.sha256()
        for arr in (self.host_alive, self.link_up, self.bw_div,
                    self.corrupt_p, self.lat_mult):
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        for e in self.events[self._cursor:]:
            if e.time_ns <= t0_ns:
                continue
            if e.time_ns > t1_ns:
                break
            h.update(repr((e.time_ns - t0_ns, e.kind, e.host,
                           e.src_node, e.dst_node, e.latency_mult,
                           e.bandwidth_div, e.corrupt_p,
                           e.symmetric)).encode())
        return h.hexdigest()

    # -- runtime ----------------------------------------------------------

    def advance(self, now_ns: int) -> list[FaultEvent]:
        """Consume every event with time <= now_ns, fold it into the
        mask state, and return the fired list."""
        fired: list[FaultEvent] = []
        while self._cursor < len(self.events) \
                and self.events[self._cursor].time_ns <= now_ns:
            ev = self.events[self._cursor]
            self._cursor += 1
            self._apply(ev)
            fired.append(ev)
        self.fired.extend(fired)
        return fired

    def _apply(self, ev: FaultEvent) -> None:
        if ev.kind in LINK_KINDS:
            s, d = ev.src_node, ev.dst_node
            if not (0 <= s < self.n_nodes and 0 <= d < self.n_nodes):
                raise ConfigError(
                    f"fault event {ev.describe()}: node index out of "
                    f"range for a {self.n_nodes}-node graph")
            mult = ev.latency_mult if ev.kind == "link_degrade" else 1
            self.lat_mult[s, d] = mult
            if ev.symmetric:
                self.lat_mult[d, s] = mult
            return
        i = self.host_index[ev.host]
        if ev.kind == "host_crash":
            self.host_alive[i] = False
        elif ev.kind == "host_reboot":
            self.host_alive[i] = True
        elif ev.kind == "iface_down":
            self.link_up[i] = False
        elif ev.kind == "iface_up":
            self.link_up[i] = True
        elif ev.kind == "host_degrade":
            self.bw_div[i] = ev.bandwidth_div
        elif ev.kind == "host_restore":
            self.bw_div[i] = 1
        elif ev.kind == "corrupt_burst":
            self.corrupt_p[i] = ev.corrupt_p
        elif ev.kind == "_corrupt_end":
            self.corrupt_p[i] = 0.0

    def device_arrays(self, device=None):
        """The current mask state as a `FaultArrays` on `device` (None:
        the CUDA card), copied."""
        from .plane import faults_from_numpy

        return faults_from_numpy(self.host_alive, self.link_up,
                                 self.lat_mult, self.bw_div,
                                 self.corrupt_p, device=device)

    def refresh_device_arrays(self, fa, fired: list[FaultEvent]):
        """`fa` brought up to the current mask state after `advance`
        returned `fired`, without uploading what did not change: the [N]
        host masks are uploaded again when a host event fired, and the
        [M, M] latency multiplier is written in place at the cells a
        link event set (the whole table is as large as a path table).
        Equal to `device_arrays()`, bit for bit."""
        dev = fa.lat_mult.device
        if any(ev.kind not in LINK_KINDS for ev in fired):
            up = lambda a, dt: torch.tensor(np.array(a, dt), device=dev)
            fa = fa._replace(host_alive=up(self.host_alive, bool),
                             link_up=up(self.link_up, bool),
                             bw_div=up(self.bw_div, np.int32),
                             corrupt_p=up(self.corrupt_p, np.float32))
        cells = sorted({(s, d) for ev in fired if ev.kind in LINK_KINDS
                        for s, d in ((ev.src_node, ev.dst_node),
                                     (ev.dst_node, ev.src_node))})
        if cells:
            src, dst = (list(c) for c in zip(*cells))
            fa.lat_mult[src, dst] = torch.tensor(self.lat_mult[src, dst],
                                                 device=dev)
        return fa

    # -- the CPU-plane send filter ----------------------------------------

    def filter_send(self, src_host, dst_host, packet, src_node: int,
                    dst_node: int, latency: int) -> tuple[bool, int]:
        """Apply the fault overlay to one cross-host send. Returns (drop,
        latency'). The corruption draw comes from the source host's RNG
        stream and happens only while a burst is active for that host, so
        a schedule without corruption never moves the stream."""
        if getattr(src_host, "fault_down", False) \
                or getattr(dst_host, "fault_down", False):
            return True, latency
        if self._node_map is not None:
            src_node = self._node_map.get(src_node, -1)
            dst_node = self._node_map.get(dst_node, -1)
        if (0 <= src_node < self.n_nodes and 0 <= dst_node < self.n_nodes):
            mult = int(self.lat_mult[src_node, dst_node])
            if mult > 1:
                latency = latency * mult
        i = self.host_index.get(src_host.name)
        if i is not None and self.corrupt_p[i] > 0.0 \
                and packet.payload_size() > 0 \
                and src_host.rng.random() < float(self.corrupt_p[i]):
            return True, latency
        return False, latency


def compile_schedule(faults_opts, *, host_names: list[str], n_nodes: int,
                     seed: int, stop_time_ns: int,
                     node_index=None) -> FaultSchedule:
    """`faults:` config block -> sorted `FaultSchedule`.

    `node_index` maps the config's graph node IDs to dense [0, M)
    indices for the device mask (identity when None). Events past
    `stop_time_ns` are kept (they simply never fire) but logged-free;
    events at t <= 0 are a config error — the schedule describes
    failures *during* the run."""
    host_set = set(host_names)
    events: list[FaultEvent] = []
    for i, raw in enumerate(faults_opts.events or []):
        events.extend(_parse_event(raw, i, host_set))
    if faults_opts.random:
        fseed = seed if faults_opts.seed is None else faults_opts.seed
        rng = Xoshiro256pp((fseed ^ _FAULT_SEED_SALT) & ((1 << 64) - 1))
        events.extend(_expand_random(faults_opts.random, list(host_names),
                                     rng))
    for ev in events:
        if ev.time_ns <= 0:
            raise ConfigError(
                f"faults: event {ev.describe()} must have at > 0")
    if node_index is not None:
        events = [
            (e if e.src_node is None else _reindex(e, node_index))
            for e in events
        ]
    # stable seq assignment AFTER expansion: config order, then
    # generator order — the same-instant tiebreak is reproducible
    events = [FaultEvent(**{**e.__dict__, "seq": i})
              for i, e in enumerate(events)]
    return FaultSchedule(events, list(host_names), n_nodes)


def _reindex(ev: FaultEvent, node_index) -> FaultEvent:
    try:
        s, d = node_index(ev.src_node), node_index(ev.dst_node)
    except (KeyError, ValueError):
        raise ConfigError(
            f"faults: event {ev.describe()} names a graph node that is "
            f"not used by any host") from None
    return FaultEvent(**{**ev.__dict__, "src_node": s, "dst_node": d})

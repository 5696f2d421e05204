"""The scenario DSL: declarative, seeded workload specs (jax-free).

The port's own copy of `shadow_tpu/workloads/spec.py` (the port imports
nothing of the JAX package): the same validation, messages, random
draws and tables, so fingerprints and program digests agree byte for
byte. Module paths in the text below name the JAX package's modules.

A *scenario* declares a fleet size, a window budget, and a list of
*pattern instances* — each a parameterized traffic shape over a
contiguous, non-overlapping range of hosts:

- ``ring_allreduce`` — the collective step structure of data-parallel
  training: ``steps`` ring hops per round, each participant sending one
  ``bytes`` chunk to its ring successor and advancing when the chunk
  from its predecessor lands (default ``steps = 2*(count-1)``, the
  reduce-scatter + all-gather hop count).
- ``all_to_all``     — expert/sequence-parallel shuffles: ``count-1``
  phases of a shifted permutation, host ``i`` sending to
  ``(i+1+s) mod count`` in phase ``s``.
- ``incast``         — the classic fan-in hotspot: ``count-1`` sources
  send to one sink, which acknowledges each round with a tiny control
  reply (closed-loop, so the event population stays bounded).
- ``rpc_fanout``     — request/response fan-out: a root sends
  ``req_bytes`` requests to ``count-1`` children; each child replies
  (``resp_bytes``) after a seeded per-(child, round) think time.
- ``onoff``          — per-host heavy-tail on/off CBR: bursts of
  ``burst`` packets to a seeded peer, OFF periods drawn from a bounded
  Pareto at compile time.

Everything random (peers, think times, off periods) is drawn by the
COMPILER from a numpy generator seeded with (scenario seed, pattern
index) — the device generator is purely table-driven, so the scenario
``fingerprint`` (and the traffic it produces) is a pure function of
(spec, seed). This module must stay importable without jax: configs are
parsed and validated on hosts that never touch the device plane.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

#: int32 virtual-time budget shared with the device plane
#: (path latency + window length < ~2.1 s, tpu/plane.py dtype discipline)
_I32_TIME_BUDGET = 2**31 - 1
#: the wire-size budget (SL506 input-domain registry,
#: analysis/ranges.py `BYTES_BUDGET` — pinned equal by
#: tests/test_ranges.py): capacity-scaled prefix sums over packet
#: bytes (the token-gate cumsum, per-window byte counters) must stay
#: inside int32, so one message caps at 16 MiB
_MAX_BYTES = 2**24

PATTERN_KINDS = ("ring_allreduce", "all_to_all", "incast", "rpc_fanout",
                 "onoff", "serve")


class ScenarioError(ValueError):
    """A scenario spec failed validation (the workload plane's
    ConfigError twin — raised at parse time, never mid-run)."""


def _req_int(raw: dict, key: str, where: str, *, default=None,
             lo: int = 0, hi: int = 2**31 - 1) -> int:
    v = raw.get(key, default)
    if v is None:
        raise ScenarioError(f"{where}: {key} is required")
    if isinstance(v, bool) or not isinstance(v, int):
        raise ScenarioError(f"{where}: {key} expected an integer, "
                            f"got {v!r}")
    if not (lo <= v <= hi):
        raise ScenarioError(f"{where}: {key}={v} out of range "
                            f"[{lo}, {hi}]")
    return v


def _req_float(raw: dict, key: str, where: str, *, default=None,
               lo: float = 0.0, hi: float = 1e12) -> float:
    v = raw.get(key, default)
    if v is None:
        raise ScenarioError(f"{where}: {key} is required")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ScenarioError(f"{where}: {key} expected a number, got {v!r}")
    if not (lo <= float(v) <= hi):
        raise ScenarioError(f"{where}: {key}={v} out of range "
                            f"[{lo}, {hi}]")
    return float(v)


@dataclass(frozen=True)
class PatternSpec:
    """One pattern instance over hosts [first, first + count)."""

    kind: str
    first: int
    count: int
    rounds: int
    bytes: int
    # rpc_fanout only
    resp_bytes: int = 64
    think_ns: int = 0
    think_jitter_ns: int = 0
    # onoff only
    burst: int = 0
    gap_ns: int = 0
    on_hold_ns: int = 0
    off_mean_ns: int = 0
    off_alpha: float = 1.5
    # serve only: open-loop arrival process (diurnal rate curve x
    # bounded-Pareto burst sizes) from `count - servers` clients
    # fanning into the first `servers` hosts of the range
    servers: int = 1
    mean_gap_ns: int = 0
    diurnal_period_ns: int = 0
    diurnal_amp: float = 0.0
    burst_cap: int = 8
    burst_alpha: float = 1.4

    def hosts(self) -> range:
        return range(self.first, self.first + self.count)

    def as_dict(self) -> dict:
        d = {"kind": self.kind, "first": self.first, "count": self.count,
             "rounds": self.rounds, "bytes": self.bytes}
        if self.kind == "rpc_fanout":
            d.update(resp_bytes=self.resp_bytes, think_ns=self.think_ns,
                     think_jitter_ns=self.think_jitter_ns)
        if self.kind == "onoff":
            d.update(burst=self.burst, gap_ns=self.gap_ns,
                     on_hold_ns=self.on_hold_ns,
                     off_mean_ns=self.off_mean_ns,
                     off_alpha=self.off_alpha)
        if self.kind == "serve":
            d.update(servers=self.servers, mean_gap_ns=self.mean_gap_ns,
                     diurnal_period_ns=self.diurnal_period_ns,
                     diurnal_amp=self.diurnal_amp,
                     burst_cap=self.burst_cap,
                     burst_alpha=self.burst_alpha)
        return d


@dataclass(frozen=True)
class ComputeSpec:
    """The scenario's ``compute:`` block — the per-host service model
    (`tpu/compute.py`): ``op`` names an entry of the checked-in
    op-timing table (`workloads/op_timings.json`, validated at compile
    time), ``queue_cap`` bounds the FIFO service queue."""

    op: str
    queue_cap: int = 64

    def as_dict(self) -> dict:
        return {"op": self.op, "queue_cap": self.queue_cap}


@dataclass(frozen=True)
class ServeSpec:
    """The scenario's ``serve:`` block — SLO targets for the recorded
    request-sojourn percentiles (docs/workloads.md "SLO record
    schema"). Targets are optional; when present the record carries a
    per-quantile ``met`` verdict next to the measured value."""

    p99_ns: Optional[int] = None
    p999_ns: Optional[int] = None

    def as_dict(self) -> dict:
        d: dict = {}
        if self.p99_ns is not None:
            d["p99_ns"] = self.p99_ns
        if self.p999_ns is not None:
            d["p999_ns"] = self.p999_ns
        return d


@dataclass(frozen=True)
class ScenarioSpec:
    """A validated scenario: fleet shape + pattern instances.

    ``transport`` selects how pattern sends reach the wire:
    ``direct`` (default) emits raw packets and credits phases on raw
    deliveries — the lossless contract; ``flows`` routes every send
    through the device flow plane (`tpu/flows.py`: cwnd/RTO/go-back-N
    retransmit), phases credit ACKED in-order segments, and the
    scenario may declare a non-zero uniform ``loss_p`` — the lossy
    half of the corpus (docs/robustness.md "Flow plane")."""

    name: str
    family: str  # the headline pattern family (corpus bookkeeping)
    seed: int
    n_hosts: int
    windows: int
    window_ns: int
    egress_cap: int
    ingress_cap: int
    transport: str = "direct"  # direct | flows
    loss_p: float = 0.0  # uniform path-loss probability
    compute: Optional[ComputeSpec] = None  # per-host service model
    serve: Optional[ServeSpec] = None  # SLO targets for the record
    patterns: tuple[PatternSpec, ...] = field(default_factory=tuple)

    def as_dict(self) -> dict:
        d = {
            "name": self.name, "family": self.family, "seed": self.seed,
            "hosts": self.n_hosts, "windows": self.windows,
            "window_ns": self.window_ns, "egress_cap": self.egress_cap,
            "ingress_cap": self.ingress_cap,
            "patterns": [p.as_dict() for p in self.patterns],
        }
        # non-default transport/loss/compute/serve keys only: the
        # canonical serialization (and therefore every existing
        # fingerprint) must not change under a default-valued new
        # field
        if self.transport != "direct":
            d["transport"] = self.transport
        if self.loss_p:
            d["loss_p"] = self.loss_p
        if self.compute is not None:
            d["compute"] = self.compute.as_dict()
        if self.serve is not None:
            d["serve"] = self.serve.as_dict()
        return d


def _parse_pattern(raw: Any, idx: int, n_hosts: int) -> PatternSpec:
    where = f"scenario.patterns[{idx}]"
    if not isinstance(raw, dict):
        raise ScenarioError(f"{where}: expected a mapping, got "
                            f"{type(raw).__name__}")
    kind = raw.get("kind")
    if kind not in PATTERN_KINDS:
        raise ScenarioError(
            f"{where}: kind expected one of {'|'.join(PATTERN_KINDS)}, "
            f"got {kind!r}")
    known = {"kind", "first", "count", "rounds", "bytes"}
    if kind == "rpc_fanout":
        known |= {"resp_bytes", "think_ns", "think_jitter_ns"}
    if kind == "onoff":
        known |= {"burst", "gap_ns", "on_hold_ns", "off_mean_ns",
                  "off_alpha"}
    if kind == "serve":
        known |= {"servers", "mean_gap_ns", "diurnal_period_ns",
                  "diurnal_amp", "burst_cap", "burst_alpha"}
    unknown = set(map(str, raw)) - known
    if unknown:
        raise ScenarioError(
            f"{where}: unknown {kind} option(s) {sorted(unknown)}")
    first = _req_int(raw, "first", where, default=0, lo=0,
                     hi=n_hosts - 1)
    min_count = 1 if kind == "onoff" else 2
    count = _req_int(raw, "count", where, default=n_hosts - first,
                     lo=min_count, hi=n_hosts - first)
    rounds = _req_int(raw, "rounds", where, default=1, lo=1, hi=4096)
    nbytes = _req_int(raw, "bytes", where, default=1400, lo=1,
                      hi=_MAX_BYTES)
    kw: dict = {}
    if kind == "rpc_fanout":
        kw["resp_bytes"] = _req_int(raw, "resp_bytes", where, default=64,
                                    lo=1, hi=_MAX_BYTES)
        kw["think_ns"] = _req_int(raw, "think_ns", where, default=0,
                                  lo=0, hi=_I32_TIME_BUDGET // 4)
        kw["think_jitter_ns"] = _req_int(
            raw, "think_jitter_ns", where, default=0, lo=0,
            hi=_I32_TIME_BUDGET // 4)
    if kind == "onoff":
        kw["burst"] = _req_int(raw, "burst", where, default=4, lo=1,
                               hi=256)
        kw["gap_ns"] = _req_int(raw, "gap_ns", where, default=100_000,
                                lo=0, hi=_I32_TIME_BUDGET // 4)
        # cross-field: the last burst lane's delay is (burst-1)*gap_ns
        # and must fit the int32 delay table (per-field bounds alone
        # admit 255 * I32/4, which overflows at compile)
        if (kw["burst"] - 1) * kw["gap_ns"] > _I32_TIME_BUDGET // 4:
            raise ScenarioError(
                f"{where}: (burst-1)*gap_ns = "
                f"{(kw['burst'] - 1) * kw['gap_ns']} ns exceeds the "
                f"int32 emission-delay budget "
                f"({_I32_TIME_BUDGET // 4} ns); shrink burst or gap_ns")
        kw["on_hold_ns"] = _req_int(raw, "on_hold_ns", where,
                                    default=0, lo=0,
                                    hi=_I32_TIME_BUDGET // 4)
        kw["off_mean_ns"] = _req_int(raw, "off_mean_ns", where,
                                     default=5_000_000, lo=1,
                                     hi=_I32_TIME_BUDGET // 4)
        kw["off_alpha"] = _req_float(raw, "off_alpha", where,
                                     default=1.5, lo=1.01, hi=10.0)
    if kind == "serve":
        kw["servers"] = _req_int(raw, "servers", where, default=1,
                                 lo=1, hi=count - 1)
        kw["mean_gap_ns"] = _req_int(raw, "mean_gap_ns", where,
                                     default=5_000_000, lo=1,
                                     hi=_I32_TIME_BUDGET // 4)
        kw["diurnal_period_ns"] = _req_int(
            raw, "diurnal_period_ns", where, default=0, lo=0,
            hi=_I32_TIME_BUDGET)
        kw["diurnal_amp"] = _req_float(raw, "diurnal_amp", where,
                                       default=0.0, lo=0.0, hi=0.95)
        kw["burst_cap"] = _req_int(raw, "burst_cap", where, default=8,
                                   lo=1, hi=64)
        kw["burst_alpha"] = _req_float(raw, "burst_alpha", where,
                                       default=1.4, lo=1.01, hi=10.0)
        if kw["diurnal_amp"] > 0 and kw["diurnal_period_ns"] == 0:
            raise ScenarioError(
                f"{where}: diurnal_amp={kw['diurnal_amp']} needs a "
                "non-zero diurnal_period_ns (a rate curve with no "
                "period is a constant)")
    return PatternSpec(kind=kind, first=first, count=count,
                       rounds=rounds, bytes=nbytes, **kw)


def parse_scenario(raw: Any, *, seed: Optional[int] = None) -> ScenarioSpec:
    """Parse + validate a scenario mapping (the body of a standalone
    scenario YAML's ``scenario:`` key, or a ``workload:`` config
    block's inline scenario). `seed` overrides the spec's own."""
    if isinstance(raw, dict) and set(raw) == {"scenario"}:
        raw = raw["scenario"]
    if not isinstance(raw, dict):
        raise ScenarioError(
            f"scenario: expected a mapping, got {type(raw).__name__}")
    known = {"name", "family", "seed", "hosts", "windows", "window_ns",
             "egress_cap", "ingress_cap", "patterns", "transport",
             "loss_p", "compute", "serve"}
    unknown = set(map(str, raw)) - known
    if unknown:
        raise ScenarioError(f"scenario: unknown option(s) "
                            f"{sorted(unknown)}")
    name = raw.get("name")
    if not isinstance(name, str) or not name:
        raise ScenarioError("scenario: name is required (a non-empty "
                            "string)")
    n_hosts = _req_int(raw, "hosts", "scenario", lo=2, hi=1 << 20)
    spec_seed = seed if seed is not None else _req_int(
        raw, "seed", "scenario", default=1, lo=0)
    windows = _req_int(raw, "windows", "scenario", default=64, lo=1,
                       hi=1 << 16)
    window_ns = _req_int(raw, "window_ns", "scenario",
                         default=10_000_000, lo=1_000,
                         hi=_I32_TIME_BUDGET // 4)
    egress_cap = _req_int(raw, "egress_cap", "scenario", default=16,
                          lo=1, hi=1 << 16)
    ingress_cap = _req_int(raw, "ingress_cap", "scenario", default=32,
                           lo=1, hi=1 << 16)
    transport = raw.get("transport", "direct")
    if transport not in ("direct", "flows"):
        raise ScenarioError(
            f"scenario: transport expected direct|flows, got "
            f"{transport!r}")
    loss_p = _req_float(raw, "loss_p", "scenario", default=0.0,
                        lo=0.0, hi=0.9)
    if loss_p > 0 and transport != "flows":
        # the lossless caveat, now ENFORCED instead of documented: the
        # direct phase machine has no retransmit layer, so a lost
        # dependency would stall a collective forever
        raise ScenarioError(
            f"scenario: loss_p={loss_p} requires `transport: flows` — "
            "direct-transport phases credit raw deliveries and have "
            "no retransmit layer, so any loss stalls the scenario "
            "(docs/robustness.md 'Flow plane')")
    if transport == "flows" and window_ns < 1_000_000:
        raise ScenarioError(
            f"scenario: `transport: flows` needs window_ns >= 1ms "
            f"(got {window_ns}): the flow plane's RTO clock advances "
            "in whole milliseconds per window (tpu/flows.py)")
    compute = None
    raw_compute = raw.get("compute")
    if raw_compute is not None:
        if not isinstance(raw_compute, dict):
            raise ScenarioError(
                f"scenario.compute: expected a mapping, got "
                f"{type(raw_compute).__name__}")
        unknown = set(map(str, raw_compute)) - {"op", "queue_cap"}
        if unknown:
            raise ScenarioError(f"scenario.compute: unknown option(s) "
                                f"{sorted(unknown)}")
        op = raw_compute.get("op")
        if not isinstance(op, str) or not op:
            raise ScenarioError(
                "scenario.compute: op is required (a non-empty name "
                "from workloads/op_timings.json)")
        compute = ComputeSpec(
            op=op,
            queue_cap=_req_int(raw_compute, "queue_cap",
                               "scenario.compute", default=64, lo=1,
                               hi=4096))
    serve_spec = None
    raw_serve = raw.get("serve")
    if raw_serve is not None:
        if not isinstance(raw_serve, dict):
            raise ScenarioError(
                f"scenario.serve: expected a mapping, got "
                f"{type(raw_serve).__name__}")
        unknown = set(map(str, raw_serve)) - {"p99_ns", "p999_ns"}
        if unknown:
            raise ScenarioError(f"scenario.serve: unknown option(s) "
                                f"{sorted(unknown)}")
        targets = {}
        for key in ("p99_ns", "p999_ns"):
            if raw_serve.get(key) is not None:
                targets[key] = _req_int(raw_serve, key,
                                        "scenario.serve", lo=1,
                                        hi=_I32_TIME_BUDGET)
        serve_spec = ServeSpec(**targets)
    raw_patterns = raw.get("patterns")
    if not isinstance(raw_patterns, list) or not raw_patterns:
        raise ScenarioError("scenario: patterns must be a non-empty "
                            "list")
    patterns = tuple(_parse_pattern(p, i, n_hosts)
                     for i, p in enumerate(raw_patterns))
    if any(p.kind == "serve" for p in patterns):
        # open-loop arrivals are meaningless without the service model
        # they are measured against, and the server tier's single
        # aggregate-dep phase is only deterministic when credits come
        # from the flow plane's ACKED in-order count
        if transport != "flows":
            raise ScenarioError(
                "scenario: serve patterns require `transport: flows` — "
                "server phases credit ACKED in-order segments, not raw "
                "deliveries (docs/workloads.md 'Serving load')")
        if compute is None:
            raise ScenarioError(
                "scenario: serve patterns require a `compute:` block — "
                "the open-loop arrival process is measured against the "
                "host service model (docs/workloads.md 'Serving load')")
    # host ranges must not overlap: each host carries exactly one phase
    # program (the compiler's phase axis is per-host, docs/workloads.md)
    claimed: dict[int, int] = {}
    for i, p in enumerate(patterns):
        for h in p.hosts():
            if h in claimed:
                raise ScenarioError(
                    f"scenario.patterns[{i}]: host {h} already claimed "
                    f"by patterns[{claimed[h]}] — pattern host ranges "
                    f"must be disjoint")
            claimed[h] = i
    family = raw.get("family", patterns[0].kind)
    if family not in PATTERN_KINDS:
        raise ScenarioError(
            f"scenario: family expected one of "
            f"{'|'.join(PATTERN_KINDS)}, got {family!r}")
    return ScenarioSpec(
        name=name, family=family, seed=spec_seed, n_hosts=n_hosts,
        windows=windows, window_ns=window_ns, egress_cap=egress_cap,
        ingress_cap=ingress_cap, transport=transport, loss_p=loss_p,
        compute=compute, serve=serve_spec, patterns=patterns)


def load_scenario_file(path: str, *,
                       seed: Optional[int] = None) -> ScenarioSpec:
    with open(path) as fh:
        raw = yaml.safe_load(fh)
    return parse_scenario(raw, seed=seed)


def scenario_fingerprint(spec: ScenarioSpec) -> str:
    """sha256 over the canonical spec serialization — a pure function
    of (spec, seed), pinned by tests: two parses of the same YAML (or
    the same spec built programmatically) fingerprint identically, and
    any field change (including the seed) changes it. The corpus
    runner stores it next to each golden digest so a digest mismatch
    distinguishes 'the scenario changed' from 'determinism broke'."""
    blob = json.dumps(spec.as_dict(), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()

"""Scenario -> traffic program: lower the DSL to SoA phase tables.

The port's own copy of `shadow_tpu/workloads/compile.py` (the port imports
nothing of the JAX package): the same validation, messages, random
draws and tables, so fingerprints and program digests agree byte for
byte. Module paths in the text below name the JAX package's modules.

A compiled scenario is a *traffic program*: dense numpy tables the
device generator (`workloads/device.py`) walks without ever consulting
the spec again. Per (host, phase):

- ``dep[N, P]``       — deliveries the host must receive while in phase
  p before it may advance (the dependency count of a collective step,
  an RPC reply quota, an incast fan-in);
- ``hold_ns[N, P]``   — minimum virtual time in phase p before it may
  advance (on/off pacing; quantized to the window cadence by the
  device generator, docs/workloads.md "Determinism contract");
- ``send_peer/send_bytes/send_delay[N, P, K]`` — the messages emitted
  on ENTERING phase p (peer -1 = unused lane); ``send_delay`` offsets
  the emission time within the entry window (RPC think time, CBR
  burst gaps), shifting delivery exactly like the CPU plane's
  now + latency;
- ``n_phases[N]``     — the host's terminal phase (0 = not a
  participant: the host starts done and never emits).

Everything seeded (onoff peers and off periods, rpc think jitter) is
drawn HERE from ``np.random.default_rng((seed, pattern_index))`` — the
program, and therefore the traffic, is a pure function of (spec, seed);
``program_digest`` pins that (tests/test_workloads.py).

Phase semantics (shared with device.py — keep in sync):
- entering phase p emits ``sends[p]``; leaving phase p requires
  ``dep[p]`` deliveries received while in p AND ``hold_ns[p]``
  elapsed;
- hosts start IN phase 0 with its sends emitted by the driver's prime
  batch (`device.prime_batch`);
- a host at ``phase == n_phases`` is done.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from .spec import PatternSpec, ScenarioError, ScenarioSpec

#: ack/control message size for closed-loop patterns (incast)
ACK_BYTES = 64


class TrafficProgram(NamedTuple):
    """SoA phase tables (numpy; `device.to_device` uploads them).

    The trailing flow fields exist only under ``transport: flows``
    (`_lower_flows`): one flow per distinct (src, dst, bytes) send
    triple, plus the [N, P, K] lane -> flow id bridge the generator's
    `enqueue` path consults. They stay None on direct-transport
    programs so the first six fields — and therefore
    `program_digest` of every existing corpus entry — are unchanged."""

    dep: np.ndarray  # [N, P] int32
    hold_ns: np.ndarray  # [N, P] int32
    send_peer: np.ndarray  # [N, P, K] int32 (-1 = unused lane)
    send_bytes: np.ndarray  # [N, P, K] int32
    send_delay: np.ndarray  # [N, P, K] int32 ns within the entry window
    n_phases: np.ndarray  # [N] int32 terminal phase per host
    n_hosts: int
    max_phases: int  # P
    max_sends: int  # K
    flow_src: np.ndarray | None = None  # [F] int32 (-1 = pad slot)
    flow_dst: np.ndarray | None = None  # [F] int32
    flow_bytes: np.ndarray | None = None  # [F] int32
    lane_flow: np.ndarray | None = None  # [N, P, K] int32 (-1 = none)
    #: per-(host, phase) service cost, lowered from the scenario's
    #: ``compute:`` block + the checked-in op-timing table
    #: (`serve.lower_service_table`); None without a compute block, so
    #: pre-compute programs digest unchanged
    compute_service_ns: np.ndarray | None = None  # [N, P] int32


class _Builder:
    """Accumulates per-host phase lists before padding to [N, P, K]."""

    def __init__(self, n_hosts: int, claimed: frozenset[int] = frozenset()):
        self.n = n_hosts
        #: hosts claimed by ANY pattern instance — peer pools that fall
        #: back to the fleet must avoid them (traffic into another
        #: pattern's host would anonymously satisfy its dependencies)
        self.claimed = claimed
        # per host: list of (dep, hold_ns, [(peer, bytes, delay), ...])
        self.phases: list[list[tuple]] = [[] for _ in range(n_hosts)]

    def add_phase(self, host: int, dep: int = 0, hold_ns: int = 0,
                  sends: list[tuple[int, int, int]] = ()):
        self.phases[host].append((dep, hold_ns, list(sends)))

    def finish(self) -> TrafficProgram:
        P = max((len(p) for p in self.phases), default=0)
        K = max((len(s) for p in self.phases for (_, _, s) in p),
                default=0)
        P, K = max(P, 1), max(K, 1)
        dep = np.zeros((self.n, P), np.int32)
        hold = np.zeros((self.n, P), np.int32)
        peer = np.full((self.n, P, K), -1, np.int32)
        nbytes = np.zeros((self.n, P, K), np.int32)
        delay = np.zeros((self.n, P, K), np.int32)
        n_phases = np.zeros((self.n,), np.int32)
        for h, plist in enumerate(self.phases):
            n_phases[h] = len(plist)
            for p, (d, hld, sends) in enumerate(plist):
                dep[h, p] = d
                hold[h, p] = hld
                for k, (pr, by, dl) in enumerate(sends):
                    peer[h, p, k] = pr
                    nbytes[h, p, k] = by
                    delay[h, p, k] = dl
        return TrafficProgram(
            dep=dep, hold_ns=hold, send_peer=peer, send_bytes=nbytes,
            send_delay=delay, n_phases=n_phases, n_hosts=self.n,
            max_phases=P, max_sends=K)


def _compile_ring_allreduce(b: _Builder, p: PatternSpec, rng):
    """`steps = 2*(count-1)` ring hops per round (reduce-scatter +
    all-gather): in every step, participant i sends one chunk to its
    ring successor and advances on the chunk from its predecessor."""
    steps = 2 * (p.count - 1)
    for i in range(p.count):
        h = p.first + i
        succ = p.first + (i + 1) % p.count
        for _ in range(p.rounds * steps):
            b.add_phase(h, dep=1, sends=[(succ, p.bytes, 0)])


def _compile_all_to_all(b: _Builder, p: PatternSpec, rng):
    """count-1 shifted-permutation phases per round: in phase s,
    participant i sends to (i+1+s) mod count and advances on the
    message from (i-1-s) mod count."""
    for i in range(p.count):
        h = p.first + i
        for _ in range(p.rounds):
            for s in range(p.count - 1):
                peer = p.first + (i + 1 + s) % p.count
                b.add_phase(h, dep=1, sends=[(peer, p.bytes, 0)])


def _compile_incast(b: _Builder, p: PatternSpec, rng):
    """Closed-loop fan-in: count-1 sources send `bytes` at the sink
    (host `first`); the sink, once all fan-in arrives, acks each
    source with a tiny control message, releasing the next round."""
    sink = p.first
    fanin = p.count - 1
    sources = [p.first + 1 + i for i in range(fanin)]
    for r in range(p.rounds):
        # sink: wait for the fan-in, then an ack-emission pass-through
        # phase (dep=0 -> the generator advances through it in the
        # same window it entered)
        b.add_phase(sink, dep=fanin)
        b.add_phase(sink, dep=0,
                    sends=[(s, ACK_BYTES, 0) for s in sources])
    for s in sources:
        for r in range(p.rounds):
            b.add_phase(s, dep=1, sends=[(sink, p.bytes, 0)])


def _compile_rpc_fanout(b: _Builder, p: PatternSpec, rng):
    """Request/response fan-out with think time: the root (host
    `first`) sends `bytes` requests to count-1 children; each child
    replies `resp_bytes` after a seeded per-(child, round) think
    delay; the root advances on the full reply quota."""
    root = p.first
    fanout = p.count - 1
    children = [p.first + 1 + i for i in range(fanout)]
    for r in range(p.rounds):
        b.add_phase(root, dep=fanout,
                    sends=[(c, p.bytes, 0) for c in children])
    # think[c, r]: base + uniform jitter, drawn in (child, round) order
    # so the stream is independent of compilation batching
    think = np.full((fanout, p.rounds), p.think_ns, np.int64)
    if p.think_jitter_ns:
        think = think + rng.integers(
            0, p.think_jitter_ns + 1, size=(fanout, p.rounds))
    for ci, c in enumerate(children):
        # phase r waits for round r's request; entering phase r+1
        # emits round r's reply (think time as an emission delay)
        for r in range(p.rounds):
            b.add_phase(c, dep=1)
            b.add_phase(c, dep=0,
                        sends=[(root, p.resp_bytes,
                                int(think[ci, r]))])


def _compile_onoff(b: _Builder, p: PatternSpec, rng):
    """Per-host on/off CBR with heavy-tail OFF periods: each cycle
    emits a `burst` of packets (gap_ns apart) at a seeded peer, holds
    `on_hold_ns`, then sleeps a bounded-Pareto OFF period. Peers are
    drawn over the pattern's own range when it spans more than one
    host, else over the fleet's UNCLAIMED hosts — traffic into another
    pattern's participants would anonymously satisfy their phase
    dependencies (deliveries credit the receiver's current phase, so a
    stray CBR packet would stand in for a collective chunk)."""
    cap = 2**29
    # Pareto scale for the requested mean: mean = x_m * a / (a - 1)
    x_m = max(1, int(p.off_mean_ns * (p.off_alpha - 1) / p.off_alpha))
    if p.count > 1:
        pool = [p.first + i for i in range(p.count)]
    else:
        pool = [x for x in range(b.n)
                if x == p.first or x not in b.claimed]
        if len(pool) < 2:
            raise ScenarioError(
                "onoff: a single-host pattern needs at least one "
                "unclaimed fleet host to target — every other host is "
                "claimed by another pattern; widen the onoff range or "
                "free a host")
    pool_arr = np.asarray(pool, np.int64)
    for i in range(p.count):
        h = p.first + i
        # all draws for host h come from h's own substream slice:
        # (cycle-ordered peer draws, then off draws) per host. The
        # skip-self draw is index arithmetic (r + (r >= self_idx)),
        # draw-for-draw identical to indexing a pool-minus-self list
        # but O(rounds) instead of O(count) per host
        self_idx = i if p.count > 1 else pool.index(h)
        r = rng.integers(0, len(pool) - 1, size=p.rounds)
        peers = pool_arr[r + (r >= self_idx)]
        u = rng.random(size=p.rounds)
        off = np.minimum((x_m * (1.0 - u) ** (-1.0 / p.off_alpha))
                         .astype(np.int64), cap).astype(np.int64)
        for c in range(p.rounds):
            sends = [(int(peers[c]), p.bytes, k * p.gap_ns)
                     for k in range(p.burst)]
            b.add_phase(h, dep=0, hold_ns=p.on_hold_ns, sends=sends)
            b.add_phase(h, dep=0, hold_ns=int(off[c]))


def _compile_serve(b: _Builder, p: PatternSpec, rng):
    """Open-loop serving arrivals (`serve._compile_serve` — kept in
    its own module with the op-timing machinery it pairs with)."""
    from . import serve
    serve._compile_serve(b, p, rng)


_COMPILERS = {
    "ring_allreduce": _compile_ring_allreduce,
    "all_to_all": _compile_all_to_all,
    "incast": _compile_incast,
    "rpc_fanout": _compile_rpc_fanout,
    "onoff": _compile_onoff,
    "serve": _compile_serve,
}


def _lower_flows(prog: TrafficProgram) -> TrafficProgram:
    """Enumerate the program's flows (``transport: flows``): one flow
    per distinct (src host, dst host, bytes) send triple, ids assigned
    in deterministic first-use order over (host, phase, lane) — a pure
    function of the program tables, so the flow layout rides the
    program digest. Fills `flow_src`/`flow_dst`/`flow_bytes` plus the
    `lane_flow` bridge. One segment = one message of the triple's
    byte size, so the phase dependency counts carry over unchanged.

    NOTE the per-lane ``send_delay`` does NOT survive the flow
    transport: emission is window-quantized by the flow plane's
    cwnd-gated window, so sub-window think/burst offsets quantize to
    the emission window (docs/workloads.md determinism contract)."""
    N, P, K = prog.send_peer.shape
    ids: dict[tuple[int, int, int], int] = {}
    lane_flow = np.full((N, P, K), -1, np.int32)
    for h in range(N):
        for p in range(int(prog.n_phases[h])):
            for k in range(K):
                peer = int(prog.send_peer[h, p, k])
                if peer < 0:
                    continue
                key = (h, peer, int(prog.send_bytes[h, p, k]))
                lane_flow[h, p, k] = ids.setdefault(key, len(ids))
    F = max(1, len(ids))  # >= 1 pad slot: zero-size arrays trace badly
    src = np.full((F,), -1, np.int32)
    dst = np.full((F,), -1, np.int32)
    nbytes = np.zeros((F,), np.int32)
    for (h, peer, by), f in ids.items():
        src[f], dst[f], nbytes[f] = h, peer, by
    return prog._replace(flow_src=src, flow_dst=dst, flow_bytes=nbytes,
                         lane_flow=lane_flow)


def compile_program(spec: ScenarioSpec) -> TrafficProgram:
    """Lower a validated scenario to its traffic program. Each pattern
    instance draws from its own `default_rng((seed, index))` substream,
    so adding a pattern never perturbs the others' draws."""
    b = _Builder(spec.n_hosts, claimed=frozenset(
        h for pat in spec.patterns for h in pat.hosts()))
    for idx, pat in enumerate(spec.patterns):
        rng = np.random.default_rng((spec.seed, idx))
        _COMPILERS[pat.kind](b, pat, rng)
    prog = b.finish()
    if prog.max_sends > spec.egress_cap:
        raise ScenarioError(
            f"scenario {spec.name!r}: a single phase emits up to "
            f"{prog.max_sends} messages from one host but "
            f"egress_cap={spec.egress_cap} — the append would be "
            f"guaranteed to overflow; raise egress_cap or shrink the "
            f"fan-out/burst")
    if spec.transport == "flows":
        prog = _lower_flows(prog)
    if spec.compute is not None:
        from . import serve
        prog = prog._replace(
            compute_service_ns=serve.lower_service_table(spec, prog))
    return prog


def program_digest(prog: TrafficProgram) -> str:
    """sha256 over the program tables — the compile-determinism pin:
    equal (spec, seed) must produce byte-equal tables. Flow tables
    (``transport: flows``) fold in only when present, so every
    direct-transport program's digest is unchanged by their
    existence."""
    h = hashlib.sha256()
    for arr in prog[:6]:
        a = np.asarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(f"{prog.n_hosts}/{prog.max_phases}/{prog.max_sends}"
             .encode())
    if prog.flow_src is not None:
        for arr in (prog.flow_src, prog.flow_dst, prog.flow_bytes,
                    prog.lane_flow):
            a = np.asarray(arr)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    if prog.compute_service_ns is not None:
        # the lowered op-timing costs ride the digest, so editing the
        # checked-in table invalidates every memo/golden entry that
        # consumed it (tests/test_compute.py drift guard)
        a = np.asarray(prog.compute_service_ns)
        h.update(b"compute")
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()

"""The serving subsystem's compile half (jax-free, like spec/compile).

The port's own copy of `shadow_tpu/workloads/serve.py` (the port imports
nothing of the JAX package): the same validation, messages, random
draws and tables, so fingerprints and program digests agree byte for
byte. Module paths in the text below name the JAX package's modules.

Two responsibilities, both pure functions of checked-in inputs:

1. **The open-loop ``serve`` pattern compiler** (`_compile_serve`,
   registered in `compile._COMPILERS`): a seeded arrival process over a
   client population. The pattern range's first ``servers`` hosts form
   the server tier; the remaining ``count - servers`` hosts are
   clients. Each client, after a seeded stagger phase (so the
   population does not fire in lockstep), emits ``rounds`` request
   batches: the inter-batch gap is exponential with a diurnal-modulated
   mean (``rate(t) = (1 + diurnal_amp * sin(2*pi*t /
   diurnal_period_ns)) / mean_gap_ns``, t = the client's own
   accumulated virtual send clock), the batch size is a bounded Pareto
   (``x_m = 1``, tail ``burst_alpha``, hard cap ``burst_cap``), and the
   target server is drawn uniformly. All draws come from the pattern's
   `default_rng((seed, index))` substream in (client, round) order —
   SL102: the device generator stays table-driven, no host-side RNG
   stream. Servers carry ONE aggregate phase whose dependency count is
   the total number of requests compiled at them, which is only
   deterministic under ``transport: flows`` (phases credit ACKED
   in-order segments; the spec parser enforces the pairing).

2. **Service-cost lowering** (`lower_service_table`): turn the
   scenario's ``compute: {op, queue_cap}`` block into the per-(host,
   phase) ``service_ns`` table the compute plane (`tpu/compute.py`)
   meters against, using the checked-in op-timing table
   ``workloads/op_timings.json`` (SCALE-Sim-validated affine per-op
   costs, arxiv 2603.22535: ``fixed_ns + per_kib_ns *
   ceil(bytes/1024)``). Only dep-bearing phases get a cost — a phase
   that waits on deliveries services them; emission-only phases
   (client request batches, incast acks) are compute-transparent. The
   lowered table is bounded at compile time so no int32 completion
   clock can overflow: ``svc_ns * (ingress_cap + queue_cap + 1)`` must
   fit the quarter budget (`tpu/plane.py` dtype discipline).

The op-timing table is drift-guarded: `op_timings_digest` is pinned by
tests/test_compute.py, and the table rides `compile.program_digest`
through the lowered ``compute_service_ns`` field, so editing a timing
invalidates every memo/golden entry that consumed it.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from functools import lru_cache

import numpy as np

from .spec import ScenarioError, ScenarioSpec, _I32_TIME_BUDGET

#: the checked-in per-op timing table (affine ns cost per request)
OP_TIMINGS_PATH = os.path.join(os.path.dirname(__file__),
                               "op_timings.json")


@lru_cache(maxsize=None)
def _load_raw(path: str) -> tuple[bytes, dict]:
    with open(path, "rb") as fh:
        blob = fh.read()
    raw = json.loads(blob)
    if not isinstance(raw, dict) or not isinstance(raw.get("ops"), dict):
        raise ScenarioError(
            f"op timing table {path}: expected a mapping with an "
            "'ops' mapping")
    for name, ent in raw["ops"].items():
        if (not isinstance(ent, dict)
                or not isinstance(ent.get("fixed_ns"), int)
                or not isinstance(ent.get("per_kib_ns"), int)
                or ent["fixed_ns"] < 0 or ent["per_kib_ns"] < 0):
            raise ScenarioError(
                f"op timing table {path}: op {name!r} needs "
                "non-negative integer fixed_ns and per_kib_ns")
    return blob, raw


def load_op_timings(path: str = OP_TIMINGS_PATH) -> dict:
    """The validated ``ops`` mapping (cached; schema-checked)."""
    return _load_raw(path)[1]["ops"]


def op_timings_digest(path: str = OP_TIMINGS_PATH) -> str:
    """sha256 over the table FILE BYTES — the drift guard tests pin
    (any edit, even whitespace, is a deliberate re-pin)."""
    return hashlib.sha256(_load_raw(path)[0]).hexdigest()


def op_service_ns(op: str, nbytes: int,
                  path: str = OP_TIMINGS_PATH) -> int:
    """Per-request service cost of ``op`` on an ``nbytes`` request."""
    ops = load_op_timings(path)
    if op not in ops:
        raise ScenarioError(
            f"compute.op {op!r} not in the op timing table "
            f"({sorted(ops)})")
    ent = ops[op]
    return int(ent["fixed_ns"]
               + ent["per_kib_ns"] * ((int(nbytes) + 1023) // 1024))


def _compile_serve(b, p, rng):
    """Lower one ``serve`` pattern instance (see module docstring).

    Draw order is (client, round): per client one stagger draw, then
    per round (u_gap, u_burst, server index) — adding rounds extends a
    client's tail without perturbing other clients' streams only in
    aggregate (the whole pattern shares one substream, like onoff's
    per-host slices: a pure function of (seed, pattern index))."""
    gap_cap = _I32_TIME_BUDGET // 4
    servers = [p.first + i for i in range(p.servers)]
    clients = [p.first + p.servers + i
               for i in range(p.count - p.servers)]
    server_load = {s: 0 for s in servers}
    for c in clients:
        # stagger: a seeded hold before the first batch so the
        # open-loop population decorrelates (every client entering
        # phase 0 in the prime batch would otherwise fire in lockstep)
        stagger = int(rng.integers(0, p.mean_gap_ns + 1))
        b.add_phase(c, dep=0, hold_ns=stagger)
        t = stagger  # the client's virtual send clock (diurnal phase)
        for _ in range(p.rounds):
            rate_mult = 1.0
            if p.diurnal_amp > 0.0:
                rate_mult += p.diurnal_amp * math.sin(
                    2.0 * math.pi * (t % p.diurnal_period_ns)
                    / p.diurnal_period_ns)
            u = rng.random()
            gap = int(min(-math.log1p(-u) * p.mean_gap_ns / rate_mult,
                          gap_cap))
            burst = min(p.burst_cap,
                        int((1.0 - rng.random()) ** (-1.0
                                                     / p.burst_alpha)))
            srv = servers[int(rng.integers(0, len(servers)))]
            server_load[srv] += burst
            b.add_phase(c, dep=0, hold_ns=gap,
                        sends=[(srv, p.bytes, 0)] * burst)
            t += gap
    for s in servers:
        # one aggregate phase: done when every request compiled at this
        # server has been ACKED through the flow plane (and, with the
        # compute plane on, serviced — gate_credits meters the count)
        b.add_phase(s, dep=server_load[s])


def lower_service_table(spec: ScenarioSpec, prog) -> np.ndarray:
    """The [N, P] int32 per-(host, phase) service table (see module
    docstring): ``op_service_ns(op, pattern bytes)`` on dep-bearing
    phases, 0 elsewhere. Bounds the worst completion clock inside the
    int32 quarter budget before anything reaches the device."""
    assert spec.compute is not None
    svc = np.zeros_like(prog.dep, dtype=np.int32)
    for pat in spec.patterns:
        cost = op_service_ns(spec.compute.op, pat.bytes)
        hosts = list(pat.hosts())
        svc[hosts] = np.where(prog.dep[hosts] > 0, cost, 0)
    worst = int(svc.max()) * (spec.ingress_cap
                              + spec.compute.queue_cap + 1)
    if worst > _I32_TIME_BUDGET // 4:
        raise ScenarioError(
            f"scenario {spec.name!r}: compute op "
            f"{spec.compute.op!r} costs up to {int(svc.max())} ns per "
            f"request; a full queue + window of arrivals could push a "
            f"completion clock to {worst} ns, past the int32 budget "
            f"({_I32_TIME_BUDGET // 4} ns) — shrink queue_cap, "
            f"ingress_cap, or the request bytes")
    return svc

"""The capacity policy: ring sizing as an explicit, auditable policy.

The port's own copy of `shadow_tpu/core/capacity.py`, which imports no
JAX either; the port imports nothing of `shadow_tpu`. The device plane's
rings are fixed-size (`tpu/plane.make_state(egress_cap, ingress_cap)`),
and a ring-full overflow is counted in `n_overflow_dropped`. The policy
says what a driver does about it:

- ``fixed``   — overflow is counted and dropped, and the first drop of
  each ring lands a structured trajectory event;
- ``strict``  — any ring-full overflow raises :class:`CapacityError`
  with per-host blame: the run refuses to diverge from the reference's
  unbounded queues;
- ``elastic`` — the driver snapshots the state before each chain; on
  overflow the offending ring doubles (to the next power of two,
  bounded by ``max_doublings``) and the chain re-executes from the
  snapshot, so the run ends as one pre-provisioned at the final
  capacity would (`tpu/elastic.py`, which holds the device half).

Every decision lands in the :class:`CapacityTrajectory`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

log = logging.getLogger("shadow_tpu_torch.capacity")

#: valid capacity modes
CAPACITY_MODES = ("fixed", "strict", "elastic")


class CapacityError(RuntimeError):
    """Ring-full overflow under the `strict` capacity policy: the
    simulation would have diverged from the reference's unbounded-queue
    semantics. Carries the ring and the per-host blame, so the operator
    knows which dimension (and which hosts) to provision. A chained
    driver also sets `chain_span`, the (r0, r1) rounds of the chain that
    overflowed."""

    def __init__(self, message: str, *, ring: str = "",
                 blame: list | None = None):
        self.ring = ring
        self.blame = list(blame or [])
        if self.blame:
            shown = ", ".join(str(b) for b in self.blame[:8])
            more = (f" (+{len(self.blame) - 8} more)"
                    if len(self.blame) > 8 else "")
            message = f"{message} [blame: {shown}{more}]"
        super().__init__(message)


def next_pow2(n: int) -> int:
    """The smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclass
class CapacityTrajectory:
    """The run's one capacity record: every growth / exhaustion / drop
    event, in virtual-time order, as plain dicts (they ride JSON
    records unchanged)."""

    mode: str = "fixed"
    events: list = field(default_factory=list)

    def record_growth(self, *, time_ns: int, ring: str, from_cap: int,
                      to_cap: int, overflow: int, plane: str) -> dict:
        ev = {
            "kind": "capacity-growth", "time_ns": int(time_ns),
            "ring": ring, "from": int(from_cap), "to": int(to_cap),
            "overflow": int(overflow), "plane": plane,
        }
        self.events.append(ev)
        log.warning(
            "capacity: %s ring %s grows %d -> %d at t=%d ns (%d "
            "packet(s) would have been ring-full drops; none were)",
            plane, ring, from_cap, to_cap, time_ns, overflow)
        return ev

    def record_drop(self, *, time_ns: int, ring: str, cap: int,
                    overflow: int, plane: str,
                    exhausted: bool = False) -> dict:
        """A ring-full drop that will happen (fixed mode, or elastic
        growth exhausted)."""
        ev = {
            "kind": ("capacity-exhausted" if exhausted
                     else "capacity-drop"),
            "time_ns": int(time_ns), "ring": ring, "cap": int(cap),
            "overflow": int(overflow), "plane": plane,
        }
        self.events.append(ev)
        log.error(
            "capacity: %s ring %s dropped %d packet(s) at cap %d "
            "(t=%d ns%s)", plane, ring, overflow, cap, time_ns,
            "; growth budget exhausted" if exhausted else
            "; capacity mode elastic would re-execute instead of drop")
        return ev

    def as_dict(self) -> dict:
        return {"mode": self.mode, "events": list(self.events)}


@dataclass
class RingPolicy:
    """Growth bookkeeping for the window-step drivers' two ring
    dimensions (egress CE / ingress CI). Doubling counts are per
    dimension and bounded by ``max_doublings``; growth targets are
    always powers of two, so the CUDA kernels' bitonic row widths stay
    eligible."""

    mode: str = "fixed"
    max_doublings: int = 3
    egress_cap: int = 16
    ingress_cap: int = 32
    plane: str = "plane"
    trajectory: CapacityTrajectory = None  # type: ignore[assignment]
    _eg_doublings: int = 0
    _in_doublings: int = 0
    _noted: frozenset = frozenset()  # rings with a drop/exhaustion noted

    def __post_init__(self):
        if self.mode not in CAPACITY_MODES:
            raise ValueError(
                f"capacity mode: expected one of "
                f"{'|'.join(CAPACITY_MODES)}, got {self.mode!r}")
        if self.trajectory is None:
            self.trajectory = CapacityTrajectory(self.mode)

    def plan_growth(self, *, eg_overflow: int, in_overflow: int,
                    time_ns: int):
        """Decide the post-overflow ring sizes. Returns (new_ce, new_ci)
        when at least one dimension can grow (events recorded), or None
        when the growth budget is exhausted for every overflowing
        dimension (exhaustion recorded: the caller commits the
        overflowing attempt and the drops become real)."""
        new_ce, new_ci = self.egress_cap, self.ingress_cap
        if eg_overflow > 0 and self._eg_doublings < self.max_doublings:
            new_ce = next_pow2(self.egress_cap + 1)
            self._eg_doublings += 1
            self.trajectory.record_growth(
                time_ns=time_ns, ring="egress", from_cap=self.egress_cap,
                to_cap=new_ce, overflow=eg_overflow, plane=self.plane)
        if in_overflow > 0 and self._in_doublings < self.max_doublings:
            new_ci = next_pow2(self.ingress_cap + 1)
            self._in_doublings += 1
            self.trajectory.record_growth(
                time_ns=time_ns, ring="ingress",
                from_cap=self.ingress_cap, to_cap=new_ci,
                overflow=in_overflow, plane=self.plane)
        if (new_ce, new_ci) == (self.egress_cap, self.ingress_cap):
            if eg_overflow > 0:
                self.note_drop(ring="egress", overflow=eg_overflow,
                               time_ns=time_ns, exhausted=True)
            if in_overflow > 0:
                self.note_drop(ring="ingress", overflow=in_overflow,
                               time_ns=time_ns, exhausted=True)
            return None
        self.egress_cap, self.ingress_cap = new_ce, new_ci
        return new_ce, new_ci

    def to_meta(self) -> dict:
        """JSON-serialisable policy snapshot: current caps, the growth
        budget consumed per dimension, the once-per-run drop dedup set,
        and the trajectory so far. `restore_meta` is the inverse."""
        return {
            "mode": self.mode,
            "egress_cap": self.egress_cap,
            "ingress_cap": self.ingress_cap,
            "eg_doublings": self._eg_doublings,
            "in_doublings": self._in_doublings,
            "noted": sorted(self._noted),
            "events": list(self.trajectory.events),
        }

    def restore_meta(self, meta: dict) -> None:
        """Continue with the same grown caps, the same remaining growth
        budget, the same drop dedup and the same trajectory history."""
        self.egress_cap = int(meta["egress_cap"])
        self.ingress_cap = int(meta["ingress_cap"])
        self._eg_doublings = int(meta["eg_doublings"])
        self._in_doublings = int(meta["in_doublings"])
        self._noted = frozenset(meta.get("noted", ()))
        self.trajectory.events.extend(meta.get("events", ()))

    def note_drop(self, *, ring: str, overflow: int, time_ns: int,
                  exhausted: bool = False) -> None:
        """Once-per-run accounting of a ring that dropped (fixed mode, or
        elastic with the growth budget exhausted): the trajectory records
        the first occurrence, not every repeat."""
        if ring in self._noted:
            return
        self._noted = self._noted | {ring}
        cap = self.egress_cap if ring == "egress" else self.ingress_cap
        self.trajectory.record_drop(
            time_ns=time_ns, ring=ring, cap=cap, overflow=overflow,
            plane=self.plane, exhausted=exhausted)

"""Structured guard violations, the abort error and the report file.

The port's copy of `shadow_tpu/guards/report.py`: `GuardViolation` (one
discrepancy with blame and the offending counter pair), `GuardError`
(raised when a class's policy is `abort` or `abort+checkpoint`),
`GuardLedger` (the run's collector and policy dispatcher) and
`write_report` (the `guards-report.json` artifact).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Optional

log = logging.getLogger("shadow_tpu_torch.guards")

#: policies a guard class may be configured with
POLICIES = ("off", "warn", "abort", "abort+checkpoint")


@dataclass
class GuardViolation:
    """One self-check discrepancy with blame attached."""

    cls: str  # "device" | "reconcile" | "progress"
    check: str  # e.g. "ingress-conservation", "pkts_out-vs-captured"
    time_ns: int
    host: Optional[str] = None  # blamed host name (None = fleet-level)
    expected: Any = None
    actual: Any = None
    detail: str = ""

    def describe(self) -> str:
        where = f" host={self.host}" if self.host else ""
        pair = ""
        if self.expected is not None or self.actual is not None:
            pair = f" expected={self.expected} actual={self.actual}"
        tail = f" ({self.detail})" if self.detail else ""
        return (f"[{self.cls}] {self.check}{where} "
                f"time_ns={self.time_ns}{pair}{tail}")

    def as_dict(self) -> dict:
        return {
            "class": self.cls,
            "check": self.check,
            "time_ns": self.time_ns,
            "host": self.host,
            "expected": self.expected,
            "actual": self.actual,
            "detail": self.detail,
        }


class GuardError(RuntimeError):
    """A guard class with an abort policy recorded violations. Carries
    the violations and whether the crash path should also write the
    emergency checkpoint (`abort+checkpoint`)."""

    def __init__(self, cls: str, violations: list[GuardViolation],
                 want_checkpoint: bool):
        self.cls = cls
        self.violations = list(violations)
        self.want_checkpoint = want_checkpoint
        head = "; ".join(v.describe() for v in self.violations[:4])
        more = (f" (+{len(self.violations) - 4} more)"
                if len(self.violations) > 4 else "")
        super().__init__(
            f"guard plane abort [{cls} policy]: "
            f"{len(self.violations)} violation(s): {head}{more}")


@dataclass
class GuardLedger:
    """Run-scoped violation collector and policy dispatcher; every guard
    class reports through `apply`."""

    policies: dict[str, str] = field(default_factory=dict)
    violations: list[GuardViolation] = field(default_factory=list)

    def apply(self, cls: str, found: list[GuardViolation]) -> None:
        """Record `found` and enforce the class policy: warn logs each
        violation; abort raises GuardError (the caller's crash path owns
        checkpoint + telemetry finalization)."""
        if not found:
            return
        self.violations.extend(found)
        policy = self.policies.get(cls, "warn")
        for v in found:
            log.warning("guard violation: %s", v.describe())
        if policy in ("abort", "abort+checkpoint"):
            raise GuardError(cls, found, policy == "abort+checkpoint")

    def as_dict(self) -> dict:
        by_class: dict[str, int] = {}
        for v in self.violations:
            by_class[v.cls] = by_class.get(v.cls, 0) + 1
        return {
            "violations": [v.as_dict() for v in self.violations],
            "by_class": by_class,
            "total": len(self.violations),
        }


def write_report(directory: str, ledger: GuardLedger,
                 extra: Optional[dict] = None) -> Optional[str]:
    """Drop guards-report.json into `directory`; never raises (the
    report must not mask the error it documents)."""
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "guards-report.json")
        payload = ledger.as_dict()
        if extra:
            payload.update(extra)
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        return path
    except OSError:
        log.error("guards: failed to write report", exc_info=True)
        return None

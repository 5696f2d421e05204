"""Cross-plane reconciliation: device counters vs CPU ledgers vs stats.

Counterpart of `shadow_tpu/guards/reconcile.py`. The device transport
(`tpu/transport.DeviceTransport`) counts ingested packets per source
host (`n_out`), released packets per destination host (`n_released`)
and ring-overflow drops (`n_overflow`) on the device; its CPU side
counts the same events in numpy int64 ledgers at capture and release
(`cpu_ledger`), and the stats count every routed packet a third way.
Any disagreement is an accounting fault and becomes a `GuardViolation`
with the host blame and the counter pair.

A device snapshot is read one harvest interval late, so each is paired
with the CPU ledger copied at the same tick. In mirrored mode the
device replays windows in batches and its counters lag by design, so
only the settled teardown snapshot is compared there.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .report import GuardViolation

#: (device counter name, CPU ledger name) identity pairs for the
#: device-transport reconciliation
TRANSPORT_PAIRS = (
    ("pkts_out", "captured"),
    ("pkts_in", "released"),
)


def reconcile_per_host(time_ns: int,
                       device: Mapping[str, np.ndarray],
                       cpu: Mapping[str, np.ndarray],
                       pairs: Sequence[tuple[str, str]],
                       host_names: Optional[Sequence[str]] = None,
                       max_violations: int = 32) -> list[GuardViolation]:
    """Compare per-host device totals with the CPU ledger for every
    (device_field, cpu_field) pair present on both sides: one violation
    per (pair, host) mismatch, at most `max_violations`, the rest
    counted in one final fleet-level violation."""
    out: list[GuardViolation] = []
    truncated = 0
    for dev_name, cpu_name in pairs:
        if dev_name not in device or cpu_name not in cpu:
            continue
        dev = np.asarray(device[dev_name], np.int64)
        led = np.asarray(cpu[cpu_name], np.int64)
        n = min(dev.shape[0], led.shape[0])
        bad = np.nonzero(dev[:n] != led[:n])[0]
        for i in bad:
            if len(out) >= max_violations:
                truncated += 1
                continue
            name = (host_names[i] if host_names and i < len(host_names)
                    else f"host{i + 1}")
            out.append(GuardViolation(
                cls="reconcile",
                check=f"{dev_name}-vs-{cpu_name}",
                time_ns=time_ns, host=name,
                expected=int(led[i]), actual=int(dev[i]),
                detail="device counter disagrees with the CPU ledger "
                       "for this host-id",
            ))
    if truncated:
        out.append(GuardViolation(
            cls="reconcile", check="per-host-mismatch-overflow",
            time_ns=time_ns,
            detail=f"{truncated} further per-host mismatches truncated "
                   f"from this report (cap {max_violations})",
        ))
    return out


def reconcile_fleet(time_ns: int,
                    checks: Sequence[tuple[str, int, int, str]],
                    ) -> list[GuardViolation]:
    """Fleet-total identities: `checks` is (name, expected, actual,
    detail) tuples; every inequality becomes a violation."""
    return [
        GuardViolation(cls="reconcile", check=name, time_ns=time_ns,
                       expected=int(expected), actual=int(actual),
                       detail=detail)
        for name, expected, actual, detail in checks
        if int(expected) != int(actual)
    ]


class TransportReconciler:
    """The manager-side reconciliation hook of a device-transport run:
    copies the transport's CPU ledger at each telemetry tick (the instant
    the harvester starts its device copy) and compares when the
    harvester's drain delivers that snapshot; `final` also checks the
    fleet conservation identity and the stats totals."""

    def __init__(self, transport, host_names: Sequence[str],
                 *, mid_run: bool):
        self._transport = transport
        self._host_names = list(host_names)
        # mirrored mode lags by design: compare only at teardown there
        self._mid_run = mid_run
        self._pending: dict[int, dict[str, np.ndarray]] = {}

    def note_tick(self, time_ns: int) -> None:
        """At a harvest tick: pair the device copy just started with a
        same-instant ledger copy."""
        if self._mid_run:
            self._pending[int(time_ns)] = self._transport.cpu_ledger()

    def on_drain(self, time_ns: int, device_totals: dict,
                 _cpu) -> list[GuardViolation]:
        """Harvester drain callback: reconcile the device snapshot of
        `time_ns` with the ledger copied at the same tick."""
        ledger = self._pending.pop(int(time_ns), None)
        if ledger is None:
            return []
        return reconcile_per_host(
            time_ns, device_totals, ledger, TRANSPORT_PAIRS,
            self._host_names)

    def final(self, time_ns: int, *, packets_sent: Optional[int] = None,
              ) -> list[GuardViolation]:
        """Teardown reconciliation on settled counters (a blocking read
        is fine: the run is over). Valid in both transport modes."""
        device = {
            name: arr.detach().cpu().numpy().astype(np.int64)
            for name, arr in self._transport.telemetry_arrays().items()
        }
        ledger = self._transport.cpu_ledger()
        out = reconcile_per_host(time_ns, device, ledger,
                                 TRANSPORT_PAIRS, self._host_names)
        # fleet conservation: everything ingested is released, dropped
        # to overflow, or still in flight on the device
        fleet = [(
            "transport-conservation",
            int(device["pkts_out"].sum()),
            int(device["pkts_in"].sum())
            + int(device["drop_ring_full"].sum())
            + int(self._transport.device_in_flight()),
            "sum(n_out) != sum(n_released) + sum(n_overflow) + in-flight",
        )]
        if packets_sent is not None:
            # every routed packet was captured exactly once
            fleet.append((
                "packets_sent-vs-captured",
                int(packets_sent),
                int(ledger["captured"].sum()),
                "SimStats.packets_sent != transport captures",
            ))
        out.extend(reconcile_fleet(time_ns, fleet))
        return out

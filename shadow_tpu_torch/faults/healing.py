"""Transient-error retry for device dispatches.

Counterpart of `shadow_tpu/faults/healing.py`'s retry half:
`is_transient_device_error`, `backoff_schedule` and `retry_transient`,
with the same classifier, the same seeded delay floats and the same
re-raise rules. A retry runs the same dispatch again on the same device;
it never demotes to the CPU or to a plain version. The JAX module's
`KernelFallback` (a Pallas kernel that fails demotes the run to XLA) is
not ported: a CUDA kernel of the port that fails to build or launch
raises.

The backoff sleeps wall time, which can change only performance, never
results, and its schedule is a pure function of its arguments, so two
runs of the same configuration retry on the same wall cadence.
"""

from __future__ import annotations

import hashlib
import logging
import time as _walltime
from typing import Callable, Tuple

log = logging.getLogger("shadow_tpu_torch.faults")

#: substrings that mark a device error as plausibly transient (the JAX
#: module's list: runtime error messages carry the status name)
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "connection reset", "Broken pipe", "temporarily unavailable",
)


def is_transient_device_error(exc: BaseException) -> bool:
    """Heuristic classifier for retryable device/runtime errors. Python
    errors (TypeError, ValueError, KeyError, AssertionError) are never
    transient."""
    if isinstance(exc, (TypeError, ValueError, KeyError, AssertionError)):
        return False
    text = f"{type(exc).__name__}: {exc}"
    return any(marker in text for marker in _TRANSIENT_MARKERS)


def backoff_schedule(attempts: int, *, base_s: float = 0.05,
                     cap_s: float = 2.0, jitter: float = 0.5,
                     seed: int = 0,
                     what: str = "device dispatch") -> Tuple[float, ...]:
    """The deterministic retry-delay sequence: delay k starts at
    `min(cap_s, base_s * 2**k)` and seeded jitter shaves up to a `jitter`
    fraction off it. The k-th jitter draw is sha256(seed, what, k) mapped
    to [0, 1): no PRNG object and no global stream."""
    if attempts < 0:
        raise ValueError(f"attempts must be >= 0, got {attempts}")
    if not 0.0 <= jitter <= 1.0:
        raise ValueError(f"jitter must be in [0, 1], got {jitter}")
    out = []
    for k in range(attempts):
        digest = hashlib.sha256(f"{seed}|{what}|{k}".encode()).digest()
        u = int.from_bytes(digest[:8], "big") / 2.0 ** 64
        delay = min(cap_s, base_s * (2.0 ** k))
        out.append(delay * (1.0 - jitter * u))
    return tuple(out)


def retry_transient(fn: Callable, *args, attempts: int = 3,
                    backoff_s: float = 0.05, cap_s: float = 2.0,
                    jitter: float = 0.5, seed: int = 0,
                    classify=is_transient_device_error,
                    what: str = "device dispatch", **kwargs):
    """Call `fn`; on a transient error retry up to `attempts` more times,
    sleeping the `backoff_schedule` delays. Non-transient errors and an
    exhausted budget re-raise the original error."""
    delays = backoff_schedule(attempts, base_s=backoff_s, cap_s=cap_s,
                              jitter=jitter, seed=seed, what=what)
    for attempt in range(attempts + 1):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — classified + re-raised
            if attempt >= attempts or not classify(e):
                raise
            delay = delays[attempt]
            log.warning(
                "transient error in %s (attempt %d/%d, retrying in "
                "%.2fs): %s", what, attempt + 1, attempts, delay, e)
            _walltime.sleep(delay)

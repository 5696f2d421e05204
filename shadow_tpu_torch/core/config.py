"""The part of the configuration the fault schedule reads.

The port's copy of `ConfigError` and of the `faults:` block's
`FaultsOptions` (`shadow_tpu/core/config.py`), cut to the fields
`faults/schedule.compile_schedule` reads: the explicit `events`, the
seeded `random` generators and the `seed` that overrides the run's.
The schedule validates both lists when it compiles them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class ConfigError(ValueError):
    pass


@dataclass
class FaultsOptions:
    """The `faults:` block: raw event mappings, a mapping of seeded
    generators, and the fault stream's seed (None: the run's seed)."""

    seed: Optional[int] = None
    events: list = field(default_factory=list)
    random: Optional[dict] = None

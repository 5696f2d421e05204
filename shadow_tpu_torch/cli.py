"""Command-line entry point: `python -m shadow_tpu_torch <config.yaml>`.

Parity: reference `src/main/shadow.rs` `run_shadow` — load + merge config
(CLI over file), init logging, create the data directory (refusing to
clobber an existing one), write `processed-config.yaml` for
reproducibility (`manager.rs:182-193`), run the simulation, write
`sim-stats.json` (`manager.rs:523-546`), and exit nonzero when any process
missed its expected final state (`controller.rs:69-73`).

The port's copy of `shadow_tpu/cli.py`, with one flag more: `--device`
(default: the CUDA card), the device of the transport
(`experimental.use_tpu_transport`) and of the flow engine
(`experimental.use_flow_engine`). Under `--device cpu` they run their
plain PyTorch versions on the CPU; a config that switches on neither
touches no device. It writes the data directory the JAX CLI writes.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys

from .core import shadowlog, units
from .core.config import ConfigError, ConfigOptions, load_config_file
from .core.manager import Manager

# Documented exit codes (docs/robustness.md; asserted in tests/test_cli.py).
# 1 keeps its historical meaning — the SIMULATION failed (a process missed
# its expected final state, a mirrored transport diverged, a data dir was
# refused) — while configuration, watchdog, crash, guard, and capacity
# failures get their own codes so wrappers can tell "fix the config" from
# "file a bug" from "inspect the emergency checkpoint" from "the simulation
# failed its own runtime invariants" from "provision bigger rings (or go
# elastic)".
EXIT_OK = 0
EXIT_SIM_FAILURE = 1
EXIT_CONFIG = 2
EXIT_WATCHDOG = 3
EXIT_CRASH = 4
EXIT_GUARD = 5
EXIT_CAPACITY = 6


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow_tpu_torch",
        description="discrete-event network simulator (PyTorch/CUDA port)",
    )
    p.add_argument("config", help="simulation YAML config")
    p.add_argument("--seed", type=int, help="override general.seed")
    p.add_argument("--stop-time", help="override general.stop_time (e.g. 10s)")
    p.add_argument("--parallelism", type=int, help="worker parallelism")
    p.add_argument(
        "--scheduler",
        choices=["serial", "thread-per-core", "thread-per-host"],
        help="override experimental.scheduler",
    )
    p.add_argument(
        "--log-level",
        choices=["error", "warning", "info", "debug", "trace"],
        help="override general.log_level",
    )
    p.add_argument(
        "-d", "--data-directory", help="override general.data_directory"
    )
    p.add_argument(
        "-e",
        "--force",
        action="store_true",
        help="remove a pre-existing data directory instead of refusing",
    )
    p.add_argument(
        "--show-config", action="store_true",
        help="print the processed config and exit",
    )
    p.add_argument(
        "--telemetry", action="store_true",
        help="enable the telemetry harvester (overrides telemetry.enabled; "
             "heartbeat JSONL + Perfetto trace land in the data directory)",
    )
    p.add_argument(
        "--guards", action="store_true",
        help="enable the guard plane (overrides guards.enabled; runtime "
             "invariants + cross-plane reconciliation + progress "
             "detection under the configured per-class policies — see "
             "docs/robustness.md)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="the device of the transport (experimental.use_tpu_transport) "
             "and of the flow engine (experimental.use_flow_engine); "
             "default: the CUDA card",
    )
    p.add_argument(
        "--resume", metavar="CKPT",
        help="resume from a checkpoint directory (flow-engine runs: "
             "completed buckets are skipped and the continued run is "
             "bitwise-identical to an uninterrupted one; see "
             "docs/robustness.md)",
    )
    return p


def _apply_overrides(config: ConfigOptions, args) -> None:
    if args.seed is not None:
        config.general.seed = args.seed
    if args.stop_time is not None:
        config.general.stop_time = units.parse_duration_ns(args.stop_time)
    if args.parallelism is not None:
        config.general.parallelism = args.parallelism
    if args.scheduler is not None:
        config.experimental.scheduler = args.scheduler
    if args.data_directory is not None:
        config.general.data_directory = args.data_directory
    if args.telemetry:
        config.telemetry.enabled = True
    if args.guards:
        config.guards.enabled = True


def _config_as_dict(config: ConfigOptions) -> dict:
    import dataclasses
    import enum as _enum

    def conv(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return {k: conv(v) for k, v in dataclasses.asdict(x).items()}
        if isinstance(x, _enum.Enum):
            return x.value if not isinstance(x.value, int) else x.name.lower()
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return x

    return {
        "general": conv(config.general),
        "network": conv(config.network),
        "experimental": conv(config.experimental),
        "telemetry": conv(config.telemetry),
        "faults": conv(config.faults),
        "guards": conv(config.guards),
        "capacity": conv(config.capacity),
        "strict": config.strict,
        "hosts": {name: conv(h) for name, h in config.hosts.items()},
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        config = load_config_file(args.config)
    except Exception as e:
        print(f"shadow_tpu_torch: config error: {e}", file=sys.stderr)
        return EXIT_CONFIG
    _apply_overrides(config, args)

    if args.show_config:
        json.dump(_config_as_dict(config), sys.stdout, indent=2)
        print()
        return 0

    level_name = args.log_level or config.general.log_level.name
    level = {"TRACE": logging.DEBUG}.get(
        str(level_name).upper(), getattr(logging, str(level_name).upper(), logging.INFO)
    )
    shadowlog.init_logging(level)
    log = logging.getLogger("shadow_tpu_torch.cli")

    data_dir = config.general.data_directory
    if os.path.exists(data_dir):
        if args.resume:
            # resuming continues the SAME run: the data directory (which
            # usually holds the checkpoint being resumed) is reused in
            # place, never wiped — wiping would destroy the checkpoint
            pass
        elif not args.force:
            print(
                f"shadow_tpu_torch: data directory {data_dir!r} exists "
                "(pass -e/--force to replace it)",
                file=sys.stderr,
            )
            return EXIT_SIM_FAILURE
        else:
            shutil.rmtree(data_dir)
    os.makedirs(data_dir, exist_ok=True)

    import yaml

    with open(os.path.join(data_dir, "processed-config.yaml"), "w") as fh:
        yaml.safe_dump(_config_as_dict(config), fh, sort_keys=False)

    from .core.capacity import CapacityError
    from .faults.checkpoint import CheckpointError
    from .faults.watchdog import WatchdogError
    from .guards.report import GuardError

    try:
        mgr = Manager(config, data_dir=data_dir,
                      device=None if args.device == "cuda" else args.device)
        mgr.resume_from = args.resume
        log.info("simulation starting: %d hosts", len(mgr.hosts))
        stats = mgr.run()
    except ConfigError as e:
        print(f"shadow_tpu_torch: config error: {e}", file=sys.stderr)
        return EXIT_CONFIG
    except CheckpointError as e:
        print(f"shadow_tpu_torch: checkpoint error: {e}", file=sys.stderr)
        return EXIT_CONFIG
    except WatchdogError as e:
        # structured hang: blame is in the message, forensics in the
        # emergency checkpoint the Manager dropped before raising
        log.error("watchdog abort: %s", e)
        print(f"shadow_tpu_torch: watchdog abort: {e}", file=sys.stderr)
        return EXIT_WATCHDOG
    except CapacityError as e:
        # a ring-full overflow under the strict capacity policy: the
        # run refused to silently diverge from the reference's
        # unbounded-queue semantics (docs/robustness.md "Elastic
        # capacity"); blame is in the message
        log.error("capacity abort: %s", e)
        print(f"shadow_tpu_torch: capacity abort: {e}", file=sys.stderr)
        print(
            "shadow_tpu_torch: raise the ring capacities or run "
            "capacity.mode: elastic (rings grow on demand, "
            "bitwise-identical to pre-provisioned)",
            file=sys.stderr,
        )
        return EXIT_CAPACITY
    except GuardError as e:
        # the simulation failed its OWN runtime invariants: the
        # violation report (guards-report.json) is in the data dir, and
        # an abort+checkpoint policy also left the emergency checkpoint
        # + finalized telemetry as a postmortem bundle
        log.error("guard abort: %s", e)
        print(f"shadow_tpu_torch: guard abort: {e}", file=sys.stderr)
        print(
            f"shadow_tpu_torch: violation report: "
            f"{os.path.join(data_dir, 'guards-report.json')}",
            file=sys.stderr,
        )
        return EXIT_GUARD
    except Exception:
        import traceback

        traceback.print_exc()
        print(
            "shadow_tpu_torch: simulation crashed (see traceback above); an "
            "emergency checkpoint was dropped in the data directory's "
            "checkpoints/ if one could be written",
            file=sys.stderr,
        )
        return EXIT_CRASH
    log.info(
        "simulation finished: %d rounds, %d packets, %.2fs wall",
        stats.rounds, stats.packets_sent, stats.wall_seconds,
    )

    if mgr.harvester is not None:
        log.info(
            "telemetry: %d heartbeat lines over %d harvests -> %s",
            mgr.harvester.emitted, mgr.harvester.harvests,
            mgr.harvester.sink_path or "(log only)",
        )

    if mgr.guard_violations:
        # warn-policy violations: the run completed, but it failed its
        # own invariants — say so loudly and point at the report
        log.warning(
            "guards: %d violation(s) recorded under warn policy — see %s",
            len(mgr.guard_violations),
            os.path.join(data_dir, "guards-report.json"),
        )

    payload = stats.as_dict()
    payload["hosts"] = mgr.host_stats()
    with open(os.path.join(data_dir, "sim-stats.json"), "w") as fh:
        json.dump(payload, fh, indent=2)

    if stats.process_failures:
        for name, why in stats.process_failures:
            log.error("process failure: %s: %s", name, why)
        return EXIT_SIM_FAILURE
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())

"""Profile the port's window step per section.

The port of `tools/profile_plane.py`: times every section of
`plane.window_step` (`tpu/profiling.profile_sections`) at one or more
bench shapes and prints one JSON report, `{"metric": "plane_section_ms",
"shapes": [...]}`, with JAX's flags plus `--device`:

    python -m shadow_tpu_torch.tools.profile_plane         # on the card
    python -m shadow_tpu_torch.tools.profile_plane --hosts 1024 --reps 5
    python -m shadow_tpu_torch.tools.profile_plane --kernel pallas_fused
    python -m shadow_tpu_torch.tools.profile_plane \
        --sections routing_scatter,routing_rank,routing_place
    python -m shadow_tpu_torch.tools.profile_plane --device cpu --hosts 64

`--legacy-sort` exits 2: the port implements the packed orderings only
(the JAX tool's pre-diet variadic sorts are a JAX-side parity
reference).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", default="1024,8192",
                    help="comma-separated host counts (default 1024,8192)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per section (default 20)")
    ap.add_argument("--egress-cap", type=int, default=16)
    ap.add_argument("--ingress-cap", type=int, default=32)
    ap.add_argument("--nodes", type=int, default=64,
                    help="graph nodes for the path tables (default 64)")
    ap.add_argument("--rr", action="store_true",
                    help="profile with the round-robin qdisc (kernel xla)")
    ap.add_argument("--legacy-sort", action="store_true",
                    help="refused: the port has the packed sorts only")
    ap.add_argument("--kernel", choices=("xla", "pallas", "pallas_fused"),
                    default="xla",
                    help="window_step kernel (default xla; pallas = kernels "
                         "C and D, pallas_fused = kernels A and B)")
    ap.add_argument("--sections", default=None,
                    help="comma-separated subset of sections to time")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("-o", "--out", default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)
    if args.legacy_sort:
        print("profile_plane: --legacy-sort: the port implements the packed "
              "orderings only; the legacy variadic sorts are a JAX-side "
              "parity reference (profile them with tools/profile_plane.py)",
              file=sys.stderr)
        return 2

    from ..tpu import profiling

    shapes = []
    for n in (int(h) for h in args.hosts.split(",") if h.strip()):
        shapes.append(profiling.profile_sections(
            n, reps=args.reps, rr_enabled=args.rr, kernel=args.kernel,
            n_nodes=args.nodes, egress_cap=args.egress_cap,
            ingress_cap=args.ingress_cap,
            sections=(args.sections.split(",") if args.sections else None),
            # "cuda" is the port's default device, which raises without
            # a card rather than running on the CPU
            device=None if args.device == "cuda" else args.device))
    report = {"metric": "plane_section_ms", "shapes": shapes}
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

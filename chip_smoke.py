#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Runs the port's main path, the PHOLD device-plane loop, through its
hand-written CUDA kernels, and the router AQM's windows through kernel
E, in phases; any failure exits non-zero before the result lines are
printed:

1. require a CUDA card; print its name and power limit (nvidia-smi);
   start the CPU runs that phases 9, 12-15, 20, 22-24 compare the
   card's with, all at once in a pool of spawned worker processes (CUDA
   hidden, two torch threads each, (cores - 2) / 2 of them; the count is
   printed), each phase awaiting its own where it compares;
2. build the kernels from `shadow_tpu_torch/csrc` (one nvcc per source,
   in parallel; kernel F's, the longest, beside phases 3-19, awaited
   before phase 20; phase 23's interposition libraries and programs with
   g++/gcc beside the phases too) and print the build seconds and
   ptxas' resource
   report;
3. kernel A (egress_rank) against its plain PyTorch version on the card,
   bitwise, at N=32768 and CE in {8, 16, 32, 64}, and timed with its
   inputs in HBM (L2 flushed before each launch by a write: `ms`; by a
   write and a read, so no dirty lines are left: `cold_clean_ms`) and
   in L2 (back-to-back launches: `warm_ms`); (d) at the egress
   capacities no main path runs but JAX's kernel takes, CE in {1, 2048,
   4096, 16384} (one-slot rows in the warp build; the wide build, a block
   of 1024 threads a row over device memory, past 1024), on 2^24 slots of
   columns (~1.09 GB) and on the int32 edge inputs, each launch counted
   under the build its launcher picked, timed as above beside the bound
   by bytes, with ptxas' report of the wide build;
4. kernel C (egress_gate): ptxas' registers, shared memory and spills
   of its kernels (a spill fails); bitwise against its plain version at
   CE in {2, 4, 8, 16, 32, 64, 128, 1024} on random inputs at N=32768
   and on the CPU tests' int32 edge inputs at a ragged N=32763; timed as
   kernel A at CE in {8, 16, 32}, beside a device copy of as many
   bytes timed alike (the floor of the timing at that size); (d) as A's
   (d), on 2^25 slots (~1.17 GB);
5. kernels B (route_place) and D (route_scatter) likewise on one input
   set at N=32768, CE=16, CI=32, with rows whose arrivals overflow the
   ring and rows that read outside the arrivals, each kernel and plain
   version on its own clone (they update the ingress in place); D and B
   agree, and both are timed on it; (d) kernel B with rings of one slot
   (CI = 1) through the routing stage, bitwise its plain version, then
   timed alone on the stage's arguments beside its byte bound;
6. the golden digest: `run_phold` at N=1024, R=16 through each kernel
   pair must end in the state the JAX package's run ends in (pinned by
   the CPU tests);
7. the main path through each kernel pair, fused (A, B) and split (C,
   D): `run_phold` at N=32768, CE=16, CI=32, M=64, R=192 after one
   untimed warm-up run, with the launch counters reset just before and
   read just after (each kernel of the pair must have launched R times,
   the other pair's none), then a R=16 run through the kernels against
   the same run through the plain versions, bitwise;
8. the capacity policy on the split path at N=32768 from CE=4, CI=8:
   elastic over R=192 in chains of 16 must grow a ring and end in the
   canonical state and delivered total of a fixed run pre-provisioned at
   its final caps; strict must raise CapacityError naming the chain;
9. the scenario corpus on the card: all ten entries of `scenarios/`
   through the port's runner (`window_step(kernel="xla")` with the
   metrics and histogram planes, `workload_step`, and for the lossy and
   serving entries the flow and compute planes), each record carrying
   `scenarios/GOLDEN.json`'s three digests and equal to the same run on
   the CPU, with no kernel launched; windows/s of each drive, and device
   kernels and busy ms a window of serve_burst_lossy (torch.profiler);
10. the metrics plane on both kernel paths at the main path's width
   (N=32768, CE=16, CI=32, R=16): the state equal to the metrics-off
   run's, the metrics equal to those of the run through the plain
   versions, each kernel of the pair launched R times;
11. `kernel="xla"` at that width: the state of the fused path's run, no
   kernel launched, and device kernels and busy ms a window of the XLA
   and fused windows (`bench.profile_windows`); (b) 6 PHOLD windows at
   that width on "xla" with `packed_sort=False` (JAX's pre-diet variadic
   sorts), every window's state, delivered count and next event equal
   to the packed sorts' run;
12. `onoff.yaml` widened to 16384 hosts (the N x N latency and loss
   tables 1 GiB each on the card; phases 12-14 draw each world's tables
   and compile its traffic program once, `shared_setups`, and upload
   them afresh each run), 160 windows: two card runs with equal
   records, every host done; the first 8 windows' record equal to the
   CPU's; wall time and windows/s;
13. a lossy serving fleet: serve_burst_lossy.yaml's shape over 16380
   hosts (1638 single-server groups of 10, 14742 flows; the N x N tables
   1.07 GB each on the card): one run of its whole window budget, every
   host done, no compute overflow, its SLO block; two card runs of the
   first 64 windows with equal records; the first 8 windows' record
   equal to the CPU's; no kernel launched; set-up and drive seconds,
   windows/s, retransmits and RTOs fired, peak device memory, and device
   kernels and busy ms a window over 16 windows (torch.profiler);
14. faults, guards and the flight recorder on the card (no kernel
   launched): (a) all ten corpus entries under the runner's default
   fault schedule with the guard plane and the flight recorder
   (sample_every=64), each record equal to the CPU's field for field,
   guards-clean, fault drops where the CPU run has them, windows/s beside
   phase 9's; (b) the serving fleet of phase 13 under its default fault
   schedule (a link degraded x4, the last host crashed and rebooted, the
   next host's egress 30 % corrupted) with guards and the recorder: one
   run of the whole window budget, guards-clean, the hosts done and the
   last one's window printed, no ring overwrite; two runs of the first 64
   windows with equal records; the first 8 windows (all four events
   inside) equal to the CPU's, with fault drops; set-up and drive
   seconds, windows/s, peak device memory, hops recorded, and device
   kernels and busy ms a window over 16 windows; (c) both Pallas
   kernel paths refuse each of the three planes on CUDA tensors;
15. the router AQM (CoDel and the down-bandwidth relay) at the bench's
   width: the bench world (N=32768, M=64, CE=16, CI=32, 10 ms windows,
   loss 0.01, seed 0) with 1 Mbit/s downlinks, each relay bucket full,
   every egress ring filled with 16 packets of 1400 B to hashed
   destinations, R=64 windows: (a) kernel E (router_drain) bitwise
   against its plain version on the router's rows of window
   `AQM_SNAPSHOT`, where CoDel drops and the relay caches, and on random
   rows at K=32 and K=64, timed cold (dirty and clean) and warm beside
   its bound, the plain version's time and a device copy of as many
   bytes timed alike; (b) `window_step(router_aqm=
   True)` on "pallas_fused" (A, B, E), "pallas" (C, D, E) and "xla" (E):
   one end state and per-window delivered counts for all three, each
   equal to its `plain_kernels=True` run over the 18 windows that carry
   traffic (none delivers after them), the first 8 windows equal to the
   CPU's, R launches of E and of the pair's kernels and none of the
   other pair's; router drops, cached packets, overflow, windows/s, and
   device kernels and busy ms a window (torch.profiler, 16 windows);
   (c) "xla" with metrics, guards and the flight recorder: guards-clean,
   `drop_qdisc` summing to the router's drops, (b)'s state, AQM-drop
   hops recorded; (d) `chain_windows` on each kernel, in 1 ms windows
   from the world's start to the end of the traffic, equal to the same
   windows run one at a time with the same boundaries, its reads of
   tensors back to the host counted (one a chained window), and one idle
   window from (b)'s drained end; (e) the AQM world's traffic at N=1024
   with ingress rings of CI=32768 slots (rows of K=32768: kernel E's
   device build, which reads its rows in device memory), 8 windows on
   "xla" and "pallas_fused" equal, the first 2 equal to the CPU's, E's
   device build launched once a window, its us a launch in the window
   beside its bound by bytes;
16. the run infrastructure (no kernel of its own): (a) the PHOLD main
   path at N=32768, R=64 through each kernel pair with the telemetry
   harvester every 32 windows and the run ledger (and "xla" with the
   histograms too), each state equal to the bare run's, 64 launches of
   each kernel of the pair, the harvests and heartbeat lines counted,
   device kernels and busy ms a window with and without
   (torch.profiler, windows 32-63 of a 64-window run, the set-up and
   the first chain before it); (d) the memo rep (`bench.run_memo`: a
   16-host ring allreduce over 1024 windows in chains of 64, cold and
   memoized), hits and digest parity; in child processes, the killed
   runs at once from the phase's start (beside (a), (d)'s memo rep and
   (c)'s uninterrupted runs) and then the resumed runs at once (beside
   (b)'s uninterrupted run), each part's seconds printed: (b) the fused
   PHOLD main path checkpointed every 32 windows, killed at round 96
   (exit 137) and resumed from its newest checkpoint, ending as the
   uninterrupted run, with the checkpoint's bytes and the save and
   resume milliseconds; (c) `run_scenarios --checkpoint-dir --kill-at
   16` then `--resume`, with `--telemetry` and `--trace`, on a direct
   entry under `--check` and a serving entry under `--faults --guards`
   (the output file byte-identical to the uninterrupted run's, the
   heartbeats after the kill and the phase annotations equal), and on
   phase 13's fleet killed at 256 of its 704 windows (its record equal
   to phase 13's); (d) the corpus under `--memo --check`; (e) the chaos
   smoke at its defaults, uninterrupted, killed at 24 and resumed,
   with and without `--memo` (equal digests);
17. ensembles (`elastic.drive_ensemble`: `torch.func.vmap` of the chain,
   each kernel's vmap rule launching it once for all worlds) of 8 bench
   worlds (N=32768, M=64, CE=16, CI=32) under distinct world keys, their
   states distinct after the first window: `bench --worlds 8`'s path
   ("xla", R=192) and, on each kernel pair, R=192 with each kernel
   launched R times (not 8 R), each timed between two solo runs of its
   kernel (the `worlds` record's amortization against their mean); on
   each, each world equal to its solo `drive_chained_windows` run
   after 32 windows; device kernels, busy ms and each batched launch's
   us a window (windows 16-31) beside the solo run's, peak device
   memory; the router AQM world's first 18 windows on each kernel, E
   and the pair launched once a window, each world equal to its solo
   run; (b) each of A-E under vmap over 8 distinct worlds at N=32768
   (one launch of 8 N rows) bitwise its plain version vmapped over the
   same worlds, timed cold and warm beside its bound;
18. the section profiler (`tpu/profiling.profile_sections`) at the
   bench's width (N=32768, M=64, CE=16, CI=32), all 24 sections timed 10
   times each (host wall ms around a synchronise, min and median) on
   "xla", "pallas_fused" and "pallas", the launches of each section's
   calls counted: A and B once a call of the step's sections (eight in
   `window_chain8`) on "pallas_fused", C and D on "pallas", D once a
   `routing_scatter` on "pallas", E once a `codel_drain` on every kernel,
   none elsewhere; each section that launches a kernel bitwise the same
   section through the plain versions on the card, on the profiled
   world (its egress drained by its 3 warm-up windows) and on the world
   before them (its seed packets routed); each window step's
   device busy time beside it (`bench.profile_windows`); `bench --kernel
   xla` and `--kernel xla --faults` in turns (through `bench.main`),
   their final states equal and their records read by
   `tools/compare_runs.py --bench`, each carrying JAX's baselines
   (`vs_baseline` over the port's object plane, `compiled_events_per_sec`
   and `vs_compiled` over `tools/phold_compiled.cc`, or null where there
   is no g++, and `prior_round` skipped against the JAX records);
   `run_scenarios --config` on a
   simulation config naming a corpus entry, with that entry's
   `scenarios/GOLDEN.json` digests;
19. the host-axis mesh (`tpu/mesh.py`) on the one card: (a) two ranks
   over gloo (NCCL refuses two ranks on one card; every collective is
   staged through host memory), rank 0 this process and rank 1 spawned,
   both on the card: the golden world (N=1024, R=16) and the bench world
   (N=32768, R=192) sharded through each kernel pair, the first equal to
   `GOLDEN_PHOLD_DIGEST`, the second to the unsharded run of phase 7,
   each rank launching its pair once a window and E never, the sharded
   events/s beside the unsharded; in-window us a launch on rank 0 over 8
   windows (torch.profiler); the multichip stress (65536 hosts, a
   64-window `chain_windows` through A and B, every arrival across the
   shard boundary, overflow drops) equal to its one-rank run; (b) one
   rank over NCCL: the golden and bench worlds through A and B equal to
   the unsharded runs; (c) A-D at a rank's shape (N_local = 16384; B and
   D with n_src = 32768 source rows, bitwise against their plain
   versions) timed cold and warm beside their bounds, the exchange's
   bytes a window and each part's seconds;
20. the device flow engine (`tpu/floweng.py`, kernel F): (a) F against
   its plain version (`run_windows_plain`) on the card, bitwise on every
   `FlowWorld` leaf and `steps_per_window`, over 60 windows of a 64-flow
   world (asymmetric 2-40 ms latencies, both transfer directions, 2 %/1 %
   loss, staggered starts, 16-slot rings), once with the default options
   and once with one-MSS pulls under a step cap of 2 (ring-overflow drops
   and saturated windows occur), the same world at (flows, ring slots)
   `FLOW_GRID` (pair counts that leave a block part empty, rings of 16
   to 1024 slots), bench_flows' first chunk and rung 3's largest bucket
   through its first chunk with work; F timed a chunk cold, clean and
   warm beside the plain version at (a)'s, bench_flows' and rung 3's
   chunks, its launch geometry (blocks, pairs a block, shared bytes)
   and the longest pair's events (counted on the plain run) with the
   microseconds an event they imply; (b) `bench_flows`' default world at
   full width (975 flows x 256 KiB, 20 ms windows, chunks of 25) through F by
   `run_to_completion`: its `flow_results` digest equal to
   `GOLDEN_FLOW_DIGEST`, F's launches equal to the chunks run, wall
   seconds and segments a wall second, and F's device ms of every launch
   of the run; (c) the rung-3 flow-engine deployment
   (`workloads/rung3_floweng.yaml`) through `flowplan.run_config`, its
   `stats_record` equal to the JAX Manager's committed record, F's device
   ms of each launch (CUDA events), then run again with a checkpoint
   directory, stopped after its first bucket and resumed, equal again;
   (d) the multichip dry run's flow world (12 flows a shard, 400 windows
   of 20 ms) through `run_windows_sharded` at 2 and 8 shards on the one
   card, bitwise a single launch of F on every leaf, F launched once a
   shard, each shard's steps those of F on that shard alone, each
   shard's device ms and both runs' wall; (e) bench_flows' world with
   rings of 32768 slots and of 30001 (a Q no power of two), past the
   28957 an earlier F staged, each run to completion equal to
   `GOLDEN_FLOW_DIGEST`, their per-flow results equal, each launch's
   device ms, the first chunk timed cold, clean and warm at both in turns
   beside its bound by bytes; the rung-3 deployment with
   `capacity.max_doublings: 8` equal to the JAX Manager's record, and
   again with ring drops added below 32768 slots, so every bucket's
   rings double from 256 to 32768 and F runs there: the record the JAX
   Manager's but for those growths;
21. the device transport (`tpu/transport.py`): (a) its functions
   (`ingest_guarded`, `step_compact` with a negative shift, a 64-window
   `chain`, a 32-window `batch_verify` with three poisoned windows), the
   guard and histogram planes on, at the rung-3 deployment's width
   (N=1000, CI=256, ingest batches of 512 with overflowing rows and pad
   sources) and after one elastic growth (CI=512), on the card bitwise
   the same functions on the CPU; (b) the committed rung-3 call log
   (`workloads/rung3_transport.log.npz`, recorded from the JAX Manager)
   through the port's `DeviceTransport` on the card by
   `tools/transport_replay.py`: sync mode with every round's pushes and
   next event equal to the record, mirrored mode with no divergence and
   the JAX transport's verified windows and packets, and `mode="auto"`'s
   D2H probe and choice; (c) wall seconds of each replay, device ms a
   dispatch by CUDA events, and device kernels and busy ms a round over
   the sync replay's first 160 rounds (torch.profiler); no kernel of
   A-F launches on this path;
22. the simulator's own entry point, `python -m shadow_tpu_torch CONFIG`
   (`cli.main` -> `core/manager.Manager`: hosts, the simulated TCP/UDP
   stack and the built-in apps on the CPU, cross-host packets through the
   device transport on the card), each CPU witness the same CLI with
   `--device cpu` and the CPU routing, in the pool: (a) the Quickstart
   configs `examples/basic-file-transfer.yaml` and `examples/phold.yaml`
   with `use_tpu_transport` in sync and in mirrored mode, each data
   directory the witness's (sim-stats.json less wall_seconds, etc-hosts,
   the processed config less the transport's keys), no divergence; (b)
   rung 3 live (1000 hosts, 975 tgen clients of 256 KiB) with the sync
   transport to 15 s (every client started), its calls recorded
   (`transport_replay.recording_class`): every release but the last equal
   to the committed call log's round for round (push count, push rows as
   a set less their pool tags against phase 21's sync replay, next
   event), its sim-stats the witness's; (c) the rung-3 flow-engine
   deployment through the CLI, its stats record the JAX Manager's, F
   launched; (d) PHOLD at CE=2048 through both kernel pairs (A and C in
   their wide build every window) and at CI=1 through the fused pair,
   each state the "xla" run's;
23. managed native processes: real executables under the port's
   interposition shim (`shadow_tpu_torch/interpose`, built into
   `_build_out/`) and syscall handler, through `python -m
   shadow_tpu_torch CONFIG` with the device transport on the card in sync
   and mirrored mode, each CPU witness the same CLI with `--device cpu`
   and the same transport keys (in the pool): (a) the shim's libraries
   and the programs built (g++/gcc, seconds printed); (b) rung 4 at its
   full shape (`workloads/rung4`: 66 onion relays and 33 clients from
   `tools/onion/*.c`, 10 nodes, 32 KiB a circuit, 30 s): exit 0, no
   process failure, every client's circuit complete, the data directory
   the witness's (every file under hosts/, etc-hosts, the config,
   sim-stats less wall_seconds and rounds), the witnesses' packets the
   CPU routing's, no divergence, no kernel of A-F launched; spawns and
   syscall dispatches counted and timed; (c) the TCP pair of
   tests/test_managed_network.py (1 MiB at 2 % loss) likewise;
24. the benchmark ladder through the port's twin
   (`shadow_tpu_torch/tools/bench_ladder.py`, the port's Manager): (a)
   rungs 1 (`python3 -m http.server` serving 10 MiB to two `curl`
   clients), 2 (the 100-host tgen mesh) and interpose (100 compiled
   processes) at the JAX tool's shapes, with the device transport on the
   card in sync and mirrored mode, in two children (a mode each) beside
   22 (b): each run's JSON line printed, its data directory (every
   host's files, the fetched files included, and etc-hosts) and packets
   those of a CPU witness on the CPU routing (in the pool), no
   divergence, nothing in flight, no kernel of A-F launched (counted in
   the children); (b) the twin's YAML for rung 3 is byte for byte the
   config phases 22 (b) and (c) run (and the same lines with the
   transport's keys), and its
   rung-4 YAML with each transport is byte for byte phase 23 (b)'s;
25. one JSON line describing every kernel (E's and F's launches of each
   build, A's and C's widths), then the result line.

Usage: python3 chip_smoke.py   (from the repository root; one card).
A fuller record of every measurement is printed on the `record:` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_HOSTS = 32768
ROUNDS = 192
EGRESS_CAP = 16
INGRESS_CAP = 32
N_NODES = 64
CHECK_ROUNDS = 16
LEGACY_WINDOWS = 6  # 11 (b): windows of packed_sort=False at full width
GROW_EVERY = 16
SMALL_CAPS = dict(egress_cap=4, ingress_cap=8)
# H100 SXM peaks (700 W). Bytes: NVIDIA's data sheet. The data sheet's
# 67 TFLOP/s float32 is 128 FMA lanes a clock on 132 SMs at 1.98 GHz; the
# CUDA programming guide's throughput table gives compute capability 9.0
# 64 int32 results a clock an SM (add, compare, shift, logic) and 32 warp
# shuffle results, so a quarter and an eighth of that flop rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
PEAK_SHUFFLES_PER_S = 67e12 / 8
# kernel C is held bitwise at every CE of C_SWEEP and timed at C_TIMED
C_SWEEP = (2, 4, 8, 16, 32, 64, 128, 1024)
C_TIMED = (8, 16, 32)
# 3-5 (d): kernels A and C at the egress capacities no main path runs but
# JAX's kernels take (a row of one slot, and the wide build past 1024), on
# as many rows as fill 1-2 GB of columns (A moves 65 B a slot, C 35 B),
# and kernel B with rings of one slot
WIDE_CES = (1, 2048, 4096, 16384)
WIDE_SLOTS = {"A": 1 << 24, "C": 1 << 25}
WIDE_EDGE_ROWS = 24  # rows of the int32 edge inputs at each width
WIDE_REPS = 10  # timed launches of each kind at each width
# 22 (d): a short PHOLD run through both kernel pairs with rows of this
# many egress slots (kernels A and C in their wide build), and one with
# rings of one ingress slot (kernel B), each against "xla"
PHOLD_WIDE = dict(n_hosts=1024, rounds=8, egress_cap=2048, ingress_cap=32)
PHOLD_CI1 = dict(n_hosts=4096, rounds=8, egress_cap=16, ingress_cap=1)
L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
NO_CLAMP = -(2**30)
MS = 1_000_000
CORPUS = Path(__file__).resolve().parent / "scenarios"
# scenarios/onoff.yaml at a fleet size users run: the same pattern and
# seed, 16384 hosts. onoff.yaml's 96 windows leave the hosts with the
# longest bounded-Pareto OFF periods unfinished at this width (the last
# finishes in window ~132), so the budget is 160 windows, again ~30
# past the last completion as in onoff.yaml
ONOFF_WIDE = {
    "name": "onoff-16384", "family": "onoff", "seed": 23, "hosts": 16384,
    "windows": 160,
    "patterns": [{"kind": "onoff", "first": 0, "count": 16384,
                  "bytes": 1400, "burst": 4, "rounds": 6, "gap_ns": 150000,
                  "on_hold_ns": 2000000, "off_mean_ns": 20000000}],
}
ONOFF_CHECK_WINDOWS = 8
# scenarios/serve_burst_lossy.yaml at a fleet size users run: its one
# pattern, unchanged, repeated over 1638 groups of 10 hosts (one server,
# nine clients each), with its seed, window, caps, 2% loss, compute and
# SLO blocks. Window budget: the first card run (2048 windows, an NVIDIA
# H100 80GB HBM3 at 700 W) finished its last host in window 663, the tail
# of doubled RTOs; plus about 30, rounded up to a multiple of 64
FLEET_GROUPS = 1638
FLEET_WINDOWS = 704
SERVE_FLEET = {
    "name": "serve-fleet-16380", "family": "serve", "seed": 11,
    "hosts": 10 * FLEET_GROUPS, "windows": FLEET_WINDOWS,
    "window_ns": 5000000, "egress_cap": 16, "ingress_cap": 64,
    "transport": "flows", "loss_p": 0.02,
    "compute": {"op": "attn_decode", "queue_cap": 128},
    "serve": {"p99_ns": 120000000, "p999_ns": 400000000},
    "patterns": [{"kind": "serve", "first": 10 * i, "count": 10,
                  "servers": 1, "rounds": 8, "bytes": 1024,
                  "mean_gap_ns": 2000000, "burst_cap": 16,
                  "burst_alpha": 1.2} for i in range(FLEET_GROUPS)],
}
FLEET_REPEAT_WINDOWS = 64
FLEET_CHECK_WINDOWS = 8
# torch.profiler over PROFILE_WINDOWS scenario windows after as many
PROFILE_WINDOWS = 16
# phase 14: the robustness planes as `run_scenarios --faults --guards
# --sample-every K` threads them. The fleet samples fewer packets, so
# that the 4096-slot ring holds a 16-window drain interval's hops
# (a CPU rehearsal at 640 hosts and sample_every=1 counted 32190 events
# in the busiest interval; times 25.6 for the fleet, over 4096)
ROBUST = dict(use_default_faults=True, guards=True, sample_every=64)
FLEET_SAMPLE_EVERY = 512
# the corpus entries whose faulted run drops packets to faults in the JAX
# package's CPU run (`tools/run_scenarios.py --faults --guards`); the
# others finish, or stop sending, before a fault touches them
FAULT_DROP_ENTRIES = {"all-to-all-16", "onoff-32", "ring-allreduce-32",
                      "serve-burst-lossy-10"}
# phase 15: the bench world with a 1 Mbit/s downlink (125 B/ms, so a
# 1400 B packet needs 11.2 ms of tokens, more than a window) and 16
# packets a host: ~180 ms of queue at each router, past CoDel's 10 ms
# target for longer than its 100 ms interval
AQM_DOWN_BPS = 1_000_000
AQM_SEED_PACKETS = 16
AQM_ROUNDS = 64
AQM_CHECK_WINDOWS = 8
# the plain versions' runs cover the windows that carry traffic (the first
# card run's last delivery came in window 17); past them the run checks
# that nothing is delivered. A plain window costs 0.36-0.74 s of host
# time on the card (kernel E's plain version: ~19 000 launches)
AQM_PLAIN_WINDOWS = 18
# kernel E's inputs: the router rows of this window (1-based: the window
# after 12), where CPU rehearsals at 1024 and 4096 hosts drop and cache
# (in window 12 they do neither)
AQM_SNAPSHOT = 13
AQM_CHAIN_NS = 1_000_000  # run-ahead of the chains (JAX's test's too)
AQM_RING = 1 << 16  # holds every sampled hop of the run
# 15 (e): the AQM world's traffic over a router with deep buffers: ingress
# rings of AQM_WIDE_CI slots, so kernel E's rows are that wide (past what
# its staged build takes: its device build); a power of two, as kernel B
# takes
AQM_WIDE_HOSTS = 1024
AQM_WIDE_CI = 32768
AQM_WIDE_WINDOWS = 8
AQM_WIDE_CPU_WINDOWS = 2
# kernel E's int32 operations a micro-step (a pop: the queue pointer, the
# standing-delay test, the state machine's branch, the bucket refill with
# its division by the rate; a resume or a chain start does fewer): an
# estimate from the source, for the operations bound
E_OPS_PER_STEP = 80
# the launch counters' names, each kernel's `<name>_kernel` on the card
PORT_KERNELS = ("egress_rank", "route_place", "egress_gate", "route_scatter",
                "router_drain")
# phase 17: ensembles of ENS_WORLDS bench worlds (drive_ensemble)
ENS_WORLDS = 8
ENS_SOLO_WINDOWS = 32  # (a): each world against its solo run over these
ENS_CHAIN = 16  # the profile: windows 16-31 of a 32-window run
ENS_PAIRS = (("pallas_fused", ("egress_rank", "route_place")),
             ("pallas", ("egress_gate", "route_scatter")))
# phase 17's device ("cpu" in a CPU rehearsal of the phase)
ENS_DEVICE = "cuda"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- the CPU witnesses -------------------------------------------------------
#
# The CPU runs that phases 9, 12-15 hold the card's records against do not
# depend on the card, so `main` starts them all at once in a pool of
# worker processes (spawned, CUDA hidden, WITNESS_THREADS torch threads
# each, sized from the host's cores) and each phase awaits its own where it
# compares. Run alone (a phase called by hand), a phase computes its
# witnesses in this process.

WITNESS_THREADS = 2
_WITNESSES: dict = {}


def witness_jobs() -> dict:
    """Every CPU witness by name: (kind, argument) for `cpu_witness`, in
    the order the pool runs them (the order the phases need them, but
    phase 22's first)."""
    corpus = [p.name for p in sorted(CORPUS.glob("*.yaml"))]
    # phase 22's first: rung 3's CPU plane runs a worker thread a core,
    # which the host-bound phases 20-22 should not share
    jobs = {f"cli:{name}": ("cli", name) for name in (*QUICKSTART, "rung3")}
    # then phase 18's object-plane baseline and phase 24's rungs, short
    # runs the end of the smoke would otherwise wait for
    jobs["cpu-baseline"] = ("cpu-baseline", None)
    jobs.update({f"ladder:{rung}": ("ladder", rung)
                 for rung in LADDER_RUNGS})
    jobs.update({f"corpus:{n}": ("corpus", n) for n in corpus})
    jobs["onoff"] = ("onoff", None)
    jobs["fleet"] = ("fleet", None)
    jobs.update({f"robust:{n}": ("robust", n) for n in corpus})
    jobs["fleet-robust"] = ("fleet-robust", None)
    jobs["aqm"] = ("aqm", None)
    jobs["aqm-wide"] = ("aqm-wide", None)
    for name, _opts in FLOW_A_RUNS:
        jobs[f"flow-a:{name}"] = ("flow-plain", ("a", name))
    for n_flows, q in FLOW_GRID:
        jobs[f"flow-grid:{n_flows}x{q}"] = ("flow-plain",
                                             ("grid", n_flows, q))
    jobs["flow-rung3"] = ("flow-plain", ("rung3",))
    for config, mode in (*((c, m) for c in MANAGED_CONFIGS
                           for m in MANAGED_MODES),
                         *((c, "cpu") for c in EXEC_CONFIGS)):
        jobs[f"managed:{config}:{mode}"] = ("managed", (config, mode))
    return jobs


def _witness_worker_init(threads: int):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(threads)


def cpu_witness(kind: str, arg):
    """One CPU run a card phase compares with: a corpus entry's record
    (`corpus`; `robust` under ROBUST), onoff's and the fleet's records
    at their check windows (`onoff`, `fleet`, `fleet-robust`), the AQM
    world's state digest after AQM_CHECK_WINDOWS (`aqm`) and the wide AQM
    world's after AQM_WIDE_CPU_WINDOWS (`aqm-wide`), and kernel F's plain
    version on phase 20 (a)'s worlds (`flow-plain`, `flow_plain_witness`),
    phase 23's managed runs through the CLI (`managed`), phase 24's
    rungs through the ladder's twin on the CPU routing (`ladder`), and
    the bench record's object-plane rate (`cpu-baseline`)."""
    import torch

    from shadow_tpu_torch import convert
    from shadow_tpu_torch.workloads import runner, spec

    if kind in ("corpus", "robust"):
        sp = spec.load_scenario_file(str(CORPUS / arg))
        kw = ROBUST if kind == "robust" else {}
        return runner.run_scenario(sp, device="cpu", **kw)
    if kind == "onoff":
        sp = spec.parse_scenario(ONOFF_WIDE)
        return runner.run_scenario(dataclasses.replace(
            sp, windows=ONOFF_CHECK_WINDOWS), device="cpu")
    if kind in ("fleet", "fleet-robust"):
        sp = spec.parse_scenario(SERVE_FLEET)
        kw = (dict(ROBUST, sample_every=FLEET_SAMPLE_EVERY)
              if kind == "fleet-robust" else {})
        return runner.run_scenario(dataclasses.replace(
            sp, windows=FLEET_CHECK_WINDOWS), device="cpu", **kw)
    if kind == "aqm":
        st, *_ = aqm_windows(torch, aqm_world("cpu"), "xla",
                             AQM_CHECK_WINDOWS)
        return convert.state_digest(st)
    if kind == "flow-plain":
        return flow_plain_witness(*arg)
    if kind == "managed":
        return managed_witness(*arg)
    if kind == "ladder":
        return ladder_witness(arg)
    if kind == "cpu-baseline":
        from shadow_tpu_torch import bench

        return bench.bench_cpu_baseline()
    if kind == "cli":
        if arg == "rung3":
            return cli_witness(with_experimental(
                rung3_live_text(), CLI_CPU_ROUTING), stop=RUNG3_LIVE_STOP)
        return cli_witness(quickstart_text(arg))
    if kind == "aqm-wide":
        # rows of K = AQM_WIDE_CI: the plain drain stops once every host
        # has halted (bitwise its fixed 4K + 16 micro-steps, too many to
        # run at this width)
        from shadow_tpu_torch.tpu import codel

        plain = codel.router_drain_plain
        codel.router_drain_plain = lambda *a: plain(
            *a, until=lambda halted: bool(halted.all()))
        try:
            st, *_ = aqm_windows(torch, aqm_wide_world("cpu"), "xla",
                                 AQM_WIDE_CPU_WINDOWS)
        finally:
            codel.router_drain_plain = plain
        return convert.state_digest(st)
    raise ValueError(f"no CPU witness {kind!r}")


def start_witnesses():
    """Start every CPU witness in a pool of spawned workers; returns the
    pool (terminate it when done) and its size, printed with the host's
    cores."""
    import multiprocessing

    cores = os.cpu_count() or 1
    workers = max(1, (cores - 2) // WITNESS_THREADS)
    pool = multiprocessing.get_context("spawn").Pool(
        workers, _witness_worker_init, (WITNESS_THREADS,))
    for name, (kind, arg) in witness_jobs().items():
        _WITNESSES[name] = pool.apply_async(cpu_witness, (kind, arg))
    print(f"CPU witnesses: {len(_WITNESSES)} runs in a pool of {workers} "
          f"workers x {WITNESS_THREADS} torch threads on a host of {cores} "
          f"cores (os.cpu_count())")
    return pool, workers, cores


def witness(name: str):
    """The CPU witness `name`: awaited from the pool, or computed here
    when no pool runs it."""
    job = _WITNESSES.pop(name, None)
    if job is not None:
        return job.get()
    return cpu_witness(*witness_jobs()[name])


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    if not out:
        fail("nvidia-smi printed no card")
    return out.splitlines()[0]


def time_device(torch, fn, reps: int = 50) -> tuple[float, float, float]:
    """Milliseconds of device time per call of `fn`: (warm, cold,
    cold_clean). Warm is CUDA events around `reps` back-to-back calls on
    the same inputs, which then sit in L2. Cold puts events around each
    call, after a write of L2_FLUSH_BYTES that evicts them, so its bytes
    come from HBM; that write leaves L2 full of dirty lines, which the
    timed call may have to write back. Cold_clean follows the write with a
    read of the same buffer, so L2 holds clean lines when the call
    starts. A spin kernel queued first keeps the card busy while the
    host enqueues, so host overhead does not show as idle."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    dirty = lambda: flush.fill_(0)
    clean = lambda: (flush.fill_(0), flush.sum())
    fn()
    clean()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        clean()
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = lambda: torch.cuda._sleep(int(min(2.5 * host_s + 1e-3, 4.0) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    warm = start.elapsed_time(end) / reps
    colds = []
    for evict in (dirty, clean):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        spin()
        for s, e in pairs:
            evict()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        colds.append(sum(s.elapsed_time(e) for s, e in pairs) / reps)
    return warm, colds[0], colds[1]


def max_abs_err(torch, got, ref) -> int:
    err = 0
    for a, b in zip(got, ref):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"dtype/shape mismatch {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, int_ops: float,
          shuffles: float = 0) -> tuple[float, str]:
    """The least time (ms) and what sets it: the bytes over HBM's rate,
    or the int32 operations and warp shuffles, each over its own rate
    (the slower of the two, since they may overlap)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(int_ops / PEAK_INT32_OPS_PER_S,
                shuffles / PEAK_SHUFFLES_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def egress_inputs(torch, n, ce, seed):
    """Kernel A's arguments on the card, drawn there by a seeded CUDA
    generator (at the widths of 3 (d) numpy would take the host
    seconds): 70 % of the slots valid, duplicate priorities and seqs
    (ties by column), garbage in invalid slots, NO_CLAMP and real
    clamps, starved and full token buckets."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    draw = lambda lo, hi, shape=(n, ce): torch.randint(
        lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    coin = lambda p: torch.rand((n, ce), generator=g, device="cuda") < p
    valid = coin(0.7)
    clamp = torch.where(coin(0.5), NO_CLAMP, draw(-5 * MS, 20 * MS))
    cols = (valid, draw(0, 8), draw(60, 1500), draw(-20 * MS, 10 * MS),
            clamp, draw(-1, n), draw(0, 4 * ce), draw(0, 64), coin(0.2))
    return (*cols, draw(0, ce * 1500, (n,)), 10 * MS)


def check_kernel_a(torch, pipeline, record):
    rows = []
    for ce in (8, 16, 32, 64):
        args = egress_inputs(torch, N_HOSTS, ce, seed=ce)
        got = pipeline.egress_rank_stage(*args)
        ref = pipeline.egress_rank_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, ref)
        if err != 0:
            fail(f"egress_rank_kernel CE={ce} disagrees with its plain "
                 f"version (max abs err {err})")
        warm_ms, ms, clean_ms = time_device(
            torch, lambda: pipeline.egress_rank_stage(*args))
        _, plain_ms, _ = time_device(
            torch, lambda: pipeline.egress_rank_plain(*args), reps=10)
        moved = nbytes(args[:10]) + nbytes(got)
        lg = int(math.log2(ce))
        stages = lg * (lg + 1) // 2  # compare-exchange stages a network
        # per slot and stage of the two networks ~6 int ops (pair compare,
        # direction, two selects); the scan 2 a step, the row sum 1, ~16
        # of rebase and packing. The warp path (CE <= 32) exchanges through
        # shuffles: 2 a stage, 8 for the payload permutation, lg each for
        # the scan and the row sum; the block path through shared memory.
        ops = N_HOSTS * ce * (2 * 6 * stages + 3 * lg + 16)
        shuffles = N_HOSTS * ce * (2 * 2 * stages + 8 + 2 * lg) \
            if ce <= 32 else 0
        bound_ms, bound_by = bound(moved, ops, shuffles)
        row = dict(ce=ce, n=N_HOSTS, max_abs_err=err, ms=ms, warm_ms=warm_ms,
                   cold_clean_ms=clean_ms, plain_ms=plain_ms, bytes=moved,
                   ops=ops, shuffles=shuffles, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms)
        rows.append(row)
        print(f"kernel A egress_rank CE={ce}: bitwise ok, kernel_ms={ms:.5f}"
              f" (cold L2; clean {clean_ms:.5f}; warm {warm_ms:.5f}) "
              f"plain_ms={plain_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}, {moved} B, {ops} int "
              f"ops, {shuffles} shuffles) share={bound_ms / ms:.3f} "
              f"library_ms=null")
    record["kernel_a"] = rows
    return next(r for r in rows if r["ce"] == EGRESS_CAP)


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, shared memory, stack and spill bytes of each function
    in an `nvcc -Xptxas -v` log, by function name (an entry lacks what
    the log does not say of it)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            # ptxas prints no smem count for a kernel without static
            # shared memory
            out.setdefault(fn, dict(smem=0))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[fn]["smem"] = int(m.group(1))
    return out


def check_ptxas(record, lib, label, key, kernel, builds, arg=None):
    """ptxas' report of kernel `kernel` of library `lib`, one line a
    build: a value of its first template argument `arg`, or its one
    build (`builds` (None,)). Fails on a spill, on a build whose report
    lacks its registers or spills, and on builds other than `builds`."""
    from shadow_tpu_torch import _build

    report = ptxas_report(_build.LOGS.get(lib, ""))
    if not report:  # not built in this process, or built without -v
        _build.build([lib], verbose_ptxas=True)
        report = ptxas_report(_build.LOGS[lib])
    rows = {}
    for fn, r in report.items():
        if kernel not in fn:
            continue
        if not {"registers", "spill_stores"} <= r.keys():
            fail(f"ptxas' report of {label} lacks registers or spills: "
                 f"{fn} {r}")
        m = re.search(r"IL[ib](\d+)E", fn)
        rows[int(m.group(1)) if m else None] = r
    order = lambda v: -1 if v is None else v
    if sorted(rows, key=order) != sorted(builds, key=order):
        fail(f"ptxas reports {label} builds {sorted(rows, key=order)}, "
             f"expected {sorted(builds, key=order)}")
    for v in sorted(rows, key=order):
        r = rows[v]
        print(f"{label} ptxas{'' if v is None else f' {arg}={v}'}: "
              f"{r['registers']} registers, {r['smem']} B smem, "
              f"{r['stack']} B stack, spill stores {r['spill_stores']} B, "
              f"loads {r['spill_loads']} B")
        if r["spill_stores"] or r["spill_loads"]:
            fail(f"{label} spills" + ("" if v is None else f" at {arg}={v}"))
    record[key] = {str(v): r for v, r in rows.items()}
    return record[key]


def check_kernel_c(torch, pipeline, record):
    """Kernel C bitwise against its plain version at every CE of
    C_SWEEP, on random inputs at N_HOSTS and on the CPU tests' edge
    inputs (`tests/torch_parity.gate_edge_columns`, both shifts) at a
    ragged N_HOSTS - 5; timed at C_TIMED."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parity import EDGE_SHIFTS, gate_edge_columns

    # one build a power-of-two CE in [1, 1024], and the wide build
    check_ptxas(record, "egress_gate", "kernel C egress_gate",
                "kernel_c_ptxas", "egress_gate_kernel",
                [1 << i for i in range(11)], "CE")
    rows = []
    for ce in C_SWEEP:
        full = egress_inputs(torch, N_HOSTS, ce, seed=100 + ce)
        args = (*full[:5], full[9], full[10])  # valid..clamp, balance, shift
        cases = [("random", args)]
        edge = gate_edge_columns(N_HOSTS - 5, ce, seed=ce)
        for shift in EDGE_SHIFTS:
            cases.append((f"edge shift={shift}", (*(
                torch.from_numpy(v).cuda() for v in edge.values()), shift)))
        outs = []
        for what, case in cases:
            outs.append(pipeline.egress_order_gate(*case))
            ref = pipeline.egress_gate_plain(*case)
            torch.cuda.synchronize()
            err = max_abs_err(torch, outs[-1], ref)
            if err != 0:
                fail(f"egress_gate_kernel CE={ce} ({what} inputs) disagrees "
                     f"with its plain version (max abs err {err})")
        print(f"kernel C egress_gate CE={ce}: bitwise ok on random inputs "
              f"(N={N_HOSTS}) and edge inputs (N={N_HOSTS - 5}, shifts "
              f"{EDGE_SHIFTS})")
        if ce not in C_TIMED:
            continue
        warm_ms, ms, clean_ms = time_device(
            torch, lambda: pipeline.egress_order_gate(*args))
        _, plain_ms, _ = time_device(
            torch, lambda: pipeline.egress_gate_plain(*args), reps=10)
        moved = nbytes(args[:6]) + nbytes(outs[0])
        lg = int(math.log2(ce))
        stages = lg * (lg + 1) // 2
        # kernel A's count for one network: ~6 int ops a slot and stage,
        # 3 a scan step and row-sum step, ~16 of rebase and packing; the
        # warp path's shuffles: 2 a stage, 3 for the carried columns, lg
        # each for the scan and the row sum
        ops = N_HOSTS * ce * (6 * stages + 3 * lg + 16)
        shuffles = N_HOSTS * ce * (2 * stages + 3 + 2 * lg) \
            if ce <= 32 else 0
        bound_ms, bound_by = bound(moved, ops, shuffles)
        # a yardstick of the timing, not of the function: a device copy
        # that reads and writes as many bytes as the kernel moves
        src = torch.empty(moved // 8, dtype=torch.int32, device="cuda")
        dst = torch.empty_like(src)
        copy_warm, copy_ms, copy_clean = time_device(
            torch, lambda: dst.copy_(src))
        row = dict(ce=ce, n=N_HOSTS, max_abs_err=err, ms=ms, warm_ms=warm_ms,
                   cold_clean_ms=clean_ms, plain_ms=plain_ms, bytes=moved,
                   ops=ops, shuffles=shuffles, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms,
                   copy_ms=copy_ms, copy_clean_ms=copy_clean,
                   copy_warm_ms=copy_warm)
        rows.append(row)
        print(f"kernel C egress_gate CE={ce}: bitwise ok, kernel_ms={ms:.5f}"
              f" (cold L2; clean {clean_ms:.5f}; warm {warm_ms:.5f}) "
              f"plain_ms={plain_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}, {moved} B, {ops} int "
              f"ops, {shuffles} shuffles) share={bound_ms / ms:.3f} "
              f"library_ms=null; a copy of {moved} B: {copy_ms:.5f} cold, "
              f"{copy_clean:.5f} clean, {copy_warm:.5f} warm")
    record["kernel_c"] = rows
    return next(r for r in rows if r["ce"] == EGRESS_CAP)


def egress_edge_inputs(torch, n, ce, seed, shift):
    """Kernel A's arguments at the edges of int32: the CPU tests' edge
    columns (`tests/torch_parity.gate_edge_columns`: negative priorities,
    wrapping rebases and prefix sums, NO_CLAMP, extreme balances) and
    random dst, seq, sock and ctrl, on the card."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parity import gate_edge_columns

    cols = gate_edge_columns(n, ce, seed)
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    extra = dict(dst=i32(rng.integers(-1, n, (n, ce))),
                 seq=i32(rng.integers(-2**31, 2**31, (n, ce))),
                 sock=i32(rng.integers(0, 64, (n, ce))),
                 ctrl=rng.random((n, ce)) < 0.2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    order = ("valid", "prio", "nbytes", "tsend", "clamp")
    return (*(t(cols[k]) for k in order),
            *(t(extra[k]) for k in ("dst", "seq", "sock", "ctrl")),
            t(cols["balance"]), shift)


def check_egress_widths(torch, pipeline, record, ident, which: str):
    """3 (d) / 4 (d): kernel A (`which` "A") or C ("C") at each egress
    capacity of WIDE_CES, on WIDE_SLOTS[which] slots of random columns
    and on WIDE_EDGE_ROWS rows of int32 edge columns (both shifts),
    bitwise against the plain version; the build the launcher ran, by
    its launch count; timed cold, clean and warm beside its bound by
    bytes (each input read and each output written once)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parity import EDGE_SHIFTS

    if which == "A":
        stage, plain = pipeline.egress_rank_stage, pipeline.egress_rank_plain
        builds, name = pipeline.A_BUILD_LAUNCHES, "egress_rank"
        pick = lambda full: full
    else:
        stage, plain = pipeline.egress_order_gate, pipeline.egress_gate_plain
        builds, name = pipeline.C_BUILD_LAUNCHES, "egress_gate"
        pick = lambda full: (*full[:5], full[9], full[10])
    check_ptxas(record, name, f"kernel {which}'s wide build",
                f"kernel_{which.lower()}_wide_ptxas", f"{name}_wide", [None])
    rows = []
    for ce in WIDE_CES:
        n = WIDE_SLOTS[which] // ce
        cases = [("random", pick(egress_inputs(torch, n, ce,
                                                       seed=7 * ce + 1)))]
        for shift in EDGE_SHIFTS:
            cases.append((f"edge shift={shift}", pick(egress_edge_inputs(
                torch, WIDE_EDGE_ROWS, ce, ce + 3, shift))))
        for what, case in cases:
            pipeline.reset_launches()
            got = stage(*case)
            torch.cuda.synchronize()
            launched = {k: v for k, v in builds.items() if v}
            want_build = pipeline.egress_build(name, ce)
            if launched != {want_build: 1} or pipeline.LAUNCHES[name] != 1:
                fail(f"kernel {which} at CE={ce} launched {launched} "
                     f"({pipeline.LAUNCHES[name]} launches), expected one "
                     f"of its {want_build} build")
            ref = plain(*case)
            err = max_abs_err(torch, got, ref)
            if err != 0:
                fail(f"kernel {which} ({name}) at CE={ce} ({what} inputs) "
                     f"disagrees with its plain version (max abs err {err})")
            if what == "random":
                outs = got
            del got, ref
        args = cases[0][1]
        warm_ms, ms, clean_ms = time_device(
            torch, lambda: stage(*args), reps=WIDE_REPS)
        _, plain_ms, _ = time_device(torch, lambda: plain(*args), reps=2)
        moved = nbytes(a for a in args if isinstance(a, torch.Tensor)) + \
            nbytes(outs)
        bound_ms, bound_by = bound(moved, 0)
        row = dict(ce=ce, n=n, build=want_build, max_abs_err=0, ms=ms,
                   warm_ms=warm_ms, cold_clean_ms=clean_ms,
                   plain_ms=plain_ms, bytes=moved, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms)
        rows.append(row)
        print(f"{which} (d) {name} CE={ce} N={n} ({want_build} build, one "
              f"launch a call): bitwise ok on random inputs and int32 edge "
              f"inputs (N={WIDE_EDGE_ROWS}, shifts {EDGE_SHIFTS}); "
              f"kernel_ms={ms:.5f} (cold L2; clean {clean_ms:.5f}; warm "
              f"{warm_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms="
              f"{bound_ms:.5f} ({bound_by}, {moved} B) share="
              f"{bound_ms / ms:.3f}  [{ident}]")
        del cases, args, outs
        torch.cuda.empty_cache()
    record[f"kernel_{which.lower()}_widths"] = rows
    return rows


def check_b_one_slot(torch, pipeline, record, ident):
    """5 (d): kernel B with rings of one slot (CI = 1, which JAX's
    `_place_kernel` takes): the routing stage `route_place` at N=32768,
    CE=16 on the card, through B and through its plain version on
    clones of the same inputs, bitwise; rows overflow. Then B alone on
    the stage's arguments, timed cold, clean and warm beside its plain
    version, with its byte bound (`placement_bytes`)."""
    n, ce = N_HOSTS, EGRESS_CAP
    full = egress_inputs(torch, n, ce, seed=5)
    full = (*full[:5], torch.remainder(full[5], n), *full[6:])
    out = pipeline.egress_rank_stage(*full)
    sock, dst, nb, seq, valid, row_perm = (out[1], out[2], out[3], out[4],
                                           out[8], out[11])
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    sent = valid & (torch.rand((n, ce), generator=g, device="cuda") < 0.8)
    deliver = torch.randint(-MS, 30 * MS, (n, ce), generator=g,
                            device="cuda", dtype=torch.int32)
    n_in = torch.randint(0, 2, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    in_valid = (n_in == 1)[:, None].clone()
    in_deliver = torch.where(in_valid, 5 * MS, 2**31 - 1).to(torch.int32)
    rings = [torch.randint(-9, 500, (n, 1), generator=g, device="cuda",
                           dtype=torch.int32) for _ in range(4)]
    args = (sent, dst, seq, nb, sock, deliver, in_deliver, *rings, in_valid,
            n_in, row_perm)
    clone = lambda: [a.clone() for a in args]
    pipeline.reset_launches()
    got = pipeline.route_place(*clone())
    launches = pipeline.LAUNCHES["route_place"]
    ref = pipeline.route_place(*clone(), plain=True)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, ref)
    if err != 0 or launches != 1:
        fail(f"kernel B at CI=1: max abs err {err}, {launches} launches")
    overflow = int(got[-1].sum())
    if overflow == 0:
        fail("kernel B at CI=1: no ring overflowed")
    # B alone on the routing stage's arguments, timed as check_placement
    # times it (the untimed first call rewrites every invalid deliver)
    work, _ = pipeline._placement_args(*clone())
    warm_ms, ms, clean_ms = time_device(torch, lambda: pipeline.place(*work))
    _, plain_ms, _ = time_device(
        torch, lambda: pipeline.place(*work, plain=True), reps=20)
    nv, offsets, take = (t.cpu().numpy()[:, None] for t in work[:3])
    placed = (nv <= 0) & (0 < nv + take)
    j = offsets - nv
    inside = placed & (j >= 0) & (j < n * ce)
    moved, rewrites = placement_bytes(work[13], work[14], placed, inside)
    if rewrites != 0:
        fail(f"kernel B at CI=1 left {rewrites} invalid delivers "
             f"unrewritten")
    ops = n * 6 + int(placed.sum()) * 30
    bound_ms, bound_by = bound(moved, ops)
    record["kernel_b_ci1"] = dict(
        n=n, ce=ce, overflow=overflow, max_abs_err=err, ms=ms,
        cold_clean_ms=clean_ms, warm_ms=warm_ms, plain_ms=plain_ms,
        placed=int(placed.sum()), bytes=moved, bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / ms)
    print(f"5 (d) kernel B route_place at CI=1 (N={n}, CE={ce}): bitwise "
          f"its plain version through the routing stage, {overflow} "
          f"arrivals overflowed; B alone on the stage's arguments "
          f"kernel_ms={ms:.5f} (cold L2; clean {clean_ms:.5f}; warm "
          f"{warm_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
          f"({bound_by}, {moved} B, {int(placed.sum())} slots placed) "
          f"share={bound_ms / ms:.3f}  [{ident}]")


def placement_inputs(torch, n=N_HOSTS, n_src=None):
    """Kernel B's and D's inputs at the main path's shape: bucket
    segments that tile the N*CE arrival slots, 1 in 16 destination rows
    hot enough to overflow the ring, a random arrival order `o_pos` (a
    permutation of N*CE), random row orders `row_perm` and payload and
    ingress columns; row 0's segment starts before the first arrival and
    row N-1's runs past the last (their slots outside read 0). Returns
    (args, counts, placed and placed-reading-an-arrival [N, CI] bool).
    With `n_src` the source columns have n_src rows (a mesh rank's
    launch after the routing exchange) and the arrivals n_src*CE slots."""
    ce, ci = EGRESS_CAP, INGRESS_CAP
    m = n if n_src is None else n_src
    rng = np.random.default_rng(5)
    nv = rng.integers(0, ci + 1, n)
    # arrivals per destination: mostly near the mean, 1 in 16 rows hot
    counts = rng.poisson(ce * 0.8, n)
    hot = rng.random(n) < 1 / 16
    counts[hot] += rng.integers(ci, 2 * ci, hot.sum())
    counts = np.minimum(counts, np.maximum(
        0, m * ce - (np.cumsum(counts) - counts)))  # fit the m*CE slots
    offsets = np.cumsum(counts) - counts
    take = np.minimum(counts, ci - nv)
    if not (counts > ci - nv).any():
        fail("the placement check built no overflowing row")
    nv[0], take[0], offsets[0] = 0, ci, -(ci // 2)
    nv[-1], take[-1], offsets[-1] = 1, ci - 1, m * ce - ci // 2
    dev = torch.device("cuda")
    t = lambda a, dt=np.int32: torch.from_numpy(
        np.ascontiguousarray(a, dt)).to(dev)
    words = lambda *shape: t(rng.integers(-2**31, 2**31, shape))
    deliver = rng.integers(-2**31, 2**31, (n, ci))
    deliver[rng.random((n, ci)) < 0.25] = 2**31 - 1
    args = (t(nv), t(offsets), t(take),
            t(rng.permutation(m * ce), np.int64),
            t(np.argsort(rng.random((m, ce)), axis=1)),
            *(words(m, ce) for _ in range(4)),
            *(words(n, ci) for _ in range(4)), t(deliver),
            t(rng.random((n, ci)) < 0.5, bool))
    ccol = np.arange(ci)[None, :]
    placed = (ccol >= nv[:, None]) & (ccol < (nv + take)[:, None])
    j = (offsets - nv)[:, None] + ccol
    inside = placed & (j >= 0) & (j < m * ce)
    return args, counts, placed, inside


def placement_bytes(deliver, valid, placed, inside) -> tuple[int, int]:
    """What kernels B and D must move when called on the ingress
    `deliver` and `valid` tensors as they stand: 12 B a row (nv, offsets,
    take); valid + deliver (5 B) a slot for the select; five words and
    the valid byte (21 B) written a placed slot, and for one that reads
    an arrival, its o_pos (8 B), row_perm and four payload words (20 B);
    4 B for each deliver of an unplaced invalid slot rewritten to
    I32_MAX. Returns (bytes, rewrites)."""
    n, ci = placed.shape
    valid = valid.cpu().numpy()
    deliver = deliver.cpu().numpy()
    rewrites = int((~placed & ~valid & (deliver != 2**31 - 1)).sum())
    return (12 * n + 5 * n * ci + 21 * int(placed.sum())
            + 28 * int(inside.sum()) + 4 * rewrites), rewrites


def check_placement(torch, pipeline, record, tag, name, kernel, plain):
    """One placement kernel (B or D) on `placement_inputs`: bitwise
    against its plain version, each on its own clone of the inputs (both
    update the ingress tensors in place), timed cold and warm (on one
    input set: a second call rewrites the same values), with its bound.
    The bound counts the bytes of the timed calls: the first, untimed
    call has rewritten every invalid deliver, so they rewrite none.
    Returns (row, the kernel's outputs)."""
    n, ci = N_HOSTS, INGRESS_CAP
    args, counts, placed, inside = placement_inputs(torch)
    clone = lambda: [a.clone() for a in args]
    mine = clone()
    got = kernel(*mine)
    ref = plain(*clone())
    torch.cuda.synchronize()
    if [g.data_ptr() for g in got] != [a.data_ptr() for a in mine[9:]]:
        fail(f"{name} did not return the ingress tensors it was given")
    err = max_abs_err(torch, got, ref)
    if err != 0:
        fail(f"{name} disagrees with its plain version (max abs err {err})")
    work = clone()
    warm_ms, ms, clean_ms = time_device(torch, lambda: kernel(*work))
    _, plain_ms, _ = time_device(torch, lambda: plain(*work), reps=20)
    _, rewrites = placement_bytes(args[13], args[14], placed, inside)
    moved, timed_rewrites = placement_bytes(work[13], work[14], placed,
                                            inside)
    if timed_rewrites != 0:
        fail(f"{name} left {timed_rewrites} invalid delivers unrewritten")
    # per slot ~6 int ops (bounds, compare, select); per placed slot ~30
    # more (the 64-bit index chain)
    ops = n * ci * 6 + int(placed.sum()) * 30
    bound_ms, bound_by = bound(moved, ops)
    nv = args[0].cpu().numpy()
    row = dict(n=n, ci=ci, placed=int(placed.sum()), rewrites=rewrites,
               overflow_rows=int((counts > ci - nv).sum()),
               max_abs_err=err, ms=ms, warm_ms=warm_ms,
               cold_clean_ms=clean_ms, plain_ms=plain_ms, bytes=moved,
               ops=ops, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms)
    record[tag] = row
    print(f"{name} N={n} CI={ci}: bitwise ok "
          f"({row['overflow_rows']} overflowing rows, {row['placed']} slots "
          f"placed, {rewrites} delivers rewritten by the first call, none "
          f"by the timed ones), kernel_ms={ms:.5f} "
          f"(cold L2; clean {clean_ms:.5f}; warm {warm_ms:.5f}) "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}, "
          f"{moved} B, {ops} int ops) share={bound_ms / ms:.3f} "
          f"library_ms=null")
    return row, got


def check_state(torch, state, n, ce, ci):
    for name, t in state._asdict().items():
        if name == "router":
            continue
        want = {"eg": (n, ce), "in": (n, ci)}.get(name[:2])
        if want is not None and tuple(t.shape) != want:
            fail(f"state.{name} has shape {tuple(t.shape)}, want {want}")
        if t.device.type != "cuda":
            fail(f"state.{name} left the card")
    if int(state.n_sent.sum()) <= 0 or int(state.n_delivered.sum()) <= 0:
        fail("the main path sent or delivered nothing")


def check_golden(bench, convert, kernel):
    g = dict(bench.GOLDEN_PHOLD)
    golden = bench.run_phold(g.pop("n_hosts"), rounds=g.pop("rounds"),
                             warmup=False, kernel=kernel, **g)
    digest = convert.state_digest(golden["state"])
    if digest != bench.GOLDEN_PHOLD_DIGEST:
        fail(f"golden PHOLD digest through kernel={kernel!r} {digest} != "
             f"{bench.GOLDEN_PHOLD_DIGEST}")
    print(f"golden digest, kernel={kernel}: ok ({digest[:16]}..., N=1024, "
          f"R=16)")


def check_main_path(torch, bench, convert, pipeline, record, ident, kernel,
                    pair):
    """The main path through one kernel pair: a warm-up run, the counted
    and timed run, then R=16 through the kernels against the plain
    versions. Returns the launch counts of the counted run."""
    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP, kernel=kernel)
    bench.run_phold(N_HOSTS, rounds=ROUNDS, warmup=False, **size)  # warm-up
    pipeline.reset_launches()
    main_run = bench.run_phold(N_HOSTS, rounds=ROUNDS, warmup=False, **size)
    launches = dict(pipeline.LAUNCHES)
    for name, count in launches.items():
        want = ROUNDS if name in pair else 0
        if count != want:
            fail(f"kernel {name} launched {count} times on the "
                 f"kernel={kernel!r} main path, expected {want}")
    check_state(torch, main_run["state"], N_HOSTS, EGRESS_CAP, INGRESS_CAP)
    rate = main_run["packet_events_per_sec"]
    rec = {k: v for k, v in main_run.items() if k != "state"}
    rec["launches"] = launches
    rec["digest"] = convert.state_digest(main_run["state"])
    print(f"main path, kernel={kernel}: N={N_HOSTS} CE={EGRESS_CAP} "
          f"CI={INGRESS_CAP} M={N_NODES} R={ROUNDS}: "
          f"packet_events_per_sec={rate:.1f} (events {main_run['events']}, "
          f"wall {main_run['wall_s']:.4f}s, launches {launches}) on {ident}")

    fused = bench.run_phold(N_HOSTS, rounds=CHECK_ROUNDS, warmup=False,
                            **size)
    plain = bench.run_phold(N_HOSTS, rounds=CHECK_ROUNDS, warmup=False,
                            plain_kernels=True, **size)
    d_kern = convert.state_digest(fused["state"])
    d_plain = convert.state_digest(plain["state"])
    if d_kern != d_plain or fused["delivered"] != plain["delivered"]:
        fail(f"the R=16 kernel={kernel!r} run through the kernels differs "
             "from the run through their plain versions")
    rec["plain_vs_kernels"] = {
        "rounds": CHECK_ROUNDS, "digest": d_kern,
        "kernel_wall_s": fused["wall_s"], "plain_wall_s": plain["wall_s"]}
    record[f"main_path_{kernel}"] = rec
    print(f"kernels vs plain versions, kernel={kernel}, R={CHECK_ROUNDS}: "
          f"bitwise ok (wall {fused['wall_s']:.4f}s vs "
          f"{plain['wall_s']:.4f}s)")
    return launches


def check_capacity(bench, convert, elastic, record):
    """Elastic growth on the split path ends as the pre-provisioned run;
    strict refuses the overflow."""
    common = dict(rounds=ROUNDS, warmup=False, n_nodes=N_NODES,
                  kernel="pallas")
    grown = bench.run_phold(N_HOSTS, capacity="elastic",
                            grow_every=GROW_EVERY, **SMALL_CAPS, **common)
    cap = grown["capacity"]
    growth = [e for e in cap["events"] if e["kind"] == "capacity-growth"]
    if not growth:
        fail("elastic run from CE=4, CI=8 grew no ring: the check is dead")
    pre = bench.run_phold(N_HOSTS, **cap["final"], **common)
    d_grown = convert.state_digest(elastic.canonical_state(grown["state"]))
    d_pre = convert.state_digest(elastic.canonical_state(pre["state"]))
    if d_grown != d_pre or grown["delivered"] != pre["delivered"]:
        fail(f"elastic run ({cap['final']}) differs from the run "
             "pre-provisioned at its final caps")
    try:
        bench.run_phold(N_HOSTS, capacity="strict", grow_every=GROW_EVERY,
                        **SMALL_CAPS, **common)
    except elastic.CapacityError as e:
        span = getattr(e, "chain_span", None)
        if span is None:
            fail("strict CapacityError carries no chain_span")
        strict = {"chain_span": list(span), "ring": e.ring,
                  "blamed_hosts": len(e.blame)}
    else:
        fail("strict run from CE=4, CI=8 raised no CapacityError")
    record["capacity"] = {
        "elastic": {k: v for k, v in grown.items() if k != "state"},
        "pre_provisioned_wall_s": pre["wall_s"], "digest": d_grown,
        "strict": strict}
    print(f"capacity: elastic from {SMALL_CAPS} grew "
          f"{[(e['ring'], e['from'], e['to'], e['time_ns']) for e in growth]}"
          f" to {cap['final']}, canonical state and delivered total "
          f"({grown['delivered']}) equal the pre-provisioned run's; "
          f"elastic wall {grown['wall_s']:.4f}s vs {pre['wall_s']:.4f}s; "
          f"strict raised CapacityError at chain {span} ({strict['ring']}, "
          f"{strict['blamed_hosts']} hosts blamed)")


def card_work(prof, windows: int):
    """The card's kernels and copies in a finished torch.profiler run
    (its user annotations left out), and their count and busy ms a window
    over `windows` windows."""
    from torch.autograd import DeviceType

    on_card = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation]
    busy_ms = sum(ev.time_range.elapsed_us() for ev in on_card) / 1e3
    return on_card, {"windows": windows,
                     "kernel_launches_per_window": len(on_card) / windows,
                     "device_busy_ms_per_window": busy_ms / windows}


def profile_chains(torch, drive, start: int, stop: int) -> dict:
    """Device kernels and busy ms a window of windows [start, stop) of a
    chained run under torch.profiler: `drive(on_chain)` runs it and calls
    `on_chain(r1, ...)` after each chain; the profiler starts and stops
    at the chain ends `start` and `stop`, after a synchronise, so the
    set-up, the chains before and what follows the run stay out of it.
    The profiled windows' wall time is not reported: the profiler's own
    start-up and recording are in it."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)

    def on_chain(r1, *_):
        if r1 in (start, stop):
            torch.cuda.synchronize()
            prof.start() if r1 == start else prof.stop()

    drive(on_chain)
    on_card, out = card_work(prof, stop - start)
    if not on_card:
        fail(f"the profiler recorded no device work in windows "
             f"[{start}, {stop})")
    # the port's own kernels among them (each kernel's symbol holds its
    # source file's name): launches a window, us a launch
    port = {}
    for name in PORT_KERNELS:
        us = [ev.time_range.elapsed_us() for ev in on_card
              if name in ev.name]
        if us:
            port[name] = {"launches_per_window": len(us) / (stop - start),
                          "us_per_launch": sum(us) / len(us)}
    out["port_kernels"] = port
    return out


def profile_scenario(torch, runner, sp, windows: int = PROFILE_WINDOWS,
                     **run_kw):
    """Device kernels and busy ms a window of a scenario's windows
    [windows, 2 * windows) (the run is cut to 2 * windows and driven in
    chains of `windows`). `run_kw` goes to `run_scenario`."""
    return profile_chains(
        torch, lambda on_chain: runner.run_scenario(
            dataclasses.replace(sp, windows=2 * windows), chain_len=windows,
            on_chain=on_chain, **run_kw),
        windows, 2 * windows)


def check_corpus(torch, pipeline, record, ident):
    """Phase 9: the whole scenario corpus on the card."""
    from shadow_tpu_torch.workloads import runner, spec

    golden = runner.load_golden(CORPUS / "GOLDEN.json")
    rows = []
    pipeline.reset_launches()
    for path in sorted(CORPUS.glob("*.yaml")):
        sp = spec.load_scenario_file(str(path))
        timings = {}
        rec = runner.run_scenario(sp, timings=timings)
        if any(pipeline.LAUNCHES.values()):
            fail(f"the corpus run of {sp.name} launched kernels "
                 f"{pipeline.LAUNCHES}; the XLA path launches none")
        if runner.golden_entry(rec) != golden[sp.name]:
            fail(f"{sp.name}: {runner.golden_entry(rec)} != golden "
                 f"{golden[sp.name]}")
        if rec != witness(f"corpus:{path.name}"):
            fail(f"{sp.name}: the card's record differs from the CPU's")
        rate = sp.windows / timings["drive_s"]
        extra = {k: rec[k] for k in ("flows", "compute") if k in rec}
        rows.append(dict(name=sp.name, hosts=sp.n_hosts, windows=sp.windows,
                         transport=sp.transport, events=rec["events"],
                         **timings, windows_per_s=rate, **extra))
        print(f"corpus {sp.name}: golden ok, CPU record equal, 0 launches; "
              f"{sp.windows} windows, drive {timings['drive_s']:.4f}s "
              f"({rate:.1f} windows/s), setup {timings['setup_s']:.4f}s"
              + (f", {rec['flows']['retransmits']} retransmits, "
                 f"{rec['flows']['rto_fired']} RTOs fired"
                 if "flows" in rec else "")
              + f" on {ident}")
    if len(rows) != 10:
        fail(f"ran {len(rows)} corpus entries, expected 10")
    sp = spec.load_scenario_file(str(CORPUS / "serve_burst_lossy.yaml"))
    prof = profile_scenario(torch, runner, sp)
    if any(pipeline.LAUNCHES.values()):
        fail(f"the profiled corpus run launched kernels {pipeline.LAUNCHES}")
    drive_ms = next(1e3 / r["windows_per_s"] for r in rows
                    if r["name"] == sp.name)
    prof["busy_share_of_drive"] = prof["device_busy_ms_per_window"] / drive_ms
    print(f"profile, {sp.name}: {prof['kernel_launches_per_window']:.1f} "
          f"device kernels a window, device busy "
          f"{prof['device_busy_ms_per_window']:.5f} ms a window over windows "
          f"{PROFILE_WINDOWS}-{2 * PROFILE_WINDOWS - 1}, "
          f"{prof['busy_share_of_drive']:.3f} of the drive's "
          f"{drive_ms:.4f} ms a window on {ident}")
    record["corpus"] = rows
    record["corpus_profile"] = prof


def check_metrics_paths(torch, bench, convert, pipeline, record):
    """Phase 10: the metrics plane on both kernel paths at full width.
    Returns the fused path's metrics-off digest."""
    from shadow_tpu_torch.telemetry.metrics import PlaneMetrics

    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP, warmup=False)
    out = {}
    for kernel, pair in (("pallas_fused", ("egress_rank", "route_place")),
                         ("pallas", ("egress_gate", "route_scatter"))):
        off = bench.run_phold(N_HOSTS, rounds=CHECK_ROUNDS, kernel=kernel,
                              **size)
        pipeline.reset_launches()
        on = bench.run_phold(N_HOSTS, rounds=CHECK_ROUNDS, kernel=kernel,
                             metrics=True, **size)
        launches = dict(pipeline.LAUNCHES)
        plain = bench.run_phold(N_HOSTS, rounds=CHECK_ROUNDS, kernel=kernel,
                                metrics=True, plain_kernels=True, **size)
        for name, count in launches.items():
            want = CHECK_ROUNDS if name in pair else 0
            if count != want:
                fail(f"metrics run, kernel={kernel!r}: {name} launched "
                     f"{count} times, expected {want}")
        d_off = convert.state_digest(off["state"])
        if convert.state_digest(on["state"]) != d_off:
            fail(f"kernel={kernel!r}: the metrics changed the state")
        for f in PlaneMetrics._fields:
            if not torch.equal(getattr(on["metrics"], f),
                               getattr(plain["metrics"], f)):
                fail(f"kernel={kernel!r}: metrics.{f} differs from the "
                     "plain versions' run")
        m = on["metrics"]
        out[kernel] = dict(digest=d_off, launches=launches,
                           windows=int(m.windows), events=int(m.events),
                           pkts_out=int(m.pkts_out.sum()),
                           drop_loss=int(m.drop_loss.sum()))
        print(f"metrics, kernel={kernel}: N={N_HOSTS} R={CHECK_ROUNDS}: state "
              f"equal to the metrics-off run, metrics equal to the plain "
              f"versions' ({out[kernel]['events']} events), launches "
              f"{launches}")
    record["metrics_paths"] = out
    return out["pallas_fused"]["digest"]


def check_xla_path(torch, bench, convert, pipeline, record, ident,
                   fused_digest):
    """Phase 11: the XLA step at full width, and its window profile beside
    the fused one."""
    pipeline.reset_launches()
    res = bench.run_phold(N_HOSTS, rounds=CHECK_ROUNDS, kernel="xla",
                          n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                          ingress_cap=INGRESS_CAP, warmup=False)
    if any(pipeline.LAUNCHES.values()):
        fail(f"kernel='xla' launched {pipeline.LAUNCHES}")
    if convert.state_digest(res["state"]) != fused_digest:
        fail("kernel='xla' at N=32768 ends in another state than the fused "
             "path")
    prof = {}
    for kernel in ("xla", "pallas_fused"):
        p = bench.profile_windows(N_HOSTS, CHECK_ROUNDS, n_nodes=N_NODES,
                                  egress_cap=EGRESS_CAP,
                                  ingress_cap=INGRESS_CAP, kernel=kernel)
        prof[kernel] = {k: p[k] for k in (
            "wall_ms_per_window", "device_busy_ms_per_window",
            "device_busy_share", "kernel_launches_per_window",
            "top_kernels")}
        print(f"profile, kernel={kernel}: N={N_HOSTS} CE={EGRESS_CAP} "
              f"CI={INGRESS_CAP}: {p['kernel_launches_per_window']:.1f} "
              f"device kernels a window, device busy "
              f"{p['device_busy_ms_per_window']:.5f} ms a window, wall "
              f"{p['wall_ms_per_window']:.4f} ms a window on {ident}")
    legacy = check_legacy_sorts(torch, convert, ident)
    record["xla_path"] = dict(digest=fused_digest, wall_s=res["wall_s"],
                              profile=prof, legacy_sorts=legacy)
    print(f"kernel=xla, N={N_HOSTS} R={CHECK_ROUNDS}: the fused path's state, "
          f"0 launches")


def check_legacy_sorts(torch, convert, ident) -> dict:
    """Phase 11 (b): PHOLD windows (the step, the respawn and its append)
    at the main path's width on "xla" with JAX's pre-diet variadic sorts
    (`packed_sort=False`), bitwise the packed sorts' run, window by
    window: the packed sorts' first full-width witness on the card."""
    from shadow_tpu_torch.tpu import plane
    from shadow_tpu_torch.tpu.profiling import build_world
    from shadow_tpu_torch.workloads.phold import respawn_batch

    world = build_world(N_HOSTS, n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                        ingress_cap=INGRESS_CAP, seed=0, warmup_windows=0)
    params, seed, window = world["params"], world["rng_root"], world["window"]
    digests, walls = {}, {}
    for packed in (True, False):
        st = world["state"]
        spawn = torch.full((N_HOSTS,), 10_000, dtype=torch.int32,
                           device=st.in_src.device)
        out, t = [], time.perf_counter()
        for r in range(LEGACY_WINDOWS):
            st, d, nxt = plane.window_step(
                st, params, seed, 0 if r == 0 else window, window,
                rr_enabled=False, kernel="xla", packed_sort=packed)
            mask, dst, nb, seq, ctrl = respawn_batch(d, spawn, r, N_HOSTS,
                                                     INGRESS_CAP)
            st = plane.ingest_rows(st, dst, nb, seq, seq, ctrl, mask,
                                   packed_sort=packed)
            spawn = spawn + mask.sum(dim=1, dtype=torch.int32)
            out.append((convert.state_digest(st),
                        int(d["mask"].sum(dtype=torch.int64)), int(nxt)))
        walls[packed] = time.perf_counter() - t
        digests[packed] = out
    if digests[False] != digests[True]:
        bad = next(i for i, (a, b) in enumerate(zip(digests[False],
                                                    digests[True])) if a != b)
        fail(f"11 (b): packed_sort=False differs from the packed sorts at "
             f"window {bad}")
    if sum(n for _d, n, _x in digests[True]) <= 0:
        fail("11 (b): the windows delivered nothing")
    print(f"11 (b) kernel=xla, N={N_HOSTS}, {LEGACY_WINDOWS} PHOLD windows "
          f"with packed_sort=False (JAX's variadic sorts): every window's "
          f"state, delivered count and next event equal the packed sorts' "
          f"({sum(n for _d, n, _x in digests[True])} delivered); wall "
          f"{walls[False]:.3f} s legacy, {walls[True]:.3f} s packed on "
          f"{ident}")
    return dict(windows=LEGACY_WINDOWS, digest=digests[True][-1][0],
                wall_s_legacy=walls[False], wall_s_packed=walls[True])


@contextlib.contextmanager
def shared_setups(runner):
    """While open, scenario runs share their host-side set-up: the
    runner's `compile_program` (it reads the spec but its `windows`) and
    its N x N numpy tables (`scenario_tables`: the spec's seed, hosts and
    loss) are computed once a key and handed out again, a deep copy of the
    program each time and the tables read-only (the device copies are
    made afresh each run). Phases 12-14 set up the 16384-host worlds 13
    times; the draws are the same numbers each time. A run that was handed
    a set-up computed before has its timings' `setup_s` renamed
    `setup_s_cached` (`setup_text`), so a set-up time is read only from a
    run that computed its own."""
    import copy

    programs, tables = {}, {}
    hits = [0]
    orig = (runner.compile_program, runner.scenario_tables,
            runner.run_scenario)

    def compile_program(spec):
        key = repr(dataclasses.replace(spec, windows=0))
        if key in programs:
            hits[0] += 1
        else:
            programs[key] = orig[0](spec)
        return copy.deepcopy(programs[key])

    def scenario_tables(spec):
        key = (spec.seed, spec.n_hosts, spec.loss_p)
        if key in tables:
            hits[0] += 1
        else:
            out = orig[1](spec)
            for a in out:
                a.flags.writeable = False
            tables[key] = out
        return tables[key]

    def run_scenario(*a, timings=None, **kw):
        before = hits[0]
        rec = orig[2](*a, timings=timings, **kw)
        if timings is not None and hits[0] != before:
            timings["setup_s_cached"] = timings.pop("setup_s")
        return rec

    (runner.compile_program, runner.scenario_tables,
     runner.run_scenario) = (compile_program, scenario_tables, run_scenario)
    try:
        yield
    finally:
        (runner.compile_program, runner.scenario_tables,
         runner.run_scenario) = orig


def setup_text(timings: dict) -> str:
    """A run's set-up seconds as printed: its own, or one computed before
    (`shared_setups`)."""
    if "setup_s" in timings:
        return f"setup {timings['setup_s']:.3f}s"
    return f"setup {timings['setup_s_cached']:.3f}s (shared, computed before)"


def check_wide_scenario(torch, record, ident):
    """Phase 12: onoff at 16384 hosts."""
    from shadow_tpu_torch.workloads import runner, spec

    sp = spec.parse_scenario(ONOFF_WIDE)
    torch.cuda.reset_peak_memory_stats()
    recs, runs = [], []
    for _ in range(2):
        timings = {}
        recs.append(runner.run_scenario(sp, timings=timings))
        runs.append(timings)
    peak = torch.cuda.max_memory_allocated()
    if recs[0] != recs[1]:
        fail("two card runs of onoff-16384 gave different records")
    if not recs[0]["all_done"]:
        fail(f"onoff-16384: {recs[0]['completed_hosts']} of "
             f"{recs[0]['participants']} hosts done")
    short = dataclasses.replace(sp, windows=ONOFF_CHECK_WINDOWS)
    card8 = runner.run_scenario(short)
    if card8 != witness("onoff"):
        fail(f"onoff-16384 after {ONOFF_CHECK_WINDOWS} windows: the card's "
             "record differs from the CPU's")
    rates = [sp.windows / t["drive_s"] for t in runs]
    record["onoff_wide"] = dict(
        hosts=sp.n_hosts, windows=sp.windows, runs=runs,
        windows_per_s=rates, events=recs[0]["events"],
        table_bytes=2 * sp.n_hosts * sp.n_hosts * 4,
        peak_device_bytes=peak, digest=recs[0]["canonical_digest"],
        check_digest=card8["canonical_digest"])
    print(f"onoff-16384: two card runs equal, all {recs[0]['participants']} "
          f"hosts done, {recs[0]['events']} events; first "
          f"{ONOFF_CHECK_WINDOWS} windows equal the CPU's; drive "
          f"{runs[0]['drive_s']:.3f}s, {runs[1]['drive_s']:.3f}s "
          f"({rates[0]:.2f}, {rates[1]:.2f} windows/s), "
          f"{setup_text(runs[0])}; peak device memory {peak} B on "
          f"{ident}")


def check_fleet(torch, pipeline, record, ident):
    """Phase 13: the lossy serving fleet at 16380 hosts."""
    from shadow_tpu_torch.workloads import runner, spec

    sp = spec.parse_scenario(SERVE_FLEET)
    torch.cuda.reset_peak_memory_stats()
    pipeline.reset_launches()
    timings = {}
    rec = runner.run_scenario(sp, timings=timings)
    peak = torch.cuda.max_memory_allocated()
    hc = rec["host_completion"]
    last = hc["max_ns"] // sp.window_ns - 1 if hc else None
    print(f"{sp.name}: {rec['completed_hosts']} of {rec['participants']} "
          f"hosts done in {sp.windows} windows (the last in window {last}); "
          f"flows {rec['flows']}; compute {rec['compute']}; slo "
          f"{json.dumps(rec['slo'])}")
    if not rec["all_done"]:
        fail(f"{sp.name}: {rec['participants'] - rec['completed_hosts']} "
             f"hosts unfinished after {sp.windows} windows")
    if rec["compute"]["overflow"] != 0:
        fail(f"{sp.name}: {rec['compute']['overflow']} requests refused by "
             "full service queues")
    if "targets" not in rec["slo"]:
        fail(f"{sp.name}: the record has no SLO targets")
    runs = []
    for _ in range(2):
        t = {}
        runs.append((runner.run_scenario(dataclasses.replace(
            sp, windows=FLEET_REPEAT_WINDOWS), timings=t), t))
    if runs[0][0] != runs[1][0]:
        fail(f"two card runs of {sp.name}'s first {FLEET_REPEAT_WINDOWS} "
             "windows gave different records")
    short = dataclasses.replace(sp, windows=FLEET_CHECK_WINDOWS)
    if runner.run_scenario(short) != witness("fleet"):
        fail(f"{sp.name} after {FLEET_CHECK_WINDOWS} windows: the card's "
             "record differs from the CPU's")
    prof = profile_scenario(torch, runner, sp)
    if any(pipeline.LAUNCHES.values()):
        fail(f"the fleet runs launched kernels {pipeline.LAUNCHES}")
    rate = sp.windows / timings["drive_s"]
    prof["busy_share_of_drive"] = prof["device_busy_ms_per_window"] * rate / 1e3
    record["serve_fleet"] = dict(
        hosts=sp.n_hosts, windows=sp.windows, last_done_window=last,
        **timings, windows_per_s=rate, events=rec["events"],
        flows=rec["flows"], compute=rec["compute"], slo=rec["slo"],
        peak_device_bytes=peak, digest=rec["canonical_digest"],
        repeat=[dict(t, digest=r["canonical_digest"]) for r, t in runs],
        profile=prof)
    print(f"{sp.name}: all {rec['participants']} hosts done by window "
          f"{last} of {sp.windows}, no compute overflow, "
          f"{rec['flows']['retransmits']} retransmits, "
          f"{rec['flows']['rto_fired']} RTOs fired; two runs of "
          f"{FLEET_REPEAT_WINDOWS} windows equal, the first "
          f"{FLEET_CHECK_WINDOWS} windows equal the CPU's; "
          f"{setup_text(timings)}, drive {timings['drive_s']:.3f}s "
          f"({rate:.2f} windows/s); {FLEET_REPEAT_WINDOWS}-window drives "
          f"{runs[0][1]['drive_s']:.3f}s, {runs[1][1]['drive_s']:.3f}s; "
          f"peak device memory {peak} B; "
          f"{prof['kernel_launches_per_window']:.1f} device kernels and "
          f"{prof['device_busy_ms_per_window']:.5f} ms busy a window "
          f"({prof['busy_share_of_drive']:.3f} of the drive's "
          f"{1e3 / rate:.4f} ms a window) on {ident}")
    return rec


def check_robustness(torch, pipeline, record, ident):
    """Phase 14: faults, guards and the flight recorder on the card."""
    from shadow_tpu_torch.workloads import runner, spec

    rows = []
    corpus_rates = {r["name"]: r["windows_per_s"] for r in record["corpus"]}
    pipeline.reset_launches()
    for path in sorted(CORPUS.glob("*.yaml")):
        sp = spec.load_scenario_file(str(path))
        timings = {}
        rec = runner.run_scenario(sp, timings=timings, **ROBUST)
        if rec != witness(f"robust:{path.name}"):
            fail(f"{sp.name} with faults, guards and the recorder: the "
                 "card's record differs from the CPU's")
        if not rec["guards"]["clean"]:
            fail(f"{sp.name}: guard violations {rec['guards']}")
        if not rec["faults_active"] or "flight_recorder" not in rec:
            fail(f"{sp.name}: the fault plane or the recorder did not run")
        if sp.name in FAULT_DROP_ENTRIES and rec["drops"]["fault"] <= 0:
            fail(f"{sp.name}: no packet dropped to a fault, where the JAX "
                 "run drops some")
        rate = sp.windows / timings["drive_s"]
        rows.append(dict(name=sp.name, windows=sp.windows, **timings,
                         windows_per_s=rate,
                         unfaulted_windows_per_s=corpus_rates[sp.name],
                         fault_drops=rec["drops"]["fault"],
                         checks=rec["guards"]["checks_evaluated"],
                         hops=rec["flight_recorder"]["recorded_hops"]))
        print(f"robust {sp.name}: CPU record equal, guards clean "
              f"({rec['guards']['checks_evaluated']} checks), "
              f"{rec['drops']['fault']} fault drops, "
              f"{rec['flight_recorder']['recorded_hops']} hops; drive "
              f"{timings['drive_s']:.4f}s ({rate:.1f} windows/s; phase 9 "
              f"{corpus_rates[sp.name]:.1f}) on {ident}")
    if len(rows) != 10:
        fail(f"ran {len(rows)} corpus entries, expected 10")

    sp = spec.parse_scenario(SERVE_FLEET)
    fleet_kw = dict(ROBUST, sample_every=FLEET_SAMPLE_EVERY)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    rec = runner.run_scenario(sp, timings=timings, **fleet_kw)
    peak = torch.cuda.max_memory_allocated()
    hc = rec["host_completion"]
    last = hc["max_ns"] // sp.window_ns - 1 if hc else None
    fr = rec["flight_recorder"]
    print(f"{sp.name} faulted: {rec['completed_hosts']} of "
          f"{rec['participants']} hosts done in {sp.windows} windows (the "
          f"last in window {last}); drops {rec['drops']}; guards "
          f"{json.dumps(rec['guards'])}; recorder {fr}; flows "
          f"{rec['flows']}; compute {rec['compute']}")
    if not rec["guards"]["clean"]:
        fail(f"{sp.name}: guard violations under faults")
    # all_done is not required: a crashed client may still be in RTO
    # backoff when the budget ends
    if not rec["faults_active"]:
        fail(f"{sp.name}: the fault plane did not run")
    # the default schedule's crash and corruption start at window 176,
    # after the two hosts they target have finished (the first card run:
    # 0 fault drops, retransmits and RTOs as phase 13's); the 8-window
    # check below, whose schedule lands in the opening burst, is where
    # the plane must drop packets
    unfaulted_equal = rec["canonical_digest"] == \
        record["serve_fleet"]["digest"]
    if fr["overwritten"] != 0 or fr["recorded_hops"] <= 0:
        fail(f"{sp.name}: the recorder overwrote {fr['overwritten']} and "
             f"kept {fr['recorded_hops']} hops at sample_every="
             f"{FLEET_SAMPLE_EVERY}")
    runs = []
    for _ in range(2):
        t = {}
        runs.append((runner.run_scenario(dataclasses.replace(
            sp, windows=FLEET_REPEAT_WINDOWS), timings=t, **fleet_kw), t))
    if runs[0][0] != runs[1][0]:
        fail(f"two faulted card runs of {sp.name}'s first "
             f"{FLEET_REPEAT_WINDOWS} windows gave different records")
    short = dataclasses.replace(sp, windows=FLEET_CHECK_WINDOWS)
    card8 = runner.run_scenario(short, **fleet_kw)
    if card8 != witness("fleet-robust"):
        fail(f"{sp.name} faulted, first {FLEET_CHECK_WINDOWS} windows: the "
             "card's record differs from the CPU's")
    if card8["drops"]["fault"] <= 0:
        fail(f"{sp.name}: no fault drop in the {FLEET_CHECK_WINDOWS}-window "
             "check")
    prof = profile_scenario(torch, runner, sp, **fleet_kw)
    if any(pipeline.LAUNCHES.values()):
        fail(f"the phase 14 runs launched kernels {pipeline.LAUNCHES}")
    rate = sp.windows / timings["drive_s"]
    prof["busy_share_of_drive"] = prof["device_busy_ms_per_window"] * rate / 1e3

    from shadow_tpu_torch.faults.plane import neutral_faults
    from shadow_tpu_torch.guards.plane import make_guards
    from shadow_tpu_torch.telemetry.flightrec import make_flightrec
    from shadow_tpu_torch.tpu import plane

    n = 64
    params = plane.make_params(np.full((n, n), MS, np.int32),
                               np.zeros((n, n), np.float32),
                               np.full(n, 10**9), device="cuda")
    st = plane.make_state(n, 16, 32, params=params, device="cuda")
    refused = []
    for kernel in ("pallas_fused", "pallas"):
        for name, value in (("faults", neutral_faults(n)),
                            ("guards", make_guards(n)),
                            ("flightrec", make_flightrec(0))):
            try:
                plane.window_step(st, params, 0, 0, MS, rr_enabled=False,
                                  kernel=kernel, **{name: value})
            except ValueError:
                refused.append(f"{kernel}:{name}")
            else:
                fail(f"window_step(kernel={kernel!r}) took {name}= on CUDA "
                     "tensors")
    record["robust"] = dict(
        corpus=rows,
        fleet=dict(hosts=sp.n_hosts, windows=sp.windows,
                   last_done_window=last, unfaulted_equal=unfaulted_equal,
                   completed_hosts=rec["completed_hosts"], **timings,
                   windows_per_s=rate, drops=rec["drops"],
                   guards=rec["guards"], flight_recorder=fr,
                   flows=rec["flows"], compute=rec["compute"],
                   peak_device_bytes=peak, digest=rec["canonical_digest"],
                   repeat=[dict(t, digest=r["canonical_digest"])
                           for r, t in runs],
                   check_digest=card8["canonical_digest"],
                   check_fault_drops=card8["drops"]["fault"], profile=prof),
        refused=refused)
    print(f"{sp.name} faulted: guards clean ({rec['guards']['checks_evaluated']}"
          f" checks), {rec['drops']['fault']} fault drops (canonical digest "
          f"{'equal to' if unfaulted_equal else 'not'} phase 13's), "
          f"{rec['completed_hosts']} of {rec['participants']} hosts done, "
          f"the last in window {last}; "
          f"two runs of {FLEET_REPEAT_WINDOWS} windows equal, the first "
          f"{FLEET_CHECK_WINDOWS} windows equal the CPU's with "
          f"{card8['drops']['fault']} fault drops; "
          f"{setup_text(timings)}, drive {timings['drive_s']:.3f}s "
          f"({rate:.2f} windows/s); {FLEET_REPEAT_WINDOWS}-window drives "
          f"{runs[0][1]['drive_s']:.3f}s, {runs[1][1]['drive_s']:.3f}s; "
          f"peak device memory {peak} B; {fr['recorded_hops']} hops "
          f"recorded, {fr['overwritten']} overwritten at sample_every="
          f"{FLEET_SAMPLE_EVERY}; {prof['kernel_launches_per_window']:.1f} "
          f"device kernels and {prof['device_busy_ms_per_window']:.5f} ms "
          f"busy a window ({prof['busy_share_of_drive']:.3f} of the drive's "
          f"{1e3 / rate:.4f} ms a window) on {ident}")
    print(f"refusals on CUDA tensors: {', '.join(refused)} raise ValueError")


def aqm_world(device):
    from shadow_tpu_torch.tpu import profiling

    return profiling.build_world(
        N_HOSTS, n_nodes=N_NODES, egress_cap=EGRESS_CAP,
        ingress_cap=INGRESS_CAP, warmup_windows=0, down_bw_bps=AQM_DOWN_BPS,
        seed_packets=AQM_SEED_PACKETS, device=device)


def aqm_windows(torch, world, kernel, rounds, *, state=None, first_shift=0,
                plain=False, planes=None, keep=()):
    """`rounds` windows of `window_step(router_aqm=True)`. Returns (end
    state, per-window delivered counts, per-window cached packets at the
    window's end, planes', {window: state after it} for `keep`), read
    from the card once, after the last window."""
    from shadow_tpu_torch.tpu import plane

    st = world["state"] if state is None else state
    planes = dict(planes or {})  # in window_step's output order
    counts, cached, kept = [], [], {}
    for r in range(rounds):
        out = plane.window_step(
            st, world["params"], world["rng_root"],
            first_shift if r == 0 else world["window"], world["window"],
            rr_enabled=False, router_aqm=True, kernel=kernel,
            plain_kernels=plain, **planes)
        st, d = out[0], out[1]
        planes = dict(zip(planes, out[3:]))
        counts.append(d["mask"].sum(dtype=torch.int32))
        cached.append(st.router.has_cached.sum(dtype=torch.int32))
        if r + 1 in keep:
            kept[r + 1] = st
    return (st, torch.stack(counts).tolist(), torch.stack(cached).tolist(),
            planes, kept)


def drain_bytes(args, outs, *, prefix: bool = False) -> int:
    """What kernel E must move: its inputs (the rows, the rates and caps,
    the control-law table, the 13 state fields it reads) read once and
    its outputs written once. With `prefix`, of each row only what this
    window's data needs: its entries that arrive before the window ends
    and the one after them (a wide row is mostly padding no machine
    reads)."""
    arrival, size, window_ns, rate, cap, st = args
    from shadow_tpu_torch.tpu import codel

    fields = [getattr(st, f) for f in codel.DRAIN_FIELDS]
    out_fields = [getattr(outs[0], f) for f in codel.DRAIN_FIELDS]
    moved = nbytes([arrival, size, rate, cap, codel.CTRL_TABLE, *fields,
                    *out_fields, *outs[1:]])
    if prefix:
        n, k = arrival.shape
        read = ((arrival < window_ns).sum(dim=1) + 1).clamp(max=k)
        moved -= 2 * 4 * (n * k - int(read.sum()))
    return moved


def check_kernel_e(torch, codel, snapshot_args, record):
    """Phase 15 (a): kernel E against its plain version on the world's
    router rows and on random rows at K=32 and K=64; timed on the
    world's rows."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parity import drain_inputs

    from shadow_tpu_torch import convert

    cases = [(f"world window {AQM_SNAPSHOT}", snapshot_args)]
    for k in (32, 64):
        arrival, size, rate, cap, state = drain_inputs(N_HOSTS, k,
                                                       seed=200 + k)
        t = lambda a: torch.from_numpy(a).cuda()
        cases.append((f"random K={k}", (t(arrival), t(size), 10 * MS,
                                        t(rate), t(cap),
                                        convert.router_from_numpy(
                                            state, "cuda"))))
    flat = lambda out: [*(getattr(out[0], f)
                          for f in codel.RouterDownState._fields), *out[1:]]
    errs, steps = {}, None
    for what, args in cases:
        got = codel.router_drain(*args)
        # the plain version (`router_drain_plain` is its first six
        # outputs), with the micro-steps each host ran
        ref = codel._router_drain_loop(*args)
        # the device build, forced at a K the staged build takes
        dev = codel.router_drain(*args, _build="device")
        torch.cuda.synchronize()
        if steps is None:  # the world's rows
            steps = ref[6]
        err = max(max_abs_err(torch, flat(got), flat(ref[:6])),
                  max_abs_err(torch, flat(dev), flat(got)))
        if err != 0:
            fail(f"router_drain_kernel ({what}) disagrees with its plain "
                 f"version or its device build (max abs err {err})")
        errs[what] = err
    args = snapshot_args
    got = codel.router_drain(*args)
    status = got[1]
    drops = int((status == codel.STATUS_DROPPED).sum())
    taken = int((got[5] >= 0).sum())
    if drops <= 0 or taken <= 0:
        fail(f"kernel E's world rows (window {AQM_SNAPSHOT}) hold {drops} "
             f"CoDel drops and {taken} relay caches; both must occur")
    warm_ms, ms, clean_ms = time_device(torch, lambda: codel.router_drain(
        *args))
    dev_warm, dev_ms, dev_clean = time_device(
        torch, lambda: codel.router_drain(*args, _build="device"))
    _, plain_ms, _ = time_device(
        torch, lambda: codel.router_drain_plain(*args), reps=1)
    moved = drain_bytes(args, got)
    total_steps = int(steps.sum(dtype=torch.int64))
    ops = total_steps * E_OPS_PER_STEP
    bound_ms, bound_by = bound(moved, ops)
    # the timing's floor at this size, as for kernel C: a device copy
    # that reads and writes as many bytes
    src = torch.empty(moved // 8, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    copy_warm, copy_ms, copy_clean = time_device(torch,
                                                 lambda: dst.copy_(src))
    n, k = args[0].shape
    geo = codel.e_geometry(n, k)
    ptxas = check_ptxas(record, "router_drain", "kernel E router_drain",
                        "kernel_e_ptxas", "router_drain_kernel", [0, 1],
                        "kStaged")
    row = dict(n=n, k=k, cases=list(errs), max_abs_err=max(errs.values()),
               geometry=geo, ptxas=ptxas,
               ms=ms, warm_ms=warm_ms, cold_clean_ms=clean_ms,
               plain_ms=plain_ms, bytes=moved, ops=ops,
               micro_steps=total_steps, max_steps=int(steps.max()),
               trip_count=4 * k + 16, drops=drops, caches=taken,
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms, copy_ms=copy_ms,
               copy_clean_ms=copy_clean, copy_warm_ms=copy_warm,
               device_build=dict(ms=dev_ms, cold_clean_ms=dev_clean,
                                 warm_ms=dev_warm,
                                 geometry=codel.e_geometry(n, k, "device")))
    record["kernel_e"] = row
    print(f"kernel E router_drain N={n} K={k}: bitwise ok on {list(errs)} "
          f"(the world rows: {drops} CoDel drops, {taken} relay caches), "
          f"kernel_ms={ms:.5f} (cold L2; clean {clean_ms:.5f}; warm "
          f"{warm_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
          f"({bound_by}, {moved} B, {ops} int ops from {total_steps} "
          f"micro-steps at ~{E_OPS_PER_STEP}) share={bound_ms / ms:.3f}; "
          f"the longest thread runs {row['max_steps']} of "
          f"{row['trip_count']} micro-steps; library_ms=null; a copy of "
          f"{moved} B: {copy_ms:.5f} cold, {copy_clean:.5f} clean, "
          f"{copy_warm:.5f} warm; the launch: {geo['hosts_a_tile']} hosts a "
          f"tile, a block of one warp a tile, {geo['blocks']} blocks of "
          f"{geo['smem_bytes']} B shared ({geo['build']} build); the device "
          f"build forced on the same rows: bitwise, {dev_ms:.5f} ms cold "
          f"(clean {dev_clean:.5f}; warm {dev_warm:.5f})")
    return row


def aqm_wide_world(device):
    """The AQM world's traffic at AQM_WIDE_HOSTS hosts whose ingress
    rings hold AQM_WIDE_CI slots (15 (e))."""
    from shadow_tpu_torch.tpu import profiling

    return profiling.build_world(
        AQM_WIDE_HOSTS, n_nodes=N_NODES, egress_cap=EGRESS_CAP,
        ingress_cap=AQM_WIDE_CI, warmup_windows=0,
        down_bw_bps=AQM_DOWN_BPS, seed_packets=AQM_SEED_PACKETS,
        device=device)


def check_aqm_wide(torch, pipeline, ident) -> dict:
    """Phase 15 (e): the router AQM with rows of K = AQM_WIDE_CI entries
    (kernel E's device build): AQM_WIDE_WINDOWS windows on "xla" and on
    "pallas_fused", equal to each other, the first AQM_WIDE_CPU_WINDOWS
    equal to the CPU's; E's us a launch in the window beside its bound
    by bytes."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.tpu import codel

    world = aqm_wide_world("cuda")
    n, k = world["state"].in_src.shape
    build = codel.e_geometry(n, k)["build"]
    if build != "device":
        fail(f"15 (e): rows of K={k} run E's {build} build")
    runs = {}
    for kernel in ("xla", "pallas_fused"):
        pipeline.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, counts, cached, _p, kept = aqm_windows(
            torch, world, kernel, AQM_WIDE_WINDOWS,
            keep=(AQM_WIDE_CPU_WINDOWS,))
        torch.cuda.synchronize()
        runs[kernel] = dict(
            digest=convert.state_digest(st), counts=counts, cached=cached,
            check_digest=convert.state_digest(kept[AQM_WIDE_CPU_WINDOWS]),
            wall_s=time.perf_counter() - t,
            launches=dict(pipeline.LAUNCHES),
            device_build_launches=pipeline.E_BUILD_LAUNCHES["device"],
            drops=int(st.router.dropped.sum(dtype=torch.int64)),
            delivered=int(st.n_delivered.sum(dtype=torch.int64)))
        if dict(pipeline.E_BUILD_LAUNCHES) != {"staged": 0,
                                               "device": AQM_WIDE_WINDOWS}:
            fail(f"15 (e) kernel={kernel!r}: E's builds launched "
                 f"{pipeline.E_BUILD_LAUNCHES} for {AQM_WIDE_WINDOWS} "
                 "windows, expected all in the device build")
    x, f = runs["xla"], runs["pallas_fused"]
    if (x["digest"], x["counts"]) != (f["digest"], f["counts"]):
        fail("15 (e): 'xla' and 'pallas_fused' end in other states")
    if sum(x["counts"]) <= 0:
        fail("15 (e): nothing delivered")
    cpu = witness("aqm-wide")
    if cpu != x["check_digest"]:
        fail(f"15 (e): the first {AQM_WIDE_CPU_WINDOWS} windows on the card "
             "differ from the CPU's")
    # E's bound on these rows: the drain's bytes of one window's call
    caught = []
    real_drain = codel.router_drain

    def spy(*args, **kw):
        out = real_drain(*args, **kw)
        caught.append((args, out))
        return out

    codel.router_drain = spy
    try:
        aqm_windows(torch, world, "xla", 1)
    finally:
        codel.router_drain = real_drain
    moved = drain_bytes(*caught[0], prefix=True)
    bound_ms = moved / PEAK_BYTES_PER_S * 1e3
    prof = profile_aqm(torch, world, "pallas_fused",
                       windows=AQM_WIDE_WINDOWS)
    e_us = prof["router_drain_us_per_launch"]
    row = dict(hosts=n, k=k, runs=runs, cpu_windows=AQM_WIDE_CPU_WINDOWS,
               bytes=moved, bound_ms=bound_ms, e_us_per_launch=e_us,
               geometry=codel.e_geometry(n, k), profile=prof)
    print(f"15 (e) AQM with rows of K={k} (N={n}, CI={k}: "
          f"{n * k * 4} B an array): {AQM_WIDE_WINDOWS} windows on 'xla' "
          f"and 'pallas_fused' equal ({x['drops']} router drops, "
          f"{x['delivered']} delivered, at most {max(x['cached'])} cached), "
          f"the first {AQM_WIDE_CPU_WINDOWS} equal to the CPU's; E's device "
          f"build launched once a window ({row['geometry']}); in the window "
          f"{e_us} us a launch beside its bound {bound_ms * 1e3:.2f} us "
          f"(bytes, {moved} B: each row's entries before the window's end "
          f"read once, the outputs written once); walls "
          f"{x['wall_s']:.2f} s xla, {f['wall_s']:.2f} s fused; "
          f"{prof['kernel_launches_per_window']:.1f} device kernels and "
          f"{prof['device_busy_ms_per_window']:.5f} ms busy a window on "
          f"{ident}")
    return row


AQM_PATHS = (("pallas_fused", ("egress_rank", "route_place")),
             ("pallas", ("egress_gate", "route_scatter")),
             ("xla", ()))


def profile_aqm(torch, world, kernel, windows=PROFILE_WINDOWS):
    """Device kernels and busy ms a window over the first `windows` AQM
    windows (the traffic's busiest), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        aqm_windows(torch, world, kernel, windows)
        torch.cuda.synchronize()
    on_card, out = card_work(prof, windows)
    e_us = [ev.time_range.elapsed_us() for ev in on_card
            if "router_drain" in ev.name]
    out["router_drain_us_per_launch"] = sum(e_us) / len(e_us) if e_us \
        else None
    return out


# the tensor methods that read a tensor back to the host
HOST_READ_METHODS = ("tolist", "item", "cpu", "numpy", "__bool__", "__int__",
                     "__float__", "__index__")


def count_host_reads(torch, fn, *args, **kw):
    """Call `fn`, counting the calls it makes of HOST_READ_METHODS on
    tensors. Returns (its result, the count)."""
    count = [0]
    own = {m: m in vars(torch.Tensor) for m in HOST_READ_METHODS}
    real = {m: getattr(torch.Tensor, m) for m in HOST_READ_METHODS}

    def counted(method):
        def read(self, *a, **k):
            count[0] += 1
            return method(self, *a, **k)
        return read

    for m, method in real.items():
        setattr(torch.Tensor, m, counted(method))
    try:
        out = fn(*args, **kw)
    finally:
        for m, method in real.items():
            if own[m]:
                setattr(torch.Tensor, m, method)
            else:
                delattr(torch.Tensor, m)
    return out, count[0]


def drive_chains(torch, world, state, kernel, *, chained: bool,
                 first_shift: int = 0):
    """From `state`, windows to the end of the traffic with the chain's
    boundaries and AQM_CHAIN_NS windows: through `chain_windows`
    (`chained`), or one `window_step` at a time with the chain's rule
    applied on the host. Returns (end state, [(windows, off, next,
    delivered) a chain], the host reads counted inside `chain_windows`)."""
    from shadow_tpu_torch.tpu import plane

    win = AQM_CHAIN_NS
    horizon = (2**31 - 1) // 2
    kw = dict(rr_enabled=False, router_aqm=True, kernel=kernel)
    st, shift, chains, reads = state, first_shift, [], 0
    while True:
        if chained:
            (st, d, off, nxt, n), r = count_host_reads(
                torch, plane.chain_windows, st, world["params"],
                world["rng_root"], shift, win, win, horizon, horizon, **kw)
            reads += r
            off, nxt, n = int(off), int(nxt), int(n)
        else:
            st, d, nxt = plane.window_step(st, world["params"],
                                           world["rng_root"], shift, win,
                                           **kw)
            off, n = 0, 1
            while n < 64:
                if bool(d["mask"].any()) or int(nxt) >= horizon - off:
                    break
                off += int(nxt)
                st, d, nxt = plane.window_step(
                    st, world["params"], world["rng_root"], int(nxt),
                    min(win, horizon - off), **kw)
                n += 1
            nxt = int(nxt)
        chains.append((n, off, nxt, int(d["mask"].sum())))
        if nxt >= horizon or len(chains) > 1000:
            return st, chains, reads
        shift = nxt


def check_router_aqm(torch, pipeline, record, ident):
    """Phase 15: the router AQM at the bench's width."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.guards.plane import make_guards, summarize
    from shadow_tpu_torch.telemetry import flightrec
    from shadow_tpu_torch.telemetry.metrics import make_metrics
    from shadow_tpu_torch.tpu import codel, plane

    t0 = time.perf_counter()
    world = aqm_world("cuda")
    # (a) kernel E on the router's rows of window AQM_SNAPSHOT, caught on
    # their way into the drain
    st, *_ = aqm_windows(torch, world, "xla", AQM_SNAPSHOT - 1)
    caught = []
    real_drain = codel.router_drain

    def spy(*args, **kw):
        caught.append(args)
        return real_drain(*args, **kw)

    codel.router_drain = spy
    try:
        aqm_windows(torch, world, "xla", 1, state=st,
                    first_shift=world["window"])
    finally:
        codel.router_drain = real_drain
    e_row = check_kernel_e(torch, codel, caught[0], record)
    t_a = time.perf_counter() - t0

    # (b) the three kernel paths
    paths = {}
    for kernel, pair in AQM_PATHS:
        torch.cuda.synchronize()
        pipeline.reset_launches()
        t = time.perf_counter()
        st, counts, cached, _p, kept = aqm_windows(
            torch, world, kernel, AQM_ROUNDS,
            keep=(AQM_CHECK_WINDOWS, AQM_PLAIN_WINDOWS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(pipeline.LAUNCHES)
        for name, count in launches.items():
            want = AQM_ROUNDS if name in pair + ("router_drain",) else 0
            if count != want:
                fail(f"AQM run, kernel={kernel!r}: {name} launched {count} "
                     f"times, expected {want}")
        e_builds = dict(pipeline.E_BUILD_LAUNCHES)
        if e_builds != {"staged": AQM_ROUNDS, "device": 0}:
            fail(f"AQM run, kernel={kernel!r}: E's builds launched "
                 f"{e_builds}, expected all {AQM_ROUNDS} staged")
        plain_st, plain_counts, *_ = aqm_windows(torch, world, kernel,
                                                 AQM_PLAIN_WINDOWS, plain=True)
        if convert.state_digest(plain_st) != convert.state_digest(
                kept[AQM_PLAIN_WINDOWS]) or \
                plain_counts != counts[:AQM_PLAIN_WINDOWS]:
            fail(f"AQM run, kernel={kernel!r}: the kernels' run differs from "
                 "the plain versions' run")
        if any(counts[AQM_PLAIN_WINDOWS:]):
            fail(f"AQM run, kernel={kernel!r}: deliveries after window "
                 f"{AQM_PLAIN_WINDOWS}, which the plain run does not cover")
        digest = convert.state_digest(st)
        paths[kernel] = dict(
            digest=digest, counts=counts, cached=cached, launches=launches,
            e_builds=e_builds, wall_s=wall, windows_per_s=AQM_ROUNDS / wall,
            check_digest=convert.state_digest(kept[AQM_CHECK_WINDOWS]),
            end=st,
            drops=int(st.router.dropped.sum(dtype=torch.int64)),
            overflow=int(st.n_overflow_dropped.sum(dtype=torch.int64)),
            delivered=int(st.n_delivered.sum(dtype=torch.int64)),
            profile=profile_aqm(torch, world, kernel))
    ref = paths["pallas_fused"]
    for kernel, p in paths.items():
        if p["digest"] != ref["digest"] or p["counts"] != ref["counts"]:
            fail(f"AQM run: kernel={kernel!r} ends in another state or "
                 "delivers other counts than kernel='pallas_fused'")
    t = time.perf_counter()
    cpu_digest = witness("aqm")
    cpu_s = time.perf_counter() - t
    if cpu_digest != ref["check_digest"]:
        fail(f"AQM run: the first {AQM_CHECK_WINDOWS} windows on the card "
             "differ from the CPU's")
    if ref["drops"] <= 0 or max(ref["cached"]) <= 0:
        fail(f"AQM run: {ref['drops']} CoDel drops and at most "
             f"{max(ref['cached'])} cached packets at a window end; both "
             "must occur")
    for kernel, p in paths.items():
        prof = p["profile"]
        print(f"AQM, kernel={kernel}: N={N_HOSTS} R={AQM_ROUNDS}: the state "
              f"and delivered counts of every path and of the plain "
              f"versions' run; launches {p['launches']}; {p['drops']} router "
              f"drops, {sum(p['cached'])} packets cached at window ends (at "
              f"most {max(p['cached'])} at one), {p['overflow']} overflowed, "
              f"{p['delivered']} delivered; {p['windows_per_s']:.2f} "
              f"windows/s; {prof['kernel_launches_per_window']:.1f} device "
              f"kernels and {prof['device_busy_ms_per_window']:.5f} ms busy a "
              f"window over the first {prof['windows']} (kernel E "
              f"{prof['router_drain_us_per_launch']} us a launch) on {ident}")
    print(f"AQM: the first {AQM_CHECK_WINDOWS} windows equal the CPU's "
          f"({cpu_s:.1f}s awaiting the CPU's witness)")
    t_b = time.perf_counter() - t0 - t_a

    # (c) the observability planes on "xla"
    planes = dict(metrics=make_metrics(N_HOSTS, device="cuda"),
                  guards=make_guards(N_HOSTS, device="cuda"),
                  flightrec=flightrec.make_flightrec(
                      0, sample_every=64, ring=AQM_RING, device="cuda"))
    st, counts, _c, planes, _k = aqm_windows(torch, world, "xla", AQM_ROUNDS,
                                             planes=planes)
    guards = summarize(planes["guards"])
    qdisc = int(planes["metrics"].drop_qdisc.sum(dtype=torch.int64))
    fr = planes["flightrec"]
    hops = int(fr.cursor)
    aqm_hops = int((fr.ev_kind[:min(hops, AQM_RING)]
                    == flightrec.HOP_DROP_AQM).sum())
    if not guards["clean"]:
        fail(f"AQM run with guards: violations {guards}")
    if qdisc != ref["drops"]:
        fail(f"AQM run: metrics.drop_qdisc sums to {qdisc}, the router "
             f"dropped {ref['drops']}")
    if convert.state_digest(st) != ref["digest"] or counts != ref["counts"]:
        fail("AQM run: metrics, guards and the recorder changed the state")
    if hops > AQM_RING or aqm_hops <= 0:
        fail(f"AQM run: {hops} hops for a ring of {AQM_RING}, {aqm_hops} "
             "AQM drops among them")
    print(f"AQM, kernel=xla with metrics, guards and the recorder: guards "
          f"clean ({guards['checks_evaluated']} checks), drop_qdisc {qdisc} "
          f"= the router's drops, the state of (b), {hops} hops recorded, "
          f"{aqm_hops} of them drop_aqm")
    t_c = time.perf_counter() - t0 - t_a - t_b

    # (d) chain_windows against the single-window loop: after the traffic
    # has drained a chain is one window with nothing to do, so the chains
    # run from the world's start to the end of the traffic, in 1 ms
    # windows (the first chain, whose first window nothing reaches, and
    # some later ones advance more than one window); then one chain from
    # (b)'s drained end state
    chains = {}
    for kernel, _pair in AQM_PATHS:
        st_c, got, reads = drive_chains(torch, world, world["state"],
                                        kernel, chained=True)
        st_w, want, _ = drive_chains(torch, world, world["state"], kernel,
                                     chained=False)
        if got != want or convert.state_digest(st_c) != \
                convert.state_digest(st_w):
            fail(f"chain_windows, kernel={kernel!r}: differs from the "
                 "single-window loop with the same boundaries")
        _st, tail, _ = drive_chains(torch, world, paths[kernel]["end"],
                                    kernel, chained=True,
                                    first_shift=world["window"])
        if [c[:3] for c in tail] != [(1, 0, 2**31 - 1)]:
            fail(f"chain_windows, kernel={kernel!r}, after the traffic: "
                 f"{tail}, not one idle window")
        lengths = [c[0] for c in got]
        # one host read a chained window, but for a chain cut at 64
        expected = sum(n if n < 64 else n - 1 for n in lengths)
        if reads != expected:
            fail(f"chain_windows, kernel={kernel!r}: {reads} host reads "
                 f"counted over {sum(lengths)} windows in {len(got)} chains, "
                 f"expected {expected} (one a chained window)")
        chains[kernel] = dict(chains=len(got), windows=sum(lengths),
                              max_windows_per_chain=max(lengths),
                              multi_window_chains=sum(n > 1 for n in lengths),
                              host_reads=reads, digest=convert.state_digest(
                                  st_c))
        print(f"chain_windows, kernel={kernel}: {len(got)} chains of "
              f"{AQM_CHAIN_NS} ns windows to the end of the traffic, "
              f"{sum(lengths)} windows (max {max(lengths)} a chain, "
              f"{chains[kernel]['multi_window_chains']} chains of more than "
              f"one), {reads} host reads counted (one a chained window); "
              f"equal to the single-window loop; "
              f"from the drained state one idle window")
    if max(c["max_windows_per_chain"] for c in chains.values()) < 2:
        fail("chain_windows: no chain advanced more than one window")
    if len({c["digest"] for c in chains.values()}) != 1:
        fail("chain_windows: the three kernels end in different states")
    paths_rec = {k: {f: v for f, v in p.items() if f != "end"}
                 for k, p in paths.items()}
    fused_e = paths["pallas_fused"]["launches"]["router_drain"]
    fused_e_builds = paths["pallas_fused"]["e_builds"]
    t_d = time.perf_counter() - t0 - t_a - t_b - t_c
    del world, paths
    wide = check_aqm_wide(torch, pipeline, ident)
    t_e = time.perf_counter() - t0 - t_a - t_b - t_c - t_d
    record["router_aqm"] = dict(
        paths=paths_rec, cpu_check_s=cpu_s,
        planes=dict(guards_clean=guards["clean"],
                    checks=guards["checks_evaluated"], drop_qdisc=qdisc,
                    hops=hops, aqm_hops=aqm_hops),
        chains=chains, wide=wide,
        seconds=dict(a=t_a, b=t_b, c=t_c, d=t_d, e=t_e))
    print(f"AQM phase seconds: (a) {t_a:.1f}, (b) {t_b:.1f}, (c) {t_c:.1f}, "
          f"(d) {t_d:.1f}, (e) {t_e:.1f}")
    return e_row, fused_e, fused_e_builds, wide


# phase 16: the run infrastructure
P16_HARVEST = 32  # windows between harvests (the chain length)
P16_ROUNDS = 64  # (a)'s windows: two harvests
P16_MEMO_WINDOWS = 1024  # (d)'s memo rep (the bench's default is 4096)
P16_CKPT_EVERY = 32
P16_KILL = 96
P16_ENTRIES = (("ring_allreduce.yaml", ("--check",)),
               ("serve_burst_lossy.yaml", ("--faults", "--guards")))
P16_KILL_ENTRY = 16
FLEET_CKPT_EVERY = 128
FLEET_KILL = 256
CHAOS_KILL = 24
CHILD_TIMEOUT_S = 600
# the children's device ("cpu" in a CPU rehearsal of the phase)
CHILD_DEVICE = "cuda"


def profile_phold(torch, bench, kernel, **kw):
    """Device kernels and busy ms a window of PHOLD windows [P16_HARVEST,
    2 * P16_HARVEST) at the main path's width, in chains of P16_HARVEST
    (`kw` goes to `run_phold`: telemetry, hist, trace). The world's
    build, its upload and the first chain come before the profiler
    starts, and the harvester's final drain and trace write after it
    stops; with the harvester on, the profiled windows hold one
    harvest."""
    return profile_chains(
        torch, lambda on_chain: bench.run_phold(
            N_HOSTS, rounds=2 * P16_HARVEST, chain_len=P16_HARVEST,
            warmup=False, kernel=kernel, n_nodes=N_NODES,
            egress_cap=EGRESS_CAP, ingress_cap=INGRESS_CAP,
            on_chain=on_chain, **kw),
        P16_HARVEST, 2 * P16_HARVEST)


def check_phold_telemetry(torch, bench, convert, pipeline, tmp, ident,
                          between=None):
    """16 (a): PHOLD at full width through each kernel pair with the
    harvester every P16_HARVEST windows and the run ledger, and through
    "xla" with the histograms too, each against the same run without
    them; `between()`, given, is called after each kernel."""
    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP, warmup=False)
    out = {}
    for kernel, pair, hist in (
            ("pallas_fused", ("egress_rank", "route_place"), False),
            ("pallas", ("egress_gate", "route_scatter"), False),
            ("xla", (), True)):
        tdir = str(Path(tmp) / f"tel-{kernel}")
        tel = dict(telemetry=tdir, hist=hist, harvest_every=P16_HARVEST,
                   trace=str(Path(tmp) / f"{kernel}.ledger.jsonl"))
        off = bench.run_phold(N_HOSTS, rounds=P16_ROUNDS, kernel=kernel,
                              chain_len=P16_HARVEST, **size)
        pipeline.reset_launches()
        on = bench.run_phold(N_HOSTS, rounds=P16_ROUNDS, kernel=kernel,
                             **tel, **size)
        launches = dict(pipeline.LAUNCHES)
        for name, count in launches.items():
            want = P16_ROUNDS if name in pair else 0
            if count != want:
                fail(f"telemetry run, kernel={kernel!r}: {name} launched "
                     f"{count} times, expected {want}")
        d_off = convert.state_digest(off["state"])
        if convert.state_digest(on["state"]) != d_off or \
                on["delivered"] != off["delivered"]:
            fail(f"kernel={kernel!r}: the harvester, histograms or tracer "
                 "changed the run")
        t = on["telemetry"]
        want_harvests = P16_ROUNDS // P16_HARVEST
        if t["harvests"] != want_harvests or \
                t["heartbeats"] != want_harvests * (N_HOSTS + 1):
            fail(f"kernel={kernel!r}: {t['harvests']} harvests and "
                 f"{t['heartbeats']} heartbeat lines, expected "
                 f"{want_harvests} and {want_harvests * (N_HOSTS + 1)}")
        ledger = [json.loads(line) for line in open(tel["trace"])]
        spans = [r for r in ledger if r["kind"] == "span"]
        if len(spans) != want_harvests or ledger[-1]["kind"] != "end":
            fail(f"kernel={kernel!r}: the ledger holds {len(spans)} spans")
        prof_off = profile_phold(torch, bench, kernel)
        prof_on = profile_phold(torch, bench, kernel, **tel)
        out[kernel] = dict(
            digest=d_off, launches=launches, harvests=t["harvests"],
            heartbeats=t["heartbeats"], ledger_records=len(ledger),
            wall_s_off=off["wall_s"], wall_s_on=on["wall_s"],
            events_per_s_off=off["packet_events_per_sec"],
            events_per_s_on=on["packet_events_per_sec"],
            profile_off=prof_off, profile_on=prof_on,
            latency=t.get("latency"))
        print(f"16 (a) kernel={kernel}: N={N_HOSTS} R={P16_ROUNDS}, harvest "
              f"every {P16_HARVEST}{' + histograms' if hist else ''} + "
              f"ledger: state equal to the bare run's, launches "
              f"{launches}, {t['harvests']} harvests, {t['heartbeats']} "
              f"heartbeat lines, {len(ledger)} ledger records; "
              f"events/s {off['packet_events_per_sec']:.1f} bare vs "
              f"{on['packet_events_per_sec']:.1f}; a window "
              f"{prof_off['kernel_launches_per_window']:.1f} vs "
              f"{prof_on['kernel_launches_per_window']:.1f} device kernels, "
              f"{prof_off['device_busy_ms_per_window']:.5f} vs "
              f"{prof_on['device_busy_ms_per_window']:.5f} ms busy "
              f"(profile of windows {P16_HARVEST}-{2 * P16_HARVEST - 1}) on "
              f"{ident}")
        if between is not None:
            between()
    return out


def phold_checkpoint_child(directory: str, kill_at: int, resume: bool,
                           n_hosts: int = N_HOSTS, rounds: int = ROUNDS,
                           every: int = P16_CKPT_EVERY,
                           device: str = "cuda"):
    """16 (b), run in a child process: the fused PHOLD main path with a
    checkpoint every `every` windows, killed (exit 137) after the
    round-`kill_at` checkpoint (0: never), or resumed from the newest
    one. Prints one JSON line."""
    import torch

    from shadow_tpu_torch import bench, convert
    from shadow_tpu_torch.faults import runstate
    from shadow_tpu_torch.tpu import pipeline
    from shadow_tpu_torch.tpu.profiling import build_world

    world = build_world(n_hosts, n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                        ingress_cap=INGRESS_CAP, seed=0, warmup_windows=0,
                        device=device)
    ck = runstate.RunCheckpointer(directory, every=every, label="phold",
                                  kill_after=kill_at or None)
    latest = runstate.latest_checkpoint(directory, "phold") if resume \
        else None
    resumed_bytes = os.path.getsize(latest) if latest is not None else None
    t0 = time.perf_counter()
    if latest is not None:  # the resume's own cost: load, verify, upload
        runstate.resume_carry(latest, (world["state"], (
            torch.zeros(n_hosts, dtype=torch.int32, device=device), 0)))
        if device == "cuda":
            torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    pipeline.reset_launches()
    state, total = bench.run_chain(world, rounds, every,
                                   kernel="pallas_fused", checkpointer=ck,
                                   resume_from=latest)
    print(json.dumps({"digest": convert.state_digest(state),
                      "delivered": total, "launches": dict(pipeline.LAUNCHES),
                      "resumed_from": latest, "resumed_bytes": resumed_bytes,
                      "resume_ms": resume_ms,
                      "save_ms": ck.save_ms, "saved": ck.saved}))


def start_child(code_or_args, cwd: Path, log: Path):
    """A child process of this interpreter (`python -c CODE` or `python
    ARGS...`) from the repository root, its output to `log`."""
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str)
            else [sys.executable, *code_or_args])
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    fh = open(log, "w")
    return subprocess.Popen(args, cwd=cwd, env=env, stdout=fh,
                            stderr=subprocess.STDOUT, text=True), fh


def wait_children(children: dict) -> dict:
    """Wait for every child; {name: (exit code, output)}; kills what
    outlives CHILD_TIMEOUT_S."""
    out = {}
    for name, (proc, fh, log) in children.items():
        try:
            rc = proc.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        fh.close()
        out[name] = (rc, Path(log).read_text())
    return out


def kill_children(children: dict):
    """Kill what is left of `children` (a failed check's way out)."""
    for proc, fh, _log in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fh.close()


def last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def heartbeats_after(path: Path, after_ns: int):
    """A heartbeat file's lines after `after_ns`, their sim lines without
    the annotations, and the file's whole set of annotations. A resumed
    harvester's lines equal the uninterrupted run's after the kill; the
    annotations the killed run's undrained snapshot would have carried
    ride its first line instead, so they are compared as a set."""
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    notes = sorted(json.dumps(a, sort_keys=True) for r in recs
                   for a in r.get("annotations", ()))
    lines = [{k: v for k, v in r.items() if k != "annotations"}
             for r in recs if r["time_ns"] > after_ns]
    return lines, notes


def run_infra_beside_children(torch, bench, convert, pipeline, ident, tmp,
                              root, rec, children, t_w1, wave1, entries,
                              dev, c_args, child_b):
    """Phase 16's work in this process while its child processes run:
    (d)'s memo rep, (c)'s uninterrupted runs, (a) and (b)'s uninterrupted
    run, beside the killed wave and then the resumed wave, which starts
    as soon as the killed wave has ended (looked at between (a)'s
    kernels; `children` holds the running wave). Returns both waves'
    results, (b)'s digest and delivered total."""
    from shadow_tpu_torch.workloads import run_scenarios

    waves = {}

    def start_wave2(block: bool):
        """Collect the killed wave and start the resumed one, if the
        killed wave has ended (or, with `block`, once it has)."""
        if "done1" in waves or not block and any(
                proc.poll() is None for proc, _fh, _l in children.values()):
            return
        t = time.perf_counter()
        done1 = wait_children(children)
        rec["seconds_wait_wave1"] = time.perf_counter() - t
        rec["seconds_wave1"] = time.perf_counter() - t_w1
        for name, (rc, text) in done1.items():
            want = 0 if name.endswith("-full") or name == "d-corpus" else 137
            if rc != want:
                fail(f"16 child {name}: exit {rc}, expected {want}:\n"
                     f"{text[-3000:]}")
        waves["done1"], waves["t_w2"] = done1, time.perf_counter()
        wave2 = {"b": child_b.format(0, True)}
        for name in entries:
            wave2[name] = c_args(name, ["--resume"])
        for tag in ("e", "e-memo"):
            wave2[f"{tag}-resumed"] = wave1[f"{tag}-killed"][:-2] + [
                "--resume", str(tmp / f"{tag}.ck" / f"ckpt-{CHAOS_KILL:012d}")]
        children.clear()
        children.update({n: (*start_child(a, root, tmp / f"{n}.2.log"),
                             tmp / f"{n}.2.log") for n, a in wave2.items()})

    # (d) the memo rep, beside the children
    t = time.perf_counter()
    memo = bench.run_memo(windows=P16_MEMO_WINDOWS)
    if not memo["digest_parity"] or memo["memo"]["hits"] == 0:
        fail(f"memo rep: parity {memo['digest_parity']}, hits "
             f"{memo['memo']['hits']}")
    rec["memo_rep"] = memo
    rec["seconds_d_rep"] = time.perf_counter() - t
    print(f"16 (d) memo rep: ring allreduce, {memo['hosts']} hosts, "
          f"{memo['windows']} windows in chains of {memo['chain_len']}: "
          f"{memo['memo']['hits']} hits, {memo['memo']['misses']} "
          f"misses, {memo['memo']['fast_forwarded_windows']} windows "
          f"fast-forwarded, parity true; cold "
          f"{memo['windows_per_s_cold']:.1f} windows/s "
          f"({memo['cold_s']:.3f}s), memoized "
          f"{memo['windows_per_s_memo']:.1f} ({memo['memo_s']:.3f}s), "
          f"x{memo['speedup']:.2f} (beside the children) on {ident}")

    # the uninterrupted runs of (c)'s two entries
    t = time.perf_counter()
    for name, (args, _kill, _every) in entries.items():
        if name == "c-fleet":
            continue
        if run_scenarios.main(args + dev + [
                "-o", str(tmp / f"{name}.full.json"), "--telemetry",
                str(tmp / f"{name}.tf")]) != 0:
            fail(f"16 (c) {name}: the uninterrupted run failed")
    rec["seconds_c_full"] = time.perf_counter() - t

    t = time.perf_counter()
    rec["phold_telemetry"] = check_phold_telemetry(
        torch, bench, convert, pipeline, tmp, ident,
        between=lambda: start_wave2(block=False))
    rec["seconds_a"] = time.perf_counter() - t

    # (b)'s uninterrupted run
    t = time.perf_counter()
    from shadow_tpu_torch.tpu.profiling import build_world
    world = build_world(N_HOSTS, n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                        ingress_cap=INGRESS_CAP, seed=0, warmup_windows=0)
    ref_state, ref_total = bench.run_chain(world, ROUNDS, P16_CKPT_EVERY,
                                           kernel="pallas_fused")
    ref_digest = convert.state_digest(ref_state)
    rec["seconds_b_full"] = time.perf_counter() - t
    start_wave2(block=True)
    t = time.perf_counter()
    done2 = wait_children(children)
    rec["seconds_wait_wave2"] = time.perf_counter() - t
    rec["seconds_wave2"] = time.perf_counter() - waves["t_w2"]
    for name, (rc, text) in done2.items():
        if rc != 0:
            fail(f"16 child {name} (resumed): exit {rc}:\n"
                 f"{text[-3000:]}")
    print(f"16 seconds: (d) memo rep {rec['seconds_d_rep']:.1f}, (c)'s "
          f"uninterrupted runs {rec['seconds_c_full']:.1f}, (a) "
          f"{rec['seconds_a']:.1f}, (b)'s uninterrupted run "
          f"{rec['seconds_b_full']:.1f}, one after another here; beside "
          f"them the killed wave of children "
          f"{rec['seconds_wave1']:.1f} from the phase's start (waited "
          f"{rec['seconds_wait_wave1']:.1f} at its end), then the resumed "
          f"wave {rec['seconds_wave2']:.1f} (waited "
          f"{rec['seconds_wait_wave2']:.1f} at its end)")
    return waves["done1"], done2, ref_digest, ref_total


def check_run_infra(torch, bench, convert, pipeline, record, ident,
                    fleet_record):
    """Phase 16: the run infrastructure on the card."""
    from shadow_tpu_torch.workloads import spec

    root = Path(__file__).resolve().parent
    rec = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        # (b), (c), (e) and the corpus under --memo in child processes:
        # the killed runs (and the chaos smoke's uninterrupted ones) at
        # once from the phase's start, beside (a), (d)'s memo rep and
        # (c)'s uninterrupted runs here; then the resumed runs at once,
        # beside (b)'s uninterrupted run here
        t_w1 = time.perf_counter()
        fleet_yaml = tmp / "serve_fleet.yaml"
        fleet_yaml.write_text(json.dumps(SERVE_FLEET))
        dev = ["--device", CHILD_DEVICE]
        rs = ["-m", "shadow_tpu_torch.workloads.run_scenarios", *dev]
        cs = ["-m", "shadow_tpu_torch.tools.chaos_smoke", *dev]
        entries = {f"c-{Path(p).stem}": ([str(CORPUS / p), *flags],
                                         P16_KILL_ENTRY, 16)
                   for p, flags in P16_ENTRIES}
        entries["c-fleet"] = ([str(fleet_yaml)], FLEET_KILL,
                              FLEET_CKPT_EVERY)
        child_b = (f"import chip_smoke; chip_smoke.phold_checkpoint_child("
                   f"{str(tmp / 'b')!r}, {{}}, {{}}, {N_HOSTS}, {ROUNDS}, "
                   f"{P16_CKPT_EVERY}, {CHILD_DEVICE!r})")
        wave1 = {"b": child_b.format(P16_KILL, False)}

        def c_args(name, tail):
            args, _kill, every = entries[name]
            out = rs + args + ["-o", str(tmp / f"{name}.kr.json"),
                               "--checkpoint-dir", str(tmp / f"{name}.ck"),
                               "--checkpoint-every", str(every)]
            if name != "c-fleet":  # 16381 heartbeat lines a harvest there
                out += ["--telemetry", str(tmp / f"{name}.tk"),
                        "--trace", str(tmp / f"{name}.trk")]
            return out + tail

        for name, (_args, kill, _every) in entries.items():
            wave1[name] = c_args(name, ["--kill-at", str(kill)])
        for memo_flag in ((), ("--memo",)):
            tag = "e-memo" if memo_flag else "e"
            wave1[f"{tag}-full"] = cs + list(memo_flag)
            wave1[f"{tag}-killed"] = cs + list(memo_flag) + [
                "--checkpoint-dir", str(tmp / f"{tag}.ck"), "--kill-at",
                str(CHAOS_KILL)]
        wave1["d-corpus"] = rs + ["--memo", "--check"]
        children = {n: (*start_child(a, root, tmp / f"{n}.log"),
                        tmp / f"{n}.log") for n, a in wave1.items()}

        try:
            done1, done2, ref_digest, ref_total = run_infra_beside_children(
                torch, bench, convert, pipeline, ident, tmp, root, rec,
                children, t_w1, wave1, entries, dev, c_args, child_b)
        except BaseException:
            kill_children(children)
            raise

        # (b) the PHOLD checkpoint
        res = last_json(done2["b"][1])
        ckpt = Path(res["resumed_from"] or "")
        if res["digest"] != ref_digest or \
                res["delivered"] != ref_total or not ckpt.name.endswith(
                    f"r{P16_KILL:08d}.runstate.npz"):
            fail(f"16 (b): the resumed PHOLD run ({res}) differs from the "
                 "uninterrupted run")
        want_l = ROUNDS - P16_KILL
        if CHILD_DEVICE == "cuda" and (
                res["launches"]["egress_rank"] != want_l
                or res["launches"]["route_place"] != want_l):
            fail(f"16 (b): the resumed run launched {res['launches']}")
        ckpt_bytes = res["resumed_bytes"]
        rec["phold_checkpoint"] = dict(
            bytes=ckpt_bytes, resume_ms=res["resume_ms"],
            save_ms_resumed_run=res["save_ms"], digest=res["digest"])
        print(f"16 (b) PHOLD fused, checkpoint every {P16_CKPT_EVERY}, "
              f"killed at {P16_KILL} (exit 137), resumed from "
              f"{ckpt.name}: digest and delivered total equal the "
              f"uninterrupted run's, {want_l} launches of A and B after "
              f"the resume; a checkpoint {ckpt_bytes} B, saves "
              f"{[round(x, 3) for x in res['save_ms']]} ms, resume "
              f"{res['resume_ms']:.3f} ms on {ident}")

        # (c) run_scenarios killed and resumed
        for name, (args, kill, every) in entries.items():
            got = (tmp / f"{name}.kr.json").read_bytes()
            if name == "c-fleet":
                want_rec = json.loads(json.dumps(fleet_record))
                if json.loads(got)["records"] != [want_rec]:
                    fail("16 (c): the resumed fleet's record differs from "
                         "phase 13's")
            else:
                if got != (tmp / f"{name}.full.json").read_bytes():
                    fail(f"16 (c) {name}: the resumed output file differs "
                         "from the uninterrupted run's")
                stem = spec.load_scenario_file(args[0]).name
                after = kill * spec.load_scenario_file(args[0]).window_ns
                hb_full = heartbeats_after(
                    tmp / f"{name}.tf" / f"{stem}.jsonl", after)
                hb_res = heartbeats_after(
                    tmp / f"{name}.tk" / f"{stem}.jsonl", after)
                if not hb_full[0] or hb_full != hb_res:
                    fail(f"16 (c) {name}: the resumed heartbeats after "
                         f"window {kill} differ from the uninterrupted "
                         "run's")
            ck = sorted((tmp / f"{name}.ck").glob("*.runstate.npz"))
            rec[f"run_scenarios_{name}"] = dict(
                kill_at=kill, checkpoint_every=every,
                checkpoint_bytes=ck[-1].stat().st_size,
                resumed_log=done2[name][1].strip().splitlines()[-3:])
            what = ("the record equal to phase 13's" if name == "c-fleet"
                    else "the output file byte-identical, the heartbeats "
                    "after the kill and the phase annotations equal")
            print(f"16 (c) run_scenarios {Path(args[0]).name} "
                  f"{' '.join(args[1:])}: killed at {kill} (exit 137), "
                  f"resumed: {what}; a checkpoint "
                  f"{ck[-1].stat().st_size} B")

        # (d) the corpus under --memo --check
        corpus_log = done1["d-corpus"][1]
        if "match the golden digests" not in corpus_log:
            fail(f"16 (d): the memoized corpus did not match:\n{corpus_log}")
        rec["memo_corpus"] = [ln for ln in corpus_log.splitlines()
                              if "memo=" in ln]
        print("16 (d) corpus --memo --check: all ten entries match the "
              "golden digests (run beside the other children, so its "
              "windows/s are not a measurement):\n  " + "\n  ".join(
                  rec["memo_corpus"]))

        # (e) the chaos smoke
        for tag in ("e", "e-memo"):
            full = last_json(done1[f"{tag}-full"][1])
            res = last_json(done2[f"{tag}-resumed"][1])
            if res["state_digest"] != full["state_digest"] or \
                    res.get("memo") != full.get("memo"):
                fail(f"16 (e) {tag}: the resumed chaos smoke differs from "
                     "the uninterrupted one")
            rec[f"chaos_{tag}"] = dict(digest=full["state_digest"],
                                       drops=full["drops"],
                                       memo=full.get("memo"))
            print(f"16 (e) chaos smoke{' --memo' if tag == 'e-memo' else ''}"
                  f" (256 hosts, 48 windows): killed at {CHAOS_KILL}, "
                  f"resumed: digest {full['state_digest'][:16]}... equal; "
                  f"drops {full['drops']}")
    record["run_infra"] = rec


def ens_digests(convert, elastic, states, n_worlds):
    return [convert.state_digest(elastic.world_slice(states, w))
            for w in range(n_worlds)]


def solo_digests(torch, bench, convert, elastic, chain, world, keys,
                 rounds):
    """Each world's solo run: `drive_chained_windows` of `chain` from the
    world's state under its key, `rounds` windows in one chain."""
    out = []
    for w in range(keys.shape[0]):
        extras = (keys[w], torch.full((N_HOSTS,), bench.SPAWN_SEQ0,
                                      dtype=torch.int32, device=ENS_DEVICE),
                  torch.zeros((), dtype=torch.int32, device=ENS_DEVICE))
        st, _ex = elastic.drive_chained_windows(
            world["state"], extras, chain, n_rounds=rounds,
            chain_len=rounds)
        out.append(convert.state_digest(st))
    return out


def profile_ensemble(torch, bench, kernel):
    """Device kernels, busy ms and each port kernel's launches and us a
    window over windows ENS_CHAIN to 2 * ENS_CHAIN - 1 of an ensemble run
    and of a solo run (`profile_chains`)."""
    kw = dict(rounds=2 * ENS_CHAIN, chain_len=ENS_CHAIN, kernel=kernel,
              warmup=False, n_nodes=N_NODES, egress_cap=EGRESS_CAP,
              ingress_cap=INGRESS_CAP)
    ens = profile_chains(torch, lambda on_chain: bench.run_worlds(
        ENS_WORLDS, N_HOSTS, on_chain=on_chain, **kw), ENS_CHAIN,
        2 * ENS_CHAIN)
    solo = profile_chains(torch, lambda on_chain: bench.run_phold(
        N_HOSTS, on_chain=on_chain, **kw), ENS_CHAIN, 2 * ENS_CHAIN)
    return ens, solo


def print_profiles(what, ens, solo, wall_ms, ident):
    busy = ens["device_busy_ms_per_window"]
    print(f"17 {what}: an ensemble window "
          f"{ens['kernel_launches_per_window']:.1f} device kernels, "
          f"{busy:.5f} ms busy (busy share {busy / wall_ms:.3f} of its "
          f"{wall_ms:.4f} ms wall), a solo window "
          f"{solo['kernel_launches_per_window']:.1f}, "
          f"{solo['device_busy_ms_per_window']:.5f} ms; the port's kernels "
          f"in the ensemble window {json.dumps(ens['port_kernels'])}, in "
          f"the solo window {json.dumps(solo['port_kernels'])} on {ident}")


def ensemble_in_turns(torch, bench, pipeline, kernel, **kw):
    """The counted, timed ensemble run (`run_worlds` over ENS_WORLDS
    worlds, R=ROUNDS; `kw` its other keywords) between two solo runs of
    the same kernel (`run_phold`; the caller has warmed both up), so the
    host's
    drift within the call weighs on both alike. Returns the ensemble's
    record without its carry, with `amortization_vs_solo` against the
    two solo runs' mean events/s, both solo rates, the ensemble's
    launch counts and its peak device memory."""
    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP)
    solo = lambda: bench.run_phold(N_HOSTS, rounds=ROUNDS, kernel=kernel,
                                   warmup=False,
                                   **size)["packet_events_per_sec"]
    before = solo()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipeline.reset_launches()
    rec = bench.run_worlds(ENS_WORLDS, N_HOSTS, rounds=ROUNDS, kernel=kernel,
                           **size, **kw)
    launches = dict(pipeline.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    after = solo()
    out = {k: v for k, v in rec.items() if k not in ("states", "extras")}
    out.update(amortization_vs_solo=rec["events_per_sec_sum"]
               / ((before + after) / 2),
               solo_events_per_sec=[before, after], launches=launches,
               peak_bytes=peak,
               wall_ms_per_window=rec["wall_s"] * 1e3 / ROUNDS)
    return out


def check_ensemble_phold(torch, bench, convert, elastic, pipeline, kernel,
                         pair, ident):
    """17, PHOLD on one kernel (pair: the kernels its path launches): (a)
    each world equal to its solo run after ENS_SOLO_WINDOWS windows (an
    untimed run, which also warms the path up); (c) the counted, timed
    run between two solo runs; a profile of windows ENS_CHAIN to
    2 * ENS_CHAIN - 1 of the ensemble beside the solo run's."""
    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP)
    from shadow_tpu_torch.tpu.profiling import build_world

    first = bench.run_worlds(ENS_WORLDS, N_HOSTS, rounds=ENS_SOLO_WINDOWS,
                             kernel=kernel, warmup=False, **size)
    ens = ens_digests(convert, elastic, first.pop("states"), ENS_WORLDS)
    del first
    world = build_world(N_HOSTS, seed=0, warmup_windows=0, device=ENS_DEVICE,
                        **size)
    keys = elastic.world_keys(world["rng_root"], range(ENS_WORLDS),
                              device=ENS_DEVICE)
    chain = bench.phold_keyed_chain_fn(world, kernel=kernel)
    solo = solo_digests(torch, bench, convert, elastic, chain, world, keys,
                        ENS_SOLO_WINDOWS)
    if solo != ens:
        bad = [w for w in range(ENS_WORLDS) if solo[w] != ens[w]]
        fail(f"ensemble, kernel={kernel!r}: worlds {bad} differ from their "
             f"solo runs after {ENS_SOLO_WINDOWS} windows")
    if len(set(solo)) != ENS_WORLDS:
        fail(f"ensemble, kernel={kernel!r}: the worlds are not distinct")
    out = ensemble_in_turns(torch, bench, pipeline, kernel, warmup=False)
    launches = out["launches"]
    for name, count in launches.items():
        want = ROUNDS if name in pair else 0
        if count != want:
            fail(f"ensemble of {ENS_WORLDS}, kernel={kernel!r}: {name} "
                 f"launched {count} times, expected {want} (one a window "
                 f"for all worlds)")
    ens_prof, solo_prof = profile_ensemble(torch, bench, kernel)
    out.update(solo_digests_equal=ENS_SOLO_WINDOWS, profile=ens_prof,
               solo_profile=solo_prof)
    print(f"17 ensemble kernel={kernel}: {ENS_WORLDS} worlds x N={N_HOSTS} "
          f"R={ROUNDS}: each world equal to its solo run over "
          f"{ENS_SOLO_WINDOWS} windows; launches {launches} (one a window "
          f"for all worlds); worlds record "
          f"{json.dumps({k: out[k] for k in WORLDS_KEYS})} (solo runs "
          f"before and after: {out['solo_events_per_sec']} events/s); wall "
          f"{out['wall_ms_per_window']:.4f} ms a window; peak "
          f"{out['peak_bytes']} B on {ident}")
    print_profiles(f"kernel={kernel}", ens_prof, solo_prof,
                   out["wall_ms_per_window"], ident)
    return out


# the keys of the JAX bench's `worlds` record
WORLDS_KEYS = ("n_worlds", "driver", "chain_len", "events",
               "min_world_events", "events_per_sec_sum",
               "amortization_vs_solo")


def aqm_ensemble_chain(torch, world, kernel):
    """The AQM world's windows under a key riding the carry (no respawn,
    as phase 15's `aqm_windows`): extras = (key, delivered total)."""
    from shadow_tpu_torch.tpu import plane

    def chain_fn(state, extras, r0, r1):
        key, total = extras
        for r in range(r0, r1):
            state, d, _nx = plane.window_step(
                state, world["params"], key, 0 if r == 0 else world["window"],
                world["window"], rr_enabled=False, router_aqm=True,
                kernel=kernel)
            total = total + d["mask"].sum(dtype=torch.int32)
        zeros = torch.zeros(state.in_src.shape[0], dtype=torch.int32,
                            device=total.device)
        return state, (key, total), zeros, zeros
    return chain_fn


def check_ensemble_aqm(torch, convert, elastic, pipeline, kernel, pair):
    """17, the router AQM world's first AQM_PLAIN_WINDOWS windows as an
    ensemble on one kernel: launches of the pair and of kernel E once a
    window, each world equal to its solo run."""
    world = aqm_world(ENS_DEVICE)
    keys = elastic.world_keys(world["rng_root"], range(ENS_WORLDS),
                              device=ENS_DEVICE)
    chain = aqm_ensemble_chain(torch, world, kernel)
    zero = torch.zeros((), dtype=torch.int32, device=ENS_DEVICE)
    pipeline.reset_launches()
    t = time.perf_counter()
    states, extras = elastic.drive_ensemble(
        elastic.stack_worlds(world["state"], ENS_WORLDS),
        (keys, zero.repeat(ENS_WORLDS)), chain, n_rounds=AQM_PLAIN_WINDOWS,
        chain_len=AQM_PLAIN_WINDOWS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(pipeline.LAUNCHES)
    for name, count in launches.items():
        want = AQM_PLAIN_WINDOWS if name in pair + ("router_drain",) else 0
        if count != want:
            fail(f"AQM ensemble, kernel={kernel!r}: {name} launched {count} "
                 f"times, expected {want}")
    mine = ens_digests(convert, elastic, states, ENS_WORLDS)
    extras_total = extras[1].tolist()
    for w in range(ENS_WORLDS):
        st, _ex = elastic.drive_chained_windows(
            world["state"], (keys[w], zero), chain,
            n_rounds=AQM_PLAIN_WINDOWS, chain_len=AQM_PLAIN_WINDOWS)
        if convert.state_digest(st) != mine[w]:
            fail(f"AQM ensemble, kernel={kernel!r}: world {w} differs from "
                 "its solo run")
    drops = states.router.dropped.sum(dim=1).tolist()
    if min(drops) <= 0:
        fail(f"AQM ensemble, kernel={kernel!r}: a world without CoDel drops "
             f"({drops})")
    del states, extras
    start = AQM_PLAIN_WINDOWS // 3
    prof = profile_chains(torch, lambda on_chain: elastic.drive_ensemble(
        elastic.stack_worlds(world["state"], ENS_WORLDS),
        (keys, zero.repeat(ENS_WORLDS)), chain, n_rounds=AQM_PLAIN_WINDOWS,
        chain_len=start, on_chain=on_chain), start, AQM_PLAIN_WINDOWS)
    return dict(launches=launches, wall_s=wall, drops=drops,
                delivered=extras_total, profile=prof)


def batched_bound(torch, name, args, outs, work) -> tuple[float, str, int]:
    """The bound of one batched launch of kernel `name` over the W * N
    rows, counted as phases 3-5 and 15 count a solo launch's: A and C
    their inputs read and outputs written once, with their networks' int
    operations and shuffles; B and D `placement_bytes` of the calls timed
    on `work` (after the first call's rewrites) with their int
    operations; E its inputs and outputs once (`drain_bytes`). Returns
    (ms, what bounds it, bytes)."""
    if name in ("route_place", "route_scatter"):
        nv, offsets, take = (a.reshape(-1, 1).cpu().numpy()
                             for a in args[:3])
        rows, ci = work[9].shape[0] * work[9].shape[1], work[9].shape[2]
        ce = args[4].shape[-1]
        ccol = np.arange(ci)[None, :]
        placed = (ccol >= nv) & (ccol < nv + take)
        j = offsets - nv + ccol
        inside = placed & (j >= 0) & (j < N_HOSTS * ce)
        moved, _ = placement_bytes(work[13].reshape(rows, ci),
                                   work[14].reshape(rows, ci), placed, inside)
        return (*bound(moved, rows * ci * 6 + int(placed.sum()) * 30),
                moved)
    if name == "router_drain":
        arrival, size, rate, cap, state = args
        moved = drain_bytes((arrival, size, None, rate, cap, state), outs)
        return (*bound(moved, 0), moved)
    n_in = 10 if name == "egress_rank" else 6
    moved = nbytes(args[:n_in]) + nbytes(outs)
    rows, ce = args[0].shape[0] * args[0].shape[1], args[0].shape[2]
    lg = int(math.log2(ce))
    stages = lg * (lg + 1) // 2
    nets = 2 if name == "egress_rank" else 1
    ops = rows * ce * (nets * 6 * stages + 3 * lg + 16)
    shuffles = rows * ce * (nets * 2 * stages + (8 if nets == 2 else 3)
                            + 2 * lg) if ce <= 32 else 0
    return (*bound(moved, ops, shuffles), moved)


def time_call_and_launch(torch, pipeline, fn, reps):
    """`time_device(fn, reps)` twice: once as it is, and once with CUDA
    events around every `pipeline._launch` inside `fn` (one a call).
    Returns ((warm, cold, cold_clean) ms of the call, the same of its
    launch alone). The rest of a call is the host's work around the
    launch: the vmap rule's fold and unfold and the outputs'
    allocations. The launch's events stay out of the call's timing, where
    their host time would show."""
    call = time_device(torch, fn, reps=reps)
    events = []
    real = pipeline._launch

    def timed(name, *args):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        real(name, *args)
        pair[1].record()
        events.append(pair)

    pipeline._launch = timed
    try:
        time_device(torch, fn, reps=reps)
    finally:
        pipeline._launch = real
    # time_device's calls: one, reps on the host clock, then reps each
    # warm, cold and cold_clean
    if len(events) != 1 + 4 * reps:
        fail(f"{len(events)} launches in {1 + 4 * reps} timed calls")
    mean = lambda part: sum(s.elapsed_time(e) for s, e in part) / reps
    warm, cold, clean = (mean(events[1 + reps * i:1 + reps * (i + 1)])
                         for i in (1, 2, 3))
    return call, (warm, cold, clean)


def check_batched_launches(torch, pipeline):
    """17 (b): each kernel under vmap over ENS_WORLDS distinct worlds at
    the bench's width (one launch for W * N rows) against its plain
    version vmapped over the same worlds, bitwise; each batched launch
    timed cold and warm as phases 3-5 time the solo ones."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parity import BATCHED_KERNELS, batched_kernel_case, \
        flat_outputs

    rows = {}
    for name in BATCHED_KERNELS:
        wrapper, plain, args, in_dims, mutated = batched_kernel_case(
            name, N_HOSTS, range(300, 300 + ENS_WORLDS), ENS_DEVICE,
            ce=EGRESS_CAP, ci=INGRESS_CAP, k=INGRESS_CAP)
        clone = lambda: tuple(a.clone() if i in mutated else a
                              for i, a in enumerate(args))
        kern = torch.func.vmap(wrapper, in_dims=in_dims)
        before = pipeline.LAUNCHES[name]
        got = flat_outputs(kern(*clone()))
        ref = flat_outputs(torch.func.vmap(plain, in_dims=in_dims)(*clone()))
        torch.cuda.synchronize()
        if pipeline.LAUNCHES[name] != before + 1:
            fail(f"batched {name}: {pipeline.LAUNCHES[name] - before} "
                 "launches for one vmapped call")
        err = max_abs_err(torch, got, ref)
        if err != 0:
            fail(f"batched {name} over {ENS_WORLDS} worlds disagrees with "
                 f"its vmapped plain version (max abs err {err})")
        work = clone()
        (warm_ms, ms, clean_ms), (l_warm, l_ms, l_clean) = \
            time_call_and_launch(torch, pipeline, lambda: kern(*work), 10)
        bound_ms, bound_by, moved = batched_bound(
            torch, name, args, kern(*clone()), work)
        rows[name] = dict(worlds=ENS_WORLDS, rows=ENS_WORLDS * N_HOSTS,
                          max_abs_err=err, ms=ms, cold_clean_ms=clean_ms,
                          warm_ms=warm_ms, launch_ms=l_ms,
                          launch_cold_clean_ms=l_clean, launch_warm_ms=l_warm,
                          bytes=moved, bound_ms=bound_ms, bound_by=bound_by,
                          share_of_bound=bound_ms / ms,
                          launch_share_of_bound=bound_ms / l_ms)
    times = {k: [v["ms"], v["cold_clean_ms"], v["warm_ms"], v["bound_ms"],
                 v["bound_by"], v["share_of_bound"]]
             for k, v in rows.items()}
    alone = {k: [v["launch_ms"], v["launch_cold_clean_ms"],
                 v["launch_warm_ms"], v["launch_share_of_bound"]]
             for k, v in rows.items()}
    print(f"17 (b) batched launches over {ENS_WORLDS} worlds x N={N_HOSTS}: "
          f"each bitwise its vmapped plain version, one launch a call; ms "
          f"cold/clean/warm, bound ms, by, cold share {json.dumps(times)}; "
          f"the launch alone (CUDA events around pipeline._launch; the rest "
          f"is the vmap rule's fold, unfold and allocations) ms "
          f"cold/clean/warm, cold share {json.dumps(alone)}")
    return rows


def check_ensembles(torch, bench, convert, pipeline, record, ident):
    """Phase 17: ensembles of ENS_WORLDS bench worlds on the card."""
    from shadow_tpu_torch.tpu import elastic

    rec = {}
    t0 = time.perf_counter()
    # the worlds differ after their first window
    one = bench.run_worlds(ENS_WORLDS, N_HOSTS, rounds=1, warmup=False,
                           kernel="pallas_fused", n_nodes=N_NODES,
                           egress_cap=EGRESS_CAP, ingress_cap=INGRESS_CAP)
    first = ens_digests(convert, elastic, one["states"], ENS_WORLDS)
    if len(set(first)) != ENS_WORLDS:
        fail("the worlds' states are not distinct after their first window")
    del one
    # "xla" is `bench --worlds 8`'s path
    for kernel, pair in (("xla", ()),) + ENS_PAIRS:
        rec[kernel] = check_ensemble_phold(torch, bench, convert, elastic,
                                           pipeline, kernel, pair, ident)
    rec["seconds_phold"] = time.perf_counter() - t0
    t = time.perf_counter()
    rec["aqm"] = {}
    for kernel, pair in AQM_PATHS:
        rec["aqm"][kernel] = check_ensemble_aqm(torch, convert, elastic,
                                                pipeline, kernel, pair)
    rec["seconds_aqm"] = time.perf_counter() - t
    print(f"17 AQM ensemble: {ENS_WORLDS} worlds x N={N_HOSTS}, the first "
          f"{AQM_PLAIN_WINDOWS} windows on each kernel, each world equal to "
          f"its solo run, one launch of each kernel a window (profile: "
          f"windows {AQM_PLAIN_WINDOWS // 3}-{AQM_PLAIN_WINDOWS - 1}): "
          f"{json.dumps(rec['aqm'])} on {ident}")
    t = time.perf_counter()
    rec["batched"] = check_batched_launches(torch, pipeline)
    rec["seconds_b"] = time.perf_counter() - t
    record["ensembles"] = rec
    launches = {name: 0 for name in PORT_KERNELS}
    for kernel, _pair in ENS_PAIRS:
        for name, count in rec[kernel]["launches"].items():
            launches[name] += count
    launches["router_drain"] = sum(r["launches"]["router_drain"]
                                   for r in rec["aqm"].values())
    return launches


# phase 18: the section profiler (tpu/profiling.profile_sections)
PROF_REPS = 10
PROF_KERNELS = (("xla", ()),
                ("pallas_fused", ("egress_rank", "route_place")),
                ("pallas", ("egress_gate", "route_scatter")))
# the sections that run the step under the profiled kernel (the faults,
# guards, trace, flows and compute sections pin "xla", as JAX's do)
STEP_SECTIONS = {"fused_stage": 1, "window_step": 1, "window_chain8": 8,
                 "window_step_telemetry": 1, "window_step_elastic": 1,
                 "window_step_workload": 1}
# the corpus entry the `run_scenarios --config` check names
CONFIG_ENTRY = "incast.yaml"


def section_launches(section: str, kernel: str, pair) -> dict:
    """The port kernels one call of `section` launches on `kernel`: the
    pair in the step's sections (eight windows in `window_chain8`), D
    alone in `routing_scatter` on "pallas" (JAX's `_route_scatter` takes
    its XLA path on "pallas_fused"), E in `codel_drain` on every kernel,
    and nothing where JAX runs XLA code."""
    if section == "codel_drain":
        return {"router_drain": 1}
    if section == "routing_scatter":
        return {"route_scatter": 1} if kernel == "pallas" else {}
    return {name: STEP_SECTIONS[section] for name in pair
            if section in STEP_SECTIONS}


def leaves(torch, tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(torch, t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(torch, tree[k])]
    return [tree]


def launched(pipeline) -> dict:
    return {k: v for k, v in pipeline.LAUNCHES.items() if v}


def profile_one_kernel(torch, pipeline, profiling, kernel, pair):
    """`profile_sections` at the bench shape on `kernel`, the launches of
    each section's timed calls counted (its first, untimed call and the
    reps) by wrapping `_time_call`, which it calls once a section in
    order."""
    counts = []
    time_call = profiling._time_call

    def counted(*args, **kw):
        pipeline.reset_launches()
        out = time_call(*args, **kw)
        counts.append(launched(pipeline))
        return out

    profiling._time_call = counted
    try:
        rep = profiling.profile_sections(
            N_HOSTS, reps=PROF_REPS, kernel=kernel, n_nodes=N_NODES,
            egress_cap=EGRESS_CAP, ingress_cap=INGRESS_CAP)
    finally:
        profiling._time_call = time_call
    if list(rep["sections"]) != list(profiling.DEFAULT_SECTIONS) \
            or rep["backend"] != "gpu":
        fail(f"profile_sections on {kernel}: record {list(rep)}")
    total = {name: 0 for name in PORT_KERNELS}
    for section, got in zip(profiling.DEFAULT_SECTIONS, counts):
        want = {k: (PROF_REPS + 1) * n for k, n in section_launches(
            section, kernel, pair).items()}
        if got != want:
            fail(f"profile_sections {section} on {kernel}: launched {got}, "
                 f"expected {want} ({PROF_REPS} reps and one untimed call)")
        for k, n in got.items():
            total[k] += n
    return rep, total


def check_sections_bitwise(torch, pipeline, profiling, kernel, pair,
                           warmup_windows):
    """Each section that launches a kernel on `kernel`, once through the
    kernels and once through the plain versions on the card, on fresh
    clones of the same inputs: its launches counted, its outputs equal
    leaf for leaf (dtype, shape and every bit). The world is the
    profiler's after `warmup_windows` windows: after its 3 the egress
    rings have drained, so 0 holds its seed packets, which the routing
    sections place."""
    wanted = tuple(s for s in profiling.DEFAULT_SECTIONS
                   if section_launches(s, kernel, pair))
    world = profiling.build_world(N_HOSTS, n_nodes=N_NODES,
                                  egress_cap=EGRESS_CAP,
                                  ingress_cap=INGRESS_CAP,
                                  warmup_windows=warmup_windows)
    calls = profiling.section_calls(world, kernel=kernel, wanted=wanted)
    plain = profiling.section_calls(world, kernel=kernel, wanted=wanted,
                                    plain=True)
    for section in wanted:
        fn, args = calls[section]
        pipeline.reset_launches()
        got = leaves(torch, fn(*profiling.fresh_args(section, args)))
        torch.cuda.synchronize()
        if launched(pipeline) != section_launches(section, kernel, pair):
            fail(f"section {section} on {kernel} launched "
                 f"{launched(pipeline)}")
        pfn, pargs = plain[section]
        pipeline.reset_launches()
        ref = leaves(torch, pfn(*profiling.fresh_args(section, pargs)))
        if launched(pipeline):
            fail(f"plain section {section} launched {launched(pipeline)}")
        if len(got) != len(ref) or not got:
            fail(f"section {section} on {kernel}: {len(got)} outputs "
                 f"against {len(ref)} plain")
        for i, (a, b) in enumerate(zip(got, ref)):
            if not isinstance(a, torch.Tensor):
                same = a == b
            else:
                same = (a.dtype == b.dtype and a.shape == b.shape
                        and torch.equal(a, b))
            if not same:
                fail(f"section {section} on {kernel}: output {i} differs "
                     f"from the plain versions'")
    return list(wanted)


BASELINE_FNS = ("bench_cpu_baseline", "bench_compiled_baseline")


def check_bench_records(torch, bench, tmp: Path, ident):
    """`bench --kernel xla` and `--kernel xla --faults` in turns, through
    its `main`: the same final state, the section breakdown in both
    records, and `tools/compare_runs.py --bench` reads the two. Each
    record carries JAX's baselines (`check_baselines`). Their rates are
    the host's, not the run's: the object plane's is the witness
    `cpu-baseline` (`bench.bench_cpu_baseline` in the pool, beside the
    phases, off the critical path), the microbench's is measured by the
    first record's run; the second record reuses both."""
    import contextlib
    import io

    recs, rates = {}, {"bench_cpu_baseline": witness("cpu-baseline")}
    saved = {name: getattr(bench, name) for name in BASELINE_FNS}

    def measured_once(name):
        def once():
            if name not in rates:
                rates[name] = saved[name]()
            return rates[name]
        return once

    for name in BASELINE_FNS:
        setattr(bench, name, measured_once(name))
    try:
        for tag, argv in (("xla", []), ("faults", ["--faults"])):
            path = tmp / f"bench-{tag}.json"
            with contextlib.redirect_stdout(io.StringIO()):
                bench.main(["--kernel", "xla", *argv, "--out", str(path)])
            recs[tag] = json.loads(path.read_text())
    finally:
        for name, fn in saved.items():
            setattr(bench, name, fn)
    for tag, rec in recs.items():
        check_baselines(rec, rates, f"18 bench {tag}", ident)
    plain, faulted = recs["xla"], recs["faults"]
    if faulted["state_digest"] != plain["state_digest"]:
        fail("bench --faults (neutral masks) ends in another state than "
             "bench without them")
    if not faulted["kernel"]["faults_threaded"] \
            or plain["kernel"]["faults_threaded"]:
        fail(f"bench kernel records {plain['kernel']}, {faulted['kernel']}")
    for rec in recs.values():
        if rec["metric"] != "packet_events_per_sec" or rec["value"] <= 0 \
                or rec["backend"]["platform"] != "gpu" \
                or rec["hosts"] != N_HOSTS or not rec["sections"]:
            fail(f"bench record lacks JAX's keys: {sorted(rec)}")
    cmp = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "tools"
                             / "compare_runs.py"), "--bench",
         str(tmp / "bench-xla.json"), str(tmp / "bench-faults.json")],
        capture_output=True, text=True, timeout=120)
    if cmp.returncode != 0 or "section" not in cmp.stdout:
        fail(f"compare_runs.py --bench: rc {cmp.returncode}: "
             f"{cmp.stdout[-500:]} {cmp.stderr[-500:]}")
    print(f"18 bench --kernel xla vs --faults: events/s "
          f"{plain['value']} vs {faulted['value']}, the same state "
          f"({plain['state_digest'][:12]}); compare_runs.py --bench:\n"
          f"{cmp.stdout.rstrip()}\n(on {ident})")
    return {tag: {k: r[k] for k in (
        "value", "sections", "state_digest", "vs_baseline", "vs_compiled",
        "compiled_events_per_sec", "prior_round")}
        for tag, r in recs.items()}


def check_baselines(rec: dict, rates: dict, what: str, ident: str):
    """JAX's four baseline keys on a card's bench record: `vs_baseline`
    positive and the run's rate over the object plane's (`rates`, the
    measured ones); `prior_round` skipped as of another backend (every
    committed BENCH_r*.json is a JAX run's); `compiled_events_per_sec`
    positive with `vs_compiled` its ratio, or, where there is no g++,
    `vs_compiled` null and a line saying so. Prints them."""
    import shutil

    rate = rec["packet_events_per_sec"]
    cpu = rates["bench_cpu_baseline"]
    prior = rec.get("prior_round") or {}
    if rec.get("vs_baseline", 0) <= 0 or \
            rec["vs_baseline"] != round(rate / cpu, 2):
        fail(f"{what}: vs_baseline {rec.get('vs_baseline')} for "
             f"{rate} events/s over the object plane's {cpu}")
    if prior.get("skipped_mismatched_backend") is not True:
        fail(f"{what}: prior_round {rec.get('prior_round')} was not skipped "
             f"as of another backend")
    compiled = rec.get("compiled_events_per_sec")
    if compiled is None or "vs_compiled" not in rec:
        fail(f"{what}: the record lacks compiled_events_per_sec/vs_compiled")
    if compiled > 0:
        if rec["vs_compiled"] is None or \
                abs(rec["vs_compiled"] - rate / compiled) > 1e-3:
            fail(f"{what}: vs_compiled {rec['vs_compiled']} for {rate} over "
                 f"{compiled}")
    elif rec["vs_compiled"] is not None or shutil.which("g++") is not None:
        fail(f"{what}: no compiled rate ({compiled}) though g++ is "
             f"{shutil.which('g++')}, vs_compiled {rec['vs_compiled']}")
    else:
        print(f"{what}: g++ is missing on this host: no compiled baseline, "
              f"vs_compiled null")
    print(f"{what} baselines: vs_baseline {rec['vs_baseline']} (the port's "
          f"object plane {cpu:.1f} events/s on the host), "
          f"compiled_events_per_sec {compiled}, vs_compiled "
          f"{rec['vs_compiled']}, prior_round {json.dumps(prior)}  "
          f"[{ident}]")


def check_config_run(tmp: Path):
    """`run_scenarios --config` on a simulation config whose `workload:`
    block names a corpus entry by a path relative to the config: the
    record carries the entry's `scenarios/GOLDEN.json` digests."""
    from shadow_tpu_torch.workloads import run_scenarios, runner

    entry = CORPUS / CONFIG_ENTRY
    cfg = tmp / "sim.yaml"
    cfg.write_text(
        "general: {stop_time: 1s}\n"
        f"workload: {{scenario: {os.path.relpath(entry, tmp)}}}\n"
        "hosts:\n  h0: {network_node_id: 0}\n")
    out = tmp / "config-run.json"
    if run_scenarios.main(["--config", str(cfg), "-o", str(out)]) != 0:
        fail("run_scenarios --config failed")
    (rec,) = json.loads(out.read_text())["records"]
    golden = runner.load_golden(str(CORPUS / "GOLDEN.json"))
    problems = runner.check_against_golden(
        [rec], {rec["name"]: golden[rec["name"]]})
    if problems:
        fail(f"run_scenarios --config: {problems}")
    print(f"18 run_scenarios --config naming {CONFIG_ENTRY}: "
          f"{rec['name']} carries its golden digests "
          f"({rec['canonical_digest'][:12]})")
    return runner.golden_entry(rec)


def check_section_profiler(torch, bench, pipeline, record, ident):
    """Phase 18: the section profiler on every kernel, the bench record
    with and without `--faults`, and `run_scenarios --config`."""
    from shadow_tpu_torch.tpu import profiling

    rec = {"kernels": {}}
    launches = {name: 0 for name in PORT_KERNELS}
    t0 = time.perf_counter()
    for kernel, pair in PROF_KERNELS:
        t = time.perf_counter()
        rep, total = profile_one_kernel(torch, pipeline, profiling, kernel,
                                        pair)
        for k, n in total.items():
            launches[k] += n
        for warmup in (3, 0):
            checked = check_sections_bitwise(torch, pipeline, profiling,
                                             kernel, pair, warmup)
        win = bench.profile_windows(N_HOSTS, PROFILE_WINDOWS,
                                    n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                                    ingress_cap=INGRESS_CAP, kernel=kernel)
        busy = {k: win[k] for k in (
            "wall_ms_per_window", "device_busy_ms_per_window",
            "device_busy_share", "kernel_launches_per_window")}
        rec["kernels"][kernel] = {
            "sections": rep["sections"], "launches": total,
            "bitwise_sections": checked, "window_profile": busy,
            "seconds": time.perf_counter() - t}
        print(f"18 profile_sections kernel={kernel} N={N_HOSTS} "
              f"CE={EGRESS_CAP} CI={INGRESS_CAP} reps={PROF_REPS} "
              f"(host wall ms around a synchronise, min / median) on "
              f"{ident}:")
        for name, v in rep["sections"].items():
            print(f"  {name:<22} {v['min_ms']:>10.4f} {v['median_ms']:>10.4f}")
        print(f"  launches {total}; bitwise their plain versions: "
              f"{checked}; window_step beside its device busy time "
              f"(bench.profile_windows, {PROFILE_WINDOWS} windows): "
              f"{busy['device_busy_ms_per_window']:.5f} ms busy, "
              f"{busy['kernel_launches_per_window']:.1f} kernels, "
              f"{busy['wall_ms_per_window']:.4f} ms wall a window")
    rec["seconds_profile"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        t = time.perf_counter()
        rec["bench"] = check_bench_records(torch, bench, tmp, ident)
        rec["seconds_bench"] = time.perf_counter() - t
        rec["config_run"] = check_config_run(tmp)
    record["sections"] = rec
    return launches


# ---------------------------------------------------------------------------
# phase 19: the host-axis mesh on the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2  # (a): ranks over gloo on the one card
MESH_ROUNDS = ROUNDS  # the bench world's windows, sharded
MESH_PROFILE_WINDOWS = 8  # device us a launch on rank 0 (torch.profiler)
MESH_STRESS_HOSTS = 65_536
MESH_STRESS_WINDOWS = 64
MESH_PAIRS = ENS_PAIRS
MESH_DEVICE = "cuda"  # (a)'s ranks' device (the CPU only to rehearse)


def mesh_exchange_bytes(n_hosts: int, ce: int) -> int:
    """What a rank receives from the routing exchange a window: the seven
    [N, CE] int32 columns of every host (its own included)."""
    return 7 * n_hosts * ce * 4


def mesh_sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_profile(torch, bench, meshmod, kernel, mesh, n_hosts, windows):
    """Device us a launch of each port kernel over `windows` sharded
    bench windows after as many warm-up windows (torch.profiler on rank
    0; every rank runs the windows, as the collectives need)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    world = bench.build_world(n_hosts, n_nodes=N_NODES,
                              egress_cap=EGRESS_CAP, ingress_cap=INGRESS_CAP,
                              warmup_windows=0, device=mesh.device)
    world["state"], world["params"] = meshmod.shard_state(
        world["state"], world["params"], mesh)
    chain = bench.phold_chain_fn(world, kernel=kernel, mesh=mesh)
    n_local = world["state"].in_src.shape[0]
    extras = (torch.full((n_local,), bench.SPAWN_SEQ0, dtype=torch.int32,
                         device=mesh.device), 0)
    state, extras, _e, _i = chain(world["state"], extras, 0, windows)
    mesh_sync(torch, mesh.device)
    if mesh.rank != 0:
        chain(state, extras, windows, 2 * windows)
        mesh_sync(torch, mesh.device)
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chain(state, extras, windows, 2 * windows)
        mesh_sync(torch, mesh.device)
    us = {}
    for name in PORT_KERNELS:
        # the kernels themselves (named `<name>_kernel`), not the custom
        # ops that launch them
        evs = [ev for ev in prof.key_averages() if name in ev.key
               and ev.count and ev.device_type == DeviceType.CUDA]
        if evs:
            n = sum(ev.count for ev in evs)
            us[name] = {"us_per_launch": sum(ev.device_time_total
                                             for ev in evs) / n,
                        "launches": n}
    return us


def mesh_rank(mesh, n_hosts, rounds, stress_hosts, stress_windows,
              profile_windows, device_type="cuda"):
    """Phase 19 (a) on one rank of the gloo mesh: the golden world and
    the bench world through each kernel pair, sharded, with each rank's
    launches; a profile of the sharded windows; the multichip stress
    against the one-rank run (rank 0). Rank 0 returns the results, the
    per-rank launch counts gathered."""
    import torch

    from shadow_tpu_torch import bench, convert
    from shadow_tpu_torch.tools import multichip
    from shadow_tpu_torch.tpu import floweng
    from shadow_tpu_torch.tpu import mesh as meshmod
    from shadow_tpu_torch.tpu import pipeline

    if mesh.device.type != device_type:
        raise RuntimeError(f"phase 19: rank {mesh.rank} is on "
                           f"{mesh.device}, not the GPU")
    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP)

    def counted(fn, *a, **kw):
        pipeline.reset_launches()
        floweng.reset_launches()
        out = fn(*a, **kw)
        mesh_sync(torch, mesh.device)
        mine = torch.tensor([pipeline.LAUNCHES[k] for k in PORT_KERNELS]
                            + [floweng.LAUNCHES["flow_window"]],
                            dtype=torch.int64, device=mesh.device)
        every = mesh.gather_leaf(mine[None]).tolist()
        return out, [dict(zip(PORT_KERNELS + ("flow_window",), r))
                     for r in every]

    out = {"ranks": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), "staged": mesh.staged, "part_s": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["part_s"][name] = now - clock[0]
        clock[0] = now

    for kernel, pair in MESH_PAIRS:
        g = dict(bench.GOLDEN_PHOLD)
        golden = bench.run_phold(g.pop("n_hosts"), rounds=g.pop("rounds"),
                                 warmup=False, kernel=kernel, mesh=mesh, **g)
        golden_digest = convert.state_digest(
            meshmod.gather_state(golden["state"], mesh))
        lap(f"golden {kernel}")
        run, launches = counted(bench.run_phold, n_hosts, rounds=rounds,
                                warmup=False, kernel=kernel, mesh=mesh,
                                **size)
        digest = convert.state_digest(meshmod.gather_state(run["state"],
                                                           mesh))
        lap(f"bench world {kernel}")
        prof = mesh_profile(torch, bench, meshmod, kernel, mesh, n_hosts,
                            profile_windows)
        lap(f"profile {kernel}")
        out[kernel] = {
            "golden_digest": golden_digest, "digest": digest,
            "launches": launches, "wall_s": run["wall_s"],
            "events": run["events"], "delivered": run["delivered"],
            "packet_events_per_sec": run["packet_events_per_sec"],
            "in_window": prof}
    t0 = time.perf_counter()
    stress, launches = counted(multichip.check_stress, mesh, stress_hosts,
                               stress_windows, "pallas_fused")
    for k in ("state", "delivered"):
        stress.pop(k)
    stress.update(launches=launches, wall_s=time.perf_counter() - t0)
    out["stress"] = stress
    lap("stress")
    return out


def nsrc_placement_row(torch, pipeline, name, kernel, plain, n, n_src):
    """Kernel B or D at a mesh rank's shape (n ring rows, n_src gathered
    source rows) against its plain version, timed cold and warm beside
    its bound (`placement_bytes` at these inputs)."""
    args, _counts, placed, inside = placement_inputs(torch, n=n,
                                                     n_src=n_src)
    clone = lambda: [a.clone() for a in args]
    got = kernel(*clone())
    ref = plain(*clone())
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, ref)
    if err != 0:
        fail(f"{name} with n_src={n_src} != N={n} disagrees with its plain "
             f"version (max abs err {err})")
    work = clone()
    kernel(*work)
    warm_ms, ms, clean_ms = time_device(torch, lambda: kernel(*work))
    _, plain_ms, _ = time_device(torch, lambda: plain(*work), reps=10)
    moved, _ = placement_bytes(work[13], work[14], placed, inside)
    ops = n * INGRESS_CAP * 6 + int(placed.sum()) * 30
    bound_ms, bound_by = bound(moved, ops)
    return dict(n=n, n_src=n_src, max_abs_err=err, ms=ms, warm_ms=warm_ms,
                cold_clean_ms=clean_ms, plain_ms=plain_ms, bytes=moved,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms)


def egress_row(torch, pipeline, name, n):
    """Kernel A or C at a mesh rank's n rows, timed cold and warm beside
    its byte bound."""
    args = egress_inputs(torch, n, EGRESS_CAP, seed=n)
    if name == "egress_rank":
        call = lambda: pipeline.egress_rank_stage(*args)
        moved = nbytes(args[:10]) + nbytes(call())
    else:
        cargs = (*args[:5], args[9], args[10])
        call = lambda: pipeline.egress_order_gate(*cargs)
        moved = nbytes(cargs[:6]) + nbytes(call())
    warm_ms, ms, clean_ms = time_device(torch, call)
    bound_ms, bound_by = bound(moved, 0)
    return dict(n=n, ms=ms, warm_ms=warm_ms, cold_clean_ms=clean_ms,
                bytes=moved, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms)


def check_mesh(torch, bench, convert, pipeline, record, ident):
    """Phase 19: (a) two ranks on the one card over gloo (named: NCCL
    refuses two ranks on one card; each collective goes through host
    memory): the golden world and the bench world sharded through each
    kernel pair, equal to `GOLDEN_PHOLD_DIGEST` and to the unsharded
    bench-world runs, each rank launching its pair once a window and E
    never, and the multichip stress equal to its one-rank run; (b) one
    rank over NCCL: the bench world through the fused pair; (c) the
    kernels at a rank's shape (N_local = N / 2, n_src = N) beside their
    bounds, each part's seconds, the exchange's bytes and the sharded
    events/s beside the unsharded run's. Returns {kernel: [launches of
    each rank on the fused or split sharded path]}."""
    from shadow_tpu_torch.tpu import mesh as meshmod

    t_all = time.perf_counter()
    size = dict(n_nodes=N_NODES, egress_cap=EGRESS_CAP,
                ingress_cap=INGRESS_CAP)
    unsharded = {}
    for kernel, _pair in MESH_PAIRS:
        main = record.get(f"main_path_{kernel}", {})
        if "digest" in main:
            unsharded[kernel] = (main["digest"],
                                 main["packet_events_per_sec"])
        else:  # phase 19 alone: a warmed-up run, as phase 7's
            run = bench.run_phold(N_HOSTS, rounds=MESH_ROUNDS, kernel=kernel,
                                  **size)
            unsharded[kernel] = (convert.state_digest(run["state"]),
                                 run["packet_events_per_sec"])
    # (a) two ranks over gloo on the one card
    t0 = time.perf_counter()
    a = meshmod.run_ranks(mesh_rank, MESH_RANKS, N_HOSTS, MESH_ROUNDS,
                          MESH_STRESS_HOSTS, MESH_STRESS_WINDOWS,
                          MESH_PROFILE_WINDOWS, MESH_DEVICE, backend="gloo",
                          device=MESH_DEVICE)
    t_a = time.perf_counter() - t0
    if not a["staged"]:
        fail("phase 19 (a): the gloo ranks' collectives were not staged "
             "through host memory")
    launches = {}
    for kernel, pair in MESH_PAIRS:
        got = a[kernel]
        if got["golden_digest"] != bench.GOLDEN_PHOLD_DIGEST:
            fail(f"phase 19 (a): the golden world sharded over {MESH_RANKS} "
                 f"ranks through kernel={kernel!r} ends in "
                 f"{got['golden_digest']}, not GOLDEN_PHOLD_DIGEST")
        if got["digest"] != unsharded[kernel][0]:
            fail(f"phase 19 (a): the bench world sharded over {MESH_RANKS} "
                 f"ranks through kernel={kernel!r} ({MESH_ROUNDS} windows) "
                 "differs from the unsharded run")
        for rank, counts in enumerate(got["launches"]):
            for name, count in counts.items():
                want = MESH_ROUNDS if name in pair else 0
                if count != want:
                    fail(f"phase 19 (a): rank {rank} launched {name} "
                         f"{count} times on the sharded kernel={kernel!r} "
                         f"path, expected {want}")
        for name in pair:
            launches[name] = [c[name] for c in got["launches"]]
        print(f"19 (a) kernel={kernel}: N={N_HOSTS} over {MESH_RANKS} ranks "
              f"(gloo on one card, each collective staged through host "
              f"memory), R={MESH_ROUNDS}: digest == the unsharded run's, "
              f"golden world == GOLDEN_PHOLD_DIGEST; launches per rank "
              f"{got['launches']}; {got['packet_events_per_sec']:.1f} "
              f"events/s sharded vs {unsharded[kernel][1]:.1f} unsharded "
              f"(a record, not a claim: the host staging dominates); "
              f"in-window us a launch on rank 0 {got['in_window']} on "
              f"{ident}")
    # E and F on neither sharded path (checked 0 above), per rank
    for name in ("router_drain", "flow_window"):
        launches[name] = [sum(a[k]["launches"][rank][name]
                              for k, _pair in MESH_PAIRS)
                          for rank in range(MESH_RANKS)]
    st = a["stress"]
    if st["diff"] or st["overflow_drops"] <= 0 or \
            st["chain"][2] != MESH_STRESS_WINDOWS:
        fail(f"phase 19 (a): the multichip stress diverged or walked short: "
             f"{st['diff'][:8]}, chain {st['chain']}, "
             f"{st['overflow_drops']} overflow drops")
    for rank, counts in enumerate(st["launches"]):
        # rank 0 also ran the one-rank reference chain
        want = MESH_STRESS_WINDOWS * (2 if rank == 0 else 1)
        if counts["route_place"] != want or counts["egress_rank"] != want \
                or counts["router_drain"] != 0:
            fail(f"phase 19 (a): the stress's rank {rank} launches {counts}")
    print(f"19 (a) stress: {st['hosts']} hosts x {st['ranks']} ranks, "
          f"kernel={st['kernel']}, chain (off, next, n_windows) "
          f"{st['chain']}, {st['overflow_drops']} overflow drops, bitwise "
          f"== the one-rank run; chain wall one rank "
          f"{st['one_rank_wall_s']:.3f}s vs sharded "
          f"{st['sharded_wall_s']:.3f}s")
    # (b) one rank over NCCL: the sharded code path with NCCL's
    # collectives on CUDA tensors and the changed B
    t0 = time.perf_counter()
    mesh = meshmod.make_mesh(1, backend="nccl", device="cuda")
    try:
        pipeline.reset_launches()
        g = dict(bench.GOLDEN_PHOLD)
        golden = bench.run_phold(g.pop("n_hosts"), rounds=g.pop("rounds"),
                                 warmup=False, kernel="pallas_fused",
                                 mesh=mesh, **g)
        golden_digest = convert.state_digest(meshmod.gather_state(
            golden["state"], mesh))
        run = bench.run_phold(N_HOSTS, rounds=MESH_ROUNDS, warmup=False,
                              kernel="pallas_fused", mesh=mesh, **size)
        digest = convert.state_digest(meshmod.gather_state(run["state"],
                                                           mesh))
        nccl_launches = dict(pipeline.LAUNCHES)
    finally:
        torch.distributed.destroy_process_group()
    t_b = time.perf_counter() - t0
    if golden_digest != bench.GOLDEN_PHOLD_DIGEST or \
            digest != unsharded["pallas_fused"][0]:
        fail("phase 19 (b): the one-rank NCCL mesh through the fused pair "
             "differs from the unsharded run")
    want = bench.GOLDEN_PHOLD["rounds"] + MESH_ROUNDS
    if nccl_launches["route_place"] != want or \
            nccl_launches["egress_rank"] != want:
        fail(f"phase 19 (b): launches {nccl_launches}, expected {want} of "
             "A and B")
    print(f"19 (b) one rank over NCCL, kernel=pallas_fused: golden world == "
          f"GOLDEN_PHOLD_DIGEST, N={N_HOSTS} R={MESH_ROUNDS} == the unsharded "
          f"run; {run['packet_events_per_sec']:.1f} events/s vs "
          f"{unsharded['pallas_fused'][1]:.1f} unsharded")
    # (c) the kernels at a rank's shape
    t0 = time.perf_counter()
    n_local = N_HOSTS // MESH_RANKS
    rows = {
        "route_place": nsrc_placement_row(torch, pipeline, "route_place",
                                          pipeline.place,
                                          pipeline.place_plain, n_local,
                                          N_HOSTS),
        "route_scatter": nsrc_placement_row(torch, pipeline,
                                            "route_scatter",
                                            pipeline.scatter,
                                            pipeline.scatter_plain, n_local,
                                            N_HOSTS),
        "egress_rank": egress_row(torch, pipeline, "egress_rank", n_local),
        "egress_gate": egress_row(torch, pipeline, "egress_gate", n_local)}
    t_c = time.perf_counter() - t0
    for name, row in rows.items():
        print(f"19 (c) {name} at N_local={n_local}"
              + (f", n_src={row['n_src']}: bitwise ok" if "n_src" in row
                 else "")
              + f": kernel_ms={row['ms']:.5f} (cold; clean "
              f"{row['cold_clean_ms']:.5f}; warm {row['warm_ms']:.5f}) "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
              f"{row['bytes']} B) share={row['share_of_bound']:.3f}"
              + (f" plain_ms={row['plain_ms']:.5f}" if "plain_ms" in row
                 else "") + f" on {ident}")
    xbytes = mesh_exchange_bytes(N_HOSTS, EGRESS_CAP)
    print(f"19 (c) the routing exchange: {xbytes} B gathered a window by "
          f"each rank ({xbytes // MESH_RANKS} B its own), staged through "
          f"host memory under gloo; part seconds (a) {t_a:.1f} (rank 0: "
          + ", ".join(f"{k} {v:.1f}" for k, v in a["part_s"].items())
          + f") (b) {t_b:.1f} (c) {t_c:.1f}, phase "
          f"{time.perf_counter() - t_all:.1f} on {ident}")
    record["mesh"] = {"a": a, "b": {"digest": digest, "golden": golden_digest,
                                    "launches": nccl_launches,
                                    "packet_events_per_sec":
                                        run["packet_events_per_sec"]},
                      "c": rows, "exchange_bytes_per_window": xbytes,
                      "part_s": {"a": t_a, "b": t_b, "c": t_c}}
    return launches


# phase 20: the device flow engine (tpu/floweng.py, kernel F)
FLOW_A = dict(n_flows=64, n_windows=60, window_us=2000, queue_slots=16)
# (a)'s two option sets: the defaults, and one-MSS pulls under a step cap
# small enough to saturate windows (its bursts overflow the rings too)
FLOW_A_RUNS = (("default", {}),
               ("gso1-cap2", dict(gso_segs=1, max_events_per_window=2)))
FLOW_CHUNK = 25  # bench_flows' chunk of windows
# (a)'s world at pair counts that do not fill a block and rings from 16 to
# 1024 slots (with bench_flows' 975 pairs at Q=128, (a)'s 64 at Q=16 and
# rung 3's 1024 at Q=256, every pair count and Q of the card tests): flows,
# ring slots; FLOW_GRID_WINDOWS windows of (a)'s width
FLOW_GRID = ((1, 16), (33, 256), (975, 1024))
FLOW_GRID_WINDOWS = 24
FLOW_BENCH_REPS = 8  # (b): bench_flows' runs back to back for its rate
FLOW_DEVICE = "cuda"  # phase 20's device ("cpu" in a CPU rehearsal)
# (d): the multichip dry run's shard counts (8: `dryrun_multichip(8)`),
# every shard on the one card
FLOW_SHARDS = (2, 8)
# (e): bench_flows' world with rings past the 28957 slots an earlier
# kernel F staged in shared memory, at a power of two (a ring slot by a
# mask) and at a Q that is none (by a division); the rung-3 deployment
# with this growth budget
FLOW_Q_LARGE = (32768, 30001)
FLOW_MAX_DOUBLINGS = 8
# ... and with ring drops added to every bucket run whose rings hold fewer
# than FLOW_GROW_TO slots, so every bucket's rings double up to it
FLOW_GROW_TO = 32768
FLOW_GROW_DROPS = 5


def flow_leaves(convert, world) -> dict:
    d = convert.flow_world_to_numpy(world)
    out = {f"plane.{k}": v for k, v in d.pop("plane").items()}
    out.update(d)
    return out


def flow_world_bytes(world) -> int:
    return sum(t.numel() * t.element_size() for t in world.plane) + sum(
        t.numel() * t.element_size() for t in world[1:])


def flow_diff(convert, got, ref) -> tuple[int, list]:
    """The largest absolute difference over every `FlowWorld` leaf, and
    the leaves that differ in dtype or value."""
    a, b = flow_leaves(convert, got), flow_leaves(convert, ref)
    bad = [k for k in b if a[k].dtype != b[k].dtype
           or not np.array_equal(a[k], b[k])]
    err = max((int(np.abs(a[k].astype(np.int64)
                          - b[k].astype(np.int64)).max())
               for k in b if a[k].size and a[k].shape == b[k].shape),
              default=0)
    return err, bad


def f_plain_chunks(floweng, world, n_chunks, n_win, win, count=False,
                   **opts):
    """`run_windows_plain` from `world`, `n_chunks` chunks of `n_win`
    windows each: after each chunk the world's leaves (`flow_leaves`), its
    steps_per_window, its seconds and, with `count`, the chunk's longest
    pair (`kernel_f_probe.longest_pair`, counted on this run, whose
    seconds then include the count)."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.tools import kernel_f_probe

    ref, chunks = world, []
    for _k in range(n_chunks):
        t0 = time.perf_counter()
        if count:
            ref, ref_steps, ev = kernel_f_probe.pair_events(
                floweng, ref, n_win, win, **opts)
            top = kernel_f_probe.longest_pair(ev)
        else:
            ref, ref_steps = floweng.run_windows_plain(ref, n_win, win,
                                                       **opts)
            top = None
        if ref_steps.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        chunks.append(dict(leaves=flow_leaves(convert, ref),
                           steps=ref_steps.tolist(), events=top,
                           seconds=time.perf_counter() - t0))
    return chunks


def flow_plain_witness(what, *arg):
    """Phase 20 (a)'s plain runs on the CPU (`cpu_witness`): (a)'s world
    under FLOW_A_RUNS' options `arg[0]`, at (flows, Q) `arg` of FLOW_GRID,
    or rung 3's largest bucket through its first chunk with work."""
    from shadow_tpu_torch.tools import kernel_f_probe
    from shadow_tpu_torch.tpu import floweng

    win = FLOW_A["window_us"]
    if what == "a":
        w0 = kernel_f_probe.world_a(floweng, "cpu", FLOW_A["n_flows"],
                                    FLOW_A["queue_slots"])
        return f_plain_chunks(floweng, w0, 1, FLOW_A["n_windows"], win,
                              **dict(FLOW_A_RUNS)[arg[0]])
    if what == "grid":
        w0 = kernel_f_probe.world_a(floweng, "cpu", *arg)
        return f_plain_chunks(floweng, w0, 1, FLOW_GRID_WINDOWS, win)
    r = kernel_f_probe.rung3_bucket("cpu")
    return f_plain_chunks(floweng, r["world"], r["busy"] + 1, r["chunk"],
                          r["window_us"], count=True)


def f_against_plain(torch, convert, floweng, world, n_chunks, n_win, win,
                    label, count=False, plain=None, **opts):
    """Kernel F (`run_windows`) and `run_windows_plain` from `world`,
    `n_chunks` chunks of `n_win` windows each, every `FlowWorld` leaf
    and `steps_per_window` held bitwise after each chunk. The plain
    run is `plain` (`f_plain_chunks`' chunks, from a CPU witness) or run
    here, on `world`'s device. Returns F's world, a row (the largest
    absolute difference, F's and the plain version's wall seconds, each
    chunk's steps and, with `count`, each chunk's longest pair) and F's
    world before the last chunk."""
    got = world
    plain_device = "cpu" if plain is not None else str(world.conn_t.device)
    if plain is None:
        plain = f_plain_chunks(floweng, world, n_chunks, n_win, win, count,
                               **opts)
    row = dict(max_abs_err=0, f_wall_s=[], plain_s=[], steps=[], events=[],
               plain_device=plain_device)
    for k, ref in enumerate(plain):
        start = got
        t0 = time.perf_counter()
        got, steps = floweng.run_windows(got, n_win, win, **opts)
        torch.cuda.synchronize()
        row["f_wall_s"].append(time.perf_counter() - t0)
        row["plain_s"].append(ref["seconds"])
        if ref["events"] is not None:
            row["events"].append(ref["events"])
        leaves = flow_leaves(convert, got)
        bad = [f for f in ref["leaves"] if not np.array_equal(
            leaves[f], ref["leaves"][f])]
        err = max((int(np.abs(leaves[f].astype(np.int64)
                              - ref["leaves"][f].astype(np.int64)).max())
                   for f in bad), default=0)
        ref_steps = torch.tensor(ref["steps"], dtype=steps.dtype)
        err = max(err, int((steps.cpu().long() - ref_steps.long()).abs()
                           .max()))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if bad or not torch.equal(steps.cpu(), ref_steps):
            fail(f"phase 20 (a) {label}, chunk {k}: kernel F differs from "
                 f"its plain version in {bad or 'steps_per_window'} (max "
                 f"abs err {err})")
        row["steps"].append(ref["steps"])
    return got, row, start


@contextlib.contextmanager
def timed_f_launches(torch, floweng):
    """While open, each launch of kernel F sits between two CUDA events on
    the stream it launches on; yields the list of (start, end) pairs."""
    real = floweng._launch_f
    events = []

    def launch(dev, ints, tensors, entry=None):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(torch.cuda.current_stream(dev))
        real(dev, ints, tensors, entry)
        e1.record(torch.cuda.current_stream(dev))
        events.append((e0, e1))

    floweng._launch_f = launch
    try:
        yield events
    finally:
        floweng._launch_f = real


def check_flow_sharded(torch, convert, floweng, ident) -> dict:
    """Phase 20 (d): the multichip dry run's flow world (12 flows a shard,
    400 windows of 20 ms) at each of FLOW_SHARDS shards on the one card:
    `run_windows_sharded` against a single launch of F on the whole
    world, bitwise on every leaf; F launched once a shard; each shard's
    steps against F on that shard alone; the input world unchanged.
    Returns {n_shards: row}."""
    from shadow_tpu_torch.tools import multichip

    n_win, win = multichip.FLOW_WINDOWS, multichip.FLOW_WINDOW_US
    rows = {}
    for n in FLOW_SHARDS:
        n_flows = 12 * n
        t0 = time.perf_counter()
        single, _ = floweng.run_windows(
            multichip.flow_world(n_flows, FLOW_DEVICE), n_win, win)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        w0 = multichip.flow_world(n_flows, FLOW_DEVICE)
        keep = floweng.clone_world(w0)
        floweng.reset_launches()
        with timed_f_launches(torch, floweng) as events:
            t0 = time.perf_counter()
            sharded, steps = floweng.run_windows_sharded(w0, n_win, win,
                                                         n_shards=n)
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t0
        launches = floweng.LAUNCHES["flow_window"]
        if launches != n:
            fail(f"phase 20 (d): {launches} launches of F for {n} shards")
        shard_ms = [e0.elapsed_time(e1) for e0, e1 in events]
        err, bad = flow_diff(convert, sharded, single)
        if bad:
            fail(f"phase 20 (d): {n} shards differ from one launch of F in "
                 f"{bad} (max abs err {err})")
        if flow_diff(convert, w0, keep)[1]:
            fail("phase 20 (d): the sharded run changed its input world")
        split = floweng.split_flow_world(w0, n)
        for s in range(n):
            alone = floweng.clone_world(floweng._shard(split, s))
            st = floweng.flow_window_(alone, n_win, win)
            if tuple(steps.shape) != (n, n_win) or not torch.equal(
                    st, steps[s]):
                fail(f"phase 20 (d): shard {s} of {n}: its steps differ "
                     f"from F launched on that shard alone")
        res = floweng.flow_results(sharded)
        done = int((res["bytes_read"] >= res["bytes_expected"]).sum())
        if done == 0 or int(steps.sum()) == 0:
            fail(f"phase 20 (d): {n} shards ran no transfer to its end")
        rows[n] = dict(flows=n_flows, launches=launches, shard_ms=shard_ms,
                       single_wall_s=single_s, sharded_wall_s=sharded_s,
                       complete=done, segments=res["segments"],
                       wire_drops=res["wire_drops"],
                       retransmits=res["retransmits"], max_abs_err=err)
        print(f"20 (d) run_windows_sharded, {n_flows} flows x {n} shards, "
              f"{n_win} windows of {win} us: bitwise == one launch of F on "
              f"every leaf; F launched {launches} times; each shard's steps "
              f"== F on that shard alone; {done}/{n_flows} complete, "
              f"{res['segments']} segments, {res['wire_drops']} wire drops; "
              f"device ms a shard {shard_ms}; wall sharded {sharded_s:.4f} "
              f"s vs one launch {single_s:.4f} s (shards share one card: "
              f"placement, not speedup) on {ident}")
    return rows


def time_flow_chunk(torch, floweng, world, n_win, win):
    """F's device ms of a launch on a chunk of `n_win` windows from
    `world`: (warm, cold, cold clean), CUDA events around
    `floweng.flow_window_` (`kernel_f_probe.time_launch`)."""
    from shadow_tpu_torch.tools import kernel_f_probe

    t = kernel_f_probe.time_launch(
        torch, lambda w: floweng.flow_window_(w, n_win, win), world)
    return t["warm"], t["cold"], t["clean"]


def check_flow_engine(torch, record, ident):
    """Phase 20: kernel F against its plain version (on (a)'s world and
    at the main paths' shapes), bench_flows at full width and the rung-3
    deployment with a kill and resume. Returns (F's kernel row, its
    launches in (b), its launches in (c))."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.core import flowplan
    from shadow_tpu_torch.core.config import load_config_str
    from shadow_tpu_torch.tools import bench_flows, kernel_f_probe
    from shadow_tpu_torch.tpu import floweng

    t_all = time.perf_counter()
    # (a) bitwise against the plain version on the card
    n_win, win = FLOW_A["n_windows"], FLOW_A["window_us"]
    w0 = kernel_f_probe.world_a(floweng, FLOW_DEVICE, FLOW_A["n_flows"],
                                FLOW_A["queue_slots"])
    a_rows = {}
    for name, opts in FLOW_A_RUNS:
        ref, row, _ = f_against_plain(torch, convert, floweng, w0, 1,
                                      n_win, win, name,
                                      plain=witness(f"flow-a:{name}"),
                                      **opts)
        res = floweng.flow_results(ref)
        a_rows[name] = dict(
            row, segments=res["segments"], wire_drops=res["wire_drops"],
            queue_drops=res["queue_drops"],
            saturated_windows=res["saturated_windows"])
    heavy = a_rows["gso1-cap2"]
    if heavy["queue_drops"] <= 0 or heavy["saturated_windows"] <= 0 \
            or a_rows["default"]["wire_drops"] <= 0:
        fail(f"phase 20 (a): the worlds must show wire drops, ring drops "
             f"and saturated windows: {a_rows}")
    a_warm, a_ms, a_clean = time_flow_chunk(torch, floweng, w0, n_win,
                                            win)
    for name, row in a_rows.items():
        print(f"20 (a) kernel F vs run_windows_plain, {FLOW_A['n_flows']} "
              f"flows x {n_win} windows, {name}: bitwise on every leaf and "
              f"steps_per_window (max {max(row['steps'][0])} steps a "
              f"window, {row['segments']} segments, {row['wire_drops']} "
              f"wire drops, {row['queue_drops']} ring drops, "
              f"{row['saturated_windows']} saturated windows); F first "
              f"call {row['f_wall_s'][0]:.4f} s wall, plain "
              f"{row['plain_s'][0]:.3f} s wall on the "
              f"{row['plain_device']}")
    print(f"20 (a) kernel F a {n_win}-window chunk: {a_ms:.5f} ms cold "
          f"(clean {a_clean:.5f}; warm {a_warm:.5f}) on {ident}")
    # (a)'s world at pair counts that leave a block part empty and at
    # rings of 16 to 1024 slots
    grid = {}
    for n_flows, q in FLOW_GRID:
        wg = kernel_f_probe.world_a(floweng, FLOW_DEVICE, n_flows, q)
        _ref, row, _ = f_against_plain(
            torch, convert, floweng, wg, 1, FLOW_GRID_WINDOWS, win,
            f"{n_flows} flows, Q={q}",
            plain=witness(f"flow-grid:{n_flows}x{q}"))
        if not any(row["steps"][0]):
            fail(f"phase 20 (a): {n_flows} flows at Q={q} ran no step")
        row["geometry"] = floweng.f_geometry(wg)
        grid[f"{n_flows}x{q}"] = row
    print(f"20 (a) kernel F vs run_windows_plain at (flows, Q) "
          f"{list(FLOW_GRID)}, {FLOW_GRID_WINDOWS} windows of {win} us: "
          f"bitwise on every leaf and steps_per_window; launches "
          f"{[r['geometry'] for r in grid.values()]}")
    # (a) at the main paths' shapes: bench_flows' first chunk, and the
    # rung-3 run's largest bucket (its first attempt's rings) through
    # its first chunk with work
    lats, sizes, qs, wus = bench_flows.default_world_args()
    bench_w0 = floweng.make_flow_world(lats, sizes, queue_slots=qs,
                                       device=FLOW_DEVICE)
    _ref, bench_row, _ = f_against_plain(torch, convert, floweng, bench_w0,
                                         1, FLOW_CHUNK, wus, "bench_flows",
                                         count=True)
    r = kernel_f_probe.rung3_bucket(FLOW_DEVICE)
    r_w0, r_wus, r_chunk, r_busy = (r["world"], r["window_us"], r["chunk"],
                                    r["busy"])
    _ref, rung3_row, r_start = f_against_plain(
        torch, convert, floweng, r_w0, r_busy + 1, r_chunk, r_wus,
        "rung-3 bucket", count=True, plain=witness("flow-rung3"))
    if not any(rung3_row["steps"][-1]) or not any(bench_row["steps"][0]):
        fail("phase 20 (a): a main-path chunk held against the plain "
             "version ran no step")
    r_lanes, r_q = r_w0.q_time.shape
    for label, row, shape in (
            ("bench_flows' first chunk", bench_row,
             f"{2 * len(lats)} lanes, Q={qs}, {FLOW_CHUNK} windows of "
             f"{wus} us"),
            (f"rung 3's {r_wus} us bucket, chunks 0-{r_busy}", rung3_row,
             f"{r['flows']} flows padded to {r_lanes} lanes, Q={r_q}, "
             f"{r_chunk} windows of {r_wus} us a chunk")):
        print(f"20 (a) kernel F vs run_windows_plain at {label} ({shape}): "
              f"bitwise on every leaf and steps_per_window after each "
              f"chunk ({sum(map(sum, row['steps']))} steps); F "
              f"{sum(row['f_wall_s']):.4f} s wall, plain (its events "
              f"counted) {sum(row['plain_s']):.3f} s wall on the "
              f"{row['plain_device']}")
    bench_row["geometry"] = floweng.f_geometry(bench_w0)
    rung3_row["geometry"] = floweng.f_geometry(r_w0)
    f_warm, f_ms, f_clean = time_flow_chunk(torch, floweng, bench_w0,
                                            FLOW_CHUNK, wus)
    print(f"20 (a) kernel F bench_flows' first {FLOW_CHUNK}-window chunk: "
          f"{f_ms:.5f} ms cold (clean {f_clean:.5f}; warm {f_warm:.5f}) vs "
          f"the plain version {bench_row['plain_s'][0] * 1e3:.1f} ms wall "
          f"on {ident}")
    r_warm, r_ms, r_clean = time_flow_chunk(torch, floweng, r_start,
                                            r_chunk, r_wus)
    print(f"20 (a) kernel F rung 3's {r_wus} us bucket, chunk {r_busy}: "
          f"{r_ms:.5f} ms cold (clean {r_clean:.5f}; warm {r_warm:.5f}) on "
          f"{ident}")
    # the serial chain: the longest pair's events against F's time
    chain = {}
    for key, label, shape, row, ms, clean in (
            ("bench", "bench_flows' first chunk",
             f"{2 * len(lats)} lanes, Q={qs}", bench_row, f_ms, f_clean),
            ("rung3", f"rung 3's chunk {r_busy}", f"{r_lanes} lanes, Q={r_q}",
             rung3_row, r_ms, r_clean)):
        top = dict(row["events"][-1], us_per_event_cold=ms * 1e3 / max(
            row["events"][-1]["events"], 1), us_per_event_clean=clean
            * 1e3 / max(row["events"][-1]["events"], 1))
        chain[key] = top
        g = row["geometry"]
        print(f"20 (a) kernel F at {label} ({shape}): {g['blocks']} blocks "
              f"of {g['pairs_a_block']} pairs ({g['smem_bytes']} B of "
              f"shared memory a block) on {g['sms']} SMs; the longest pair "
              f"(pair {top['pair']}) {top['events']} events "
              f"({top['sched']} scheduled, {top['pulls']} pulls, "
              f"{top['app']} app phases; its busier lane "
              f"{top['busier_lane']}; the mean pair "
              f"{top['mean_pair_events']:.1f}), "
              f"{top['us_per_event_clean']:.3f} us an event clean "
              f"({top['us_per_event_cold']:.3f} cold) on {ident}")

    # (b) bench_flows' default world at full width
    floweng.reset_launches()
    out = bench_flows.run(device=FLOW_DEVICE)
    b_launches = out["launches"]
    chunks = round(out["sim_seconds"] * 1e6 / wus / FLOW_CHUNK)
    if out["digest"] != bench_flows.GOLDEN_FLOW_DIGEST:
        fail(f"phase 20 (b): flow_results digest {out['digest']} != "
             f"GOLDEN_FLOW_DIGEST ({out})")
    if b_launches != chunks * (out["saturation_retries"] + 1):
        fail(f"phase 20 (b): {b_launches} launches of F for {chunks} "
             f"chunks and {out['saturation_retries']} retries")
    # the run again FLOW_BENCH_REPS times back to back, each timed on the
    # host clock around the call, unrounded
    rep_s = []
    for _ in range(FLOW_BENCH_REPS):
        t0 = time.perf_counter()
        rep = bench_flows.run(device=FLOW_DEVICE)
        rep_s.append(time.perf_counter() - t0)
        if rep["digest"] != out["digest"]:
            fail("phase 20 (b): a repeated bench_flows run differs")
    # and once more, each launch timed by CUDA events (device ms); a spin
    # queued before the first event keeps the card busy while the host
    # enqueues the wrapper's work, so its host time does not show
    in_run = []

    def timed_chunk(w, cap):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        w2 = floweng.clone_world(w)
        torch.cuda._sleep(kernel_f_probe.SPIN_CYCLES)
        e0.record()
        st = floweng.flow_window_(w2, FLOW_CHUNK, wus,
                                  max_events_per_window=cap)
        e1.record()
        in_run.append((e0, e1, st))
        return w2, st

    floweng.run_to_completion(bench_w0, wus, max_sim_s=40.0,
                              chunk_windows=FLOW_CHUNK, probe_every=2,
                              run_fn=timed_chunk)
    torch.cuda.synchronize()
    run_ms = [e0.elapsed_time(e1) for e0, e1, _ in in_run]
    max_steps = max(int(st.max()) for _, _, st in in_run)
    bench_bytes = 2 * flow_world_bytes(bench_w0)
    bench_bound_ms = bench_bytes / PEAK_BYTES_PER_S * 1e3
    seg = out["segments"]
    rates = dict(wall_segments_per_s=seg * len(rep_s) / sum(rep_s),
                 device_segments_per_s=seg / (sum(run_ms) / 1e3))
    print(f"20 (b) bench_flows {out['flows']} flows x "
          f"{out['bytes_per_flow']} B: {out['flows_complete']} complete in "
          f"{out['sim_seconds']} s simulated, {seg} segments, "
          f"{out['retransmits']} retransmits, {out['saturation_retries']} "
          f"retries; digest == GOLDEN_FLOW_DIGEST; F launched "
          f"{b_launches} times ({chunks} chunks); first run "
          f"{out['wall_seconds']} s wall (the tool's rounding); "
          f"{FLOW_BENCH_REPS} more back to back {rep_s} s wall, "
          f"{rates['wall_segments_per_s']} segments a wall second; in-run "
          f"device ms a launch {run_ms} (sum {sum(run_ms)}, "
          f"{rates['device_segments_per_s']} segments a device second; "
          f"max {max_steps} steps a window; bound {bench_bound_ms:.5f} ms: "
          f"the world's {bench_bytes} B read and written once a launch) on "
          f"{ident}")

    # (c) the rung-3 deployment, then killed after a bucket and resumed
    want = json.loads(flowplan.RUNG3_RECORD.read_text())
    want.pop("source")
    text = flowplan.RUNG3_YAML.read_text()
    floweng.reset_launches()
    with timed_f_launches(torch, floweng) as c_events:
        t0 = time.perf_counter()
        stats = flowplan.run_config(load_config_str(text),
                                    device=FLOW_DEVICE)
        c_wall = time.perf_counter() - t0
    c_launches = floweng.LAUNCHES["flow_window"]
    torch.cuda.synchronize()
    c_ms = [e0.elapsed_time(e1) for e0, e1 in c_events]
    got = flowplan.stats_record(stats)
    if got != want:
        fail(f"phase 20 (c): the rung-3 run's record {got} != the JAX "
             f"Manager's {want}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        killed = flow_run_killed(floweng, flowplan, load_config_str(text),
                                 tmp, FLOW_DEVICE)
        resumed = flowplan.run_config(
            load_config_str(text), device=FLOW_DEVICE,
            resume_from=os.path.join(tmp, "flow-progress"))
        r_wall = time.perf_counter() - t0
    if not killed:
        fail("phase 20 (c): the rung-3 run has one bucket; nothing killed")
    if flowplan.stats_record(resumed) != want:
        fail("phase 20 (c): the rung-3 run killed after its first bucket "
             "and resumed differs from the JAX Manager's record")
    print(f"20 (c) rung 3 on the flow engine ({len(stats.flow_complete_us)}"
          f" flows, {stats.sim_time_ns / 1e9:.0f} s simulated, "
          f"{stats.rounds} windows): record == the JAX Manager's "
          f"({stats.packets_sent} packets, {stats.packets_dropped} dropped, "
          f"{stats.flow_retransmits} retransmits, "
          f"{len(stats.process_failures)} failures); {c_wall:.2f} s wall, "
          f"{c_launches} launches of F, device ms summed {sum(c_ms)} "
          f"(CUDA events around each launch: {c_ms}); killed where its "
          f"second bucket starts and resumed: equal ({r_wall:.2f} s wall "
          f"for both parts) on {ident}")

    # (d) the multichip dry run's world sharded over the one card
    t_d = time.perf_counter()
    d_rows = check_flow_sharded(torch, convert, floweng, ident)
    d_s = time.perf_counter() - t_d

    # (e) rings past 28957 slots, and grown there by the flow plan
    t_e = time.perf_counter()
    e_row = check_flow_large_rings(torch, floweng, flowplan, want, text,
                                   ident)
    e_s = time.perf_counter() - t_e

    bound_ms, bound_by = bench_bound_ms, "bytes"
    sched_batch, pull_cap = 8, 8
    a_bytes = 2 * flow_world_bytes(w0)
    row = dict(
        max_abs_err=max(r["max_abs_err"] for r in (
            *a_rows.values(), bench_row, rung3_row)),
        ms=f_ms, warm_ms=f_warm, cold_clean_ms=f_clean,
        plain_ms=bench_row["plain_s"][0] * 1e3,
        bound_ms=bound_ms, bound_by=bound_by, bytes=bench_bytes,
        share_of_bound=bound_ms / max(f_ms, 1e-9),
        a_ms=a_ms, a_warm_ms=a_warm, a_cold_clean_ms=a_clean,
        rung3_ms=r_ms, rung3_warm_ms=r_warm, rung3_cold_clean_ms=r_clean,
        grid=grid, chain=chain,
        a_plain_cpu_ms=a_rows["default"]["plain_s"][0] * 1e3,
        a_bytes=a_bytes,
        a_bound_ms=a_bytes / PEAK_BYTES_PER_S * 1e3,
        in_run_ms=run_ms, in_run_mean_ms=sum(run_ms) / len(run_ms),
        bench=out, bench_rep_wall_s=rep_s, bench_rates=rates, a=a_rows,
        bench_chunk=bench_row, rung3_chunks=rung3_row,
        rung3_wall_s=c_wall, rung3_resume_wall_s=r_wall,
        rung3_in_run_ms=c_ms, rung3_in_run_sum_ms=sum(c_ms),
        launches_bench=b_launches, launches_rung3=c_launches,
        sharded=d_rows, sharded_s=d_s,
        launches_sharded={n: r["launches"] for n, r in d_rows.items()},
        large_rings=e_row, large_rings_s=e_s,
        # the serial chain of a pair: both lanes' scheduled events and
        # pulls, 2 * (sched_batch + pull_cap) + 2 app phases a fused step
        chain_events_per_step=2 * (sched_batch + pull_cap) + 2,
        bench_max_steps_per_window=max_steps,
        phase_s=time.perf_counter() - t_all)
    record["flow_engine"] = row
    print(f"20 kernel F: {row['ms']:.5f} ms cold a chunk of bench_flows' "
          f"world, bound_ms={bound_ms:.5f} ({bound_by}, {bench_bytes} B: "
          f"the world read and written once) share="
          f"{row['share_of_bound']:.4f}; in-run mean "
          f"{row['in_run_mean_ms']:.4f} ms; max_abs_err "
          f"{row['max_abs_err']}; the serial chain: up to "
          f"{row['chain_events_per_step']} events a fused step, "
          f"{max_steps} steps in bench_flows' busiest window, the longest "
          f"pair of its first chunk {chain['bench']['events']} events; "
          f"library_ms=null; phase {row['phase_s']:.1f} s on {ident}")
    return row, b_launches, c_launches


def f_ring_bytes(world) -> int:
    """The bytes of a flow world's rings (q_time, q_fields)."""
    return nbytes([world.q_time, world.q_fields])


def check_flow_large_rings(torch, floweng, flowplan, want, rung3_text,
                           ident) -> dict:
    """Phase 20 (e): bench_flows' world (975 flows x 256 KiB) with rings
    of each of FLOW_Q_LARGE slots, run to completion: `GOLDEN_FLOW_DIGEST`
    and the same per-flow results; each launch's device ms; the first
    chunk timed cold, clean and warm at each Q, in turns, beside its bound
    by bytes. Then the rung-3 deployment with `capacity.max_doublings:
    FLOW_MAX_DOUBLINGS`, which a card once refused, equal to the JAX
    Manager's record; and again with ring drops added below FLOW_GROW_TO
    slots (`flow_run_grown`): every bucket's rings grown to FLOW_GROW_TO,
    F launched there, the record the JAX Manager's with those growths."""
    from shadow_tpu_torch.core.config import load_config_str
    from shadow_tpu_torch.tools import bench_flows, kernel_f_probe

    lats, sizes, _q, wus = bench_flows.default_world_args()
    worlds, runs = {}, {}
    for q in FLOW_Q_LARGE:
        w0 = floweng.make_flow_world(lats, sizes, queue_slots=q,
                                     device=FLOW_DEVICE)
        geo = floweng.f_geometry(w0)
        floweng.reset_launches()
        events = []

        def timed_chunk(w, cap, events=events):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            w2 = floweng.clone_world(w)
            torch.cuda._sleep(kernel_f_probe.SPIN_CYCLES)
            e0.record()
            floweng.flow_window_(w2, FLOW_CHUNK, wus,
                                 max_events_per_window=cap)
            e1.record()
            events.append((e0, e1))
            return w2, None

        t0 = time.perf_counter()
        w, sim_s, retries = floweng.run_to_completion(
            w0, wus, max_sim_s=40.0, chunk_windows=FLOW_CHUNK,
            probe_every=2, run_fn=timed_chunk)
        res = floweng.flow_results(w)
        wall = time.perf_counter() - t0
        ms = [e0.elapsed_time(e1) for e0, e1 in events]
        launches = floweng.LAUNCHES["flow_window"]
        if launches != len(events):
            fail(f"20 (e) Q={q}: {launches} launches of F for "
                 f"{len(events)} chunks")
        digest = bench_flows.results_digest(res)
        if digest != bench_flows.GOLDEN_FLOW_DIGEST:
            fail(f"20 (e) Q={q}: flow_results digest {digest} != "
                 "GOLDEN_FLOW_DIGEST")
        worlds[q] = w0
        runs[q] = dict(geometry=geo, sim_seconds=sim_s, retries=retries,
                       wall_s=wall, in_run_ms=ms, in_run_sum_ms=sum(ms),
                       launches=launches, ring_bytes=f_ring_bytes(w0),
                       res=res)
        del w
    a, b = (runs[q]["res"] for q in FLOW_Q_LARGE)
    for k in a:
        if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            fail(f"20 (e): flow_results[{k!r}] at Q={FLOW_Q_LARGE[1]} "
                 f"differs from Q={FLOW_Q_LARGE[0]}'s")
    # the first chunk, cold, clean and warm, the two Q in turns; its bound
    # by bytes: every leaf but the rings read and written once, and each
    # ring entry the chunk pushes (its 16 fields and its time) written
    # once and read once
    q0 = FLOW_Q_LARGE[0]
    first = floweng.clone_world(worlds[q0])
    floweng.flow_window_(first, FLOW_CHUNK, wus)
    pushed = int((first.n_segments - worlds[q0].n_segments).sum(
        dtype=torch.int64))
    del first
    times = {q: [] for q in worlds}
    for q in (*FLOW_Q_LARGE, *FLOW_Q_LARGE[::-1]):
        times[q].append(time_flow_chunk(torch, floweng, worlds[q],
                                        FLOW_CHUNK, wus))
    for q, w0 in worlds.items():
        r = runs[q]
        moved = 2 * (flow_world_bytes(w0) - f_ring_bytes(w0)) + \
            2 * pushed * (w0.q_fields.shape[2] + 1) * 4
        r.pop("res")
        r.update(chunk_ms=[dict(warm=t[0], cold=t[1], clean=t[2])
                           for t in times[q]],
                 chunk_bytes=moved,
                 chunk_bound_ms=moved / PEAK_BYTES_PER_S * 1e3)
        print(f"20 (e) bench_flows' world at Q={q} "
              f"({r['geometry']['blocks']} blocks of "
              f"{r['geometry']['pairs_a_block']} pairs, "
              f"{r['geometry']['smem_bytes']} B shared a block; rings "
              f"{r['ring_bytes']} B): digest == GOLDEN_FLOW_DIGEST in "
              f"{r['sim_seconds']} s simulated, {r['launches']} launches "
              f"({r['wall_s']:.2f} s wall), device ms a launch "
              f"{r['in_run_ms']} (sum {r['in_run_sum_ms']}); the first "
              f"chunk in turns {r['chunk_ms']} ms beside its bound "
              f"{r['chunk_bound_ms']:.5f} ms (bytes, {r['chunk_bytes']} B: "
              f"the world but its rings, and the {pushed} entries the chunk "
              f"pushes) on {ident}")
    print(f"20 (e) every per-flow result at Q={FLOW_Q_LARGE[1]} equals "
          f"Q={FLOW_Q_LARGE[0]}'s")
    del worlds
    torch.cuda.empty_cache()
    # the rung-3 deployment with the growth budget a card once refused
    cfg = load_config_str(f"capacity: {{max_doublings: {FLOW_MAX_DOUBLINGS}}}"
                          f"\n" + rung3_text)
    if cfg.capacity.max_doublings != FLOW_MAX_DOUBLINGS:
        fail("20 (e): the config's capacity section was not read")
    floweng.reset_launches()
    t0 = time.perf_counter()
    stats = flowplan.run_config(cfg, device=FLOW_DEVICE)
    r3_wall = time.perf_counter() - t0
    if flowplan.stats_record(stats) != want:
        fail(f"20 (e): rung 3 at capacity.max_doublings={FLOW_MAX_DOUBLINGS}"
             " differs from the JAX Manager's record")
    r3 = dict(max_doublings=FLOW_MAX_DOUBLINGS, wall_s=r3_wall,
              launches=floweng.LAUNCHES["flow_window"],
              capacity_events=list(stats.capacity_events))
    print(f"20 (e) rung 3 with capacity.max_doublings={FLOW_MAX_DOUBLINGS} "
          f"(rings up to {256 << FLOW_MAX_DOUBLINGS} slots allowed): runs, "
          f"record == the JAX Manager's ({len(stats.capacity_events)} ring "
          f"growths, {r3['launches']} F launches, {r3_wall:.2f} s wall) on "
          f"{ident}")
    # ... and grown there: the rings of every bucket double from 256 to
    # FLOW_GROW_TO, each size a fresh world and a re-run of the bucket
    t0 = time.perf_counter()
    stats, bucket_runs = flow_run_grown(floweng, flowplan, cfg, FLOW_DEVICE)
    grow_wall = time.perf_counter() - t0
    got = flowplan.stats_record(stats)
    events = got["stats"]["capacity_events"]
    got["stats"]["capacity_events"] = want["stats"]["capacity_events"]
    if got != want:
        fail("20 (e): rung 3 with its rings grown differs from the JAX "
             "Manager's record")
    if events != want["stats"]["capacity_events"] + flow_grown_events(
            flowplan, cfg):
        fail(f"20 (e): rung 3's ring growths {events} are not every "
             f"bucket's doublings from {flowplan.QUEUE_SLOTS0} to "
             f"{FLOW_GROW_TO}")
    top = [n for q, n in bucket_runs if q == FLOW_GROW_TO]
    if not top or min(top) <= 0:
        fail(f"20 (e): F's launches by ring size {bucket_runs}: none at "
             f"Q={FLOW_GROW_TO} in some bucket")
    r3.update(grown=dict(wall_s=grow_wall, growths=len(events),
                         runs_by_q=bucket_runs))
    print(f"20 (e) rung 3 with {FLOW_GROW_DROPS} ring drops added below "
          f"{FLOW_GROW_TO} slots: {len(events)} ring growths (every "
          f"bucket {flowplan.QUEUE_SLOTS0} -> {FLOW_GROW_TO}), F launches "
          f"by (Q, launches) {bucket_runs}, record == the JAX Manager's "
          f"but those growths ({grow_wall:.2f} s wall) on {ident}")
    return dict(runs={str(q): r for q, r in runs.items()}, pushed=pushed,
                rung3=r3)


def flow_run_grown(floweng, flowplan, config, device):
    """`run_config` with FLOW_GROW_DROPS ring drops added to the result
    of each bucket run whose rings hold fewer than FLOW_GROW_TO slots, so
    the flow plan grows every bucket's rings to FLOW_GROW_TO (no traffic
    of the TCP model does: a lane's ring holds its peer's window of
    segments and ACKs, a few hundred at most). Returns (stats, [(ring
    slots, F launches) for each bucket run])."""
    real_results, real_world = floweng.flow_results, flowplan.bucket_world
    marks = []

    def results(world):
        res = real_results(world)
        if world.q_time.shape[1] < FLOW_GROW_TO:
            res = dict(res, queue_drops=res["queue_drops"] + FLOW_GROW_DROPS)
        return res

    def bucket_world(plan, window_us, idx, queue_slots, dev):
        marks.append((queue_slots, floweng.LAUNCHES["flow_window"]))
        return real_world(plan, window_us, idx, queue_slots, dev)

    floweng.flow_results, flowplan.bucket_world = results, bucket_world
    try:
        stats = flowplan.run_config(config, device=device)
    finally:
        floweng.flow_results, flowplan.bucket_world = real_results, \
            real_world
    ends = [n for _q, n in marks[1:]] + [floweng.LAUNCHES["flow_window"]]
    return stats, [(q, end - n) for (q, n), end in zip(marks, ends)]


def flow_grown_events(flowplan, config) -> list:
    """The capacity events of `flow_run_grown(config)`: each bucket's
    rings doubled from flowplan.QUEUE_SLOTS0 to FLOW_GROW_TO, the buckets
    widest window first, as `run_flow_simulation` records them."""
    plan = flowplan.compile_flow_plan(config,
                                      flowplan.routing_from_config(config))
    out = []
    for window_us in sorted(flowplan.flow_buckets(plan), reverse=True):
        q = flowplan.QUEUE_SLOTS0
        while q < FLOW_GROW_TO:
            out.append({"kind": "capacity-growth",
                        "time_ns": config.general.stop_time,
                        "ring": "flow-queue", "from": q, "to": 2 * q,
                        "overflow": FLOW_GROW_DROPS, "plane": "floweng",
                        "bucket_window_us": window_us})
            q *= 2
    return out


class FlowKill(RuntimeError):
    """The simulated kill of a flow run (`flow_run_killed`)."""


def flow_run_killed(floweng, flowplan, config, ckpt_dir, device) -> bool:
    """`run_config` with checkpoints in `ckpt_dir`, killed where its
    second bucket starts: `floweng.run_to_completion` raises once the
    first bucket's `flow-progress` checkpoint exists. Returns whether
    the run was killed (a one-bucket run finishes)."""
    real = floweng.run_to_completion
    ckpt = os.path.join(ckpt_dir, "flow-progress")

    def killing(*args, **kw):
        if os.path.exists(ckpt):
            raise FlowKill(f"killed after the checkpoint {ckpt}")
        return real(*args, **kw)

    floweng.run_to_completion = killing
    try:
        flowplan.run_config(config, device=device, checkpoint_dir=ckpt_dir)
    except FlowKill:
        return True
    finally:
        floweng.run_to_completion = real
    return False


# phase 21: the device transport (tpu/transport.py) at rung-3 width
TX_HOSTS = 1000  # the rung-3 deployment's hosts
TX_CI = 256  # its in-flight slots a destination (tpu_ingress_cap)
TX_BATCH = 512  # an ingest batch's pad (the log's largest round: 383)
TX_K = 32  # windows a mirrored dispatch
TX_COMPACT = 4096  # tpu_compact_cap
TX_LOG = Path(__file__).resolve().parent / "shadow_tpu_torch" / \
    "workloads" / "rung3_transport.log.npz"
TX_DEVICE = "cuda"  # phase 21's device ("cpu" in a CPU rehearsal)


def tx_state(n, ci, seed):
    """A transport state (numpy): half the slots live with deliver times
    over 4 ms and a few at the top and bottom of int32, a full row (1)
    and an empty one (2), counters that keep the conservation law."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, ci)) < 0.5
    valid[1], valid[2] = True, False
    deliver = rng.integers(-50_000, 4_000_000, (n, ci))
    edge = rng.random((n, ci)) < 0.02
    deliver[edge] = rng.choice([2**31 - 3, -2**31, -2**31 + 7], edge.sum())
    deliver[~valid] = 2**31 - 1
    n_rel = rng.integers(0, 50, n)
    n_out = np.zeros(n, np.int64)
    n_out[0] = valid.sum() + n_rel.sum()
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(in_src=i32(rng.integers(0, n, (n, ci))),
                in_seq=i32(rng.integers(0, 2**31 - 1, (n, ci))),
                in_tag=i32(rng.integers(0, 2**31 - 1, (n, ci))),
                in_deliver=i32(deliver), in_valid=valid,
                n_overflow=np.zeros(n, np.int32), n_out=i32(n_out),
                n_released=i32(n_rel))


def tx_batch(n, b, seed, real):
    """An ingest batch: `real` live rows, a fifth of them for row 0 (past
    its free slots), three for the full row 1, two with an out-of-range
    destination; the pads' source out of range."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, b), rng.integers(0, n, b)
    h = real // 5
    dst[:h], dst[h:h + 3] = 0, 1
    dst[h + 3:h + 5] = n + 1
    send = rng.integers(0, 1_000_000, b)
    clamp = send + rng.integers(-300_000, 300_000, b)
    valid = np.arange(b) < real
    src[~valid] = n
    i32 = lambda a: np.asarray(a, np.int32)
    return [i32(src), i32(dst), i32(rng.integers(0, 2**31 - 1, b)),
            i32(rng.integers(0, 2**31 - 1, b)), i32(send), i32(clamp), valid]


def tx_functions(torch, transport, elastic, seed, grow: bool):
    """(a): `ingest_guarded`, `step_compact` (a negative shift), `chain`
    (64 windows) and `batch_verify` (TX_K windows, three poisoned) with
    guards and histograms on, on TX_DEVICE and on the CPU from the same
    numpy inputs: a TX_HOSTS x TX_CI state, or that state grown once
    (`grow`). The expected fingerprints are the CPU's. Returns {name:
    (device out, cpu out, warm device ms)}."""
    n = TX_HOSTS
    rng = np.random.default_rng(seed)
    lat = rng.integers(20_000_000, 200_000_000, (40, 40)).astype(np.int32)
    node = rng.integers(0, 40, n)
    st0 = tx_state(n, TX_CI, seed)
    spread = np.where(st0["in_valid"], 2_000_000 + 3_000 * rng.permutation(
        n * TX_CI).reshape(n, TX_CI), 2**31 - 1).astype(np.int32)
    cols = tx_batch(n, TX_BATCH, seed + 1, real=383)
    k_cols = [tx_batch(n, TX_BATCH, seed + 2 + i, real=int(rng.integers(
        0, 383))) for i in range(TX_K)]
    shifts = rng.integers(0, 400_000, TX_K).tolist()
    widths = rng.integers(0, 500_000, TX_K).tolist()
    names = ("src", "dst", "seq", "tag", "send", "clamp", "valid")

    def on(dev):
        t = lambda a: torch.from_numpy(np.array(a)).to(dev)
        st = transport.TransportState(**{f: t(v) for f, v in st0.items()})
        if grow:
            st = elastic.grow_transport_state(st, 2 * TX_CI)
        ch = st._replace(in_deliver=elastic._pad_cols(
            t(spread), st.in_valid.shape[1], 2**31 - 1))
        g = transport.make_transport_guard(dev)
        h = transport.make_transport_hist(n, dev)
        kw = dict(latency=t(lat), host_node=t(node))
        ing = {f: t(np.stack([c[i] for c in k_cols]))
               for i, f in enumerate(names)}
        return st, ch, g, h, kw, [t(c) for c in cols], ing

    # the true fingerprints of the TX_K windows (on the CPU), 3 poisoned
    _st, ch, _g, _h, kw, _c, ing = on("cpu")
    exp_np = np.zeros((3, TX_K), np.int64)
    for i in range(TX_K):
        ch, due, deliver, _ = transport.step(ch, shifts[i], widths[i])
        exp_np[:, i] = [int(v) for v in transport.fingerprint(
            ch, due, deliver)]
        ch, _ = transport.ingest(ch, None, *(ing[f][i] for f in names), **kw)
    exp_np[0, 3] ^= 1
    exp_np[1, 11] ^= 1
    exp_np[2, 17] += 1

    runs = {}
    for i, dev in enumerate((TX_DEVICE, "cpu")):
        st, ch, g, h, kw, c, ing = on(dev)
        exp = torch.from_numpy(exp_np).to(dev)
        div = torch.zeros((), dtype=torch.int32, device=dev)
        calls = {
            "ingest": lambda: transport.ingest_guarded(st, g, h, *c, **kw),
            "step_compact": lambda: transport.step_compact(
                st, g, h, -10_000_000, 1_000_000, cap=TX_COMPACT),
            "chain": lambda: transport.chain(
                ch, g, h, 0, 1_000_000, 0, 10**9, 10**9, cap=TX_COMPACT),
            "batch_verify": lambda: transport.batch_verify(
                ch, g, h, shifts, widths, ing, exp[0], exp[1],
                exp[2].to(torch.int32), div, **kw)}
        for name, fn in calls.items():
            out = fn()
            ms = None
            if i == 0 and not grow:
                ms = warm_ms(torch, fn)
            runs.setdefault(name, []).append((out, ms))
    return {name: (d[0], c[0], d[1]) for name, (d, c) in runs.items()}


def warm_ms(torch, fn, reps: int = 3) -> float:
    """Device ms a call of `fn`, called `reps` times back to back after
    a warm-up, between two CUDA events (a call that reads the host waits
    for the card there, so its span is in the time)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tx_leaves(torch, tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in tx_leaves(torch, t)]


def timed_transport(torch, transport, events: list):
    """The port's `DeviceTransport` with each dispatch between two CUDA
    events, appended to `events` as (kind, start, end)."""

    class Timed(transport.DeviceTransport):
        def _retrying(self, fn, what, *a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = super()._retrying(fn, what, *a, **k)
            e.record()
            events.append((what, s, e))
            return out

    return Timed


def dispatch_ms(torch, events) -> dict:
    """Dispatches and device ms a dispatch, by kind, of timed events."""
    torch.cuda.synchronize()
    by = {}
    for what, s, e in events:
        n, ms = by.get(what, (0, 0.0))
        by[what] = (n + 1, ms + s.elapsed_time(e))
    return {w: {"dispatches": n, "ms_per_dispatch": ms / n}
            for w, (n, ms) in by.items()}


TX_PROFILE_ROUNDS = 160  # (c): rounds of each replay under the profiler


def profile_transport(torch, replay, log, mode: str) -> dict:
    """(c): the card's kernels and busy ms a round over the first
    TX_PROFILE_ROUNDS rounds of a `mode` replay of `log` (torch.profiler;
    its wall time is not reported), and the six kernels that take the
    most device time, by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        replay.replay(log, mode, rounds=TX_PROFILE_ROUNDS, device=TX_DEVICE)
        torch.cuda.synchronize()
    on_card, out = card_work(prof, TX_PROFILE_ROUNDS)
    if not on_card:
        fail(f"phase 21 (c): the profiler recorded no device work in the "
             f"{mode} replay")
    by = {}
    for ev in on_card:
        n, us = by.get(ev.name, (0, 0.0))
        by[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:6]
    out["top_kernels"] = [{"name": k[:80], "launches": n, "ms": us / 1e3}
                          for k, (n, us) in top]
    return {k.replace("window", "round"): v for k, v in out.items()}


def check_transport(torch, record, ident):
    """Phase 21: the device transport. (a) its functions at rung-3 width
    on the card bitwise against the CPU, at CI=TX_CI and after one
    growth; (b) the rung-3 call log replayed in sync mode (every round
    against the JAX record) and mirrored mode (no divergence, JAX's
    verified windows and packets), and `mode="auto"`'s probe; (c) wall
    seconds and device ms a dispatch."""
    from shadow_tpu_torch.tools import transport_replay as replay
    from shadow_tpu_torch.tpu import elastic, transport

    t_all = time.perf_counter()
    rows, div = {}, None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU reference: small ops, one thread
    try:
        outs = [tx_functions(torch, transport, elastic, 21, grow)
                for grow in (False, True)]
    finally:
        torch.set_num_threads(threads)
    for grow, out in zip((False, True), outs):
        ci = 2 * TX_CI if grow else TX_CI
        for name, (dev_out, cpu_out, ms) in out.items():
            a = [x.cpu() for x in tx_leaves(torch, dev_out)]
            b = tx_leaves(torch, cpu_out)
            err = max_abs_err(torch, a, b)
            if err or len(a) != len(b):
                fail(f"phase 21 (a): {name} at CI={ci} differs from the CPU "
                     f"(max abs err {err})")
            rows[f"{name}@{ci}"] = {"device_ms": ms, "max_abs_err": err}
            if name == "batch_verify":
                div = int(dev_out[3])
                if div != 3:
                    fail(f"phase 21 (a): batch_verify at CI={ci} counted "
                         f"{div} diverged windows of the 3 poisoned")
            if name == "chain" and int(dev_out[1].windows) != 64:
                fail("phase 21 (a): the chain did not run 64 windows")
    t_a = time.perf_counter() - t_all
    print(f"21 (a) transport functions at N={TX_HOSTS}, CI={TX_CI} and "
          f"grown to {2 * TX_CI}, on the card bitwise the CPU (guards and "
          f"histograms on; warm device ms by CUDA events): "
          + ", ".join(f"{k} {v['device_ms']:.4f}" for k, v in rows.items()
                      if v["device_ms"] is not None)
          + f"  [{ident}]")

    log = replay.load_log(str(TX_LOG))
    meta = log["meta"]
    runs = {}
    for mode in ("sync", "mirrored"):
        events = []
        cls = timed_transport(torch, transport, events)
        make = lambda hosts, routing, mode, **kw: cls(
            hosts, routing, None, mode=mode, device=TX_DEVICE, **kw)
        try:
            out = replay.replay(log, mode, make_transport=make)
        except replay.Mismatch as e:
            fail(f"phase 21 (b): the {mode} replay of the rung-3 log: {e}")
        out.pop("transport")
        if mode == "sync":
            untagged = out.pop("untagged_digests")
        else:
            out.pop("untagged_digests")
        out["device"] = dispatch_ms(torch, events)
        runs[mode] = out
        print(f"21 (b) rung-3 log, {mode}: {out['rounds']} rounds, "
              f"{out['captures']} captures, {out['dispatches']} dispatches "
              f"in {out['wall_s']:.3f} s wall; divergence "
              f"{out['divergence_count']}, verified "
              f"{out['verified_windows']} windows / "
              f"{out['verified_packets']} packets (JAX "
              f"{meta['mirrored']['verified_windows']} / "
              f"{meta['mirrored']['verified_packets']}); device ms a "
              f"dispatch {json.dumps(out['device'])}  [{ident}]")
    if runs["sync"]["rounds"] != meta["rounds"] or \
            runs["sync"]["captures"] != meta["captures"]:
        fail("phase 21 (b): the sync replay did not run the whole log")
    t_b = time.perf_counter() - t_all - t_a
    # the sync replay, the mode auto picks on the card
    prof = profile_transport(torch, replay, log, "sync")
    runs["sync"]["profile"] = prof
    wall_ms = runs["sync"]["wall_s"] * 1e3 / runs["sync"]["rounds"]
    print(f"21 (c) sync replay, rounds 0-{TX_PROFILE_ROUNDS - 1} under "
          f"torch.profiler: {prof['kernel_launches_per_round']:.1f} device "
          f"kernels and {prof['device_busy_ms_per_round']:.5f} ms busy a "
          f"round (the whole replay's wall: {wall_ms:.5f} ms a round); the "
          f"most device time: {json.dumps(prof['top_kernels'])}  [{ident}]")
    hosts = [replay._Host(i + 1, int(nd), [])
             for i, nd in enumerate(log["host_node"])]
    auto = transport.DeviceTransport(hosts, replay._Routing(log["latency"]),
                                     None, mode="auto", device=TX_DEVICE,
                                     **replay.transport_kwargs(meta))
    print(f"21 (b) mode=auto: D2H probe {auto.d2h_probe_ms:.4f} ms -> "
          f"{auto.mode}  [{ident}]")
    phase_s = time.perf_counter() - t_all
    row = {"functions": rows, "replay": runs,
           "auto": {"d2h_probe_ms": auto.d2h_probe_ms, "mode": auto.mode},
           "phase_s": phase_s, "part_s": {"a": t_a, "b": t_b,
                                          "c": phase_s - t_a - t_b},
           "gpu": ident}
    record["transport"] = row
    print(f"21 device transport: sync {runs['sync']['wall_s']:.3f} s, "
          f"mirrored {runs['mirrored']['wall_s']:.3f} s for "
          f"{meta['rounds']} rounds and {meta['captures']} captures; phase "
          f"{phase_s:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) and the "
          f"probe {phase_s - t_a - t_b:.1f})  [{ident}]")
    return row, untagged


# -- phase 22: the simulator's own entry point --------------------------------
#
# `python -m shadow_tpu_torch CONFIG` (`cli.main` -> `core/manager.Manager`
# -> hosts, the simulated TCP/UDP stack and the built-in apps on the CPU,
# packets crossing hosts through the port's device transport on the card),
# run in this process; each CPU witness is the same CLI with `--device cpu`
# and the CPU routing, in the witness pool.

EXAMPLES = Path(__file__).resolve().parent / "examples"
QUICKSTART = ("basic-file-transfer", "phold")  # examples/ on the card
TX_MODES = ("sync", "mirrored")
RUNG3_LIVE_STOP = "15s"  # (b): every client has started by 11 s
CLI_TRANSPORT = ("experimental: {{use_tpu_transport: true, "
                 "tpu_transport_mode: {mode}}}")
CLI_CPU_ROUTING = "experimental: {}"
# what a CPU-routing witness's processed-config.yaml lacks of the card
# run's: the transport's switch and mode
TRANSPORT_KEYS = ("use_tpu_transport", "tpu_transport_mode")


def with_experimental(text: str, line: str) -> str:
    """A config's text with its one-line `experimental:` mapping replaced
    by `line`, or `line` appended where it has none."""
    out, n = re.subn(r"(?m)^experimental:.*$", line, text)
    if n > 1 or (n and not re.search(r"(?m)^experimental:\s*\{", text)):
        raise ValueError("the config's experimental: block is not one "
                         "inline mapping")
    return out if n else text.rstrip("\n") + "\n" + line + "\n"


def run_cli(argv, managers=None) -> int:
    """The port's CLI (`cli.main`) in this process, warnings and worse
    logged; returns its exit code. The log handler it installs is closed
    after the run. Each Manager it builds is appended to `managers`."""
    import logging

    from shadow_tpu_torch import cli

    logger = logging.getLogger("shadow_tpu_torch")
    before = list(logger.handlers)
    orig = cli.Manager
    if managers is not None:
        class Kept(orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                managers.append(self)

        cli.Manager = Kept
    try:
        return cli.main([*map(str, argv), "--log-level", "warning"])
    finally:
        cli.Manager = orig
        for h in list(logger.handlers):
            if h not in before:
                logger.removeHandler(h)
                h.close()


def data_dir_contents(path) -> dict:
    """A CLI data directory file by file (relative path -> bytes), with
    sim-stats.json parsed less its wall_seconds and processed-config.yaml
    parsed less general.data_directory."""
    import yaml

    out = {}
    for f in sorted(Path(path).rglob("*")):
        if not f.is_file():
            continue
        rel = f.relative_to(path).as_posix()
        if rel == "sim-stats.json":
            d = json.loads(f.read_text())
            d.pop("wall_seconds")
        elif rel == "processed-config.yaml":
            d = yaml.safe_load(f.read_text())
            d["general"].pop("data_directory")
        else:
            d = f.read_bytes()
        out[rel] = d
    return out


def cli_witness(text: str, stop=None) -> dict:
    """The port's CLI on config `text` with `--device cpu` (and
    `--stop-time stop`): its exit code and data directory."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "config.yaml"
        cfg.write_text(text)
        argv = [cfg, "-d", Path(tmp) / "data", "--device", "cpu"]
        rc = run_cli(argv + (["--stop-time", stop] if stop else []))
        return {"rc": rc, "data": data_dir_contents(Path(tmp) / "data")}


def quickstart_text(name: str) -> str:
    return (EXAMPLES / f"{name}.yaml").read_text()


def rung3_live_text() -> str:
    from shadow_tpu_torch.core import flowplan

    return flowplan.RUNG3_YAML.read_text()


def same_data_dirs(card: dict, cpu: dict, what: str,
                   config_less=TRANSPORT_KEYS, stats_less=()) -> None:
    """A card run's data directory against its CPU witness's: every file
    equal (sim-stats.json but its wall_seconds and `stats_less`), the
    processed config but the `config_less` keys of `experimental` (by
    default the transport's, which a CPU-routing witness lacks)."""
    if card.keys() != cpu.keys():
        fail(f"{what}: the data directories hold {sorted(card)} on the "
             f"card and {sorted(cpu)} on the CPU")
    for rel in card:
        a, b = card[rel], cpu[rel]
        if rel == "processed-config.yaml":
            a, b = (dict(d, experimental={
                k: v for k, v in d["experimental"].items()
                if k not in config_less}) for d in (a, b))
        if rel == "sim-stats.json":
            a, b = ({k: v for k, v in d.items() if k not in stats_less}
                    for d in (a, b))
        if a != b:
            fail(f"{what}: {rel} differs from the CPU witness's")


def quickstart_card_runs() -> list[dict]:
    """22 (a)'s card runs: each of QUICKSTART through the port's CLI with
    the device transport on TX_DEVICE, in sync and mirrored mode. Returns
    a row a run: its exit code, data directory, wall seconds, kernel
    launches and the transport's device, mode, dispatches, divergence,
    packets in flight and verified windows and packets."""
    from shadow_tpu_torch.tpu import floweng, pipeline

    runs = []
    for name in QUICKSTART:
        for mode in TX_MODES:
            text = with_experimental(quickstart_text(name),
                                     CLI_TRANSPORT.format(mode=mode))
            with tempfile.TemporaryDirectory() as tmp:
                cfg = Path(tmp) / "config.yaml"
                cfg.write_text(text)
                mgrs = []
                pipeline.reset_launches()
                floweng.reset_launches()
                t0 = time.perf_counter()
                rc = run_cli([cfg, "-d", Path(tmp) / "data"], mgrs)
                wall = time.perf_counter() - t0
                data = data_dir_contents(Path(tmp) / "data")
            (mgr,) = mgrs
            tr = mgr.transport
            runs.append(dict(
                name=name, mode=mode, rc=rc, data=data, wall_s=wall,
                launches={k: v for k, v in {**pipeline.LAUNCHES,
                                            **floweng.LAUNCHES}.items() if v},
                transport=None if tr is None else dict(
                    device=tr.device.type, mode=tr.mode,
                    dispatches=tr.dispatches,
                    divergence=tr.divergence_count, in_flight=tr.in_flight,
                    verified_windows=tr.verified_windows,
                    verified_packets=tr.verified_packets)))
    return runs


def runs_child(fn: str, out: str, *args) -> None:
    """A phase's card runs (`fn(*args)`, a function of this module
    returning rows: `quickstart_card_runs`, `managed_card_runs`,
    `ladder_card_runs`) in a child process, pickled to `out`."""
    import pickle

    runs = globals()[fn](*args)
    with open(out, "wb") as fh:
        pickle.dump(runs, fh)


def start_runs_beside(tag: str, fn: str, tmp: Path, *args: str):
    """Start `fn(*args)`'s card runs in a child process (beside 22 (b):
    22 (a)'s, 23's and 24's are host-bound and time nothing on the card
    that is compared, the host has cores to spare by then, and a fresh
    process spawns its helpers cheaply); returns (wait, kill): `wait()`
    waits for them and returns their rows, failing phase `tag` if the
    child did, `kill()` stops the child if it still runs."""
    import pickle

    name = "-".join((fn, *args))
    out = tmp / f"{name}.pickle"
    log = tmp / f"{name}.log"
    call = ", ".join(map(repr, (fn, str(out), *args)))
    children = {fn: (*start_child(
        f"import chip_smoke as c; c.runs_child({call})", HERE, log), log)}

    def wait() -> list[dict]:
        rc, text = wait_children(children)[fn]
        if rc != 0:
            fail(f"{tag}: the card runs' child exited {rc}:\n"
                 f"{text[-3000:]}")
        with open(out, "rb") as fh:
            return pickle.load(fh)

    return wait, lambda: kill_children(children)


def check_quickstart(torch, record, ident, runs):
    """22 (a): the card runs of `quickstart_card_runs` (`runs`): exit 0,
    the data directory the CPU routing's (a witness), the transport on
    the card in the mode asked, no divergence, nothing in flight, no
    kernel launched."""
    rows = {}
    # a witness a config, awaited once (the pool hands each result out
    # once; a second call would run it again in this process)
    witnesses = {name: witness(f"cli:{name}") for name in QUICKSTART}
    for run in runs:
        name, mode, tr = run["name"], run["mode"], run["transport"]
        what = f"22 (a) {name} ({mode})"
        cpu = witnesses[name]
        if cpu["rc"] != 0:
            fail(f"22 (a): the CPU witness of {name} exited {cpu['rc']}")
        if run["rc"] != 0 or tr is None or tr["device"] != TX_DEVICE:
            fail(f"{what}: exit {run['rc']}, transport {tr}")
        if tr["mode"] != mode or tr["divergence"] or tr["in_flight"]:
            fail(f"{what}: {tr}")
        same_data_dirs(run["data"], cpu["data"], what)
        if run["launches"]:
            fail(f"{what} launched {run['launches']}")
        stats = run["data"]["sim-stats.json"]
        rows[f"{name}:{mode}"] = dict(
            wall_s=run["wall_s"], rounds=stats["rounds"],
            packets=stats["packets_sent"], **tr)
        print(f"{what}: exit 0, the data directory the CPU routing's "
              f"(sim-stats less wall_seconds, etc-hosts, the config less "
              f"the transport's keys); {stats['rounds']} rounds, "
              f"{stats['packets_sent']} packets, {tr['dispatches']} "
              f"dispatches, divergence 0, verified {tr['verified_windows']}"
              f" windows / {tr['verified_packets']} packets; "
              f"{run['wall_s']:.2f} s wall  [{ident}]")
    record["quickstart"] = rows
    return rows


def rung3_live(torch, record, ident, stop=RUNG3_LIVE_STOP, untagged=None,
               cpu=None):
    """22 (b): rung 3 (1000 hosts, 975 tgen clients of 256 KiB) under the
    port's Manager through its CLI, the device transport in sync mode on
    the card, to `stop` (None: the config's 120 s), its calls recorded
    (`transport_replay.recording_class`): every release but the last
    equal to the committed call log's round for round (push count, push
    rows as a set less their pool tags against `untagged`, a sync
    replay's, and next event; the replay runs here when not given). At
    120 s, all of the log's releases and its stats; else its sim-stats
    equal to the witness named `cpu` (the CPU routing's run to `stop`),
    if given."""
    from shadow_tpu_torch.tools import transport_replay as replay
    from shadow_tpu_torch.tpu import transport

    log = replay.load_log(str(TX_LOG))
    if untagged is None:
        untagged = replay.replay(log, "sync",
                                 device=TX_DEVICE)["untagged_digests"]
    text = with_experimental(rung3_live_text(),
                             CLI_TRANSPORT.format(mode="sync"))
    sink, mgrs = [], []
    orig = transport.DeviceTransport
    transport.DeviceTransport = replay.recording_class(sink)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = Path(tmp) / "config.yaml"
            cfg.write_text(text)
            t0 = time.perf_counter()
            rc = run_cli([cfg, "-d", Path(tmp) / "data"]
                         + (["--stop-time", stop] if stop else []), mgrs)
            wall = time.perf_counter() - t0
            card = data_dir_contents(Path(tmp) / "data")
    finally:
        transport.DeviceTransport = orig
    (tr,) = sink
    if tr.device.type != TX_DEVICE:
        fail(f"22 (b): the transport ran on {tr.device}")
    stats = card["sim-stats.json"]
    n_rel = len(tr.log.rel)
    whole = stop is None
    try:
        compared = replay.compare_releases(
            tr.log, log, rounds=n_rel if whole else n_rel - 1,
            untagged=untagged)
    except replay.Mismatch as e:
        fail(f"22 (b): rung 3 live to {stop or '120s'}: {e}")
    if whole:
        want = log["meta"]["stats"]
        got = {"rounds": stats["rounds"],
               "packets_sent": stats["packets_sent"],
               "packets_dropped": stats["packets_dropped"],
               "process_failures": len(stats["process_failures"])}
        if compared != len(log["rel"]) or got != want or rc != 0:
            fail(f"22 (b): rung 3 live to 120 s: {compared} releases of "
                 f"{len(log['rel'])}, stats {got} (exit {rc}), the log's "
                 f"{want}")
    elif cpu is not None:
        cpu = witness(cpu)
        if rc != cpu["rc"] or stats != cpu["data"]["sim-stats.json"]:
            fail(f"22 (b): rung 3 live to {stop}: exit {rc} and its "
                 f"sim-stats differ from the CPU routing's (exit "
                 f"{cpu['rc']})")
    row = dict(stop=stop or "120s", releases=n_rel, compared=compared,
               rounds=stats["rounds"], packets=stats["packets_sent"],
               dropped=stats["packets_dropped"],
               captures=len(tr.log.caps), dispatches=tr.dispatches,
               wall_s=wall, exit=rc, gpu=ident)
    record["rung3_live"] = row
    print(f"22 (b) rung 3 live to {row['stop']} (1000 hosts, the port's "
          f"Manager, sync transport on the card): {stats['rounds']} rounds, "
          f"{stats['packets_sent']} packets ({stats['packets_dropped']} "
          f"dropped), {len(tr.log.caps)} captures, {tr.dispatches} "
          f"dispatches, {wall:.2f} s wall; releases 0-{compared - 1} of "
          f"{n_rel} equal to the committed log's (push count, rows as a "
          f"set less pool tags, next event)"
          + ("; stats the log's" if whole else
             "; sim-stats the CPU routing's" if cpu is not None else "")
          + f"  [{ident}]")
    return row


def check_flow_cli(torch, record, ident):
    """22 (c): `python -m shadow_tpu_torch` on the rung-3 flow-engine
    deployment (kernel F on the card), its stats record the JAX
    Manager's committed one."""
    from shadow_tpu_torch.core import flowplan
    from shadow_tpu_torch.tpu import floweng

    want = json.loads(flowplan.RUNG3_RECORD.read_text())
    want.pop("source")
    mgrs = []
    floweng.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = run_cli([flowplan.RUNG3_YAML, "-d", Path(tmp) / "data"], mgrs)
        wall = time.perf_counter() - t0
        card = data_dir_contents(Path(tmp) / "data")
    launches = floweng.LAUNCHES["flow_window"]
    (mgr,) = mgrs
    got = flowplan.stats_record(mgr.stats)
    if got != want or rc != 0 or launches == 0:
        fail(f"22 (c): the flow engine through the CLI: exit {rc}, "
             f"{launches} launches of F, record {got} != {want}")
    if card["sim-stats.json"]["rounds"] != want["stats"]["rounds"]:
        fail("22 (c): sim-stats.json disagrees with the run's stats")
    record["flow_cli"] = dict(wall_s=wall, launches=launches)
    print(f"22 (c) rung 3 on the flow engine through `python -m "
          f"shadow_tpu_torch`: exit 0, record == the JAX Manager's, "
          f"{launches} launches of F, {wall:.2f} s wall  [{ident}]")
    return launches


# -- phase 23: managed native processes --------------------------------------
#
# Real executables under the port's interposition shim (`interpose/`, built
# from the checkout into `_build_out/`) and syscall handler, through `python
# -m shadow_tpu_torch CONFIG`, their packets crossing the device transport on
# the card; each CPU witness is the same CLI with `--device cpu` and the same
# transport keys, in the witness pool.

HERE = Path(__file__).resolve().parent
MANAGED_TESTS = HERE / "tests" / "test_managed_network.py"
# (b): rung 4 at its full shape (tools/bench_ladder.py's defaults)
RUNG4 = dict(n_relays=66, n_clients=33, n_nodes=10, size=32_768)
TCP_SIZE = 1_048_576  # (c): test_managed_network.py's first transfer
MANAGED_CONFIGS = ("rung4", "tcp")
MANAGED_MODES = ("cpu", *TX_MODES)  # the CPU routing, then the transport
# (d): a shell whose stdio redirects must cross its execve, on the CPU
# routing: appended (carried on any kernel) and at offsets that matter
# (carried where the kernel gives pidfd_getfd or fdinfo offsets; the card
# machine's gives neither, and there the exec must fail, named)
EXEC_CONFIGS = ("exec-append", "exec-redirect")
MANAGED_CARD_RUNS = (*((c, m) for c in MANAGED_CONFIGS for m in TX_MODES),
                     *((c, "cpu") for c in EXEC_CONFIGS))


def managed_test_sources() -> dict[str, str]:
    """SERVER_C and CLIENT_C of tests/test_managed_network.py, read from
    the file's text (the test module imports the JAX package, so it is
    parsed here, never imported)."""
    import ast

    want = {"SERVER_C": "tserver", "CLIENT_C": "tclient"}
    out = {}
    for node in ast.parse(MANAGED_TESTS.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in want:
            out[want[node.targets[0].id]] = ast.literal_eval(node.value)
    if len(out) != len(want):
        fail(f"phase 23: {MANAGED_TESTS} lacks {sorted(want)}")
    return out


def built_once(prefix: str, key, fill) -> Path:
    """A directory of `_build_out/` named by `prefix` and a hash of `key`
    (as JSON), filled by `fill(directory)` once, by whichever process
    comes first (a temporary directory renamed into place whole).
    Returns it."""
    import hashlib
    import shutil

    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode())
    out = HERE / "shadow_tpu_torch" / "_build_out" / \
        f"{prefix}-{digest.hexdigest()[:16]}"
    if out.is_dir():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=out.name + ".", dir=out.parent))
    try:
        fill(tmp)
        try:
            tmp.rename(out)
        except OSError:
            if not out.is_dir():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def managed_programs() -> Path:
    """Rung 4's relay and client (`tools/onion/*.c`) and the TCP pair,
    compiled with `gcc -O1` into a directory of `_build_out/` named by a
    hash of their sources, once (`built_once`). Returns it."""
    from shadow_tpu_torch.workloads import rung4

    tcp = managed_test_sources()
    sources = {n: (rung4.ONION_SOURCES / f"{n}.c").read_text()
               for n in rung4.PROGRAMS}

    def fill(tmp: Path):
        rung4.compile_onion(tmp)
        for name, text in tcp.items():
            (tmp / f"{name}.c").write_text(text)
            subprocess.run(["gcc", "-O1", "-o", str(tmp / name),
                            str(tmp / f"{name}.c")], check=True,
                           capture_output=True, text=True)

    return built_once("programs", [sources, tcp], fill)


def exec_text(config: str) -> str:
    """23 (d)'s configs: one host whose shell execs `cat` with its stdio
    redirected, as `EXEC_APPEND` and `EXEC_REDIRECT` of
    tests/test_torch_managed.py. "exec-append": stdout and stderr
    appended (out.txt must read "headbody"); "exec-redirect": stdin from
    a file, stdout at the offset the shell's own write left it, stderr
    appended (out.txt "headbodybody"). cat exits 1: one of its files is
    missing."""
    import shutil

    sh, cat = shutil.which("sh"), shutil.which("cat")
    if sh is None or cat is None:
        fail("23 (d): no sh or no cat binary")
    script = "printf body > in.txt; printf old > err.txt; " + (
        f"printf head > out.txt; exec {cat} in.txt nope >> out.txt "
        "2>> err.txt" if config == "exec-append" else
        f"{{ printf head; exec {cat} - in.txt nope; }} < in.txt > out.txt "
        "2>> err.txt")
    return f"""general: {{stop_time: 10s, seed: 3}}
network: {{graph: {{type: 1_gbit_switch}}}}
hosts:
  box:
    network_node_id: 0
    processes:
    - {{path: {sh}, args: ["-c", "{script}"], start_time: 1s,
       expected_final_state: {{exited: 1}}}}
"""


def stdio_offsets_seen() -> bool:
    """Whether this kernel lets the simulator carry a redirect whose
    offset matters across an execve: pidfd_open works (pidfd_getfd), or
    /proc/<pid>/fdinfo gives `pos`."""
    from shadow_tpu_torch.process import managed

    try:
        os.close(os.pidfd_open(os.getpid()))
        return True
    except OSError:
        return "pos" in managed._fdinfo(os.getpid(), 1)


def managed_text(config: str, mode: str) -> str:
    """Phase 23's config `config` (of MANAGED_CONFIGS or EXEC_CONFIGS) with the CPU
    routing (`mode` "cpu") or the device transport in `mode`."""
    from shadow_tpu_torch.workloads import rung4

    programs = managed_programs()
    if config in EXEC_CONFIGS:
        text = exec_text(config)
    elif config == "rung4":
        text = rung4.rung4_text(programs, **RUNG4)
    else:
        text = f"""general: {{stop_time: 60s, seed: 11}}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_up "100 Mbit" host_bandwidth_down "100 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.02 ]
      ]
hosts:
  server:
    network_node_id: 0
    ip_addr: 11.0.0.1
    processes:
    - {{path: {programs / 'tserver'}, args: ["8080", "{TCP_SIZE}"],
       start_time: 1s, expected_final_state: {{exited: 0}}}}
  client:
    network_node_id: 0
    ip_addr: 11.0.0.2
    processes:
    - {{path: {programs / 'tclient'}, args: ["11.0.0.1", "8080",
       "{TCP_SIZE}"], start_time: 2s, expected_final_state: {{exited: 0}}}}
"""
    line = (CLI_CPU_ROUTING if mode == "cpu"
            else CLI_TRANSPORT.format(mode=mode))
    return with_experimental(text, line)


def managed_witness(config: str, mode: str) -> dict:
    """The CPU witness of a phase-23 run: the CLI with `--device cpu`,
    its spawns and syscall dispatches counted (`managed_counters`)."""
    text = managed_text(config, mode)
    with managed_counters() as counts:
        out = cli_witness(text)
    return dict(out, counts=counts)


@contextlib.contextmanager
def managed_counters():
    """Count, while open, the managed processes' spawns (each native
    launch: IPC channel, clock block, the spawn helper's exec, the death
    watcher) and syscall dispatches (each trapped syscall the simulator
    answers over the shim's IPC channel), with their host seconds, summed
    over the worker threads."""
    import threading

    from shadow_tpu_torch.process import managed

    cls = managed.ManagedSimProcess
    lock = threading.Lock()
    counts = dict(spawns=0, spawn_s=0.0, syscalls=0, syscall_s=0.0)

    def counted(fn, n, s):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    counts[n] += 1
                    counts[s] += dt
        return wrapper

    orig = (cls._launch_native, cls._handle_syscall_event)
    cls._launch_native = counted(orig[0], "spawns", "spawn_s")
    cls._handle_syscall_event = counted(orig[1], "syscalls", "syscall_s")
    try:
        yield counts
    finally:
        cls._launch_native, cls._handle_syscall_event = orig


@contextlib.contextmanager
def kept_warnings(word: str):
    """While open, the messages of the port's warnings and worse that
    name `word`, in a list."""
    import logging

    kept = []

    class Kept(logging.Handler):
        def emit(self, record):
            if word in record.getMessage():
                kept.append(record.getMessage())

    handler = Kept(logging.WARNING)
    logger = logging.getLogger("shadow_tpu_torch")
    logger.addHandler(handler)
    try:
        yield kept
    finally:
        logger.removeHandler(handler)


def managed_card_runs() -> list[dict]:
    """Phase 23's card runs: each of MANAGED_CONFIGS through the port's
    CLI with the device transport on TX_DEVICE, in sync and mirrored
    mode, and each of EXEC_CONFIGS (no transport). Returns a row a run:
    its exit code, data directory, wall seconds, kernel launches, managed
    processes, spawns and syscall dispatches (`managed_counters`), the
    warnings that name execve, and the transport's device, mode,
    dispatches, divergence, packets in flight and verified windows and
    packets."""
    from shadow_tpu_torch.tpu import floweng, pipeline

    runs = []
    for config, mode in MANAGED_CARD_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = Path(tmp) / "config.yaml"
            cfg.write_text(managed_text(config, mode))
            mgrs = []
            pipeline.reset_launches()
            floweng.reset_launches()
            with managed_counters() as counts, \
                    kept_warnings("execve") as warnings:
                t0 = time.perf_counter()
                rc = run_cli([cfg, "-d", Path(tmp) / "data"], mgrs)
                wall = time.perf_counter() - t0
            launches = {k: v for k, v in {**pipeline.LAUNCHES,
                                          **floweng.LAUNCHES}.items()
                        if v}
            data = data_dir_contents(Path(tmp) / "data")
        (mgr,) = mgrs
        tr = mgr.transport
        runs.append(dict(
            config=config, mode=mode, rc=rc, data=data, wall_s=wall,
            launches=launches, processes=len(mgr._spawned),
            counts=dict(counts), warnings=warnings,
            transport=None if tr is None else dict(
                device=tr.device.type, mode=tr.mode,
                dispatches=tr.dispatches,
                divergence=tr.divergence_count, in_flight=tr.in_flight,
                verified_windows=tr.verified_windows,
                verified_packets=tr.verified_packets)))
    return runs


def check_managed(torch, record, ident, built, runs=None):
    """Phase 23: (a) the port's interposition libraries and the programs
    (`built`: `build_managed`'s result and seconds); (b) rung 4 at its
    full shape and (c) the TCP pair of tests/test_managed_network.py
    through the CLI with the device transport on the card in sync and
    mirrored mode (`runs`, `managed_card_runs`' rows; run here when not
    given), each equal to its CPU witness, the transport witnesses'
    packets the CPU routing's; no kernel of A-F launched; (d) a shell's
    stdio redirects across its execve (`check_exec`)."""
    from shadow_tpu_torch.workloads import rung4

    (lib_dir, programs), build_s = built
    print(f"23 (a) the port's interposition libraries built into "
          f"{Path(lib_dir).relative_to(HERE)} and the programs into "
          f"{programs.relative_to(HERE)} with g++/gcc beside the phases: "
          f"{build_s:.2f}s")
    if runs is None:
        runs = managed_card_runs()
    rows = {"build_s": build_s}
    routings = {c: witness(f"managed:{c}:cpu") for c in MANAGED_CONFIGS}
    for run in runs:
        config, mode, tr = run["config"], run["mode"], run["transport"]
        if config in EXEC_CONFIGS:
            rows[config] = check_exec(run, ident)
            continue
        part = "23 (b) rung 4" if config == "rung4" else "23 (c) TCP pair"
        what = f"{part} ({mode})"
        routing = routings[config]
        if routing["rc"] != 0:
            fail(f"{part}: the CPU routing's witness exited {routing['rc']}")
        cpu = witness(f"managed:{config}:{mode}")
        if cpu["rc"] != 0:
            fail(f"{what}: the CPU witness exited {cpu['rc']}")
        cs, rs = (d["sim-stats.json"] for d in (cpu["data"],
                                                routing["data"]))
        if (cs["packets_sent"], cs["packets_dropped"]) != \
                (rs["packets_sent"], rs["packets_dropped"]):
            fail(f"{what}: the witness's packets {cs['packets_sent']} / "
                 f"{cs['packets_dropped']} dropped are not the CPU "
                 f"routing's {rs['packets_sent']} / {rs['packets_dropped']}")
        host_files = lambda d: {k: v for k, v in d.items()
                                if k.startswith("hosts/") or k == "etc-hosts"}
        same_data_dirs(host_files(cpu["data"]), host_files(routing["data"]),
                       f"{what}: the transport witness against the CPU "
                       f"routing's")
        card, counts = run["data"], run["counts"]
        stats = card["sim-stats.json"]
        if run["rc"] != 0 or stats["process_failures"]:
            fail(f"{what}: exit {run['rc']}, process failures "
                 f"{stats['process_failures']}")
        if tr is None or tr["device"] != TX_DEVICE or tr["mode"] != mode:
            fail(f"{what}: the transport ran {tr}")
        if tr["divergence"] or tr["in_flight"]:
            fail(f"{what}: divergence {tr['divergence']}, "
                 f"{tr['in_flight']} packets in flight")
        if run["launches"]:
            fail(f"{what} launched {run['launches']}")
        if config == "rung4":
            lines = [card.get(f"hosts/client{c}/client{c}.client.0.stdout")
                     for c in range(RUNG4["n_clients"])]
            bad = [c for c, ln in enumerate(lines)
                   if ln != rung4.circuit_line(RUNG4["size"])]
            if bad:
                fail(f"{what}: clients {bad} did not complete their "
                     f"circuits")
        if counts["spawns"] != run["processes"]:
            fail(f"{what}: {counts['spawns']} spawns of {run['processes']} "
                 f"managed processes")
        # sim-stats less rounds: two runs of one package differ there (a
        # managed process's death reaches the Manager from a watcher
        # thread, at a round the wall clock picks)
        same_data_dirs(card, cpu["data"], what, config_less=(),
                       stats_less=("rounds",))
        rows[f"{config}:{mode}"] = dict(
            wall_s=run["wall_s"], rounds=stats["rounds"],
            witness_rounds=cs["rounds"], packets=stats["packets_sent"],
            dropped=stats["packets_dropped"], dispatches=tr["dispatches"],
            verified_windows=tr["verified_windows"],
            verified_packets=tr["verified_packets"], **counts,
            witness_counts=cpu["counts"])
        print(f"{what}: exit 0, {counts['spawns']} managed processes, the "
              f"data directory the CPU witness's (every host's stdout and "
              f"stderr, etc-hosts, the config, sim-stats less rounds)"
              f"{'; every circuit complete' if config == 'rung4' else ''}; "
              f"{stats['rounds']} rounds (witness {cs['rounds']}), "
              f"{stats['packets_sent']} packets ({stats['packets_dropped']} "
              f"dropped; the CPU routing's too), {tr['dispatches']} "
              f"dispatches, divergence 0; {counts['syscalls']} syscalls "
              f"dispatched ({counts['syscall_s']:.2f} s), spawns "
              f"{counts['spawn_s']:.2f} s (the witness's "
              f"{cpu['counts']['spawn_s']:.2f} s); no kernel launched; "
              f"{run['wall_s']:.2f} s wall  [{ident}]")
    if any(c not in rows for c in EXEC_CONFIGS):
        fail(f"23 (d): the card runs lack {EXEC_CONFIGS}")
    record["managed"] = rows
    return rows


def check_exec(run: dict, ident: str) -> dict:
    """23 (d): a shell of `exec_text` on the card machine. Each redirect
    crosses the execve (out.txt "headbody" for "exec-append",
    "headbodybody" for "exec-redirect"), with exit 0 and two spawns (the
    shell, then cat in its place); where this kernel shows no offsets
    (`stdio_offsets_seen`), "exec-redirect"'s exec instead fails as one
    that failed at spawn, exit 1 with the shell's exit 127 and a warning
    naming pidfd_getfd and the unseen offset, one spawn and cat never
    run. Either way no kernel launched and the data directory is its CPU
    witness's."""
    config = run["config"]
    what = f"23 (d) execve with redirects ({config})"
    card, counts = run["data"], run["counts"]
    cpu = witness(f"managed:{config}:cpu")
    carried = config == "exec-append" or stdio_offsets_seen()
    want = {"exec-append": b"headbody", "exec-redirect": b"headbodybody"}
    out = card.get("hosts/box/out.txt")
    err = card.get("hosts/box/err.txt", b"")
    named = [w for w in run["warnings"] if "pidfd_getfd is refused" in w
             and "its offset is unseen" in w]
    if carried:
        ok = (run["rc"] == 0 and not card["sim-stats.json"][
            "process_failures"] and out == want[config]
              and err.startswith(b"old") and b"nope" in err
              and counts["spawns"] == 2 and not run["warnings"])
    else:
        ok = (run["rc"] == 1 and out == b"head" and err == b"old"
              and counts["spawns"] == 1 and len(named) == 1)
    if not ok or cpu["rc"] != run["rc"] or run["processes"] != 1:
        fail(f"{what}: exit {run['rc']} (witness {cpu['rc']}), out.txt "
             f"{out!r}, err.txt {err!r}, {counts['spawns']} spawns, "
             f"warnings {run['warnings']}; the redirects "
             f"{'should have crossed' if carried else 'should have failed the exec, named'}")
    if run["launches"]:
        fail(f"{what} launched {run['launches']}")
    same_data_dirs(card, cpu["data"], what, config_less=(),
                   stats_less=("rounds",))
    print(f"{what}: exit {run['rc']}, out.txt {out!r}, err.txt {err!r}: "
          + ("every redirect crossed the execve" if carried else
             f"the exec failed as this kernel shows no offsets: {named[0]}")
          + f"; the data directory the CPU witness's; {counts['syscalls']} "
          f"syscalls dispatched, {counts['spawns']} spawns "
          f"{counts['spawn_s']:.2f} s; {run['wall_s']:.2f} s wall  [{ident}]")
    return dict(wall_s=run["wall_s"], rc=run["rc"], carried=carried,
                out=out.decode(), err=err.decode(),
                warnings=run["warnings"], **counts)


def start_beside(fn):
    """Run `fn` in a thread; returns a function that waits for it and
    returns (its result, its seconds), raising what it raised."""
    import threading

    out = {}

    def run():
        t0 = time.perf_counter()
        try:
            out["r"] = fn()
        except BaseException as exc:  # re-raised by the waiter
            out["error"] = exc
        out["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["r"], out["s"]

    return wait


def build_managed():
    """Phase 23 (a): the port's interposition libraries and the programs."""
    from shadow_tpu_torch import interpose

    return os.path.dirname(interpose.build()), managed_programs()


# -- phase 24: the benchmark ladder through the port's twin -----------------
#
# `shadow_tpu_torch/tools/bench_ladder.py`'s rungs 1, 2 and interpose at the
# JAX tool's shapes through the port's Manager, the device transport on the
# card (in a child beside 22 (b)), each against a CPU witness on the CPU
# routing in the pool; rungs 3, 3f and 4 run in phases 22 and 23 already,
# and their YAML is held to the twin's builders.

LADDER_RUNGS = ("1", "2", "interpose")
LADDER_SERVED = 10 * 1024 * 1024  # rung 1's file (bench_ladder.rung1's size)


def ladder_programs() -> Path:
    """Rung 1's served file and the interposition rung's TCP pair
    (`bench_ladder.compile_tcp_pair`), made once into a directory of
    `_build_out/` (`built_once`, by the pair's sources and the file's
    size): every card run and witness reads the same paths, so their
    configs and data directories compare. Returns it."""
    from shadow_tpu_torch.tools import bench_ladder

    def fill(tmp: Path):
        bench_ladder.write_served_file(tmp, LADDER_SERVED)
        bench_ladder.compile_tcp_pair(tmp)

    return built_once("ladder", [bench_ladder.tcp_pair_sources(),
                                 LADDER_SERVED], fill)


def ladder_run(rung: str, transport: str, data_dir: Path, device) -> dict:
    """The twin's rung `rung` at the JAX tool's shape with `transport`
    on `device`, its data directory `data_dir`; returns its JSON line."""
    from shadow_tpu_torch.tools import bench_ladder

    programs = ladder_programs()
    kw = dict(data_dir=data_dir, device=device, transport=transport)
    if rung == "1":
        line = bench_ladder.rung1(LADDER_SERVED, tmp=programs, **kw)
    elif rung == "2":
        line = bench_ladder.rung2(**kw)
    else:
        line = bench_ladder.rung_interpose(tmp=programs, **kw)
    if not line:
        fail(f"24 (a): rung {rung} skipped: no python3 or no curl binary")
    return line


def ladder_witness(rung: str) -> dict:
    """The CPU witness of a phase-24 rung: the twin on the CPU routing
    with `device="cpu"`; its JSON line and data directory."""
    import io

    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            line = ladder_run(rung, "cpu", Path(tmp) / "data", "cpu")
        return {"line": line, "data": data_dir_contents(Path(tmp) / "data")}


def ladder_card_runs(*modes: str) -> list[dict]:
    """Phase 24's card runs: each of LADDER_RUNGS through the twin's
    runner with the device transport on the card, in each of `modes`
    (default TX_MODES; the smoke runs a child a mode). Returns a row a
    run: its JSON line, data directory, kernel
    launches, managed (native) processes, spawns and syscall dispatches,
    and the
    transport's device, mode, dispatches, divergence, packets in flight
    and verified windows and packets."""
    import io

    from shadow_tpu_torch.process.managed import \
        ManagedSimProcess as managed_cls
    from shadow_tpu_torch.tools import bench_ladder
    from shadow_tpu_torch.tpu import floweng, pipeline

    mgrs = []
    orig = bench_ladder.Manager

    class Kept(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            mgrs.append(self)

    bench_ladder.Manager = Kept
    runs = []
    try:
        for mode in modes or TX_MODES:
            for rung in LADDER_RUNGS:
                mgrs.clear()
                with tempfile.TemporaryDirectory() as tmp:
                    pipeline.reset_launches()
                    floweng.reset_launches()
                    with managed_counters() as counts, \
                            contextlib.redirect_stdout(io.StringIO()) as out:
                        line = ladder_run(rung, mode, Path(tmp) / "data",
                                          None)
                    launches = {k: v for k, v in {
                        **pipeline.LAUNCHES, **floweng.LAUNCHES}.items()
                        if v}
                    data = data_dir_contents(Path(tmp) / "data")
                (mgr,) = mgrs
                tr = mgr.transport
                runs.append(dict(
                    rung=rung, mode=mode, line=line,
                    printed=out.getvalue(), data=data, launches=launches,
                    processes=sum(isinstance(cell.get("proc"), managed_cls)
                                  for _n, _p, cell in mgr._spawned),
                    counts=dict(counts),
                    transport=None if tr is None else dict(
                        device=tr.device.type, mode=tr.mode,
                        dispatches=tr.dispatches,
                        divergence=tr.divergence_count,
                        in_flight=tr.in_flight,
                        verified_windows=tr.verified_windows,
                        verified_packets=tr.verified_packets)))
    finally:
        bench_ladder.Manager = orig
    return runs


def check_ladder_texts(ident) -> None:
    """24 (b): the twin's rung-3 YAML is byte for byte the config phases
    22 (b) and (c) run, and with the transport's keys the lines 22 (b)
    runs; its rung-4 YAML with each transport is byte for byte phase 23
    (b)'s."""
    from shadow_tpu_torch.tools import bench_ladder
    from shadow_tpu_torch.workloads import rung4

    if bench_ladder.rung3_text(use_flow_engine=True) != rung3_live_text():
        fail("24 (b): the twin's rung 3f YAML is not the one 22 (b) and (c) "
             "run")
    # the same lines, the transport's in another place: 22 (b) puts it
    # where the flow engine's was, the twin after the hosts
    live = with_experimental(rung3_live_text(),
                             CLI_TRANSPORT.format(mode="sync"))
    twin = bench_ladder.with_transport(bench_ladder.rung3_text(), "sync")
    if sorted(twin.splitlines()) != sorted(live.splitlines()):
        fail("24 (b): the twin's rung 3 with the sync transport is not the "
             "config 22 (b) runs")
    programs = managed_programs()
    for mode in TX_MODES:
        twin = bench_ladder.with_transport(
            rung4.rung4_text(programs, **RUNG4), mode)
        if twin != managed_text("rung4", mode):
            fail(f"24 (b): the twin's rung 4 ({mode}) is not 23 (b)'s YAML")
    print(f"24 (b) the twin's YAML: rung 3f byte for byte the config of 22 "
          f"(b) and (c), rung 3 with the sync transport 22 (b)'s lines, "
          f"rung 4 with each transport byte for byte 23 (b)'s; not run "
          f"again  [{ident}]")


def check_ladder(torch, record, ident, runs):
    """Phase 24: (a) the card runs of `ladder_card_runs` (`runs`), each
    against its rung's CPU witness: no process failure, the packets and
    simulated seconds the witness's, the data directory the witness's
    (`same_data_dirs`: every host's files, rung 1's fetched files among
    them, and etc-hosts), the transport on the card in the mode asked, no
    divergence, nothing in flight, a spawn a managed process, no kernel
    of A-F launched; each run's JSON line printed; (b)
    `check_ladder_texts`."""
    rows, launched = {}, {}
    # a witness a rung, awaited once (as in check_quickstart)
    witnesses = {rung: witness(f"ladder:{rung}") for rung in LADDER_RUNGS}
    for run in runs:
        rung, mode, tr, line = (run["rung"], run["mode"], run["transport"],
                                run["line"])
        what = f"24 (a) rung {rung} ({mode})"
        cpu = witnesses[rung]
        wl = cpu["line"]
        if line["failures"] or wl["failures"]:
            fail(f"{what}: {line['failures']} process failures (witness "
                 f"{wl['failures']})")
        if tr is None or tr["device"] != TX_DEVICE or tr["mode"] != mode:
            fail(f"{what}: the transport ran {tr}")
        if tr["divergence"] or tr["in_flight"]:
            fail(f"{what}: divergence {tr['divergence']}, {tr['in_flight']} "
                 f"packets in flight")
        if (line["packets"], line["sim_seconds"]) != (wl["packets"],
                                                      wl["sim_seconds"]):
            fail(f"{what}: {line['packets']} packets in {line['sim_seconds']}"
                 f" s, the witness {wl['packets']} in {wl['sim_seconds']} s")
        same_data_dirs(run["data"], cpu["data"], what)
        counts = run["counts"]
        if counts["spawns"] != run["processes"]:
            fail(f"{what}: {counts['spawns']} spawns of {run['processes']} "
                 f"managed processes")
        for k, v in run["launches"].items():
            launched[k] = launched.get(k, 0) + v
        if run["launches"]:
            fail(f"{what} launched {run['launches']}")
        print(run["printed"].rstrip())
        rows[f"{rung}:{mode}"] = dict(
            {k: line[k] for k in ("rung", "sim_seconds", "wall_seconds",
                                  "sim_per_wall", "events_per_sec",
                                  "events", "packets", "failures")},
            peak_rss_mib=line.get("peak_rss_mib"),
            witness_wall_seconds=wl["wall_seconds"],
            witness_events=wl["events"], dispatches=tr["dispatches"],
            verified_windows=tr["verified_windows"],
            verified_packets=tr["verified_packets"], **counts)
        print(f"{what}: {line['rung']} {line['sim_seconds']} s simulated, "
              f"{line['packets']} packets (the witness's), {line['events']} "
              f"events (witness {wl['events']}), the data directory the CPU "
              f"witness's ({len(run['data'])} files), {tr['dispatches']} "
              f"dispatches, divergence 0, {counts['spawns']} spawns "
              f"{counts['spawn_s']:.2f} s, {counts['syscalls']} syscalls "
              f"{counts['syscall_s']:.2f} s; {line['wall_seconds']} s wall, "
              f"sim/wall {line['sim_per_wall']} (the witness's "
              f"{wl['wall_seconds']} s on the CPU routing)  [{ident}]")
    if sorted(rows) != sorted(f"{r}:{m}" for r in LADDER_RUNGS
                              for m in TX_MODES):
        fail(f"24 (a): the card runs were {sorted(rows)}")
    print(f"24 (a) kernel launches of A-F in the ladder's children: "
          f"{sum(launched.values())}")
    check_ladder_texts(ident)
    record["ladder"] = rows
    return rows


def check_phold_widths(torch, bench, convert, pipeline, record, ident):
    """22 (d): PHOLD_WIDE through "pallas_fused" and "pallas" (kernels A
    and C in their wide build, every window) and PHOLD_CI1 through
    "pallas_fused" (kernel B with one-slot rings), each state equal to
    the "xla" run's."""
    rows = {}
    for size, paths in ((PHOLD_WIDE, ("pallas_fused", "pallas")),
                        (PHOLD_CI1, ("pallas_fused",))):
        size = dict(size)
        n = size.pop("n_hosts")
        ref = bench.run_phold(n, warmup=False, kernel="xla", **size)
        want = convert.state_digest(ref["state"])
        for kernel in paths:
            pipeline.reset_launches()
            out = bench.run_phold(n, warmup=False, kernel=kernel, **size)
            builds = {**{f"A:{k}": v for k, v in
                         pipeline.A_BUILD_LAUNCHES.items() if v},
                      **{f"C:{k}": v for k, v in
                         pipeline.C_BUILD_LAUNCHES.items() if v}}
            launches = {k: v for k, v in pipeline.LAUNCHES.items() if v}
            got = convert.state_digest(out["state"])
            key = f"{kernel}@CE={size['egress_cap']},CI={size['ingress_cap']}"
            pair = (("egress_rank", "route_place") if kernel == "pallas_fused"
                    else ("egress_gate", "route_scatter"))
            if got != want or launches != {p: size["rounds"] for p in pair}:
                fail(f"22 (d) PHOLD {key}: digest {got[:16]} vs xla "
                     f"{want[:16]}, launches {launches}")
            rows[key] = dict(builds=builds, launches=launches,
                             delivered=out["delivered"])
            print(f"22 (d) PHOLD N={n} R={size['rounds']} {key}: state == "
                  f"xla's ({out['delivered']} delivered); launches "
                  f"{launches}, by build {builds}  [{ident}]")
    record["phold_widths"] = rows
    return rows


def kernel_entry(name, source, replaces, launches, row, ens_launches,
                 section_launches, mesh_launches):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "ensemble_launches": ens_launches,
            "section_launches": section_launches,
            "mesh_launches_per_rank": mesh_launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "warm_ms": row["warm_ms"], "cold_clean_ms": row["cold_clean_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    pool, workers, cores = start_witnesses()
    try:
        return run_phases(torch, workers, cores)
    finally:
        pool.terminate()
        pool.join()


def run_phases(torch, workers: int, cores: int):
    from shadow_tpu_torch import _build, bench, convert
    from shadow_tpu_torch.tpu import elastic, floweng, pipeline
    from shadow_tpu_torch.workloads import runner

    ident = gpu_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"gpu: {ident}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    record = {"gpu": ident, "kind": kind, "torch": torch.__version__,
              "witness_pool": dict(workers=workers, cores=cores,
                                   threads=WITNESS_THREADS)}

    # kernel F's nvcc, the longest by far, builds beside phases 3-19 (F
    # first runs in phase 20); the others before phase 3, all at once
    t0 = time.perf_counter()
    f_build = start_beside(lambda: _build.build(
        ["flow_window"], verbose_ptxas=True)["flow_window"])
    # phase 23's shim and programs (g++/gcc) build beside the phases too
    managed_build = start_beside(build_managed)
    build_s = _build.build([n for n in _build.SIGNATURES
                            if n != "flow_window"], verbose_ptxas=True)
    build_wall = time.perf_counter() - t0
    record["build_s"] = build_s
    print(f"build: {json.dumps(build_s)} wall {build_wall:.2f}s (kernel F "
          f"builds beside the phases)")

    phase_s = {"build": build_wall}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    a = timed("3 kernel A", check_kernel_a, torch, pipeline, record)
    a_widths = timed("3 (d) kernel A widths", check_egress_widths, torch,
                     pipeline, record, ident, "A")
    c = timed("4 kernel C", check_kernel_c, torch, pipeline, record)
    c_widths = timed("4 (d) kernel C widths", check_egress_widths, torch,
                     pipeline, record, ident, "C")
    b, b_out = timed("5 kernel B", check_placement, torch, pipeline, record,
                     "kernel_b", "kernel B route_place", pipeline.place,
                     pipeline.place_plain)
    d, d_out = timed("5 kernel D", check_placement, torch, pipeline, record,
                     "kernel_d", "kernel D route_scatter", pipeline.scatter,
                     pipeline.scatter_plain)
    if max_abs_err(torch, d_out, b_out) != 0:
        fail("kernels D and B disagree on the same inputs")
    timed("5 (d) kernel B CI=1", check_b_one_slot, torch, pipeline, record,
          ident)
    print(f"kernels D and B on the same inputs: equal; D {d['ms']:.5f} ms "
          f"vs B {b['ms']:.5f} ms cold, {d['cold_clean_ms']:.5f} vs "
          f"{b['cold_clean_ms']:.5f} cold clean, {d['warm_ms']:.5f} vs "
          f"{b['warm_ms']:.5f} warm")

    for kernel in ("pallas_fused", "pallas"):
        timed(f"6 golden {kernel}", check_golden, bench, convert, kernel)
    fused = timed("7 main path fused", check_main_path, torch, bench, convert,
                  pipeline, record, ident, "pallas_fused",
                  ("egress_rank", "route_place"))
    split = timed("7 main path split", check_main_path, torch, bench, convert,
                  pipeline, record, ident, "pallas",
                  ("egress_gate", "route_scatter"))
    timed("8 capacity", check_capacity, bench, convert, elastic, record)
    timed("9 corpus", check_corpus, torch, pipeline, record, ident)
    fused_digest = timed("10 metrics", check_metrics_paths, torch, bench,
                         convert, pipeline, record)
    timed("11 xla", check_xla_path, torch, bench, convert, pipeline, record,
          ident, fused_digest)
    with shared_setups(runner):
        timed("12 onoff-16384", check_wide_scenario, torch, record, ident)
        fleet_rec = timed("13 serving fleet", check_fleet, torch, pipeline,
                          record, ident)
        timed("14 robustness", check_robustness, torch, pipeline, record,
              ident)
    e, e_launches, e_builds, e_wide = timed(
        "15 router AQM", check_router_aqm, torch, pipeline, record, ident)
    timed("16 run infrastructure", check_run_infra, torch, bench, convert,
          pipeline, record, ident, fleet_rec)
    floweng.reset_launches()
    ens = timed("17 ensembles", check_ensembles, torch, bench, convert,
                pipeline, record, ident)
    ens["flow_window"] = floweng.LAUNCHES["flow_window"]
    floweng.reset_launches()
    sec = timed("18 section profiler", check_section_profiler, torch, bench,
                pipeline, record, ident)
    sec["flow_window"] = floweng.LAUNCHES["flow_window"]
    mesh_l = timed("19 mesh", check_mesh, torch, bench, convert, pipeline,
                   record, ident)
    f_wait = "20 kernel F's build, awaited"
    build_s["flow_window"], _ = timed(f_wait, f_build)
    print(f"build of kernel F: {build_s['flow_window']:.2f}s beside phases "
          f"3-19, awaited {phase_s[f_wait]:.2f}s")
    f_row, f_launches, f_rung3 = timed("20 flow engine", check_flow_engine,
                                       torch, record, ident)
    big_run = f_row["large_rings"]["runs"][str(FLOW_Q_LARGE[0])]
    big_chunk = big_run["chunk_ms"]
    f_big = dict(q=FLOW_Q_LARGE[0], launches=big_run["launches"],
                 ms=max(t["cold"] for t in big_chunk),
                 cold_clean_ms=max(t["clean"] for t in big_chunk),
                 warm_ms=max(t["warm"] for t in big_chunk),
                 bound_ms=big_run["chunk_bound_ms"], bound_by="bytes",
                 in_run_ms=big_run["in_run_ms"])
    # the transport's path launches no hand-written kernel: its counts
    # are read around phase 21 like every other path's
    pipeline.reset_launches()
    floweng.reset_launches()
    _tx, untagged = timed("21 device transport", check_transport, torch,
                          record, ident)
    tx_launches = {**pipeline.LAUNCHES, **floweng.LAUNCHES}
    if any(tx_launches.values()):
        fail(f"phase 21 launched kernels {tx_launches}")
    record["transport_launches"] = tx_launches
    managed_built = timed("23 (a) shim and programs' build, awaited",
                          managed_build)
    # 22 (a)'s and 23's card runs in child processes beside 22 (b)
    with tempfile.TemporaryDirectory() as tmp:
        qs_wait, qs_kill = start_runs_beside(
            "22 (a)", "quickstart_card_runs", Path(tmp))
        mg_wait, mg_kill = start_runs_beside(
            "23", "managed_card_runs", Path(tmp))
        # the ladder's card runs, a child a mode
        ladder = [start_runs_beside("24", "ladder_card_runs", Path(tmp),
                                    mode) for mode in TX_MODES]
        try:
            timed("22 (b) rung 3 live", rung3_live, torch, record, ident,
                  RUNG3_LIVE_STOP, untagged, "cli:rung3")
            # (c) and (d) time nothing on the card: they run while the
            # children finish
            f_cli = timed("22 (c) flow engine CLI", check_flow_cli, torch,
                          record, ident)
            phold_widths = timed("22 (d) PHOLD widths", check_phold_widths,
                                 torch, bench, convert, pipeline, record,
                                 ident)
            qs_runs = timed("22 (a) quickstart's child, awaited", qs_wait)
            mg_runs = timed("23 managed processes' child, awaited",
                            mg_wait)
            lad_runs = timed("24 ladder's children, awaited", lambda: [
                run for wait, _kill in ladder for run in wait()])
        finally:
            qs_kill()
            mg_kill()
            for _wait, kill in ladder:
                kill()
    timed("22 (a) quickstart", check_quickstart, torch, record, ident,
          qs_runs)
    timed("23 managed processes", check_managed, torch, record, ident,
          managed_built, mg_runs)
    timed("24 ladder", check_ladder, torch, record, ident, lad_runs)
    record["phase_s"] = phase_s
    print(f"phase seconds: {json.dumps(phase_s)}")
    print(f"phase seconds summed, the build's wait included: "
          f"{sum(phase_s.values()):.1f} (CPU witnesses in a pool of "
          f"{workers} workers on {cores} cores)")

    widths = lambda rows: [{k: r[k] for k in (
        "ce", "n", "build", "ms", "cold_clean_ms", "warm_ms", "plain_ms",
        "bound_ms", "bound_by")} for r in rows]
    kernels = [
        dict(kernel_entry("egress_rank_kernel",
                          "shadow_tpu_torch/csrc/egress_rank.cu",
                          "shadow_tpu/tpu/pallas_pipeline.py:77",
                          fused["egress_rank"], a, ens["egress_rank"],
                          sec["egress_rank"], mesh_l["egress_rank"]),
             widths=widths(a_widths), phold_wide=phold_widths[
                 f"pallas_fused@CE={PHOLD_WIDE['egress_cap']},"
                 f"CI={PHOLD_WIDE['ingress_cap']}"]["builds"]),
        kernel_entry("route_place_kernel",
                     "shadow_tpu_torch/csrc/route_place.cu",
                     "shadow_tpu/tpu/pallas_pipeline.py:188",
                     fused["route_place"], b, ens["route_place"],
                     sec["route_place"], mesh_l["route_place"]),
        dict(kernel_entry("egress_gate_kernel",
                          "shadow_tpu_torch/csrc/egress_gate.cu",
                          "shadow_tpu/tpu/pallas_egress.py:91",
                          split["egress_gate"], c, ens["egress_gate"],
                          sec["egress_gate"], mesh_l["egress_gate"]),
             widths=widths(c_widths), phold_wide=phold_widths[
                 f"pallas@CE={PHOLD_WIDE['egress_cap']},"
                 f"CI={PHOLD_WIDE['ingress_cap']}"]["builds"]),
        kernel_entry("route_scatter_kernel",
                     "shadow_tpu_torch/csrc/route_scatter.cu",
                     "shadow_tpu/tpu/pallas_route.py:48",
                     split["route_scatter"], d, ens["route_scatter"],
                     sec["route_scatter"], mesh_l["route_scatter"]),
        dict(kernel_entry("router_drain_kernel",
                          "shadow_tpu_torch/csrc/router_drain.cu",
                          "shadow_tpu/tpu/codel.py:578 (router_drain, "
                          "lax.fori_loop)", e_launches, e,
                          ens["router_drain"], sec["router_drain"],
                          mesh_l["router_drain"]),
             launches_by_build={
                 "staged": e_builds["staged"],
                 "device": e_wide["runs"]["pallas_fused"][
                     "device_build_launches"]},
             device_build=dict(e["device_build"],
                               in_window_us=e_wide["e_us_per_launch"],
                               in_window_bound_us=e_wide["bound_ms"] * 1e3,
                               k=e_wide["k"])),
        dict(kernel_entry("flow_window_kernel",
                          "shadow_tpu_torch/csrc/flow_window.cu",
                          "shadow_tpu/tpu/floweng.py:531 (run_windows, "
                          "lax.scan of lax.while_loop)", f_launches, f_row,
                          ens["flow_window"], sec["flow_window"],
                          mesh_l["flow_window"]), rung3_launches=f_rung3,
             cli_launches=f_cli,
             sharded_launches=f_row["launches_sharded"],
             large_rings=f_big),
    ]
    print(f"record: {json.dumps(record, default=str)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

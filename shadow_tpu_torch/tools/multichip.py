"""The sharded step's contract on a host-axis mesh of ranks, and the
flow engine's over shards.

    python -m shadow_tpu_torch.tools.multichip --ranks N [--device cpu]
        [--backend gloo|nccl] [--hosts H]
        [--kernel xla|pallas_fused|pallas]

The port's counterpart of `__graft_entry__.dryrun_multichip`, over
`torch.distributed` (`tpu/mesh.py`): N ranks, rank 0 this process and
the others spawned, each owning N_hosts / N contiguous host rows.

1. Two rounds: the flat `ingest` of one packet a host and
   `window_step`, twice (a steady-state round with a rebase and
   deliveries), on 4 * N hosts, sharded, against the same rounds on one
   rank: the state, both delivered dicts and both next events equal,
   bitwise, through each of the three kernels.
2. The stress: `--hosts` (65536) hosts over a 64-node graph with
   starved token buckets, an ingest burst of 18 packets a host to
   dst = src + N/2 (every one crosses a shard boundary; the egress
   rings overflow, so the drop path runs sharded), then a 64-window
   `chain_windows` through `--kernel` ("xla", as JAX's) that walks
   every window: state, delivered dict, (off, next, n_windows) and the
   overflow drops equal the one-rank run's, bitwise.
3. The flow engine (`check_flow_engine`, in this process after the
   ranks): JAX's dry-run world of 12 flows a shard over N shards,
   400 windows of 20 ms through `floweng.run_windows` and through
   `floweng.run_windows_sharded(n_shards=N)`, one controller and no
   collective (pairs never interact): completion times, bytes read and
   the segment, retransmit and drop counters equal.

The devices default to the CUDA card (NCCL when each rank has a card of
its own, else gloo, each collective through host memory; `--backend`
names one); `--device cpu` runs gloo on the CPU. The JSON line at the end carries
the results and wall seconds (virtual ranks or shards that share one
host or one card: this checks placement, not speedup).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import convert
from ..tpu import floweng
from ..tpu import mesh as meshmod
from ..tpu.plane import (KERNELS, chain_windows, ingest, make_params,
                         make_state, window_step)

MS = 1_000_000
STRESS_HOSTS = 65_536
STRESS_WINDOWS = 64
STRESS_INGRESS_CAP = 16
STRESS_NODES = 64
TWO_ROUND_SEED = 7
STRESS_SEED = 11
FLOW_SEED = 23
FLOW_WINDOWS = 400
FLOW_WINDOW_US = 20_000
FLOW_COUNTERS = ("segments", "retransmits", "wire_drops", "queue_drops")


def _np(tree):
    """A pytree of tensors (NamedTuples, dicts, tuples) as numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_fields"):
        return {f: _np(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    return tree


def diff(a, b, path="") -> list[str]:
    """The leaves of two numpy trees that differ (empty: bitwise equal)."""
    if isinstance(a, dict):
        return [d for k in a for d in diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in diff(x, y, f"{path}[{i}]")]
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
        return [path]
    return []


def _gathered(mesh, state, delivered, next_ev):
    """A rank's (state, delivered dicts, next events) as the unsharded
    numpy results (a collective)."""
    if mesh is None:
        return _np(state), _np(delivered), _np(next_ev)
    return (_np(meshmod.gather_state(state, mesh)),
            _np(meshmod.gather_state(delivered, mesh)), _np(next_ev))


# -- 1. two rounds ------------------------------------------------------------


def example_world(n_hosts: int, device, egress_cap: int = 8,
                  ingress_cap: int = 16):
    """`__graft_entry__._example_world`: 10 ms paths with 1 % loss, 1
    Gbit/s hosts, full buckets, two packets a host to the next host."""
    lat = np.full((n_hosts, n_hosts), 10 * MS, np.int32)
    loss = np.full((n_hosts, n_hosts), 0.01, np.float32)
    params = make_params(lat, loss, np.full(n_hosts, 1_000_000_000),
                         device=device)
    state = make_state(n_hosts, egress_cap=egress_cap,
                       ingress_cap=ingress_cap,
                       initial_tokens=params.tb_cap, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    src = torch.arange(n_hosts, **i32).repeat_interleave(2)
    b = 2 * n_hosts
    state = ingest(state, src, (src + 1) % n_hosts,
                   torch.full((b,), 1400, **i32), torch.arange(b, **i32),
                   torch.arange(b, **i32),
                   torch.zeros(b, dtype=torch.bool, device=device))
    return state, params


def two_round_batch(n_hosts: int, device) -> dict:
    """One new packet a host: dst = 7 * src + 3 mod N."""
    i32 = dict(dtype=torch.int32, device=device)
    src = torch.arange(n_hosts, **i32)
    return dict(src=src, dst=(src * 7 + 3) % n_hosts,
                nbytes=torch.full((n_hosts,), 1000, **i32),
                prio=torch.arange(n_hosts, **i32),
                seq=torch.arange(n_hosts, **i32) + 100,
                ctrl=torch.zeros(n_hosts, dtype=torch.bool, device=device))


def two_rounds(state, params, batch, kernel: str, mesh=None):
    """Round 1 and a steady-state round 2 (rebase + delivery), each the
    batch's ingest then `window_step`. Returns the gathered numpy
    (state, [delivered1, delivered2], [next1, next2])."""
    delivered, nexts = [], []
    for r, (shift, seq_off) in enumerate(((0, 0), (10 * MS, 1000))):
        state = ingest(state, batch["src"], batch["dst"], batch["nbytes"],
                       batch["prio"], batch["seq"] + seq_off, batch["ctrl"],
                       mesh=mesh)
        state, d, nxt = window_step(state, params, TWO_ROUND_SEED, shift, MS,
                                    rr_enabled=False, kernel=kernel,
                                    mesh=mesh)
        delivered.append(d)
        nexts.append(nxt)
    return _gathered(mesh, state, delivered, nexts)


def check_two_rounds(mesh, kernels=KERNELS) -> dict:
    """Part 1 on this rank: the sharded rounds on 4 * R hosts through
    each of `kernels`, against the one-rank rounds. Returns {kernel:
    the leaves that differ, and a line if no packet moved}."""
    n = 4 * mesh.size
    out = {}
    for kernel in kernels:
        world = example_world(n, mesh.device)
        batch = two_round_batch(n, mesh.device)
        sh = two_rounds(*meshmod.shard_state(*world, mesh), batch, kernel,
                        mesh)
        ref = two_rounds(*example_world(n, mesh.device), batch, kernel)
        out[kernel] = diff(list(ref), list(sh))
        if int(sh[0]["n_sent"].sum()) <= 0:
            out[kernel].append("no packets moved in the two rounds")
    return out


def sharded_windows(mesh, params_np: dict, state_np: dict, batch_np: dict,
                    seed: int, windows: int, variants) -> dict:
    """A given world ((params, state) as `convert`'s numpy dicts) on this
    rank: the flat ingest of `batch_np` (src, dst, nbytes, prio, seq,
    ctrl), then `windows` windows of MS (the first with shift 0), for
    each (kernel, rr_enabled) of `variants`. Returns {variant: the
    gathered numpy (state, [delivered], [next])}."""
    out = {}
    for kernel, rr in variants:
        state, params = meshmod.shard_state(
            convert.state_from_numpy(state_np, mesh.device),
            convert.params_from_numpy(params_np, mesh.device), mesh)
        b = {k: torch.as_tensor(np.asarray(v)).to(mesh.device)
             for k, v in batch_np.items()}
        state = ingest(state, b["src"], b["dst"], b["nbytes"], b["prio"],
                       b["seq"], b["ctrl"], mesh=mesh)
        delivered, nexts = [], []
        for w in range(windows):
            state, d, nxt = window_step(state, params, seed,
                                        0 if w == 0 else MS, MS,
                                        rr_enabled=rr, kernel=kernel,
                                        mesh=mesh)
            delivered.append(d)
            nexts.append(nxt)
        out[(kernel, rr)] = _gathered(mesh, state, delivered, nexts)
    return out


# -- 2. the stress ------------------------------------------------------------


def stress_world(n_hosts: int, device):
    """`__graft_entry__._stress_multichip`'s world: a 64-node graph of 70
    ms paths with 1 % loss, 80 kbit/s hosts with empty buckets (every
    egress queue stays non-empty, nothing deliverable), CE 8, CI 16."""
    m = STRESS_NODES
    lat = np.full((m, m), 70 * MS, np.int32)
    loss = np.full((m, m), 0.01, np.float32)
    params = make_params(lat, loss, np.full(n_hosts, 80_000),
                         host_node=np.arange(n_hosts) % m, device=device)
    state = make_state(n_hosts, egress_cap=8,
                       ingress_cap=STRESS_INGRESS_CAP, device=device)
    return state, params


def stress_batch(n_hosts: int, device) -> dict:
    """18 packets a host (ingress cap + 2) to dst = src + N/2 mod N."""
    per_host = STRESS_INGRESS_CAP + 2
    b = n_hosts * per_host
    i32 = dict(dtype=torch.int32, device=device)
    src = torch.arange(n_hosts, **i32).repeat_interleave(per_host)
    ids = torch.arange(b, **i32)
    return dict(src=src, dst=(src + n_hosts // 2) % n_hosts,
                nbytes=torch.full((b,), 900, **i32), prio=ids % 7, seq=ids,
                ctrl=torch.zeros(b, dtype=torch.bool, device=device))


def stress_run(state, params, batch, windows: int, kernel: str, mesh=None):
    """The burst's ingest, then one `windows`-window chain of 1 ms
    windows. Returns (gathered numpy state, delivered, [off, next,
    n_windows], wall seconds of the chain)."""
    state = ingest(state, batch["src"], batch["dst"], batch["nbytes"],
                   batch["prio"], batch["seq"], batch["ctrl"], mesh=mesh)
    t0 = time.perf_counter()
    state, delivered, off, nxt, n_win = chain_windows(
        state, params, STRESS_SEED, 0, MS, MS, 2**30, 2**30,
        max_windows=windows, rr_enabled=False, kernel=kernel, mesh=mesh)
    if state.eg_dst.device.type == "cuda":
        torch.cuda.synchronize(state.eg_dst.device)
    wall = time.perf_counter() - t0
    st, d, chain = _gathered(mesh, state, delivered, [off, nxt, n_win])
    return st, d, chain, wall


def check_stress(mesh, n_hosts: int = STRESS_HOSTS,
                 windows: int = STRESS_WINDOWS, kernel: str = "xla",
                 reference: bool = True) -> dict:
    """Part 2 on this rank: the sharded stress, and on rank 0 the
    one-rank run of the same world against it (`reference`). Returns
    the leaves that differ, the chain, the overflow drops and the wall
    seconds."""
    batch = stress_batch(n_hosts, mesh.device)
    sh = stress_run(*meshmod.shard_state(*stress_world(n_hosts,
                                                       mesh.device), mesh),
                    batch, windows, kernel, mesh)
    out = {"hosts": n_hosts, "ranks": mesh.size, "kernel": kernel,
           "chain": [int(v) for v in sh[2]],
           "overflow_drops": int(sh[0]["n_overflow_dropped"].sum()),
           "sharded_wall_s": sh[3], "state": sh[0], "delivered": sh[1]}
    if reference and mesh.rank == 0:
        ref = stress_run(*stress_world(n_hosts, mesh.device), batch,
                         windows, kernel)
        out["diff"] = diff([ref[0], ref[1], [int(v) for v in ref[2]]],
                           [sh[0], sh[1], out["chain"]])
        out["one_rank_wall_s"] = ref[3]
    return out


# -- 3. the flow engine -------------------------------------------------------


def flow_world(n_flows: int, device):
    """`__graft_entry__._flow_engine_multichip`'s world: 20-120 ms paths,
    30-120 KB fetches (the passive side writes) starting in the first
    400 ms, up to 1 % loss, 128-slot rings."""
    rng = np.random.default_rng(FLOW_SEED)
    lats = rng.integers(20, 120, n_flows) * 1000
    sizes = rng.integers(30_000, 120_000, n_flows)
    starts = rng.integers(0, 400, n_flows) * 1000
    loss = rng.uniform(0.0, 0.01, n_flows)
    return floweng.make_flow_world(lats, sizes, start_us=starts, loss=loss,
                                   server_writes=True, queue_slots=128,
                                   device=device)


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if out[0].conn_t.device.type == "cuda":
        torch.cuda.synchronize(out[0].conn_t.device)
    return out, time.perf_counter() - t0


def check_flow_engine(n_shards: int, device, n_flows_per_shard: int = 12,
                      n_windows: int = FLOW_WINDOWS) -> dict:
    """Part 3: the flow world over `n_shards` shards on `device`, run
    whole and sharded. Returns the results that differ (`diff`, empty
    when equal), the flows complete and both runs' wall seconds."""
    n_flows = n_flows_per_shard * n_shards
    (single, _), single_s = _timed(floweng.run_windows,
                                   flow_world(n_flows, device), n_windows,
                                   FLOW_WINDOW_US)
    (sharded, steps), sharded_s = _timed(
        floweng.run_windows_sharded, flow_world(n_flows, device), n_windows,
        FLOW_WINDOW_US, n_shards=n_shards)
    rs, rp = floweng.flow_results(single), floweng.flow_results(sharded)
    diff = [k for k in ("complete_us", "bytes_read")
            if not np.array_equal(rs[k], rp[k])]
    diff += [k for k in FLOW_COUNTERS if rs[k] != rp[k]]
    return {"flows": n_flows, "shards": n_shards, "windows": n_windows,
            "window_us": FLOW_WINDOW_US, "diff": diff,
            "complete": int((rp["bytes_read"] >= rp["bytes_expected"]).sum()),
            "steps_shape": list(steps.shape),
            **{k: rp[k] for k in FLOW_COUNTERS},
            "single_wall_s": single_s, "sharded_wall_s": sharded_s}


def rank_main(mesh, hosts: int, kernel: str) -> dict:
    """Both parts on one rank (the CLI's body)."""
    t0 = time.perf_counter()
    rounds = check_two_rounds(mesh)
    t1 = time.perf_counter()
    stress = check_stress(mesh, hosts, STRESS_WINDOWS, kernel)
    for k in ("state", "delivered"):
        stress.pop(k)
    return {"ranks": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "two_rounds": rounds,
            "two_rounds_s": t1 - t0, "stress": stress,
            "stress_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch.tools.multichip",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--hosts", type=int, default=STRESS_HOSTS)
    ap.add_argument("--kernel", choices=KERNELS, default="xla")
    args = ap.parse_args(argv)
    if args.hosts % args.ranks:
        ap.error(f"--hosts {args.hosts} must shard evenly over "
                 f"{args.ranks} ranks")
    rep = meshmod.run_ranks(rank_main, args.ranks, args.hosts, args.kernel,
                            backend=args.backend, device=args.device)
    flow = rep["flow_engine"] = check_flow_engine(args.ranks, args.device)
    bad = {k: v for k, v in rep["two_rounds"].items() if v}
    st = rep["stress"]
    print(f"two rounds on {4 * args.ranks} hosts x {args.ranks} ranks "
          f"({rep['backend']}, {rep['device']}): "
          + ("bitwise == one rank through " + ", ".join(KERNELS)
             if not bad else f"DIVERGED {bad}"), file=sys.stderr)
    print(f"stress: {st['hosts']} hosts x {st['ranks']} ranks, "
          f"kernel={st['kernel']}, chain (off, next, n_windows) "
          f"{st['chain']}, {st['overflow_drops']} overflow drops; "
          + ("sharded bitwise == one rank" if not st["diff"]
             else f"DIVERGED in {st['diff'][:8]}")
          + f"; wall one rank {st['one_rank_wall_s']:.2f}s vs "
          f"{args.ranks} ranks {st['sharded_wall_s']:.2f}s (ranks share "
          "one host: placement, not speedup)", file=sys.stderr)
    print(f"flow engine: {flow['flows']} flows x {flow['shards']} shards, "
          f"{flow['complete']}/{flow['flows']} complete, "
          + ("sharded == one run" if not flow["diff"]
             else f"DIVERGED in {flow['diff']}")
          + f" ({flow['segments']} segments, {flow['wire_drops']} wire "
          f"drops); wall one run {flow['single_wall_s']:.2f}s vs sharded "
          f"{flow['sharded_wall_s']:.2f}s (shards share one device: "
          "placement, not speedup)", file=sys.stderr)
    print(json.dumps(rep, sort_keys=True))
    ok = (not bad and not st["diff"] and st["overflow_drops"] > 0
          and st["chain"][2] == STRESS_WINDOWS and not flow["diff"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

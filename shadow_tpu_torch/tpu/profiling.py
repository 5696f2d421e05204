"""The PHOLD bench world and the per-section profiler of the window step
(counterpart of `shadow_tpu/tpu/profiling.py`).

`build_world` is the bench's world at a given shape. `profile_sections`
rebuilds it, then times each section of `plane.window_step` as its own
call: the same section helpers `window_step` composes
(`plane._rebase_refill`, `_egress_order`, `_token_gate`,
`_routing_rank`, `_routing_place`, ...), called on the world's
intermediates, so a section times what the step runs. The sections and
their order are the JAX profiler's (`DEFAULT_SECTIONS`; `bench` records
`BENCH_SECTIONS`):

- `rebase_refill`, `rr_tensors`, `qdisc_sort`, `token_gate`,
  `loss_latency`, `ingress_compact`, `release_due`, `egress_compact`,
  `ingest_rows`: one helper each, in plain PyTorch on every kernel;
- `routing_scatter`: the whole routing stage, through kernel D on
  `kernel="pallas"` and through its plain version (the XLA placement)
  on the others, as JAX's `_route_scatter` dispatches; `routing_rank`
  and `routing_place` its two halves, the latter always the XLA
  placement;
- `codel_drain`: the router drain, kernel E on CUDA tensors;
- `fused_stage`: sections 1-5b composed for `kernel` (A and B on
  "pallas_fused", C and D on "pallas");
- `window_step`, `window_chain8` (eight windows) and the step with a
  presence plane: `_telemetry`, `_elastic` and `_workload` under
  `kernel`, `_faults`, `_guards`, `_trace`, `_flows` and `_compute` on
  "xla", as the JAX profiler pins them.

A section's time is the host's wall clock around one call, after a
synchronise of the card before it and up to one after it: the min and
median over `reps` calls after one untimed call, in ms rounded to 4
places (JAX's `block_until_ready` semantics). It includes the launches'
dispatch, which is where a solo window's time goes on the card
(`bench.profile_windows` gives the device's busy time beside it).
Kernels B and D update the compacted ingress in place, where the JAX
functions return new arrays, so each call of `routing_scatter` and
`routing_place` gets fresh clones of those inputs, made before the clock
starts (`MUTATED_ARGS`, `fresh_args`); `fused_stage` compacts its own.

`packed_sort=False` times JAX's pre-diet variadic sorts on "xla"
(`routing_rank` and `routing_place` are then the legacy rank and
scatters), as JAX's does; the Pallas kernels refuse it. Drive it from
the CLI: `python -m shadow_tpu_torch.tools.profile_plane`.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import resolve_device
from ..workloads.phold import respawn_batch
from . import codel, pipeline, plane
from .plane import ingest, make_params, make_state, window_step
from .prims import floormod, wrap_i32

MS = 1_000_000
# the JAX bench's root key is jax.random.key(1)
RNG_SEED = 1

#: every section, in the JAX profiler's order
DEFAULT_SECTIONS = (
    "rebase_refill", "rr_tensors", "qdisc_sort", "token_gate",
    "loss_latency", "ingress_compact", "routing_scatter", "routing_rank",
    "routing_place", "release_due", "codel_drain", "egress_compact",
    "ingest_rows", "fused_stage", "window_step", "window_chain8",
    "window_step_telemetry",
    "window_step_faults", "window_step_guards", "window_step_elastic",
    "window_step_trace", "window_step_workload", "window_step_flows",
    "window_step_compute",
)

#: the subset `bench` records in its JSON `sections` (the JAX bench's)
BENCH_SECTIONS = (
    "rebase_refill", "qdisc_sort", "token_gate", "loss_latency",
    "ingress_compact", "routing_scatter", "routing_rank", "routing_place",
    "release_due", "egress_compact", "ingest_rows", "window_step",
    "window_chain8",
)

#: argument positions a section writes in place (the compacted ingress
#: rings kernels B and D and their plain version update)
MUTATED_ARGS = {"routing_scatter": tuple(range(6, 12)),
                "routing_place": tuple(range(9, 15))}


def build_world(n_hosts: int, *, n_nodes: int = 64, egress_cap: int = 16,
                ingress_cap: int = 32, seed: int = 0,
                warmup_windows: int = 3, down_bw_bps: int | None = None,
                seed_packets: int = 4, device=None) -> dict:
    """The bench.py PHOLD world: node-level path tables from `seed`,
    `seed_packets` packets of 1400 B per host to hashed destinations
    appended by the flat `ingest`, then `warmup_windows` full windows.

    `down_bw_bps` (bits/s, None: unlimited, as in the JAX bench) gives
    every host that downlink and starts its relay bucket full: the
    world of the router AQM (`window_step(router_aqm=True)`)."""
    device = resolve_device(device)
    N, M = n_hosts, n_nodes
    rng = np.random.default_rng(seed)
    lat = rng.integers(1 * MS, 50 * MS, size=(M, M), dtype=np.int32)
    lat = np.minimum(lat, lat.T)
    loss = np.full((M, M), 0.01, np.float32)
    host_node = (np.arange(N) % M).astype(np.int32)
    bw = np.full((N,), 10_000_000_000, np.int64)
    params = make_params(
        lat, loss, bw, host_node=host_node, device=device,
        down_bw_bps=None if down_bw_bps is None else np.full(N, down_bw_bps))
    state = make_state(N, egress_cap=egress_cap, ingress_cap=ingress_cap,
                       initial_tokens=params.tb_cap,
                       initial_dn_tokens=(None if down_bw_bps is None
                                          else params.dn_cap), device=device)
    k = seed_packets
    i64 = dict(dtype=torch.int64, device=device)
    src0 = torch.arange(N, **i64).repeat_interleave(k)
    dst0 = floormod(wrap_i32(src0 * 1566083941
                             + torch.arange(k, **i64).repeat(N) * 40503
                             + 1), N)
    b0 = src0.shape[0]
    ids = torch.arange(b0, dtype=torch.int32, device=device)
    state = ingest(state, src0.to(torch.int32), dst0,
                   torch.full((b0,), 1400, dtype=torch.int32, device=device),
                   ids, ids, torch.zeros(b0, dtype=torch.bool, device=device))
    window = 10 * MS
    shift = 0
    delivered = None
    for _ in range(warmup_windows):
        state, delivered, _next = window_step(
            state, params, RNG_SEED, shift, window, rr_enabled=False,
            kernel="pallas_fused")
        shift = window
    return {
        "state": state, "params": params, "rng_root": RNG_SEED,
        "shift": window, "window": window, "delivered": delivered,
        "egress_cap": egress_cap, "ingress_cap": ingress_cap,
    }


@functools.lru_cache(maxsize=4)
def _onoff_program(n_hosts: int, egress_cap: int, ingress_cap: int):
    """The `window_step_workload` section's traffic: an onoff program over
    every host (its host-side compile takes seconds at the bench's width,
    so a process compiles each shape once; the program is read-only)."""
    from ..workloads.compile import compile_program
    from ..workloads.spec import parse_scenario

    return compile_program(parse_scenario({
        "name": "profile-onoff", "hosts": n_hosts,
        "egress_cap": egress_cap, "ingress_cap": ingress_cap,
        "patterns": [{"kind": "onoff", "burst": 2, "rounds": 4,
                      "gap_ns": 200_000, "off_mean_ns": 2_000_000}],
    }))


def fresh_args(name: str, args: tuple) -> tuple:
    """`args` with clones of what section `name` writes in place."""
    mutated = MUTATED_ARGS.get(name, ())
    return tuple(a.clone() if i in mutated else a
                 for i, a in enumerate(args))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn, args, reps: int, *, device: torch.device,
               mutated=()) -> dict:
    """Min and median wall time of a section, synchronising the card
    around every call; the inputs at `mutated` are cloned before each
    call's clock starts."""
    fresh = lambda: tuple(a.clone() if i in mutated else a
                          for i, a in enumerate(args))
    fn(*fresh())
    _sync(device)  # the first call outside the timing
    times = []
    for _ in range(reps):
        a = fresh()
        _sync(device)
        t0 = time.perf_counter()
        fn(*a)
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "min_ms": round(times[0] * 1e3, 4),
        "median_ms": round(times[len(times) // 2] * 1e3, 4),
        "reps": reps,
    }


def section_calls(world: dict, *, kernel: str = "xla",
                  rr_enabled: bool = False, wanted=DEFAULT_SECTIONS,
                  plain: bool = False, packed_sort: bool = True) -> dict:
    """Each wanted section of the window step on `world` (a
    `build_world` dict) as {name: (fn, args)}: `fn(*fresh_args(name,
    args))` runs it once. Each section's inputs are computed here,
    untimed, through the plain versions of the kernels (so the set-up
    launches nothing). `plain=True` runs every section through the plain
    versions too (the reference a card run is held against); otherwise
    CUDA tensors go through the kernels `kernel` selects, as in
    `window_step`. `packed_sort=False` runs every section that sorts
    through JAX's pre-diet variadic sorts ("xla" only)."""
    plane._check_step_options(kernel, rr_enabled, packed_sort, {})
    ps = dict(packed_sort=packed_sort)
    wanted = tuple(wanted)
    unknown = sorted(set(wanted) - set(DEFAULT_SECTIONS))
    if unknown:
        raise ValueError(f"unknown sections {unknown}: expected names from "
                         f"{DEFAULT_SECTIONS}")
    state, params = world["state"], world["params"]
    seed, shift, window = world["rng_root"], world["shift"], world["window"]
    N, CI = state.in_src.shape
    M = params.latency_ns.shape[0]
    dev = state.in_src.device

    def step(st, sh, *, kernel=kernel, **planes):
        return window_step(st, params, seed, sh, window,
                           rr_enabled=rr_enabled, kernel=kernel,
                           plain_kernels=plain, **ps, **planes)

    def rebase_refill(st, sh):
        in_deliver, balance, rem = plane._rebase_refill(st, params, sh)
        return (in_deliver, balance, rem,
                *plane._rebase_egress(st.eg_valid, st.eg_tsend, st.eg_clamp,
                                      sh))

    def loss_latency(st, dst, ctrl, tsend, clamp, sendable):
        return plane._loss_latency(st, params, seed, dst, ctrl, tsend, clamp,
                                   sendable, window, no_loss=False)

    def route(*args):
        return plane._route_scatter(*args, kernel=kernel, plain=plain, **ps)

    # each section's inputs, once
    in_deliver, balance, _rem, tsend_rb, clamp_rb = rebase_refill(state,
                                                                  shift)
    qk1, qk2, _aux = plane._qdisc_keys(state, params, rr_enabled=rr_enabled)
    (eg_prio, eg_sock, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend, eg_clamp,
     eg_valid) = plane._egress_order(state, qk1, qk2, tsend_rb, clamp_rb,
                                     **ps)
    sendable, _bal = plane._token_gate(eg_valid, eg_bytes, balance)
    sent, _lost, _corrupt, _rc, deliver_rel = loss_latency(
        state, eg_dst, eg_ctrl, eg_tsend, eg_clamp, sendable)
    compacted = plane._compact_ingress(state, in_deliver, **ps)
    n_valid_in = compacted[6]
    route_args = (sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                  *compacted)
    (in_src_m, in_seq_m, in_sock_m, in_bytes_m, in_deliver_m, in_valid_m,
     _ovf) = plane._route_scatter(*fresh_args("routing_scatter", route_args),
                                  plain=True, **ps)
    # the routing sub-sections (5a rank, 5b place) of the sort mode; the
    # place inputs are the rank outputs, computed here
    if packed_sort:
        rank = lambda s, d, q, dl, nv: plane._routing_rank(s, d, q, dl, nv,
                                                           CI)
        place = plane._routing_place
        rank_args = (sent, eg_dst, eg_seq, deliver_rel, n_valid_in)
        place_args = (*rank(*rank_args)[:4], n_valid_in, eg_seq, eg_bytes,
                      eg_sock, deliver_rel, *compacted[:6])
    else:
        rank = lambda s, d, q, b, k, dl, nv: plane._routing_rank_legacy(
            s, d, q, b, k, dl, nv, CI)
        place = plane._routing_place_legacy
        rank_args = (sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                     n_valid_in)
        place_args = (*rank(*rank_args)[:7], *compacted[:6])
    merged = (in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
              in_valid_m)

    def fused_stage(st, sh):
        """Sections 1-5b as `kernel` composes them: the span the fused
        pair covers, ending at the due release on every kernel."""
        in_dl, balance2, _rem2 = plane._rebase_refill(st, params, sh)
        if kernel == "pallas_fused":
            rank_stage = (pipeline.egress_rank_plain if plain
                          else pipeline.egress_rank_stage)
            (_p, f_sock, f_dst, f_bytes, f_seq, f_ctrl, f_tsend, f_clamp,
             _v, f_send, _spent, f_perm) = rank_stage(
                st.eg_valid, st.eg_prio, st.eg_bytes, st.eg_tsend,
                st.eg_clamp, st.eg_dst, st.eg_seq, st.eg_sock, st.eg_ctrl,
                balance2, sh)
            f_sent, _l, _c, _rc, f_dr = loss_latency(
                st, f_dst, f_ctrl, f_tsend, f_clamp, f_send)
            *m, f_ovf = pipeline.route_place(
                f_sent, f_dst, f_seq, f_bytes, f_sock, f_dr,
                *plane._compact_ingress(st, in_dl), f_perm, plain=plain)
        else:
            qk1f, qk2f, _af = plane._qdisc_keys(st, params,
                                                rr_enabled=rr_enabled)
            if kernel == "pallas" and not plain:
                (perm, f_bytes, f_tsend, f_clamp, _v, f_send,
                 _spent) = pipeline.egress_order_gate(
                    st.eg_valid, st.eg_prio, st.eg_bytes, st.eg_tsend,
                    st.eg_clamp, balance2, sh)
                _p, f_sock, f_dst, f_seq, f_ctrl = plane._take_egress(st,
                                                                      perm)
            else:
                (_p, f_sock, f_dst, f_bytes, f_seq, f_ctrl, f_tsend, f_clamp,
                 f_valid) = plane._egress_order(
                    st, qk1f, qk2f,
                    *plane._rebase_egress(st.eg_valid, st.eg_tsend,
                                          st.eg_clamp, sh), **ps)
                f_send, _b = plane._token_gate(f_valid, f_bytes, balance2)
            f_sent, _l, _c, _rc, f_dr = loss_latency(
                st, f_dst, f_ctrl, f_tsend, f_clamp, f_send)
            *m, f_ovf = route(f_sent, f_dst, f_seq, f_bytes, f_sock, f_dr,
                              *plane._compact_ingress(st, in_dl, **ps))
        m_src, m_seq, m_sock, m_bytes, m_del, m_valid = m
        return f_ovf, plane._release_due(m_del, m_src, m_seq, m_sock,
                                         m_bytes, m_valid, window, **ps)

    def chain8(st, sh):
        """Eight windows back to back: the driver's chain unit."""
        total = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(8):
            st, delivered, _nx = step(st, sh)
            total = total + delivered["mask"].sum(dtype=torch.int32)
            sh = window
        return st, total

    def elastic_probe(st, sh):
        out = step(st, sh)
        ovf = out[0].n_overflow_dropped - st.n_overflow_dropped
        return (*out, ovf, ovf.sum(dtype=torch.int32))

    def presence(name):
        """The (fn, args) of a step with a presence plane, built only when
        wanted (the workload and flow planes cost a host set-up)."""
        from ..faults.plane import neutral_faults
        from ..guards.plane import make_guards
        from ..telemetry.flightrec import make_flightrec
        from ..telemetry.histo import make_histograms
        from ..telemetry.metrics import make_metrics

        if name == "window_step_telemetry":
            return (lambda st, m, sh: step(st, sh, metrics=m),
                    (state, make_metrics(N, device=dev), shift))
        if name == "window_step_faults":
            return (lambda st, f, sh: step(st, sh, kernel="xla", faults=f),
                    (state, neutral_faults(N, M, device=dev), shift))
        if name == "window_step_guards":
            return (lambda st, g, sh: step(st, sh, kernel="xla", guards=g),
                    (state, make_guards(N, device=dev), shift))
        if name == "window_step_trace":
            return (lambda st, h, f, sh: step(st, sh, kernel="xla", hist=h,
                                              flightrec=f),
                    (state, make_histograms(N, device=dev),
                     make_flightrec(0, sample_every=64, ring=4096,
                                    device=dev), shift))
        if name == "window_step_workload":
            from ..workloads import device as wdevice

            prog = _onoff_program(N, state.eg_dst.shape[1], CI)
            wl = wdevice.to_device(prog, dev)

            def probe(st, ws, sh):
                st, delivered, nxt = step(st, sh)
                st, ws = wdevice.workload_step(wl, ws, st, delivered, 1,
                                               window)
                return st, ws, nxt
            return probe, (state, wdevice.make_workload_state(prog, dev),
                           shift)
        if name == "window_step_flows":
            from . import flows

            hosts = np.arange(N, dtype=np.int32)
            ftab = flows.make_flow_tables(hosts, (hosts + 1) % N,
                                          np.full(N, 1400, np.int32),
                                          device=dev)
            return (lambda st, fs, sh: step(st, sh, kernel="xla",
                                            flows=(ftab, fs)),
                    (state, flows.make_flow_state(N, device=dev), shift))
        from . import compute

        ctab = compute.make_compute_tables(
            np.full((N, 1), 25_000, np.int32), 64, device=dev)
        return (lambda st, cs, sh: step(st, sh, kernel="xla",
                                        compute=(ctab, cs)),
                (state, compute.make_compute_state(ctab), shift))

    def ingest_rows():
        """The bench's respawn of the last warm-up window's deliveries
        (its first respawning round), appended."""
        spawn_seq = torch.full((N,), 10_000, dtype=torch.int32, device=dev)
        mask, new_dst, row_bytes, seq_vals, row_ctrl = respawn_batch(
            world["delivered"], spawn_seq, 1, N, CI)
        return (lambda *a: plane.ingest_rows(*a, **ps),
                (state, new_dst, row_bytes, seq_vals, seq_vals, row_ctrl,
                 mask))

    arr_s, _src_s, _seq_s, _sock_s, bytes_s, _valid_s = plane._router_order(
        *merged)
    rt = codel.rebase_router_state(state.router, shift, params.dn_rate,
                                   params.dn_cap)
    calls = {
        "rebase_refill": lambda: (rebase_refill, (state, shift)),
        "rr_tensors": lambda: (
            lambda st: plane._qdisc_keys(st, params, rr_enabled=True),
            (state,)),
        "qdisc_sort": lambda: (lambda *a: plane._egress_order(*a, **ps),
                               (state, qk1, qk2, tsend_rb, clamp_rb)),
        "token_gate": lambda: (plane._token_gate,
                               (eg_valid, eg_bytes, balance)),
        "loss_latency": lambda: (loss_latency, (state, eg_dst, eg_ctrl,
                                                eg_tsend, eg_clamp, sendable)),
        "ingress_compact": lambda: (
            lambda *a: plane._compact_ingress(*a, **ps), (state, in_deliver)),
        "routing_scatter": lambda: (route, route_args),
        "routing_rank": lambda: (rank, rank_args),
        "routing_place": lambda: (place, place_args),
        "release_due": lambda: (
            lambda *a: plane._release_due(*a, window, **ps),
            (in_deliver_m, in_src_m, in_seq_m, in_sock_m, in_bytes_m,
             in_valid_m)),
        "codel_drain": lambda: (
            lambda a, b, r: codel.router_drain(a, b, window, params.dn_rate,
                                               params.dn_cap, r, plain=plain),
            (arr_s, bytes_s, rt)),
        "egress_compact": lambda: (
            lambda *a: plane._compact_egress(*a, **ps),
            (eg_prio, eg_dst, eg_bytes, eg_seq, eg_ctrl, eg_tsend, eg_clamp,
             eg_sock, eg_valid & ~sendable)),
        "ingest_rows": ingest_rows,
        "fused_stage": lambda: (fused_stage, (state, shift)),
        "window_step": lambda: (step, (state, shift)),
        "window_chain8": lambda: (chain8, (state, shift)),
        "window_step_elastic": lambda: (elastic_probe, (state, shift)),
    }
    return {name: (calls[name]() if name in calls else presence(name))
            for name in wanted}


def profile_sections(n_hosts: int, *, reps: int = 20, sections=None,
                     rr_enabled: bool = False, packed_sort: bool = True,
                     kernel: str = "xla", n_nodes: int = 64,
                     egress_cap: int = 16, ingress_cap: int = 32,
                     seed: int = 0, device=None) -> dict:
    """Time each window-step section at the given bench shape (the JAX
    `profile_sections`, with its record's keys). Returns a JSON-ready
    dict; `backend` names the device as `jax.default_backend()` names
    its platforms ("gpu" for a CUDA card, "cpu"). `packed_sort=False`
    times JAX's pre-diet variadic sorts ("xla" only, as in JAX)."""
    device = resolve_device(device)
    wanted = tuple(sections) if sections is not None else DEFAULT_SECTIONS
    world = build_world(n_hosts, n_nodes=n_nodes, egress_cap=egress_cap,
                        ingress_cap=ingress_cap, seed=seed, device=device)
    calls = section_calls(world, kernel=kernel, rr_enabled=rr_enabled,
                          wanted=wanted, packed_sort=packed_sort)
    out_sections = {}
    for name in wanted:
        fn, args = calls[name]
        out_sections[name] = _time_call(fn, args, reps, device=device,
                                        mutated=MUTATED_ARGS.get(name, ()))
    return {
        "hosts": n_hosts,
        "egress_cap": egress_cap,
        "ingress_cap": ingress_cap,
        "nodes": n_nodes,
        "backend": "gpu" if device.type == "cuda" else device.type,
        "rr_enabled": rr_enabled,
        "packed_sort": packed_sort,
        "kernel": kernel,
        "sections": out_sections,
    }

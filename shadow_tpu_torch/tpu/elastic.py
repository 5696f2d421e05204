"""Elastic ring growth and the chained-window driver loop.

Counterpart of `shadow_tpu/tpu/elastic.py`: `ring_dims`, `grow_state`,
`canonical_state`, `chain_spans`, `run_elastic_window` and
`drive_chained_windows` under the capacity policy of
`core/capacity.py`, with the memo (`tpu/memo.py`), the run tracer
(`telemetry/tracer.py`), the full-run checkpointer
(`faults/runstate.py`) and per-round inputs; and the ensemble driver
`drive_ensemble` with its per-world keys (`world_key`, `world_keys`).

Growth is invisible to the window step: live lanes are front-packed, so
they keep their columns when a ring widens; every sort in `window_step`
is stable with invalid-last keys, so the new all-invalid columns sort
behind the live lanes; and every consumer masks by validity. What growth
does not keep is the dead lanes' payload, which each run permutes from
its own history; `canonical_state` sets those lanes to the `make_state`
fills, so a grown run and one pre-provisioned at the final capacity
compare bitwise.

A chain is the caller's Python loop of windows r0..r1-1 that reads the
device back at its end; the host regains control only between chains.
Under a policy the chain is the growth-decision unit: it is attempted
from its start state, its per-ring overflow is read back once, and an
overflowing chain is discarded and re-run from that snapshot against
grown rings. So nothing a chain runs may write a tensor in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.capacity import (CAPACITY_MODES, CapacityError,  # noqa: F401
                             CapacityTrajectory, RingPolicy, next_pow2)
from .. import resolve_device
from .prims import I32_MAX, NO_CLAMP, fold_in


def ring_dims(state) -> tuple[int, int]:
    """(egress_cap, ingress_cap) of a `plane.NetPlaneState`."""
    return int(state.eg_dst.shape[1]), int(state.in_src.shape[1])


def _pad_cols(t: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Widen a [N, C] ring to [N, width] with `fill` in the new lanes."""
    n, c = t.shape
    if width == c:
        return t
    block = torch.full((n, width - c), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, block], dim=1)


def grow_state(state, new_egress_cap: int, new_ingress_cap: int):
    """Repack a `plane.NetPlaneState` into wider rings, bitwise: every
    existing column moves unchanged, and the new trailing lanes carry the
    `make_state` fills (-1 dst/src, I32_MAX priority and deliver,
    NO_CLAMP, zeros elsewhere, invalid). Per-host tensors, the RR
    counters and the router state pass through. Shrinking is refused: it
    could drop live packets. Returns `state` itself when nothing grows."""
    ce, ci = ring_dims(state)
    if new_egress_cap < ce or new_ingress_cap < ci:
        raise ValueError(
            f"grow_state cannot shrink rings: have (CE={ce}, CI={ci}), "
            f"asked for (CE={new_egress_cap}, CI={new_ingress_cap})")
    if (new_egress_cap, new_ingress_cap) == (ce, ci):
        return state
    eg = lambda t, fill: _pad_cols(t, new_egress_cap, fill)
    ing = lambda t, fill: _pad_cols(t, new_ingress_cap, fill)
    return state._replace(
        eg_dst=eg(state.eg_dst, -1), eg_bytes=eg(state.eg_bytes, 0),
        eg_prio=eg(state.eg_prio, I32_MAX), eg_seq=eg(state.eg_seq, 0),
        eg_ctrl=eg(state.eg_ctrl, False), eg_tsend=eg(state.eg_tsend, 0),
        eg_clamp=eg(state.eg_clamp, NO_CLAMP), eg_sock=eg(state.eg_sock, 0),
        eg_valid=eg(state.eg_valid, False),
        in_src=ing(state.in_src, -1), in_bytes=ing(state.in_bytes, 0),
        in_seq=ing(state.in_seq, 0), in_sock=ing(state.in_sock, 0),
        in_deliver_rel=ing(state.in_deliver_rel, I32_MAX),
        in_valid=ing(state.in_valid, False),
    )


def grow_transport_state(state, new_ingress_cap: int):
    """Repack a `transport.TransportState` into wider per-destination
    in-flight rings. Transport slots are sparse (never compacted) and its
    ingest fills the lowest free columns first, so while no packet was
    overflow-dropped the grown state is bitwise a run pre-provisioned at
    the wider capacity, dead lanes included: the new lanes carry the
    construction fills (0, I32_MAX deliver, invalid). Shrinking is
    refused; returns `state` itself when nothing grows."""
    ci = int(state.in_src.shape[1])
    if new_ingress_cap < ci:
        raise ValueError(
            f"grow_transport_state cannot shrink: have CI={ci}, asked "
            f"for {new_ingress_cap}")
    if new_ingress_cap == ci:
        return state
    pad = lambda t, fill: _pad_cols(t, new_ingress_cap, fill)
    return state._replace(
        in_src=pad(state.in_src, 0), in_seq=pad(state.in_seq, 0),
        in_tag=pad(state.in_tag, 0),
        in_deliver=pad(state.in_deliver, I32_MAX),
        in_valid=pad(state.in_valid, False),
    )


def canonical_state(state):
    """Set a `NetPlaneState`'s dead lanes to the `make_state` fills,
    leaving live lanes and every per-host tensor untouched. Dead-lane
    payload is outside the determinism contract (every consumer masks by
    validity) and is the one thing a grown run cannot reproduce, so the
    elastic-vs-pre-provisioned comparison is between canonical states."""
    ev, iv = state.eg_valid, state.in_valid
    w = torch.where
    return state._replace(
        eg_dst=w(ev, state.eg_dst, -1), eg_bytes=w(ev, state.eg_bytes, 0),
        eg_prio=w(ev, state.eg_prio, I32_MAX),
        eg_seq=w(ev, state.eg_seq, 0), eg_ctrl=state.eg_ctrl & ev,
        eg_tsend=w(ev, state.eg_tsend, 0),
        eg_clamp=w(ev, state.eg_clamp, NO_CLAMP),
        eg_sock=w(ev, state.eg_sock, 0),
        in_src=w(iv, state.in_src, -1), in_bytes=w(iv, state.in_bytes, 0),
        in_seq=w(iv, state.in_seq, 0), in_sock=w(iv, state.in_sock, 0),
        in_deliver_rel=w(iv, state.in_deliver_rel, I32_MAX),
    )


def chain_spans(n_rounds: int, chain_len: int, *, start_round: int = 0,
                boundaries=()) -> list[tuple[int, int]]:
    """The driver's chain partition: [start_round, n_rounds) split at
    every absolute `chain_len` multiple and at every explicit boundary
    round, as [r0, r1) pairs (empty spans dropped). The cuts are aligned
    to round 0, not to `start_round`, so a run resumed at a round
    partitions what remains as the whole run did, and under the elastic
    policy grows the same trajectory."""
    if chain_len < 1:
        raise ValueError(f"chain_len must be >= 1, got {chain_len}")
    if start_round >= n_rounds:
        return []
    cuts = {start_round, n_rounds}
    first = ((start_round // chain_len) + 1) * chain_len
    cuts.update(range(first, n_rounds, chain_len))
    cuts.update(b for b in boundaries if start_round < b < n_rounds)
    edges = sorted(cuts)
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _host(x) -> np.ndarray:
    """An overflow count (tensor or number) as a 1-d numpy array: the
    driver's one read of the device per chain attempt."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(x))


def _global_overflow(mesh, x):
    """An overflow count of a host-axis mesh rank as the fleet's: a
    per-host tensor gathered in host order, a 0-d one summed over the
    ranks (every rank then decides alike)."""
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    return mesh.gather_leaf(x) if x.dim() else mesh.all_sum(x)


def run_elastic_window(state, attempt_fn, policy: RingPolicy, *,
                       time_ns: int, host_names=None, mesh=None):
    """One chain of windows under the capacity policy.

    `attempt_fn(state)` runs the chain from `state` and returns (out,
    eg_overflow, in_overflow): what the driver commits, and the per-host
    [N] (or scalar) ring-full drops of the egress (append-side) and
    ingress (routing-side) rings. It must be a pure function of `state`
    and what its closure holds.

    fixed: commit the attempt; the first drop of a ring lands a
    trajectory event. strict: raise `CapacityError` with per-host blame.
    elastic: grow the overflowing ring(s) of the pre-attempt state and
    re-run, bounded by the policy's `max_doublings` per dimension (once
    exhausted, the overflowing attempt is committed and its drops are
    real). Returns (out, state_used), the pre-chain state the committed
    attempt ran from.

    Under a host-axis `mesh` the state is a rank's rows and the
    overflows are gathered before the decision, so every rank grows,
    commits or raises alike and the strict policy blames global
    hosts."""
    while True:
        out, eg_ovf, in_ovf = attempt_fn(state)
        eg_arr = _host(_global_overflow(mesh, eg_ovf))
        in_arr = _host(_global_overflow(mesh, in_ovf))
        eg_total, in_total = int(eg_arr.sum()), int(in_arr.sum())
        if eg_total == 0 and in_total == 0:
            return out, state
        if policy.mode == "strict":
            blame = sorted(set(np.nonzero(eg_arr)[0].tolist())
                           | set(np.nonzero(in_arr)[0].tolist()))
            if host_names:
                blame = [host_names[i] if i < len(host_names) else i
                         for i in blame]
            ring = ("egress" if eg_total and not in_total else
                    "ingress" if in_total and not eg_total else
                    "egress+ingress")
            raise CapacityError(
                f"ring-full overflow under capacity.mode=strict: "
                f"{eg_total} egress + {in_total} ingress drop(s) in the "
                f"window at t={time_ns} ns (caps CE={policy.egress_cap}, "
                f"CI={policy.ingress_cap}); raise the ring capacities or "
                f"run capacity.mode=elastic", ring=ring, blame=blame)
        if policy.mode != "elastic":
            if eg_total:
                policy.note_drop(ring="egress", overflow=eg_total,
                                 time_ns=time_ns)
            if in_total:
                policy.note_drop(ring="ingress", overflow=in_total,
                                 time_ns=time_ns)
            return out, state
        target = policy.plan_growth(eg_overflow=eg_total,
                                    in_overflow=in_total, time_ns=time_ns)
        if target is None:  # growth budget exhausted: the drops are real
            return out, state
        state = grow_state(state, *target)


def drive_chained_windows(state, extras, chain_fn, *, n_rounds: int,
                          chain_len: int, start_round: int = 0,
                          boundaries=(), per_round=None,
                          policy: RingPolicy | None = None,
                          window_ns: int = 0, host_names=None,
                          on_chain=None, memo=None, memo_span_salt=None,
                          tracer=None, checkpointer=None, mesh=None):
    """The driver loop: run `chain_fn(state, extras, r0, r1) -> (state',
    extras', eg_overflow, in_overflow)` over the `chain_spans`, the
    overflows being the chain's per-host ring-full drops. With
    `per_round`, `chain_fn` takes a fifth argument, `per_round(r0, r1)`:
    the span's per-window inputs, built on the host before it runs.

    Without a policy the overflows are ignored. Under `policy`, every
    chain runs through `run_elastic_window` from its start state (one
    snapshot a chain), and a `CapacityError` it raises carries
    `chain_span` = (r0, r1). `on_chain(r1, state, extras)` runs after
    every committed chain; a (state, extras) pair it returns replaces
    the carried one. Returns the final (state, extras).

    `memo` (a `tpu/memo.ChainMemo`) makes the span the memo unit: at
    each boundary the carry's host copy is keyed; a hit replays the
    recorded post-span carry instead of running it, and hits in a row
    with no `on_chain` stay on the host (mode "ffwd"; with a hook the
    carry is uploaded for it, mode "replay"). A miss runs (under
    `policy` too) and records. `memo_span_salt(r0, r1) -> bytes` folds
    the span's outside inputs into the key (the fault schedule's span
    fingerprint) and is required with `per_round`.

    `tracer` (a `telemetry/tracer.RunTracer`) gets one span record a
    chain, from host clocks read where the loop already is on the host:
    the wall split (dispatch, memo bookkeeping, hook), the mode, the
    span's capacity events and the span salt's hex. It adds no device
    synchronise.

    `checkpointer` (a `faults/runstate.RunCheckpointer`) adds its
    instants to the boundaries and saves the whole carry at each one
    after `on_chain`, so the carry saved is the one the next span starts
    from; on the memo's host path it saves the host mirror as it is. A
    run killed at a boundary and resumed from its checkpoint ends as the
    uninterrupted run.

    `mesh` (a `tpu/mesh.Mesh`): `chain_fn` runs a host-axis mesh rank's
    rows, and the policy's decisions read the fleet's overflows
    (`run_elastic_window`). The memo and the checkpointer are refused
    under a mesh (ValueError), as the JAX runner refuses them: their
    host copy of the carry would hold one rank's rows."""
    if mesh is not None and (memo is not None or checkpointer is not None):
        raise ValueError(
            "drive_chained_windows: the memo and the checkpointer do not "
            "run under a host-axis mesh (their host copy of the carry "
            "would hold one rank's rows)")
    if memo is not None and per_round is not None and memo_span_salt is None:
        raise ValueError(
            "drive_chained_windows: memo with per_round inputs needs a "
            "memo_span_salt folding them into the key (e.g. the fault "
            "schedule's span_fingerprint) — refusing to memoize spans "
            "whose external inputs the key cannot see")
    if checkpointer is not None:
        boundaries = tuple(boundaries) + checkpointer.cut_rounds(n_rounds)

    host_carry = None  # the memo's host mirror of (state, extras)
    stale = False  # the tensors are behind host_carry (hits pending)

    def _upload():
        nonlocal state, extras, stale
        state, extras = memo.to_device(host_carry)
        stale = False

    def _maybe_checkpoint(r1):
        # after on_chain: the carry saved is the one the next span starts
        # from; an authoritative host mirror is saved with no device read
        if checkpointer is None or not checkpointer.due(r1, n_rounds):
            return
        carry = host_carry if host_carry is not None else (state, extras)
        checkpointer.save(r1, carry, host=host_carry is not None,
                          tracer=tracer)

    clock = tracer.clock if tracer is not None else (lambda: 0.0)
    for r0, r1 in chain_spans(n_rounds, chain_len, start_round=start_round,
                              boundaries=boundaries):
        t0 = clock()
        salt_hex = None
        salt = b""
        if memo_span_salt is not None and (memo is not None
                                           or tracer is not None):
            salt = memo_span_salt(r0, r1)
            if tracer is not None:
                salt_hex = salt.hex()
        if memo is not None:
            if host_carry is None:
                host_carry = memo.snapshot(state, extras)
            key, pre_walk = memo.key(host_carry, r0, r1, span_salt=salt)
            entry = memo.lookup(key)
            if entry is not None:
                host_carry = memo.replay(entry, host_carry)
                stale = True
                mode, hook_ms = "ffwd", 0.0
                if on_chain is not None:
                    mode = "replay"
                    _upload()
                    th = clock()
                    replaced = on_chain(r1, state, extras)
                    hook_ms = (clock() - th) * 1e3
                    if replaced is not None:
                        state, extras = replaced
                        host_carry = None  # the tensors are authoritative
                if tracer is not None:
                    tracer.span(r0, r1, mode=mode, t0=t0, hook_ms=hook_ms,
                                span_salt=salt_hex)
                _maybe_checkpoint(r1)
                continue
            if stale:
                _upload()
        args = (r0, r1) if per_round is None else (r0, r1,
                                                   per_round(r0, r1))
        growth = None
        if policy is None:
            state, extras, _eg, _in = chain_fn(state, extras, *args)
        else:
            def attempt(st, _ex=extras, _args=args):
                st2, ex2, eg, inn = chain_fn(st, _ex, *_args)
                return (st2, ex2), eg, inn

            n_events = len(policy.trajectory.events)
            try:
                (state, extras), _used = run_elastic_window(
                    state, attempt, policy, time_ns=r0 * int(window_ns),
                    host_names=host_names, mesh=mesh)
            except CapacityError as e:
                # the overflow is seen per chain, so the span is the
                # blame unit
                e.chain_span = (r0, r1)
                raise
            growth = policy.trajectory.events[n_events:]
        dispatch_ms = (clock() - t0) * 1e3
        memo_ms = 0.0
        if memo is not None:
            tm = clock()
            host_carry = memo.snapshot(state, extras)
            memo.record(key, pre_walk, host_carry, span_len=r1 - r0)
            memo_ms = (clock() - tm) * 1e3
        hook_ms = 0.0
        if on_chain is not None:
            th = clock()
            replaced = on_chain(r1, state, extras)
            hook_ms = (clock() - th) * 1e3
            if replaced is not None:
                state, extras = replaced
                host_carry = None
        if tracer is not None:
            tracer.span(r0, r1, mode="execute", t0=t0,
                        dispatch_ms=dispatch_ms, memo_ms=memo_ms,
                        hook_ms=hook_ms, growth=growth, span_salt=salt_hex)
        _maybe_checkpoint(r1)
    if stale:
        _upload()
    return state, extras


def world_key(rng_root, seed):
    """The per-world RNG key: `fold_in(rng_root, seed)`, bitwise
    `jax.random.key_data(jax.random.fold_in(root, seed))`. `rng_root` is
    an int seed (the root `jax.random.key(seed)`) or a key tensor; the
    result is an int64 [2] key tensor that `window_step` takes as its
    `rng_seed`. One threefry block under a fixed key is a bijection of
    the seed, so distinct 32-bit seeds give distinct world keys."""
    return fold_in(rng_root, seed)


def world_keys(rng_root, seeds, device=None) -> torch.Tensor:
    """The keys of worlds `seeds` (ints, an int array or tensor), [W, 2]:
    the `world_key` of each, in one batched threefry call, on `device`
    (the card by default, as every entry point; a key tensor root's own
    device when it is one and `device` is None)."""
    if isinstance(rng_root, torch.Tensor) and device is None:
        dev = rng_root.device
    else:
        dev = resolve_device(device)
        if isinstance(rng_root, torch.Tensor):
            rng_root = rng_root.to(dev)
    seeds = torch.as_tensor(seeds).to(device=dev, dtype=torch.int64)
    return world_key(rng_root, seeds)


def _map_leaves(fn, tree):
    """`tree` (tuples, NamedTuples, lists, dicts) with `fn` applied to
    every leaf: a tensor, or anything else (None for a plane that is
    off, a Python number)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_worlds(tree, n_worlds: int):
    """`n_worlds` copies of a solo carry as one batched carry: every
    tensor leaf repeated on a new leading world axis."""
    return _map_leaves(lambda t: torch.stack([t] * n_worlds)
                       if isinstance(t, torch.Tensor) else t, tree)


def world_slice(tree, w: int):
    """World `w` of a batched carry, as a solo carry (views)."""
    return _map_leaves(lambda t: t[w] if isinstance(t, torch.Tensor) else t,
                       tree)


def drive_ensemble(states, extras, chain_fn, *, n_rounds: int,
                   chain_len: int, start_round: int = 0, boundaries=(),
                   per_round=None, per_round_axis=None, on_chain=None,
                   tracer=None, checkpointer=None):
    """W independent worlds run the same chained-window schedule as one
    batched program: `torch.func.vmap` of the very `chain_fn` that
    `drive_chained_windows` drives solo, over the leading world axis of
    `states` and of every tensor of `extras`, the JAX driver's
    `jax.vmap`. The round bounds (r0, r1) are shared, so every world
    sees the same chain partition as its solo run (`chain_spans`);
    per-world inputs (the `world_keys`, schedules, workload parameters)
    ride `extras`, or `per_round(r0, r1)` (a fifth `chain_fn` argument)
    batched on `per_round_axis` (None: shared).

    Every hand-written kernel the chain reaches is a custom op whose
    vmap rule launches it once for all W worlds (`tpu/ops.py`): a chain
    of K windows launches each of its kernels K times, whatever W.

    As in JAX: no capacity policy (ring growth is per world, and one
    world's growth would reshape every world's rings), so ensembles run
    at fixed capacity and the chain's overflow counts are dropped;
    `on_chain(r1, states, extras)` once a chain, for the whole ensemble
    (a (states, extras) pair it returns replaces the carry);
    `tracer` gets one `mode="ensemble"` span a chain (dispatch and hook
    milliseconds from host clocks, no synchronise); `checkpointer`'s
    instants join the boundaries and it saves the batched carry, [W,
    ...] leaves, in one file. Returns the final batched (states,
    extras)."""
    def vchain(states, extras, *args):
        # every tensor of the carry is batched; a leaf that is not one
        # (a plane that is off) is not
        in_dims = (0, _map_leaves(
            lambda t: 0 if isinstance(t, torch.Tensor) else None, extras),
            None, None)
        if per_round is not None:
            in_dims += (per_round_axis,)
        return torch.func.vmap(chain_fn, in_dims=in_dims)(
            states, extras, *args)

    if checkpointer is not None:
        boundaries = tuple(boundaries) + checkpointer.cut_rounds(n_rounds)
    clock = tracer.clock if tracer is not None else (lambda: 0.0)
    for r0, r1 in chain_spans(n_rounds, chain_len, start_round=start_round,
                              boundaries=boundaries):
        t0 = clock()
        args = (r0, r1) if per_round is None else (r0, r1,
                                                   per_round(r0, r1))
        states, extras, _eg, _in = vchain(states, extras, *args)
        dispatch_ms = (clock() - t0) * 1e3
        hook_ms = 0.0
        if on_chain is not None:
            th = clock()
            replaced = on_chain(r1, states, extras)
            hook_ms = (clock() - th) * 1e3
            if replaced is not None:
                states, extras = replaced
        if tracer is not None:
            tracer.span(r0, r1, mode="ensemble", t0=t0,
                        dispatch_ms=dispatch_ms, hook_ms=hook_ms)
        if checkpointer is not None and checkpointer.due(r1, n_rounds):
            checkpointer.save(r1, (states, extras), tracer=tracer)
    return states, extras

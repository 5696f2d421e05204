"""Device-resident inter-host transport for live simulations.

Counterpart of `shadow_tpu/tpu/transport.py`. A simulation whose hosts
run on the CPU (the JAX package's `Manager`, or a replay of its call
log, `tools/transport_replay.py`) hands each cross-host packet to
`DeviceTransport.capture` in place of pushing it to the destination;
the transport keeps it in per-destination in-flight slots on the device
and releases it into the destination's event queue in the window it is
due, under the same (time, src_host_id, src_event_id) keys, so event
order equals the CPU transport's bit for bit:

- `capture` (any worker thread) takes a pool tag for the packet and
  queues one row; it is pure Python under one lock;
- `finish_round` ingests the round's rows: `ingest` computes each
  deliver time, max(send + latency, round end), and places it in the
  lowest free slot of its destination;
- `release` runs the window step: sync mode releases what is due,
  chains through delivery-free windows on the device (`chain`) and reads
  the compacted released set back once; mirrored mode leaves the
  delivery to the CPU and replays the windows on the device in batches
  of K (`batch_verify`), each window's released set reduced to a count
  and a u32 fingerprint pair compared with the CPU ledger's, the
  divergence counter read once, at `finalize`.

The JAX kernels are `jax.jit` closures; here they are plain functions on
tensors that take the state and return the next one, out of place
(nothing here writes a tensor that another holder may still read):
`guard_update`, `hist_step`, `ingest`, `step`, `fingerprint`,
`step_compact`, `chain`, `batch_verify`, `ingest_guarded`. The JAX
`lax.while_loop` of `chain` reads the host once a chained window (one
small tensor: the continue flag and the next event), as
`plane.chain_windows` does; the `lax.scan` of `batch_verify` is a Python
loop that reads nothing back. int32 arithmetic that can leave int32 is
done in int64 and wrapped; the u32 fingerprint is int64 masked to 32
bits after every multiply and add.

`DeviceTransport(..., device=None)` runs on the CUDA card and raises
without one; `device="cpu"` runs the same functions on the CPU.
`mode="auto"` times a small device-to-host read and picks sync below
2.0 ms, as JAX does. A dispatch that raises a transient error is retried
on the same device (`faults/healing.retry_transient`) and raises after
its retries; it never falls back.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time as _walltime
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.capacity import CapacityError, CapacityTrajectory, next_pow2
from .prims import I32_MAX, wrap_i32

log = logging.getLogger("shadow_tpu_torch.tpu")

# capture row columns: src, dst, seq, tag, send_abs, clamp_abs
_NCOL = 6

_MIX_A = 2654435761  # Knuth multiplicative
_MIX_B = 2246822519  # xxhash prime
_MIX_C = 3266489917  # xxhash prime 3
_MIX_D = 668265263  # xxhash prime 4
_M32 = 0xFFFFFFFF


def _fingerprint_np(tags: np.ndarray, deliver_rel: np.ndarray):
    """Order-independent fingerprint pair of a released set, numpy twin of
    `fingerprint` (the same wrap-around u32 arithmetic): two independent
    u32 mixes of each (tag, deliver) pair, summed modulo 2**32."""
    a, b, c, k = (np.uint32(m) for m in (_MIX_A, _MIX_B, _MIX_C, _MIX_D))
    t = tags.astype(np.uint32)
    d = deliver_rel.astype(np.uint32)
    h1 = ((t * a) ^ d) * b
    h2 = ((t * c) ^ (d * k)) + (h1 >> 16)
    return int(h1.sum(dtype=np.uint32)), int(h2.sum(dtype=np.uint32))


def _probe_d2h_ms(device: torch.device) -> float:
    """Median wall cost of reading a fresh 64-element result back to the
    host (the blocking read sync mode pays each delivering window), after
    one warm-up read."""
    x = torch.zeros(64, dtype=torch.int32, device=device)
    (x + 1).cpu()
    costs = []
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # the probe picks sync or mirrored, which give the same results:
        # this wall read changes speed only
        t0 = _walltime.monotonic()
        (x + 1).cpu()
        costs.append(_walltime.monotonic() - t0)
    return sorted(costs)[1] * 1e3


class TransportState(NamedTuple):
    """Sparse per-destination in-flight slots, axis 0 = destination host.
    Slots are not compacted: release clears valid bits, ingest fills the
    lowest free columns."""

    in_src: torch.Tensor  # int32 [N, CI]
    in_seq: torch.Tensor  # int32 [N, CI]
    in_tag: torch.Tensor  # int32 [N, CI] host-side pool slot
    in_deliver: torch.Tensor  # int32 [N, CI] rel to the device base
    in_valid: torch.Tensor  # bool [N, CI]
    n_overflow: torch.Tensor  # int32 [N]
    n_out: torch.Tensor  # int32 [N] packets ingested per source host
    n_released: torch.Tensor  # int32 [N] packets released per dest host


def make_transport_state(n: int, ci: int, device) -> TransportState:
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return TransportState(
        in_src=z(n, ci), in_seq=z(n, ci), in_tag=z(n, ci),
        in_deliver=torch.full((n, ci), I32_MAX, dtype=torch.int32,
                              device=device),
        in_valid=torch.zeros((n, ci), dtype=torch.bool, device=device),
        n_overflow=z(n), n_out=z(n), n_released=z(n))


class TransportGuard(NamedTuple):
    """Scalar invariant accumulator of the transport functions (the guard
    plane): each window re-checks the conservation law (everything
    ingested is released, overflow-dropped or in a slot), that no live
    slot holds the idle sentinel, and clock monotonicity."""

    violations: torch.Tensor  # 0-d int32 bitmask (guards.plane bits)
    first_window: torch.Tensor  # 0-d int32 first violating dispatch
    windows: torch.Tensor  # 0-d int32 guarded dispatches checked


def make_transport_guard(device=None) -> TransportGuard:
    device = resolve_device(device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return TransportGuard(violations=i32(0), first_window=i32(I32_MAX),
                          windows=i32(0))


class TransportHist(NamedTuple):
    """Per-destination log2 histograms of the transport functions."""

    #: [N, B] int32: deliver - send per packet, at the destination
    hist_delivery_ns: torch.Tensor
    #: [N, B] int32: in-flight occupancy sampled once a window step
    hist_qdepth: torch.Tensor


def make_transport_hist(n_hosts: int, device=None) -> TransportHist:
    from ..telemetry.histo import HIST_BUCKETS

    device = resolve_device(device)
    z = lambda: torch.zeros((n_hosts, HIST_BUCKETS), dtype=torch.int32,
                            device=device)
    return TransportHist(hist_delivery_ns=z(), hist_qdepth=z())


# -- the device functions ------------------------------------------------------


def _sum32(t: torch.Tensor) -> torch.Tensor:
    """jnp's int32 `sum` (wrapping), as a 0-d int32 tensor."""
    return wrap_i32(t.sum(dtype=torch.int64))


def _add_at(base: torch.Tensor, idx: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """JAX `base.at[idx].add(vals, mode="drop")` for a [n] int32 base:
    negative indices count from the end, the rest out of range drop."""
    n = base.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    i = torch.where((i >= 0) & (i < n), i, n)
    out = torch.cat([base, base.new_zeros(1)])
    return out.index_add(0, i, vals.to(torch.int32))[:n]


def _put(buf: torch.Tensor, flat: torch.Tensor,
         vals: torch.Tensor) -> torch.Tensor:
    """JAX `buf.reshape(-1).at[flat].set(vals, mode="drop")` with the
    drop slot at `buf.numel()`, out of place."""
    out = torch.cat([buf.reshape(-1), buf.new_zeros(1)])
    out = out.index_copy(0, flat, vals.to(buf.dtype))
    return out[:-1].reshape(buf.shape)


def _stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`jnp.argsort(x, stable=True)` of a bool tensor (sorted as int8:
    bool sorts are not supported everywhere on CUDA)."""
    return torch.sort(x.to(torch.int8), dim=dim, stable=True).indices


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for x in [0, 2**32) as int64 and a u32 constant,
    in 16-bit halves so no product leaves int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * k + (((hi * k) & 0xFFFF) << 16)) & _M32


def guard_update(g: Optional[TransportGuard], st: TransportState, shift,
                 window) -> Optional[TransportGuard]:
    """The guard plane's window check (None passes through): the
    conservation law sum(n_out) - sum(n_released) - sum(n_overflow) ==
    occupied slots, no live slot at the idle deliver sentinel, and a
    non-negative shift and window (Python ints), accumulated as a
    bitmask with the first violating dispatch."""
    if g is None:
        return None
    from ..guards import plane as gp

    occupancy = _sum32(st.in_valid)
    conserved = (wrap_i32(st.n_out.sum(dtype=torch.int64)
                          - st.n_released.sum(dtype=torch.int64)
                          - st.n_overflow.sum(dtype=torch.int64))
                 == occupancy)
    struct_ok = ~(st.in_valid & (st.in_deliver == I32_MAX)).any()
    clock_bad = 0 if (shift >= 0 and window >= 0) else gp.GUARD_CLOCK
    zero = torch.zeros((), dtype=torch.int32, device=st.in_valid.device)
    bad = (torch.where(conserved, zero, gp.GUARD_INGRESS_FLOW)
           | torch.where(struct_ok, zero, gp.GUARD_RING_STRUCT)
           | clock_bad).to(torch.int32)
    hit = (g.violations == 0) & (bad != 0)
    return TransportGuard(
        violations=g.violations | bad,
        first_window=torch.where(hit, g.windows, g.first_window),
        windows=g.windows + 1)


def hist_step(h: Optional[TransportHist],
              st: TransportState) -> Optional[TransportHist]:
    """One in-flight occupancy sample per destination (None passes
    through)."""
    if h is None:
        return None
    from ..telemetry import histo

    return h._replace(hist_qdepth=histo.accum_depth(
        h.hist_qdepth, st.in_valid.sum(dim=1, dtype=torch.int32)))


def ingest(st: TransportState, h: Optional[TransportHist], src, dst, seq,
           tag, send_rel, clamp_rel, valid, *, latency: torch.Tensor,
           host_node: torch.Tensor):
    """Place a capture batch ([B] int32 columns, times relative to the
    device base, `valid` bool) into per-destination free slots, the
    deliver time max(send + latency, round end) computed here; `h`
    accumulates each packet's deliver - send at its destination. Rows are
    grouped by destination with a stable sort (batch order kept within),
    and the k-th row of a destination takes its k-th free column; a row
    past the free columns is counted in `n_overflow`. Returns (st', h')."""
    N, CI = st.in_valid.shape
    B = src.shape[0]
    dev = src.device
    sc = torch.clamp(src, 0, N - 1).to(torch.int64)
    dc = torch.clamp(dst, 0, N - 1).to(torch.int64)
    lat = latency[host_node[sc], host_node[dc]]
    deliver = torch.maximum(
        wrap_i32(send_rel.to(torch.int64) + lat.to(torch.int64)), clamp_rel)
    if h is not None:
        from ..telemetry import histo

        h = h._replace(hist_delivery_ns=histo.accum_scatter(
            h.hist_delivery_ns, dc, histo.bucket_index(wrap_i32(
                deliver.to(torch.int64) - send_rel.to(torch.int64))),
            valid & (dst >= 0) & (dst < N)))
    # group by destination (stable: batch order preserved within)
    dkey = torch.where(valid, dst, torch.full_like(dst, N))
    o_dst, perm = torch.sort(dkey, stable=True)
    o_src, o_seq, o_tag, o_del, o_valid = (
        a[perm] for a in (src, seq, tag, deliver, valid))
    idx = torch.arange(B, dtype=torch.int64, device=dev)
    new_group = torch.ones(B, dtype=torch.bool, device=dev)
    new_group[1:] = o_dst[1:] != o_dst[:-1]
    seg_start = torch.cummax(torch.where(new_group, idx, 0), dim=0).values
    rank = idx - seg_start  # k-th packet for this destination
    # the k-th free column of each row (stable: lowest first)
    free_cols = _stable_argsort(st.in_valid, dim=1)
    n_free = (~st.in_valid).sum(dim=1)
    dsel = torch.clamp(o_dst, 0, N - 1).to(torch.int64)
    live = o_valid & (o_dst < N)
    ok = live & (rank < n_free[dsel])
    col = free_cols[dsel, torch.clamp(rank, max=CI - 1)]
    flat = torch.where(ok, dsel * CI + col, N * CI)
    put = lambda buf, vals: _put(buf, flat, vals)
    zeros = torch.zeros(N, dtype=torch.int32, device=dev)
    incoming = _add_at(zeros, dsel, live)
    placed = _add_at(zeros, dsel, ok)
    st = st._replace(
        in_src=put(st.in_src, o_src), in_seq=put(st.in_seq, o_seq),
        in_tag=put(st.in_tag, o_tag), in_deliver=put(st.in_deliver, o_del),
        in_valid=put(st.in_valid, torch.ones_like(ok)),
        n_overflow=st.n_overflow + (incoming - placed),
        # captured packets per source host (the pads' out-of-range
        # source drops, as JAX's mode="drop" drops it)
        n_out=_add_at(st.n_out, o_src, live))
    return st, h


def step(st: TransportState, shift: int, window: int):
    """One window [0, window) after rebasing the slots by `shift`:
    release = clear the due mask. Returns (st', due, deliver, next_rel),
    `deliver` the rebased times (I32_MAX where idle), `next_rel` the
    earliest deliver still in flight (0-d int32; I32_MAX if none)."""
    rebased = wrap_i32(st.in_deliver.to(torch.int64) - shift)
    deliver = torch.where(st.in_valid, rebased, I32_MAX)
    due = st.in_valid & (deliver < window)
    new_valid = st.in_valid & ~due
    next_rel = torch.where(new_valid, deliver, I32_MAX).min()
    st = st._replace(
        in_deliver=deliver, in_valid=new_valid,
        n_released=st.n_released + due.sum(dim=1, dtype=torch.int32))
    return st, due, deliver, next_rel


def fingerprint(st: TransportState, due: torch.Tensor,
                deliver: torch.Tensor):
    """(fp1, fp2, count) of the released set: each u32 fingerprint is a
    sum modulo 2**32 (int64 0-d tensors holding the u32 value), the count
    a 0-d int32."""
    t = st.in_tag.to(torch.int64) & _M32
    d = deliver.to(torch.int64) & _M32
    h1 = _mul32(_mul32(t, _MIX_A) ^ d, _MIX_B)
    h2 = ((_mul32(t, _MIX_C) ^ _mul32(d, _MIX_D)) + (h1 >> 16)) & _M32
    zero = torch.zeros((), dtype=torch.int64, device=t.device)
    fp1 = torch.where(due, h1, zero).sum() & _M32
    fp2 = torch.where(due, h2, zero).sum() & _M32
    return fp1, fp2, _sum32(due)


def _compact(st: TransportState, due, deliver, cap: int):
    """The released set front-packed into min(cap, N*CI) columns, in slot
    order: (count, dst (-1 past the count), src, seq, tag, deliver)."""
    CI = st.in_valid.shape[1]
    flat = due.reshape(-1)
    idx = _stable_argsort(~flat)[:cap]
    take = lambda a: a.reshape(-1)[idx]
    dst = torch.where(take(due), (idx // CI).to(torch.int32), -1)
    return (_sum32(due), dst, take(st.in_src), take(st.in_seq),
            take(st.in_tag), take(deliver))


def step_compact(st, g, h, shift: int, window: int, *, cap: int):
    """Sync mode: one window, and the released set compacted for one
    small read (the caller raises if the count exceeds `cap`: deliveries
    cannot be dropped). Returns (st, g, h, comp, next_rel, overflow)."""
    st, due, deliver, next_rel = step(st, shift, window)
    g = guard_update(g, st, shift, window)
    h = hist_step(h, st)
    return (st, g, h, _compact(st, due, deliver, cap), next_rel,
            _sum32(st.n_overflow))


#: windows a chain may run, its first included (JAX's while_loop bound)
CHAIN_WINDOWS = 64


def chain(st, g, h, shift0: int, window0: int, runahead: int, horizon: int,
          stop: int, *, cap: int):
    """Sync mode: advance through delivery-free windows (the boundary
    rule of `plane.chain_windows`): the first window runs unconditionally;
    afterwards, while a window delivered nothing and the next event stays
    below both the horizon (earliest CPU-side event) and the stop, the
    next window opens at that event with width min(runahead, stop -
    start), at most CHAIN_WINDOWS windows. Reads the host once after each
    window that could be followed: one small tensor holding the continue
    flag and the next event. Returns (st, g, h, comp, off, next_rel,
    overflow), `off` the last window's start relative to the first."""
    st, due, deliver, next_rel = step(st, shift0, window0)
    g = guard_update(g, st, shift0, window0)
    h = hist_step(h, st)
    hs = min(horizon, stop)
    off, n = 0, 1
    while n < CHAIN_WINDOWS:
        go, nxt = torch.stack([
            ((~due.any()) & (next_rel < hs - off)).to(torch.int32),
            next_rel]).tolist()
        if not go:
            break
        off += nxt
        width = min(runahead, stop - off)
        st, due, deliver, next_rel = step(st, nxt, width)
        g = guard_update(g, st, nxt, width)
        h = hist_step(h, st)
        n += 1
    off_t = torch.tensor(off, dtype=torch.int32, device=next_rel.device)
    return (st, g, h, _compact(st, due, deliver, cap), off_t, next_rel,
            _sum32(st.n_overflow))


def batch_verify(st, g, h, shifts, widths, ing: dict, exp_fp, exp_fp2,
                 exp_n, div, *, latency: torch.Tensor,
                 host_node: torch.Tensor):
    """Mirrored mode: K windows a dispatch, each window step -> the
    released set's fingerprint against the CPU ledger's -> that round's
    ingest (sync mode's device sequence). `shifts` and `widths` are K
    Python ints; `ing` holds [K, B] columns (src, dst, seq, tag, send,
    clamp, valid); `exp_fp`, `exp_fp2` (u32 values as int64) and `exp_n`
    are [K] tensors; `div` is the 0-d int32 divergence counter, which
    counts each window whose set differs. Reads nothing back."""
    for i, (shift, width) in enumerate(zip(shifts, widths)):
        st, due, deliver, _next = step(st, shift, width)
        fp1, fp2, cnt = fingerprint(st, due, deliver)
        ok = (fp1 == exp_fp[i]) & (fp2 == exp_fp2[i]) & (cnt == exp_n[i])
        h = hist_step(h, st)
        st, h = ingest(st, h, ing["src"][i], ing["dst"][i], ing["seq"][i],
                       ing["tag"][i], ing["send"][i], ing["clamp"][i],
                       ing["valid"][i], latency=latency, host_node=host_node)
        g = guard_update(g, st, shift, width)
        div = torch.where(ok, div, div + 1)
    return st, g, h, div


def ingest_guarded(st, g, h, src, dst, seq, tag, send_rel, clamp_rel,
                   valid, *, latency: torch.Tensor, host_node: torch.Tensor):
    """The standalone ingest dispatch, the guard check run over the
    post-ingest state with a neutral (0, 0) clock."""
    st, h = ingest(st, h, src, dst, seq, tag, send_rel, clamp_rel, valid,
                   latency=latency, host_node=host_node)
    return st, guard_update(g, st, 0, 0), h


# -- the transport ---------------------------------------------------------------


class DeviceTransport:
    """The Manager-facing transport: `capture`, `finish_round`,
    `release`, `finalize`, with the guard and histogram planes, the CPU
    reconciliation ledger, the fault latency table and the capacity
    policy. Host index = host_id - 1."""

    def __init__(self, hosts, routing, ip_to_node_id, *,
                 egress_cap: int = 256, ingress_cap: int = 256,
                 mode: str = "auto", compact_cap: int = 4096,
                 capacity_mode: str = "fixed", max_doublings: int = 3,
                 capacity_strict: bool | None = None, device=None):
        self.device = dev = resolve_device(device)
        self.hosts = sorted(hosts, key=lambda h: h.host_id)
        n = len(self.hosts)
        if [h.host_id for h in self.hosts] != list(range(1, n + 1)):
            raise ValueError("DeviceTransport needs host ids 1..N")
        # node-level latency table ([M, M]) and a host -> node map
        node_lat = np.asarray(routing.latency_ns)
        if node_lat.size and node_lat.max() >= I32_MAX:
            raise ValueError("path latency exceeds the int32 device budget")
        host_node = np.asarray(
            [routing.node_index(h.node_id) for h in self.hosts], np.int64)
        # the undegraded table stays on the host: link_degrade events
        # rebuild the device table from it (`apply_fault_latency`)
        self._base_latency_np = node_lat.astype(np.int64)
        self._latency = torch.as_tensor(node_lat.astype(np.int32),
                                        device=dev)
        self._host_node = torch.as_tensor(host_node, device=dev)
        # transient-device-error retry policy (faults/healing.py)
        self.retry_attempts = 0
        self.retry_backoff_s = 0.05
        self.retry_cap_s = 2.0
        self.retry_jitter = 0.5
        self.retry_seed = 0
        self.dispatches = 0

        self.state = make_transport_state(n, ingress_cap, dev)
        self._ingress_cap = ingress_cap
        self._compact_cap = compact_cap
        self._n = n
        # capacity policy: the per-destination slots are this plane's
        # one ring. elastic grows them before an overflowing ingest (a
        # host-side occupancy mirror, exact while nothing drops); strict
        # raises CapacityError on any drop
        self._capacity_mode = capacity_mode
        self._capacity_strict = (capacity_strict
                                 if capacity_strict is not None
                                 else capacity_mode == "strict")
        self._max_doublings = max_doublings
        self._ingress_cap0 = ingress_cap
        self._exhausted_noted = False
        self.capacity = CapacityTrajectory(capacity_mode)
        self._cap_drained = 0
        self._occ = np.zeros(n, np.int64)
        self._guard: Optional[TransportGuard] = None
        self._hist: Optional[TransportHist] = None
        # CPU ledgers for the reconciliation (guards/reconcile.py): the
        # capture side runs on any worker thread, under this lock, which
        # also serialises the capture's pool and row queue
        self._led_lock = threading.Lock()
        self._led_captured = np.zeros(n, np.int64)
        self._led_released = np.zeros(n, np.int64)
        self._tcp_source = None

        self.d2h_probe_ms: Optional[float] = None
        if mode == "auto":
            self.d2h_probe_ms = _probe_d2h_ms(dev)
            mode = "sync" if self.d2h_probe_ms < 2.0 else "mirrored"
            log.info("device transport auto mode: D2H probe %.2f ms -> %s",
                     self.d2h_probe_ms, mode)
        if mode not in ("sync", "mirrored"):
            raise ValueError(f"unknown tpu_transport_mode {mode!r}")
        self.mode = mode
        self.mirrored = mode == "mirrored"

        self._pending: list[tuple] = []
        # slot-indexed pool of tags: sync mode holds the packet, mirrored
        # a placeholder; a tag is freed once the device released it
        # (sync) or its window was dispatched (mirrored)
        self._pool: list = []
        self._free: list[int] = []
        self._prev_start: Optional[int] = None
        self.next_pending_abs: Optional[int] = None
        self._overflow_seen = 0
        self._overflow_prev = np.zeros(n, np.int64)
        self._batch_pad = 64

        # mirrored mode: the CPU ledger heap of (deliver_abs, tag,
        # dst_idx), the record batch, and the device divergence counter
        self._expect_heap: list[tuple[int, int, int]] = []
        self._div = torch.zeros((), dtype=torch.int32, device=dev)
        self._k = 32  # windows per batched dispatch
        self._records: list[tuple] = []  # (start, end, expected, ingest)
        self._open_record: Optional[tuple] = None
        self._dev_base: Optional[int] = None
        self.divergence_count = 0
        self.verified_windows = 0
        self.verified_packets = 0
        self._finalized = False

    # -- dispatches ---------------------------------------------------------

    def _retrying(self, fn, what: str, *args, **kwargs):
        """One dispatch of `fn`, retried on a transient error when the
        caller configured retries. Nothing is written in place, so a
        retry starts from the same inputs."""
        self.dispatches += 1
        if not self.retry_attempts:
            return fn(*args, **kwargs)
        from ..faults.healing import retry_transient

        return retry_transient(
            fn, *args, attempts=self.retry_attempts,
            backoff_s=self.retry_backoff_s, cap_s=self.retry_cap_s,
            jitter=self.retry_jitter, seed=self.retry_seed,
            what=f"device transport {what}", **kwargs)

    def _k_ingest(self, st, g, h, src, dst, seq, tag, send_rel, clamp_rel,
                  valid):
        return self._retrying(ingest_guarded, "ingest", st, g, h, src, dst,
                              seq, tag, send_rel, clamp_rel, valid,
                              latency=self._latency,
                              host_node=self._host_node)

    def _k_step(self, st, g, h, shift, window):
        return self._retrying(step_compact, "step", st, g, h, int(shift),
                              int(window), cap=self._compact_cap)

    def _k_chain(self, st, g, h, shift0, window0, runahead, horizon, stop):
        return self._retrying(chain, "chain", st, g, h, int(shift0),
                              int(window0), int(runahead), int(horizon),
                              int(stop), cap=self._compact_cap)

    def _k_batch_verify(self, st, g, h, shifts, widths, ing, exp_fp,
                        exp_fp2, exp_n, div):
        return self._retrying(
            batch_verify, "batch_verify", st, g, h,
            np.asarray(shifts, np.int64).tolist(),
            np.asarray(widths, np.int64).tolist(), ing, exp_fp, exp_fp2,
            exp_n, div, latency=self._latency, host_node=self._host_node)

    # -- guard and histogram planes ---------------------------------------------

    def enable_guards(self) -> None:
        """Thread a `TransportGuard` through every dispatch from now on."""
        if self._guard is None:
            self._guard = make_transport_guard(self.device)

    def guard_report(self) -> Optional[dict]:
        """Read and decode the guard accumulator (one small read; at
        teardown). None when guards were never enabled."""
        if self._guard is None:
            return None
        from ..guards import plane as gp

        bits, first, windows = torch.stack(list(self._guard)).tolist()
        return {"clean": bits == 0, "classes": gp.decode_bits(bits),
                "first_window": first, "windows": windows}

    def enable_histograms(self) -> None:
        """Thread a `TransportHist` through every dispatch from now on."""
        if self._hist is None:
            self._hist = make_transport_hist(self._n, self.device)

    def histogram_arrays(self) -> dict:
        """Per-host [N, B] histogram counters for a harvester (copies;
        empty when histograms were never enabled)."""
        if self._hist is None:
            return {}
        return {name: getattr(self._hist, name).clone()
                for name in TransportHist._fields}

    def cpu_ledger(self) -> dict[str, np.ndarray]:
        """The CPU reconciliation ledger: per-host capture / release
        counts kept apart from the device's n_out / n_released. Copies."""
        return {"captured": self._led_captured.copy(),
                "released": self._led_released.copy()}

    def device_in_flight(self) -> int:
        """Slots occupied on the device (one blocking read; teardown)."""
        return int(self.state.in_valid.sum().item())

    def apply_fault_latency(self, lat_mult: np.ndarray) -> None:
        """Mirror a link_degrade/link_restore event: the latency table
        becomes base * mult, so device deliver times keep matching the
        CPU arithmetic. Mirrored mode flushes its record batch first, so
        no dispatched window mixes tables."""
        if self.mirrored and self._records:
            self._flush_mirrored()
        degraded = self._base_latency_np * np.asarray(lat_mult, np.int64)
        if degraded.size and degraded.max() >= I32_MAX:
            raise ValueError(
                "fault-degraded path latency exceeds the int32 device "
                "budget; lower the latency_mult")
        self._latency = torch.as_tensor(degraded.astype(np.int32),
                                        device=self.device)

    # -- capacity policy -----------------------------------------------------------

    def drain_capacity_events(self) -> list[dict]:
        """Capacity-trajectory events recorded since the last drain."""
        events = self.capacity.events[self._cap_drained:]
        self._cap_drained = len(self.capacity.events)
        return list(events)

    def capacity_summary(self) -> dict:
        """The run's capacity record for stats and snapshots."""
        out = self.capacity.as_dict()
        out["ingress_cap"] = self._ingress_cap
        out["ingress_cap_initial"] = self._ingress_cap0
        return out

    def _maybe_grow_for(self, batch, time_ns: int) -> None:
        """Elastic mode, before an ingest: grow the rings (next power of
        two covering the need, at most max_doublings) if this batch would
        overflow any destination, so nothing is dropped."""
        if self._capacity_mode != "elastic" or not batch:
            return
        counts = np.bincount(
            np.asarray([row[1] for row in batch], np.int64),
            minlength=self._n)
        need_per = self._occ + counts
        need = int(need_per.max())
        if need > self._ingress_cap:
            cap_max = self._ingress_cap0 << self._max_doublings
            new_ci = min(next_pow2(need), cap_max)
            if new_ci > self._ingress_cap:
                self._grow_ingress(
                    new_ci, time_ns=time_ns,
                    overflow=int(np.maximum(
                        need_per - self._ingress_cap, 0).sum()))
            if need > new_ci and not self._exhausted_noted:
                # growth budget exhausted: the drops become real, noted
                # once a run
                self._exhausted_noted = True
                self.capacity.record_drop(
                    time_ns=time_ns, ring="transport-ingress", cap=new_ci,
                    overflow=int(np.maximum(need_per - new_ci, 0).sum()),
                    plane="transport", exhausted=True)
        # the ingest drops past the cap, so the mirror clamps too
        self._occ = np.minimum(self._occ + counts, self._ingress_cap)

    def _note_released(self, dst_idx) -> None:
        """Occupancy-mirror decrement by destination (elastic only)."""
        if self._capacity_mode == "elastic" and len(dst_idx):
            self._occ -= np.bincount(np.asarray(dst_idx, np.int64),
                                     minlength=self._n)

    def _grow_ingress(self, new_ci: int, *, time_ns: int,
                      overflow: int) -> None:
        """Widen the in-flight rings to `new_ci` columns. Mirrored mode
        flushes its record batch first, so no dispatched window mixes
        ring shapes."""
        from . import elastic

        if self.mirrored and self._records:
            self._flush_mirrored()
        self.capacity.record_growth(
            time_ns=time_ns, ring="transport-ingress",
            from_cap=self._ingress_cap, to_cap=new_ci, overflow=overflow,
            plane="transport")
        self.state = elastic.grow_transport_state(self.state, new_ci)
        self._ingress_cap = new_ci

    # -- capture (any worker thread) ------------------------------------------------

    def capture(self, src_host, dst_host, packet, now_ns: int, seq: int,
                round_end_ns: int, deliver_ns: int) -> None:
        src_idx = src_host.host_id - 1
        dst_idx = dst_host.host_id - 1
        with self._led_lock:
            self._led_captured[src_idx] += 1
            if self._free:
                tag = self._free.pop()
            else:
                tag = len(self._pool)
                self._pool.append(None)
            if self.mirrored:
                self._pool[tag] = True  # the ledger entry is in the heap
                heapq.heappush(self._expect_heap, (deliver_ns, tag, dst_idx))
            else:
                self._pool[tag] = packet
            self._pending.append(
                (src_idx, dst_idx, seq, tag, now_ns, round_end_ns))

    @property
    def in_flight(self) -> int:
        return len(self._pool) - len(self._free)

    # -- round barrier: ingest this round's captures ----------------------------------

    def finish_round(self, start_ns: int, end_ns: int) -> None:
        if self.mirrored:
            # elastic: grow before this round's captures are recorded, so
            # the batched replay never overflows a ring
            self._maybe_grow_for(self._pending, start_ns)
            rec, self._open_record = self._open_record, None
            if rec is not None:
                self._records.append((*rec, self._pending))
                self._pending = []
            elif self._pending:
                # captures in a round whose release was skipped (the
                # device was empty): a width-0 record carries the ingest
                self._records.append((start_ns, start_ns, [],
                                      self._pending))
                self._pending = []
            if len(self._records) >= self._k:
                self._flush_mirrored()
            return
        if not self._pending:
            return
        batch = self._pending
        self._pending = []
        self._maybe_grow_for(batch, start_ns)
        b = len(batch)
        pad = self._batch_pad
        while pad < b:
            pad *= 2
        self._batch_pad = pad
        # times relative to the device base (this round's start, unless
        # a chain overshot a cross-thread post: then send_rel < 0, fine)
        base_ns = self._prev_start if self._prev_start is not None \
            else start_ns
        arr = np.zeros((_NCOL + 1, pad), np.int64)
        arr[:_NCOL, :b] = np.asarray(batch, np.int64).T
        arr[0, b:] = self._n  # pad slots: out-of-range src
        arr[4:6] -= base_ns
        arr[4:6, b:] = 0
        arr[_NCOL, :b] = 1
        # one upload of the seven int32 columns (JAX's conversion)
        src, dst, seq, tag, send, clamp, valid = torch.from_numpy(
            arr.astype(np.int32)).to(self.device).unbind(0)
        self.state, self._guard, self._hist = self._k_ingest(
            self.state, self._guard, self._hist, src, dst, seq, tag, send,
            clamp, valid.to(torch.bool))

    # -- round start: release everything due in [start, end) ----------------------------

    def release(self, start_ns: int, end_ns: int,
                horizon_ns: Optional[int] = None,
                runahead_ns: Optional[int] = None,
                stop_ns: Optional[int] = None) -> None:
        """Run the window step and surface due deliveries.

        sync mode: push the released packets into their hosts' event
        queues; with `runahead_ns` and `stop_ns` (the Manager's round
        loop) chain through delivery-free windows, returning when a
        window delivers or the next device event reaches `horizon_ns`.
        mirrored mode: the deliveries were pushed at capture; open this
        round's record (window + the CPU ledger's expected set)."""
        if self.mirrored:
            self._release_mirrored(start_ns, end_ns)
            return
        if self.in_flight == 0:
            # nothing on the device: skip the step (every slot is idle,
            # so the rebase does not matter)
            self._prev_start = start_ns
            self.next_pending_abs = None
            return
        shift = 0 if self._prev_start is None else start_ns - self._prev_start
        if shift < 0:
            # a chain advanced the device base past this window's start
            # (a cross-thread post scheduled an earlier CPU event after
            # it ran): only [base, end) needs releasing, and a window
            # wholly behind the base has nothing on the device
            if end_ns <= self._prev_start:
                return
            start_ns = self._prev_start
            shift = 0
        if shift >= I32_MAX:
            raise ValueError("window shift exceeds the int32 ns budget")
        if runahead_ns is not None and stop_ns is not None:
            clamp = I32_MAX // 2
            horizon_rel = min((horizon_ns if horizon_ns is not None
                               else stop_ns) - start_ns, clamp)
            stop_rel = min(stop_ns - start_ns, clamp)
            (self.state, self._guard, self._hist, comp, off, next_rel,
             overflow) = self._k_chain(
                self.state, self._guard, self._hist, shift,
                end_ns - start_ns, runahead_ns, horizon_rel, stop_rel)
        else:
            (self.state, self._guard, self._hist, comp, next_rel,
             overflow) = self._k_step(self.state, self._guard, self._hist,
                                      shift, end_ns - start_ns)
            off = torch.zeros_like(next_rel)

        # one blocking read a delivering window: the compacted released
        # set, the chain's offset, the next event and the overflow total
        count, dst, src, seq, tag, d_t = comp
        head = torch.stack([count, off, next_rel, overflow])
        host = torch.cat([head, dst, src, seq, tag, d_t]).cpu().numpy()
        n, off_v, next_v, overflow_v = (int(v) for v in host[:4])
        base_ns = start_ns + off_v
        self._prev_start = base_ns
        if n > self._compact_cap:
            raise RuntimeError(
                f"released burst ({n}) exceeds tpu_compact_cap "
                f"({self._compact_cap}); raise experimental.tpu_compact_cap")
        cols = host[4:].reshape(5, -1)[:, :n]
        dst, src, seq, tag, d_t = cols

        self._note_overflow(overflow_v)

        # deliveries are relative to the last window's start
        if n:
            np.add.at(self._led_released, dst, 1)
            self._note_released(dst)
            hosts, pool, free = self.hosts, self._pool, self._free
            for i, s, q, g, t in zip(dst.tolist(), src.tolist(),
                                     seq.tolist(), tag.tolist(),
                                     d_t.tolist()):
                packet = pool[g]
                if packet is None:
                    continue  # overflow-dropped at ingest (counted)
                pool[g] = None
                free.append(g)
                hosts[i].push_packet_event(packet, base_ns + t, s + 1, q)

        self.next_pending_abs = (base_ns + next_v if next_v < I32_MAX
                                 else None)

    # -- mirrored mode ----------------------------------------------------------------

    def _pop_expected(self, end_ns: int) -> list[tuple[int, int, int]]:
        """The CPU ledger for this window: every capture due before
        end_ns, as (deliver_abs, tag, dst_idx)."""
        out = []
        heap = self._expect_heap
        while heap and heap[0][0] < end_ns:
            out.append(heapq.heappop(heap))
        return out

    def _release_mirrored(self, start_ns: int, end_ns: int) -> None:
        self.next_pending_abs = None  # the CPU queues hold everything
        if not self._expect_heap and self._open_record is None:
            # nothing undelivered on the device: flush against the old
            # base, then move the base, so an idle gap (unbounded) never
            # enters the int32 shift arithmetic
            if self._records:
                self._flush_mirrored()
            self._dev_base = start_ns
            return
        # with deliveries pending the gap is bounded by path latency, but
        # a width-0 no-op record per 2**30 ns keeps every shift in range
        last = self._records[-1][0] if self._records else self._dev_base
        if last is not None:
            while start_ns - last > (1 << 30):
                last += 1 << 30
                self._records.append((last, last, [], []))
                if len(self._records) >= self._k:
                    self._flush_mirrored()
        expected = self._pop_expected(end_ns)
        # these deliveries free their slots when this record replays
        # (the step runs before the ingest in `batch_verify`)
        self._note_released([e[2] for e in expected])
        self._open_record = (start_ns, end_ns, expected)

    def _flush_mirrored(self) -> None:
        """Dispatch one batched verify for the accumulated records."""
        records = self._records
        self._records = []
        K = self._k
        if len(records) > K:
            raise AssertionError("more records than one batch holds")
        b_ing = max((len(r[3]) for r in records), default=0)
        # the pad grows 4x, as JAX's (its compile count stays small)
        while self._batch_pad < b_ing:
            self._batch_pad *= 4
        B = self._batch_pad

        shifts = np.zeros(K, np.int64)
        widths = np.zeros(K, np.int64)
        exp = np.zeros((3, K), np.int64)  # fp1, fp2, count
        ing = np.zeros((_NCOL + 1, K, B), np.int64)
        base = self._dev_base if self._dev_base is not None \
            else records[0][0]
        for i, (start, end, expected, batch) in enumerate(records):
            shift = start - base
            if not 0 <= shift < I32_MAX:
                raise AssertionError("window shift exceeds the int32 budget")
            shifts[i] = shift
            widths[i] = end - start
            base = start
            if expected:
                pairs = np.asarray(expected, np.int64)
                exp[0, i], exp[1, i] = _fingerprint_np(
                    pairs[:, 1], pairs[:, 0] - start)
                exp[2, i] = len(expected)
            if batch:
                ing[:_NCOL, i, :len(batch)] = np.asarray(batch, np.int64).T
                ing[_NCOL, i, :len(batch)] = 1
            # capture times relative to this record's window start
            ing[4:6, i] -= start
        dead = ing[_NCOL] == 0
        ing[0][dead] = self._n  # dead slots: out-of-range src
        ing[4][dead] = 0  # keep dead-slot times inside int32
        ing[5][dead] = 0
        # one upload: the columns as int32 (JAX's conversion), then the
        # expected fingerprints and counts as int64
        t = torch.from_numpy(np.concatenate([
            ing.astype(np.int32).astype(np.int64).reshape(-1),
            exp.reshape(-1)])).to(self.device)
        cols = t[:ing.size].reshape(ing.shape).to(torch.int32)
        row = dict(zip(("src", "dst", "seq", "tag", "send", "clamp"),
                       cols[:_NCOL].unbind(0)))
        row["valid"] = cols[_NCOL] != 0
        exp_t = t[ing.size:].reshape(3, K)
        self.state, self._guard, self._hist, self._div = \
            self._k_batch_verify(
                self.state, self._guard, self._hist, shifts, widths, row,
                exp_t[0], exp_t[1], exp_t[2].to(torch.int32), self._div)
        self._dev_base = base
        pool, free = self._pool, self._free
        for _start, _end, expected, _batch in records:
            # the CPU ledger is authoritative: tags come home when their
            # window is dispatched (device execution is in order, so a
            # reused tag in a later ingest cannot collide)
            for _deliver, tag, dst_idx in expected:
                pool[tag] = None
                free.append(tag)
                self._led_released[dst_idx] += 1
            self.verified_packets += len(expected)
        # count only real windows (width > 0 or a ledger to check)
        self.verified_windows += sum(
            1 for start, end, expected, _b in records
            if end > start or expected)

    def finalize(self) -> None:
        """Flush the partial record batch and read the divergence
        counter: the one blocking read of a mirrored run."""
        if self._finalized or not self.mirrored:
            return
        self._finalized = True
        rec, self._open_record = self._open_record, None
        if rec is not None:  # a release whose round never finished
            self._records.append((*rec, self._pending))
            self._pending = []
        while self._records:
            batch = self._records[:self._k]
            rest = self._records[self._k:]
            # pad the tail batch with width-0 no-op records
            while len(batch) < self._k:
                batch.append((batch[-1][0], batch[-1][0], [], []))
            self._records = batch
            self._flush_mirrored()
            self._records = rest
        # packets still in flight past the stop time: hand the tags back
        for _deliver, tag, _dst in self._expect_heap:
            self._pool[tag] = None
            self._free.append(tag)
        self._expect_heap.clear()
        div, overflow = torch.stack(
            [self._div, _sum32(self.state.n_overflow)]).tolist()
        self.divergence_count += div
        if self.divergence_count:
            log.error(
                "device transport diverged from the CPU ledger in %d "
                "window(s) (of %d verified)",
                self.divergence_count, self.verified_windows)
        self._note_overflow(overflow)

    # -- telemetry -----------------------------------------------------------------

    def attach_tcp_source(self, plane_getter, conn_host) -> None:
        """Register a device-TCP retransmit source for the harvest:
        `plane_getter()` returns the current `tpu/tcp.TcpPlane` and
        `conn_host` [C] maps each connection to its sending host."""
        self._tcp_source = (plane_getter, torch.as_tensor(
            np.asarray(conn_host), dtype=torch.int32, device=self.device))

    def telemetry_arrays(self) -> dict:
        """Per-host counters for a harvester, in the PlaneMetrics names
        (host index i = host_id i+1), as copies a later dispatch cannot
        touch."""
        st = self.state
        out = {"pkts_out": st.n_out.clone(), "pkts_in": st.n_released.clone(),
               "drop_ring_full": st.n_overflow.clone()}
        if self._tcp_source is not None:
            from . import tcp as dtcp

            plane_getter, conn_host = self._tcp_source
            out["retransmits"] = dtcp.retransmits_by_host(
                plane_getter(), conn_host, self._n).to(torch.int32)
        return out

    # -- shared --------------------------------------------------------------------

    def _note_overflow(self, total_overflow: int) -> None:
        if total_overflow <= self._overflow_seen:
            return
        delta = total_overflow - self._overflow_seen
        log.error(
            "device transport dropped %d packets to ingress-capacity "
            "overflow — raise experimental.tpu_ingress_cap or run "
            "capacity.mode=elastic", delta)
        if self._capacity_strict:
            # strict: refuse to diverge from the unbounded-queue
            # semantics, with per-host blame (a run that is already over)
            overflow = self.state.n_overflow.cpu().numpy().astype(np.int64)
            blame = [self.hosts[i].name
                     for i in np.nonzero(overflow > 0)[0]]
            raise CapacityError(
                f"device transport dropped {delta} packet(s) to "
                f"ingress-capacity overflow under the strict capacity "
                f"policy (tpu_ingress_cap={self._ingress_cap}); raise "
                f"the cap or run capacity.mode=elastic",
                ring="transport-ingress", blame=blame)
        # the first drop lands a capacity-trajectory event
        if not any(e["ring"] == "transport-ingress"
                   and e["kind"] != "capacity-growth"
                   for e in self.capacity.events):
            self.capacity.record_drop(
                time_ns=self._prev_start or 0, ring="transport-ingress",
                cap=self._ingress_cap, overflow=delta, plane="transport")
        self._overflow_seen = total_overflow
        if self.mirrored:
            # the CPU delivery is authoritative: a device overflow is a
            # divergence, not a simulated drop
            self.divergence_count += 1
            return
        # device drops into the per-host tracker counters (the packets
        # never reach a CPU interface)
        overflow = self.state.n_overflow.cpu().numpy().astype(np.int64)
        deltas = overflow - self._overflow_prev
        for i in np.nonzero(deltas > 0)[0]:
            for tracker in getattr(self.hosts[i], "trackers", []):
                tracker.counters.packets_dropped += int(deltas[i])
        self._overflow_prev += np.maximum(deltas, 0)

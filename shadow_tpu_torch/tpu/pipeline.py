"""The egress and routing stages around the four CUDA kernels of the
window step.

The fused pair (`window_step(kernel="pallas_fused")`), counterpart of
`shadow_tpu/tpu/pallas_pipeline.py`:

- `egress_rank_stage` wraps kernel A (`csrc/egress_rank.cu`, replacing
  `_egress_rank_kernel`): per host row, the clock rebase, the FIFO
  bitonic sort by (validity | priority, column), the permutation of all
  nine egress columns, the prefix-sum token gate, and the routing
  stage's row-local (seq, column) order `row_perm`.
- `route_place` runs the routing stage around kernel B (`place`,
  `csrc/route_place.cu`, replacing `_place_kernel`): the cross-host
  exchange (`plane._routing_rank`, one flat sort plus bucket bounds)
  stays PyTorch; the kernel lands each destination row's bucket segment
  of the arrival-sorted stream in its free slots.

The split pair (`window_step(kernel="pallas")`), counterpart of
`shadow_tpu/tpu/pallas_egress.py` and `pallas_route.py`:

- `egress_order_gate` wraps kernel C (`csrc/egress_gate.cu`, replacing
  `_egress_kernel`): kernel A's rebase, sort and token gate, returning
  the sort permutation and the bytes/tsend/clamp/validity columns in
  that order; the caller gathers the other columns.
- `route_scatter` runs the same routing stage around kernel D
  (`scatter`, `csrc/route_scatter.cu`, replacing `_route_kernel`), with
  the row order computed in PyTorch (no kernel A): kernel B's function,
  one warp a destination row.

Each kernel has its plain PyTorch version here, computing the same
function. A wrapper given CPU tensors calls the plain version; given
CUDA tensors it launches the kernel, or raises. `LAUNCHES` counts the
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_kernel
from .plane import _routing_rank, _seq_row_order
from .prims import _SIGN32, I32_MAX, NO_CLAMP, take, u32, wrap_i32

# kernel launches since the last reset, by kernel name
LAUNCHES = {"egress_rank": 0, "route_place": 0, "egress_gate": 0,
            "route_scatter": 0}
# widest egress row kernels A and C take (one thread block per row)
MAX_EGRESS_CAP = 1024


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require_pow2(cap: int, what: str):
    if cap < 2 or cap & (cap - 1):
        raise ValueError(
            f"the fused egress/route kernels need a power-of-two {what} "
            f"of at least 2 (the bitonic network width), got {cap}")


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _egress_checks(valid, cols: dict, balance):
    """The guards of kernels A and C: a power-of-two row no wider than
    the kernels take, and every column of the dtype, shape, device and
    layout the kernel reads. Returns (N, CE, device)."""
    N, CE = valid.shape
    _require_pow2(CE, "egress capacity")
    if CE > MAX_EGRESS_CAP:
        raise ValueError(f"egress capacity {CE} exceeds the kernel's "
                         f"widest row, {MAX_EGRESS_CAP}")
    dev = valid.device
    for name, t in cols.items():
        dt = torch.bool if name in ("valid", "ctrl") else torch.int32
        _check(name, t, dt, (N, CE), dev)
    _check("balance", balance, torch.int32, (N,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"egress stage: unsupported device {dev}")
    return N, CE, dev


def _launch(name: str, *args):
    """Launch kernel `name` on the current stream of the device the
    arguments' tensors lie on (the first tensor's); raise on a refused
    launch. Tensors go as pointers, ints as they are."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = getattr(load_kernel(name), f"{name}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(_ptr(a) if isinstance(a, torch.Tensor) else a
                   for a in args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}_kernel: CUDA error {err} at launch")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# kernel C: egress sort + token gate
# ---------------------------------------------------------------------------


def egress_gate_plain(valid, prio, nbytes, tsend, clamp, balance,
                      shift_ns: int):
    """Kernel C's function in plain PyTorch. Returns (perm [N, CE] int32,
    bytes_s, tsend_s, clamp_s int32, valid_s, sendable bool [N, CE],
    spent [N] int32): the FIFO order by (validity | priority, column)
    and the rebased carried columns in it, the token gate, and each
    row's spent bytes."""
    tsend_rb = torch.where(valid, tsend - shift_ns, 0)
    clamp_rb = torch.where(valid & (clamp != NO_CLAMP), clamp - shift_ns,
                           clamp)
    key = torch.where(valid, 0, _SIGN32) | u32(prio)
    key_s, perm = torch.sort(key, dim=1, stable=True)
    # validity comes back from the key's top bit, as in the TPU kernel
    valid_s = (key_s & _SIGN32) == 0
    bytes_s = take(nbytes, perm)
    cum = wrap_i32(torch.cumsum(torch.where(valid_s, bytes_s, 0), dim=1,
                                dtype=torch.int64))
    sendable = valid_s & (cum <= balance[:, None])
    spent = wrap_i32(torch.where(sendable, bytes_s, 0).sum(
        dim=1, dtype=torch.int64))
    return (perm.to(torch.int32), bytes_s, take(tsend_rb, perm),
            take(clamp_rb, perm), valid_s, sendable, spent)


def egress_order_gate(valid, prio, nbytes, tsend, clamp, balance,
                      shift_ns: int):
    """Kernel C: the split path's egress order and token gate, bitwise
    the TPU kernel's outputs after its wrapper (see `egress_gate_plain`
    for the layout)."""
    N, CE, dev = _egress_checks(valid, dict(
        valid=valid, prio=prio, nbytes=nbytes, tsend=tsend, clamp=clamp),
        balance)
    if dev.type == "cpu":
        return egress_gate_plain(valid, prio, nbytes, tsend, clamp, balance,
                                 shift_ns)
    i32 = lambda: torch.empty((N, CE), dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty((N, CE), dtype=torch.bool, device=dev)
    outs = (i32(), i32(), i32(), i32(), b8(), b8(),
            torch.empty(N, dtype=torch.int32, device=dev))
    _launch("egress_gate", N, CE, int(shift_ns), valid, prio, nbytes, tsend,
            clamp, balance, *outs)
    return outs


# ---------------------------------------------------------------------------
# kernel A: egress sort + token gate + payload permutation + row order
# ---------------------------------------------------------------------------


def egress_rank_plain(valid, prio, nbytes, tsend, clamp, dst, seq, sock,
                      ctrl, balance, shift_ns: int):
    """Kernel A's function in plain PyTorch: kernel C's, every egress
    column permuted, and the sorted rows' seq order. Returns the 9
    sorted egress columns (prio, sock, dst, bytes, seq, ctrl, tsend,
    clamp, valid), then sendable, spent [N] and row_perm [N, CE] int32."""
    (perm, bytes_s, tsend_s, clamp_s, valid_s, sendable,
     spent) = egress_gate_plain(valid, prio, nbytes, tsend, clamp, balance,
                                shift_ns)
    perm = perm.to(torch.int64)
    seq_s = take(seq, perm)
    return (take(prio, perm), take(sock, perm), take(dst, perm), bytes_s,
            seq_s, take(ctrl, perm), tsend_s, clamp_s, valid_s, sendable,
            spent, _seq_row_order(seq_s))


def egress_rank_stage(valid, prio, nbytes, tsend, clamp, dst, seq, sock,
                      ctrl, balance, shift_ns: int):
    """Kernel A: the FIFO egress stage of one window, bitwise the TPU
    kernel's outputs (see `egress_rank_plain` for the layout)."""
    ins = dict(valid=valid, prio=prio, nbytes=nbytes, tsend=tsend,
               clamp=clamp, dst=dst, seq=seq, sock=sock, ctrl=ctrl)
    N, CE, dev = _egress_checks(valid, ins, balance)
    if dev.type == "cpu":
        return egress_rank_plain(valid, prio, nbytes, tsend, clamp, dst,
                                 seq, sock, ctrl, balance, shift_ns)
    i32 = lambda: torch.empty((N, CE), dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty((N, CE), dtype=torch.bool, device=dev)
    outs = (i32(), i32(), i32(), i32(), i32(), b8(), i32(), i32(), b8(),
            b8(), torch.empty(N, dtype=torch.int32, device=dev), i32())
    _launch("egress_rank", N, CE, int(shift_ns), *ins.values(), balance,
            *outs)
    return outs


# ---------------------------------------------------------------------------
# kernel B: bucketed placement
# ---------------------------------------------------------------------------


def place_plain(nv, lo, take_n, s_src, s_seq, s_sock, s_bytes, s_del,
                b_src, b_seq, b_sock, b_bytes, b_del, b_valid):
    """Kernel B's function in plain PyTorch: slots [nv, nv + take) of
    each destination row read the CI-left-padded stream at
    clip(lo + c + CI, 0, B2 - 1); every other slot keeps its base.
    Returns (src, seq, sock, bytes, deliver, valid) [N, CI]."""
    N, CI = b_src.shape
    B2 = s_src.shape[0]
    ccol = torch.arange(CI, dtype=torch.int32, device=b_src.device)
    nv_, lo_, tk_ = nv[:, None], lo[:, None], take_n[:, None]
    mask = (ccol >= nv_) & (ccol < nv_ + tk_)
    idx = torch.clamp(lo_ + ccol + CI, 0, B2 - 1).to(torch.int64)
    sel = lambda s, base: torch.where(mask, s[idx], base)
    return (sel(s_src, b_src), sel(s_seq, b_seq), sel(s_sock, b_sock),
            sel(s_bytes, b_bytes), sel(s_del, b_del), mask | b_valid)


def _placement_checks(nv, lo, take_n, streams, bases, b_valid):
    """The guards of kernels B and D. Returns (N, CI, B2, device)."""
    N, CI = b_valid.shape
    B2 = streams[0].shape[0]
    dev = b_valid.device
    for name, t in (("nv", nv), ("lo", lo), ("take", take_n)):
        _check(name, t, torch.int32, (N,), dev)
    for i, t in enumerate(streams):
        _check(f"stream{i}", t, torch.int32, (B2,), dev)
    for i, t in enumerate(bases):
        _check(f"base{i}", t, torch.int32, (N, CI), dev)
    _check("b_valid", b_valid, torch.bool, (N, CI), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"placement: unsupported device {dev}")
    return N, CI, B2, dev


def _placement_outputs(N, CI, dev):
    return tuple(torch.empty((N, CI), dtype=torch.int32, device=dev)
                 for _ in range(5)) + (
        torch.empty((N, CI), dtype=torch.bool, device=dev),)


def place(nv, lo, take_n, s_src, s_seq, s_sock, s_bytes, s_del,
          b_src, b_seq, b_sock, b_bytes, b_del, b_valid):
    """Kernel B (see `place_plain`)."""
    _require_pow2(b_valid.shape[1], "ingress capacity")
    streams = (s_src, s_seq, s_sock, s_bytes, s_del)
    bases = (b_src, b_seq, b_sock, b_bytes, b_del)
    N, CI, B2, dev = _placement_checks(nv, lo, take_n, streams, bases,
                                       b_valid)
    if dev.type == "cpu":
        return place_plain(nv, lo, take_n, *streams, *bases, b_valid)
    outs = _placement_outputs(N, CI, dev)
    _launch("route_place", N, CI, B2, nv, lo, take_n, *streams, *bases,
            b_valid, *outs)
    return outs


# ---------------------------------------------------------------------------
# kernel D: per-destination-row append
# ---------------------------------------------------------------------------


# Kernel D computes kernel B's function, taken a row at a time (one warp
# a destination row, only placed lanes reading the stream), so its plain
# version is B's.
scatter_plain = place_plain


def scatter(nv, lo, take_n, s_src, s_seq, s_sock, s_bytes, s_del,
            b_src, b_seq, b_sock, b_bytes, b_del, b_valid):
    """Kernel D (see `scatter_plain`)."""
    streams = (s_src, s_seq, s_sock, s_bytes, s_del)
    bases = (b_src, b_seq, b_sock, b_bytes, b_del)
    N, CI, B2, dev = _placement_checks(nv, lo, take_n, streams, bases,
                                       b_valid)
    if dev.type == "cpu":
        return scatter_plain(nv, lo, take_n, *streams, *bases, b_valid)
    outs = _placement_outputs(N, CI, dev)
    _launch("route_scatter", N, CI, B2, nv, lo, take_n, *streams, *bases,
            b_valid, *outs)
    return outs


# ---------------------------------------------------------------------------
# the routing stage around kernels B and D
# ---------------------------------------------------------------------------


def _placement_args(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                    in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                    in_valid_c, n_valid_in, row_perm):
    """The exchange of the routing stage in PyTorch: `plane._routing_rank`
    (the flat arrival sort and bucket bounds) and the arrival-sorted
    payload streams, addressed through the composed permutation (sorted
    position -> original slot) and padded by CI on both sides (padding is
    never selected). Returns (the placement kernel's arguments,
    overflow [N])."""
    N, CE = eg_dst.shape
    CI = in_src_c.shape[1]
    row_perm, o_pos, offsets, take_n, overflow = _routing_rank(
        sent, eg_dst, eg_seq, deliver_rel, n_valid_in, CI, row_perm)
    src_row = torch.div(o_pos, CE, rounding_mode="floor")
    g = src_row * CE + row_perm.reshape(-1).to(torch.int64)[o_pos]
    pad = lambda a: torch.nn.functional.pad(a, (CI, CI))
    stream = lambda a: pad(a.reshape(-1)[g])
    args = (n_valid_in, offsets - n_valid_in, take_n,
            pad(src_row.to(torch.int32)), stream(eg_seq), stream(eg_sock),
            stream(eg_bytes), stream(deliver_rel), in_src_c, in_seq_c,
            in_sock_c, in_bytes_c,
            torch.where(in_valid_c, in_deliver_c, I32_MAX), in_valid_c)
    return args, overflow


def route_place(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                in_valid_c, n_valid_in, row_perm, *, plain: bool = False):
    """Land the routed arrivals in the destination rings through kernel
    B: bitwise the JAX plane's `_routing_rank` + `_routing_place` over the
    compacted ingress. `row_perm` is kernel A's seq order. `plain=True`
    runs kernel B's plain version whatever the device. Returns the merged
    ingress columns (src, seq, sock, bytes, deliver, valid) + overflow
    [N]."""
    _require_pow2(in_src_c.shape[1], "ingress capacity")
    args, overflow = _placement_args(
        sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel, in_deliver_c,
        in_src_c, in_seq_c, in_sock_c, in_bytes_c, in_valid_c, n_valid_in,
        row_perm)
    merged = place_plain(*args) if plain else place(*args)
    return (*merged, overflow)


def route_scatter(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                  in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                  in_valid_c, n_valid_in, *, plain: bool = False):
    """The split path's routing stage through kernel D: bitwise the JAX
    plane's `_route_scatter` (packed sort), with the seq row order
    computed here. `plain=True` runs kernel D's plain version whatever
    the device. Returns the merged ingress columns + overflow [N]."""
    args, overflow = _placement_args(
        sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel, in_deliver_c,
        in_src_c, in_seq_c, in_sock_c, in_bytes_c, in_valid_c, n_valid_in,
        None)
    merged = scatter_plain(*args) if plain else scatter(*args)
    return (*merged, overflow)

"""The fused egress-rank and route-place stages around the two CUDA
kernels of the main path.

Counterpart of `shadow_tpu/tpu/pallas_pipeline.py`:

- `egress_rank_stage` wraps kernel A (`csrc/egress_rank.cu`, replacing
  `_egress_rank_kernel`): per host row, the clock rebase, the FIFO
  bitonic sort by (validity | priority, column), the permutation of all
  nine egress columns, the prefix-sum token gate, and the routing
  stage's row-local (seq, column) order `row_perm`.
- `route_place` wraps kernel B (`csrc/route_place.cu`, replacing
  `_place_kernel`): the cross-host exchange (`plane._routing_rank`, one
  flat sort plus bucket bounds) stays PyTorch; the kernel lands each
  destination row's bucket segment of the arrival-sorted stream in its
  free slots.

Each kernel has its plain PyTorch version here, computing the same
function. A wrapper given CPU tensors calls the plain version; given
CUDA tensors it launches the kernel, or raises. `LAUNCHES` counts the
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_kernel
from .plane import _routing_rank
from .prims import _SIGN32, I32_MAX, NO_CLAMP, take, u32, wrap_i32

# kernel launches since the last reset, by kernel name
LAUNCHES = {"egress_rank": 0, "route_place": 0}
# widest egress row kernel A takes (one thread block per row)
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


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# kernel A: egress sort + token gate + routing row order
# ---------------------------------------------------------------------------


def egress_rank_plain(valid, prio, nbytes, tsend, clamp, dst, seq, sock,
                      ctrl, balance, shift_ns: int):
    """Kernel A's function in plain PyTorch. Returns the 9 sorted egress
    columns (prio, sock, dst, bytes, seq, ctrl, tsend, clamp, valid),
    then sendable, spent [N] and row_perm [N, CE] int32."""
    tsend_rb = torch.where(valid, tsend - shift_ns, 0)
    clamp_rb = torch.where(valid & (clamp != NO_CLAMP), clamp - shift_ns,
                           clamp)
    key = torch.where(valid, 0, _SIGN32) | u32(prio)
    key_s, perm = torch.sort(key, dim=1, stable=True)
    # validity comes back from the key's top bit, as in the TPU kernel
    valid_s = (key_s & _SIGN32) == 0
    bytes_s, seq_s = take(nbytes, perm), take(seq, perm)
    cum = wrap_i32(torch.cumsum(torch.where(valid_s, bytes_s, 0), dim=1,
                                dtype=torch.int64))
    sendable = valid_s & (cum <= balance[:, None])
    spent = wrap_i32(torch.where(sendable, bytes_s, 0).sum(
        dim=1, dtype=torch.int64))
    row_perm = torch.sort(u32(seq_s) ^ _SIGN32, dim=1,
                          stable=True).indices.to(torch.int32)
    return (take(prio, perm), take(sock, perm), take(dst, perm), bytes_s,
            seq_s, take(ctrl, perm), take(tsend_rb, perm),
            take(clamp_rb, perm), valid_s, sendable, spent, row_perm)


def egress_rank_stage(valid, prio, nbytes, tsend, clamp, dst, seq, sock,
                      ctrl, balance, shift_ns: int):
    """Kernel A: the FIFO egress stage of one window, bitwise the TPU
    kernel's outputs (see `egress_rank_plain` for the layout)."""
    N, CE = valid.shape
    _require_pow2(CE, "egress capacity")
    if CE > MAX_EGRESS_CAP:
        raise ValueError(f"egress capacity {CE} exceeds the kernel's "
                         f"widest row, {MAX_EGRESS_CAP}")
    dev = valid.device
    ins = dict(valid=valid, prio=prio, nbytes=nbytes, tsend=tsend,
               clamp=clamp, dst=dst, seq=seq, sock=sock, ctrl=ctrl)
    for name, t in ins.items():
        dt = torch.bool if name in ("valid", "ctrl") else torch.int32
        _check(name, t, dt, (N, CE), dev)
    _check("balance", balance, torch.int32, (N,), dev)
    if dev.type == "cpu":
        return egress_rank_plain(valid, prio, nbytes, tsend, clamp, dst,
                                 seq, sock, ctrl, balance, shift_ns)
    if dev.type != "cuda":
        raise ValueError(f"egress_rank_stage: unsupported device {dev}")
    fn = load_kernel("egress_rank").egress_rank_launch
    i32 = lambda: torch.empty((N, CE), dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty((N, CE), dtype=torch.bool, device=dev)
    outs = (i32(), i32(), i32(), i32(), i32(), b8(), i32(), i32(), b8(),
            b8(), torch.empty(N, dtype=torch.int32, device=dev), i32())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(N, CE, int(shift_ns),
                 *(_ptr(t) for t in ins.values()), _ptr(balance),
                 *(_ptr(t) for t in outs), ctypes.c_void_p(stream))
    _raise_on(err, "egress_rank_kernel")
    LAUNCHES["egress_rank"] += 1
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


def place(nv, lo, take_n, s_src, s_seq, s_sock, s_bytes, s_del,
          b_src, b_seq, b_sock, b_bytes, b_del, b_valid):
    """Kernel B (see `place_plain`)."""
    N, CI = b_src.shape
    _require_pow2(CI, "ingress capacity")
    B2 = s_src.shape[0]
    dev = b_src.device
    for name, t in (("nv", nv), ("lo", lo), ("take", take_n)):
        _check(name, t, torch.int32, (N,), dev)
    streams = (s_src, s_seq, s_sock, s_bytes, s_del)
    for i, t in enumerate(streams):
        _check(f"stream{i}", t, torch.int32, (B2,), dev)
    bases = (b_src, b_seq, b_sock, b_bytes, b_del)
    for i, t in enumerate(bases):
        _check(f"base{i}", t, torch.int32, (N, CI), dev)
    _check("b_valid", b_valid, torch.bool, (N, CI), dev)
    if dev.type == "cpu":
        return place_plain(nv, lo, take_n, *streams, *bases, b_valid)
    if dev.type != "cuda":
        raise ValueError(f"route_place: unsupported device {dev}")
    fn = load_kernel("route_place").route_place_launch
    outs = tuple(torch.empty((N, CI), dtype=torch.int32, device=dev)
                 for _ in range(5)) + (
        torch.empty((N, CI), dtype=torch.bool, device=dev),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(N, CI, B2, _ptr(nv), _ptr(lo), _ptr(take_n),
                 *(_ptr(t) for t in streams), *(_ptr(t) for t in bases),
                 _ptr(b_valid), *(_ptr(t) for t in outs),
                 ctypes.c_void_p(stream))
    _raise_on(err, "route_place_kernel")
    LAUNCHES["route_place"] += 1
    return outs


def route_place(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                in_valid_c, n_valid_in, row_perm, *, plain: bool = False):
    """Land the routed arrivals in the destination rings: bitwise the
    JAX plane's `_routing_rank` + `_routing_place` over the compacted
    ingress. `row_perm` is kernel A's seq order. The exchange (the flat
    arrival sort and bucket bounds) and the arrival-sorted payload
    streams, addressed through the composed permutation and padded by CI
    on both sides (padding is never selected), stay PyTorch; kernel B
    places them. `plain=True` runs kernel B's plain version whatever the
    device. Returns the merged ingress columns (src, seq, sock, bytes,
    deliver, valid) + overflow [N]."""
    N, CE = eg_dst.shape
    CI = in_src_c.shape[1]
    _require_pow2(CI, "ingress capacity")
    o_pos, offsets, take_n, overflow = _routing_rank(
        sent, eg_dst, deliver_rel, n_valid_in, CI, row_perm)
    src_row = torch.div(o_pos, CE, rounding_mode="floor")
    g = src_row * CE + row_perm.reshape(-1).to(torch.int64)[o_pos]
    pad = lambda a: torch.nn.functional.pad(a, (CI, CI))
    stream = lambda a: pad(a.reshape(-1)[g])
    args = (n_valid_in, offsets - n_valid_in, take_n,
            pad(src_row.to(torch.int32)), stream(eg_seq), stream(eg_sock),
            stream(eg_bytes), stream(deliver_rel), in_src_c, in_seq_c,
            in_sock_c, in_bytes_c,
            torch.where(in_valid_c, in_deliver_c, I32_MAX), in_valid_c)
    merged = place_plain(*args) if plain else place(*args)
    return (*merged, overflow)

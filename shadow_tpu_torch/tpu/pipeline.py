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
  of the arrival order in its free slots, reading each arrival through
  the routing permutation, and updates the window's compacted ingress
  rings in place.

The split pair (`window_step(kernel="pallas")`), counterpart of
`shadow_tpu/tpu/pallas_egress.py` and `pallas_route.py`:

- `egress_order_gate` wraps kernel C (`csrc/egress_gate.cu`, replacing
  `_egress_kernel`): kernel A's rebase, sort and token gate, returning
  the sort permutation and the bytes/tsend/clamp/validity columns in
  that order; the caller gathers the other columns.
- `route_scatter` runs the same routing stage around kernel D
  (`scatter`, `csrc/route_scatter.cu`, replacing `_route_kernel`), with
  the row order computed in PyTorch (no kernel A): kernel B's function
  and device code (`csrc/ring_place.cuh`), in place as well.

Each kernel has its plain PyTorch version here, computing the same
function. A wrapper given CPU tensors calls the plain version; given
CUDA tensors it launches the kernel, or raises, unless the caller asks
for the plain version (`plain=True`, `window_step(plain_kernels=True)`).
`LAUNCHES` counts the kernel launches, and nothing else; kernel E, the
router AQM's drain (`codel.router_drain`), launches through `_launch`
and counts here too.

Each kernel is a `torch.library.custom_op` (`shadow_tpu_torch::<name>`;
kernel E's in `codel`) whose implementation runs the plain version on
CPU tensors and launches the kernel on CUDA tensors, with a vmap rule
(`register_vmap`): under `torch.func.vmap`, as `elastic.drive_ensemble`
runs a chain, the rule folds the world axis into the host rows and
calls the op once, so one launch (and one count) serves all W worlds
(`ops.fold_worlds`). Kernels A, C and E work row by row and need nothing
more; B and D take `world_rows`, the rows of one world, so a row reads
only its own world's arrivals. The wrappers check dtypes, shapes and
devices on the tensors they are given (under vmap, each world's); the
ops check what needs the storage (distinct rings, kernel C's alignment).

The split pair's plain versions are also the JAX XLA path's egress and
routing stages: `egress_gate_plain` is made of `plane._rebase_egress`,
`_egress_sort` and `_gate_spent`, which `plane._egress_order` and
`_token_gate` (the XLA step's, with the round-robin tiebreak key) share,
and `route_scatter(plain=True)` is `_route_scatter`, so
`window_step(kernel="xla")` runs them and launches no kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_kernel
from .ops import custom_op, fold_worlds, row_op
from .plane import (_egress_sort, _gate_spent, _rebase_egress, _routing_rank,
                    _seq_row_order)
from .prims import I32_MAX, take

# kernel launches since the last reset, by kernel name
LAUNCHES = {"egress_rank": 0, "route_place": 0, "egress_gate": 0,
            "route_scatter": 0, "router_drain": 0}
# kernel E's launches of each of its builds (as its launcher reports them,
# `codel.e_geometry`)
E_BUILD_LAUNCHES = {"staged": 0, "device": 0}
# widest egress row kernels A and C take (one thread block holds a row)
MAX_EGRESS_CAP = 1024


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for build in E_BUILD_LAUNCHES:
        E_BUILD_LAUNCHES[build] = 0


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
    """Kernel C's function in plain PyTorch, and the JAX XLA path's FIFO
    egress stage: the clock rebase (`plane._rebase_egress`), the sort by
    (validity | priority, column) (`plane._egress_sort`) and the
    prefix-sum token gate (`plane._gate_spent`, the JAX `_token_gate`).
    Returns (perm [N, CE] int32, bytes_s, tsend_s, clamp_s int32,
    valid_s, sendable bool [N, CE], spent [N] int32)."""
    perm, bytes_s, tsend_s, clamp_s, valid_s = _egress_sort(
        valid, prio, nbytes, *_rebase_egress(valid, tsend, clamp, shift_ns))
    sendable, spent = _gate_spent(valid_s, bytes_s, balance)
    return perm, bytes_s, tsend_s, clamp_s, valid_s, sendable, spent


def _egress_gate_impl(valid, prio, nbytes, tsend, clamp, balance,
                      shift_ns: int):
    """The `egress_gate` op: the plain version on CPU tensors, kernel C
    on CUDA tensors (the checks of `egress_order_gate` done)."""
    if valid.device.type == "cpu":
        return egress_gate_plain(valid, prio, nbytes, tsend, clamp, balance,
                                 shift_ns)
    N, CE = valid.shape
    dev = valid.device
    for name, t in (("valid", valid), ("prio", prio), ("nbytes", nbytes),
                    ("tsend", tsend), ("clamp", clamp)):
        # the kernel moves each thread's 4 slots as one vector
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel C reads 16-byte vectors, and "
                             f"this tensor does not start on 16 bytes")
    i32 = lambda: torch.empty((N, CE), dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty((N, CE), dtype=torch.bool, device=dev)
    outs = (i32(), i32(), i32(), i32(), b8(), b8(),
            torch.empty(N, dtype=torch.int32, device=dev))
    _launch("egress_gate", N, CE, int(shift_ns), valid, prio, nbytes, tsend,
            clamp, balance, *outs)
    return outs


_egress_gate_op = row_op(
    "egress_gate", _egress_gate_impl,
    "(Tensor valid, Tensor prio, Tensor nbytes, Tensor tsend, Tensor clamp, "
    "Tensor balance, int shift_ns) -> (" + ", ".join(["Tensor"] * 7) + ")")


def egress_order_gate(valid, prio, nbytes, tsend, clamp, balance,
                      shift_ns: int):
    """Kernel C: the split path's egress order and token gate, bitwise
    the TPU kernel's outputs after its wrapper (see `egress_gate_plain`
    for the layout)."""
    _egress_checks(valid, dict(valid=valid, prio=prio, nbytes=nbytes,
                               tsend=tsend, clamp=clamp), balance)
    return _egress_gate_op(valid, prio, nbytes, tsend, clamp, balance,
                           int(shift_ns))


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


_EGRESS_RANK_INS = ("valid", "prio", "nbytes", "tsend", "clamp", "dst", "seq",
                    "sock", "ctrl", "balance")


def _egress_rank_impl(valid, prio, nbytes, tsend, clamp, dst, seq, sock,
                      ctrl, balance, shift_ns: int):
    """The `egress_rank` op: the plain version on CPU tensors, kernel A
    on CUDA tensors (the checks of `egress_rank_stage` done)."""
    ins = (valid, prio, nbytes, tsend, clamp, dst, seq, sock, ctrl, balance)
    if valid.device.type == "cpu":
        return egress_rank_plain(*ins, shift_ns)
    N, CE = valid.shape
    dev = valid.device
    i32 = lambda: torch.empty((N, CE), dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty((N, CE), dtype=torch.bool, device=dev)
    outs = (i32(), i32(), i32(), i32(), i32(), b8(), i32(), i32(), b8(),
            b8(), torch.empty(N, dtype=torch.int32, device=dev), i32())
    _launch("egress_rank", N, CE, int(shift_ns), *ins, *outs)
    return outs


_egress_rank_op = row_op(
    "egress_rank", _egress_rank_impl,
    "(" + ", ".join(f"Tensor {n}" for n in _EGRESS_RANK_INS)
    + ", int shift_ns) -> (" + ", ".join(["Tensor"] * 12) + ")")


def egress_rank_stage(valid, prio, nbytes, tsend, clamp, dst, seq, sock,
                      ctrl, balance, shift_ns: int):
    """Kernel A: the FIFO egress stage of one window, bitwise the TPU
    kernel's outputs (see `egress_rank_plain` for the layout)."""
    ins = dict(valid=valid, prio=prio, nbytes=nbytes, tsend=tsend,
               clamp=clamp, dst=dst, seq=seq, sock=sock, ctrl=ctrl)
    _egress_checks(valid, ins, balance)
    return _egress_rank_op(*ins.values(), balance, int(shift_ns))


# ---------------------------------------------------------------------------
# kernels B and D: placement of the routed arrivals, in place
# ---------------------------------------------------------------------------


def place_plain(nv, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock,
                eg_bytes, deliver_rel, in_src, in_seq, in_sock, in_bytes,
                in_deliver, in_valid, world_rows: int | None = None):
    """Kernel B's function in plain PyTorch, in place. Slot c of
    destination row r is placed when nv <= c < nv + take; it takes
    arrival j = offsets - nv + c of the arrival-sorted order, read
    through the routing permutation: p = o_pos[j], its source row
    src = p // CE and egress slot g = src * CE + row_perm.flat[p], so the
    item (src, then eg_seq, eg_sock, eg_bytes and deliver_rel at g), all
    five 0 for j outside [0, n_src*CE); the slot becomes valid. Every
    other slot keeps its values, except that an invalid one gets
    deliver = I32_MAX.

    The source rows are an axis of their own: row_perm, the eg_* columns
    and deliver_rel are [n_src, CE] and o_pos [n_src*CE], while the rings
    are [N, CI]. Without a mesh n_src = N; a mesh rank places the
    arrivals of all R*N_local gathered source hosts into its N_local
    rows, and src is the global source host.

    The six ingress tensors (src, seq, sock, bytes, deliver [N, CI]
    int32, valid [N, CI] bool) are updated in place and returned in that
    order: the caller hands over tensors that nothing reads afterwards.

    `world_rows` (the kernels' ensemble launch, `ring_place.cuh`): the N
    rows are N / world_rows worlds of world_rows rows each, one after
    another, and o_pos, row_perm, j and src are each world's own; None
    is one world of N rows. An ensemble has no mesh: `world_rows` with
    n_src != N raises ValueError."""
    N, CI = in_src.shape
    n_src, CE = row_perm.shape
    if world_rows is not None and n_src != N:
        raise ValueError(
            f"placement: world_rows (an ensemble) with {n_src} source rows "
            f"for {N} destination rows; an ensemble runs without a mesh")
    R = n_src if world_rows is None else world_rows
    ccol = torch.arange(CI, dtype=torch.int64, device=in_src.device)
    nv_ = nv.to(torch.int64)[:, None]
    placed = (ccol >= nv_) & (ccol < nv_ + take_n[:, None])
    j = offsets.to(torch.int64)[:, None] - nv_ + ccol
    inside = placed & (j >= 0) & (j < R * CE)
    j = torch.where(inside, j, 0)
    if world_rows is not None and R != N:
        # the first flat egress slot of each row's world
        base = (torch.arange(N, dtype=torch.int64, device=in_src.device)
                // R * (R * CE))[:, None]
        p = o_pos[base + j]
        src = torch.div(p, CE, rounding_mode="floor")
        g = base + src * CE + row_perm.reshape(-1)[base + p].to(torch.int64)
    else:
        p = o_pos[j]
        src = torch.div(p, CE, rounding_mode="floor")
        g = src * CE + row_perm.reshape(-1)[p].to(torch.int64)
    in_deliver.copy_(torch.where(in_valid, in_deliver, I32_MAX))
    items = (src.to(torch.int32), *(c.reshape(-1)[g] for c in (
        eg_seq, eg_sock, eg_bytes, deliver_rel)))
    rings = (in_src, in_seq, in_sock, in_bytes, in_deliver)
    for ring, item in zip(rings, items):
        ring.copy_(torch.where(placed, torch.where(inside, item, 0), ring))
    in_valid |= placed
    return (*rings, in_valid)


_PLACE_INS = ("nv", "offsets", "take_n", "o_pos", "row_perm", "eg_seq",
              "eg_sock", "eg_bytes", "deliver_rel")
_RINGS = ("in_src", "in_seq", "in_sock", "in_bytes", "in_deliver",
          "in_valid")


def _placement_checks(nv, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock,
                      eg_bytes, deliver_rel, in_src, in_seq, in_sock,
                      in_bytes, in_deliver, in_valid):
    """The guards of kernels B and D: every argument of the dtype, shape,
    device and layout the kernel reads, the source columns on n_src rows
    (row_perm's) and the rings on N. (That the six ingress tensors are
    distinct, as they are written in place, the op checks on the storage.)
    Returns (N, CI, CE, device, n_src)."""
    N, CI = in_valid.shape
    n_src, CE = row_perm.shape[-2:]
    dev = in_valid.device
    for name, t in (("nv", nv), ("offsets", offsets), ("take", take_n)):
        _check(name, t, torch.int32, (N,), dev)
    _check("o_pos", o_pos, torch.int64, (n_src * CE,), dev)
    for name, t in (("row_perm", row_perm), ("eg_seq", eg_seq),
                    ("eg_sock", eg_sock), ("eg_bytes", eg_bytes),
                    ("deliver_rel", deliver_rel)):
        _check(name, t, torch.int32, (n_src, CE), dev)
    rings = dict(in_src=in_src, in_seq=in_seq, in_sock=in_sock,
                 in_bytes=in_bytes, in_deliver=in_deliver)
    for name, t in rings.items():
        _check(name, t, torch.int32, (N, CI), dev)
    _check("in_valid", in_valid, torch.bool, (N, CI), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"placement: unsupported device {dev}")
    return N, CI, CE, dev, n_src


def _place_op(name: str):
    """The custom op of placement kernel `name` (B or D): the plain
    version on CPU tensors, the kernel on CUDA tensors, the six ingress
    tensors written in place; its vmap rule folds the worlds into the
    rows and passes `world_rows` and `src_rows` (the source rows of a
    world) on, so one launch places every world."""

    def impl(*args):
        *tensors, world_rows, src_rows = args
        rings = tensors[9:]
        if len({t.data_ptr() for t in rings}) < 6 and rings[-1].numel():
            raise ValueError("placement: the six ingress tensors are updated "
                             "in place and must be distinct")
        N, CI = rings[-1].shape
        if world_rows != N and src_rows != world_rows:
            raise ValueError(
                f"placement: an ensemble launch (world_rows {world_rows} of "
                f"{N} rows) with {src_rows} source rows a world; an ensemble "
                "runs without a mesh")
        if rings[-1].device.type == "cpu":
            place_plain(*tensors,
                        world_rows=None if world_rows == N else world_rows)
            return
        _launch(name, N, world_rows, src_rows, CI, tensors[4].shape[1],
                *tensors)

    schema = ("(" + ", ".join(
        [f"Tensor {n}" for n in _PLACE_INS]
        + [f"Tensor({chr(97 + i)}!) {n}" for i, n in enumerate(_RINGS)])
        + ", int world_rows, int src_rows) -> ()")
    op = custom_op(name, impl, schema, mutates=_RINGS)

    def batched(info, in_dims, *args):
        op(*fold_worlds(info, in_dims, args, mutated=range(9, 15)))
        return None, None

    op.register_vmap(batched)
    return op


_PLACE_OPS = {name: _place_op(name) for name in ("route_place",
                                                 "route_scatter")}


def _place_with(name: str, args, plain: bool):
    N, CI, CE, dev, n_src = _placement_checks(*args)
    if plain:
        return place_plain(*args)
    _PLACE_OPS[name](*args, N, n_src)
    return args[9:]


def place(nv, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock, eg_bytes,
          deliver_rel, in_src, in_seq, in_sock, in_bytes, in_deliver,
          in_valid, *, plain: bool = False):
    """Kernel B (see `place_plain`): updates the six ingress tensors in
    place, writing only the slots that change, and returns them.
    `plain=True` runs the plain version whatever the device."""
    return _place_with("route_place", (
        nv, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock, eg_bytes,
        deliver_rel, in_src, in_seq, in_sock, in_bytes, in_deliver,
        in_valid), plain)


# Kernel D computes kernel B's function, taken a row at a time, and runs
# kernel B's device code (csrc/ring_place.cuh), so its plain version is
# B's.
scatter_plain = place_plain


def scatter(nv, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock, eg_bytes,
            deliver_rel, in_src, in_seq, in_sock, in_bytes, in_deliver,
            in_valid, *, plain: bool = False):
    """Kernel D (see `scatter_plain`): updates the six ingress tensors in
    place, writing only the slots that change, and returns them.
    `plain=True` runs the plain version whatever the device."""
    return _place_with("route_scatter", (
        nv, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock, eg_bytes,
        deliver_rel, in_src, in_seq, in_sock, in_bytes, in_deliver,
        in_valid), plain)


# ---------------------------------------------------------------------------
# the routing stage around kernels B and D
# ---------------------------------------------------------------------------


def _placement_args(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                    in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                    in_valid_c, n_valid_in, row_perm, mesh=None):
    """The exchange of the routing stage in PyTorch, `plane._routing_rank`
    (the flat arrival sort and bucket bounds), and the placement kernel's
    arguments: the routing tensors themselves, which the kernel reads
    through the permutation. Returns (arguments, overflow [N]).

    Under a host-axis `mesh` (`tpu/mesh.Mesh`) the rank's egress columns
    and row order are first gathered from every rank (`exchange`): the
    arguments then hold the [R*N_local, CE] source columns of all hosts,
    and the rank's own destination rows take their arrivals from them."""
    row0 = 0
    if mesh is not None:
        (sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
         row_perm) = exchange(mesh, sent, eg_dst, eg_seq, eg_bytes, eg_sock,
                              deliver_rel, row_perm)
        row0 = mesh.row0(in_src_c.shape[0])
    row_perm, o_pos, offsets, take_n, overflow = _routing_rank(
        sent, eg_dst, eg_seq, deliver_rel, n_valid_in, in_src_c.shape[1],
        row_perm, row0=row0)
    args = (n_valid_in, offsets, take_n, o_pos, row_perm, eg_seq, eg_sock,
            eg_bytes, deliver_rel, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
            in_deliver_c, in_valid_c)
    return args, overflow


def exchange(mesh, sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
             row_perm=None):
    """The routing exchange of a host-axis mesh: every rank's [N_local,
    CE] egress columns and row order (`plane._seq_row_order` of its own
    rows when `row_perm` is None), gathered in rank order into the
    [R*N_local, CE] layout of the unsharded run (ranks own contiguous
    host ranges), in one collective. Returns (sent, eg_dst, eg_seq,
    eg_bytes, eg_sock, deliver_rel, row_perm)."""
    if row_perm is None:
        row_perm = _seq_row_order(eg_seq)
    return mesh.gather_rows((sent, eg_dst, eg_seq, eg_bytes, eg_sock,
                             deliver_rel, row_perm))


def route_place(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                in_valid_c, n_valid_in, row_perm, *, plain: bool = False,
                mesh=None):
    """Land the routed arrivals in the destination rings through kernel
    B: bitwise the JAX plane's `_routing_rank` + `_routing_place` over the
    compacted ingress. `row_perm` is kernel A's seq order. `plain=True`
    runs kernel B's plain version whatever the device. Returns the merged
    ingress columns (src, seq, sock, bytes, deliver, valid) + overflow
    [N]. The merged columns are the compacted ingress tensors given,
    updated in place (the JAX function returns new arrays): pass tensors
    that nothing reads afterwards, as `window_step`'s own are. Under a
    host-axis `mesh` the columns are the rank's rows and the exchange
    (`exchange`) comes first."""
    _require_pow2(in_src_c.shape[1], "ingress capacity")
    args, overflow = _placement_args(
        sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel, in_deliver_c,
        in_src_c, in_seq_c, in_sock_c, in_bytes_c, in_valid_c, n_valid_in,
        row_perm, mesh)
    return (*place(*args, plain=plain), overflow)


def route_scatter(sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel,
                  in_deliver_c, in_src_c, in_seq_c, in_sock_c, in_bytes_c,
                  in_valid_c, n_valid_in, *, plain: bool = False, mesh=None):
    """The split path's routing stage through kernel D: bitwise the JAX
    plane's `_route_scatter` (packed sort), with the seq row order
    computed here. `plain=True` runs kernel D's plain version whatever
    the device; it is also the JAX XLA path's `_route_scatter` (packed
    sort), which `window_step(kernel="xla")` runs that way. Returns the
    merged ingress columns + overflow [N]; like `route_place`, it updates
    the compacted ingress tensors in place and returns them, and takes a
    `mesh` as it does."""
    args, overflow = _placement_args(
        sent, eg_dst, eg_seq, eg_bytes, eg_sock, deliver_rel, in_deliver_c,
        in_src_c, in_seq_c, in_sock_c, in_bytes_c, in_valid_c, n_valid_in,
        None, mesh)
    return (*scatter(*args, plain=plain), overflow)

"""Host-axis mesh for the network plane, over `torch.distributed`.

Counterpart of `shadow_tpu/tpu/mesh.py`. JAX shards the host axis of
every SoA array over a device mesh and leaves the cross-host routing
scatter to the SPMD partitioner. The port uses PyTorch's own idiom: one
process a rank, NCCL for CUDA tensors and gloo for CPU tensors, each
rank owning the contiguous host rows [r*N/R, (r+1)*N/R). The node-level
path tables ([M, M] latency and loss) and the [N] host -> node map are
replicated, as `param_shardings` does in JAX; every per-host vector and
[N, ...] plane is sliced.

What the partitioner does for JAX, the window step does itself under a
`mesh=` (`tpu/plane.window_step`, `chain_windows`): the routing exchange
(`pipeline.exchange`, every rank's egress columns gathered into the
unsharded [N, CE] layout, so kernels B and D place the rank's own
arrivals with a source axis of N rows), the global host ids of the loss
and corruption draws, and the reductions across ranks (the next event,
the chain's continue flag, the metrics' scalar leaves, the destination
counts of the fault, guard and histogram planes). A sharded run is
bitwise the unsharded one.

`make_mesh` joins the process group the caller started (`torchrun`, or
`run_ranks`, which spawns the ranks and runs rank 0 in the calling
process), or starts a one-rank group itself. Under gloo a CUDA tensor's
collective is staged through host memory (`Mesh.staged`): gloo's
transports move host buffers, and NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import datetime
import math
import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device

HOST_AXIS = "hosts"

#: a collective waits this long for the other ranks before it raises
TIMEOUT_S = 300


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Mesh:
    """One rank's view of the host-axis mesh: its rank, the world size,
    the backend, the torch device its tensors live on, and the
    collectives the sharded step uses. Host ranges come from
    `host_range(n_hosts)`."""

    def __init__(self, rank: int, size: int, backend: str,
                 device: torch.device):
        self.rank, self.size = rank, size
        self.backend, self.device = backend, device
        # gloo moves host buffers: a CUDA tensor goes through host memory
        self.staged = backend == "gloo" and device.type == "cuda"

    def host_range(self, n_hosts: int) -> tuple[int, int]:
        """(row0, rows): the contiguous host rows this rank owns of
        `n_hosts`, which must shard evenly, as JAX's mesh needs."""
        if n_hosts % self.size:
            raise ValueError(
                f"{n_hosts} hosts do not shard evenly over {self.size} "
                f"ranks along {HOST_AXIS!r}")
        rows = n_hosts // self.size
        return self.rank * rows, rows

    def row0(self, n_local: int) -> int:
        """The first global host of this rank, given its row count."""
        return self.rank * n_local

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def _from_wire(self, t: torch.Tensor, like: torch.Tensor):
        return t.to(like.device) if self.staged else t

    def gather_rows(self, tensors):
        """Each [n_local, ...] int32 or bool tensor gathered along axis 0
        in rank order, [R*n_local, ...] on every rank, dtypes kept: one
        all-gather of the tensors packed side by side as int32."""
        n = tensors[0].shape[0]
        widths = [math.prod(t.shape[1:]) for t in tensors]
        for t in tensors:
            if t.dtype not in (torch.int32, torch.bool):
                raise TypeError(f"gather_rows: int32 or bool, got {t.dtype}")
        packed = self._to_wire(torch.cat(
            [t.reshape(n, -1).to(torch.int32) for t in tensors], dim=1))
        parts = [torch.empty_like(packed) for _ in range(self.size)]
        dist.all_gather(parts, packed.contiguous())
        full = self._from_wire(torch.cat(parts), tensors[0])
        out, col = [], 0
        for t, w in zip(tensors, widths):
            piece = full[:, col:col + w].reshape(self.size * n,
                                                 *t.shape[1:])
            out.append(piece != 0 if t.dtype == torch.bool
                       else piece.contiguous())
            col += w
        return tuple(out)

    def gather_leaf(self, t: torch.Tensor) -> torch.Tensor:
        """One tensor of any dtype gathered along axis 0 in rank order."""
        wire = self._to_wire(t.to(torch.uint8) if t.dtype == torch.bool
                             else t).contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire)
        full = self._from_wire(torch.cat(parts), t)
        return full != 0 if t.dtype == torch.bool else full

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        wire = self._to_wire(t).clone()
        dist.all_reduce(wire, op=op)
        return self._from_wire(wire, t)

    def all_min(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over the ranks, on every rank."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks, on every rank (exact for
        integers; int32 sums wrap as int32 adds do)."""
        return self._reduce(t, dist.ReduceOp.SUM)


def _cuda_index(backend: str, rank: int, device: torch.device) -> int:
    if device.index is not None:
        return device.index
    # NCCL: a card a rank; gloo may put several ranks on one card
    return rank if backend == "nccl" else rank % torch.cuda.device_count()


def _backend(backend: str | None, size: int, device):
    """(backend, device) for `size` ranks on `device`: `backend` when
    the caller names one, NCCL needing a card a rank (more ranks than
    visible cards raise ValueError naming backend="gloo", which can put
    several ranks on one card) and CUDA tensors; else NCCL on CUDA when
    every rank has a card of its own, gloo otherwise."""
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend: 'nccl' or 'gloo', got {backend!r}")
    cards = torch.cuda.device_count()
    if backend == "nccl" and size > cards:
        raise ValueError(
            f"NCCL needs a CUDA card a rank: {size} ranks, {cards} card(s) "
            "visible; pass backend=\"gloo\" to put several ranks on one "
            "card (each collective then goes through host memory)")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' moves CUDA tensors; a CPU mesh "
                         "runs over gloo")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and size <= cards else "gloo"
    return backend, dev


def make_mesh(n_devices: int | None = None, *, backend: str | None = None,
              device=None) -> Mesh:
    """This process's `Mesh` of `n_devices` ranks along the host axis.

    Inside an initialised process group (`torchrun`, `run_ranks`) it
    joins that group, whose size must be `n_devices` when given;
    otherwise it starts a one-rank group on localhost (n_devices None or
    1). The backend is the group's, or `_backend`'s choice: NCCL when
    every rank has a card of its own, gloo on the CPU or with several
    ranks on one card. `device` None means the CUDA card, as for every
    entry point of the port; a rank on CUDA takes card `rank` under NCCL
    and `rank % cards` under gloo."""
    size = (dist.get_world_size() if dist.is_initialized()
            else n_devices or 1)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) inside a process group "
                         f"of {size} ranks")
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    backend, dev = _backend(backend, size, device)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"make_mesh({size}): no process group is initialised; "
                "start the ranks with run_ranks or torchrun")
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", _cuda_index(backend, rank, dev))
        torch.cuda.set_device(dev)
    return Mesh(rank, size, backend, dev)


class HostSharding(NamedTuple):
    """The rows [row0, row0 + rows) of a host-major tensor, on a rank's
    device: the port's `NamedSharding(mesh, P(HOST_AXIS))`."""

    row0: int
    rows: int
    device: torch.device

    def place(self, t: torch.Tensor) -> torch.Tensor:
        # a copy, so the rank does not keep the whole tensor alive
        return t[self.row0:self.row0 + self.rows].to(self.device, copy=True)


#: a replicated leaf: the whole tensor on every rank (`P()` in JAX)
REPLICATED = None


def host_sharding(mesh: Mesh, n_hosts: int) -> HostSharding:
    """Axis-0 sharding of [N, ...] per-host tensors of `n_hosts` hosts."""
    return HostSharding(*mesh.host_range(n_hosts), mesh.device)


def param_shardings(mesh: Mesh, n_hosts: int):
    """A `plane.NetPlaneParams` of shardings: the node-level path tables
    and `host_node` replicated (every rank gathers arbitrary (src, dst)
    pairs from them, and destination lookups index any host's node), the
    per-host vectors sliced with the host axis."""
    from .plane import NetPlaneParams

    vec = host_sharding(mesh, n_hosts)
    return NetPlaneParams(latency_ns=REPLICATED, loss=REPLICATED,
                          host_node=REPLICATED, tb_rate=vec, tb_cap=vec,
                          qdisc_rr=vec, dn_rate=vec, dn_cap=vec)


#: NamedTuples that every rank holds whole (not host-major): the flight
#: recorder's ring, which JAX replicates too
WHOLE_ON_EVERY_RANK = ("FlightRecArrays",)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        if type(tree).__name__ in WHOLE_ON_EVERY_RANK:
            return tree
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_tree(tree, mesh: Mesh, n_hosts: int):
    """A host-major pytree of global tensors as this rank's part: every
    leaf of rank >= 1 sliced on axis 0 (it must have `n_hosts` rows),
    every 0-d leaf replicated (JAX's `_shard_host_axis`), all on the
    rank's device. A flight recorder in the tree stays as it is (whole
    on every rank)."""
    sh = host_sharding(mesh, n_hosts)

    def place(t):
        if t.dim() == 0:
            return t.to(mesh.device)
        if t.shape[0] != n_hosts:
            raise ValueError(f"shard_tree: a leaf of shape {tuple(t.shape)} "
                             f"is not host-major over {n_hosts} hosts")
        return sh.place(t)

    return _map(place, tree)


def shard_state(state, params, mesh: Mesh):
    """Place a global (state, params) pair onto this rank: the state's
    per-host leaves sliced (`shard_tree`), the params as
    `param_shardings` says."""
    n = state.eg_dst.shape[0]
    shardings = param_shardings(mesh, n)
    params = type(params)(*(
        t.to(mesh.device) if sh is REPLICATED else sh.place(t)
        for t, sh in zip(params, shardings)))
    return shard_tree(state, mesh, n), params


def gather_state(tree, mesh: Mesh):
    """Every host-major leaf (rank >= 1) of a sharded pytree gathered in
    global host order, the 0-d leaves and a flight recorder as they are
    (whole on every rank): the unsharded tree, on every rank (a
    collective: every rank calls it; rank 0 writes the records)."""
    return _map(lambda t: t if t.dim() == 0 else mesh.gather_leaf(t), tree)


def _rank_main(i, fn, size, addr, backend, device, args):
    """A spawned rank (1 + i) of `run_ranks`: join, run, leave."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=addr, world_size=size,
                            rank=i + 1,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(make_mesh(size, backend=backend, device=device), *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, *args, backend: str | None = None,
              device=None, local: dict | None = None):
    """Run `fn(mesh, *args)` on `n_ranks` ranks of a new process group
    and return rank 0's result: ranks 1.. are spawned processes (the
    spawn start method, `fn` and `args` picklable, `fn` a module-level
    function), rank 0 is this process, called with the keywords `local`
    too (objects that stay in this process). A rank that raises fails
    the call; the others are stopped. On the CPU each rank computes on
    one thread (the ranks are the parallelism: a rank waiting in a
    collective must not leave the others' thread pools spinning); rank
    0's thread count is restored after."""
    import torch.multiprocessing as tmp

    backend, dev = _backend(backend, n_ranks, device)
    if dist.is_initialized():
        raise RuntimeError("run_ranks: this process is already in a "
                           "process group")
    addr = f"tcp://localhost:{_free_port()}"
    ctx = None
    if n_ranks > 1:
        ctx = tmp.start_processes(
            _rank_main, args=(fn, n_ranks, addr, backend, str(dev), args),
            nprocs=n_ranks - 1, join=False, start_method="spawn")
    ok = False
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=addr, world_size=n_ranks, rank=0,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(make_mesh(n_ranks, backend=backend, device=str(dev)),
                     *args, **(local or {}))
        finally:
            dist.destroy_process_group()
        ok = True
    finally:
        torch.set_num_threads(threads)
        if ctx is not None and ok:
            while not ctx.join():  # raises what a spawned rank raised
                pass
        elif ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
    return out

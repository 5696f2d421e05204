"""Carry plane params and state between numpy and the port's tensors.

A state as numpy is a dict of arrays keyed by `NetPlaneState` field,
with `router` a dict keyed by `RouterDownState` field (the router's and
the CoDel trace replay's `CodelState` also convert alone): the JAX plane's
NamedTuples converted leaf by leaf (`st._asdict()`), dtypes unchanged
(bool stays bool, int32 int32, float32 float32). The flat tuples
(`PlaneMetrics`, `PlaneHistograms`, `WorkloadState`, the flow plane's
`FlowTables` and `FlowState`, the compute plane's `ComputeTables` and
`ComputeState`, the fault plane's `FaultArrays`, the guard plane's
`GuardState`) go as dicts keyed by field; a field that is not an array
(`FlowTables.lane_flow` None, `ComputeTables.queue_cap` an int) is
carried as it is. The flight recorder's `FlightRecArrays` has two
uint32 leaves, which the port holds as int64 tensors:
`flightrec_from_numpy` and `flightrec_to_numpy` convert them.
`state_digest` hashes that layout, so one digest names a state in
either package; `digest_pytrees` is the scenario runner's digest.

A driver carry (nested tuples, NamedTuples and dicts of tensors, None
for a plane that is off) goes to the host with `carry_to_host`: the same
structure of numpy arrays, in the JAX package's dtypes (`HOST_DTYPES`),
so a memo key, a checkpoint or a digest of it is the JAX carry's.
`carry_to_device` and `leaf_to_device` bring it back.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .telemetry.flightrec import FlightRecArrays
from .tpu.codel import CodelState, RouterDownState
from .tpu.mesh import gather_state
from .tpu.plane import NetPlaneParams, NetPlaneState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(d: dict, device) -> NetPlaneParams:
    return NetPlaneParams(**{f: _tensor(d[f], device)
                             for f in NetPlaneParams._fields})


def state_from_numpy(d: dict, device) -> NetPlaneState:
    fields = {f: _tensor(d[f], device) for f in NetPlaneState._fields
              if f != "router"}
    return NetPlaneState(router=router_from_numpy(d["router"], device),
                         **fields)


def state_to_numpy(state: NetPlaneState) -> dict:
    np_of = lambda t: t.detach().cpu().numpy()
    out = {f: np_of(getattr(state, f)) for f in NetPlaneState._fields
           if f != "router"}
    out["router"] = {f: np_of(getattr(state.router, f))
                     for f in RouterDownState._fields}
    return out


def router_from_numpy(d: dict, device) -> RouterDownState:
    """A `RouterDownState` from the JAX twin's `_asdict()`."""
    return RouterDownState(**{f: _tensor(d[f], device)
                              for f in RouterDownState._fields})


def codel_from_numpy(d: dict, device) -> CodelState:
    """The trace replay's `CodelState` from the JAX twin's `_asdict()`."""
    return CodelState(**{f: _tensor(d[f], device)
                         for f in CodelState._fields})


def _is_array(v) -> bool:
    return v is not None and not isinstance(v, (int, float, bool))


def tuple_to_numpy(t) -> dict:
    """A flat NamedTuple of tensors as a numpy dict in field order."""
    return {f: (getattr(t, f).detach().cpu().numpy()
                if _is_array(getattr(t, f)) else getattr(t, f))
            for f in t._fields}


def tuple_from_numpy(cls, d: dict, device):
    """The inverse of `tuple_to_numpy` for the NamedTuple class `cls`;
    `d` may be the JAX twin's `_asdict()`."""
    return cls(**{f: _tensor(d[f], device) if _is_array(d[f]) else d[f]
                  for f in cls._fields})


_FLIGHTREC_U32 = ("key", "sample_every")

#: (NamedTuple class name, field) -> the JAX package's dtype of a leaf
#: the port holds in a wider tensor dtype
HOST_DTYPES = {("FlightRecArrays", f): np.uint32 for f in _FLIGHTREC_U32}


def map_carry(fn, carry, owner: str = "", name: str = ""):
    """`carry` with every leaf replaced by `fn(owner, field, leaf)`:
    `owner` is the class name of the NamedTuple holding the leaf ("" for
    an anonymous tuple position) and `field` its field name (a tuple
    position adds "[i]", a dict key ".k"). None subtrees stay None."""
    if carry is None:
        return None
    if isinstance(carry, tuple) and hasattr(carry, "_fields"):
        cls = type(carry).__name__
        return type(carry)(*(map_carry(fn, v, cls, f)
                             for f, v in zip(carry._fields, carry)))
    if isinstance(carry, (tuple, list)):
        return type(carry)(map_carry(fn, v, owner, f"{name}[{i}]")
                           for i, v in enumerate(carry))
    if isinstance(carry, dict):
        return {k: map_carry(fn, carry[k], owner, f"{name}.{k}")
                for k in sorted(carry)}
    return fn(owner, name, carry)


def carry_to_host(carry, mesh=None):
    """The carry as numpy, in the JAX package's dtypes, with one
    synchronise for the lot: every card tensor's copy is queued first
    (`non_blocking`), then the stream is waited on once. CPU tensors are
    copied, so a later in-place write cannot reach the host carry. A
    Python number leaf becomes a 0-d array. Under a host-axis `mesh`
    (every rank calls it) the rank's carry is gathered first
    (`tpu/mesh.gather_state`): the whole, unsharded carry."""
    if mesh is not None:
        carry = gather_state(carry, mesh)
    cuda = []

    def stage(_o, _f, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            cuda.append(leaf.device)
            return leaf.detach().to("cpu", non_blocking=True)
        return leaf

    staged = map_carry(stage, carry)
    if cuda:
        torch.cuda.synchronize(cuda[0])

    def host(owner, field, leaf):
        if isinstance(leaf, torch.Tensor):
            a = leaf.detach().cpu().numpy()
            a = a.copy() if leaf.device.type == "cpu" else a
        else:
            a = np.asarray(leaf)
        dt = HOST_DTYPES.get((owner, field))
        return a.astype(dt) if dt is not None else a

    return map_carry(host, staged)


def leaf_to_device(owner: str, field: str, a, device) -> torch.Tensor:
    """One host leaf as a tensor on `device`, in the port's dtype (a
    `HOST_DTYPES` leaf goes back to int64)."""
    a = np.asarray(a)
    if (owner, field) in HOST_DTYPES:
        a = a.astype(np.int64)
    return _tensor(a, device)


def carry_to_device(carry, device):
    """The inverse of `carry_to_host`: every numpy leaf a tensor on
    `device`."""
    return map_carry(lambda o, f, a: leaf_to_device(o, f, a, device), carry)


def flightrec_from_numpy(d: dict, device) -> FlightRecArrays:
    """A `FlightRecArrays` from the JAX twin's `_asdict()` (uint32 key
    and sample_every become int64 tensors of the same values)."""
    return FlightRecArrays(**{
        f: _tensor(np.asarray(d[f]).astype(np.int64) if f in _FLIGHTREC_U32
                   else d[f], device) for f in FlightRecArrays._fields})


def flightrec_to_numpy(fr: FlightRecArrays) -> dict:
    """The inverse of `flightrec_from_numpy`, with the JAX dtypes."""
    d = tuple_to_numpy(fr)
    for f in _FLIGHTREC_U32:
        d[f] = d[f].astype(np.uint32)
    return d


def _leaves(tree, prefix=""):
    """(name, numpy array) of every leaf, in the order `jax.tree.leaves`
    gives the JAX twin: a NamedTuple's fields in order, a nested one
    (the state's `router`) in its field's place, None skipped and a
    Python scalar as `np.asarray` makes it. A state's numpy dict is
    walked in `NetPlaneState` field order; a bare tensor is one leaf."""
    if isinstance(tree, torch.Tensor):
        yield prefix.rstrip("."), tree.detach().cpu().numpy()
        return
    if isinstance(tree, dict):
        for f in NetPlaneState._fields:
            if f == "router":
                for g in RouterDownState._fields:
                    yield f"router.{g}", np.asarray(tree["router"][g])
            else:
                yield f, np.asarray(tree[f])
        return
    for f in tree._fields:
        v = getattr(tree, f)
        if v is None:  # an empty subtree, no leaf
            continue
        if isinstance(v, tuple):
            yield from _leaves(v, f"{prefix}{f}.")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{f}", v.detach().cpu().numpy()
        else:  # a Python scalar leaf, as numpy reads it
            yield f"{prefix}{f}", np.asarray(v)


def state_digest(state) -> str:
    """sha256 over every state leaf in field order (name, dtype, shape,
    bytes); takes a `NetPlaneState` or its numpy dict."""
    h = hashlib.sha256()
    for name, a in _leaves(state):
        a = np.ascontiguousarray(a)
        h.update(f"{name}:{a.dtype.str}:{a.shape};".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def digest_pytrees(*trees) -> str:
    """sha256 over every leaf of the trees, in order: the numpy dtype
    name, then the raw bytes. The bytes the JAX package's
    `workloads.runner.digest_pytrees` hashes for the twin pytrees, so
    the scenario corpus's canonical digests agree across packages."""
    h = hashlib.sha256()
    for tree in trees:
        for _name, a in _leaves(tree):
            h.update(str(a.dtype).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()

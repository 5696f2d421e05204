"""Carry plane params and state between numpy and the port's tensors.

A state as numpy is a dict of arrays keyed by `NetPlaneState` field,
with `router` a dict keyed by `RouterDownState` field: the JAX plane's
NamedTuples converted leaf by leaf (`st._asdict()`), dtypes unchanged
(bool stays bool, int32 int32, float32 float32). `state_digest` hashes
that layout, so one digest names a state in either package.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .tpu.codel import RouterDownState
from .tpu.plane import NetPlaneParams, NetPlaneState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(d: dict, device) -> NetPlaneParams:
    return NetPlaneParams(**{f: _tensor(d[f], device)
                             for f in NetPlaneParams._fields})


def state_from_numpy(d: dict, device) -> NetPlaneState:
    fields = {f: _tensor(d[f], device) for f in NetPlaneState._fields
              if f != "router"}
    router = RouterDownState(**{f: _tensor(d["router"][f], device)
                                for f in RouterDownState._fields})
    return NetPlaneState(router=router, **fields)


def state_to_numpy(state: NetPlaneState) -> dict:
    np_of = lambda t: t.detach().cpu().numpy()
    out = {f: np_of(getattr(state, f)) for f in NetPlaneState._fields
           if f != "router"}
    out["router"] = {f: np_of(getattr(state.router, f))
                     for f in RouterDownState._fields}
    return out


def state_digest(state) -> str:
    """sha256 over every state leaf in field order (name, dtype, shape,
    bytes); takes a `NetPlaneState` or its numpy dict."""
    d = state_to_numpy(state) if isinstance(state, NetPlaneState) else state
    h = hashlib.sha256()

    def leaf(name, a):
        a = np.ascontiguousarray(a)
        h.update(f"{name}:{a.dtype.str}:{a.shape};".encode())
        h.update(a.tobytes())

    for f in NetPlaneState._fields:
        if f == "router":
            for g in RouterDownState._fields:
                leaf(f"router.{g}", d["router"][g])
        else:
            leaf(f, d[f])
    return h.hexdigest()

"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
feed the JAX plane and the port the same numpy data and compare outputs
exactly."""

from __future__ import annotations

import numpy as np


def jax_state_to_numpy(st) -> dict:
    """A JAX `NetPlaneState` as the numpy dict `shadow_tpu_torch.convert`
    reads (router as a nested dict)."""
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "router"}
    d["router"] = {k: np.asarray(v) for k, v in st.router._asdict().items()}
    return d


def jax_params_to_numpy(params) -> dict:
    return {k: np.asarray(v) for k, v in params._asdict().items()}


def assert_states_equal(a: dict, b: dict, ctx=None):
    """Every leaf bitwise equal, dtype and shape included."""
    assert a.keys() == b.keys(), ctx
    for k in a:
        if k == "router":
            assert_states_equal(a[k], b[k], (ctx, "router"))
            continue
        assert a[k].dtype == b[k].dtype, (ctx, k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), (ctx, k)

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


def placement_inputs(n, ce, ci, seed, *, hot=1 / 8):
    """Kernel B's and D's arguments as numpy arrays, in `pipeline.place`'s
    order: bucket segments that tile the n*ce arrival slots, rows whose
    arrivals overflow the ring, a random arrival order `o_pos` and row
    orders `row_perm`, random payload and ingress columns (invalid slots
    with and without deliver = I32_MAX). Row 0's segment starts before
    the first arrival and row n-1's runs past the last, so both read
    arrivals j outside [0, n*ce)."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    nv = rng.integers(0, ci + 1, n)
    counts = rng.poisson(ce * 0.8, n)
    hot_rows = rng.random(n) < hot
    counts[hot_rows] += rng.integers(ci, 2 * ci, hot_rows.sum())
    counts = np.minimum(counts, np.maximum(
        0, n * ce - (np.cumsum(counts) - counts)))  # fit the n*ce slots
    offsets = np.cumsum(counts) - counts
    take = np.minimum(counts, ci - nv)
    nv[0], take[0], offsets[0] = 0, ci, -(ci // 2)
    nv[-1], take[-1], offsets[-1] = 1, ci - 1, n * ce - ci // 2
    words = lambda *shape: i32(rng.integers(-2**31, 2**31, shape))
    deliver = words(n, ci)
    deliver[rng.random((n, ci)) < 0.25] = 2**31 - 1
    return (i32(nv), i32(offsets), i32(take),
            rng.permutation(n * ce).astype(np.int64),
            i32(np.argsort(rng.random((n, ce)), axis=1)),
            words(n, ce), words(n, ce), words(n, ce), words(n, ce),
            words(n, ci), words(n, ci), words(n, ci), words(n, ci), deliver,
            rng.random((n, ci)) < 0.5)


def assert_states_equal(a: dict, b: dict, ctx=None):
    """Every leaf bitwise equal, dtype and shape included."""
    assert a.keys() == b.keys(), ctx
    for k in a:
        if k == "router":
            assert_states_equal(a[k], b[k], (ctx, "router"))
            continue
        assert a[k].dtype == b[k].dtype, (ctx, k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), (ctx, k)

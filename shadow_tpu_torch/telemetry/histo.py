"""On-device log2-bucketed latency and depth histograms
(`PlaneHistograms`).

Counterpart of `shadow_tpu/telemetry/histo.py`: per-host [N, B] int32
bucket matrices where bucket b counts observations in [2**b, 2**(b+1))
(bucket 0 also takes values <= 1), accumulated on the device by
`window_step(kernel="xla", hist=...)` and `ingest_rows(hist=...)` with
int32 scatter-adds, which are exact in any order. The bucket index is
integer comparisons against the powers of two, never a float log2: the
JAX package's `31 - clz(v)`, which PyTorch has no operator for.
Percentiles are read on the host from the final counts and report a
bucket's upper edge.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

#: log2 buckets: 32 cover the whole int32 domain
HIST_BUCKETS = 32

#: the standard SLO quantiles the report surfaces
QUANTILES = (0.5, 0.9, 0.99, 0.999)

#: key prefix of a histogram leaf in a counter dict
HIST_PREFIX = "hist_"


class PlaneHistograms(NamedTuple):
    """Accumulating device histograms; every leaf is [N, B] int32."""

    #: deliver - send per packet, attributed to the destination host
    hist_delivery_ns: torch.Tensor
    #: egress-queue sojourn before the gate, attributed to the source
    hist_sojourn_ns: torch.Tensor
    #: queue-depth samples: one per host per window plus one per
    #: `ingest_rows` append
    hist_qdepth: torch.Tensor


def make_histograms(n_hosts: int, *, device=None) -> PlaneHistograms:
    """A zeroed histogram tuple for `n_hosts` hosts."""
    device = resolve_device(device)
    z = lambda: torch.zeros((n_hosts, HIST_BUCKETS), dtype=torch.int32,
                            device=device)
    return PlaneHistograms(
        hist_delivery_ns=z(), hist_sojourn_ns=z(), hist_qdepth=z())


def hist_names() -> tuple[str, ...]:
    """Leaf names in field order."""
    return tuple(PlaneHistograms._fields)


# -- device-side accumulation ------------------------------------------------


def bucket_index(values: torch.Tensor) -> torch.Tensor:
    """log2 bucket of int32 values, floor(log2(max(v, 1))), as int64:
    the count of the powers 2**1 .. 2**30 that are <= v (a binary search
    over integer boundaries). int32 values stop at 2**31 - 1, so the
    index never passes 30, inside [0, HIST_BUCKETS)."""
    edges = torch.tensor([1 << k for k in range(1, 31)], dtype=torch.int32,
                         device=values.device)
    return torch.bucketize(values.to(torch.int32), edges, right=True)


def _add_counts(h: torch.Tensor, flat_idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """h + per-cell counts of `mask` at the flat [N * B] indices."""
    counts = h.reshape(-1).scatter_add(
        0, flat_idx.reshape(-1), mask.reshape(-1).to(torch.int32))
    return counts.reshape(h.shape)


def accum_rows(h: torch.Tensor, bucket: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Fold [N, C] per-slot observations into the histogram of their
    row (source-attributed)."""
    rows = torch.arange(h.shape[0], device=h.device)[:, None]
    return _add_counts(h, rows * HIST_BUCKETS + bucket, mask)


def accum_scatter(h: torch.Tensor, rows: torch.Tensor, bucket: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Fold [N, C] per-slot observations into the histogram of a target
    row per slot (destination-attributed), rows clipped into [0, N)
    (out-of-range rows must be masked by the caller)."""
    r = torch.clamp(rows, 0, h.shape[0] - 1).to(torch.int64)
    return _add_counts(h, r * HIST_BUCKETS + bucket, mask)


def accum_depth(h: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """One depth observation per host ([N] int32 occupancy)."""
    return accum_rows(h, bucket_index(depth)[:, None],
                      torch.ones_like(depth, dtype=torch.bool)[:, None])


# -- host-side percentile extraction (numpy, on the final counts) -----------


def bucket_edges(b: int) -> tuple[int, int]:
    """[lo, hi) value bounds of bucket `b` (bucket 0's lo is 0)."""
    return (0 if b == 0 else 1 << b, 1 << (b + 1))


def percentile(counts, q: float) -> int:
    """The q-quantile's upper bound from a [B] bucket-count vector: the
    upper edge of the first bucket whose cumulative count reaches
    ceil(q * total); 0 when the histogram is empty."""
    c = np.asarray(counts, np.int64)
    total = int(c.sum())
    if total <= 0:
        return 0
    need = max(int(np.ceil(q * total)), 1)
    b = int(np.searchsorted(np.cumsum(c), need))
    return bucket_edges(min(b, HIST_BUCKETS - 1))[1]


def percentiles(counts, qs=QUANTILES) -> dict:
    """{"p50": ..., "p99": ..., ...} upper bounds for the quantiles."""
    out = {}
    for q in qs:
        digits = f"{q:g}".split(".")[1]
        key = "p" + (digits + "0" if len(digits) == 1 else digits)
        out[key] = percentile(counts, q)
    return out


def fleet_percentiles(hist_nb, qs=QUANTILES) -> dict:
    """`percentiles` over the fleet-summed [N, B] histogram (int64
    sums, so a saturated fleet cannot wrap)."""
    if isinstance(hist_nb, torch.Tensor):
        hist_nb = hist_nb.detach().cpu().numpy()
    return percentiles(np.asarray(hist_nb, np.int64).sum(axis=0), qs)


def ensemble_percentiles(world_counts, qs=QUANTILES) -> dict:
    """Percentiles across an ensemble of worlds: `world_counts` holds one
    [B] bucket-count vector a world for the same histogram (arrays or
    tensors; a [W, B] tensor is W of them). Each world's quantiles come
    from `percentiles` alone, then each quantile's spread over the
    worlds is reported as ``{"p99": {"min": ..., "median": ..., "max":
    ..., "worlds": W}, ...}``. The median is `statistics.median` (the
    mean of the middle two for an even W); a world with an empty
    histogram counts, with percentiles 0; no worlds raises ValueError.
    The JAX `ensemble_percentiles`."""
    import statistics

    if isinstance(world_counts, torch.Tensor):
        world_counts = list(world_counts.detach().cpu().numpy())
    if len(world_counts) == 0:
        raise ValueError(
            "ensemble_percentiles needs >= 1 world bucket vector")
    per_world = [percentiles(c.detach().cpu().numpy()
                             if isinstance(c, torch.Tensor) else c, qs)
                 for c in world_counts]
    out = {}
    for key in per_world[0]:
        vals = sorted(p[key] for p in per_world)
        out[key] = {"min": vals[0], "median": statistics.median(vals),
                    "max": vals[-1], "worlds": len(vals)}
    return out

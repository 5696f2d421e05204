"""Kernels B and D with a source axis of their own (n_src source rows,
N ring rows), as a host-axis mesh rank runs them after the routing
exchange: the plain versions against a direct numpy reference, the
unsharded routing cut to each rank's rows against the rank's placement
(through `pipeline.route_place`/`route_scatter` with a mesh that hands
back the gathered columns), and the ensemble launch refused with a
source axis."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_parity import placement_inputs  # noqa: E402

from shadow_tpu_torch.tpu import pipeline  # noqa: E402
from shadow_tpu_torch.tpu.prims import I32_MAX  # noqa: E402

MS = 1_000_000


def place_reference(nv, offsets, take, o_pos, row_perm, eg_seq, eg_sock,
                    eg_bytes, deliver_rel, in_src, in_seq, in_sock,
                    in_bytes, in_deliver, in_valid):
    """The placement a slot at a time, from `ring_place.cuh`'s text."""
    rings = [a.copy() for a in (in_src, in_seq, in_sock, in_bytes,
                                in_deliver, in_valid)]
    n, ci = in_src.shape
    n_src, ce = row_perm.shape
    for r in range(n):
        for c in range(ci):
            if nv[r] <= c < nv[r] + take[r]:
                j = int(offsets[r]) - int(nv[r]) + c
                if 0 <= j < n_src * ce:
                    p = int(o_pos[j])
                    src = p // ce
                    g = src * ce + int(row_perm.reshape(-1)[p])
                    item = (src, *(a.reshape(-1)[g] for a in (
                        eg_seq, eg_sock, eg_bytes, deliver_rel)))
                else:
                    item = (0, 0, 0, 0, 0)
                for ring, v in zip(rings, item):
                    ring[r, c] = v
                rings[5][r, c] = True
            elif not in_valid[r, c]:
                rings[4][r, c] = I32_MAX
    return rings


@pytest.mark.parametrize("n,n_src,ce,ci", [(16, 64, 8, 16), (37, 148, 4, 8),
                                           (64, 16, 16, 32), (8, 8, 8, 4)])
@pytest.mark.parametrize("fn", [pipeline.place_plain, pipeline.scatter_plain],
                         ids=["B", "D"])
def test_plain_placement_with_a_source_axis_matches_numpy(fn, n, n_src, ce,
                                                          ci):
    args = placement_inputs(n, ce, ci, seed=n + n_src, n_src=n_src)
    want = place_reference(*args)
    got = fn(*(torch.from_numpy(a.copy()) for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert got[5].sum() > args[14].sum()  # it placed something


class GatheredMesh:
    """One rank of an R-rank mesh in this process: `gather_rows` checks
    that it is handed the rank's rows of the global columns, and hands
    back the global columns (what the all-gather returns)."""

    def __init__(self, rank, size, global_cols):
        self.rank, self.size, self.global_cols = rank, size, global_cols

    def row0(self, n_local):
        return self.rank * n_local

    def gather_rows(self, tensors):
        n = tensors[0].shape[0]
        for t, g in zip(tensors, self.global_cols):
            assert torch.equal(t, g[self.rank * n:(self.rank + 1) * n])
        return tuple(self.global_cols)


def routing_world(n, ce, ci, seed):
    """Egress columns of a window over n hosts (destinations anywhere,
    some out of range, deliver times with ties) and the compacted
    ingress rings they land in."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=np.int32: torch.from_numpy(np.asarray(a, dt))
    cols = dict(
        sent=t(rng.random((n, ce)) < 0.6, bool),
        eg_dst=t(rng.integers(-1, n + 1, (n, ce))),
        eg_seq=t(rng.integers(0, 4 * ce, (n, ce))),
        eg_bytes=t(rng.integers(60, 1500, (n, ce))),
        eg_sock=t(rng.integers(0, 9, (n, ce))),
        deliver_rel=t(rng.integers(0, 4, (n, ce)) * MS))
    nv = rng.integers(0, ci + 1, n)
    valid = np.arange(ci)[None, :] < nv[:, None]
    rings = dict(
        in_deliver=t(np.where(valid, rng.integers(0, 9, (n, ci)) * MS,
                              I32_MAX)),
        in_src=t(rng.integers(0, n, (n, ci))),
        in_seq=t(rng.integers(0, 99, (n, ci))),
        in_sock=t(rng.integers(0, 9, (n, ci))),
        in_bytes=t(rng.integers(60, 1500, (n, ci))), in_valid=t(valid, bool))
    return cols, rings, t(nv)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("fused", [True, False], ids=["B", "D"])
def test_unsharded_routing_cut_to_each_rank_equals_its_placement(fused,
                                                                 ranks):
    """The unsharded routing stage's merged rows and overflow of hosts
    [r*N/R, (r+1)*N/R) equal rank r's: its own egress rows in, the
    gathered columns of every host (and, on the fused path, kernel A's
    row order) through the exchange, its own rings placed."""
    n, ce, ci = 32, 8, 16
    cols, rings, nv = routing_world(n, ce, ci, seed=ranks + 10 * fused)
    row_perm = pipeline._seq_row_order(cols["eg_seq"])
    order = ("sent", "eg_dst", "eg_seq", "eg_bytes", "eg_sock",
             "deliver_rel")
    ring_order = ("in_deliver", "in_src", "in_seq", "in_sock", "in_bytes",
                  "in_valid")
    clone = lambda d: [d[k].clone() for k in ring_order]
    stage = pipeline.route_place if fused else pipeline.route_scatter
    extra = (row_perm,) if fused else ()
    whole = stage(*(cols[k] for k in order), *clone(rings), nv, *extra)
    assert whole[-1].sum() > 0 and whole[5].sum() > rings["in_valid"].sum()
    nl = n // ranks
    for r in range(ranks):
        rows = slice(r * nl, (r + 1) * nl)
        mesh = GatheredMesh(r, ranks,
                            [cols[k] for k in order] + [row_perm])
        mine = stage(*(cols[k][rows] for k in order),
                     *(t[rows].clone() for t in clone(rings)), nv[rows],
                     *(p[rows] for p in extra), mesh=mesh)
        for g, w in zip(mine, whole):
            assert torch.equal(g, w[rows]), r


def test_ensemble_launch_with_a_source_axis_is_refused():
    """`world_rows` (the ensemble launch) with n_src != N raises, in the
    plain version and in the op (an ensemble runs without a mesh)."""
    args = [torch.from_numpy(a) for a in placement_inputs(
        8, 4, 8, seed=1, n_src=16)]
    with pytest.raises(ValueError, match="ensemble"):
        pipeline.place_plain(*args, world_rows=4)
    with pytest.raises(ValueError, match="ensemble"):
        pipeline._PLACE_OPS["route_place"](*args, 4, 16)

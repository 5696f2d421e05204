"""The port's kernels as PyTorch custom ops, batched over worlds.

Each hand-written kernel is a `torch.library.custom_op` in the
`shadow_tpu_torch` namespace, so `torch.func.vmap` (the ensemble
driver, `elastic.drive_ensemble`) reaches it through a vmap rule
instead of tracing into a `ctypes` launch, which a batched tensor, with
no storage of its own, cannot feed. The rule folds the world axis into
the kernel's row axis and calls the op once: one launch for all W
worlds, never a loop over them.
"""

from __future__ import annotations

import torch

OP_NAMESPACE = "shadow_tpu_torch"


def custom_op(name: str, impl, schema: str, mutates=()):
    """`impl` registered as the custom op `shadow_tpu_torch::<name>` with
    the given schema (its arguments by name; a mutated one `Tensor(x!)`)."""
    return torch.library.custom_op(f"{OP_NAMESPACE}::{name}", impl,
                                   mutates_args=tuple(mutates),
                                   schema=schema)


def fold_worlds(info, in_dims, args, mutated=()):
    """The vmap rule's half before the op: every tensor argument with
    its world axis first and folded into its first (row) axis, [W, R,
    ...] -> [W * R, ...], so the rows are world 0's, then world 1's, and
    so on. A tensor shared by the worlds (in_dim None) is repeated for
    each. The arguments at the indices `mutated` are written by the op in
    place, so each must fold to a view of itself: batched, world axis
    first and contiguous (as the window step's fresh tensors are)."""
    W = info.batch_size
    folded = []
    for i, (a, d) in enumerate(zip(args, in_dims)):
        if isinstance(a, torch.Tensor):
            if i in mutated and (d != 0 or not a.is_contiguous()):
                raise ValueError(
                    "an op argument written in place must be batched on "
                    "its first axis and contiguous under vmap")
            a = a.expand(W, *a.shape) if d is None else a.movedim(d, 0)
            a = a.reshape(W * a.shape[1], *a.shape[2:])
        folded.append(a)
    return folded


def unfold(W: int, outs):
    """The vmap rule's half after the op: each [W * R, ...] output back
    to [W, R, ...], world axis 0."""
    outs = tuple(o.unflatten(0, (W, -1)) for o in outs)
    return outs, (0,) * len(outs)


def row_op(name: str, impl, schema: str):
    """A custom op of a kernel that works row by row (A, C, E), with the
    vmap rule that folds the worlds into its rows: one call, one launch,
    for every world."""
    op = custom_op(name, impl, schema)

    def batched(info, in_dims, *args):
        folded = fold_worlds(info, in_dims, args)
        return unfold(info.batch_size, op(*folded))

    op.register_vmap(batched)
    return op

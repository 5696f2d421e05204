"""Full-run checkpoint/resume for the chained driver (`RunCheckpointer`).

Counterpart of `shadow_tpu/faults/runstate.py`, in its file format,
array for array: a checkpoint either package writes resumes in the
other. At a chain boundary, where the host already regains control, the
whole driver carry is written to one atomic, self-verifying ``.npz``
(`faults/checkpoint.write_npz_checkpoint`: tmp + fsync + rename,
per-array sha256, the schema stamp ``runstate-v1``):

- the net-plane state and every extras plane of the carry, flattened
  by structural path (``carry.0.eg_dst``, ``carry.1.3.hist_qdepth``,
  ...) in the JAX package's dtypes (the flight recorder's uint32
  leaves, int64 tensors in the port, are written as uint32 and read
  back as int64: `convert.HOST_DTYPES`), with the planes that are off
  recorded as ``none_paths``, so a resume under other switches is
  refused by name;
- the root key's words when the caller has one, the round and the
  virtual clock; a key riding the carry (an int64 [..., 2] key tensor,
  `prims.key_tensor`, `elastic.world_keys`) is written at its path as
  the uint32 key words, where JAX writes `jax.random.key_data` of its
  typed key, when its path is among ``key_paths``;
- the capacity policy's growth history (the grown shapes ride the
  arrays: `restore_carry` takes the structure from the template and the
  shapes from the file);
- the fault schedule's position and fingerprint;
- the memo cache (`ChainMemo.spill` under ``memo.``).

A run killed at any chain boundary and resumed from its newest
checkpoint ends byte-identical to the uninterrupted run: `chain_spans`
cuts at absolute multiples, so a resume partitions the rest as the
whole run did, and chain length is invisible to the state stream.
Truncation, bit flips, schema drift, a missing leaf, a presence mismatch
and a schedule-fingerprint mismatch each raise `CheckpointError` naming
the field.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np
import torch

from ..convert import HOST_DTYPES, carry_to_host, leaf_to_device
from .checkpoint import (CheckpointError, load_npz_checkpoint,
                         write_npz_checkpoint)

__all__ = [
    "RUNSTATE_SCHEMA", "RunCheckpointer", "flatten_carry",
    "latest_checkpoint", "load_runstate", "restore_carry",
    "resume_carry",
]

#: schema stamp for full-run checkpoints (`load_npz_checkpoint`
#: refuses a mismatch before any field is trusted)
RUNSTATE_SCHEMA = "runstate-v1"

_SUFFIX = ".runstate.npz"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _key_words(path: str, a: np.ndarray) -> np.ndarray:
    """A key leaf's host array as JAX's key words: uint32 [..., 2]."""
    if a.shape[-1:] != (2,) or a.dtype.kind not in "iu" or (
            a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF)):
        raise ValueError(f"carry leaf {path!r} is not a key: "
                         f"{a.dtype}{a.shape}")
    return a.astype(np.uint32)


def flatten_carry(carry, prefix: str = "carry", *, host: bool = False,
                  key_paths=()):
    """Flatten a driver carry into path-named host arrays.

    `carry` holds tensors (copied to the host in the JAX dtypes with one
    synchronise), or with ``host=True`` is already `convert.carry_to_host`
    output. The leaves at ``key_paths`` are key tensors, written as
    uint32 key words (JAX's dtype for a spilled key). Returns
    ``(arrays, none_paths)``: every leaf under its structural path and
    the sorted paths of the ``None`` subtrees."""
    if not host:
        carry = carry_to_host(carry)
    arrays: dict[str, np.ndarray] = {}
    nones: list[str] = []

    def rec(node, path: str):
        if node is None:
            nones.append(path)
            return
        if _is_namedtuple(node):
            for fname, val in zip(node._fields, node):
                rec(val, f"{path}.{fname}")
            return
        if isinstance(node, (tuple, list)):
            for i, val in enumerate(node):
                rec(val, f"{path}.{i}")
            return
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{path}.{k}")
            return
        arrays[path] = np.asarray(node)

    rec(carry, prefix)
    for path in key_paths:
        arrays[path] = _key_words(path, arrays[path])
    return arrays, sorted(nones)


_NP_OF = {torch.bool: np.dtype(bool), torch.int32: np.dtype(np.int32),
          torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64), torch.int16: np.dtype(np.int16),
          torch.int8: np.dtype(np.int8), torch.uint8: np.dtype(np.uint8)}


def restore_carry(template, arrays, *, none_paths=(),
                  prefix: str = "carry", source: str = "<checkpoint>",
                  key_paths=()):
    """Inverse of `flatten_carry`: the template's structure with the
    checkpoint's leaves as tensors on each template leaf's device, in
    the port's dtypes (a Python number leaf comes back as a Python
    number).

    The template gives the structure and the leaf types; shapes come
    from the file, so a checkpoint written after elastic growth restores
    the grown world into a template built at the seed capacity. Refusals
    (`CheckpointError`, naming the path): a leaf the template expects and
    the file lacks; a leaf whose dtype is not the template's; a plane
    this run has off that the checkpoint recorded; a plane this run has
    on that the checkpoint recorded as ``None``. A leaf at
    ``key_paths`` is read as uint32 key words into an int64 key tensor."""
    none_set = set(none_paths)

    def rec(node, path: str, owner: str = "", field: str = ""):
        if node is None:
            if path in none_set:
                return None
            below = [k for k in arrays
                     if k == path or k.startswith(path + ".")]
            if below:
                raise CheckpointError(
                    f"{source}: presence mismatch at {path!r} — this run "
                    f"has the plane disabled (None) but the checkpoint "
                    f"recorded {below[0]!r}; resume with the same "
                    f"switches as the checkpointing run")
            return None
        if _is_namedtuple(node):
            cls = type(node).__name__
            return type(node)(*(rec(v, f"{path}.{f}", cls, f)
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(rec(v, f"{path}.{i}")
                              for i, v in enumerate(node))
        if isinstance(node, dict):
            return {k: rec(node[k], f"{path}.{k}") for k in sorted(node)}
        if path in none_set:
            raise CheckpointError(
                f"{source}: presence mismatch at {path!r} — the "
                f"checkpoint recorded this plane disabled (None) but "
                f"this run has it enabled; resume with the same "
                f"switches as the checkpointing run")
        if path not in arrays:
            raise CheckpointError(
                f"{source}: checkpoint is missing carry leaf {path!r} — "
                f"written by an incompatible configuration?")
        arr = np.asarray(arrays[path])
        if not isinstance(node, torch.Tensor):
            return type(node)(arr.item())
        want = (np.uint32 if path in key_paths else
                HOST_DTYPES.get((owner, field), _NP_OF.get(node.dtype)))
        if want is not None and arr.dtype != np.dtype(want):
            raise CheckpointError(
                f"{source}: carry leaf {path!r} is {arr.dtype} in the "
                f"checkpoint, {np.dtype(want)} in this run")
        if path in key_paths:
            return torch.from_numpy(arr.astype(np.int64)).to(node.device)
        return leaf_to_device(owner, field, arr, node.device)

    return rec(template, prefix)


class RunCheckpointer:
    """Periodic full-run checkpoints at chain boundaries.

    Construct one per run and hand it to
    ``drive_chained_windows(checkpointer=)`` or
    ``drive_ensemble(checkpointer=)`` (an ensemble's batched carry, [W,
    ...] leaves, goes to one file). ``key_paths`` names the carry's key
    leaves (e.g. ``"carry.1.0"``), written as JAX's uint32 key words.
    The driver merges `cut_rounds` into its
    boundary set (so checkpoint instants are chain cuts even when
    ``every`` is not a multiple of ``chain_len`` — bitwise-invisible
    by the chain-length theorem) and calls `save` at every due
    boundary.

    ``schedule`` / ``policy`` / ``memo`` are the host-side companions
    whose state must survive with the carry: the fault schedule's
    position, the `RingPolicy` growth trajectory, and the `ChainMemo`
    cache. ``extra_meta`` rides every checkpoint verbatim (scenario
    fingerprints, knob digests — whatever the resume path wants to
    cross-check)."""

    def __init__(self, directory: str, *, every: int,
                 label: str = "run", keep: int = 2,
                 window_ns: int = 0, rng_key_data=None,
                 schedule=None, policy=None, memo=None,
                 extra_meta: Optional[dict] = None,
                 kill_after: Optional[int] = None, key_paths=()):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")
        if keep < 1:
            raise ValueError(f"checkpoint keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.every = int(every)
        self.label = str(label)
        self.keep = int(keep)
        self.window_ns = int(window_ns)
        self.rng_key_data = rng_key_data
        self.schedule = schedule
        self.policy = policy
        self.memo = memo
        self.extra_meta = dict(extra_meta or {})
        self.key_paths = tuple(key_paths)
        # CI/test crash point: die with SIGKILL's exit code the
        # instant the checkpoint for this round is durable — the
        # kill/resume parity gate's deterministic "preemption"
        self.kill_after = kill_after
        self.saved = 0
        self.last_path: Optional[str] = None
        self.save_ms: list[float] = []

    # -- driver protocol --------------------------------------------------

    def cut_rounds(self, n_rounds: int) -> tuple:
        """The checkpoint instants as explicit chain boundaries."""
        return tuple(range(self.every, n_rounds, self.every))

    def due(self, r1: int, n_rounds: int) -> bool:
        """Checkpoint after the span ending at ``r1``? (The final
        boundary is skipped — the run is already finishing.)"""
        return r1 % self.every == 0 and r1 < n_rounds

    def path_for(self, r1: int) -> str:
        return os.path.join(self.directory,
                            f"{self.label}-r{r1:08d}{_SUFFIX}")

    def save(self, r1: int, carry, *, host: bool = False,
             tracer=None) -> dict:
        """Write the checkpoint for the boundary at round ``r1``.

        ``carry`` is the driver's ``(state, extras)``: tensors, copied to
        the host with one synchronise (`convert.carry_to_host`), or with
        ``host=True`` the memo's host mirror, saved as it is (no device
        round trip). `save_ms` keeps the host milliseconds of each save,
        the file's fsync and rename included."""
        t0 = time.perf_counter()
        arrays, none_paths = flatten_carry(carry, host=host,
                                           key_paths=self.key_paths)
        meta: dict[str, Any] = {
            "kind": "runstate",
            "label": self.label,
            "round": int(r1),
            "window_ns": self.window_ns,
            "time_ns": int(r1) * self.window_ns,
            "none_paths": none_paths,
        }
        meta.update(self.extra_meta)
        if self.rng_key_data is not None:
            arrays["rng.key_data"] = np.asarray(self.rng_key_data)
        if self.schedule is not None:
            # the schedule's position is its monotone advance time:
            # the cursor is a pure function of it, so resume replays
            # one advance() to land on the identical cursor
            meta["schedule"] = {
                "now_ns": int(r1) * self.window_ns,
                "fingerprint": self.schedule.fingerprint(),
            }
        if self.policy is not None:
            meta["capacity"] = self.policy.to_meta()
        if self.memo is not None:
            m_meta, m_arrays = self.memo.spill(prefix="memo.")
            meta["memo"] = m_meta
            arrays.update(m_arrays)
        path = self.path_for(r1)
        write_npz_checkpoint(path, schema=RUNSTATE_SCHEMA, meta=meta,
                             arrays=arrays)
        self.saved += 1
        self.last_path = path
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        self._prune()
        ckpt_id = os.path.basename(path)[:-len(_SUFFIX)]
        if tracer is not None:
            tracer.annotate("checkpoint", id=ckpt_id, r=int(r1),
                            path=path)
        if self.kill_after is not None and int(r1) == int(self.kill_after):
            if tracer is not None:
                tracer.annotate("kill", r=int(r1), id=ckpt_id)
            os._exit(137)  # SIGKILL's exit code, with no clean-up
        return {"path": path, "id": ckpt_id, "round": int(r1)}

    def _prune(self) -> None:
        files = sorted(
            e for e in os.listdir(self.directory)
            if e.startswith(f"{self.label}-r") and e.endswith(_SUFFIX))
        for e in files[:-self.keep]:
            try:
                os.unlink(os.path.join(self.directory, e))
            except OSError:
                pass
        for e in os.listdir(self.directory):
            if ".tmp-" in e:
                try:
                    os.unlink(os.path.join(self.directory, e))
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# resume side
# ---------------------------------------------------------------------------


def latest_checkpoint(directory: str, label: str = "run") -> Optional[str]:
    """Newest runstate checkpoint for ``label`` (names embed the
    zero-padded round, so lexicographic == temporal); None when the
    directory holds none."""
    if not os.path.isdir(directory):
        return None
    files = sorted(
        e for e in os.listdir(directory)
        if e.startswith(f"{label}-r") and e.endswith(_SUFFIX))
    return os.path.join(directory, files[-1]) if files else None


def load_runstate(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Load + verify one runstate checkpoint; ``(meta, arrays)``.
    Every refusal (truncation, tamper, schema drift, uncovered field)
    is a `CheckpointError` naming what is wrong (see
    `faults/checkpoint.load_npz_checkpoint`)."""
    meta, arrays = load_npz_checkpoint(path, schema=RUNSTATE_SCHEMA)
    if meta.get("kind") != "runstate":
        raise CheckpointError(
            f"{path}: kind {meta.get('kind')!r} is not a full-run "
            f"checkpoint")
    return meta, arrays


def resume_carry(path: str, template_carry, *, schedule=None,
                 policy=None, memo=None, key_paths=()) -> dict:
    """One-call resume: load, verify, rebuild the carry, and restore
    the host-side companions.

    Returns ``{"round", "carry", "meta", "rng_key_data",
    "memo_loaded"}``. ``template_carry`` is the freshly built
    ``(state, extras)`` of a cold run of the SAME configuration —
    structure from it, bytes and shapes from the file. When given,
    ``schedule`` is advanced to the recorded position, ``policy``
    re-absorbs the growth trajectory, and ``memo`` re-admits the
    spilled cache (salt-checked; `ChainMemo.absorb` refuses a
    mismatched world)."""
    meta, arrays = load_runstate(path)
    carry = restore_carry(template_carry, arrays,
                          none_paths=meta.get("none_paths", ()),
                          source=path, key_paths=key_paths)
    out: dict[str, Any] = {
        "round": int(meta["round"]),
        "carry": carry,
        "meta": meta,
        "rng_key_data": arrays.get("rng.key_data"),
        "memo_loaded": 0,
    }
    if schedule is not None and "schedule" in meta:
        want = meta["schedule"].get("fingerprint")
        if want is not None and want != schedule.fingerprint():
            raise CheckpointError(
                f"{path}: fault-schedule fingerprint mismatch (checkpoint "
                f"{str(want)[:12]}..., this run "
                f"{schedule.fingerprint()[:12]}...) — resume with the "
                f"schedule the checkpointing run used")
        schedule.advance(int(meta["schedule"]["now_ns"]))
    if policy is not None and "capacity" in meta:
        policy.restore_meta(meta["capacity"])
    if memo is not None and "memo" in meta:
        # restore=True: this is a RESUME, not a cross-run cache
        # import — per-entry hits, persisted flags, and every counter
        # come back verbatim, so the resumed run's memo report is
        # byte-identical to the uninterrupted twin's
        out["memo_loaded"] = memo.absorb(meta["memo"], arrays,
                                         prefix="memo.", source=path,
                                         restore=True)
    return out

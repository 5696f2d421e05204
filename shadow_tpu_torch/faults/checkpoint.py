"""Crash-survivable checkpoints: atomic write-rename + checksums.

Counterpart of `shadow_tpu/faults/checkpoint.py`, in the same formats,
so a checkpoint either package writes, the other reads:

- a DIRECTORY checkpoint ``<name>/`` holding ``arrays.npz`` (every array
  leaf under ``<group>.<field>``), ``meta.json`` and ``MANIFEST.json``
  (sha256 of both payload files and the format version), written into
  ``<name>.tmp-<pid>/`` and `os.replace`d into place
  (`write_checkpoint`, `load_checkpoint`, `prune_checkpoints`); the
  device-plane kind ``plane`` (`save_plane_checkpoint`,
  `load_plane_checkpoint`) rides it;
- a SINGLE-FILE ``.npz`` with an embedded JSON meta record carrying a
  per-array sha256 map and a schema stamp (`write_npz_checkpoint`,
  `load_npz_checkpoint`), written tmp file -> fsync -> `os.replace` ->
  parent-directory fsync, so the file exists whole or not at all.
  `faults/runstate.py` (full-run checkpoints) and `tpu/memo.py`
  (`ChainMemo.save/load`) ride it.

The checksums detect corruption (truncation, bit rot, schema drift);
they are not a tamper seal. The CPU `Manager`'s diagnostic snapshots
(kind ``manager``: `manager_snapshot`, `write_manager_checkpoint`) take
the manager duck-typed, so a Manager running over the port's device
transport writes them with its tensors read through `.cpu().numpy()`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Optional

import numpy as np

log = logging.getLogger("shadow_tpu_torch.faults")

FORMAT_VERSION = 1
MANIFEST = "MANIFEST.json"
_ARRAYS = "arrays.npz"
_META = "meta.json"


class CheckpointError(RuntimeError):
    """Unreadable, corrupt, or mismatched checkpoint."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (POSIX only promises the rename is durable once the parent is)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # e.g. platforms refusing O_RDONLY on directories
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_checkpoint(path: str, *, meta: dict,
                     arrays: Optional[dict[str, np.ndarray]] = None) -> dict:
    """Write one checkpoint directory atomically; returns the manifest.

    `meta` must be JSON-serializable; `arrays` values must be numpy
    arrays (callers copy tensors to the host first). `path` is the final
    directory name."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        np.savez(os.path.join(tmp, _ARRAYS), **(arrays or {}))
        with open(os.path.join(tmp, _META), "w") as fh:
            json.dump(meta, fh, sort_keys=True, indent=1)
        manifest = {
            "format": FORMAT_VERSION,
            "kind": meta.get("kind", "unknown"),
            "sha256": {
                _ARRAYS: _sha256(os.path.join(tmp, _ARRAYS)),
                _META: _sha256(os.path.join(tmp, _META)),
            },
        }
        with open(os.path.join(tmp, MANIFEST), "w") as fh:
            json.dump(manifest, fh, sort_keys=True, indent=1)
        # fsync the payload so the rename can't land before the bytes
        for name in (_ARRAYS, _META, MANIFEST):
            fd = os.open(os.path.join(tmp, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        if os.path.exists(path):
            # rotate the old same-name checkpoint out of the way so the
            # replace is atomic; it is gone only after the new one lands
            old = f"{path}.old-{os.getpid()}"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)
    return manifest


def load_checkpoint(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Verify the manifest checksums and return (meta, arrays)."""
    path = os.path.abspath(path)
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise CheckpointError(f"{path}: not a checkpoint (no {MANIFEST})")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: unreadable manifest: {e}") from e
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: checkpoint format {manifest.get('format')!r} != "
            f"supported {FORMAT_VERSION}")
    shas = manifest.get("sha256")
    # a manifest that lists no checksum for a payload file verifies
    # nothing about it — a truncated arrays.npz would be half-accepted.
    # Both payload files MUST be covered (the old hole: iterate-what's-
    # listed silently skipped anything missing from the map).
    if not isinstance(shas, dict) or not {_ARRAYS, _META} <= set(shas):
        absent = sorted({_ARRAYS, _META} - set(shas or ()))
        raise CheckpointError(
            f"{path}: manifest lists no checksum for {absent} — refusing "
            f"a checkpoint whose payload cannot be verified")
    for name, want in shas.items():
        fpath = os.path.join(path, name)
        if not os.path.isfile(fpath):
            raise CheckpointError(f"{path}: missing payload file {name}")
        got = _sha256(fpath)
        if got != want:
            raise CheckpointError(
                f"{path}: checksum mismatch on {name} (manifest {want[:12]}"
                f"..., file {got[:12]}...) — the checkpoint is corrupt")
    try:
        with open(os.path.join(path, _META)) as fh:
            meta = json.load(fh)
        with np.load(os.path.join(path, _ARRAYS)) as z:
            arrays = {k: z[k] for k in z.files}
    except CheckpointError:
        raise
    except Exception as e:  # truncated zip, bad JSON, OSError, ...
        raise CheckpointError(
            f"{path}: unreadable payload (truncated or corrupt): {e}") from e
    return meta, arrays


def prune_checkpoints(directory: str, keep: int, prefix: str = "ckpt-") -> None:
    """Keep the newest `keep` periodic checkpoints (by name — names
    embed the zero-padded round number, so lexicographic == temporal)
    and sweep dead ``.tmp-*`` / ``.old-*`` partials."""
    if not os.path.isdir(directory):
        return
    entries = sorted(
        e for e in os.listdir(directory)
        if e.startswith(prefix) and ".tmp-" not in e and ".old-" not in e)
    for e in entries[:-keep] if keep > 0 else entries:
        shutil.rmtree(os.path.join(directory, e), ignore_errors=True)
    for e in os.listdir(directory):
        if ".tmp-" in e or ".old-" in e:
            shutil.rmtree(os.path.join(directory, e), ignore_errors=True)


# ---------------------------------------------------------------------------
# single-file atomic checkpoints: .npz with an embedded, self-verifying
# meta record (the runstate / ChainMemo persistence format)
# ---------------------------------------------------------------------------

NPZ_META_KEY = "__meta__"


def _array_sha256(arr: np.ndarray) -> str:
    """Content hash of one array: dtype + shape + bytes, so a bit flip,
    a silent dtype cast, or a reshape all read as corruption."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def write_npz_checkpoint(path: str, *, schema: str, meta: dict,
                         arrays: dict[str, np.ndarray]) -> dict:
    """Atomically write one self-verifying ``.npz`` checkpoint file.

    The JSON-serializable `meta` is embedded in the archive itself (as
    a uint8 blob under `NPZ_META_KEY`) together with a `schema` stamp,
    the format version, and a per-array sha256 map covering EVERY
    array — so there is exactly one file to rename, and a load can
    refuse truncation/corruption naming the offending field. Write
    order is tmp file -> fsync -> os.replace -> parent-dir fsync; a
    kill at any instant leaves either the old file or the new one,
    never a prefix. Returns the full embedded meta."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    clean: dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        if name == NPZ_META_KEY:
            raise CheckpointError(
                f"array name {name!r} collides with the embedded meta key")
        clean[name] = np.asarray(arr)
    full_meta = dict(meta)
    full_meta["format"] = FORMAT_VERSION
    full_meta["schema"] = schema
    full_meta["sha256"] = {n: _array_sha256(a)
                           for n, a in sorted(clean.items())}
    blob = np.frombuffer(
        json.dumps(full_meta, sort_keys=True).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **{NPZ_META_KEY: blob}, **clean)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(parent)
    return full_meta


def load_npz_checkpoint(path: str, *,
                        schema: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Load + verify a `write_npz_checkpoint` file; (meta, arrays).

    Refuses — always as `CheckpointError`, always naming what's wrong —
    an unreadable/truncated archive, a missing or undecodable meta
    record, a format/schema mismatch, an array listed in the checksum
    map but absent from the archive, an array present but NOT covered
    by the map, and any per-array checksum mismatch."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise CheckpointError(f"{path}: no such checkpoint file")
    try:
        with np.load(path) as z:
            payload = {k: z[k] for k in z.files}
    except Exception as e:  # BadZipFile / EOF / OSError / pickle refusal
        raise CheckpointError(
            f"{path}: unreadable checkpoint (truncated or corrupt): "
            f"{e}") from e
    if NPZ_META_KEY not in payload:
        raise CheckpointError(
            f"{path}: missing embedded meta record {NPZ_META_KEY!r} — not "
            f"a runstate-format checkpoint")
    try:
        meta = json.loads(bytes(payload.pop(NPZ_META_KEY)).decode())
    except ValueError as e:
        raise CheckpointError(
            f"{path}: undecodable embedded meta record: {e}") from e
    if meta.get("format") != FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: checkpoint format {meta.get('format')!r} != "
            f"supported {FORMAT_VERSION}")
    if meta.get("schema") != schema:
        raise CheckpointError(
            f"{path}: schema {meta.get('schema')!r} != expected {schema!r} "
            f"— written by an incompatible version?")
    want = meta.get("sha256")
    if not isinstance(want, dict):
        raise CheckpointError(
            f"{path}: meta carries no per-array sha256 map — refusing a "
            f"checkpoint whose arrays cannot be verified")
    missing = sorted(set(want) - set(payload))
    if missing:
        raise CheckpointError(
            f"{path}: missing array {missing[0]!r} (listed in the checksum "
            f"map but absent from the archive — truncated checkpoint?)")
    extra = sorted(set(payload) - set(want))
    if extra:
        raise CheckpointError(
            f"{path}: array {extra[0]!r} is not covered by the checksum "
            f"map — refusing an unverifiable field")
    for name in sorted(want):
        got = _array_sha256(payload[name])
        if got != want[name]:
            raise CheckpointError(
                f"{path}: checksum mismatch on array {name!r} (meta "
                f"{want[name][:12]}..., file {got[:12]}...) — the "
                f"checkpoint is corrupt")
    return meta, payload


# ---------------------------------------------------------------------------
# device-plane checkpoints (kind="plane"): full bitwise restore
# ---------------------------------------------------------------------------


def _flatten_named(prefix: str, tree) -> dict[str, np.ndarray]:
    """NamedTuple of tensors -> {prefix.field: numpy array} (nested
    NamedTuples recurse with dotted names), in the JAX package's dtypes
    (`convert.carry_to_host`)."""
    from ..convert import carry_to_host

    out: dict[str, np.ndarray] = {}
    host = carry_to_host(tree)
    for name in host._fields:
        leaf = getattr(host, name)
        if hasattr(leaf, "_fields"):
            out.update(_flatten_named(f"{prefix}.{name}", leaf))
        else:
            out[f"{prefix}.{name}"] = np.asarray(leaf)
    return out


def _unflatten_named(prefix: str, template, arrays: dict[str, np.ndarray],
                     device):
    """Inverse of `_flatten_named`: rebuild `template`'s type with the
    stored leaves as tensors on `device`, in the port's dtypes."""
    from ..convert import leaf_to_device

    kw = {}
    cls = type(template).__name__
    for name in template._fields:
        leaf = getattr(template, name)
        if hasattr(leaf, "_fields"):
            kw[name] = _unflatten_named(f"{prefix}.{name}", leaf, arrays,
                                        device)
        else:
            key = f"{prefix}.{name}"
            if key not in arrays:
                raise CheckpointError(
                    f"checkpoint is missing array leaf {key!r} — written "
                    f"by an incompatible version?")
            kw[name] = leaf_to_device(cls, name, arrays[key], device)
    return type(template)(**kw)


def save_plane_checkpoint(path: str, *, state, clock_ns: int,
                          rng_key_data: np.ndarray,
                          faults=None, metrics=None,
                          extra_arrays: Optional[dict] = None,
                          meta: Optional[dict] = None) -> dict:
    """Checkpoint a device-plane world (`tpu/plane.NetPlaneState` and
    friends) for a bitwise restore. `rng_key_data` is the root key's raw
    uint32 words (`tpu/prims.key_data`); `extra_arrays` carries any
    driver-private carry (tensors or numpy; restore returns them as numpy
    under `extra`)."""
    from ..convert import carry_to_host

    arrays = _flatten_named("state", state)
    arrays["rng.key_data"] = np.asarray(rng_key_data, np.uint32)
    if faults is not None:
        arrays.update(_flatten_named("faults", faults))
    if metrics is not None:
        arrays.update(_flatten_named("metrics", metrics))
    extra = carry_to_host(dict(extra_arrays or {}))
    for name, arr in extra.items():
        arrays[f"extra.{name}"] = np.asarray(arr)
    full_meta = {
        "kind": "plane",
        "clock_ns": int(clock_ns),
        "has_faults": faults is not None,
        "has_metrics": metrics is not None,
    }
    if hasattr(state, "eg_dst") and hasattr(state, "in_src"):
        # the ring dimensions a resumed elastic run had grown to
        full_meta["ring_dims"] = {
            "egress_cap": int(arrays["state.eg_dst"].shape[1]),
            "ingress_cap": int(arrays["state.in_src"].shape[1]),
        }
    full_meta.update(meta or {})
    return write_checkpoint(path, meta=full_meta, arrays=arrays)


def load_plane_checkpoint(path: str, *, state_template,
                          faults_template=None, metrics_template=None,
                          grow_to=None, device=None):
    """Restore a `plane` checkpoint onto `device` (None: the template
    state's device). Returns a dict with `meta`, `state`, `clock_ns`,
    `rng_key_data` and, when stored and a template is given, `faults` and
    `metrics`; `extra` holds the driver-private arrays as numpy.

    The state keeps the ring shapes it was saved with (the template gives
    only the structure), so a checkpoint written mid-growth restores the
    grown world. `grow_to=(egress_cap, ingress_cap)` repacks it into
    larger rings through `tpu/elastic.grow_state`."""
    import torch

    if device is None:
        device = state_template.eg_dst.device
    device = torch.device(device)
    meta, arrays = load_checkpoint(path)
    if meta.get("kind") != "plane":
        raise CheckpointError(
            f"{path}: kind {meta.get('kind')!r} is not a device-plane "
            f"checkpoint")
    out: dict[str, Any] = {
        "meta": meta,
        "clock_ns": int(meta["clock_ns"]),
        "state": _unflatten_named("state", state_template, arrays, device),
        "rng_key_data": arrays["rng.key_data"],
    }
    if grow_to is not None:
        from ..tpu import elastic

        out["state"] = elastic.grow_state(out["state"], *grow_to)
    if meta.get("has_faults") and faults_template is not None:
        out["faults"] = _unflatten_named("faults", faults_template, arrays,
                                         device)
    if meta.get("has_metrics") and metrics_template is not None:
        out["metrics"] = _unflatten_named("metrics", metrics_template,
                                          arrays, device)
    out["extra"] = {k[len("extra."):]: v for k, v in arrays.items()
                    if k.startswith("extra.")}
    return out


# ---------------------------------------------------------------------------
# manager snapshots (kind="manager"): periodic + emergency diagnostics
# ---------------------------------------------------------------------------


def manager_snapshot(manager, now_ns: int, *, reason: str) -> dict:
    """The serializable core of a round-loop manager: RNG streams,
    clocks, tracker counters, stats, telemetry totals, and the device
    transport's counter arrays. Diagnostic, not resumable: host event
    queues hold live closures no serializer can see."""
    meta: dict[str, Any] = {
        "kind": "manager",
        "resumable": False,
        "reason": reason,
        "clock_ns": int(now_ns),
        "rounds": int(manager.stats.rounds),
        "seed": int(manager.config.general.seed),
        "stop_time_ns": int(manager.config.general.stop_time),
        "global_rng_state": [int(s) for s in manager.global_rng.s],
        "hosts": {
            h.name: {
                "now_ns": int(h.now()),
                "rng_state": [int(s) for s in h.rng.s],
                "events_executed": int(h.n_events_executed),
                "fault_down": bool(getattr(h, "fault_down", False)),
                "fault_packets_dropped": int(
                    getattr(h, "fault_packets_dropped", 0)),
            }
            for h in manager.hosts
        },
        "trackers": {name: t.counters.as_dict()
                     for name, t in manager.trackers.items()},
        "stats": manager.stats.as_dict(),
    }
    if manager.harvester is not None:
        meta["telemetry"] = {
            "harvests": manager.harvester.harvests,
            "emitted": manager.harvester.emitted,
        }
    ledger = getattr(manager, "_guard_ledger", None)
    if ledger is not None:
        # the violation ledger rides every snapshot: an emergency
        # checkpoint of an aborted run carries the findings that ended it
        meta["guards"] = ledger.as_dict()
    arrays: dict[str, np.ndarray] = {}
    transport = getattr(manager, "transport", None)
    if transport is not None:
        # the capacity trajectory rides every snapshot (getattr: a
        # stand-in transport may lack the policy)
        cap_summary = getattr(transport, "capacity_summary", None)
        if cap_summary is not None:
            meta["capacity"] = cap_summary()
        for name, arr in transport.telemetry_arrays().items():
            arrays[f"transport.{name}"] = arr.detach().cpu().numpy()
    return {"meta": meta, "arrays": arrays}


def write_manager_checkpoint(manager, directory: str, now_ns: int, *,
                             reason: str, keep: int = 2) -> Optional[str]:
    """Periodic/emergency manager snapshot; never raises (a failing
    emergency checkpoint must not mask the crash it documents)."""
    try:
        snap = manager_snapshot(manager, now_ns, reason=reason)
        name = ("emergency" if reason == "emergency"
                else f"ckpt-{manager.stats.rounds:012d}")
        path = os.path.join(directory, name)
        write_checkpoint(path, meta=snap["meta"], arrays=snap["arrays"])
        if reason != "emergency":
            prune_checkpoints(directory, keep)
        log.info("checkpoint: wrote %s snapshot at simtime %d -> %s",
                 reason, now_ns, path)
        return path
    except Exception:
        log.error("checkpoint: failed to write %s snapshot", reason,
                  exc_info=True)
        return None

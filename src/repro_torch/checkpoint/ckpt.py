"""Crash-safe flat-npz checkpointing of the port's trees: manifest,
checksums, retention, atomic writes (torch copy of the reference
``repro.checkpoint.ckpt``; the files are the same format).

A tree is a nest of dicts, lists and tuples whose leaves are tensors or
numpy arrays (the port's parameters, a list of per-layer dicts, and its
optimizer state).  Leaves are addressed by their path with dict keys and
list indices joined by ``/`` (``params/0/w_self``, ``opt_state/step``),
the reference's leaf names, so a checkpoint written by either package
restores into the other's tree of the same structure, and is readable
with plain numpy.  Tensors are copied to host numpy at save time: an
in-place optimizer update after the save cannot reach the file.

Durability contract (single writer per directory):

- the npz is written to a ``*.tmp`` file, **fsync'd**, then atomically
  ``os.replace``d into place; ``meta_*.json`` follows the same tmp +
  replace protocol, so a reader never sees a torn file;
- a ``MANIFEST.json`` (also written atomically) records each COMPLETED
  step with the npz's sha256 — it is the last thing written, so a save
  killed at any point leaves the directory restorable at the previous
  step (``latest_step`` trusts the manifest when one exists and never
  reports a half-finished save);
- stale ``*.tmp`` files left by a crashed writer are garbage-collected
  at the start of the next save, so they can never race or shadow a
  real checkpoint;
- ``keep_last=k`` retains only the newest k steps: the manifest is
  rewritten FIRST, then the retired files are deleted, so a crash
  mid-retention strands at worst unreferenced files (cleaned by the
  next retention pass), never a referenced-but-deleted step.

``restore_checkpoint`` verifies the recorded checksum (corruption ->
``CheckpointCorruptError``) and raises typed, leaf-naming errors on
structure drift: ``CheckpointKeyError`` (missing/extra leaves),
``CheckpointShapeError``, ``CheckpointDtypeError`` — real exceptions,
not ``assert``s that vanish under ``python -O``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "MANIFEST.json"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


class CheckpointError(RuntimeError):
    """Base class for checkpoint layer failures."""


class CheckpointCorruptError(CheckpointError):
    """Stored checksum does not match the bytes on disk."""


class CheckpointKeyError(CheckpointError):
    """Checkpoint and restore-target trees have different leaf sets."""


class CheckpointShapeError(CheckpointError):
    """A stored leaf's shape does not match the restore target's."""


class CheckpointDtypeError(CheckpointError):
    """A stored leaf's dtype does not match the restore target's."""


def _maybe_crash(name: str) -> None:
    """Chaos-test failpoint (inert unless ``core.faults`` armed it)."""
    from repro_torch.core import faults
    faults.maybe_crash(name)


def _flatten_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(leaf name, leaf)`` pairs of a nest of dicts, lists and tuples,
    dict keys in sorted order (the reference's leaf order)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, v in items:
        out += _flatten_paths(v, f"{prefix}/{name}" if prefix else name)
    return out


def _unflatten(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[name]``."""
    def at(name):
        return f"{prefix}/{name}" if prefix else name
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, at(str(k))) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, at(str(i)))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _to_numpy(name: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {name!r}: bfloat16 has no numpy dtype; "
                            f"checkpoint it as float32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {name: _to_numpy(name, leaf)
            for name, leaf in _flatten_paths(tree)}


def _np_dtype(leaf) -> Optional[np.dtype]:
    """The numpy dtype a restore target's leaf asks for (None: any)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return None
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    dt = getattr(leaf, "dtype", None)
    return None if dt is None else np.dtype(dt)


# ---------------------------------------------------------------------------
# Low-level durable-write helpers
# ---------------------------------------------------------------------------

def _fsync_dir(directory: str) -> None:
    """Persist renames within ``directory`` (best effort off POSIX)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:                          # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:                          # pragma: no cover
        pass
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj: Any) -> None:
    """tmp + fsync + ``os.replace``: a reader sees the old file or the
    new one, never a torn write."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _gc_stale_tmp(directory: str) -> List[str]:
    """Remove ``*.tmp`` files left behind by a crashed writer.  Called
    at the start of every save (single-writer directories, so any tmp
    present then is stale) — crashed writes can therefore never shadow,
    race, or be mistaken for a real checkpoint."""
    removed = []
    for fn in os.listdir(directory):
        if fn.endswith(".tmp"):
            try:
                os.unlink(os.path.join(directory, fn))
                removed.append(fn)
            except OSError:                  # pragma: no cover
                pass
    return removed


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

def _read_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {path}: {e}") from e
    if not isinstance(m, dict) or "steps" not in m:
        raise CheckpointCorruptError(
            f"malformed checkpoint manifest {path}: no 'steps' table")
    return m


def _scan_steps(directory: str) -> List[int]:
    return sorted(int(m.group(1)) for fn in os.listdir(directory)
                  if (m := _CKPT_RE.match(fn)))


def _load_or_adopt_manifest(directory: str) -> dict:
    """Existing manifest, or a fresh one ADOPTING any pre-manifest
    checkpoints already in the directory (so upgrading a directory
    written by the old format never hides or GC's its steps)."""
    m = _read_manifest(directory)
    if m is not None:
        return m
    m = {"format": 1, "steps": {}}
    for step in _scan_steps(directory):
        fn = f"ckpt_{step:08d}.npz"
        m["steps"][str(step)] = {
            "file": fn,
            "sha256": _sha256(os.path.join(directory, fn)),
            "has_meta": os.path.exists(
                os.path.join(directory, f"meta_{step:08d}.json")),
        }
    return m


def _write_manifest(directory: str, manifest: dict) -> None:
    _write_json_atomic(os.path.join(directory, MANIFEST), manifest)
    _fsync_dir(directory)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None,
                    keep_last: Optional[int] = None) -> str:
    """Durably write ``tree`` as step ``step``.

    Write order (each stage atomic, manifest last): npz -> meta ->
    manifest -> retention.  A crash at ANY point leaves ``latest_step``
    reporting the previous completed step and the directory fully
    restorable there.  ``keep_last`` retains only the newest k manifest
    steps (None/0 = keep all).
    """
    os.makedirs(directory, exist_ok=True)
    _gc_stale_tmp(directory)
    manifest = _load_or_adopt_manifest(directory)

    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        _maybe_crash("ckpt.before_npz_rename")
        os.replace(tmp, path)                 # atomic
    except Exception:
        # recoverable failure (disk full, ...): clean our own tmp up.
        # BaseException (KeyboardInterrupt, SimulatedCrash) falls
        # through like real process death — the next save's
        # _gc_stale_tmp reaps the leftover.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _maybe_crash("ckpt.after_npz_rename")

    if metadata is not None:
        _write_json_atomic(
            os.path.join(directory, f"meta_{step:08d}.json"), metadata)
    _maybe_crash("ckpt.after_meta")

    manifest["steps"][str(step)] = {
        "file": os.path.basename(path),
        "sha256": _sha256(path),
        "has_meta": metadata is not None,
    }
    _write_manifest(directory, manifest)

    if keep_last:
        _retire_old(directory, manifest, int(keep_last))
    return path


def _retire_old(directory: str, manifest: dict, keep_last: int) -> None:
    """Drop all but the newest ``keep_last`` steps: manifest first (the
    source of truth shrinks atomically), files second, then a sweep for
    unreferenced leftovers older than the retained window."""
    steps = sorted(int(s) for s in manifest["steps"])
    if keep_last < 1 or len(steps) <= keep_last:
        return
    drop = steps[:-keep_last]
    for s in drop:
        del manifest["steps"][str(s)]
    _write_manifest(directory, manifest)
    kept_min = min(int(s) for s in manifest["steps"])
    for fn in os.listdir(directory):
        m = _CKPT_RE.match(fn) or re.match(r"meta_(\d+)\.json$", fn)
        if m and int(m.group(1)) < kept_min:
            try:
                os.unlink(os.path.join(directory, fn))
            except OSError:                  # pragma: no cover
                pass
    _fsync_dir(directory)


def available_steps(directory: str) -> List[int]:
    """Completed steps, oldest first (manifest-backed when present)."""
    if not os.path.isdir(directory):
        return []
    m = _read_manifest(directory)
    if m is not None:
        return sorted(int(s) for s in m["steps"])
    return _scan_steps(directory)


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETED step.  With a manifest present, only steps the
    manifest records count — an npz orphaned by a crash between its
    rename and the manifest update is invisible, so readers resume from
    the last save that actually finished."""
    steps = available_steps(directory)
    return max(steps) if steps else None


def load_metadata(directory: str, step: Optional[int] = None
                  ) -> Optional[dict]:
    """The ``metadata`` dict saved alongside step ``step`` (default:
    latest), or None when the step has no meta file."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    path = os.path.join(directory, f"meta_{step:08d}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None,
                       verify: bool = True) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays): tensor leaves come back as tensors on the target leaf's
    device, array leaves as numpy arrays.  ``verify`` checks the manifest's sha256 before
    deserializing (skipped for pre-manifest directories, which recorded
    none)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint step {step} not found: {path}")

    if verify:
        m = _read_manifest(directory)
        entry = None if m is None else m["steps"].get(str(step))
        if entry is not None and entry.get("sha256"):
            digest = _sha256(path)
            if digest != entry["sha256"]:
                raise CheckpointCorruptError(
                    f"checksum mismatch for {path}: manifest records "
                    f"{entry['sha256'][:12]}..., file hashes "
                    f"{digest[:12]}... — the checkpoint is corrupt")

    with np.load(path) as data:
        flat_like = _flatten_paths(like)
        want = [name for name, _ in flat_like]
        have = set(data.files)
        missing = [n for n in want if n not in have]
        extra = sorted(have - set(want))
        if missing or extra:
            raise CheckpointKeyError(
                f"checkpoint {path} does not match the restore target: "
                f"missing leaves {missing or 'none'}, "
                f"unexpected leaves {extra or 'none'} — was it saved "
                f"from a different model/optimizer structure?")
        leaves = {}
        for name, leaf in flat_like:
            arr = data[name]
            want_shape = tuple(getattr(leaf, "shape", arr.shape))
            if arr.shape != want_shape:
                raise CheckpointShapeError(
                    f"leaf {name!r}: checkpoint shape {arr.shape} != "
                    f"restore target shape {want_shape}")
            want_dtype = _np_dtype(leaf)
            if want_dtype is not None and arr.dtype != want_dtype:
                raise CheckpointDtypeError(
                    f"leaf {name!r}: checkpoint dtype {arr.dtype} != "
                    f"restore target dtype {want_dtype}")
            leaves[name] = (torch.from_numpy(arr).to(leaf.device)
                            if isinstance(leaf, torch.Tensor) else arr)
    return _unflatten(like, leaves)

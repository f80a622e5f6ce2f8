"""Sharded numpy checkpoints: npz per host shard + an atomic JSON manifest.

Layout of one checkpoint::

    <dir>/step_000123/
        shard_00000.npz          # this host's arrays (name -> array)
        MANIFEST.json            # written LAST, atomically (tmp+rename):
                                 # a checkpoint without a manifest is invalid

The layout, shard names and manifest are the reference package's
(``repro.checkpoint.store``), so either package reads what the other
wrote.  Crash-consistency: the manifest rename is the commit point; a
job killed mid-write leaves a step directory without MANIFEST.json,
which restore ignores and ``gc_incomplete`` removes.  Durability: every
save fsyncs the tmp file before its rename, then the step directory and
its parent after the manifest rename.

Two paths share the layout: the flat name->array path that the
coherence engine's snapshots use (``save_arrays``, ``load_arrays``;
``ft.coherence``), and the tree path of the trainer
(``save_checkpoint``, ``restore_checkpoint``), which writes each leaf of
a nested dict/list tree of tensors under its path in the reference's
``jax.tree_util.keystr`` form (``['params']['blocks'][0]['wq']``), so a
tree the reference saved restores here and the other way round.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

_MANIFEST = "MANIFEST.json"
_STEP_RE = re.compile(r"^step_(\d{9})$")


def _fsync_dir(path: Path):
    """fsync a *directory*: renames inside it are only durable once the
    directory's own entry table reaches disk."""
    fd = os.open(path, getattr(os, "O_DIRECTORY", os.O_RDONLY))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_committed(d: Path, host_flat: Dict[str, np.ndarray],
                     manifest: dict, host: int):
    """The durable-commit protocol: fsync'd tmp-write + rename for the
    shard, fsync'd tmp-write + rename for the manifest (the commit
    point), then fsync the step dir (persists both renames) and its
    parent (persists the step dir's creation)."""
    shard = d / f"shard_{host:05d}.npz"
    tmp = d / f".shard_{host:05d}.tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **host_flat)
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(shard)
    mtmp = d / ".manifest.tmp"
    with open(mtmp, "w") as f:
        f.write(json.dumps(manifest, indent=1))
        f.flush()
        os.fsync(f.fileno())
    mtmp.rename(d / _MANIFEST)     # commit point
    _fsync_dir(d)                  # makes both renames durable
    _fsync_dir(d.parent)           # makes the step dir itself durable


def _step_dir(root: Path, step: int) -> Path:
    return Path(root) / f"step_{step:09d}"


def _step_dirs(root: Path):
    """(step, path) for every conforming ``step_NNNNNNNNN`` directory;
    stray entries are ignored."""
    out = []
    for p in Path(root).glob("step_*"):
        m = _STEP_RE.match(p.name)
        if m and p.is_dir():
            out.append((int(m.group(1)), p))
    return out


def _host_leaves(tree) -> Dict[str, np.ndarray]:
    """The tree's leaves on the host, by path (a copy, taken now)."""
    return {k: (v.detach().cpu().numpy().copy() if torch.is_tensor(v)
                else np.array(v)) for k, v in tree_flatten(tree)}


def save_checkpoint(root, step: int, tree, *, blocking: bool = True,
                    extra: Optional[dict] = None, host: int = 0
                    ) -> "threading.Thread | None":
    """Copy ``tree``'s leaves to the host now; write the shard and the
    manifest now, or on a background thread when ``blocking=False`` (the
    thread is returned)."""
    d = _step_dir(Path(root), step)
    d.mkdir(parents=True, exist_ok=True)
    host_flat = _host_leaves(tree)
    spec = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in host_flat.items()}

    def _write():
        manifest = {"step": step, "time": time.time(), "n_hosts": 1,
                    "leaves": spec, "extra": extra or {}}
        _write_committed(d, host_flat, manifest, host)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def restore_checkpoint(root, step: int, template) -> Any:
    """Step ``step``'s arrays in ``template``'s structure: each leaf read
    by its path, checked against the template leaf's shape, and cast to
    its dtype on its device."""
    data, _ = load_arrays(root, step)
    out = []
    for key, tmpl in tree_flatten(template):
        if key not in data:
            raise ValueError(f"checkpoint step {step} has no leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(tmpl.shape)}")
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=tmpl.device, dtype=tmpl.dtype))
    return tree_unflatten(template, out)


def restore_extra(root, step: int) -> dict:
    d = _step_dir(Path(root), step)
    return json.loads((d / _MANIFEST).read_text())["extra"]


def latest_step(root) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [s for s, p in _step_dirs(root) if (p / _MANIFEST).exists()]
    return max(steps) if steps else None


def save_arrays(root, step: int, arrays: Dict[str, np.ndarray], *,
                extra: Optional[dict] = None, host: int = 0):
    """Save a flat name->ndarray dict (e.g. ``RegCScaleRuntime.snapshot()``
    arrays) with JSON-serializable ``extra`` meta, as step ``step`` under
    ``root``."""
    d = _step_dir(Path(root), step)
    d.mkdir(parents=True, exist_ok=True)
    host_flat = {k: np.asarray(v) for k, v in arrays.items()}
    spec = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in host_flat.items()}
    manifest = {"step": step, "time": time.time(), "n_hosts": 1,
                "leaves": spec, "extra": extra or {}}
    _write_committed(d, host_flat, manifest, host)


def load_arrays(root, step: int) -> "tuple[Dict[str, np.ndarray], dict]":
    """Load a :func:`save_arrays` checkpoint: (arrays, extra)."""
    d = _step_dir(Path(root), step)
    manifest = json.loads((d / _MANIFEST).read_text())
    data: Dict[str, np.ndarray] = {}
    for shard in sorted(d.glob("shard_*.npz")):
        with np.load(shard) as z:
            data.update({k: z[k] for k in z.files})
    missing = set(manifest["leaves"]) - set(data)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    return data, manifest["extra"]


def gc_incomplete(root):
    """Remove step dirs that never committed a manifest (crash debris).
    Only conforming ``step_NNNNNNNNN`` directories are candidates."""
    root = Path(root)
    if not root.exists():
        return
    for _s, p in _step_dirs(root):
        if not (p / _MANIFEST).exists():
            shutil.rmtree(p)


class CheckpointManager:
    """Keep-last-k rotation + async writes with at most one in flight."""

    def __init__(self, root, *, keep: int = 3, async_write: bool = True):
        self.root = Path(root)
        self.keep = keep
        self.async_write = async_write
        self._inflight: Optional[threading.Thread] = None
        gc_incomplete(self.root)

    def save(self, step: int, tree, *, extra: Optional[dict] = None):
        """``save_checkpoint`` of a tree with the manager's rotation and
        its at-most-one-in-flight async discipline; the leaves are copied
        to the host before this returns."""
        self.wait()
        self._inflight = save_checkpoint(
            self.root, step, tree, blocking=not self.async_write, extra=extra)
        self._rotate(pending=step)

    def restore(self, step: int, template):
        self.wait()
        return restore_checkpoint(self.root, step, template)

    def save_arrays(self, step: int, arrays: Dict[str, np.ndarray], *,
                    extra: Optional[dict] = None):
        """Module-level :func:`save_arrays` with the manager's rotation and
        its at-most-one-in-flight async discipline.  The arrays are copied
        now, so the caller may go on mutating its state."""
        self.wait()
        snap = {k: np.asarray(v).copy() for k, v in arrays.items()}
        if self.async_write:
            t = threading.Thread(target=save_arrays,
                                 args=(self.root, step, snap),
                                 kwargs={"extra": extra}, daemon=True)
            t.start()
            self._inflight = t
        else:
            save_arrays(self.root, step, snap, extra=extra)
        self._rotate(pending=step)

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _rotate(self, pending: Optional[int] = None):
        steps = sorted(s for s, p in _step_dirs(self.root)
                       if (p / _MANIFEST).exists())
        if pending is not None and pending not in steps:
            steps = sorted(steps + [pending])   # in-flight counts toward keep
        for s in steps[: max(0, len(steps) - self.keep)]:
            if s != pending:
                shutil.rmtree(_step_dir(self.root, s))

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.root)

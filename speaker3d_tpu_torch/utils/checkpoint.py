"""Checkpointer with the JAX trainer's directory layout.

The counterpart of ``speaker3d_tpu/utils/checkpoint.py``: one directory
``CKPT-EPOCH-{N}-00/`` per checkpoint, holding a ``CKPT.yaml`` (unixtime,
epoch) and one ``<name>.ckpt`` per recoverable; recovery takes the latest by
unixtime, or a given epoch. A recoverable is a nested dict of arrays, saved
as an .npz keyed by '/'-joined paths (``save_pytree``; numpy, no flax), or
an object with ``save(path)`` / ``load(path)`` (``EpochCounter``).
``EpochLogger`` appends the ``train_epoch.log`` lines.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import yaml

CKPT_PREFIX = "CKPT"
META_FNAME = f"{CKPT_PREFIX}.yaml"


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + "/")
        else:
            yield key, v


def save_pytree(path: str, tree: Dict) -> None:
    """A nested dict of arrays -> an .npz keyed by '/'-joined paths (through
    a file handle, so numpy adds no second extension)."""
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in _flatten(tree)})


def load_pytree(path: str) -> Dict:
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return out


class EpochCounter:
    """Resumable epoch iterator."""

    def __init__(self, limit: int):
        self.current = 0
        self.limit = limit

    def __iter__(self):
        return self

    def __next__(self):
        if self.current < self.limit:
            self.current += 1
            return self.current
        raise StopIteration

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(str(self.current))

    def load(self, path: str):
        with open(path) as f:
            self.current = int(f.read().strip())


class Checkpointer:
    def __init__(self, checkpoints_dir: str,
                 recoverables: Optional[Dict[str, Any]] = None):
        self.checkpoints_dir = checkpoints_dir
        os.makedirs(checkpoints_dir, exist_ok=True)
        self.recoverables: Dict[str, Any] = dict(recoverables or {})

    def add_recoverable(self, name: str, obj: Any):
        self.recoverables[name] = obj

    def _ckpt_dir(self, epoch: int) -> str:
        return os.path.join(self.checkpoints_dir,
                            f"{CKPT_PREFIX}-EPOCH-{epoch}-00")

    def list_checkpoints(self):
        out = []
        for name in sorted(os.listdir(self.checkpoints_dir)):
            d = os.path.join(self.checkpoints_dir, name)
            meta_path = os.path.join(d, META_FNAME)
            if os.path.isdir(d) and os.path.isfile(meta_path):
                with open(meta_path) as f:
                    meta = yaml.safe_load(f)
                out.append((d, meta))
        return out

    def save_checkpoint(self, epoch: int, states: Optional[Dict[str, Any]] = None):
        """``states``: name -> nested dict of arrays; recoverables with
        ``save()`` save themselves."""
        d = self._ckpt_dir(epoch)
        os.makedirs(d, exist_ok=True)
        for name, tree in (states or {}).items():
            save_pytree(os.path.join(d, f"{name}.ckpt"), tree)
        for name, obj in self.recoverables.items():
            if hasattr(obj, "save"):
                obj.save(os.path.join(d, f"{name}.ckpt"))
        with open(os.path.join(d, META_FNAME), "w") as f:
            yaml.safe_dump({"unixtime": time.time(), "epoch": epoch}, f)
        return d

    def find_checkpoint(self, epoch: Optional[int] = None):
        ckpts = self.list_checkpoints()
        if not ckpts:
            return None
        if epoch is not None:
            for d, meta in ckpts:
                if meta.get("epoch") == epoch:
                    return d, meta
            return None
        return max(ckpts, key=lambda it: it[1].get("unixtime", 0))

    def recover_if_possible(self, epoch: Optional[int] = None):
        """{name: nested dict} of the saved array states, plus
        ``'__meta__'`` (objects with ``load()`` are restored in place), or
        None when there is no checkpoint."""
        found = self.find_checkpoint(epoch)
        if found is None:
            return None
        d, meta = found
        states = {}
        for fname in os.listdir(d):
            if not fname.endswith(".ckpt"):
                continue
            name = fname[:-len(".ckpt")]
            fpath = os.path.join(d, fname)
            obj = self.recoverables.get(name)
            if obj is not None and hasattr(obj, "load"):
                obj.load(fpath)
            else:
                with open(fpath, "rb") as f:
                    is_zip = f.read(2) == b"PK"
                if is_zip:  # an npz tree; anything else belongs to an
                    states[name] = load_pytree(fpath)  # unregistered object
        states["__meta__"] = meta
        return states


class EpochLogger:
    """Append stats lines to ``train_epoch.log``."""

    def __init__(self, save_file: str):
        self.save_file = save_file
        os.makedirs(os.path.dirname(save_file) or ".", exist_ok=True)

    def log_stats(self, stats_meta: Dict[str, Any],
                  stats: Optional[Dict[str, Any]] = None):
        parts = [f"{k}: {v}" for k, v in stats_meta.items()]
        if stats:
            parts += [f"{k}: {v}" for k, v in stats.items()]
        line = " - ".join(parts)
        with open(self.save_file, "a") as f:
            f.write(line + "\n")
        return line

"""Fault-tolerant checkpointing (``repro/training/checkpoint.py`` without
``jax.tree_util``).

The on-disk layout is the JAX package's, so either package restores the
other's snapshots:

* atomic two-phase commit: write shards to ``step_N.tmp/`` -> fsync ->
  atomic rename to ``step_N/`` -> update ``LATEST`` atomically; a crash
  mid-write never corrupts the restore point, and a ``LATEST`` naming a
  step that is gone falls back to the newest complete one;
* one ``.npy`` file per leaf, named by its flattened tree path (``a/b``
  -> ``a__b.npy``), plus ``meta.json`` (step, extra, keys); a ``DTensor``
  leaf is saved whole (its global array, as JAX saves a sharded array);
* async mode: serialization runs on a background thread (the
  device->host copy happens at ``save()``; disk I/O overlaps what
  follows), one save in flight at a time;
* keep-last-K garbage collection.

A tree is nested dicts (keys sorted, as ``jax.tree_util`` orders them),
lists and tuples (keyed by index) of numpy arrays, tensors or scalars;
``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor


def _paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs in ``jax.tree_util``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):           # the global array, as JAX's
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _unflatten(template, load, prefix: tuple = ()):
    """``template``'s structure with each leaf replaced by
    ``load(key, leaf)``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, load, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, load, prefix + (str(i),))
               for i, v in enumerate(template)]
        if hasattr(template, "_fields"):        # a NamedTuple
            return type(template)(*out)
        return type(template)(out)
    return load("/".join(prefix), template)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Snapshot `tree` at `step`. In async mode the device->host copy
        happens now; disk I/O runs on a background thread."""
        host = _flatten(tree)               # device->host, blocking
        meta = {"step": step, "extra": extra or {},
                "keys": sorted(host.keys())}
        if self.async_save:
            self.wait()                     # double buffer: one in flight
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def _write(self, step: int, host: dict, meta: dict):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for key, arr in host.items():
            fname = key.replace("/", "__") + ".npy"
            with open(tmp / fname, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic commit
        # update LATEST atomically
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.rename(latest_tmp, self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            steps = self.steps()
            return max(steps) if steps else None
        step = int(f.read_text())
        # tolerate a crash between rename and LATEST update
        if not (self.dir / f"step_{step}").exists():
            steps = self.steps()
            return max(steps) if steps else None
        return step

    # ------------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of `template`: numpy arrays, or
        tensors on the template leaf's device where the leaf is a
        tensor.  ``shardings``, a tree of the template's structure with
        :class:`repro_torch.sharding.NamedSharding` leaves (None for a
        leaf to leave whole), re-shards onto its mesh (an elastic restart
        onto another mesh, JAX's ``device_put``): each such leaf comes
        back a ``DTensor`` of the saved global shape, every rank slicing
        its own shard from the file it reads (no communication)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        shard_of = dict(_paths(shardings))

        def load(key, leaf):
            arr = np.load(d / (key.replace("/", "__") + ".npy"))
            sharding = shard_of.get(key)
            if sharding is not None:
                full = torch.from_numpy(arr).to(sharding.mesh.device_type)
                return distribute_tensor(full, sharding.mesh,
                                         sharding.placements,
                                         src_data_rank=None)
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(arr).to(leaf.device)
            return arr
        return _unflatten(template, load), meta

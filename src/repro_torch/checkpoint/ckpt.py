"""Checkpoints of the port: atomic commit, async save, bounded
retention, and restore onto any device.

The counterpart of `repro.checkpoint.ckpt`, with its layout:
<dir>/step_<N:08d>/ holds arrays.npz (leaf path -> array) and
manifest.json (step, tree structure, keys, shapes, dtypes, user
metadata). A tree is a nested dict / list / tuple of tensors or arrays
(the train state {"params": masters, "opt": state}); its leaves are
named by `runtime.buckets.leaves_with_path`, the reference's `keystr`
of the same containers. Writes go to a temporary directory first and
are `os.replace`d into place, so a crash mid-save never corrupts the
latest checkpoint. numpy has no bf16: a bf16 leaf is stored as its
16-bit pattern (int16) with "bfloat16" in the manifest's dtypes, and
restored bit for bit.

Elastic restore: `restore(..., device=)` places every leaf on the
device given (the one-card counterpart of the reference's
`mesh=`/`specs=`; a checkpoint written on the card restores on the CPU
and back). The sharded restore comes with the sharded pool (ROADMAP
queue A item 8).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.runtime.buckets import leaves_with_path

BF16 = "bfloat16"


def _array(leaf):
    """(numpy array as stored, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _structure(tree):
    """The containers of `tree` with "*" for each leaf (the manifest's
    treedef)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {str(k): _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return "*"


def save(directory: str, step: int, tree: Any, *,
         metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        arrays, dtypes = {}, {}
        for path, leaf in leaves_with_path(tree):
            arrays[path], dtypes[path] = _array(leaf)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "treedef": json.dumps(_structure(tree)),
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": dtypes,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)   # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _rebuild(tree, path, fetch):
    """`tree`'s containers with each leaf replaced by fetch(its path)."""
    if tree is None:
        return None
    if isinstance(tree, OrderedDict):
        return OrderedDict((k, _rebuild(v, f"{path}[{k!r}]", fetch))
                           for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{path}[{k!r}]", fetch)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{path}[{i}]", fetch)
                          for i, v in enumerate(tree))
    return fetch(path)


def restore(directory: str, step: int, tree_like: Any, *,
            device="cpu") -> Any:
    """Restore into the structure of `tree_like`, every leaf a tensor on
    `device` with the dtype it was saved in (the elastic path)."""
    path = os.path.join(directory, f"step_{step:08d}")
    dtypes = read_metadata(directory, step)["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def fetch(key):
        t = torch.from_numpy(arrays[key])
        if dtypes[key] == BF16:
            t = t.view(torch.bfloat16)
        return t.to(device)

    return _rebuild(tree_like, "", fetch)


def read_metadata(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as fh:
        return json.load(fh)


def snapshot(tree: Any) -> Any:
    """A host copy of every tensor leaf of `tree` (the optimizer updates
    the train state in place, so a save must not read it later)."""
    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return np.array(leaf)

    leaves = dict(leaves_with_path(tree))
    return _rebuild(tree, "", lambda p: copy(leaves[p]))


class CheckpointManager:
    """Periodic + async checkpointing with bounded retention."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any, *, metadata=None,
                   force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        host_tree = snapshot(tree)   # snapshot now
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc,
                args=(step, host_tree, metadata), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree, metadata)
        return True

    def _save_and_gc(self, step, tree, metadata):
        save(self.dir, step, tree, metadata=metadata)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()


__all__ = ["CheckpointManager", "latest_step", "read_metadata", "restore",
           "save", "snapshot"]

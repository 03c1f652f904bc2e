"""Gradient bucketizer: tensor-tree leaves -> size-bounded buckets
(= coflows). The port of `repro.runtime.buckets`.

The backward pass produces gradients in reverse-layer order; buckets
preserve that order (bucket 0 = deepest layers = ready first), which
becomes the coflow 'arrival rank' fed to the Saath coordinator.

A tree is a nested dict / list / tuple of tensors (or arrays, or
scalars), e.g. a module's `state_dict()`. Its leaves are visited in the
order `jax.tree_util.tree_leaves_with_path` visits the same nested
containers, and each is named by the string `jax.tree_util.keystr`
gives its path, so bucket ids, paths and bytes are the reference's:

* a plain dict's keys in sorted order, an `OrderedDict`'s (a
  `state_dict()`) in insertion order; a key `k` writes ``[repr(k)]``,
  e.g. ``['layer0']['weight']``;
* a list's or tuple's items in order, index ``i`` writing ``[i]``;
* None holds no leaf; anything else is a leaf.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Bucket:
    bid: int
    paths: tuple          # leaf key-paths (the reference's keystr)
    leaf_idx: tuple       # flat leaf indices
    bytes: int


def leaves_with_path(tree: Any, path: str = "") -> List[tuple]:
    """(path string, leaf) pairs in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, collections.OrderedDict):
        keys = list(tree)
    elif isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree)
                for kv in leaves_with_path(sub, f"{path}[{i}]")]
    else:
        return [(path, tree)]
    return [kv for k in keys
            for kv in leaves_with_path(tree[k], f"{path}[{k!r}]")]


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):          # a torch tensor
        return int(leaf.numel()) * int(leaf.element_size())
    if hasattr(leaf, "shape"):
        return int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    return 8


def bucketize(tree: Any, bucket_bytes: int = 64 * 1024 * 1024,
              reverse: bool = True) -> List[Bucket]:
    """Greedy fill in (reversed) leaf order; a leaf larger than
    bucket_bytes gets its own bucket."""
    items = [(path, idx, _nbytes(leaf))
             for idx, (path, leaf) in enumerate(leaves_with_path(tree))]
    if reverse:
        items = items[::-1]

    buckets: List[Bucket] = []
    cur_p, cur_i, cur_b = [], [], 0
    for path, idx, sz in items:
        if cur_b > 0 and cur_b + sz > bucket_bytes:
            buckets.append(Bucket(len(buckets), tuple(cur_p), tuple(cur_i),
                                  cur_b))
            cur_p, cur_i, cur_b = [], [], 0
        cur_p.append(path)
        cur_i.append(idx)
        cur_b += sz
    if cur_b:
        buckets.append(Bucket(len(buckets), tuple(cur_p), tuple(cur_i),
                              cur_b))
    return buckets


__all__ = ["Bucket", "bucketize", "leaves_with_path"]

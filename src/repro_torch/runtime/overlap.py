"""Wave-ordered collective issue (the all-or-none issue engine). The
port of `repro.runtime.overlap`.

The reference chains its waves inside one jitted program with
`optimization_barrier`, so that XLA cannot reorder them. The port is
eager: each wave's collectives are issued asynchronously on the
caller's process group (`torch.distributed`, any backend: gloo on the
CPU, NCCL on the card), and every handle of a wave is waited on before
the next wave is issued. Collectives *within* a wave (disjoint
resources per the planner) stay free to overlap with each other.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist


def issue_waves(tensors: Dict[str, torch.Tensor],
                waves: Sequence[Sequence[str]],
                op: Callable[[str, torch.Tensor], tuple]):
    """Apply `op(name, x)` (a collective) to each named tensor, wave by
    wave. `op` issues the collective and returns `(result, handle)`,
    where `handle` has a `wait()` (a `torch.distributed` work object) or
    is None for a collective already complete; a wave's handles are all
    waited on before the next wave is issued. Returns dict of
    results."""
    out: Dict[str, torch.Tensor] = {}
    for wave in waves:
        pending = []
        for n in wave:
            out[n], handle = op(n, tensors[n])
            if handle is not None:
                pending.append(handle)
        for handle in pending:
            handle.wait()
    return out


def scheduled_psum(grads_flat: List[torch.Tensor], buckets, waves,
                   group=None):
    """Per-bucket all-reduce (sum) of flattened gradients over `group`
    (None = the default process group), issued in Saath wave order.
    grads_flat: flat leaf list (same order bucketize saw). Returns the
    reduced flat list; the inputs are not modified."""
    name_to_bucket = {f"grad/{b.bid}": b for b in buckets}
    packed = {
        f"grad/{b.bid}": torch.cat(
            [grads_flat[i].reshape(-1) for i in b.leaf_idx])
        for b in buckets
    }

    def op(name, x):
        return x, dist.all_reduce(x, group=group, async_op=True)

    reduced = issue_waves(packed, waves, op)

    out = list(grads_flat)
    for name, vec in reduced.items():
        b = name_to_bucket[name]
        off = 0
        for i in b.leaf_idx:
            n = grads_flat[i].numel()
            out[i] = vec[off:off + n].reshape(grads_flat[i].shape)
            off += n
    return out


__all__ = ["issue_waves", "scheduled_psum"]

"""Entry points of the port's kernels, dispatched by tensor device.

The counterpart of `repro.kernels.ops`: a CUDA tensor launches the
hand-written kernel (or raises: nothing falls back to the plain
version), a CPU tensor takes the plain PyTorch version in `ref.py`.
``force="ref"`` runs the plain version on any device; it exists so that
`chip_smoke.py` can hold each kernel against its plain version on the
card. Each kernel module keeps a launch counter (`launch_counts`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import contention as _contention
from repro_torch.kernels import walk as _walk
from repro_torch.kernels.ref import (WalkFlows, contention_ref,
                                     tick_walk_ref)


def _use_kernel(t: torch.Tensor, force: Optional[str]) -> bool:
    if force is None:
        return t.is_cuda
    if force == "ref":
        return False
    raise ValueError(f"unknown force {force!r}; available: None, 'ref'")


def contention(a_send, a_recv, active, *, force: Optional[str] = None):
    """(B, C, P) incidence x2 + (B, C) active -> (B, C) int32 k_c."""
    if _use_kernel(a_send, force):
        return _contention.contention_cuda(a_send, a_recv, active)
    return contention_ref(a_send, a_recv, active)


def tick_walk(order, n_live, cnt, avail0, min_rate, wc,
              flows: Optional[WalkFlows] = None, *,
              force: Optional[str] = None):
    """Admission + work-conservation walk -> (rate, admitted, wc_rate,
    wc_flow); see `ref.tick_walk_ref` for the contract."""
    if _use_kernel(cnt, force):
        return _walk.tick_walk_cuda(order, n_live, cnt, avail0, min_rate,
                                    wc, flows)
    return tick_walk_ref(order, n_live, cnt, avail0, min_rate, wc, flows)


def launch_counts() -> dict:
    """Kernel launches since the last `reset_launches`, by kernel."""
    return {"contention": _contention.launches,
            "tick_walk": _walk.launches}


def reset_launches() -> None:
    _contention.launches = 0
    _walk.launches = 0


__all__ = ["contention", "tick_walk", "WalkFlows", "launch_counts",
           "reset_launches"]

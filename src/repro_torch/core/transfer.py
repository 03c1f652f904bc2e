"""Counted host<->device copies of the event-driven host plane.

The host plane (`fabric.simulator`, `core.policies`) keeps its
bookkeeping in host numpy f64 and sends the card only what a kernel
computes: the contention count (`core.contention`, K1) and, for
`saath-torch`, the whole coordinator tick. Every such copy goes through
`upload` / `download`, which count the bytes that cross to or from a
CUDA device (a copy that stays on the CPU counts nothing), so that a
replay can report its traffic (`fabric.simulator.SimResult`).
"""
from __future__ import annotations

import numpy as np
import torch

io = {"h2d_bytes": 0, "d2h_bytes": 0, "h2d_copies": 0, "d2h_copies": 0}


def upload(a, device, dtype=None) -> torch.Tensor:
    """A host array (or tensor) on `device`, as `dtype` when given."""
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a)
    if dtype is not None:
        t = t.to(dtype)
    dev = torch.device(device)
    if dev.type != "cpu":
        io["h2d_bytes"] += t.numel() * t.element_size()
        io["h2d_copies"] += 1
    return t.to(dev)


def download(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array."""
    if t.device.type != "cpu":
        io["d2h_bytes"] += t.numel() * t.element_size()
        io["d2h_copies"] += 1
    return t.cpu().numpy()


def counts() -> dict:
    return dict(io)


__all__ = ["upload", "download", "counts", "io"]

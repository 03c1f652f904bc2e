"""Coflow contention k_c for the event-driven host plane, on the card.

The port of `repro.core.contention` (a numpy f32 sgemm there): k_c is
the number of OTHER active coflows that share at least one sender or
receiver port with coflow c — how many coflows scheduling c would block
(§2.4, §3 idea 3). `Saath` (its LCoF order) and `LWTF` (its t_c * k_c
key) call it once per schedule. It sends the active rows of the (C, P)
bool incidence to `device` as (1, C_act, P) — an inactive row counts
nowhere, and its k_c is 0 — runs `kernels.ops.contention` (kernel K1 on
a CUDA device, `ref.contention_ref` on the CPU) and brings the (C,)
int32 counts back. The counts are exact integers on both, so the host
plane's results do not move.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transfer import download, upload
from repro_torch.kernels import ops
from repro_torch.kernels.contention import MAX_PORTS


def contention(A_send: np.ndarray, A_recv: np.ndarray, active: np.ndarray,
               *, device) -> np.ndarray:
    """A_send/A_recv: (C, P) bool incidence. active: (C,) bool.

    Returns (C,) int32; inactive coflows get 0. Raises for P > MAX_PORTS
    (K1's limit) on every device, so a CPU run refuses what the card
    would."""
    C, P = A_send.shape
    if P > MAX_PORTS:
        raise ValueError(f"contention_cuda supports P <= {MAX_PORTS}")
    out = np.zeros(C, np.int32)
    rows = np.flatnonzero(active)
    if rows.size == 0:
        return out
    a_s = upload(A_send[rows][None], device, torch.bool)
    a_r = upload(A_recv[rows][None], device, torch.bool)
    act = torch.ones((1, rows.size), dtype=torch.bool, device=a_s.device)
    out[rows] = download(ops.contention(a_s, a_r, act))[0]
    return out


__all__ = ["contention"]

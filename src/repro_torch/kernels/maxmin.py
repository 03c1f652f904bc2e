"""Max-min fair work-conservation rates as a hand-written CUDA kernel
for Hopper (kernel K3).

Replaces the Pallas kernel `repro/kernels/maxmin.py:maxmin_pallas`
(called by the leaf-spine tick at `repro/core/jax_coordinator.py:383`
under `LeafSpine(wc_fill="maxmin")`): bipartite max-min fair rates of
the work-conservation candidates by progressive filling. The Pallas
kernel runs dense (P, F) one-hot mat-vecs; the CUDA kernel
(`csrc/maxmin.cu`) takes each flow's row ids instead, one block per
lane, with the row state in shared memory, a compacted candidate list
(in a global scratch this wrapper allocates when a lane's candidates
outgrow shared memory) that each round shrinks to its survivors,
incremental counts, two barriers a round and an exact early exit. What
bounds it on the card, and why it is built with `-fmad=false`, is in
the source's head note.

`maxmin_cuda` launches it; `kernels.ops.maxmin_rates` dispatches to it
for CUDA tensors and to `ref.maxmin_ref` for CPU tensors. `launches`
counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import maxmin_rounds

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("maxmin")
        lib.saath_maxmin.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.saath_maxmin.restype = ctypes.c_int
        lib.saath_maxmin_scratch.argtypes = [ctypes.c_int] * 4
        lib.saath_maxmin_scratch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def maxmin_cuda(src: torch.Tensor, dst: torch.Tensor, cand: torch.Tensor,
                avail: torch.Tensor, *, up: Optional[torch.Tensor] = None,
                dn: Optional[torch.Tensor] = None,
                num_links: int = 0) -> torch.Tensor:
    """Same contract as `ref.maxmin_ref`, on one CUDA device: (B, F)
    int64 ports `src`/`dst` (and leaves `up`/`dn` in [0, Lf] when
    `num_links` = Lf > 0), (B, F) bool `cand`, (B, W) f32 row capacities
    with W = 2P + 2Lf -> (B, F) f32 rates."""
    global launches
    if avail.dim() != 2 or not avail.is_cuda:
        raise ValueError("maxmin_cuda needs a (B, W) CUDA tensor of row "
                         "capacities")
    B, W = avail.shape
    Lf = num_links
    P = W // 2 - Lf
    if W % 2 or P <= 0 or Lf < 0:
        raise ValueError(f"avail's {W} rows are not 2P + 2Lf with "
                         f"Lf = {Lf}")
    if Lf and (up is None or dn is None):
        raise ValueError("a leaf-spine fill needs the flows' up/dn links")
    dev = avail.device
    F = src.shape[-1]
    i64 = torch.int64
    keep = [build.checked(src, "src", (B, F), i64, dev),
            build.checked(dst, "dst", (B, F), i64, dev),
            build.checked(up, "up", (B, F), i64, dev) if Lf else None,
            build.checked(dn, "dn", (B, F), i64, dev) if Lf else None,
            build.checked(cand, "cand", (B, F), torch.bool, dev),
            build.checked(avail, "avail", (B, W), torch.float32, dev)]
    lib = _library()
    n_scratch = lib.saath_maxmin_scratch(B, P, Lf, F)
    if n_scratch < 0:
        raise ValueError(f"maxmin_cuda: the state of {W} rows exceeds one "
                         f"block's shared memory")
    # the candidate lists of a lane that outgrows shared memory
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev) \
        if n_scratch else None
    rates = torch.empty((B, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_maxmin(
            *(None if t is None else t.data_ptr() for t in keep),
            rates.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, F, P, Lf,
            maxmin_rounds(W), stream)
    if err:
        raise RuntimeError(f"max-min kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return rates


__all__ = ["maxmin_cuda"]

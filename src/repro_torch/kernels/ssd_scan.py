"""The Mamba-2 SSD chunked scan as a hand-written CUDA kernel for Hopper
(kernel K4).

Replaces the Pallas kernel `repro/kernels/ssd_scan.py:ssd_scan_pallas`,
the fast path of the chunked SSD scan that the prefill of every Mamba
layer runs (`repro/models/mamba.py:162`). One block per (batch, head)
loops over the chunks with the (Dh, N) f32 state in shared memory; what
bounds it on the card and how its design answers that are in the head
note of `csrc/ssd_scan.cu`.

`ssd_scan_cuda` launches it on inputs whose length is a multiple of the
chunk; `kernels.ops.ssd_scan` pads any length, dispatches CUDA tensors
here and CPU tensors to `ref.ssd_chunked_ref`. `launches` counts the
kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        lib.saath_ssd_scan.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.saath_ssd_scan.restype = ctypes.c_int
        _lib = lib
    return _lib


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *,
                  init_state: Optional[torch.Tensor] = None,
                  lc: int = 128):
    """The chunked SSD scan on one CUDA device: x (B, L, H, Dh), dt
    (B, L, H), b and c (B, L, G, N), all f32 or all bf16; a (H,) f32;
    init_state (B, H, Dh, N) f32 or None (zeros); L a multiple of `lc`.
    Returns (y (B, L, H, Dh) in x's dtype, final state (B, H, Dh, N)
    f32), the contract of `ref.ssd_chunked_ref`."""
    global launches
    if x.dim() != 4 or not x.is_cuda:
        raise ValueError("ssd_scan_cuda needs x as a (B, L, H, Dh) CUDA "
                         "tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan_cuda takes float32 or bfloat16, not "
                         f"{x.dtype}")
    B, L, H, Dh = x.shape
    if b.dim() != 4:
        raise ValueError("b and c must be (B, L, G, N)")
    G, N = b.shape[2], b.shape[3]
    if G == 0 or H % G or L % lc or B * H == 0:
        raise ValueError(f"ssd_scan_cuda: H = {H} must be a multiple of "
                         f"G = {G}, L = {L} of lc = {lc}, and B * H > 0")
    dev, dtype = x.device, x.dtype
    keep = [build.checked(x, "x", (B, L, H, Dh), dtype, dev),
            build.checked(dt, "dt", (B, L, H), dtype, dev),
            build.checked(a, "a", (H,), torch.float32, dev),
            build.checked(b, "b", (B, L, G, N), dtype, dev),
            build.checked(c, "c", (B, L, G, N), dtype, dev),
            None if init_state is None else build.checked(
                init_state, "init_state", (B, H, Dh, N), torch.float32,
                dev)]
    lib = _library()
    y = torch.empty((B, L, H, Dh), dtype=dtype, device=dev)
    sfin = torch.empty((B, H, Dh, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_ssd_scan(
            *(None if t is None else t.data_ptr() for t in keep),
            y.data_ptr(), sfin.data_ptr(), B, L, H, Dh, G, N, lc,
            int(dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"SSD scan kernel launch failed at (B, L, H, "
                           f"Dh, G, N, lc) = {(B, L, H, Dh, G, N, lc)}: "
                           f"CUDA error {err} (a shared-memory request "
                           f"above the block's limit is error 1)")
    launches += 1
    return y, sfin


__all__ = ["ssd_scan_cuda"]

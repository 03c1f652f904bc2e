"""The Mamba-2 SSD chunked scan as a hand-written CUDA kernel for Hopper
(kernel K4).

Replaces the Pallas kernel `repro/kernels/ssd_scan.py:ssd_scan_pallas`,
the fast path of the chunked SSD scan that the prefill of every Mamba
layer runs (`repro/models/mamba.py:162`). A first launch forms the
causal half of c b^T once per (batch, group, chunk) into an L2-resident
scratch; the scan then gives each block DT columns of one head's state
and y, carried across the chunks in shared memory, with every product a
register-tiled f32 product. What bounds it on the card and how its
design answers that are in the head note of `csrc/ssd_scan.cu`.

`ssd_scan_cuda` launches it (two CUDA launches, counted as one call in
`launches`) on any length: rows past L read as the reference's zero
padding. x, b and c are read through their batch and time-step strides,
so views whose heads and state columns are packed need no copy.
`kernels.ops.ssd_scan` dispatches CUDA tensors here and CPU tensors to
`ref.ssd_chunked_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_CHUNK = 128   # chunk rows a block holds in shared memory
MAX_STATE = 128   # state columns N

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        lib.saath_ssd_scan.argtypes = [ctypes.c_void_p] * 9 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
        lib.saath_ssd_scan.restype = ctypes.c_int
        lib.saath_ssd_scan_scratch.argtypes = [ctypes.c_int] * 4
        lib.saath_ssd_scan_scratch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _rows(t, name: str, shape, dtype, device):
    """`t` after `build.check`, kept as it is when its last two dims are
    packed (unit innermost stride, the next the innermost size), else
    copied to contiguous: the kernel takes the batch and time-step
    strides of the first two dims."""
    build.check(t, name, shape, dtype, device)
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        t = t.contiguous()
    return t


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *,
                  init_state: Optional[torch.Tensor] = None,
                  lc: int = 128):
    """The chunked SSD scan on one CUDA device: x (B, L, H, Dh), dt
    (B, L, H), b and c (B, L, G, N), all f32 or all bf16; a (H,) f32;
    init_state (B, H, Dh, N) f32 or None (zeros); any L, lc <= 128 and
    N <= 128. Returns (y (B, L, H, Dh) in x's dtype, final state
    (B, H, Dh, N) f32), the contract of `ref.ssd_chunked_ref`."""
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
    if G == 0 or H % G or B * H == 0 or not 1 <= lc <= MAX_CHUNK \
            or N > MAX_STATE:
        raise ValueError(f"ssd_scan_cuda: H = {H} must be a multiple of "
                         f"G = {G}, B * H > 0, 1 <= lc = {lc} <= "
                         f"{MAX_CHUNK} and N = {N} <= {MAX_STATE}")
    dev, dtype = x.device, x.dtype
    x = _rows(x, "x", (B, L, H, Dh), dtype, dev)
    b = _rows(b, "b", (B, L, G, N), dtype, dev)
    c = _rows(c, "c", (B, L, G, N), dtype, dev)
    dt = build.checked(dt, "dt", (B, L, H), dtype, dev)
    a = build.checked(a, "a", (H,), torch.float32, dev)
    s0 = None if init_state is None else build.checked(
        init_state, "init_state", (B, H, Dh, N), torch.float32, dev)
    lib = _library()
    gt = torch.empty(max(lib.saath_ssd_scan_scratch(B, L, G, lc), 1),
                     dtype=torch.float32, device=dev)
    y = torch.empty((B, L, H, Dh), dtype=dtype, device=dev)
    sfin = torch.empty((B, H, Dh, N), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), b.stride(0),
                                      b.stride(1), c.stride(0), c.stride(1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), gt.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sfin.data_ptr(), B, L, H, Dh, G, N, lc, strides,
            int(dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"SSD scan kernel launch failed at (B, L, H, "
                           f"Dh, G, N, lc) = {(B, L, H, Dh, G, N, lc)}: "
                           f"CUDA error {err}")
    launches += 1
    return y, sfin


__all__ = ["ssd_scan_cuda"]

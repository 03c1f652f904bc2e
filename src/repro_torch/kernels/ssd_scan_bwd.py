"""Backward of the Mamba-2 SSD chunked scan as a hand-written CUDA kernel
for Hopper (kernel K8).

The JAX package's train step differentiates the chunked scan
(`repro/models/mamba.py:18`, `ssd_chunked_jnp`) with `jax.value_and_grad`;
its Pallas forward (`repro/kernels/ssd_scan.py:73`), which K4 replaces,
has no backward. K8 is the port's counterpart of that derived gradient:
`models.mamba` wraps the prefill scan in an autograd function whose
forward is K4 and whose backward is this kernel on the card.

Given the forward's inputs x (B, L, H, Dh), dt (B, L, H), a (H,) f32, b
and c (B, L, G, N), with no initial state, and the gradient dy of y, it
returns (dx, ddt, da, db, dc): da in f32, the others in the inputs'
dtype, db and dc summed over the H / G heads of each group (the
contract of `ref.ssd_chunked_bwd_ref`). Four launches, counted as one
call (the head note of `csrc/ssd_scan_bwd.cu` has the design and its
bound): the chunk-start states, swept forward; their gradients, swept
in reverse; every chunk's local gradients, one block per (batch, chunk,
head), f32 products on the CUDA cores; the heads' sums of db and dc in
head order. No atomics: two calls give the same bits.

x, b, c and dy are read through their batch and time-step strides (a
view whose last two dims are packed needs no copy; the mixer's views of
its convolution output are such views). The workspaces (`workspace`:
the chunk states and their gradients, db and dc per head, da's
partials; 805 MB at Mamba2-1.3B's train shape) are allocated per call.
It raises for N or lc over 128, H no multiple of G, a dtype other than
f32 or bf16, a failed build or a failed launch (nothing falls back to
the plain version).

`ssd_scan_bwd_cuda` launches it; `kernels.ops.ssd_scan_bwd` dispatches
CUDA tensors here and CPU tensors to the plain version. `launches`
counts its calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import MAX_CHUNK, MAX_STATE, _rows

# the workspaces in the order the kernel carves them from one buffer
WORKSPACES = ("states", "state_grads", "db_heads", "dc_heads", "da_parts")
launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan_bwd")
        lib.saath_ssd_scan_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        lib.saath_ssd_scan_bwd.restype = ctypes.c_int
        lib.saath_ssd_scan_bwd_workspace.argtypes = \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.saath_ssd_scan_bwd_workspace.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def workspace(B: int, L: int, H: int, Dh: int, N: int, lc: int) -> dict:
    """{workspace: bytes} of one call at these sizes (all f32), as the
    kernel's library lays them out: the chunk states and their gradients
    (B, nch, H, Dh, N), db and dc per head (B, L, H, N), da's partials
    (B, nch, H)."""
    floats = (ctypes.c_longlong * len(WORKSPACES))()
    _library().saath_ssd_scan_bwd_workspace(B, L, H, Dh, N, lc, floats)
    return {k: 4 * n for k, n in zip(WORKSPACES, floats)}


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                      lc: int = 128):
    """(dx, ddt, da, db, dc) of `ref.ssd_chunked_ref`'s y at (x, dt, a, b,
    c), no initial state, for the output gradient `dy`, on one CUDA
    device: x and dy (B, L, H, Dh), dt (B, L, H), b and c (B, L, G, N),
    all f32 or all bf16; a (H,) f32; any L, lc <= 128, N <= 128. The
    gradients are contiguous, da f32, the others in x's dtype."""
    global launches
    if x.dim() != 4 or not x.is_cuda:
        raise ValueError("ssd_scan_bwd_cuda needs x as a (B, L, H, Dh) "
                         "CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan_bwd_cuda takes float32 or bfloat16, "
                         f"not {x.dtype}")
    B, L, H, Dh = x.shape
    if b.dim() != 4:
        raise ValueError("b and c must be (B, L, G, N)")
    G, N = b.shape[2], b.shape[3]
    if G == 0 or H % G or not 1 <= lc <= MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan_bwd_cuda: H = {H} must be a multiple "
                         f"of G = {G}, 1 <= lc = {lc} <= {MAX_CHUNK} and "
                         f"N = {N} <= {MAX_STATE}")
    dev, dtype = x.device, x.dtype
    x = _rows(x, "x", (B, L, H, Dh), dtype, dev)
    dy = _rows(dy, "dy", (B, L, H, Dh), dtype, dev)
    b = _rows(b, "b", (B, L, G, N), dtype, dev)
    c = _rows(c, "c", (B, L, G, N), dtype, dev)
    dt = build.checked(dt, "dt", (B, L, H), dtype, dev)
    a = build.checked(a, "a", (H,), torch.float32, dev)
    dx = torch.empty((B, L, H, Dh), dtype=dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=dtype, device=dev)
    db = torch.empty((B, L, G, N), dtype=dtype, device=dev)
    dc = torch.empty((B, L, G, N), dtype=dtype, device=dev)
    da = torch.zeros((H,), dtype=torch.float32, device=dev)
    if B * L * H == 0:
        return dx.zero_(), ddt.zero_(), da, db.zero_(), dc.zero_()
    lib = _library()
    work = torch.empty(lib.saath_ssd_scan_bwd_workspace(B, L, H, Dh, N, lc,
                                                        None),
                       dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 8)(x.stride(0), x.stride(1), b.stride(0),
                                      b.stride(1), c.stride(0), c.stride(1),
                                      dy.stride(0), dy.stride(1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da.data_ptr(), db.data_ptr(), dc.data_ptr(), work.data_ptr(),
            B, L, H, Dh, G, N, lc, strides, int(dtype == torch.bfloat16),
            stream)
    if err:
        raise RuntimeError(f"SSD scan backward launch failed at (B, L, H, "
                           f"Dh, G, N, lc) = {(B, L, H, Dh, G, N, lc)}: "
                           f"CUDA error {err}")
    launches += 1
    return dx, ddt, da, db, dc


__all__ = ["WORKSPACES", "ssd_scan_bwd_cuda", "workspace"]

"""LCoF contention k_c as a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel `repro/kernels/contention.py:
contention_pallas` (called on every coordinator tick at
`repro/core/jax_coordinator.py:259`). k_c = the number of other active
coflows that share at least one sender or receiver port with active
coflow c. The kernel (`csrc/contention.cu`) builds, for every port,
bitmasks over the lane's active coflows and ORs the masks of each
coflow's ports (port-major: far fewer word operations than counting
pairs), in one cooperative launch: exact integers, so no float
tolerance. What bounds it on the card and how its design answers that
are in the source's head note.

`contention_cuda` launches it; `kernels.ops.contention` dispatches to it
for CUDA tensors and to `ref.contention_ref` for CPU tensors. `launches`
counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_PORTS = 1024   # a row's port words fit one warp (<= 32 lanes)

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("contention")
        lib.saath_contention.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.saath_contention.restype = ctypes.c_int
        lib.saath_contention_scratch.argtypes = [ctypes.c_int] * 3
        lib.saath_contention_scratch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def contention_cuda(a_send: torch.Tensor, a_recv: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """(B, C, P) f32, bf16 or bool {0,1} incidence x2 + (B, C) bool
    active on one CUDA device -> (B, C) int32 contention counts."""
    global launches
    if a_send.dim() != 3 or a_send.shape != a_recv.shape:
        raise ValueError("a_send/a_recv must share one (B, C, P) shape")
    B, C, P = a_send.shape
    if active.shape != (B, C) or active.dtype != torch.bool:
        raise ValueError("active must be a (B, C) bool tensor")
    if a_send.dtype not in (torch.float32, torch.bfloat16, torch.bool) \
            or a_recv.dtype != a_send.dtype:
        raise ValueError("incidence must be float32, bfloat16 or bool")
    if not (a_send.is_cuda and a_recv.device == a_send.device
            and active.device == a_send.device):
        raise ValueError("contention_cuda needs all inputs on one CUDA "
                         "device")
    if P > MAX_PORTS:
        raise ValueError(f"contention_cuda supports P <= {MAX_PORTS}")
    a_send, a_recv = a_send.contiguous(), a_recv.contiguous()
    active = active.contiguous()
    lib = _library()
    scratch = torch.empty(max(lib.saath_contention_scratch(B, C, P), 1),
                          dtype=torch.int32, device=a_send.device)
    out = torch.empty((B, C), dtype=torch.int32, device=a_send.device)
    with torch.cuda.device(a_send.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_contention(a_send.data_ptr(), a_recv.data_ptr(),
                                   active.data_ptr(), scratch.data_ptr(),
                                   out.data_ptr(), B, C, P,
                                   a_send.element_size(), stream)
    if err:
        raise RuntimeError(f"contention kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


__all__ = ["contention_cuda", "MAX_PORTS"]

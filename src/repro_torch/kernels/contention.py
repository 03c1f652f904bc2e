"""LCoF contention k_c as a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel `repro/kernels/contention.py:
contention_pallas` (called on every coordinator tick at
`repro/core/jax_coordinator.py:259`). k_c = the number of other active
coflows that share at least one sender or receiver port with active
coflow c. The kernel (`csrc/contention.cu`) bit-packs each coflow's port
sets into 32-bit words and counts overlapping pairs with AND/OR over
the words: exact integers, so no float tolerance. What bounds it on the
card and how its design answers that are in the source's head note.

`contention_cuda` launches it; `kernels.ops.contention` dispatches to it
for CUDA tensors and to `ref.contention_ref` for CPU tensors. `launches`
counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_PORTS = 1024   # shared-memory tiles are sized for <= 32 words a set

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("contention").saath_contention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def contention_cuda(a_send: torch.Tensor, a_recv: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """(B, C, P) f32 or bf16 {0,1} incidence x2 + (B, C) bool active on
    one CUDA device -> (B, C) int32 contention counts."""
    global launches
    if a_send.dim() != 3 or a_send.shape != a_recv.shape:
        raise ValueError("a_send/a_recv must share one (B, C, P) shape")
    B, C, P = a_send.shape
    if active.shape != (B, C) or active.dtype != torch.bool:
        raise ValueError("active must be a (B, C) bool tensor")
    if a_send.dtype not in (torch.float32, torch.bfloat16) \
            or a_recv.dtype != a_send.dtype:
        raise ValueError("incidence must be float32 or bfloat16")
    if not (a_send.is_cuda and a_recv.device == a_send.device
            and active.device == a_send.device):
        raise ValueError("contention_cuda needs all inputs on one CUDA "
                         "device")
    if P > MAX_PORTS:
        raise ValueError(f"contention_cuda supports P <= {MAX_PORTS}")
    a_send, a_recv = a_send.contiguous(), a_recv.contiguous()
    active = active.contiguous()
    W = (P + 31) // 32
    words = torch.empty((B, C, 2 * W), dtype=torch.int32,
                        device=a_send.device)
    out = torch.empty((B, C), dtype=torch.int32, device=a_send.device)
    with torch.cuda.device(a_send.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(a_send.data_ptr(), a_recv.data_ptr(),
                        active.data_ptr(), words.data_ptr(),
                        out.data_ptr(), B, C, P, a_send.element_size(),
                        stream)
    if err:
        raise RuntimeError(f"contention kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


__all__ = ["contention_cuda", "MAX_PORTS"]

"""The coordinator tick's admission and work-conservation walk as one
hand-written CUDA kernel for Hopper.

It has no Pallas counterpart: `repro/core/jax_coordinator.py:tick_core`
left these loops to XLA as `while_loop`s (admission `:311-322`,
coflow-granular work conservation `:330-340`, per-flow greedy work
conservation `:387-407`). Eager PyTorch would need the trip counts on
the host every tick; the kernel (`csrc/walk.cu`) reads them from device
memory, one block per lane, so the tick loop never synchronizes. Its
head note says what bounds it and why it is built with `-fmad=false`.

`tick_walk_cuda` launches it; `kernels.ops.tick_walk` dispatches to it
for CUDA tensors and to `ref.tick_walk_ref` for CPU tensors. `launches`
counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import WalkFlows

MAX_PORTS = 4096   # 2P floats of residual capacity in shared memory

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("walk").saath_tick_walk
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def tick_walk_cuda(order: torch.Tensor, n_live: torch.Tensor,
                   cnt: torch.Tensor, avail0: torch.Tensor,
                   min_rate: torch.Tensor, wc: torch.Tensor,
                   flows: Optional[WalkFlows] = None):
    """Same contract as `ref.tick_walk_ref`, on one CUDA device. With
    `flows`, the flows of each coflow must be stored contiguously in
    [flow_lo, flow_hi) (the `traces.batch` layout): the kernel walks the
    missed coflows' segments instead of sorting the candidate flows."""
    global launches
    if cnt.dim() != 3 or cnt.shape[2] % 2:
        raise ValueError("cnt must be (B, C, 2P)")
    B, C, P2 = cnt.shape
    P = P2 // 2
    dev = cnt.device
    if not cnt.is_cuda:
        raise ValueError("tick_walk_cuda needs CUDA tensors")
    if P > MAX_PORTS:
        raise ValueError(f"tick_walk_cuda supports P <= {MAX_PORTS}")
    f32, i64 = torch.float32, torch.int64
    cnt = _check(cnt, "cnt", (B, C, P2), f32, dev)
    order = _check(order, "order", (B, C), i64, dev)
    n_live = _check(n_live, "n_live", (B,), i64, dev)
    avail0 = _check(avail0, "avail0", (B, P2), f32, dev)
    min_rate = _check(min_rate, "min_rate", (B,), f32, dev)
    wc = _check(wc, "wc", (B,), f32, dev)
    rate = torch.empty((B, C), dtype=f32, device=dev)
    admitted = torch.empty((B, C), dtype=torch.bool, device=dev)
    wc_rate = torch.empty((B, C), dtype=f32, device=dev)
    if flows is not None:
        F = flows.src.shape[1]
        lo = _check(flows.flow_lo, "flow_lo", (B, C), i64, dev)
        hi = _check(flows.flow_hi, "flow_hi", (B, C), i64, dev)
        src = _check(flows.src, "src", (B, F), i64, dev)
        dst = _check(flows.dst, "dst", (B, F), i64, dev)
        live = _check(flows.live, "live", (B, F), torch.bool, dev)
        wc_flow = torch.empty((B, F), dtype=f32, device=dev)
        fptr = [lo.data_ptr(), hi.data_ptr(), src.data_ptr(),
                dst.data_ptr(), live.data_ptr()]
        out_flow = wc_flow.data_ptr()
    else:
        F, wc_flow, fptr, out_flow = 0, None, [None] * 5, None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(order.data_ptr(), n_live.data_ptr(),
                        cnt.data_ptr(), avail0.data_ptr(),
                        min_rate.data_ptr(), wc.data_ptr(), *fptr,
                        rate.data_ptr(), admitted.data_ptr(),
                        wc_rate.data_ptr(), out_flow, B, C, P, F,
                        int(flows is not None), stream)
    if err:
        raise RuntimeError(f"tick walk kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return rate, admitted, wc_rate, wc_flow


__all__ = ["tick_walk_cuda", "MAX_PORTS"]

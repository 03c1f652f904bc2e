"""The coordinator tick's admission and work-conservation walk as one
hand-written CUDA kernel for Hopper.

It has no Pallas counterpart: `repro/core/jax_coordinator.py:tick_core`
left these loops to XLA as `while_loop`s (admission `:311-322`,
coflow-granular work conservation `:330-340`, per-flow greedy work
conservation `:387-434`, with the leaf-spine link caps). Eager PyTorch
would need the trip counts on the host every tick; the kernel
(`csrc/walk.cu`) reads them from device memory, one block per lane, so
the tick loop never synchronizes. It walks W = 2P + 2Lf capacity
columns (ports, then uplinks and downlinks; Lf = 0 on the big switch)
and in its admission-only mode stops after admission, for the max-min
fill (K3) to run on the capacity it leaves. Its head note says what
bounds it and why it is built with `-fmad=false`.

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

MAX_COLUMNS = 8192   # W floats of residual capacity in shared memory
MODE_COFLOW, MODE_FLOW, MODE_ADMIT = 0, 1, 2

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("walk").saath_tick_walk
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tick_walk_cuda(order: torch.Tensor, n_live: torch.Tensor,
                   cnt: torch.Tensor, avail0: torch.Tensor,
                   min_rate: torch.Tensor, wc: torch.Tensor,
                   flows: Optional[WalkFlows] = None, *,
                   num_links: int = 0, admit_only: bool = False):
    """Same contract as `ref.tick_walk_ref`, on one CUDA device. With
    `flows`, the flows of each coflow must be stored contiguously in
    [flow_lo, flow_hi) (the `traces.batch` layout): the kernel walks the
    missed coflows' segments instead of sorting the candidate flows."""
    global launches
    if cnt.dim() != 3:
        raise ValueError("cnt must be (B, C, W)")
    B, C, W = cnt.shape
    Lf = num_links
    P = W // 2 - Lf
    if W % 2 or P <= 0 or Lf < 0:
        raise ValueError(f"cnt's {W} columns are not 2P + 2Lf with "
                         f"Lf = {Lf}")
    dev = cnt.device
    if not cnt.is_cuda:
        raise ValueError("tick_walk_cuda needs CUDA tensors")
    if W > MAX_COLUMNS:
        raise ValueError(f"tick_walk_cuda supports W <= {MAX_COLUMNS}")
    f32, i64 = torch.float32, torch.int64
    cnt = build.checked(cnt, "cnt", (B, C, W), f32, dev)
    order = build.checked(order, "order", (B, C), i64, dev)
    n_live = build.checked(n_live, "n_live", (B,), i64, dev)
    avail0 = build.checked(avail0, "avail0", (B, W), f32, dev)
    min_rate = build.checked(min_rate, "min_rate", (B,), f32, dev)
    wc = build.checked(wc, "wc", (B,), f32, dev)
    rate = torch.empty((B, C), dtype=f32, device=dev)
    admitted = torch.empty((B, C), dtype=torch.bool, device=dev)
    wc_rate = torch.empty((B, C), dtype=f32, device=dev)
    avail = torch.empty((B, W), dtype=f32, device=dev)
    mode = MODE_ADMIT if admit_only else \
        MODE_COFLOW if flows is None else MODE_FLOW
    F, wc_flow, fptr, out_flow = 0, None, [None] * 7, None
    if mode == MODE_FLOW:
        if Lf and (flows.up is None or flows.dn is None):
            raise ValueError("a leaf-spine walk needs the flows' up/dn "
                             "links")
        F = flows.src.shape[1]
        keep = [build.checked(flows.flow_lo, "flow_lo", (B, C), i64, dev),
                build.checked(flows.flow_hi, "flow_hi", (B, C), i64, dev),
                build.checked(flows.src, "src", (B, F), i64, dev),
                build.checked(flows.dst, "dst", (B, F), i64, dev),
                build.checked(flows.live, "live", (B, F), torch.bool, dev)]
        if Lf:
            keep += [build.checked(flows.up, "up", (B, F), i64, dev),
                     build.checked(flows.dn, "dn", (B, F), i64, dev)]
        fptr = [t.data_ptr() for t in keep] + [None] * (7 - len(keep))
        wc_flow = torch.empty((B, F), dtype=f32, device=dev)
        out_flow = wc_flow.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(order.data_ptr(), n_live.data_ptr(),
                        cnt.data_ptr(), avail0.data_ptr(),
                        min_rate.data_ptr(), wc.data_ptr(), *fptr,
                        rate.data_ptr(), admitted.data_ptr(),
                        wc_rate.data_ptr(), out_flow, avail.data_ptr(),
                        B, C, P, Lf, F, mode, stream)
    if err:
        raise RuntimeError(f"tick walk kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return rate, admitted, wc_rate, wc_flow, avail


__all__ = ["tick_walk_cuda", "MAX_COLUMNS"]

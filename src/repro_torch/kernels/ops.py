"""Entry points of the port's kernels, dispatched by tensor device.

The counterpart of `repro.kernels.ops`: a CUDA tensor launches the
hand-written kernel (or raises: nothing falls back to the plain
version), a CPU tensor takes the plain PyTorch version in `ref.py`.
``force="ref"`` runs the plain version on any device; it exists so that
`chip_smoke.py` can hold each kernel against its plain version on the
card. Each kernel module keeps a launch counter (`launch_counts`); K6
also counts the rows it summed.

The kernels launch through `ctypes`, so autograd records nothing of
them: a CUDA call of `ssd_scan` or `flash_attention` with an input that
requires a gradient, while grad mode is on, raises instead of returning
an output with no gradient. Their gradients go through the autograd
functions `models.mamba.SSDScan` (backward `ssd_scan_bwd`, K8) and
`models.attention.FlashAttention` (backward `flash_attention_bwd`, K7),
whose forwards run with grad mode off.

Every entry point is a boundary an observer can see: while
`analysis.op_scan` scans a callable, each call here is one
`kernel:<name>` entry of its histogram (the CUDA kernels launch through
`ctypes`, where no dispatch mode sees them) and the scan is suspended
inside it, so the plain versions' ops are not counted either.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import contention as _contention
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import maxmin as _maxmin
from repro_torch.kernels import prefix_sum as _prefix
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssd_bwd
from repro_torch.kernels import walk as _walk
from repro_torch.kernels.ref import (WalkFlows, contention_ref,
                                     flash_attention_bwd_ref,
                                     flash_attention_ref, maxmin_ref,
                                     prefix_sum_ref, ssd_chunked_bwd_ref,
                                     ssd_chunked_ref, tick_walk_ref)


# objects with kernel_enter(name) / kernel_exit(name), called around
# every entry point below (one list read a call when none is set)
observers: list = []


def _boundary(name: str):
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not observers:
                return fn(*args, **kwargs)
            for o in observers:
                o.kernel_enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                for o in observers:
                    o.kernel_exit(name)
        return call
    return wrap


def _use_kernel(t: torch.Tensor, force: Optional[str]) -> bool:
    if force is None:
        return t.is_cuda
    if force == "ref":
        return False
    raise ValueError(f"unknown force {force!r}; available: None, 'ref'")


def _no_tape(name: str, via: str, *ts) -> None:
    """Raise where autograd would record a CUDA kernel call: the kernels
    launch through `ctypes`, so their outputs carry no `grad_fn` and
    every gradient through them would be silently lost. Inside an
    autograd function's forward grad mode is off and the call passes;
    `via` names the function that carries the gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(f"ops.{name} on CUDA records no gradient; an "
                           f"input requires one: call it through {via}")


@_boundary("contention")
def contention(a_send, a_recv, active, *, force: Optional[str] = None):
    """(B, C, P) f32, bf16 or bool incidence x2 + (B, C) active ->
    (B, C) int32 k_c."""
    if _use_kernel(a_send, force):
        return _contention.contention_cuda(a_send, a_recv, active)
    return contention_ref(a_send, a_recv, active)


@_boundary("tick_walk")
def tick_walk(order, n_live, cnt, avail0, min_rate, wc,
              flows: Optional[WalkFlows] = None, *, num_links: int = 0,
              admit_only: bool = False, force: Optional[str] = None):
    """Admission + work-conservation walk -> (rate, admitted, wc_rate,
    wc_flow, avail); see `ref.tick_walk_ref` for the contract."""
    if _use_kernel(cnt, force):
        return _walk.tick_walk_cuda(order, n_live, cnt, avail0, min_rate,
                                    wc, flows, num_links=num_links,
                                    admit_only=admit_only)
    return tick_walk_ref(order, n_live, cnt, avail0, min_rate, wc, flows,
                         num_links=num_links, admit_only=admit_only)


@_boundary("maxmin")
def maxmin_rates(src, dst, cand, avail, *, up=None, dn=None,
                 num_links: int = 0, force: Optional[str] = None):
    """Max-min fair rates of the candidate flows (B, F) over the W row
    capacities `avail` (B, W); see `ref.maxmin_ref` for the contract."""
    if _use_kernel(avail, force):
        return _maxmin.maxmin_cuda(src, dst, cand, avail, up=up, dn=dn,
                                   num_links=num_links)
    return maxmin_ref(src, dst, cand, avail, up=up, dn=dn,
                      num_links=num_links)


@_boundary("ssd_scan")
def ssd_scan(x, dt, a, b, c, *, init_state=None, lc: int = 128,
             force: Optional[str] = None):
    """Mamba-2 SSD chunked scan, any L: x (B, L, H, Dh), dt (B, L, H),
    a (H,), b and c (B, L, G, N), init_state (B, H, Dh, N) or None ->
    (y in x's dtype, final state f32); see `ref.ssd_chunked_ref`. On
    CUDA, K4 reads rows past the last chunk's end as zeros (the
    reference's padding) and takes x, b and c through their strides."""
    if not _use_kernel(x, force):
        return ssd_chunked_ref(x, dt, a, b, c, init_state=init_state,
                               lc=lc)
    _no_tape("ssd_scan", "models.mamba.scan", x, dt, a, b, c, init_state)
    return _ssd.ssd_scan_cuda(x, dt, a, b, c, init_state=init_state, lc=lc)


@_boundary("ssd_scan_bwd")
def ssd_scan_bwd(x, dt, a, b, c, dy, *, init_state=None, lc: int = 128,
                 force: Optional[str] = None):
    """The gradient of `ssd_scan`'s y at (x, dt, a, b, c) for the output
    gradient dy, with no initial state (a train step has none; one
    raises): (dx, ddt, da, db, dc), da in f32, the others in the inputs'
    dtype (see `ref.ssd_chunked_bwd_ref`); on CUDA the kernel K8, which
    takes x, b, c and dy through their strides."""
    if init_state is not None:
        raise ValueError("ssd_scan_bwd takes no initial state: a train "
                         "step's scan starts from zeros")
    if _use_kernel(x, force):
        return _ssd_bwd.ssd_scan_bwd_cuda(x, dt, a, b, c, dy, lc=lc)
    return ssd_chunked_bwd_ref(x, dt, a, b, c, dy, lc=lc)


@_boundary("flash_attention")
def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    force: Optional[str] = None):
    """Forward GQA attention: q (B, H, S, D), k (B, Hkv, T, D) and v
    (B, Hkv, T, Dv) -> o (B, H, S, Dv) in q's dtype; the causal mask is
    aligned top-left, query i at absolute position q_offset + i (>= 0).
    See `ref.flash_attention_ref` for the contract; on CUDA the kernel
    K5 (built for the (D, Dv) pairs of `flash_attention.WIDTHS`) reads
    strided views in place and lays o out like q."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, not {q_offset}")
    if _use_kernel(q, force):
        _no_tape("flash_attention", "models.attention.attend", q, k, v)
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           q_offset=q_offset)
    return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


@_boundary("flash_attention_bwd")
def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        q_offset: int = 0, force: Optional[str] = None):
    """The gradient of `flash_attention` at (q, k, v) for the output
    gradient do, given its output o: (dq, dk, dv) in the inputs' dtype
    (see `ref.flash_attention_bwd_ref`); on CUDA the kernel K7, built
    for the pairs of `flash_attention_bwd.WIDTHS`, each gradient laid out
    like its input."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, not {q_offset}")
    if _use_kernel(q, force):
        return _flash_bwd.flash_attention_bwd_cuda(q, k, v, o, do,
                                                   causal=causal,
                                                   q_offset=q_offset)
    return flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                   q_offset=q_offset)


@_boundary("prefix_sum")
def prefix_sum(x, *, force: Optional[str] = None):
    """(B, F) f32 -> (B, F + 1) f32: a zero column, then each row's
    inclusive prefix sums in the JAX package's scan order (see
    `ref.prefix_sum_ref`); the engine's segment sums gather from it,
    a step's independent sums stacked into the rows of one call."""
    if _use_kernel(x, force):
        return _prefix.prefix_sum_cuda(x)
    return prefix_sum_ref(x)


def launch_counts() -> dict:
    """Kernel launches since the last `reset_launches`, by kernel, and
    the rows K6 summed in its launches (`prefix_sum_rows`)."""
    return {"contention": _contention.launches,
            "tick_walk": _walk.launches,
            "maxmin": _maxmin.launches,
            "ssd_scan": _ssd.launches,
            "ssd_scan_bwd": _ssd_bwd.launches,
            "flash_attention": _flash.launches,
            "flash_attention_bwd": _flash_bwd.launches,
            "prefix_sum": _prefix.launches,
            "prefix_sum_rows": _prefix.rows}


def reset_launches() -> None:
    _contention.launches = 0
    _walk.launches = 0
    _maxmin.launches = 0
    _ssd.launches = 0
    _ssd_bwd.launches = 0
    _flash.launches = 0
    _flash_bwd.launches = 0
    _prefix.launches = 0
    _prefix.rows = 0


__all__ = ["contention", "tick_walk", "maxmin_rates", "ssd_scan",
           "ssd_scan_bwd", "flash_attention", "flash_attention_bwd",
           "prefix_sum", "WalkFlows", "launch_counts", "reset_launches"]

"""Entry points of the port's kernels, dispatched by tensor device.

The counterpart of `repro.kernels.ops`: a CUDA tensor launches the
hand-written kernel (or raises: nothing falls back to the plain
version), a CPU tensor takes the plain PyTorch version in `ref.py`.
``force="ref"`` runs the plain version on any device; it exists so that
`chip_smoke.py` can hold each kernel against its plain version on the
card. Each kernel module keeps a launch counter (`launch_counts`); K6
also counts the rows it summed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import contention as _contention
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import maxmin as _maxmin
from repro_torch.kernels import prefix_sum as _prefix
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import walk as _walk
from repro_torch.kernels.ref import (WalkFlows, contention_ref,
                                     flash_attention_ref, maxmin_ref,
                                     prefix_sum_ref, ssd_chunked_ref,
                                     tick_walk_ref)


def _use_kernel(t: torch.Tensor, force: Optional[str]) -> bool:
    if force is None:
        return t.is_cuda
    if force == "ref":
        return False
    raise ValueError(f"unknown force {force!r}; available: None, 'ref'")


def contention(a_send, a_recv, active, *, force: Optional[str] = None):
    """(B, C, P) f32, bf16 or bool incidence x2 + (B, C) active ->
    (B, C) int32 k_c."""
    if _use_kernel(a_send, force):
        return _contention.contention_cuda(a_send, a_recv, active)
    return contention_ref(a_send, a_recv, active)


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


def maxmin_rates(src, dst, cand, avail, *, up=None, dn=None,
                 num_links: int = 0, force: Optional[str] = None):
    """Max-min fair rates of the candidate flows (B, F) over the W row
    capacities `avail` (B, W); see `ref.maxmin_ref` for the contract."""
    if _use_kernel(avail, force):
        return _maxmin.maxmin_cuda(src, dst, cand, avail, up=up, dn=dn,
                                   num_links=num_links)
    return maxmin_ref(src, dst, cand, avail, up=up, dn=dn,
                      num_links=num_links)


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
    return _ssd.ssd_scan_cuda(x, dt, a, b, c, init_state=init_state, lc=lc)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    force: Optional[str] = None):
    """Forward GQA attention: q (B, H, S, D), k and v (B, Hkv, T, D) ->
    o (B, H, S, D) in q's dtype; the causal mask is aligned top-left,
    query i at absolute position q_offset + i (>= 0). See
    `ref.flash_attention_ref` for the contract; on CUDA the kernel K5
    reads strided views in place and lays o out like q."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, not {q_offset}")
    if _use_kernel(q, force):
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           q_offset=q_offset)
    return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


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
            "flash_attention": _flash.launches,
            "prefix_sum": _prefix.launches,
            "prefix_sum_rows": _prefix.rows}


def reset_launches() -> None:
    _contention.launches = 0
    _walk.launches = 0
    _maxmin.launches = 0
    _ssd.launches = 0
    _flash.launches = 0
    _prefix.launches = 0
    _prefix.rows = 0


__all__ = ["contention", "tick_walk", "maxmin_rates", "ssd_scan",
           "flash_attention", "prefix_sum", "WalkFlows", "launch_counts",
           "reset_launches"]

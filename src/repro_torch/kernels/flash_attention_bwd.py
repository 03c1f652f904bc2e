"""Backward of the GQA flash attention as a hand-written CUDA kernel for
Hopper (kernel K7).

The JAX package's train step differentiates `jnp_flash`
(`repro/models/attention.py:28`) with `jax.value_and_grad`; its Pallas
forward (`repro/kernels/flash_attention.py:77`), which K5 replaces, has
no backward. K7 is the port's counterpart of that derived gradient:
`models.attention` wraps the prefill attention in an autograd function
whose forward is K5 and whose backward is this kernel on the card.

Given the forward's inputs q (B, H, S, D), k (B, Hkv, T, D), v
(B, Hkv, T, Dv), its output o (B, H, S, Dv) and the output's gradient
do, it returns (dq, dk, dv) in q's dtype, dk and dv summed over the G =
H / Hkv query heads of each KV head. Three launches (the head note of
`csrc/flash_attention_bwd.cu` has the design): per query row the softmax
statistics and delta = rowsum(do o), recomputing the scores; dk and dv
per key tile; dq per query tile. No atomics: each output element has one
owner, so the gradients are the same from run to run. Products and sums
in f32 on the CUDA cores, for f32 and bf16 inputs alike; it is built for
the (D, Dv) pairs of `flash_attention.WIDTHS` and raises on any other,
on a failed build or a failed launch (nothing falls back to the plain
version, `ref.flash_attention_bwd_ref`).

`flash_attention_bwd_cuda` launches it; `kernels.ops.flash_attention_bwd`
dispatches CUDA tensors here and CPU tensors to the plain version.
`launches` counts its calls (three kernel launches each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import WIDTHS, _bhs_strides, _like

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention_bwd")
        lib.saath_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.saath_flash_attention_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(3) == 1 or t.shape[3] == 1 else t.contiguous()


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             q_offset: int = 0):
    """(dq, dk, dv) of `ref.flash_attention_ref` at (q, k, v) for the
    output gradient `do`, on one CUDA device: q (B, H, S, D), k
    (B, Hkv, T, D), v (B, Hkv, T, Dv), the forward's o and do
    (B, H, S, Dv), all f32 or all bf16, read in place through their
    strides (a tensor whose last axis is not contiguous is copied first);
    H a multiple of Hkv, (D, Dv) in `WIDTHS`, q_offset >= 0. Each
    gradient is laid out like its input (so a transposed view's gradient
    transposes back to a contiguous tensor)."""
    global launches
    if q.dim() != 4 or not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda needs q as a (B, H, S, "
                         "D) CUDA tensor")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bwd_cuda takes float32 or "
                         f"bfloat16, not {q.dtype}")
    B, H, S, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k and v must be (B, Hkv, T, D)")
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (D, Dv) not in WIDTHS or Hkv == 0 or H % Hkv or q_offset < 0:
        raise ValueError(f"flash_attention_bwd_cuda: (D = {D}, Dv = {Dv}) "
                         f"must be one of {WIDTHS}, H = {H} a multiple of "
                         f"Hkv = {Hkv}, q_offset = {q_offset} >= 0")
    for t, name, shape in ((k, "k", (B, Hkv, T, D)),
                           (v, "v", (B, Hkv, T, Dv)),
                           (o, "o", (B, H, S, Dv)),
                           (do, "do", (B, H, S, Dv))):
        build.check(t, name, shape, q.dtype, q.device)
    q, k, v, o, do = (_last_contiguous(t) for t in (q, k, v, o, do))
    dq, dk, dv = _like(q, D), _like(k, D), _like(v, Dv)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty(3, B, H, S, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t, n in ((q, "q"), (k, "k"), (v, "v"), (o, "o"),
                         (do, "do"), (dq, "dq"), (dk, "dk"), (dv, "dv"))
          for s in _bhs_strides(t, n)))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), B, H, Hkv, S, T, D, Dv, strides,
            1.0 / (D ** 0.5), int(causal), q_offset,
            int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"attention backward launch failed at (B, H, "
                           f"Hkv, S, T, D, Dv) = {(B, H, Hkv, S, T, D, Dv)}:"
                           f" CUDA error {err}")
    launches += 1
    return dq, dk, dv


__all__ = ["WIDTHS", "flash_attention_bwd_cuda"]

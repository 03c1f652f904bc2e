"""Forward GQA flash attention as a hand-written CUDA kernel for Hopper
(kernel K5).

Replaces the Pallas kernel `repro/kernels/flash_attention.py:
flash_attention_pallas`, the fast path of the online-softmax attention
that the prefill of every attention layer runs
(`repro/models/attention.py:181`, `jnp_flash`), MLA's among them, whose
q.k width (192: 128 without RoPE, 64 with) differs from its value width
(128), and Gemma's 256-wide heads. It is built for the (D, Dv) pairs
of `WIDTHS`. A block takes one
(batch, head, tile of query rows) and loops over the key tiles up to
its causal limit with the rows' running max, sum and accumulator in
registers. Two designs, by dtype (the head note of
`csrc/flash_attention.cu` has both, and what bounds each):

- f32: 64 query rows a block, every product on the CUDA cores (the
  2e-6 bar rules out TF32); bound by its f32 multiply-adds.
- bf16: 128 query rows a block; a producer warpgroup streams K and V
  tiles (128 keys; 64 at D = 256) with TMA into a 2-stage ring of shared
  memory, two consumer
  warpgroups form both products with `wgmma` on the tensor cores (bf16
  operands, f32 sums) and overlap the softmax's exps with them; bound by
  the tensor cores. P is rounded to bf16 before P V (ROADMAP C8).

TMA reads q, k and v in place from their strides, and needs a
16-byte-aligned base and (batch, head, row) strides that are multiples
of 16 bytes (8 bf16 elements) on every axis longer than 1: a bf16 view
that breaks the rule raises `ValueError` (copy it with `.contiguous()`
first); nothing falls back to another path.

`flash_attention_cuda` launches it; `kernels.ops.flash_attention`
dispatches CUDA tensors here and CPU tensors to
`ref.flash_attention_ref`. `launches` counts the kernel's launches (one
per call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the (q.k width D, value width Dv) pairs the kernel is built for
WIDTHS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.saath_flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.saath_flash_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bhs_strides(t: torch.Tensor, name: str):
    """The (batch, head, row) strides of a (B, H, S, D) tensor whose D
    axis is contiguous (any order of the other three, e.g. a transposed
    (B, S, H, D) tensor)."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"{name}: the head dimension must be contiguous, "
                         f"strides {t.stride()}")
    return t.stride()[:3]


def _tma_strides(t: torch.Tensor, name: str):
    """`_bhs_strides` of a bf16 tensor that TMA loads, after checking
    the rule TMA sets (16-byte-aligned base, strides multiples of 16
    bytes); a size-1 axis is never stepped, so its stride is passed as
    D."""
    st = _bhs_strides(t, name)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the bf16 attention kernel loads it with "
                         f"TMA, which needs a 16-byte-aligned base; its "
                         f"data pointer is {t.data_ptr() % 16} bytes past "
                         f"a 16-byte boundary")
    out = []
    for axis, size, s in zip(("batch", "head", "row"), t.shape[:3], st):
        if size == 1:
            s = t.shape[3]
        elif (s * t.element_size()) % 16:
            raise ValueError(f"{name}: the bf16 attention kernel loads it "
                             f"with TMA, which needs strides that are "
                             f"multiples of 16 bytes; its {axis} stride is "
                             f"{s} elements ({s * t.element_size()} bytes)")
        out.append(s)
    return out


def _like(q: torch.Tensor, width: int) -> torch.Tensor:
    """An empty (B, H, S, width) tensor whose (batch, head, row) axes
    are laid out in the order of q's strides, width contiguous (so that
    a transposed (B, S, H, D) q gives an o whose transpose back is
    contiguous)."""
    order = sorted(range(3), key=lambda a: -q.stride(a))
    o = q.new_empty([q.shape[a] for a in order] + [width])
    return o.permute(*[order.index(a) for a in range(3)], 3)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """Forward GQA attention on one CUDA device: q (B, H, S, D), k
    (B, Hkv, T, D) and v (B, Hkv, T, Dv), all f32 or all bf16, each with
    its last axis contiguous (strided views such as `x.transpose(1, 2)`
    of a (B, S, H, D) tensor are read in place); H a multiple of Hkv,
    (D, Dv) in `WIDTHS`, q_offset >= 0. Returns o (B, H, S, Dv) in q's
    dtype, laid out like q (so `o.transpose(1, 2)` of a transposed q is
    contiguous), the contract of `ref.flash_attention_ref`; the scores
    are scaled by D^-1/2. In bf16 the inputs must meet TMA's alignment
    rule (see the module note) or it raises ValueError."""
    global launches
    if q.dim() != 4 or not q.is_cuda:
        raise ValueError("flash_attention_cuda needs q as a (B, H, S, D) "
                         "CUDA tensor")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16, "
                         f"not {q.dtype}")
    B, H, S, D = q.shape
    if k.dim() != 4:
        raise ValueError("k and v must be (B, Hkv, T, D)")
    Hkv, T = k.shape[1], k.shape[2]
    Dv = v.shape[3] if v.dim() == 4 else -1
    if (D, Dv) not in WIDTHS or Hkv == 0 or H % Hkv or q_offset < 0:
        raise ValueError(f"flash_attention_cuda: (D = {D}, Dv = {Dv}) must "
                         f"be one of {WIDTHS}, H = {H} a multiple of Hkv = "
                         f"{Hkv}, q_offset = {q_offset} >= 0")
    for t, name, shape in ((k, "k", (B, Hkv, T, D)),
                           (v, "v", (B, Hkv, T, Dv))):
        if tuple(t.shape) != shape or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name}: expected {q.dtype} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    o = _like(q, Dv)
    if o.numel() == 0:
        return o
    loaded = _tma_strides if q.dtype == torch.bfloat16 else _bhs_strides
    strides = (ctypes.c_longlong * 12)(
        *loaded(q, "q"), *loaded(k, "k"), *loaded(v, "v"),
        *_bhs_strides(o, "o"))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            Hkv, S, T, D, Dv, strides, 1.0 / (D ** 0.5), int(causal),
            q_offset, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed at (B, H, Hkv, "
                           f"S, T, D, Dv) = {(B, H, Hkv, S, T, D, Dv)}: CUDA "
                           f"error "
                           f"{err} (a shared-memory request above the "
                           f"block's limit, or a tensor map the CUDA driver "
                           f"refused, is error 1)")
    launches += 1
    return o


__all__ = ["WIDTHS", "flash_attention_cuda"]

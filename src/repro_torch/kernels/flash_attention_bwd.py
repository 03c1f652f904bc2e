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
`csrc/flash_attention_bwd.cu` has the design, its bound and its shared
memory and registers): per query row the base-2 log-sum-exp of the
scores and delta = rowsum(do o); dk and dv per (key tile, split of the
G query heads); dq per query tile. When the heads are split (the
largest divisor of G up to 4, while the dk/dv grid has fewer than
4 x 132 blocks), each split writes f32 partials to a workspace and a
fourth launch sums them in a fixed order and casts. No atomics: each
gradient element has one owner and one order of sums, so two calls give
the same bits.

- bf16: every product on `wgmma` tensor cores fed by TMA (a producer
  warpgroup, two consumer warpgroups, rings of 2 stages), bf16 operands
  and f32 sums; P^T and dS^T are rounded to bf16 in registers as the A
  operands of dV += P^T dO, dK += dS^T Q and dQ += dS K (ROADMAP C14).
  The launches do 5 D + 3 Dv multiply-adds a (query, key) pair; the
  function needs 3 D + 2 Dv.
- f32: the same launches and split on the CUDA cores (no TF32), register
  micro-tiles of 4 x 4 (4 x 2 at (192, 128)) fed by float4 reads of
  tiles that 16-byte `cp.async` copies stage in shared memory.

Bound on the H100 at StarCoder2-3B's train shape (B 4, H 24, Hkv 2,
S = T = 2048, D = Dv = 128, causal): the function's 3 D + 2 Dv
multiply-adds for each of 201 M unmasked pairs take 0.26 ms at the
bf16 tensor-core rate and 3.85 ms at the f32 rate of the CUDA cores;
its bytes 0.05 ms. Shared memory and registers a thread at (128, 128):
bf16 97 / 130 / 129 KB for stats / dk, dv / dq, one block an SM, 168
registers (setmaxnreg: 240 for the consumers); f32 66 / 166.5 / 149.5
KB, 96 / 210 / 168 registers. At (192, 128): bf16 145 / 121.5 / 161
KB; f32 98 / 91 / 87 KB, two blocks an SM. `resources` reads them from
the CUDA runtime.

Both read their inputs in place through 16-byte loads, which need a
16-byte-aligned base and (batch, head, row) strides that are multiples
of 16 bytes with the last axis contiguous: a view that breaks the rule
is copied first. The workspace (lse2 and delta, (B H, S rounded up to
128) f32 each, then the partials, (B, Hkv, splits, T, D + Dv) f32; 67 MB
at StarCoder2-3B's train shape) is allocated per call. It is built for
the (D, Dv) pairs of its own `WIDTHS` (K5's but (256, 256), ROADMAP
queue A item 11e-ii) and raises on any other,
on a failed build or a failed launch (nothing falls back to the plain
version, `ref.flash_attention_bwd_ref`).

`flash_attention_bwd_cuda` launches it; `kernels.ops.flash_attention_bwd`
dispatches CUDA tensors here and CPU tensors to the plain version.
`launches` counts its calls (three or four kernel launches each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_bhs_strides, _like,
                                                  _tma_strides)

# the (q.k width D, value width Dv) pairs the kernel is built for: K5's
# but (256, 256), which Gemma-7B's training would need (ROADMAP queue A
# item 11e-ii)
WIDTHS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
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
        lib.saath_flash_attention_bwd_workspace.argtypes = \
            [ctypes.c_int] * 8
        lib.saath_flash_attention_bwd_workspace.restype = ctypes.c_longlong
        lib.saath_flash_attention_bwd_resources.argtypes = \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.saath_flash_attention_bwd_resources.restype = ctypes.c_int
        _lib = lib
    return _lib


def _vector_readable(t: torch.Tensor) -> torch.Tensor:
    """`t`, or its contiguous copy unless its base is 16-byte aligned,
    its last axis contiguous and its other strides (of axes longer than
    1) multiples of 16 bytes: the rule of the kernel's 16-byte loads."""
    ok = t.data_ptr() % 16 == 0 and (t.stride(3) == 1 or t.shape[3] == 1) \
        and all(n == 1 or (s * t.element_size()) % 16 == 0
                for n, s in zip(t.shape[:3], t.stride()[:3]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             q_offset: int = 0):
    """(dq, dk, dv) of `ref.flash_attention_ref` at (q, k, v) for the
    output gradient `do`, on one CUDA device: q (B, H, S, D), k
    (B, Hkv, T, D), v (B, Hkv, T, Dv), the forward's o and do
    (B, H, S, Dv), all f32 or all bf16, read in place through their
    strides (a view that breaks the rule of the 16-byte loads, see the
    module note, is copied first); H a multiple of Hkv, (D, Dv) in
    `WIDTHS`, q_offset >= 0. Each
    gradient is laid out like its input (so a transposed view's gradient
    transposes back to a contiguous tensor)."""
    global launches
    widths = (q.shape[-1], v.shape[-1])
    if widths not in WIDTHS:
        raise ValueError(f"flash_attention_bwd_cuda: (D, Dv) = {widths} "
                         f"must be one of {WIDTHS} (the others, Gemma-7B's "
                         f"(256, 256) among them, are ROADMAP queue A item "
                         f"11e-ii)")
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
    if Hkv == 0 or H % Hkv or q_offset < 0:
        raise ValueError(f"flash_attention_bwd_cuda: H = {H} must be a "
                         f"multiple of Hkv = {Hkv}, q_offset = {q_offset} "
                         f">= 0")
    for t, name, shape in ((k, "k", (B, Hkv, T, D)),
                           (v, "v", (B, Hkv, T, Dv)),
                           (o, "o", (B, H, S, Dv)),
                           (do, "do", (B, H, S, Dv))):
        build.check(t, name, shape, q.dtype, q.device)
    q, k, v, o, do = (_vector_readable(t) for t in (q, k, v, o, do))
    dq, dk, dv = _like(q, D), _like(k, D), _like(v, Dv)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _library()
    work = torch.empty(lib.saath_flash_attention_bwd_workspace(
        B, H, Hkv, S, T, D, Dv, bf16), dtype=torch.float32,
        device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t, n in ((q, "q"), (k, "k"), (v, "v"), (o, "o"),
                         (do, "do")) for s in _tma_strides(t, n)),
        *(s for t, n in ((dq, "dq"), (dk, "dk"), (dv, "dv"))
          for s in _bhs_strides(t, n)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.saath_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            work.data_ptr(), B, H, Hkv, S, T, D, Dv, strides,
            1.0 / (D ** 0.5), int(causal), q_offset, bf16, stream)
    if err:
        raise RuntimeError(f"attention backward launch failed at (B, H, "
                           f"Hkv, S, T, D, Dv) = {(B, H, Hkv, S, T, D, Dv)}:"
                           f" CUDA error {err}")
    launches += 1
    return dq, dk, dv


def resources(D: int, Dv: int, dtype: torch.dtype) -> dict:
    """{kernel: (registers a thread, dynamic shared bytes, resident blocks
    an SM)} of the instance's stats, dk/dv and dq kernels at (D, Dv), as
    the CUDA runtime reports them on the current device (the bf16
    kernels' registers are the block's allocation; setmaxnreg gives their
    consumer warpgroups 240 a thread)."""
    out = (ctypes.c_int * 9)()
    err = _library().saath_flash_attention_bwd_resources(
        D, Dv, int(dtype == torch.bfloat16), out)
    if err:
        raise RuntimeError(f"attention backward resources at (D, Dv) = "
                           f"{(D, Dv)}: CUDA error {err}")
    return {name: tuple(out[3 * i:3 * i + 3])
            for i, name in enumerate(("stats", "dkdv", "dq"))}


__all__ = ["WIDTHS", "flash_attention_bwd_cuda", "resources"]

"""Row prefix sums in the JAX package's scan order as a hand-written CUDA
kernel for Hopper (kernel K6).

It has no Pallas counterpart: the JAX engine's segment sums
(`repro/fabric/jax_engine.py:_segment_sum`) are `jnp.cumsum` plus two
gathers, and XLA scans in blocks of 16, recursively
(`ref.prefix_sum_ref` spells the order out). A per-coflow float byte sum
rounds by that order, so the port sums in it too: the Aalo-queue
ablation's total bytes and the learned pilot estimate then equal the
reference's bit for bit (ROADMAP C2, C9). The kernel
(`csrc/prefix_sum.cu`) spreads each row over tiles of 4096 floats in one
cooperative launch and scans the row's block totals exactly as XLA
does; its head note gives the design and what bounds it.

`prefix_sum_cuda` launches it; `kernels.ops.prefix_sum` dispatches to it
for CUDA tensors and to `ref.prefix_sum_ref` for CPU tensors.
`launches` counts the kernel's launches (one per call), `rows` the rows
those launches summed (the engine stacks a step's independent segment
sums into one call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
rows = 0
_lib = None
# F -> floats of global scratch one row needs (its level-2 and level-3
# totals; -1 past the kernel's longest row), asked of the library once
# per row length
_scratch_per_row: dict = {}


def _library():
    global _lib
    if _lib is None:
        lib = build.load("prefix_sum")
        lib.saath_prefix_sum.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.saath_prefix_sum.restype = ctypes.c_int
        lib.saath_prefix_sum_scratch.argtypes = [ctypes.c_int,
                                                 ctypes.c_longlong]
        lib.saath_prefix_sum_scratch.restype = ctypes.c_longlong
        lib.saath_prefix_sum_configs.argtypes = []
        lib.saath_prefix_sum_configs.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def launch_configs() -> int:
    """Launch configurations the loaded library has worked out and kept
    (one per device); 0 before it is loaded."""
    return 0 if _lib is None else int(_lib.saath_prefix_sum_configs())


def _launch(lib, x, out, scratch, B, F) -> int:
    stream = torch.cuda.current_stream().cuda_stream
    return lib.saath_prefix_sum(
        x.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), B, F, stream)


def prefix_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """(B, F) f32 on a CUDA device -> (B, F + 1) f32: a leading zero
    column, then each row's inclusive prefix sums in XLA's order.

    It runs on every event step (2-3 calls a step), so its host path is
    kept short: the scratch size is cached per F, and the device is
    switched only when `x` is not on the current one."""
    global launches, rows
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"prefix_sum_cuda takes a (B, F) float32 tensor, "
                         f"not {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError("prefix_sum_cuda needs a CUDA tensor")
    x = x.contiguous()
    B, F = x.shape
    if B == 0 or F == 0:
        return x.new_zeros((B, F + 1))
    lib = _library()
    per_row = _scratch_per_row.get(F)
    if per_row is None:
        per_row = _scratch_per_row[F] = lib.saath_prefix_sum_scratch(1, F)
    if per_row < 0:
        raise ValueError(f"prefix_sum_cuda takes rows of at most 2^23 "
                         f"floats, not {F}")
    out = x.new_empty((B, F + 1))
    scratch = x.new_empty(B * per_row)
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        err = _launch(lib, x, out, scratch, B, F)
    else:
        with torch.cuda.device(dev):
            err = _launch(lib, x, out, scratch, B, F)
    if err:
        raise RuntimeError(f"prefix-sum kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    rows += B
    return out


__all__ = ["prefix_sum_cuda", "launch_configs"]

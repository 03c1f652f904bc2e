"""The ops a callable dispatches: the op-level counterpart of
`repro.analysis.jaxpr_scan`.

The port is eager, so where the reference reads a jaxpr the port runs
the callable under a `TorchDispatchMode` and records what it actually
dispatches:

* `Scan.ops` — a histogram of aten overload names (``aten.add.Tensor``),
  plus one ``kernel:<name>`` entry a call of each hand-written kernel.
  The kernels launch through `ctypes`, where no dispatch mode sees
  them, so they are recorded at the `kernels.ops` boundary, and the
  scan is suspended inside an `ops.*` call: on the CPU the plain
  versions run there (K2's plain walk is a Python loop whose op count
  depends on the data), and with the scan suspended the CPU's and the
  card's histograms hold the same ``kernel:*`` entries;
* `Scan.f64_sites` — ops that produce float64 (any f64 output) and
  casts to it (``aten._to_copy -> float64``): the f32 slab must never
  drift to f64 in the step;
* `Scan.host_sites` — host synchronizations and transfers: scalar
  reads (``aten._local_scalar_dense``: `.item()`, `bool()`, `float()`
  of a tensor), ops whose output shape depends on the data
  (``nonzero``, ``masked_select``, boolean indexing, ``unique``), and
  copies between the host and another device. A choke point's counted
  crossing (`analysis.sanitize.crossing`: the session loop's flag read,
  the engine's uploads) is recorded apart, in `Scan.crossings`;
* `Scan.signature` — dtype and shape of each tensor argument, in
  argument order (``float32[2, 8]``), the counterpart of the
  reference's jit cache signature.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import sanitize

__all__ = ["Scan", "scan", "signature", "tensor_sig"]

# ops whose output shape depends on the data: the host must read a
# count back from the device before it can allocate the result
DATA_DEPENDENT = frozenset({
    "nonzero.default", "masked_select.default", "_unique2.default",
    "unique_dim.default", "unique_consecutive.default",
    "repeat_interleave.Tensor",
})


@dataclasses.dataclass
class Scan:
    """What one run of a callable dispatched (see the module doc)."""
    ops: Counter
    f64_sites: List[str]
    host_sites: List[str]
    crossings: Counter
    signature: List[str]
    result: object = None

    @property
    def kernels(self) -> dict:
        """The ``kernel:*`` entries of the histogram, by kernel name."""
        return {k[len("kernel:"):]: v for k, v in self.ops.items()
                if k.startswith("kernel:")}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def tensor_sig(x) -> str:
    """``float32[2, 8]`` for a tensor or numpy array."""
    return f"{_dtype_name(x.dtype)}{list(x.shape)}"


def signature(tree) -> List[str]:
    """The tensor and numpy leaves of an argument tree (tuples, lists,
    NamedTuples, dicts by sorted key), in order; None leaves and Python
    scalars are left out."""
    out: List[str] = []

    def walk(x):
        if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
            out.append(tensor_sig(x))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [o for o in out if isinstance(o, torch.Tensor)]
    return []


def _bool_index(args) -> bool:
    idx = args[1] if len(args) > 1 else ()
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in (idx or ()))


class _ScanMode(TorchDispatchMode):
    """Records every dispatched op outside the `kernels.ops` boundary;
    also a `sanitize` listener (choke-point crossings) and a
    `kernels.ops` observer (kernel calls)."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.f64: List[str] = []
        self.host: List[str] = []
        self.crossings: Counter = Counter()
        self._in_kernel = 0

    # kernels.ops observer
    def kernel_enter(self, name: str) -> None:
        if not self._in_kernel:
            self.ops[f"kernel:{name}"] += 1
        self._in_kernel += 1

    def kernel_exit(self, name: str) -> None:
        self._in_kernel -= 1

    # sanitize listener
    def on_crossing(self, kind, nbytes, where, accounted) -> None:
        if not self._in_kernel:
            self.crossings[f"{kind}:{where}"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_kernel:
            return out
        name = func.__name__
        self.ops[f"aten.{name}"] += 1
        if name == "_to_copy.default" and \
                kwargs.get("dtype") == torch.float64:
            self.f64.append(f"aten.{name} -> float64")
        elif any(o.dtype == torch.float64 for o in _outputs(out)):
            self.f64.append(f"aten.{name} (f64 output)")
        if sanitize.in_choke_point():
            return out
        if name == "_local_scalar_dense.default":
            self.host.append(f"aten.{name} (scalar read)")
        elif name in DATA_DEPENDENT or (name == "index.Tensor"
                                        and _bool_index(args)):
            self.host.append(f"aten.{name} (data-dependent shape)")
        else:
            hit = sanitize.device_crossing(func, args, kwargs)
            if hit is not None:
                self.host.append(f"{hit[2]} ({hit[0]} copy)")
        return out


def scan(fn: Callable, *args, **kwargs) -> Scan:
    """Run `fn(*args, **kwargs)` once under the scan; its return value is
    kept in `Scan.result`."""
    from repro_torch.kernels import ops

    mode = _ScanMode()
    sig = signature((args, kwargs))
    ops.observers.append(mode)
    sanitize.listen(mode)
    try:
        with mode:
            result = fn(*args, **kwargs)
    finally:
        sanitize.unlisten(mode)
        ops.observers.remove(mode)
    return Scan(ops=mode.ops, f64_sites=mode.f64, host_sites=mode.host,
                crossings=mode.crossings, signature=sig, result=result)

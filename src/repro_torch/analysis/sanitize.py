"""Runtime sanitizers for the serving plane's dispatch contracts.

The port of `repro.analysis.sanitize`. The port is eager (no compiled
executables, no jit cache), so the two context managers check what an
eager program can get wrong on a warm path:

* ``assert_no_recompiles()`` counts what the port builds inside the
  scope: nvcc builds (`kernels.build.build_all`), newly loaded kernel
  libraries (`build._loaded`), new K6 scratch sizes
  (`prefix_sum._scratch_per_row`), new launch configurations kept by
  the K1 and K6 libraries (one per (device, P) and per device), and on
  the card growth of the caching allocator's peak of allocated bytes
  (`torch.cuda.memory_stats()["allocated_bytes.all.peak"]`): the path
  held more device memory at once than the process had before, a new
  buffer rather than blocks the cache hands back. (A new segment at an
  unchanged peak is the allocator's fragmentation, not a build.) More
  than `allow` raises `RecompileError`; the yielded scope's `.compiles`
  names them.
* ``assert_no_transfers()`` arms a guard of two parts. The port's own
  choke points (`fabric.engine.host_to_device`, the session loop's flag
  read, `SessionPool._download`) report every crossing they make, on
  any device: on the CPU that counter is the guard. A
  `TorchDispatchMode` sees the copies between the host and another
  device that go around them (`_to_copy`, `copy_`, a scalar read of a
  device tensor). An upload or download outside an
  `accounted_transfer()` frame raises `TransferError` at its call site;
  inside one it is counted on the scope (`.uploads`, `.upload_bytes`,
  `.downloads`, `.download_bytes`, `.flag_reads`). The `SessionPool`
  wraps exactly its io-counted methods (`@_io_accounted`), so the
  scope's download bytes equal the pool's `io` ledger (`download_bytes`
  + `ctl_bytes`) plus one byte a flag read (`io["loop_reads"]`).

What the dispatch mode cannot see is covered statically, in the device
step, by the lint rule `host-sync-in-step`: on the card a tensor built
from Python data (`torch.tensor([...], device="cuda")`) uploads without
dispatching a copy (`chip_smoke.py` phase 25 prints what the mode sees:
pinned non-blocking copies, `.cpu()`, `.item()`, `float()`, `bool()`,
`.tolist()`); on the CPU `.tolist()` dispatches nothing.

The choke points read one module-level flag, `armed`, when no guard or
op scan listens.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["RecompileError", "TransferError", "accounted_transfer",
           "assert_no_recompiles", "assert_no_transfers", "build_state",
           "built_since", "crossing", "device_crossing", "in_choke_point",
           "listen", "unlisten"]

# read by the choke points: is any guard or op scan listening?
armed = False
_listeners: list = []
_tls = threading.local()


class RecompileError(AssertionError):
    """Something was built inside an assert_no_recompiles scope."""


class TransferError(AssertionError):
    """A host-device transfer outside an accounted_transfer() frame,
    inside an assert_no_transfers scope."""


def _accounted() -> int:
    return getattr(_tls, "accounted", 0)


def in_choke_point() -> bool:
    """Is this thread inside a choke point's reported crossing? The
    dispatch modes leave the copies made there to that report."""
    return getattr(_tls, "choke", 0) > 0


def listen(listener) -> None:
    """Arm the choke points for `listener` (its `on_crossing(kind,
    nbytes, where, accounted)` sees every crossing)."""
    global armed
    _listeners.append(listener)
    armed = True


def unlisten(listener) -> None:
    global armed
    _listeners.remove(listener)
    armed = bool(_listeners)


@contextlib.contextmanager
def accounted_transfer():
    """Carve-out for io-accounted host-device crossings: inside it an
    `assert_no_transfers` scope counts transfers instead of raising. The
    `SessionPool` wraps exactly the methods its `pool.io` counters
    cover, so the sanitizer's reach is everything the accounting
    misses."""
    _tls.accounted = _accounted() + 1
    try:
        yield
    finally:
        _tls.accounted -= 1


@contextlib.contextmanager
def crossing(kind: str, nbytes: int, where: str, *,
             accounted: bool = False):
    """A choke point's crossing of `nbytes` ("h2d" or "d2h") at
    `where`, reported to every listener before it runs (a guard raises
    here on an unaccounted one). `accounted` marks a crossing that is
    counted by construction (the session loop's flag read). Called only
    when `armed`."""
    acc = accounted or _accounted() > 0
    for listener in list(_listeners):
        listener.on_crossing(kind, int(nbytes), where, acc)
    _tls.choke = getattr(_tls, "choke", 0) + 1
    try:
        yield
    finally:
        _tls.choke -= 1


def _is_host(device) -> bool:
    return torch.device(device).type == "cpu"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def device_crossing(func, args, kwargs) -> Optional[tuple]:
    """(kind, nbytes, op) when the dispatched op moves data between the
    host and another device, else None: `_to_copy` and `copy_` across
    the host boundary, and a scalar read of a device tensor (`.item()`,
    `bool()`, `float()`)."""
    name = func.__name__
    if name == "_to_copy.default":
        src = args[0]
        dst = kwargs.get("device") or src.device
        a, b = _is_host(src.device), _is_host(dst)
    elif name == "copy_.default":
        dst, src = args[0], args[1]
        if not isinstance(src, torch.Tensor):
            return None
        a, b = _is_host(src.device), _is_host(dst.device)
    elif name == "_local_scalar_dense.default":
        src = args[0]
        a, b = _is_host(src.device), True
    else:
        return None
    if a == b:
        return None
    return ("h2d" if a else "d2h"), _nbytes(src), f"aten.{name}"


class _TransferScope:
    """Handle yielded by `assert_no_transfers`: the accounted crossings
    seen so far, by direction (`crossings` keeps them by (kind,
    where))."""

    def __init__(self):
        self.crossings: Counter = Counter()
        self.uploads = self.upload_bytes = 0
        self.downloads = self.download_bytes = 0
        self.flag_reads = 0

    def on_crossing(self, kind, nbytes, where, accounted) -> None:
        if not accounted:
            way = "host-to-device" if kind == "h2d" else "device-to-host"
            raise TransferError(
                f"unaccounted {way} transfer of {nbytes} bytes at {where} "
                f"inside assert_no_transfers (an io-counted path runs "
                f"inside accounted_transfer())")
        self.crossings[(kind, where)] += 1
        if kind == "h2d":
            self.uploads += 1
            self.upload_bytes += nbytes
        else:
            self.downloads += 1
            self.download_bytes += nbytes
            self.flag_reads += where == "engine.session_advance"


class _TransferMode(TorchDispatchMode):
    """Sees the host-device copies that go around the choke points."""

    def __init__(self, scope: _TransferScope):
        super().__init__()
        self.scope = scope

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not in_choke_point():
            hit = device_crossing(func, args, kwargs)
            if hit is not None:
                kind, nbytes, op = hit
                self.scope.on_crossing(kind, nbytes, op, _accounted() > 0)
        return func(*args, **kwargs)


@contextlib.contextmanager
def assert_no_transfers():
    """Disallow every host-device transfer inside the scope (the choke
    points' and the copies a dispatch mode sees) except those inside
    `accounted_transfer()`. Violations raise `TransferError` at the
    offending call site. Yields the scope that counts the accounted
    ones."""
    scope = _TransferScope()
    listen(scope)
    try:
        with _TransferMode(scope):
            yield scope
    finally:
        unlisten(scope)


def _device_peak() -> Optional[int]:
    """The caching allocator's peak of allocated bytes on the current
    card (since the process started or the peak was last reset), or
    None off the card."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.memory_stats().get("allocated_bytes.all.peak")


def build_state() -> dict:
    """What the port has built so far in this process, by kind."""
    from repro_torch.kernels import build, contention, prefix_sum

    return {"nvcc": list(build.built),
            "load": set(build._loaded),
            "k6_scratch": set(prefix_sum._scratch_per_row),
            "k1_config": contention.launch_configs(),
            "k6_config": prefix_sum.launch_configs(),
            "device_peak": _device_peak()}


def built_since(before: dict, after: dict) -> list:
    """Names of what was built between two `build_state` snapshots."""
    out = [f"nvcc {n}" for n in after["nvcc"][len(before["nvcc"]):]]
    out += [f"load {n}" for n in sorted(after["load"] - before["load"])]
    out += [f"K6 scratch size F={f}"
            for f in sorted(after["k6_scratch"] - before["k6_scratch"])]
    for key, what in (("k1_config", "K1 launch configuration"),
                      ("k6_config", "K6 launch configuration")):
        out += [what] * max(after[key] - before[key], 0)
    if before["device_peak"] is not None and \
            after["device_peak"] is not None and \
            after["device_peak"] > before["device_peak"]:
        out.append(f"device memory peak +"
                   f"{after['device_peak'] - before['device_peak']} bytes")
    return out


class _RecompileScope:
    """Handle yielded by `assert_no_recompiles`: `.compiles` lists what
    was built so far inside the scope."""

    def __init__(self, before: dict):
        self._before = before

    @property
    def compiles(self) -> list:
        return built_since(self._before, build_state())


@contextlib.contextmanager
def assert_no_recompiles(allow: int = 0):
    """Fail with `RecompileError` if more than `allow` things are built
    inside the scope (nvcc builds, library loads, K6 scratch sizes, K1
    and K6 launch configurations, a higher peak of allocated device
    memory on the card). Warm the path first: the sanitizer asserts
    reuse, it does not tell first builds from rebuilds; the peak is the
    process's, so reset it (`torch.cuda.reset_peak_memory_stats()`)
    before warming to hold the path to its own. Yields a scope whose `.compiles` lists what
    was built."""
    scope = _RecompileScope(build_state())
    yield scope
    built = scope.compiles
    if len(built) > allow:
        raise RecompileError(
            f"{len(built)} build(s) inside an assert_no_recompiles("
            f"allow={allow}) scope: {built}")

"""Dispatch sanitizers, op-level audit and static checks of the port.

The counterpart of `repro.analysis`, over what the eager port runs:

* ``repro_torch.analysis.sanitize`` — runtime sanitizers:
  `assert_no_recompiles` (nvcc builds, library loads, launch
  configurations and device-memory peaks on a warm path) and
  `assert_no_transfers` (the port's choke points plus a
  `TorchDispatchMode` over host-device copies), with
  `accounted_transfer` carve-outs for the pool's io-counted methods.
* ``repro_torch.analysis.op_scan`` — the ops a callable dispatches,
  with the hand-written kernels recorded at the `kernels.ops` boundary.
* ``repro_torch.analysis.audit`` — runs the device step's entry points
  on a tiny seeded slab and checks: no f64 op, no host sync inside the
  step, and no drift from ``analysis/torch_dispatch_manifest.json``
  (``python -m repro_torch.analysis.audit [--update]``).
* ``repro_torch.analysis.lint`` — stdlib-`ast` rules for the eager
  device step (host syncs, branches on tensors, implicit dtypes,
  unaccounted pool pulls), the slab contracts and hygiene
  (``python -m repro_torch.analysis.lint src/repro_torch``).
* ``repro_torch.analysis.coherence`` — the slab coherence protocol of
  the pool, session and server, typestate-checked against
  ``analysis/torch_coherence_manifest.json`` (``--selftest`` re-checks
  five seeded coherence bugs).
* ``repro_torch.analysis.explore`` — random pool schedules replayed on
  the async pool against each tenant run alone, compared bit for bit.

Only `sanitize` is imported here: the pool and the engine use it on
their hot paths.
"""
from repro_torch.analysis.sanitize import (RecompileError, TransferError,
                                           accounted_transfer,
                                           assert_no_recompiles,
                                           assert_no_transfers)

__all__ = ["assert_no_recompiles", "assert_no_transfers",
           "accounted_transfer", "RecompileError", "TransferError"]

"""Coflow bridge: collective traffic sources -> Saath schedule -> waves.
The port of `repro.runtime.coflow_bridge`.

This is the paper's technique acting as the framework's collective
scheduler (DESIGN.md §2). Each pending collective is one COFLOW:

* a gradient bucket's reduce-scatter / all-reduce over the ``data`` (and
  ``pod``) axis — arrival rank = backward generation order;
* a MoE all-to-all wave over the expert axis;
* background tenants: checkpoint uploads (host/DCN links), KV-cache
  migrations between serving replicas.

Port model: every chip has independent links per mesh axis, so two
collectives contend iff they use the same (axis, chip-group) resource;
DCN/host traffic uses distinct 'ports'. The planner is a thin client of
`repro_torch.api.SaathSession`: collectives are submitted in dense
arrival-rank order and each wave is one `plan_tick` — the session's
wave-planning mode, in which the admitted (resource-disjoint,
all-or-none) set completes instantly. Later waves are issued only once
earlier ones have completed (`runtime.overlap`). ``backend="torch"``
(the default) runs the coordinator tick on the session's slab on
`device` (K1, K2 and K6 on the card); ``backend="numpy"`` is the host
reference, kept as the parity oracle — the two produce identical wave
orders (tests/test_torch_runtime_bridge.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.coflow import Coflow, Flow
from repro_torch.core.params import SchedulerParams


@dataclasses.dataclass(frozen=True)
class CollectiveCoflow:
    name: str
    bytes: int                 # per-chip payload
    resources: tuple           # e.g. ("ici:data",), ("ici:model",), ("dcn",)
    arrival_rank: int          # readiness order within the step
    chips: tuple = ()          # chip ids involved; () = all


# canonical resources on a (pod, data, model) mesh
RESOURCES = ("ici:data", "ici:model", "ici:pod", "dcn", "host")


def collective_to_coflow(c: CollectiveCoflow, *, num_chips: int = 16,
                         arrival: float = 0.0) -> Coflow:
    """One collective as a Coflow on the (resource, chip) port grid: a
    flow per involved chip on each of its resources, sized by the
    per-chip bytes — so per-flow queue thresholds and LCoF act exactly
    as in the paper (a 'wide' MoE a2a demotes faster than a thin DCN
    upload)."""
    res_index = {r: i for i, r in enumerate(RESOURCES)}
    chips = c.chips or tuple(range(num_chips))
    flows, fid = [], 0
    for r in c.resources:
        base = res_index[r] * num_chips
        for ch in chips:
            flows.append(Flow(fid, base + ch, base + ch,
                              max(c.bytes, 1.0)))
            fid += 1
    return Coflow(cid=0, arrival=arrival, flows=flows)


def bridge_params() -> SchedulerParams:
    """Default fabric knobs for the collective plane (50 GB/s
    link-class ports, 0.1 ms waves, 8 MB start threshold)."""
    return SchedulerParams(port_bw=50e9, delta=1e-4,
                           start_threshold=8 * 1024 * 1024)


def plan_waves(coflows: Sequence[CollectiveCoflow], *,
               num_chips: int = 16,
               params: Optional[SchedulerParams] = None,
               backend: str = "torch", device=None) -> List[List[str]]:
    """Order collectives with the Saath coordinator; returns waves of
    coflow names (wave = admitted in the same coordinator tick).
    `device` is where the session runs (None = CUDA, raising without a
    card; "cpu" = the plain path).

    All-or-none holds by construction: an SPMD collective is
    indivisible across its chips, so within a wave no two collectives
    share a contended (resource, chip) port. Duplicate arrival ranks
    are legal — e.g. two tenants both built with
    grad_bucket_coflows(rank_offset=0) — and are densely renumbered
    preserving (rank, submission) order before submission, so the
    session's global FIFO ranks reproduce the intended order.
    """
    if not coflows:
        return []
    from repro_torch.api import SaathSession

    params = params or bridge_params()
    P = len(RESOURCES) * num_chips
    order = sorted(range(len(coflows)),
                   key=lambda i: (coflows[i].arrival_rank, i))
    # work conservation off: a wave is an all-or-none admitted set; a
    # partially-issued collective is meaningless
    sess = SaathSession(params, num_ports=P, backend=backend,
                        mechanisms={"work_conservation": False},
                        device=device)
    names = {}
    for i in order:
        c = coflows[i]
        h = sess.submit([collective_to_coflow(c, num_chips=num_chips)])[0]
        names[h] = c.name

    waves: List[List[str]] = []
    remaining = set(names)
    guard = 0
    while remaining and guard < len(names) + 2:
        guard += 1
        admitted = sorted(h for h in sess.plan_tick() if h in remaining)
        if not admitted:  # should not happen: ports free up every wave
            admitted = [min(remaining)]
            sess.complete(admitted)
        waves.append([names[h] for h in admitted])
        remaining.difference_update(admitted)
    if remaining:
        # a truncated plan would silently drop collectives from the step
        raise RuntimeError(
            f"plan_waves failed to place {len(remaining)} collectives "
            f"({sorted(names[h] for h in remaining)}) after {guard} "
            "waves — scheduler made no progress")
    return waves


def grad_bucket_coflows(buckets, *, axes=("ici:data",),
                        rank_offset: int = 0) -> List[CollectiveCoflow]:
    """Buckets arrive in reverse-layer order (bucket 0 ready first)."""
    return [CollectiveCoflow(name=f"grad/{b.bid}", bytes=b.bytes,
                             resources=tuple(axes),
                             arrival_rank=rank_offset + b.bid)
            for b in buckets]


__all__ = ["CollectiveCoflow", "RESOURCES", "collective_to_coflow",
           "bridge_params", "plan_waves", "grad_bucket_coflows"]

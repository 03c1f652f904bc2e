"""The multi-tenant coflow serving front door (DESIGN.md §8), on the card.

The port of `repro.launch.serve`. `CoflowServer` is the admission-
controlled service surface of the scheduling plane: tenants register by
name, submit coflows and poll completions, while one
`repro_torch.api.SessionPool` hosts every tenant as a row of a single
batched device-resident slab: `advance(dt)` moves every tenant's
coordinator with one batched advance.

Admission: `max_tenants` fixes the slab's row count up front;
`register` raises `AdmissionError` once the cap is reached, and `evict`
frees a row (dropping the tenant's unfinished coflows) for the next
registrant. A tenant may register with its own `SchedulerParams` and
mechanism switches (`register(name, params=..., mechanisms=...)`),
learned sizes (``mechanisms={"clairvoyant": False}``) included: the pool
stacks one parameter row per tenant, so a heterogeneous fleet still
rides one advance. Per-tenant outcomes come out as the same normalized
`repro_torch.api.Result` the offline replay gives
(`api.scenario.result_from_completions`).

Retention is bounded: every harvested completion is folded into the
tenant's `TenantAggregates` (exact lifetime count, mean CCT, makespan,
bytes), and the raw `CompletedCoflow` records are dropped once `poll`
returns them (plus a `history_limit` backstop for tenants that never
poll). `result()` reports exact lifetime aggregates, while its
per-coflow arrays cover the retained window.

Harvesting walks the pool's new-completion index
(`SessionPool.completed_sessions`): `advance` polls only the tenants
whose row finished something since the last harvest. That index is a
sync point: it downloads the (tick, finished) control the pool's
advance parks on the device.

Overload shedding: a tenant may register under a `TenantQuota` (live-
coflow and live-byte budgets and an SLO). A `submit` that would exceed
the budget is shed whole under ``policy="reject"``
(`QuotaExceededError`) or split under ``policy="defer"`` (the in-budget
prefix is admitted, the rest queues server-side and is retried on every
`advance`, arrivals clamped to the tenant clock); a deferred coflow
older than the quota's `slo` is shed instead of admitted. Counters live
in `TenantAggregates` (`shed`, `deferred`) and fleet-wide in `stats()`.

Against the reference's signature, `device=` is added (None = CUDA,
raising without a card; "cpu" = the plain path) and `kernel` and
`async_dispatch` are gone: the port's pool has one kernel route per
device and its advance always defers the control download. `shards`
and `features` pass through to the pool; `shards > 1` raises there
(ROADMAP queue A item 8).

CLI demo:
  PYTHONPATH=src python -m repro_torch.launch.serve --tenants 6
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api import Result, SessionPool, result_from_completions
from repro_torch.api.pool import PoolFullError
from repro_torch.api.session import CompletedCoflow
from repro_torch.core.coflow import Coflow
from repro_torch.core.params import SchedulerParams


class AdmissionError(RuntimeError):
    """The server is at its tenant admission cap."""


class QuotaExceededError(RuntimeError):
    """A submit was shed: it would exceed the tenant's quota and the
    tenant registered under ``policy="reject"``."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """A tenant's overload budget: live-load caps plus an SLO.

    `max_live_coflows` / `max_live_bytes` bound the tenant's live load
    (unfinished coflows on its row); a submit that would exceed either is
    shed (``policy="reject"``: the whole batch raises
    `QuotaExceededError`) or deferred (``policy="defer"``: the in-budget
    prefix is admitted, the overflow queues server-side and is retried on
    each `advance`). `slo` is the deferral deadline in tenant seconds: a
    deferred coflow older than it is shed."""
    max_live_coflows: Optional[int] = None
    max_live_bytes: Optional[float] = None
    slo: Optional[float] = None
    policy: str = "reject"

    def __post_init__(self):
        if self.policy not in ("reject", "defer"):
            raise ValueError(
                f"quota policy must be 'reject' or 'defer', "
                f"got {self.policy!r}")
        for name in ("max_live_coflows", "max_live_bytes", "slo"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")


@dataclasses.dataclass
class TenantAggregates:
    """Exact lifetime completion statistics, folded as completions are
    harvested (O(1) memory however long the tenant lives)."""
    coflows: int = 0
    flows: int = 0
    bytes: float = 0.0
    cct_sum: float = 0.0
    last_fct: float = -math.inf     # max absolute flow completion time
    trimmed: int = 0                # records dropped by history_limit
    shed: int = 0                   # coflows refused over quota/SLO
    deferred: int = 0               # coflows queued by policy="defer"

    def fold(self, comps: Sequence[CompletedCoflow]) -> None:
        for d in comps:
            self.coflows += 1
            self.flows += int(d.fct.size)
            if d.size is not None:
                self.bytes += float(np.sum(d.size))
            self.cct_sum += float(d.cct)
            if d.fct.size:
                self.last_fct = max(self.last_fct, float(np.max(d.fct)))

    @property
    def avg_cct(self) -> float:
        return self.cct_sum / self.coflows if self.coflows \
            else float("nan")

    @property
    def makespan(self) -> float:
        # a fold of zero-flow completions leaves last_fct at -inf
        if not math.isfinite(self.last_fct):
            return float("nan")
        return self.last_fct


@dataclasses.dataclass
class TenantResult(Result):
    """A tenant's normalized `Result`: `avg_cct`, `makespan`,
    `num_coflows` and `total_bytes` come from the exact lifetime
    aggregates, the per-coflow arrays from the retained (not yet polled)
    completion window."""
    agg: Optional[TenantAggregates] = None
    total_bytes: Optional[np.ndarray] = None   # (1,) lifetime bytes

    @property
    def avg_cct(self) -> np.ndarray:
        if self.agg is None:
            return Result.avg_cct.fget(self)
        return np.array([self.agg.avg_cct])

    @property
    def makespan(self) -> np.ndarray:
        if self.agg is None:
            return Result.makespan.fget(self)
        return np.array([self.agg.makespan])

    @staticmethod
    def from_window(window: Sequence[CompletedCoflow],
                    agg: TenantAggregates) -> "TenantResult":
        """Build from the retained window and the lifetime aggregates
        (counts lifted to the lifetime totals)."""
        base = result_from_completions(window, engine="torch",
                                       policy="saath")
        out = TenantResult(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(Result)},
            agg=agg if agg.coflows else None)
        if agg.coflows:
            out.num_coflows = np.array([agg.coflows])
            out.num_flows = np.array([agg.flows])
            out.total_bytes = np.array([agg.bytes])
        else:
            out.total_bytes = np.array([float(np.nansum(out.sent))])
        return out


class CoflowServer:
    """Admission-controlled multi-tenant coflow scheduling service.

    All tenants share one fabric (`num_ports` ports) and the pool's
    structure switches; each owns an isolated `SaathSession` row of the
    server's `SessionPool`, optionally under its own scheduler
    parameters, and its coflows never contend with another tenant's (the
    pool batches the computation, not the fabric). `history_limit`
    bounds the raw completions retained per tenant between polls.
    """

    def __init__(self, params: Optional[SchedulerParams] = None, *,
                 num_ports: int, max_tenants: int = 16,
                 mechanisms: Optional[dict] = None, chunk: int = 32,
                 history_limit: int = 4096, shards: int = 1,
                 features: Optional[tuple] = None, device=None):
        self.pool = SessionPool(params, num_ports=num_ports,
                                max_sessions=max_tenants,
                                mechanisms=mechanisms, chunk=chunk,
                                shards=shards, features=features,
                                device=device)
        self.history_limit = int(history_limit)
        self._tenants: Dict[str, object] = {}
        self._pending: Dict[str, List[CompletedCoflow]] = {}
        self._agg: Dict[str, TenantAggregates] = {}
        self._quota: Dict[str, Optional[TenantQuota]] = {}
        # policy="defer" overflow: (coflow, tenant clock at deferral)
        self._deferred: Dict[str, List[tuple]] = {}
        self._live_bytes: Dict[str, float] = {}
        self.rejected = 0

    # ---- admission -------------------------------------------------------

    @property
    def tenants(self) -> List[str]:
        return list(self._tenants)

    @property
    def occupancy(self) -> tuple:
        return (len(self._tenants), self.pool.max_sessions)

    def register(self, tenant: str,
                 params: Optional[SchedulerParams] = None,
                 mechanisms: Optional[dict] = None,
                 quota: Optional[TenantQuota] = None) -> None:
        """Admit a tenant (raises `AdmissionError` at the cap,
        `ValueError` on a duplicate name), optionally under its own
        `SchedulerParams`/mechanism switches and a `TenantQuota`."""
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} is already registered")
        try:
            # only the pool-full signal is an admission decision; any
            # other fault propagates as itself
            sess = self.pool.session(params=params, mechanisms=mechanisms)
        except PoolFullError as e:
            self.rejected += 1
            used, cap = self.occupancy
            raise AdmissionError(
                f"admission cap reached ({used}/{cap} tenants); evict "
                f"one or raise max_tenants") from e
        self._tenants[tenant] = sess
        self._pending[tenant] = []
        self._agg[tenant] = TenantAggregates()
        self._quota[tenant] = quota
        self._deferred[tenant] = []
        self._live_bytes[tenant] = 0.0

    def evict(self, tenant: str) -> None:
        """Release a tenant's row (unfinished coflows are dropped)."""
        sess = self._session(tenant)
        self.pool.release(sess)
        # deletes, not reads: the coherence checker holds every read of
        # `_pending` to a preceding harvest
        del self._tenants[tenant]
        del self._pending[tenant]
        del self._agg[tenant]
        del self._quota[tenant]
        del self._deferred[tenant]
        del self._live_bytes[tenant]

    def _session(self, tenant: str):
        try:
            return self._tenants[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}; registered: "
                f"{sorted(self._tenants)}") from None

    # ---- the tenant-keyed session surface --------------------------------

    def submit(self, tenant: str, coflows: Sequence[Coflow]) -> List[int]:
        """Submit coflows to a tenant's row, under its quota when one was
        registered: an over-budget batch is refused whole with
        `QuotaExceededError` (``policy="reject"``) or split, the
        in-budget prefix admitted now and the overflow deferred
        (``policy="defer"``). Returns the handles admitted now."""
        sess = self._session(tenant)
        quota = self._quota[tenant]
        coflows = list(coflows)
        if quota is None:
            handles = sess.submit(coflows)
            self._live_bytes[tenant] += sum(c.total_bytes for c in coflows)
            return handles
        agg = self._agg[tenant]
        fits = self._budget_room(tenant, coflows)
        if fits < len(coflows) and quota.policy == "reject":
            agg.shed += len(coflows)
            raise QuotaExceededError(
                f"tenant {tenant!r} over quota ({sess.num_live} live "
                f"coflows, {self._live_bytes[tenant]:.3g} live bytes); "
                f"batch of {len(coflows)} shed")
        admit, overflow = coflows[:fits], coflows[fits:]
        handles = sess.submit(admit) if admit else []
        self._live_bytes[tenant] += sum(c.total_bytes for c in admit)
        if overflow:
            now = sess.now
            self._deferred[tenant].extend((c, now) for c in overflow)
            agg.deferred += len(overflow)
        return handles

    def _budget_room(self, tenant: str, coflows: Sequence[Coflow]) -> int:
        """How many of `coflows` (in order) fit the tenant's quota now:
        the greedy prefix against the live-coflow and live-byte
        budgets."""
        quota = self._quota[tenant]
        live = self._tenants[tenant].num_live
        live_b = self._live_bytes[tenant]
        n = 0
        for c in coflows:
            if quota.max_live_coflows is not None and \
                    live + 1 > quota.max_live_coflows:
                break
            if quota.max_live_bytes is not None and \
                    live_b + c.total_bytes > quota.max_live_bytes:
                break
            live += 1
            live_b += c.total_bytes
            n += 1
        return n

    def _harvest(self, tenant: str) -> None:
        """Drain the session's fresh completions into the tenant's
        bounded pending buffer, folding the aggregates first."""
        done = self._tenants[tenant].poll()
        if not done:
            return
        agg = self._agg[tenant]
        before = agg.bytes
        agg.fold(done)
        self._live_bytes[tenant] = max(
            0.0, self._live_bytes[tenant] - (agg.bytes - before))
        pend = self._pending[tenant]
        pend.extend(done)
        if len(pend) > self.history_limit:
            drop = len(pend) - self.history_limit
            del pend[:drop]
            agg.trimmed += drop

    def advance(self, dt: float) -> float:
        """Advance every tenant's clock by `dt` with one pooled advance,
        harvest the tenants whose rows completed something (the pool's
        new-completion index), then retry the deferred submissions."""
        self.pool.advance(dt)
        fresh = {id(s) for s in self.pool.completed_sessions()}
        if fresh:
            for tenant, sess in self._tenants.items():
                if id(sess) in fresh:
                    self._harvest(tenant)
        self._admit_deferred()
        return dt

    def _admit_deferred(self) -> None:
        """Retry each tenant's deferred queue in deferral order: entries
        older than the quota's SLO are shed, the rest admitted while the
        freed budget lasts (arrivals clamp to the tenant clock)."""
        for tenant, queue in self._deferred.items():
            if not queue:
                continue
            sess = self._tenants[tenant]
            quota = self._quota[tenant]
            agg = self._agg[tenant]
            now = sess.now
            keep: List[tuple] = []
            blocked = False
            for c, t_defer in queue:
                if quota.slo is not None and now - t_defer > quota.slo:
                    agg.shed += 1
                    continue
                if not blocked and self._budget_room(tenant, [c]):
                    sess.submit([c])
                    self._live_bytes[tenant] += c.total_bytes
                else:
                    blocked = True    # keep the order: nothing younger
                    keep.append((c, t_defer))  # jumps ahead
            self._deferred[tenant] = keep

    def poll(self, tenant: str) -> List[CompletedCoflow]:
        """Completions for `tenant` not yet returned by a poll; returned
        records leave the server (their statistics stay in
        `aggregates(tenant)`)."""
        self._session(tenant)
        self._harvest(tenant)
        out = self._pending[tenant]
        self._pending[tenant] = []
        return out

    def num_live(self, tenant: str) -> int:
        return self._session(tenant).num_live

    def aggregates(self, tenant: str) -> TenantAggregates:
        """The tenant's exact lifetime completion statistics."""
        self._session(tenant)
        self._harvest(tenant)
        return self._agg[tenant]

    def result(self, tenant: str) -> Result:
        """The tenant's completions as a normalized `Result` (an idle
        tenant reports NaN aggregates, never 0.0). Does not move the
        `poll` cursor: `avg_cct`/`makespan`/`num_coflows` cover the whole
        registration, the per-coflow arrays the retained window."""
        self._session(tenant)
        self._harvest(tenant)
        return TenantResult.from_window(self._pending[tenant],
                                        self._agg[tenant])

    def stats(self) -> dict:
        used, cap = self.occupancy
        return {
            "tenants": used, "max_tenants": cap,
            "rejected": self.rejected,
            "live_coflows": sum(s.num_live for s in self._tenants.values()),
            "completed": sum(a.coflows for a in self._agg.values()),
            "retained": sum(len(p) for p in self._pending.values()),
            "shed": sum(a.shed for a in self._agg.values()),
            "deferred": sum(a.deferred for a in self._agg.values()),
            "deferred_pending": sum(len(q)
                                    for q in self._deferred.values()),
            "shards": self.pool.shards,
            "slab": (self.pool._C_cap, self.pool._F_cap),
        }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="multi-tenant coflow serving demo")
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--max-tenants", type=int, default=4,
                    help="admission cap (< --tenants demonstrates "
                    "rejection and eviction)")
    ap.add_argument("--seconds", type=float, default=0.4,
                    help="virtual horizon per tenant")
    ap.add_argument("--ports", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the slab lives (default: the CUDA card; "
                    "'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from repro_torch.traces.synth import tiny_trace

    params = SchedulerParams(port_bw=1e9, delta=1e-3, start_threshold=1e6)
    srv = CoflowServer(params, num_ports=args.ports,
                       max_tenants=args.max_tenants, device=args.device)
    t0 = time.perf_counter()
    waiting = [f"tenant/{i}" for i in range(args.tenants)]
    admitted: List[str] = []
    pending: Dict[str, list] = {}
    for i, name in enumerate(list(waiting)):
        try:
            srv.register(name)
        except AdmissionError:
            continue
        waiting.remove(name)
        admitted.append(name)
        tr = tiny_trace(16, args.ports, seed=args.seed + i, load=0.5)
        pending[name] = sorted(tr.coflows, key=lambda c: c.arrival)

    steps = 0
    next_seed = args.seed + args.tenants
    while admitted or waiting:
        srv.advance(args.seconds / 8)
        steps += 1
        for name in list(admitted):
            sess = srv._tenants[name]
            while pending[name] and pending[name][0].arrival <= sess.now:
                srv.submit(name, [pending[name].pop(0)])
            if not pending[name] and srv.num_live(name) == 0:
                res = srv.result(name)
                print(f"  {name}: {int(res.num_coflows[0])} coflows, "
                      f"avg_cct={res.avg_cct[0] * 1e3:.2f}ms, "
                      f"makespan={res.makespan[0] * 1e3:.1f}ms")
                srv.evict(name)       # frees the row for a waiter
                admitted.remove(name)
                if waiting:
                    nxt = waiting.pop(0)
                    srv.register(nxt)
                    admitted.append(nxt)
                    tr = tiny_trace(16, args.ports, seed=next_seed,
                                    load=0.5)
                    next_seed += 1
                    pending[nxt] = sorted(tr.coflows,
                                          key=lambda c: c.arrival)
        if steps > 10000:
            raise RuntimeError("demo failed to drain")
    wall = time.perf_counter() - t0
    out = dict(srv.stats(), wall_seconds=wall, steps=steps,
               device=str(srv.pool.device))
    print(f"== served {args.tenants} tenants through a "
          f"{args.max_tenants}-row slab on {out['device']} in {wall:.2f}s "
          f"({steps} fleet steps; slab {out['slab']}) ==")
    return out


if __name__ == "__main__":
    main()

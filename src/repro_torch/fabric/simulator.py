"""Event-driven fabric simulator (the paper's §6 simulation plane).

The port's own copy of `repro.fabric.engine` (named `simulator` here
because the port's `fabric.engine` is the batched tensor replay, the
counterpart of `repro.fabric.jax_engine`).

Faithful to the paper's coordinator model: the schedule is recomputed on
the δ grid; between recomputations ports follow the current rates.  For
speed the simulator is *event-driven*: it jumps directly to the next
time the schedule could change — a coflow arrival, a flow completion, a
queue-threshold crossing, a starvation deadline — then quantizes that
instant UP to the δ grid (a new schedule only takes effect at the next
coordinator tick, exactly like the prototype's pipelined coordinator).
A flow finishing mid-interval leaves its ports idle until the next tick,
reproducing the δ-sensitivity of Fig. 14(c).

Flow completion times are recorded exactly (not grid-quantized): rates
are constant inside an interval so the completion instant is algebraic.

The bookkeeping is host numpy in f64, as in the reference, so a replay's
results equal the reference's bit for bit; the policies' kernel work
(the contention count, `saath-torch`'s tick) runs on their `device`,
and `SimResult` reports the kernel launches and host<->device bytes the
run made.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core import transfer
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.state import FlowTable
from repro_torch.kernels import ops

if TYPE_CHECKING:  # avoid circular import (policies import fabric.state)
    from repro_torch.core.policies.base import Policy


@dataclasses.dataclass
class SimResult:
    table: FlowTable
    steps: int            # scheduler invocations
    wall_seconds: float   # host time spent simulating
    sched_seconds: float  # host time spent inside policy.schedule
    makespan: float       # last ABSOLUTE flow completion time (not a
    #                       CCT — CCTs are arrival-relative durations);
    #                       NaN when no flow finished — the same
    #                       "nothing completed" value the tensor plane
    #                       and the repro_torch.api.Result normalizer
    #                       report, so
    #                       an empty replay can't masquerade as a
    #                       zero-second one
    launches: dict = dataclasses.field(default_factory=dict)
    #                       kernel launches during the run, by kernel
    io: dict = dataclasses.field(default_factory=dict)
    #                       host<->device bytes and copies during the run
    #                       (`core.transfer`; none on the CPU)

    @property
    def cct(self) -> np.ndarray:
        return self.table.cct

    @property
    def avg_cct(self) -> float:
        """Mean CCT over finished coflows; NaN when none finished (no
        all-NaN RuntimeWarning), matching the tensor plane's semantics."""
        from repro_torch.fabric.metrics import nan_row_mean

        return float(nan_row_mean(self.table.cct[None, :])[0])


def _quantize_up(t: float, delta: float) -> float:
    k = math.ceil(t / delta - 1e-9)
    return k * delta


def integrate_interval(table: FlowTable, rates: np.ndarray,
                       live: np.ndarray, now: float,
                       t_next: float) -> None:
    """Advance `table` at constant `rates` across [now, t_next): record
    exact (algebraic) flow completion instants, first-schedule times,
    and coflow completions (CCT = last FCT - arrival). Shared by
    `Simulator.run` and the online `repro_torch.api.SaathSession` numpy
    backend so the two replay loops cannot drift."""
    served = live & (rates > 0)
    table.first_sched[served & np.isnan(table.first_sched)] = now

    adv = rates * (t_next - now)
    rem = table.size - table.sent
    fin = live & (adv >= rem - 1e-9) & (rates > 0)
    if fin.any():
        table.fct[fin] = now + rem[fin] / rates[fin]
        table.done[fin] = True
        table.sent[fin] = table.size[fin]
    grow = live & ~fin
    table.sent[grow] = np.minimum(table.size[grow],
                                  table.sent[grow] + adv[grow])
    table.rate[:] = rates

    if fin.any():
        for c in np.unique(table.cid[fin]):
            lo, hi = table.flow_lo[c], table.flow_hi[c]
            if table.done[lo:hi].all() and not table.finished[c]:
                table.finished[c] = True
                table.active[c] = False
                last = float(np.nanmax(table.fct[lo:hi]))
                table.cct[c] = last - table.arrival[c]


class Simulator:
    """Replays a FlowTable under a Policy.

    max_jump bounds the event horizon so policies whose priorities drift
    continuously (e.g. SRTF remaining-bytes swaps) are re-evaluated at
    least every `max_jump` seconds even with no discrete event.
    """

    def __init__(self, params: SchedulerParams, *,
                 max_jump: Optional[float] = None,
                 max_steps: int = 50_000_000,
                 topology=None):
        self.params = params
        self.max_jump = max_jump if max_jump is not None else 200 * params.delta
        self.max_steps = max_steps
        # fabric model (fabric.topology); None keeps the policy's own
        # (default BigSwitch — the pre-refactor per-port arithmetic)
        self.topology = topology

    # ---- event horizon ---------------------------------------------------
    def _next_event(self, table: FlowTable, policy: Policy, now: float,
                    rates: np.ndarray, next_arrival: float) -> float:
        live = table.flow_live()
        t = next_arrival
        # flow completions at current rates
        srv = live & (rates > 0)
        if srv.any():
            t_fin = now + (table.size[srv] - table.sent[srv]) / rates[srv]
            t = min(t, float(t_fin.min()))
        # policy-internal events (queue-threshold crossings, deadlines)
        t = min(t, policy.progress_events(table, now, rates))
        t = min(t, now + self.max_jump)
        return t

    def _activate(self, table: FlowTable, now: float) -> None:
        dep_ok = np.ones(table.num_coflows, bool)
        if table.deps is not None:
            dep_ok = table.deps_satisfied()
        table.active[:] = ((table.arrival <= now + 1e-12) & ~table.finished
                           & dep_ok)

    def run(self, table: FlowTable, policy: Policy) -> SimResult:
        p = self.params
        t0 = time.perf_counter()
        sched_s = 0.0
        if self.topology is not None:
            policy.topology = self.topology
        launches0, io0 = ops.launch_counts(), transfer.counts()
        policy.reset(table)

        arrivals = np.sort(np.unique(table.arrival))
        if arrivals.size == 0:
            return SimResult(table, 0, 0.0, 0.0, float("nan"))
        now = _quantize_up(float(arrivals[0]), p.delta)
        steps = 0

        while steps < self.max_steps:
            self._activate(table, now)
            if table.finished.all():
                break
            live = table.flow_live()
            future = arrivals[arrivals > now + 1e-12]
            next_arrival = float(future[0]) if future.size else math.inf
            if not live.any():
                if math.isinf(next_arrival):
                    # DAG deps may unlock coflows without new arrivals
                    if not table.finished.all():
                        raise RuntimeError("simulator stalled: unfinished "
                                           "coflows with no live flows")
                    break
                now = _quantize_up(next_arrival, p.delta)
                continue

            s0 = time.perf_counter()
            rates = policy.schedule(table, now)
            sched_s += time.perf_counter() - s0
            steps += 1

            t_ev = self._next_event(table, policy, now, rates, next_arrival)
            if math.isinf(t_ev):
                raise RuntimeError(
                    f"simulator deadlock at t={now:.3f}: no rates, no events "
                    f"({int(live.sum())} live flows)")
            t_next = max(_quantize_up(t_ev, p.delta), now + p.delta)
            integrate_interval(table, rates, live, now, t_next)
            now = t_next
        else:
            raise RuntimeError("simulator exceeded max_steps")

        # last absolute FCT; guard the all-NaN case (nothing finished)
        # instead of letting np.nanmax emit a RuntimeWarning
        fin_fct = table.fct[np.isfinite(table.fct)]
        makespan = float(fin_fct.max()) if fin_fct.size else float("nan")
        launches = {k: v - launches0[k]
                    for k, v in ops.launch_counts().items()}
        io = {k: v - io0[k] for k, v in transfer.counts().items()}
        return SimResult(table, steps, time.perf_counter() - t0, sched_s,
                         makespan, launches, io)

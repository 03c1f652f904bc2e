"""Aalo (Chowdhury & Stoica, SIGCOMM'15) — the paper's main baseline.

Global coordinator assigns coflows to exponential priority queues by
TOTAL bytes sent; each port schedules its local flows strict-priority
across queues, FIFO (coflow arrival order) within a queue (§2.2).
The port's own copy of `repro.core.policies.aalo` (host numpy f64).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import queues
from repro_torch.core.policies.base import Policy, greedy_flow_alloc
from repro_torch.fabric.state import FlowTable


class Aalo(Policy):
    name = "aalo"

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        if not live.any():
            return np.zeros(table.size.shape[0])
        q = queues.aalo_queue(table.coflow_sent_total(), self.params)
        # flow order: (queue, coflow arrival, flow id)
        order = np.lexsort((np.arange(live.shape[0]),
                            table.arrival[table.cid], q[table.cid]))
        return greedy_flow_alloc(table, order, live,
                                 extra=self.fabric_binding(table))

    def progress_events(self, table: FlowTable, now: float,
                        rates: np.ndarray) -> float:
        """Earliest total-bytes queue-threshold crossing under `rates`."""
        R = np.bincount(table.cid, weights=rates,
                        minlength=table.num_coflows)
        total = table.coflow_sent_total()
        th = np.array(self.params.thresholds())
        q = queues.aalo_queue(total, self.params)
        nxt = th[q]  # Q_q^hi; inf in last queue
        with np.errstate(divide="ignore", invalid="ignore"):
            dt = np.where((R > 0) & np.isfinite(nxt) & table.active,
                          (nxt - total) / R, np.inf)
        dt = dt[dt > 1e-12]
        return now + float(dt.min()) if dt.size else float("inf")


class CoordinatedFifo(Policy):
    """Single global FIFO by coflow arrival (no queues) — the ordering D5's
    deadlines are derived from; also a baseline."""

    name = "fifo"

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        if not live.any():
            return np.zeros(table.size.shape[0])
        order = np.lexsort((np.arange(live.shape[0]),
                            table.arrival[table.cid]))
        return greedy_flow_alloc(table, order, live,
                                 extra=self.fabric_binding(table))

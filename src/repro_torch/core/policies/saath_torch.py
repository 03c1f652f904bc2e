"""The event-driven host plane driving the port's coordinator tick, one
tick at a time (`saath-torch`).

The counterpart of `repro.core.policies.saath_jax`: each `schedule` call
builds the tick's views of the flow table on the host, exactly as the
reference's `saath-jax` does (the arrival rank by a stable double
argsort; m, total and the §4.3 inputs summed in f64 and cast to f32;
the per-flow view with each coflow's [flow_lo, flow_hi) segment), sends
to `self.device` what changes tick to tick (the trace's fixed views go
up once, in `reset`), runs `core.coordinator.schedule_tick` there (K1,
K2 and, under `LeafSpine(wc_fill="maxmin")`, K3 on the card) and maps
the coflow rates back to the live flows, plus the work-conservation
rates of single flows. On a leaf-spine fabric it also builds the
per-(coflow, link) live counts and link capacities the tick's MADD
reads (the reference's `saath-jax` ignores the fabric; this policy
allocates against it, like the numpy `Saath`).

No axis is padded: eager PyTorch does not recompile on a new shape,
and none of the tick's kernels needs a padded C or F.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams
from repro_torch.core.policies.base import Policy
from repro_torch.core.policies.saath import (deadline_event,
                                             median_estimate,
                                             threshold_event)
from repro_torch.core.transfer import download, upload
from repro_torch.fabric.state import FlowTable
from repro_torch.fabric.topology import wc_fill_of

F32, I64, B8 = torch.float32, torch.int64, torch.bool


def _row(x, device, dtype) -> torch.Tensor:
    """A host array as one lane (a leading axis of 1) on `device`."""
    return upload(np.asarray(x)[None], device, dtype)


class SaathTorch(Policy):
    name = "saath-torch"

    def __init__(self, params: SchedulerParams, *,
                 work_conservation: bool | None = None, device=None):
        super().__init__(params, device=device)
        cp = co.CoordParams.from_params(params)
        if work_conservation is not None:
            cp = cp._replace(work_conservation=work_conservation)
        self.cp = cp

    def reset(self, table: FlowTable) -> None:
        """A fresh coordinator state, and the views that stay fixed for
        the whole trace uploaded once: the arrival rank, widths, port
        bandwidths, the per-flow view's ids and segments and, on a
        leaf-spine fabric, link capacities and the walk's link ids."""
        dev = self.device
        self._state = co.init_state(1, table.num_coflows, dev)

        def up(x, dtype):
            return _row(x, dev, dtype)

        rank = np.argsort(np.argsort(table.arrival, kind="stable"),
                          kind="stable")
        self._fixed = dict(
            arrival=up(rank, I64), width=up(table.width, I64),
            bw_s=up(table.bw_send.astype(np.float32), F32),
            bw_r=up(table.bw_recv.astype(np.float32), F32))
        self._fixed_flows = dict(
            cid=up(table.cid, I64), src=up(table.src, I64),
            dst=up(table.dst, I64), flow_lo=up(table.flow_lo, I64),
            flow_hi=up(table.flow_hi, I64), up=None, dn=None)
        self._extra = self.fabric_binding(table)
        extra = self._extra
        if extra is not None:
            Lf = extra.num_uplinks
            self._fixed["bw_x"] = up(extra.cap, F32)
            # the walk's link ids: the local leaf, Lf = "no shared link"
            self._fixed_flows.update(
                up=up(np.where(extra.up >= 0, extra.up, Lf), I64),
                dn=up(np.where(extra.dn >= 0, extra.dn - Lf, Lf), I64))

    def _views(self, table: FlowTable):
        """The tick's inputs: the fixed views of `reset`, and what
        changes tick to tick (active, live, the port and link counts,
        m, total and the §4.3 inputs) uploaded now."""
        dev = self.device
        live = table.flow_live()
        cnt_s, cnt_r = table.flow_counts(live)

        def up(x, dtype):
            return _row(x, dev, dtype)

        C = table.num_coflows
        mixed, m_dyn = ((np.zeros(C, bool), np.zeros(C))
                        if not self.cp.dynamics_requeue
                        else median_estimate(table, live))
        links = {}
        extra = self._extra
        if extra is not None:
            cnt_x = np.zeros((C, 2 * extra.num_uplinks), np.float32)
            lf = live & (extra.up >= 0)
            np.add.at(cnt_x, (table.cid[lf], extra.up[lf]), 1)
            np.add.at(cnt_x, (table.cid[lf], extra.dn[lf]), 1)
            links = dict(cnt_x=up(cnt_x, F32))
        batch = co.CoflowBatch(
            active=up(table.active, B8),
            m=up(table.coflow_max_flow_sent().astype(np.float32), F32),
            cnt_s=up(cnt_s.astype(np.float32), F32),
            cnt_r=up(cnt_r.astype(np.float32), F32),
            total=up(table.coflow_sent_total().astype(np.float32), F32),
            mixed=up(mixed, B8), m_dyn=up(m_dyn.astype(np.float32), F32),
            **links, **self._fixed)
        flows = co.FlowView(live=up(live, B8), **self._fixed_flows)
        return batch, flows

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        batch, flows = self._views(table)
        self._state, out = co.schedule_tick(
            self._state, batch, upload(np.float32([now]), self.device),
            cp=self.cp, flows=flows, wc_fill=wc_fill_of(self.topology))
        C = table.num_coflows
        # one download: the coflow rates, then the flows' fill rates
        got = download(torch.cat([out["rate"][0], out["wc_flow"][0]]))
        rates = got[:C].astype(np.float64)[table.cid]
        rates[~table.flow_live()] = 0.0
        rates += got[C:].astype(np.float64)
        self._last_out = out
        return rates

    def progress_events(self, table: FlowTable, now: float,
                        rates: np.ndarray) -> float:
        # numpy Saath's per-flow-threshold and deadline events; the
        # state's queue and deadline come back in one download (the
        # queue indices are exact in f32)
        qd = download(torch.stack([self._state.queue[0].to(F32),
                                   self._state.deadline[0]]))
        t = threshold_event(table, qd[0].astype(np.int64),
                            np.array(self.params.thresholds()),
                            table.flow_live(), rates, now)
        return min(t, deadline_event(qd[1], table.active, now))


__all__ = ["SaathTorch"]

"""SAATH (the paper's contribution): all-or-none + per-flow queue
thresholds + LCoF + work conservation + starvation deadlines + §4.3
cluster-dynamics (approximate-SRTF) re-queueing.

The port's own copy of `repro.core.policies.saath`: the event-driven
host coordinator, in f64 numpy, with its LCoF contention count on
`self.device` (`core.contention`: kernel K1 on the card, exact
integers). `core.coordinator` is the batched tensor tick (and
`saath-torch` drives it one tick at a time).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import queues
from repro_torch.core.contention import contention
from repro_torch.core.params import SchedulerParams
from repro_torch.core.sampling import SizeEstimator
from repro_torch.core.policies.base import (Policy, greedy_flow_alloc,
                                            maxmin_waterfill)
from repro_torch.fabric.state import FlowTable


class Saath(Policy):
    name = "saath"

    def __init__(self, params: SchedulerParams, *, all_or_none: bool = True,
                 per_flow_threshold: bool = True, lcof: bool = True,
                 work_conservation: bool | None = None, device=None):
        super().__init__(params, device=device)
        # ablation switches (Fig. 10: A/N, A/N+PF, full SAATH);
        # work_conservation defaults to the SchedulerParams field so the
        # numpy reference and the jitted planes read one knob
        self.all_or_none = all_or_none
        self.per_flow_threshold = per_flow_threshold
        self.lcof = lcof
        self.work_conservation = (params.work_conservation
                                  if work_conservation is None
                                  else work_conservation)
        # non-clairvoyant mode: pilot-flow size learning (sampling.py)
        self.estimator = (None if params.clairvoyant
                          else SizeEstimator(params))

    def reset(self, table: FlowTable) -> None:
        C = table.num_coflows
        self._queue = np.full(C, -1, np.int32)     # -1 = not yet seen
        self._deadline = np.full(C, np.inf)
        self._running = np.zeros(C, bool)  # admitted in the last schedule
        self.stats_deadline_hits = 0
        self.stats_admitted = 0
        self.stats_wc_flows = 0

    # ---- queue assignment (D3 + §4.3) -----------------------------------
    def _assign_queues(self, table: FlowTable, now: float) -> np.ndarray:
        p = self.params
        if self.per_flow_threshold:
            q_new = queues.saath_queue(table.coflow_max_flow_sent(),
                                       table.width, p)
        else:
            q_new = queues.aalo_queue(table.coflow_sent_total(), p)

        if p.dynamics_requeue and p.clairvoyant:
            # §4.3: once some flows finished, estimate remaining length from
            # the median finished-flow length and re-queue by Eq. 1 — this can
            # move a coflow back UP the queues (approximate SRTF).
            mixed, m_hat = median_estimate(table, table.flow_live())
            for c in np.nonzero(mixed)[0]:
                q_new[c] = queues.saath_queue(
                    m_hat[c:c + 1], table.width[c:c + 1], p)[0]
        elif p.dynamics_requeue:
            # non-clairvoyant §4.3: the re-queue runs off the pilot-flow
            # estimate (mean finished-pilot size) instead of the exact
            # finished-flow median; coflows whose pilots are all still in
            # flight keep their bytes-sent Eq. 1 placement above.
            live = table.flow_live()
            est_flow, _, learned = self.estimator.estimates(table)
            has_live = np.bincount(table.cid[live],
                                   minlength=table.num_coflows) > 0
            mixed = learned & has_live & table.active
            if mixed.any():
                for c in np.nonzero(mixed)[0]:
                    lo, hi = table.flow_lo[c], table.flow_hi[c]
                    fdone = table.done[lo:hi]
                    rem = np.maximum(
                        est_flow[c] - table.sent[lo:hi][~fdone], 0.0)
                    m_hat = float(rem.max()) if rem.size else 0.0
                    q_new[c] = queues.saath_queue(
                        np.array([m_hat]), table.width[c:c + 1], p)[0]
        return q_new

    # ---- deadlines (D5) ---------------------------------------------------
    def _refresh_deadlines(self, table: FlowTable, q_new: np.ndarray,
                           now: float) -> None:
        p = self.params
        entered = table.active & (q_new != self._queue)
        if entered.any():
            cq = np.bincount(q_new[table.active], minlength=p.num_queues)
            t_min = queues.min_queue_residence(q_new, table.width, p)
            for c in np.nonzero(entered)[0]:
                self._deadline[c] = now + (
                    p.deadline_factor * max(cq[q_new[c]], 1) * t_min[c])
        self._queue = np.where(table.active, q_new, self._queue)

    # ---- the Fig. 7 schedule ---------------------------------------------
    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        p = self.params
        live = table.flow_live()
        rates = np.zeros(table.size.shape[0])
        if not live.any():
            return rates

        q_new = self._assign_queues(table, now)
        self._refresh_deadlines(table, q_new, now)

        active = table.active.copy()
        A_s, A_r = table.incidence(live)
        k = contention(A_s, A_r, active, device=self.device)
        expired = active & (now >= self._deadline)
        self.stats_deadline_hits += int(expired.sum())

        # LCoF order: deadline-expired first (FIFO-by-deadline among them),
        # then (queue, contention, stability, arrival). Fig.7 lines 2-4.
        # 'stability' prefers coflows admitted in the previous schedule on
        # exact (queue, contention) ties — local agents follow the current
        # schedule until told otherwise (§5), so ties do not cause churn.
        # expired deadline TIES break by arrival (then index): same
        # tick + same queue + same width gives exactly equal deadlines,
        # and both planes must resolve them by a layout-independent
        # order — the jitted coordinator's slab position is a session's
        # submission order, not this table's cid order.
        cids = np.nonzero(active)[0]
        if self.lcof:
            key = [(0, self._deadline[c], 0, 0, table.arrival[c], c)
                   if expired[c] else
                   (1, q_new[c], k[c], int(~self._running[c]),
                    table.arrival[c], c) for c in cids]
        else:  # FIFO within queue (the A/N-only ablation)
            key = [(0, self._deadline[c], 0, 0, table.arrival[c], c)
                   if expired[c] else
                   (1, q_new[c], table.arrival[c], 0, 0, c) for c in cids]
        order = cids[sorted(range(len(cids)), key=lambda i: key[i])]

        cnt_s, cnt_r = table.flow_counts(live)
        avail_s = table.bw_send.copy()
        avail_r = table.bw_recv.copy()
        # fabric model (DESIGN.md §11): on a leaf-spine topology the
        # MADD rate is also capped by the coflow's per-uplink/downlink
        # flow counts against residual link capacity; `extra is None`
        # (big switch) keeps every line below bitwise pre-refactor
        extra = self.fabric_binding(table)
        avail_x = cnt_x = None
        if extra is not None:
            avail_x = extra.cap.copy()
            cnt_x = np.zeros((table.num_coflows, avail_x.shape[0]),
                             np.int64)
            lf = live & (extra.up >= 0)
            np.add.at(cnt_x, (table.cid[lf], extra.up[lf]), 1)
            np.add.at(cnt_x, (table.cid[lf], extra.dn[lf]), 1)
        admitted = np.zeros(table.num_coflows, bool)
        missed = []
        for c in order:
            cs, cr = cnt_s[c], cnt_r[c]
            ps, pr = cs > 0, cr > 0
            if not ps.any() and not pr.any():
                continue
            # MADD equal rate (D2): slowest-port rate for every flow
            r = np.inf
            if ps.any():
                r = min(r, (avail_s[ps] / cs[ps]).min())
            if pr.any():
                r = min(r, (avail_r[pr] / cr[pr]).min())
            if extra is not None:
                cx = cnt_x[c]
                px = cx > 0
                if px.any():
                    r = min(r, (avail_x[px] / cx[px]).min())
            if self.all_or_none and r < p.min_rate:
                missed.append(c)
                continue
            if r <= 0.0:
                missed.append(c)
                continue
            lo, hi = table.flow_lo[c], table.flow_hi[c]
            seg = rates[lo:hi]
            seg[live[lo:hi]] = r
            avail_s -= r * cs
            avail_r -= r * cr
            if extra is not None:
                avail_x -= r * cnt_x[c]
            admitted[c] = True
            self.stats_admitted += 1

        if self.work_conservation and missed:
            # D4 lines 18-23: per-flow greedy fill of leftover bandwidth, in
            # the missed-coflow order (the 'ordered list of the un-scheduled
            # CoFlows'). A LeafSpine(wc_fill="maxmin") topology fills the
            # leftovers by max-min water-filling instead — the allocation
            # family of the in-network papers.
            wc_order = np.concatenate(
                [np.arange(table.flow_lo[c], table.flow_hi[c])
                 for c in missed])
            before = rates > 0
            if extra is not None and \
                    getattr(self.topology, "wc_fill", "greedy") == "maxmin":
                cand = np.zeros(live.shape, bool)
                cand[wc_order] = True
                cand &= live
                rates += maxmin_waterfill(
                    table, cand, extra=extra, avail_s=avail_s,
                    avail_r=avail_r, avail_x=avail_x)
            else:
                greedy_flow_alloc(table, wc_order, live, avail_s, avail_r,
                                  rates, extra=extra, avail_x=avail_x)
            self.stats_wc_flows += int(((rates > 0) & ~before).sum())

        if p.wc_admitted_round:
            # beyond-paper: raise the equal rate of admitted coflows when all
            # of their ports still have slack (keeps MADD equal-rate shape).
            for c in order:
                cs, cr = cnt_s[c], cnt_r[c]
                ps, pr = cs > 0, cr > 0
                if not (ps.any() or pr.any()) or c in missed:
                    continue
                r = np.inf
                if ps.any():
                    r = min(r, (avail_s[ps] / cs[ps]).min())
                if pr.any():
                    r = min(r, (avail_r[pr] / cr[pr]).min())
                if extra is not None:
                    cx = cnt_x[c]
                    px = cx > 0
                    if px.any():
                        r = min(r, (avail_x[px] / cx[px]).min())
                if not np.isfinite(r) or r <= 0.0:
                    continue
                sel = live & (table.cid == c)
                rates[sel] += r
                avail_s -= r * cs
                avail_r -= r * cr
                if extra is not None:
                    avail_x -= r * cnt_x[c]

        self._running = admitted
        return rates

    # ---- simulator event hook ---------------------------------------------
    def progress_events(self, table: FlowTable, now: float,
                        rates: np.ndarray) -> float:
        """Earliest of (a) a per-flow queue-threshold crossing, (b) a
        starvation-deadline expiry, under constant `rates`."""
        p = self.params
        live = table.flow_live()
        t = float("inf")
        th = np.array(p.thresholds())
        if self.per_flow_threshold:
            t = min(t, threshold_event(table, self._queue, th, live,
                                       rates, now))
        else:
            R = np.bincount(table.cid, weights=rates,
                            minlength=table.num_coflows)
            total = table.coflow_sent_total()
            q = np.where(self._queue < 0, 0, self._queue)
            nxt = th[q]
            with np.errstate(divide="ignore", invalid="ignore"):
                dt = np.where((R > 0) & np.isfinite(nxt) & table.active,
                              (nxt - total) / R, np.inf)
            dt = dt[dt > 1e-12]
            if dt.size:
                t = min(t, now + float(dt.min()))
        return min(t, deadline_event(self._deadline, table.active, now))


def median_estimate(table: FlowTable, live: np.ndarray):
    """The clairvoyant §4.3 estimate: which active coflows hold both
    finished and live flows (`mixed`), and for each of them the
    remaining length of its longest live flow if every flow is as long
    as the median finished one (`m_hat`, f64; 0 elsewhere)."""
    C = table.num_coflows
    done_f = table.done & table.active[table.cid]
    has_done = np.bincount(table.cid[done_f], minlength=C) > 0
    has_live = np.bincount(table.cid[live], minlength=C) > 0
    mixed = has_done & has_live & table.active
    m_hat = np.zeros(C)
    for c in np.nonzero(mixed)[0]:
        lo, hi = table.flow_lo[c], table.flow_hi[c]
        fdone = table.done[lo:hi]
        f_e = float(np.median(table.size[lo:hi][fdone]))
        rem = np.maximum(f_e - table.sent[lo:hi][~fdone], 0.0)
        m_hat[c] = float(rem.max()) if rem.size else 0.0
    return mixed, m_hat


def threshold_event(table: FlowTable, queue: np.ndarray, th: np.ndarray,
                    live: np.ndarray, rates: np.ndarray,
                    now: float) -> float:
    """The earliest per-flow queue-threshold crossing under constant
    `rates`: flow f of coflow c crosses when sent_f reaches
    Q_q^hi / N_c (`queue` per coflow, -1 = not yet seen)."""
    q = queue[table.cid]
    q = np.where(q < 0, 0, q)
    lim = th[q] / np.maximum(table.width[table.cid], 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        dt = np.where(live & (rates > 0) & np.isfinite(lim),
                      (lim - table.sent) / rates, np.inf)
    dt = dt[dt > 1e-12]
    return now + float(dt.min()) if dt.size else float("inf")


def deadline_event(deadline: np.ndarray, active: np.ndarray,
                   now: float) -> float:
    """The earliest starvation deadline of an active coflow after `now`."""
    dl = deadline[active & (deadline > now + 1e-12)]
    return float(dl.min()) if dl.size else float("inf")

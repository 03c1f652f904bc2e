"""Clairvoyant baselines (flow sizes known a-priori): SCF, SRTF, LWTF
(§2.4 / Fig. 3) and Varys' SEBF+MADD (§6.1 / Fig. 9). The port's own
copy of `repro.core.policies.offline`; LWTF's contention count runs on
`self.device` (`core.contention`, kernel K1 on the card)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.contention import contention
from repro_torch.core.policies.base import (Policy, coflow_flow_order,
                                            greedy_flow_alloc)
from repro_torch.fabric.state import FlowTable


def _port_remaining(table: FlowTable, live: np.ndarray):
    """(C,P) remaining bytes at sender / receiver ports."""
    rem = np.where(live, table.size - table.sent, 0.0)
    C, P = table.num_coflows, table.num_ports
    rem_s = np.zeros((C, P))
    rem_r = np.zeros((C, P))
    np.add.at(rem_s, (table.cid, table.src), rem)
    np.add.at(rem_r, (table.cid, table.dst), rem)
    return rem_s, rem_r


def _rank_rates(table: FlowTable, live: np.ndarray, key: np.ndarray,
                extra=None):
    rank = np.argsort(np.argsort(key, kind="stable"), kind="stable")
    order = coflow_flow_order(table, rank)
    return greedy_flow_alloc(table, order, live, extra=extra)


class SCF(Policy):
    """Shortest-CoFlow-First by static total size."""

    name = "scf"
    clairvoyant = True

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        if not live.any():
            return np.zeros(table.size.shape[0])
        total = np.bincount(table.cid, weights=table.size,
                            minlength=table.num_coflows)
        key = np.where(table.active, total, np.inf)
        return _rank_rates(table, live, key,
                           extra=self.fabric_binding(table))


class SRTF(Policy):
    """Shortest-Remaining-Time-First by total remaining bytes."""

    name = "srtf"
    clairvoyant = True

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        if not live.any():
            return np.zeros(table.size.shape[0])
        rem = np.bincount(table.cid, weights=np.where(live, table.size -
                                                      table.sent, 0.0),
                          minlength=table.num_coflows)
        key = np.where(table.active, rem, np.inf)
        return _rank_rates(table, live, key,
                           extra=self.fabric_binding(table))


class LWTF(Policy):
    """Least-Waiting-Time-First: order by t_c * k_c (§2.4) where t_c is the
    remaining bottleneck time and k_c the current contention."""

    name = "lwtf"
    clairvoyant = True

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        if not live.any():
            return np.zeros(table.size.shape[0])
        rem_s, rem_r = _port_remaining(table, live)
        t_c = np.maximum(rem_s.max(1), rem_r.max(1)) / self.params.port_bw
        A_s, A_r = table.incidence(live)
        k = contention(A_s, A_r, table.active, device=self.device)
        key = np.where(table.active, t_c * np.maximum(k, 1), np.inf)
        return _rank_rates(table, live, key,
                           extra=self.fabric_binding(table))


class VarysSEBF(Policy):
    """Varys: Smallest-Effective-Bottleneck-First ordering + MADD rates
    (all flows of a coflow finish together at its bottleneck time), then
    greedy backfill for work conservation."""

    name = "varys-sebf"
    clairvoyant = True

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        rates = np.zeros(table.size.shape[0])
        if not live.any():
            return rates
        rem_s, rem_r = _port_remaining(table, live)
        gamma = np.maximum(rem_s.max(1), rem_r.max(1)) / self.params.port_bw
        order = np.argsort(np.where(table.active, gamma, np.inf),
                           kind="stable")
        avail_s = table.bw_send.copy()
        avail_r = table.bw_recv.copy()
        extra = self.fabric_binding(table)
        avail_x = rem_x = None
        if extra is not None:
            # (C, Lx) remaining bytes crossing each extra link
            avail_x = extra.cap.copy()
            rem = np.where(live, table.size - table.sent, 0.0)
            rem_x = np.zeros((table.num_coflows, avail_x.shape[0]))
            m = extra.up >= 0
            np.add.at(rem_x, (table.cid[m], extra.up[m]), rem[m])
            np.add.at(rem_x, (table.cid[m], extra.dn[m]), rem[m])
        rem_f = np.where(live, table.size - table.sent, 0.0)
        for c in order:
            if not table.active[c] or gamma[c] <= 0:
                continue
            ps = rem_s[c] > 0
            pr = rem_r[c] > 0
            # effective bottleneck against CURRENT available bandwidth
            with np.errstate(divide="ignore"):
                g = max(
                    (rem_s[c][ps] / np.maximum(avail_s[ps], 1e-12)).max()
                    if ps.any() else 0.0,
                    (rem_r[c][pr] / np.maximum(avail_r[pr], 1e-12)).max()
                    if pr.any() else 0.0)
            if extra is not None:
                px = rem_x[c] > 0
                if px.any():
                    g = max(g, (rem_x[c][px]
                                / np.maximum(avail_x[px], 1e-12)).max())
            if g <= 0 or not np.isfinite(g):
                continue
            lo, hi = table.flow_lo[c], table.flow_hi[c]
            fr = rem_f[lo:hi] / g  # MADD: finish together at time g
            rates[lo:hi] = fr
            np.subtract.at(avail_s, table.src[lo:hi], fr)
            np.subtract.at(avail_r, table.dst[lo:hi], fr)
            avail_s = np.maximum(avail_s, 0.0)
            avail_r = np.maximum(avail_r, 0.0)
            if extra is not None:
                mu = extra.up[lo:hi] >= 0
                np.subtract.at(avail_x, extra.up[lo:hi][mu], fr[mu])
                np.subtract.at(avail_x, extra.dn[lo:hi][mu], fr[mu])
                avail_x = np.maximum(avail_x, 0.0)
        # work-conserving backfill in the same order (only flows that did not
        # get a MADD rate; greedy fill of leftover bandwidth)
        bf_order = np.concatenate(
            [np.arange(table.flow_lo[c], table.flow_hi[c])
             for c in order if table.active[c]]) if order.size else order
        if bf_order.size:
            greedy_flow_alloc(table, bf_order, live & (rates <= 0),
                              avail_s, avail_r, rates,
                              extra=extra, avail_x=avail_x)
        return rates

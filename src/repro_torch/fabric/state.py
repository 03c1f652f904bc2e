"""Struct-of-arrays flow table (the port's own copy of
`repro.fabric.state`): `traces.batch.pack` flattens traces through it,
`api.Result.table` rebuilds a filled one from a replay, and the
event-driven host plane (`fabric.simulator` and `core.policies`) reads
and advances it in f64 through the live views below."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.coflow import Trace


@dataclasses.dataclass
class FlowTable:
    """All flows of a trace, flattened. Policies read, simulator writes."""

    num_ports: int
    num_coflows: int
    # per-flow
    cid: np.ndarray        # (F,) int32 owning coflow
    src: np.ndarray        # (F,) int32
    dst: np.ndarray        # (F,) int32
    size: np.ndarray       # (F,) float64 bytes
    sent: np.ndarray       # (F,) float64 bytes
    rate: np.ndarray       # (F,) float64 bytes/s (current schedule)
    done: np.ndarray       # (F,) bool
    fct: np.ndarray        # (F,) float64 completion time (nan until done)
    first_sched: np.ndarray  # (F,) float64 first time rate>0 (nan before)
    # per-coflow
    arrival: np.ndarray    # (C,) float64
    width: np.ndarray      # (C,) int32
    active: np.ndarray     # (C,) bool  (arrived and unfinished)
    finished: np.ndarray   # (C,) bool
    cct: np.ndarray        # (C,) float64 (nan until finished)
    # flow index ranges per coflow (flows are stored contiguous per coflow)
    flow_lo: np.ndarray    # (C,) int32
    flow_hi: np.ndarray    # (C,) int32
    # port capacities, bytes/s
    bw_send: np.ndarray    # (P,)
    bw_recv: np.ndarray    # (P,)
    # optional DAG stage dependencies (§4.3): deps[c] = list of cids that
    # must finish before coflow c becomes schedulable
    deps: "list | None" = None

    def deps_satisfied(self) -> np.ndarray:
        ok = np.ones(self.num_coflows, bool)
        if self.deps is None:
            return ok
        for c, dd in enumerate(self.deps):
            if dd:
                ok[c] = all(self.finished[d] for d in dd)
        return ok

    @staticmethod
    def from_trace(trace: Trace, port_bw: float) -> "FlowTable":
        C = len(trace.coflows)
        F = trace.num_flows
        P = trace.num_ports
        t = FlowTable(
            num_ports=P, num_coflows=C,
            cid=np.zeros(F, np.int32), src=np.zeros(F, np.int32),
            dst=np.zeros(F, np.int32), size=np.zeros(F), sent=np.zeros(F),
            rate=np.zeros(F), done=np.zeros(F, bool), fct=np.full(F, np.nan),
            first_sched=np.full(F, np.nan),
            arrival=np.zeros(C), width=np.zeros(C, np.int32),
            active=np.zeros(C, bool), finished=np.zeros(C, bool),
            cct=np.full(C, np.nan),
            flow_lo=np.zeros(C, np.int32), flow_hi=np.zeros(C, np.int32),
            bw_send=np.full(P, port_bw), bw_recv=np.full(P, port_bw),
        )
        i = 0
        ordered = sorted(trace.coflows, key=lambda c: c.cid)
        cid2idx = {c.cid: j for j, c in enumerate(ordered)}
        deps = []
        for c_idx, c in enumerate(ordered):
            t.arrival[c_idx] = c.arrival
            t.width[c_idx] = c.width
            t.flow_lo[c_idx] = i
            for f in c.flows:
                t.cid[i] = c_idx
                t.src[i] = f.src
                t.dst[i] = f.dst
                t.size[i] = f.size
                i += 1
            t.flow_hi[c_idx] = i
            deps.append([cid2idx[d] for d in (c.stage_deps or [])])
        if any(deps):
            t.deps = deps
        return t

    # ---- live views -----------------------------------------------------
    def flow_live(self) -> np.ndarray:
        """(F,) bool — flow belongs to an active coflow and is unfinished."""
        return self.active[self.cid] & ~self.done

    def coflow_sent_total(self) -> np.ndarray:
        return np.bincount(self.cid, weights=self.sent,
                           minlength=self.num_coflows)

    def coflow_max_flow_sent(self) -> np.ndarray:
        """m_c = max bytes sent by any flow of each coflow (Saath Eq.1)."""
        out = np.zeros(self.num_coflows)
        np.maximum.at(out, self.cid, self.sent)
        return out

    def incidence(self, live=None):
        """Boolean (C,P) sender & receiver incidence over live flows."""
        if live is None:
            live = self.flow_live()
        A_s = np.zeros((self.num_coflows, self.num_ports), bool)
        A_r = np.zeros((self.num_coflows, self.num_ports), bool)
        A_s[self.cid[live], self.src[live]] = True
        A_r[self.cid[live], self.dst[live]] = True
        return A_s, A_r

    def flow_counts(self, live=None):
        """Integer (C,P) live-flow counts at sender / receiver ports."""
        if live is None:
            live = self.flow_live()
        cnt_s = np.zeros((self.num_coflows, self.num_ports), np.int32)
        cnt_r = np.zeros((self.num_coflows, self.num_ports), np.int32)
        np.add.at(cnt_s, (self.cid[live], self.src[live]), 1)
        np.add.at(cnt_r, (self.cid[live], self.dst[live]), 1)
        return cnt_s, cnt_r

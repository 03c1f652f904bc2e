"""Policy interface + shared allocation primitives of the event-driven
host plane (the port's own copy of `repro.core.policies.base`).

The allocation walks are host numpy in f64, in the reference's order:
their first-touch rounds (`np.unique(return_index=True)`) and in-place
`np.subtract.at` sums decide the results bit for bit, and a per-flow
walk over device tensors would sync once per round. What the policies
compute on the card goes through `core.contention` (K1) and, for
`saath-torch`, `core.coordinator.schedule_tick`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.state import FlowTable


class Policy:
    """A scheduling policy: maps fabric state -> per-flow rates (bytes/s).

    The simulator calls `schedule(table, now)` at every scheduling instant
    (δ-grid aligned). Policies may keep internal per-coflow bookkeeping
    (queues, deadlines); they must tolerate coflows finishing between calls.

    `topology` is the fabric model the policy allocates against
    (`fabric.topology`): None/BigSwitch keeps the pre-refactor per-port
    arithmetic bitwise; `Simulator(topology=...)` installs it before
    `reset`. `device` is where the policy's kernel work runs (the K1
    contention count, `saath-torch`'s tick): CUDA unless the caller
    passes another (raising without a card); "cpu" runs the plain
    PyTorch versions.
    """

    name = "base"
    clairvoyant = False  # True => allowed to read flow sizes (offline)

    def __init__(self, params: SchedulerParams, *, device=None):
        from repro_torch.fabric.engine import resolve_device

        self.params = params
        self.topology = None
        self.device = resolve_device(device)

    def fabric_binding(self, table: FlowTable):
        """The table-bound `ExtraLinks` of this policy's topology — None
        for the big switch, so allocation code gates all link handling
        on `extra is not None` (the bitwise-preservation pattern)."""
        from repro_torch.fabric.topology import bind_table

        return bind_table(self.topology, table)

    def reset(self, table: FlowTable) -> None:  # pragma: no cover - trivial
        pass

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        raise NotImplementedError

    def progress_events(self, table: FlowTable, now: float,
                        rates: np.ndarray) -> float:
        """Earliest future instant at which this policy's *internal* state
        (queue assignment, deadline expiry) would change the schedule given
        constant `rates`. The simulator re-invokes the coordinator then.
        inf = no internal events (completions/arrivals still trigger)."""
        return float("inf")


def greedy_flow_alloc(table: FlowTable, flow_order: np.ndarray,
                      live: np.ndarray,
                      avail_s: np.ndarray | None = None,
                      avail_r: np.ndarray | None = None,
                      rates: np.ndarray | None = None, *,
                      extra=None,
                      avail_x: np.ndarray | None = None) -> np.ndarray:
    """Allocate each live flow min(avail_src, avail_dst) in the given order.

    This is the per-port 'strict priority + FIFO within queue' allocation
    used by Aalo/SCF/SRTF/LWTF-style policies (no coflow coordination) and
    by Saath's work-conservation backfill (avail_s/avail_r passed in and
    updated in place).

    Exact round-based vectorization of the sequential greedy: in each round
    every candidate flow that is the FIRST (in priority order) to touch both
    its sender and receiver port is allocated min(avail) — identical to the
    one-at-a-time result because no earlier flow shares its ports. Each
    round saturates >=1 port per allocated flow, so rounds are few.

    `extra` (a `fabric.topology.ExtraLinks`) extends the walk to a
    leaf-spine fabric: candidates must also see residual capacity on
    their uplink/downlink, the first-toucher rule covers those links,
    and the allocation is the min over all four resources. With
    `extra=None` the pre-refactor body runs unchanged (bitwise — the
    regression guard in tests/test_fabric_regression.py).
    """
    F = table.size.shape[0]
    rates = np.zeros(F) if rates is None else rates
    avail_s = table.bw_send.copy() if avail_s is None else avail_s
    avail_r = table.bw_recv.copy() if avail_r is None else avail_r
    src, dst = table.src, table.dst
    ordered = flow_order[live[flow_order]]
    if extra is None:
        for _ in range(2 * table.num_ports + 2):
            if ordered.size == 0:
                break
            cand = ordered[(avail_s[src[ordered]] > 0.0)
                           & (avail_r[dst[ordered]] > 0.0)]
            if cand.size == 0:
                break
            # first occurrence of each port, in priority order
            _, first_s = np.unique(src[cand], return_index=True)
            _, first_r = np.unique(dst[cand], return_index=True)
            is_first_s = np.zeros(cand.size, bool)
            is_first_r = np.zeros(cand.size, bool)
            is_first_s[first_s] = True
            is_first_r[first_r] = True
            take = cand[is_first_s & is_first_r]
            r = np.minimum(avail_s[src[take]], avail_r[dst[take]])
            rates[take] = r
            # 'take' flows have unique src and dst among themselves
            avail_s[src[take]] -= r
            avail_r[dst[take]] -= r
            ordered = cand[~(is_first_s & is_first_r)]
        return rates
    up, dn = extra.up, extra.dn
    avail_x = extra.cap.copy() if avail_x is None else avail_x
    Lx = avail_x.shape[0]
    for _ in range(2 * (table.num_ports + Lx) + 2):
        if ordered.size == 0:
            break
        u, d = up[ordered], dn[ordered]
        ok = (avail_s[src[ordered]] > 0.0) & (avail_r[dst[ordered]] > 0.0)
        ok &= (u < 0) | (avail_x[np.maximum(u, 0)] > 0.0)
        ok &= (d < 0) | (avail_x[np.maximum(d, 0)] > 0.0)
        cand = ordered[ok]
        if cand.size == 0:
            break
        _, first_s = np.unique(src[cand], return_index=True)
        _, first_r = np.unique(dst[cand], return_index=True)
        # intra-leaf flows (no extra link) get unique pseudo-ids so the
        # first-toucher dedup never groups them
        fresh = Lx + np.arange(cand.size, dtype=np.int64)
        uu = np.where(up[cand] >= 0, up[cand], fresh)
        dd = np.where(dn[cand] >= 0, dn[cand], fresh)
        _, first_u = np.unique(uu, return_index=True)
        _, first_d = np.unique(dd, return_index=True)
        is_first = np.zeros((4, cand.size), bool)
        is_first[0, first_s] = True
        is_first[1, first_r] = True
        is_first[2, first_u] = True
        is_first[3, first_d] = True
        takeable = is_first.all(axis=0)
        take = cand[takeable]
        r = np.minimum(avail_s[src[take]], avail_r[dst[take]])
        tu, td = up[take], dn[take]
        mu, md = tu >= 0, td >= 0
        r = np.minimum(r, np.where(mu, avail_x[np.maximum(tu, 0)],
                                   np.inf))
        r = np.minimum(r, np.where(md, avail_x[np.maximum(td, 0)],
                                   np.inf))
        rates[take] = r
        # 'take' flows have unique ports and links among themselves
        avail_s[src[take]] -= r
        avail_r[dst[take]] -= r
        avail_x[tu[mu]] -= r[mu]
        avail_x[td[md]] -= r[md]
        ordered = cand[~takeable]
    return rates


def coflow_flow_order(table: FlowTable, coflow_rank: np.ndarray) -> np.ndarray:
    """Flow order induced by a per-coflow rank (ties by flow id)."""
    return np.lexsort((np.arange(table.size.shape[0]),
                       coflow_rank[table.cid]))


def maxmin_waterfill(table: FlowTable, live: np.ndarray,
                     max_iter: int | None = None, *,
                     extra=None,
                     avail_s: np.ndarray | None = None,
                     avail_r: np.ndarray | None = None,
                     avail_x: np.ndarray | None = None) -> np.ndarray:
    """Exact bipartite max-min fair rates (progressive filling).

    Models the steady-state throughput of per-flow TCP fair sharing —
    the UC-TCP baseline (§6.1). With `extra` (`fabric.topology
    .ExtraLinks`) the filling also levels across leaf uplinks/downlinks
    — the leaf-spine allocation the in-network papers assume, and the
    loop `kernels/maxmin.py` accelerates on the jitted plane. Residual
    `avail_*` vectors (updated in place) let Saath's `wc_fill="maxmin"`
    water-fill only the leftover capacity of a partly-admitted fabric;
    by default the walk starts from the full port bandwidth, bitwise
    the pre-refactor behavior when `extra is None`.
    """
    F = table.size.shape[0]
    rates = np.zeros(F)
    frozen = ~live
    avail_s = table.bw_send.copy() if avail_s is None else avail_s
    avail_r = table.bw_recv.copy() if avail_r is None else avail_r
    if extra is not None:
        avail_x = extra.cap.copy() if avail_x is None else avail_x
        Lx = avail_x.shape[0]
        up, dn = extra.up, extra.dn
        up_ok, dn_ok = up >= 0, dn >= 0
    else:
        Lx = 0
    it = 0
    limit = max_iter or 2 * (table.num_ports + Lx) + 2
    while not frozen.all() and it < limit:
        it += 1
        act = ~frozen
        cnt_s = np.bincount(table.src[act], minlength=table.num_ports)
        cnt_r = np.bincount(table.dst[act], minlength=table.num_ports)
        with np.errstate(divide="ignore", invalid="ignore"):
            lvl_s = np.where(cnt_s > 0, avail_s / np.maximum(cnt_s, 1), np.inf)
            lvl_r = np.where(cnt_r > 0, avail_r / np.maximum(cnt_r, 1), np.inf)
        lvl = min(lvl_s.min(), lvl_r.min())
        if extra is not None:
            cnt_x = (np.bincount(up[act & up_ok], minlength=Lx)
                     + np.bincount(dn[act & dn_ok], minlength=Lx))
            with np.errstate(divide="ignore", invalid="ignore"):
                lvl_x = np.where(cnt_x > 0,
                                 avail_x / np.maximum(cnt_x, 1), np.inf)
            lvl = min(lvl, lvl_x.min())
        if not np.isfinite(lvl):
            break
        # freeze flows incident to saturated ports (or links) at `lvl`
        sat_s = (lvl_s <= lvl + 1e-12) & (cnt_s > 0)
        sat_r = (lvl_r <= lvl + 1e-12) & (cnt_r > 0)
        hit = act & (sat_s[table.src] | sat_r[table.dst])
        if extra is not None:
            sat_x = (lvl_x <= lvl + 1e-12) & (cnt_x > 0)
            hit |= act & ((up_ok & sat_x[np.maximum(up, 0)])
                          | (dn_ok & sat_x[np.maximum(dn, 0)]))
        if not hit.any():
            break
        rates[hit] = lvl
        np.subtract.at(avail_s, table.src[hit], lvl)
        np.subtract.at(avail_r, table.dst[hit], lvl)
        avail_s = np.maximum(avail_s, 0.0, out=avail_s)
        avail_r = np.maximum(avail_r, 0.0, out=avail_r)
        if extra is not None:
            np.subtract.at(avail_x, up[hit & up_ok], lvl)
            np.subtract.at(avail_x, dn[hit & dn_ok], lvl)
            avail_x = np.maximum(avail_x, 0.0, out=avail_x)
        frozen = frozen | hit
    return rates

"""Padded batch representation of coflow traces for the fleet engine.

The port's own copy of `repro.traces.batch` for the big-switch fabric:
``pack`` flattens a list of `Trace` (or `FlowTable`) objects into one
`TraceBatch` of rectangular numpy arrays — flows padded to a common F,
coflows to a common C, ports to a common P — and `to_device` moves it
onto a torch device for `fabric.engine`, which replays the whole fleet
along the leading batch axis.

Padding semantics (DESIGN.md §3):

* padded flows have ``flow_valid=False`` and start *done* in the
  engine, so they never go live, never contribute to port counts, and
  never hold a coflow open;
* padded coflows have ``coflow_valid=False`` and ``arrival=+inf`` so
  they never activate; their width is 1 so Eq. 1 arithmetic stays
  benign;
* ``arrival_rank`` is the host-computed exact FIFO rank (stable argsort
  of arrival) — float arrivals may collide in f32, ranks cannot.

``pack(..., topology=LeafSpine(...))`` also writes the leaf-spine link
layout (Lf leaves): per-flow uplink/downlink leaf ids with the sentinel
Lf for "touches no shared link", per-leaf link capacities, and the
(cid, link)-sorted permutations with searchsorted group bounds that
make per-(coflow, link) live counts one segment sum. On the big switch
(``topology`` None or `BigSwitch`) the link fields are zero-width.
``pilot`` stays None: pilot sampling is a later slice of the port.

Pad sizes round up to multiples (flows: 64, coflows: 16).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch.core.coflow import Trace
from repro_torch.fabric.state import FlowTable
from repro_torch.fabric.topology import leaf_links_for


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class TraceBatch(NamedTuple):
    """B padded traces. Leading axis of every array is the trace axis.

    Host-side the leaves are numpy arrays; `to_device` returns the same
    NamedTuple with torch tensors (index leaves as int64)."""
    # per-flow (B, F)
    cid: np.ndarray         # int32 owning coflow (0 for padding)
    src: np.ndarray         # int32 sender port
    dst: np.ndarray         # int32 receiver port
    size: np.ndarray        # float32 bytes (1.0 for padding)
    flow_valid: np.ndarray  # bool
    # per-coflow (B, C)
    arrival: np.ndarray       # float32 seconds (+inf for padding)
    arrival_rank: np.ndarray  # int32 exact FIFO rank (host-computed)
    width: np.ndarray         # int32 total flow count N_c
    coflow_valid: np.ndarray  # bool
    flow_lo: np.ndarray       # int32 [lo, hi) contiguous flow range —
    flow_hi: np.ndarray       # segment reductions become cumsum diffs
    # per-port (B, P)
    bw_send: np.ndarray     # float32 bytes/s
    bw_recv: np.ndarray     # float32 bytes/s
    # port-count machinery (host-precomputed): flows reordered by
    # (cid, src) / (cid, dst) make every (coflow, port) group contiguous,
    # so the engine's live-flow port counts are 1-D cumsum differences.
    perm_src: np.ndarray    # (B, F) int32 flow order sorted by (cid, src)
    perm_dst: np.ndarray    # (B, F) int32 flow order sorted by (cid, dst)
    lo_src: np.ndarray      # (B, C, P) int32 group start in perm_src order
    hi_src: np.ndarray      # (B, C, P) int32 group end
    lo_dst: np.ndarray      # (B, C, P) int32
    hi_dst: np.ndarray      # (B, C, P) int32
    # flows sorted by (cid, valid-first, size): within every coflow the
    # REAL flows occupy [flow_lo, flow_hi) in ascending size order, so
    # the §4.3 finished-flow median is an order-statistics lookup.
    perm_size: np.ndarray   # (B, F) int32
    # leaf-spine link layout (Lf leaves; zero-width on the big switch)
    link_up: np.ndarray     # (B, F) int32 uplink leaf, Lf = "no link"
    link_dn: np.ndarray     # (B, F) int32 downlink leaf, Lf = "no link"
    bw_up: np.ndarray       # (B, Lf) float32 uplink capacities
    bw_dn: np.ndarray       # (B, Lf) float32 downlink capacities
    perm_up: np.ndarray     # (B, F) int32 flow order sorted by (cid, up)
    perm_dn: np.ndarray     # (B, F) int32 flow order sorted by (cid, dn)
    lo_up: np.ndarray       # (B, C, Lf) int32 group start in perm_up order
    hi_up: np.ndarray       # (B, C, Lf) int32 group end
    lo_dn: np.ndarray       # (B, C, Lf) int32
    hi_dn: np.ndarray       # (B, C, Lf) int32
    pilot: np.ndarray | None = None  # pilot sampling: not packed (None)

    @property
    def num_traces(self) -> int:
        return self.cid.shape[0]

    @property
    def max_flows(self) -> int:
        return self.cid.shape[1]

    @property
    def max_coflows(self) -> int:
        return self.arrival.shape[1]

    @property
    def num_ports(self) -> int:
        return self.bw_send.shape[1]

    @property
    def num_leaf_links(self) -> int:
        """Lf, the leaves of the packed leaf-spine topology (0 = big
        switch: the tick leaves the link machinery out)."""
        return self.bw_up.shape[1]


def empty_batch(num_rows: int, *, flow_capacity: int, coflow_capacity: int,
                port_capacity: int, leaf_links: int = 0) -> TraceBatch:
    """An all-padding TraceBatch: every row is a blank row (no valid
    coflows or flows), filled in place by `pack_row`. `leaf_links` is
    the Lf of the link layout (0 = big switch)."""
    B, F = num_rows, flow_capacity
    C, P = coflow_capacity, port_capacity
    Lf = leaf_links
    if B <= 0 or P <= 0 or F < 0 or C < 0 or Lf < 0:
        raise ValueError("empty_batch needs positive rows/ports and "
                         "non-negative flow/coflow/link capacities")
    ident = np.tile(np.arange(F, dtype=np.int32), (B, 1))
    return TraceBatch(
        cid=np.zeros((B, F), np.int32), src=np.zeros((B, F), np.int32),
        dst=np.zeros((B, F), np.int32), size=np.ones((B, F), np.float32),
        flow_valid=np.zeros((B, F), bool),
        arrival=np.full((B, C), np.inf, np.float32),
        arrival_rank=np.full((B, C), 2 ** 30, np.int32),
        width=np.ones((B, C), np.int32),
        coflow_valid=np.zeros((B, C), bool),
        flow_lo=np.zeros((B, C), np.int32),
        flow_hi=np.zeros((B, C), np.int32),
        bw_send=np.zeros((B, P), np.float32),
        bw_recv=np.zeros((B, P), np.float32),
        perm_src=ident.copy(), perm_dst=ident.copy(),
        lo_src=np.zeros((B, C, P), np.int32),
        hi_src=np.zeros((B, C, P), np.int32),
        lo_dst=np.zeros((B, C, P), np.int32),
        hi_dst=np.zeros((B, C, P), np.int32),
        perm_size=ident.copy(),
        link_up=np.full((B, F), Lf, np.int32),
        link_dn=np.full((B, F), Lf, np.int32),
        bw_up=np.zeros((B, Lf), np.float32),
        bw_dn=np.zeros((B, Lf), np.float32),
        perm_up=ident.copy(), perm_dn=ident.copy(),
        lo_up=np.zeros((B, C, Lf), np.int32),
        hi_up=np.zeros((B, C, Lf), np.int32),
        lo_dn=np.zeros((B, C, Lf), np.int32),
        hi_dn=np.zeros((B, C, Lf), np.int32),
    )


def blank_row(tb: TraceBatch, b: int) -> None:
    """Reset row `b` to all-padding in place."""
    F = tb.max_flows
    tb.cid[b] = 0
    tb.src[b] = 0
    tb.dst[b] = 0
    tb.size[b] = 1.0
    tb.flow_valid[b] = False
    tb.arrival[b] = np.inf
    tb.arrival_rank[b] = 2 ** 30
    tb.width[b] = 1
    tb.coflow_valid[b] = False
    tb.flow_lo[b] = 0
    tb.flow_hi[b] = 0
    tb.bw_send[b] = 0.0
    tb.bw_recv[b] = 0.0
    tb.perm_src[b] = np.arange(F, dtype=np.int32)
    tb.perm_dst[b] = np.arange(F, dtype=np.int32)
    tb.lo_src[b] = 0
    tb.hi_src[b] = 0
    tb.lo_dst[b] = 0
    tb.hi_dst[b] = 0
    tb.perm_size[b] = np.arange(F, dtype=np.int32)
    tb.link_up[b] = tb.num_leaf_links
    tb.link_dn[b] = tb.num_leaf_links
    tb.bw_up[b] = 0.0
    tb.bw_dn[b] = 0.0
    tb.perm_up[b] = np.arange(F, dtype=np.int32)
    tb.perm_dn[b] = np.arange(F, dtype=np.int32)
    tb.lo_up[b] = 0
    tb.hi_up[b] = 0
    tb.lo_dn[b] = 0
    tb.hi_dn[b] = 0


def pack_row(tb: TraceBatch, b: int, t: FlowTable, *,
             arrival_rank=None, topology=None) -> None:
    """Write one FlowTable into row `b` in place (blanking it first),
    recomputing the row's host-side permutations and segment layouts,
    and the link layout when `topology` is a `LeafSpine`.
    `arrival_rank` overrides the row's arrival argsort with the caller's
    exact FIFO ranks: an online session's ranks are session-global
    submission ranks, which must survive re-packs of the still-live
    subset (reference `src/repro/traces/batch.py:210`). Raises when the row's
    capacities cannot hold the table."""
    f, c = t.size.shape[0], t.num_coflows
    F, C, P = tb.max_flows, tb.max_coflows, tb.num_ports
    if f > F or c > C or t.num_ports > P:
        raise ValueError(
            f"slab row capacity exceeded: ({f} flows, {c} coflows, "
            f"{t.num_ports} ports) > ({F}, {C}, {P})")
    blank_row(tb, b)
    if c == 0:
        return
    tb.cid[b, :f] = t.cid
    # padded flows get the first padded coflow id — or, when the trace
    # fills C exactly, the LAST REAL id (the pad run then contiguously
    # extends that coflow's run). Any gather through a pad cid must stay
    # masked by flow_valid (pads start done).
    tb.cid[b, f:] = min(c, C - 1)
    tb.src[b, :f] = t.src
    tb.dst[b, :f] = t.dst
    tb.size[b, :f] = t.size
    tb.flow_valid[b, :f] = True
    tb.arrival[b, :c] = t.arrival
    tb.arrival_rank[b, :c] = np.argsort(
        np.argsort(t.arrival, kind="stable"), kind="stable") \
        if arrival_rank is None else arrival_rank
    tb.width[b, :c] = t.width
    tb.coflow_valid[b, :c] = True
    tb.flow_lo[b, :c] = t.flow_lo
    tb.flow_hi[b, :c] = t.flow_hi
    tb.bw_send[b, :t.num_ports] = t.bw_send
    tb.bw_recv[b, :t.num_ports] = t.bw_recv
    for port, perm_out, lo_out, hi_out in (
            (t.src, tb.perm_src, tb.lo_src, tb.hi_src),
            (t.dst, tb.perm_dst, tb.lo_dst, tb.hi_dst)):
        order = np.lexsort((port, t.cid)).astype(np.int32)
        perm_out[b, :f] = order
        keys = t.cid[order].astype(np.int64) * P + port[order]
        grid = np.arange(C * P, dtype=np.int64)
        lo_out[b] = np.searchsorted(keys, grid, "left").reshape(C, P)
        hi_out[b] = np.searchsorted(keys, grid, "right").reshape(C, P)
    # (cid, valid-first, size) order: pads share the last real cid when
    # the trace fills C exactly, so the valid key pushes them BEHIND
    # that coflow's real flows.
    tb.perm_size[b] = np.lexsort(
        (tb.size[b], ~tb.flow_valid[b], tb.cid[b])).astype(np.int32)
    # leaf-spine link layout (blank_row already reset it to "no links")
    Lf = tb.num_leaf_links
    need = 0 if topology is None else topology.leaf_count(t.num_ports)
    if need == 0:
        return
    if need > Lf:
        raise ValueError(
            f"slab row link capacity exceeded: topology needs {need} "
            f"leaves > {Lf} packed")
    cap_up, cap_dn = topology.link_caps(t.bw_send, t.bw_recv)
    tb.bw_up[b, :need] = cap_up
    tb.bw_dn[b, :need] = cap_dn
    up, dn = topology.flow_links(t.src, t.dst)
    # sentinel Lf = "touches no shared link" (intra-leaf; also the blank
    # value padding keeps), left out of the (cid, link) grid
    tb.link_up[b, :f] = np.where(up >= 0, up, Lf).astype(np.int32)
    tb.link_dn[b, :f] = np.where(dn >= 0, dn, Lf).astype(np.int32)
    grid = (np.arange(C, dtype=np.int64)[:, None] * (Lf + 1)
            + np.arange(Lf, dtype=np.int64)[None, :]).ravel()
    for link, perm_out, lo_out, hi_out in (
            (tb.link_up[b, :f], tb.perm_up, tb.lo_up, tb.hi_up),
            (tb.link_dn[b, :f], tb.perm_dn, tb.lo_dn, tb.hi_dn)):
        order = np.lexsort((link, t.cid)).astype(np.int32)
        perm_out[b, :f] = order
        keys = t.cid[order].astype(np.int64) * (Lf + 1) + link[order]
        lo_out[b] = np.searchsorted(keys, grid, "left").reshape(C, Lf)
        hi_out[b] = np.searchsorted(keys, grid, "right").reshape(C, Lf)


def row_of(tb: TraceBatch, b: int) -> tuple:
    """Copies of row `b`'s leaves without the batch axis: the unit the
    `SessionPool`'s dirty-row scatter stages on the host (pack into a
    1-row scratch with `pack_row`, slice with `row_of`, stack the dirty
    set with `stack_rows`, scatter once; reference
    `src/repro/traces/batch.py:302`)."""
    return tuple(None if a is None else np.array(a[b]) for a in tb)


def stack_rows(rows: Sequence[tuple]) -> TraceBatch:
    """Stack `row_of` tuples into a (k, ...) TraceBatch update payload
    (reference `src/repro/traces/batch.py:310`)."""
    if not rows:
        raise ValueError("stack_rows needs at least one row")
    return TraceBatch(*(None if cols[0] is None else np.stack(cols)
                        for cols in zip(*rows)))


def pack(traces: Sequence[Union[Trace, FlowTable]], *,
         port_bw: float = None,
         flow_multiple: int = 64, coflow_multiple: int = 16,
         flow_capacity: int = 0, coflow_capacity: int = 0,
         port_capacity: int = 0, topology=None) -> TraceBatch:
    """Pad/pack traces (or FlowTables) into one host-side TraceBatch.

    `port_bw` is required when packing `Trace` objects (FlowTables carry
    their own per-port bandwidths). DAG stage dependencies are rejected.
    `topology` (None, `BigSwitch` or `LeafSpine`) sets the link layout.
    """
    tables: List[FlowTable] = []
    for t in traces:
        if isinstance(t, Trace):
            if port_bw is None:
                raise ValueError("port_bw is required to pack Trace objects")
            tables.append(FlowTable.from_trace(t, port_bw))
        else:
            tables.append(t)
    if not tables:
        raise ValueError("pack() needs at least one trace")
    for t in tables:
        if t.deps is not None:
            raise NotImplementedError(
                "DAG stage deps are not supported by the batched engine")

    B = len(tables)
    F = max(_round_up(max(t.size.shape[0] for t in tables), flow_multiple),
            flow_capacity)
    C = max(_round_up(max(t.num_coflows for t in tables), coflow_multiple),
            coflow_capacity)
    P = max(max(t.num_ports for t in tables), port_capacity)
    Lf = leaf_links_for(topology, P)
    tb = empty_batch(B, flow_capacity=F, coflow_capacity=C,
                     port_capacity=P, leaf_links=Lf)
    for b, t in enumerate(tables):
        pack_row(tb, b, t, topology=topology if Lf else None)
    return tb


def to_device(tb: TraceBatch, device) -> TraceBatch:
    """The same TraceBatch with torch tensors on `device`: int32 index
    leaves become int64 (torch's gather/scatter index type), f32 and
    bool leaves keep their dtype, a None leaf stays None. Accepts any
    NamedTuple with TraceBatch's field names (e.g. the JAX package's)."""
    out = []
    for name in TraceBatch._fields:
        a = getattr(tb, name, None)
        if a is None:
            out.append(None)
            continue
        a = np.array(a)     # a writable, contiguous host copy
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        out.append(torch.from_numpy(a).to(device))
    return TraceBatch(*out)


__all__ = ["TraceBatch", "pack", "pack_row", "blank_row", "empty_batch",
           "row_of", "stack_rows", "to_device"]

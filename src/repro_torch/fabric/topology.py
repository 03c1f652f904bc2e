"""Fabric models of the port: the big switch and the leaf-spine tree.

The port's own copy of `repro.fabric.topology` (DESIGN.md §11). The
batched engine consumes a topology through the `TraceBatch` link layout
that `traces.batch.pack_row` writes: per-flow uplink/downlink leaf ids
plus a (cid, link)-sorted permutation with searchsorted group bounds, so
per-(coflow, link) live counts are one segment sum inside the tick. The
event-driven host plane (`fabric.simulator`, `core.policies`) consumes
it through `bind_table`: an `ExtraLinks` view (per-link capacities and
per-flow link ids, -1 for intra-leaf flows) that the allocation walks
thread through their arithmetic; the big switch binds to None, and every
walk then takes its pre-refactor branch bit for bit.

* `BigSwitch()`: contention only at the ingress/egress ports; packs no
  link leaves (Lf = 0), so the tick runs its big-switch structure.
* `LeafSpine(hosts_per_leaf, oversub, wc_fill)`: port p lives under
  leaf `p // hosts_per_leaf`; an inter-leaf flow also crosses its
  source leaf's uplink and its destination leaf's downlink, each of
  capacity (subtended port bandwidth) / `oversub`. At 1:1 the link mins
  never bind, so the replay equals the big switch's. `wc_fill` picks
  the work-conservation fill: "greedy" (the paper's D4 walk with
  per-link feasibility) or "maxmin" (max-min fair water-filling over
  the leftover flows, kernel K3 on the card).

Both are frozen dataclasses with the reference's field names and
`repr`, because `Scenario.hash` hashes `repr(topology)`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np


class ExtraLinks(NamedTuple):
    """The host plane's bound view of a topology's non-port links.

    `cap[k]` is the capacity of extra link k (uplinks first, then
    downlinks: k in [0, Lf) is leaf k's uplink, k in [Lf, 2Lf) is leaf
    k-Lf's downlink). `up[f]`/`dn[f]` are flow f's extra-link ids into
    `cap` — both -1 when the flow stays inside one leaf and touches no
    shared link.
    """
    cap: np.ndarray        # (2*Lf,) float64 link capacities, bytes/s
    up: np.ndarray         # (F,) int32 uplink id in [0, Lf), -1 = none
    dn: np.ndarray         # (F,) int32 downlink id in [Lf, 2Lf), -1 = none
    num_uplinks: int       # Lf


@dataclasses.dataclass(frozen=True)
class BigSwitch:
    """The non-blocking fabric of the paper: per-port contention only."""

    def leaf_count(self, num_ports: int) -> int:
        return 0

    def bind(self, table) -> Optional[ExtraLinks]:
        return None


@dataclasses.dataclass(frozen=True)
class LeafSpine:
    """A two-tier leaf-spine fabric with uniform oversubscription: each
    leaf owns one logical uplink and one logical downlink into a
    non-blocking spine, of capacity (subtended port bandwidth) /
    `oversub`; `oversub=1.0` is full bisection."""
    hosts_per_leaf: int = 4
    oversub: float = 1.0
    wc_fill: str = "greedy"

    def __post_init__(self):
        if self.hosts_per_leaf < 1:
            raise ValueError("hosts_per_leaf must be >= 1")
        if not self.oversub > 0.0:
            raise ValueError("oversub must be positive")
        if self.wc_fill not in ("greedy", "maxmin"):
            raise ValueError(
                f"wc_fill must be 'greedy' or 'maxmin', "
                f"got {self.wc_fill!r}")

    def leaf_count(self, num_ports: int) -> int:
        return int(math.ceil(num_ports / self.hosts_per_leaf))

    def leaf_of(self, ports: np.ndarray) -> np.ndarray:
        return (np.asarray(ports, np.int32)
                // np.int32(self.hosts_per_leaf)).astype(np.int32)

    def link_caps(self, bw_send: np.ndarray,
                  bw_recv: np.ndarray) -> tuple:
        """Per-leaf (uplink, downlink) capacities from the per-port
        bandwidths, as two (Lf,) float64 vectors."""
        P = bw_send.shape[0]
        Lf = self.leaf_count(P)
        leaf = self.leaf_of(np.arange(P, dtype=np.int32))
        cap_up = (np.bincount(leaf, weights=bw_send, minlength=Lf)
                  / self.oversub).astype(np.float64)
        cap_dn = (np.bincount(leaf, weights=bw_recv, minlength=Lf)
                  / self.oversub).astype(np.float64)
        return cap_up, cap_dn

    def flow_links(self, src: np.ndarray, dst: np.ndarray) -> tuple:
        """Per-flow (uplink leaf, downlink leaf) ids, -1 for flows whose
        endpoints share a leaf (they never touch the spine)."""
        up = self.leaf_of(src)
        dn = self.leaf_of(dst)
        inter = up != dn
        m1 = np.int32(-1)
        return (np.where(inter, up, m1).astype(np.int32),
                np.where(inter, dn, m1).astype(np.int32))

    def bind(self, table) -> ExtraLinks:
        """Bind to a `fabric.state.FlowTable`: the ExtraLinks view the
        host allocation walks thread through their arithmetic."""
        Lf = self.leaf_count(table.num_ports)
        cap_up, cap_dn = self.link_caps(table.bw_send, table.bw_recv)
        up, dn = self.flow_links(table.src, table.dst)
        dn = np.where(dn >= 0, dn + np.int32(Lf),
                      np.int32(-1)).astype(np.int32)
        return ExtraLinks(
            cap=np.concatenate([cap_up, cap_dn]).astype(np.float64),
            up=up, dn=dn, num_uplinks=Lf)


def normalize_topology(topology) -> object:
    """None -> BigSwitch(); raises TypeError for anything that is not
    one of the port's fabric models."""
    if topology is None:
        return BigSwitch()
    if isinstance(topology, (BigSwitch, LeafSpine)):
        return topology
    raise TypeError(
        f"topology must be BigSwitch, LeafSpine, or None; "
        f"got {topology!r}")


def bind_table(topology, table) -> Optional[ExtraLinks]:
    """The host plane's one entry: None (big-switch semantics — callers
    take their pre-refactor branch) or the bound ExtraLinks."""
    return normalize_topology(topology).bind(table)


def leaf_links_for(topology, num_ports: int) -> int:
    """How many leaves a batch packed for `topology` carries (0 keeps the
    link machinery out of the tick)."""
    return normalize_topology(topology).leaf_count(num_ports)


def wc_fill_of(topology) -> str:
    """The work-conservation fill a topology asks for ("greedy" for the
    big switch, the paper's D4 walk)."""
    return getattr(normalize_topology(topology), "wc_fill", "greedy")


__all__ = ["BigSwitch", "LeafSpine", "ExtraLinks", "normalize_topology",
           "bind_table", "leaf_links_for", "wc_fill_of"]

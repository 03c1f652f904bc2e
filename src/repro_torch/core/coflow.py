"""Coflow/flow model (the port's own copy of `repro.core.coflow`).

Object form (`Coflow`, `Flow`) is used for traces; `traces.batch.pack`
flattens them into struct-of-arrays (`fabric.state.FlowTable`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Flow:
    fid: int            # global flow id
    src: int            # sender port
    dst: int            # receiver port
    size: float         # bytes


@dataclasses.dataclass
class Coflow:
    cid: int
    arrival: float      # seconds
    flows: List[Flow]
    stage_deps: Optional[List[int]] = None  # DAG: cids this stage waits on

    @property
    def width(self) -> int:
        return len(self.flows)

    @property
    def total_bytes(self) -> float:
        return float(sum(f.size for f in self.flows))


@dataclasses.dataclass
class Trace:
    num_ports: int
    coflows: List[Coflow]

    @property
    def num_flows(self) -> int:
        return sum(c.width for c in self.coflows)

    def validate(self) -> None:
        seen = set()
        for c in self.coflows:
            assert c.cid not in seen, f"duplicate cid {c.cid}"
            seen.add(c.cid)
            assert c.arrival >= 0
            assert c.width >= 1
            for f in c.flows:
                assert 0 <= f.src < self.num_ports
                assert 0 <= f.dst < self.num_ports
                assert f.size > 0

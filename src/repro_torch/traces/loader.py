"""Loader for the public coflow-benchmark trace format (the port's own
copy of `repro.traces.loader`, built on the port's `Coflow`/`Flow`/
`Trace`: the same file gives the same trace on both planes).

Format (github.com/coflow/coflow-benchmark, FB-UIUC trace):

    <num_ports> <num_coflows>
    <id> <arrival_ms> <num_mappers> <m1 m2 ...> <num_reducers> \
        <r1:size_mb r2:size_mb ...>

Each reducer entry is `port:total_MB_received`; the shuffle bytes of one
reducer are split equally across the coflow's mappers (the convention used
by the open-source coflowsim this paper compares against).
"""
from __future__ import annotations

from repro_torch.core.coflow import Coflow, Flow, Trace

MB = 1024.0 * 1024.0


def load_coflow_benchmark(path: str) -> Trace:
    with open(path) as fh:
        tokens = fh.readline().split()
        num_ports, num_coflows = int(tokens[0]), int(tokens[1])
        coflows = []
        fid = 0
        for _ in range(num_coflows):
            parts = fh.readline().split()
            cid = int(parts[0])
            arrival = float(parts[1]) / 1e3
            nm = int(parts[2])
            mappers = [int(x) % num_ports for x in parts[3:3 + nm]]
            idx = 3 + nm
            nr = int(parts[idx])
            flows = []
            for ent in parts[idx + 1: idx + 1 + nr]:
                r, sz = ent.split(":")
                dst = int(r) % num_ports
                per_mapper = float(sz) * MB / max(len(mappers), 1)
                for src in mappers:
                    flows.append(Flow(fid, src, dst,
                                      max(per_mapper, 1.0)))
                    fid += 1
            coflows.append(Coflow(cid=cid, arrival=arrival, flows=flows))
    tr = Trace(num_ports=num_ports, coflows=coflows)
    tr.validate()
    return tr


__all__ = ["load_coflow_benchmark", "MB"]

"""Oversubscription sweep on the port: CCT degradation under a
leaf-spine fabric (the counterpart of `benchmarks/fig_oversub.py`).

The paper's big-switch assumption (§3) is exact at 1:1
oversubscription — the uplink residual always dominates the sum of its
subtended port residuals — but real leaf-spine fabrics run 2:1..4:1,
where the shared uplinks/downlinks bind and every policy's CCTs
stretch. This driver sweeps oversub x policy lane through BOTH planes:

* torch lane: a fleet of traces replayed through the batched engine,
  one `Scenario(topology=LeafSpine(...))` per (oversub, policy) cell
  (the default greedy work-conservation fill) — "aalo-like" here is the
  coordinated-FIFO ablation of the Saath coordinator (lcof=0, per-flow
  thresholds off), the batched plane's closest Aalo analogue;
* numpy lane: the event-driven host plane on one trace per cell (the
  true `aalo` host policy), gating that the degradation is a property
  of the fabric model, not of one engine.

Every cell is recorded to BENCH_torch.json via
`benchmarks.torch_common.record` (keyed by scenario hash — the topology
is part of the hash).

    python -m benchmarks.torch_fig_oversub
"""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import Bench, cli_bench, emit, record
from repro_torch.api import Scenario
from repro_torch.api import run as api_run
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.topology import LeafSpine
from repro_torch.traces.synth import tiny_trace

OVERSUBS = (1.0, 2.0, 4.0)
HOSTS_PER_LEAF = 4
# traces in the fleet, quick and --full
FLEET_QUICK, FLEET_FULL = 4, 16


def _fleet(quick: bool):
    n = FLEET_QUICK if quick else FLEET_FULL
    return tuple(tiny_trace(30, 16, seed=s, load=0.8) for s in range(n))


def run(bench: Bench, engine: str = "torch"):
    p = SchedulerParams()
    traces = _fleet(bench.quick)
    rows = []

    # torch lane: fleet x (saath, coordinated-FIFO ablation) x oversub
    lanes = {"saath": None,
             "aalo-like": dict(lcof=False, per_flow_threshold=False)}
    torch_avg = {}
    for lane, mech in lanes.items():
        for ov in OVERSUBS:
            sc = Scenario(policy="saath", engine="torch", params=p,
                          traces=traces, mechanisms=mech,
                          topology=LeafSpine(
                              hosts_per_leaf=HOSTS_PER_LEAF, oversub=ov),
                          label=f"oversub-{lane}-{ov:g}",
                          device=bench.device)
            res = api_run(sc)
            record("fig_oversub_torch", res, lane=lane, oversub=ov)
            avg = float(np.nanmean(res.avg_cct))
            torch_avg[(lane, ov)] = avg
            rows.append({"engine": "torch", "lane": lane, "oversub": ov,
                         "avg_cct": avg,
                         "wall_seconds": res.wall_seconds})

    # numpy lane: one trace, the true host policies
    for lane in ("saath", "aalo"):
        for ov in OVERSUBS:
            sc = Scenario(policy=lane, engine="numpy", params=p,
                          trace=traces[0],
                          topology=LeafSpine(
                              hosts_per_leaf=HOSTS_PER_LEAF, oversub=ov),
                          label=f"oversub-{lane}-{ov:g}",
                          device=bench.device)
            res = api_run(sc)
            record("fig_oversub_numpy", res, lane=lane, oversub=ov)
            rows.append({"engine": "numpy", "lane": lane, "oversub": ov,
                         "avg_cct": float(np.nanmean(res.avg_cct)),
                         "wall_seconds": res.wall_seconds})

    emit("fig_oversub", rows)

    # the fabric model must BITE: 4:1 visibly worse than 1:1, per lane,
    # per plane
    for eng in ("torch", "numpy"):
        for lane in ({"torch": ("saath", "aalo-like"),
                      "numpy": ("saath", "aalo")}[eng]):
            r = {row["oversub"]: row["avg_cct"] for row in rows
                 if row["engine"] == eng and row["lane"] == lane}
            assert r[4.0] > 1.1 * r[1.0], \
                f"{eng}/{lane}: 4:1 should degrade CCTs: {r}"
    return rows


if __name__ == "__main__":
    bench, engine = cli_bench()
    run(bench, engine)

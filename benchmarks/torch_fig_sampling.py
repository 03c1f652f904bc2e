"""Non-clairvoyant Saath on the port: known vs pilot-learned coflow
sizes vs Aalo (the counterpart of `benchmarks/fig_sampling.py`).

The paper assumes the coordinator knows every coflow's flow sizes up
front (clairvoyance); the sampling layer drops that assumption
Philae-style (arxiv 2108.11255): a few pilot flows per coflow finish
first and their mean size becomes the coflow's estimate for the §4.3
re-queue, with plain bytes-sent Eq. 1 placement as the fallback before
the first pilot completes. This driver measures what the learning costs
on the FB-like bench fabric, three lanes per plane:

* known   — clairvoyant Saath (the paper's setting);
* learned — `Scenario(clairvoyance=False)`, sizes from pilot flows;
* aalo    — the non-clairvoyant baseline Saath must beat: the true
  `aalo` host policy on the numpy plane, the coordinated-FIFO ablation
  (lcof/per-flow thresholds off) on the torch plane.

Every cell is recorded to BENCH_torch.json via
`benchmarks.torch_common.record` (the clairvoyance flag is part of the
scenario hash). The acceptance gate: learned-size Saath still beats
Aalo on average CCT on BOTH planes — sampling trades a little of the
known-size win, not the win.

    python -m benchmarks.torch_fig_sampling
"""
from __future__ import annotations

import dataclasses

import numpy as np

from benchmarks.torch_common import Bench, cli_bench, emit, record
from repro_torch.api import run as api_run
from repro_torch.core.params import SchedulerParams

AALO_MECH = dict(lcof=False, per_flow_threshold=False)


def run(bench: Bench, engine: str = "torch"):
    # §4.3 re-queueing is where clairvoyance enters the schedule; the
    # sampling estimator feeds exactly that path, so it must be on
    p = SchedulerParams(dynamics_requeue=True)
    rows = []
    avg = {}

    torch_lanes = {"known": dict(clairvoyance=True),
                   "learned": dict(clairvoyance=False),
                   "aalo-like": dict(mechanisms=AALO_MECH)}
    np_lanes = {"known": ("saath", dict(clairvoyance=True)),
                "learned": ("saath", dict(clairvoyance=False)),
                "aalo": ("aalo", dict())}

    for lane, kw in torch_lanes.items():
        sc = dataclasses.replace(
            bench.scenario("saath", engine="torch", params=p,
                           label=f"sampling-{lane}"), **kw)
        res = api_run(sc)
        record("fig_sampling_torch", res, lane=lane)
        avg[("torch", lane)] = float(np.nanmean(res.avg_cct))
        rows.append({"engine": "torch", "lane": lane,
                     "avg_cct": avg[("torch", lane)],
                     "wall_seconds": res.wall_seconds})

    for lane, (policy, kw) in np_lanes.items():
        sc = dataclasses.replace(
            bench.scenario(policy, engine="numpy", params=p,
                           label=f"sampling-{lane}"), **kw)
        res = api_run(sc)
        record("fig_sampling_numpy", res, lane=lane)
        avg[("numpy", lane)] = float(np.nanmean(res.avg_cct))
        rows.append({"engine": "numpy", "lane": lane,
                     "avg_cct": avg[("numpy", lane)],
                     "wall_seconds": res.wall_seconds})

    emit("fig_sampling", rows)

    # the acceptance gate: losing clairvoyance must not lose the win —
    # pilot-learned Saath still beats the Aalo lane on avg CCT
    for eng, aalo in (("torch", "aalo-like"), ("numpy", "aalo")):
        assert avg[(eng, "learned")] < avg[(eng, aalo)], \
            f"{eng}: learned Saath should beat Aalo: " \
            f"learned={avg[(eng, 'learned')]:.4g} " \
            f"aalo={avg[(eng, aalo)]:.4g}"
    return rows


if __name__ == "__main__":
    bench, engine = cli_bench()
    run(bench, engine)

"""Fig. 14 on the port: sensitivity to S (start threshold), E (growth),
delta (sync interval), A (arrival speedup), d (deadline factor), plus
the work-conservation / §4.3-re-queue mechanism switches (the
counterpart of `benchmarks/fig14_sensitivity.py`).

One methodology on both engines, through `repro_torch.api.run`:

* the (S, E, delta, d, mech) grid is ONE sweep Scenario over one trace
  — batched into one replay on the torch engine, looped on numpy;
* the arrival-speedup (A) axis changes the TRACE, so it is one Scenario
  per A with an Aalo host baseline (speedup = contention claim).

Key paper claims checked: Saath insensitive to S (LCoF fixes FIFO's
HoL); Saath's edge grows with contention (A); mechanisms don't hurt.

    python -m benchmarks.torch_fig14_sensitivity
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmarks.torch_common import Bench, cli_bench, emit, record
from repro_torch.api import Scenario
from repro_torch.api import run as api_run
from repro_torch.core.params import MB, SchedulerParams
from repro_torch.fabric.metrics import percentile_speedup

# (coflows, ports) of the sweep's trace, quick and --full
TRACE_QUICK, TRACE_FULL = (60, 24), (100, 48)


def _grid(base: SchedulerParams):
    grid = []
    for S in (1 * MB, 10 * MB, 100 * MB):
        grid.append(("S", S / MB,
                     dataclasses.replace(base, start_threshold=S)))
    for E in (2.0, 10.0, 32.0):
        grid.append(("E", E, dataclasses.replace(base, growth=E)))
    for delta in (8e-3, 64e-3, 256e-3):
        grid.append(("delta_ms", delta * 1e3,
                     dataclasses.replace(base, delta=delta)))
    for d in (1.0, 2.0, 8.0):
        grid.append(("d", d, dataclasses.replace(base, deadline_factor=d)))
    # mechanism switches (wc = work conservation, rq = §4.3 re-queue),
    # value encodes the pair as 2*wc + rq
    for wc in (True, False):
        for rq in (True, False):
            grid.append(("mech", 2 * wc + rq, dataclasses.replace(
                base, work_conservation=wc, dynamics_requeue=rq)))
    return grid


def run(bench: Bench, engine: str = "torch"):
    from repro_torch.traces import tiny_trace

    n, ports = TRACE_QUICK if bench.quick else TRACE_FULL
    trace = tiny_trace(n, ports, seed=0, load=0.8)
    base = SchedulerParams()
    grid = _grid(base)

    t0 = time.perf_counter()
    res = api_run(Scenario(policy="saath", engine=engine, trace=trace,
                           sweep=tuple(p for _, _, p in grid),
                           label="fig14/grid", device=bench.device))
    wall = time.perf_counter() - t0
    record("fig14_grid", res)
    rows = []
    for i, (knob, value, _) in enumerate(grid):
        cct = res.row_cct(i)
        rows.append({"knob": knob, "value": value,
                     "avg_cct": float(np.nanmean(cct)),
                     "p50_cct": float(np.nanpercentile(cct, 50)),
                     "p90_cct": float(np.nanpercentile(cct, 90))})

    # contention axis: A scales the TRACE's arrival rate; Saath side on
    # the Scenario's engine, Aalo host baseline
    for A in (0.5, 1.0, 2.0):
        tr = tiny_trace(n, ports, seed=0, load=0.8, arrival_speedup=A)
        a = api_run(Scenario(policy="aalo", engine="numpy", trace=tr,
                             params=base, device=bench.device))
        s = api_run(Scenario(policy="saath", engine=engine, trace=tr,
                             params=base, label=f"fig14/A={A}",
                             device=bench.device))
        sp = percentile_speedup(a.row_cct(), s.row_cct())
        rows.append({"knob": "A", "value": A, "avg_cct": sp["p50"],
                     "p50_cct": sp["p50"], "p90_cct": sp["p90"]})

    emit(f"fig14_sensitivity[{engine}]",
         rows + [{"knob": "wall_s", "value": wall, "avg_cct": len(grid),
                  "p50_cct": float("nan"), "p90_cct": float("nan")}])

    # S-insensitivity: avg CCT varies < 2x across the S grid
    s_rows = [r["avg_cct"] for r in rows if r["knob"] == "S"]
    assert max(s_rows) <= 2.0 * min(s_rows), s_rows
    # mechanisms should not hurt: full SAATH (wc+rq) avg CCT stays
    # within 10% of (and typically beats) the no-mechanism ablation
    mech = {r["value"]: r["avg_cct"] for r in rows if r["knob"] == "mech"}
    assert mech[3] <= 1.1 * mech[0], mech
    # contention claim: speedup at A=2 >= speedup at A=0.5 (more
    # contention -> LCoF pays off more)
    a_lo = next(r for r in rows if r["knob"] == "A" and r["value"] == 0.5)
    a_hi = next(r for r in rows if r["knob"] == "A" and r["value"] == 2.0)
    assert a_hi["p50_cct"] >= a_lo["p50_cct"] * 0.8, (a_lo, a_hi)
    return rows


if __name__ == "__main__":
    run(*cli_bench())

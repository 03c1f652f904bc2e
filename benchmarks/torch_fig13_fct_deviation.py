"""Fig. 13 on the port: FCT deviation (out-of-sync) collapses under
Saath vs Aalo (the counterpart of `benchmarks/fig13_fct_deviation.py`).

The per-flow FCTs the deviation metric consumes are part of the
normalized `Result` on both engines, so the Saath side just takes the
Scenario's engine; Aalo is a host policy on the numpy engine.

    python -m benchmarks.torch_fig13_fct_deviation
"""
from __future__ import annotations

from benchmarks.torch_common import Bench, cli_bench, emit, pctl
from repro_torch.fabric.metrics import fct_normalized_std


def run(bench: Bench, engine: str = "torch"):
    rows = []
    devs = {}
    for pol in ("aalo", "saath"):
        table = bench.run(pol, engine=engine if pol == "saath"
                          else "numpy").table()
        dev = fct_normalized_std(table)
        devs[pol] = dev
        for kind in ("equal", "unequal"):
            d = dev[kind]
            if d.size == 0:
                continue
            rows.append({
                "policy": pol, "kind": kind,
                "frac_zero": float((d < 1e-6).mean()),
                "frac_under_10pct": float((d < 0.10).mean()),
                "p50": pctl(d, 50),
            })
    emit(f"fig13_fct_deviation[{engine}]", rows)
    a = devs["aalo"]["equal"]
    s = devs["saath"]["equal"]
    if a.size and s.size:
        assert (s < 0.10).mean() >= (a < 0.10).mean(), (
            "Saath should reduce FCT deviation for equal-length coflows")
    return rows


if __name__ == "__main__":
    run(*cli_bench())

"""Fig. 11/12 on the port: Saath speedup over Aalo per Table-1 bin
(size <=/> 100MB x width <=/> 10; the counterpart of
`benchmarks/fig11_bins.py`).

The Saath side runs on the Scenario's engine; `Result.table()`
materializes a filled FlowTable from either engine, so the bin metrics
consume one shape of data with no engine branching.

    python -m benchmarks.torch_fig11_bins
"""
from __future__ import annotations

from benchmarks.torch_common import Bench, cli_bench, emit
from repro_torch.fabric.metrics import bin_speedups


def run(bench: Bench, engine: str = "torch"):
    aalo = bench.run("aalo", engine="numpy").table()
    saath = bench.run("saath", engine=engine).table()
    bins = bin_speedups(aalo, saath, qs=(50, 90))
    rows = []
    for b, d in bins.items():
        row = {"bin": b, "frac": d.get("frac", 0.0),
               "p50": d.get("p50", float("nan")),
               "p90": d.get("p90", float("nan")),
               "n": d.get("n", 0)}
        rows.append(row)
    emit(f"fig11_bins[{engine}]", rows)
    return rows


if __name__ == "__main__":
    run(*cli_bench())

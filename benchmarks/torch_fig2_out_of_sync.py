"""Fig. 2 on the port: prevalence of the out-of-sync problem under Aalo
(the counterpart of `benchmarks/fig2_out_of_sync.py`).

(a) width distribution; (b) flow-length skew; (c) normalized std-dev of
per-flow FCTs under Aalo (a host policy on the numpy engine), split
equal/unequal flow lengths.

    python -m benchmarks.torch_fig2_out_of_sync
"""
from __future__ import annotations

from benchmarks.torch_common import Bench, cli_bench, emit, pctl
from repro_torch.fabric.metrics import fct_normalized_std


def run(bench: Bench, engine: str = "torch"):
    t = bench.run("aalo", engine="numpy", record_as="fig2").table()
    widths = t.width
    rows = [{
        "metric": "width",
        "p50": pctl(widths, 50), "p90": pctl(widths, 90),
        "frac_single": float((widths == 1).mean()),
    }]
    dev = fct_normalized_std(t)
    for kind in ("equal", "unequal"):
        d = dev[kind]
        if d.size == 0:
            continue
        rows.append({
            "metric": f"fct_norm_std_{kind}",
            "p50": pctl(d, 50), "p90": pctl(d, 80),
            "frac_single": float((d > 0.39).mean()),
        })
    emit("fig2_out_of_sync", rows)
    # paper: 20% of equal-length coflows see >39% deviation under Aalo
    d = dev["equal"]
    assert d.size and pctl(d, 80) > 0.1, "out-of-sync should be visible"
    return rows


if __name__ == "__main__":
    run(*cli_bench())

"""Fig. 10 on the port: design-component breakdown — A/N, A/N+P/F, full
Saath (LCoF), each vs Aalo (the counterpart of
`benchmarks/fig10_breakdown.py`). Paper (FB): 1.13x -> 1.3x -> 1.53x
median.

The ablation switches are the shared `repro_torch.api` mechanism names:
on the numpy engine they become Saath ctor kwargs, on the torch engine
they are switches of the batched fleet engine — one Scenario field
either way. The ablation ordering assertion guards both planes end to
end.

    python -m benchmarks.torch_fig10_breakdown
"""
from __future__ import annotations

from benchmarks.torch_common import Bench, cli_bench, emit
from repro_torch.fabric.metrics import percentile_speedup

VARIANTS = [
    ("A/N", dict(lcof=False, per_flow_threshold=False)),
    ("A/N+PF", dict(lcof=False, per_flow_threshold=True)),
    ("SAATH", dict(lcof=True, per_flow_threshold=True)),
]


def run(bench: Bench, engine: str = "torch"):
    base = bench.run("aalo", engine="numpy").row_cct()
    rows = []
    for name, mech in VARIANTS:
        cct = bench.run("saath", engine=engine, mechanisms=mech,
                        label=f"fig10/{name}").row_cct()
        rows.append({"variant": name, **percentile_speedup(base, cct)})
    emit(f"fig10_breakdown[{engine}]", rows)
    # the paper's Fig. 10 claim: each design component helps at p50
    # (5% slack absorbs replay noise on the quick fabric)
    an, anpf, saath = (r["p50"] for r in rows)
    assert anpf >= an * 0.95, ("A/N+PF should not lose to A/N", rows)
    assert saath >= anpf * 0.95, ("SAATH should not lose to A/N+PF", rows)
    assert saath >= an * 0.95, (
        "full SAATH should not lose to A/N-only at p50", rows)
    return rows


if __name__ == "__main__":
    run(*cli_bench())

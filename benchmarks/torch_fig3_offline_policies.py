"""Fig. 3 on the port: offline SCF vs SRTF vs LWTF speedups over Aalo
(sizes known; the counterpart of `benchmarks/fig3_offline_policies.py`).

LWTF (t*k: duration x contention) should beat SCF/SRTF — the paper's
evidence that contention matters. Every lane is a host policy on the
numpy engine (LWTF's contention count through K1 on the card).

    python -m benchmarks.torch_fig3_offline_policies
"""
from __future__ import annotations

from benchmarks.torch_common import Bench, cli_bench, emit
from repro_torch.fabric.metrics import percentile_speedup


def run(bench: Bench, engine: str = "torch"):
    base = bench.run("aalo", engine="numpy").row_cct()
    rows = []
    for pol in ("scf", "srtf", "lwtf"):
        s = percentile_speedup(base,
                               bench.run(pol, engine="numpy").row_cct())
        rows.append({"policy": pol, **{k: v for k, v in s.items()}})
    emit("fig3_offline", rows)
    lwtf = next(r for r in rows if r["policy"] == "lwtf")
    scf = next(r for r in rows if r["policy"] == "scf")
    assert lwtf["overall"] >= scf["overall"] * 0.95, (
        "LWTF should be competitive with SCF overall")
    return rows


if __name__ == "__main__":
    run(*cli_bench())

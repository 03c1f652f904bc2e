"""Fig. 9 on the port: CCT speedup of Saath over Aalo / Varys-SEBF /
UC-TCP (the counterpart of `benchmarks/fig9_speedup.py`).

Paper (FB trace): Saath vs Aalo p50 = 1.53x, p90 = 4.5x; ~Varys-SEBF
parity; >>100x vs UC-TCP.

The Saath side runs on whichever engine the Scenario names (--engine,
default torch: the batched replay on the card); the baselines are
host policies on the numpy engine, and `saath-torch` (the port's tick,
one tick a schedule) is the reference's `saath-jax` lane. The fleet
section is inherently cross-engine: 16 traces replayed as ONE batched
torch-engine call vs 16 sequential `Simulator.run` replays on the host
(the reference's yardstick, whatever --device says) — the >= 5x
wall-clock claim the batched engine exists for.

    python -m benchmarks.torch_fig9_speedup            # on the card
    PYTHONPATH=src python -m benchmarks.torch_fig9_speedup --device cpu
"""
from __future__ import annotations

import os

import numpy as np

from benchmarks.torch_common import Bench, cli_bench, emit, record
from repro_torch.api import Scenario
from repro_torch.api import run as api_run
from repro_torch.fabric.metrics import percentile_speedup

FLEET = 16  # traces in the batched sweep
FLEET_TRACE = (40, 20)  # each fleet trace's coflows and ports
BASELINES = ("aalo", "varys-sebf", "uc-tcp", "fifo", "saath-torch")


def run(bench: Bench, engine: str = "torch"):
    saath = bench.run("saath", engine=engine,
                      record_as="fig9_saath").row_cct()
    rows = []
    for pol in BASELINES:
        other = bench.run(pol, engine="numpy").row_cct()
        s = percentile_speedup(other, saath)  # CCT_other / CCT_saath
        rows.append({"vs": pol, **s})
    emit(f"fig9_speedup[{engine}]", rows)
    aalo = next(r for r in rows if r["vs"] == "aalo")
    assert aalo["p50"] > 1.1, f"Saath should beat Aalo at p50: {aalo}"
    assert aalo["p90"] > 2.0, f"...and strongly at p90: {aalo}"
    rows += run_fleet(bench)
    return rows


def fleet_traces(bench: Bench):
    """The fleet: FLEET traces (twice as many at full scale) of
    tiny_trace(*FLEET_TRACE, load=0.8), seeds 0, 1, ..."""
    from repro_torch.traces import tiny_trace

    fleet = FLEET if bench.quick else 2 * FLEET
    return tuple(tiny_trace(*FLEET_TRACE, seed=s, load=0.8)
                 for s in range(fleet))


def run_fleet(bench: Bench):
    """16-trace fleet: sequential event-driven numpy replays vs one
    batched torch-engine call, all through `repro_torch.api.run`
    (cold/warm split via Scenario.warm_timing).

    Two batched rows: full FIDELITY (per-flow work conservation + §4.3
    re-queue — must match the numpy replays' CCTs) and the
    coflow-granular THROUGHPUT mode (the parameter-sweep configuration
    the >= 5x wall-clock gate applies to)."""
    from repro_torch.core.params import SchedulerParams

    p = SchedulerParams()
    traces = fleet_traces(bench)
    fleet, (n, ports) = len(traces), FLEET_TRACE

    # the yardstick is the reference's: host-only numpy replays (Saath's
    # contention count on the CPU, not one K1 launch a step on the card)
    seq = api_run(Scenario(policy="saath", engine="numpy", params=p,
                           traces=traces, label="fleet-seq",
                           device="cpu"))
    t_seq = seq.wall_seconds

    fid = api_run(Scenario(policy="saath", engine="torch", params=p,
                           traces=traces, warm_timing=True,
                           label="fleet-fidelity", device=bench.device))
    t_cold = fid.wall_seconds + fid.compile_seconds
    t_fid = fid.wall_seconds
    ratio = float(np.mean(fid.avg_cct) / np.mean(seq.avg_cct))

    fast = api_run(Scenario(policy="saath", engine="torch", params=p,
                            traces=traces, fidelity="coflow",
                            mechanisms={"dynamics_requeue": False},
                            warm_timing=True, label="fleet-throughput",
                            device=bench.device))
    t_warm = fast.wall_seconds
    ratio_fast = float(np.mean(fast.avg_cct) / np.mean(seq.avg_cct))

    record("fig9_fleet_seq", seq)
    record("fig9_fleet_fidelity", fid)
    record("fig9_fleet_throughput", fast)
    rows = [
        {"vs": "fleet-seq-numpy", "wall_s": t_seq, "speedup": 1.0,
         "note": f"{fleet}x Simulator.run {n}x{ports}"},
        {"vs": "fleet-torch-cold", "wall_s": t_cold,
         "speedup": t_seq / t_cold, "note": "incl. kernel builds"},
        {"vs": "fleet-torch-fidelity", "wall_s": t_fid,
         "speedup": t_seq / t_fid,
         "note": f"events={fid.steps} avg-cct-ratio={ratio:.3f}"},
        {"vs": "fleet-torch-warm", "wall_s": t_warm,
         "speedup": t_seq / t_warm,
         "note": f"events={fast.steps} "
                 f"avg-cct-ratio={ratio_fast:.3f}"},
    ]
    emit("fig9_fleet", rows)
    warm = t_seq / t_warm
    # >= 5x on a quiet machine; SAATH_FLEET_MIN_SPEEDUP relaxes the gate
    # where wall-clock ratios wander (and on the CPU, where the batched
    # engine runs the kernels' plain versions: the gate is the card's)
    floor = float(os.environ.get("SAATH_FLEET_MIN_SPEEDUP", "5.0"))
    assert warm >= floor, f"batched fleet should be >={floor}x: {warm:.1f}x"
    # full fidelity must MATCH the per-flow reference, not approximate it
    assert 0.97 < ratio < 1.03, ratio
    # the coflow-granular throughput mode keeps the documented envelope
    assert 0.5 < ratio_fast < 2.0, ratio_fast
    return rows


if __name__ == "__main__":
    run(*cli_bench())

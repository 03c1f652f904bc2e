"""Table 2 on the port: the coordinator's scheduling cost (the
counterpart of `benchmarks/table2_coordinator_latency.py`).

Rows:

(a) the host-reference Saath replay on the bench fabric (the numpy
    engine, `run(Scenario(engine="numpy"))`, its LCoF contention count
    on the device through K1), as the reference times it: host seconds
    inside the policy's schedule calls over the schedule steps;
(b) one coordinator tick of the port (`core.coordinator.schedule_tick`,
    K1 and K2 on the card) at production scale, (C, P) = (512, 150),
    (2048, 512) and (4096, 512), on the reference's random inputs, with
    the LCoF contention sub-step (`kernels.ops.contention`, K1 on the
    card) timed on its own. Times are synchronised wall times: the host
    clock around `--reps` calls, each ending in a device synchronise
    (what a coordinator that acts on each tick's rates waits for);
(c) the amortized per-trace event-step cost of a whole fleet of
    `tiny_trace`s through `repro_torch.api.run(Scenario(...,
    warm_timing=True))` (best of two warm runs; the first run's excess
    and its kernel builds are printed apart).

The paper's C++ coordinator: 0.57 ms avg / 2.85 ms P90 at ~150 ports.
The tick at 4096 coflows must stay under a second.

    PYTHONPATH=src python -m benchmarks.torch_table2_coordinator_latency
    PYTHONPATH=src python -m benchmarks.torch_table2_coordinator_latency \\
        --device cpu --sizes 64x16 --reps 2 --fleet 2
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmarks.torch_common import Bench, cli_parser, device_name, emit, \
    pctl, record
from repro_torch.api import Scenario
from repro_torch.api import run as api_run
from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams
from repro_torch.kernels import build, ops

SIZES = ((512, 150), (2048, 512), (4096, 512))
# row (c)'s fleet: (coflows, ports, traces), quick and --full (the
# reference's `run_engine_throughput`)
FLEET_QUICK, FLEET_FULL = (60, 24, 16), (120, 48, 32)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, n=20, warmup=3):
    """Synchronised wall seconds of each of `n` calls of `fn` (after
    `warmup` calls): (mean, list of per-call seconds)."""
    for _ in range(warmup):
        fn()
        _sync(device)
    per = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        per.append(time.perf_counter() - t0)
    return float(np.mean(per)), per


def tick_inputs(C: int, P: int, rng, device):
    """The reference's random tick inputs (its draws, in its order), as
    one lane of the port's CoflowBatch."""
    active = rng.uniform(size=C) < 0.7
    m = rng.uniform(0, 1e8, C)
    width = rng.integers(1, 64, C)
    cnt_s = (rng.uniform(size=(C, P)) < 0.05) * rng.integers(1, 4, (C, P))
    cnt_r = (rng.uniform(size=(C, P)) < 0.05) * rng.integers(1, 4, (C, P))

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                               device=device)

    f32 = torch.float32
    return co.CoflowBatch(
        active=t(active, torch.bool),
        arrival=t(np.arange(C), torch.int64), m=t(m, f32),
        width=t(width, torch.int64), cnt_s=t(cnt_s, f32),
        cnt_r=t(cnt_r, f32),
        bw_s=torch.full((1, P), 1e9, dtype=f32, device=device),
        bw_r=torch.full((1, P), 1e9, dtype=f32, device=device))


def coordinator_rows(device, sizes=SIZES, reps: int = 20):
    """Row (b): a tick and its contention sub-step at each (C, P)."""
    rng = np.random.default_rng(0)
    cp = co.CoordParams.from_params(SchedulerParams())
    rows = []
    for C, P in sizes:
        state = co.init_state(1, C, device)
        batch = tick_inputs(C, P, rng, device)

        def tick():
            co.schedule_tick(state, batch, 1.0, cp=cp)

        dt, per = _time(tick, device, n=reps)
        a_s, a_r = batch.cnt_s > 0, batch.cnt_r > 0
        dt_k, _ = _time(lambda: ops.contention(a_s, a_r, batch.active),
                        device, n=reps)
        rows.append({"impl": "torch-tick", "C": C, "P": P,
                     "avg_ms": dt * 1e3, "p90_ms": pctl(per, 90) * 1e3,
                     "note": f"contention={dt_k * 1e3:.3f}ms"})
    return rows


def fleet_row(bench: Bench, fleet: int = 0, engine: str = "torch"):
    """Row (c): a tiny_trace fleet through the front door on `engine`,
    warm."""
    from repro_torch.traces import tiny_trace

    n, ports, width = FLEET_QUICK if bench.quick else FLEET_FULL
    fleet = fleet or width
    traces = tuple(tiny_trace(n, ports, seed=s, load=0.8)
                   for s in range(fleet))
    res = api_run(Scenario(policy="saath", engine=engine,
                           params=SchedulerParams(), traces=traces,
                           warm_timing=True,
                           device=bench.device, label="table2/fleet"))
    record("table2_fleet", res)
    return {"impl": f"{engine}-batched-engine", "C": n, "P": ports,
            "avg_ms": 1e3 * res.wall_seconds / max(res.steps, 1),
            "p90_ms": float("nan"),
            "note": f"fleet={fleet} steps={res.steps} "
                    f"wall={res.wall_seconds:.3f}s first-run excess="
                    f"{res.compile_seconds:.3f}s (kernel builds "
                    f"{res.build_seconds:.3f}s) (amortized per "
                    f"trace-step)"}


def replay_row(bench: Bench):
    """Row (a): the numpy-engine Saath replay on the bench fabric."""
    res = bench.run("saath", engine="numpy", label="table2/replay",
                    record_as="table2_replay")
    return {"impl": "numpy-replay", "C": int(res.num_coflows[0]),
            "P": res.table(0).num_ports,
            "avg_ms": 1e3 * res.sched_seconds / max(res.steps, 1),
            "p90_ms": float("nan"),
            "note": f"full Fig.7 step incl. WC; steps={res.steps} "
                    f"wall={res.wall_seconds:.3f}s (kernel builds "
                    f"{res.build_seconds:.3f}s)"}


def _size(text: str):
    c, p = text.lower().split("x")
    return int(c), int(p)


def main(argv=None):
    ap = cli_parser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=_size, nargs="+", default=list(SIZES),
                    help="(C)x(P) of row (b)'s ticks, e.g. 512x150")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed ticks per size")
    ap.add_argument("--fleet", type=int, default=0,
                    help="traces in row (c)'s fleet (default 16, 32 "
                    "with --full)")
    args = ap.parse_args(argv)
    return run(Bench(quick=not args.full, device=args.device),
               sizes=args.sizes, reps=args.reps, fleet=args.fleet)


def run(bench: Bench, engine: str = "torch", *, sizes=None,
        reps: int = 20, fleet: int = 0):
    """Rows (a), (b) at `sizes` (default SIZES) and (c) on the bench's
    device (row (c)'s fleet on `engine`), and the sub-second gate at the
    largest tick; the suite runner's entry (`benchmarks/torch_run.py`)."""
    dev = bench.device
    rows = [replay_row(bench)]
    print(f"# (a) numpy-replay: host ms inside the policy a schedule step "
          f"on {device_name(dev)}", file=sys.stderr)
    built = build.build_seconds
    rows += coordinator_rows(dev, sizes or SIZES, reps)
    print(f"# (b) synchronised wall times on {device_name(dev)}; "
          f"kernel builds {build.build_seconds - built:.2f}s before the "
          f"timed calls", file=sys.stderr)
    rows.append(fleet_row(bench, fleet, engine))
    emit(f"table2_coordinator[torch on {device_name(dev)}]", rows)
    big = max((r for r in rows if r["impl"] == "torch-tick"),
              key=lambda r: r["C"])
    assert big["avg_ms"] < 1e3, "coordinator tick should be sub-second"
    return rows


if __name__ == "__main__":
    main()
